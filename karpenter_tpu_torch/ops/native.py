"""ctypes bridge to the native C++ group-FFD solver (native/ffd.cpp).

The port's copy of `karpenter_tpu/ops/native.py`, over the same source.
The shared library is built on first use by `ops/_build.load_native`
(g++ -O3 into `build/karpenter_tpu_torch/`, never beside the source);
`available()` is False when no compiler is present. Semantics are
bit-identical to solve_host / solve_device, so the facade's backend ladder
gives one answer on every rung.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import List, Optional

import numpy as np

from .binpack import SolveResult, VirtualNode, finalize_offerings
from .encode import CatalogTensors, EncodedPods, align_resources
from .solver import _bucket

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        from ._build import load_native
        lib = load_native()
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ffd_solve.restype = ctypes.c_int32
        u8p_or_null = ctypes.c_void_p  # nullable uint8* (banned / conflict)
        lib.ffd_solve.argtypes = [
            f32p, f32p, u8p, f32p, i32p, u8p, u8p, u8p, i32p, i32p,
            u8p_or_null, u8p_or_null,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, f32p, u8p, u8p, i32p, i32p,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    except (subprocess.CalledProcessError, OSError) as e:
        _build_error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def solve_native(cat: CatalogTensors, enc: EncodedPods,
                 existing: Optional[List[VirtualNode]] = None,
                 n_max: Optional[int] = None) -> SolveResult:
    """Same contract as solve_host/solve_device."""
    lib = _load()
    assert lib is not None, f"native solver unavailable: {_build_error}"
    assert not enc.spread_zone.any(), "run split_spread_groups before solve"
    existing = existing or []
    R = enc.requests.shape[1]
    G, T, Z, C = enc.G, cat.T, cat.Z, cat.C
    Ne = len(existing)
    total = int(enc.counts.sum())
    if n_max is None:
        n_max = _bucket(Ne + total)  # native state is cheap; no retry loop

    alloc = np.ascontiguousarray(align_resources(cat.allocatable, R), np.float32)
    price = np.ascontiguousarray(cat.price, np.float32)
    avail = np.ascontiguousarray(cat.available, np.uint8)
    requests = np.ascontiguousarray(enc.requests, np.float32)
    counts = np.ascontiguousarray(enc.counts, np.int32)
    compat = np.ascontiguousarray(enc.compat, np.uint8)
    allow_zone = np.ascontiguousarray(enc.allow_zone, np.uint8)
    allow_cap = np.ascontiguousarray(enc.allow_cap, np.uint8)
    mpn = np.ascontiguousarray(enc.max_per_node, np.int32)

    prior = np.zeros((G, n_max), np.int32)
    node_type = np.zeros(n_max, np.int32)
    node_cum = np.zeros((n_max, R), np.float32)
    node_zmask = np.zeros((n_max, Z), np.uint8)
    node_cmask = np.zeros((n_max, C), np.uint8)
    for i, n in enumerate(existing):
        assert len(n.cum) <= R, (
            f"existing node cum has {len(n.cum)} resources but the current "
            f"axis is {R} — the resource axis only grows within a process")
        node_type[i] = n.type_idx
        node_cum[i, : len(n.cum)] = n.cum
        node_zmask[i] = n.zone_mask.astype(np.uint8)
        node_cmask[i] = n.cap_mask.astype(np.uint8)
        for g, cnt in n.prior_by_group.items():
            if g < G:
                prior[g, i] = cnt

    banned = None
    if any(n.banned_groups is not None for n in existing):
        banned = np.zeros((G, n_max), np.uint8)
        for i, n in enumerate(existing):
            if n.banned_groups is not None:
                banned[: len(n.banned_groups), i] = n.banned_groups
    conflict = (np.ascontiguousarray(enc.conflict, np.uint8)
                if enc.conflict is not None else None)

    def _ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    takes = np.zeros((G, n_max), np.int32)
    unsched = np.zeros(G, np.int32)
    n_used = ctypes.c_int64(0)
    lib.ffd_solve(alloc, price, avail, requests, counts, compat, allow_zone,
                  allow_cap, mpn, np.ascontiguousarray(prior),
                  _ptr(banned), _ptr(conflict),
                  G, T, Z, C, R, n_max, Ne,
                  node_type, node_cum, node_zmask, node_cmask,
                  takes, unsched, ctypes.byref(n_used))

    nodes: List[VirtualNode] = []
    for i in range(int(n_used.value)):
        pods = {g: int(takes[g, i]) for g in range(G) if takes[g, i] > 0}
        nodes.append(VirtualNode(
            type_idx=int(node_type[i]),
            zone_mask=node_zmask[i].astype(bool),
            cap_mask=node_cmask[i].astype(bool),
            cum=node_cum[i].copy(), pods_by_group=pods,
            banned_groups=existing[i].banned_groups if i < Ne else None,
            existing_name=existing[i].existing_name if i < Ne else None))
    result = SolveResult(
        nodes=nodes,
        unschedulable={g: int(unsched[g]) for g in range(G) if unsched[g] > 0})
    finalize_offerings(result, cat)
    return result
