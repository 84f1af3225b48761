"""The provisioning solve on the card: `solve_device`.

The port of `karpenter_tpu/ops/solver.py`'s single-device path. The host
side is the reference's own numpy (copied here): group padding and
packing, the node-budget estimate, the projected resource columns, the
packed-result parse and the decode. The device side is one packed upload
of the group matrix (plus the node matrix when resuming), the group scan
(`ops/solve_scan`: kernels B0 and B on the card), the compaction into the
reference's int32 result layout, and ONE host read. The node-budget
regrow loop is the reference's; a sparse budget (k_max) too small for the
takes re-packs the same scan output instead of scanning again.

Entry points run on `cuda` unless the caller passes `device="cpu"`, which
runs the same path with the scan's plain PyTorch version. Multi-device
(`mesh=`) is not ported.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..obs.tracer import NOOP_SPAN, TRACER
from .binpack import BIG, EPS, SolveResult, VirtualNode
from .encode import (CatalogTensors, EncodedPods, align_resources,
                     align_zone_overhead)
from .solve_scan import ScanOut, pack_solution, solve_scan


class InjectedFault(RuntimeError):
    """A device fault raised by the dispatch-fault hook. It is the one
    exception the facade's device rung degrades on (metered, rerouted to
    the native or host rung for a cooldown); a kernel that fails to build,
    refuses its shapes or fails to launch raises its own error out of
    `Solver.solve` instead."""


# fault-injection seams, nil-guarded (None costs one identity check a
# solve). The dispatch hook is called with the backend name just before
# the scan and raises InjectedFault to model the card failing mid-solve.
# The corruption hook is called as hook("result", SolveResult) after the
# decode and returns a (silently wrong) replacement or None; while it is
# armed, an integrity violation on the device rung is treated as the
# injected corruption it is (quarantine and recovery) instead of raising.
_dispatch_fault_hook = None
_corruption_hook = None


def set_dispatch_fault_hook(fn) -> None:
    global _dispatch_fault_hook
    _dispatch_fault_hook = fn


def set_corruption_hook(fn) -> None:
    global _corruption_hook
    _corruption_hook = fn


def _maybe_corrupt(target: str, obj):
    if _corruption_hook is None:
        return obj
    out = _corruption_hook(target, obj)
    return obj if out is None else out


def _span(name: str):
    return TRACER.span(name) if TRACER.enabled else NOOP_SPAN


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card. Without a card and without an explicit device it raises —
    the port never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the host")
    return torch.device("cuda")


def reject_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "multi-device (mesh=) solving is not ported to karpenter_tpu_torch "
            "yet; it runs on one card with mesh=None")


@dataclass(frozen=True)
class DeviceCatalog:
    """Catalog tensors resident on one device."""

    alloc: torch.Tensor                   # f32 [T, R]
    price: torch.Tensor                   # f32 [T, Z, C], +inf = no offering
    avail: torch.Tensor                   # bool [T, Z, C]
    ovh_z: Optional[torch.Tensor] = None  # f32 [T, Z, R] or None


def _put(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host -> device upload of one numpy array."""
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def device_catalog(cat: CatalogTensors, R: int,
                   device: torch.device) -> DeviceCatalog:
    zovh = align_zone_overhead(cat, R)
    return DeviceCatalog(
        alloc=_put(align_resources(cat.allocatable, R).astype(np.float32),
                   device),
        price=_put(cat.price.astype(np.float32), device),
        avail=_put(cat.available.astype(bool), device),
        ovh_z=(_put(zovh.astype(np.float32), device) if zovh is not None
               else None))


# per-catalog device cache for callers without their own (bare solve_device
# and consolidation_screen calls): keyed on (id(cat), device) with a weakref
# finalizer so a freed CatalogTensors' reused address never aliases a stale
# entry. Callers that mutate a catalog's arrays in place after a solve must
# use a new object.
#
# Views minted by the facade's SharedCatalogCache carry a CONTENT-
# authoritative token ("shared", nodeclass-hash, fingerprint) and key here by
# token instead of id, so the per-solve derived copies (block gating,
# daemonset overhead) share ONE device upload across every tenant facade.
# Only "shared"-rooted tokens qualify: a facade's own (nodeclass-hash, epoch)
# token is unique per provider, not per content — two providers' epoch
# counters can agree while their availability differs.
_dcat_cache: dict = {}
_DCAT_TOKEN_MAX = 32  # bound for token-keyed entries (no weakref owner)
# evictions observed inside weakref finalizers queue here and flush to the
# metric from caller context: a finalizer runs inside GC, which can fire on
# a thread already holding the metric's (non-reentrant) lock
_dcat_evict_pending: list = []


def _count_dcat_eviction(reason: str) -> None:
    from ..metrics import DCAT_EVICTIONS
    DCAT_EVICTIONS.inc(reason=reason)


def _finalize_dcat(key) -> None:
    """weakref-finalizer eviction of an id-keyed entry (GC context: dict
    ops only, metric deferred)."""
    if _dcat_cache.pop(key, None) is not None:
        _dcat_evict_pending.append("weakref")


def release_shared_views(prefix: tuple) -> int:
    """Drop every token-keyed device-catalog entry whose content token
    starts with `prefix` — the SharedCatalogCache calls this when it evicts
    a view, so a dead shared view never pins device buffers past its own
    eviction. Returns the number of entries released."""
    victims = [k for k in _dcat_cache
               if isinstance(k[0], tuple) and k[0][:len(prefix)] == prefix]
    for k in victims:
        _dcat_cache.pop(k, None)
        _count_dcat_eviction("view_evicted")
    return len(victims)


def _dcat_fits(dcat: DeviceCatalog, cat: CatalogTensors, R: int,
               device: torch.device) -> bool:
    """Can this device catalog serve a solve of `cat` at R resource
    columns on `device`?"""
    on = dcat.alloc.device
    return (dcat.alloc.shape[1] >= R and on.type == device.type
            and (device.index is None or on.index == device.index)
            and (dcat.ovh_z is not None) == (cat.zone_overhead is not None))


def _auto_dcat(cat: CatalogTensors, R: int,
               device: torch.device) -> DeviceCatalog:
    """Epoch-cached device catalog. Every eviction path meters
    dcat_evictions_total{reason}: churn here is re-upload cost."""
    while _dcat_evict_pending:  # flush GC-deferred weakref evictions
        _count_dcat_eviction(_dcat_evict_pending.pop())
    device = torch.device(device)
    tok = cat.cache_token
    by_token = tok is not None and len(tok) > 0 and tok[0] == "shared"
    key = ((tuple(tok), str(device)) if by_token
           else (id(cat), str(device)))
    ent = _dcat_cache.get(key)
    if ent is not None and _dcat_fits(ent, cat, R, device):
        return ent
    if ent is not None:
        # present but unusable (resource axis grew / overhead flipped)
        _count_dcat_eviction("stale")
    if ent is None and not by_token:
        weakref.finalize(cat, _finalize_dcat, key)
    dcat = device_catalog(cat, R, device)
    _dcat_cache[key] = dcat
    if by_token:
        # token-keyed entries deliberately OUTLIVE any one CatalogTensors
        # object (derived per-solve copies die at end of solve; their
        # upload must not) — bound them FIFO instead of by weakref
        tkeys = [k for k in _dcat_cache if isinstance(k[0], tuple)]
        for k in tkeys[:max(0, len(tkeys) - _DCAT_TOKEN_MAX)]:
            _dcat_cache.pop(k, None)
            _count_dcat_eviction("fifo")
    return dcat


# ---------------------------------------------------------------------------
# host-side helpers: copies of the reference's numpy (solver.py)
# ---------------------------------------------------------------------------


def _pack_groups(requests, counts, compat, allow_zone, allow_cap,
                 max_per_node, cols) -> np.ndarray:
    """One f32 [Gp, Rk+1+T+Z+C+1] matrix: requests (projected), counts,
    compat, allow_zone, allow_cap, max_per_node. Counts/caps are exact in
    f32 below 2^24 — far above any real pod count."""
    return np.concatenate([
        requests[:, cols].astype(np.float32),
        counts[:, None].astype(np.float32),
        compat.astype(np.float32),
        allow_zone.astype(np.float32),
        allow_cap.astype(np.float32),
        max_per_node[:, None].astype(np.float32),
    ], axis=1)


def _pack_nodes(node_type, node_cum, node_zmask, node_cmask, node_open,
                cols) -> np.ndarray:
    """One f32 [n, 1+Rk+Z+C+1] matrix of resumed-node state."""
    return np.concatenate([
        node_type[:, None].astype(np.float32),
        node_cum[:, cols].astype(np.float32),
        node_zmask.astype(np.float32),
        node_cmask.astype(np.float32),
        node_open[:, None].astype(np.float32),
    ], axis=1)


# monotone union of resource columns ever requested in this process (the
# reference keeps one per package so its jit statics stay stable; this
# package keeps its own, and results do not depend on it: a column no
# group requests can never bind)
_cols_union: set = {0}


def _request_cols(enc: EncodedPods, cat: CatalogTensors) -> tuple:
    """Resource columns the scan must carry: the process-lifetime union of
    columns any group has requested, plus any column a zone-overhead
    reservation charges. Clamped to the current resource axis; never
    empty."""
    used = enc.requests.any(axis=0)
    if cat.zone_overhead is not None:
        zc = cat.zone_overhead.any(axis=(0, 1))
        used[: zc.shape[0]] |= zc
    _cols_union.update(int(c) for c in np.nonzero(used)[0])
    R = enc.requests.shape[1]
    return tuple(c for c in sorted(_cols_union) if c < R)


def _group_inputs(enc: EncodedPods, Gp: int):
    """Pad the per-group arrays to the scan bucket."""
    return (_pad_to(enc.requests.astype(np.float32), Gp),
            _pad_to(enc.counts.astype(np.int32), Gp),
            _pad_to(enc.compat, Gp),
            _pad_to(enc.allow_zone, Gp),
            _pad_to(enc.allow_cap, Gp),
            _pad_to(enc.max_per_node.astype(np.int32), Gp))


def _auto_node_budget(cat: CatalogTensors, enc: EncodedPods,
                      n_existing: int) -> int:
    """Node-axis budget: the estimate commits the same cost-per-slot argmin
    type the scan does, so a 1.25x margin suffices; underestimates are
    safe — the scan reports overflow and solve_device retries doubled."""
    est = _estimate_nodes(cat, enc)
    return _bucket(n_existing + max(64, est + est // 4 + enc.G))


def _pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return np.pad(x, pad, constant_values=fill)


def _estimate_nodes(cat: CatalogTensors, enc: EncodedPods) -> int:
    """FFD node-count estimate: ceil(count / slots) per group, at the slots
    of the cost-per-slot-argmin type. Chunked over groups so the
    [chunk, T, R] broadcast stays small."""
    alloc = align_resources(cat.allocatable, enc.requests.shape[1])
    min_price = np.where(cat.available, cat.price, np.inf).min(axis=(1, 2))
    est = 0.0
    for lo in range(0, enc.G, 256):
        hi = min(lo + 256, enc.G)
        req = enc.requests[lo:hi].astype(np.float32)            # [g, R]
        with_req = np.where(req > 0, req, np.float32(1.0))
        slots = np.where(req[:, None, :] > 0,
                         np.floor(alloc[None, :, :] / with_req[:, None, :]
                                  + EPS),
                         np.float32(BIG)).min(axis=2)           # [g, T]
        cap = np.where(enc.max_per_node[lo:hi] > 0,
                       enc.max_per_node[lo:hi], BIG)[:, None]
        slots = np.clip(slots, 0.0, cap)
        ok = enc.compat[lo:hi] & (slots >= 1) & np.isfinite(min_price)[None, :]
        cps = np.where(ok, min_price[None, :] / np.maximum(slots, 1.0),
                       np.inf)                                  # [g, T]
        t_star = np.argmin(cps, axis=1)
        g_idx = np.arange(hi - lo)
        s = np.where(np.isfinite(cps[g_idx, t_star]),
                     slots[g_idx, t_star], np.float32(BIG))
        est += float(np.ceil(enc.counts[lo:hi] / np.maximum(s, 1.0)).sum())
    return int(est)


def _bucket(n: int, quantum: int = 64) -> int:
    """Round up to a padding bucket {2^k, 3·2^(k-1)} (worst-case padding
    waste 33%; the scan's per-step cost is O(n_max))."""
    n = max(n, 1)
    p = int(2 ** math.floor(math.log2(n)))
    for cand in (p, 3 * p // 2, 2 * p):
        if cand >= n:
            return max(quantum, cand)
    return max(quantum, 2 * p)


def _parse_packed(buf: np.ndarray, Gp: int, n_max: int, k_max: int):
    """Split one packed int32 result vector (layout: solve_scan.pack_solution)."""
    nused, overflowed, nnz = int(buf[0]), bool(buf[1]), int(buf[2])
    o = 3
    unsched = buf[o: o + Gp]; o += Gp
    ntype = buf[o: o + n_max]; o += n_max
    idx = buf[o: o + k_max]; o += k_max
    vals = buf[o: o + k_max]
    return nused, overflowed, nnz, unsched, ntype, idx, vals


def _decode_solution(cat: CatalogTensors, enc: EncodedPods,
                     existing: List[VirtualNode], node_cum: np.ndarray,
                     node_zmask: np.ndarray, node_cmask: np.ndarray,
                     nused: int, ntype: np.ndarray, idx: np.ndarray,
                     vals: np.ndarray, nnz: int, unsched: np.ndarray,
                     n_max: int) -> SolveResult:
    """Host-side reconstruction (vectorized, no device reads). cum is
    re-accumulated in ascending group order with the same f32 ops as the
    scan, so values agree bitwise."""
    R = enc.requests.shape[1]
    G = enc.G
    n_existing = len(existing)
    n_total = min(nused, n_max)
    take_g = idx[:nnz] // n_max
    take_n = idx[:nnz] % n_max
    take_v = vals[:nnz]

    cum = np.zeros((n_total, R), np.float32)
    cum[:n_existing] = node_cum[:n_existing]
    zmask = np.ones((n_total, cat.Z), bool)
    cmask = np.ones((n_total, cat.C), bool)
    zmask[:n_existing] = node_zmask[:n_existing]
    cmask[:n_existing] = node_cmask[:n_existing]
    fresh = np.ones(n_total, bool)
    fresh[:n_existing] = False
    t_avail_z = cat.available.any(axis=2)  # [T, Z]
    t_avail_c = cat.available.any(axis=1)  # [T, C]
    nt = ntype[:n_total]
    zmask[fresh] = t_avail_z[nt[fresh]]
    cmask[fresh] = t_avail_c[nt[fresh]]

    pods_by_node: List[dict] = [dict() for _ in range(n_total)]
    in_range = take_n < n_total
    for g in range(G):
        sel = (take_g == g) & in_range
        if not sel.any():
            continue
        ns = take_n[sel]
        vs = take_v[sel]
        cum[ns] = cum[ns] + vs[:, None].astype(np.float32) * enc.requests[g][None, :].astype(np.float32)
        zmask[ns] &= enc.allow_zone[g]
        cmask[ns] &= enc.allow_cap[g]
        for n, v in zip(ns.tolist(), vs.tolist()):
            pods_by_node[n][g] = v

    nodes: List[VirtualNode] = []
    for i in range(n_total):
        nodes.append(VirtualNode(
            type_idx=int(nt[i]), zone_mask=zmask[i], cap_mask=cmask[i],
            cum=cum[i], pods_by_group=pods_by_node[i],
            banned_groups=existing[i].banned_groups if i < n_existing else None,
            existing_name=existing[i].existing_name if i < n_existing else None))

    unschedulable = {g: int(unsched[g]) for g in range(G) if unsched[g] > 0}
    result = SolveResult(nodes=nodes, unschedulable=unschedulable)
    fi = np.nonzero(fresh)[0]
    if fi.size:
        from .binpack import cheapest_offerings
        result.launches = cheapest_offerings(nt[fi], zmask[fi], cmask[fi],
                                             cat)
    return result


# ---------------------------------------------------------------------------
# the device call
# ---------------------------------------------------------------------------


def _scan_onebuf(dcat: DeviceCatalog, gbuf: torch.Tensor,
                 prior: Optional[torch.Tensor],
                 banned: Optional[torch.Tensor],
                 conflict: Optional[torch.Tensor],
                 nbuf: Optional[torch.Tensor], n_existing: int,
                 n_max: int, cols: tuple, track_conflicts: bool,
                 zone_ovh: bool) -> ScanOut:
    """Unpack gbuf/nbuf by static offsets on the device, synthesize what
    was not shipped, run the scan. With pack_solution, the port of the
    reference's `_solve_onebuf_impl`."""
    dev = gbuf.device
    T, Z, C = dcat.price.shape
    Rk = len(cols)
    Gp = gbuf.shape[0]
    cix = torch.as_tensor(cols, dtype=torch.int64, device=dev)
    alloc_k = dcat.alloc[:, cix]
    requests = gbuf[:, :Rk]
    o = Rk
    counts = gbuf[:, o].to(torch.int32); o += 1
    compat = gbuf[:, o:o + T] > 0; o += T
    allow_zone = gbuf[:, o:o + Z] > 0; o += Z
    allow_cap = gbuf[:, o:o + C] > 0; o += C
    max_per_node = gbuf[:, o].to(torch.int32)
    prior_ = (prior if prior is not None
              else torch.zeros((Gp, 1), dtype=torch.int32, device=dev))
    banned_ = (banned if banned is not None
               else torch.zeros((Gp, 1), dtype=torch.bool, device=dev))
    conflict_ = (conflict if conflict is not None
                 else torch.zeros((Gp, 1), dtype=torch.bool, device=dev))
    zovh_ = (dcat.ovh_z[:, :, cix] if zone_ovh
             else torch.zeros((1, 1, Rk), dtype=torch.float32, device=dev))
    if nbuf is None:
        node_type = torch.zeros(n_max, dtype=torch.int32, device=dev)
        node_cum = torch.zeros((n_max, Rk), dtype=torch.float32, device=dev)
        node_zmask = torch.zeros((n_max, Z), dtype=torch.bool, device=dev)
        node_cmask = torch.zeros((n_max, C), dtype=torch.bool, device=dev)
        node_open = torch.zeros(n_max, dtype=torch.bool, device=dev)
        n_used = 0
    else:
        node_type = nbuf[:, 0].to(torch.int32)
        node_cum = nbuf[:, 1:1 + Rk]
        node_zmask = nbuf[:, 1 + Rk:1 + Rk + Z] > 0
        node_cmask = nbuf[:, 1 + Rk + Z:1 + Rk + Z + C] > 0
        node_open = nbuf[:, 1 + Rk + Z + C] > 0
        # resumed nodes are exactly the open prefix
        n_used = n_existing
    return solve_scan(
        alloc_k, dcat.price, dcat.avail, requests, counts, compat,
        allow_zone, allow_cap, max_per_node, prior_, banned_, conflict_,
        zovh_, node_type, node_cum, node_zmask, node_cmask, node_open,
        n_used, n_max, track_conflicts=track_conflicts, zone_ovh=zone_ovh)


@dataclass
class _Staged:
    """Host-side inputs of one solve, and the uploads that do not depend
    on the node budget."""

    dcat: DeviceCatalog
    Gp: int
    cols: tuple
    track: bool
    zone_ovh: bool
    gbuf: torch.Tensor
    conflict: Optional[torch.Tensor]
    existing: List[VirtualNode]
    node_type: np.ndarray
    node_cum: np.ndarray
    node_zmask: np.ndarray
    node_cmask: np.ndarray
    has_prior: bool
    has_banned: bool


def _stage(cat: CatalogTensors, enc: EncodedPods,
           existing: List[VirtualNode], dev: torch.device,
           dcat: Optional[DeviceCatalog] = None) -> _Staged:
    R = enc.requests.shape[1]
    n_existing = len(existing)
    Gp = _bucket(enc.G, 8)
    if dcat is None or not _dcat_fits(dcat, cat, R, dev):
        dcat = _auto_dcat(cat, R, dev)
    node_type = np.zeros(n_existing, np.int32)
    node_cum = np.zeros((n_existing, R), np.float32)
    node_zmask = np.zeros((n_existing, cat.Z), bool)
    node_cmask = np.zeros((n_existing, cat.C), bool)
    for i, n in enumerate(existing):
        assert len(n.cum) <= R, (
            f"existing node cum has {len(n.cum)} resources but the "
            f"current axis is {R} — the resource axis only grows "
            f"within a process")
        node_type[i] = n.type_idx
        node_cum[i, : len(n.cum)] = n.cum
        node_zmask[i] = n.zone_mask
        node_cmask[i] = n.cap_mask
    track = enc.conflict is not None
    cols = _request_cols(enc, cat)
    # pad group inputs; padded groups have count 0 -> no-ops in the scan
    gbuf = _put(_pack_groups(*_group_inputs(enc, Gp), list(cols)), dev)
    conflict = (_put(_pad_to(_pad_to(enc.conflict, Gp, 0), Gp, 1), dev)
                if track else None)
    return _Staged(dcat=dcat, Gp=Gp, cols=cols, track=track,
                   zone_ovh=dcat.ovh_z is not None, gbuf=gbuf,
                   conflict=conflict, existing=existing,
                   node_type=node_type, node_cum=node_cum,
                   node_zmask=node_zmask, node_cmask=node_cmask,
                   has_prior=any(n.prior_by_group for n in existing),
                   has_banned=any(n.banned_groups is not None
                                  for n in existing))


def _scan(st: _Staged, n_max: int) -> ScanOut:
    """The group scan at one node budget: its outputs, still on the device
    (they do not depend on the sparse budget k_max; only the packing
    does)."""
    dev = st.gbuf.device
    existing, Gp = st.existing, st.Gp
    n_existing = len(existing)
    prior = np.zeros((Gp, n_max if st.has_prior else 1), np.int32)
    banned = np.zeros((Gp, n_max if st.has_banned else 1), bool)
    for i, n in enumerate(existing):
        if st.has_prior:
            for g, cnt in n.prior_by_group.items():
                if g < Gp:
                    prior[g, i] = cnt
        if st.has_banned and n.banned_groups is not None:
            banned[: len(n.banned_groups), i] = n.banned_groups
    nbuf = (None if n_existing == 0 else
            _put(_pack_nodes(_pad_to(st.node_type, n_max),
                             _pad_to(st.node_cum, n_max),
                             _pad_to(st.node_zmask, n_max),
                             _pad_to(st.node_cmask, n_max),
                             _pad_to(np.ones(n_existing, bool), n_max),
                             list(st.cols)), dev))
    return _scan_onebuf(
        st.dcat, st.gbuf, _put(prior, dev) if st.has_prior else None,
        _put(banned, dev) if st.has_banned else None, st.conflict, nbuf,
        n_existing, n_max, st.cols, st.track, st.zone_ovh)


def _dispatch(st: _Staged, n_max: int, k_max: int) -> torch.Tensor:
    """The device call at one (n_max, k_max) budget: the packed int32
    result, still on the device."""
    return pack_solution(*_scan(st, n_max), k_max)


def solve_device(cat: CatalogTensors, enc: EncodedPods,
                 existing: Optional[List[VirtualNode]] = None,
                 n_max: Optional[int] = None,
                 dcat: Optional[DeviceCatalog] = None, device=None,
                 mesh=None) -> SolveResult:
    """Run the solve on `device` (default: the CUDA card) and decode the
    result to the SolveResult solve_host produces. `enc` must be
    spread-free (split_spread_groups).

    dcat: the catalog already on the device (the facade's per-view cache);
    one that cannot serve this solve (too few resource columns, another
    device, zone overhead flipped) is replaced by the process cache's.

    With tracing on, each stage is a span (the reference's names):
    solve.prep (node budget), solve.device_put (staging and uploads),
    solve.dispatch (the scan, enqueued), solve.readback (packing and the
    one host read, which waits for the card), solve.decode."""
    reject_mesh(mesh)
    dev = resolve_device(device)
    assert not enc.spread_zone.any(), "run split_spread_groups before solve"
    existing = existing or []
    n_existing = len(existing)
    total_pods = int(enc.counts.sum())
    auto_n = n_max is None
    if auto_n:
        with _span("solve.prep"):
            n_max = _auto_node_budget(cat, enc, n_existing)
    with _span("solve.device_put"):
        st = _stage(cat, enc, existing, dev, dcat)
    if _dispatch_fault_hook is not None:
        _dispatch_fault_hook("device")
    while True:
        with _span("solve.dispatch"):
            out = _scan(st, n_max)  # ONE scan per node budget
        with _span("solve.readback"):
            # sparse-take budget: nnz ~ n_used + cross-node sharing, far
            # below the [Gp * n_max] flat size
            k_max = _bucket(2 * n_max)
            buf = pack_solution(*out, k_max).cpu().numpy()  # ONE host read
            (nused, overflowed, nnz, unsched, ntype, idx,
             vals) = _parse_packed(buf, st.Gp, n_max, k_max)
            if nnz > k_max:
                # takes were truncated: re-pack the same scan at a larger
                # budget
                k_max = _bucket(nnz)
                buf = pack_solution(*out, k_max).cpu().numpy()
                (nused, overflowed, nnz, unsched, ntype, idx,
                 vals) = _parse_packed(buf, st.Gp, n_max, k_max)
        if not overflowed or not auto_n or n_max >= n_existing + total_pods:
            break
        # node budget too small: regrow it and scan again (the reference's
        # loop)
        n_max = min(_bucket(n_max * 2), _bucket(n_existing + total_pods))

    with _span("solve.decode"):
        res = _decode_solution(cat, enc, existing, st.node_cum,
                               st.node_zmask, st.node_cmask, nused, ntype,
                               idx, vals, nnz, unsched, n_max)
    return _maybe_corrupt("result", res)


def solve_packed(cat: CatalogTensors, enc: EncodedPods,
                 existing: Optional[List[VirtualNode]] = None,
                 n_max: Optional[int] = None, device=None
                 ) -> Tuple[np.ndarray, dict]:
    """The packed int32 vector of solve_device's first device call for
    these inputs, with the statics it used (n_max, k_max, cols, flags, Gp)
    — the seam the parity tests hold against the reference's
    `_solve_onebuf` output."""
    dev = resolve_device(device)
    existing = existing or []
    if n_max is None:
        n_max = _auto_node_budget(cat, enc, len(existing))
    st = _stage(cat, enc, existing, dev)
    k_max = _bucket(2 * n_max)
    statics = dict(n_max=n_max, k_max=k_max, cols=st.cols,
                   track_conflicts=st.track, zone_ovh=st.zone_ovh, Gp=st.Gp)
    return _dispatch(st, n_max, k_max).cpu().numpy(), statics
