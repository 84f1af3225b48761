"""The provisioning solve's group scan: kernels B0 and B
(`csrc/solve_scan.cu`) and their plain PyTorch versions, plus the packing
of the scan's output into the reference's single int32 result vector.

Replaces the XLA program `karpenter_tpu/ops/solver.py::_solve_kernel` (a
`lax.scan` over pod groups) and the packing tail of `_solve_onebuf_impl`.

The reference's step 2 (the cost-per-slot argmin that picks the offering
new nodes open at) reads only the group's row and the catalog, never node
state, so it is hoisted out of the scan: kernel B0 (`offer_argmin`) runs
it for every group at once, one block per group. Kernel B (`solve_scan`)
then runs the dependent chain of group steps as one thread-block cluster
whose node state stays in the blocks' shared memory (`_scan_layout` picks
the cluster size and slice; past the cluster's capacity the slices live in
global scratch, the same kernel code through a pointer).

Both kernels take a request axis (the port of `_solve_batched_impl`, a
`jax.vmap` of the scan over requests): `solve_scan_batched` runs a bucket
of Bp requests that share one catalog as ONE launch of B0 and ONE of B,
one cluster per request, and `pack_solution_batched` packs its rows. The
serial `solve_scan` is the same launch at Bp = 1.

`solve_scan`, `solve_scan_batched` and `offer_argmin` take the plain
version for CPU tensors and launch the kernels for CUDA tensors; there is
no fallback between the two.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .binpack import BIG, EPS

# launches since import (chip_smoke resets and reads): one a launch,
# whatever the number of requests it serves
launches = 0        # kernel B
offer_launches = 0  # kernel B0

_EPS = float(np.float32(EPS))
_F32_MAX = float(np.finfo(np.float32).max)

ScanOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]
OfferOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def offer_argmin_plain(alloc, price, avail, requests, compat, allow_zone,
                       allow_cap, max_per_node, zovh,
                       zone_ovh: bool = False) -> OfferOut:
    """The reference's step 2 (`solver.py:425-448`) for every group at once,
    vectorised over [Gp, T, Z, C]. Returns (t_star i64 [Gp], s i64 [Gp] =
    max(slots[t_star], 1), ok bool [Gp] = best cost-per-slot < f32 max,
    t_avail_z bool [Gp, Z], t_avail_c bool [Gp, C]); the scan opens nodes
    only where ok and the group has pods left."""
    dev = alloc.device
    T, Z, C = price.shape
    Gp = requests.shape[0]
    big_f = torch.tensor(float(BIG), dtype=torch.float32, device=dev)
    f32_max = torch.tensor(_F32_MAX, dtype=torch.float32, device=dev)
    cap_per = torch.where(max_per_node == 0, BIG,
                          max_per_node).to(torch.int64)             # [Gp]
    with_req = torch.where(requests > 0, requests, torch.ones_like(requests))
    alloc_eff = alloc[None]                                         # [1, T, R]
    if zone_ovh:
        zm_open = allow_zone[:, None, :] & avail.any(dim=2)[None]   # [Gp, T, Z]
        alloc_eff = alloc[None] - torch.where(
            zm_open[..., None], zovh[None], 0.0).amax(dim=2)        # [Gp, T, R]
    slots = torch.where(requests[:, None, :] > 0,
                        torch.floor(alloc_eff / with_req[:, None, :] + _EPS),
                        big_f).amin(dim=2)                          # [Gp, T]
    slots = torch.minimum(slots.clamp_min(0.0).to(torch.int64),
                          cap_per[:, None])
    adm = (avail[None] & compat[:, :, None, None]
           & allow_zone[:, None, :, None] & allow_cap[:, None, None, :])
    feasible = adm & (slots >= 1)[:, :, None, None]                 # [Gp, T, Z, C]
    cps = torch.where(feasible,
                      price[None] / slots.clamp_min(1)[:, :, None, None]
                      .to(torch.float32),
                      f32_max).reshape(Gp, -1)
    flat = torch.argmin(cps, dim=1)            # the first index of the minimum
    best = cps.gather(1, flat[:, None])[:, 0]
    t_star = flat // (Z * C)
    s = slots.gather(1, t_star[:, None])[:, 0].clamp_min(1)
    return (t_star, s, best < f32_max, avail[t_star].any(dim=2),
            avail[t_star].any(dim=1))


def solve_scan_plain(alloc, price, avail, requests, counts, compat,
                     allow_zone, allow_cap, max_per_node, prior, banned,
                     conflict, zovh, node_type, node_cum, node_zmask,
                     node_cmask, node_open, n_used: int, n_max: int,
                     track_conflicts: bool = False,
                     zone_ovh: bool = False) -> ScanOut:
    """A Python loop over groups that mirrors the reference's scan `step`
    line by line, with step 2's argmin taken from offer_argmin_plain.
    Returns (ntype i32 [n_max], takes i32 [Gp, n_max], unsched i32 [Gp],
    nused i32 [], overflow bool []).

    The one deliberate difference: the first-fit prefix runs in int64
    where the reference's runs in f32. The f32 prefix is exact below 2^24,
    and above it the take is already clamped to zero, so both give the same
    takes (an int64 prefix can neither round nor wrap)."""
    dev = alloc.device
    Gp = requests.shape[0]
    node_ids = torch.arange(n_max, device=dev)
    ntype = node_type.to(torch.int64).clone()
    cum = node_cum.clone()
    zmask = node_zmask.clone()
    cmask = node_cmask.clone()
    nopen = node_open.clone()
    nused = torch.tensor(n_used, dtype=torch.int64, device=dev)
    hosted = torch.zeros((n_max, Gp if track_conflicts else 1), dtype=torch.bool,
                         device=dev)
    takes = torch.zeros((Gp, n_max), dtype=torch.int32, device=dev)
    unsched = torch.zeros(Gp, dtype=torch.int32, device=dev)
    clamped_any = torch.zeros((), dtype=torch.bool, device=dev)
    big_f = torch.tensor(float(BIG), dtype=torch.float32, device=dev)
    t_stars, slots_s, oks, t_zs, t_cs = offer_argmin_plain(
        alloc, price, avail, requests, compat, allow_zone, allow_cap,
        max_per_node, zovh, zone_ovh)

    for g in range(Gp):
        req = requests[g]
        count = counts[g].to(torch.int64)
        gcompat, gzone, gcap = compat[g], allow_zone[g], allow_cap[g]
        cap_per = torch.where(max_per_node[g] == 0, BIG,
                              max_per_node[g]).to(torch.int64)
        prior_n, banned_n, conf_g = prior[g], banned[g], conflict[g]

        # --- 1. fill existing nodes (vectorized first-fit) ---
        zmask2 = zmask & gzone[None, :]                             # [N, Z]
        cmask2 = cmask & gcap[None, :]                              # [N, C]
        talloc = alloc[ntype]                                       # [N, R]
        if zone_ovh:
            ovh_n = torch.where(zmask2[:, :, None], zovh[ntype],
                                0.0).amax(dim=1)                    # [N, R]
            talloc = talloc - ovh_n
        headroom = talloc - cum
        with_req = torch.where(req > 0, req, torch.ones_like(req))
        k_cap = torch.where(req > 0, torch.floor(headroom / with_req + _EPS),
                            big_f).amin(dim=1)
        k_cap = k_cap.clamp_min(0.0).to(torch.int64)                # [N]
        off_ok = (zmask2[:, :, None] & cmask2[:, None, :]
                  & avail[ntype]).any(dim=2).any(dim=1)
        eligible = nopen & gcompat[ntype] & off_ok & ~banned_n
        if track_conflicts:
            eligible &= ~(hosted & conf_g[None, :]).any(dim=1)
        cap_eff = (cap_per - prior_n).clamp_min(0)
        k = torch.where(eligible, torch.minimum(k_cap, cap_eff), 0)
        kf = torch.minimum(k, count)
        prefix = torch.cumsum(kf, 0) - kf
        take = torch.minimum(kf, count - prefix).clamp_min(0)       # [N]
        placed = torch.minimum(take.sum(), count)
        rem = count - placed

        got = take > 0
        cum = cum + take[:, None].to(torch.float32) * req[None, :]
        zmask = torch.where(got[:, None], zmask2, zmask)
        cmask = torch.where(got[:, None], cmask2, cmask)

        # --- 2. open new nodes at the cost-per-slot argmin offering ---
        t_star, s = t_stars[g], slots_s[g]
        schedulable = oks[g] & (rem > 0)
        n_new_want = torch.where(schedulable, (rem + s - 1) // s, 0)
        n_new = torch.minimum(n_new_want, (n_max - nused).clamp_min(0))
        clamped = n_new < n_new_want
        new_pos = node_ids - nused
        is_new = (new_pos >= 0) & (new_pos < n_new)
        pods_on = torch.minimum((rem - new_pos * s).clamp_min(0), s)
        new_take = torch.where(is_new, pods_on, 0)
        overflow = torch.where(schedulable,
                               (rem - new_take.sum()).clamp_min(0), 0)

        ntype = torch.where(is_new, t_star, ntype)
        cum = torch.where(is_new[:, None],
                          new_take[:, None].to(torch.float32) * req[None, :],
                          cum)
        zmask = torch.where(is_new[:, None], (gzone & t_zs[g])[None, :],
                            zmask)
        cmask = torch.where(is_new[:, None], (gcap & t_cs[g])[None, :],
                            cmask)
        nopen = nopen | is_new
        nused = nused + n_new

        unsched[g] = torch.where(schedulable, overflow, rem).to(torch.int32)
        g_take = take + new_take
        takes[g] = g_take.to(torch.int32)
        if track_conflicts:
            hosted[:, g] |= g_take > 0
        clamped_any |= clamped
    return (ntype.to(torch.int32), takes, unsched, nused.to(torch.int32),
            clamped_any)


# ---------------------------------------------------------------------------
# kernel B's layout: cluster size, node slice, where the slices live
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448     # shared memory one block may use on an H100
STATIC_SMEM = 1_024      # kernel B's static shared arrays, rounded up
CL_MAX = 16              # the largest (non-portable) cluster on Hopper
NODES_PER_BLOCK = 512    # one node for each of kernel B's 512 threads
REC_HDR = 12             # int32 header words of B0's per-group record


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


@dataclass(frozen=True)
class ScanLayout:
    """How kernel B is launched for one problem size."""

    cl: int            # blocks in the cluster (1, 2, 4, 8 or 16)
    slice: int         # nodes each block owns (the last block may own fewer)
    nodes_smem: bool   # node slices in shared memory (else global scratch)
    cat_smem: bool     # catalog rows in shared memory (else read in place)
    smem_bytes: int    # dynamic shared memory per block
    slab_bytes: int    # bytes of one block's node slice
    rec_words: int     # int32 words of one group record (a multiple of 4)


def _rec_words(Rk: int, T: int, W: int) -> int:
    """Words of B0's record: header, req[Rk], compat bits, conflict words,
    padded to whole 16-byte chunks (the scan prefetches it with cp.async)."""
    return _round_up(REC_HDR + Rk + -(-T // 32) + W, 4)


def _scan_layout(n_max: int, Rk: int, W: int, Z: int, C: int, T: int,
                 zone_ovh: bool = False) -> ScanLayout:
    """Kernel B's cluster size and node slice, from sizes alone.

    Per block: two group records (the cp.async double buffer), the catalog
    rows (alloc, availability bits, zone overhead) when they take at most
    half the block's shared memory, and the node slice at 12 + 4*Rk + 4*W
    bytes a node (type, zone|captype bits, kf scratch, cum, hosted words).
    The cluster is the smallest power of two that both holds the node state
    and gives each block at most NODES_PER_BLOCK nodes, up to CL_MAX. Past
    CL_MAX blocks' capacity the slices live in global scratch (CL_MAX
    blocks). The cluster only grows with n_max."""
    budget = SMEM_LIMIT - STATIC_SMEM
    rec = _rec_words(Rk, T, W)
    fixed = 2 * rec * 4
    cat = _round_up(T * 8 + T * Rk * 4 + (T * Z * Rk * 4 if zone_ovh else 0),
                    16)
    if fixed > budget:
        raise ValueError(f"solve_scan: a group record of {rec} words does not "
                         f"fit in shared memory (T={T})")
    cat_smem = fixed + cat <= budget // 2
    base = fixed + (cat if cat_smem else 0)
    node_bytes = 12 + 4 * Rk + 4 * W
    cap = (budget - base) // node_bytes           # nodes one block can hold
    cl_par = 1
    while cl_par < CL_MAX and cl_par * NODES_PER_BLOCK < n_max:
        cl_par *= 2
    cl_fit = 1
    while cl_fit <= CL_MAX and cl_fit * cap < n_max:
        cl_fit *= 2
    nodes_smem = cl_fit <= CL_MAX
    cl = max(cl_par, cl_fit) if nodes_smem else CL_MAX
    S = _round_up(-(-max(n_max, 1) // cl), 4)
    slab = _round_up(S * node_bytes, 16)
    smem = base + (slab if nodes_smem else 0)
    return ScanLayout(cl=cl, slice=S, nodes_smem=nodes_smem,
                      cat_smem=cat_smem, smem_bytes=smem, slab_bytes=slab,
                      rec_words=rec)


# ---------------------------------------------------------------------------
# the CUDA wrappers
# ---------------------------------------------------------------------------

_fns: dict = {}  # the configured ctypes entry points, once loaded


def _lib():
    if _fns:
        return _fns
    from ._build import load
    lib = load("solve_scan")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    b0 = lib.offer_argmin_launch
    b0.argtypes = ([P] * 5 + [L, I] + [P] * 6 + [I, P, I, P, I, P, I, P]
                   + [I] * 7 + [P])
    b0.restype = ctypes.c_int
    b = lib.solve_scan_launch
    b.argtypes = ([P] * 4 + [I, P, I, P, I, P, P, I] + [P] * 8 + [L]
                  + [I] * 15 + [P])
    b.restype = ctypes.c_int
    mc = lib.solve_scan_max_cluster
    mc.argtypes, mc.restype = [I], ctypes.c_int
    _fns.update(offer=b0, scan=b, max_cluster=mc)
    return _fns


def max_cluster(smem_bytes: int) -> int:
    """The largest cluster of kernel B (a power of two <= CL_MAX) the card
    can co-schedule at `smem_bytes` of shared memory a block; 0 if none."""
    return int(_lib()["max_cluster"](int(smem_bytes)))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check_shapes(alloc, price, requests):
    """Sizes of a bucket: requests is [Bp, Gp, Rk]."""
    T, Z, C = price.shape
    Bp, Gp, Rk = requests.shape
    if Rk < 1 or Rk > 32:
        raise ValueError(f"solve_scan supports 1..32 resource columns, got {Rk}")
    if Z > 31 or C > 31 or Z * C > 64 or Z + C > 32:
        raise ValueError(f"solve_scan supports Z*C <= 64 offerings per type "
                         f"and Z + C <= 32, got Z={Z}, C={C}")
    if T < 1 or Gp < 1 or Bp < 1 or Bp > 65535:
        raise ValueError(f"solve_scan needs T >= 1, Gp >= 1 and 1 <= Bp <= "
                         f"65535, got {T}, {Gp}, {Bp}")
    if tuple(alloc.shape) != (T, Rk):
        raise ValueError(f"solve_scan shapes: alloc {tuple(alloc.shape)}, "
                         f"Rk {Rk}")
    return T, Z, C, Bp, Gp, Rk


def _on(x: torch.Tensor, dev: torch.device, dtype,
        rows: bool = False) -> torch.Tensor:
    """x as `dtype`, contiguous, on the kernels' device; with rows=True only
    its columns need unit stride (a row-strided view of a packed upload is
    taken as it is). A tensor whose type and layout fit is not copied."""
    if x.device != dev:
        raise ValueError("solve_scan inputs must share one CUDA device")
    x = x.to(dtype)
    if rows and x.stride(-1) == 1:
        return x
    return x.contiguous()


def _offer_table(alloc, price, avail, requests, counts, compat, allow_zone,
                 allow_cap, max_per_node, prior, banned, conflict, zovh,
                 zone_ovh: bool, track: bool):
    """Launch kernel B0 once over a bucket (group inputs [Bp, Gp, ...]):
    ([Bp, Gp, rec_words] int32 records, [T] int64 availability bits, W).
    Inputs are taken as they come where their type and layout already fit
    (no copies, no bit-packing on the host side)."""
    global offer_launches
    dev = alloc.device
    T, Z, C, Bp, Gp, Rk = _check_shapes(alloc, price, requests)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def c(x, dtype):
        return _on(x, dev, dtype)

    alloc_c, price_c, avail_c = c(alloc, f32), c(price, f32), c(avail, b8)
    zovh_c = c(zovh, f32) if zone_ovh else None
    if zovh_c is not None and tuple(zovh_c.shape) != (T, Z, Rk):
        raise ValueError(f"zovh shape {tuple(zovh_c.shape)} != {(T, Z, Rk)}")
    req_c = _on(requests, dev, f32, rows=True)
    prior_c, banned_c = c(prior, i32), c(banned, b8)
    conf_c = c(conflict, b8) if track else None
    if conf_c is not None and tuple(conf_c.shape) != (Bp, Gp, Gp):
        raise ValueError(f"conflict shape {tuple(conf_c.shape)} != "
                         f"{(Bp, Gp, Gp)}")
    W = -(-Gp // 32) if track else 0
    RW = _rec_words(Rk, T, W)
    if T * 4 > SMEM_LIMIT:
        raise ValueError(f"offer_argmin supports T <= {SMEM_LIMIT // 4}")
    recs = torch.empty((Bp, Gp, RW), dtype=i32, device=dev)
    availbits = torch.empty(T, dtype=torch.int64, device=dev)
    rc = _lib()["offer"](
        _ptr(alloc_c), _ptr(price_c), _ptr(avail_c), _ptr(zovh_c),
        _ptr(req_c), req_c.stride(0), req_c.stride(1), _ptr(c(counts, i32)),
        _ptr(c(compat, b8)), _ptr(c(allow_zone, b8)), _ptr(c(allow_cap, b8)),
        _ptr(c(max_per_node, i32)), _ptr(prior_c), prior_c.shape[2],
        _ptr(banned_c), banned_c.shape[2], _ptr(conf_c), Gp if track else 0,
        _ptr(recs), RW, _ptr(availbits), T, Z, C, Rk, Gp, W, Bp,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"offer_argmin launch failed: cudaError {rc}")
    offer_launches += 1
    return recs, availbits, W


def offer_argmin_batched_cuda(alloc, price, avail, requests, compat,
                              allow_zone, allow_cap, max_per_node, zovh,
                              zone_ovh: bool = False) -> OfferOut:
    """Launch kernel B0 once over a bucket (group inputs [Bp, Gp, ...]) and
    read its records back as offer_argmin_plain's tuple, each with a
    leading request axis (what the scan itself reads is the record
    table)."""
    dev = alloc.device
    T, Z, C = price.shape
    Bp, Gp = requests.shape[:2]
    zeros_i = torch.zeros((Bp, Gp, 1), dtype=torch.int32, device=dev)
    zeros_b = torch.zeros((Bp, Gp, 1), dtype=torch.bool, device=dev)
    recs, _, _ = _offer_table(
        alloc, price, avail, requests,
        torch.zeros((Bp, Gp), dtype=torch.int32, device=dev), compat,
        allow_zone, allow_cap, max_per_node, zeros_i, zeros_b, zeros_b, zovh,
        zone_ovh, False)
    recs = recs.to(torch.int64)
    tbits = recs[..., 6]
    zs = torch.arange(Z, device=dev)
    cs = torch.arange(C, device=dev)
    return (recs[..., 3], recs[..., 4], recs[..., 5] != 0,
            ((tbits[..., None] >> zs) & 1) != 0,
            ((tbits[..., None] >> (Z + cs)) & 1) != 0)


def offer_argmin_cuda(alloc, price, avail, requests, compat, allow_zone,
                      allow_cap, max_per_node, zovh,
                      zone_ovh: bool = False) -> OfferOut:
    """Kernel B0 for one request: the batched launch at Bp = 1."""
    out = offer_argmin_batched_cuda(
        alloc, price, avail, requests[None], compat[None], allow_zone[None],
        allow_cap[None], max_per_node[None], zovh, zone_ovh)
    return tuple(x[0] for x in out)


def offer_argmin(*args, **kwargs) -> OfferOut:
    """Step 2 for every group: the plain version for CPU tensors, kernel B0
    for CUDA tensors (arguments as offer_argmin_plain)."""
    dev = args[0].device if args else kwargs["alloc"].device
    if dev.type == "cpu":
        return offer_argmin_plain(*args, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"offer_argmin runs on cpu or cuda, not {dev}")
    return offer_argmin_cuda(*args, **kwargs)


def solve_scan_batched_cuda(alloc, price, avail, requests, counts, compat,
                            allow_zone, allow_cap, max_per_node, prior,
                            banned, conflict, zovh, node_type, node_cum,
                            node_zmask, node_cmask, node_open, n_used: int,
                            n_max: int, track_conflicts: bool = False,
                            zone_ovh: bool = False,
                            layout: Optional[ScanLayout] = None) -> ScanOut:
    """ONE launch of kernel B0 and ONE of kernel B over a bucket of Bp
    requests on the current stream (no synchronisation): B runs one
    cluster per request. Arguments as solve_scan_batched_plain; `layout`
    overrides `_scan_layout`'s choice (to time another cluster size)."""
    global launches
    dev = alloc.device
    T, Z, C, Bp, Gp, Rk = _check_shapes(alloc, price, requests)
    if tuple(node_cum.shape) != (n_max, Rk):
        raise ValueError(f"node_cum shape {tuple(node_cum.shape)} != "
                         f"{(n_max, Rk)}")
    if prior.shape[2] not in (1, n_max) or banned.shape[2] not in (1, n_max):
        raise ValueError("prior/banned must be [Bp, Gp, 1] or "
                         "[Bp, Gp, n_max]")
    recs, availbits, W = _offer_table(
        alloc, price, avail, requests, counts, compat, allow_zone, allow_cap,
        max_per_node, prior, banned, conflict, zovh, zone_ovh,
        track_conflicts)
    lay = layout or _scan_layout(n_max, Rk, W, Z, C, T, zone_ovh)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    alloc_c = _on(alloc, dev, f32)
    zovh_c = _on(zovh, dev, f32) if zone_ovh else None
    prior_c, banned_c = _on(prior, dev, i32), _on(banned, dev, b8)
    ntype_in = _on(node_type, dev, i32)
    cum_in = _on(node_cum, dev, f32, rows=True)
    zm_in, cm_in, open_in = (_on(node_zmask, dev, b8),
                             _on(node_cmask, dev, b8), _on(node_open, dev, b8))
    ntype = torch.empty((Bp, n_max), dtype=i32, device=dev)
    takes = torch.empty((Bp, Gp, n_max), dtype=i32, device=dev)
    unsched = torch.empty((Bp, Gp), dtype=i32, device=dev)
    hdr = torch.empty((Bp, 2), dtype=i32, device=dev)
    scratch = (None if lay.nodes_smem else
               torch.empty(Bp * lay.cl * lay.slab_bytes, dtype=torch.uint8,
                           device=dev))
    rc = _lib()["scan"](
        _ptr(alloc_c), _ptr(availbits), _ptr(zovh_c), _ptr(recs),
        lay.rec_words, _ptr(prior_c), prior_c.shape[2], _ptr(banned_c),
        banned_c.shape[2], _ptr(ntype_in), _ptr(cum_in), cum_in.stride(0),
        _ptr(zm_in), _ptr(cm_in), _ptr(open_in), _ptr(ntype), _ptr(takes),
        _ptr(unsched), _ptr(hdr), _ptr(scratch), lay.slab_bytes,
        T, Z, C, Rk, W, Gp, n_max, int(n_used), lay.slice,
        int(lay.cat_smem), int(track_conflicts), lay.cl, lay.smem_bytes,
        int(lay.nodes_smem), Bp, torch.cuda.current_stream(dev).cuda_stream)
    if rc == -2:
        raise RuntimeError(f"solve_scan: the card cannot co-schedule a "
                           f"cluster of {lay.cl} blocks at {lay.smem_bytes} "
                           f"bytes of shared memory a block")
    if rc != 0:
        raise RuntimeError(f"solve_scan launch failed: cudaError {rc} "
                           f"(layout {lay}, Bp {Bp})")
    launches += 1
    return ntype, takes, unsched, hdr[:, 0], hdr[:, 1] != 0


def solve_scan_cuda(alloc, price, avail, requests, counts, compat,
                    allow_zone, allow_cap, max_per_node, prior, banned,
                    conflict, zovh, node_type, node_cum, node_zmask,
                    node_cmask, node_open, n_used: int, n_max: int,
                    track_conflicts: bool = False, zone_ovh: bool = False,
                    layout: Optional[ScanLayout] = None) -> ScanOut:
    """Kernels B0 and B for one request: the batched launch at Bp = 1.
    Same arguments and results as solve_scan_plain."""
    out = solve_scan_batched_cuda(
        alloc, price, avail, requests[None], counts[None], compat[None],
        allow_zone[None], allow_cap[None], max_per_node[None], prior[None],
        banned[None], conflict[None], zovh, node_type, node_cum, node_zmask,
        node_cmask, node_open, n_used, n_max, track_conflicts, zone_ovh,
        layout)
    return tuple(x[0] for x in out)


def solve_scan(*args, **kwargs) -> ScanOut:
    """The group scan: the plain version for CPU tensors, kernels B0 and B
    for CUDA tensors (arguments as solve_scan_plain)."""
    dev = args[0].device if args else kwargs["alloc"].device
    if dev.type == "cpu":
        return solve_scan_plain(*args, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"solve_scan runs on cpu or cuda, not {dev}")
    return solve_scan_cuda(*args, **kwargs)


def solve_scan_batched_plain(alloc, price, avail, requests, counts, compat,
                             allow_zone, allow_cap, max_per_node, prior,
                             banned, conflict, zovh, node_type, node_cum,
                             node_zmask, node_cmask, node_open, n_used: int,
                             n_max: int, track_conflicts: bool = False,
                             zone_ovh: bool = False) -> ScanOut:
    """The scan over a bucket: solve_scan_plain on each request's rows (the
    reference's `jax.vmap`). Group inputs carry a leading request axis
    [Bp, Gp, ...]; the catalog and the starting node state are shared.
    Returns (ntype [Bp, n_max], takes [Bp, Gp, n_max], unsched [Bp, Gp],
    nused [Bp], overflow [Bp])."""
    rows = [solve_scan_plain(
        alloc, price, avail, requests[b], counts[b], compat[b],
        allow_zone[b], allow_cap[b], max_per_node[b], prior[b], banned[b],
        conflict[b], zovh, node_type, node_cum, node_zmask, node_cmask,
        node_open, n_used, n_max, track_conflicts, zone_ovh)
        for b in range(requests.shape[0])]
    return tuple(torch.stack(x) for x in zip(*rows))


def solve_scan_batched(*args, **kwargs) -> ScanOut:
    """The scan over a bucket of requests: the plain version for CPU
    tensors, one launch each of kernels B0 and B for CUDA tensors
    (arguments as solve_scan_batched_plain)."""
    dev = args[0].device if args else kwargs["alloc"].device
    if dev.type == "cpu":
        return solve_scan_batched_plain(*args, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"solve_scan runs on cpu or cuda, not {dev}")
    return solve_scan_batched_cuda(*args, **kwargs)


def pack_solution(ntype: torch.Tensor, takes: torch.Tensor,
                  unsched: torch.Tensor, nused: torch.Tensor,
                  overflow: torch.Tensor, k_max: int) -> torch.Tensor:
    """One int32 vector in the reference's layout
    (`_solve_kernel_packed_impl`):

        [n_used, overflow, nnz | unsched[Gp] | ntype[n_max]
         | idx[k_max] | vals[k_max]]

    idx are the flat indices g * n_max + n of the nonzero takes in
    ascending order, zero-filled past nnz; vals = flat[idx], so a filled
    slot repeats flat[0] exactly as jnp.nonzero(size=, fill_value=0)
    followed by a gather does. nnz counts every nonzero take even past
    k_max (the caller re-packs the same scan output at a larger budget).
    Compaction is a cumsum of flat > 0 and a scatter, all on the device
    with no host sync: pack_solution_batched at a bucket of one."""
    return pack_solution_batched(ntype[None], takes[None], unsched[None],
                                 nused.reshape(1), overflow.reshape(1),
                                 k_max)[0]


def pack_solution_batched(ntype: torch.Tensor, takes: torch.Tensor,
                          unsched: torch.Tensor, nused: torch.Tensor,
                          overflow: torch.Tensor, k_max: int) -> torch.Tensor:
    """pack_solution for each request of a bucket: [Bp, L] int32, row b the
    vector pack_solution makes of request b's scan output (the reference's
    vmapped onebuf tail). A row-wise cumsum and scatter on the device, no
    host sync."""
    dev = takes.device
    Bp = takes.shape[0]
    flat = takes.reshape(Bp, -1)
    pos = flat > 0
    nnz = pos.sum(dim=1)
    rank = torch.cumsum(pos, 1) - 1
    slot = torch.where(pos & (rank < k_max), rank, k_max)  # k_max = discard
    idx = torch.zeros((Bp, k_max + 1), dtype=torch.int64, device=dev)
    idx.scatter_(1, slot, torch.arange(flat.shape[1], device=dev)
                 .expand(Bp, -1))
    idx = idx[:, :k_max]
    vals = flat.gather(1, idx)
    head = torch.stack([nused.to(torch.int64), overflow.to(torch.int64), nnz],
                       dim=1)
    return torch.cat([head.to(torch.int32), unsched.to(torch.int32),
                      ntype.to(torch.int32), idx.to(torch.int32),
                      vals.to(torch.int32)], dim=1)
