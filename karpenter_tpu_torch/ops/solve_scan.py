"""The provisioning solve's group scan: kernel B (`csrc/solve_scan.cu`) and
its plain PyTorch version, plus the packing of the scan's output into the
reference's single int32 result vector.

Replaces the XLA program `karpenter_tpu/ops/solver.py::_solve_kernel` (a
`lax.scan` over pod groups) and the packing tail of `_solve_onebuf_impl`.
Eager PyTorch would issue ~40 small launches per group step; kernel B runs
the whole scan in one launch, one thread block per solve looping over the
groups in order. What bounds it is that dependent chain of steps, not
bytes or arithmetic rate (see PERF.md).

`solve_scan` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .binpack import BIG, EPS

launches = 0  # kernel launches since import (chip_smoke resets and reads it)

_EPS = float(np.float32(EPS))
_F32_MAX = float(np.finfo(np.float32).max)

ScanOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def solve_scan_plain(alloc, price, avail, requests, counts, compat,
                     allow_zone, allow_cap, max_per_node, prior, banned,
                     conflict, zovh, node_type, node_cum, node_zmask,
                     node_cmask, node_open, n_used: int, n_max: int,
                     track_conflicts: bool = False,
                     zone_ovh: bool = False) -> ScanOut:
    """A Python loop over groups that mirrors the reference's scan `step`
    line by line. Returns (ntype i32 [n_max], takes i32 [Gp, n_max],
    unsched i32 [Gp], nused i32 [], overflow bool []).

    The one deliberate difference: the first-fit prefix runs in int64
    where the reference's runs in f32. The f32 prefix is exact below 2^24,
    and above it the take is already clamped to zero, so both give the same
    takes (an int64 prefix can neither round nor wrap)."""
    dev = alloc.device
    T, Z, C = price.shape
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
    avail_z_any = avail.any(dim=2)                                  # [T, Z]
    big_f = torch.tensor(float(BIG), dtype=torch.float32, device=dev)
    f32_max = torch.tensor(_F32_MAX, dtype=torch.float32, device=dev)

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
        adm = (avail & gcompat[:, None, None] & gzone[None, :, None]
               & gcap[None, None, :])                               # [T, Z, C]
        alloc_eff = alloc
        if zone_ovh:
            zm_open = gzone[None, :] & avail_z_any                  # [T, Z]
            alloc_eff = alloc - torch.where(zm_open[:, :, None], zovh,
                                            0.0).amax(dim=1)
        slots_t = torch.where(req > 0,
                              torch.floor(alloc_eff / with_req[None, :] + _EPS),
                              big_f).amin(dim=1)
        slots_t = torch.minimum(slots_t.clamp_min(0.0).to(torch.int64),
                                cap_per)                            # [T]
        feasible = adm & (slots_t[:, None, None] >= 1)
        cps = torch.where(feasible,
                          price / slots_t.clamp_min(1)[:, None, None]
                          .to(torch.float32),
                          f32_max)
        flat = torch.argmin(cps.reshape(-1))
        best_cps = cps.reshape(-1)[flat]
        t_star = flat // (Z * C)
        schedulable = (best_cps < f32_max) & (rem > 0)

        s = slots_t[t_star].clamp_min(1)
        n_new_want = torch.where(schedulable, (rem + s - 1) // s, 0)
        n_new = torch.minimum(n_new_want, (n_max - nused).clamp_min(0))
        clamped = n_new < n_new_want
        new_pos = node_ids - nused
        is_new = (new_pos >= 0) & (new_pos < n_new)
        pods_on = torch.minimum((rem - new_pos * s).clamp_min(0), s)
        new_take = torch.where(is_new, pods_on, 0)
        overflow = torch.where(schedulable,
                               (rem - new_take.sum()).clamp_min(0), 0)

        t_avail_z = avail[t_star].any(dim=1)                        # [Z]
        t_avail_c = avail[t_star].any(dim=0)                        # [C]
        ntype = torch.where(is_new, t_star, ntype)
        cum = torch.where(is_new[:, None],
                          new_take[:, None].to(torch.float32) * req[None, :],
                          cum)
        zmask = torch.where(is_new[:, None], (gzone & t_avail_z)[None, :],
                            zmask)
        cmask = torch.where(is_new[:, None], (gcap & t_avail_c)[None, :],
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


def _bits(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., K] (K <= 63) -> int64 [...] with bit k set where mask[k]."""
    K = mask.shape[-1]
    w = torch.ones(K, dtype=torch.int64, device=mask.device) << torch.arange(
        K, device=mask.device)
    return (mask.to(torch.int64) * w).sum(dim=-1)


def _word_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool [G, K] -> int32 [G, ceil(K/32)] bit sets (bit k%32 of word k//32),
    the two's-complement view of each uint32 word."""
    G, K = mask.shape
    W = max(1, -(-K // 32))
    padded = torch.zeros((G, W * 32), dtype=torch.bool, device=mask.device)
    padded[:, :K] = mask
    words = _bits(padded.reshape(G, W, 32))
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).contiguous()


_fn = None  # the configured ctypes entry point, once loaded


def _lib():
    global _fn
    if _fn is not None:
        return _fn
    from ._build import load
    lib = load("solve_scan")
    fn = lib.solve_scan_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 10 + [P, I, P, I, P, I] + [P] * 9 + [I] * 7 + [P])
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def solve_scan_cuda(alloc, price, avail, requests, counts, compat,
                    allow_zone, allow_cap, max_per_node, prior, banned,
                    conflict, zovh, node_type, node_cum, node_zmask,
                    node_cmask, node_open, n_used: int, n_max: int,
                    track_conflicts: bool = False,
                    zone_ovh: bool = False) -> ScanOut:
    """Launch kernel B on the current stream (no synchronisation). Same
    arguments and results as solve_scan_plain."""
    global launches
    dev = alloc.device
    T, Z, C = price.shape
    Gp, Rk = requests.shape
    if Rk < 1 or Rk > 32:
        raise ValueError(f"solve_scan supports 1..32 resource columns, got {Rk}")
    if Z > 31 or C > 31 or Z * C > 64:
        raise ValueError(f"solve_scan supports Z*C <= 64 offerings per type, "
                         f"got Z={Z}, C={C}")
    if tuple(alloc.shape) != (T, Rk) or tuple(node_cum.shape) != (n_max, Rk):
        raise ValueError(f"solve_scan shapes: alloc {tuple(alloc.shape)}, "
                         f"node_cum {tuple(node_cum.shape)}, Rk {Rk}")
    f32, i32 = torch.float32, torch.int32

    def c(x, dtype):
        if x.device != dev:
            raise ValueError("solve_scan inputs must share one CUDA device")
        return x.to(dtype).contiguous()

    alloc_c = c(alloc, f32)
    price_c = c(price, f32).reshape(-1)
    availbits = _bits(c(avail, torch.bool).reshape(T, Z * C))
    zovh_c = c(zovh, f32) if zone_ovh else None
    if zovh_c is not None and tuple(zovh_c.shape) != (T, Z, Rk):
        raise ValueError(f"zovh shape {tuple(zovh_c.shape)} != {(T, Z, Rk)}")
    req_c = c(requests, f32)
    counts_c = c(counts, i32)
    compat_c = c(compat, torch.bool)
    gzone = _bits(c(allow_zone, torch.bool)).to(i32)
    gcap = _bits(c(allow_cap, torch.bool)).to(i32)
    maxpn = c(max_per_node, i32)
    prior_c = c(prior, i32)
    banned_c = c(banned, torch.bool)
    if prior_c.shape[1] not in (1, n_max) or banned_c.shape[1] not in (1, n_max):
        raise ValueError("prior/banned must be [Gp, 1] or [Gp, n_max]")
    confbits = _word_bits(c(conflict, torch.bool)) if track_conflicts else None
    W = confbits.shape[1] if confbits is not None else 0
    ntype = c(node_type, i32).clone()
    cum = c(node_cum, f32).clone()
    zbits = _bits(c(node_zmask, torch.bool)).to(i32)
    cbits = _bits(c(node_cmask, torch.bool)).to(i32)
    nopen = c(node_open, torch.bool).clone()
    hosted = (torch.zeros((n_max, W), dtype=i32, device=dev)
              if track_conflicts else None)
    takes = torch.empty((Gp, n_max), dtype=i32, device=dev)
    unsched = torch.empty(Gp, dtype=i32, device=dev)
    hdr = torch.empty(2, dtype=i32, device=dev)

    def ptr(x: Optional[torch.Tensor]):
        return None if x is None else x.data_ptr()

    rc = _lib()(ptr(alloc_c), ptr(price_c), ptr(availbits), ptr(zovh_c),
                ptr(req_c), ptr(counts_c), ptr(compat_c), ptr(gzone),
                ptr(gcap), ptr(maxpn), ptr(prior_c), prior_c.shape[1],
                ptr(banned_c), banned_c.shape[1], ptr(confbits), W,
                ptr(ntype), ptr(cum), ptr(zbits), ptr(cbits), ptr(nopen),
                ptr(hosted), ptr(takes), ptr(unsched), ptr(hdr),
                T, Z, C, Rk, Gp, n_max, int(n_used),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"solve_scan launch failed: cudaError {rc}")
    launches += 1
    return ntype, takes, unsched, hdr[0], hdr[1] != 0


def solve_scan(*args, **kwargs) -> ScanOut:
    """The group scan: the plain version for CPU tensors, kernel B for CUDA
    tensors (arguments as solve_scan_plain)."""
    dev = args[0].device if args else kwargs["alloc"].device
    if dev.type == "cpu":
        return solve_scan_plain(*args, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"solve_scan runs on cpu or cuda, not {dev}")
    return solve_scan_cuda(*args, **kwargs)


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
    k_max (the caller regrows the budget). Compaction is a cumsum of
    flat > 0 and a scatter, all on the device with no host sync."""
    dev = takes.device
    flat = takes.reshape(-1)
    pos = flat > 0
    nnz = pos.sum()
    rank = torch.cumsum(pos, 0) - 1
    slot = torch.where(pos & (rank < k_max), rank, k_max)  # k_max = discard
    idx = torch.zeros(k_max + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(flat.numel(), device=dev))
    idx = idx[:k_max]
    vals = flat[idx]
    head = torch.stack([nused.to(torch.int64).reshape(()),
                        overflow.to(torch.int64).reshape(()), nnz])
    return torch.cat([head.to(torch.int32), unsched.to(torch.int32),
                      ntype.to(torch.int32), idx.to(torch.int32),
                      vals.to(torch.int32)])
