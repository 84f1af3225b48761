"""The node-sharded group scan: kernel M (`csrc/mesh_scan.cu`) and its
plain PyTorch version.

Replaces the XLA programs `karpenter_tpu/parallel/mesh.py::sharded_solve_fn`
and `karpenter_tpu/ops/solver.py::_mesh_packed_fn`: the reference's
`_solve_kernel` (`ops/solver.py:348-483`) with its node state split over a
mesh (`parallel/mesh`), shard s owning the contiguous node range
[s*Ns, (s+1)*Ns), Ns = n_max / S. Split over the shards: node type, cum,
the zone and captype masks, the open flags, `prior_counts` and `banned`
when they span the nodes, and the hosted-group bits. Replicated: the
catalog, the group inputs, `conflict`, `nused`, `placed` and `rem`.

Step 2 of the reference's scan (the offer argmin) reads no node state, so
kernel B0 (`ops/solve_scan`) runs once per shard on its replicated inputs
and writes the per-group records that kernel M reads.

Per group step g every shard computes, for its own nodes, kf = min(k,
count) and its shard total saturated at count; the totals are
all-gathered (`parallel/collectives.all_gather`, outside the kernel);
then each shard takes the saturated sum of the LOWER shards' totals as its
carry, writes its takes (a shard whose carry reaches count takes nothing)
and opens the new nodes [nused, nused + n_new) that fall in its range.
Kernel M does this as one launch per shard per step: apply step g - 1
with the gathered totals, then count step g. That is (Gp + 1) x S
launches and Gp gathers a solve. Inside a shard the kernel's blocks each
write their own total, so what is gathered is the [S * nb] vector of block
totals; a shard's total is the saturated sum of its blocks'.

`mesh_scan` takes per-shard lists of tensors; the plain version runs for
CPU shards, kernel M for CUDA shards, and nothing falls back between the
two. The prefix is integer and saturating in both, where the reference's
runs in f32 (exact below 2^24, and moot once it passes count), and the
float operations on cum are the reference's, in its order, so all three
agree element for element.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from ..parallel import collectives as col
from ..parallel.mesh import Mesh
from .binpack import BIG, EPS
from . import solve_scan as ss

# kernel M launches since import (chip_smoke resets and reads): one per
# shard per step
launches = 0

NTM = 256  # kernel M threads per block, one node each (csrc/mesh_scan.cu)

_EPS = float(np.float32(EPS))


def _bits(zmask: torch.Tensor, cmask: torch.Tensor) -> torch.Tensor:
    """int32 [N]: zone bits | captype bits << Z (kernel M's node word)."""
    Z, C = zmask.shape[1], cmask.shape[1]
    dev = zmask.device
    zw = (zmask.to(torch.int64) << torch.arange(Z, device=dev)).sum(1)
    cw = (cmask.to(torch.int64) << (Z + torch.arange(C, device=dev))).sum(1)
    return (zw | cw).to(torch.int32)


def _unbits(bits: torch.Tensor, Z: int, C: int):
    b = bits.to(torch.int64)[:, None]
    dev = bits.device
    zm = ((b >> torch.arange(Z, device=dev)) & 1) != 0
    cm = ((b >> (Z + torch.arange(C, device=dev))) & 1) != 0
    return zm, cm


def _gather_out(ntype, cum, zmask, cmask, nopen, nused, takes, unsched,
                overflow):
    """Per-shard outputs -> the reference's nine outputs, on shard 0's
    device (the gather of replicated outputs): split state concatenated
    along the node axis, the replicated scalars taken from shard 0."""
    return (col.gather(ntype), col.gather(cum), col.gather(zmask),
            col.gather(cmask), col.gather(nopen), nused[0],
            col.gather(takes, 1), unsched[0], overflow[0])


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def mesh_scan_plain(mesh: Mesh, alloc, price, avail, requests, counts,
                    compat, allow_zone, allow_cap, max_per_node, prior,
                    banned, conflict, zovh, node_type, node_cum, node_zmask,
                    node_cmask, node_open, n_used, n_max: int,
                    track_conflicts: bool = False, zone_ovh: bool = False):
    """The sharded scan in PyTorch ops, shard by shard, with the same
    collectives and the same saturating integer prefix as kernel M. Every
    argument is a list of S per-shard tensors (replicated ones repeat;
    prior and banned are [Gp, Ns] slices or [Gp, 1]); n_used a per-shard
    scalar or an int. Returns the nine outputs of the reference's
    `_solve_kernel`, gathered on shard 0's device."""
    S = mesh.size
    Ns = col.block(n_max, S)
    Gp = requests[0].shape[0]
    offers = [ss.offer_argmin_plain(
        alloc[s], price[s], avail[s], requests[s], compat[s], allow_zone[s],
        allow_cap[s], max_per_node[s], zovh[s], zone_ovh) for s in range(S)]
    ntype = [node_type[s].to(torch.int64).clone() for s in range(S)]
    cum = [node_cum[s].to(torch.float32).clone() for s in range(S)]
    zmask = [node_zmask[s].clone() for s in range(S)]
    cmask = [node_cmask[s].clone() for s in range(S)]
    nopen = [node_open[s].clone() for s in range(S)]
    nu0 = [int(n_used[s]) if isinstance(n_used, (list, tuple))
           else int(n_used) for s in range(S)]
    nused = [torch.tensor(nu0[s], dtype=torch.int64,
                          device=alloc[s].device) for s in range(S)]
    hosted = [torch.zeros((Ns, Gp if track_conflicts else 1),
                          dtype=torch.bool, device=alloc[s].device)
              for s in range(S)]
    takes = [torch.zeros((Gp, Ns), dtype=torch.int32, device=alloc[s].device)
             for s in range(S)]
    unsched = [torch.zeros(Gp, dtype=torch.int32, device=alloc[s].device)
               for s in range(S)]
    clamped = [torch.zeros((), dtype=torch.bool, device=alloc[s].device)
               for s in range(S)]

    for g in range(Gp):
        kfs, tots = [], []
        for s in range(S):
            dev = alloc[s].device
            req = requests[s][g]
            count = counts[s][g].to(torch.int64)
            cap_per = torch.where(max_per_node[s][g] == 0, BIG,
                                  max_per_node[s][g]).to(torch.int64)
            prior_n, banned_n = prior[s][g], banned[s][g]
            conf_g = conflict[s][g]
            gzone, gcap = allow_zone[s][g], allow_cap[s][g]
            zmask2 = zmask[s] & gzone[None, :]
            cmask2 = cmask[s] & gcap[None, :]
            talloc = alloc[s][ntype[s]]
            if zone_ovh:
                ovh_n = torch.where(zmask2[:, :, None], zovh[s][ntype[s]],
                                    0.0).amax(dim=1)
                talloc = talloc - ovh_n
            headroom = talloc - cum[s]
            with_req = torch.where(req > 0, req, torch.ones_like(req))
            big_f = torch.tensor(float(BIG), dtype=torch.float32, device=dev)
            k_cap = torch.where(req > 0,
                                torch.floor(headroom / with_req + _EPS),
                                big_f).amin(dim=1)
            k_cap = k_cap.clamp_min(0.0).to(torch.int64)
            off_ok = (zmask2[:, :, None] & cmask2[:, None, :]
                      & avail[s][ntype[s]]).any(dim=2).any(dim=1)
            eligible = (nopen[s] & compat[s][g][ntype[s]] & off_ok
                        & ~banned_n)
            if track_conflicts:
                eligible &= ~(hosted[s] & conf_g[None, :]).any(dim=1)
            cap_eff = (cap_per - prior_n).clamp_min(0)
            k = torch.where(eligible, torch.minimum(k_cap, cap_eff), 0)
            kf = torch.minimum(k, count)
            kfs.append(kf)
            # the shard's total, saturated at count: what the step gathers
            tots.append(torch.minimum(kf.sum(), count).reshape(1))
        gathered = col.all_gather(tots, mesh)          # [S] on every shard
        for s in range(S):
            dev = alloc[s].device
            req = requests[s][g]
            count = counts[s][g].to(torch.int64)
            kf = kfs[s]
            gt_all = gathered[s]
            carry = torch.minimum(gt_all[:s].sum(), count)
            tot = torch.minimum(gt_all.sum(), count)   # == placed
            pre = torch.cumsum(kf, 0) - kf
            prefix = torch.minimum(carry + pre, count)
            take = torch.minimum(kf, count - prefix).clamp_min(0)
            rem = count - tot
            got = take > 0
            cum[s] = cum[s] + take[:, None].to(torch.float32) * req[None, :]
            zmask[s] = torch.where(got[:, None],
                                   zmask[s] & allow_zone[s][g][None, :],
                                   zmask[s])
            cmask[s] = torch.where(got[:, None],
                                   cmask[s] & allow_cap[s][g][None, :],
                                   cmask[s])
            t_stars, slots_s, oks, t_zs, t_cs = offers[s]
            t_star, sl = t_stars[g], slots_s[g]
            schedulable = oks[g] & (rem > 0)
            n_new_want = torch.where(schedulable, (rem + sl - 1) // sl, 0)
            n_new = torch.minimum(n_new_want,
                                  (n_max - nused[s]).clamp_min(0))
            node_ids = s * Ns + torch.arange(Ns, device=dev)
            new_pos = node_ids - nused[s]
            is_new = (new_pos >= 0) & (new_pos < n_new)
            pods_on = torch.minimum((rem - new_pos * sl).clamp_min(0), sl)
            new_take = torch.where(is_new, pods_on, 0)
            # the new nodes' total, replicated: min(rem, n_new * s)
            put = n_new * sl
            overflow = torch.where(schedulable, (rem - put).clamp_min(0), 0)
            ntype[s] = torch.where(is_new, t_star, ntype[s])
            cum[s] = torch.where(is_new[:, None],
                                 new_take[:, None].to(torch.float32)
                                 * req[None, :], cum[s])
            zmask[s] = torch.where(is_new[:, None],
                                   (allow_zone[s][g] & t_zs[g])[None, :],
                                   zmask[s])
            cmask[s] = torch.where(is_new[:, None],
                                   (allow_cap[s][g] & t_cs[g])[None, :],
                                   cmask[s])
            nopen[s] = nopen[s] | is_new
            nused[s] = nused[s] + n_new
            unsched[s][g] = torch.where(schedulable, overflow,
                                        rem).to(torch.int32)
            g_take = take + new_take
            takes[s][g] = g_take.to(torch.int32)
            if track_conflicts:
                hosted[s][:, g] |= g_take > 0
            clamped[s] |= n_new < n_new_want
    return _gather_out([t.to(torch.int32) for t in ntype], cum, zmask, cmask,
                       nopen, [n.to(torch.int32) for n in nused], takes,
                       unsched, clamped)


# ---------------------------------------------------------------------------
# kernel M
# ---------------------------------------------------------------------------

_fns: dict = {}


def _lib():
    if _fns:
        return _fns
    from ._build import load
    lib = load("mesh_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    new = lib.mesh_scan_new
    new.argtypes = ([P] * 4 + [I, P, I, P, I] + [P] * 11 + [I] * 12)
    new.restype = ctypes.c_void_p
    step = lib.mesh_scan_step
    step.argtypes = [P, I, P, P]
    step.restype = ctypes.c_int
    free = lib.mesh_scan_free
    free.argtypes = [P]
    free.restype = None
    _fns.update(new=new, step=step, free=free)
    return _fns


def mesh_scan_cuda(mesh: Mesh, alloc, price, avail, requests, counts,
                   compat, allow_zone, allow_cap, max_per_node, prior, banned,
                   conflict, zovh, node_type, node_cum, node_zmask,
                   node_cmask, node_open, n_used, n_max: int,
                   track_conflicts: bool = False, zone_ovh: bool = False):
    """Kernels B0 (once a shard) and M ((Gp + 1) launches a shard) on the
    shards' current streams, no synchronisation; arguments and results as
    mesh_scan_plain."""
    global launches
    S = mesh.size
    Ns = col.block(n_max, S)
    nb = -(-Ns // NTM)  # blocks a shard
    Gp = requests[0].shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    lib = _lib()
    shards = []
    try:
        for s in range(S):
            dev = alloc[s].device
            if dev.type != "cuda":
                raise ValueError("mesh_scan_cuda: every shard must be on a "
                                 "CUDA device")
            # the shard's device is current for its B0 launch and for
            # anything its staging allocates
            with col.on_shard(dev):
                T, Z, C, _, _, Rk = ss._check_shapes(alloc[s], price[s],
                                                     requests[s][None])
                recs, availbits, W = ss._offer_table(
                    alloc[s], price[s], avail[s], requests[s][None],
                    counts[s][None], compat[s][None], allow_zone[s][None],
                    allow_cap[s][None], max_per_node[s][None],
                    prior[s][None], banned[s][None], conflict[s][None],
                    zovh[s], zone_ovh, track_conflicts)
                prior_c = ss._on(prior[s], dev, i32)
                banned_c = ss._on(banned[s], dev, torch.bool)
                if {prior_c.shape[1], banned_c.shape[1]} - {1, Ns}:
                    raise ValueError("mesh_scan: prior/banned must be "
                                     "[Gp, 1] or the shard's [Gp, Ns]")
                if tuple(node_cum[s].shape) != (Ns, Rk):
                    raise ValueError(f"mesh_scan: node_cum shard "
                                     f"{tuple(node_cum[s].shape)} != "
                                     f"{(Ns, Rk)}")
                st = dict(
                    dev=dev, recs=recs, availbits=availbits,
                    alloc=ss._on(alloc[s], dev, f32),
                    zovh=ss._on(zovh[s], dev, f32) if zone_ovh else None,
                    prior=prior_c, banned=banned_c,
                    type=node_type[s].to(dev, i32).clone(),
                    open=node_open[s].to(dev, u8).clone(),
                    bits=_bits(node_zmask[s], node_cmask[s]).to(dev),
                    cum=node_cum[s].to(dev, f32).contiguous().clone(),
                    host=torch.zeros((Ns, max(W, 1)), dtype=i32,
                                     device=dev),
                    kf=torch.empty(Ns, dtype=i32, device=dev),
                    pre=torch.empty(Ns, dtype=i32, device=dev),
                    tot=torch.zeros(nb, dtype=i32, device=dev),
                    takes=torch.empty((Gp, Ns), dtype=i32, device=dev),
                    unsched=torch.empty(Gp, dtype=i32, device=dev),
                    hdr=torch.zeros(4, dtype=i32, device=dev))
                nu = (n_used[s] if isinstance(n_used, (list, tuple))
                      else n_used)
                if isinstance(nu, torch.Tensor):
                    st["hdr"][0].copy_(nu.to(dev, i32).reshape(()))
                else:
                    st["hdr"][0] = int(nu)
                p = lambda t: None if t is None else t.data_ptr()  # noqa
                # a [Gp, 1] prior or banned is read from B0's record, which
                # this shard's B0 built from this shard's own column (a
                # split [Gp, 1] slice at Ns == 1 reads the same value)
                h = lib["new"](
                    p(st["alloc"]), p(st["availbits"]), p(st["zovh"]),
                    p(st["recs"]),
                    int(recs.shape[-1]), p(prior_c),
                    int(prior_c.shape[1] > 1),
                    p(banned_c), int(banned_c.shape[1] > 1),
                    p(st["type"]), p(st["open"]), p(st["bits"]),
                    p(st["cum"]),
                    p(st["host"]), p(st["kf"]), p(st["pre"]), p(st["tot"]),
                    p(st["takes"]), p(st["unsched"]), p(st["hdr"]),
                    T, Z, C, Rk, W, Gp, Ns, s * Ns, n_max, s, S,
                    int(track_conflicts))
                if not h:
                    raise ValueError(f"mesh_scan: arguments refused (T={T} "
                                     f"Z={Z} C={C} Rk={Rk} Gp={Gp} "
                                     f"Ns={Ns})")
                st["handle"] = h
                shards.append(st)
        gathered = [None] * S
        for g in range(Gp + 1):
            for s, st in enumerate(shards):
                gt = gathered[s]
                with col.on_shard(st["dev"]):
                    rc = lib["step"](st["handle"], g,
                                     None if gt is None else gt.data_ptr(),
                                     torch.cuda.current_stream(st["dev"])
                                     .cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"mesh_scan launch failed: cudaError "
                                       f"{rc} (shard {s}, step {g})")
                launches += 1
            if g < Gp:
                gathered = col.all_gather([st["tot"] for st in shards], mesh)
    finally:
        for st in shards:
            lib["free"](st["handle"])
    Z, C = node_zmask[0].shape[1], node_cmask[0].shape[1]
    masks = [_unbits(st["bits"], Z, C) for st in shards]
    return _gather_out(
        [st["type"] for st in shards], [st["cum"] for st in shards],
        [m[0] for m in masks], [m[1] for m in masks],
        [st["open"] != 0 for st in shards],
        [st["hdr"][Gp & 1] for st in shards],
        [st["takes"] for st in shards], [st["unsched"] for st in shards],
        [st["hdr"][2] != 0 for st in shards])


def mesh_scan(mesh: Mesh, *args, **kwargs):
    """The sharded scan: the plain version for CPU shards, kernels B0 and
    M for CUDA shards (arguments as mesh_scan_plain)."""
    kinds = {d.type for d in mesh.devices}
    if kinds == {"cpu"}:
        return mesh_scan_plain(mesh, *args, **kwargs)
    if kinds == {"cuda"}:
        return mesh_scan_cuda(mesh, *args, **kwargs)
    raise ValueError(f"mesh_scan runs on cpu or cuda shards, not {kinds}")


# ---------------------------------------------------------------------------
# the reference's sharded_solve_fn call
# ---------------------------------------------------------------------------

# the reference's in_shardings of _solve_kernel's 19 arguments: None =
# replicated, 0 = node axis split, 1 = [G, N] split on its node axis
# (replicated instead when the array is a [G, 1] dummy)
_IN_AXES = (None, None, None,                    # alloc, price, avail
            None, None, None, None, None, None,  # group inputs
            1, 1, None, None,                    # prior, banned, conflict, zovh
            0, 0, 0, 0, 0,                       # node state
            None)                                # n_used


def shard_args(mesh: Mesh, n_max: int, *args) -> tuple:
    """Lay the 19 arguments of the reference's `_solve_kernel` out over the
    mesh as its in_shardings say: (18 per-shard lists, per-shard n_used),
    mesh_scan's arguments before n_max."""
    if len(args) != len(_IN_AXES):
        raise TypeError(f"the sharded solve takes {len(_IN_AXES)} arguments,"
                        f" got {len(args)}")
    if n_max % mesh.size:
        raise ValueError(f"n_max {n_max} does not split over {mesh.size} "
                         f"shards")
    parts = []
    for x, ax in zip(args, _IN_AXES):
        if ax == 1 and not isinstance(x, col.ShardedTensor) \
                and np.shape(x)[1] != n_max:
            ax = None
        parts.append(col.parts_of(x, mesh, ax))
    n_used = [int(p.item()) if p.device.type == "cpu" else p
              for p in parts[-1]]
    return (*parts[:-1], n_used)


def sharded_solve(mesh: Mesh, n_max: int, *args, track_conflicts=False,
                  zone_ovh=False):
    """`parallel.mesh.sharded_solve_fn(mesh, n_max)`'s body: lay the 19
    arguments out over the mesh and run the sharded scan."""
    return mesh_scan(mesh, *shard_args(mesh, n_max, *args), n_max,
                     track_conflicts=track_conflicts, zone_ovh=zone_ovh)
