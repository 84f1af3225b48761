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
count) and its shard total saturated at count; the totals are exchanged;
then each shard takes the saturated sum of the LOWER shards' totals as its
carry, writes its takes (a shard whose carry reaches count takes nothing)
and opens the new nodes [nused, nused + n_new) that fall in its range.
Inside a shard kernel M's blocks each write their own total, so what is
exchanged is the vector of block totals; a shard's total is the saturated
sum of its blocks'. The takes do not depend on how many blocks a shard
has: all terms are non-negative, so min(sum min(x_i, c), c) =
min(sum x_i, c).

Kernel M has two routes, picked before any launch by `mesh_route` from
the mesh's devices and, where the shards share a card, by `card_route`
from the sizes:
- shards that share one device (a virtual mesh, or one shard): ONE
  cooperative launch a solve (`mesh_scan_persistent_cuda`) for every shard
  and step, one grid barrier a step in place of the host's gather; the
  node state in shared memory, or, where a block's nodes would pass the
  card's shared memory, in the shards' arrays in global memory
  (`persistent_layout`);
- shards on distinct cards, or more shards than the card holds blocks at
  once: one launch a shard a step (`mesh_scan_per_step_cuda`: apply step
  g - 1 with the gathered totals, then count step g), the totals
  all-gathered between steps (`parallel/collectives.all_gather`):
  (Gp + 1) x S launches and Gp gathers a solve.
Neither route falls back to the other, nor to the plain version. Both
take every shape the reference's scan takes: the node's zone and captype
bits are B0's bit strings, NB = ceil((Z + C) / 32) words a node
(`csrc/scan_common.cuh`).

`mesh_scan` takes per-shard lists of tensors; the plain version runs for
CPU shards, kernel M for CUDA shards, and nothing falls back between the
two. The prefix is integer and saturating in both, where the reference's
runs in f32 (exact below 2^24, and moot once it passes count), and the
float operations on cum are the reference's, in its order, so all three
agree element for element.
"""

from __future__ import annotations

import ctypes
import inspect
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import collectives as col
from ..parallel.mesh import Mesh
from .binpack import BIG, EPS
from . import solve_scan as ss

# kernel M launches since import (chip_smoke resets and reads), on either
# route: one a solve (persistent), one a shard a step (per-step)
launches = 0

NTM = 256  # kernel M threads a block (csrc/mesh_scan.cu)
NODE_SMEM_FIXED = 13  # shared bytes a node beside its cum, one bit word


def node_smem(Rk: int, nb: int = 1) -> int:
    """Shared bytes a node of the persistent kernel (csrc NODE_SMEM): cum,
    type, nb bit words, kf, open."""
    return 4 * Rk + NODE_SMEM_FIXED + 4 * (nb - 1)

_EPS = float(np.float32(EPS))


def _bits(zmask: torch.Tensor, cmask: torch.Tensor) -> torch.Tensor:
    """int32 [N, NB]: kernel M's node words, the bit string of zone z at
    bit z and captype c at bit Z + c (word w holding bits 32w..32w+31)."""
    N, Z, C = zmask.shape[0], zmask.shape[1], cmask.shape[1]
    nb = ss._node_words(Z, C)
    dev = zmask.device
    flat = torch.zeros((N, 32 * nb), dtype=torch.int64, device=dev)
    flat[:, :Z] = zmask.to(torch.int64)
    flat[:, Z:Z + C] = cmask.to(torch.int64)
    words = (flat.reshape(N, nb, 32)
             << torch.arange(32, device=dev)).sum(2)
    # values up to 2^32 - 1: the int32 of the same 32 bits
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def _unbits(bits: torch.Tensor, Z: int, C: int):
    """(zmask [N, Z], cmask [N, C]) of node words [N, NB] (or [N])."""
    b = ss._unpack_words(bits.reshape(bits.shape[0], -1))
    return b[:, :Z], b[:, Z:Z + C]


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
    sig = dict(
        new=([P] * 4 + [I, P, I, P, I] + [P] * 11 + [I] * 12, P),
        step=([P, I, P, P], I), free=([P], None), args_bytes=([], I),
        pack=([P, I, P, I], I), coop_limits=([P], I),
        coop_occupancy=([I, P], I), coop=([P, I, I, I, I, P, P], I))
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, f"mesh_scan_{name}")
        fn.argtypes, fn.restype = argtypes, restype
        _fns[name] = fn
    return _fns


def mesh_route(devices: Sequence[torch.device]) -> str:
    """Kernel M's route for a mesh's shard devices: "persistent" (one
    cooperative launch a solve) when every shard sits on one device, as
    far as the card holds the shards' blocks at once (`card_route`),
    "per_step" (a launch a shard a step, the block totals all-gathered on
    the host between steps) when the shards span distinct devices."""
    return "persistent" if len(set(devices)) == 1 else "per_step"


@dataclass(frozen=True)
class PersistentLayout:
    """The grid of the persistent launch."""

    nbp: int           # blocks a shard
    npt: int           # nodes a thread (a run of consecutive nodes)
    smem: int          # dynamic shared bytes a block (0: nodes in global)
    nodes_smem: bool   # the node state in shared memory, else the shards'
                       # arrays in global memory


def persistent_layout(S: int, Ns: int, Rk: int, sms: int, smem_max: int,
                      blocks_per_sm, nb: int = 1
                      ) -> Optional[PersistentLayout]:
    """The persistent launch's grid, from sizes alone: all S * nbp blocks
    co-resident on `sms` SMs, each SM holding `blocks_per_sm(smem)` blocks
    of `smem` dynamic shared bytes. The fewest nodes a thread (the most
    blocks) at which a block's nodes fit in `smem_max` shared bytes with
    the grid co-resident; else the node state stays in global memory
    (smem 0), at the fewest nodes a thread that keeps the grid co-resident.
    None where S shards outnumber the blocks the card holds at once even
    then (the per-step route's case, `card_route`). A node takes
    `node_smem(Rk, nb)` shared bytes (nb bit words a node)."""
    npt = 1
    while True:
        chunk = npt * NTM
        smem = chunk * node_smem(Rk, nb)
        if smem > smem_max:
            break
        nbp = -(-Ns // chunk)
        if S * nbp <= sms * blocks_per_sm(smem):
            return PersistentLayout(nbp, npt, smem, True)
        if nbp == 1:
            break  # longer runs only take shared memory, never blocks
        npt += 1
    nbp = min((sms * blocks_per_sm(0)) // S, -(-Ns // NTM))
    if nbp < 1:
        return None
    npt = -(-Ns // (nbp * NTM))
    return PersistentLayout(-(-Ns // (npt * NTM)), npt, 0, False)


def card_route(S: int, Ns: int, Rk: int, sms: int, smem_max: int,
               blocks_per_sm, nb: int = 1
               ) -> Tuple[str, Optional[PersistentLayout]]:
    """(route, layout) of S shards of Ns nodes that share one card, from
    sizes alone, before any launch: ("persistent", its layout) where the
    card holds at least one block a shard at once, else ("per_step",
    None)."""
    lay = persistent_layout(S, Ns, Rk, sms, smem_max, blocks_per_sm, nb)
    return ("per_step", None) if lay is None else ("persistent", lay)


def _cuda_call(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"mesh_scan: {what} failed: cudaError {rc}")


_occupancy_memo: dict = {}


def _occupancy(lib, smem: int) -> int:
    """Blocks of the persistent kernel one SM of the current device holds
    with `smem` dynamic shared bytes each."""
    key = (torch.cuda.current_device(), smem)
    if key not in _occupancy_memo:
        out = (ctypes.c_int * 1)()
        _cuda_call(lib["coop_occupancy"](smem, out),
                   "the occupancy query")
        _occupancy_memo[key] = out[0]
    return _occupancy_memo[key]


def _check(mesh: Mesh, alloc, price, avail, requests, counts, compat,
           allow_zone, allow_cap, max_per_node, prior, banned, conflict,
           zovh, node_type, node_cum, node_zmask, node_cmask, node_open,
           n_used, n_max: int, track_conflicts: bool = False,
           zone_ovh: bool = False) -> list:
    """Refuse, before any build or launch, malformed arguments
    (ValueError); (T, Z, C, Rk) of each shard. Every width, zone and
    captype count and catalog size is taken."""
    S = mesh.size
    Ns = col.block(n_max, S)
    dims = []
    for s in range(S):
        T, Z, C, _, _, Rk = ss._check_shapes(alloc[s], price[s],
                                             requests[s][None])
        dims.append((T, Z, C, Rk))
        if {prior[s].shape[1], banned[s].shape[1]} - {1, Ns}:
            raise ValueError("mesh_scan: prior/banned must be [Gp, 1] or "
                             "the shard's [Gp, Ns]")
        if tuple(node_cum[s].shape) != (Ns, Rk):
            raise ValueError(f"mesh_scan: node_cum shard "
                             f"{tuple(node_cum[s].shape)} != {(Ns, Rk)}")
        if alloc[s].device.type != "cuda":
            raise ValueError("mesh_scan_cuda: every shard must be on a "
                             "CUDA device")
    return dims


def _sizes(mesh: Mesh, args, kwargs) -> tuple:
    """(Ns, Rk, nb) of a call's arguments (those of mesh_scan_plain), once
    they pass `_check`: the shard's nodes, the columns and the bit words a
    node."""
    dims = _check(mesh, *args, **kwargs)
    a = inspect.signature(mesh_scan_plain).bind(mesh, *args,
                                                **kwargs).arguments
    T, Z, C, Rk = dims[0]
    return col.block(a["n_max"], mesh.size), Rk, ss._node_words(Z, C)


def _route_on_card(mesh: Mesh, Ns: int, Rk: int, nb: int = 1):
    """`card_route` at the card the shards share: its SMs, opt-in shared
    memory and the kernel's occupancy (nb bit words a node). Raises where
    the card takes no cooperative launch."""
    dev = mesh.devices[0]
    lib = _lib()
    with col.on_shard(dev):
        lim = (ctypes.c_int * 3)()
        _cuda_call(lib["coop_limits"](lim), "the device query")
        sms, smem_max, coop = lim
        if not coop:
            raise RuntimeError(f"mesh_scan: {dev} takes no cooperative "
                               f"launch")
        return card_route(mesh.size, Ns, Rk, sms, smem_max,
                          lambda b: _occupancy(lib, b), nb)


def _stage(mesh: Mesh, alloc, price, avail, requests, counts, compat,
           allow_zone, allow_cap, max_per_node, prior, banned, conflict,
           zovh, node_type, node_cum, node_zmask, node_cmask, node_open,
           n_used, n_max: int, track_conflicts: bool = False,
           zone_ovh: bool = False, *, per_step: bool,
           kf: bool = False) -> list:
    """Check every shard's arguments (`_check`), then launch B0 once a
    shard and lay out its node state and M's handle: one dict a shard.
    `per_step` adds the scratch only the per-step kernel reads (kf, pre,
    block totals); `kf` the kf scratch alone (the persistent kernel with
    its node state in global memory)."""
    S = mesh.size
    Ns = col.block(n_max, S)
    Gp = requests[0].shape[0]
    dims = _check(mesh, alloc, price, avail, requests, counts, compat,
                  allow_zone, allow_cap, max_per_node, prior, banned,
                  conflict, zovh, node_type, node_cum, node_zmask,
                  node_cmask, node_open, n_used, n_max)
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    lib = _lib()
    nb = -(-Ns // NTM)  # the per-step kernel's blocks a shard
    shards = []
    try:
        for s in range(S):
            dev = alloc[s].device
            # the shard's device is current for its B0 launch and for
            # anything its staging allocates
            T, Z, C, Rk = dims[s]
            with col.on_shard(dev):
                recs, availbits, W = ss._offer_table(
                    alloc[s], price[s], avail[s], requests[s][None],
                    counts[s][None], compat[s][None], allow_zone[s][None],
                    allow_cap[s][None], max_per_node[s][None],
                    prior[s][None], banned[s][None], conflict[s][None],
                    zovh[s], zone_ovh, track_conflicts)
                prior_c = ss._on(prior[s], dev, i32)
                banned_c = ss._on(banned[s], dev, torch.bool)
                st = dict(
                    dev=dev, ZC=(Z, C), recs=recs,
                    availbits=availbits,
                    alloc=ss._on(alloc[s], dev, f32),
                    zovh=ss._on(zovh[s], dev, f32) if zone_ovh else None,
                    prior=prior_c, banned=banned_c,
                    type=node_type[s].to(dev, i32).clone(),
                    open=node_open[s].to(dev, u8).clone(),
                    bits=_bits(node_zmask[s], node_cmask[s]).to(dev),
                    cum=node_cum[s].to(dev, f32).contiguous().clone(),
                    host=torch.zeros((Ns, max(W, 1)), dtype=i32,
                                     device=dev),
                    takes=torch.empty((Gp, Ns), dtype=i32, device=dev),
                    unsched=torch.empty(Gp, dtype=i32, device=dev),
                    hdr=torch.zeros(4, dtype=i32, device=dev))
                if per_step or kf:
                    st["kf"] = torch.empty(Ns, dtype=i32, device=dev)
                if per_step:
                    st.update(pre=torch.empty(Ns, dtype=i32, device=dev),
                              tot=torch.zeros(nb, dtype=i32, device=dev))
                nu = (n_used[s] if isinstance(n_used, (list, tuple))
                      else n_used)
                if isinstance(nu, torch.Tensor):
                    st["hdr"][0].copy_(nu.to(dev, i32).reshape(()))
                else:
                    st["hdr"][0] = int(nu)
                p = lambda k: None if st.get(k) is None else st[k].data_ptr()  # noqa
                # a [Gp, 1] prior or banned is read from B0's record, which
                # this shard's B0 built from this shard's own column (a
                # split [Gp, 1] slice at Ns == 1 reads the same value)
                h = lib["new"](
                    p("alloc"), p("availbits"), p("zovh"), p("recs"),
                    int(recs.shape[-1]), p("prior"),
                    int(prior_c.shape[1] > 1), p("banned"),
                    int(banned_c.shape[1] > 1), p("type"), p("open"),
                    p("bits"), p("cum"), p("host"), p("kf"), p("pre"),
                    p("tot"), p("takes"), p("unsched"), p("hdr"),
                    T, Z, C, Rk, W, Gp, Ns, s * Ns, n_max, s, S,
                    int(track_conflicts))
                if not h:
                    raise ValueError(f"mesh_scan: malformed arguments (T={T} "
                                     f"Z={Z} C={C} Rk={Rk} Gp={Gp} "
                                     f"Ns={Ns})")
                st["handle"] = h
                shards.append(st)
    except BaseException:
        _free(shards)
        raise
    return shards


def _free(shards) -> None:
    lib = _lib()
    for st in shards:
        lib["free"](st.pop("handle"))


def _outputs(shards):
    """The per-shard state after M -> mesh_scan_plain's outputs."""
    Gp = shards[0]["takes"].shape[0]
    masks = [_unbits(st["bits"], *st["ZC"]) for st in shards]
    return _gather_out(
        [st["type"] for st in shards], [st["cum"] for st in shards],
        [m[0] for m in masks], [m[1] for m in masks],
        [st["open"] != 0 for st in shards],
        [st["hdr"][Gp & 1] for st in shards],
        [st["takes"] for st in shards], [st["unsched"] for st in shards],
        [st["hdr"][2] != 0 for st in shards])


def mesh_scan_per_step_cuda(mesh: Mesh, *args, **kwargs):
    """Kernels B0 (once a shard) and M's per-step route ((Gp + 1) launches
    a shard, the block totals all-gathered between steps) on the shards'
    current streams, no synchronisation; arguments and results as
    mesh_scan_plain. The route for shards on distinct cards, and for more
    shards on one card than it holds blocks at once."""
    global launches
    shards = _stage(mesh, *args, **kwargs, per_step=True)
    Gp = shards[0]["takes"].shape[0]
    lib = _lib()
    try:
        gathered = [None] * mesh.size
        for g in range(Gp + 1):
            for s, st in enumerate(shards):
                gt = gathered[s]
                with col.on_shard(st["dev"]):
                    rc = lib["step"](st["handle"], g,
                                     None if gt is None else gt.data_ptr(),
                                     torch.cuda.current_stream(st["dev"])
                                     .cuda_stream)
                _cuda_call(rc, f"launch (shard {s}, step {g})")
                launches += 1
            if g < Gp:
                gathered = col.all_gather([st["tot"] for st in shards], mesh)
    finally:
        _free(shards)
    return _outputs(shards)


def mesh_scan_persistent_cuda(mesh: Mesh, *args, **kwargs):
    """Kernels B0 (once a shard) and M's persistent route (ONE cooperative
    launch for every shard and step) on the device's current stream, no
    synchronisation; arguments and results as mesh_scan_plain. Every shard
    must sit on one device that holds a block of each at once
    (`card_route`); the grid's layout, and where the node state lives,
    come from `persistent_layout`. A refused launch raises RuntimeError."""
    global launches
    dev = mesh.devices[0]
    if mesh_route(mesh.devices) != "persistent":
        raise ValueError(f"mesh_scan: the persistent route needs every "
                         f"shard on one device, not {mesh.describe()}")
    S = mesh.size
    route, lay = _route_on_card(mesh, *_sizes(mesh, args, kwargs))
    if lay is None:
        raise ValueError(f"mesh_scan: {S} shards outnumber the blocks {dev} "
                         f"holds at once: the per-step route serves them")
    shards = _stage(mesh, *args, **kwargs, per_step=False,
                    kf=not lay.nodes_smem)
    lib = _lib()
    try:
        with col.on_shard(dev):
            size = lib["args_bytes"]()
            host = torch.empty(S * size, dtype=torch.uint8, pin_memory=True)
            handles = (ctypes.c_void_p * S)(*[st["handle"] for st in shards])
            if lib["pack"](handles, S, host.data_ptr(),
                           int(not lay.nodes_smem)) != 0:
                raise ValueError("mesh_scan: the shards' arguments do not "
                                 "form one mesh")
            args_dev = host.to(dev, non_blocking=True)
            tot = torch.empty((2, S * lay.nbp), dtype=torch.int32,
                              device=dev)
            rc = lib["coop"](args_dev.data_ptr(), S, lay.nbp, lay.npt,
                             lay.smem, tot.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
            _cuda_call(rc, f"the cooperative launch ({S} x {lay.nbp} "
                           f"blocks, {lay.smem} shared bytes a block)")
            launches += 1
    finally:
        _free(shards)
    return _outputs(shards)


def mesh_scan_cuda(mesh: Mesh, *args, **kwargs):
    """Kernel M on CUDA shards, by the route chosen from the mesh's devices
    (`mesh_route`) and, where they share a card, from the sizes
    (`card_route`), before any launch; arguments and results as
    mesh_scan_plain."""
    if (mesh_route(mesh.devices) == "persistent"
            and _route_on_card(mesh, *_sizes(mesh, args, kwargs))[0]
            == "persistent"):
        return mesh_scan_persistent_cuda(mesh, *args, **kwargs)
    return mesh_scan_per_step_cuda(mesh, *args, **kwargs)


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
