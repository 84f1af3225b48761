"""Batched consolidation screening on the card: `consolidation_screen`.

The port of `karpenter_tpu/ops/consolidate.py`'s single-device path. The
dominant question of consolidation — "could node n's pods re-schedule onto
the other nodes' spare capacity?" — is a dense [N, G] computation for
every candidate at once:

    k[m, g]   = pods of group g that fit node m's headroom (0 if m is
                incompatible with g or no offering survives the masks)
    screen[n] = for all g with pods on n:  count[n, g] <= sum_{m != n} k[m, g]

The screen over-approximates (a filter and priority order, never a
verdict). k runs through kernel A (`ops/screen_k`); the body around it
(eligibility, column sum, `others`, the screen test and the packing) is
plain PyTorch on the device.

With `mesh=` the candidate-node axis splits over the mesh's shards (N
padded to a multiple of its size with inactive rows): the node matrix is
split, the group matrix and the catalog replicated, kernel A runs per
shard on its rows, and the [G] column total is a psum of the shards' f32
partial sums (`parallel/collectives`), as GSPMD reduces the reference's.
k is integer-valued, so while a column's sum stays below 2^24 the
partial sums are exact and the mesh's screen and slack equal mesh=None's
element for element. Past that (a group that requests nothing has k =
BIG on its eligible nodes) the sums round in another order: that slack
agrees within f32 rounding, and a verdict could move only where a node's
`others` lies within a few f32 ulps of its need.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..obs import devicemem as dm
from .encode import CatalogTensors, EncodedPods, align_zone_overhead
from .screen_k import screen_k
from .solver import (PROBE_VARIANTS, _auto_dcat, _put, _put_sharded, _read,
                     _request_cols, resolve_device, slope_time)


def eligibility(avail, node_type, node_zmask, node_cmask, node_active,
                compat, allow_zone, allow_cap) -> torch.Tensor:
    """bool [N, G]: node n may host group g (type compatible, an available
    offering surviving both masks, node active). The reference's f32
    einsum "nz,gz,nc,gc,nzc->ng" > 0 is computed here as a boolean any
    (exact, and no TF32 question arises). Shared with the optimizer's
    tournament, so the two headroom views cannot disagree."""
    N = node_type.shape[0]
    G = compat.shape[0]
    Z, C = allow_zone.shape[1], allow_cap.shape[1]
    ok_t = compat.T[node_type]                                # [N, G]
    nzc = avail[node_type] & node_zmask[:, :, None] & node_cmask[:, None, :]
    gzc = allow_zone[:, :, None] & allow_cap[:, None, :]      # [G, Z, C]
    off = (nzc.reshape(N, 1, Z * C) & gzc.reshape(1, G, Z * C)).any(dim=2)
    return ok_t & off & node_active[:, None]


def _screen_k(alloc, avail, node_type, node_cum, node_zmask, node_cmask,
              node_active, group_req, compat, allow_zone, allow_cap
              ) -> torch.Tensor:
    """k [N, G] of the screen's rows: headroom, eligibility, kernel A."""
    talloc = alloc[node_type]                                 # [N, R]
    headroom = talloc - node_cum                              # [N, R]
    elig = eligibility(avail, node_type, node_zmask, node_cmask,
                       node_active, compat, allow_zone, allow_cap)
    return screen_k(headroom, group_req, elig)                # [N, G]


def _screen_tail(k, total, node_active, node_groups):
    """(screen [N] f32, slack [N, G] f32) of the screen's rows, given the
    f32 column total over ALL rows."""
    others = total[None, :] - k                               # [N, G]
    need = node_groups.to(torch.float32)                      # [N, G]
    screen = ((need <= others) | (need == 0)).all(dim=1) & node_active
    return screen.to(torch.float32), others - need


def _screen_body(alloc, avail, node_type, node_cum, node_zmask, node_cmask,
                 node_active, group_req, compat, allow_zone, allow_cap,
                 node_groups) -> torch.Tensor:
    """ONE packed f32 vector: [0:N] screen (1.0 = candidate may
    consolidate), [N:N+N*G] headroom slack (others' capacity minus need,
    row-major [N, G]). The port of `_screen_kernel_impl`."""
    k = _screen_k(alloc, avail, node_type, node_cum, node_zmask, node_cmask,
                  node_active, group_req, compat, allow_zone, allow_cap)
    screen, slack = _screen_tail(k, k.sum(dim=0), node_active, node_groups)
    return torch.cat([screen, slack.reshape(-1)])


def _pack_screen_nodes(node_type, node_cum, node_zmask, node_cmask, active,
                       counts, cols) -> np.ndarray:
    """One f32 [Np, 1+Rk+Z+C+1+G] matrix of all node-side screen inputs."""
    return np.concatenate([
        node_type[:, None].astype(np.float32),
        node_cum[:, cols].astype(np.float32),
        node_zmask.astype(np.float32),
        node_cmask.astype(np.float32),
        active[:, None].astype(np.float32),
        counts.astype(np.float32),
    ], axis=1)


def _pack_screen_groups(req, compat, allow_zone, allow_cap,
                        cols) -> np.ndarray:
    """One f32 [G, Rk+T+Z+C] matrix of all group-side screen inputs."""
    return np.concatenate([
        req[:, cols].astype(np.float32),
        compat.astype(np.float32),
        allow_zone.astype(np.float32),
        allow_cap.astype(np.float32),
    ], axis=1)


def _unpack_screen(alloc, avail, nbuf, gbuf, cols: tuple) -> tuple:
    """Unpack the packed screen inputs by static offsets (resource columns
    projected to `cols`): (alloc_k, avail, node_type, node_cum,
    node_zmask, node_cmask, active, req, compat, allow_zone, allow_cap,
    counts), the screen body's arguments; the optimizer's tournament
    reads the same packing."""
    T, Z, C = avail.shape
    Rk = len(cols)
    G = gbuf.shape[0]
    cix = torch.as_tensor(cols, dtype=torch.int64, device=alloc.device)
    alloc_k = alloc[:, cix]
    req = gbuf[:, :Rk]
    o = Rk
    compat = gbuf[:, o:o + T] > 0; o += T
    allow_zone = gbuf[:, o:o + Z] > 0; o += Z
    allow_cap = gbuf[:, o:o + C] > 0
    node_type = nbuf[:, 0].to(torch.int64)
    o = 1
    node_cum = nbuf[:, o:o + Rk]; o += Rk
    node_zmask = nbuf[:, o:o + Z] > 0; o += Z
    node_cmask = nbuf[:, o:o + C] > 0; o += C
    active = nbuf[:, o] > 0; o += 1
    counts = nbuf[:, o:o + G]
    return (alloc_k, avail, node_type, node_cum, node_zmask, node_cmask,
            active, req, compat, allow_zone, allow_cap, counts)


def _screen_onebuf(alloc, avail, nbuf, gbuf, cols: tuple) -> torch.Tensor:
    """Unpack by static offsets and run the screen body."""
    return _screen_body(*_unpack_screen(alloc, avail, nbuf, gbuf, cols))


def _screen_args(cat: CatalogTensors, enc: EncodedPods, views, Np: int = 0):
    """Numpy node-side screen inputs (the reference's `_screen_args`):
    type, cum (zone reservation charged), zone and captype masks, active
    flags; padded with inactive rows to Np when Np > N."""
    R = enc.requests.shape[1]
    N = len(views)
    Np = max(Np, N)
    node_type = np.zeros(Np, np.int32)
    node_cum = np.zeros((Np, R), np.float32)
    node_zmask = np.zeros((Np, cat.Z), bool)
    node_cmask = np.zeros((Np, cat.C), bool)
    for i, v in enumerate(views):
        node_type[i] = v.virtual.type_idx
        node_cum[i, : len(v.virtual.cum)] = v.virtual.cum
        node_zmask[i] = v.virtual.zone_mask
        node_cmask[i] = v.virtual.cap_mask
    zovh = align_zone_overhead(cat, R)
    if zovh is not None:
        # zone-varying daemonset reservation: charge each node's headroom
        # with the max over its zone mask (host-side, as in the solve)
        node_cum = node_cum + np.where(
            node_zmask[:, :, None], zovh[node_type], np.float32(0.0)
        ).max(axis=1)
    active = np.zeros(Np, bool)
    active[:N] = True
    return node_type, node_cum, node_zmask, node_cmask, active


def screen_packed(cat: CatalogTensors, enc: EncodedPods, views: "List",
                  group_counts: np.ndarray, device=None) -> torch.Tensor:
    """The packed screen vector, still on the device (two uploads: the
    node-side and group-side matrices; the catalog rides the per-catalog
    device cache)."""
    dev = resolve_device(device)
    R = enc.requests.shape[1]
    cols = _request_cols(enc, cat)
    with dm.attributed(reason="screen_upload"):
        nbuf = _put(_pack_screen_nodes(*_screen_args(cat, enc, views),
                                       group_counts, list(cols)), dev)
        gbuf = _put(_pack_screen_groups(enc.requests, enc.compat,
                                        enc.allow_zone, enc.allow_cap,
                                        list(cols)), dev)
    dcat = _auto_dcat(cat, R, dev)
    return _screen_onebuf(dcat.alloc, dcat.avail, nbuf, gbuf, cols)


def _screen_dispatch(cat: CatalogTensors, enc: EncodedPods, views: "List",
                     group_counts: np.ndarray, device=None):
    """screen_device_time's dispatch: i -> the packed screen of variant
    i % PROBE_VARIANTS, whose node matrix is the production one with every
    node's cum[:, 0] raised by i x 0.001 (f32): same shapes, distinct
    inputs (the packed screens may agree where no change crosses a floor
    of kernel A). The group matrix and the catalog are the production
    ones."""
    dev = resolve_device(device)
    R = enc.requests.shape[1]
    cols = _request_cols(enc, cat)
    dcat = _auto_dcat(cat, R, dev)
    node_type, node_cum, node_zmask, node_cmask, active = _screen_args(
        cat, enc, views)
    with dm.attributed(reason="screen_upload"):
        gbuf = _put(_pack_screen_groups(enc.requests, enc.compat,
                                        enc.allow_zone, enc.allow_cap,
                                        list(cols)), dev)
        variants = []
        for i in range(PROBE_VARIANTS):
            cum = node_cum.copy()
            cum[:, 0] += np.float32(i) * np.float32(0.001)
            variants.append(_put(_pack_screen_nodes(
                node_type, cum, node_zmask, node_cmask, active, group_counts,
                list(cols)), dev))
    return lambda i: _screen_onebuf(dcat.alloc, dcat.avail,
                                    variants[i % PROBE_VARIANTS], gbuf, cols)


def screen_device_time(cat: CatalogTensors, enc: EncodedPods, views: "List",
                       group_counts: np.ndarray, iters: int = 40,
                       device=None) -> float:
    """Per-call time of the screen's dispatch on `device` (default: the
    card), in seconds: solver.slope_time over PROBE_VARIANTS node matrices
    with perturbed cum, through the production dispatch (`_screen_onebuf`:
    kernel A on a card, its plain version with device="cpu")."""
    return slope_time(_screen_dispatch(cat, enc, views, group_counts,
                                       device), iters=iters,
                      n_variants=PROBE_VARIANTS)


def screen_packed_mesh(cat: CatalogTensors, enc: EncodedPods, views: "List",
                       group_counts: np.ndarray, mesh) -> torch.Tensor:
    """The packed screen vector of an Np-row screen over `mesh` (Np = N
    rounded up to a multiple of its size; the padding rows are inactive),
    on shard 0's device. The same two uploads as one device: the node
    matrix split over the shards, the group matrix replicated; the
    catalog from the mesh-keyed epoch cache. Per shard: kernel A on its
    rows and the f32 column sum; the psum of those is the total every
    shard's tail reads; screen and slack gathered in the packed layout."""
    from ..parallel import collectives as col
    N = len(views)
    ms = int(mesh.size)
    Np = -(-N // ms) * ms
    R = enc.requests.shape[1]
    cols = _request_cols(enc, cat)
    counts = group_counts
    if Np > N:
        counts = np.concatenate([group_counts, np.zeros(
            (Np - N, enc.G), group_counts.dtype)])
    dcat = _auto_dcat(cat, R, mesh=mesh)
    with dm.attributed(reason="screen_upload"):
        nbuf = _put_sharded(_pack_screen_nodes(
            *_screen_args(cat, enc, views, Np), counts, list(cols)),
            col.Sharding(mesh, 0))
        gbuf = _put_sharded(_pack_screen_groups(
            enc.requests, enc.compat, enc.allow_zone, enc.allow_cap,
            list(cols)), col.Sharding(mesh))
    rows, ks = [], []
    for s, d in enumerate(mesh.devices):
        with col.on_shard(d):
            rows.append(_unpack_screen(dcat.alloc.parts[s],
                                       dcat.avail.parts[s], nbuf.parts[s],
                                       gbuf.parts[s], cols))
            ks.append(_screen_k(*rows[s][:11]))
    totals = col.psum([k.sum(dim=0) for k in ks], mesh)
    tails = [_screen_tail(k, t, r[6], r[11])
             for k, t, r in zip(ks, totals, rows)]
    return torch.cat([col.gather([t[0] for t in tails]),
                      col.gather([t[1] for t in tails]).reshape(-1)])


def consolidation_screen(cat: CatalogTensors, enc: EncodedPods,
                         views: "List", group_counts: np.ndarray,
                         device=None, mesh=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """views: `state.cluster.NodeView`s (only `.virtual` is read);
    group_counts [N, G] = pods of group g on node n. Returns (screen [N]
    bool, slack [N, G]), after ONE host read.

    mesh: split the candidate-node axis over the mesh's shards
    (`screen_packed_mesh`); `device` is then unused."""
    dev = resolve_device(device) if mesh is None else None
    N = len(views)
    if N == 0:
        return np.zeros(0, bool), np.zeros((0, enc.G), np.float32)
    from . import solver as _solver_mod
    # same fault seam as the solve kernels: a fault plan can take the
    # device out at screen dispatch too (the disruption controller meters
    # an InjectedFault and degrades to cost order; anything else raises)
    if _solver_mod._dispatch_fault_hook is not None:
        _solver_mod._dispatch_fault_hook("screen")
    if mesh is not None:
        Np = -(-N // int(mesh.size)) * int(mesh.size)
        buf = _read(screen_packed_mesh(cat, enc, views, group_counts, mesh))
    else:
        Np = N
        buf = _read(screen_packed(cat, enc, views, group_counts, dev))
    screen = buf[:N] > 0.5
    slack = buf[Np: Np + Np * enc.G].reshape(Np, enc.G)[:N]
    return screen, slack
