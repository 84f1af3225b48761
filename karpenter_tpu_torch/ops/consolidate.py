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
plain PyTorch on the device. Multi-device (`mesh=`) is not ported.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .encode import CatalogTensors, EncodedPods, align_zone_overhead
from .screen_k import screen_k
from .solver import (_auto_dcat, _put, _request_cols, reject_mesh,
                     resolve_device)


def _screen_body(alloc, avail, node_type, node_cum, node_zmask, node_cmask,
                 node_active, group_req, compat, allow_zone, allow_cap,
                 node_groups) -> torch.Tensor:
    """ONE packed f32 vector: [0:N] screen (1.0 = candidate may
    consolidate), [N:N+N*G] headroom slack (others' capacity minus need,
    row-major [N, G]). The port of `_screen_kernel_impl`."""
    N = node_type.shape[0]
    G = group_req.shape[0]
    Z, C = allow_zone.shape[1], allow_cap.shape[1]
    talloc = alloc[node_type]                                 # [N, R]
    headroom = talloc - node_cum                              # [N, R]
    ok_t = compat.T[node_type]                                # [N, G]
    # an available offering surviving both masks: the reference's f32
    # einsum "nz,gz,nc,gc,nzc->ng" > 0, computed here as a boolean any
    # (exact, and no TF32 question arises)
    nzc = avail[node_type] & node_zmask[:, :, None] & node_cmask[:, None, :]
    gzc = allow_zone[:, :, None] & allow_cap[:, None, :]      # [G, Z, C]
    off = (nzc.reshape(N, 1, Z * C) & gzc.reshape(1, G, Z * C)).any(dim=2)
    elig = ok_t & off & node_active[:, None]                  # [N, G]
    k = screen_k(headroom, group_req, elig)                   # [N, G]
    total = k.sum(dim=0)                                      # [G]
    others = total[None, :] - k                               # [N, G]
    need = node_groups.to(torch.float32)                      # [N, G]
    screen = ((need <= others) | (need == 0)).all(dim=1) & node_active
    return torch.cat([screen.to(torch.float32), (others - need).reshape(-1)])


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


def _screen_onebuf(alloc, avail, nbuf, gbuf, cols: tuple) -> torch.Tensor:
    """Unpack by static offsets (resource columns projected to `cols`) and
    run the screen body."""
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
    return _screen_body(alloc_k, avail, node_type, node_cum, node_zmask,
                        node_cmask, active, req, compat, allow_zone,
                        allow_cap, counts)


def _screen_args(cat: CatalogTensors, enc: EncodedPods, views):
    """Numpy node-side screen inputs (the reference's `_screen_args`, one
    device): type, cum (zone reservation charged), zone and captype
    masks, active flags."""
    R = enc.requests.shape[1]
    N = len(views)
    node_type = np.zeros(N, np.int32)
    node_cum = np.zeros((N, R), np.float32)
    node_zmask = np.zeros((N, cat.Z), bool)
    node_cmask = np.zeros((N, cat.C), bool)
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
    return node_type, node_cum, node_zmask, node_cmask, np.ones(N, bool)


def screen_packed(cat: CatalogTensors, enc: EncodedPods, views: "List",
                  group_counts: np.ndarray, device=None) -> torch.Tensor:
    """The packed screen vector, still on the device (two uploads: the
    node-side and group-side matrices; the catalog rides the per-catalog
    device cache)."""
    dev = resolve_device(device)
    R = enc.requests.shape[1]
    cols = _request_cols(enc, cat)
    nbuf = _put(_pack_screen_nodes(*_screen_args(cat, enc, views),
                                   group_counts, list(cols)), dev)
    gbuf = _put(_pack_screen_groups(enc.requests, enc.compat, enc.allow_zone,
                                    enc.allow_cap, list(cols)), dev)
    dcat = _auto_dcat(cat, R, dev)
    return _screen_onebuf(dcat.alloc, dcat.avail, nbuf, gbuf, cols)


def consolidation_screen(cat: CatalogTensors, enc: EncodedPods,
                         views: "List", group_counts: np.ndarray,
                         device=None, mesh=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """views: `state.cluster.NodeView`s (only `.virtual` is read);
    group_counts [N, G] = pods of group g on node n. Returns (screen [N]
    bool, slack [N, G]), after ONE host read."""
    reject_mesh(mesh)
    dev = resolve_device(device)
    N = len(views)
    if N == 0:
        return np.zeros(0, bool), np.zeros((0, enc.G), np.float32)
    from . import solver as _solver_mod
    # same fault seam as the solve kernels: a fault plan can take the
    # device out at screen dispatch too (the disruption controller meters
    # an InjectedFault and degrades to cost order; anything else raises)
    if _solver_mod._dispatch_fault_hook is not None:
        _solver_mod._dispatch_fault_hook("screen")
    buf = screen_packed(cat, enc, views, group_counts, dev).cpu().numpy()
    screen = buf[:N] > 0.5
    slack = buf[N: N + N * enc.G].reshape(N, enc.G)
    return screen, slack
