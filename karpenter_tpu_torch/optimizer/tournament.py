"""Batched repack tournament: score S victim subsets in one dispatch.

The port of `karpenter_tpu/optimizer/tournament.py`. The consolidation
screen (ops/consolidate.py) answers "could node n's pods re-schedule onto
the OTHERS" for every node at once; the tournament generalizes it to
SUBSETS: for each candidate subset s with victim mask m_s ∈ {0,1}^N,

    need_s[g]   = Σ_{n∈s} counts[n, g]          pods to rehome
    supply_s[g] = Σ_{n∉s} k[n, g]               survivors' per-group caps
    feasible_s  = ∀g: need_s[g] ≤ supply_s[g]
    savings_s   = Σ_{n∈s} price[n]              (replacement-free repack)

where k[n, g] is the screen's per-(node, group) placement cap — computed
from the SAME CatalogTensors / EncodedPods encodings and packing, so the
tournament and the screen can never disagree about headroom. The
convex-relaxation pass (relax.py) rides the same dispatch to rank the
feasible ones by cross-group contention.

Two backends:
- **host** (numpy): `repack_inputs` + `score_subsets_host`, the
  reference's math verbatim;
- **device** (`score_subsets_device`): the screen's packing, ONE upload,
  k from kernel A (`ops/screen_k`) and everything after k in kernel C
  (`optimizer/tournament_k`), ONE packed [S·4] readback. It runs on the
  CUDA card unless the caller passes `device=` ("cpu" runs both kernels'
  plain versions). With `mesh=` the subset rows split over the mesh's
  shards (`parallel/mesh`): each shard computes k through kernel A on the
  replicated node and group matrices and runs kernel C over its own
  subset rows; the price row, which rides the last shard in the
  reference's layout, is broadcast to every shard.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import solver as _solver_mod
from ..obs import devicemem as dm
from ..ops.binpack import BIG, EPS
from ..ops.consolidate import (_pack_screen_groups, _pack_screen_nodes,
                               _screen_args, _unpack_screen, eligibility)
from ..ops.encode import align_resources
from ..ops.screen_k import screen_k
from ..ops.solver import (_auto_dcat, _put, _put_sharded, _read,
                          _request_cols, resolve_device)
from . import tournament_k
from .relax import RELAX_ITERS, relax_residuals, replacement_lower_bound


def group_slot_prices(cat, enc) -> np.ndarray:
    """[G] best $/pod-slot/hr per group — the replacement bound's rate
    card, matching the host solver's node-opening metric: over types
    compatible with the group, (cheapest offering surviving the group's
    zone/captype masks) / (pods of the group the type holds). BIG where
    no compatible available type can host the group."""
    R = enc.requests.shape[1]
    alloc = align_resources(cat.allocatable, R)             # [T, R]
    req = enc.requests.astype(np.float32)                   # [G, R]
    with_req = np.where(req > 0, req, np.float32(1.0))
    slots = np.where(req[:, None, :] > 0,
                     np.floor(alloc[None, :, :] / with_req[:, None, :]
                              + EPS),
                     np.float32(BIG)).min(axis=2)           # [G, T]
    slots = np.where(enc.compat, np.maximum(slots, 0.0), 0.0)
    # cheapest offering per (group, type) surviving the group's masks
    mask = (cat.available[None, :, :, :]
            & enc.allow_zone[:, None, :, None]
            & enc.allow_cap[:, None, None, :])              # [G, T, Z, C]
    price = np.where(mask, cat.price[None], np.inf)
    price_gt = price.reshape(enc.G, cat.T, -1).min(axis=2)  # [G, T]
    per_slot = np.where(slots > 0, price_gt / np.maximum(slots, 1.0),
                        np.inf).min(axis=1)                 # [G]
    return np.where(np.isfinite(per_slot), per_slot,
                    np.float32(BIG)).astype(np.float32)


def repack_inputs(cat, enc, views, group_counts: np.ndarray,
                  exclude: Optional[np.ndarray] = None):
    """Host-side tournament inputs, shared with the screen's
    construction (`_screen_args`) so the two headroom views are
    identical: (headroom [N, R], group_req [G, R], elig [N, G],
    k [N, G], active [N])."""
    R = enc.requests.shape[1]
    node_type, node_cum, node_zmask, node_cmask, active = _screen_args(
        cat, enc, views)
    alloc = align_resources(cat.allocatable, R)
    avail = cat.available
    req, compat = enc.requests.astype(np.float32), enc.compat
    allow_zone, allow_cap = enc.allow_zone, enc.allow_cap
    active = active.copy()
    if exclude is not None:
        active &= ~exclude
    talloc = alloc[node_type]                               # [N, R]
    headroom = (talloc - node_cum).astype(np.float32)
    ok_t = compat[:, node_type].T                           # [N, G]
    a = avail[node_type]                                    # [N, Z, C]
    off = np.einsum("nz,gz,nc,gc,nzc->ng",
                    node_zmask.astype(np.float32),
                    allow_zone.astype(np.float32),
                    node_cmask.astype(np.float32),
                    allow_cap.astype(np.float32),
                    a.astype(np.float32)) > 0               # [N, G]
    elig = ok_t & off & active[:, None]
    req = req.astype(np.float32)
    with_req = np.where(req > 0, req, np.float32(1.0))
    ratios = np.where(req[None, :, :] > 0,
                      np.floor(headroom[:, None, :] / with_req[None, :, :]
                               + EPS),
                      np.float32(BIG))                      # [N, G, R]
    k = np.where(elig, np.maximum(ratios.min(axis=2), 0.0),
                 np.float32(0.0)).astype(np.float32)
    return headroom, req, elig, k, active


def score_subsets_host(headroom: np.ndarray, group_req: np.ndarray,
                       k: np.ndarray, counts: np.ndarray,
                       prices: np.ndarray, masks: np.ndarray,
                       per_slot: np.ndarray,
                       iters: int = RELAX_ITERS,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """NumPy tournament: (feasible [S] bool — per-group replacement-free
    screen, savings [S] f32, residual [S] f32 — fractionally unplaced
    pods, repl_lb [S] f32 — replacement-cost lower bound for the
    residue)."""
    counts = counts.astype(np.float32)
    need = masks @ counts                                   # [S, G]
    supply = k.sum(axis=0)[None, :] - masks @ k             # [S, G]
    feasible = ((need <= supply + EPS) | (need == 0)).all(axis=1)
    savings = masks @ prices.astype(np.float32)             # [S]
    residual_g = relax_residuals(headroom, group_req, k, masks, need,
                                 iters=iters)               # [S, G]
    repl_lb = replacement_lower_bound(residual_g, per_slot)
    return (feasible, savings.astype(np.float32),
            np.asarray(residual_g.sum(axis=1), np.float32),
            np.asarray(repl_lb, np.float32))


# --- device path -----------------------------------------------------------
# The packed single-dispatch tournament, mirroring the screen's onebuf
# path: the node-side and group-side matrices are the screen's packing
# (ops/consolidate), the [S, N] victim masks carry the price row appended,
# and the per-slot prices ride at the end: all four in ONE upload. Output
# is one packed [S, 4] buffer (feasible, savings, residual, repl_lb) — one
# blocking read.


def tournament_onebuf(alloc, avail, nbuf, gbuf, masks, price_row, pslot,
                      cols: tuple, iters: int = RELAX_ITERS) -> torch.Tensor:
    """The port of `_tournament_impl`: unpack the screen's packing, k
    through kernel A (the screen's own k), then kernel C over the [S, N]
    victim masks. Returns the packed f32 [S*4] vector on the inputs'
    device."""
    (alloc_k, avail, node_type, node_cum, node_zmask, node_cmask, active,
     req, compat, allow_zone, allow_cap, counts) = _unpack_screen(
        alloc, avail, nbuf, gbuf, cols)
    headroom = alloc_k[node_type] - node_cum                # [N, Rk]
    elig = eligibility(avail, node_type, node_zmask, node_cmask, active,
                       compat, allow_zone, allow_cap)
    k = screen_k(headroom, req, elig)                       # [N, G]
    return tournament_k.tournament(headroom, req, k, counts, masks,
                                   price_row, pslot, iters=iters)


def score_subsets_device(cat, enc, views, group_counts: np.ndarray,
                         prices: np.ndarray, masks: np.ndarray,
                         mesh=None, iters: int = RELAX_ITERS,
                         exclude: Optional[np.ndarray] = None,
                         device=None,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Device tournament: the results of score_subsets_host (the
    relaxation's sums within rounding), one packed dispatch on `device`
    (the CUDA card unless given). `exclude` [N] strikes nodes (pending
    victims, deleting claims) from the SUPPLY side by clearing their
    active bit — the same `active &= ~exclude` the host path applies, so
    the two backends agree about who may absorb a repack. Probes the
    dispatch-fault hook at "optimizer" like every other kernel dispatch.

    mesh: split the subset rows over the mesh's shards (the reference's
    `_mesh_tournament_fn` layout; `device` is then unused): node matrix,
    group matrix and per-slot prices replicated, the [Sp + 1, N] mask
    matrix (masks, zero-mask padding, the price row last) split on its
    rows, Sp + 1 a multiple of the mesh size. Padding rows are inert (need
    0: feasible, savings 0) and dropped. The price row lands on the last
    shard and is broadcast to every shard; each shard runs A and C over its
    own mask rows (a shard whose block is the price row alone runs none),
    and the packed rows are gathered for the one read."""
    from ..parallel import collectives as col
    dev = resolve_device(device) if mesh is None else None
    if _solver_mod._dispatch_fault_hook is not None:
        _solver_mod._dispatch_fault_hook("optimizer")
    S = masks.shape[0]
    R = enc.requests.shape[1]
    cols = _request_cols(enc, cat)
    node_type, node_cum, node_zmask, node_cmask, active = _screen_args(
        cat, enc, views)
    if exclude is not None:
        active = active & ~exclude
    ms = int(mesh.size) if mesh is not None else 1
    Sp = -(-(S + 1) // ms) * ms - 1
    mbuf_np = np.zeros((Sp + 1, len(views)), np.float32)
    mbuf_np[:S] = masks
    mbuf_np[-1] = prices.astype(np.float32)
    parts = [_pack_screen_nodes(node_type, node_cum, node_zmask, node_cmask,
                                active, group_counts, list(cols)),
             _pack_screen_groups(enc.requests, enc.compat, enc.allow_zone,
                                 enc.allow_cap, list(cols)),
             mbuf_np, group_slot_prices(cat, enc)[None, :]]
    if mesh is None:
        with dm.attributed(reason="screen_upload"):
            flat = _put(np.concatenate([p.reshape(-1) for p in parts]), dev)
        nbuf, gbuf, mbuf, pslot = [
            t.view(p.shape) for t, p in zip(
                flat.split([p.size for p in parts]), parts)]
        dcat = _auto_dcat(cat, R, dev)
        buf = _read(tournament_onebuf(dcat.alloc, dcat.avail, nbuf, gbuf,
                                      mbuf[:-1], mbuf[-1], pslot[0], cols,
                                      iters))
    else:
        rep = col.Sharding(mesh)
        dcat = _auto_dcat(cat, R, mesh=mesh)
        with dm.attributed(reason="screen_upload"):
            nbuf, gbuf, pslot = (_put_sharded(p, rep) for p in
                                 (parts[0], parts[1], parts[3][0]))
            mbuf = _put_sharded(mbuf_np, col.Sharding(mesh, 0))
        price_row = col.broadcast(mbuf.parts[-1][-1], mesh)
        out = []
        for s, d in enumerate(mesh.devices):
            rows = mbuf.parts[s][:-1] if s == ms - 1 else mbuf.parts[s]
            if rows.shape[0] == 0:
                continue
            with col.on_shard(d):
                out.append(tournament_onebuf(
                    dcat.alloc.parts[s], dcat.avail.parts[s], nbuf.parts[s],
                    gbuf.parts[s], rows, price_row[s], pslot.parts[s], cols,
                    iters))
        buf = _read(col.gather(out))
    out = buf.reshape(Sp, 4)[:S]
    return (out[:, 0] > 0.5, out[:, 1].astype(np.float32),
            out[:, 2].astype(np.float32), out[:, 3].astype(np.float32))
