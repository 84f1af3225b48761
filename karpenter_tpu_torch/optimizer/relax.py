"""Convex-relaxation scoring: fractional repack of victim subsets.

The port of `karpenter_tpu/optimizer/relax.py`. The reference serves NumPy
and jax.numpy from one body through an `xp` parameter; here the body is
written twice:
- `relax_residuals`: NumPy, the host path's (a verbatim copy);
- `relax_residuals_plain`: PyTorch, the plain version beside kernel C
  (`optimizer/tournament_k.py`), which computes the same relaxation on the
  card inside the tournament.

The per-group tournament screen (tournament.py) is an over-approximation
— it checks each pod group against the survivors' headroom SEPARATELY,
so two groups that individually fit but jointly exceed a node's capacity
still screen feasible, and the exact `Solver.solve()` verification then
wastes a full re-solve rejecting them. This module scores each subset
with the natural LP relaxation of the repack instead: place FRACTIONAL
pods of each victim group onto surviving nodes, subject to per-node
multi-resource capacity and per-(node, group) eligibility caps, and
report the unplaceable fractional residue.

The relaxation is solved by projected proportional fitting (a damped
Sinkhorn-style alternation between the group-demand constraints and the
node-capacity simplex), a fixed small number of iterations.

residual == 0  ⇒ the subset is fractionally repackable (cross-group
                 contention included) — verify it first;
residual >> 0  ⇒ the per-group screen was fooled; rank it last (and
                 usually never spend an exact solve on it).
"""

from __future__ import annotations

import numpy as np
import torch

RELAX_ITERS = 6
_BIG = np.float32(1e9)
_EPS = np.float32(1e-6)


def relax_residuals(headroom, group_req, k, masks, need,
                    iters: int = RELAX_ITERS):
    """Fractional-repack residue per subset (NumPy).

    headroom  [N, R]  survivors' free capacity (victims' rows are dead
                      weight — their columns are zeroed via `masks`)
    group_req [G, R]  per-pod resource vector per group
    k         [N, G]  per-(node, group) placement cap (eligibility +
                      single-resource fit, the screen's k)
    masks     [S, N]  victim masks (1.0 = evicted)
    need      [S, G]  pods of each group the subset must rehome

    Returns residual [S, G] — fractional pods of each group with no
    feasible home (all-zero row = fractionally repackable). All
    float32, no in-place ops."""
    headroom = np.maximum(headroom, 0.0)
    surv = 1.0 - masks                                    # [S, N]
    cap = surv[:, :, None] * k[None, :, :]                # [S, N, G]
    denom = cap.sum(axis=1) + _EPS                        # [S, G]
    x = cap * (need / denom)[:, None, :]                  # proportional seed
    for _ in range(int(iters)):
        load = np.einsum("sng,gr->snr", x, group_req)     # [S, N, R]
        ratio = np.where(load > _EPS,
                         headroom[None, :, :] / np.maximum(load, _EPS),
                         _BIG)
        scale = np.clip(ratio.min(axis=2), 0.0, 1.0)      # [S, N]
        x = x * scale[:, :, None]                         # capacity proj
        deficit = np.maximum(need - x.sum(axis=1), 0.0)   # [S, G]
        slack = np.maximum(cap - x, 0.0)                  # [S, N, G]
        sden = slack.sum(axis=1) + _EPS
        x = x + slack * (deficit / sden)[:, None, :]      # demand proj
    # one last capacity projection, then measure what never found a home
    load = np.einsum("sng,gr->snr", x, group_req)
    ratio = np.where(load > _EPS,
                     headroom[None, :, :] / np.maximum(load, _EPS), _BIG)
    scale = np.clip(ratio.min(axis=2), 0.0, 1.0)
    x = x * scale[:, :, None]
    return np.maximum(need - x.sum(axis=1), 0.0)       # [S, G]


def sum_over_nodes(t: torch.Tensor) -> torch.Tensor:
    """[S, N, G] -> [S, G]: the sum over nodes, added one node at a time in
    node order (kernel C's order, so the two agree bit for bit)."""
    acc = torch.zeros_like(t[:, 0, :])
    for n in range(t.shape[1]):
        acc = acc + t[:, n, :]
    return acc


def _capacity_scale(x: torch.Tensor, group_req: torch.Tensor,
                    headroom: torch.Tensor) -> torch.Tensor:
    """[S, N] factor that brings each survivor's fractional load under its
    headroom: clip(min_r headroom / load, 0, 1), BIG where a column is
    unloaded. The load sums over groups in group order, as kernel C."""
    S, N, G = x.shape
    load = torch.zeros((S, N, group_req.shape[1]), dtype=x.dtype,
                       device=x.device)
    for g in range(G):
        load = load + x[:, :, g, None] * group_req[g]
    ratio = torch.where(load > float(_EPS),
                        headroom[None, :, :] / load.clamp_min(float(_EPS)),
                        torch.full_like(load, float(_BIG)))
    return ratio.amin(dim=2).clamp(0.0, 1.0)


def relax_residuals_plain(headroom: torch.Tensor, group_req: torch.Tensor,
                          k: torch.Tensor, masks: torch.Tensor,
                          need: torch.Tensor,
                          iters: int = RELAX_ITERS) -> torch.Tensor:
    """`relax_residuals` in PyTorch ops, f32 on any device: the plain
    version of the relaxation kernel C runs (same arguments, residual
    [S, G]). Every sum runs in kernel C's order (nodes in node order,
    groups in group order), so the two agree bit for bit; against the
    reference's XLA and NumPy orders they agree within rounding."""
    headroom = headroom.clamp_min(0.0)
    surv = 1.0 - masks
    cap = surv[:, :, None] * k[None, :, :]
    denom = sum_over_nodes(cap) + float(_EPS)
    x = cap * (need / denom)[:, None, :]
    for _ in range(int(iters)):
        x = x * _capacity_scale(x, group_req, headroom)[:, :, None]
        deficit = (need - sum_over_nodes(x)).clamp_min(0.0)
        slack = (cap - x).clamp_min(0.0)
        sden = sum_over_nodes(slack) + float(_EPS)
        x = x + slack * (deficit / sden)[:, None, :]
    x = x * _capacity_scale(x, group_req, headroom)[:, :, None]
    return (need - sum_over_nodes(x)).clamp_min(0.0)


def replacement_lower_bound(residual, per_slot):
    """$/hr estimate of the NEW capacity a subset's fractionally
    unplaceable residue would force open: residual pods per group
    priced at that group's best price-per-slot — the SAME
    price-per-pod-slot metric the exact solver opens nodes with
    (ops/binpack solve_host step 2), so the ranking and the verdict
    share one cost model. Exact pricing belongs to `Solver.solve()` —
    this only decides who gets a slot in the verify budget.

    residual [S, G] (relax_residuals), per_slot [G] ($/pod-slot/hr,
    BIG where no type can host the group). Returns [S]."""
    return residual @ per_slot                          # [S]
