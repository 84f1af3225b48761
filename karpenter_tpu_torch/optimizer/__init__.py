"""Global disruption optimizer: combinatorial repack search.

The port of `karpenter_tpu/optimizer/`. Consolidation's greedy multi-node
pass only considers PREFIXES of the cost-ordered candidate list, so
savings that require JOINT eviction of a non-prefix subset are invisible
to it. This package turns consolidation into a global search:

1. **subsets.py** — a seeded candidate-subset generator (exhaustive for
   small pools, slack-guided + hash-sampled past the budget) producing
   a batched [S, N] victim-mask tensor;
2. **tournament.py** — a repack-feasibility + cost-delta tournament
   scoring all S subsets in ONE dispatch, reusing the screen's
   CatalogTensors/EncodedPods encodings and packing; on the device, k is
   kernel A (`ops/screen_k`) and the rest kernel C
   (`optimizer/tournament_k`, `csrc/tournament.cu`);
3. **relax.py** — an LP/convex-relaxation scoring pass (fractional
   repack by projected proportional fitting) that ranks the feasible
   subsets by cross-group contention BEFORE the handful of exact
   `Solver.solve()` verifications;
4. integration behind `KARPENTER_TPU_OPTIMIZER` (default: armed) in
   `DisruptionController._multi_node` (=0 restores the greedy path
   byte-for-byte). Every EXECUTED disruption still passes a real exact
   solve — the optimizer only proposes; `Solver.solve()` disposes.

Observability: `consolidation_savings_total{source}` meters realized
$/hr by decision source, `optimizer_subsets_total{event}` the search
funnel, and `stats.OPTIMIZER` the per-tenant search and verify counts.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .relax import RELAX_ITERS
from .stats import OPTIMIZER
from .subsets import MAX_K, MAX_SUBSETS, evictability, generate_subsets
from .tournament import (group_slot_prices, repack_inputs,
                         score_subsets_device, score_subsets_host)

OPTIMIZER_ENV = "KARPENTER_TPU_OPTIMIZER"
# relaxation tensor budget (S*N*G elements): the subset batch shrinks
# before the [S, N, G] fractional-repack tensor outgrows memory
RELAX_BUDGET = 8_000_000
# residual (fractional unplaced pods) below this counts as "fractionally
# repackable" for ranking purposes
RESIDUAL_EPS = 1e-3
# exact verifications attempted per pass, independent of subset count
VERIFY_LIMIT = 8


def optimizer_enabled() -> bool:
    """The opt-out gate: KARPENTER_TPU_OPTIMIZER=0 restores the greedy
    multi-node path byte-for-byte (default: armed)."""
    return os.environ.get(OPTIMIZER_ENV, "1") not in ("0", "false", "no")


@dataclass
class RepackPlan:
    """Ranked output of one subset search: `subsets` are view-index
    tuples ordered by expected value (feasible, low relaxation residual,
    high savings first) — the exact-verify queue."""

    subsets: List[Tuple[int, ...]] = field(default_factory=list)
    savings: List[float] = field(default_factory=list)
    residuals: List[float] = field(default_factory=list)
    scored: int = 0
    feasible: int = 0
    exhaustive: bool = True
    backend: str = "host"
    search_s: float = 0.0


def rank_subsets(feasible: np.ndarray, savings: np.ndarray,
                 residual: np.ndarray, repl_lb: np.ndarray):
    """The verify order of S scored subsets: (indices ranked, the
    replacement-free mask). Two tiers in one ranking: replacement-FREE
    repacks (per-group feasible AND ~zero fractional residue) by gross
    savings, then replacement-BACKED subsets (residue priced by the lower
    bound) by NET savings — the exact solve re-prices both, this only
    decides who gets a slot in the verify budget. f32 throughout, ties in
    generation order."""
    repack_free = feasible & (residual <= RESIDUAL_EPS)
    net = savings - repl_lb
    value = np.where(repack_free, np.float32(1e6) + savings,
                     np.where(net > 0, net, np.float32(-1.0)))
    order = [int(i) for i in np.argsort(-value, kind="stable")
             if value[i] > 0]
    return order, repack_free


def plan_repack(cat, enc, views: Sequence, counts: np.ndarray,
                slack: np.ndarray, candidate_idx: Sequence[int],
                max_k: int = MAX_K, *,
                exclude: Optional[np.ndarray] = None,
                use_device: bool = False, mesh=None, device=None,
                max_subsets: int = MAX_SUBSETS,
                iters: int = RELAX_ITERS, seed: int = 0) -> RepackPlan:
    """Run the tournament over subsets of `candidate_idx` (positions in
    `views`) and return the ranked exact-verify queue. Deterministic for
    fixed inputs. `use_device` scores on `device` (the CUDA card unless
    given) through kernels A and C, else on the host in NumPy; with a
    `mesh` the subset rows split over its shards (stats backend "mesh")."""
    t0 = time.perf_counter()
    N = len(views)
    prices = np.array([float(v.price) for v in views], np.float32)
    G = max(int(enc.G), 1)
    cap = max(16, RELAX_BUDGET // max(N * G, 1))
    max_subsets = min(max_subsets, cap)
    per_slot = group_slot_prices(cat, enc)
    guide = evictability(slack, counts, prices, candidate_idx, per_slot)
    subs, exhaustive = generate_subsets(len(candidate_idx), guide,
                                        max_k=max_k,
                                        max_subsets=max_subsets, seed=seed)
    if not subs:
        return RepackPlan(backend="host")
    cand = np.asarray(list(candidate_idx), np.int64)
    masks = np.zeros((len(subs), N), np.float32)
    for si, s in enumerate(subs):
        masks[si, cand[list(s)]] = 1.0
    if use_device:
        feasible, savings, residual, repl_lb = score_subsets_device(
            cat, enc, views, counts, prices, masks, mesh=mesh,
            iters=iters, exclude=exclude, device=device)
        backend = "mesh" if mesh is not None else "device"
        if exclude is not None and exclude.any():
            # supply-side exclusion rode the active bit into the kernel
            # (same as the host path); subsets CONTAINING an excluded
            # node as a victim are struck host-side
            bad = masks[:, exclude].any(axis=1)
            feasible = feasible & ~bad
            savings = np.where(bad, np.float32(0.0), savings)
    else:
        headroom, group_req, _elig, k, _active = repack_inputs(
            cat, enc, views, counts, exclude=exclude)
        feasible, savings, residual, repl_lb = score_subsets_host(
            headroom, group_req, k, counts, prices, masks, per_slot,
            iters=iters)
        backend = "host"
    order, repack_free = rank_subsets(feasible, savings, residual, repl_lb)
    search_s = time.perf_counter() - t0
    plan = RepackPlan(
        subsets=[tuple(int(c) for c in cand[list(subs[i])])
                 for i in order],
        savings=[float(savings[i]) for i in order],
        residuals=[float(residual[i]) for i in order],
        scored=len(subs), feasible=int(np.count_nonzero(repack_free)),
        exhaustive=exhaustive, backend=backend, search_s=search_s)
    OPTIMIZER.record_scored(len(subs), search_s)
    from ..metrics import OPTIMIZER_SUBSETS
    OPTIMIZER_SUBSETS.inc(len(subs), event="scored")
    return plan


__all__ = ["OPTIMIZER", "OPTIMIZER_ENV", "RepackPlan", "RELAX_BUDGET",
           "RESIDUAL_EPS", "MAX_K", "MAX_SUBSETS", "VERIFY_LIMIT",
           "optimizer_enabled", "plan_repack", "rank_subsets",
           "repack_inputs",
           "generate_subsets", "evictability"]
