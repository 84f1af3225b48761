"""Canary dual-path solves: catch FEASIBLE-but-wrong device results.

The feasibility oracle proves a placement is legal; it cannot prove it
is the placement the policy would have chosen. A corrupted price or
availability tensor (or a systematically mis-compiled kernel) produces
placements that pass every feasibility check while quietly paying more
or stranding pods the host path would have placed. The canary closes
that gap: a deterministic, rate-limited sampler re-solves ~1/K device
solves through `ops.binpack.solve_host` (the numpy ground truth the
golden tests trust) and compares COST-EQUIVALENCE-wise:

- total launch cost within a float tolerance,
- per-group unschedulable counts exactly,
- per-group placed counts exactly (launch-cost ties may break toward a
  different node composition, but cost-equivalent solutions place the
  same pods).

Never byte-wise: argmin ties may break differently between backends, so
node ordering and override lists are out of scope — the golden tests
own bitwise parity, the canary owns "the device path has not drifted
from policy".

Determinism: the sampler is count-based per facade (every K-th eligible
solve), so chaos repeat contracts see identical canary schedules; the
host re-solve is pure compute (no RNG, no cloud calls, no fault-seam
probes), so end-state hashes and fault fingerprints are untouched.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .oracle import Violation

COST_ATOL = 1e-3
COST_RTOL = 1e-5


def _fingerprint(enc, result) -> Tuple[float, tuple, tuple]:
    """(total launch cost, per-group placed, per-group unschedulable)."""
    G = int(enc.G)
    placed = np.zeros(G, np.int64)
    for node in result.nodes:
        for g, cnt in node.pods_by_group.items():
            if 0 <= g < G:
                placed[g] += cnt
    unsched = np.zeros(G, np.int64)
    for g, cnt in result.unschedulable.items():
        if 0 <= g < G:
            unsched[g] = cnt
    cost = float(sum(l[3] for l in (result.launches or [])
                     if np.isfinite(l[3])))
    return cost, tuple(placed.tolist()), tuple(unsched.tolist())


def compare_results(enc, device_result, host_result) -> Optional[str]:
    """None = cost-equivalent; otherwise a human-readable disagreement."""
    d_cost, d_placed, d_unsched = _fingerprint(enc, device_result)
    h_cost, h_placed, h_unsched = _fingerprint(enc, host_result)
    if d_unsched != h_unsched:
        diff = [g for g in range(len(d_unsched))
                if d_unsched[g] != h_unsched[g]]
        return (f"unschedulable counts diverge on groups {diff[:4]}: "
                f"device={[d_unsched[g] for g in diff[:4]]} "
                f"host={[h_unsched[g] for g in diff[:4]]}")
    if d_placed != h_placed:
        diff = [g for g in range(len(d_placed))
                if d_placed[g] != h_placed[g]]
        return (f"placed counts diverge on groups {diff[:4]}: "
                f"device={[d_placed[g] for g in diff[:4]]} "
                f"host={[h_placed[g] for g in diff[:4]]}")
    if not np.isclose(d_cost, h_cost, rtol=COST_RTOL, atol=COST_ATOL):
        return (f"launch cost diverges: device={d_cost:.6f}/hr "
                f"host={h_cost:.6f}/hr")
    return None


class CanarySampler:
    """Per-facade deterministic 1/K sampler. `due()` advances the
    counter; `check()` runs the host re-solve and returns the canary
    violations (empty = agreement)."""

    def __init__(self, every: Optional[int] = None):
        self._every = every
        self._count = 0

    def due(self) -> bool:
        from . import canary_every
        every = self._every if self._every is not None else canary_every()
        if every <= 0:
            return False
        self._count += 1
        return self._count % every == 0

    @staticmethod
    def check(cat, enc, result) -> List[Violation]:
        """Fresh-nodes solves only (the call site gates on no existing
        nodes): the cost-equivalence comparison assumes both paths open
        the same empty fleet — resumed occupancy can break ties
        differently per group and would need its own comparator."""
        from ..ops.binpack import solve_host
        from . import INTEGRITY
        host = solve_host(cat, enc)
        disagreement = compare_results(enc, result, host)
        INTEGRITY.record_canary(disagreement is None)
        if disagreement is None:
            return []
        return [Violation("canary", disagreement)]
