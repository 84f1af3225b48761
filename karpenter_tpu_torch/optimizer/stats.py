"""Process-global optimizer meter — the observability face of the search.

The port's own copy of `karpenter_tpu/optimizer/stats.py`. One meter per
process (like the `obs.profile.LEDGER` / `obs.devicemem` ledgers): the disruption controllers of every tenant shard record their
subset-search and exact-verify outcomes here under the live tenant scope
(metrics/tenant.py), and the watchdog's `optimizer_divergence` invariant
reads the per-tenant reject streaks — a relaxation ranking that keeps
proposing subsets the exact solver rejects has diverged from solve
semantics and must be visible the moment it happens, not after a bench
run.
"""

from __future__ import annotations

import threading
from typing import Dict


class OptimizerMeter:
    """Per-tenant counters for the global disruption optimizer:

    - ``scored``      subsets scored by the tournament kernel
    - ``verified``    exact `Solver.solve()` verifications attempted
    - ``accepted``    verifications that confirmed the subset (executed)
    - ``rejected``    verifications the exact solver refused
    - ``reject_streak`` consecutive rejects since the last accept — the
      watchdog's divergence signal (an accept resets it to zero)
    - ``fallbacks``   searches that degraded to the greedy path
    - ``search_s``    cumulative wall seconds spent in subset search
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict[str, float]] = {}

    def _row(self, tenant: str) -> Dict[str, float]:
        return self._tenants.setdefault(tenant, {
            "scored": 0, "verified": 0, "accepted": 0, "rejected": 0,
            "reject_streak": 0, "fallbacks": 0, "search_s": 0.0})

    @staticmethod
    def _tenant() -> str:
        from ..metrics.tenant import current_tenant
        return current_tenant()

    def record_scored(self, n: int, search_s: float = 0.0,
                      tenant: str = "") -> None:
        with self._lock:
            row = self._row(tenant or self._tenant())
            row["scored"] += int(n)
            row["search_s"] += float(search_s)

    def record_verify(self, accepted: bool, tenant: str = "") -> None:
        with self._lock:
            row = self._row(tenant or self._tenant())
            row["verified"] += 1
            if accepted:
                row["accepted"] += 1
                row["reject_streak"] = 0
            else:
                row["rejected"] += 1
                row["reject_streak"] += 1

    def record_fallback(self, tenant: str = "") -> None:
        with self._lock:
            self._row(tenant or self._tenant())["fallbacks"] += 1

    # --- read side (watchdog + reports) -----------------------------------
    def reject_streaks(self) -> Dict[str, int]:
        """tenant -> consecutive exact-verify rejects since the last
        accept — the `optimizer_divergence` observable."""
        with self._lock:
            return {t: int(r["reject_streak"])
                    for t, r in self._tenants.items()}

    def verify_hit_rate(self, tenant: str = "") -> float:
        with self._lock:
            row = self._tenants.get(tenant or self._tenant())
            if not row or not row["verified"]:
                return 0.0
            return row["accepted"] / row["verified"]

    def snapshot(self) -> dict:
        with self._lock:
            return {t: dict(r) for t, r in sorted(self._tenants.items())}

    def totals(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {
                "scored": 0, "verified": 0, "accepted": 0, "rejected": 0,
                "fallbacks": 0, "search_s": 0.0}
            for row in self._tenants.values():
                for key in out:
                    out[key] += row[key]
        return out


OPTIMIZER = OptimizerMeter()
