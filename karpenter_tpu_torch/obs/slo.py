"""Per-tenant SLO / error-budget engine (the port's copy of
`karpenter_tpu/obs/slo.py`).

The fleet funnels 50+ tenants through one queue (docs/fleet.md) with
isolation asserted by scenario-specific p99 bounds — but no DECLARED
objectives: nothing says what a tenant is owed, how much of it has been
burned, or pages when the burn rate says the budget dies early. This
module closes that: declarative `SloSpec`s evaluated over the existing
tenant-dimensioned metric families, with multi-window burn rates
(fast=5m / slow=1h of SIM time, so chaos runs evaluate on the timeline
that produced the events), error-budget gauges, and
`slo_burn_alerts_total` firings that also land an `slo.burn` trace in
the flight-recorder ring — the alert arrives with its evidence.

Indicators are cumulative (good, total) event counts read from the
process registry; the engine snapshots them on its own clock and works
in deltas, so budgets are PER RUN (baselined at engine construction)
even though the registry is process-cumulative across seeded repeats —
which is what keeps `make fleet-audit`'s repeat contract intact with
the observatory enabled.

Alert condition: classic multi-window — fast-window burn >= fast
threshold AND slow-window burn >= slow threshold. Edge-triggered per
(slo, tenant): one alert per excursion, re-armed when burn subsides.

The fleet noisy-neighbor invariant reads as: the victim tenants' budget
gauges stay high while the noisy tenant's burns and alerts
(fleet/scenarios._noisy_analyze asserts both).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .exposition import register_debug_route
from .tracer import TRACER, Span, Trace

Indicator = Callable[[str], Tuple[float, float]]  # tenant -> (good, total)


@dataclass(frozen=True)
class SloSpec:
    """One declared objective: `objective` is the target good/total
    ratio; `indicator(tenant)` returns CUMULATIVE (good, total) event
    counts for that tenant (monotone non-decreasing)."""

    name: str
    objective: float
    indicator: Indicator
    description: str = ""

    @property
    def allowance(self) -> float:
        return max(1e-9, 1.0 - self.objective)


def default_slos(latency_wait_ms: float = 25.0) -> List[SloSpec]:
    """The standing objective set over the families every tenant already
    emits. Thresholds are deliberately modest — these are floors the
    fair scheduler should clear easily; burning one means isolation or
    the warm path actually regressed."""
    from ..metrics import (FLEET_SOLVE_WAIT, FLEET_SOLVES, FLEET_THROTTLED,
                           WARMPATH_AUDITS, WARMPATH_DECISIONS)

    def solve_latency(tenant: str) -> Tuple[float, float]:
        total = float(FLEET_SOLVE_WAIT.total(tenant=tenant))
        good = float(FLEET_SOLVE_WAIT.cumulative_le(latency_wait_ms,
                                                    tenant=tenant))
        return good, total

    def availability(tenant: str) -> Tuple[float, float]:
        served = FLEET_SOLVES.value(tenant=tenant)
        throttled = FLEET_THROTTLED.value(tenant=tenant)
        return served, served + throttled

    def warm_hit(tenant: str) -> Tuple[float, float]:
        good = (WARMPATH_DECISIONS.sum(path="warm", tenant=tenant)
                + WARMPATH_DECISIONS.sum(path="mixed", tenant=tenant))
        return good, WARMPATH_DECISIONS.sum(tenant=tenant)

    def audit_clean(tenant: str) -> Tuple[float, float]:
        total = WARMPATH_AUDITS.sum(tenant=tenant)
        return WARMPATH_AUDITS.sum(outcome="clean", tenant=tenant), total

    return [
        SloSpec("solve_latency", 0.90, solve_latency,
                f"solve virtual queueing delay <= {latency_wait_ms:g}ms "
                "for >=90% of dispatches"),
        SloSpec("solve_availability", 0.95, availability,
                "solve submissions served (not throttled by the "
                "in-flight cap) for >=95% of attempts"),
        SloSpec("warm_hit_rate", 0.50, warm_hit,
                "warm or mixed admission for >=50% of provisioner "
                "decisions (only meaningful with the warm path on)"),
        SloSpec("audit_divergence", 0.999, audit_clean,
                "warm-path audits clean for >=99.9% of replays"),
    ]


class _History:
    """Time-ordered (t, good, total) snapshots with MONOTONE window-start
    pointers: snapshots only append and windows only move forward, so
    finding each window's earliest in-window snapshot is amortized O(1)
    per tick instead of a linear rescan (a 100-tenant fleet evaluates
    hundreds of these per tick)."""

    __slots__ = ("pts", "fast_i", "slow_i")

    def __init__(self):
        self.pts: List[Tuple[float, float, float]] = []
        self.fast_i = 0
        self.slow_i = 0

    def append(self, now: float, good: float, total: float,
               fast_window: float, slow_window: float) -> None:
        self.pts.append((now, good, total))
        last = len(self.pts) - 1
        while (self.fast_i < last
               and now - self.pts[self.fast_i][0] > fast_window):
            self.fast_i += 1
        while (self.slow_i < last
               and now - self.pts[self.slow_i][0] > slow_window):
            self.slow_i += 1
        # compact dead prefix occasionally (everything before slow_i is
        # outside both windows forever)
        if self.slow_i > 4096:
            del self.pts[:self.slow_i]
            self.fast_i -= self.slow_i
            self.slow_i = 0

    def window_delta(self, fast: bool) -> Tuple[float, float]:
        """(good delta, total delta) from the window's earliest
        in-window snapshot to the latest."""
        i = self.fast_i if fast else self.slow_i
        t0, g0, n0 = self.pts[i]
        _t1, g1, n1 = self.pts[-1]
        return g1 - g0, n1 - n0


class SloEngine:
    """Evaluates declared objectives for a set of tenants on a clock."""

    FAST_WINDOW = 300.0     # 5m of sim time
    SLOW_WINDOW = 3600.0    # 1h of sim time
    FAST_BURN = 4.0         # fast-window burn threshold
    SLOW_BURN = 1.0         # slow-window burn threshold
    # minimum sim-seconds between evaluations: sub-second cadence buys
    # nothing against 5m/1h windows, and indicator reads aren't free at
    # fleet scale (the runner calls tick() every loop iteration)
    MIN_INTERVAL = 1.0

    def __init__(self, clock, slos: Optional[List[SloSpec]] = None,
                 tenants: Tuple[str, ...] = (),
                 fast_window: Optional[float] = None,
                 slow_window: Optional[float] = None,
                 fast_burn: Optional[float] = None,
                 slow_burn: Optional[float] = None,
                 min_interval: Optional[float] = None):
        self.clock = clock
        self.slos = list(slos) if slos is not None else default_slos()
        self.fast_window = (self.FAST_WINDOW if fast_window is None
                            else fast_window)
        self.slow_window = (self.SLOW_WINDOW if slow_window is None
                            else slow_window)
        self.fast_burn = self.FAST_BURN if fast_burn is None else fast_burn
        self.slow_burn = self.SLOW_BURN if slow_burn is None else slow_burn
        self.min_interval = (self.MIN_INTERVAL if min_interval is None
                             else min_interval)
        self.tenants: List[str] = []
        self._history: Dict[Tuple[str, str], _History] = {}
        # (slo, tenant) -> (good, total) at engine construction: the
        # per-run budget baseline over a process-cumulative registry
        self._baseline: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._alerting: set = set()
        self._last_eval: Optional[float] = None
        self.alerts: List[dict] = []
        for t in tenants:
            self.add_tenant(t)
        register_debug_route("/debug/slo",
                             lambda eng, query: eng.payload(query),
                             owner=self)

    def add_tenant(self, tenant: str) -> None:
        if tenant in self.tenants:
            return
        self.tenants.append(tenant)
        for slo in self.slos:
            key = (slo.name, tenant)
            self._baseline[key] = slo.indicator(tenant)
            self._history[key] = _History()

    # --- evaluation -------------------------------------------------------
    def tick(self, now: Optional[float] = None,
             force: bool = False) -> List[dict]:
        """Snapshot every indicator and evaluate burn/budget; returns
        alerts fired by THIS evaluation (also appended to self.alerts).
        Rate-limited to one evaluation per `min_interval` sim-seconds
        unless `force`d (the runner forces a final evaluation)."""
        from ..metrics import (SLO_BURN_ALERTS, SLO_BURN_RATE,
                               SLO_ERROR_BUDGET)
        now = float(self.clock.now()) if now is None else float(now)
        if (not force and self._last_eval is not None
                and now - self._last_eval < self.min_interval):
            return []
        self._last_eval = now
        fired: List[dict] = []
        for slo in self.slos:
            for tenant in self.tenants:
                key = (slo.name, tenant)
                good, total = slo.indicator(tenant)
                hist = self._history[key]
                hist.append(now, good, total,
                            self.fast_window, self.slow_window)
                burn_fast = self._burn(slo, hist, fast=True)
                burn_slow = self._burn(slo, hist, fast=False)
                SLO_BURN_RATE.set(burn_fast, slo=slo.name, window="fast",
                                  tenant=tenant)
                SLO_BURN_RATE.set(burn_slow, slo=slo.name, window="slow",
                                  tenant=tenant)
                budget = self.budget(slo, tenant, good, total)
                SLO_ERROR_BUDGET.set(budget, slo=slo.name, tenant=tenant)
                alerting = (burn_fast >= self.fast_burn
                            and burn_slow >= self.slow_burn)
                if alerting and key not in self._alerting:
                    self._alerting.add(key)
                    alert = {"slo": slo.name, "tenant": tenant, "at": now,
                             "burn_fast": round(burn_fast, 3),
                             "burn_slow": round(burn_slow, 3),
                             "budget_remaining": round(budget, 4)}
                    self.alerts.append(alert)
                    fired.append(alert)
                    SLO_BURN_ALERTS.inc(slo=slo.name, tenant=tenant)
                    self._flight_record(alert)
                elif not alerting:
                    self._alerting.discard(key)
        return fired

    def _burn(self, slo: SloSpec, hist: _History, fast: bool) -> float:
        """Bad-event rate over the window / the objective's allowance."""
        if not hist.pts:
            return 0.0
        dg, dn = hist.window_delta(fast)
        if dn <= 0:
            return 0.0
        bad_rate = max(0.0, dn - dg) / dn
        return bad_rate / slo.allowance

    def budget(self, slo: SloSpec, tenant: str,
               good: Optional[float] = None,
               total: Optional[float] = None) -> float:
        """Error budget remaining since the engine's baseline, in
        [-inf, 1]: 1 = untouched, 0 = exhausted, negative = overdrawn."""
        if good is None or total is None:
            good, total = slo.indicator(tenant)
        g0, n0 = self._baseline.get((slo.name, tenant), (0.0, 0.0))
        dn = total - n0
        if dn <= 0:
            return 1.0
        bad = max(0.0, dn - (good - g0))
        return 1.0 - (bad / dn) / slo.allowance

    def budgets(self) -> Dict[str, Dict[str, float]]:
        """tenant -> {slo: budget remaining} for reports/assertions."""
        return {t: {s.name: round(self.budget(s, t), 4) for s in self.slos}
                for t in self.tenants}

    def _flight_record(self, alert: dict) -> None:
        """Land an slo.burn marker in the flight-recorder ring — works
        with tracing disabled too (the ring accepts direct offers), so a
        chaos run's alert evidence survives without span overhead."""
        marker = Span(name="slo.burn",
                      trace_id=f"sloburn-{alert['tenant']}-"
                               f"{alert['slo']}-{int(alert['at'])}",
                      span_id=0, parent_id=None, t0=0.0,
                      t1=alert["burn_fast"] / 1e3, ts=alert["at"],
                      attrs=dict(alert))
        TRACER.recorder.offer(Trace(trace_id=marker.trace_id,
                                    spans=[marker]), meter=False)

    # --- exposition -------------------------------------------------------
    def payload(self, query: str = "") -> dict:
        return {
            "slos": [{"name": s.name, "objective": s.objective,
                      "description": s.description} for s in self.slos],
            "windows": {"fast_s": self.fast_window,
                        "slow_s": self.slow_window,
                        "fast_burn": self.fast_burn,
                        "slow_burn": self.slow_burn},
            "budgets": self.budgets(),
            "alerts": list(self.alerts),
            "alerting_now": sorted(f"{s}/{t}" for s, t in self._alerting),
        }
