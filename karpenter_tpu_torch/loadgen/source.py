"""OpenLoopSource: emit a LoadPlan's arrivals onto a live shard.

The port's own copy of `karpenter_tpu/loadgen/source.py`, semantics unchanged.

The generator half of the traffic plane: installed on a shard's engine
(one hook, same seam the chaos bursts use), it drains the materialized
schedule as sim time passes and routes every due batch through the
fleet's `AdmissionController` — WITHOUT waiting for the control plane
to drain. Admitted batches become pending pods in the shard's store;
deferred batches park in a due-time queue and re-offer after their
seed-deterministic backoff; shed batches are dropped and metered. Every
fate lands on the plan's canonical ledger, so the soak repeat contract
covers the shed/defer set byte-for-byte.

The source also publishes the OVERLOAD OBSERVABLE the watchdog's
`overload_unbounded` invariant reads: the tenant's waiting-pod depth
(pending in the store + parked in the deferred queue), the age of the
oldest still-waiting batch, and the admission budget that should bound
it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..metrics import LOADGEN_ARRIVALS, LOADGEN_BACKLOG
from .plan import Arrival, LoadPlan


@dataclass
class _Deferred:
    due: float                # absolute sim time of the next re-offer
    attempts: int             # re-offers already consumed
    first_offer: float        # absolute sim time of the FIRST offer
    arrival: Arrival

    # deterministic queue order: due time, then schedule key
    def sort_key(self):
        return (self.due, self.arrival.key)


class OpenLoopSource:
    """One per (LoadPlan, tenant shard). Construction materializes the
    plan, stamps its origin off the shard clock (aligned with the
    FaultPlan origin when one is armed, so arrival times and fault times
    share a timebase), publishes the workload horizon for quiet(), and
    installs the emit hook."""

    def __init__(self, plan: LoadPlan, sim, tenant: str, admission,
                 name_prefix: str = "lg"):
        self.plan = plan.materialize()
        self.sim = sim
        self.tenant = tenant
        self.admission = admission
        self.name_prefix = name_prefix
        self.plan.origin = (sim.fault_plan.origin
                            if sim.fault_plan is not None
                            else float(sim.clock.now()))
        self._next = 0                      # schedule cursor
        self._deferred: List[_Deferred] = []
        self.stats: Dict[str, float] = {
            "batches": 0, "offered_pods": 0, "admitted_pods": 0,
            "deferred_pods": 0, "shed_pods": 0, "reoffers": 0}
        # keep the run open until the last scheduled arrival has fired
        # (the open-loop analog of fleet/scenarios._waved's horizon)
        horizon = self.plan.origin + self.plan.horizon
        sim.fleet_workload_horizon = max(
            getattr(sim, "fleet_workload_horizon", 0.0), horizon)
        sim.engine.add_hook(self._on_tick)

    # --- emission ---------------------------------------------------------
    def _on_tick(self, now: float) -> None:
        # re-offers first (their due times predate this tick), in
        # deterministic (due, key) order
        if self._deferred:
            self._deferred.sort(key=_Deferred.sort_key)
            while self._deferred and self._deferred[0].due <= now:
                d = self._deferred.pop(0)
                self.stats["reoffers"] += 1
                self._offer(now, d.arrival, attempts=d.attempts,
                            first_offer=d.first_offer)
        sched = self.plan.schedule
        while self._next < len(sched) \
                and self.plan.origin + sched[self._next].t <= now:
            a = sched[self._next]
            self._next += 1
            self.stats["batches"] += 1
            self.stats["offered_pods"] += a.pods
            self.plan.record(now, "arrive", f"{a.key}x{a.pods}:{a.process}")
            LOADGEN_ARRIVALS.inc(a.pods, process=a.process,
                                 tenant=self.tenant)
            self._offer(now, a, attempts=0, first_offer=now)
        LOADGEN_BACKLOG.set(float(self.deferred_pods()),
                            tenant=self.tenant)

    def _offer(self, now: float, a: Arrival, attempts: int,
               first_offer: float) -> None:
        # a re-offered batch was popped off the deferred queue before
        # this call, so deferred_pods() never counts the batch against
        # its own verdict
        decision = self.admission.decide(
            self.tenant, len(self.sim.store.pending_pods()),
            self.deferred_pods(), a.pods, attempts=attempts, key=a.key,
            now=now)
        if decision.action == "admit":
            self._admit(a)
            self.stats["admitted_pods"] += a.pods
            self.plan.record(now, "admit", f"{a.key}x{a.pods}")
        elif decision.action == "defer":
            self.stats["deferred_pods"] += a.pods
            self.plan.record(
                now, "defer",
                f"{a.key}x{a.pods}#{attempts}:{decision.reason}")
            self._deferred.append(_Deferred(
                due=now + decision.delay, attempts=attempts + 1,
                first_offer=first_offer, arrival=a))
        else:  # shed
            self.stats["shed_pods"] += a.pods
            self.plan.record(now, "shed",
                             f"{a.key}x{a.pods}:{decision.reason}")

    def _admit(self, a: Arrival) -> None:
        from ..models.pod import Pod
        from ..models.resources import Resources
        req = Resources.parse({"cpu": a.cpu, "memory": a.mem})
        for i in range(a.pods):
            self.sim.store.add_pod(Pod(
                name=f"{self.name_prefix}-{a.key}-{i}", requests=req))

    # --- observables ------------------------------------------------------
    def deferred_pods(self) -> int:
        return sum(d.arrival.pods for d in self._deferred)

    def waiting_pods(self) -> int:
        """Pending pods in the store + pods parked in the deferred
        queue — the depth the admission budgets are written against."""
        return len(self.sim.store.pending_pods()) + self.deferred_pods()

    def drained(self) -> bool:
        """Every scheduled arrival emitted and no batch still parked."""
        return self._next >= len(self.plan.schedule) and not self._deferred

    def overload_state(self) -> dict:
        """The watchdog's overload_unbounded observable for this tenant:
        current waiting depth, the oldest still-parked batch's age, and
        the budget admission control should bound the depth at (carried
        even when shedding is disabled — that IS the disabled-shedding
        detection case)."""
        now = float(self.sim.clock.now())
        oldest = (min(d.first_offer for d in self._deferred)
                  if self._deferred else None)
        return {
            "depth": self.waiting_pods(),
            "oldest_age_s": 0.0 if oldest is None else now - oldest,
            "budget": getattr(self.admission, "shed_depth", 0),
            "armed": bool(getattr(self.admission, "enabled", False)),
        }
