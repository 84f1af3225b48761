"""SoakRunner: drive a tenant fleet OPEN-LOOP past saturation and judge.

The port's own copy of `karpenter_tpu/loadgen/soak.py`. The shared
`SolverService` and every shard run on `device=` (the CUDA card unless
given; "cpu" runs the kernels' plain versions).

The long-soak serving mode: N tenant shards on one
clock and one SolverService, each fed by a seeded `LoadPlan` through an
`OpenLoopSource` — arrivals fire on schedule whether or not the control
plane has kept up. Two phases:

1. **drive** — tick every shard for the scenario's open-loop window
   (at least every plan's arrival horizon), sampling each tenant's
   waiting-pod depth so the report carries the observed maximum the
   admission budgets are judged against;
2. **drain** — optionally keep flying until every shard goes quiet
   (bounded by the drain budget), so end-state hashes are computed on
   settled states and the chaos end-of-run invariants apply.

Judgment reuses the whole verification stack this mode was built for:
the SLO engine (the standing objectives PLUS an `admission_availability`
objective over the shed counters, so overload burns a declared budget),
the fleet watchdog with the `overload_unbounded` invariant armed over
the sources' depth observables, the per-shard watchdogs make_sim armed,
and the chaos invariants + two-digest repeat contract — extended here to
a THIRD digest, the load fingerprint (what arrived, what was shed and
deferred), since a soak whose end states agree could still have shed
different pods on the way.

    python -m karpenter_tpu_torch.loadgen soak_overload --seed 7 --repeat 2
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..fleet.service import AdmissionController, SolverService
from ..fleet.tenant import TenantShard, build_shard, tenant_seed
from ..utils.clock import FakeClock
from .plan import (BurstyArrivals, DiurnalArrivals, LoadPlan,
                   PoissonArrivals, SpotWeather, TraceReplay)
from .source import OpenLoopSource


def admission_slo(objective: float = 0.95):
    """Declared objective over the admission verdicts: offered pods
    admitted (not shed) for >= objective of offers — the SLO whose burn
    rate is the paging signal for an overload window (the availability
    face of `loadgen_shed_total`)."""
    from ..metrics import LOADGEN_ADMITTED, LOADGEN_SHED
    from ..obs.slo import SloSpec

    def indicator(tenant):
        admitted = LOADGEN_ADMITTED.value(tenant=tenant)
        shed = LOADGEN_SHED.sum(tenant=tenant)
        return admitted, admitted + shed

    return SloSpec("admission_availability", objective, indicator,
                   f"offered pods admitted (not shed by the admission "
                   f"controller) for >={objective:.0%} of offers")


@dataclass(frozen=True)
class SoakScenario:
    name: str
    description: str
    # (tenant_index, tenant_name, rate) -> LoadPlan rules; `rate` is the
    # scenario's arrival_rate after any CLI --arrival-rate override
    tenant_load: Callable[[int, str, float], List[object]]
    # (tenant_index, tenant_name) -> EXTRA FaultPlan rules (the plan's
    # weather overlay expansion is appended automatically)
    tenant_rules: Callable[[int, str], List[object]] = lambda i, n: []
    tenants: int = 4
    arrival_rate: float = 1.0        # batches/sec/tenant (CLI overrides)
    duration: float = 60.0           # open-loop drive window, sim seconds
    drain: float = 600.0             # post-drive drain budget (0 = none)
    step: float = 0.5
    spot_only: bool = False          # pin every tenant's pool to spot
    admission: bool = True           # arm shedding (False = the negative
    #                                  harness the watchdog must catch)
    defer_depth: Optional[int] = None
    shed_depth: Optional[int] = None
    inflight_budget: Optional[int] = None
    max_defers: Optional[int] = None
    inflight_cap: Optional[int] = None   # SolverService override
    window: Optional[float] = None
    batch: bool = False
    warmpath: bool = False
    # (runner, report) -> None: scenario verdicts onto the report
    analyze: Optional[Callable] = None


@dataclass
class SoakReport:
    scenario: str
    seed: int
    tenants: int
    converged: bool
    violations: List[str]
    tenant_hashes: Dict[str, str]
    tenant_fault_fingerprints: Dict[str, str]
    tenant_load_fingerprints: Dict[str, str]
    sim_seconds: float
    stats: Dict[str, float] = field(default_factory=dict)
    slo: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.converged and not self.violations

    def _digest(self, parts: Dict[str, str]) -> str:
        h = hashlib.sha256()
        for k in sorted(parts):
            h.update(f"{k}={parts[k]}\n".encode())
        return h.hexdigest()

    @property
    def soak_hash(self) -> str:
        return self._digest(self.tenant_hashes)

    @property
    def fault_fingerprint(self) -> str:
        return self._digest(self.tenant_fault_fingerprints)

    @property
    def load_fingerprint(self) -> str:
        """Tenant-keyed digest of every plan's schedule+ledger digest —
        the third repeat digest: two runs must agree on what arrived AND
        what was shed/deferred, not just how the cluster ended up."""
        return self._digest(self.tenant_load_fingerprints)

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        lines = [f"[{status}] soak={self.scenario} seed={self.seed} "
                 f"tenants={self.tenants} sim_seconds={self.sim_seconds:g}",
                 f"  soak_hash={self.soak_hash}",
                 f"  load_fingerprint={self.load_fingerprint}"]
        for k in sorted(self.stats):
            lines.append(f"  {k}={self.stats[k]:g}")
        if not self.converged:
            lines.append("  DID NOT DRAIN before the drain budget")
        lines += [f"  violation: {x}" for x in self.violations]
        return "\n".join(lines)


class SoakRunner:
    """Run one soak scenario at a seed. `arrival_rate`, `duration`, and
    `admission` override the scenario (the CLI knobs). The shared service
    solves on the device rung, on the CUDA card unless `device` names
    another (the reference defaults to its host rung)."""

    def __init__(self, scenario="soak_smoke", tenants: Optional[int] = None,
                 seed: int = 0, backend: str = "device",
                 arrival_rate: Optional[float] = None,
                 duration: Optional[float] = None,
                 admission: Optional[bool] = None,
                 batch: Optional[bool] = None,
                 device=None):
        self.scenario: SoakScenario = (
            scenario if isinstance(scenario, SoakScenario)
            else get_soak_scenario(scenario))
        sc = self.scenario
        self.tenants = int(tenants) if tenants else sc.tenants
        self.seed = seed
        self.backend = backend
        self.arrival_rate = (sc.arrival_rate if arrival_rate is None
                             else float(arrival_rate))
        self.duration = sc.duration if duration is None else float(duration)
        self.admission_armed = (sc.admission if admission is None
                                else bool(admission))
        self.batch = sc.batch if batch is None else bool(batch)
        self.device = device
        self.clock: Optional[FakeClock] = None
        self.service: Optional[SolverService] = None
        self.admission: Optional[AdmissionController] = None
        self.shards: List[TenantShard] = []
        self.sources: Dict[str, OpenLoopSource] = {}
        self.slo = None
        self.watchdog = None
        self.origin = 0.0
        # per-tenant worst observed waiting depth during the drive
        self.max_depth: Dict[str, int] = {}

    # the watchdog's loadgen observable: every source's row
    def overload_state(self) -> Dict[str, dict]:
        return {t: s.overload_state() for t, s in self.sources.items()}

    def build(self) -> None:
        sc = self.scenario
        self.clock = FakeClock()
        self.origin = self.clock.now()
        self.admission = AdmissionController(
            defer_depth=sc.defer_depth, shed_depth=sc.shed_depth,
            inflight_budget=sc.inflight_budget, max_defers=sc.max_defers,
            enabled=self.admission_armed, seed=self.seed)
        self.service = SolverService(self.clock, backend=self.backend,
                                     inflight_cap=sc.inflight_cap,
                                     window=sc.window, batch=self.batch,
                                     admission=self.admission,
                                     device=self.device)
        self.admission.service = self.service
        self.shards = []
        self.sources = {}
        workload = _spot_only_workload if sc.spot_only else None
        for i in range(self.tenants):
            name = f"t{i:03d}"
            # the load stream is derived from (seed, tenant, "/load") so
            # it can never alias the shard's FaultPlan stream
            plan = LoadPlan(seed=tenant_seed(self.seed, f"{name}/load"),
                            rules=sc.tenant_load(i, name,
                                                 self.arrival_rate))
            rules = list(sc.tenant_rules(i, name)) + plan.weather_rules()
            shard = build_shard(name, self.clock, self.service,
                                fleet_seed=self.seed, rules=rules,
                                workload=workload, warmpath=sc.warmpath,
                                device=self.device)
            self.shards.append(shard)
            self.sources[name] = OpenLoopSource(plan, shard.sim, name,
                                                self.admission)
            self.max_depth[name] = 0

    def _sample_depths(self) -> None:
        for t, src in self.sources.items():
            d = src.waiting_pods()
            if d > self.max_depth[t]:
                self.max_depth[t] = d

    def run(self) -> SoakReport:
        from ..faults.injector import fleet_device_fault_hook
        from ..faults.runner import check_invariants, state_hash
        from ..obs.explain import RECORDER
        from ..obs.slo import SloEngine, default_slos
        from ..obs.watchdog import Watchdog
        sc = self.scenario
        if not self.shards:
            self.build()
        clock = self.clock
        RECORDER.reset()
        self.slo = SloEngine(clock,
                             slos=default_slos() + [admission_slo()],
                             tenants=tuple(s.name for s in self.shards))
        self.watchdog = Watchdog(clock, service=self.service,
                                 loadgen=self).arm(clock.now())
        plans = {s.name: s.plan for s in self.shards if s.plan is not None}
        # the drive window must outlast every plan's schedule — a
        # shorter --soak-duration must not silently truncate arrivals
        # (that would change the schedule half of the load fingerprint)
        horizon = max((src.plan.horizon for src in self.sources.values()),
                      default=0.0)
        drive_until = self.origin + max(self.duration, horizon + sc.step)
        converged = not sc.drain  # drain disabled: judged at the horizon

        def tick_all() -> None:
            # ONE per-tick judging sequence for both phases: shards,
            # depth sampling, then the observers
            for shard in self.shards:
                shard.tick()
            self._sample_depths()
            self.slo.tick()
            self.watchdog.tick()

        with fleet_device_fault_hook(plans):
            while clock.now() < drive_until:
                tick_all()
                clock.step(sc.step)
            if sc.drain:
                deadline = clock.now() + sc.drain
                while clock.now() < deadline:
                    tick_all()
                    if all(s.quiet() for s in self.shards) \
                            and all(src.drained()
                                    for src in self.sources.values()):
                        converged = True
                        break
                    clock.step(sc.step)
        self.slo.tick(force=True)
        self.watchdog.tick(force=True)

        violations: List[str] = []
        hashes: Dict[str, str] = {}
        fault_fps: Dict[str, str] = {}
        load_fps: Dict[str, str] = {}
        overload_findings = float(self.watchdog.fired("overload_unbounded"))
        fleet_findings = float(self.watchdog.stats["findings"])
        for shard in self.shards:
            if sc.drain and converged:
                for v in check_invariants(shard.sim):
                    violations.append(f"[{shard.name}] {v}")
            wd = getattr(shard.sim, "watchdog", None)
            if wd is not None and wd.armed:
                from ..metrics.tenant import tenant_scope
                with tenant_scope(shard.name):
                    wd.tick(shard.sim.clock.now(), force=True)
                fleet_findings += float(wd.stats["findings"])
            hashes[shard.name] = state_hash(shard.sim)
            fault_fps[shard.name] = (shard.plan.fingerprint()
                                     if shard.plan is not None else "")
            load_fps[shard.name] = self.sources[shard.name] \
                .plan.fingerprint()
        # the bound the admission budgets promise: a tenant whose depth
        # ended above budget with shedding armed is an unbounded backlog
        # — the watchdog must have seen it live (cross_check maps it)
        for t, src in self.sources.items():
            row = src.overload_state()
            if row["armed"] and row["budget"] \
                    and row["depth"] > row["budget"]:
                violations.append(
                    f"[{t}] unbounded backlog: waiting depth "
                    f"{row['depth']} above the admission budget "
                    f"{row['budget']} at end of run")
        violations.extend(self.watchdog.cross_check(violations))

        totals = {"offered": 0.0, "admitted": 0.0, "shed": 0.0,
                  "deferred": 0.0, "reoffers": 0.0}
        for src in self.sources.values():
            totals["offered"] += src.stats["offered_pods"]
            totals["admitted"] += src.stats["admitted_pods"]
            totals["shed"] += src.stats["shed_pods"]
            totals["deferred"] += src.stats["deferred_pods"]
            totals["reoffers"] += src.stats["reoffers"]
        sim_seconds = clock.now() - self.origin
        drive_seconds = max(drive_until - self.origin, 1e-9)
        stats: Dict[str, float] = {
            "offered_pods": totals["offered"],
            "admitted_pods": totals["admitted"],
            "shed_pods": totals["shed"],
            "deferred_offers": totals["deferred"],
            "reoffers": totals["reoffers"],
            "shed_frac": round(totals["shed"]
                               / max(totals["offered"], 1.0), 4),
            "offered_pods_per_sim_sec": round(
                totals["offered"] / drive_seconds, 3),
            "max_waiting_depth": float(max(self.max_depth.values(),
                                           default=0)),
            "solves_dispatched": float(self.service.stats["dispatched"]),
            "solves_throttled": float(self.service.stats["throttled"]),
            "slo_alerts": float(len(self.slo.alerts)),
            "watchdog_findings": fleet_findings,
            "overload_findings": overload_findings,
        }
        report = SoakReport(
            scenario=sc.name, seed=self.seed, tenants=self.tenants,
            converged=converged, violations=violations,
            tenant_hashes=hashes, tenant_fault_fingerprints=fault_fps,
            tenant_load_fingerprints=load_fps,
            sim_seconds=sim_seconds, stats=stats)
        report.slo = self.slo.payload()
        if sc.analyze is not None:
            sc.analyze(self, report)
        return report


def _spot_only_workload(sim, rng) -> None:
    from ..models import labels as L
    from ..models.requirements import Operator, Requirement
    sim.store.nodepools["default"].requirements.add(
        Requirement(L.CAPACITY_TYPE, Operator.IN, (L.CAPACITY_SPOT,)))


# --- scenario catalog --------------------------------------------------------

def _smoke_load(i: int, name: str, rate: float) -> List[object]:
    # a modest mixed stream WELL below saturation: admission must stay
    # silent (shed==0, the tier-1 assert) while the fleet absorbs an
    # open-loop trickle it never sees from the closed-loop runners
    return [PoissonArrivals(rate=rate, t0=0.0, t1=30.0,
                            pods_min=1, pods_max=3),
            BurstyArrivals(every=12.0, burst=2, t0=5.0, t1=30.0,
                           pods_min=1, pods_max=2)]


def _smoke_analyze(runner: SoakRunner, report: SoakReport) -> None:
    if report.stats["shed_pods"] > 0:
        report.violations.append(
            f"shed {report.stats['shed_pods']:g} pods below saturation — "
            f"the admission controller engaged when it should not have")
    if report.stats["overload_findings"] > 0:
        report.violations.append(
            "overload_unbounded fired below saturation (false positive)")
    if report.stats["offered_pods"] <= 0:
        report.violations.append("load generator offered nothing")


def _overload_load(i: int, name: str, rate: float) -> List[object]:
    # sustained Poisson + a storm train, flown through recurring spot
    # fronts on a spot-only pool: during a front nothing places, the
    # backlog builds PAST the budgets, and shedding must bound it
    return [PoissonArrivals(rate=rate, t0=0.0, t1=90.0,
                            pods_min=2, pods_max=4),
            BurstyArrivals(every=15.0, burst=6, t0=5.0, t1=90.0,
                           pods_min=2, pods_max=5),
            SpotWeather(t0=10.0, t1=75.0, every=30.0, duration=25.0)]


def _overload_analyze(runner: SoakRunner, report: SoakReport) -> None:
    st = report.stats
    sc = runner.scenario
    budget = runner.admission.shed_depth
    if runner.admission_armed:
        if st["shed_pods"] <= 0:
            report.violations.append(
                "drove past saturation but nothing was shed — the "
                "admission controller never engaged")
        # bound: depth may overshoot by at most one arrival batch (the
        # decision is taken before the batch lands)
        slack = 8
        if st["max_waiting_depth"] > budget + slack:
            report.violations.append(
                f"waiting depth peaked at {st['max_waiting_depth']:g}, "
                f"above the shed budget {budget} (+{slack} batch slack) — "
                f"shedding did not bound the queue")
        if st["overload_findings"] > 0:
            report.violations.append(
                "overload_unbounded fired with shedding armed — the "
                "budgets did not hold")
        burn = [a for a in runner.slo.alerts
                if a["slo"] == "admission_availability"]
        if not burn:
            report.violations.append(
                "no admission_availability burn alert fired despite "
                "shedding — the overload window went unpaged")
        st["admission_burn_alerts"] = float(len(burn))


def _diurnal_load(i: int, name: str, rate: float) -> List[object]:
    # the day-curve + a replayed trace fragment: the longest member of
    # the catalog (make soak), below saturation end to end
    trace = tuple((40.0 + 20.0 * k, 2, "250m", "512Mi") for k in range(6))
    return [DiurnalArrivals(rate=rate, amplitude=0.6, period=80.0,
                            t0=0.0, t1=160.0, pods_min=1, pods_max=3),
            TraceReplay(entries=trace)]


SOAK_SCENARIOS: Dict[str, SoakScenario] = {}


def _register(sc: SoakScenario) -> SoakScenario:
    SOAK_SCENARIOS[sc.name] = sc
    return sc


_register(SoakScenario(
    name="soak_smoke",
    description="Open-loop Poisson+burst trickle well below saturation "
                "across 4 tenants: shed must stay 0, the fleet drains, "
                "and the load fingerprint repeats under one seed (the "
                "tier-1 member).",
    tenant_load=_smoke_load,
    tenants=4,
    arrival_rate=0.5,
    duration=30.0,
    drain=300.0,
    # batched+pipelined dispatch is the DEFAULT serving engine: results,
    # waits, and all three repeat-contract digests are identical to the
    # serial pump by construction — `--no-batch` is the escape hatch
    batch=True,
    analyze=_smoke_analyze))

_register(SoakScenario(
    name="soak_overload",
    description="Sustained arrivals + storm trains through recurring "
                "spot-capacity fronts on spot-only pools: the backlog "
                "builds past the admission budgets, shedding bounds it "
                "(watchdog fires zero overload_unbounded findings), the "
                "shed rate burns the admission_availability SLO, and "
                "the whole thing drains once the weather clears.",
    tenant_load=_overload_load,
    tenants=4,
    arrival_rate=1.5,
    duration=90.0,
    drain=900.0,
    spot_only=True,
    defer_depth=24,
    shed_depth=60,
    max_defers=4,
    batch=True,
    analyze=_overload_analyze))

_register(SoakScenario(
    name="soak_diurnal",
    description="A diurnal day-curve plus a replayed trace fragment, "
                "below saturation for the whole window — the long "
                "steady-state member (`make soak`).",
    tenant_load=_diurnal_load,
    tenants=6,
    arrival_rate=0.8,
    duration=160.0,
    drain=600.0,
    analyze=_smoke_analyze))


def get_soak_scenario(name: str) -> SoakScenario:
    try:
        return SOAK_SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown soak scenario {name!r}; catalog: "
                       f"{sorted(SOAK_SCENARIOS)}") from None
