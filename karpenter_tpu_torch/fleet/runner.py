"""FleetRunner: drive N tenant shards through one process and judge them.

The port's own copy of `karpenter_tpu/fleet/runner.py`. The service is the
port's `SolverService` on `device=` (the CUDA card unless given), or what
`service_factory` builds (a `FederatedSolverService` whose buckets cross
the wire); federated scenarios embed a `SolverServer` on the same device.
The SLO engine, the explain recorder (`report.explain`), the fleet
watchdog over the shared service and each shard's own watchdog ride every
run, as in the reference.

Modeled on `faults/runner.ScenarioRunner` (and the RestartRunner's
build/drive/judge shape): build every shard on ONE FakeClock and ONE
SolverService, interleave engine ticks round-robin (each under its
tenant's metric scope), keep flying until every shard is quiet or the
deadline passes, then:

- check EVERY shard against the chaos runner's end-of-run invariants
  (all pods bound, no leaked claims/instances, store<->cloud
  consistency) — per-tenant isolation means per-tenant judgment;
- compute each shard's id-free end-state hash plus its fault-timeline
  fingerprint. Same fleet seed => identical per-tenant hashes, the
  fleet reproducibility contract `make fleet-audit` asserts;
- fold in the scenario's analyze() verdict (noisy-neighbor isolation
  bounds) and the service's fairness stats.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.clock import FakeClock
from .scenarios import FleetScenario, get_fleet_scenario
from .service import SolverService
from .tenant import TenantShard, build_shard


@dataclass
class FleetReport:
    scenario: str
    seed: int
    tenants: int
    converged: bool
    violations: List[str]
    tenant_hashes: Dict[str, str]
    tenant_fingerprints: Dict[str, str]
    sim_seconds: float
    stats: Dict[str, float] = field(default_factory=dict)
    # canonical timeline digest of the FLEET-level wire plan (WireFault
    # firings + server restarts) — "" when the scenario has no wire
    # plan. Part of the repeat contract alongside the two digests below
    wire_fingerprint: str = ""
    # observatory attachments (never part of the determinism contract —
    # fleet_hash/fleet_fingerprint ignore them):
    slo: Dict[str, object] = field(default_factory=dict)
    explain: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.converged and not self.violations

    @property
    def fleet_hash(self) -> str:
        """One digest over every tenant's end-state hash (tenant-keyed,
        so a pair of swapped tenant states cannot cancel out)."""
        h = hashlib.sha256()
        for tenant in sorted(self.tenant_hashes):
            h.update(f"{tenant}={self.tenant_hashes[tenant]}\n".encode())
        return h.hexdigest()

    @property
    def fleet_fingerprint(self) -> str:
        """Tenant-keyed digest of every shard's fault-timeline
        fingerprint — the other half of the repeat contract: end states
        that coincidentally agree must not mask a nondeterministic
        fault timeline."""
        h = hashlib.sha256()
        for tenant in sorted(self.tenant_fingerprints):
            h.update(
                f"{tenant}={self.tenant_fingerprints[tenant]}\n".encode())
        return h.hexdigest()

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        lines = [f"[{status}] fleet={self.scenario} seed={self.seed} "
                 f"tenants={self.tenants} "
                 f"sim_seconds={self.sim_seconds:g}",
                 f"  fleet_hash={self.fleet_hash}"]
        for k in sorted(self.stats):
            lines.append(f"  {k}={self.stats[k]:g}")
        if not self.converged:
            lines.append("  DID NOT CONVERGE before the sim deadline")
        lines += [f"  violation: {x}" for x in self.violations]
        return "\n".join(lines)


class FleetRunner:
    """Run one fleet scenario at a seed."""

    def __init__(self, scenario="fleet_smoke", tenants: Optional[int] = None,
                 seed: int = 0, backend: str = "host",
                 inflight_cap: Optional[int] = None,
                 journal_dir: Optional[str] = None,
                 warmpath: Optional[bool] = None,
                 batch: Optional[bool] = None,
                 service_factory=None,
                 federate: Optional[bool] = None,
                 device=None):
        self.scenario: FleetScenario = (
            scenario if isinstance(scenario, FleetScenario)
            else get_fleet_scenario(scenario))
        self.tenants = int(tenants) if tenants else self.scenario.tenants
        self.seed = seed
        self.backend = backend
        self.inflight_cap = (inflight_cap if inflight_cap is not None
                             else self.scenario.inflight_cap)
        self.journal_dir = journal_dir
        self.warmpath = (self.scenario.warmpath if warmpath is None
                         else warmpath)
        # batched dispatch is an EXECUTION detail of the shared service:
        # per-tenant end-state hashes and fault fingerprints must be
        # identical armed or not (the chaos parity contract —
        # tests/test_fleet.py compares a run each way)
        self.batch = self.scenario.batch if batch is None else bool(batch)
        # federation seam: a callable (clock, service_kwargs) -> service
        # replaces the in-process SolverService with e.g. a
        # FederatedSolverService whose buckets cross the wire. The judge
        # (hashes, fingerprints, invariants) is untouched — the
        # cross-process determinism contract is asserted BY running the
        # same scenario through both factories.
        self.service_factory = service_factory
        # federate-by-default scenarios (fed_*) build their own embedded
        # server + factory in build(); federate=False forces the
        # in-process arm of the same scenario (the parity drill)
        self.federate = (self.scenario.federate if federate is None
                         else bool(federate))
        self.fed_server = None     # embedded SolverServer when federated
        self.device = device
        # FLEET-level wire FaultPlan (scenario.wire_rules): WireFault
        # weather + drive-hook events on ONE canonical timeline, seeded
        # from the fleet seed — FleetReport.wire_fingerprint
        self.wire_plan = None
        self.clock: Optional[FakeClock] = None
        self.service: Optional[SolverService] = None
        self.shards: List[TenantShard] = []
        self.slo = None  # obs.slo.SloEngine, built in run()
        # fleet-level obs.watchdog.Watchdog over the SHARED service
        # (starvation/backlog); each shard's make_sim stack arms its own
        # per-tenant watchdog for the cluster-state invariants
        self.watchdog = None
        self.origin = 0.0

    def build(self) -> None:
        sc = self.scenario
        self.clock = FakeClock()
        self.origin = self.clock.now()
        if self.federate and self.service_factory is None:
            # federate-by-default: embed one SolverServer on the runner's
            # device that the runner can also actuate (the
            # fed_server_restart drive hook reboots it) behind the
            # in-memory wire. Federation engages only for device-
            # batchable buckets, so force the same shape the CLI's
            # --federate does.
            from ..federation.server import SolverServer
            self.batch = True
            if self.backend == "host":
                self.backend = "device"
            self.fed_server = SolverServer(run_id=f"fed-{sc.name}",
                                           device=self.device)

            def _factory(clock, kw, _srv=self.fed_server,
                         _sc=sc.name):
                from ..federation import build_federated_service
                return build_federated_service(
                    clock, run_id=f"fed-{_sc}", shared_server=_srv, **kw)
            self.service_factory = _factory
        if sc.wire_rules is not None:
            from ..faults.plan import FaultPlan
            self.wire_plan = FaultPlan(seed=self.seed,
                                       rules=sc.wire_rules())
            self.wire_plan.clock = self.clock
            self.wire_plan.origin = self.origin
        service_kwargs = dict(backend=self.backend,
                              inflight_cap=self.inflight_cap,
                              quantum=sc.quantum, window=sc.window,
                              batch=self.batch, device=self.device)
        if self.service_factory is not None:
            self.service = self.service_factory(self.clock, service_kwargs)
        else:
            self.service = SolverService(self.clock, **service_kwargs)
        self.shards = []
        for i in range(self.tenants):
            name = f"t{i:03d}"
            self.shards.append(build_shard(
                name, self.clock, self.service,
                fleet_seed=self.seed,
                rules=sc.tenant_rules(i, name),
                workload=sc.tenant_workload(i, name),
                warmpath=self.warmpath,
                journal_dir=self.journal_dir,
                device=self.device))

    def run(self) -> FleetReport:
        from ..faults.injector import (fleet_device_fault_hook,
                                       wire_fault_plan_hook)
        from ..faults.runner import check_invariants, state_hash
        sc = self.scenario
        if not self.shards:
            self.build()
        clock = self.clock
        # the observatory's SLO engine rides every fleet run: declared
        # per-tenant objectives evaluated on the SIM clock over the
        # tenant-dimensioned families the shards already emit. Read-only
        # over metrics + clock, so end-state hashes and fault
        # fingerprints are untouched (the fleet-audit repeat contract
        # holds with it on).
        from ..obs.slo import SloEngine
        self.slo = SloEngine(clock,
                             tenants=tuple(s.name for s in self.shards))
        # per-run provenance baseline: tenant/pod names are deterministic
        # across seeded repeats in ONE process (run_matrix), so stale
        # records from a previous run could satisfy this run's explain
        # verdict — reset like the SLO engine baselines
        from ..obs.explain import RECORDER
        RECORDER.reset()
        # the fleet face of the verification plane: one watchdog over
        # the SHARED service (starvation/backlog are fleet properties,
        # not any shard's) alongside the per-shard watchdogs each
        # make_sim stack already armed
        from ..obs.watchdog import Watchdog
        self.watchdog = Watchdog(clock, service=self.service).arm(
            clock.now())
        deadline = clock.now() + sc.timeout
        plans = {s.name: s.plan for s in self.shards if s.plan is not None}
        converged = False
        with fleet_device_fault_hook(plans), \
                wire_fault_plan_hook(self.wire_plan):
            while clock.now() < deadline:
                if sc.drive is not None:
                    sc.drive(self, clock.now() - self.origin)
                for shard in self.shards:
                    shard.tick()
                self.slo.tick()
                self.watchdog.tick()
                if all(s.quiet() for s in self.shards):
                    converged = True
                    break
                clock.step(sc.step)
        self.slo.tick(force=True)  # final evaluation at the end state
        self.watchdog.tick(force=True)

        violations: List[str] = []
        hashes: Dict[str, str] = {}
        fingerprints: Dict[str, str] = {}
        warm_div = 0.0
        fleet_findings = float(self.watchdog.stats["findings"])
        for shard in self.shards:
            shard_v = check_invariants(shard.sim)
            # per-shard found-it-first cross-check under the shard's
            # tenant scope (findings metered at the final evaluation
            # land on the tenant's series, like every other sample)
            wd = getattr(shard.sim, "watchdog", None)
            if wd is not None and wd.armed:
                from ..metrics.tenant import tenant_scope
                with tenant_scope(shard.name):
                    wd.tick(shard.sim.clock.now(), force=True)
                shard_v.extend(wd.cross_check(shard_v))
                fleet_findings += float(wd.stats["findings"])
            for v in shard_v:
                violations.append(f"[{shard.name}] {v}")
            hashes[shard.name] = state_hash(shard.sim)
            fingerprints[shard.name] = (shard.plan.fingerprint()
                                        if shard.plan is not None else "")

            wp = shard.sim.warmpath
            if wp is not None and wp.stats["divergences"]:
                warm_div += wp.stats["divergences"]
                violations.append(
                    f"[{shard.name}] warm-path auditor diverged "
                    f"{wp.stats['divergences']} time(s)")

        svc = self.service
        stats: Dict[str, float] = {
            "solves_dispatched": float(svc.stats["dispatched"]),
            "solves_throttled": float(svc.stats["throttled"]),
            "catalog_shared_hits": float(svc.shared_catalog.stats["hits"]),
            "catalog_shared_misses": float(
                svc.shared_catalog.stats["misses"]),
            "faults_injected": float(sum(
                len(s.plan.timeline) for s in self.shards
                if s.plan is not None)),
        }
        wall = sum(s.wall_seconds for s in svc.tenants.values())
        if wall > 0:
            stats["aggregate_solves_per_wall_sec"] = round(
                svc.stats["dispatched"] / wall, 1)
        if svc.batch:
            stats["solve_batches"] = float(svc.stats["batches"])
            stats["batched_tickets"] = float(svc.stats["batched_tickets"])
            stats["pipeline_overlap_ratio"] = round(
                svc.pipeline_overlap_ratio(), 4)
        fed_state = getattr(svc, "federation_state", None)
        if fed_state is not None:
            fs = fed_state()
            stats["federated_wire_buckets"] = float(fs["wire_buckets"])
            stats["federated_wire_tickets"] = float(fs["wire_tickets"])
            stats["federated_local_buckets"] = float(fs["local_buckets"])
            stats["federated_wire_failures"] = float(fs["failures"])
            cstats = svc.fed.stats
            stats["federation_catalog_uploads"] = float(cstats["uploads"])
            stats["federation_announce_hits"] = float(
                cstats["announce_hits"])
            stats["federation_retries"] = float(cstats["retries"])
            stats["federation_rejoins"] = float(fs["rejoins"])
            stats["federation_generation_changes"] = float(
                cstats["generation_changes"])
        if self.wire_plan is not None:
            stats["wire_faults_injected"] = float(
                len(self.wire_plan.timeline))
        if warm_div:
            stats["warm_divergences"] = warm_div
        stats["watchdog_findings"] = fleet_findings
        stats["slo_alerts"] = float(len(self.slo.alerts))
        report = FleetReport(
            scenario=sc.name, seed=self.seed, tenants=self.tenants,
            converged=converged, violations=violations,
            tenant_hashes=hashes, tenant_fingerprints=fingerprints,
            sim_seconds=clock.now() - self.origin, stats=stats,
            wire_fingerprint=(self.wire_plan.fingerprint()
                              if self.wire_plan is not None else ""))
        report.slo = self.slo.payload()
        # causal trail: any tenant the service throttled gets one
        # explained pod attached (throttle count + the funnel of the
        # solve that finally placed it), so a starvation finding in the
        # report comes with its provenance instead of a bare counter
        from ..obs.explain import RECORDER
        for tenant, state in svc.tenants.items():
            if not state.throttled:
                continue
            pods = RECORDER.tenant_pods(tenant, outcome="throttled")
            if pods:
                report.explain[tenant] = RECORDER.explain(pods[-1], tenant)
        if sc.analyze is not None:
            sc.analyze(self, report)
        return report
