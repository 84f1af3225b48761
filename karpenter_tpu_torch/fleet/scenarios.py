"""Fleet scenario catalog — the port's copy of the reference's
(`karpenter_tpu/fleet/scenarios.py`), every scenario unchanged. The
fed_* scenarios federate by default (an embedded `SolverServer` behind
the in-memory wire); `federation_smoke` runs in process unless run with
`--federate`, as in the reference.

A FleetScenario describes a whole fleet: how many tenant shards, each
tenant's workload (seeded from the tenant's OWN rng stream, so tenant
t007's arrivals are identical whether 8 or 80 neighbors exist), each
tenant's fault rules (tenant-scoped FaultPlans — ICE storms, API
brownouts, interruption bursts; never ClockJump/CrashPoint, which are
fleet-global/restart concerns), and an optional `analyze` hook that
turns the service's per-tenant latency samples into scenario-specific
verdicts (the noisy-neighbor isolation check).

Reproduce any run from its seed:

    python -m karpenter_tpu_torch.fleet fleet_noisy_neighbor --seed 7 --repeat 2
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..faults.plan import ApiFault, IceWindow, WireFault


@dataclass(frozen=True)
class FleetScenario:
    name: str
    description: str
    # (tenant_index, tenant_name) -> workload fn(sim, rng) applied at build
    tenant_workload: Callable[[int, str], Callable]
    # (tenant_index, tenant_name) -> FaultPlan rules for that tenant
    tenant_rules: Callable[[int, str], List[object]] = lambda i, n: []
    tenants: int = 8                 # default shard count (CLI overrides)
    timeout: float = 300.0           # sim-seconds deadline
    step: float = 0.5
    warmpath: bool = False
    # arm the service's batched+pipelined dispatcher (--batch overrides);
    # hashes/fingerprints are identical either way — the chaos contract
    batch: bool = False
    inflight_cap: Optional[int] = None   # SolverService override
    window: Optional[float] = None
    quantum: Optional[float] = None
    # route buckets through the federation plane by default (the CLI's
    # --federate forces this on; FleetRunner(federate=False) forces the
    # in-process arm of the same scenario for parity drills)
    federate: bool = False
    # () -> WireFault rules for the FLEET-level wire plan (seeded from
    # the fleet seed; fires through the federation transport seams). A
    # non-None value — even one returning [] — makes the runner mint the
    # plan, so drive hooks can record onto its canonical timeline
    wire_rules: Optional[Callable[[], List[object]]] = None
    # (runner, rel_time) -> None: called every fleet loop iteration with
    # run-relative sim time — the mid-run actuator seam (e.g. the
    # fed_server_restart scenario reboots the embedded server with it)
    drive: Optional[Callable] = None
    # (runner, report) -> None: append scenario verdicts to the report
    # (stats and, on failure, violations)
    analyze: Optional[Callable] = None


def _add_pods(sim, n: int, prefix: str, cpu: str = "500m",
              mem: str = "1Gi") -> None:
    from ..models.pod import Pod
    from ..models.resources import Resources
    for i in range(n):
        sim.store.add_pod(Pod(
            name=f"{prefix}-{i}",
            requests=Resources.parse({"cpu": cpu, "memory": mem})))


def _waved(waves: List[tuple]):
    """Workload of (t, n, prefix, cpu, mem) waves; later waves arrive via
    an engine hook relative to the shard's plan origin (or build time).
    Publishes the shard's WORKLOAD HORIZON (the last wave's arrival
    instant) so TenantShard.quiet() keeps the run open until every
    scheduled wave has actually fired — the workload analog of the chaos
    runner's fault horizon (a fleet that 'converges' before its late
    waves arrive proves nothing and starves scenario analyzers of their
    quiet-period samples)."""
    def workload(sim, rng):
        origin = (sim.fault_plan.origin if sim.fault_plan is not None
                  else sim.clock.now())
        sim.fleet_workload_horizon = origin + max(
            (t for t, *_ in waves), default=0.0)
        fired = set()
        for t, n, prefix, cpu, mem in waves:
            if t <= 0:
                fired.add(prefix)
                _add_pods(sim, n, prefix, cpu, mem)

        def arrivals(now: float) -> None:
            for t, n, prefix, cpu, mem in waves:
                if prefix not in fired and now - origin >= t:
                    fired.add(prefix)
                    _add_pods(sim, n, prefix, cpu, mem)
        sim.engine.add_hook(arrivals)
    return workload


def _spot_only(inner):
    def workload(sim, rng):
        from ..models import labels as L
        from ..models.requirements import Operator, Requirement
        sim.store.nodepools["default"].requirements.add(
            Requirement(L.CAPACITY_TYPE, Operator.IN, (L.CAPACITY_SPOT,)))
        inner(sim, rng)
    return workload


def _p99(samples: List[float]) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, math.ceil(0.99 * len(s)) - 1)]


# --- fleet_smoke -----------------------------------------------------------
# Every tenant: a seeded initial wave plus a later trickle; every third
# tenant flies through a short spot ICE window (its unconstrained pool
# slides to on-demand — weather, not a wall). The tier-1 member runs 8
# shards; `make fleet` runs the same scenario at 50+.


def _smoke_workload(i: int, name: str):
    def workload(sim, rng):
        first = 4 + rng.randrange(5)          # 4..8 pods
        second = 2 + rng.randrange(4)         # 2..5 pods
        at = 8.0 + rng.randrange(8)           # 8..15s
        _waved([(0.0, first, "w0", "500m", "1Gi"),
                (at, second, "w1", "250m", "512Mi")])(sim, rng)
    return workload


def _smoke_rules(i: int, name: str) -> List[object]:
    # covers t=0: the initial wave's launch must actually fly through the
    # window (later trickles often fit wave-1 headroom and never touch
    # the cloud), so every third tenant really does take ICE weather
    if i % 3 == 0:
        return [IceWindow(0.0, 35.0, capacity_type="spot")]
    return []


# --- fleet_noisy_neighbor --------------------------------------------------
# Tenant t000 is the abuser: a spot-only pool storming big waves into a
# fleet-length spot ICE window with a CreateFleet brownout on top — its
# reconciles re-solve every second for minutes. Every other tenant
# trickles small waves throughout. The analyze hook is the isolation
# verdict: victims' virtual solve latency p99 during the storm must stay
# < 2x their quiet baseline, while the noisy tenant gets throttled.

_STORM_T0, _STORM_T1 = 10.0, 150.0
# ICE marks live 3 minutes past the last failed launch, so victim
# samples are only "quiet" once the noisy tenant can actually launch
# again and its solve storm has ended
_STORM_SLACK = 200.0


def _noisy_workload(i: int, name: str):
    if i == 0:
        return _spot_only(_waved([
            (0.0, 40, "storm0", "500m", "1Gi"),
            (20.0, 40, "storm1", "500m", "1Gi"),
            (45.0, 30, "storm2", "500m", "1Gi")]))

    def workload(sim, rng):
        waves = [(0.0, 3 + rng.randrange(3), "v0", "500m", "1Gi")]
        t = 20.0 + rng.randrange(10)
        k = 1
        while t < 380.0:
            waves.append((t, 2 + rng.randrange(3), f"v{k}", "250m",
                          "512Mi"))
            t += 25.0 + rng.randrange(15)
            k += 1
        _waved(waves)(sim, rng)
    return workload


def _noisy_rules(i: int, name: str) -> List[object]:
    if i != 0:
        return []
    return [IceWindow(_STORM_T0, _STORM_T1, capacity_type="spot"),
            ApiFault(("create_fleet",), 20.0, 120.0, p=0.3,
                     error="rate_limited", retry_after=2.0)]


def _noisy_analyze(runner, report) -> None:
    """Victim-isolation verdict from the service's sample streams.
    Latency = virtual wait + virtual service (deterministic cost model),
    so the p99s are reproducible across seeded repeats."""
    service = runner.service
    noisy = "t000"
    t0 = runner.origin
    quiet: List[float] = []
    storm: List[float] = []
    for tenant, state in service.tenants.items():
        if tenant == noisy:
            continue
        for at, wait, cost in state.samples:
            rel = at - t0
            lat = wait + cost
            if _STORM_T0 <= rel < _STORM_T1 + _STORM_SLACK:
                storm.append(lat)
            else:
                quiet.append(lat)
    p99_quiet = _p99(quiet)
    p99_storm = _p99(storm)
    throttled = service.tenants[noisy].throttled
    report.stats.update({
        "victim_p99_quiet_ms": round(p99_quiet * 1e3, 3),
        "victim_p99_storm_ms": round(p99_storm * 1e3, 3),
        "victim_samples_storm": float(len(storm)),
        "noisy_throttled": float(throttled),
        "noisy_solves": float(service.tenants[noisy].solves),
    })
    if storm and quiet and p99_storm >= 2.0 * p99_quiet:
        report.violations.append(
            f"victim solve p99 not bounded: storm {p99_storm * 1e3:.2f}ms "
            f">= 2x quiet {p99_quiet * 1e3:.2f}ms")
    if not throttled:
        report.violations.append(
            "noisy tenant was never throttled — the in-flight cap did "
            "not engage")
    # --- SLO / error-budget verdict (obs/slo.py): the declared-objective
    # form of the same isolation invariant — the noisy tenant must BURN
    # (its throttles are availability bad-events; a burn-rate alert must
    # fire), while every victim's budget survives the storm.
    slo = getattr(runner, "slo", None)
    if slo is not None:
        budgets = slo.budgets()
        noisy_alerts = [a for a in slo.alerts if a["tenant"] == noisy]
        victim_avail = [budgets[t].get("solve_availability", 1.0)
                        for t in budgets if t != noisy]
        report.stats.update({
            "noisy_burn_alerts": float(len(noisy_alerts)),
            "noisy_availability_budget": budgets.get(noisy, {}).get(
                "solve_availability", 1.0),
            "victim_min_availability_budget": (min(victim_avail)
                                               if victim_avail else 1.0),
        })
        if not noisy_alerts:
            report.violations.append(
                "noisy tenant never fired an SLO burn-rate alert despite "
                "being throttled")
        if victim_avail and min(victim_avail) <= 0.5:
            report.violations.append(
                f"a victim tenant's availability error budget did not "
                f"survive the storm (min remaining "
                f"{min(victim_avail):.3f})")
    # --- provenance verdict (obs/explain.py): a throttled pod must be
    # explainable — /debug/explain answers with its throttle trail and,
    # once a later solve placed it, the constraint funnel.
    explained = report.explain.get(noisy)
    report.stats["noisy_throttled_pod_explained"] = float(
        bool(explained and explained.get("throttles", 0) > 0))
    if not explained:
        report.violations.append(
            "no /debug/explain record for any of the noisy tenant's "
            "throttled pods")


FLEET_SCENARIOS: Dict[str, FleetScenario] = {}


def _register(sc: FleetScenario) -> FleetScenario:
    FLEET_SCENARIOS[sc.name] = sc
    return sc


_register(FleetScenario(
    name="fleet_smoke",
    description="Seeded waves across every shard, a short spot ICE "
                "window on every third tenant: the deterministic fleet "
                "member (8 shards in tier-1; `make fleet` runs 50+). "
                "Per-tenant end-state hashes must repeat under one seed.",
    tenant_workload=_smoke_workload,
    tenant_rules=_smoke_rules,
    tenants=8,
    timeout=240.0))

# --- federation_smoke -------------------------------------------------------
# The federation plane's tier-1 member: uniform first waves so every
# tenant's fresh solve lands in the SAME shape class (maximum
# co-batching → maximum wire traffic when run --federate), plus seeded
# trickles for per-tenant variety. Runs identically in-process — the
# cross-process determinism test executes this scenario through BOTH
# service factories and requires byte-identical digests. The analyze
# hook only judges federated runs: at least one bucket must actually
# cross the wire, the degrade ladder must not have been armed, and
# catalog tensors must have crossed at most once per distinct view
# (the once-per-cluster contract).


def _fedsmoke_workload(i: int, name: str):
    def workload(sim, rng):
        second = 2 + rng.randrange(4)         # 2..5 pods
        at = 10.0 + rng.randrange(8)          # 10..17s
        _waved([(0.0, 6, "w0", "500m", "1Gi"),
                (at, second, "w1", "250m", "512Mi")])(sim, rng)
    return workload


def _federation_analyze(runner, report) -> None:
    svc = runner.service
    fed_state = getattr(svc, "federation_state", None)
    if fed_state is None:
        return  # in-process run of the same scenario: digests only
    fs = fed_state()
    report.stats["federation_degraded"] = float(fs["degraded"])
    if fs["wire_buckets"] == 0:
        report.violations.append(
            "federated run but no bucket ever crossed the wire — the "
            "whole fleet silently ran the local path")
    if fs["failures"]:
        report.violations.append(
            f"{fs['failures']} wire failure(s) degraded buckets in a "
            f"scenario with no injected wire faults")
    uploads = svc.fed.stats["uploads"]
    views = max(1, svc.shared_catalog.stats["misses"])
    report.stats["catalog_uploads"] = float(uploads)
    report.stats["catalog_views_minted"] = float(views)
    if uploads > views:
        report.violations.append(
            f"catalog tensors crossed the wire {uploads} times for "
            f"{views} distinct view(s) — the token-announce protocol "
            f"is re-shipping content")


_register(FleetScenario(
    name="federation_smoke",
    description="Uniform first waves (one co-batched shape class) plus "
                "seeded trickles across 8 shards; batch armed. Run with "
                "--federate to push every bucket through the wire: the "
                "verdict requires wire traffic, zero degrades, and at "
                "most one catalog upload per distinct view. Digests "
                "must match the in-process run of the same seed.",
    tenant_workload=_fedsmoke_workload,
    tenant_rules=lambda i, n: [],
    tenants=8,
    timeout=240.0,
    batch=True,
    analyze=_federation_analyze))

# --- federation resilience scenarios ---------------------------------------
# Wire weather over the federated fleet: every scenario runs the same
# shaped workload (a uniform first wave for co-batching, a seeded
# mid-run trickle, then LATE waves well past the fault window so the
# breaker has post-weather traffic to probe and rejoin on — a fleet
# that converges while still degraded proves only that the local path
# works). The WireFault rules live on a FLEET-level plan (seeded from
# the fleet seed, recorded on its own canonical timeline →
# FleetReport.wire_fingerprint), not on any tenant's plan: the wire is
# shared infrastructure, and its weather must not perturb per-tenant
# fingerprints — that is exactly what lets the parity drill compare a
# federated run's tenant digests against the in-process run's.


def _fedchaos_workload(i: int, name: str):
    def workload(sim, rng):
        second = 2 + rng.randrange(3)         # 2..4 pods
        at = 10.0 + rng.randrange(6)          # 10..15s
        _waved([(0.0, 6, "w0", "500m", "1Gi"),
                (at, second, "w1", "250m", "512Mi"),
                (70.0, 3, "w2", "250m", "512Mi"),
                (82.0, 2, "w3", "250m", "512Mi")])(sim, rng)
    return workload


def _fed_resilience_stats(runner, report) -> dict:
    """Shared verdict base for the wire-weather scenarios: surface every
    resilience meter, and flag the invariants NO amount of weather may
    break — buckets crossed the wire at some point, zero stale frames
    decoded, and the run did not END degraded (the ladder must have
    closed the breaker once the weather passed)."""
    svc = runner.service
    fed_state = getattr(svc, "federation_state", None)
    if fed_state is None:
        return None  # in-process parity arm: digests only, no wire
    fs = fed_state()
    report.stats.update({
        "federation_degraded": float(fs["degraded"]),
        "federation_rejoins": float(fs["rejoins"]),
        "federation_last_rejoin_ms": float(fs["last_rejoin_ms"]),
        "federation_retries": float(fs["retries"]),
        "federation_probes_ok": float(fs["probes_ok"]),
        "federation_probes_fail": float(fs["probes_fail"]),
        "federation_generation_changes": float(fs["generation_changes"]),
        "federation_stale_rejected": float(fs["stale_rejected"]),
        "federation_reupload_bytes": float(fs["reupload_bytes"]),
    })
    if fs["wire_buckets"] == 0:
        report.violations.append(
            "federated run but no bucket ever crossed the wire — the "
            "whole fleet silently ran the local path")
    if fs["stale_decoded"]:
        report.violations.append(
            f"{fs['stale_decoded']} stale-generation frame(s) were "
            f"DECODED — the split-brain guard failed")
    if fs["degraded"]:
        report.violations.append(
            f"run ended stuck degraded (breaker {fs['breaker']}, "
            f"cooldown {fs['cooldown']}) — the rejoin ladder never "
            f"closed the breaker after the weather passed")
    return fs


def _paged(runner, invariant: str) -> bool:
    wd = getattr(runner, "watchdog", None)
    return wd is not None and any(f.invariant == invariant
                                  for f in wd.findings)


def _fed_flap_analyze(runner, report) -> None:
    fs = _fed_resilience_stats(runner, report)
    if fs is None:
        return
    if not fs["failures"]:
        report.violations.append(
            "flap window injected but no wire failure was ever observed")
    if not fs["rejoins"]:
        report.violations.append(
            "wire degraded under the flap but never rejoined — the "
            "breaker's probe/trial ladder did not recover")
    if fs["failures"] and not _paged(runner, "federation_degraded"):
        report.violations.append(
            "wire failures degraded dispatch but the watchdog's "
            "federation_degraded invariant never paged")


def _fed_partition_analyze(runner, report) -> None:
    fs = _fed_resilience_stats(runner, report)
    if fs is None:
        return
    if not fs["probes_fail"]:
        report.violations.append(
            "blackhole window but every healthz probe passed — the "
            "partition never reached the breaker's probe path")
    if not fs["rejoins"]:
        report.violations.append(
            "partition healed but the wire never rejoined")
    if fs["failures"] and not _paged(runner, "federation_degraded"):
        report.violations.append(
            "partition degraded dispatch but the watchdog's "
            "federation_degraded invariant never paged")


def _fed_restart_analyze(runner, report) -> None:
    fs = _fed_resilience_stats(runner, report)
    if fs is None:
        return
    svc = runner.service
    if fs["generation_changes"] != 1:
        report.violations.append(
            f"expected exactly one observed boot-generation change "
            f"across the restart, saw {fs['generation_changes']:g}")
    if fs["failures"]:
        report.violations.append(
            f"a clean restart cost {fs['failures']:g} wire failure(s) — "
            f"recovery must ride the generation protocol, not the "
            f"degrade ladder")
    if not fs["reupload_bytes"]:
        report.violations.append(
            "server restarted but no catalog tensors were re-uploaded — "
            "the new boot is serving solves against state it cannot hold")
    uploads = svc.fed.stats["uploads"]
    views = max(1, svc.shared_catalog.stats["misses"])
    report.stats["catalog_uploads"] = float(uploads)
    report.stats["catalog_views_minted"] = float(views)
    if uploads > 2 * views:
        report.violations.append(
            f"catalog tensors crossed the wire {uploads} times for "
            f"{views} distinct view(s) across ONE restart — tokens must "
            f"re-announce exactly once per boot")


def _restart_drive(runner, rel: float) -> None:
    """Reboot the embedded server once, mid-fleet: generation bumps,
    catalogs and ledger clear — the client side must recover through
    the generation protocol alone. Recorded on the fleet wire plan's
    canonical timeline so the restart rides the wire fingerprint."""
    if rel < 40.0 or getattr(runner, "_fed_restarted", False):
        return
    srv = getattr(runner, "fed_server", None)
    if srv is None:
        return  # in-process parity arm: nothing to reboot
    runner._fed_restarted = True
    srv.restart()
    if runner.wire_plan is not None:
        runner.wire_plan.record(runner.clock.now(), "wire",
                                f"server_restart:gen{srv.generation}")


_register(FleetScenario(
    name="fed_flap",
    description="A 15s flapping wire window over the federated fleet "
                "(every other pair of solve RPCs dies mid-flight): the "
                "breaker must open, probe, trial, and rejoin — "
                "transient weather costs retries + a rejoin, never a "
                "terminal local-only fleet. Tenant digests must match "
                "the in-process arm.",
    tenant_workload=_fedchaos_workload,
    tenant_rules=lambda i, n: [],
    tenants=8,
    timeout=240.0,
    batch=True,
    federate=True,
    wire_rules=lambda: [WireFault(kind="flap", at=3.0, window=15.0,
                                  nth=2, methods=("solve_bucket",))],
    analyze=_fed_flap_analyze))

_register(FleetScenario(
    name="fed_partition",
    description="A 15s full wire blackhole (every RPC, healthz "
                "included, dies at the socket): the breaker opens, "
                "probes FAIL until the partition heals, then one clean "
                "probe + trial rejoins the wire. The watchdog pages "
                "federation_degraded while the partition holds.",
    tenant_workload=_fedchaos_workload,
    tenant_rules=lambda i, n: [],
    tenants=8,
    timeout=240.0,
    batch=True,
    federate=True,
    wire_rules=lambda: [WireFault(kind="blackhole", at=3.0,
                                  window=15.0)],
    analyze=_fed_partition_analyze))

_register(FleetScenario(
    name="fed_server_restart",
    description="The embedded federation server hard-restarts at t=40 "
                "(generation bump, catalogs + ledger cleared): clients "
                "must observe the new boot generation, re-handshake, "
                "re-announce every token exactly once, and decode zero "
                "stale frames — with end-state digests byte-identical "
                "to the in-process arm of the same seed.",
    tenant_workload=_fedchaos_workload,
    tenant_rules=lambda i, n: [],
    tenants=8,
    timeout=240.0,
    batch=True,
    federate=True,
    wire_rules=lambda: [],
    drive=_restart_drive,
    analyze=_fed_restart_analyze))

_register(FleetScenario(
    name="fleet_noisy_neighbor",
    description="Tenant t000 storms a spot-only pool through a 140s ICE "
                "window + CreateFleet brownout while 11 victims trickle "
                "small waves. Verdict: victim solve p99 < 2x quiet "
                "baseline, noisy tenant throttled by the in-flight cap, "
                "all tenants converge.",
    tenant_workload=_noisy_workload,
    tenant_rules=_noisy_rules,
    tenants=12,
    timeout=900.0,
    inflight_cap=6,
    window=10.0,
    analyze=_noisy_analyze))


def get_fleet_scenario(name: str) -> FleetScenario:
    try:
        return FLEET_SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown fleet scenario {name!r}; catalog: "
                       f"{sorted(FLEET_SCENARIOS)}") from None
