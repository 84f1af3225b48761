"""Named chaos scenarios — the port's copy of the reference's catalog
(`karpenter_tpu/faults/scenarios.py`), every scenario with its rules,
workload and deadline unchanged, so `SCENARIOS` and `get_scenario` are the
reference's. Every scenario runs, the three warm-path ones
(`warmpath_smoke`, `warmpath_storm`, `crash_launch_storm`) included.

Each scenario pairs a workload with a FaultPlan rule set and a sim
deadline. All rule times are run-relative sim-seconds. Every scenario in
the catalog must CONVERGE: after its faults expire, the runner's
invariants (all pods bound, no leaked claims, store/cloud consistency)
must hold — fault handling is a correctness property of the scheduler
here (tightly-coupled bundles make a single interrupted node a whole-
bundle replan), not ops hygiene.

Reproduce any run from its seed:

    python -m karpenter_tpu_torch.faults ice_storm --seed 7

Scenarios marked `slow=True` are long soaks (minutes of sim time) and are
excluded from tier-1 by the `slow` pytest marker; the `smoke` scenario is
the short deterministic member that rides in tier-1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .plan import (ApiFault, ClockJump, CorruptionFault, CrashPoint,
                   DeviceFault, IceWindow, InterruptionBurst)


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    build_rules: Callable[[], List[object]]
    workload: Callable[[object], None]       # (SimEnvironment) -> None
    timeout: float = 600.0                   # sim-seconds deadline
    backend: str = "host"
    step: float = 0.5
    slow: bool = False
    types: Optional[Callable[[], list]] = None  # catalog override
    # run with the warm-path incremental admitter armed (auditor in
    # always-on mode, audit_every=1): the runner then also asserts
    # auditor divergence == 0 — the warm path may only ever fall COLD
    # under weather, never place wrong
    warmpath: bool = False
    # the plan carries CrashPoint rules: the engine WILL be torn down
    # mid-run and must be driven by runner.RestartRunner (which rebuilds
    # the stack on the surviving cloud/clock/journal and re-lists the
    # workload); ScenarioRunner cannot run these
    restart: bool = False
    # env overrides applied for the duration of the run (the corruption
    # scenarios tighten the integrity plane's audit cadence this way);
    # the runner restores the previous values on exit
    env: Optional[dict] = None
    # minimum run-relative sim time the run must stay open, merged with
    # the fault plan's own horizon — workload-driven scenarios whose
    # arrival waves outlast their last rule's `at` set this so quiet()
    # cannot converge before the late waves land
    horizon: float = 0.0


# --- workloads -------------------------------------------------------------


def _add_pods(sim, n: int, cpu: str = "500m", mem: str = "1Gi",
              prefix: str = "p", **kw) -> list:
    from ..models.pod import Pod
    from ..models.resources import Resources
    pods = [Pod(name=f"{prefix}-{i}",
                requests=Resources.parse({"cpu": cpu, "memory": mem}), **kw)
            for i in range(n)]
    for p in pods:
        sim.store.add_pod(p)
    return pods


def _plain(n: int, **kw):
    def workload(sim):
        _add_pods(sim, n, **kw)
    return workload


def _waves(*waves, **podkw):
    """Staged arrivals: waves of (t, n, prefix) pods, later ones admitted
    by an engine hook — the weather must hit a cluster that is still
    PROVISIONING, not one that settled before the first rule fired."""
    def workload(sim):
        origin = (sim.fault_plan.origin if sim.fault_plan is not None
                  else sim.clock.now())
        fired = set()
        for t, n, prefix in waves:
            if t <= 0:
                fired.add(prefix)
                _add_pods(sim, n, prefix=prefix, **podkw)

        def arrivals(now: float) -> None:
            for t, n, prefix in waves:
                if prefix not in fired and now - origin >= t:
                    fired.add(prefix)
                    _add_pods(sim, n, prefix=prefix, **podkw)
        sim.engine.add_hook(arrivals)
    return workload


def _spot_only_pool(inner):
    """Wrap a workload: the default pool may only launch spot — the shape
    that turns an ICE storm into real InsufficientCapacity errors (an
    unconstrained pool just slides to the on-demand override rows)."""
    def workload(sim):
        from ..models import labels as L
        from ..models.requirements import Operator, Requirement
        sim.store.nodepools["default"].requirements.add(
            Requirement(L.CAPACITY_TYPE, Operator.IN, (L.CAPACITY_SPOT,)))
        inner(sim)
    return workload


def _bundle_workload(plain: int = 20, workers: int = 3):
    """A tightly-coupled colocated bundle (workers require hostname
    colocation with their cache — the planner opens ONE bundle node for
    them) plus background pods. Interrupting the bundle's node must
    replan the WHOLE bundle atomically."""
    def workload(sim):
        from ..models import labels as L
        from ..models.pod import Pod, PodAffinityTerm
        from ..models.resources import Resources
        sim.store.add_pod(Pod(
            name="bundle-cache-0", labels={"app": "bundle-cache"},
            requests=Resources.parse({"cpu": "1", "memory": "2Gi"})))
        for i in range(workers):
            sim.store.add_pod(Pod(
                name=f"bundle-w-{i}", labels={"app": "bundle-w"},
                requests=Resources.parse({"cpu": "1", "memory": "1Gi"}),
                affinity_terms=[PodAffinityTerm(
                    topology_key=L.HOSTNAME,
                    label_selector={"app": "bundle-cache"})]))
        _add_pods(sim, plain, prefix="bg")
    return workload


# --- catalog ---------------------------------------------------------------


SCENARIOS = {}


def _register(sc: Scenario) -> Scenario:
    # the restart flag routes the scenario to RestartRunner (the only
    # runner that survives a fired CrashPoint) — a mismatch would either
    # crash ScenarioRunner mid-run or silently never arm the deaths
    has_crash = any(isinstance(r, CrashPoint) for r in sc.build_rules())
    assert has_crash == sc.restart, (
        f"scenario {sc.name!r}: restart={sc.restart} but its rules "
        f"{'do' if has_crash else 'do not'} contain CrashPoint")
    SCENARIOS[sc.name] = sc
    return sc


_register(Scenario(
    name="smoke",
    description="Short deterministic tier-1 member: a spot ICE window, a "
                "hard CreateFleet throttle burst carrying a Retry-After "
                "hint against a mid-window pod wave, and a +20s clock "
                "jump.",
    build_rules=lambda: [
        IceWindow(0.0, 40.0, capacity_type="spot"),
        ApiFault(("create_fleet",), 9.0, 16.0, p=1.0,
                 error="rate_limited", retry_after=3.0),
        ClockJump(30.0, 20.0),
    ],
    workload=_waves((0.0, 12, "p0"), (10.0, 12, "p1")),
    timeout=240.0))

_register(Scenario(
    name="ice_storm",
    description="Every spot offering ICEs for 140 sim-seconds against a "
                "spot-only pool (real InsufficientCapacity errors, not "
                "silent on-demand slide) while describes brown out at "
                "p=0.1 — launches must mark offerings, re-solve off them, "
                "and recover as the 3-minute marks expire.",
    build_rules=lambda: [
        IceWindow(10.0, 150.0, capacity_type="spot"),
        ApiFault(("describe",), 20.0, 120.0, p=0.1, error="rate_limited"),
    ],
    workload=_spot_only_pool(
        _waves((0.0, 40, "p0"), (30.0, 40, "p1"))),
    timeout=900.0))

_register(Scenario(
    name="api_brownout",
    description="Cloud API returns retryable 429 with p=0.3 (Retry-After "
                "2s) across create/terminate/describe for two sim-"
                "minutes; backoff + batching must absorb it without "
                "leaking claims.",
    build_rules=lambda: [
        ApiFault(("create_fleet", "terminate", "describe"), 5.0, 120.0,
                 p=0.3, error="rate_limited", retry_after=2.0),
        # a guaranteed throttle burst on the second wave's launch window,
        # so the scenario exercises the retry path at every seed
        ApiFault(("create_fleet",), 40.0, 48.0, p=1.0,
                 error="rate_limited", retry_after=2.0),
        ApiFault(("describe_nodes",), 30.0, 90.0, p=0.2, error="server"),
    ],
    workload=_waves((0.0, 30, "p0"), (40.0, 30, "p1")),
    timeout=600.0))

_register(Scenario(
    name="interruption_wave",
    description="A spot interruption hits the node of a colocated bundle "
                "(plus a kill burst in the background fleet): the whole "
                "bundle must be replanned atomically onto a fresh node.",
    build_rules=lambda: [
        InterruptionBurst(at=40.0, count=1, kind="spot",
                          target_pods=("bundle-",)),
        InterruptionBurst(at=70.0, count=2, kind="kill"),
    ],
    workload=_bundle_workload(plain=20),
    timeout=600.0))

_register(Scenario(
    name="device_loss",
    description="The TPU backend raises on the first kernel dispatch "
                "mid-solve: the facade must re-run the solve on native/"
                "host, meter the fallback, and keep provisioning.",
    build_rules=lambda: [DeviceFault(dispatch=1, count=1)],
    workload=_plain(12),
    backend="device",
    timeout=300.0))

_register(Scenario(
    name="sdc_storm",
    description="Silent data corruption in staged solve buffers: seeded "
                "zero-row and bit-flip rules corrupt the device-resident "
                "request matrix — once at t=0 and again mid-run against "
                "a warm-serving cluster (no exception, no fault signal). "
                "Every injection must be caught by the feasibility "
                "oracle BEFORE its placements commit, quarantine must "
                "degrade only this facade's device path (host re-solve "
                "recovers the reconcile), and the run must converge with "
                "100% detection, zero invariant violations, and a "
                "repeating end-hash/fingerprint pair.",
    build_rules=lambda: [
        # each rule fires on its first eligible resident-gbuf upload at
        # or after `at` — the second hits whatever cold solve the
        # mid-run waves escalate, corrupting a buffer the warm window
        # was actively serving around
        CorruptionFault(target="resident", kind="zero_row", nth=1,
                        key_contains="gbuf"),
        CorruptionFault(target="resident", kind="bitflip", nth=1, at=20.0,
                        key_contains="gbuf"),
    ],
    workload=_waves(*[(10.0 * i, 8, f"p{i}") for i in range(8)]),
    backend="device",
    timeout=900.0,
    horizon=80.0,
    # the audit cadence is the backstop for an injection no later cold
    # solve consumes (warm windows absorb steady arrivals)
    env={"KARPENTER_TPU_INTEGRITY_AUDIT": "4"}))

_register(Scenario(
    name="resident_rot",
    description="Device-resident catalog rot: a stale-patch rule rots "
                "an allocatable row at first upload (over-capacity "
                "placements the oracle must catch), then — after the "
                "quarantine's cooldown re-seeds the catalog — a bit-flip "
                "rots a price row whose damage is behaviorally SILENT "
                "(feasible placements, wrong cost): the per-row digest "
                "audit must catch what the per-solve oracle cannot, "
                "invalidate the entry, and escalate the facade to the "
                "host backend; 100% detection, zero false findings "
                "after recovery.",
    build_rules=lambda: [
        CorruptionFault(target="resident", kind="stale_patch", nth=1,
                        key_contains="alloc"),
        CorruptionFault(target="resident", kind="bitflip", nth=1, at=20.0,
                        key_contains="price"),
    ],
    workload=_waves(*[(10.0 * i, 8, f"p{i}") for i in range(8)]),
    backend="device",
    timeout=900.0,
    horizon=80.0,
    env={"KARPENTER_TPU_INTEGRITY_AUDIT": "2"}))

_register(Scenario(
    name="clock_skew",
    description="Sim time jumps +90s and later +300s mid-run (NTP step / "
                "VM migration): TTL caches, boot delays, and liveness "
                "windows all see the discontinuity and must not strand "
                "claims.",
    # the second jump is scheduled past the first one's landing point
    # (20+90=110), so the run sees two DISTINCT discontinuities rather
    # than one cascaded +390s drain; the p1 wave lands just before the
    # second jump so pods are pending across it
    build_rules=lambda: [ClockJump(20.0, 90.0), ClockJump(150.0, 300.0)],
    workload=_waves((0.0, 25, "p0"), (145.0, 15, "p1")),
    timeout=600.0))

_register(Scenario(
    name="soak",
    description="The long combined storm: spot ICE, API brownout, spot + "
                "kill interruption bursts, and a clock jump, against a "
                "cluster growing in waves. Minutes of sim time — slow "
                "marker, runs under `make chaos`.",
    build_rules=lambda: [
        IceWindow(60.0, 240.0, capacity_type="spot"),
        ApiFault(("create_fleet", "terminate", "describe"), 100.0, 400.0,
                 p=0.25, error="rate_limited", retry_after=2.0),
        InterruptionBurst(at=150.0, count=3, kind="spot"),
        InterruptionBurst(at=350.0, count=2, kind="kill"),
        ClockJump(200.0, 90.0),
    ],
    workload=_waves((0.0, 120, "w0"), (120.0, 60, "w1"),
                    (300.0, 60, "w2")),
    timeout=1500.0,
    slow=True))


import dataclasses as _dc

_register(_dc.replace(
    SCENARIOS["smoke"],
    name="warmpath_smoke",
    warmpath=True,
    description="The tier-1 smoke scenario with the warm-path admitter "
                "armed and its auditor in always-on mode (every warm "
                "admission replayed through a full solve): `make "
                "warmpath-audit` runs this — divergence must be zero."))

def _warm_trickle_workload(sim):
    """A standing fleet (24 big pods open nodes with spare slots) plus
    8-pod small trickles that FIT that spare — the steady-state shape
    the warm path exists for. Trickle waves between storms must be
    admitted warm; waves landing on fresh wreckage go cold."""
    from ..models.pod import Pod
    from ..models.resources import Resources
    origin = (sim.fault_plan.origin if sim.fault_plan is not None
              else sim.clock.now())
    _add_pods(sim, 24, cpu="2", mem="2Gi", prefix="w0")
    fired = set()
    trickles = [(20.0, "w1"), (35.0, "w2"), (45.0, "w3"), (70.0, "w4"),
                (85.0, "w5"), (110.0, "w6"), (140.0, "w7"), (155.0, "w8")]

    def arrivals(now: float) -> None:
        for t, prefix in trickles:
            if prefix not in fired and now - origin >= t:
                fired.add(prefix)
                _add_pods(sim, 8, cpu="200m", mem="256Mi", prefix=prefix)
    sim.engine.add_hook(arrivals)


_register(Scenario(
    name="warmpath_storm",
    description="Steady 8-pod arrival trickles against a standing fleet "
                "with the warm path armed (auditor always-on), hit by a "
                "spot ICE window and an interruption burst mid-stream: "
                "the warm path must keep admitting between storms, fall "
                "COLD (never wrong) when marks/claims/nodes change, and "
                "end with zero audit divergence.",
    build_rules=lambda: [
        IceWindow(55.0, 150.0, capacity_type="spot"),
        InterruptionBurst(at=90.0, count=2, kind="spot"),
        InterruptionBurst(at=160.0, count=1, kind="kill"),
    ],
    workload=_warm_trickle_workload,
    timeout=900.0,
    warmpath=True))


# --- crash-restart scenarios (driven by runner.RestartRunner) --------------


def _storm_waves(*waves):
    """Mixed-size staged arrivals for restart scenarios: waves of
    (t, n, prefix, podkw). Restart-safe by construction: the fired-set
    lives inside the per-call closure, so re-invoking the workload on a
    rebuilt sim re-lists every already-due wave (the watch re-sync) and
    later waves still arrive on schedule."""
    def workload(sim):
        origin = (sim.fault_plan.origin if sim.fault_plan is not None
                  else sim.clock.now())
        fired = set()

        def fire_due(now: float) -> None:
            for t, n, prefix, kw in waves:
                if prefix not in fired and now - origin >= t:
                    fired.add(prefix)
                    _add_pods(sim, n, prefix=prefix, **kw)
        fire_due(sim.clock.now())
        sim.engine.add_hook(fire_due)
    return workload


_register(Scenario(
    name="restart_smoke",
    description="Tier-1 crash-restart member: the operator dies once "
                "POST-LAUNCH (instances minted, nothing committed — "
                "restart must adopt them via intent replay, never "
                "double-launch) and once MID-LAUNCH-BATCH on a later "
                "wave (intents open, nothing launched — restart must "
                "abort them and re-solve). Zero leaked instances, zero "
                "duplicate launches, all pods bound.",
    build_rules=lambda: [
        CrashPoint(point="post_launch", nth=1),
        CrashPoint(point="mid_launch_batch", nth=2, at=10.0),
    ],
    workload=_storm_waves(
        (0.0, 12, "p0", dict(cpu="2", mem="4Gi")),
        (15.0, 12, "p1", dict(cpu="2", mem="4Gi"))),
    timeout=300.0,
    restart=True))

_register(Scenario(
    name="crash_launch_storm",
    description="Crash-restart under weather with the warm path armed: "
                "the operator dies post-launch during the initial fleet "
                "build, then MID-WARM-AUDIT during a warm trickle "
                "(nominations made, audit unproven — the rebuilt "
                "process must force cold and re-solve), then "
                "mid-launch-batch when a late big wave forces new "
                "launches through an API brownout. Divergence-free "
                "audits post-restart, no duplicate launches.",
    build_rules=lambda: [
        CrashPoint(point="post_launch", nth=1),
        CrashPoint(point="mid_warm_audit", nth=1, at=15.0),
        CrashPoint(point="mid_launch_batch", nth=2, at=50.0),
        ApiFault(("create_fleet", "describe"), 55.0, 90.0, p=0.2,
                 error="rate_limited", retry_after=2.0),
    ],
    workload=_storm_waves(
        (0.0, 24, "w0", dict(cpu="2", mem="2Gi")),
        (20.0, 8, "w1", dict(cpu="200m", mem="256Mi")),
        (35.0, 8, "w2", dict(cpu="200m", mem="256Mi")),
        (60.0, 24, "w3", dict(cpu="2", mem="2Gi"))),
    timeout=600.0,
    warmpath=True,
    restart=True))

_register(Scenario(
    name="crash_drain",
    description="The operator dies MID-DRAIN: a spot reclaim wave "
                "starts draining nodes and the process crashes between "
                "deleting the store node and terminating the instance — "
                "restart must resurrect the claim from its adoption "
                "tags (instance still running, nothing leaked, nothing "
                "double-terminated); a later kill burst proves the "
                "rebuilt stack still recovers dead capacity.",
    build_rules=lambda: [
        InterruptionBurst(at=40.0, count=2, kind="spot"),
        CrashPoint(point="mid_drain", nth=1, at=35.0),
        InterruptionBurst(at=150.0, count=1, kind="kill"),
    ],
    workload=_storm_waves(
        (0.0, 20, "p0", dict(cpu="2", mem="4Gi"))),
    timeout=600.0,
    restart=True))


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; catalog: "
                       f"{sorted(SCENARIOS)}") from None
