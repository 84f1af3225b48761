"""The port's open-loop traffic plane (`karpenter_tpu_torch/loadgen/`, the
fleet's `AdmissionController` and `SolverService(admission=)`) held against
the JAX reference's.

Every class of the reference's `tests/test_loadgen.py` but
`TestPerfGateClassification` (the bench's perf archive, ROADMAP item 5)
reruns through the port. Each case is written once over a namespace of
either package's objects and runs through both: the plans' schedules,
timelines and fingerprints, every admission verdict and backoff delay, the
sources' stats and ledgers, and the soak reports' three digests (end-state
hash, fault fingerprint, load fingerprint), stats, SLO alerts and watchdog
findings must be equal, exactly. The port runs with `device="cpu"` (the
kernels' plain versions); the claim-name, pod-uid and instance-id sequences
restart at the same value in both packages before each run.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
from types import SimpleNamespace

import pytest

from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops.encode import encode_catalog

from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res


def _namespace(pkg: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")
    dev = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    lg = mod("loadgen")
    svc = mod("fleet.service")
    return SimpleNamespace(
        pkg=pkg, mod=mod, dev=dev, lg=lg, M=mod("metrics"),
        AdmissionController=svc.AdmissionController,
        SolverService=lambda clock, **kw: svc.SolverService(clock, **dev,
                                                            **kw),
        SoakRunner=lambda *a, **kw: lg.SoakRunner(*a, **dev, **kw),
        build_shard=lambda *a, **kw: mod("fleet.tenant").build_shard(
            *a, **dev, **kw),
        FakeClock=mod("utils.clock").FakeClock,
        small_catalog=mod("catalog").small_catalog,
        CatalogProvider=mod("catalog.provider").CatalogProvider,
        plan=mod("faults.plan"), TRACER=mod("obs.tracer").TRACER,
        FlightRecorder=mod("obs.tracer").FlightRecorder)


REF = _namespace("karpenter_tpu")
PORT = _namespace("karpenter_tpu_torch")


def _reset_planes() -> None:
    """Both packages' delta and resident planes, explain recorders and
    integrity meters start each run empty: memo keys hold id(facade), and
    a reused id must not meet a dead facade's entry in one package and not
    in the other."""
    for P in (REF, PORT):
        for path, name in (("ops.delta", "DELTA"),
                           ("ops.resident", "RESIDENT"),
                           ("obs.explain", "RECORDER"),
                           ("integrity", "INTEGRITY")):
            getattr(P.mod(path), name).reset()


def _reset_sequences() -> None:
    _reset_planes()
    for nodeclaim, pod, fake in ((ref_nodeclaim, ref_pod, ref_fake),
                                 (port_nodeclaim, port_pod, port_fake)):
        nodeclaim._seq = itertools.count()
        pod._uid = itertools.count()
        fake._ids = itertools.count(1)


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """Both resource axes get the same columns; afterwards the reference
    gets its sequences back and its intern table and planes reset
    (ROADMAP §3's test-order hazard)."""
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids)
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids = saved
    ref_pod._sig_intern.clear()
    _reset_planes()


@pytest.fixture(autouse=True)
def _fresh_flight_ring():
    """Soak runs land slo.burn / watchdog.finding markers in each
    package's process-global flight-recorder ring; every test gets its own
    rings (as the reference's module does)."""
    old = [P.TRACER.recorder for P in (REF, PORT)]
    for P, rec in zip((REF, PORT), old):
        P.TRACER.recorder = P.FlightRecorder(size=rec.size)
    yield
    for P, rec in zip((REF, PORT), old):
        P.TRACER.recorder = rec


def _both(case, *args):
    out = {}
    for P in (REF, PORT):
        _reset_sequences()
        out[P.pkg] = case(P, *args)
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]
    return out["karpenter_tpu_torch"]


def _rows(items):
    """Dataclass instances of either package as plain tuples."""
    return [(type(x).__name__,) + dataclasses.astuple(x) for x in items]


def _verdict(d):
    return (d.action, d.reason, d.delay)


def _findings(wd):
    return [f.to_dict() for f in wd.findings]


def _report(runner, rep):
    """Everything a soak report and its runner carry that must be equal."""
    return {
        "digests": (rep.soak_hash, rep.fault_fingerprint,
                    rep.load_fingerprint),
        "tenant_hashes": rep.tenant_hashes,
        "fault_fps": rep.tenant_fault_fingerprints,
        "load_fps": rep.tenant_load_fingerprints,
        "ok": (rep.ok, rep.converged, rep.violations),
        "sim_seconds": rep.sim_seconds, "stats": rep.stats,
        "slo": (rep.slo["alerts"], rep.slo["budgets"]),
        "watchdog": (_findings(runner.watchdog),
                     [_findings(s.sim.watchdog) for s in runner.shards]),
        "timelines": {t: (src.plan.timeline, src.stats)
                      for t, src in runner.sources.items()},
        "admission": runner.admission.snapshot(),
    }


# --- TestLoadPlan --------------------------------------------------------

def _rules(P):
    return [P.lg.PoissonArrivals(rate=2.0, t0=0.0, t1=20.0),
            P.lg.DiurnalArrivals(rate=1.0, amplitude=0.5, period=30.0,
                                 t0=0.0, t1=30.0),
            P.lg.BurstyArrivals(every=8.0, burst=3, t0=0.0, t1=25.0)]


def plan_same_seed_same_schedule_and_fingerprint(P):
    a = P.lg.LoadPlan(seed=7, rules=_rules(P)).materialize()
    b = P.lg.LoadPlan(seed=7, rules=_rules(P)).materialize()
    assert a.schedule == b.schedule
    assert a.schedule
    assert a.fingerprint() == b.fingerprint()
    return [_rows(a.schedule), a.fingerprint()]


def plan_different_seed_different_schedule(P):
    a = P.lg.LoadPlan(seed=7, rules=_rules(P)).materialize()
    b = P.lg.LoadPlan(seed=8, rules=_rules(P)).materialize()
    assert a.schedule != b.schedule
    assert a.fingerprint() != b.fingerprint()
    return [_rows(b.schedule), b.fingerprint()]


def plan_processes_respect_windows(P):
    plan = P.lg.LoadPlan(seed=1, rules=_rules(P)).materialize()
    assert all(0.0 <= a.t < 30.0 for a in plan.schedule)
    procs = {a.process for a in plan.schedule}
    assert {"poisson", "diurnal", "bursty"} <= procs
    assert plan.horizon == plan.schedule[-1].t
    assert plan.total_pods >= len(plan.schedule)
    return [plan.horizon, plan.total_pods, sorted(procs)]


def plan_ledger_entries_change_fingerprint(P):
    a = P.lg.LoadPlan(seed=3, rules=[P.lg.PoissonArrivals(rate=1.0)])
    b = P.lg.LoadPlan(seed=3, rules=[P.lg.PoissonArrivals(rate=1.0)])
    assert a.fingerprint() == b.fingerprint()
    a.record(5.0, "shed", "a000001x3:queue_depth")
    assert a.fingerprint() != b.fingerprint()
    assert a.shed_defer_set() == ((5.0, "shed", "a000001x3:queue_depth"),)
    return [a.fingerprint(), b.fingerprint()]


def plan_trace_replay_round_trip(P, tmp):
    entries = [(1.0, 2, "250m", "512Mi"), (4.5, 3, "500m", "1Gi")]
    path = str(tmp / f"{P.pkg}.jsonl")
    P.lg.save_trace(path, entries)
    with open(path) as f:
        text = f.read()
    replay = P.lg.load_trace(path)
    plan = P.lg.LoadPlan(seed=0, rules=[replay]).materialize()
    assert [(a.t, a.pods, a.cpu, a.mem) for a in plan.schedule] == entries
    assert all(a.process == "trace" for a in plan.schedule)
    return [text, _rows(plan.schedule), plan.fingerprint()]


def _weather(P):
    return [P.lg.SpotWeather(t0=0.0, t1=120.0, every=40.0, duration=20.0,
                             reclaim=2),
            P.lg.IceWeather(t0=0.0, t1=100.0, every=50.0, duration=30.0,
                            zone="zone-a")]


def plan_weather_expands_into_fault_rules(P):
    plan = P.lg.LoadPlan(seed=5, rules=_weather(P))
    rules = plan.weather_rules()
    ices = [r for r in rules if isinstance(r, P.plan.IceWindow)]
    bursts = [r for r in rules if isinstance(r, P.plan.InterruptionBurst)]
    assert ices and bursts
    assert any(r.capacity_type == "spot" for r in ices)
    assert any(r.zone == "zone-a" for r in ices)
    again = P.lg.LoadPlan(seed=5, rules=_weather(P)).weather_rules()
    assert rules == again
    return _rows(rules)


def plan_unknown_rule_rejected(P):
    with pytest.raises(TypeError) as e:
        P.lg.LoadPlan(seed=0, rules=[object()]).materialize()
    return str(e.value)


PLAN_CASES = {f.__name__: f for f in (
    plan_same_seed_same_schedule_and_fingerprint,
    plan_different_seed_different_schedule, plan_processes_respect_windows,
    plan_ledger_entries_change_fingerprint,
    plan_weather_expands_into_fault_rules, plan_unknown_rule_rejected)}


class TestLoadPlan:
    @pytest.mark.parametrize("name", sorted(PLAN_CASES))
    def test_plan_equals_the_reference(self, name):
        _both(PLAN_CASES[name])

    def test_trace_replay_round_trip(self, tmp_path):
        _both(plan_trace_replay_round_trip, tmp_path)


# --- TestAdmissionController ---------------------------------------------

def ac_admit_below_budgets(P):
    ac = P.AdmissionController(defer_depth=10, shed_depth=20)
    d = ac.decide("a", pending=2, deferred=0, arriving=3)
    assert d.action == "admit"
    assert ac.stats["a"]["admitted"] == 3
    return [_verdict(d), ac.snapshot()]


def ac_defer_past_soft_budget_with_deterministic_backoff(P):
    ac = P.AdmissionController(defer_depth=10, shed_depth=100, seed=4)
    d1 = ac.decide("a", pending=9, deferred=0, arriving=3, key="k1")
    assert d1.action == "defer" and d1.delay > 0
    ac2 = P.AdmissionController(defer_depth=10, shed_depth=100, seed=4)
    assert ac2.decide("a", 9, 0, 3, key="k1").delay == d1.delay
    d2 = ac.decide("a", pending=9, deferred=0, arriving=3, attempts=1,
                   key="k1")
    assert d2.delay > d1.delay * 0.74
    ac3 = P.AdmissionController(defer_depth=10, shed_depth=100, seed=5)
    d3 = ac3.decide("a", 9, 0, 3, key="k1")
    assert d3.delay != d1.delay
    db = ac.decide("b", pending=9, deferred=0, arriving=3, key="k1")
    assert db.delay != d1.delay
    # the whole backoff ladder, attempt by attempt
    ladder = [ac.backoff(f"a|k{i}", n) for i in range(3) for n in range(8)]
    return [[_verdict(d) for d in (d1, d2, d3, db)], ladder, ac.snapshot()]


def ac_deferred_backlog_does_not_block_reoffers(P):
    ac = P.AdmissionController(defer_depth=10, shed_depth=100)
    d = ac.decide("a", pending=0, deferred=50, arriving=3, attempts=1,
                  key="k1")
    assert d.action == "admit"
    return [_verdict(d), ac.snapshot()]


def ac_shed_past_hard_budget_and_defer_allowance(P):
    shed = P.M.LOADGEN_SHED
    ac = P.AdmissionController(defer_depth=10, shed_depth=20, max_defers=2)
    before_q = shed.value(tenant="a", reason="queue_depth")
    before_d = shed.value(tenant="a", reason="defer_budget")
    d = ac.decide("a", pending=9, deferred=10, arriving=3)
    assert (d.action, d.reason) == ("shed", "queue_depth")
    assert shed.value(tenant="a", reason="queue_depth") == before_q + 3
    d2 = ac.decide("a", pending=11, deferred=0, arriving=2, attempts=2)
    assert (d2.action, d2.reason) == ("shed", "defer_budget")
    assert shed.value(tenant="a", reason="defer_budget") == before_d + 2
    return [_verdict(d), _verdict(d2), ac.snapshot()]


def ac_disabled_admits_everything(P):
    ac = P.AdmissionController(defer_depth=1, shed_depth=2, enabled=False)
    d = ac.decide("a", pending=999, deferred=0, arriving=50)
    assert d.action == "admit"
    return [_verdict(d), ac.snapshot()]


def ac_rate_limit_sheds_with_rate_reason(P):
    shed = P.M.LOADGEN_SHED
    ac = P.AdmissionController(defer_depth=100, shed_depth=200,
                               rate_limit=10.0, rate_burst=10.0)
    before = shed.value(tenant="a", reason="rate")
    out = [ac.decide("a", 0, 0, arriving=8, now=0.0)]
    assert out[-1].action == "admit"
    out.append(ac.decide("a", 0, 0, arriving=8, now=0.1))
    assert (out[-1].action, out[-1].reason) == ("shed", "rate")
    assert shed.value(tenant="a", reason="rate") == before + 8
    out.append(ac.decide("a", 0, 0, arriving=8, now=1.2))
    assert out[-1].action == "admit"
    out.append(ac.decide("b", 0, 0, arriving=8, now=0.1))
    assert out[-1].action == "admit"
    out.append(ac.decide("a", 0, 0, arriving=8, attempts=1, now=1.21))
    assert out[-1].action == "admit"
    return [[_verdict(d) for d in out], ac.snapshot(),
            sorted(ac._rate_buckets.items())]


def ac_rate_limit_deterministic_sequence(P):
    def run():
        ac = P.AdmissionController(defer_depth=100, shed_depth=200,
                                   rate_limit=5.0)
        out = []
        for i in range(12):
            d = ac.decide("a", 0, 0, arriving=3, now=i * 0.25, key=f"k{i}")
            out.append((d.action, d.reason))
        return out
    a = run()
    assert a == run()
    return a


def ac_rate_limit_off_by_default(P):
    ac = P.AdmissionController(defer_depth=100, shed_depth=200)
    for i in range(20):
        assert ac.decide("a", 0, 0, arriving=50,
                         now=i * 0.01).action == "admit"
    return ac.snapshot()


def ac_rate_limit_zero_sheds_everything(P):
    ac = P.AdmissionController(rate_limit=0.0)
    d = ac.decide("a", 0, 0, arriving=1, now=0.0)
    assert (d.action, d.reason) == ("shed", "rate")
    d2 = ac.decide("a", 0, 0, arriving=1, now=100.0)
    assert (d2.action, d2.reason) == ("shed", "rate")
    return [_verdict(d), _verdict(d2), ac.snapshot()]


def ac_inflight_budget_defers_on_service_queue(P):
    svc = P.SolverService(P.FakeClock(), backend="host")
    ac = P.AdmissionController(service=svc, defer_depth=100,
                               shed_depth=200, inflight_budget=2)
    svc.register("a", P.CatalogProvider(lambda: P.small_catalog()))
    for _ in range(3):
        svc.submit("a", "solve", lambda: 1, cost=0.001)
    d = ac.decide("a", pending=0, deferred=0, arriving=2)
    assert (d.action, d.reason) == ("defer", "inflight")
    svc.pump()
    d2 = ac.decide("a", pending=0, deferred=0, arriving=2)
    assert d2.action == "admit"
    return [_verdict(d), _verdict(d2), ac.snapshot()]


def ac_service_carries_the_controller_on_debug_fleet(P):
    """SolverService(admission=) holds the controller, and /debug/fleet's
    admission block is its snapshot (None without one)."""
    clock = P.FakeClock()
    ac = P.AdmissionController(defer_depth=5, shed_depth=9, seed=2)
    svc = P.SolverService(clock, backend="host", admission=ac)
    ac.service = svc
    assert svc.admission is ac
    ac.decide("t", pending=4, deferred=0, arriving=3, key="k")
    block = svc.debug_payload()["admission"]
    assert block == ac.snapshot()
    bare = P.SolverService(P.FakeClock(), backend="host")
    assert bare.admission is None
    assert bare.debug_payload()["admission"] is None
    return block


AC_CASES = {f.__name__: f for f in (
    ac_admit_below_budgets,
    ac_defer_past_soft_budget_with_deterministic_backoff,
    ac_deferred_backlog_does_not_block_reoffers,
    ac_shed_past_hard_budget_and_defer_allowance,
    ac_disabled_admits_everything, ac_rate_limit_sheds_with_rate_reason,
    ac_rate_limit_deterministic_sequence, ac_rate_limit_off_by_default,
    ac_rate_limit_zero_sheds_everything,
    ac_inflight_budget_defers_on_service_queue,
    ac_service_carries_the_controller_on_debug_fleet)}


class TestAdmissionController:
    @pytest.mark.parametrize("name", sorted(AC_CASES))
    def test_admission_equals_the_reference(self, name):
        _both(AC_CASES[name])


# --- TestQueueDepthGauge -------------------------------------------------

def queue_depth_exported(P):
    svc = P.SolverService(P.FakeClock(), backend="host")
    svc.register("a", P.CatalogProvider(lambda: P.small_catalog()))
    for _ in range(3):
        svc.submit("a", "solve", lambda: 1, cost=0.001)
    assert P.M.FLEET_QUEUE_DEPTH.value(tenant="a") == 3.0
    assert svc.snapshot()["a"]["queued"] == 3
    svc.pump()
    assert P.M.FLEET_QUEUE_DEPTH.value(tenant="a") == 0.0
    assert svc.snapshot()["a"]["queued"] == 0
    return svc.snapshot()["a"]["solves"]


class TestQueueDepthGauge:
    def test_fleet_queue_depth_exported(self):
        _both(queue_depth_exported)


# --- TestOpenLoopSource --------------------------------------------------

def _sim_source(P, rules, **ac_kw):
    clock = P.FakeClock()
    svc = P.SolverService(clock, backend="host")
    ac = P.AdmissionController(service=svc, **ac_kw)
    shard = P.build_shard("t000", clock, svc)
    plan = P.lg.LoadPlan(seed=11, rules=rules)
    src = P.lg.OpenLoopSource(plan, shard.sim, "t000", ac)
    return clock, shard, src


def source_arrivals_become_pods_without_waiting_for_drain(P):
    clock, shard, src = _sim_source(
        P, [P.lg.BurstyArrivals(every=5.0, burst=2, t0=0.0, t1=18.0,
                                pods_min=2, pods_max=2)],
        defer_depth=100, shed_depth=200)
    end = clock.now() + 25.0
    while clock.now() < end:
        shard.tick()
        clock.step(0.5)
    assert src.stats["offered_pods"] > 0
    assert src.stats["admitted_pods"] == src.stats["offered_pods"]
    assert src.drained()
    kinds = {k for _, k, _ in src.plan.timeline}
    assert kinds == {"arrive", "admit"}
    return [src.stats, src.plan.timeline, src.plan.fingerprint(),
            src.overload_state(), sorted(shard.sim.store.pods)]


def source_defer_parks_and_reoffers(P):
    clock, shard, src = _sim_source(
        P, [P.lg.BurstyArrivals(every=4.0, burst=6, t0=0.0, t1=10.0,
                                pods_min=3, pods_max=3)],
        defer_depth=6, shed_depth=500, max_defers=50)
    end = clock.now() + 120.0
    depths = []
    while clock.now() < end and not src.drained():
        shard.tick()
        depths.append((src.waiting_pods(), src.deferred_pods()))
        clock.step(0.5)
    assert src.stats["deferred_pods"] > 0
    assert src.stats["reoffers"] > 0
    assert src.drained()
    assert src.stats["shed_pods"] == 0
    return [src.stats, src.plan.timeline, src.plan.shed_defer_set(),
            depths, src.plan.fingerprint()]


SOURCE_CASES = {f.__name__: f for f in (
    source_arrivals_become_pods_without_waiting_for_drain,
    source_defer_parks_and_reoffers)}


class TestOpenLoopSource:
    @pytest.mark.parametrize("name", sorted(SOURCE_CASES))
    def test_source_equals_the_reference(self, name):
        _both(SOURCE_CASES[name])


# --- TestSoakSmoke / TestSoakOverload ------------------------------------

def soak(P, scenario, seed, backend="host", **kw):
    runner = P.SoakRunner(scenario, seed=seed, backend=backend, **kw)
    rep = runner.run()
    return runner, rep


def soak_smoke_clean_below_saturation(P):
    runner, rep = soak(P, "soak_smoke", 0)
    assert rep.ok, rep.summary()
    assert rep.converged
    assert rep.stats["shed_pods"] == 0
    assert rep.stats["overload_findings"] == 0
    assert rep.stats["offered_pods"] > 0
    assert rep.stats["admitted_pods"] == rep.stats["offered_pods"]
    return [_report(runner, rep), rep.summary()]


def soak_smoke_repeat_digests_identical(P):
    _, a = soak(P, "soak_smoke", 3)
    _reset_sequences()
    _, b = soak(P, "soak_smoke", 3)
    digests = (a.soak_hash, a.fault_fingerprint, a.load_fingerprint)
    assert digests == (b.soak_hash, b.fault_fingerprint, b.load_fingerprint)
    return digests


def soak_different_seed_different_load(P):
    _, a = soak(P, "soak_smoke", 0)
    _, b = soak(P, "soak_smoke", 1)
    assert a.load_fingerprint != b.load_fingerprint
    return [a.load_fingerprint, b.load_fingerprint]


def soak_overload_bounded_and_metered(P):
    shed = P.M.LOADGEN_SHED
    before = shed.value(tenant="t000", reason="queue_depth")
    runner, rep = soak(P, "soak_overload", 0)
    assert rep.ok, rep.summary()
    st = rep.stats
    assert st["shed_pods"] > 0
    assert st["max_waiting_depth"] <= 60 + 8
    assert st["overload_findings"] == 0
    assert st["admission_burn_alerts"] >= 1
    assert any(fp for fp in rep.tenant_fault_fingerprints.values())
    after = shed.value(tenant="t000", reason="queue_depth")
    assert after > before
    return [_report(runner, rep), after - before]


def soak_overload_repeat_contract_with_faultplan_armed(P):
    ra, a = soak(P, "soak_overload", 5)
    _reset_sequences()
    rb, b = soak(P, "soak_overload", 5)
    digests = (a.soak_hash, a.fault_fingerprint, a.load_fingerprint)
    assert digests == (b.soak_hash, b.fault_fingerprint, b.load_fingerprint)
    for t in ra.sources:
        assert ra.sources[t].plan.shed_defer_set() \
            == rb.sources[t].plan.shed_defer_set()
        assert ra.sources[t].plan.timeline == rb.sources[t].plan.timeline
    return [digests, {t: s.plan.shed_defer_set()
                      for t, s in ra.sources.items()}]


def soak_shedding_disabled_trips_watchdog(P):
    runner, rep = soak(P, "soak_overload", 0, admission=False)
    assert rep.stats["shed_pods"] == 0
    assert rep.stats["overload_findings"] >= 1
    assert rep.stats["max_waiting_depth"] > 60
    return _report(runner, rep)


SOAK_CASES = {f.__name__: f for f in (
    soak_smoke_clean_below_saturation, soak_smoke_repeat_digests_identical,
    soak_different_seed_different_load, soak_overload_bounded_and_metered,
    soak_overload_repeat_contract_with_faultplan_armed,
    soak_shedding_disabled_trips_watchdog)}


class TestSoak:
    @pytest.mark.parametrize("name", sorted(SOAK_CASES))
    def test_soak_equals_the_reference(self, name):
        _both(SOAK_CASES[name])

    @pytest.mark.parametrize("scenario", ["soak_smoke", "soak_overload"])
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("backend", ["host", "native"])
    def test_digests_equal_the_reference(self, scenario, seed, backend):
        """c13's procedure (bench.py's `SoakRunner("soak_overload",
        seed=0)`) and the tier-1 member give the reference's three
        digests on the host and native rungs."""
        def case(P):
            return _report(*soak(P, scenario, seed, backend=backend))
        _both(case)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_soak_smoke_device_rung_equals_the_reference(self, seed):
        """On the device rung every tenant's solves go through one
        batched SolverService (batched B0/B's plain versions here)."""
        def case(P):
            runner, rep = soak(P, "soak_smoke", seed, backend="device")
            assert runner.service.stats["batches"] > 0
            return _report(runner, rep)
        _both(case)


# --- TestChaosParity -----------------------------------------------------

def chaos_smoke_unperturbed_by_a_soak_run(P):
    runner = P.mod("faults.runner").ScenarioRunner
    before = runner("smoke", seed=2, **P.dev).run()
    _reset_sequences()
    P.SoakRunner("soak_smoke", seed=2, backend="host").run()
    _reset_sequences()
    after = runner("smoke", seed=2, **P.dev).run()
    assert before.ok and after.ok
    assert before.end_hash == after.end_hash
    assert before.fault_fingerprint == after.fault_fingerprint
    return [before.end_hash, before.fault_fingerprint]


class TestChaosParity:
    def test_chaos_smoke_unperturbed_by_a_soak_run(self):
        _both(chaos_smoke_unperturbed_by_a_soak_run)


# --- TestCli -------------------------------------------------------------

class TestCli:
    def test_loadgen_cli_lists_and_runs(self, capsys):
        out = {}
        for P, extra in ((REF, []), (PORT, ["--device", "cpu"])):
            main = P.mod("loadgen.__main__").main
            assert main([]) == 0
            listing = capsys.readouterr().out
            assert "soak_smoke" in listing and "soak_overload" in listing
            _reset_sequences()
            assert main(["soak_smoke", "--repeat", "2", "--backend",
                         "host"] + extra) == 0
            runs = capsys.readouterr().out
            assert "reproducible: 2 runs identical" in runs
            out[P.pkg] = (listing, runs)
        assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]

    def test_main_soak_flags_parse(self):
        argv = ["--soak", "--arrival-rate", "0.7", "--soak-duration", "40",
                "--soak-scenario", "soak_overload", "--soak-no-admission"]
        out = {}
        for P in (REF, PORT):
            Options = P.mod("utils.options").Options
            opts = Options.parse(argv)
            assert opts.soak is True
            assert opts.arrival_rate == 0.7
            assert opts.soak_duration == 40.0
            assert opts.soak_scenario == "soak_overload"
            assert opts.soak_no_admission is True
            opts2 = Options.parse(["--soak", "false"])
            assert opts2.soak is False
            out[P.pkg] = [dataclasses.asdict(o) for o in (opts, opts2)]
        for row in out["karpenter_tpu_torch"]:
            assert row.pop("device") == ""
            # the port's default rung is the device's, the reference's auto
            assert row.pop("solver_backend") == "device"
        for row in out["karpenter_tpu"]:
            assert row.pop("solver_backend") == "auto"
        assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]

    def test_run_soak_wiring(self, capsys):
        out = {}
        for P, extra in ((REF, []), (PORT, ["--device", "cpu"])):
            run_soak = P.mod("main").run_soak
            Options = P.mod("utils.options").Options
            _reset_sequences()
            # the rung the reference's default (auto) takes on the CPU
            opts = Options.parse(["--soak", "--soak-duration", "32",
                                  "--solver-backend", "native"] + extra)
            assert run_soak(opts) == 0
            text = capsys.readouterr().out
            assert "soak=soak_smoke" in text
            out[P.pkg] = text
        assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]
