"""The port's online invariant watchdog (`karpenter_tpu_torch/obs/
watchdog.py`) held against the JAX reference's.

The cases of the reference's `tests/test_watchdog.py` rerun through the
port: every invariant in `INVARIANTS` is TRIPPED by a seeded fault (the
two federation invariants over a federated service's ladder state), the
no-fault side stays quiet, clock jumps are absorbed, the
chaos, restart and fleet catalogs run with it armed and produce no
warning, and `/debug/watchdog` and `/readyz` serve it. Each trip is written
once over a namespace of either package's objects and runs through both:
the findings it fires (invariant, severity, key, message, sim time,
attributes) and the watchdog's counters must be equal, exactly. Last, a watchdog never changes a run: the end
state hash is equal with it armed and disarmed.
"""

from __future__ import annotations

import gc
import importlib
import itertools
import json
import re
import time
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
    port = pkg == "karpenter_tpu_torch"
    dev = {"device": "cpu"} if port else {}
    tracer = mod("obs.tracer")
    if port:
        import torch
        zeros = torch.zeros
    else:
        import jax.numpy as jnp
        zeros = jnp.zeros

    def make_sim(**kw):
        return mod("sim").make_sim(**dev, **kw)
    return SimpleNamespace(
        pkg=pkg, mod=mod, dev=dev, make_sim=make_sim, zeros=zeros,
        NodeClaim=mod("models.nodeclaim").NodeClaim,
        Node=mod("models.nodeclaim").Node,
        Pod=mod("models.pod").Pod, Resources=mod("models.resources").Resources,
        L=mod("models.labels"), Watchdog=mod("obs.watchdog").Watchdog,
        INVARIANTS=mod("obs.watchdog").INVARIANTS,
        FakeClock=mod("utils.clock").FakeClock, TRACER=tracer.TRACER,
        FlightRecorder=tracer.FlightRecorder, Span=tracer.Span,
        Trace=tracer.Trace, tenant_scope=mod("metrics.tenant").tenant_scope)


REF = _namespace("karpenter_tpu")
PORT = _namespace("karpenter_tpu_torch")


def _reset_planes() -> None:
    """Both packages' delta and resident planes and explain recorders
    start empty: memo keys hold id(facade), and a reused id must not meet
    a dead facade's entry in one package and not in the other."""
    for P in (REF, PORT):
        for path, name in (("ops.delta", "DELTA"),
                           ("ops.resident", "RESIDENT"),
                           ("obs.explain", "RECORDER")):
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
    gets its sequences back and its intern table, planes and meters reset
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
    for P in (REF, PORT):
        P.mod("integrity").INTEGRITY.reset()
        P.mod("obs.recompute").RECOMPUTE.reset()


def _age(target, seconds: float, step: float = 5.0) -> None:
    """Advance sim time in watchdog-cadence steps, ticking the watchdog
    each step — continuous aging, the way the engine drives it (a
    single giant step would be absorbed as a clock jump, by design)."""
    wd = target.watchdog if hasattr(target, "watchdog") else target
    clock = wd.clock
    end = clock.now() + seconds
    while clock.now() < end:
        clock.step(step)
        wd.tick()


def _findings(wd, invariant):
    return [f for f in wd.findings if f.invariant == invariant]


# --- the seeded trips, each over either package's namespace --------------
# Each asserts what the reference's test asserts and returns the watchdogs
# it armed; the parity test runs it on both packages and compares what
# fired.

def trip_claim_leak(P):
    sim = P.make_sim()
    wd = sim.watchdog
    wd.claim_grace = 50.0
    sim.store.add_nodeclaim(P.NodeClaim(name="leak-1", nodepool="default"))
    _age(sim, 30)
    assert not _findings(wd, "claim_leak")  # inside grace: quiet
    _age(sim, 40)
    found = _findings(wd, "claim_leak")
    assert found and found[0].severity == "critical"
    assert "unlaunched" in found[0].message
    assert wd.verdict() == "critical"
    WATCHDOG_FINDINGS = P.mod("metrics").WATCHDOG_FINDINGS
    assert WATCHDOG_FINDINGS.value(invariant="claim_leak",
                                   severity="critical") >= 1
    # edge-triggered: the excursion fires once, not per tick
    _age(sim, 100)
    assert len(_findings(wd, "claim_leak")) == 1
    # the claim resolving clears the excursion and the verdict
    sim.store.delete_nodeclaim("leak-1")
    wd.tick(force=True)
    assert wd.verdict() == "ok"
    return [wd]


def trip_claim_leak_duplicate_token(P):
    """Two LIVE instances under one idempotency token — never legitimate,
    fires with no grace at the next cloud sweep (seeded by tag
    corruption: a cloud-side double-provision the ledger missed)."""
    prov = P.mod("cloud.provider")
    sim = P.make_sim()
    wd = sim.watchdog
    ov = [prov.LaunchOverride(instance_type="c5.large", zone="zone-a",
                              capacity_type="on-demand", price=0.1)]
    insts = sim.cloud.create_fleet(
        [prov.LaunchRequest(nodeclaim_name=f"dup-{i}", overrides=ov)
         for i in range(2)])
    live = [i for i in insts if getattr(i, "id", None)]
    assert len(live) == 2
    for inst in live:
        inst.tags[P.L.TAG_LAUNCH_TOKEN] = "tok-dup"
    wd.tick(force=True)
    found = _findings(wd, "claim_leak")
    assert found and "token" in found[0].message
    return [wd]


def trip_store_cloud_drift(P):
    sim = P.make_sim()
    wd = sim.watchdog
    wd.drift_grace = 40.0
    wd.CLOUD_SWEEP = 5.0
    sim.store.add_node(P.Node(name="ghost",
                              provider_id="tpu:///zone-a/i-nope"))
    wd.tick(force=True)
    assert not _findings(wd, "store_cloud_drift")  # first sighting
    _age(sim, 60)
    found = _findings(wd, "store_cloud_drift")
    assert found and found[0].severity == "critical"
    assert "ghost" in found[0].message
    # repairing the store clears the excursion
    sim.store.delete_node("ghost")
    _age(sim, 20)
    assert wd.verdict() == "ok"
    return [wd]


def trip_intent_age(P):
    INTENT_GRACE = P.mod("controllers.gc").INTENT_GRACE
    sim = P.make_sim()
    wd = sim.watchdog
    sim.journal.open_launch("wedged-claim", "default", "default",
                            token="tok-wedge", now=sim.clock.now())
    _age(sim, INTENT_GRACE * 0.8, step=20.0)
    assert not _findings(wd, "intent_age")  # the GC shield window
    _age(sim, INTENT_GRACE * 0.4, step=20.0)
    found = _findings(wd, "intent_age")
    assert found and found[0].severity == "critical"
    assert "wedged-claim" in found[0].message
    return [wd]


def trip_warm_audit_lag(P):
    sim = P.make_sim(warmpath=True, warm_audit_every=999)
    wd = sim.watchdog
    pod = P.Pod(name="lagged", requests=P.Resources.parse(
        {"cpu": "100m", "memory": "64Mi"}))
    # a recorded warm admission the lazy auditor never replays
    sim.warmpath.auditor.record("default", [pod],
                                {"default/lagged": "claim-x"},
                                now=sim.clock.now())
    _age(sim, 60)
    assert not _findings(wd, "warm_audit_lag")
    _age(sim, 100)
    found = _findings(wd, "warm_audit_lag")
    assert found and found[0].severity == "warning"
    # the audit running clears the lag
    sim.warmpath.auditor.audit()
    wd.tick(force=True)
    assert wd.verdict() == "ok"
    return [wd]


def trip_warm_divergence(P):
    sim = P.make_sim(warmpath=True)
    wd = sim.watchdog
    pod = P.Pod(name="div", requests=P.Resources.parse(
        {"cpu": "100m", "memory": "64Mi"}))
    # a recorded batch with no committed baseline: the replay cannot
    # vouch for it — a genuine divergence, metered and forced cold
    sim.warmpath.auditor.record("default", [pod], {"default/div": "claim-x"},
                                now=sim.clock.now())
    sim.warmpath._run_audit()
    assert sim.warmpath.stats["divergences"] >= 1
    wd.tick(force=True)
    found = _findings(wd, "warm_divergence")
    assert found and found[0].severity == "warning"
    assert "forced cold" in found[0].message
    return [wd]


def trip_fleet_starvation(P):
    small_catalog = P.mod("catalog").small_catalog
    CatalogProvider = P.mod("catalog.provider").CatalogProvider
    SolverService = P.mod("fleet.service").SolverService
    clock = P.FakeClock()
    svc = SolverService(clock, backend="host", **P.dev)
    svc.register("hog", CatalogProvider(lambda: small_catalog()))
    svc.register("victim", CatalogProvider(lambda: small_catalog()))
    wd = P.Watchdog(clock, service=svc).arm()
    wd.tick(force=True)
    assert not _findings(wd, "fleet_starvation")
    # the hog queues seconds of virtual device time; its own later
    # tickets wait behind its backlog past the starvation threshold
    for _ in range(4):
        svc.submit("hog", "solve", lambda: 1, cost=2.0)
    svc.pump()
    assert svc.tenants["hog"].max_wait >= wd.starvation_s
    wd.tick(force=True)
    found = _findings(wd, "fleet_starvation")
    assert found and found[0].severity == "warning"
    # backlog flavor: queued-but-undispatched tickets over the max
    wd2 = P.Watchdog(clock, service=svc, backlog_max=2).arm()
    for _ in range(4):
        svc.submit("victim", "solve", lambda: 1, cost=0.001)
    wd2.tick(force=True)
    assert any(f.key == "backlog" for f in _findings(wd2, "fleet_starvation"))
    svc.pump()
    return [wd, wd2]


def trip_pipeline_stall(P):
    small_catalog = P.mod("catalog").small_catalog
    CatalogProvider = P.mod("catalog.provider").CatalogProvider
    SolverService = P.mod("fleet.service").SolverService
    clock = P.FakeClock()
    svc = SolverService(clock, backend="host", batch=True, **P.dev)
    svc.register("a", CatalogProvider(lambda: small_catalog()))
    wd = P.Watchdog(clock, service=svc, pipeline_grace=30.0).arm()
    wd.tick(force=True)
    assert not _findings(wd, "pipeline_stall")
    # flavor 1: a device batch dispatched and never drained — the
    # pipeline wedged; a healthy pump always drains before returning
    svc._inflight_since = float(clock.now())
    clock.step(60.0)
    wd.tick(force=True)
    found = _findings(wd, "pipeline_stall")
    assert found and found[0].severity == "warning"
    assert found[0].key == "inflight"
    # draining clears the excursion (edge re-arms)
    svc._inflight_since = None
    wd.tick(force=True)
    assert ("pipeline_stall", "inflight") not in wd._active
    # flavor 2: a shape class that co-pends >=2 tickets pump after pump
    # but NEVER co-batches them — the bucketing silently dead
    svc.class_stats["g8/n64"] = {
        "tickets": 12, "batches": 6,
        "copending_pumps": wd.COBATCH_MIN_PUMPS, "cobatched_pumps": 0}
    wd.tick(force=True)
    assert any(f.key == "class/g8/n64"
               for f in _findings(wd, "pipeline_stall"))
    # a serial service (batch unarmed) never evaluates the monitor
    svc2 = SolverService(P.FakeClock(), backend="host", **P.dev)
    svc2._inflight_since = -1e9
    wd2 = P.Watchdog(svc2.clock, service=svc2).arm()
    wd2.tick(force=True)
    assert not _findings(wd2, "pipeline_stall")
    return [wd, wd2]


def trip_federation_degraded(P):
    """A wire failure arms the federated client's cooldown — the watchdog
    pages while the fleet is silently running buckets on the local path
    instead of over the wire."""
    build = P.mod("federation").build_federated_service
    SolverService = P.mod("fleet.service").SolverService
    clock = P.FakeClock()
    svc = build(clock, run_id="wd-test", backend="host", **P.dev)
    wd = P.Watchdog(clock, service=svc).arm()
    wd.tick(force=True)
    assert not _findings(wd, "federation_degraded")
    # seed the exact state _dispatch_bucket leaves after a wire failure:
    # failure count, cooldown window, last error
    svc._fed_failures = 1
    svc._fed_cooldown = 3
    svc._fed_last_error = "ConnectionError: connection refused"
    wd.tick(force=True)
    found = _findings(wd, "federation_degraded")
    assert found and found[0].severity == "warning"
    assert found[0].key == "wire"
    assert found[0].attrs["cooldown"] == 3
    # recovery: the cooldown is spent and the wire probes clean — the
    # edge clears so a later failure can page again
    svc._fed_cooldown = 0
    wd.tick(force=True)
    assert ("federation_degraded", "wire") not in wd._active
    # an in-process service exposes no federation_state and never
    # evaluates the monitor
    svc2 = SolverService(P.FakeClock(), backend="host", **P.dev)
    wd2 = P.Watchdog(svc2.clock, service=svc2).arm()
    wd2.tick(force=True)
    assert not _findings(wd2, "federation_degraded")
    return [wd, wd2]


def trip_federation_rejoin(P):
    """The recovery ladder's own invariant: the breaker sits open past
    the grace while healthz probes pass — the server is healthy but the
    client never rejoins. Probes failing (server genuinely down) must NOT
    fire: degraded is then the correct steady state."""
    build = P.mod("federation").build_federated_service
    clock = P.FakeClock()
    svc = build(clock, run_id="wd-rejoin", backend="host", **P.dev)
    wd = P.Watchdog(clock, service=svc).arm()
    wd.tick(force=True)
    assert not _findings(wd, "federation_rejoin")
    # seed the exact state the breaker leaves after a wire failure: open,
    # cooldown armed, degraded-since stamped
    svc._breaker = "open"
    svc._fed_failures = 1
    svc._fed_cooldown = 8
    svc._fed_last_error = "ConnectionError: connection reset"
    svc._degraded_since = clock.now()
    svc._probe_ok_degraded = 0
    # degraded pages immediately; rejoin stays quiet — no probe has
    # passed yet, so "stuck" cannot be distinguished from "down"
    _age(wd, wd.REJOIN_GRACE + 15.0)
    assert _findings(wd, "federation_degraded")
    assert not _findings(wd, "federation_rejoin")
    # healthz probes pass while STILL degraded past the grace: the ladder
    # should have closed the breaker by now — page
    svc._probe_ok_degraded = 3
    wd.tick(force=True)
    found = _findings(wd, "federation_rejoin")
    assert found and found[0].severity == "warning"
    assert found[0].key == "wire"
    assert found[0].attrs["probes_ok"] == 3
    assert found[0].attrs["breaker"] == "open"
    assert found[0].attrs["degraded_for"] >= wd.REJOIN_GRACE
    # edge-triggered: the excursion fires once, not per tick
    _age(wd, 20.0)
    assert len(_findings(wd, "federation_rejoin")) == 1
    return [wd]


def _fake_loadgen(depth: int, armed: bool):
    class _FakeLoadgen:
        def __init__(self):
            self.depth = depth

        def overload_state(self):
            return {"t000": {"depth": self.depth, "oldest_age_s": 0.0,
                             "budget": 60, "armed": armed}}
    return _FakeLoadgen()


def trip_overload_unbounded(P):
    """The reference's `test_loadgen.py::
    test_shedding_disabled_trips_watchdog`, fed by the real admission
    controller: soak_overload with shedding DISABLED grows its open-loop
    backlog past the admission budget, and the fleet watchdog fires
    overload_unbounded. Run on a flight-recorder ring of its own, as the
    reference's loadgen module does."""
    old = P.TRACER.recorder
    P.TRACER.recorder = P.FlightRecorder(size=old.size)
    try:
        runner = P.mod("loadgen").SoakRunner("soak_overload", seed=0,
                                             backend="host",
                                             admission=False, **P.dev)
        rep = runner.run()
    finally:
        P.TRACER.recorder = old
    assert rep.stats["shed_pods"] == 0
    assert rep.stats["overload_findings"] >= 1
    assert rep.stats["max_waiting_depth"] > 60  # past the budget
    found = _findings(runner.watchdog, "overload_unbounded")
    assert found and all(f.severity == "critical" for f in found)
    assert all("DISABLED" in f.message for f in found)
    return [runner.watchdog] + [s.sim.watchdog for s in runner.shards]


def trip_overload_grace_edge_and_shrink(P):
    """The watchdog's overload_unbounded semantics over a stand-in
    observable (the reference's `test_watchdog.py::
    test_trip_overload_unbounded`): quiet under budget and inside the
    grace, one critical finding past it, cleared by draining, and a
    shrinking over-budget backlog never fires."""
    lg = _fake_loadgen(0, False)
    clock = P.FakeClock()
    wd = P.Watchdog(clock, loadgen=lg, overload_grace=45.0).arm()
    # under budget: no excursion opens
    lg.depth = 40
    wd.tick(force=True)
    assert not _findings(wd, "overload_unbounded")
    # over budget but inside the grace: still quiet
    lg.depth = 80
    wd.tick(force=True)
    clock.step(20.0)
    lg.depth = 100
    wd.tick(force=True)
    assert not _findings(wd, "overload_unbounded")
    # still growing past the grace: critical finding, once
    clock.step(30.0)
    lg.depth = 140
    wd.tick(force=True)
    found = _findings(wd, "overload_unbounded")
    assert found and found[0].severity == "critical"
    assert found[0].key == "t000"
    assert "DISABLED" in found[0].message
    assert wd.verdict() == "critical"
    clock.step(10.0)
    lg.depth = 160
    wd.tick(force=True)
    assert len(_findings(wd, "overload_unbounded")) == 1  # edge
    # the backlog draining back under budget clears the excursion
    lg.depth = 10
    wd.tick(force=True)
    assert wd.verdict() == "ok"
    # a SHRINKING over-budget backlog (admission catching up) does not
    # fire: growth is the unbounded signal, not the excursion
    wd2 = P.Watchdog(P.FakeClock(), loadgen=lg, overload_grace=45.0).arm()
    lg.depth = 200
    wd2.tick(force=True)
    wd2.clock.step(60.0)
    lg.depth = 120
    wd2.tick(force=True)
    assert not _findings(wd2, "overload_unbounded")
    return [wd, wd2]


def trip_optimizer_divergence(P):
    """The exact verifier rejecting the optimizer's ranked subsets
    OPTIMIZER_STREAK times in a row fires a warning for the tenant; an
    accept resets the streak; pre-arm residue never fires."""
    OPTIMIZER = P.mod("optimizer.stats").OPTIMIZER
    with P.tenant_scope("stale"):
        for _ in range(P.Watchdog.OPTIMIZER_STREAK + 2):
            OPTIMIZER.record_verify(False)
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()
    wd.tick(force=True)
    assert not _findings(wd, "optimizer_divergence")  # residue
    # healthy verify traffic: some rejects, then an accept — quiet
    with P.tenant_scope("t001"):
        for _ in range(P.Watchdog.OPTIMIZER_STREAK - 1):
            OPTIMIZER.record_verify(False)
    wd.tick(force=True)
    assert not _findings(wd, "optimizer_divergence")
    with P.tenant_scope("t001"):
        OPTIMIZER.record_verify(True)
    wd.tick(force=True)
    assert not _findings(wd, "optimizer_divergence")
    # a real divergence streak: fires once (edge), warning, keyed by the
    # tenant
    with P.tenant_scope("t001"):
        for _ in range(P.Watchdog.OPTIMIZER_STREAK):
            OPTIMIZER.record_verify(False)
    wd.tick(force=True)
    found = _findings(wd, "optimizer_divergence")
    assert found and found[0].severity == "warning"
    assert found[0].key == "t001"
    wd.tick(force=True)
    assert len(_findings(wd, "optimizer_divergence")) == 1
    assert wd.verdict() == "warning"
    # an accept repairs the ranking: excursion clears, verdict ok
    with P.tenant_scope("t001"):
        OPTIMIZER.record_verify(True)
    wd.tick(force=True)
    assert wd.verdict() == "ok"
    return [wd]


def trip_integrity_breach(P):
    """A solution-integrity violation fires a critical finding once; it
    clears after recovery, an UNRECOVERED violation holds the verdict
    critical, and pre-arm residue never fires."""
    INTEGRITY = P.mod("integrity").INTEGRITY
    INTEGRITY.reset()
    INTEGRITY.record_violation("capacity", "stale-run", tenant="old")
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()
    wd.tick(force=True)
    assert not _findings(wd, "integrity_breach")  # residue is quiet
    INTEGRITY.record_ok(tenant="t001")
    wd.tick(force=True)
    assert not _findings(wd, "integrity_breach")
    INTEGRITY.record_violation("capacity", "node 0 over", "t001")
    INTEGRITY.record_recovery(True, tenant="t001")
    wd.tick(force=True)
    found = _findings(wd, "integrity_breach")
    assert found and found[0].severity == "critical"
    assert found[0].key == "t001"
    wd.tick(force=True)
    assert len(_findings(wd, "integrity_breach")) == 1  # edge
    wd.tick(force=True)
    assert wd.verdict() == "ok"
    INTEGRITY.record_violation("price", "host disagrees", "t002")
    INTEGRITY.record_recovery(False, tenant="t002")
    wd.tick(force=True)
    assert _findings(wd, "integrity_breach")
    wd.tick(force=True)
    assert wd.verdict() == "critical"
    INTEGRITY.reset()
    return [wd]


def trip_recompute_runaway(P):
    """A stage whose redundant fraction sits above RECOMPUTE_FRAC and
    keeps RISING past the grace fires once; pre-arm residue never
    counts."""
    RECOMPUTE = P.mod("obs.recompute").RECOMPUTE
    W = P.Watchdog
    RECOMPUTE.reset()
    RECOMPUTE.classify("encode", 1)
    for _ in range(600):
        RECOMPUTE.classify("encode", 1)
    clock = P.FakeClock()
    wd = W(clock).arm()
    wd.tick(force=True)
    assert not _findings(wd, "recompute_runaway")  # residue is quiet
    for _ in range(W.RECOMPUTE_MIN_UNITS // 4):
        RECOMPUTE.classify("solve", 7)
    _age(wd, 30)
    assert not _findings(wd, "recompute_runaway")
    for i in range(29):
        RECOMPUTE.classify("solve", 100 + i)  # fresh variety
    for _ in range(240):
        RECOMPUTE.classify("solve", 7)
    wd.tick(force=True)
    assert not _findings(wd, "recompute_runaway")  # stamped, quiet
    for _ in range(300):
        RECOMPUTE.classify("solve", 7)
    _age(wd, W.RECOMPUTE_GRACE + 30)
    found = _findings(wd, "recompute_runaway")
    assert found and found[0].severity == "warning"
    assert found[0].key == "solve"
    assert found[0].attrs["frac"] > W.RECOMPUTE_FRAC
    wd.tick(force=True)
    assert len(_findings(wd, "recompute_runaway")) == 1  # edge
    assert wd.verdict() == "warning"
    for i in range(2000):
        RECOMPUTE.classify("solve", 10_000 + i)
    wd.tick(force=True)
    assert wd.verdict() == "ok"
    RECOMPUTE.reset()
    return [wd]


def trip_recompute_steady_plateau_never_fires(P):
    RECOMPUTE = P.mod("obs.recompute").RECOMPUTE
    W = P.Watchdog
    RECOMPUTE.reset()
    clock = P.FakeClock()
    wd = W(clock).arm()
    for i in range(25):
        RECOMPUTE.classify("disrupt", i)
    for _ in range(475):
        RECOMPUTE.classify("disrupt", 1)
    wd.tick(force=True)
    for window in range(10):
        _age(wd, W.RECOMPUTE_GRACE / 2)
        for i in range(2):
            RECOMPUTE.classify("disrupt", 50_000 + 100 * window + i)
        for _ in range(38):
            RECOMPUTE.classify("disrupt", 1)
    assert not _findings(wd, "recompute_runaway")
    assert wd.verdict() == "ok"
    RECOMPUTE.reset()
    return [wd]


def trip_recompute_jump_absorbed(P):
    RECOMPUTE = P.mod("obs.recompute").RECOMPUTE
    W = P.Watchdog
    RECOMPUTE.reset()
    clock = P.FakeClock()
    wd = W(clock).arm()
    for i in range(30):
        RECOMPUTE.classify("spread", 100 + i)  # fresh variety
    for _ in range(290):
        RECOMPUTE.classify("spread", 1)  # ~0.90 at the stamp
    wd.tick(force=True)  # stamps the excursion
    for _ in range(200):
        RECOMPUTE.classify("spread", 1)
    clock.step(W.RECOMPUTE_GRACE + 120)  # one giant jump
    wd.tick()
    assert not _findings(wd, "recompute_runaway")  # absorbed
    assert wd.stats["jump_absorbed"] >= 1
    for _ in range(200):
        RECOMPUTE.classify("spread", 1)
    _age(wd, W.RECOMPUTE_GRACE + 30)  # genuine aging fires
    assert _findings(wd, "recompute_runaway")
    RECOMPUTE.reset()
    return [wd]


def trip_overload_jump_absorbed(P):
    lg = _fake_loadgen(100, True)
    clock = P.FakeClock()
    wd = P.Watchdog(clock, loadgen=lg, overload_grace=45.0,
                    interval=5.0).arm()
    wd.tick(force=True)          # excursion opens at t0
    clock.step(300.0)            # one giant step = a jump, absorbed
    lg.depth = 110
    wd.tick(force=True)
    assert wd.stats["jump_absorbed"] >= 1
    assert not _findings(wd, "overload_unbounded")
    return [wd]


def trip_profile_unattributed(P):
    LEDGER = P.mod("obs.profile").LEDGER
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()
    wd.tick(force=True)
    assert not _findings(wd, "profile_unattributed")
    # a traced hot-path root whose wall time no bucket claims
    root = P.Span(name="bench.gap", trace_id="gap1", span_id=1,
                  parent_id=None, t0=0.0, t1=0.050, ts=0.0)
    LEDGER.ingest(P.Trace(trace_id="gap1", spans=[root]))
    clock.step(wd.interval + 1)
    wd.tick(force=True)
    found = _findings(wd, "profile_unattributed")
    assert found and found[0].severity == "info"
    assert found[0].attrs["gap_ms"] >= wd.UNATTRIBUTED_MS
    return [wd]


class _Owner:
    pass


def trip_devicemem_leak(P):
    """A residency-ledger group whose OWNER died while its buffers stay
    live (pinned elsewhere) past the grace is a leak; freeing the buffers
    clears it."""
    DEVICEMEM = P.mod("obs.devicemem").DEVICEMEM
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()
    owner = _Owner()
    arr = P.zeros(256)  # the pin: outlives its owner below
    DEVICEMEM.track("catalog", [arr], owner=owner,
                    token=("shared", "leaktest"))
    wd.tick(force=True)
    assert not _findings(wd, "devicemem_leak")  # owner alive: healthy
    del owner
    try:
        _age(wd, wd.DEVICEMEM_GRACE + wd.interval + 1)
        found = _findings(wd, "devicemem_leak")
        assert found and found[0].severity == "warning"
        assert found[0].attrs["leaked_bytes"] >= 256 * 4
        assert "leaktest" in found[0].message
    finally:
        del arr
    wd.tick(force=True)
    assert not any(inv == "devicemem_leak" for inv, _k in wd._active)
    return [wd]


def trip_devicemem_orphans_predating_arm_never_fire(P):
    DEVICEMEM = P.mod("obs.devicemem").DEVICEMEM
    owner = _Owner()
    arr = P.zeros(64)
    DEVICEMEM.track("catalog", [arr], owner=owner)
    del owner  # orphaned BEFORE arm
    try:
        clock = P.FakeClock()
        wd = P.Watchdog(clock).arm()
        _age(wd, wd.DEVICEMEM_GRACE + wd.interval + 1)
        assert not _findings(wd, "devicemem_leak")
    finally:
        del arr
    return [wd]


def trip_resident_staleness(P):
    import numpy as np
    RESIDENT = P.mod("ops.resident").RESIDENT
    RESIDENT.reset()
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()
    mat = np.ones((4, 8), np.float32)
    key = ("facade", 1234, "nc-stale", False, 0)
    RESIDENT.upload(key + ("gbuf", 8), mat, token=("nc-stale", 7), **P.dev)
    RESIDENT.observe_view(("facade", 1234, "nc-stale"), ("nc-stale", 7))
    wd.tick(force=True)
    assert not _findings(wd, "resident_staleness")
    # the catalog epoch moves on, the entry never refreshes
    RESIDENT.observe_view(("facade", 1234, "nc-stale"), ("nc-stale", 8))
    _age(wd, wd.RESIDENT_GRACE + wd.interval + 1)
    found = _findings(wd, "resident_staleness")
    assert found and found[0].severity == "warning"
    assert "nc-stale" in found[0].message
    # a refresh at the new token (what the next solve does) clears it
    RESIDENT.upload(key + ("gbuf", 8), mat, token=("nc-stale", 8), **P.dev)
    wd.tick(force=True)
    assert not any(inv == "resident_staleness" for inv, _k in wd._active)
    RESIDENT.reset()
    return [wd]


def trip_resident_staleness_predating_arm_never_fires(P):
    import numpy as np
    RESIDENT = P.mod("ops.resident").RESIDENT
    RESIDENT.reset()
    mat = np.ones((2, 4), np.float32)
    key = ("facade", 99, "nc-old", False, 0)
    RESIDENT.upload(key + ("gbuf", 4), mat, token=("nc-old", 1), **P.dev)
    RESIDENT.observe_view(("facade", 99, "nc-old"), ("nc-old", 2))
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()  # already stale HERE: residue
    _age(wd, wd.RESIDENT_GRACE + wd.interval + 1)
    assert not _findings(wd, "resident_staleness")
    RESIDENT.reset()
    return [wd]


def trip_delta_staleness(P):
    DELTA = P.mod("ops.delta").DELTA
    DELTA.reset()
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()
    key = ("facade", 4321, "nc-delta")
    DELTA.store("solve", key, 42, "memoized-result", check_fp=7)
    for _ in range(DELTA.audit_every):
        DELTA.serve("solve", key, 42)
    wd.tick(force=True)
    assert not _findings(wd, "delta_staleness")
    _age(wd, wd.DELTA_GRACE + wd.interval + 1)
    found = _findings(wd, "delta_staleness")
    assert found and found[0].severity == "warning"
    assert "nc-delta" in found[0].message
    assert found[0].attrs["stage"] == "solve"
    assert found[0].attrs["since_confirm"] >= DELTA.audit_every
    DELTA.confirm("solve", key, 42)
    wd.tick(force=True)
    assert not any(inv == "delta_staleness" for inv, _k in wd._active)
    DELTA.reset()
    return [wd]


def trip_delta_staleness_predating_arm_never_fires(P):
    DELTA = P.mod("ops.delta").DELTA
    DELTA.reset()
    key = ("facade", 777, "nc-residue")
    DELTA.store("affinity", key, 9, "memoized-descriptor")
    for _ in range(DELTA.audit_every):
        DELTA.serve("affinity", key, 9)
    clock = P.FakeClock()
    wd = P.Watchdog(clock).arm()  # already audit-due HERE: residue
    _age(wd, wd.DELTA_GRACE + wd.interval + 1)
    assert not _findings(wd, "delta_staleness")
    DELTA.reset()
    return [wd]


def _slow(P):
    return P.Trace(trace_id="slow", spans=[
        P.Span(name="s", trace_id="slow", span_id=1, parent_id=None,
               t0=0.0, t1=1.0)])


def _fast(P, tid):
    return P.Trace(trace_id=tid, spans=[
        P.Span(name="s", trace_id=tid, span_id=1, parent_id=None,
               t0=0.0, t1=1e-6)])


def trip_meter_monitors_attribute_per_tenant(P):
    clock = P.FakeClock()
    saved = P.TRACER.recorder
    try:
        P.TRACER.recorder = P.FlightRecorder(1)
        wd = P.Watchdog(clock).arm()
        P.TRACER.recorder.offer(_slow(P))
        with P.tenant_scope("b"):
            for i in range(wd.RING_DROPS + 5):
                P.TRACER.recorder.offer(_fast(P, f"f{i}"))
        clock.step(wd.interval + 1)
        wd.tick(force=True)
        found = _findings(wd, "trace_ring_overflow")
        assert found and found[0].key == "ring/b"
        assert found[0].attrs["tenant"] == "b"
        assert P.TRACER.recorder.dropped_by_tenant["b"] >= wd.RING_DROPS
    finally:
        P.TRACER.recorder = saved
    return [wd]


def trip_meter_overflow_fires_on_diffuse_cross_tenant_drops(P):
    clock = P.FakeClock()
    saved = P.TRACER.recorder
    try:
        P.TRACER.recorder = P.FlightRecorder(1)
        wd = P.Watchdog(clock).arm()
        P.TRACER.recorder.offer(_slow(P))
        per_tenant = wd.RING_DROPS // 4  # well below the threshold
        for t in range(8):               # 8 * 16 = 128 >= 64 total
            with P.tenant_scope(f"t{t}"):
                for i in range(per_tenant):
                    P.TRACER.recorder.offer(_fast(P, f"d{t}-{i}"))
        clock.step(wd.interval + 1)
        wd.tick(force=True)
        found = _findings(wd, "trace_ring_overflow")
        assert found and found[0].key == "ring"  # the aggregate edge
        assert found[0].attrs["dropped"] >= wd.RING_DROPS
    finally:
        P.TRACER.recorder = saved
    return [wd]


def trip_marker_rejections_never_meter(P):
    rec = P.FlightRecorder(1)
    rec.offer(_slow(P))
    marker = P.Trace(trace_id="m", spans=[
        P.Span(name="watchdog.finding", trace_id="m", span_id=0,
               parent_id=None, t0=0.0, t1=1e-6)])
    assert rec.offer(marker, meter=False) is False
    assert rec.dropped == 0 and rec.dropped_by_tenant == {}
    assert rec.offer(marker) is False  # a metered reject DOES count
    assert rec.dropped == 1
    return []


def trip_trace_ring_overflow(P):
    clock = P.FakeClock()
    saved = P.TRACER.recorder
    try:
        P.TRACER.recorder = P.FlightRecorder(1)
        wd = P.Watchdog(clock).arm()
        P.TRACER.recorder.offer(_slow(P))
        wd.tick(force=True)
        assert not _findings(wd, "trace_ring_overflow")
        for i in range(wd.RING_DROPS + 5):
            P.TRACER.recorder.offer(_fast(P, f"f{i}"))
        assert P.TRACER.recorder.dropped >= wd.RING_DROPS
        clock.step(wd.interval + 1)
        wd.tick(force=True)
        found = _findings(wd, "trace_ring_overflow")
        assert found and found[0].severity == "info"
    finally:
        P.TRACER.recorder = saved
    return [wd]


def jump_does_not_age_claims(P):
    """A +300s chaos ClockJump must not turn a healthy launch into a fake
    leak — the stamp shift keeps observed ages continuous."""
    sim = P.make_sim()
    wd = sim.watchdog
    wd.claim_grace = 200.0
    sim.store.add_nodeclaim(P.NodeClaim(name="young", nodepool="default"))
    _age(sim, 20)
    sim.clock.step(300.0)  # the skew event
    wd.tick()
    assert wd.stats["jump_absorbed"] >= 1
    assert not _findings(wd, "claim_leak")
    _age(sim, 300)  # and aging still works afterwards
    assert _findings(wd, "claim_leak")
    return [wd]


def duplicate_token_excursion_clears_on_termination(P):
    prov = P.mod("cloud.provider")
    sim = P.make_sim()
    wd = sim.watchdog
    ov = [prov.LaunchOverride(instance_type="c5.large", zone="zone-a",
                              capacity_type="on-demand", price=0.1)]
    live = [i for i in sim.cloud.create_fleet(
        [prov.LaunchRequest(nodeclaim_name=f"dupfix-{i}", overrides=ov)
         for i in range(2)]) if getattr(i, "id", None)]
    for inst in live:
        inst.tags[P.L.TAG_LAUNCH_TOKEN] = "tok-fix"
    wd.tick(force=True)
    assert wd.verdict() == "critical"
    # the operator terminates one copy: the excursion must clear
    sim.cloud.terminate([live[0].id])
    sim.clock.step(wd.interval + 1)
    wd.tick(force=True)
    assert wd.verdict() == "ok"
    return [wd]


def jump_does_not_fake_warm_audit_lag(P):
    sim = P.make_sim(warmpath=True, warm_audit_every=999)
    wd = sim.watchdog
    pod = P.Pod(name="j", requests=P.Resources.parse(
        {"cpu": "100m", "memory": "64Mi"}))
    sim.warmpath.auditor.record("default", [pod], {"default/j": "c"},
                                now=sim.clock.now())
    _age(sim, 20)  # watchdog observes the pending window
    sim.clock.step(3600.0)  # the skew event
    wd.tick()
    assert not _findings(wd, "warm_audit_lag"), \
        "a clock jump aged a seconds-old batch into a finding"
    _age(sim, 200)  # genuine lag afterwards still fires
    assert _findings(wd, "warm_audit_lag")
    return [wd]


TRIPS = {f.__name__: f for f in (
    trip_claim_leak, trip_claim_leak_duplicate_token, trip_store_cloud_drift,
    trip_intent_age, trip_warm_audit_lag, trip_warm_divergence,
    trip_fleet_starvation, trip_pipeline_stall, trip_federation_degraded,
    trip_federation_rejoin, trip_overload_unbounded,
    trip_overload_grace_edge_and_shrink,
    trip_optimizer_divergence, trip_integrity_breach, trip_recompute_runaway,
    trip_recompute_steady_plateau_never_fires, trip_recompute_jump_absorbed,
    trip_overload_jump_absorbed, trip_profile_unattributed,
    trip_devicemem_leak, trip_devicemem_orphans_predating_arm_never_fire,
    trip_resident_staleness,
    trip_resident_staleness_predating_arm_never_fires, trip_delta_staleness,
    trip_delta_staleness_predating_arm_never_fires,
    trip_meter_monitors_attribute_per_tenant,
    trip_meter_overflow_fires_on_diffuse_cross_tenant_drops,
    trip_marker_rejections_never_meter, trip_trace_ring_overflow,
    jump_does_not_age_claims, duplicate_token_excursion_clears_on_termination,
    jump_does_not_fake_warm_audit_lag)}


class TestArming:
    def test_make_sim_arms_by_default(self):
        sim = PORT.make_sim()
        assert sim.watchdog is not None and sim.watchdog.armed
        assert sim.engine.watchdog is sim.watchdog
        assert sim.watchdog.verdict() == "ok"

    def test_opt_out(self):
        sim = PORT.make_sim(watchdog=False)
        assert sim.watchdog is None and sim.engine.watchdog is None

    def test_invariant_taxonomy_frozen(self):
        assert PORT.INVARIANTS == REF.INVARIANTS == (
            "claim_leak", "store_cloud_drift", "intent_age",
            "warm_audit_lag", "warm_divergence", "fleet_starvation",
            "pipeline_stall", "profile_unattributed",
            "trace_ring_overflow", "devicemem_leak",
            "resident_staleness", "delta_staleness",
            "overload_unbounded", "optimizer_divergence",
            "integrity_breach", "recompute_runaway",
            "federation_degraded", "federation_rejoin")


def _normal(f) -> dict:
    """A finding as a dict, with the residency ledger's process-local
    group id masked (each package numbers its own groups)."""
    d = f.to_dict()
    for k in ("key", "message"):
        d[k] = re.sub(r"group/\d+", "group/N", d[k])
    return d


@pytest.mark.parametrize("name", sorted(TRIPS))
def test_trip_equals_the_reference(name):
    """One seeded fault per invariant, each asserting the no-fault side
    too, through both packages: the same findings, at the same sim time,
    with the same attributes, and the same counters."""
    out = {}
    for P in (REF, PORT):
        _reset_sequences()
        wds = TRIPS[name](P)
        out[P.pkg] = [([_normal(f) for f in wd.findings], dict(wd.stats),
                       dict(wd._fired), wd.verdict()) for wd in wds]
        gc.collect()
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]


class TestZeroFalsePositives:
    """The existing catalogs with the watchdog armed: no warning or
    critical findings, and the determinism contract intact."""

    def test_chaos_smoke_clean_and_deterministic(self):
        from karpenter_tpu_torch.faults.runner import ScenarioRunner
        reports = [ScenarioRunner("smoke", seed=7, device="cpu").run()
                   for _ in range(2)]
        for rep in reports:
            assert rep.ok, rep.summary()
            assert rep.stats["watchdog_findings_warning"] == 0
            assert rep.stats["watchdog_evals"] > 0
        assert reports[0].end_hash == reports[1].end_hash
        assert (reports[0].fault_fingerprint
                == reports[1].fault_fingerprint)

    def test_restart_smoke_clean(self):
        from karpenter_tpu_torch.faults.runner import RestartRunner
        rep = RestartRunner("restart_smoke", seed=1, device="cpu").run()
        assert rep.ok, rep.summary()
        assert rep.stats["watchdog_findings_warning"] == 0

    def test_fleet_smoke_clean(self):
        from karpenter_tpu_torch.fleet.runner import FleetRunner
        runner = FleetRunner("fleet_smoke", tenants=3, seed=0, device="cpu")
        rep = runner.run()
        assert rep.ok, rep.summary()
        assert rep.stats["watchdog_findings"] == 0
        assert runner.watchdog.verdict() == "ok"

    def test_ice_storm_clean(self):
        from karpenter_tpu_torch.faults.runner import ScenarioRunner
        rep = ScenarioRunner("ice_storm", seed=0, device="cpu").run()
        assert rep.ok, rep.summary()
        assert rep.stats["watchdog_findings_warning"] == 0


class TestCrossCheck:
    def test_blind_spot_reported(self):
        sim = PORT.make_sim()
        wd = sim.watchdog
        v = ["claim foo leaked: never launched (phase=Unknown)"]
        blind = wd.cross_check(v)
        assert blind and "blind spot" in blind[0]
        assert "claim_leak" in blind[0]

    def test_found_it_first_suppresses_blind_spot(self):
        sim = PORT.make_sim()
        wd = sim.watchdog
        wd.claim_grace = 10.0
        sim.store.add_nodeclaim(PORT.NodeClaim(name="leak-2",
                                               nodepool="default"))
        _age(sim, 30)
        assert wd.fired("claim_leak")
        blind = wd.cross_check(
            ["claim leak-2 leaked: never launched (phase=Unknown)"])
        assert blind == []

    def test_unmapped_violations_ignored(self):
        sim = PORT.make_sim()
        assert sim.watchdog.cross_check(
            ["7 interruption messages never consumed"]) == []


class TestExpositionIntegration:
    def test_debug_watchdog_route(self):
        from karpenter_tpu_torch.obs.exposition import render
        sim = PORT.make_sim()
        sim.watchdog.tick(force=True)
        status, ctype, body = render("/debug/watchdog")
        assert status == 200
        doc = json.loads(body)
        assert doc["armed"] and doc["verdict"] == "ok"
        assert doc["invariants"] == list(PORT.INVARIANTS)
        # the sim dying flips the route inactive (weakref contract)
        del sim
        gc.collect()
        _, _, body = render("/debug/watchdog")
        assert json.loads(body).get("inactive") is True

    def test_readyz_reflects_verdict(self):
        from karpenter_tpu_torch.obs import exposition
        from karpenter_tpu_torch.obs.exposition import render
        saved = dict(exposition.READINESS_PROBES)
        exposition.READINESS_PROBES.clear()
        try:
            sim = PORT.make_sim()
            wd = sim.watchdog
            status, _, body = render("/readyz")
            assert status == 200 and json.loads(body)["ready"] is True
            wd.claim_grace = 10.0
            sim.store.add_nodeclaim(PORT.NodeClaim(name="leak-3",
                                                   nodepool="default"))
            _age(sim, 30)
            assert wd.verdict() == "critical"
            status, _, body = render("/readyz")
            doc = json.loads(body)
            assert status == 503 and doc["ready"] is False
            assert any(p["verdict"] == "critical"
                       for p in doc["probes"].values())
            # the condition clearing restores readiness
            sim.store.delete_nodeclaim("leak-3")
            wd.tick(force=True)
            status, _, _ = render("/readyz")
            assert status == 200
            # stacks that died leave no probe behind: registering the
            # next one drops theirs
            del sim, wd
            gc.collect()
            PORT.make_sim()
            assert len(exposition.READINESS_PROBES) == 1
        finally:
            exposition.READINESS_PROBES.clear()
            exposition.READINESS_PROBES.update(saved)

    def test_finding_lands_in_flight_recorder(self):
        # a ring of its own: the process ring may already be full of
        # earlier tests' markers, which a new one cannot displace
        saved = PORT.TRACER.recorder
        PORT.TRACER.recorder = PORT.FlightRecorder(16)
        try:
            sim = PORT.make_sim()
            wd = sim.watchdog
            wd.claim_grace = 10.0
            sim.store.add_nodeclaim(PORT.NodeClaim(name="leak-4",
                                                   nodepool="default"))
            _age(sim, 30)
            assert any(t.trace_id.startswith("watchdog-claim_leak")
                       for t in PORT.TRACER.recorder.slowest())
        finally:
            PORT.TRACER.recorder = saved


class TestOverhead:
    def test_rate_limited_tick_is_cheap(self):
        """Between evaluations a tick is one compare-and-return."""
        sim = PORT.make_sim()
        wd = sim.watchdog
        wd.tick(force=True)
        now = sim.clock.now()  # frozen: every call rate-limits out
        t0 = time.perf_counter()
        for _ in range(10_000):
            wd.tick(now)
        per_call = (time.perf_counter() - t0) / 10_000
        assert per_call < 50e-6, f"rate-limited tick {per_call * 1e6:.1f}us"

    def test_full_evaluation_bounded(self):
        sim = PORT.make_sim()
        for i in range(50):
            sim.store.add_nodeclaim(PORT.NodeClaim(name=f"w-{i}",
                                                   nodepool="default"))
        t0 = time.perf_counter()
        for _ in range(20):
            sim.clock.step(sim.watchdog.interval + 1)
            sim.watchdog.tick()
        per_eval = (time.perf_counter() - t0) / 20
        assert per_eval < 5e-3, f"evaluation {per_eval * 1e3:.2f}ms"


class TestReviewFixes:
    """Regression guards for the reference's review findings."""

    def test_verdict_survives_findings_log_trim(self):
        """A live critical excursion keeps the verdict critical after
        MAX_FINDINGS of newer churn evicted its log entry."""
        clock = PORT.FakeClock()
        wd = PORT.Watchdog(clock).arm()
        wd._fire([], "claim_leak", "critical", "pinned", "live leak",
                 clock.now())
        for i in range(wd.MAX_FINDINGS + 10):
            wd._fire([], "profile_unattributed", "info", f"churn-{i}",
                     "meter churn", clock.now())
        assert not any(f.key == "pinned" for f in wd.findings)  # evicted
        assert wd.verdict() == "critical"                       # not amnestied

    def test_marker_rejection_does_not_self_trip_overflow(self):
        """Findings whose marker traces the ring rejects never count
        toward the trace_ring_overflow meter."""
        clock = PORT.FakeClock()
        saved = PORT.TRACER.recorder
        try:
            PORT.TRACER.recorder = PORT.FlightRecorder(1)
            PORT.TRACER.recorder.offer(_slow(PORT))
            wd = PORT.Watchdog(clock).arm()
            for i in range(wd.RING_DROPS + 5):
                wd._fire([], "claim_leak", "critical", f"m-{i}", "x",
                         clock.now())
            clock.step(wd.interval + 1)
            wd.tick(force=True)
            assert not _findings(wd, "trace_ring_overflow")
        finally:
            PORT.TRACER.recorder = saved


# --- a watchdog never changes a run ---------------------------------------

def _hash_with(watchdog: bool, warmpath: bool) -> tuple:
    _reset_sequences()
    sim = PORT.make_sim(watchdog=watchdog, warmpath=warmpath)
    for wave in range(3):
        for i in range(6):
            sim.store.add_pod(PORT.Pod(
                name=f"wave{wave}-{i}", requests=PORT.Resources.parse(
                    {"cpu": "500m", "memory": "1Gi"})))
        sim.engine.run_for(60)
    for p in list(sim.store.pods.values())[:8]:
        sim.store.delete_pod(p.namespace, p.name)
    sim.engine.run_for(600, step=5)
    return PORT.mod("sim").state_hash(sim), dict(sim.disruption.stats)


@pytest.mark.parametrize("warmpath", [False, True], ids=["cold", "warm"])
def test_state_hash_equal_with_and_without_the_watchdog(warmpath):
    assert _hash_with(True, warmpath) == _hash_with(False, warmpath)
