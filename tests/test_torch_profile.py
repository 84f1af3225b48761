"""The port's phase-attribution profiler (`karpenter_tpu_torch/obs/profile.py`)
held against the JAX reference's: the PhaseLedger cases of the reference's
`tests/test_observatory.py` (and the batched pump's ledger case of
`tests/test_batch_parity.py`) run through both packages.

The ledger's taxonomy, its span-to-bucket map and its device/host split
are the reference's; the same traces attribute to the same buckets, bytes,
signature classes and virtual waits in both packages, exactly. Wall time
comes from real spans (sleeps and solves), so milliseconds and coverage
are held to the reference's bounds on each package, not to each other.
A traced facade solve inside a reconcile and a traced batched pump keep
the 0.99 coverage invariant in both packages.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import pytest

from karpenter_tpu import metrics as ref_metrics
from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.catalog.generator import small_catalog
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.nodepool import NodePool
from karpenter_tpu.models.pod import Pod
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.obs import exposition as ref_expo
from karpenter_tpu.obs import profile as ref_profile
from karpenter_tpu.obs import tracer as ref_tracer
from karpenter_tpu.ops.encode import encode_catalog

from karpenter_tpu_torch import metrics as port_metrics
from karpenter_tpu_torch.convert import port_object
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.obs import exposition as port_expo
from karpenter_tpu_torch.obs import profile as port_profile
from karpenter_tpu_torch.obs import tracer as port_tracer

REF = SimpleNamespace(name="ref", P=ref_profile, T=ref_tracer, M=ref_metrics,
                      E=ref_expo, pkg="karpenter_tpu", conv=lambda x: x,
                      kw={})
PORT = SimpleNamespace(name="port", P=port_profile, T=port_tracer,
                       M=port_metrics, E=port_expo, pkg="karpenter_tpu_torch",
                       conv=port_object, kw={"device": "cpu"})
POOL = NodePool(name="default")


def _mod(X, name):
    import importlib
    return importlib.import_module(f"{X.pkg}.{name}")


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    ref_pod._sig_intern.clear()
    for X in (REF, PORT):
        _mod(X, "ops.delta").DELTA.reset()
        _mod(X, "ops.resident").RESIDENT.reset()
        _mod(X, "integrity").INTEGRITY.reset()


@pytest.fixture(autouse=True)
def _fresh():
    """A fresh flight-recorder ring per package, an empty global ledger,
    and the global tracer restored after each test."""
    saved = [(X.T.TRACER, X.T.TRACER.recorder, X.T.TRACER.enabled,
              X.T.TRACER.clock) for X in (REF, PORT)]
    for X in (REF, PORT):
        X.T.TRACER.recorder = X.T.FlightRecorder(8)
        X.P.LEDGER.reset()
    yield
    for tracer, ring, enabled, clock in saved:
        tracer.recorder = ring
        tracer.enabled, tracer.clock = enabled, clock
    for X in (REF, PORT):
        X.P.LEDGER.reset()


def _ledger_tracer(X):
    tr = X.T.Tracer(enabled=True, ring_size=4)
    tr.trace_dir = ""
    led = X.P.PhaseLedger()
    tr.add_sink(led.ingest)
    return tr, led


def _both(case):
    want = case(REF)
    got = case(PORT)
    assert got == want
    return got


def _structure(snap):
    """A snapshot without wall time: buckets, sides, counts, bytes,
    signature classes and virtual waits."""
    return ({t: {k: {b: (r["side"], r["count"]) for b, r in d.items()}
                 for k, d in kinds.items()}
             for t, kinds in snap["phases"].items()},
            snap["bytes"],
            {t: {s: r["count"] for s, r in sigs.items()}
             for t, sigs in snap["signatures"].items()},
            snap["virtual_queue_wait_ms"], snap["taxonomy"],
            snap["traces"], snap["errors"])


# --- the taxonomy and its span map ------------------------------------------

CASES = [
    ("engine.hooks", {}, "hooks"),
    ("provision.batch", {}, "batch"),
    ("encode.lower", {"cache_hits": 0, "cache_misses": 2}, "encode_cold"),
    ("encode.lower", {"cache_hits": 3, "cache_misses": 0}, "encode_cached"),
    ("encode.affinity", {}, "affinity"),
    ("solve.spread", {}, "spread"),
    ("solve.prep", {"groups_padded": 8, "n_max": 64}, "prep"),
    ("solve.catalog_put", {"h2d_bytes": 256}, "catalog_put"),
    ("solve.device_put", {"h2d_bytes": 128}, "device_put"),
    ("solve.compile", {}, "compile"),
    ("solve.dispatch", {}, "dispatch"),
    ("solve.readback", {"d2h_bytes": 64}, "readback"),
    ("solve.decode", {}, "decode"),
    ("solve.run", {"backend": "host", "groups": 3}, "solve_host"),
    ("solve.device", {}, "solver_overhead"),
    ("provision.launch", {}, "launch"),
    ("provision.bind", {}, "bind"),
    ("warmpath.admit", {}, "warm_admit"),
    ("warmpath.commit", {}, "commit"),
    ("journal.fsync", {"records": 1}, "journal_fsync"),
    ("cloud.create_fleet", {}, "cloud_api"),
    ("fleet.submit", {}, "queue_wait"),
    ("solve.batch_pack", {"h2d_bytes": 512, "requests": 4}, "batch_pack"),
    ("fleet.pipeline_wait", {"batch": 4}, "pipeline_wait"),
    ("solve.resident_patch", {"h2d_bytes": 96, "rows": 3},
     "resident_patch"),
    ("optimizer.search", {"candidates": 8, "scored": 210},
     "optimizer_search"),
    ("optimizer.verify", {"ranked": 12}, "optimizer_verify"),
    ("integrity.verify", {"backend": "device", "outcome": "ok"},
     "integrity"),
    ("federation.wire", {"method": "solve_bucket"}, "wire"),
    ("reconcile:provisioner", {}, "reconcile_other"),
]


def test_taxonomy_equals_the_reference():
    """The buckets, the span map, the device side and the coverage
    target are the reference's, and every bucket has a case above."""
    assert port_profile.PHASES == ref_profile.PHASES
    assert port_profile._SPAN_PHASE == ref_profile._SPAN_PHASE
    assert port_profile.DEVICE_PHASES == ref_profile.DEVICE_PHASES
    assert port_profile.COVERAGE_TARGET == ref_profile.COVERAGE_TARGET == 0.99
    covered = {b for _, _, b in CASES}
    assert covered == set(port_profile.PHASES)


def _every_bucket(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("engine.tick"):
        for name, attrs, _bucket in CASES:
            with tr.span(name, **attrs):
                pass
    snap = led.snapshot()
    phases = snap["phases"]["default"]["reconcile"]
    for name, attrs, bucket in CASES:
        assert bucket in phases and phases[bucket]["ms"] > 0, (name, bucket)
    assert phases["device_put"]["side"] == "device"
    assert phases["encode_cold"]["side"] == "host"
    assert snap["bytes"]["default/device_put"] == 128
    assert snap["bytes"]["default/catalog_put"] == 256
    assert snap["bytes"]["default/readback"] == 64
    assert led.errors == 0
    return _structure(snap)


def _inherits(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("engine.tick"):
        with tr.span("provision.launch"):
            with tr.span("totally.unmapped.child"):
                time.sleep(0.002)
    phases = led.snapshot()["phases"]["default"]["reconcile"]
    assert phases["launch"]["ms"] >= 2.0
    return _structure(led.snapshot())


def _adhoc_root(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("my-adhoc-trace"):
        with tr.span("whatever"):
            pass
    assert led.traces == 0
    return [led.traces]


def _gap(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("engine.tick"):
        with tr.span("provision.batch"):
            pass
        time.sleep(0.02)
    assert led.coverage() < 0.99 and led.unattributed_ms() >= 15.0
    markers = [t for t in X.T.TRACER.recorder.slowest()
               if t.root.name == "profile.unattributed"]
    assert markers
    attrs = markers[0].root.attrs
    assert attrs["coverage"] < 0.99 and attrs["gap_ms"] >= 15.0
    assert attrs["source_trace"]
    return [len(markers), attrs["root"], attrs["kind"]]


def _spanned(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("engine.tick"):
        with tr.span("provision.batch"):
            time.sleep(0.01)
    assert led.coverage() >= 0.99
    assert not [t for t in X.T.TRACER.recorder.slowest()
                if t.root.name == "profile.unattributed"]
    return _structure(led.snapshot())


def _virtual_wait(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("fleet.dispatch", tenant="a", wait_ms=7.5):
        with tr.span("solve.run", backend="host"):
            pass
    snap = led.snapshot()
    assert snap["virtual_queue_wait_ms"]["a"] == 7.5
    return _structure(snap)


def _signature(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("solve.device"):
        with tr.span("solve.prep", groups_padded=8, n_max=128):
            pass
        with tr.span("solve.dispatch"):
            pass
    sigs = led.snapshot()["signatures"]["default"]
    assert "g8/n128" in sigs and sigs["g8/n128"]["count"] == 1
    return _structure(led.snapshot())


def _report(X):
    tr, led = _ledger_tracer(X)
    with tr.trace("engine.tick"):
        with tr.span("solve.device_put", h2d_bytes=64):
            pass
        with tr.span("solve.decode"):
            pass
    text = X.P.format_report(led.snapshot())
    assert "host total" in text and "device total" in text
    assert "device_put" in text and "coverage" in text
    assert X.P.format_report({}).startswith("profile report: no traces")
    return _structure(led.snapshot())


def _defensive(X):
    led = X.P.PhaseLedger()
    led.ingest(object())
    assert led.errors == 1
    return [led.errors]


def _route(X):
    import json
    tr = X.T.TRACER
    tr.configure(enabled=True)
    with tr.trace("engine.tick"):
        with tr.span("provision.batch"):
            pass
    tr.configure(enabled=False)
    status, ctype, body = X.E.render("/debug/profile")
    assert status == 200 and "json" in ctype
    doc = json.loads(body)
    assert doc["taxonomy"] == list(X.P.PHASES) and doc["traces"] == 1
    return [doc["taxonomy"], doc["traces"], sorted(doc["phases"])]


@pytest.mark.parametrize("case", [_every_bucket, _inherits, _adhoc_root,
                                  _gap, _spanned, _virtual_wait, _signature,
                                  _report, _defensive, _route],
                         ids=lambda c: c.__name__[1:])
def test_ledger_equals_the_reference(case):
    _both(case)


def test_metric_families_move():
    got = {}
    for X in (REF, PORT):
        tr, led = _ledger_tracer(X)
        m0 = X.M.PROFILE_PHASE_MS.value(phase="batch", kind="reconcile")
        with tr.trace("engine.tick"):
            with tr.span("provision.batch"):
                time.sleep(0.002)
        assert X.M.PROFILE_PHASE_MS.value(phase="batch",
                                          kind="reconcile") > m0
        got[X.name] = X.M.PROFILE_COVERAGE.value(kind="reconcile") > 0
    assert got["port"] == got["ref"]


# --- live paths ---------------------------------------------------------------


def test_live_sim_tick_attributes():
    """A traced busy tick of each package's engine lands in its global
    ledger with the same buckets and coverage of at least 0.8. Busy: 40
    pods (the reference's case has 4), so that a few milliseconds of the
    host preempting the test between two spans cannot stand for an
    un-spanned seam of a tick that short. The port's own spans (its
    output passes; the delta plane and the explain recorder) add exactly
    their two buckets, decode and solver_overhead."""
    got = {}
    for X in (REF, PORT):
        make_sim = _mod(X, "sim").make_sim
        kw = {"backend": "host", **X.kw}
        sim = make_sim(**kw)
        for i in range(40):
            sim.store.add_pod(X.conv(Pod(name=f"obs-{i}",
                                         requests=Resources.parse(
                                             {"cpu": "500m",
                                              "memory": "1Gi"}))))
        # collector pauses inside the traced tick would land as root
        # self-time (the gap the invariant meters), not as work
        import gc
        gc.collect()
        gc.disable()
        X.T.TRACER.configure(enabled=True, clock=sim.clock.now)
        try:
            sim.engine.tick()
        finally:
            X.T.TRACER.configure(enabled=False)
            gc.enable()
        led = X.P.LEDGER
        snap = led.snapshot()
        assert led.traces >= 1 and led.errors == 0
        phases = snap["phases"]["default"]["reconcile"]
        for expected in ("hooks", "batch", "encode_cold", "solve_host",
                         "launch"):
            assert expected in phases, sorted(phases)
        assert led.coverage() >= 0.8, snap["coverage"]
        got[X.name] = sorted(phases)
    assert got["port"] == sorted(set(got["ref"])
                                 | {"decode", "solver_overhead"})


def _tenant_pods(rng, tenant, n):
    return [Pod(name=f"{tenant}-{i}", requests=Resources.parse(
        {"cpu": rng.choice(["250m", "500m", "1"]),
         "memory": rng.choice(["512Mi", "1Gi"])}))
        for i in range(n)]


def test_traced_dispatch_attributes_to_ticket_tenant():
    """A direct client solve with tracing on roots at fleet.dispatch and
    lands on the ticket's tenant series, in both packages."""
    got = {}
    for X in (REF, PORT):
        svc_mod = _mod(X, "fleet.service")
        clock = _mod(X, "utils.clock").FakeClock
        provider = _mod(X, "catalog.provider").CatalogProvider
        types = X.conv(small_catalog())
        svc = svc_mod.SolverService(clock(), **X.kw)
        client = svc.register("tnt", provider(lambda: types))
        X.T.TRACER.enabled = True
        try:
            client.solve(X.conv([Pod(name="tp-0", requests=Resources.parse(
                {"cpu": "500m", "memory": "1Gi"}))]), X.conv(POOL))
        finally:
            X.T.TRACER.enabled = False
        phases = X.P.LEDGER.snapshot()["phases"]
        assert "tnt" in phases and "default" not in phases
        got[X.name] = sorted(phases)
    assert got["port"] == got["ref"]


def test_ledger_attributes_batching_overhead_with_full_coverage(
        monkeypatch):
    """The reference's test_batch_parity case: a traced batched pump lands
    batch_pack and pipeline_wait in the ledger, each co-batched tenant's
    decode lands on its own series, and coverage stays >= 0.99 — in both
    packages, with the same buckets per tenant but for the port's own
    spans: its batched node budget (prep) and its delta lookup, delta
    record and explain recorder (solver_overhead). Delta memos disarmed:
    the traced round repeats the warm round's content."""
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    got = {}
    for X in (REF, PORT):
        _mod(X, "ops.delta").DELTA.reset()
        svc_mod = _mod(X, "fleet.service")
        clock = _mod(X, "utils.clock").FakeClock
        provider = _mod(X, "catalog.provider").CatalogProvider
        types = X.conv(small_catalog())
        svc = svc_mod.SolverService(clock(), backend="device", batch=True,
                                    **X.kw)
        clients = [svc.register(f"t{i}", provider(lambda: types))
                   for i in range(3)]
        warm = [c.solve_async(X.conv(_tenant_pods(random.Random(i),
                                                  f"w{i}", 5)),
                              X.conv(POOL)) for i, c in enumerate(clients)]
        svc.pump()
        for t in warm:
            t.result()
        X.P.LEDGER.reset()
        X.T.TRACER.configure(enabled=True)
        try:
            tickets = [c.solve_async(X.conv(_tenant_pods(random.Random(i),
                                                         f"x{i}", 5)),
                                     X.conv(POOL))
                       for i, c in enumerate(clients)]
            svc.pump()
            for t in tickets:
                t.result()
        finally:
            X.T.TRACER.configure(enabled=False)
        snap = X.P.LEDGER.snapshot()
        buckets = {b for tenant in snap["phases"].values()
                   for kind in tenant.values() for b in kind}
        assert {"batch_pack", "pipeline_wait"} <= buckets, buckets
        assert X.P.LEDGER.coverage(kind="reconcile") >= 0.99
        for t in ("t0", "t1", "t2"):
            t_buckets = {b for kind in snap["phases"].get(t, {}).values()
                         for b in kind}
            assert "decode" in t_buckets, (t, sorted(t_buckets))
        got[X.name] = {t: sorted({b for kind in d.values() for b in kind}
                                 - {"compile", "dispatch"})
                       for t, d in snap["phases"].items()}
    own = {"t0", "t1", "t2"}
    assert got["port"] == {
        t: sorted(set(b) | {"prep", "solver_overhead"}) if t in own else b
        for t, b in got["ref"].items()}


def test_traced_facade_solve_keeps_the_coverage_invariant():
    """One traced device-rung facade solve inside a provisioner reconcile
    (the root it has in the operator): its buckets cover at least 0.99
    of the root's wall, with the reference's buckets. A warm-up solve of
    other pods first: the reference compiles on its first call."""
    got = {}
    for X in (REF, PORT):
        solver_cls = _mod(X, "ops.facade").Solver
        provider = _mod(X, "catalog.provider").CatalogProvider
        types = X.conv(small_catalog())
        f = solver_cls(provider(lambda: types), backend="device", **X.kw)
        f.solve(X.conv(_tenant_pods(random.Random(1), "fw", 40)),
                X.conv(POOL))
        X.P.LEDGER.reset()
        X.T.TRACER.configure(enabled=True)
        try:
            with X.T.TRACER.trace("reconcile:provisioner"):
                f.solve(X.conv(_tenant_pods(random.Random(3), "fs", 40)),
                        X.conv(POOL))
        finally:
            X.T.TRACER.configure(enabled=False)
        led = X.P.LEDGER
        assert led.traces == 1 and led.errors == 0
        assert led.coverage(kind="reconcile") >= 0.99
        phases = led.snapshot()["phases"]["default"]["reconcile"]
        assert {"encode_cached", "prep", "device_put", "readback", "decode",
                "integrity"} <= set(phases), sorted(phases)
        got[X.name] = sorted(set(phases) - {"compile", "dispatch"})
    assert got["port"] == got["ref"]


def test_debug_slo_route_is_served():
    """obs/slo registers /debug/slo on the exposition table, as the
    reference does; a dead engine's route answers inactive."""
    import gc
    import json
    from karpenter_tpu_torch.obs.slo import SloEngine
    from karpenter_tpu_torch.utils.clock import FakeClock
    eng = SloEngine(FakeClock())
    status, _, body = port_expo.render("/debug/slo")
    assert status == 200 and "inactive" not in json.loads(body)
    del eng
    gc.collect()
    status, _, body = port_expo.render("/debug/slo")
    assert json.loads(body) == {"inactive": True}
