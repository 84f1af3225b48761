"""The port's federation plane (`karpenter_tpu_torch/federation/`) held
against the JAX reference's.

The 38 cases of the reference's `tests/test_federation.py` (envelope
codec, catalog protocol, federated service, retry ladder, generation
protocol, cross-process determinism, wire versioning, HTTP transport) are
written once over a namespace of either package's objects and run through
both: the reference on JAX on the CPU, the port with `device="cpu"` (the
kernels' plain versions). Each asserts what the reference's case asserts
and returns what it observed — SolveOutputs, the three digests, server and
client stats, breaker state — and the harness adds every `FEDERATION_*`
counter's samples and the resident manager's stats; the two packages'
observations must be equal, exactly. Before each run both packages'
claim-name, pod-uid and instance-id sequences restart at the same value
and their process-global meters and planes are reset.

The reference's batch-mesh case runs through both packages: the
reference's server over its 8 virtual devices, the port's over 8 CPU
shards, each giving the in-process digests. On top: the frames both packages encode are byte-equal and each decodes the
other's; a port server answers a reference client, and a reference server
a port client, with the rows of the same package's server; a resident
stack crosses the wire unchanged and with one changed row (the repair of
`ops/solver.dispatch_packed`); the fed_* drills and `federation_smoke
--federate` at seeds 0 and 1 give the reference's digests.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
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

REPO = Path(__file__).resolve().parent.parent
FED_METERS = ("FEDERATION_RPCS", "FEDERATION_RETRIES", "FEDERATION_BREAKER",
              "FEDERATION_GENERATION", "FEDERATION_WIRE_BYTES",
              "FEDERATION_CATALOG", "FEDERATION_FALLBACKS")
# report stats measured on the host clock: never part of an equality
WALL_STATS = ("aggregate_solves_per_wall_sec", "pipeline_overlap_ratio")


def _namespace(pkg: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")
    port = pkg == "karpenter_tpu_torch"
    fed = mod("federation")
    return SimpleNamespace(
        pkg=pkg, mod=mod, port=port,
        dev={"device": "cpu"} if port else {},
        CatalogProvider=mod("catalog").CatalogProvider,
        small_catalog=mod("catalog.generator").small_catalog,
        NodePool=mod("models.nodepool").NodePool, Pod=mod("models.pod").Pod,
        Resources=mod("models.resources").Resources,
        FakeClock=mod("utils.clock").FakeClock,
        FleetRunner=mod("fleet").FleetRunner,
        SolverService=mod("fleet.service").SolverService,
        build_federated_service=fed.build_federated_service,
        FederatedSolverClient=fed.FederatedSolverClient,
        server_mod=mod("federation.server"),
        env=mod("federation.envelopes"), tr=mod("federation.transport"),
        client_mod=mod("federation.client"), remote=mod("cloud.remote"),
        injector=mod("faults.injector"), faults=mod("faults"),
        metrics=mod("metrics"), solver=mod("ops.solver"),
        INTEGRITY=mod("integrity").INTEGRITY)


REF = _namespace("karpenter_tpu")
PORT = _namespace("karpenter_tpu_torch")
V = REF.remote.WIRE_SCHEMA_VERSION
assert PORT.remote.WIRE_SCHEMA_VERSION == V


# --- per-run isolation -----------------------------------------------------

def _reset_planes() -> None:
    """Both packages' delta and resident planes, explain recorders,
    integrity meters and federation meters start each run empty (memo
    keys hold id(facade); ROADMAP §3's test-order hazards)."""
    for P in (REF, PORT):
        for path, name in (("ops.delta", "DELTA"),
                           ("ops.resident", "RESIDENT"),
                           ("obs.explain", "RECORDER")):
            getattr(P.mod(path), name).reset()
        P.INTEGRITY.reset()
        for name in FED_METERS:
            getattr(P.metrics, name)._values.clear()


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
    gets its sequences back and its intern table, planes and meters reset,
    and both packages' wire seams are disarmed and their degraded_mode
    gauges restored."""
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids)
    messages = REF.mod("cloud.messages")
    saved_messages = messages._counter[0]
    # the quarantine drill sets both packages' degraded_mode gauges
    degraded = [(P.metrics.DEGRADED_MODE, dict(P.metrics.DEGRADED_MODE._values))
                for P in (REF, PORT)]
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
        P.tr.set_wire_fault_hook(None)
        P.tr.set_wire_reply_hook(None)
        P.solver.set_corruption_hook(None)
    messages._counter[0] = saved_messages
    for gauge, values in degraded:
        gauge._values.clear()
        gauge._values.update(values)


def _plain(x):
    """A value with every dataclass, tuple and set of either package
    turned into plain dicts and lists (comparable across packages)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _out(out):
    """Everything a SolveOutput decides, stats excluded."""
    return _plain(([(l.instance_type, l.zone, l.capacity_type, l.price,
                     l.overrides, l.pod_keys, dict(l.requests),
                     dict(l.labels)) for l in out.launches],
                   {k: list(v) for k, v in out.existing_placements.items()},
                   list(out.unschedulable)))


def _report(rep) -> dict:
    return {"ok": rep.ok, "converged": rep.converged,
            "violations": list(rep.violations),
            "tenant_hashes": dict(rep.tenant_hashes),
            "tenant_fingerprints": dict(rep.tenant_fingerprints),
            "fleet": (rep.fleet_hash, rep.fleet_fingerprint,
                      rep.wire_fingerprint, rep.sim_seconds),
            "stats": {k: v for k, v in rep.stats.items()
                      if k not in WALL_STATS}}


def _svc(svc) -> dict:
    obs = {"fed_stats": dict(svc.fed_stats), "client": dict(svc.fed.stats),
           "breaker": svc._breaker, "cooldown": svc._fed_cooldown,
           "failures": svc._fed_failures, "last_error": svc._fed_last_error}
    server = getattr(svc.fed.transport, "server", None)
    if server is not None:
        obs["server"] = dict(server.stats)
    return obs


def _meters(P) -> dict:
    """Every FEDERATION_* sample, but the received wire bytes: a reply
    frame carries the server's measured span (a float whose decimal
    length varies from run to run)."""
    out = {name: dict(getattr(P.metrics, name)._values)
           for name in FED_METERS}
    out["FEDERATION_WIRE_BYTES"].pop(("received",), None)
    return out


def _resident(P) -> dict:
    snap = P.mod("ops.resident").RESIDENT.snapshot()
    return {"stats": snap["stats"],
            "fed": sorted((e["key"], e["rows"], e["stats"]["patches"],
                           e["stats"]["full"], e["stats"]["clean"])
                          for e in snap["entries"]
                          if e["key"].startswith("fed/"))}


def _both(case):
    out = {}
    for P in (REF, PORT):
        _reset_sequences()
        obs = case(P)
        out[P.pkg] = {"case": obs, "meters": _meters(P),
                      "resident": _resident(P)}
    return out


# --- helpers over a namespace ---------------------------------------------

def mk_pods(P, n, prefix="p", cpu="500m", mem="1Gi"):
    return [P.Pod(name=f"{prefix}-{i}",
                  requests=P.Resources.parse({"cpu": cpu, "memory": mem}))
            for i in range(n)]


def mk_server(P, **kw):
    return P.server_mod.SolverServer(**kw, **P.dev)


def mk_fed_service(P, process="p000", shared_server=None, run_id="fed-test",
                   **kw):
    kw.setdefault("backend", "device")
    kw.setdefault("batch", True)
    return P.build_federated_service(P.FakeClock(), run_id=run_id,
                                     process=process,
                                     shared_server=shared_server,
                                     **P.dev, **kw)


def mk_runner(P, name, **kw):
    return P.FleetRunner(name, **P.dev, **kw)


def factory(P, run_id, process="p000", shared_server=None):
    def build(clock, kw):
        return P.build_federated_service(clock, run_id=run_id,
                                         process=process,
                                         shared_server=shared_server, **kw)
    return build


def solve_wave(P, svc, client, prefix, n=4):
    t = client.solve_async(mk_pods(P, n, prefix), P.NodePool(name="default"))
    svc.pump()
    return t.result()


def roundtrip(P, env):
    wire = json.loads(json.dumps(P.env.encode_envelope(env), sort_keys=True))
    out = P.env.decode_envelope(wire)
    assert type(out) is type(env)
    return out


CASES = {}


def case(f):
    CASES[f.__name__] = f
    return f


# --- TestEnvelopeCodec ----------------------------------------------------

@case
def envelope_handshake(P):
    env = P.env.HandshakeEnvelope(schema=V, run_id="r", process="p000")
    assert roundtrip(P, env) == env
    return _plain(env)


@case
def envelope_catalog_upload(P):
    E = P.env
    rng = np.random.default_rng(0)
    env = E.CatalogUploadEnvelope(
        schema=V, run_id="r", process="p001",
        token=("shared", "abcd", "efgh"),
        alloc=E.pack_array(rng.random((3, 5)).astype(np.float32)),
        price=E.pack_array(rng.random((3, 4)).astype(np.float32)),
        avail=E.pack_array(np.ones((3, 4), np.bool_)),
        ovh_z=None, R=5)
    out = roundtrip(P, env)
    assert out == env
    assert isinstance(out.token, tuple)
    np.testing.assert_array_equal(E.unpack_array(out.alloc),
                                  E.unpack_array(env.alloc))
    return _plain(out)


@case
def envelope_solve_bucket_request(P):
    E = P.env
    g = np.arange(2 * 4 * 6, dtype=np.float32).reshape(2, 4, 6)
    env = E.SolveBucketRequest(
        schema=V, run_id="r", process="p000",
        token=("shared", "h", "f"), shape_class="g4n8", Gp=4, B=2,
        statics={"n_max": 8, "k_max": 4, "cols": (0, 1, 2),
                 "track_conflicts": True, "zone_ovh": False},
        gbuf=E.pack_array(g),
        conf=E.pack_array(np.zeros((2, 4, 4), np.bool_)),
        tenants=("t000", "t001"))
    out = roundtrip(P, env)
    assert out == env
    assert out.statics["cols"] == (0, 1, 2)  # tuple, not list
    np.testing.assert_array_equal(E.unpack_array(out.gbuf), g)
    return _plain(out)


@case
def envelope_solve_bucket_result(P):
    E = P.env
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    env = E.SolveBucketResult(schema=V, run_id="r",
                              rows=E.pack_array(rows), span_s=0.25, padded=3)
    out = roundtrip(P, env)
    assert out == env
    got = E.unpack_array(out.rows)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, rows)
    return _plain(out)


@case
def envelope_verdicts_and_findings(P):
    E = P.env
    envs = (
        E.AdmissionVerdictEnvelope(schema=V, run_id="r", process="p0",
                                   tenant="t0", action="admit",
                                   reason="under quota"),
        E.IntegrityVerdictEnvelope(schema=V, run_id="r", process="p0",
                                   tenant="t0", check="capacity", ok=False,
                                   detail="node n3 over"),
        E.WatchdogFindingEnvelope(schema=V, run_id="r", process="p0",
                                  invariant="federation_degraded",
                                  severity="warning", key="wire",
                                  message="cooldown armed"),
        E.ReportAck(schema=V, run_id="r", accepted=3))
    for env in envs:
        assert roundtrip(P, env) == env
    return [_plain(e) for e in envs]


@case
def envelope_unknown_rejected(P):
    with pytest.raises(ValueError) as a:
        P.env.decode_envelope({"__fed__": "NopeEnvelope", "f": {}})
    with pytest.raises(TypeError) as b:
        P.env.encode_envelope(object())
    return [str(a.value), str(b.value)]


@case
def envelope_tensor_bytes(P):
    p = P.env.pack_array(np.zeros((3, 5), np.float32))
    assert P.env.tensor_bytes(p) == 3 * 5 * 4
    assert P.env.tensor_bytes(None) == 0
    z = P.env.pack_array(np.zeros((64, 64), np.float32), compress=True)
    return [P.env.tensor_bytes(p), P.env.packed_wire_bytes(p),
            P.env.packed_wire_bytes(z), z.get("z")]


# --- TestCatalogProtocol --------------------------------------------------

def _upload(P, server, token, R, run_id="x"):
    E = P.env
    env = E.CatalogUploadEnvelope(
        schema=V, run_id=run_id, process="p0", token=token,
        alloc=E.pack_array(np.ones((3, R), np.float32)),
        price=E.pack_array(np.ones((3, 2), np.float32)),
        avail=E.pack_array(np.ones((3, 2), np.bool_)),
        ovh_z=None, R=R)
    return server.handle("put_catalog", E.encode_envelope(env))


@case
def catalog_upload_once_then_announce_hits(P):
    server = mk_server(P, run_id="x")
    tok = ("shared", "h", "f")
    outs = [_upload(P, server, tok, 5)]
    assert outs[0]["result"] == {"stored": True, "duplicate": False}
    # duplicate upload at the same width carries no new information
    outs.append(_upload(P, server, tok, 5))
    assert outs[1]["result"]["duplicate"] is True
    assert server.stats["catalog_uploads"] == 1
    outs.append(server.handle("has_catalog", {"schema": V,
                                              "token": list(tok), "R": 5}))
    assert outs[2]["result"]["present"] is True
    return [outs, dict(server.stats)]


@case
def catalog_width_rule_narrow_store_misses_wider_ask(P):
    server = mk_server(P, run_id="x")
    tok = ("shared", "h", "f")
    _upload(P, server, tok, 4)
    out = server.handle("has_catalog", {"schema": V, "token": list(tok),
                                        "R": 6})
    assert out["result"]["present"] is False
    out2 = _upload(P, server, tok, 6)
    assert out2["result"]["duplicate"] is False  # replaced, not kept
    out3 = server.handle("has_catalog", {"schema": V, "token": list(tok),
                                         "R": 6})
    assert out3["result"]["present"] is True
    return [out, out2, out3, dict(server.stats)]


@case
def catalog_lru_bound_evicts_oldest(P):
    server = mk_server(P, run_id="x", max_catalogs=2)
    for i in range(3):
        _upload(P, server, ("shared", f"h{i}", "f"), 4)
    assert len(server._catalogs) == 2
    out = server.handle("has_catalog", {
        "schema": V, "token": ["shared", "h0", "f"], "R": 4})
    assert out["result"]["present"] is False  # oldest evicted
    return [out, list(server._catalogs), dict(server.stats)]


@case
def catalog_report_mirrors_to_server_ledger(P):
    E = P.env
    server = mk_server(P, run_id="x")
    client = P.FederatedSolverClient(P.tr.InMemoryTransport(server),
                                     run_id="x", process="p0")
    items = [
        E.AdmissionVerdictEnvelope(schema=V, run_id="x", process="p0",
                                   tenant="t0", action="admit", reason=""),
        E.IntegrityVerdictEnvelope(schema=V, run_id="x", process="p0",
                                   tenant="t0", check="canary", ok=True,
                                   detail=""),
        E.WatchdogFindingEnvelope(schema=V, run_id="x", process="p0",
                                  invariant="claim_leak", severity="info",
                                  key="c1", message="m"),
    ]
    assert client.report(items) == 3
    assert client.report([]) == 0
    assert len(server.reports) == 3
    assert server.stats["reports"] == 3
    assert isinstance(server.reports[0], E.AdmissionVerdictEnvelope)
    return [[_plain(r) for r in server.reports], dict(server.stats),
            dict(client.stats)]


# --- TestFederatedService -------------------------------------------------

@case
def service_bucket_crosses_wire_and_solves(P):
    svc = mk_fed_service(P)
    types = P.small_catalog()
    pool = P.NodePool(name="default")
    clients = [svc.register(f"t{i}", P.CatalogProvider(lambda: types))
               for i in range(3)]
    tickets = [c.solve_async(mk_pods(P, 4, f"p{i}"), pool)
               for i, c in enumerate(clients)]
    svc.pump()
    for t in tickets:
        assert t.result().launches
    assert svc.fed_stats["wire_buckets"] >= 1
    assert svc.fed_stats["wire_tickets"] == 3
    assert svc.fed.stats["uploads"] == 1
    server = svc.fed.transport.server
    assert server.stats["buckets"] >= 1
    assert server.stats["catalog_uploads"] == 1
    assert server.stats["max_bucket_rows"] == 3
    return [[_out(t.result()) for t in tickets], _svc(svc)]


@case
def service_catalog_uploads_once_per_cluster_not_per_process(P):
    server = mk_server(P, run_id="fed-share")
    s1 = mk_fed_service(P, "p000", shared_server=server, run_id="fed-share")
    s2 = mk_fed_service(P, "p001", shared_server=server, run_id="fed-share")
    types = P.small_catalog()
    pool = P.NodePool(name="default")
    outs = []
    for svc, name in ((s1, "a"), (s2, "b")):
        c = svc.register(name, P.CatalogProvider(lambda: types))
        t = c.solve_async(mk_pods(P, 4, name), pool)
        svc.pump()
        assert t.result().launches
        outs.append(_out(t.result()))
    assert server.stats["catalog_uploads"] == 1
    assert s1.fed.stats["uploads"] == 1
    assert s2.fed.stats["uploads"] == 0
    assert s2.fed.stats["announce_hits"] >= 1
    assert s2.fed_stats["wire_buckets"] >= 1
    return [outs, _svc(s1), _svc(s2)]


@case
def service_unknown_token_reannounces_and_retries_once(P):
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        server = svc.fed.transport.server
        types = P.small_catalog()
        pool = P.NodePool(name="default")
        c = svc.register("a", P.CatalogProvider(lambda: types))
        t = c.solve_async(mk_pods(P, 4, "w0"), pool)
        svc.pump()
        assert t.result().launches
        server._catalogs.clear()  # simulate server restart
        t2 = c.solve_async(mk_pods(P, 4, "w1"), pool)
        svc.pump()
        assert t2.result().launches
    assert svc.fed.stats["retried_unknown_token"] == 1
    assert server.stats["unknown_token"] == 1
    assert svc.fed.stats["uploads"] == 2  # re-shipped after restart
    assert svc._fed_failures == 0 and svc._fed_cooldown == 0
    return [_out(t.result()), _out(t2.result()), _svc(svc)]


@case
def service_wire_failure_hostsolves_bucket_and_arms_cooldown(P):
    FB = P.metrics.FEDERATION_FALLBACKS
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        types = P.small_catalog()
        pool = P.NodePool(name="default")
        c = svc.register("a", P.CatalogProvider(lambda: types))
        err0 = FB.value(reason="error")
        cd0 = FB.value(reason="cooldown")
        with P.injector.wire_fault_hook(fail_methods=("solve_bucket",),
                                        after=0) as state:
            t = c.solve_async(mk_pods(P, 4, "w0"), pool)
            svc.pump()
            assert t.result().launches  # host-solved through its facade
        assert svc._fed_failures == 1
        assert svc._fed_cooldown > 0
        assert FB.value(reason="error") == err0 + 1
        # wire healthy again, but the cooldown gates: local device path
        t2 = c.solve_async(mk_pods(P, 4, "w1"), pool)
        svc.pump()
        assert t2.result().launches
    assert svc.fed_stats["local_buckets"] >= 1
    assert svc.fed_stats["cooldown_skips"] >= 1
    assert FB.value(reason="cooldown") == cd0 + 1
    return [_out(t.result()), _out(t2.result()), _svc(svc), dict(state),
            c.facade.stats.get("device_fallbacks")]


@case
def service_schema_skew_raises_not_degrades(P):
    svc = mk_fed_service(P)
    types = P.small_catalog()
    pool = P.NodePool(name="default")
    c = svc.register("a", P.CatalogProvider(lambda: types))
    orig = svc.fed.transport.call

    def skewed(method, payload):
        if method == "solve_bucket":
            raise P.remote.WireVersionError(V, V + 1)
        return orig(method, payload)

    svc.fed.transport.call = skewed
    c.solve_async(mk_pods(P, 4, "w0"), pool)
    with pytest.raises(P.remote.WireVersionError) as e:
        svc.pump()
    assert svc._fed_cooldown == 0  # ladder never armed
    return [str(e.value), _svc(svc)]


# --- TestRetryLadder ------------------------------------------------------

def _plan(P, svc, **rule):
    plan = P.faults.FaultPlan(seed=0, rules=[P.faults.WireFault(**rule)])
    plan.clock = svc.clock
    plan.origin = svc.clock.now()
    return plan


@case
def ladder_transient_latency_on_idempotent_rpc_retries(P):
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        types = P.small_catalog()
        c = svc.register("a", P.CatalogProvider(lambda: types))
        plan = _plan(P, svc, kind="latency", at=0.0, window=1e9, nth=1,
                     count=1, methods=("has_catalog",))
        with P.injector.wire_fault_plan_hook(plan):
            res = solve_wave(P, svc, c, "w0")
    assert res.launches
    assert svc.fed.stats["retries"] == 1
    assert svc._fed_failures == 0 and svc._fed_cooldown == 0
    assert svc.fed_stats["wire_buckets"] >= 1
    assert svc.fed.stats["uploads"] == 1
    # the injected stall rode the plan's canonical timeline
    assert any(d.startswith("latency:has_catalog")
               for _, k, d in plan.timeline)
    return [_out(res), _svc(svc), list(plan.timeline), plan.fingerprint()]


@case
def ladder_solve_bucket_never_blind_retries(P):
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        types = P.small_catalog()
        c = svc.register("a", P.CatalogProvider(lambda: types))
        plan = _plan(P, svc, kind="reset", at=0.0, window=1e9, nth=1,
                     count=1, methods=("solve_bucket",))
        with P.injector.wire_fault_plan_hook(plan):
            res = solve_wave(P, svc, c, "w0")
    assert res.launches                      # host-solved, still served
    assert svc.fed.stats["retries"] == 0     # no blind retry
    assert svc.fed.stats["solve_rpcs"] == 1  # exactly one attempt
    assert svc._fed_failures == 1
    assert svc._breaker == "open"
    return [_out(res), _svc(svc), list(plan.timeline), plan.fingerprint()]


@case
def ladder_breaker_probes_and_rejoins_after_cooldown(P):
    cooldown = P.client_mod.FED_COOLDOWN
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        types = P.small_catalog()
        c = svc.register("a", P.CatalogProvider(lambda: types))
        with P.injector.wire_fault_hook(fail_methods=("solve_bucket",),
                                        after=0):
            outs = [_out(solve_wave(P, svc, c, "w0"))]
        assert svc._breaker == "open"
        assert svc._degraded_since is not None
        timeline = [(svc._breaker, svc._fed_cooldown)]
        # drain the cooldown: each bucket decrements; the last one probes,
        # half-opens, and serves as the trial
        for i in range(cooldown):
            svc.clock.step(1.0)
            outs.append(_out(solve_wave(P, svc, c, f"r{i}")))
            timeline.append((svc._breaker, svc._fed_cooldown))
    assert svc._breaker == "closed"
    assert svc.fed_stats["rejoins"] == 1
    assert svc.fed_stats["probes_ok"] == 1
    assert svc.fed_stats["local_buckets"] == cooldown - 1
    assert svc.fed_stats["last_rejoin_ms"] > 0
    assert svc.fed.stats["probes"] == 1
    assert svc._degraded_since is None and svc._probe_ok_degraded == 0
    assert svc.fed_stats["wire_buckets"] >= 1
    return [outs, timeline, _svc(svc)]


@case
def ladder_failed_probe_rearms_cooldown(P):
    cooldown = P.client_mod.FED_COOLDOWN
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        types = P.small_catalog()
        c = svc.register("a", P.CatalogProvider(lambda: types))
        timeline = []
        with P.injector.wire_fault_hook(fail_methods=("solve_bucket",
                                                      "healthz"), after=0):
            assert solve_wave(P, svc, c, "w0").launches
            for i in range(cooldown):
                assert solve_wave(P, svc, c, f"r{i}").launches
                timeline.append((svc._breaker, svc._fed_cooldown))
    assert svc._breaker == "open"
    assert svc.fed_stats["probes_fail"] == 1
    assert svc.fed_stats["rejoins"] == 0
    assert svc._fed_cooldown == cooldown
    return [timeline, _svc(svc)]


# --- TestGenerationProtocol -----------------------------------------------

@case
def generation_restart_recovery_rehandshakes_and_reuploads_once(P):
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        server = svc.fed.transport.server
        types = P.small_catalog()
        c = svc.register("a", P.CatalogProvider(lambda: types))
        assert solve_wave(P, svc, c, "w0").launches
        assert svc.fed._server_gen == 1
        assert svc.fed.stats["uploads"] == 1
        server.restart()
        assert server.generation == 2
        assert solve_wave(P, svc, c, "w1").launches
        assert svc.fed._server_gen == 2
        assert svc.fed.stats["generation_changes"] == 1
        assert svc.fed.stats["rehandshakes"] == 1
        assert svc.fed.stats["uploads"] == 2       # re-announced ONCE
        assert svc.fed.stats["reupload_bytes"] > 0
        assert svc.fed.stats["stale_decoded"] == 0
        assert svc._fed_failures == 0 and svc._fed_cooldown == 0
        assert server.stats["restarts"] == 1
        # steady state after recovery: no further catalog traffic
        catalog_rpcs = svc.fed.stats["catalog_rpcs"]
        assert solve_wave(P, svc, c, "w2").launches
    assert svc.fed.stats["generation_changes"] == 1
    assert svc.fed.stats["catalog_rpcs"] == catalog_rpcs
    return _svc(svc)


@case
def generation_stale_rejected_never_decoded(P):
    svc = mk_fed_service(P)
    client = svc.fed
    client._server_gen = 99   # this client negotiated a newer boot
    with pytest.raises(P.tr.StaleGenerationError) as e:
        client._wire_call("healthz", {"schema": V})
    assert client.stats["stale_rejected"] == 1
    assert client.stats["stale_decoded"] == 0
    assert client.stats["retries"] == 0       # stale is terminal
    # a probe swallows it into a clean False
    assert client.probe() is False
    assert client.stats["stale_rejected"] == 2
    return [str(e.value), _svc(svc)]


@case
def generation_compress_renegotiation_across_restart(P):
    with _env("KARPENTER_TPU_DELTA", "0"):
        svc = mk_fed_service(P)
        server = svc.fed.transport.server
        types = P.small_catalog()
        c = svc.register("a", P.CatalogProvider(lambda: types))
        assert solve_wave(P, svc, c, "w0").launches
        assert svc.fed.compress is True
        server.restart(compress_capability=False)
        assert solve_wave(P, svc, c, "w1").launches
    assert svc.fed.compress is False          # renegotiated down
    assert svc.fed.stats["retried_generation"] >= 1
    assert svc.fed.stats["generation_changes"] == 1
    assert svc._fed_failures == 0
    assert svc.fed.stats["stale_decoded"] == 0
    assert server.stats["compress_rejected"] >= 1
    return _svc(svc)


# --- TestCrossProcessDeterminism ------------------------------------------

def _federated(P, seed, tenants=4):
    runner = mk_runner(P, "federation_smoke", tenants=tenants, seed=seed,
                       backend="device",
                       service_factory=factory(P, f"fed-{seed}"))
    return runner.run(), runner


@case
def determinism_federated_digests_match_in_process(P):
    fed, runner = _federated(P, seed=5)
    local = mk_runner(P, "federation_smoke", tenants=4, seed=5,
                      backend="device").run()
    assert fed.ok, fed.summary()
    assert local.ok, local.summary()
    assert fed.tenant_hashes == local.tenant_hashes
    assert fed.tenant_fingerprints == local.tenant_fingerprints
    assert fed.fleet_hash == local.fleet_hash
    assert fed.fleet_fingerprint == local.fleet_fingerprint
    assert fed.stats["federated_wire_buckets"] > 0
    assert fed.stats["federated_wire_failures"] == 0
    assert fed.stats["catalog_uploads"] <= fed.stats["catalog_views_minted"]
    return [_report(fed), _report(local), _svc(runner.service)]


@case
def determinism_mid_solve_server_crash_degrades_and_watchdog_pages_first(P):
    FB = P.metrics.FEDERATION_FALLBACKS
    runner = mk_runner(P, "fleet_smoke", tenants=6, seed=0,
                       backend="device", batch=True,
                       service_factory=factory(P, "fed-crash"))
    err0 = FB.value(reason="error")
    with P.injector.wire_fault_hook(fail_methods=("solve_bucket",), after=2):
        report = runner.run()
    assert report.converged, report.summary()
    assert report.ok, report.summary()
    svc = runner.service
    assert svc._fed_failures >= 1
    assert svc.fed_stats["wire_buckets"] == 2  # before the crash
    assert FB.value(reason="error") > err0
    assert (svc.fed_stats["local_buckets"]
            + svc.fed_stats["cooldown_skips"]) >= 1
    assert report.stats["federated_wire_failures"] >= 1
    found = [f for f in runner.watchdog.findings
             if f.invariant == "federation_degraded"]
    assert found, "federation_degraded never fired"
    assert found[0].severity == "warning"
    assert found[0].attrs["failures"] >= 1
    return [_report(report), _svc(svc), [f.to_dict() for f in found]]


@case
def determinism_server_restart_drill_digest_parity(P):
    runner = mk_runner(P, "fed_server_restart", seed=2)
    fed = runner.run()
    local = mk_runner(P, "fed_server_restart", seed=2, federate=False).run()
    assert fed.ok, fed.summary()
    assert local.ok, local.summary()
    assert fed.tenant_hashes == local.tenant_hashes
    assert fed.tenant_fingerprints == local.tenant_fingerprints
    assert fed.fleet_hash == local.fleet_hash
    assert fed.fleet_fingerprint == local.fleet_fingerprint
    assert fed.stats["federation_generation_changes"] == 1
    assert fed.stats["federation_reupload_bytes"] > 0
    assert fed.stats["federation_degraded"] == 0
    assert any("server_restart:gen2" in d
               for _, k, d in runner.wire_plan.timeline)
    assert runner.fed_server.stats["restarts"] == 1
    return [_report(fed), _report(local), _svc(runner.service),
            dict(runner.fed_server.stats)]


@case
def determinism_fed_flap_scenario_repeats_byte_identical(P):
    a = mk_runner(P, "fed_flap", seed=1).run()
    b = mk_runner(P, "fed_flap", seed=1).run()
    assert a.ok, a.summary()
    assert a.fleet_hash == b.fleet_hash
    assert a.fleet_fingerprint == b.fleet_fingerprint
    assert a.wire_fingerprint == b.wire_fingerprint
    assert a.stats["wire_faults_injected"] > 0  # weather actually fired
    assert a.stats["federation_rejoins"] >= 1
    assert a.stats["federation_retries"] == b.stats["federation_retries"]
    return [_report(a), _report(b)]


@case
def determinism_noisy_neighbor_federated_digests_match_in_process(P):
    fed = mk_runner(P, "fleet_noisy_neighbor", seed=0, backend="device",
                    batch=True,
                    service_factory=factory(P, "fed-noisy")).run()
    local = mk_runner(P, "fleet_noisy_neighbor", seed=0, backend="device",
                      batch=True).run()
    assert fed.ok, fed.summary()
    assert local.ok, local.summary()
    assert fed.fleet_hash == local.fleet_hash
    assert fed.fleet_fingerprint == local.fleet_fingerprint
    assert fed.stats["federated_wire_buckets"] > 0
    assert fed.stats["federated_wire_failures"] == 0
    return [_report(fed), _report(local)]


def _flip_row0(P, buf):
    """Silent f32 bit-rot in row 0 of a [B, Gp, W] stack, committed as a
    new array/tensor of the package's own kind."""
    arr = np.array(buf.cpu() if P.port else buf)
    words = arr.reshape(-1, arr.shape[-1])[0].view(np.uint32)
    words ^= np.uint32(1 << 30)
    if P.port:
        import torch
        return torch.from_numpy(arr).to(buf.device)
    import jax.numpy as jnp
    return jnp.asarray(arr)


@case
def determinism_corruption_across_the_boundary_detected_before_commit(P):
    fired = {"n": 0}

    def hook(target, buf, key=None):
        # the server's batched stack is the only 3-D gbuf ([B,Gp,W]);
        # fire exactly once so the blast radius is one bucket (the
        # resident manager's probe passes a key: never fired here)
        if target != "gbuf" or fired["n"] or len(buf.shape) != 3:
            return buf
        fired["n"] += 1
        return _flip_row0(P, buf)

    server = mk_server(P, run_id="fed-sdc", use_resident=False)
    runner = mk_runner(P, "federation_smoke", tenants=6, seed=1,
                       backend="device",
                       service_factory=factory(P, "fed-sdc",
                                               shared_server=server))
    det0 = P.INTEGRITY.detections()
    P.solver.set_corruption_hook(hook)
    try:
        report = runner.run()
    finally:
        P.solver.set_corruption_hook(None)
    assert fired["n"] == 1, "injection never reached the server"
    assert report.ok, report.summary()
    assert P.INTEGRITY.detections() > det0, (
        "corrupt placements crossed the wire undetected")
    recoveries = sum(
        s.sim.solver.facade.stats.get("integrity_recoveries", 0)
        for s in runner.shards)
    assert recoveries >= 1
    return [_report(report), recoveries, P.INTEGRITY.detections() - det0,
            dict(server.stats)]


# --- TestWireVersioning ---------------------------------------------------

@case
def versioning_server_rejects_skew_before_parsing_body(P):
    server = mk_server(P, run_id="x")
    out = server.handle("handshake", {"schema": V + 1, "not_even": "valid"})
    assert "error" in out
    err = P.remote.decode_error(out["error"])
    assert isinstance(err, P.remote.WireVersionError)
    return [out, str(err)]


@case
def versioning_client_handshake_checks_reply_schema(P):
    class SkewedTransport:
        def call(self, method, payload):
            return {"wire_schema": V + 1, "run_id": "x"}

    client = P.FederatedSolverClient(SkewedTransport(), run_id="x")
    with pytest.raises(P.remote.WireVersionError) as e:
        client.handshake()
    return [str(e.value), dict(client.stats)]


@case
def versioning_unknown_method_is_not_found(P):
    server = mk_server(P, run_id="x")
    transport = P.tr.InMemoryTransport(server)
    with pytest.raises(P.remote.NotFoundError) as e:
        transport.call("no_such_method", {"schema": V})
    return [str(e.value), transport.last_gen]


# --- TestHTTPTransport ----------------------------------------------------

@case
def http_handshake_and_solve_over_http(P):
    server = mk_server(P, run_id="fed-http")
    srv, port = P.server_mod.serve_in_thread(server)
    try:
        svc = mk_fed_service(P, server_addr=f"127.0.0.1:{port}",
                             run_id="fed-http")
        types = P.small_catalog()
        pool = P.NodePool(name="default")
        c = svc.register("a", P.CatalogProvider(lambda: types))
        t = c.solve_async(mk_pods(P, 4, "w0"), pool)
        svc.pump()
        assert t.result().launches
        assert svc.fed_stats["wire_buckets"] == 1
        assert server.stats["catalog_uploads"] == 1
        assert server.stats["handshakes"] >= 1
    finally:
        srv.shutdown()
        srv.server_close()
    return [_out(t.result()), _svc(svc), dict(server.stats)]


@case
def http_rejects_skewed_header_with_426(P):
    import http.client
    server = mk_server(P, run_id="x")
    srv, port = P.server_mod.serve_in_thread(server)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.request("POST", "/fed/handshake", body=b"{}",
                         headers={"Content-Type": "application/json",
                                  "X-Wire-Schema": str(V + 1)})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 426
            assert body["error"]["type"] == "WireVersionError"
        finally:
            conn.close()
        t = P.tr.HTTPTransport("127.0.0.1", port)
        with pytest.raises(P.remote.WireVersionError) as e:
            # a healthy header but a skewed BODY also rejects
            t.call("handshake", {"schema": V + 1})
    finally:
        srv.shutdown()
        srv.server_close()
    return [resp.status, body, str(e.value)]


@case
def http_handshake_refuses_versionless_server(P):
    import http.server
    import threading

    class Legacy(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = b'{"ok": true}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Legacy)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        t = P.tr.HTTPTransport("127.0.0.1", srv.server_address[1])
        with pytest.raises(P.remote.WireVersionError) as e:
            t.handshake()
    finally:
        srv.shutdown()
        srv.server_close()
    return str(e.value)


def _spawn(P, port, generation, run_id):
    """`python -m <package>.federation.server` on the CPU; returns the
    process and its READY port."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    args = [sys.executable, "-m", f"{P.pkg}.federation.server",
            "--port", str(port), "--run-id", run_id,
            "--generation", str(generation)]
    if P.port:
        args += ["--device", "cpu"]
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env,
                            cwd=str(REPO))
    line = proc.stdout.readline().strip()
    assert line.startswith("READY "), line
    return proc, int(line.split()[1])


def _stop(proc):
    proc.terminate()
    proc.wait(timeout=30)
    proc.stdout.close()


@case
def http_subprocess_server_ready_protocol(P):
    proc, port = _spawn(P, 0, 1, "fed-sub")
    try:
        got = P.tr.HTTPTransport("127.0.0.1", port).handshake()
        assert got == V
    finally:
        _stop(proc)
    return got


@case
def http_subprocess_restart_recovers_through_generation(P):
    with _env("KARPENTER_TPU_DELTA", "0"):
        proc, port = _spawn(P, 0, 1, "fed-regen")
        try:
            svc = mk_fed_service(P, server_addr=f"127.0.0.1:{port}",
                                 run_id="fed-regen")
            types = P.small_catalog()
            pool = P.NodePool(name="default")
            c = svc.register("a", P.CatalogProvider(lambda: types))
            t = c.solve_async(mk_pods(P, 4, "w0"), pool)
            svc.pump()
            assert t.result().launches
            assert svc.fed._server_gen == 1
            _stop(proc)
            proc, _ = _spawn(P, port, 2, "fed-regen")
            t2 = c.solve_async(mk_pods(P, 4, "w1"), pool)
            svc.pump()
            assert t2.result().launches
            assert svc.fed._server_gen == 2
            assert svc.fed.stats["generation_changes"] == 1
            assert svc.fed.stats["rehandshakes"] == 1
            assert svc.fed.stats["uploads"] == 2
            assert svc.fed.stats["stale_decoded"] == 0
            assert svc._fed_failures == 0
        finally:
            _stop(proc)
    return [_out(t.result()), _out(t2.result()), _svc(svc)]


class _env:
    """Set one environment variable for a block (both packages read the
    knobs per call)."""

    def __init__(self, key, value):
        self.key, self.value = key, value

    def __enter__(self):
        self.prev = os.environ.get(self.key)
        os.environ[self.key] = self.value

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop(self.key, None)
        else:
            os.environ[self.key] = self.prev


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_the_reference(name):
    """The reference's case through both packages: each asserts what the
    reference asserts, and what the two observed (outputs, digests, stats,
    federation meters, resident stats) is equal."""
    out = _both(CASES[name])
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]


def test_mesh_sharded_server_raises_through_reject_mesh():
    """Once a raise-test of the batch mesh (the name is kept): the
    reference's test_mesh_sharded_server_keeps_digest_parity through both
    packages. Laying each bucket's request axis over a batch mesh of 8
    shards is an execution detail: the federated digests equal the
    in-process run's, and the reference's. The server reports its
    shards; `--mesh` without cards raises for lack of devices instead of
    serving on one."""
    from karpenter_tpu.parallel.mesh import make_batch_mesh as ref_mesh
    from karpenter_tpu_torch import parallel
    from karpenter_tpu_torch.federation.server import main
    with parallel.virtual_devices(8, "cpu"):
        port_mesh = parallel.make_batch_mesh()

    def case(P):
        mesh = ref_mesh() if not P.port else port_mesh

        def build(clock, kw):
            return P.build_federated_service(clock, run_id="fed-3",
                                             process="p000", mesh=mesh, **kw)
        runner = mk_runner(P, "federation_smoke", tenants=4, seed=3,
                           backend="device", service_factory=build)
        fed = runner.run()
        local = mk_runner(P, "federation_smoke", tenants=4, seed=3,
                          backend="device").run()
        assert fed.ok, fed.summary()
        assert local.ok, local.summary()
        assert fed.fleet_hash == local.fleet_hash
        assert fed.fleet_fingerprint == local.fleet_fingerprint
        assert fed.stats["federated_wire_buckets"] > 0
        server = runner.service.fed.transport.server
        assert server.stats["max_bucket_rows"] % 8 == 0
        hs = server.handle("handshake", {"schema": V})["result"]
        assert hs["mesh_devices"] == 8
        return [fed.fleet_hash, fed.fleet_fingerprint,
                dict(fed.tenant_hashes), dict(fed.tenant_fingerprints)]
    out = _both(case)
    assert out["karpenter_tpu_torch"]["case"] == out["karpenter_tpu"]["case"]
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="needs"):
            main(["--mesh", "--device", "cpu"])


# --- across the packages ----------------------------------------------------

def _envelopes(P, compress: bool):
    """One envelope of every class, built from the same seeded arrays."""
    E = P.env
    rng = np.random.default_rng(7)
    g = rng.random((3, 8, 12)).astype(np.float32)
    g[:, 4:] = 0.0   # padding rows: compressible
    conf = rng.random((3, 8, 8)) < 0.2
    pa = (lambda a: E.pack_array(a, compress=compress))
    return [
        E.HandshakeEnvelope(schema=V, run_id="r", process="p000"),
        E.CatalogUploadEnvelope(
            schema=V, run_id="r", process="p001",
            token=("shared", "abcd", "efgh", ("ds", 2)),
            alloc=pa(rng.random((40, 5)).astype(np.float32)),
            price=pa(rng.random((40, 3, 2)).astype(np.float32)),
            avail=pa(rng.random((40, 3, 2)) < 0.5),
            ovh_z=pa(np.zeros((40, 3, 5), np.float32)), R=5),
        E.SolveBucketRequest(
            schema=V, run_id="r", process="p000",
            token=("shared", "h", "f"), shape_class="g8/n16", Gp=8, B=3,
            statics={"n_max": 16, "k_max": 32, "cols": (0, 1, 3),
                     "track_conflicts": True, "zone_ovh": True},
            gbuf=pa(g), conf=pa(conf), tenants=("t000", "t001", "t002")),
        E.SolveBucketResult(schema=V, run_id="r",
                            rows=pa(np.arange(3 * 300, dtype=np.int32)
                                    .reshape(3, 300)),
                            span_s=0.125, padded=3),
        E.AdmissionVerdictEnvelope(schema=V, run_id="r", process="p0",
                                   tenant="t0", action="shed",
                                   reason="rate"),
        E.IntegrityVerdictEnvelope(schema=V, run_id="r", process="p0",
                                   tenant="t0", check="capacity", ok=False,
                                   detail="n3"),
        E.WatchdogFindingEnvelope(schema=V, run_id="r", process="p0",
                                  invariant="federation_rejoin",
                                  severity="warning", key="wire",
                                  message="m"),
        E.ReportAck(schema=V, run_id="r", accepted=2),
    ]


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
def test_frames_are_byte_equal_and_decode_across_packages(compress):
    """Both packages encode the same envelope to the same JSON bytes, and
    each decodes the other's frame back to the same fields: tensors bit
    for bit, tokens as tuples, statics with `cols` a tuple."""
    ref_envs = _envelopes(REF, compress)
    port_envs = _envelopes(PORT, compress)
    for r, p in zip(ref_envs, port_envs):
        rb = json.dumps(REF.env.encode_envelope(r), sort_keys=True)
        pb = json.dumps(PORT.env.encode_envelope(p), sort_keys=True)
        assert rb == pb, type(r).__name__
        from_ref = PORT.env.decode_envelope(json.loads(rb))
        from_port = REF.env.decode_envelope(json.loads(pb))
        assert type(from_ref).__name__ == type(r).__name__
        assert _plain(from_ref) == _plain(r)
        assert _plain(from_port) == _plain(p)
        token = getattr(from_ref, "token", None)
        if token is not None:
            assert isinstance(token, tuple)
            assert isinstance(token[3] if len(token) > 3 else (), tuple)
        if isinstance(from_ref, PORT.env.SolveBucketRequest):
            assert from_ref.statics["cols"] == (0, 1, 3)
            np.testing.assert_array_equal(
                PORT.env.unpack_array(from_ref.gbuf),
                REF.env.unpack_array(r.gbuf))
            assert ("z" in from_ref.gbuf) == compress


def _recording(server):
    """Keep every solve_bucket reply's rows (wall time dropped)."""
    rows = []
    real = server.handle

    def handle(method, payload):
        out = real(method, payload)
        if method == "solve_bucket" and "result" in out:
            f = out["result"]["f"]
            rows.append((f["rows"], f["padded"]))
        return out
    server.handle = handle
    return rows


def _served(C, server, tenants=4, seed=0):
    """Client package C's federation_smoke run, every bucket answered by
    `server` (either package's): the report and the rows it received."""
    rows = _recording(server)
    rep = mk_runner(C, "federation_smoke", tenants=tenants, seed=seed,
                    backend="device",
                    service_factory=factory(C, "fed-x",
                                            shared_server=server)).run()
    assert rep.ok, rep.summary()
    return _report(rep), rows, dict(server.stats)


def test_port_server_answers_a_reference_client():
    """The reference's fleet and client (JAX on the CPU) with its buckets
    answered by the port's SolverServer(device="cpu"): the same rows,
    digests and server stats as with the reference's own server."""
    _reset_sequences()
    want = _served(REF, REF.server_mod.SolverServer(run_id="fed-x"))
    _reset_sequences()
    got = _served(REF, mk_server(PORT, run_id="fed-x"))
    assert got[1] and got == want


def test_reference_server_answers_a_port_client():
    """The port's fleet and client with its buckets answered by the
    reference's SolverServer: the same rows, digests and server stats as
    with the port's own server."""
    _reset_sequences()
    want = _served(PORT, mk_server(PORT, run_id="fed-x"))
    _reset_sequences()
    got = _served(PORT, REF.server_mod.SolverServer(run_id="fed-x"))
    assert got[1] and got == want


def _frames():
    """A catalog upload and three solve_bucket frames for one client
    process, built with the reference's own packing from three tenants'
    encoded solves of small_catalog(): a stack, the same stack again, and
    the stack with request 1's group counts changed (one changed row of
    the resident [B, Gp, W] stack)."""
    from karpenter_tpu.ops import solver as rs
    from karpenter_tpu.ops.encode import (align_resources,
                                          align_zone_overhead, encode_pods)
    E = REF.env
    types = REF.small_catalog()
    cat = encode_catalog(types)
    cat.cache_token = ("shared", "fedtest", "f0")
    encs = [encode_pods(mk_pods(REF, 3 + i, f"t{i}"), cat) for i in range(3)]
    reqs = [rs.prepare_batchable(cat, e) for e in encs]
    first = reqs[0]
    assert all(r.signature == first.signature for r in reqs)
    st = first.statics
    R = int(encs[0].requests.shape[1])
    gstack = np.stack([rs._pack_groups(*rs._group_inputs(r.enc, first.Gp),
                                       list(st["cols"])) for r in reqs])
    zovh = align_zone_overhead(cat, R)
    put = E.CatalogUploadEnvelope(
        schema=V, run_id="r", process="p007", token=cat.cache_token,
        alloc=E.pack_array(align_resources(cat.allocatable, R)),
        price=E.pack_array(np.asarray(cat.price)),
        avail=E.pack_array(np.asarray(cat.available)),
        ovh_z=E.pack_array(zovh) if zovh is not None else None, R=R)
    changed = gstack.copy()
    changed[1, 0, len(st["cols"])] -= 1.0   # one pod fewer in a group
    assert changed[1, 0, len(st["cols"])] >= 1.0

    def solve(g):
        return E.encode_envelope(E.SolveBucketRequest(
            schema=V, run_id="r", process="p007", token=cat.cache_token,
            shape_class=first.shape_class, Gp=int(first.Gp), B=3,
            statics=dict(st), gbuf=E.pack_array(g), conf=None,
            tenants=("t000", "t001", "t002")))
    return (json.dumps(E.encode_envelope(put)),
            [json.dumps(solve(g)) for g in (gstack, gstack, changed)])


def test_resident_stack_through_the_server_equals_the_reference():
    """The same frames through each package's server: the resident
    manager sees a full upload, a clean hit and a one-row patch of the
    process's stack in both, with equal stats and patch bytes and the
    same rows. (The port's dispatch_packed once skipped the resident
    manager: every stack was a plain upload, and the stats differed.)"""
    put, solves = _frames()
    out = {}
    for P, server in ((REF, REF.server_mod.SolverServer(run_id="r")),
                      (PORT, mk_server(PORT, run_id="r"))):
        _reset_planes()
        patch = P.metrics.DEVICEMEM_PATCH
        outcomes = ("patched", "avoided", "full")
        before = {k: patch.value(outcome=k) for k in outcomes}
        assert "result" in server.handle("put_catalog", json.loads(put))
        replies = []
        for frame in solves:
            rep = server.handle("solve_bucket", json.loads(frame))
            assert "result" in rep, rep
            replies.append(rep["result"]["f"]["rows"])
        out[P.pkg] = (replies, _resident(P),
                      {k: patch.value(outcome=k) - before[k]
                       for k in outcomes})
    replies, res, patch = out["karpenter_tpu_torch"]
    assert res["stats"]["full_uploads"] >= 1
    assert res["stats"]["clean_hits"] >= 1 and res["stats"]["patches"] >= 1
    assert res["fed"] and res["fed"][0][0].startswith("fed/p007/")
    assert replies[0] == replies[1] != replies[2]
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["federation_smoke", "fed_flap",
                                  "fed_partition", "fed_server_restart"])
def test_federated_scenario_equals_the_reference(name, seed):
    """The wire-weather and crash-restart drills (and federation_smoke,
    federated as the CLI's --federate runs it) at seeds 0 and 1: the
    digests, the wire fingerprint, the verdicts, the stats and the wire
    timeline equal the reference's; where the reference holds a drill to
    its in-process arm (fed_server_restart), the federated digests equal
    the in-process arm's."""
    out = {}
    for P in (REF, PORT):
        _reset_sequences()
        kw = {}
        if name == "federation_smoke":
            kw["service_factory"] = factory(P, f"fed-{name}")
            kw["backend"] = "device"
        runner = mk_runner(P, name, seed=seed, **kw)
        rep = runner.run()
        assert rep.ok, rep.summary()
        obs = {"report": _report(rep), "svc": _svc(runner.service),
               "wire": (list(runner.wire_plan.timeline)
                        if runner.wire_plan is not None else None)}
        if name == "fed_server_restart":
            _reset_sequences()
            local = mk_runner(P, name, seed=seed, federate=False).run()
            assert (local.tenant_hashes, local.tenant_fingerprints,
                    local.fleet_hash) == (rep.tenant_hashes,
                                          rep.tenant_fingerprints,
                                          rep.fleet_hash)
        out[P.pkg] = (obs, _meters(P))
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]
