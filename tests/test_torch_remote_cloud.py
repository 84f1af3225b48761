"""The port's remote CloudProvider (`karpenter_tpu_torch/cloud/remote.py`)
and make_sim's polled path for a cloud without `on_node_created`, held
against the JAX reference's.

Every class of the reference's `tests/test_remote_cloud.py` reruns through
the port. Each case is written once over a namespace of either package's
objects and runs through both: `encode(obj)` must be byte-equal to the
reference's JSON for the same object, decoded objects and wire results
equal, and the error taxonomy must come back with the same classes and
payloads. The port's loops run with `device="cpu"`. The subprocess case
serves the port's cloud with `python -m karpenter_tpu_torch.cloud.remote`;
its wall-clock run holds behaviour (pods bind over HTTP), as the
reference's does.
"""

from __future__ import annotations

import importlib
import itertools
import json
import os
import random
import socket
import subprocess
import sys
import threading
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _namespace(pkg: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")
    dev = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    prov = mod("cloud.provider")
    return SimpleNamespace(
        pkg=pkg, mod=mod, dev=dev, remote=mod("cloud.remote"), prov=prov,
        FakeCloud=mod("cloud.fake").FakeCloud,
        FakeCloudConfig=mod("cloud.fake").FakeCloudConfig,
        small_catalog=mod("catalog.generator").small_catalog,
        FakeClock=mod("utils.clock").FakeClock,
        Pod=mod("models.pod").Pod, Taint=mod("models.pod").Taint,
        Node=mod("models.nodeclaim").Node,
        Resources=mod("models.resources").Resources,
        req=mod("models.requirements"), L=mod("models.labels"),
        Image=mod("cloud.image").Image, messages=mod("cloud.messages"),
        make_sim=lambda **kw: mod("sim").make_sim(**dev, **kw))


REF = _namespace("karpenter_tpu")
PORT = _namespace("karpenter_tpu_torch")


def _reset_sequences() -> None:
    """Claim names, pod uids, instance ids and interruption message ids
    restart at the same value in both packages; the planes start empty."""
    for P in (REF, PORT):
        for path, name in (("ops.delta", "DELTA"),
                           ("ops.resident", "RESIDENT"),
                           ("obs.explain", "RECORDER")):
            getattr(P.mod(path), name).reset()
        P.messages._counter[0] = 0
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
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids,
             REF.messages._counter[0])
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids,
     REF.messages._counter[0]) = saved
    ref_pod._sig_intern.clear()
    for P in (REF, PORT):
        for path, name in (("ops.delta", "DELTA"),
                           ("ops.resident", "RESIDENT"),
                           ("obs.explain", "RECORDER"),
                           ("integrity", "INTEGRITY")):
            getattr(P.mod(path), name).reset()


def _both(case, *args):
    out = {}
    for P in (REF, PORT):
        _reset_sequences()
        out[P.pkg] = case(P, *args)
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]
    return out["karpenter_tpu_torch"]


def _wire(P, obj) -> str:
    """The JSON an object crosses the wire as."""
    return json.dumps(P.remote.encode(obj), sort_keys=False)


def _fake(P, **cfg):
    return P.FakeCloud(P.small_catalog(), clock=P.FakeClock(),
                       config=P.FakeCloudConfig(**cfg) if cfg else None)


class _Served:
    def __init__(self, P, cloud=None):
        self.cloud = cloud if cloud is not None else _fake(P)
        self.srv, port = P.remote.serve_in_thread(self.cloud)
        self.rc = P.remote.RemoteCloud("127.0.0.1", port, timeout=5.0)

    def __enter__(self):
        return self.cloud, self.rc

    def __exit__(self, *exc):
        self.srv.shutdown()


# --- TestCodec -----------------------------------------------------------

def _roundtrip(P, obj):
    return P.remote.decode(json.loads(json.dumps(P.remote.encode(obj))))


def codec_sets_round_trip_as_sets(P):
    out = _roundtrip(P, {"zones": {"zone-b", "zone-a"}})
    assert out["zones"] == {"zone-a", "zone-b"}
    assert isinstance(out["zones"], set)
    out2 = _roundtrip(P, frozenset({"x"}))
    assert out2 == {"x"} and isinstance(out2, set)
    assert _roundtrip(P, (1, "a")) == (1, "a")
    assert isinstance(_roundtrip(P, (1, "a")), tuple)
    return [_wire(P, {"zones": {"zone-b", "zone-a"}}),
            _wire(P, frozenset({"x"})), _wire(P, (1, "a"))]


def _samples(P):
    prov = P.prov
    ov = prov.LaunchOverride("c5.large", "zone-a", "spot", 0.05,
                             reservation_id="r-1",
                             reservation_type="capacity-block")
    samples = [
        ov,
        prov.LaunchRequest(nodeclaim_name="nc-1", overrides=[ov],
                           image_id="img-1", user_data="#!/bin/sh",
                           tags={"k": "v"}, network_groups=["ng-1"],
                           profile="prof"),
        prov.Instance(id="i-1", instance_type="c5.large", zone="zone-a",
                      capacity_type="spot", image_id="img-1",
                      state="running", launch_time=1.5, tags={"a": "b"},
                      price=0.05, nodeclaim="nc-1", reservation_id=None,
                      network_groups=["ng-1"], profile="prof"),
        prov.NetworkGroup(id="ng-1", name="net", tags={"team": "a"}),
        prov.NodeProfile(name="prof", role="role-a", created_at=2.0,
                         tags={}),
        P.Node(name="n-1", provider_id="tpu:///zone-a/i-1",
               labels={"l": "v"}, annotations={"an": "v"},
               taints=[P.Taint(key="t", effect="NoSchedule", value="x")],
               capacity=P.Resources.parse({"cpu": "4"}),
               allocatable=P.Resources.parse({"cpu": "3"}),
               ready=True, conditions={"Ready": True},
               nodeclaim="nc-1", created_at=1.0, deletion_timestamp=None),
        P.Taint(key="t", effect="NoExecute", value=""),
    ]
    samples.extend(P.small_catalog()[:3])
    samples.append(P.Image(id="ami-1", name="std-1", family="standard",
                           arch="amd64", created_at=3.0, deprecated=False,
                           tags={"v": "1"}))
    return samples


def codec_every_wire_class_round_trips(P):
    samples = _samples(P)
    registered = set(P.remote._wire_classes())
    covered = {type(s).__name__ for s in samples}
    for s in samples:
        if type(s).__name__ == "InstanceType":
            covered.update(("Offering", "Overhead"))
    assert registered <= covered, registered - covered
    for s in samples:
        got = _roundtrip(P, s)
        assert got == s, f"{type(s).__name__} did not round-trip"
    return [sorted(registered), [_wire(P, s) for s in samples]]


def codec_random_requirements_roundtrip(P):
    L, R = P.L, P.req
    rng = random.Random(7)
    keys = [L.INSTANCE_TYPE, L.ZONE, L.CAPACITY_TYPE, L.ARCH,
            "custom.io/label"]
    ops = [R.Operator.IN, R.Operator.NOT_IN, R.Operator.EXISTS,
           R.Operator.DOES_NOT_EXIST, R.Operator.GT, R.Operator.LT]
    wires = []
    for _ in range(200):
        r = R.Requirements()
        for _ in range(rng.randrange(1, 5)):
            op = rng.choice(ops)
            key = rng.choice(keys)
            if op in (R.Operator.GT, R.Operator.LT):
                vals = (str(rng.randrange(0, 100)),)
            elif op in (R.Operator.EXISTS, R.Operator.DOES_NOT_EXIST):
                vals = ()
            else:
                vals = tuple(f"v{rng.randrange(6)}"
                             for _ in range(rng.randrange(1, 4)))
            r.add(R.Requirement(key, op, vals,
                                min_values=rng.choice([None, None, 2])))
        back = P.remote.decode(P.remote.encode(r))
        assert sorted(back.keys()) == sorted(r.keys())
        for k in r.keys():
            assert back.get(k) == r.get(k), k
            assert back.min_values(k) == r.min_values(k), k
        wires.append(_wire(P, r))
    return wires


def codec_random_instances_roundtrip(P):
    rng = random.Random(11)
    wires = []
    for i in range(100):
        inst = P.prov.Instance(
            id=f"i-{i}", instance_type=f"t{rng.randrange(9)}.large",
            zone=f"zone-{rng.choice('abc')}",
            capacity_type=rng.choice(["spot", "on-demand", "reserved"]),
            image_id=f"img-{i}", state=rng.choice(["pending", "running"]),
            launch_time=rng.random() * 1e6,
            tags={f"k{j}": f"v{j}" for j in range(rng.randrange(4))},
            price=rng.random(), nodeclaim=f"nc-{i}",
            reservation_id=rng.choice([None, f"res-{i}"]),
            network_groups=[f"ng-{j}" for j in range(rng.randrange(3))],
            profile=rng.choice(["", f"prof-{i}"]))
        assert P.remote.decode(P.remote.encode(inst)) == inst
        wires.append(_wire(P, inst))
    return wires


def codec_catalog_types_roundtrip_exactly(P):
    wires = []
    for t in P.small_catalog():
        back = P.remote.decode(P.remote.encode(t))
        assert back.name == t.name
        assert dict(back.capacity) == dict(t.capacity)
        assert back.offerings == t.offerings
        assert dict(back.overhead.__dict__) == dict(t.overhead.__dict__)
        for k in t.requirements.keys():
            assert back.requirements.get(k) == t.requirements.get(k)
        wires.append(_wire(P, t))
    return wires


CODEC_CASES = {f.__name__: f for f in (
    codec_sets_round_trip_as_sets, codec_every_wire_class_round_trips,
    codec_random_requirements_roundtrip, codec_random_instances_roundtrip,
    codec_catalog_types_roundtrip_exactly)}


class TestCodec:
    @pytest.mark.parametrize("name", sorted(CODEC_CASES))
    def test_codec_equals_the_reference(self, name):
        _both(CODEC_CASES[name])


# --- TestWire ------------------------------------------------------------

def wire_catalog_roundtrip(P):
    with _Served(P) as (cloud, rc):
        local = cloud.describe_types()
        wired = rc.describe_types()
        assert len(wired) == len(local)
        for a, b in zip(local, wired):
            assert a.name == b.name
            assert dict(a.capacity) == dict(b.capacity)
            assert len(a.offerings) == len(b.offerings)
            assert a.offerings[0].price == b.offerings[0].price
            for k in a.requirements.keys():
                assert b.requirements.has(k)
                assert a.requirements.get(k) == b.requirements.get(k)
        return [_wire(P, t) for t in wired]


def wire_launch_describe_terminate_roundtrip(P):
    with _Served(P) as (cloud, rc):
        t = cloud.describe_types()[0]
        o = t.offerings[0]
        req = P.prov.LaunchRequest(
            nodeclaim_name="nc-1",
            overrides=[P.prov.LaunchOverride(t.name, o.zone,
                                             o.capacity_type, o.price)],
            tags={"team": "a"})
        (inst,) = rc.create_fleet([req])
        assert isinstance(inst, P.prov.Instance)
        assert inst.instance_type == t.name and inst.tags == {"team": "a"}
        got = rc.describe([inst.id])
        assert len(got) == 1 and got[0].provider_id == inst.provider_id
        rc.terminate([inst.id])
        assert cloud.instances[inst.id].state == "terminated"
        return [_wire(P, inst), _wire(P, got)]


def wire_images_nodes_profiles_netgroups(P):
    with _Served(P) as (cloud, rc):
        assert [i.id for i in rc.describe_images()] == \
            [i.id for i in cloud.describe_images()]
        assert rc.describe_network_groups() == \
            cloud.describe_network_groups()
        p = rc.create_profile("prof-1", "role-a")
        assert p.role == "role-a"
        rc.update_profile_role("prof-1", "role-b")
        assert any(q.name == "prof-1" and q.role == "role-b"
                   for q in rc.describe_profiles())
        rc.delete_profile("prof-1")
        assert not any(q.name == "prof-1" for q in rc.describe_profiles())
        return [_wire(P, rc.describe_images()),
                _wire(P, rc.describe_network_groups()),
                _wire(P, rc.describe_profiles())]


def wire_interruption_queue_over_wire(P):
    with _Served(P) as (cloud, rc):
        t = cloud.describe_types()[0]
        o = t.offerings[0]
        (inst,) = rc.create_fleet([P.prov.LaunchRequest(
            nodeclaim_name="nc-q",
            overrides=[P.prov.LaunchOverride(t.name, o.zone,
                                             o.capacity_type, o.price)])])
        cloud.send_spot_interruption(inst.id)
        msgs = rc.poll_interruptions(10)
        assert len(msgs) == 1 and isinstance(msgs[0], str)
        assert P.messages.parse(msgs[0]).instance_ids == (inst.id,)
        rc.delete_message(msgs[0])
        assert not cloud.interruptions
        return [json.loads(msgs[0])]


WIRE_CASES = {f.__name__: f for f in (
    wire_catalog_roundtrip, wire_launch_describe_terminate_roundtrip,
    wire_images_nodes_profiles_netgroups,
    wire_interruption_queue_over_wire)}


class TestWire:
    @pytest.mark.parametrize("name", sorted(WIRE_CASES))
    def test_wire_equals_the_reference(self, name):
        _both(WIRE_CASES[name])


# --- TestErrorTaxonomy ---------------------------------------------------

class _ErrorCloud:
    """Raises a configured taxonomy error on every call."""

    def __init__(self, exc):
        self.exc = exc

    def describe(self, ids=None):
        raise self.exc

    def create_fleet(self, reqs):
        raise self.exc


ERRORS = {
    "not_found": lambda p: p.NotFoundError("gone"),
    "rate_limited": lambda p: p.RateLimitedError("slow down"),
    "server": lambda p: p.ServerError("boom"),
    "ice": lambda p: p.InsufficientCapacityError(
        [("m5.large", "zone-a", "spot")], "ICE"),
    "zone_exhausted": lambda p: p.ZoneExhaustedError(["zone-a", "zone-b"]),
    "capacity_type": lambda p: p.CapacityTypeUnfulfillableError(["spot"]),
    "reservation": lambda p: p.ReservationExceededError("res-1"),
}


def error_roundtrip_preserves_class_and_payload(P, which):
    exc = ERRORS[which](P.prov)
    srv, port = P.remote.serve_in_thread(_ErrorCloud(exc))
    try:
        rc = P.remote.RemoteCloud("127.0.0.1", port)
        with pytest.raises(type(exc)) as ei:
            rc.describe()
        got = ei.value
        assert got.retryable == exc.retryable
        payload = {}
        for attr in ("offerings", "zones", "capacity_types",
                     "reservation_id"):
            if hasattr(exc, attr):
                want = getattr(exc, attr)
                have = getattr(got, attr)
                if attr == "offerings":
                    want = [tuple(w) for w in want]
                assert have == want, attr
                payload[attr] = have
        return [type(got).__name__, str(got), got.retryable, payload,
                json.dumps(P.remote.encode_error(exc))]
    finally:
        srv.shutdown()


def error_connection_refused_is_retryable_server_error(P):
    rc = P.remote.RemoteCloud("127.0.0.1", 1, timeout=0.5)
    with pytest.raises(P.prov.ServerError) as ei:
        rc.describe()
    assert ei.value.retryable
    assert not rc.healthz()
    return type(ei.value).__name__


def error_timeout_is_retryable_server_error(P):
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]
    t = threading.Thread(target=lambda: lst.accept(), daemon=True)
    t.start()
    rc = P.remote.RemoteCloud("127.0.0.1", port, timeout=0.3)
    with pytest.raises(P.prov.ServerError) as ei:
        rc.describe()
    assert ei.value.retryable
    lst.close()
    return type(ei.value).__name__


def error_per_item_fleet_errors(P):
    prov = P.prov

    class Mixed:
        def create_fleet(self, reqs):
            return [prov.Instance(id="i-1", instance_type="t", zone="z",
                                  capacity_type="spot", image_id="img"),
                    prov.InsufficientCapacityError([("t", "z", "spot")])]

    srv, port = P.remote.serve_in_thread(Mixed())
    try:
        rc = P.remote.RemoteCloud("127.0.0.1", port)
        a, b = rc.create_fleet([])
        assert isinstance(a, prov.Instance) and a.id == "i-1"
        assert isinstance(b, prov.InsufficientCapacityError)
        assert b.offerings == [("t", "z", "spot")]
        return [_wire(P, a), type(b).__name__, b.offerings]
    finally:
        srv.shutdown()


def error_throttled_fake_maps_to_rate_limited(P):
    cloud = _fake(P, describe_rate=0.0001, describe_burst=1)
    srv, port = P.remote.serve_in_thread(cloud)
    try:
        rc = P.remote.RemoteCloud("127.0.0.1", port)
        rc.describe()
        with pytest.raises(P.prov.RateLimitedError) as ei:
            rc.describe()
        return [type(ei.value).__name__, ei.value.retryable]
    finally:
        srv.shutdown()


TAXONOMY_CASES = {f.__name__: f for f in (
    error_connection_refused_is_retryable_server_error,
    error_timeout_is_retryable_server_error, error_per_item_fleet_errors,
    error_throttled_fake_maps_to_rate_limited)}


class TestErrorTaxonomy:
    @pytest.mark.parametrize("which", sorted(ERRORS))
    def test_roundtrip_preserves_class_and_payload(self, which):
        _both(error_roundtrip_preserves_class_and_payload, which)

    @pytest.mark.parametrize("name", sorted(TAXONOMY_CASES))
    def test_taxonomy_equals_the_reference(self, name):
        _both(TAXONOMY_CASES[name])


# --- TestSubprocessE2E ---------------------------------------------------

def subprocess_full_stack(P):
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{P.pkg}.cloud.remote",
         "--ready-delay", "0.05"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=REPO,
        text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("READY "), line
        port = int(line.split()[1])
        rc = P.remote.RemoteCloud("127.0.0.1", port, timeout=10.0)
        assert rc.healthz()
        sim = P.make_sim(cloud=rc, clock=P.FakeClock())
        for i in range(12):
            sim.store.add_pod(P.Pod(name=f"p{i}", requests=P.Resources.parse(
                {"cpu": "500m", "memory": "1Gi"})))
        deadline = time.monotonic() + 60

        def bound():
            return all(p.node_name for p in sim.store.pods.values())
        while time.monotonic() < deadline and not bound():
            sim.engine.run_for(5, step=1)
            time.sleep(0.05)
        assert bound(), "pods never bound over the remote cloud"
        assert sim.store.nodeclaims, "no claims launched over HTTP"
        insts = rc.describe()
        assert any(i.state == "running" for i in insts)
        return [bound(), len(sim.store.pods)]
    finally:
        proc.terminate()
        proc.wait(timeout=10)


class TestSubprocessE2E:
    def test_full_stack_over_subprocess_cloud(self):
        _both(subprocess_full_stack)


# --- TestRemoteSoak ------------------------------------------------------

def remote_soak_converges_over_throttled_http_cloud(P):
    cloud = _fake(P, describe_rate=30.0, describe_burst=30,
                  create_fleet_rate=5.0, create_fleet_burst=5)
    srv, port = P.remote.serve_in_thread(cloud)
    try:
        rc = P.remote.RemoteCloud("127.0.0.1", port, timeout=10.0,
                                  clock=cloud.clock)
        sim = P.make_sim(cloud=rc, clock=cloud.clock)
        for i in range(25):
            sim.store.add_pod(P.Pod(name=f"s{i}", requests=P.Resources.parse(
                {"cpu": "500m", "memory": "1Gi"})))
        ok = sim.engine.run_until(
            lambda: all(p.node_name for p in sim.store.pods.values()),
            timeout=1200)
        assert ok, "engine never converged over the throttled HTTP cloud"
        assert sim.store.nodeclaims
        return [cloud.clock.now(),
                sorted((p.name, p.node_name)
                       for p in sim.store.pods.values()),
                sorted(sim.store.nodeclaims), dict(cloud.api_calls)]
    finally:
        srv.shutdown()


class TestRemoteSoak:
    def test_engine_converges_over_throttled_http_cloud(self):
        _both(remote_soak_converges_over_throttled_http_cloud)
