"""The port's lease-based leader election (`karpenter_tpu_torch/utils/
leaderelection.py`, the engine's `elector` and the runtime's lease
handover) held against the JAX reference's.

Every class of the reference's `tests/test_leaderelection.py` reruns
through the port. Each case is written once over a namespace of either
package's objects, asserts what the reference's test asserts, and returns
its transition sequence (every tick's verdict, the lease records, the
callbacks fired); the sequences of the two packages must be equal. The
real-clock runtime case holds behaviour only (the lease released on stop),
as the reference's does.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import itertools
import threading
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
    le = mod("utils.leaderelection")
    return SimpleNamespace(
        pkg=pkg, mod=mod, dev=dev, Elector=le.Elector, Lease=le.Lease,
        InMemoryLeaseBackend=le.InMemoryLeaseBackend,
        FileLeaseBackend=le.FileLeaseBackend,
        HTTPLeaseBackend=le.HTTPLeaseBackend, remote=mod("cloud.remote"),
        FakeCloud=mod("cloud.fake").FakeCloud,
        small_catalog=mod("catalog.generator").small_catalog,
        FakeClock=mod("utils.clock").FakeClock,
        RealClock=mod("utils.clock").RealClock,
        Engine=mod("controllers.engine").Engine,
        Runtime=mod("controllers.runtime").Runtime,
        Pod=mod("models.pod").Pod, Resources=mod("models.resources").Resources,
        make_sim=lambda **kw: mod("sim").make_sim(**dev, **kw))


REF = _namespace("karpenter_tpu")
PORT = _namespace("karpenter_tpu_torch")


def _reset_sequences() -> None:
    for P in (REF, PORT):
        for path, name in (("ops.delta", "DELTA"),
                           ("ops.resident", "RESIDENT"),
                           ("obs.explain", "RECORDER")):
            getattr(P.mod(path), name).reset()
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


def _lease(lease):
    return None if lease is None else dataclasses.astuple(lease)


def mk(P, backend, ident, **kw):
    return P.Elector(backend=backend, identity=ident, lease_duration=15.0,
                     renew_deadline=10.0, retry_period=2.0, **kw)


# --- TestElector ---------------------------------------------------------

def first_candidate_acquires(P):
    b = P.InMemoryLeaseBackend()
    e = mk(P, b, "a")
    assert e.tick(0.0) is True
    assert b.get().holder == "a"
    assert b.get().transitions == 0
    return _lease(b.get())


def standby_waits_while_holder_renews(P):
    b = P.InMemoryLeaseBackend()
    a, s = mk(P, b, "a"), mk(P, b, "s")
    seq = [a.tick(0.0)]
    assert seq[0]
    t = 0.0
    while t < 60.0:
        t += 2.0
        seq.append((a.tick(t), s.tick(t)))
        assert seq[-1] == (True, False)
    assert b.get().holder == "a"
    return [seq, _lease(b.get())]


def standby_takes_over_after_expiry(P):
    b = P.InMemoryLeaseBackend()
    a, s = mk(P, b, "a"), mk(P, b, "s")
    assert a.tick(0.0)
    seq = [s.tick(1.0)]
    assert not seq[0]
    t = 1.0
    while t + 2.0 < 16.0:
        t += 2.0
        seq.append(s.tick(t))
        assert not seq[-1], t
    seq.append(s.tick(16.1))
    assert seq[-1]
    assert b.get().holder == "s"
    assert b.get().transitions == 1
    return [seq, _lease(b.get()), s._observed]


def expiry_judged_from_observation_not_record_time(P):
    b = P.InMemoryLeaseBackend()
    b.update(P.Lease(holder="a", acquire_time=-1000.0, renew_time=-1000.0,
                     lease_duration=15.0), None)
    s = mk(P, b, "s")
    seq = [s.tick(0.0), s.tick(14.0), s.tick(15.5)]
    assert seq == [False, False, True]
    return [seq, _lease(b.get())]


def holder_steps_down_on_partition(P):
    b = P.InMemoryLeaseBackend()
    a = mk(P, b, "a")
    stopped = []
    a.on_stopped_leading.append(lambda: stopped.append(True))
    seq = [a.tick(0.0)]
    b.fail_writes = True
    seq += [a.tick(2.0), a.tick(8.0), a.tick(10.5)]
    assert seq == [True, True, True, False]
    assert stopped == [True]
    b.fail_writes = False
    seq.append(a.tick(12.0))
    assert seq[-1]
    return [seq, stopped, _lease(b.get())]


def no_dual_leadership_through_partition(P):
    b = P.InMemoryLeaseBackend()
    a, s = mk(P, b, "a"), mk(P, b, "s")
    assert a.tick(0.0)
    assert not s.tick(0.5)
    b.fail_writes = True
    seq = []
    t = 0.5
    took_over = False
    while t < 30.0 and not took_over:
        t += 1.0
        la = a.tick(t)
        b.fail_writes = False
        ls = s.tick(t + 0.01)
        b.fail_writes = True
        assert not (la and ls), f"dual leadership at t={t}"
        seq.append((t, la, ls))
        took_over = ls
    assert took_over
    return [seq, _lease(b.get())]


def cas_race_single_winner(P):
    b = P.InMemoryLeaseBackend()
    cands = [mk(P, b, f"c{i}") for i in range(5)]
    wins = [c.tick(0.0) for c in cands]
    assert sum(wins) == 1
    return [wins, _lease(b.get())]


def release_hands_over_immediately(P):
    b = P.InMemoryLeaseBackend()
    a, s = mk(P, b, "a"), mk(P, b, "s")
    assert a.tick(0.0)
    assert not s.tick(1.0)
    a.release(2.0)
    released = _lease(b.get())
    assert not a.is_leader()
    assert s.tick(3.0)
    assert b.get().transitions == 1
    return [released, _lease(b.get())]


def callbacks_fire_once_per_transition(P):
    b = P.InMemoryLeaseBackend()
    started = []
    a = mk(P, b, "a", on_started_leading=[lambda: started.append(1)])
    seq = [a.tick(0.0), a.tick(2.0), a.tick(4.0)]
    assert started == [1]
    return [seq, started, _lease(b.get())]


ELECTOR_CASES = {f.__name__: f for f in (
    first_candidate_acquires, standby_waits_while_holder_renews,
    standby_takes_over_after_expiry,
    expiry_judged_from_observation_not_record_time,
    holder_steps_down_on_partition, no_dual_leadership_through_partition,
    cas_race_single_winner, release_hands_over_immediately,
    callbacks_fire_once_per_transition)}


class TestElector:
    @pytest.mark.parametrize("name", sorted(ELECTOR_CASES))
    def test_elector_equals_the_reference(self, name):
        _both(ELECTOR_CASES[name])


# --- TestFileBackend -----------------------------------------------------

def file_cas_semantics(P, tmp):
    path = tmp / P.pkg
    path.mkdir()
    b = P.FileLeaseBackend(str(path / "leader.lease"))
    assert b.get() is None
    out = [b.update(P.Lease("a", 0.0, 0.0, 15.0), None)]
    got = b.get()
    assert got.holder == "a" and got.version == 1
    out += [b.update(P.Lease("b", 1.0, 1.0, 15.0), None),
            b.update(P.Lease("b", 1.0, 1.0, 15.0), 99),
            b.update(P.Lease("b", 1.0, 1.0, 15.0, transitions=1), 1)]
    assert out == [True, False, False, True]
    assert b.get().holder == "b" and b.get().version == 2
    return [out, _lease(b.get()), (path / "leader.lease").read_text()]


def file_two_electors(P, tmp):
    path = str(tmp / f"{P.pkg}.lease")
    a = mk(P, P.FileLeaseBackend(path), "a")
    s = mk(P, P.FileLeaseBackend(path), "s")
    seq = [a.tick(0.0), s.tick(1.0)]
    a.release(2.0)
    seq.append(s.tick(3.0))
    assert seq == [True, False, True]
    return [seq, _lease(P.FileLeaseBackend(path).get())]


def file_corrupt_treated_as_absent(P, tmp):
    path = str(tmp / f"{P.pkg}.lease")
    with open(path, "w") as f:
        f.write("{not json")
    b = P.FileLeaseBackend(path)
    assert b.get() is None
    assert b.update(P.Lease("a", 0.0, 0.0, 15.0), None)
    return _lease(b.get())


FILE_CASES = {f.__name__: f for f in (
    file_cas_semantics, file_two_electors, file_corrupt_treated_as_absent)}


class TestFileBackend:
    @pytest.mark.parametrize("name", sorted(FILE_CASES))
    def test_file_backend_equals_the_reference(self, name, tmp_path):
        _both(FILE_CASES[name], tmp_path)


# --- TestEngineHA --------------------------------------------------------

class _FailingBackend:
    def __init__(self, inner):
        self.inner = inner

    def get(self):
        return self.inner.get()

    def update(self, lease, expected_version):
        return False


def engine_only_leader_provisions_and_failover_works(P):
    env = P.make_sim()
    backend = P.InMemoryLeaseBackend()
    el_a = mk(P, backend, "replica-a")
    el_b = mk(P, backend, "replica-b")
    env.engine.elector = el_a
    eng_b = P.Engine(clock=env.clock, elector=el_b)
    eng_b.add(*env.engine.controllers)
    for i in range(6):
        env.store.add_pod(P.Pod(name=f"p{i}", requests=P.Resources.parse(
            {"cpu": "1", "memory": "1Gi"})))

    def both_tick():
        env.engine.tick()
        eng_b.tick()

    for _ in range(40):
        both_tick()
        env.clock.step(0.5)
    assert el_a.is_leader() and not el_b.is_leader()
    bound = [p for p in env.store.pods.values() if p.node_name]
    assert len(bound) == 6
    n_claims = len(env.store.nodeclaims)
    backend.fail_writes = False
    el_a.backend = _FailingBackend(backend)
    for i in range(6, 12):
        env.store.add_pod(P.Pod(name=f"p{i}", requests=P.Resources.parse(
            {"cpu": "1", "memory": "1Gi"})))
    ok = eng_b_took_over = False
    steps = 0
    for _ in range(120):
        both_tick()
        env.clock.step(0.5)
        steps += 1
        eng_b_took_over = eng_b_took_over or el_b.is_leader()
        ok = all(p.node_name for p in env.store.pods.values())
        if ok and eng_b_took_over:
            break
    assert not el_a.is_leader()
    assert eng_b_took_over
    assert ok, [p.name for p in env.store.pods.values() if not p.node_name]
    return [n_claims, steps, sorted((p.name, p.node_name)
                                    for p in env.store.pods.values()),
            sorted(env.store.nodeclaims), _lease(backend.get())]


class TestEngineHA:
    def test_only_leader_provisions_and_failover_works(self):
        _both(engine_only_leader_provisions_and_failover_works)


# --- TestRuntimeRelease --------------------------------------------------

def runtime_shutdown_releases_lease(P):
    backend = P.InMemoryLeaseBackend()
    el = P.Elector(backend=backend, identity="a", retry_period=0.01)
    rt = P.Runtime(clock=P.RealClock(), elector=el)

    async def drive():
        task = asyncio.create_task(rt.start())
        for _ in range(200):
            await asyncio.sleep(0.01)
            if el.is_leader():
                break
        assert el.is_leader()
        rt.stop()
        await task

    asyncio.run(drive())
    assert not el.is_leader()
    assert backend.get().holder == ""
    return [el.is_leader(), backend.get().holder, rt.crash_counts]


class TestRuntimeRelease:
    def test_shutdown_releases_lease(self):
        _both(runtime_shutdown_releases_lease)


# --- TestHTTPLeaseBackend ------------------------------------------------

def _served(P):
    cloud = P.FakeCloud(P.small_catalog(), clock=P.FakeClock())
    return P.remote.serve_in_thread(cloud)


def http_two_replicas_one_leader(P):
    srv, port = _served(P)
    try:
        a = P.Elector(backend=P.HTTPLeaseBackend("127.0.0.1", port),
                      identity="replica-a")
        b = P.Elector(backend=P.HTTPLeaseBackend("127.0.0.1", port),
                      identity="replica-b")
        seq = [(a.tick(0.0), b.tick(0.0))]
        assert a.is_leader() and not b.is_leader()
        for now in (5.0, 10.0, 20.0, 30.0):
            seq.append((a.tick(now), b.tick(now)))
        assert a.is_leader() and not b.is_leader()
        return [seq, _lease(a.backend.get())]
    finally:
        srv.shutdown()


def http_release_hands_over(P):
    srv, port = _served(P)
    try:
        a = P.Elector(backend=P.HTTPLeaseBackend("127.0.0.1", port),
                      identity="replica-a")
        b = P.Elector(backend=P.HTTPLeaseBackend("127.0.0.1", port),
                      identity="replica-b")
        seq = [a.tick(0.0), b.tick(0.0)]
        a.release(1.0)
        seq.append(b.tick(2.0))
        assert not a.is_leader() and b.is_leader()
        return [seq, _lease(b.backend.get())]
    finally:
        srv.shutdown()


def http_endpoint_down_steps_leader_down(P):
    srv, port = _served(P)
    try:
        a = P.Elector(backend=P.HTTPLeaseBackend("127.0.0.1", port,
                                                 timeout=0.3),
                      identity="replica-a")
        a.tick(0.0)
        assert a.is_leader()
    finally:
        srv.shutdown()
    seq = [a.tick(5.0)]
    assert a.is_leader()
    seq.append(a.tick(11.0))
    assert not a.is_leader()
    return seq


def http_gateway_restart_keeps_holder(P, tmp):
    lease_file = str(tmp / f"{P.pkg}.lease")

    def serve():
        cloud = P.FakeCloud(P.small_catalog(), clock=P.FakeClock())
        srv = P.remote.make_server(
            cloud, lease_backend=P.FileLeaseBackend(lease_file))
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv, srv.server_address[1]

    srv, port = serve()
    a = P.Elector(backend=P.HTTPLeaseBackend("127.0.0.1", port),
                  identity="replica-a")
    a.tick(0.0)
    assert a.is_leader()
    srv.shutdown()
    srv2, port2 = serve()
    try:
        b = P.Elector(backend=P.HTTPLeaseBackend("127.0.0.1", port2),
                      identity="replica-b")
        seq = [b.tick(5.0)]
        assert not b.is_leader(), (
            "standby acquired through a restarted gateway — the lease "
            "record did not survive")
        seq.append(b.tick(30.0))
        assert b.is_leader()
        return [seq, _lease(b.backend.get())]
    finally:
        srv2.shutdown()


HTTP_CASES = {f.__name__: f for f in (
    http_two_replicas_one_leader, http_release_hands_over,
    http_endpoint_down_steps_leader_down)}


class TestHTTPLeaseBackend:
    @pytest.mark.parametrize("name", sorted(HTTP_CASES))
    def test_http_backend_equals_the_reference(self, name):
        _both(HTTP_CASES[name])

    def test_gateway_restart_keeps_holder(self, tmp_path):
        _both(http_gateway_restart_keeps_holder, tmp_path)
