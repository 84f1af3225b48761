"""The port's operator shell held against the JAX reference's: the
batching cloud (`cloud/batcher.py`), the metering middleware
(`cloud/metering.py`), options (`utils/options.py`), the asyncio runtime
(`controllers/runtime.py`), `main.py`'s `build_operator`, `run_soak` and
`run_fleet`, the debug monitor (`utils/debug.py`) and the duration
recorder (`metrics/durations.py`).

The reference's cases that import these modules rerun through the port:
`tests/test_infra.py`'s `TestBatchingCloud`, `TestOptions`, `TestRuntime`,
`TestOperator` and `TestDebugMonitor`; `tests/test_obs.py`'s runtime routes,
`/readyz` and `DurationRecorder`; `tests/test_restart.py::
test_runtime_runs_stop_hooks`; `tests/test_metrics.py`'s metering and
reconcile durations; and `tests/test_runtime_soak.py` (marked slow, as the
reference marks it). Each case is written once over a namespace of either
package's objects. Where the case runs on a stepped clock, its outputs
(wire-call counts and sequences, the batcher's stats, parsed options, the
debug trace, the recorded events) must be equal in both packages; `Options`
differ only in the port's `device` field. The real-clock runtime cases hold
behaviour, as the reference's own do: convergence, crash counts, one wire
call per window, the lease released on SIGTERM. The port's loops and
operators run with `device="cpu"` (the kernels' plain versions).
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import itertools
import json
import os
import random
import signal
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
    port = pkg == "karpenter_tpu_torch"
    dev = {"device": "cpu"} if port else {}
    Options = mod("utils.options").Options

    def options(argv=(), env=None):
        """Options.parse over argv and env; the port's operator runs on the
        host (`device="cpu"`)."""
        opts = Options.parse(list(argv), env={} if env is None else env)
        if port:
            opts.device = "cpu"
        return opts
    return SimpleNamespace(
        pkg=pkg, port=port, mod=mod, dev=dev, Options=Options,
        options=options, BatchingCloud=mod("cloud.batcher").BatchingCloud,
        MeteredCloud=mod("cloud.metering").MeteredCloud,
        prov=mod("cloud.provider"), FakeCloud=mod("cloud.fake").FakeCloud,
        FakeCloudConfig=mod("cloud.fake").FakeCloudConfig,
        small_catalog=mod("catalog").small_catalog,
        FakeClock=mod("utils.clock").FakeClock,
        RealClock=mod("utils.clock").RealClock,
        Runtime=mod("controllers.runtime").Runtime, main=mod("main"),
        le=mod("utils.leaderelection"), M=mod("metrics"),
        Pod=mod("models.pod").Pod, Resources=mod("models.resources").Resources,
        L=mod("models.labels"), Phase=mod("models.nodeclaim").Phase,
        DebugMonitor=mod("utils.debug").DebugMonitor,
        DurationRecorder=mod("metrics.durations").DurationRecorder,
        exposition=mod("obs.exposition"), TRACER=mod("obs.tracer").TRACER,
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


def _mk_cloud(P, clock=None):
    clock = clock or P.FakeClock()
    return P.FakeCloud(P.small_catalog(), clock=clock), clock


def _seed_instances(P, cloud, n):
    for i in range(n):
        cloud.instances[f"i-{i}"] = P.prov.Instance(
            id=f"i-{i}", instance_type="m5.large", zone="zone-a",
            capacity_type="on-demand", image_id="img", state="running")


def _record_terminate(cloud, clock):
    """Wrap the fake's terminate so each wire call is recorded with its
    sim time and ids (the call still reaches the fake)."""
    calls = []
    real = cloud.terminate

    def terminate(ids):
        calls.append((clock.now(), list(ids)))
        return real(ids)
    cloud.terminate = terminate
    return calls


# --- TestBatchingCloud ---------------------------------------------------

def batch_terminations_coalesce_across_controllers(P):
    cloud, clock = _mk_cloud(P)
    b = P.BatchingCloud(cloud, clock, idle=0.1, max_window=1.0)
    _seed_instances(P, cloud, 9)
    calls = _record_terminate(cloud, clock)
    before = cloud.api_calls["terminate"]
    b.terminate(["i-0", "i-1", "i-2"])
    b.terminate(["i-3", "i-4"])
    b.terminate(["i-5"])
    assert cloud.api_calls["terminate"] == before
    clock.step(0.2)
    b.flush()
    assert cloud.api_calls["terminate"] == before + 1
    assert all(cloud.instances[f"i-{k}"].state == "terminated"
               for k in range(6))
    assert b.stats["largest_batch"] == 6
    return [calls, dict(b.stats), dict(cloud.api_calls)]


def batch_max_window_bounds_latency(P):
    cloud, clock = _mk_cloud(P)
    calls = _record_terminate(cloud, clock)
    b = P.BatchingCloud(cloud, clock, idle=10.0, max_window=1.0)
    b.terminate(["i-x"])
    clock.step(0.5)
    b.terminate(["i-y"])
    clock.step(0.6)
    b.flush()
    assert b.stats["terminate_batches"] == 1
    return [calls, dict(b.stats)]


def batch_max_items_fires_immediately(P):
    cloud, clock = _mk_cloud(P)
    b = P.BatchingCloud(cloud, clock, idle=10.0, max_window=30.0,
                        max_items=5)
    calls = _record_terminate(cloud, clock)
    before = cloud.api_calls["terminate"]
    b.terminate([f"i-{k}" for k in range(5)])
    assert cloud.api_calls["terminate"] == before + 1
    return [calls, dict(b.stats)]


def batch_describe_coalesces_reads_within_window(P):
    cloud, clock = _mk_cloud(P)
    b = P.BatchingCloud(cloud, clock, idle=0.1)
    before = cloud.api_calls["describe"]
    b.describe(); b.describe(); b.describe()
    assert cloud.api_calls["describe"] == before + 1
    assert b.stats["describe_coalesced"] == 2
    clock.step(0.2)
    b.describe()
    assert cloud.api_calls["describe"] == before + 2
    return [dict(b.stats), dict(cloud.api_calls)]


def batch_describe_sees_flushed_terminations(P):
    cloud, clock = _mk_cloud(P)
    cloud.instances["i-d"] = P.prov.Instance(
        id="i-d", instance_type="m5.large", zone="zone-a",
        capacity_type="on-demand", image_id="img", state="running")
    b = P.BatchingCloud(cloud, clock, idle=0.1)
    seen = [any(i.id == "i-d" for i in b.describe())]
    b.terminate(["i-d"])
    clock.step(0.2)
    b.flush()
    seen.append(any(i.id == "i-d" for i in b.describe()))
    assert seen == [True, False]
    return [seen, dict(b.stats), dict(cloud.api_calls)]


def batch_retryable_flush_error_keeps_batch_pending(P):
    clock = P.FakeClock()
    cloud = P.FakeCloud(P.small_catalog(), clock=clock,
                        config=P.FakeCloudConfig(terminate_rate=0.5,
                                                 terminate_burst=1))
    b = P.BatchingCloud(cloud, clock, idle=0.1, rng=random.Random(3))
    cloud.terminate([])
    b.terminate(["i-r"])
    clock.step(0.2)
    b.flush()
    assert b.stats["terminate_errors"] == 1
    pending = list(b._pending)
    clock.step(5.0)
    b.flush()
    assert b.stats["terminate_batches"] == 1
    return [pending, dict(b.stats), dict(cloud.api_calls)]


def batch_nonretryable_batch_error_falls_back_per_id(P):
    cloud, clock = _mk_cloud(P)
    _seed_instances(P, cloud, 3)
    real_terminate = cloud.terminate
    calls = []

    def poisoned(ids):
        calls.append(list(ids))
        if len(ids) > 1 or ids == ["i-poison"]:
            raise P.prov.NotFoundError("i-poison not found")
        real_terminate(ids)
    cloud.terminate = poisoned
    b = P.BatchingCloud(cloud, clock, idle=0.1)
    b.terminate(["i-0", "i-poison", "i-1", "i-2"])
    clock.step(0.2)
    b.flush()
    assert all(cloud.instances[f"i-{k}"].state == "terminated"
               for k in range(3))
    assert not b._pending
    return [calls, dict(b.stats)]


def batch_throttled_flush_backs_off_exponentially(P):
    cloud, clock = _mk_cloud(P)
    calls = []

    def throttled(ids):
        calls.append((clock.now(), list(ids)))
        raise P.prov.RateLimitedError("throttle")
    cloud.terminate = throttled
    b = P.BatchingCloud(cloud, clock, idle=0.1, max_items=2,
                        rng=random.Random(0))
    b.terminate(["a", "b"])
    assert len(calls) == 1
    b.terminate(["c", "d"])
    assert len(calls) == 1
    gates = []
    for _ in range(50):
        clock.step(0.05)
        b.flush()
        gates.append((b._retry_after, b._backoff))
    assert len(calls) <= 6
    return [calls, gates, dict(b.stats)]


def batch_per_id_retryable_remainder_keeps_backoff(P):
    cloud, clock = _mk_cloud(P)
    batch_calls = []

    def misbehaving(ids):
        batch_calls.append((clock.now(), list(ids)))
        if len(ids) > 1:
            raise P.prov.NotFoundError("bad batch")
        raise P.prov.RateLimitedError("throttle")
    cloud.terminate = misbehaving
    b = P.BatchingCloud(cloud, clock, idle=0.1, rng=random.Random(0))
    b.terminate(["a", "b", "c"])
    clock.step(0.2)
    b.flush()
    assert b._pending == ["a", "b", "c"]
    assert b._retry_after > clock.now()
    first_attempts = len(batch_calls)
    for _ in range(50):
        clock.step(0.05)
        b.flush()
    assert len(batch_calls) - first_attempts <= 12
    return [batch_calls, dict(b.stats)]


def batch_create_fleet_and_shutdown(P):
    """create_fleet passes through metered (and invalidates the read
    cache); shutdown ships a batch whose window never closed."""
    cloud, clock = _mk_cloud(P)
    b = P.BatchingCloud(cloud, clock, idle=10.0, max_window=30.0)
    t = cloud.describe_types()[0]
    o = t.offerings[0]
    insts = b.create_fleet([P.prov.LaunchRequest(
        nodeclaim_name="nc-1", overrides=[P.prov.LaunchOverride(
            t.name, o.zone, o.capacity_type, o.price)])])
    ids = [i.id for i in insts]
    calls = _record_terminate(cloud, clock)
    b.terminate(ids)
    b.shutdown()
    b.shutdown()  # idempotent
    assert cloud.instances[ids[0]].state == "terminated"
    return [ids, calls, dict(b.stats)]


BATCH_CASES = {f.__name__: f for f in (
    batch_terminations_coalesce_across_controllers,
    batch_max_window_bounds_latency, batch_max_items_fires_immediately,
    batch_describe_coalesces_reads_within_window,
    batch_describe_sees_flushed_terminations,
    batch_retryable_flush_error_keeps_batch_pending,
    batch_nonretryable_batch_error_falls_back_per_id,
    batch_throttled_flush_backs_off_exponentially,
    batch_per_id_retryable_remainder_keeps_backoff,
    batch_create_fleet_and_shutdown)}


def runtime_concurrent_reconcilers_one_wire_call(P):
    clock = P.RealClock()
    cloud = P.FakeCloud(P.small_catalog(), clock=clock)
    _seed_instances(P, cloud, 8)
    b = P.BatchingCloud(cloud, clock, idle=0.05, max_window=0.5)

    class Reaper:
        def __init__(self, name, ids):
            self.name, self.ids, self.fired = name, ids, False

        def reconcile(self, now):
            if not self.fired:
                self.fired = True
                b.terminate(self.ids)
            return 10.0

    reapers = [Reaper(f"r{k}", [f"i-{2*k}", f"i-{2*k+1}"]) for k in range(4)]
    before = cloud.api_calls["terminate"]

    async def run():
        rt = P.Runtime(clock=clock).add(*reapers, b.flusher())
        task = asyncio.create_task(rt.start())
        await asyncio.sleep(0.4)
        rt.stop()
        await task
        return rt.crash_counts
    crashes = asyncio.run(run())
    assert cloud.api_calls["terminate"] == before + 1
    assert b.stats["terminate_batches"] == 1
    assert b.stats["terminate_items"] == 8
    assert all(i.state == "terminated" for i in cloud.instances.values())
    return [crashes, dict(b.stats)]


def operator_wires_batching_cloud(P):
    cloud = P.FakeCloud(P.small_catalog())
    opts = P.options()
    opts.metrics_port = 0
    opts.solver_backend = "host"
    runtime, store, raw = P.main.build_operator(opts, cloud=cloud)
    wrapped = {getattr(c, "cloud", None) for c in runtime.controllers}
    bclouds = {c for c in wrapped if isinstance(c, P.BatchingCloud)}
    assert len(bclouds) == 1
    metered = next(iter(bclouds)).inner
    assert isinstance(metered, P.MeteredCloud)
    assert metered._inner is cloud
    assert any(c.name == "cloud.batcher.flush" for c in runtime.controllers)
    assert raw is cloud and runtime.elector is None
    return [[getattr(c, "name", type(c).__name__)
             for c in runtime.controllers], len(runtime.on_stop),
            sorted(store.nodepools), sorted(store.nodeclasses)]


class TestBatchingCloud:
    @pytest.mark.parametrize("name", sorted(BATCH_CASES))
    def test_batcher_equals_the_reference(self, name):
        _both(BATCH_CASES[name])

    def test_runtime_concurrent_reconcilers_one_wire_call(self):
        _both(runtime_concurrent_reconcilers_one_wire_call)

    def test_build_operator_wires_batching_cloud(self):
        _both(operator_wires_batching_cloud)


# --- TestOptions ---------------------------------------------------------

OPTION_INPUTS = {
    "defaults": ([], {}),
    "flag_overrides_env": (["--cluster-name", "flagged"],
                           {"CLUSTER_NAME": "from-env"}),
    "env_overrides_default": ([], {"SOLVER_BACKEND": "host",
                                   "BATCH_IDLE_SECONDS": "2.5",
                                   "ISOLATED": "true"}),
    "feature_gates": (["--feature-gates",
                       "NodeOverlay=true,NodeRepair=false"], {}),
    "soak_and_fleet": (["--soak", "--fleet-tenants", "3", "--fleet-batch",
                        "--leader-elect", "false"],
                       {"FEATURE_GATES": "WarmPathAdmission=true",
                        "METRICS_PORT": "0"}),
}


def _options_checks(name, o, port):
    if name == "defaults":
        assert o.vm_memory_overhead_percent == 0.075
        assert o.solver_backend == ("device" if port else "auto")
        assert o.gate("SpotToSpotConsolidation")
    elif name == "flag_overrides_env":
        assert o.cluster_name == "flagged"
    elif name == "env_overrides_default":
        assert o.solver_backend == "host"
        assert o.batch_idle_seconds == 2.5
        assert o.isolated is True
    elif name == "feature_gates":
        assert o.gate("NodeOverlay")
        assert not o.gate("NodeRepair")


class TestOptions:
    @pytest.mark.parametrize("name", sorted(OPTION_INPUTS))
    def test_parse_equals_the_reference(self, name):
        argv, env = OPTION_INPUTS[name]
        out = {}
        for P in (REF, PORT):
            o = P.Options.parse(list(argv), env=dict(env))
            _options_checks(name, o, P is PORT)
            out[P.pkg] = dataclasses.asdict(o)
        port = out["karpenter_tpu_torch"]
        assert port.pop("device") == ""
        # the port's one other default: the device rung where the
        # reference's is auto; a flag or env var sets both alike
        if out["karpenter_tpu"]["solver_backend"] == "auto":
            assert port["solver_backend"] == "device"
            port["solver_backend"] = "auto"
        assert port == out["karpenter_tpu"]

    def test_device_field(self):
        """The port's one added field: flag, env var, default."""
        Options = PORT.Options
        assert Options.parse([], env={}).device == ""
        assert Options.parse(["--device", "cpu"], env={}).device == "cpu"
        assert Options.parse([], env={"DEVICE": "cuda:1"}).device == "cuda:1"
        assert Options.parse(["--device", "cpu"],
                             env={"DEVICE": "cuda"}).device == "cpu"
        assert not hasattr(REF.Options(), "device")


# --- TestRuntime ---------------------------------------------------------

def runtime_sigterm_releases_leader_lease(P):
    backend = P.le.InMemoryLeaseBackend()
    clock = P.RealClock()
    elector = P.le.Elector(backend=backend, identity="replica-a")
    runtime = P.Runtime(clock=clock, elector=elector)

    async def drive():
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGTERM, runtime.stop)
        try:
            task = asyncio.create_task(runtime.start())
            for _ in range(100):
                if elector.is_leader():
                    break
                await asyncio.sleep(0.05)
            assert elector.is_leader()
            os.kill(os.getpid(), signal.SIGTERM)
            await asyncio.wait_for(task, timeout=5)
        finally:
            loop.remove_signal_handler(signal.SIGTERM)

    asyncio.run(drive())
    fresh = P.le.Elector(backend=backend, identity="replica-b")
    fresh.tick(clock.now())
    assert fresh.is_leader(), "lease not released on SIGTERM"
    return [fresh.is_leader(), runtime.crash_counts]


def runtime_drives_controllers(P):
    class Ticker:
        name = "ticker"

        def __init__(self):
            self.count = 0

        def reconcile(self, now):
            self.count += 1
            return 0.01

    async def run():
        t = Ticker()
        rt = P.Runtime().add(t)
        task = asyncio.create_task(rt.start())
        await asyncio.sleep(0.2)
        rt.stop()
        await task
        assert t.count >= 5
        return rt.crash_counts
    return asyncio.run(run())


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def runtime_metrics_endpoint(P):
    port = _free_port()

    async def run():
        rt = P.Runtime(metrics_port=port)
        task = asyncio.create_task(rt.start())
        await asyncio.sleep(0.1)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /metrics HTTP/1.1\r\n\r\n")
        await writer.drain()
        data = await reader.read(200)
        assert b"200 OK" in data
        writer.close()
        rt.stop()
        await task
        return data.split(b"\r\n")[0]
    return asyncio.run(run())


def runtime_counts_crashes_and_backoffs(P):
    """A retryable CloudError backs off and a crash is counted, each
    metered by disposition (the engine's contract on a live loop)."""
    class Flaky:
        def __init__(self, name, exc):
            self.name, self.exc, self.calls = name, exc, 0

        def reconcile(self, now):
            self.calls += 1
            if self.calls == 1:
                raise self.exc
            return 0.01

    errs = P.M.RECONCILE_ERRORS
    before = (errs.value(controller="thr", disposition="backoff"),
              errs.value(controller="boom", disposition="crash"))

    async def run():
        rt = P.Runtime().add(
            Flaky("thr", P.prov.RateLimitedError("slow")),
            Flaky("boom", ValueError("bug")))
        task = asyncio.create_task(rt.start())
        await asyncio.sleep(0.1)
        rt.stop()
        await task
        return rt
    rt = asyncio.run(run())
    after = (errs.value(controller="thr", disposition="backoff"),
             errs.value(controller="boom", disposition="crash"))
    assert rt.backoff_counts == {"thr": 1}
    assert rt.crash_counts == {"boom": 1}
    return [rt.backoff_counts, rt.crash_counts,
            [a - b for a, b in zip(after, before)]]


RUNTIME_CASES = {f.__name__: f for f in (
    runtime_sigterm_releases_leader_lease, runtime_drives_controllers,
    runtime_metrics_endpoint, runtime_counts_crashes_and_backoffs)}


class TestRuntime:
    @pytest.mark.parametrize("name", sorted(RUNTIME_CASES))
    def test_runtime_equals_the_reference(self, name):
        _both(RUNTIME_CASES[name])

    def test_runtime_runs_stop_hooks(self):
        """test_restart.py: on_stop hooks run after the controller tasks
        stop (the wiring build_operator uses for BatchingCloud.shutdown)."""
        def case(P):
            flushed = []
            rt = P.Runtime(metrics_port=0)
            rt.on_stop.append(lambda: flushed.append(True))

            async def drive():
                task = asyncio.create_task(rt.start())
                await asyncio.sleep(0.02)
                rt.stop()
                await task
            asyncio.run(drive())
            assert flushed == [True]
            return flushed
        _both(case)

    def test_runtime_serves_routes(self):
        """test_obs.py: the runtime's endpoint serves the route table."""
        def case(P):
            saved = (P.TRACER.enabled, P.TRACER.clock, P.TRACER.recorder,
                     P.TRACER.trace_dir, P.TRACER.drop_empty)
            P.TRACER.configure(enabled=True, ring_size=8)
            P.TRACER.trace_dir = ""
            port = _free_port()
            try:
                async def scenario():
                    rt = P.Runtime(metrics_port=port)
                    task = asyncio.create_task(rt.start())
                    await asyncio.sleep(0.05)
                    out = {}
                    for path in ("/healthz", "/metrics", "/debug/traces"):
                        reader, writer = await asyncio.open_connection(
                            "127.0.0.1", port)
                        writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
                        await writer.drain()
                        out[path] = await reader.read()
                        writer.close()
                    rt.stop()
                    await task
                    return out
                out = asyncio.run(scenario())
            finally:
                (P.TRACER.enabled, P.TRACER.clock, P.TRACER.recorder,
                 P.TRACER.trace_dir, P.TRACER.drop_empty) = saved
            assert out["/healthz"].endswith(b"ok\n")
            assert b"200 OK" in out["/metrics"]
            assert b"karpenter_tpu" in out["/metrics"]
            assert b"application/json" in out["/debug/traces"]
            return [out["/healthz"], out["/debug/traces"].split(b"\r\n")[:2]]
        _both(case)

    def test_runtime_serves_readyz(self):
        """test_obs.py: /readyz through the runtime answers 503 with the
        right reason line while a readiness probe fails, 200 otherwise."""
        def case(P):
            saved = dict(P.exposition.READINESS_PROBES)
            P.exposition.READINESS_PROBES.clear()
            # the body carries the process-global degraded_mode gauge:
            # start it empty, whatever an earlier module left in it
            degraded = P.mod("metrics").DEGRADED_MODE
            saved_degraded = dict(degraded._values)
            degraded._values.clear()
            port = _free_port()

            async def get(path):
                reader, writer = await asyncio.open_connection("127.0.0.1",
                                                               port)
                writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
                await writer.drain()
                out = await reader.read()
                writer.close()
                return out

            async def scenario():
                rt = P.Runtime(metrics_port=port)
                task = asyncio.create_task(rt.start())
                await asyncio.sleep(0.05)
                up = await get("/readyz")
                P.exposition.register_readiness("down", lambda: (False, {}))
                down = await get("/readyz")
                rt.stop()
                await task
                return up, down
            try:
                up, down = asyncio.run(scenario())
            finally:
                P.exposition.READINESS_PROBES.clear()
                P.exposition.READINESS_PROBES.update(saved)
                degraded._values.clear()
                degraded._values.update(saved_degraded)
            assert b"200 OK" in up
            assert b"503 Service Unavailable" in down
            body = json.loads(down.split(b"\r\n\r\n", 1)[1])
            return [up.split(b"\r\n")[0], down.split(b"\r\n")[0], body]
        _both(case)


# --- TestOperator --------------------------------------------------------

def operator_runs_end_to_end(P):
    cloud = P.FakeCloud(P.small_catalog(),
                        config=P.FakeCloudConfig(node_ready_delay=0.05,
                                                 register_delay=0.02))
    opts = P.options()
    opts.metrics_port = 0
    opts.solver_backend = "host"
    runtime, store, _ = P.main.build_operator(opts, cloud=cloud)
    for i in range(20):
        store.add_pod(P.Pod(name=f"rt-{i}", requests=P.Resources.parse(
            {"cpu": "500m", "memory": "1Gi"})))

    async def run():
        task = asyncio.create_task(runtime.start())
        for _ in range(100):
            await asyncio.sleep(0.1)
            if all(p.node_name for p in store.pods.values()):
                break
        runtime.stop()
        await task
    asyncio.run(run())
    assert all(p.node_name for p in store.pods.values())
    assert store.nodeclaims
    assert runtime.crash_counts == {}
    return [sorted(store.pods), runtime.crash_counts]


def operator_wires_round5_options(P, tmp):
    snap = str(tmp / f"{P.pkg}-prices.json")
    cloud = P.FakeCloud(P.small_catalog())
    opts = P.options()
    opts.metrics_port = 0
    opts.solver_backend = "host"
    opts.pricing_snapshot_file = snap
    opts.leader_elect = True
    opts.leader_elect_endpoint = "127.0.0.1:8085"
    runtime, store, raw = P.main.build_operator(opts, cloud=cloud)
    cat = next(c for c in runtime.controllers
               if getattr(c, "name", "") == "providers.refresh").catalog
    assert cat.pricing.snapshot_path == snap
    assert isinstance(runtime.elector.backend, P.le.HTTPLeaseBackend)
    assert runtime.elector.backend.port == 8085
    return [runtime.elector.backend.host, runtime.elector.backend.port]


def operator_file_lease_and_journal(P, tmp):
    """Leader election on a file lease and a file-backed intent journal:
    the operator leads, provisions, and releases the lease on stop."""
    lease = str(tmp / P.pkg / "leader.lease")
    cloud = P.FakeCloud(P.small_catalog(),
                        config=P.FakeCloudConfig(node_ready_delay=0.05,
                                                 register_delay=0.02))
    opts = P.options()
    opts.metrics_port = 0
    opts.solver_backend = "host"
    opts.leader_elect = True
    opts.leader_elect_lease_file = lease
    opts.leader_elect_identity = "op-a"
    opts.intent_journal_file = str(tmp / f"{P.pkg}-intents.wal")
    runtime, store, _ = P.main.build_operator(opts, cloud=cloud)
    for i in range(6):
        store.add_pod(P.Pod(name=f"le-{i}", requests=P.Resources.parse(
            {"cpu": "500m", "memory": "1Gi"})))

    async def run():
        task = asyncio.create_task(runtime.start())
        for _ in range(100):
            await asyncio.sleep(0.1)
            if all(p.node_name for p in store.pods.values()):
                break
        runtime.stop()
        await task
    asyncio.run(run())
    assert all(p.node_name for p in store.pods.values())
    held = P.le.FileLeaseBackend(lease).get()
    assert held.holder == ""  # released on stop
    return [held.holder, held.transitions, runtime.crash_counts]


class TestOperator:
    def test_build_operator_runs_end_to_end(self):
        _both(operator_runs_end_to_end)

    def test_build_operator_wires_round5_options(self, tmp_path):
        _both(operator_wires_round5_options, tmp_path)

    def test_build_operator_file_lease_and_journal(self, tmp_path):
        _both(operator_file_lease_and_journal, tmp_path)

    def test_build_operator_puts_the_solver_on_options_device(self):
        """Options.device reaches the facade: "cpu" runs the device rung's
        plain versions on the host."""
        opts = PORT.options()
        opts.metrics_port = 0
        opts.solver_backend = "device"
        runtime, _, _ = PORT.main.build_operator(
            opts, cloud=PORT.FakeCloud(PORT.small_catalog()))
        prov = next(c for c in runtime.controllers
                    if getattr(c, "name", "") == "provisioner")
        assert prov.solver.backend == "device"
        assert prov.solver.device.type == "cpu"

    def test_run_fleet_equals_the_reference(self, capsys):
        out = {}
        for P in (REF, PORT):
            _reset_sequences()
            # the rung the reference's default (auto) takes on the CPU
            opts = P.options(["--fleet-tenants", "2",
                              "--solver-backend", "native"])
            assert P.main.run_fleet(opts) == 0
            # every line but the measured host wall time
            out[P.pkg] = [line for line in capsys.readouterr().out.split("\n")
                          if "wall" not in line]
        assert "fleet=fleet_smoke" in out["karpenter_tpu_torch"][0]
        assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]

    def test_federate_raises_naming_item_12(self, capsys):
        """`run_fleet --federate`: the fleet's buckets cross the in-memory
        wire to an embedded SolverServer (the device rung, batched), and
        the report equals the reference's. (The name dates from before
        the federation plane was ported, when --federate raised.)"""
        out = {}
        for P in (REF, PORT):
            _reset_sequences()
            # the device rung named: the reference's default (auto) takes
            # a host rung on the CPU, where no bucket is batchable
            opts = P.options(["--fleet-tenants", "2", "--federate",
                              "--solver-backend", "device"])
            assert P.main.run_fleet(opts) == 0
            out[P.pkg] = [line for line in capsys.readouterr().out.split("\n")
                          if "wall" not in line and "overlap" not in line]
        assert "fleet=fleet_smoke" in out["karpenter_tpu_torch"][0]
        assert any("federated_wire_buckets" in line
                   for line in out["karpenter_tpu_torch"])
        assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]

    def test_main_soak_entry_point(self):
        """`python -m karpenter_tpu_torch.main --soak` prints the
        reference's report for the same scenario and seed."""
        out = {}
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["JAX_PLATFORMS"] = "cpu"
        for pkg, extra in (("karpenter_tpu", []),
                           ("karpenter_tpu_torch", ["--device", "cpu"])):
            proc = subprocess.run(
                [sys.executable, "-m", f"{pkg}.main", "--soak",
                 "--soak-scenario", "soak_smoke", "--solver-backend",
                 "native"] + extra, capture_output=True, text=True,
                cwd=REPO, env=env, timeout=300)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            out[pkg] = proc.stdout
        assert "soak=soak_smoke" in out["karpenter_tpu_torch"]
        assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]


# --- TestDebugMonitor ----------------------------------------------------

def debug_transitions_streamed(P):
    sim = P.make_sim()
    mon = P.DebugMonitor.attach(sim, sink=lambda s: None)
    sim.store.add_pod(P.Pod(name="w0", requests=P.Resources.parse(
        {"cpu": "500m", "memory": "1Gi"})))
    assert sim.engine.run_until(
        lambda: all(p.node_name for p in sim.store.pods.values()),
        timeout=120)
    trace = "\n".join(mon.lines)
    assert "pod/default/w0" in trace
    assert "nodeclaim/" in trace and "phase" in trace
    assert "Ready" in trace or "ready" in trace
    sim.engine.run_for(60, step=1)
    assert any("Initialized" in ln for ln in mon.lines)
    return list(mon.lines)


class TestDebugMonitor:
    def test_transitions_streamed(self):
        _both(debug_transitions_streamed)


# --- TestDurationRecorder (test_obs.py) ----------------------------------

def durations_exception_records_error_outcome(P, tmp):
    path = tmp / f"{P.pkg}.jsonl"
    rec = P.DurationRecorder(str(path))
    clk = P.FakeClock()
    with pytest.raises(RuntimeError):
        with rec.measure("failing-run", sim_clock=clk, pods=5):
            clk.step(3.0)
            raise RuntimeError("boom")
    with rec.measure("ok-run", sim_clock=clk):
        clk.step(1.0)
    events = [json.loads(line) for line in open(path)]
    assert len(events) == 2
    assert events[0]["name"] == "failing-run"
    assert events[0]["seconds"] == 3.0
    assert events[0]["dimensions"] == {"pods": "5", "outcome": "error"}
    assert events[1]["dimensions"]["outcome"] == "ok"
    return path.read_text()


def durations_record_thread_safe(P, tmp):
    path = tmp / f"{P.pkg}-threads.jsonl"
    rec = P.DurationRecorder(str(path))

    def worker(i):
        for j in range(50):
            rec.record(f"w{i}", 0.001 * j, {"i": str(i)}, clock=P.FakeClock())

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lines = path.read_text().splitlines()
    assert len(lines) == 400
    return sorted(json.dumps(json.loads(line), sort_keys=True)
                  for line in lines)


class TestDurationRecorder:
    @pytest.mark.parametrize("case", [durations_exception_records_error_outcome,
                                      durations_record_thread_safe],
                             ids=["exception_records_error_outcome",
                                  "record_thread_safe"])
    def test_recorder_equals_the_reference(self, case, tmp_path):
        _both(case, tmp_path)


# --- test_metrics.py: metering and reconcile durations -------------------

def _launch_req(P, name="m5.large"):
    return P.prov.LaunchRequest(nodeclaim_name="nc-metrics", overrides=[
        P.prov.LaunchOverride(instance_type=name, zone="zone-a",
                              capacity_type="on-demand", price=0.1)])


def metering_wire_calls_observed(P):
    cloud = P.MeteredCloud(P.FakeCloud(P.small_catalog(), clock=P.FakeClock()))
    dur = P.M.CLOUD_API_DURATION
    before = dur._totals.get(("describe_types",), 0)
    cloud.describe_types()
    cloud.describe_types()
    assert dur._totals[("describe_types",)] == before + 2
    return dur._totals[("describe_types",)] - before


def metering_in_band_fleet_errors_counted(P):
    raw = P.FakeCloud(P.small_catalog(), clock=P.FakeClock())
    raw.set_capacity("m5.large", "zone-a", "on-demand", 0)
    cloud = P.MeteredCloud(raw)
    key = dict(method="create_fleet", error="InsufficientCapacityError")
    before = P.M.CLOUD_API_ERRORS.value(**key)
    out = cloud.create_fleet([_launch_req(P)])
    assert any(isinstance(o, P.prov.InsufficientCapacityError) for o in out)
    assert P.M.CLOUD_API_ERRORS.value(**key) > before
    return [type(o).__name__ for o in out] + [
        P.M.CLOUD_API_ERRORS.value(**key) - before]


def metering_raised_errors_counted_and_reraised(P):
    raw = P.FakeCloud(P.small_catalog(), clock=P.FakeClock(),
                      config=P.FakeCloudConfig(describe_rate=1,
                                               describe_burst=1))
    cloud = P.MeteredCloud(raw)
    cloud.describe()
    key = dict(method="describe", error="RateLimitedError")
    before = P.M.CLOUD_API_ERRORS.value(**key)
    with pytest.raises(P.prov.RateLimitedError):
        cloud.describe()
    assert P.M.CLOUD_API_ERRORS.value(**key) == before + 1
    return 1


def metering_non_api_attributes_pass_through(P):
    raw = P.FakeCloud(P.small_catalog(), clock=P.FakeClock())
    cloud = P.MeteredCloud(raw)
    assert cloud.instances is raw.instances
    assert cloud.clock is raw.clock
    return True


def engine_records_reconcile_durations(P):
    dur = P.M.RECONCILE_DURATION
    before = {k: dur._totals.get((k,), 0) for k in ("provisioner",
                                                     "disruption")}
    sim = P.make_sim()
    sim.engine.tick()
    assert dur._totals.get(("provisioner",), 0) > before["provisioner"]
    assert dur._totals.get(("disruption",), 0) > before["disruption"]
    return sorted(c.name for c in sim.engine.controllers)


METRIC_CASES = {f.__name__: f for f in (
    metering_wire_calls_observed, metering_in_band_fleet_errors_counted,
    metering_raised_errors_counted_and_reraised,
    metering_non_api_attributes_pass_through,
    engine_records_reconcile_durations)}


class TestMetering:
    @pytest.mark.parametrize("name", sorted(METRIC_CASES))
    def test_metering_equals_the_reference(self, name):
        _both(METRIC_CASES[name])


# --- test_runtime_soak.py ------------------------------------------------

def _fast_clock(P):
    class FastClock(P.RealClock):
        """Wall clock x600: ~6 real seconds span a simulated hour."""

        SCALE = 600.0

        def __init__(self):
            self._t0 = time.monotonic()
            self._base = 1_000_000.0

        def now(self) -> float:
            return self._base + (time.monotonic() - self._t0) * self.SCALE
    return FastClock()


class Turbo:
    """Clamp requeue to 50ms real so every controller gets hundreds of
    cycles within the soak window."""

    def __init__(self, inner):
        self.inner = inner
        self.name = getattr(inner, "name", type(inner).__name__)

    def reconcile(self, now: float) -> float:
        self.inner.reconcile(now)
        return 0.05


def runtime_soak_chaos_throttle(P):
    clock = _fast_clock(P)
    cloud = P.FakeCloud(P.small_catalog(), clock=clock,
                        config=P.FakeCloudConfig(
                            node_ready_delay=30.0, register_delay=10.0,
                            create_fleet_rate=0.05, create_fleet_burst=4,
                            describe_rate=0.2, describe_burst=40,
                            terminate_rate=0.1, terminate_burst=8))
    opts = P.Options(interruption_queue="soak-q", metrics_port=0)
    if P.port:
        opts.device = "cpu"
    runtime, store, _ = P.main.build_operator(options=opts, cloud=cloud)
    assert runtime.clock is clock
    bcloud = next(c for c in runtime.controllers
                  if getattr(c, "name", "") == "provisioner").cloud
    runtime.controllers = [Turbo(c) for c in runtime.controllers]

    async def churn():
        rng = random.Random(42)
        n = 0
        for wave in range(18):
            for _ in range(8):
                store.add_pod(P.Pod(name=f"s{n}", requests=P.Resources.parse(
                    {"cpu": ["250m", "1", "2"][n % 3], "memory": "1Gi"})))
                n += 1
            if wave % 2 == 0:
                running = [i for i in cloud.instances.values()
                           if i.state == "running"]
                if running:
                    cloud.kill_instance(rng.choice(running).id,
                                        reason="chaos")
            bound = [p for p in store.pods.values() if p.node_name]
            for p in rng.sample(bound, min(2, len(bound))):
                store.delete_pod(p.namespace, p.name)
            await asyncio.sleep(0.35)
        return n

    async def main():
        run = asyncio.create_task(runtime.start())
        await churn()

        def converged():
            return (store.pods
                    and all(p.node_name for p in store.pods.values()))
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline and not converged():
            await asyncio.sleep(0.25)
        ok = converged()
        runtime.stop()
        await asyncio.wait_for(run, timeout=10)
        return ok

    ok = asyncio.run(main())
    assert clock.now() - 1_000_000.0 >= 3600.0
    assert runtime.crash_counts == {}, runtime.crash_counts
    assert ok
    assert bcloud.stats["terminate_batches"] >= 1
    assert bcloud.stats["describe_coalesced"] >= 1
    indexed = {k for g in store._pending_groups.values() for k in g}
    truth = {k for k, p in store.pods.items()
             if p.phase == "Pending" and p.node_name is None
             and P.L.NOMINATED not in p.annotations}
    assert indexed == truth
    iids = {i.id for i in cloud.instances.values() if i.state == "running"}
    for c in store.nodeclaims.values():
        assert c.phase not in (P.Phase.FAILED, P.Phase.TERMINATED), c.name
        if not c.is_deleting() and c.provider_id:
            assert c.provider_id.rsplit("/", 1)[-1] in iids, c.name
    return [ok, runtime.crash_counts]


@pytest.mark.slow
def test_runtime_soak_chaos_throttle():
    """The reference's `tests/test_runtime_soak.py` (slow there too):
    every controller through the port's asyncio runtime for a simulated
    hour under chaos kills, API throttling and pod churn."""
    _both(runtime_soak_chaos_throttle)
