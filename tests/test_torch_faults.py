"""The port's fault plan (`karpenter_tpu_torch/faults/plan.py`,
`injector.py` and `make_sim(fault_plan=)`) held against the JAX
reference's.

For every rule family the same seed and the same probes must give the
same canonical timeline and fingerprint in both packages, exactly. The
port's plan raises the port's own `ops/solver.InjectedFault` (the one
exception its facade, optimizer and batched pump degrade on), its
CorruptionFault rules damage torch tensors exactly as the reference's
damage device arrays, and the rules whose planes are not ported
(WireFault's transport seams: item 12) raise instead of never firing.
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import pytest

from karpenter_tpu import sim as ref_sim
from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.faults import injector as ref_injector
from karpenter_tpu.faults import plan as ref_plan
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops.encode import encode_catalog
from karpenter_tpu.utils import clock as ref_clock
from karpenter_tpu.utils.crashpoints import CrashInjected as RefCrash

from karpenter_tpu_torch import sim as port_sim
from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.faults import injector as port_injector
from karpenter_tpu_torch.faults import plan as port_plan
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.utils import clock as port_clock
from karpenter_tpu_torch.utils import crashpoints as port_crashpoints
from karpenter_tpu_torch.utils.crashpoints import CrashInjected as PortCrash

REF = SimpleNamespace(plan=ref_plan, injector=ref_injector, sim=ref_sim,
                      clock=ref_clock, pod=ref_pod, res=ref_res,
                      nodeclaim=ref_nodeclaim, fake=ref_fake, crash=RefCrash,
                      kw={})
PORT = SimpleNamespace(plan=port_plan, injector=port_injector, sim=port_sim,
                       clock=port_clock, pod=port_pod, res=port_res,
                       nodeclaim=port_nodeclaim, fake=port_fake,
                       crash=PortCrash, kw={"device": "cpu"})


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """Give the reference back its sequences, and empty its signature
    intern table and device-resident state after this module (the
    test-order hazard of ROADMAP §3)."""
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids)
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids = saved
    from karpenter_tpu.integrity import INTEGRITY
    from karpenter_tpu.ops.delta import DELTA
    from karpenter_tpu.ops.resident import RESIDENT
    ref_pod._sig_intern.clear()
    RESIDENT.reset()
    DELTA.reset()
    from karpenter_tpu_torch.ops.delta import DELTA as PORT_DELTA
    from karpenter_tpu_torch.ops.resident import RESIDENT as PORT_RESIDENT
    PORT_RESIDENT.reset()
    PORT_DELTA.reset()
    INTEGRITY.reset()


def _reset_sequences(P) -> None:
    _reset_planes(P)
    P.nodeclaim._seq = itertools.count()
    P.pod._uid = itertools.count()
    P.fake._ids = itertools.count(1)


def _reset_planes(P) -> None:
    """This package's delta and resident planes start each run empty:
    memo keys hold id(facade), and a reused id must not meet a dead
    facade's entry in one package and not in the other."""
    import importlib
    pkg = P.nodeclaim.__name__.split(".")[0]
    for mod, name in (("ops.delta", "DELTA"), ("ops.resident", "RESIDENT")):
        getattr(importlib.import_module(f"{pkg}.{mod}"), name).reset()


# --- one probe script per rule family, run against each package ---------


def _ice(P):
    plan = P.plan.FaultPlan(seed=1, rules=[
        P.plan.IceWindow(10.0, 20.0, zone="zone-a", capacity_type="spot"),
        P.plan.IceWindow(15.0, 30.0, instance_type="m5.large")])
    plan.origin = 1_000.0
    hits = [plan.ice_active(t, z, c, 1_000.0 + now)
            for now in (5.0, 10.0, 17.5, 20.0, 29.0, 30.0)
            for t in ("m5.large", "c5.xlarge")
            for z in ("zone-a", "zone-b")
            for c in ("spot", "on-demand")]
    return plan, hits


def _api(P):
    plan = P.plan.FaultPlan(seed=3, rules=[
        P.plan.ApiFault(("create_fleet",), 0.0, 100.0, p=0.5,
                        error="rate_limited", retry_after=7.0),
        P.plan.ApiFault(("describe", "terminate"), 20.0, 60.0, p=0.3,
                        error="server"),
        P.plan.ApiFault(("describe_nodes",), 50.0, 70.0)])
    out = []
    for t in range(0, 120, 3):
        for m in ("create_fleet", "describe", "terminate", "describe_nodes"):
            err = plan.api_fault(m, float(t))
            out.append((type(err).__name__,
                        getattr(err, "retry_after", None)))
    return plan, out


def _clock_jump(P):
    plan = P.plan.FaultPlan(seed=0, rules=[
        P.plan.ClockJump(30.0, 20.0), P.plan.ClockJump(40.0, 90.0),
        P.plan.ClockJump(200.0, 5.0)])
    clock = P.clock.FakeClock(start=500.0)
    plan.clock, plan.origin = clock, clock.now()
    for j in plan.clock_jumps:
        clock.schedule_jump(plan.origin + j.at, j.delta, plan.on_jump)
    seen = []
    for _ in range(30):
        clock.step(7.0)
        seen.append(clock.now())
    return plan, seen


def _device(P):
    plan = P.plan.FaultPlan(seed=0, rules=[
        P.plan.DeviceFault(dispatch=2, count=2),
        P.plan.DeviceFault(dispatch=7, count=1)])
    plan.clock = P.clock.FakeClock()
    plan.origin = plan.clock.now()
    out = []
    for i in range(10):
        plan.clock.step(1.5)
        try:
            plan.on_dispatch("device" if i % 3 else "screen")
            out.append("ok")
        except P.plan.InjectedFault as e:
            out.append(str(e))
    return plan, out


def _burst(P):
    """Spot, kill and rebalance bursts (one aimed by pod-name prefix)
    delivered by install_bursts into a running make_sim: the victims are
    drawn with the plan RNG over the creation-ordered instances."""
    _reset_sequences(P)
    plan = P.plan.FaultPlan(seed=5, rules=[
        P.plan.InterruptionBurst(at=20.0, count=2, kind="spot"),
        P.plan.InterruptionBurst(at=25.0, count=1, kind="rebalance"),
        P.plan.InterruptionBurst(at=30.0, count=1, kind="kill",
                                 target_pods=("big-",)),
        P.plan.InterruptionBurst(at=40.0, count=50, kind="kill")])
    sim = P.sim.make_sim(fault_plan=plan, backend="host", **P.kw)
    R = P.res.Resources
    for i in range(8):
        sim.store.add_pod(P.pod.Pod(
            name=f"big-{i}" if i % 2 else f"small-{i}",
            requests=R.parse({"cpu": "3" if i % 2 else "1",
                              "memory": "4Gi"})))
    sim.engine.run_until(lambda: False, timeout=60.0, step=0.5)
    return plan, sorted(i.state for i in sim.cloud.instances.values())


def _crash(P):
    plan = P.plan.FaultPlan(seed=0, rules=[
        P.plan.CrashPoint(point="post_launch", nth=2, at=10.0),
        P.plan.CrashPoint(point="mid_drain", nth=1),
        P.plan.CrashPoint(point="mid_launch_batch", nth=3)])
    plan.clock = P.clock.FakeClock()
    plan.origin = plan.clock.now()
    out = []
    for i, point in enumerate(("post_launch", "mid_drain", "post_launch",
                               "mid_launch_batch", "post_launch",
                               "mid_launch_batch", "post_launch",
                               "mid_launch_batch", "mid_drain")):
        plan.clock.step(4.0)
        try:
            plan.on_crash_point(point)
            out.append("ok")
        except P.crash as e:
            out.append(str(e))
    out.append(plan.crashes_remaining)
    return plan, out


FAMILIES = {"IceWindow": _ice, "ApiFault": _api, "ClockJump": _clock_jump,
            "DeviceFault": _device, "InterruptionBurst": _burst,
            "CrashPoint": _crash}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rule_family_timeline_and_fingerprint_equal(family):
    ref_plan_obj, ref_out = FAMILIES[family](REF)
    port_plan_obj, port_out = FAMILIES[family](PORT)
    assert port_out == ref_out
    assert port_plan_obj.timeline == ref_plan_obj.timeline
    assert port_plan_obj.timeline, f"{family}: no fault fired"
    assert port_plan_obj.fingerprint() == ref_plan_obj.fingerprint()


def test_wire_seams_equal_the_reference_when_driven_directly():
    """The WireFault seams are copied (their transport is item 12): driven
    by hand they raise the same classes on the same probes and garble the
    same reply frames, on one timeline."""
    def drive(P):
        plan = P.plan.FaultPlan(seed=2, rules=[
            P.plan.WireFault(kind="flap", at=0.0, window=50.0, nth=2,
                             methods=("solve_bucket",)),
            P.plan.WireFault(kind="latency", nth=2, count=2),
            P.plan.WireFault(kind="slow_handshake", nth=1),
            P.plan.WireFault(kind="blackhole", at=60.0, window=5.0),
            P.plan.WireFault(kind="corrupt_frame", nth=2, count=1)])
        plan.clock = P.clock.FakeClock()
        plan.origin = plan.clock.now()
        out = []
        for i in range(14):
            plan.clock.step(5.0)
            for m in ("solve_bucket", "handshake", "healthz"):
                try:
                    plan.on_wire(m)
                    out.append("ok")
                except Exception as e:  # noqa: BLE001 — the class is the probe
                    out.append(type(e).__name__)
            out.append(plan.on_wire_reply("solve_bucket", b'{"a":1}'))
        return plan, out
    (rp, rout), (pp, pout) = drive(REF), drive(PORT)
    assert pout == rout
    assert pp.timeline == rp.timeline and pp.fingerprint() == rp.fingerprint()


def test_injected_fault_is_the_solvers():
    assert port_plan.InjectedFault is port_solver.InjectedFault
    from karpenter_tpu_torch.faults import InjectedFault
    assert InjectedFault is port_solver.InjectedFault


def test_corruption_fault_raises_naming_item_7():
    """Once a difference (the port's plan refused CorruptionFault rules
    until the resident-state seam existed), now an equality case: the same
    rules and probes give the same damaged bytes, timeline and fingerprint
    in both packages, and the port's damage lands in a NEW tensor — the
    probed one keeps its bytes."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    probes = [("gbuf", rng.random((6, 5), np.float32), ()),
              ("resident", rng.random((7, 4), np.float32), ("f", "gbuf")),
              ("resident", rng.random((5, 3, 2), np.float32), ("f", "price")),
              ("resident", rng.random((8, 8)) > 0.5, ("f", "conflict")),
              ("resident", np.zeros((4, 3), np.float32), ("f", "gbuf")),
              ("gbuf", np.ones((3, 4, 2), np.float32), ())]

    def rules(P):
        C = P.plan.CorruptionFault
        return [C(target="gbuf", kind="bitflip", nth=1, count=2),
                C(target="resident", kind="zero_row", nth=1,
                  key_contains="gbuf", count=2),
                C(target="resident", kind="stale_patch", nth=1,
                  key_contains="price"),
                C(target="resident", kind="bitflip", nth=1,
                  key_contains="conflict")]

    ref = REF.plan.FaultPlan(seed=4, rules=rules(REF))
    port = PORT.plan.FaultPlan(seed=4, rules=rules(PORT))
    for target, arr, key in probes:
        want = np.asarray(ref.on_corruption(target, jnp.asarray(arr), key))
        held = torch.from_numpy(arr.copy())
        got = port.on_corruption(target, held, key)
        assert np.array_equal(got.numpy(), want), (target, key)
        assert np.array_equal(held.numpy(), arr)  # never damaged in place
    assert port.timeline == ref.timeline
    assert port.fingerprint() == ref.fingerprint()
    assert len(port.timeline) == 6


def test_wire_fault_hooks_raise_naming_item_12():
    plan = port_plan.FaultPlan(seed=0, rules=[port_plan.WireFault()])
    with pytest.raises(NotImplementedError, match="item 12"):
        with port_injector.wire_fault_plan_hook(plan):
            pass
    with pytest.raises(NotImplementedError, match="item 12"):
        port_injector.wire_fault_hook()
    # a plan without wire rules arms nothing, as in the reference
    with port_injector.wire_fault_plan_hook(port_plan.FaultPlan(seed=0)):
        pass


def test_device_fault_hook_arms_the_solver_seam_and_always_disarms():
    plan = port_plan.FaultPlan(seed=0, rules=[port_plan.DeviceFault()])
    plan.clock = port_clock.FakeClock()
    with pytest.raises(port_solver.InjectedFault):
        with port_injector.device_fault_hook(plan):
            assert port_solver._dispatch_fault_hook is not None
            port_solver.probe_dispatch_fault("device")
    assert port_solver._dispatch_fault_hook is None
    crash = port_plan.FaultPlan(seed=0, rules=[
        port_plan.CrashPoint(point="mid_drain")])
    crash.clock = port_clock.FakeClock()
    with port_injector.crash_point_hook(crash):
        assert port_crashpoints._hook is not None
    assert port_crashpoints._hook is None


def test_faulty_cloud_raises_and_passes_through():
    clock = port_clock.FakeClock()
    from karpenter_tpu_torch.catalog import small_catalog
    from karpenter_tpu_torch.cloud.provider import RateLimitedError
    cloud = port_fake.FakeCloud(small_catalog(), clock=clock)
    plan = port_plan.FaultPlan(rules=[
        port_plan.ApiFault(("terminate",), 0.0, 100.0, p=1.0)])
    plan.origin = clock.now()
    fc = port_injector.FaultyCloud(cloud, plan, clock)
    with pytest.raises(RateLimitedError):
        fc.terminate(["i-x"])
    assert fc.describe() == []
    assert fc.describe_types()
    assert fc.snapshot()["instances"] == {}


@pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])
def test_reinstall_keeps_origin_and_does_not_reschedule_jumps(P):
    """make_sim(fault_plan=) on the clock the plan is already installed on
    (a restart) stamps no new origin and schedules no jump again; the
    reference is held to the same two facts."""
    plan = P.plan.FaultPlan(seed=0, rules=[P.plan.ClockJump(30.0, 20.0),
                                           P.plan.ClockJump(90.0, 5.0)])
    sim = P.sim.make_sim(fault_plan=plan, backend="host", **P.kw)
    origin = plan.origin
    assert origin == sim.clock.now()
    assert len(sim.clock._jumps) == 2
    assert sim.fault_plan is plan and sim.cloud.fault_plan is plan
    assert sim.provisioner.cloud is not sim.cloud   # FaultyCloud between
    sim.clock.step(40.0)
    assert sim.clock.now() == origin + 60.0         # the first jump fired
    again = P.sim.make_sim(cloud=sim.cloud, clock=sim.clock, backend="host",
                           fault_plan=plan, journal=sim.journal, **P.kw)
    assert plan.origin == origin
    assert len(again.clock._jumps) == 1             # only the unfired one
    assert [k for _, k, _ in plan.timeline] == ["clock_jump"]


def test_plain_make_sim_arms_nothing():
    from karpenter_tpu_torch.utils import crashpoints
    sim = port_sim.make_sim(backend="host", device="cpu")
    assert sim.fault_plan is None and sim.cloud.fault_plan is None
    assert sim.clock._jumps == []
    assert port_solver._dispatch_fault_hook is None
    assert crashpoints._hook is None
    assert sim.provisioner.cloud is sim.cloud
