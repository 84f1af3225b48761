"""The port's chaos runner (`karpenter_tpu_torch/faults/runner.py`) held
against the JAX reference's, scenario by scenario.

Every runnable non-restart scenario of the catalog runs through the
reference's `ScenarioRunner` at its own backend and through the port's on
the device rung (`device="cpu"`: the kernels' plain versions). The end
state, the fault timeline and the stats both report must be equal,
exactly — the online watchdog's findings and the warm path's stats
included; the sequences (claim names, pod uids, instance ids) restart at
the same value in both packages before each run. Then the reference's
`tests/test_chaos.py` cases rerun through the port.
"""

from __future__ import annotations

import dataclasses
import itertools

import pytest

from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.faults import ScenarioRunner as RefRunner
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops.encode import encode_catalog

from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.faults import (SCENARIOS, FaultPlan,
                                        InterruptionBurst, ScenarioRunner)
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res

UNPORTED: dict = {}
RUNNABLE = sorted(n for n, sc in SCENARIOS.items()
                  if not sc.restart and n not in UNPORTED)
STATS = ("solver_device_fallbacks", "ice_marks", "provisioner_ice_errors",
         "solver_catalog_rebuilds", "corruptions_injected",
         "corruptions_detected", "watchdog_findings",
         "watchdog_findings_warning", "watchdog_evals")
WARM_STATS = ("warm_pods", "warm_reconciles", "cold_reconciles",
              "warm_audits", "warm_divergences")


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """Both resource axes get the same columns; afterwards the reference
    gets its sequences back and its intern table, resident state, delta
    memos and integrity meter reset (ROADMAP §3's test-order hazard)."""
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
    _reset_planes()


def _reset_sequences() -> None:
    _reset_planes()
    for nodeclaim, pod, fake in ((ref_nodeclaim, ref_pod, ref_fake),
                                 (port_nodeclaim, port_pod, port_fake)):
        nodeclaim._seq = itertools.count()
        pod._uid = itertools.count()
        fake._ids = itertools.count(1)


def _reset_planes() -> None:
    """Both packages' delta and resident planes, explain recorders and
    integrity meters start each run empty: memo keys hold id(facade), and
    a reused id must not meet a dead facade's entry in one package and not
    in the other; an unrecovered violation an earlier module left in one
    package's meter holds its integrity_breach excursion open, so a drill
    pages once there and twice in the other (ROADMAP §3's test-order
    hazard)."""
    from karpenter_tpu.integrity import INTEGRITY as REF_INTEGRITY
    from karpenter_tpu.obs.explain import RECORDER as REF_RECORDER
    from karpenter_tpu.ops.delta import DELTA as REF_DELTA
    from karpenter_tpu.ops.resident import RESIDENT as REF_RESIDENT
    from karpenter_tpu_torch.integrity import INTEGRITY as PORT_INTEGRITY
    from karpenter_tpu_torch.obs.explain import RECORDER as PORT_RECORDER
    from karpenter_tpu_torch.ops.delta import DELTA as PORT_DELTA
    from karpenter_tpu_torch.ops.resident import RESIDENT as PORT_RESIDENT
    for plane in (REF_DELTA, REF_RESIDENT, REF_RECORDER, REF_INTEGRITY,
                  PORT_DELTA, PORT_RESIDENT, PORT_RECORDER, PORT_INTEGRITY):
        plane.reset()


def _port_device(name: str):
    return dataclasses.replace(SCENARIOS[name], backend="device")


@pytest.mark.parametrize("name", RUNNABLE)
def test_scenario_equals_the_reference(name):
    _reset_sequences()
    ref = RefRunner(name, seed=0).run()
    _reset_sequences()
    port = ScenarioRunner(_port_device(name), seed=0, device="cpu").run()
    assert ref.ok, ref.summary()
    assert port.ok, port.summary()
    assert port.faults_injected > 0
    assert (port.converged, port.violations) == (ref.converged,
                                                 ref.violations)
    assert port.end_hash == ref.end_hash
    assert port.fault_fingerprint == ref.fault_fingerprint
    assert port.faults_injected == ref.faults_injected
    assert port.sim_seconds == ref.sim_seconds
    for k in STATS:
        assert port.stats[k] == ref.stats[k], k
    if not port.stats["corruptions_injected"]:
        assert port.stats["watchdog_findings_warning"] == 0
    if SCENARIOS[name].warmpath:
        for k in WARM_STATS:
            assert port.stats[k] == ref.stats[k], k
        assert port.stats["warm_divergences"] == 0
    assert port.stats == ref.stats


def test_same_seed_reproduces_timeline_and_end_state():
    a = ScenarioRunner("smoke", seed=3, device="cpu").run()
    b = ScenarioRunner("smoke", seed=3, device="cpu").run()
    assert a.ok and b.ok
    assert (a.fault_fingerprint, a.end_hash, a.faults_injected) == \
        (b.fault_fingerprint, b.end_hash, b.faults_injected)


def test_brownout_reproduces_probabilistic_draws():
    a = ScenarioRunner("api_brownout", seed=11, device="cpu").run()
    b = ScenarioRunner("api_brownout", seed=11, device="cpu").run()
    assert a.ok and b.ok
    assert a.fault_fingerprint == b.fault_fingerprint
    assert a.end_hash == b.end_hash


def test_capacity_degraded_gauge_tracks_live_marks_and_clears():
    from karpenter_tpu_torch.metrics import DEGRADED_MODE
    runner = ScenarioRunner("ice_storm", seed=0, device="cpu")
    rep = runner.run()
    assert rep.ok
    sim = runner.last_sim
    sim.catalog.unavailable.seqnum
    assert DEGRADED_MODE.value(component="capacity") == float(
        sim.catalog.unavailable.active())
    assert rep.stats["ice_marks"] > 0
    assert rep.stats["provisioner_ice_errors"] > 0
    sim.clock.step(181.0)  # past UNAVAILABLE_OFFERINGS_TTL
    sim.catalog.unavailable.seqnum
    assert sim.catalog.unavailable.active() == 0
    assert DEGRADED_MODE.value(component="capacity") == 0.0


def test_faults_meter_and_fault_spans_surface():
    """Every injection counts on faults_injected_total{kind}, and with
    the tracer on lands a fault.<kind> span in the flight recorder."""
    from karpenter_tpu_torch.metrics import FAULTS_INJECTED
    from karpenter_tpu_torch.obs.tracer import TRACER
    saved = (TRACER.enabled, TRACER.clock, TRACER.recorder,
             TRACER.trace_dir, TRACER.drop_empty)
    before = FAULTS_INJECTED.value(kind="ice")
    TRACER.configure(enabled=True, ring_size=64)
    TRACER.trace_dir = ""
    try:
        rep = ScenarioRunner("ice_storm", seed=0, device="cpu").run()
        spans = {s.name for t in TRACER.recorder.slowest()
                 for s in t.spans}
    finally:
        (TRACER.enabled, TRACER.clock, TRACER.recorder,
         TRACER.trace_dir, TRACER.drop_empty) = saved
    assert rep.ok
    assert FAULTS_INJECTED.value(kind="ice") > before
    assert any(n.startswith("fault.") for n in spans)


def test_device_loss_fallback_metered_and_converges():
    from karpenter_tpu_torch.metrics import SOLVER_FALLBACKS

    def fallbacks():
        return sum(SOLVER_FALLBACKS.value(from_backend="device",
                                          to_backend=b)
                   for b in ("host", "native"))
    before = fallbacks()
    rep = ScenarioRunner("device_loss", seed=0, device="cpu").run()
    assert rep.ok, rep.summary()
    assert rep.stats["solver_device_fallbacks"] == 1
    assert fallbacks() == before + 1


def test_bundle_replanned_atomically_and_tensor_reuploaded_once():
    """An interruption hitting ONE node of a colocated bundle replans the
    WHOLE bundle onto one fresh node, and its mark bumps the ICE
    component of the catalog epoch exactly once."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.pod import Pod, PodAffinityTerm
    from karpenter_tpu_torch.models.requirements import Operator, Requirement
    from karpenter_tpu_torch.models.resources import Resources
    from karpenter_tpu_torch.sim import make_sim
    plan = FaultPlan(seed=0, rules=[
        InterruptionBurst(at=30.0, count=1, kind="spot",
                          target_pods=("bundle-",))])
    sim = make_sim(fault_plan=plan, backend="host", device="cpu")
    sim.store.nodepools["default"].requirements.add(Requirement(
        L.CAPACITY_TYPE, Operator.IN,
        (L.CAPACITY_SPOT, L.CAPACITY_ON_DEMAND)))
    sim.store.add_pod(Pod(
        name="bundle-cache-0", labels={"app": "bundle-cache"},
        requests=Resources.parse({"cpu": "1", "memory": "2Gi"})))
    for i in range(3):
        sim.store.add_pod(Pod(
            name=f"bundle-w-{i}", labels={"app": "bundle-w"},
            requests=Resources.parse({"cpu": "1", "memory": "1Gi"}),
            affinity_terms=[PodAffinityTerm(
                topology_key=L.HOSTNAME,
                label_selector={"app": "bundle-cache"})]))
    for i in range(10):
        sim.store.add_pod(Pod(
            name=f"bg-{i}",
            requests=Resources.parse({"cpu": "500m", "memory": "1Gi"})))

    def bundle_nodes():
        return {p.node_name for p in sim.store.pods.values()
                if p.name.startswith("bundle-")}

    def all_bound():
        return all(p.node_name is not None for p in sim.store.pods.values())
    assert sim.engine.run_until(all_bound, timeout=25.0)
    (node0,) = bundle_nodes()
    marks0 = sim.catalog.unavailable.stats["marks"]
    epoch0 = sim.catalog.epoch
    assert not plan.timeline

    def replanned():
        nodes = bundle_nodes()
        return all_bound() and len(nodes) == 1 and node0 not in nodes
    assert sim.engine.run_until(replanned, timeout=120.0)
    assert [k for _, k, _ in plan.timeline] == ["interruption"]
    assert sim.catalog.unavailable.stats["marks"] == marks0 + 1
    epoch1 = sim.catalog.epoch
    assert epoch1[1] == epoch0[1] + 1
    assert (epoch1[0],) + epoch1[2:] == (epoch0[0],) + epoch0[2:]


def test_runner_needs_a_card_without_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScenarioRunner("smoke", seed=0).run()


# --- the soak's weather over the full catalog: the over-capacity state ---

_CPUS = ("100m", "250m", "500m", "750m", "1", "1500m", "2", "3", "4", "6")
_MEMS = ("128Mi", "256Mi", "512Mi", "1Gi", "2Gi", "3Gi", "4Gi", "8Gi",
         "16Gi")


def _storm(pod_mod, res_mod, catalog_types, scenarios, n: int):
    """The soak scenario replaced onto the 810-type catalog with n grid
    pods (chip_smoke's storm, cut in size) arriving in waves of n/2, n/4
    and n/4 at 0, 120 and 300 s."""
    import numpy as np
    waves = ((0.0, n // 2), (120.0, n // 4), (300.0, n - n // 2 - n // 4))

    def workload(sim):
        rng = np.random.default_rng(0)
        ci = rng.integers(0, len(_CPUS), n).tolist()
        mi = rng.integers(0, len(_MEMS), n).tolist()
        pods = [pod_mod.Pod(name=f"p{i}", requests=res_mod.Resources.parse(
            {"cpu": _CPUS[c], "memory": _MEMS[m]}))
            for i, (c, m) in enumerate(zip(ci, mi))]
        origin, fired, at = sim.fault_plan.origin, set(), 0
        starts = []
        for t, k in waves:
            starts.append((t, pods[at:at + k]))
            at += k

        def arrivals(now):
            for w, (t, wave) in enumerate(starts):
                if w not in fired and now - origin >= t:
                    fired.add(w)
                    for p in wave:
                        sim.store.add_pod(p)
        arrivals(sim.clock.now())
        sim.engine.add_hook(arrivals)
    return dataclasses.replace(scenarios["soak"], name="storm",
                               types=lambda: catalog_types,
                               workload=workload)


def test_storm_reaches_the_over_capacity_state_like_the_reference():
    """The soak's weather over 200 grid pods on the full catalog brings
    both packages' armed loops to the recorded over-capacity state
    (ROADMAP §3): the oracle flags existing nodes over capacity, the
    runner reports the flags against its zero-false-positive contract,
    and end state, fault timeline, flags and stats are equal."""
    from karpenter_tpu.faults import SCENARIOS as REF_SCENARIOS
    from karpenter_tpu.models import pod as ref_pod_mod

    from karpenter_tpu_torch.catalog import generate_catalog as port_catalog
    _reset_sequences()
    ref_runner = RefRunner(_storm(ref_pod_mod, ref_res, generate_catalog(),
                                  REF_SCENARIOS, 200), seed=0)
    ref = ref_runner.run()
    _reset_sequences()
    port_sc = dataclasses.replace(
        _storm(port_pod, port_res, port_catalog(), SCENARIOS, 200),
        backend="device")
    port_runner = ScenarioRunner(port_sc, seed=0, device="cpu")
    port = port_runner.run()
    assert port.converged and ref.converged
    assert port.stats["corruptions_detected"] > 0
    assert port.violations == ref.violations == [
        f"{int(port.stats['corruptions_detected'])} integrity violation(s) "
        f"on a corruption-free run — the zero-false-positive contract broke"]
    assert (port.end_hash, port.fault_fingerprint, port.faults_injected) == \
        (ref.end_hash, ref.fault_fingerprint, ref.faults_injected)
    for k in STATS + ("corruptions_detected",):
        assert port.stats[k] == ref.stats[k], k
    assert port_runner.last_sim.solver.stats["integrity_violations"] == \
        ref_runner.last_sim.solver.stats["integrity_violations"]
