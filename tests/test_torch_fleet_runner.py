"""The port's fleet runner (`karpenter_tpu_torch/fleet/{tenant,runner,
scenarios,__main__}.py`) and SLO engine (`obs/slo.py`) held against the
JAX reference's.

Each fleet scenario runs through the reference's `FleetRunner` (JAX on the
CPU) and the port's (`device="cpu"`: the kernels' plain versions), with
the claim-name, pod-uid and instance-id sequences restarted at the same
value in both before each run. Per-tenant end-state hashes, fault
fingerprints, the service's dispatch counts, the watchdogs' findings, the
explained pods of `report.explain` and the SLO engine's alerts must be
equal, exactly — and so must the batched pump's batch and ticket counts, with both packages' delta planes armed (their memos serve some
repeated solves before they reach the pump) and with KARPENTER_TPU_DELTA=0.
"""

from __future__ import annotations

import itertools

import pytest

from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.fleet import FleetRunner as RefRunner
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops.encode import encode_catalog

from karpenter_tpu_torch.catalog import CatalogProvider, small_catalog
from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.faults.plan import (ClockJump, CrashPoint,
                                             DeviceFault, FaultPlan)
from karpenter_tpu_torch.fleet import (FLEET_SCENARIOS, FleetRunner,
                                       SolverService, build_shard,
                                       tenant_journal_path, tenant_seed)
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.models.nodepool import NodePool
from karpenter_tpu_torch.utils.clock import FakeClock

SERVICE = ("solves_dispatched", "solves_throttled", "catalog_shared_hits",
           "catalog_shared_misses", "faults_injected", "slo_alerts",
           "watchdog_findings")


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
    """Both packages' delta and resident planes and explain recorders
    start each run empty: memo keys hold id(facade), and a reused id must
    not meet a dead facade's entry in one package and not in the other."""
    from karpenter_tpu.obs.explain import RECORDER as REF_RECORDER
    from karpenter_tpu.ops.delta import DELTA as REF_DELTA
    from karpenter_tpu.ops.resident import RESIDENT as REF_RESIDENT
    from karpenter_tpu_torch.obs.explain import RECORDER as PORT_RECORDER
    from karpenter_tpu_torch.ops.delta import DELTA as PORT_DELTA
    from karpenter_tpu_torch.ops.resident import RESIDENT as PORT_RESIDENT
    for plane in (REF_DELTA, REF_RESIDENT, REF_RECORDER, PORT_DELTA,
                  PORT_RESIDENT, PORT_RECORDER):
        plane.reset()


def _both(name, **kw):
    _reset_sequences()
    ref = RefRunner(name, **kw).run()
    _reset_sequences()
    port = FleetRunner(name, device="cpu", **kw).run()
    assert ref.ok, ref.summary()
    assert port.ok, port.summary()
    assert port.tenant_hashes == ref.tenant_hashes
    assert port.tenant_fingerprints == ref.tenant_fingerprints
    assert (port.fleet_hash, port.fleet_fingerprint, port.sim_seconds) == \
        (ref.fleet_hash, ref.fleet_fingerprint, ref.sim_seconds)
    for k in SERVICE:
        assert port.stats[k] == ref.stats[k], k
    assert port.slo["alerts"] == ref.slo["alerts"]
    assert port.slo["budgets"] == ref.slo["budgets"]
    assert port.explain == ref.explain
    return ref, port


@pytest.mark.parametrize("backend,batch", [("host", False),
                                           ("device", True)],
                         ids=["serial-host", "batched-device"])
def test_fleet_smoke_equals_the_reference(backend, batch):
    ref, port = _both("fleet_smoke", tenants=8, seed=0, backend=backend,
                      batch=batch)
    assert port.tenant_fingerprints["t000"]
    assert port.tenant_fingerprints["t001"] == ""
    assert port.stats["faults_injected"] > 0
    if batch:
        # the delta plane armed in both: the same solves reach the pump
        for k in ("solve_batches", "batched_tickets"):
            assert port.stats[k] == ref.stats[k], k
        assert (port.stats["solve_batches"],
                port.stats["batched_tickets"]) == (22, 22)


def test_fleet_smoke_batch_counts_without_the_delta_plane(monkeypatch):
    """With both delta planes off, every solve reaches the batched pump:
    the batch and ticket counts are equal, and the buckets hold about one
    ticket each, as in the reference."""
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    ref, port = _both("fleet_smoke", tenants=8, seed=0, backend="device",
                      batch=True)
    for k in ("solve_batches", "batched_tickets"):
        assert port.stats[k] == ref.stats[k], k
    assert port.stats["batched_tickets"] <= 1.5 * port.stats["solve_batches"]


def test_federation_smoke_in_process_equals_the_reference():
    ref, port = _both("federation_smoke", seed=0, backend="device")
    assert port.stats["solve_batches"] > 0


def test_noisy_neighbor_equals_the_reference_and_isolates():
    """The SLO engine's alerts and budgets, the isolation verdict (victim
    p99 during the storm < 2x quiet, the noisy tenant throttled and
    burning) and the provenance verdict (a throttled pod of the noisy
    tenant explained, its record equal), equal the reference's."""
    ref, port = _both("fleet_noisy_neighbor", seed=0, backend="host")
    for k in ("victim_p99_quiet_ms", "victim_p99_storm_ms",
              "victim_samples_storm", "noisy_throttled", "noisy_solves",
              "noisy_burn_alerts", "noisy_availability_budget",
              "victim_min_availability_budget",
              "noisy_throttled_pod_explained"):
        assert port.stats[k] == ref.stats[k], k
    assert port.stats["noisy_throttled"] > 0
    assert port.stats["victim_p99_storm_ms"] < \
        2 * port.stats["victim_p99_quiet_ms"]
    assert port.slo["alerts"]
    assert port.stats["noisy_throttled_pod_explained"] == 1.0
    noisy = next(iter(port.explain))
    assert port.explain[noisy]["throttles"] > 0


def test_smoke_hashes_repeat_and_batching_changes_nothing():
    a = FleetRunner("fleet_smoke", tenants=4, seed=7, device="cpu").run()
    b = FleetRunner("fleet_smoke", tenants=4, seed=7, backend="device",
                    batch=True, device="cpu").run()
    assert a.ok and b.ok
    assert a.tenant_hashes == b.tenant_hashes
    assert a.fleet_fingerprint == b.fleet_fingerprint
    c = FleetRunner("fleet_smoke", tenants=4, seed=1, device="cpu").run()
    assert c.fleet_hash != a.fleet_hash


def test_tenant_device_fault_degrades_only_that_tenant():
    """A device fault on tenant a's dispatch degrades a's facade; b keeps
    the device rung (no cross-tenant suspension leak)."""
    from karpenter_tpu_torch.faults.injector import fleet_device_fault_hook
    from karpenter_tpu_torch.metrics.tenant import tenant_scope
    from karpenter_tpu_torch.models.pod import Pod
    from karpenter_tpu_torch.models.resources import Resources
    svc = SolverService(FakeClock(), backend="device", device="cpu")
    a = svc.register("a", CatalogProvider(lambda: small_catalog()))
    b = svc.register("b", CatalogProvider(lambda: small_catalog()))
    pool = NodePool(name="default")

    def pods(prefix):
        return [Pod(name=f"{prefix}-{i}", requests=Resources.parse(
            {"cpu": "500m", "memory": "1Gi"})) for i in range(4)]
    plan = FaultPlan(seed=0, rules=[DeviceFault(dispatch=1, count=1)])
    plan.clock = svc.clock
    with fleet_device_fault_hook({"a": plan}):
        with tenant_scope("a"):
            assert a.solve(pods("a"), pool).launches
        assert a.facade._device_suspended > 0
        assert a.facade.stats["device_fallbacks"] == 1
        with tenant_scope("b"):
            assert b.solve(pods("b"), pool).launches
        assert b.facade._device_suspended == 0
        assert b.facade.stats["device_fallbacks"] == 0
    assert [k for _, k, _ in plan.timeline] == ["device"]


@pytest.mark.parametrize("rule", [ClockJump(10.0, 20.0),
                                  CrashPoint(point="post_launch")],
                         ids=["ClockJump", "CrashPoint"])
def test_fleet_global_rules_rejected_in_a_tenant_plan(rule):
    clock = FakeClock()
    svc = SolverService(clock, backend="host", device="cpu")
    with pytest.raises(ValueError):
        build_shard("t000", clock, svc, rules=[rule], device="cpu")


def test_tenant_identity_is_the_references():
    from karpenter_tpu.fleet.tenant import tenant_seed as ref_seed
    for fleet_seed in (0, 1, 7):
        for t in ("t000", "t001", "t042"):
            assert tenant_seed(fleet_seed, t) == ref_seed(fleet_seed, t)
    paths = {tenant_journal_path("/j", f"t{i:03d}") for i in range(64)}
    assert len(paths) == 64


@pytest.mark.parametrize("name", ["fed_flap", "fed_partition",
                                  "fed_server_restart"])
def test_federated_scenarios_raise_naming_item_12(name):
    """The federated drills (an embedded SolverServer behind the in-memory
    wire) at seed 0: digests, wire fingerprint and the federation stats
    equal the reference's. (The name dates from before the federation
    plane was ported, when these scenarios raised.)"""
    ref, port = _both(name, seed=0)
    assert port.wire_fingerprint == ref.wire_fingerprint
    fed = {k: v for k, v in port.stats.items()
           if k.startswith(("federat", "wire_", "catalog_"))}
    assert fed == {k: ref.stats[k] for k in fed}
    assert port.stats["federated_wire_buckets"] > 0


def test_slo_engine_equals_the_reference_on_synthetic_indicators():
    """Burn rates, budgets and edge-triggered alerts over a scripted
    indicator, step for step."""
    from karpenter_tpu.obs import slo as ref_slo
    from karpenter_tpu.utils.clock import FakeClock as RefClock

    from karpenter_tpu_torch.obs import slo as port_slo

    def drive(slo_mod, clock_cls):
        counts = {"good": 0.0, "total": 0.0}
        spec = slo_mod.SloSpec("x", 0.9, lambda t: (counts["good"],
                                                    counts["total"]))
        clock = clock_cls(start=0.0)
        eng = slo_mod.SloEngine(clock, slos=[spec], tenants=("a", "b"),
                                fast_window=30.0, slow_window=120.0)
        trail = []
        for i in range(200):
            clock.step(1.0)
            counts["total"] += 4
            counts["good"] += 4 if (i // 40) % 2 else (1 if i % 3 else 4)
            trail.append(eng.tick())
        return trail, eng.budgets(), eng.alerts
    assert drive(port_slo, FakeClock) == drive(ref_slo, RefClock)


def test_faults_cli_lists_and_runs(capsys):
    from karpenter_tpu_torch.faults.__main__ import main
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "smoke" in out and "fleet_smoke [fleet x8]" in out
    assert main(["smoke", "--device", "cpu", "--repeat", "2"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] scenario=smoke" in out and "reproducible" in out
    assert main(["restart_smoke", "--device", "cpu"]) == 0
    assert main(["warmpath_smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] scenario=warmpath_smoke" in out


def test_fleet_cli_lists_and_runs(capsys):
    from karpenter_tpu_torch.fleet.__main__ import main
    assert main([]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in FLEET_SCENARIOS)
    assert main(["fleet_smoke", "--tenants", "3", "--batch", "--backend",
                 "device", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[PASS]" in out and "tenants=3" in out and "solve_batches" in out
    # --federate: the buckets cross the in-memory wire to an embedded
    # SolverServer; the report equals the reference CLI's
    from karpenter_tpu.fleet.__main__ import main as ref_main
    args = ["federation_smoke", "--tenants", "4", "--federate"]
    outs = []
    for fn, extra in ((ref_main, []), (main, ["--device", "cpu"])):
        _reset_sequences()
        assert fn(args + extra) == 0
        outs.append([line for line in capsys.readouterr().out.split("\n")
                     if "wall" not in line and "overlap" not in line])
    assert outs[1] == outs[0]
    assert any("federated_wire_buckets" in line for line in outs[1])
