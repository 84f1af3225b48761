"""The port's warm path (`karpenter_tpu_torch/warmpath/`) held against the
JAX reference's.

First the 25 cases of the reference's `tests/test_warmpath.py`, rerun
through the port's `make_sim(warmpath=True, device="cpu")` on its default
device rung (kernels B0 and B as their plain versions): arrival-only
reconciles are admitted against the standing headroom ledger with the full
solver's placement semantics (the always-on auditor replays every warm
admission through `Solver.solve()` and divergence must be zero), and
anything else falls cold, never wrong.

Then bench c8's steady-state sequence at a small size (64 standing pods,
each pinned to its own node by hostname self-anti-affinity, one prime
burst, 6 warm bursts of 32, 2 forced-cold bursts, a final audit) through
both packages' `make_sim(warmpath=True, backend=X)` on each rung, with the
sequences (claim names, pod uids, instance ids) restarted at the same value
in both: the end state hash, the warm path's stats and hit rate, the
decision and audit counters and the auditor's divergences must be equal,
exactly.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops.encode import encode_catalog

from karpenter_tpu_torch import sim as port_sim
from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.metrics import (WARMPATH_AUDITS, WARMPATH_DECISIONS,
                                         WARMPATH_DIVERGENCE)
from karpenter_tpu_torch.models import labels as L
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.models.pod import Pod, PodAffinityTerm
from karpenter_tpu_torch.models.resources import Resources


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


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """Both resource axes get the same columns; afterwards the reference
    gets its sequences back and its intern table, planes and integrity
    meter reset (ROADMAP §3's test-order hazard)."""
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids)
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids = saved
    from karpenter_tpu.integrity import INTEGRITY
    from karpenter_tpu_torch.integrity import INTEGRITY as PORT_INTEGRITY
    ref_pod._sig_intern.clear()
    _reset_planes()
    INTEGRITY.reset()
    PORT_INTEGRITY.reset()


def make_sim(**kw):
    return port_sim.make_sim(device="cpu", **kw)


def mk_pods(n, prefix, cpu="250m", mem="256Mi", **kw):
    return [Pod(name=f"{prefix}-{i}",
                requests=Resources.parse({"cpu": cpu, "memory": mem}), **kw)
            for i in range(n)]


def add(sim, n, prefix, **kw):
    pods = mk_pods(n, prefix, **kw)
    for p in pods:
        sim.store.add_pod(p)
    return pods


def settle(sim, timeout=300):
    ok = sim.engine.run_until(
        lambda: all(p.node_name for p in sim.store.pods.values()),
        timeout=timeout)
    assert ok, [p.name for p in sim.store.pods.values() if not p.node_name]


def steady_sim(**kw):
    """A sim at warm steady state: a standing claim with headroom, all
    pods bound, ledger committed AFTER the fleet settled (the third
    wave's cold pass recommits post-materialization)."""
    sim = make_sim(warmpath=True, **kw)
    add(sim, 8, "w1")
    settle(sim)
    add(sim, 2, "w2")  # cold again (node-add events), recommits clean
    settle(sim)
    return sim


class TestDeltaTracker:
    def test_starts_dirty_until_first_commit(self):
        sim = make_sim(warmpath=True)
        assert sim.warmpath.tracker.dirty == "uncommitted"

    def test_plain_arrival_keeps_warm_window_open(self):
        sim = steady_sim()
        assert sim.warmpath.tracker.dirty is None
        add(sim, 1, "arrival")
        assert sim.warmpath.tracker.dirty is None

    def test_claim_delete_dirties(self):
        sim = steady_sim()
        name = next(iter(sim.store.nodeclaims))
        sim.store.delete_nodeclaim(name)
        assert sim.warmpath.tracker.dirty == "nodeclaim-delete"

    def test_daemonset_add_dirties(self):
        from karpenter_tpu_torch.models.pod import DaemonSet
        sim = steady_sim()
        sim.store.add_daemonset(DaemonSet(
            name="agent", requests=Resources.parse({"cpu": "100m"})))
        assert sim.warmpath.tracker.dirty == "daemonset-add"

    def test_bind_of_nominated_pod_is_warm_safe(self):
        sim = steady_sim()
        assert sim.warmpath.tracker.dirty is None
        pods = add(sim, 2, "warm-bind")
        sim.provisioner.reconcile(sim.clock.now())   # warm-admits them
        assert all(p.annotations.get(L.NOMINATED) for p in pods)
        settle(sim)  # BindingController binds the nominated pods
        assert sim.warmpath.tracker.dirty is None

    def test_unbind_dirties(self):
        sim = steady_sim()
        bound = next(p for p in sim.store.pods.values() if p.node_name)
        sim.store.unbind_pod(bound)
        assert sim.warmpath.tracker.dirty is not None

    def test_pending_pod_withdrawn_is_warm_safe(self):
        sim = steady_sim()
        add(sim, 1, "withdrawn")
        sim.store.delete_pod("default", "withdrawn-0")
        assert sim.warmpath.tracker.dirty is None


class TestWarmAdmission:
    def test_trickles_admitted_warm_with_zero_divergence(self):
        sim = steady_sim()
        claims_before = set(sim.store.nodeclaims)
        div0 = WARMPATH_DIVERGENCE.value()
        for wave in range(3):
            add(sim, 3, f"trickle-{wave}")
            settle(sim)
        wp = sim.warmpath
        assert wp.stats["warm_reconciles"] >= 3, wp.stats
        assert wp.stats["warm_pods"] >= 9
        assert wp.auditor.stats["audits"] >= 3       # always-on auditor
        assert wp.stats["divergences"] == 0
        assert WARMPATH_DIVERGENCE.value() == div0
        # warm admissions ride standing capacity: no new claims
        assert set(sim.store.nodeclaims) == claims_before

    def test_warm_placement_lands_on_standing_claim(self):
        sim = steady_sim()
        claim = next(iter(sim.store.nodeclaims.values()))
        before = Resources(claim.resource_requests)
        pods = add(sim, 2, "landing")
        sim.provisioner.reconcile(sim.clock.now())
        for p in pods:
            assert p.annotations.get(L.NOMINATED) == claim.name
        # the claim's accounted requests grew by the admitted pods
        grown = claim.resource_requests.get("cpu") - before.get("cpu")
        assert abs(grown - 0.5) < 1e-6

    def test_overflow_escalates_to_full_solver(self):
        sim = steady_sim()
        claims_before = len(sim.store.nodeclaims)
        # far more than the standing claim's headroom: the fitting slice
        # is admitted warm, the remainder escalates and opens nodes
        add(sim, 60, "burst", cpu="1", mem="1Gi")
        settle(sim)
        assert len(sim.store.nodeclaims) > claims_before
        assert sim.warmpath.stats["escalated_pods"] > 0
        assert sim.warmpath.stats["divergences"] == 0

    def test_colocation_bundle_escalates_whole(self):
        sim = steady_sim()
        sim.store.add_pod(Pod(
            name="cache", labels={"app": "cache"},
            requests=Resources.parse({"cpu": "250m", "memory": "256Mi"})))
        for i in range(2):
            sim.store.add_pod(Pod(
                name=f"worker-{i}", labels={"app": "worker"},
                requests=Resources.parse({"cpu": "250m",
                                          "memory": "256Mi"}),
                affinity_terms=[PodAffinityTerm(
                    topology_key=L.HOSTNAME,
                    label_selector={"app": "cache"})]))
        settle(sim)
        # the bundle went through the full solver (colocation planner),
        # warm or not — and the audit stayed clean throughout
        assert sim.warmpath.stats["divergences"] == 0
        cache = sim.store.pods["default/cache"]
        workers = [sim.store.pods[f"default/worker-{i}"] for i in range(2)]
        assert all(w.node_name == cache.node_name for w in workers)

    def test_ice_mark_forces_cold(self):
        sim = steady_sim()
        warm_before = sim.warmpath.stats["warm_reconciles"]
        sim.catalog.unavailable.mark_unavailable(
            "c5.large", "zone-a", "spot", reason="test")
        add(sim, 2, "post-ice")
        settle(sim)
        assert sim.warmpath.stats["warm_reconciles"] == warm_before
        assert sim.warmpath.stats["cold_reconciles"] >= 3
        assert WARMPATH_DECISIONS.value(path="cold",
                                        reason="catalog-epoch") >= 1

    def test_interruption_kill_forces_cold_and_recovers(self):
        sim = steady_sim()
        iid = next(i.id for i in sim.cloud.instances.values()
                   if i.state == "running")
        sim.cloud.kill_instance(iid, reason="test")
        add(sim, 2, "post-kill")
        settle(sim, timeout=600)
        assert sim.warmpath.tracker.dirty is None  # recommitted since
        assert sim.warmpath.stats["divergences"] == 0
        assert all(p.node_name for p in sim.store.pods.values())

    def test_claim_marked_deleting_forces_cold(self):
        """delete_nodeclaim mutates the claim IN PLACE (deletion
        timestamp, phase); the store broadcasts it, so the tracker goes
        dirty and arrivals stop landing on the draining node."""
        sim = steady_sim()
        assert sim.warmpath.tracker.dirty is None
        claim = next(iter(sim.store.nodeclaims.values()))
        sim.termination.delete_nodeclaim(claim, sim.clock.now(), "test")
        assert sim.warmpath.tracker.dirty == "nodeclaim-deleting"
        add(sim, 2, "post-drain")
        settle(sim, timeout=600)
        # cold path replaced the fleet; nobody is nominated to the
        # drained claim
        assert all(p.annotations.get(L.NOMINATED) != claim.name
                   for p in sim.store.pods.values())

    def test_cordon_forces_cold(self):
        """A decision-time cordon is an in-place Node taint — it must
        dirty the warm window so arrivals stop filling the victim."""
        sim = steady_sim()
        from karpenter_tpu_torch.state.cluster import build_node_views
        views = build_node_views(sim.store, sim.solver.tensors(None),
                                 sim.clock.now())
        sim.disruption._cordon(views[:1])
        assert sim.warmpath.tracker.dirty == "node-cordon"

    def test_nodepool_mutation_forces_cold(self):
        from karpenter_tpu_torch.models.requirements import (Operator,
                                                             Requirement)
        sim = steady_sim()
        sim.store.nodepools["default"].requirements.add(
            Requirement(L.CAPACITY_TYPE, Operator.IN, (L.CAPACITY_SPOT,)))
        assert sim.warmpath.classify() == "pool-config"


class TestAuditor:
    def test_clean_audit_metered(self):
        sim = steady_sim()
        clean0 = WARMPATH_AUDITS.value(outcome="clean")
        add(sim, 2, "audited")
        sim.provisioner.reconcile(sim.clock.now())
        assert WARMPATH_AUDITS.value(outcome="clean") == clean0 + 1

    def test_divergence_forces_cold_flight_records_and_recovers(self):
        sim = steady_sim()
        div0 = WARMPATH_DIVERGENCE.value()
        # sabotage the audit BASELINE (not the ledger): phantom residents
        # consume every baseline node's headroom, so the replayed full
        # solve must open a node where the warm path placed on existing
        for base in sim.warmpath.auditor._baselines.values():
            for vn in base.nodes:
                vn.cum = vn.cum + np.float32(1e6)
        pods = add(sim, 2, "diverging")
        sim.provisioner.reconcile(sim.clock.now())
        assert WARMPATH_DIVERGENCE.value() > div0
        assert sim.warmpath.tracker.dirty == "audit-divergence"
        assert any(e[2] == "WarmPathDivergence" for e in sim.store.events)
        # the pods were still nominated (warm placement stands — the
        # audit is a meter, the FORCED COLD is the repair) and the
        # cluster converges
        assert all(p.annotations.get(L.NOMINATED) for p in pods)
        settle(sim)
        # next arrival goes cold and recommits a clean window
        add(sim, 1, "after-divergence")
        settle(sim)
        assert sim.warmpath.stats["divergences"] >= 1

    def test_commit_audits_pending_batches_instead_of_dropping(self):
        """With audit_every > 1, a mixed reconcile's commit audits the
        recorded warm batches before it resets the baseline."""
        sim = steady_sim(warm_audit_every=50)
        add(sim, 2, "recorded")
        sim.provisioner.reconcile(sim.clock.now())   # warm, unaudited
        assert sim.warmpath.auditor.has_pending()
        audits0 = sim.warmpath.auditor.stats["audits"]
        # force the next reconcile cold: its commit must audit first
        sim.warmpath.force_cold("test")
        add(sim, 1, "cold-trigger")
        sim.provisioner.reconcile(sim.clock.now())
        assert sim.warmpath.auditor.stats["audits"] == audits0 + 1
        assert not sim.warmpath.auditor.has_pending()
        assert sim.warmpath.stats["divergences"] == 0

    def test_audit_cadence_counts_windows_not_pool_batches(self):
        sim = steady_sim(warm_audit_every=3)
        for i in range(2):
            add(sim, 1, f"window-{i}")
            sim.provisioner.reconcile(sim.clock.now())
        assert sim.warmpath.auditor.stats["audits"] == 0
        add(sim, 1, "window-2")
        sim.provisioner.reconcile(sim.clock.now())   # third window: due
        assert sim.warmpath.auditor.stats["audits"] == 1

    def test_audit_is_rebased_after_clean_window(self):
        sim = steady_sim()
        add(sim, 2, "w-a", cpu="100m")
        sim.provisioner.reconcile(sim.clock.now())
        # second, differently-sized batch: without the rebase the joint
        # replay could legitimately reorder across batches — with it,
        # each window is exact parity
        add(sim, 2, "w-b", cpu="750m")
        sim.provisioner.reconcile(sim.clock.now())
        assert sim.warmpath.auditor.stats["audits"] >= 2
        assert sim.warmpath.stats["divergences"] == 0


class TestScenarios:
    def test_warmpath_storm_chaos_scenario(self):
        from karpenter_tpu_torch.faults.runner import ScenarioRunner
        rep = ScenarioRunner("warmpath_storm", seed=0, device="cpu").run()
        assert rep.ok, rep.summary()
        assert rep.stats["warm_pods"] > 0, rep.stats
        assert rep.stats["warm_divergences"] == 0
        assert rep.stats["warm_audits"] >= 1

    def test_warmpath_smoke_scenario(self):
        from karpenter_tpu_torch.faults.runner import ScenarioRunner
        rep = ScenarioRunner("warmpath_smoke", seed=0, device="cpu").run()
        assert rep.ok, rep.summary()
        assert rep.stats["warm_divergences"] == 0


class TestObservability:
    def test_metrics_exposed(self):
        from karpenter_tpu_torch.metrics import REGISTRY
        sim = steady_sim()
        add(sim, 1, "metered")
        sim.provisioner.reconcile(sim.clock.now())
        exposed = REGISTRY.expose()
        for name in ("karpenter_tpu_warmpath_decisions_total",
                     "karpenter_tpu_warmpath_admit_duration_seconds",
                     "karpenter_tpu_warmpath_warm_hit_rate",
                     "karpenter_tpu_warmpath_divergence_total",
                     "karpenter_tpu_warmpath_audits_total"):
            assert name in exposed, name

    def test_admit_span_and_path_attr(self):
        from karpenter_tpu_torch.obs.tracer import TRACER
        sim = steady_sim()
        TRACER.configure(enabled=True, clock=sim.clock.now)
        try:
            add(sim, 1, "traced")
            sim.clock.step(2.0)  # make the provisioner due again
            sim.engine.tick()
            spans = {s.name: s for t in TRACER.recorder.slowest()
                     for s in t.spans}
            assert "warmpath.admit" in spans
            rec = next(s for n, s in spans.items()
                       if n == "reconcile:provisioner")
            assert rec.attrs.get("path") == "warm"
        finally:
            TRACER.configure(enabled=False)
            TRACER.recorder.clear()


# --- bench c8's steady-state sequence, both packages ----------------------

C8_STANDING = 64
C8_WARM = 6
C8_COLD = 2
C8_BURST = 32


def _c8(sim_mod, pod_mod, res_mod, fake_mod, metrics_mod, backend, **kw):
    """Bench c8 (bench.py:488-570) at a small size: standing pods pinned
    one to a node, a prime burst (cold: it commits the ledger), warm
    bursts, forced-cold bursts, then the auditor drained."""
    sim = sim_mod.make_sim(
        warmpath=True, warm_audit_every=64, backend=backend,
        cloud_config=fake_mod.FakeCloudConfig(
            node_ready_delay=1.0, register_delay=0.5,
            create_fleet_rate=1e6, create_fleet_burst=10**6), **kw)
    for i in range(C8_STANDING):
        sim.store.add_pod(pod_mod.Pod(
            name=f"standing-{i}", labels={"app": "standing"},
            requests=res_mod.Resources.parse({"cpu": "500m",
                                              "memory": "512Mi"}),
            affinity_terms=[pod_mod.PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": "standing"}, anti=True)]))
    assert sim.engine.run_until(
        lambda: all(p.node_name for p in sim.store.pods.values()),
        timeout=900.0, step=1.0)

    def burst(tag):
        for i in range(C8_BURST):
            sim.store.add_pod(pod_mod.Pod(
                name=f"burst-{tag}-{i}",
                requests=res_mod.Resources.parse({"cpu": "100m",
                                                  "memory": "128Mi"})))

    def counters():
        return {(p, r): metrics_mod.WARMPATH_DECISIONS.value(path=p, reason=r)
                for p, r in (("warm", "arrivals-only"),
                             ("mixed", "arrivals-only"),
                             ("escalated", "arrivals-only"),
                             ("cold", "uncommitted"),
                             ("cold", "bench-forced"))} | {
            o: metrics_mod.WARMPATH_AUDITS.value(outcome=o)
            for o in ("clean", "divergent")}
    before = counters()
    burst("prime")
    sim.provisioner.reconcile(sim.clock.now())
    for rep in range(C8_WARM):
        burst(f"warm{rep}")
        sim.provisioner.reconcile(sim.clock.now())
    for rep in range(C8_COLD):
        burst(f"cold{rep}")
        sim.warmpath.force_cold("bench-forced")
        sim.provisioner.reconcile(sim.clock.now())
    divergences = sim.warmpath.auditor.audit()
    after = counters()
    return sim, divergences, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("backend", ["device", "native", "host"])
def test_c8_sequence_equals_the_reference(backend):
    from karpenter_tpu import metrics as ref_metrics
    from karpenter_tpu import sim as ref_sim
    from karpenter_tpu.faults.runner import state_hash as ref_state_hash

    from karpenter_tpu_torch import metrics as port_metrics

    def reset():
        _reset_planes()
        for nodeclaim, pod, fake in ((ref_nodeclaim, ref_pod, ref_fake),
                                     (port_nodeclaim, port_pod, port_fake)):
            nodeclaim._seq = itertools.count()
            pod._uid = itertools.count()
            fake._ids = itertools.count(1)
    reset()
    ref, ref_div, ref_counts = _c8(ref_sim, ref_pod, ref_res, ref_fake,
                                   ref_metrics, backend)
    reset()
    port, port_div, port_counts = _c8(port_sim, port_pod, port_res,
                                      port_fake, port_metrics, backend,
                                      device="cpu")
    assert len(port.store.nodeclaims) >= C8_STANDING
    assert port.warmpath.stats["warm_reconciles"] >= C8_WARM
    assert port_div == ref_div == []
    assert port.warmpath.stats == ref.warmpath.stats
    assert port.warmpath.auditor.stats == ref.warmpath.auditor.stats
    assert port.warmpath.hit_rate == ref.warmpath.hit_rate
    assert port_counts == ref_counts
    assert port_counts["clean"] >= 1 and port_counts["divergent"] == 0
    assert port_sim.state_hash(port) == ref_state_hash(ref)
    assert port.watchdog.stats == ref.watchdog.stats
    assert port.watchdog.findings_at_least("info") == 0
