"""The port's control loop held against the JAX reference's.

Each scenario of `tests/test_e2e_slice.py` and `tests/test_disruption.py`
(plus a discovered-capacity one) runs through the reference's
`make_sim(backend=X)` (JAX on the CPU) and through the port's
`make_sim(backend=X, device="cpu")`, with KARPENTER_TPU_OPTIMIZER=0 (the
greedy path; the loop with the optimizer armed, the default, is held
equal in test_torch_sim_optimizer.py). Both packages build their pods,
pools and clouds with their own constructors from the same seeds, and the
process-global sequences (claim names, pod uids, instance ids) start from
the same value in both before each run.

What must be equal, exactly:
- the port's `state_hash` against the reference's
  `faults.runner.state_hash`, and the reference's `state_hash` applied to
  the port's sim (which checks the copy);
- the disruption decision log (every event the disruption controller
  records: reason, victims and replacements);
- every controller's stats;
- every event the store records.
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_tpu import sim as ref_sim
from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.catalog import small_catalog as ref_small_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.cloud.provider import LaunchOverride as RefLaunchOverride
from karpenter_tpu.cloud.provider import LaunchRequest as RefLaunchRequest
from karpenter_tpu.faults.runner import state_hash as ref_state_hash
from karpenter_tpu.metrics import SOLVER_FALLBACKS as REF_FALLBACKS
from karpenter_tpu.models import labels as ref_labels
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import nodepool as ref_nodepool
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import requirements as ref_req
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.consolidate import consolidation_screen as ref_screen
from karpenter_tpu.ops.encode import encode_catalog, encode_pods as ref_encode
from karpenter_tpu.state.cluster import build_node_views as ref_views

from karpenter_tpu_torch import sim as port_sim
from karpenter_tpu_torch.catalog import small_catalog as port_small_catalog
from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.cloud.provider import LaunchOverride as PortLaunchOverride
from karpenter_tpu_torch.cloud.provider import LaunchRequest as PortLaunchRequest
from karpenter_tpu_torch.metrics import SOLVER_FALLBACKS as PORT_FALLBACKS
from karpenter_tpu_torch.models import labels as port_labels
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import nodepool as port_nodepool
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import requirements as port_req
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import consolidate as port_consolidate
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.ops.encode import encode_pods as port_encode
from karpenter_tpu_torch.state.cluster import build_node_views as port_views


def _namespace(sim, state_hash, labels, nodeclaim, nodepool, pod, req, res,
               fake, small_catalog, override, request, screen, encode, views,
               **extra):
    return SimpleNamespace(
        make_sim=sim.make_sim, state_hash=state_hash, L=labels,
        nodeclaim=nodeclaim, pod=pod, fake=fake, Pod=pod.Pod,
        Taint=pod.Taint, Toleration=pod.Toleration,
        NodePool=nodepool.NodePool, DisruptionSpec=nodepool.DisruptionSpec,
        Budget=nodepool.Budget, Requirement=req.Requirement,
        Operator=req.Operator, Resources=res.Resources,
        MEMORY=res.MEMORY, small_catalog=small_catalog,
        LaunchOverride=override, LaunchRequest=request, screen=screen,
        encode_pods=encode, build_node_views=views, extra=extra)


REF = _namespace(ref_sim, ref_state_hash, ref_labels, ref_nodeclaim,
                 ref_nodepool, ref_pod, ref_req, ref_res, ref_fake,
                 ref_small_catalog, RefLaunchOverride, RefLaunchRequest,
                 ref_screen, ref_encode, ref_views)
PORT = _namespace(port_sim, port_sim.state_hash, port_labels, port_nodeclaim,
                  port_nodepool, port_pod, port_req, port_res, port_fake,
                  port_small_catalog, PortLaunchOverride, PortLaunchRequest,
                  port_consolidate.consolidation_screen,
                  port_encode, port_views, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """After this module: give the reference back its claim-name, pod-uid
    and instance-id sequences, empty its signature intern table (a
    rotation, see test_torch_encode.py) and reset its device-resident
    state, delta memos and integrity meter, as its own test modules do."""
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids)
    yield
    # the reference's sequences continue where they were before this module
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


@pytest.fixture(scope="module", autouse=True)
def _shared_resource_axis():
    """Both packages' resource axes get the same columns in the same
    order (see test_torch_facade.py)."""
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    assert port_res.resource_axis() == ref_res.resource_axis()


@pytest.fixture(autouse=True)
def _greedy(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")


def _reset_sequences(P) -> None:
    """Claim names break ties in orderings: both packages mint them (and
    pod uids and instance ids) from the same starting value."""
    _reset_planes(P)
    P.nodeclaim._seq = itertools.count()
    P.pod._uid = itertools.count()
    P.fake._ids = itertools.count(1)


def _reset_planes(P) -> None:
    """This package's delta and resident planes and explain recorder
    start each run empty: memo keys hold id(facade), and a reused id must
    not meet a dead facade's entry in one package and not in the other."""
    import importlib
    pkg = P.nodeclaim.__name__.split(".")[0]
    for mod, name in (("ops.delta", "DELTA"), ("ops.resident", "RESIDENT"),
                      ("obs.explain", "RECORDER")):
        getattr(importlib.import_module(f"{pkg}.{mod}"), name).reset()


# --- scenarios: each drives one package's sim with its own objects --------


def add_pods(P, sim, n, cpu="500m", mem="1Gi", prefix="p", **kw):
    pods = [P.Pod(name=f"{prefix}-{i}",
                  requests=P.Resources.parse({"cpu": cpu, "memory": mem}),
                  **kw)
            for i in range(n)]
    for p in pods:
        sim.store.add_pod(p)
    return pods


def all_bound(sim):
    return all(p.node_name is not None for p in sim.store.pods.values())


def settle(sim, timeout=120):
    assert sim.engine.run_until(lambda: all_bound(sim), timeout=timeout)


def sc_500_pods(P, sim):
    add_pods(P, sim, 500)
    settle(sim)
    assert len(sim.store.nodes) < 100


def sc_in_flight(P, sim):
    add_pods(P, sim, 20)
    settle(sim, 60)
    add_pods(P, sim, 5, prefix="follow")
    settle(sim, 60)


def sc_ice_failover(P, sim):
    for t in sim.cloud.types.values():
        for o in t.offerings:
            if o.capacity_type == "spot":
                sim.cloud.set_capacity(t.name, o.zone, "spot", 0)
    add_pods(P, sim, 50)
    settle(sim)
    assert all(c.capacity_type == "on-demand"
               for c in sim.store.nodeclaims.values())


def sc_ice_marks(P, sim):
    for t in sim.cloud.types.values():
        for o in t.offerings:
            if not t.name.startswith("m5."):
                sim.cloud.set_capacity(t.name, o.zone, o.capacity_type, 0)
    add_pods(P, sim, 30)
    settle(sim, 180)


def tainted_pool(P):
    taint = P.Taint(key="dedicated", value="ml", effect="NoSchedule")
    return {"nodepool": P.NodePool(name="tainted", taints=[taint])}


def sc_taints(P, sim):
    add_pods(P, sim, 5, prefix="plain")
    tolerant = add_pods(P, sim, 5, prefix="tol", tolerations=[
        P.Toleration(key="dedicated", operator="Exists")])
    sim.engine.run_for(30)
    assert all(p.node_name is not None for p in tolerant)


def sc_multi_pool(P, sim):
    del sim.store.nodepools["default"]
    heavy = P.NodePool(name="heavy", weight=10)
    heavy.requirements.add(P.Requirement(P.L.INSTANCE_FAMILY, P.Operator.IN,
                                         ("m5",)))
    sim.store.add_nodepool(heavy)
    sim.store.add_nodepool(P.NodePool(name="light", weight=1))
    add_pods(P, sim, 10)
    add_pods(P, sim, 1, prefix="gpu", cpu="1", mem="2Gi",
             node_affinity=[{"key": P.L.INSTANCE_GPU_COUNT,
                             "operator": "Gt", "values": ["0"]}])
    settle(sim)
    assert {c.nodepool for c in sim.store.nodeclaims.values()} == \
        {"heavy", "light"}


def sc_limits(P, sim):
    add_pods(P, sim, 100, cpu="1", mem="1Gi")
    sim.engine.run_for(30)
    assert any(e[2] == "LimitExceeded" for e in sim.store.events)


def sc_registration_timeout(P, sim):
    sim.cloud.config.register_delay = 10**9
    add_pods(P, sim, 3)
    sim.engine.run_for(20)
    first = set(sim.store.nodeclaims)
    sim.engine.run_for(16 * 60, step=30)
    assert first and not (first & set(sim.store.nodeclaims))


def sc_empty_node(P, sim):
    pods = add_pods(P, sim, 20)
    settle(sim)
    for p in pods:
        sim.store.delete_pod(p.namespace, p.name)
    sim.engine.run_until(lambda: not sim.store.nodeclaims, timeout=300)
    assert not sim.store.nodeclaims


def when_empty_pool(P):
    return {"nodepool": P.NodePool(name="default", disruption=P.DisruptionSpec(
        consolidation_policy="WhenEmpty"))}


def sc_when_empty(P, sim):
    add_pods(P, sim, 30)
    settle(sim)
    sim.engine.run_for(300, step=5)
    assert sim.disruption.stats["consolidated"] == 0


def sc_scale_down(P, sim):
    """Mixed sizes, then 70% of the pods leave: emptiness, single-node
    consolidation (kernel A's screen orders the candidates) and the exact
    re-solves behind it."""
    rng = np.random.default_rng(3)
    pods = []
    for i, (c, m) in enumerate(zip(rng.choice(["250m", "500m", "1", "2"], 80),
                                   rng.choice(["512Mi", "1Gi", "2Gi"], 80))):
        pods += add_pods(P, sim, 1, cpu=str(c), mem=str(m), prefix=f"s{i}")
    settle(sim)
    n_before = len(sim.store.nodeclaims)
    for i in rng.permutation(len(pods))[: int(len(pods) * 0.7)]:
        sim.store.delete_pod(pods[i].namespace, pods[i].name)
    sim.engine.run_for(600, step=5)
    assert all_bound(sim)
    assert len(sim.store.nodeclaims) < n_before


def small_nodes_pool(P):
    """Only the "large" size (a few pods a node) and a 50% budget: a
    scale-down leaves many half-used nodes for multi-node consolidation."""
    pool = P.NodePool(name="default", disruption=P.DisruptionSpec(
        budgets=[P.Budget(nodes="50%")]))
    pool.requirements.add(P.Requirement(P.L.INSTANCE_SIZE, P.Operator.IN,
                                        ("large",)))
    return {"nodepool": pool}


def sc_multi_node(P, sim):
    pods = add_pods(P, sim, 30, cpu="500m", mem="512Mi")
    settle(sim)
    n_before = len(sim.store.nodeclaims)
    for i in np.random.default_rng(0).permutation(len(pods))[:18]:
        sim.store.delete_pod(pods[i].namespace, pods[i].name)
    sim.engine.run_for(600, step=5)
    assert all_bound(sim) and len(sim.store.nodeclaims) < n_before
    assert sim.disruption.stats["multi_consolidated"] > 0


def one_a_pass_pool(P):
    return {"nodepool": P.NodePool(name="default", disruption=P.DisruptionSpec(
        budgets=[P.Budget(nodes="1")]))}


def sc_consolidation_order(P, sim):
    """Four waves of mixed pods, half deleted, one disruption a pass: which
    node goes first — the screen's order — decides the end state."""
    rng = np.random.default_rng(0)
    pods = []
    for w in range(4):
        for i in range(int(rng.integers(3, 8))):
            pods += add_pods(P, sim, 1, prefix=f"w{w}-{i}",
                             cpu=str(rng.choice(["500m", "1", "2", "3"])),
                             mem=str(rng.choice(["1Gi", "2Gi", "4Gi"])))
        settle(sim)
    for i in rng.permutation(len(pods))[: len(pods) // 2]:
        sim.store.delete_pod(pods[i].namespace, pods[i].name)
    sim.engine.run_for(400, step=5)
    assert sim.disruption.stats["consolidated"] > 0


def sc_do_not_disrupt(P, sim):
    add_pods(P, sim, 10, annotations={"karpenter.tpu/do-not-disrupt": "true"})
    settle(sim)
    claims = set(sim.store.nodeclaims)
    sim.engine.run_for(400, step=5)
    assert claims <= set(sim.store.nodeclaims)


def zero_budget_pool(P):
    return {"nodepool": P.NodePool(name="default", disruption=P.DisruptionSpec(
        budgets=[P.Budget(nodes="0")]))}


def sc_budget(P, sim):
    pods = add_pods(P, sim, 20)
    settle(sim)
    n = len(sim.store.nodeclaims)
    for p in pods:
        sim.store.delete_pod(p.namespace, p.name)
    sim.engine.run_for(400, step=5)
    assert len(sim.store.nodeclaims) == n


def sc_drift(P, sim):
    add_pods(P, sim, 10)
    settle(sim)
    old = set(sim.store.nodeclaims)
    sim.store.nodeclasses["default"].user_data = "#!/bin/bash\necho new"
    sim.engine.run_for(600, step=5)
    assert all_bound(sim) and not (old & set(sim.store.nodeclaims))


def expiring_pool(P):
    return {"nodepool": P.NodePool(name="default", expire_after=3600.0)}


def sc_expiration(P, sim):
    add_pods(P, sim, 5)
    settle(sim)
    old = set(sim.store.nodeclaims)
    sim.engine.run_for(4000, step=20)
    assert all_bound(sim) and not (old & set(sim.store.nodeclaims))


def sc_spot_interruption(P, sim):
    add_pods(P, sim, 10)
    settle(sim)
    victim = next(iter(sim.store.nodeclaims.values()))
    iid = victim.provider_id.rsplit("/", 1)[-1]
    inst = sim.cloud.instances[iid]
    sim.cloud.send_spot_interruption(iid)
    sim.engine.run_for(60)
    assert victim.name not in sim.store.nodeclaims
    assert sim.catalog.unavailable.is_unavailable(
        inst.instance_type, inst.zone, inst.capacity_type)
    assert sim.engine.run_until(lambda: all_bound(sim), timeout=120)


def sc_leaked_instance(P, sim):
    t = next(iter(sim.cloud.types.values()))
    o = t.offerings[0]
    res = sim.cloud.create_fleet([P.LaunchRequest(
        nodeclaim_name="ghost",
        overrides=[P.LaunchOverride(t.name, o.zone, o.capacity_type,
                                    o.price)])])
    sim.engine.run_for(200, step=10)
    assert sim.cloud.instances[res[0].id].state == "terminated"


def sc_screen_absorbable(P, sim):
    """The screen over the live cluster after most pods left (the
    reference test's direct call), then the loop consolidates."""
    pods = add_pods(P, sim, 40)
    settle(sim)
    cat = sim.solver.tensors(sim.store.nodeclasses["default"])
    for p in pods[:30]:
        sim.store.delete_pod(p.namespace, p.name)
    views = P.build_node_views(sim.store, cat, sim.clock.now())
    enc = P.encode_pods([p for v in views for p in v.pods], cat)
    sig_to_g = {g.representative.constraint_signature(): i
                for i, g in enumerate(enc.groups)}
    counts = np.zeros((len(views), max(enc.G, 1)), np.int32)
    for i, v in enumerate(views):
        for p in v.pods:
            counts[i, sig_to_g[p.constraint_signature()]] += 1
    screen, _ = P.screen(cat, enc, views, counts, **P.extra)
    assert screen.any()
    sim.engine.run_for(300, step=5)
    return screen.tolist()


def sc_chaos(P, sim):
    """kwok-style chaos: periodic instance kills; the state-change events
    drain dead claims, GC reaps orphans, pods reschedule."""
    add_pods(P, sim, 30)
    settle(sim)
    sim.start_chaos(interval=120.0, seed=42)
    sim.engine.run_for(900, step=5)
    sim.stop_chaos()
    assert any(i.state == "terminated" for i in sim.cloud.instances.values())
    assert sim.engine.run_until(lambda: all_bound(sim), timeout=300)


def sc_discovered_capacity(P, sim):
    """Live nodes report less memory than the catalog's estimate: the
    discovered-capacity controller writes it back into the catalog
    (a new epoch), and later solves and screens must see it."""
    pods = add_pods(P, sim, 30, cpu="1", mem="2Gi")
    settle(sim)
    for node in sim.store.nodes.values():
        node.capacity[P.MEMORY] = node.capacity.get(P.MEMORY) * 0.8
    sim.engine.run_for(90, step=5)
    add_pods(P, sim, 30, cpu="1", mem="2Gi", prefix="late")
    settle(sim)
    for p in pods[:20]:
        sim.store.delete_pod(p.namespace, p.name)
    sim.engine.run_for(300, step=5)


SCENARIOS = {
    "500_pods": (sc_500_pods, None),
    "in_flight_claims": (sc_in_flight, None),
    "ice_failover": (sc_ice_failover, None),
    "ice_marks": (sc_ice_marks, None),
    "taints": (sc_taints, tainted_pool),
    "multi_nodepool_weight": (sc_multi_pool,
                              lambda P: {"types": P.small_catalog(8)}),
    "limits": (sc_limits, lambda P: {"nodepool": P.NodePool(
        name="limited", limits=P.Resources.parse({"cpu": "8"}))}),
    "registration_timeout": (sc_registration_timeout, None),
    "empty_node": (sc_empty_node, None),
    "when_empty_policy": (sc_when_empty, when_empty_pool),
    "scale_down_consolidation": (sc_scale_down, None),
    "multi_node_consolidation": (sc_multi_node, small_nodes_pool),
    "consolidation_order": (sc_consolidation_order, one_a_pass_pool),
    "do_not_disrupt": (sc_do_not_disrupt, None),
    "budgets": (sc_budget, zero_budget_pool),
    "drift": (sc_drift, None),
    "expiration": (sc_expiration, expiring_pool),
    "spot_interruption": (sc_spot_interruption, None),
    "leaked_instance": (sc_leaked_instance, None),
    "screen_absorbable": (sc_screen_absorbable, None),
    "chaos_kill_thread": (sc_chaos, None),
    "discovered_capacity": (sc_discovered_capacity, None),
}
# these also run on the "host" and "native" rungs: the ones that reach the
# screen, the exact re-solves, drift, the ICE path and a catalog rewrite
OTHER_RUNGS = ("scale_down_consolidation", "multi_node_consolidation",
               "screen_absorbable", "drift", "ice_failover",
               "discovered_capacity", "multi_nodepool_weight")
CASES = ([(name, "device") for name in SCENARIOS]
         + [(name, rung) for rung in ("host", "native")
            for name in OTHER_RUNGS])


def run(P, name, backend):
    drive, kwargs = SCENARIOS[name]
    _reset_sequences(P)
    kw = dict(kwargs(P) if kwargs is not None else {})
    sim = P.make_sim(backend=backend, **kw, **P.extra)
    return sim, drive(P, sim)


def controller_stats(sim):
    return {c.name: dict(c.stats) for c in sim.engine.controllers
            if hasattr(c, "stats")}


def decisions(sim):
    return [e for e in sim.store.events if e[0] == "disruption"]


def assert_same_run(ref, port):
    assert port_sim.state_hash(port) == ref_state_hash(ref)
    assert ref_state_hash(port) == port_sim.state_hash(port)
    assert decisions(port) == decisions(ref)
    assert controller_stats(port) == controller_stats(ref)
    assert port.store.events == ref.store.events


@pytest.mark.parametrize("name,backend", CASES)
def test_sim_matches_reference(name, backend):
    ref, ref_extra = run(REF, name, backend)
    port, port_extra = run(PORT, name, backend)
    assert port_extra == ref_extra
    assert_same_run(ref, port)


# --- the screen's error contract -------------------------------------------


def _screen_counts(metric):
    return metric.value(from_backend="screen", to_backend="cost-order")


def test_injected_screen_fault_is_metered_like_the_reference(monkeypatch):
    """A dispatch-hook fault at the screen (the reference's seam, the
    port's InjectedFault) degrades the pass to plain cost order: the same
    SOLVER_FALLBACKS{from_backend="screen"} delta, the same screen_errors
    stat and the same end state as the reference."""
    from karpenter_tpu.faults.plan import InjectedFault as RefInjected

    def ref_hook(backend):
        if backend == "screen":
            raise RefInjected("injected screen fault")

    def port_hook(backend):
        if backend == "screen":
            raise port_solver.InjectedFault("injected screen fault")

    monkeypatch.setattr(ref_solver, "_dispatch_fault_hook", ref_hook)
    monkeypatch.setattr(port_solver, "_dispatch_fault_hook", port_hook)
    r0, p0 = _screen_counts(REF_FALLBACKS), _screen_counts(PORT_FALLBACKS)
    ref, _ = run(REF, "scale_down_consolidation", "device")
    r1 = _screen_counts(REF_FALLBACKS)
    port, _ = run(PORT, "scale_down_consolidation", "device")
    p1 = _screen_counts(PORT_FALLBACKS)
    assert p1 - p0 == r1 - r0 > 0
    assert port.disruption.stats["screen_errors"] == r1 - r0
    assert_same_run(ref, port)


def test_kernel_refusal_in_the_screen_raises_out_of_tick(monkeypatch):
    """Kernel A refusing its input inside the loop is not absorbed: it
    raises out of DisruptionController.reconcile and Engine.tick (which
    absorbs only retryable cloud errors), nothing is metered as a screen
    fallback."""
    def refuse(*a, **kw):
        raise RuntimeError("screen_k: nvcc failed for screen_k.cu (exit 1)")

    monkeypatch.setattr(port_consolidate, "screen_k", refuse)
    _reset_sequences(PORT)
    sim = port_sim.make_sim(backend="device", device="cpu")
    pods = add_pods(PORT, sim, 40)
    settle(sim)
    for p in pods[:30]:
        sim.store.delete_pod(p.namespace, p.name)
    p0 = _screen_counts(PORT_FALLBACKS)
    with pytest.raises(RuntimeError, match="^screen_k: nvcc"):
        sim.engine.run_for(300, step=5)
    assert _screen_counts(PORT_FALLBACKS) == p0
    assert "screen_errors" not in sim.disruption.stats


# --- construction ----------------------------------------------------------


def test_armed_optimizer_and_unported_options_raise(monkeypatch):
    """The global optimizer is ported: armed (the default), make_sim
    constructs (its loop is held equal to the reference's in
    test_torch_sim_optimizer.py). The fault plan is ported too (its runs
    are held equal to the reference's in test_torch_chaos.py), and so is
    the warm path: warmpath=True builds it in front of the provisioner
    (its runs are held equal in test_torch_warmpath.py). No option is
    left raising."""
    from karpenter_tpu_torch.faults import FaultPlan
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER")
    assert port_sim.make_sim(device="cpu").disruption is not None
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    plan = FaultPlan(seed=0)
    assert port_sim.make_sim(device="cpu", fault_plan=plan).fault_plan is plan
    warm = port_sim.make_sim(device="cpu", warmpath=True)
    assert warm.warmpath is not None
    assert warm.provisioner.warmpath is warm.warmpath
    assert warm.watchdog.warmpath is warm.warmpath
    assert port_sim.make_sim(device="cpu").disruption is not None


def test_discovered_capacity_never_serves_a_stale_device_catalog(monkeypatch):
    """Every device solve and every screen of a run in which discovered
    capacity rewrites the catalog's memory (a new epoch, a new catalog
    view) is served a device catalog equal to the host view it solves."""
    from karpenter_tpu_torch.ops.encode import align_resources
    seen = {"solve": 0, "screen": 0, "mem": set()}

    def fresh(cat, dcat, R):
        alloc = align_resources(cat.allocatable, R).astype(np.float32)
        assert np.array_equal(dcat.alloc.cpu().numpy()[:, :R], alloc[:, :R])
        assert np.array_equal(dcat.price.cpu().numpy(),
                              cat.price.astype(np.float32))
        assert np.array_equal(dcat.avail.cpu().numpy(), cat.available)
        mem = port_res.resource_axis().index(port_res.MEMORY)
        seen["mem"].add(float(cat.allocatable[:, mem].sum()))

    solve_device = port_solver.solve_device

    def checked_solve(cat, enc, existing=None, dcat=None, **kw):
        fresh(cat, dcat, enc.requests.shape[1])
        seen["solve"] += 1
        return solve_device(cat, enc, existing, dcat=dcat, **kw)

    auto_dcat = port_consolidate._auto_dcat

    def checked_dcat(cat, R, device):
        dcat = auto_dcat(cat, R, device)
        fresh(cat, dcat, R)
        seen["screen"] += 1
        return dcat

    monkeypatch.setattr(port_solver, "solve_device", checked_solve)
    monkeypatch.setattr(port_consolidate, "_auto_dcat", checked_dcat)
    sim, _ = run(PORT, "discovered_capacity", "device")
    disc = next(c for c in sim.engine.controllers
                if c.name == "instancetype.capacity")
    assert disc.stats["discovered"] > 0
    assert seen["solve"] >= 2 and seen["screen"] >= 1
    assert len(seen["mem"]) >= 2  # the memory the solves saw did change
