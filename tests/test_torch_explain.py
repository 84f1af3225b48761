"""The port's explain recorder (`karpenter_tpu_torch/obs/explain.py`) held
against the JAX reference's.

First the six cases of the reference's
`tests/test_observatory.py::TestExplain`, rerun through the port: the
funnel, chosen offering and runner-up of a placed pod; the stage that
eliminates an unschedulable one; the throttle trail that survives a later
placement; the fleet client's throttle notes; the skipping of oversize
solves; and the `/debug/explain` route. Then the records themselves: the
same pods through both packages' `Solver.solve` on each rung must leave
equal records (outcome, funnel counts, chosen offering, runner-up, binding
constraint, node) for every pod, exactly.
"""

from __future__ import annotations

import json

import pytest

from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops.encode import encode_catalog

from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.utils.clock import FakeClock


def _reset_planes() -> None:
    """Both packages' delta and resident planes and explain recorders
    start empty: memo keys hold id(facade), and a reused id must not meet
    a dead facade's entry in one package and not in the other."""
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
    """Both resource axes get the same columns; afterwards the reference's
    intern table and both packages' planes are reset (ROADMAP §3's
    test-order hazard)."""
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    from karpenter_tpu.integrity import INTEGRITY
    ref_pod._sig_intern.clear()
    _reset_planes()
    INTEGRITY.reset()


class TestExplain:
    def _solver(self):
        from karpenter_tpu_torch.catalog import small_catalog
        from karpenter_tpu_torch.catalog.provider import CatalogProvider
        from karpenter_tpu_torch.ops.facade import Solver
        return Solver(CatalogProvider(lambda: small_catalog()),
                      backend="host", device="cpu")

    def _pods(self, n=4, cpu="500m", mem="1Gi", prefix="xp"):
        from karpenter_tpu_torch.models.pod import Pod
        from karpenter_tpu_torch.models.resources import Resources
        return [Pod(name=f"{prefix}-{i}", requests=Resources.parse(
            {"cpu": cpu, "memory": mem})) for i in range(n)]

    def test_placed_pod_has_funnel_chosen_and_runner_up(self):
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.obs.explain import FUNNEL_STAGES, RECORDER
        RECORDER.reset()
        solver = self._solver()
        out = solver.solve(self._pods(4), NodePool(name="default"))
        assert out.launches
        rec = RECORDER.explain("default/xp-0")
        assert rec is not None and rec["outcome"] == "placed_new_node"
        assert rec["chosen"]["instance_type"] == \
            out.launches[0].instance_type
        stages = [s["stage"] for s in rec["funnel"]]
        assert stages == list(FUNNEL_STAGES)
        # counts only narrow down the funnel
        offs = [s["offerings"] for s in rec["funnel"][:-1]]
        assert offs == sorted(offs, reverse=True)
        assert rec["funnel"][0]["types"] > 0
        assert rec["binding_constraint"]
        if rec["runner_up"] is not None:
            # the runner-up is a different offering (it may be CHEAPER
            # per hour — the solver commits the cost-per-SLOT argmin)
            assert (rec["runner_up"]["instance_type"],
                    rec["runner_up"]["zone"],
                    rec["runner_up"]["capacity_type"]) != (
                rec["chosen"]["instance_type"], rec["chosen"]["zone"],
                rec["chosen"]["capacity_type"])

    def test_unschedulable_pod_binds_at_eliminating_stage(self):
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.obs.explain import RECORDER
        RECORDER.reset()
        solver = self._solver()
        giant = self._pods(1, cpu="4000", mem="99999Gi", prefix="giant")
        out = solver.solve(giant, NodePool(name="default"))
        assert out.unschedulable == ["default/giant-0"]
        rec = RECORDER.explain("default/giant-0")
        assert rec["outcome"] == "unschedulable"
        assert rec["binding_constraint"] == "resource_fit"
        assert rec["funnel"][-1]["offerings"] == 0

    def test_throttle_trail_survives_later_placement(self):
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.obs.explain import RECORDER
        RECORDER.reset()
        solver = self._solver()
        pods = self._pods(2, prefix="thr")
        RECORDER.note_throttle("default",
                               [f"default/{p.name}" for p in pods])
        rec = RECORDER.explain("default/thr-0")
        assert rec["outcome"] == "throttled"
        assert rec["binding_constraint"] == "fleet_inflight_cap"
        assert rec["throttles"] == 1
        solver.solve(pods, NodePool(name="default"))
        rec = RECORDER.explain("default/thr-0")
        assert rec["outcome"] == "placed_new_node"
        assert rec["throttles"] == 1  # the trail survives placement

    def test_fleet_client_notes_throttles(self):
        from karpenter_tpu_torch.catalog import small_catalog
        from karpenter_tpu_torch.catalog.provider import CatalogProvider
        from karpenter_tpu_torch.fleet.service import (SolverService,
                                                       SolverServiceBusy)
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.obs.explain import RECORDER
        RECORDER.reset()
        svc = SolverService(FakeClock(), inflight_cap=1, device="cpu")
        client = svc.register("busy", CatalogProvider(
            lambda: small_catalog()))
        pool = NodePool(name="default")
        client.solve(self._pods(2, prefix="ok"), pool)
        with pytest.raises(SolverServiceBusy):
            client.solve(self._pods(2, prefix="nope"), pool)
        rec = RECORDER.explain("default/nope-0", tenant="busy")
        assert rec["outcome"] == "throttled"
        assert RECORDER.tenant_pods("busy", outcome="throttled")
        # the deferred submission path notes its refusals too
        with pytest.raises(SolverServiceBusy):
            client.solve_async(self._pods(1, prefix="later"), pool)
        assert RECORDER.explain("default/later-0",
                                tenant="busy")["throttles"] == 1

    def test_oversize_solves_are_skipped(self):
        from karpenter_tpu_torch.obs.explain import RECORDER
        saved = RECORDER.MAX_PODS_PER_SOLVE
        RECORDER.reset()
        try:
            RECORDER.MAX_PODS_PER_SOLVE = 2
            from karpenter_tpu_torch.models.nodepool import NodePool
            solver = self._solver()
            solver.solve(self._pods(5, prefix="big"), NodePool(
                name="default"))
            assert RECORDER.stats["skipped"] == 1
            assert RECORDER.explain("default/big-0") is None
        finally:
            RECORDER.MAX_PODS_PER_SOLVE = saved

    def test_debug_explain_route(self):
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.obs.explain import RECORDER
        from karpenter_tpu_torch.obs.exposition import render
        RECORDER.reset()
        solver = self._solver()
        solver.solve(self._pods(2, prefix="rt"), NodePool(name="default"))
        _, _, body = render("/debug/explain?pod=default/rt-0")
        doc = json.loads(body)
        assert doc["found"] and doc["outcome"] == "placed_new_node"
        _, _, body = render("/debug/explain?pod=default/ghost")
        assert json.loads(body) == {"found": False, "pod": "default/ghost"}
        _, _, body = render("/debug/explain")
        assert "stages" in json.loads(body)


# --- records equal to the reference's -------------------------------------

def _mix(P, seed: int):
    """A seeded pod mix that reaches every outcome: placed on new nodes
    (several shapes), placed on existing headroom, unschedulable past
    every type, dropped by the pool's taint, and a zone-pinned group."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cpus = ("250m", "500m", "1", "2")
    mems = ("256Mi", "1Gi", "2Gi", "4Gi")
    pods = []
    for i in range(24):
        pods.append(P.Pod(name=f"mix-{i}", requests=P.Resources.parse(
            {"cpu": cpus[int(rng.integers(4))],
             "memory": mems[int(rng.integers(4))]})))
    pods.append(P.Pod(name="giant-0", requests=P.Resources.parse(
        {"cpu": "4000", "memory": "99999Gi"})))
    for i in range(3):
        pods.append(P.Pod(
            name=f"zoned-{i}", requests=P.Resources.parse(
                {"cpu": "500m", "memory": "512Mi"}),
            node_affinity=[{"key": P.L.ZONE, "operator": "In",
                            "values": ["zone-b"]}]))
    return pods


def _run(pkg, backend: str, seed: int):
    import importlib

    import numpy as np
    P = type("P", (), {})
    P.Pod = importlib.import_module(f"{pkg}.models.pod").Pod
    P.Resources = importlib.import_module(f"{pkg}.models.resources").Resources
    P.L = importlib.import_module(f"{pkg}.models.labels")
    nodepool = importlib.import_module(f"{pkg}.models.nodepool")
    catalog = importlib.import_module(f"{pkg}.catalog")
    provider = importlib.import_module(f"{pkg}.catalog.provider")
    facade = importlib.import_module(f"{pkg}.ops.facade")
    RECORDER = importlib.import_module(f"{pkg}.obs.explain").RECORDER
    kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    solver = facade.Solver(provider.CatalogProvider(
        lambda: catalog.small_catalog()), backend=backend, **kw)
    pool = nodepool.NodePool(name="default")
    first = solver.solve(_mix(P, seed), pool)
    # a second solve onto the first's launches: existing headroom
    cat = solver.tensors(None)
    binpack = importlib.import_module(f"{pkg}.ops.binpack")
    existing = [binpack.VirtualNode(
        type_idx=cat.name_to_idx[l.instance_type],
        zone_mask=np.array([z == l.zone for z in cat.zones]),
        cap_mask=np.array([c == l.capacity_type for c in cat.captypes]),
        cum=np.zeros(len(cat.resources), np.float32),
        existing_name=f"n{i}") for i, l in enumerate(first.launches)]
    more = [P.Pod(name=f"more-{i}", requests=P.Resources.parse(
        {"cpu": "100m", "memory": "128Mi"})) for i in range(6)]
    solver.solve(more, pool, existing=existing)
    keys = ([f"default/{p.name}" for p in _mix(P, seed)]
            + [f"default/more-{i}" for i in range(6)])
    return {k: RECORDER.explain(k) for k in keys}, dict(RECORDER.stats)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["device", "native", "host"])
def test_records_equal_the_reference(backend, seed):
    _reset_planes()
    ref, ref_stats = _run("karpenter_tpu", backend, seed)
    port, port_stats = _run("karpenter_tpu_torch", backend, seed)
    assert port_stats == ref_stats
    assert port_stats["solves"] == 2 and port_stats["errors"] == 0
    assert port == ref
    outcomes = {r["outcome"] for r in port.values() if r is not None}
    assert {"placed_new_node", "placed_existing_node",
            "unschedulable"} <= outcomes


def test_group_funnel_equals_the_reference():
    """The funnel of every encoded group of the facade's own encode,
    stage by stage."""
    from karpenter_tpu.obs.explain import _group_funnel as ref_funnel
    from karpenter_tpu.ops.encode import encode_pods as ref_encode

    from karpenter_tpu_torch.catalog import generate_catalog as port_catalog
    from karpenter_tpu_torch.models import labels as port_L
    from karpenter_tpu_torch.models.pod import Pod as PortPod
    from karpenter_tpu_torch.models.resources import Resources as PortRes
    from karpenter_tpu_torch.obs.explain import _group_funnel as port_funnel
    from karpenter_tpu_torch.ops.encode import encode_catalog as port_enc_cat
    from karpenter_tpu_torch.ops.encode import encode_pods as port_encode

    from karpenter_tpu.models import labels as ref_L
    from karpenter_tpu.models.pod import Pod as RefPod
    from karpenter_tpu.models.resources import Resources as RefRes

    class R:
        Pod, Resources, L = RefPod, RefRes, ref_L

    class T:
        Pod, Resources, L = PortPod, PortRes, port_L
    ref_cat = encode_catalog(generate_catalog())
    port_cat = port_enc_cat(port_catalog())
    ref_enc = ref_encode(_mix(R, 3), ref_cat)
    port_enc = port_encode(_mix(T, 3), port_cat)
    assert port_enc.G == ref_enc.G > 1
    for g in range(port_enc.G):
        assert port_funnel(port_cat, port_enc, g) == \
            ref_funnel(ref_cat, ref_enc, g), g
