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
constraint, node) for every pod, exactly. Last, the port's funnel memo:
the records it writes from kept funnels equal those a recorder with an
empty memo writes for the same solve.
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

def _mix(P, seed: int, tag: str = ""):
    """A seeded pod mix that reaches every outcome: placed on new nodes
    (several shapes), placed on existing headroom, unschedulable past
    every type, dropped by the pool's taint, and a zone-pinned group.
    `tag` prefixes every name: the same groups under other pods."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cpus = ("250m", "500m", "1", "2")
    mems = ("256Mi", "1Gi", "2Gi", "4Gi")
    pods = []
    for i in range(24):
        pods.append(P.Pod(name=f"{tag}mix-{i}", requests=P.Resources.parse(
            {"cpu": cpus[int(rng.integers(4))],
             "memory": mems[int(rng.integers(4))]})))
    pods.append(P.Pod(name=f"{tag}giant-0", requests=P.Resources.parse(
        {"cpu": "4000", "memory": "99999Gi"})))
    for i in range(3):
        pods.append(P.Pod(
            name=f"{tag}zoned-{i}", requests=P.Resources.parse(
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
    # the first solve's groups again under other pods: the port's
    # records come from its funnel memo, the reference's are computed
    solver.solve(_mix(P, seed, tag="again-"), pool)
    keys = ([f"default/{p.name}" for p in _mix(P, seed)]
            + [f"default/more-{i}" for i in range(6)]
            + [f"default/{p.name}" for p in _mix(P, seed, tag="again-")])
    return {k: RECORDER.explain(k) for k in keys}, dict(RECORDER.stats)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["device", "native", "host"])
def test_records_equal_the_reference(backend, seed):
    _reset_planes()
    ref, ref_stats = _run("karpenter_tpu", backend, seed)
    since = _funnels_counted({})
    port, port_stats = _run("karpenter_tpu_torch", backend, seed)
    assert _funnels_counted(since)["shared"] > 0  # the memo answered
    assert port_stats == ref_stats
    assert port_stats["solves"] == 3 and port_stats["errors"] == 0
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


# --- the port's funnel memo ------------------------------------------------

def _funnels_counted(since: dict) -> dict:
    """karpenter_tpu_explain_funnels_total by event, less `since`."""
    from karpenter_tpu_torch.metrics import EXPLAIN_FUNNELS
    return {e: EXPLAIN_FUNNELS.value(event=e) - since.get(e, 0.0)
            for e in ("computed", "shared")}


class TestFunnelMemo:
    """Every record the memo answers equals the record a recorder with an
    empty memo writes for the same solve: every field, `solve_seq`
    included, in the same LRU order."""

    def _solver(self, backend="host"):
        from karpenter_tpu_torch.catalog import small_catalog
        from karpenter_tpu_torch.catalog.provider import CatalogProvider
        from karpenter_tpu_torch.ops.facade import Solver
        return Solver(CatalogProvider(lambda: small_catalog()),
                      backend=backend, device="cpu")

    def _pods(self, prefix: str):
        """Twelve pods of four (cpu, memory) groups."""
        from karpenter_tpu_torch.models.pod import Pod
        from karpenter_tpu_torch.models.resources import Resources
        shapes = (("250m", "256Mi"), ("500m", "1Gi"), ("1", "2Gi"),
                  ("2", "4Gi"))
        return [Pod(name=f"{prefix}-{i}", requests=Resources.parse(
            {"cpu": shapes[i % 4][0], "memory": shapes[i % 4][1]}))
            for i in range(12)]

    def _shadowed(self, monkeypatch):
        """RECORDER records every solve as before; each solve is also
        recorded by a recorder with an empty memo at the same solve_seq,
        and the two recorders' records are compared on the spot (the
        encode's arrays may be reused by the next solve). Returns the
        funnel counter's deltas of RECORDER's own record, a solve each."""
        from karpenter_tpu_torch.obs.explain import RECORDER, ExplainRecorder
        RECORDER.reset()
        counted = []
        real = RECORDER.record_solve

        def both(cat, enc, out):
            since = _funnels_counted({})
            real(cat, enc, out)
            counted.append(_funnels_counted(since))
            fresh = ExplainRecorder()
            fresh.stats["solves"] = RECORDER.stats["solves"] - 1
            fresh.record_solve(cat, enc, out)
            assert fresh.stats == RECORDER.stats
            assert fresh._pods
            for (tenant, key), rec in fresh._pods.items():
                assert RECORDER.explain(key, tenant) == rec, key
            assert list(RECORDER._pods)[-len(fresh._pods):] == \
                list(fresh._pods)
        monkeypatch.setattr(RECORDER, "record_solve", both)
        return counted

    @pytest.mark.parametrize("backend", ["host", "device"])
    def test_repeated_groups_share_their_funnels(self, monkeypatch,
                                                 backend):
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.obs.explain import RECORDER
        counted = self._shadowed(monkeypatch)
        solver = self._solver(backend)
        for prefix in ("one", "two", "three"):
            solver.solve(self._pods(prefix), NodePool(name="default"))
        assert len(counted) == 3
        assert counted[0] == {"computed": 4, "shared": 0}
        for c in counted[1:]:
            assert c == {"computed": 0, "shared": 4}
        # the third solve's records hold the first solve's stages list
        assert RECORDER.explain("default/three-0")["funnel"] is \
            RECORDER.explain("default/one-0")["funnel"]
        RECORDER.reset()

    @pytest.mark.parametrize("change", ["price", "daemonset"])
    def test_a_new_catalog_view_computes_its_funnels_again(
            self, monkeypatch, change):
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.models.pod import DaemonSet
        from karpenter_tpu_torch.models.resources import Resources
        from karpenter_tpu_torch.obs.explain import RECORDER
        counted = self._shadowed(monkeypatch)
        solver = self._solver()
        pool = NodePool(name="default")
        kw = {}
        solver.solve(self._pods("before"), pool)
        token = solver.tensors(None).cache_token
        if change == "price":
            # the spot price of a group's cheapest type, in every zone,
            # far above every other offering's
            chosen = RECORDER.explain("default/before-3")["funnel"][-1][
                "chosen"]
            assert chosen["capacity_type"] == "spot"
            solver.catalog.pricing.update_spot(
                {(chosen["instance_type"], z): 100.0
                 for z in solver.tensors(None).zones})
            assert solver.tensors(None).cache_token != token
        else:
            # reserved on every node: the 4-vCPU types no longer fit
            # a 2-vCPU pod
            kw["daemonsets"] = [DaemonSet(name="agent", requests=(
                Resources.parse({"cpu": "3", "memory": "6Gi"})))]
        solver.solve(self._pods("after"), pool, **kw)
        solver.solve(self._pods("again"), pool, **kw)
        assert counted == [{"computed": 4, "shared": 0},
                           {"computed": 4, "shared": 0},
                           {"computed": 0, "shared": 4}]
        before = RECORDER.explain("default/before-3")["funnel"]
        after = RECORDER.explain("default/after-3")["funnel"]
        assert after != before  # the new view's stages, not the old
        RECORDER.reset()

    @pytest.mark.parametrize("row", ["requests", "compat", "allow_zone",
                                     "allow_cap"])
    def test_groups_that_differ_in_one_row_get_their_own_funnels(
            self, monkeypatch, row):
        from karpenter_tpu_torch.models import labels as L
        from karpenter_tpu_torch.models.nodepool import NodePool
        from karpenter_tpu_torch.models.pod import Pod
        from karpenter_tpu_torch.models.resources import Resources
        from karpenter_tpu_torch.ops.encode import encode_pods
        term = {"compat": (L.INSTANCE_TYPE, "NotIn", ["c5.large"]),
                "allow_zone": (L.ZONE, "In", ["zone-b"]),
                "allow_cap": (L.CAPACITY_TYPE, "In", ["on-demand"])}

        def pod(name, other):
            mem = "1025Mi" if other and row == "requests" else "1Gi"
            aff = ([dict(zip(("key", "operator", "values"), term[row]))]
                   if other and row in term else [])
            return Pod(name=name, requests=Resources.parse(
                {"cpu": "500m", "memory": mem}), node_affinity=aff)
        counted = self._shadowed(monkeypatch)
        solver = self._solver()
        # the two groups' encoded rows differ in `row` alone
        enc = encode_pods([pod("a", False), pod("b", True)],
                          solver.tensors(None))
        assert enc.G == 2
        differ = [name for name in ("requests", "compat", "allow_zone",
                                    "allow_cap")
                  if (getattr(enc, name)[0] != getattr(enc, name)[1]).any()]
        assert differ == [row]
        pool = NodePool(name="default")
        solver.solve([pod("base", False)], pool)
        solver.solve([pod("other", True)], pool)
        assert counted == [{"computed": 1, "shared": 0},
                           {"computed": 1, "shared": 0}]

    def _direct(self, n_groups=4):
        """An encode against the generated catalog (no cache_token) and
        an output that leaves every pod unschedulable, so a record
        touches every group."""
        from karpenter_tpu_torch.catalog import generate_catalog
        from karpenter_tpu_torch.models.pod import Pod
        from karpenter_tpu_torch.models.resources import Resources
        from karpenter_tpu_torch.ops.encode import encode_catalog, encode_pods
        from karpenter_tpu_torch.ops.facade import SolveOutput
        cat = encode_catalog(generate_catalog())
        pods = [Pod(name=f"d-{i}", requests=Resources.parse(
            {"cpu": f"{250 * (1 + i % n_groups)}m", "memory": "512Mi"}))
            for i in range(2 * n_groups)]
        enc = encode_pods(pods, cat)
        assert enc.G == n_groups
        out = SolveOutput([], {}, [f"default/{p.name}" for p in pods])
        return cat, enc, out

    def test_a_view_without_a_token_is_never_kept(self):
        from karpenter_tpu_torch.obs.explain import ExplainRecorder
        cat, enc, out = self._direct()
        assert cat.cache_token is None
        rec = ExplainRecorder()
        for _ in range(2):
            since = _funnels_counted({})
            rec.record_solve(cat, enc, out)
            assert _funnels_counted(since) == {"computed": 4, "shared": 0}
        assert not rec._funnels and not rec._views
        assert rec.stats["errors"] == 0

    def test_a_token_on_other_content_names_another_view(self):
        """Two facades' fresh providers can stamp one token on different
        catalogs: the content decides, not the token."""
        from dataclasses import replace

        from karpenter_tpu_torch.obs.explain import ExplainRecorder
        cat, enc, out = self._direct()
        cat.cache_token = ("view",)
        rec = ExplainRecorder()
        rec.record_solve(cat, enc, out)
        first = rec.explain("default/d-0")["funnel"]
        dearer = replace(cat, price=cat.price * 2)
        since = _funnels_counted({})
        rec.record_solve(dearer, enc, out)
        assert _funnels_counted(since) == {"computed": 4, "shared": 0}
        second = rec.explain("default/d-0")["funnel"]
        assert second[-1]["chosen"]["price"] == pytest.approx(
            2 * first[-1]["chosen"]["price"])
        fresh = ExplainRecorder()
        fresh.stats["solves"] = 1
        fresh.record_solve(dearer, enc, out)
        assert fresh.explain("default/d-0") == rec.explain("default/d-0")

    def test_reset_empties_the_memo(self):
        from karpenter_tpu_torch.obs.explain import ExplainRecorder
        cat, enc, out = self._direct()
        cat.cache_token = ("view",)
        rec = ExplainRecorder()
        rec.record_solve(cat, enc, out)
        assert len(rec._funnels) == 4 and len(rec._views) == 1
        rec.reset()
        assert not rec._funnels and not rec._views
        since = _funnels_counted({})
        rec.record_solve(cat, enc, out)
        assert _funnels_counted(since) == {"computed": 4, "shared": 0}

    def test_the_memo_trims_the_least_recent_first(self):
        from karpenter_tpu_torch.obs.explain import ExplainRecorder, _exact
        from karpenter_tpu_torch.ops.facade import SolveOutput
        cat, enc, out = self._direct(n_groups=6)
        cat.cache_token = ("view",)
        rec = ExplainRecorder()
        rec.MAX_FUNNELS = 4
        rec.record_solve(cat, enc, out)
        group_of = {f"{p.namespace}/{p.name}": gi
                    for gi, grp in enumerate(enc.groups) for p in grp.pods}
        # the record touches the groups in its pods' order, d-0 to d-5
        order = [group_of[f"default/d-{i}"] for i in range(6)]

        def kept():
            return [next(g for g in range(6) if k[1:] == tuple(
                _exact(a[g]) for a in (enc.requests, enc.compat,
                                       enc.allow_zone, enc.allow_cap)))
                for k in rec._funnels]

        def touch(i):
            since = _funnels_counted({})
            rec.record_solve(cat, enc, SolveOutput([], {},
                                                   [f"default/d-{i}"]))
            return _funnels_counted(since)
        assert kept() == order[2:]
        assert touch(2) == {"computed": 0, "shared": 1}  # a hit refreshes
        assert kept() == order[3:] + order[2:3]
        assert touch(0) == {"computed": 1, "shared": 0}
        assert kept() == order[4:] + [order[2], order[0]]

    def test_threads_share_the_memo(self):
        """The federation server records from more than one thread: under
        a churning memo (two views, a bound of 4, six groups) every
        record still equals a fresh recorder's and the bound holds."""
        import sys
        import threading
        from dataclasses import replace

        from karpenter_tpu_torch.obs.explain import ExplainRecorder
        cat, enc, out = self._direct(n_groups=6)
        views = [replace(cat, cache_token=("a",)),
                 replace(cat, price=cat.price * 2, cache_token=("b",))]
        want = []
        for view in views:
            fresh = ExplainRecorder()
            fresh.record_solve(view, enc, out)
            want.append({k: (r["funnel"], r["binding_constraint"])
                         for (_, k), r in fresh._pods.items()})
        rec = ExplainRecorder()
        rec.MAX_FUNNELS = 4

        def work(i):
            for n in range(30):
                view = n % 2 if i % 2 else 1 - n % 2
                rec.record_solve(views[view], enc, out)
        saved = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(saved)
        assert rec.stats["errors"] == 0
        assert len(rec._funnels) <= 4
        # one more record of each view, after the churn, from the memo
        for view, expect in zip(views, want):
            rec.record_solve(view, enc, out)
            got = {k: (r["funnel"], r["binding_constraint"])
                   for (_, k), r in rec._pods.items()}
            assert got == expect, view.cache_token
