"""The port's provisioning solve held against the JAX reference.

The same encoded input (the reference's encode, carried across with
`karpenter_tpu_torch.convert`) goes through the reference's `_solve_onebuf`
on JAX-CPU and through the port's solve on the CPU, where the group scan
runs its plain PyTorch version. The packed int32 result vectors must be
equal element for element; the port's decoded SolveResult must agree node
for node with both packages' `solve_host`, and pass `validate_solution`.
"""

import dataclasses
import random

import numpy as np
import pytest

import jax.numpy as jnp

from karpenter_tpu.catalog import GeneratorConfig, generate_catalog, small_catalog
from karpenter_tpu.models import labels as L
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models.pod import Pod, PodAffinityTerm, TopologySpreadConstraint
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.binpack import VirtualNode, solve_host, split_spread_groups
from karpenter_tpu.ops.encode import encode_catalog, encode_pods

from karpenter_tpu_torch import convert
from karpenter_tpu_torch.ops import binpack as port_binpack
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.ops.solve_scan import pack_solution


@pytest.fixture(scope="module", autouse=True)
def _rotate_reference_intern_table():
    """Empty the reference's signature intern table after this module (a
    rotation; see test_torch_encode.py)."""
    yield
    ref_pod._sig_intern.clear()


def mk_pods(n, cpu="500m", mem="1Gi", prefix="p", **kw):
    return [Pod(name=f"{prefix}-{i}",
                requests=Resources.parse({"cpu": cpu, "memory": mem}), **kw)
            for i in range(n)]


def _random_pods(rng: random.Random, n: int):
    """The reference fuzz's pod mix (tests/test_solver_fuzz.py)."""
    cpus = ["100m", "250m", "500m", "1", "2", "3", "7"]
    mems = ["128Mi", "512Mi", "1Gi", "2Gi", "5Gi", "12Gi"]
    pods = []
    for i in range(n):
        kw = dict(requests=Resources.parse({
            "cpu": rng.choice(cpus), "memory": rng.choice(mems)}))
        r = rng.random()
        if r < 0.15:
            kw["node_selector"] = {
                L.ZONE: rng.choice(["zone-a", "zone-b", "zone-c"])}
        elif r < 0.25:
            kw["node_affinity"] = [{
                "key": L.INSTANCE_FAMILY, "operator": "In",
                "values": tuple(rng.sample(
                    ["m5", "c5", "r5", "m6", "c6"], rng.randrange(1, 4)))}]
        elif r < 0.32:
            kw["labels"] = {"app": f"g{rng.randrange(4)}"}
            kw["affinity_terms"] = [PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": kw["labels"]["app"]}, anti=True)]
        pods.append(Pod(name=f"f{i}", **kw))
    return pods


def _poke_availability(rng: random.Random, cat):
    T, Z, C = cat.available.shape
    for _ in range(rng.randrange(0, 30)):
        cat.available[rng.randrange(T), rng.randrange(Z),
                      rng.randrange(C)] = False
    if rng.random() < 0.3:
        cat.available[:, rng.randrange(Z), rng.randrange(C)] = False


def ref_packed(cat, enc, existing, st):
    """The reference's single-device `_solve_onebuf` call, with its input
    preparation as in karpenter_tpu.ops.solver._solve_device_impl, at the
    port's statics."""
    R = enc.requests.shape[1]
    Gp, n_max, k_max, cols = st["Gp"], st["n_max"], st["k_max"], st["cols"]
    dcat = ref_solver.device_catalog(cat, R)
    gbuf = jnp.asarray(ref_solver._pack_groups(
        *ref_solver._group_inputs(enc, Gp), list(cols)))
    conflict = (jnp.asarray(ref_solver._pad_to(
        ref_solver._pad_to(enc.conflict, Gp, 0), Gp, 1))
        if st["track_conflicts"] else None)
    n_ex = len(existing)
    nbuf = prior = banned = None
    if n_ex:
        nt = np.zeros(n_max, np.int32)
        cum = np.zeros((n_max, R), np.float32)
        zm = np.zeros((n_max, cat.Z), bool)
        cm = np.zeros((n_max, cat.C), bool)
        op = np.zeros(n_max, bool)
        for i, n in enumerate(existing):
            nt[i], cum[i, :len(n.cum)] = n.type_idx, n.cum
            zm[i], cm[i], op[i] = n.zone_mask, n.cap_mask, True
        nbuf = jnp.asarray(ref_solver._pack_nodes(nt, cum, zm, cm, op,
                                                  list(cols)))
        if any(n.prior_by_group for n in existing):
            p = np.zeros((Gp, n_max), np.int32)
            for i, n in enumerate(existing):
                for g, c in n.prior_by_group.items():
                    if g < Gp:
                        p[g, i] = c
            prior = jnp.asarray(p)
        if any(n.banned_groups is not None for n in existing):
            b = np.zeros((Gp, n_max), bool)
            for i, n in enumerate(existing):
                if n.banned_groups is not None:
                    b[: len(n.banned_groups), i] = n.banned_groups
            banned = jnp.asarray(b)
    return np.asarray(ref_solver._solve_onebuf(
        dcat.alloc, dcat.price, dcat.avail, gbuf, prior, banned, conflict,
        dcat.ovh_z if st["zone_ovh"] else None, nbuf, n_max=n_max,
        k_max=k_max, cols=tuple(cols), track_conflicts=st["track_conflicts"],
        zone_ovh=st["zone_ovh"]))


def _same(a, b, what):
    assert len(a.nodes) == len(b.nodes), (what, len(a.nodes), len(b.nodes))
    for i, (x, y) in enumerate(zip(a.nodes, b.nodes)):
        assert x.type_idx == y.type_idx, f"{what} node {i}: type"
        assert x.pods_by_group == y.pods_by_group, f"{what} node {i}: takes"
        assert (np.asarray(x.zone_mask) == np.asarray(y.zone_mask)).all()
        assert (np.asarray(x.cap_mask) == np.asarray(y.cap_mask)).all()
        assert np.allclose(x.cum, y.cum, atol=1e-3), f"{what} node {i}: cum"
        assert x.existing_name == y.existing_name
    assert a.unschedulable == b.unschedulable, what
    assert a.launches == b.launches, what


def check(cat, enc, existing=None, n_max=None):
    """Packed vector equal to the reference; SolveResult equal to both
    host oracles and clean under validate_solution. Returns the port's
    result."""
    existing = existing or []
    pcat = convert.catalog_from_arrays(vars(cat))
    # arrays only: the port never sees the reference's Pod objects
    penc = convert.pods_from_arrays(
        {k: v for k, v in vars(enc).items() if k != "groups"})
    pex = convert.nodes_from_arrays(vars(n) for n in existing)
    got, st = port_solver.solve_packed(pcat, penc, pex, n_max=n_max,
                                       device="cpu")
    want = ref_packed(cat, enc, existing, st)
    np.testing.assert_array_equal(got, want)
    d = port_solver.solve_device(pcat, penc, pex, n_max=n_max, device="cpu")
    assert not port_binpack.validate_solution(pcat, penc, d), \
        port_binpack.validate_solution(pcat, penc, d)[:5]
    _same(solve_host(cat, enc, existing or None), d, "reference host vs port")
    _same(port_binpack.solve_host(pcat, penc, pex or None), d,
          "port host vs port")
    return d


@pytest.fixture(scope="module")
def small():
    return encode_catalog(small_catalog())


def _existing_8xl(cat, **kw):
    t = next(i for i, n in enumerate(cat.names) if n.endswith("8xlarge"))
    return VirtualNode(type_idx=t, zone_mask=np.ones(cat.Z, bool),
                       cap_mask=np.ones(cat.C, bool),
                       cum=np.zeros(len(cat.resources), np.float32),
                       existing_name="inflight-1", **kw)


# --- TestGoldenAgreement inputs (tests/test_solver.py) ---

def _golden_cases(cat):
    anti = [PodAffinityTerm(topology_key="kubernetes.io/hostname",
                            label_selector={"app": "x"}, anti=True)]
    return {
        "single_group": mk_pods(100),
        "multi_group_heterogeneous": (
            mk_pods(40, "250m", "512Mi", "s") + mk_pods(25, "2", "4Gi", "l")
            + mk_pods(10, "4", "8Gi", "xl") + mk_pods(30, "1", "16Gi", "mem")),
        "constrained_groups": (
            mk_pods(20, "1", "2Gi", "a",
                    node_selector={L.INSTANCE_FAMILY: "m5"})
            + mk_pods(15, "1", "2Gi", "b",
                      node_affinity=[{"key": L.CAPACITY_TYPE,
                                      "operator": "In", "values": ["spot"]}])
            + mk_pods(10, "500m", "1Gi", "c",
                      node_selector={L.ZONE: "zone-b"})),
        "unschedulable": mk_pods(5, "1000", "1Gi", "huge"),
        "anti_affinity_one_per_node": mk_pods(
            7, "250m", "512Mi", "aa", labels={"app": "x"},
            affinity_terms=anti),
    }


@pytest.mark.parametrize("case", ["single_group", "multi_group_heterogeneous",
                                  "constrained_groups", "unschedulable",
                                  "anti_affinity_one_per_node"])
def test_golden_agreement(small, case):
    enc = encode_pods(_golden_cases(small)[case], small)
    check(small, enc)


def test_golden_zone_spread_split(small):
    pods = mk_pods(9, "250m", "512Mi", "sp",
                   topology_spread=[TopologySpreadConstraint(
                       topology_key=L.ZONE, max_skew=1)])
    enc = split_spread_groups(encode_pods(pods, small), small)
    d = check(small, enc)
    assert len({zi for _, zi, _, _ in d.launches}) == 3


def test_golden_existing_nodes_filled_first(small):
    enc = encode_pods(mk_pods(10), small)
    d = check(small, enc, [_existing_8xl(small)])
    assert len(d.nodes) == 1 and d.nodes[0].pod_count() == 10


def test_golden_full_catalog_multi_constraint():
    cat = encode_catalog(generate_catalog())
    pods = (mk_pods(300, "500m", "1Gi", "w")
            + mk_pods(100, "2", "4Gi", "x",
                      node_affinity=[{"key": L.INSTANCE_CATEGORY,
                                      "operator": "In", "values": ["c", "m"]}])
            + mk_pods(50, "1", "8Gi", "y",
                      node_affinity=[{"key": L.INSTANCE_SIZE,
                                      "operator": "NotIn",
                                      "values": ["metal"]}])
            + mk_pods(8, "4", "16Gi", "g",
                      node_affinity=[{"key": L.INSTANCE_GPU_COUNT,
                                      "operator": "Gt", "values": ["0"]}]))
    d = check(cat, encode_pods(pods, cat))
    assert not d.unschedulable


# --- TestCrossGroupAntiAffinity inputs ---

def _anti(sel):
    return [PodAffinityTerm(topology_key="kubernetes.io/hostname",
                            label_selector=sel, anti=True)]


def test_conflicting_groups_never_colocate(small):
    pods = (mk_pods(4, "1", "2Gi", "db", labels={"tier": "db"},
                    affinity_terms=_anti({"tier": "web"}))
            + mk_pods(6, "500m", "1Gi", "web", labels={"tier": "web"}))
    enc = encode_pods(pods, small)
    assert enc.conflict is not None
    d = check(small, enc)
    for node in d.nodes:
        tiers = {enc.groups[g].representative.labels["tier"]
                 for g, c in node.pods_by_group.items() if c}
        assert tiers != {"db", "web"}


def test_resident_pods_repel_new_groups(small):
    enc = encode_pods(mk_pods(2, "250m", "512Mi", "nx", labels={"app": "x"}),
                      small)
    vn = _existing_8xl(small, banned_groups=np.ones(enc.G, bool))
    d = check(small, enc, [vn])
    assert d.nodes[0].pod_count() == 0


# --- TestReviewFindings inputs ---

def test_zero_request_pods_no_overflow(small):
    pods = [Pod(name=f"z-{i}", requests=Resources({"pods": 1.0}))
            for i in range(300)]
    d = check(small, encode_pods(pods, small))
    assert sum(n.pod_count() for n in d.nodes) == 300


def test_all_zero_request_pods(small):
    """Pods requesting nothing at all: k_cap is BIG on every node."""
    pods = [Pod(name=f"e-{i}", requests=Resources()) for i in range(50)]
    check(small, encode_pods(pods, small))


def test_anti_affinity_across_reconciles(small):
    pods = mk_pods(3, "250m", "512Mi", "aa", labels={"app": "x"},
                   affinity_terms=_anti({"app": "x"}))
    enc = encode_pods(pods, small)
    d = check(small, enc, [_existing_8xl(small, prior_by_group={0: 1})])
    assert d.nodes[0].pods_by_group.get(0, 0) == 0 and len(d.nodes) == 4


def test_existing_pods_by_group_not_carried(small):
    enc = encode_pods(mk_pods(4), small)
    d = check(small, enc, [_existing_8xl(small, pods_by_group={99: 7})])
    assert 99 not in d.nodes[0].pods_by_group


def test_oversize_cum_asserts_clearly(small):
    enc = convert.pods_from_arrays(vars(encode_pods(mk_pods(2), small)))
    pcat = convert.catalog_from_arrays(vars(small))
    bad = convert.nodes_from_arrays([dict(
        type_idx=0, zone_mask=np.ones(small.Z, bool),
        cap_mask=np.ones(small.C, bool), cum=np.zeros(99, np.float32),
        existing_name="x")])
    with pytest.raises(AssertionError, match="resource axis"):
        port_solver.solve_device(pcat, enc, bad, device="cpu")


def test_explicit_small_n_max_regrows_sparse_budget(small):
    pods = [Pod(name=f"m-{i}", requests=Resources.parse(
        {"cpu": f"{10 + i}m", "memory": "64Mi"})) for i in range(40)]
    enc = encode_pods(pods, small)
    d = check(small, enc, n_max=64)
    assert sum(n.pod_count() for n in d.nodes) == 40


def _small_n_max_pods(kind):
    if kind == "small_n_max":   # test_explicit_small_n_max_regrows_sparse_budget
        return [Pod(name=f"m-{i}", requests=Resources.parse(
            {"cpu": f"{10 + i}m", "memory": "64Mi"})) for i in range(40)]
    # 200 one-pod groups on a few nodes: nnz 200 > the first k_max 128
    return [Pod(name=f"w-{i}", requests=Resources.parse(
        {"cpu": f"{10 + i}m", "memory": "64Mi"})) for i in range(200)]


@pytest.mark.parametrize("kind", ["small_n_max", "nnz_past_k_max"])
def test_sparse_budget_regrow_scans_once(small, kind, monkeypatch):
    """One solve_device scans once per node budget: when nnz passes the
    sparse budget it re-packs the same scan output at a larger k_max
    instead of scanning again, and the result still equals the
    reference's."""
    enc = encode_pods(_small_n_max_pods(kind), small)
    pcat = convert.catalog_from_arrays(vars(small))
    penc = convert.pods_from_arrays(
        {k: v for k, v in vars(enc).items() if k != "groups"})
    got, st = port_solver.solve_packed(pcat, penc, n_max=64, device="cpu")
    assert (got[2] > st["k_max"]) == (kind == "nnz_past_k_max")
    calls = []
    real = port_solver.solve_scan

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(port_solver, "solve_scan", counted)
    d = port_solver.solve_device(pcat, penc, n_max=64, device="cpu")
    assert len(calls) == 1
    monkeypatch.undo()
    _same(solve_host(small, enc), d, "reference host vs port")
    assert sum(n.pod_count() for n in d.nodes) == enc.counts.sum()
    check(small, enc, n_max=64)


def test_node_budget_regrow():
    """An explicit budget below the solve's node count is not regrown
    (the caller fixed it); the auto budget regrows until nothing spills."""
    cat = encode_catalog(small_catalog())
    enc = encode_pods(mk_pods(40, "2", "4Gi", "b", labels={"app": "y"},
                              affinity_terms=_anti({"app": "y"})), cat)
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(vars(enc))
    tight = port_solver.solve_device(pcat, penc, n_max=8, device="cpu")
    assert len(tight.nodes) == 8 and sum(tight.unschedulable.values()) == 32
    got, st = port_solver.solve_packed(pcat, penc, n_max=8, device="cpu")
    np.testing.assert_array_equal(got, ref_packed(cat, enc, [], st))
    assert got[1] == 1  # the overflow flag


# --- resumed solve with prior and banned groups on existing nodes ---

def test_resumed_solve_prior_and_banned():
    cat = encode_catalog(generate_catalog(GeneratorConfig(
        families=["m5", "c5", "r5"])))
    rng = random.Random(5)
    base = solve_host(cat, encode_pods(_random_pods(rng, 120), cat))
    enc = encode_pods(_random_pods(rng, 150), cat)
    existing = []
    for i, n in enumerate(base.nodes[:12]):
        n.existing_name = f"n{i}"
        if i % 3 == 0:
            n.prior_by_group = {g: 1 for g in range(0, enc.G, 2)}
        if i % 4 == 1:
            n.banned_groups = np.arange(enc.G) % 3 == 0
        existing.append(n)
    check(cat, enc, existing)


# --- zone-varying daemonset overhead ---

@pytest.mark.parametrize("seed", range(2))
def test_zone_overhead_catalog(seed):
    base = encode_catalog(generate_catalog(GeneratorConfig(
        families=["m5", "c5", "r5", "c6"])))
    rng = np.random.default_rng(seed)
    zovh = np.zeros((base.T, base.Z, base.allocatable.shape[1]), np.float32)
    zovh[:, 0, 0] = np.float32(0.5)                       # cpu in zone-a
    zovh[:, 1, 1] = rng.choice([256.0, 512.0], base.T).astype(np.float32)
    cat = dataclasses.replace(base, zone_overhead=zovh)
    pods = _random_pods(random.Random(seed), 200)
    enc = encode_pods(pods, cat)
    d = check(cat, enc)
    assert d.nodes


# --- the reference fuzz seeds ---

@pytest.mark.parametrize("seed", range(8))
def test_three_way_agreement_random(seed):
    rng = random.Random(seed * 7919 + 13)
    cat = encode_catalog(generate_catalog(GeneratorConfig(
        families=rng.sample(["m5", "c5", "r5", "m6", "c6", "r6", "t3"], 4))))
    _poke_availability(rng, cat)
    pods = _random_pods(rng, rng.randrange(100, 400))
    check(cat, encode_pods(pods, cat))


@pytest.mark.parametrize("seed", range(4))
def test_resume_agreement_random(seed):
    rng = random.Random(seed * 104729 + 7)
    cat = encode_catalog(generate_catalog(GeneratorConfig(
        families=["m5", "c5", "r5"])))
    base = solve_host(cat, encode_pods(_random_pods(rng, 120), cat))
    existing = list(base.nodes[:10])
    for i, n in enumerate(existing):
        n.existing_name = f"n{i}"
    enc2 = encode_pods(_random_pods(rng, 150), cat)
    check(cat, enc2, existing)


# --- the packing layout itself ---

def test_pack_solution_matches_nonzero_fill():
    """idx/vals follow jnp.nonzero(size=k_max, fill_value=0) and a gather:
    ascending flat order, fill slots repeat flat[0], nnz counts past
    k_max."""
    import torch
    rng = np.random.default_rng(0)
    takes = rng.integers(0, 3, (5, 7)).astype(np.int32)
    takes[0, 0] = 2
    flat = takes.reshape(-1)
    for k_max in (4, int((flat > 0).sum()), 64):
        got = pack_solution(torch.zeros(7, dtype=torch.int32),
                            torch.as_tensor(takes),
                            torch.zeros(5, dtype=torch.int32),
                            torch.tensor(3), torch.tensor(False),
                            k_max).numpy()
        (idx,) = jnp.nonzero(jnp.asarray(flat), size=k_max, fill_value=0)
        assert got[2] == (flat > 0).sum()
        np.testing.assert_array_equal(got[3 + 5 + 7: 3 + 5 + 7 + k_max], idx)
        np.testing.assert_array_equal(got[3 + 5 + 7 + k_max:],
                                      flat[np.asarray(idx)])


def test_mesh_is_not_ported(small):
    pcat = convert.catalog_from_arrays(vars(small))
    penc = convert.pods_from_arrays(vars(encode_pods(mk_pods(3), small)))
    with pytest.raises(NotImplementedError, match="not ported"):
        port_solver.solve_device(pcat, penc, device="cpu", mesh=object())
