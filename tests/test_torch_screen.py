"""The port's consolidation screen held against the JAX reference.

Plain `screen_k` against the reference's Pallas kernel run in interpret
mode, at atol 0; the port's `consolidation_screen` (device="cpu") against
the reference's on JAX-CPU; and the screen's no-false-negative property on
the port. Kernel A itself runs only on the card: its tests are in
test_torch_kernels.py.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_tpu.catalog import GeneratorConfig, generate_catalog, small_catalog
from karpenter_tpu.models import labels as L
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models.nodeclaim import NodeClaim
from karpenter_tpu.models.pod import Pod
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops.binpack import solve_host
from karpenter_tpu.ops.consolidate import consolidation_screen as ref_screen
from karpenter_tpu.ops.encode import encode_catalog, encode_pods
from karpenter_tpu.ops.pallas_screen import screen_k as ref_screen_k
from karpenter_tpu.state.cluster import NodeView as RefNodeView

from karpenter_tpu_torch import convert
from karpenter_tpu_torch.catalog import GeneratorConfig as PGeneratorConfig
from karpenter_tpu_torch.catalog import generate_catalog as p_generate_catalog
from karpenter_tpu_torch.models.pod import Pod as PPod
from karpenter_tpu_torch.models.resources import Resources as PResources
from karpenter_tpu_torch.ops import binpack as port_binpack
from karpenter_tpu_torch.ops.consolidate import NodeView, consolidation_screen
from karpenter_tpu_torch.ops.encode import encode_catalog as p_encode_catalog
from karpenter_tpu_torch.ops.encode import encode_pods as p_encode_pods
from karpenter_tpu_torch.ops.screen_k import screen_k


@pytest.fixture(scope="module", autouse=True)
def _rotate_reference_intern_table():
    """Empty the reference's signature intern table after this module (a
    rotation; see test_torch_encode.py)."""
    yield
    ref_pod._sig_intern.clear()


def _k_inputs(seed, N, G, R):
    rng = np.random.default_rng(seed)
    head = rng.uniform(-2.0, 12.0, (N, R)).astype(np.float32)
    req = rng.uniform(0.0, 3.0, (G, R)).astype(np.float32)
    req[rng.random((G, R)) < 0.3] = 0.0  # zero-request columns
    elig = rng.random((N, G)) < 0.8
    return head, req, elig


SHAPES = [(300, 37, 6), (8, 1, 1), (257, 129, 9), (64, 128, 4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_screen_k_plain_matches_pallas(shape):
    """The four shapes of tests/test_pallas_screen.py, atol 0."""
    head, req, elig = _k_inputs(7, *shape)
    want = np.asarray(ref_screen_k(jnp.asarray(head), jnp.asarray(req),
                                   jnp.asarray(elig), interpret=True))
    got = screen_k(torch.as_tensor(head), torch.as_tensor(req),
                   torch.as_tensor(elig)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def _slack_tolerance(N):
    """Slack entries of groups whose request row is all zero sum N values
    of BIG = 1e9 in f32: inexact, and order-dependent (the reference's XLA
    reduction and torch's sum add in different orders). The relative error
    of an n-term f32 sum is bounded by (n - 1) * 2^-24."""
    return max(N - 1, 1) * 2.0 ** -24


def _compare(cat, enc, views, counts, pcat, penc, pviews):
    s_ref, sl_ref = ref_screen(cat, enc, views, counts)
    s, sl = consolidation_screen(pcat, penc, pviews, counts, device="cpu")
    np.testing.assert_array_equal(s, s_ref)
    zero = ~enc.requests.any(axis=1)                     # [G]
    np.testing.assert_array_equal(sl[:, ~zero], sl_ref[:, ~zero])
    if zero.any():
        np.testing.assert_allclose(sl[:, zero], sl_ref[:, zero],
                                   rtol=_slack_tolerance(len(views)), atol=0)


def _views_from_solve(cat, enc, result):
    views, pviews, rows = [], [], []
    for i, n in enumerate(result.nodes):
        n.existing_name = f"n{i}"
        row = np.zeros(enc.G, np.int32)
        for g, c in n.pods_by_group.items():
            row[g] = c
        rows.append(row)
        views.append(RefNodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"),
                                 node=None, pods=[], virtual=n, price=0.1))
        pviews.append(NodeView(virtual=convert.nodes_from_arrays([vars(n)])[0]))
    counts = (np.stack(rows) if rows else np.zeros((0, enc.G), np.int32))
    return views, pviews, counts


def _random_pods(rng, n, zero_frac=0.0):
    cpus = ["100m", "250m", "500m", "1", "2", "3", "7"]
    mems = ["128Mi", "512Mi", "1Gi", "2Gi", "5Gi", "12Gi"]
    pods = []
    for i in range(n):
        if rng.random() < zero_frac:
            pods.append(Pod(name=f"z{i}", requests=Resources()))
            continue
        kw = {}
        if rng.random() < 0.15:
            kw["node_selector"] = {
                L.ZONE: rng.choice(["zone-a", "zone-b", "zone-c"])}
        pods.append(Pod(name=f"f{i}", requests=Resources.parse(
            {"cpu": rng.choice(cpus), "memory": rng.choice(mems)}), **kw))
    return pods


@pytest.mark.parametrize("seed", range(4))
def test_consolidation_screen_matches_reference(seed):
    rng = random.Random(seed * 977 + 1)
    cat = encode_catalog(generate_catalog(GeneratorConfig(
        families=rng.sample(["m5", "c5", "r5", "m6", "c6"], 3))))
    enc = encode_pods(_random_pods(rng, rng.randrange(60, 200),
                                   zero_frac=0.1 if seed % 2 else 0.0), cat)
    views, pviews, counts = _views_from_solve(cat, enc, solve_host(cat, enc))
    _compare(cat, enc, views, counts, convert.catalog_from_arrays(vars(cat)),
             convert.pods_from_arrays(vars(enc)), pviews)


def test_consolidation_screen_synthetic_nodes():
    """The reference test_full_screen_kernel_pallas_vs_xla input: random
    node types and loads, so many (node, group) pairs are ineligible."""
    cat = encode_catalog(small_catalog())
    pods = [Pod(name=f"s{i}", requests=Resources.parse(
        {"cpu": ["500m", "1", "2"][i % 3], "memory": "1Gi"}))
        for i in range(120)]
    enc = encode_pods(pods, cat)
    rng = np.random.default_rng(3)
    N = 41
    from karpenter_tpu.ops.binpack import VirtualNode
    nodes = []
    for i in range(N):
        cum = np.zeros(enc.requests.shape[1], np.float32)
        cum[0] = rng.uniform(0, 8)
        nodes.append(VirtualNode(type_idx=int(rng.integers(0, cat.T)),
                                 zone_mask=rng.random(cat.Z) < 0.7,
                                 cap_mask=rng.random(cat.C) < 0.7, cum=cum))
    counts = rng.integers(0, 3, (N, enc.G)).astype(np.int32)
    views = [RefNodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"),
                         node=None, pods=[], virtual=n, price=0.1)
             for i, n in enumerate(nodes)]
    pviews = [NodeView(virtual=v) for v in
              convert.nodes_from_arrays(vars(n) for n in nodes)]
    _compare(cat, enc, views, counts, convert.catalog_from_arrays(vars(cat)),
             convert.pods_from_arrays(vars(enc)), pviews)


def test_consolidation_screen_zone_overhead():
    base = encode_catalog(generate_catalog(GeneratorConfig(
        families=["m5", "c5"])))
    zovh = np.zeros((base.T, base.Z, base.allocatable.shape[1]), np.float32)
    zovh[:, 0, 0] = np.float32(0.5)
    zovh[:, 2, 1] = np.float32(512.0)
    cat = dataclasses.replace(base, zone_overhead=zovh)
    rng = random.Random(11)
    enc = encode_pods(_random_pods(rng, 150), cat)
    views, pviews, counts = _views_from_solve(cat, enc, solve_host(cat, enc))
    _compare(cat, enc, views, counts, convert.catalog_from_arrays(vars(cat)),
             convert.pods_from_arrays(vars(enc)), pviews)


def test_consolidation_screen_empty():
    cat = p_encode_catalog(p_generate_catalog(PGeneratorConfig(
        families=["m5"])))
    enc = p_encode_pods([PPod(name="a", requests=PResources.parse(
        {"cpu": "1"}))], cat)
    s, sl = consolidation_screen(cat, enc, [], np.zeros((0, enc.G)),
                                 device="cpu")
    assert s.shape == (0,) and sl.shape == (0, enc.G)


# --- the reference's test_screen_has_no_false_negatives_random, on the port

def _p_random_pods(rng: random.Random, n: int):
    """tests/test_solver_fuzz.py's pod mix, built with the port's models."""
    from karpenter_tpu_torch.models import labels as PL
    from karpenter_tpu_torch.models.pod import PodAffinityTerm as PTerm
    cpus = ["100m", "250m", "500m", "1", "2", "3", "7"]
    mems = ["128Mi", "512Mi", "1Gi", "2Gi", "5Gi", "12Gi"]
    pods = []
    for i in range(n):
        kw = dict(requests=PResources.parse({
            "cpu": rng.choice(cpus), "memory": rng.choice(mems)}))
        r = rng.random()
        if r < 0.15:
            kw["node_selector"] = {
                PL.ZONE: rng.choice(["zone-a", "zone-b", "zone-c"])}
        elif r < 0.25:
            kw["node_affinity"] = [{
                "key": PL.INSTANCE_FAMILY, "operator": "In",
                "values": tuple(rng.sample(
                    ["m5", "c5", "r5", "m6", "c6"], rng.randrange(1, 4)))}]
        elif r < 0.32:
            kw["labels"] = {"app": f"g{rng.randrange(4)}"}
            kw["affinity_terms"] = [PTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": kw["labels"]["app"]}, anti=True)]
        pods.append(PPod(name=f"f{i}", **kw))
    return pods


@pytest.mark.parametrize("seed", range(6))
def test_screen_has_no_false_negatives_random(seed):
    """Any node whose pods the exact solver can place onto the others'
    headroom must screen true."""
    rng = random.Random(seed * 60013 + 3)
    cat = p_encode_catalog(p_generate_catalog(PGeneratorConfig(
        families=["m5", "c5", "r5"])))
    pods = [p for p in _p_random_pods(rng, rng.randrange(60, 160))
            if not p.affinity_terms]
    enc = p_encode_pods(pods, cat)
    base = port_binpack.solve_host(cat, enc)
    views, rows = [], []
    for i, n in enumerate(base.nodes):
        n.existing_name = f"n{i}"
        row = np.zeros(enc.G, np.int32)
        for g, c in n.pods_by_group.items():
            row[g] = c
        rows.append(row)
        views.append(NodeView(virtual=n))
    counts = (np.stack(rows) if rows else np.zeros((0, enc.G), np.int32))
    screen, _ = consolidation_screen(cat, enc, views, counts, device="cpu")
    sig_to_g = {g.representative.constraint_signature(): i
                for i, g in enumerate(enc.groups)}
    by_group: dict = {}
    for p in pods:
        by_group.setdefault(sig_to_g.get(p.constraint_signature()), []).append(p)
    for i, n in enumerate(base.nodes):
        if screen[i]:
            continue
        victim = []
        for g, c in n.pods_by_group.items():
            victim.extend(by_group.get(g, [])[:c])
        if not victim:
            continue
        others = [m for j, m in enumerate(base.nodes) if j != i]
        out = port_binpack.solve_host(cat, p_encode_pods(victim, cat),
                                      existing=others)
        fits = not out.unschedulable and not out.new_nodes()
        assert not fits, f"seed {seed}: node {i} consolidatable but screened False"
