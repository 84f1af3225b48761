"""The store's two indexes (pods by node name, nodes by provider id) and
the one-pass `build_node_views` give what the JAX package's scans give:
the same claims, the same pods in the same order, `cum` bit for bit, the
same masks, and `pods_on_node` / `cluster_occupancy` equal, on a store
with bound pods, nominated and unbound pods on several claims, a
deleting claim and pods bound out of insertion order; and each index
stays true after every bind, unbind and delete."""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.catalog import small_catalog as ref_small_catalog
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models.resources import Resources as RefResources
from karpenter_tpu.ops.encode import encode_catalog
from karpenter_tpu.state import cluster as ref_cluster
from karpenter_tpu.state.store import Store as RefStore

from karpenter_tpu_torch import convert
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models.resources import Resources as PortResources
from karpenter_tpu_torch.state import cluster as port_cluster
from karpenter_tpu_torch.state.store import Store as PortStore

REF = dict(store=RefStore, nc=ref_nodeclaim, pod=ref_pod, res=RefResources,
           cluster=ref_cluster)
PORT = dict(store=PortStore, nc=port_nodeclaim, pod=port_pod,
            res=PortResources, cluster=port_cluster)

CPUS = ("100m", "250m", "333m", "700m", "1100m", "1500m", "2")
MEMS = ("100Mi", "129Mi", "1Gi", "1500Mi", "3Gi")


@pytest.fixture(scope="module")
def cats():
    cat = encode_catalog(ref_small_catalog())
    return cat, convert.catalog_from_arrays(vars(cat))


def _build(P, cat, seed: int):
    """A store with 6 claims (one deleting, one launched without a node
    yet), pods bound to them out of insertion order, and pods nominated
    to several claims and left unbound."""
    rng = np.random.default_rng(seed)
    s = P["store"]()
    nc, pm = P["nc"], P["pod"]
    types = [cat.names[i] for i in rng.choice(cat.T, 6, replace=False)]
    claims = []
    for i, t in enumerate(types):
        c = nc.NodeClaim(name=f"claim-{i}", nodepool="default",
                         instance_type=t, zone=cat.zones[i % cat.Z],
                         capacity_type=cat.captypes[i % cat.C],
                         price=0.1 * (i + 1),
                         phase=(nc.Phase.LAUNCHED if i == 5
                                else nc.Phase.INITIALIZED),
                         provider_id=f"tpu:///z/i-{i:04d}")
        if i < 5:
            c.node_name = f"node-{i}"
            s.add_node(nc.Node(name=f"node-{i}",
                               provider_id=c.provider_id, ready=True))
        s.add_nodeclaim(c)
        claims.append(c)
    claims[3].deletion_timestamp = 1.0
    # an unmanaged node too
    s.add_node(nc.Node(name="node-x", provider_id="tpu:///z/i-x", ready=True))
    pods = []
    for i in range(60):
        p = pm.Pod(name=f"p{i:03d}", requests=P["res"].parse(
            {"cpu": CPUS[int(rng.integers(len(CPUS)))],
             "memory": MEMS[int(rng.integers(len(MEMS)))], "pods": "1"}))
        s.add_pod(p)
        pods.append(p)
    # bound out of insertion order, some re-bound elsewhere
    for i in rng.permutation(45).tolist():
        s.bind_pod(pods[i], f"node-{int(rng.integers(5))}"
                   if i % 9 else "node-x")
    for i in rng.choice(45, 8, replace=False).tolist():
        s.bind_pod(pods[i], f"node-{int(rng.integers(5))}")
    # nominated and unbound, to several claims (one without a node)
    for i in range(45, 60):
        s.nominate_pod(pods[i], f"claim-{int(rng.integers(6))}")
    # nominated and bound: views count it on its node only
    s.nominate_pod(pods[0], "claim-5")
    return s, pods


def _view_key(views):
    return [(v.name, v.node.name if v.node else None,
             [f"{p.namespace}/{p.name}" for p in v.pods],
             v.virtual.cum.tobytes(), v.virtual.zone_mask.tobytes(),
             v.virtual.cap_mask.tobytes(), v.virtual.type_idx, v.price)
            for v in views]


def _occupancy(P, s):
    by = {}
    occ = P["cluster"].cluster_occupancy(s, by)
    return ([(z, [p.name for p in ps]) for z, ps in occ],
            {k: [p.name for p in v] for k, v in by.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_views_and_occupancy_equal_the_references(cats, seed):
    ref_cat, port_cat = cats
    rs, _ = _build(REF, ref_cat, seed)
    ps, _ = _build(PORT, ref_cat, seed)
    want = ref_cluster.build_node_views(rs, ref_cat, 10.0)
    got = port_cluster.build_node_views(ps, port_cat, 10.0)
    assert len(want) == 5   # the deleting claim and none other left out
    assert _view_key(got) == _view_key(want)
    for name in list(rs.nodes) + ["node-none"]:
        assert ([p.name for p in ps.pods_on_node(name)]
                == [p.name for p in rs.pods_on_node(name)])
    for c in rs.nodeclaims.values():
        a = rs.node_for_nodeclaim(c)
        b = ps.node_for_nodeclaim(ps.nodeclaims[c.name])
        assert (a.name if a else None) == (b.name if b else None)
    assert _occupancy(PORT, ps) == _occupancy(REF, rs)
    assert ([v.name for v in port_cluster.pool_node_views(
        ps, port_cat, 10.0, "default")]
        == [v.name for v in ref_cluster.pool_node_views(
            rs, ref_cat, 10.0, "default")])


def _scan(s, node_name):
    return [p.name for p in s.pods.values() if p.node_name == node_name]


def _index_true(s):
    names = set(s.nodes) | {p.node_name for p in s.pods.values()
                            if p.node_name}
    for n in names:
        assert [p.name for p in s.pods_on_node(n)] == _scan(s, n)


@pytest.mark.parametrize("op", ["bind", "unbind", "delete", "readd",
                                "replace"])
def test_the_pod_index_after_each_update(cats, op):
    ref_cat, _ = cats
    s, pods = _build(PORT, ref_cat, 3)
    _index_true(s)
    p = pods[7]
    if op == "bind":
        s.bind_pod(p, "node-2" if p.node_name != "node-2" else "node-1")
    elif op == "unbind":
        s.unbind_pod(p)
    elif op == "delete":
        s.delete_pod(p.namespace, p.name)
    elif op == "readd":
        # a delete and re-add moves the key last in the store's order
        s.delete_pod(p.namespace, p.name)
        s.add_pod(p)
        s.bind_pod(p, "node-0")
        assert s.pods_on_node("node-0")[-1] is p
    else:
        # a same-key replacement keeps the key's place and drops the old
        # object from its node
        q = port_pod.Pod(name=p.name, requests=PortResources.parse(
            {"cpu": "1"}))
        q.node_name = "node-4"
        s.add_pod(q)
        assert p not in s.pods_on_node(p.node_name or "")
    _index_true(s)


def test_the_provider_id_index(cats):
    ref_cat, _ = cats
    s, _ = _build(PORT, ref_cat, 4)
    c = s.nodeclaims["claim-1"]
    assert s.node_for_nodeclaim(c).name == "node-1"
    s.delete_node("node-1")
    assert s.node_for_nodeclaim(c) is None
    # a second node under the same provider id: the first added answers
    s.add_node(port_nodeclaim.Node(name="node-1b", provider_id=c.provider_id))
    s.add_node(port_nodeclaim.Node(name="node-1c", provider_id=c.provider_id))
    assert s.node_for_nodeclaim(c).name == "node-1b"
    s.delete_node("node-1b")
    assert s.node_for_nodeclaim(c).name == "node-1c"
    assert s.node_for_nodeclaim(s.nodeclaims["claim-5"]) is None
