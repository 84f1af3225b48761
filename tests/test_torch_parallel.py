"""The port's multi-device path (`karpenter_tpu_torch/parallel/`) held
against the JAX reference's `tests/test_parallel.py`.

Each case feeds both packages the same encoded input. The reference runs
on its 8 virtual CPU devices (tests/conftest.py); the port runs on CPU
shards asked for explicitly (`parallel.virtual_devices(n, "cpu")`), where
the sharded scan is kernel M's plain version and every collective a CPU
tensor operation. Every mesh answer is held equal to the reference's and
to the port's own mesh=None answer:

- `run_sharded_solve` and `Solver(backend="mesh")` (the reference's first
  two cases), the mesh screen at N=37 (uneven shards) and, marked slow as
  the reference's, at the bench shape;
- kernel M's plain version against the reference's `_solve_kernel`,
  element for element, at mesh sizes 1, 2, 3 and 8, where first fits and
  new nodes straddle shard boundaries, with priors and bans on existing
  nodes, conflicts, zone overhead and a node budget that overflows; and
  through `solve_device`, the regrow that doubles the budget;
- the batch mesh (`dispatch_batch`), the resident grouped patch of a
  sharded stack, and the mesh tournament.

The reference's `test_graft_entry_contract` is the JAX package's own entry
and has no counterpart. Kernel M on the card is held against its plain
version in test_torch_kernels.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from karpenter_tpu import optimizer as ref_opt
from karpenter_tpu.catalog import CatalogProvider as RefProvider
from karpenter_tpu.catalog import generate_catalog, small_catalog
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.nodeclaim import NodeClaim
from karpenter_tpu.models.nodepool import NodePool
from karpenter_tpu.models.pod import Pod, PodAffinityTerm
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import resident as ref_resident
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.binpack import VirtualNode, solve_host
from karpenter_tpu.ops.consolidate import consolidation_screen as ref_screen
from karpenter_tpu.ops.encode import (align_resources, align_zone_overhead,
                                      encode_catalog, encode_pods)
from karpenter_tpu.ops.facade import Solver as RefSolver
from karpenter_tpu.optimizer import tournament as ref_tournament
from karpenter_tpu.parallel.mesh import make_batch_mesh as ref_batch_mesh
from karpenter_tpu.parallel import make_mesh as ref_make_mesh
from karpenter_tpu.parallel import run_sharded_solve as ref_run_sharded
from karpenter_tpu.state.cluster import NodeView as RefNodeView

from karpenter_tpu_torch import convert, parallel
from karpenter_tpu_torch import optimizer as port_opt
from karpenter_tpu_torch.catalog import CatalogProvider as PortProvider
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.models.nodeclaim import NodeClaim as PNodeClaim
from karpenter_tpu_torch.obs import devicemem as port_dm
from karpenter_tpu_torch.ops import resident as port_resident
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.ops.consolidate import consolidation_screen
from karpenter_tpu_torch.ops.facade import Solver as PortSolver
from karpenter_tpu_torch.optimizer import tournament as port_tournament
from karpenter_tpu_torch.parallel.collectives import Sharding, ShardedTensor
from karpenter_tpu_torch.state.cluster import NodeView

port_object = convert.port_object


@pytest.fixture(scope="module", autouse=True)
def _shared_axis_and_clean_planes():
    """Both resource axes share their columns (see test_torch_encode.py);
    afterwards the reference's intern table and both packages' resident
    planes are reset, as the other parity modules leave them."""
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    ref_pod._sig_intern.clear()
    ref_resident.RESIDENT.reset()
    port_resident.RESIDENT.reset()


def _cpu_mesh(n, batch=False):
    """A mesh of n CPU shards (the explicit virtual-device request)."""
    with parallel.virtual_devices(n, "cpu"):
        return (parallel.make_batch_mesh(n) if batch
                else parallel.make_mesh(n))


def _pad_to(x, n, axis=0):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return np.pad(x, pad)


# --- the reference's test_parallel.py cases ----------------------------------

def test_sharded_solve_agrees_with_host():
    """200 pods on small_catalog(), n_max=256, Gp=16: every output of the
    port's run_sharded_solve on 8 CPU shards equals the reference's on its
    8 devices, element for element, and agrees with solve_host."""
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    cat = encode_catalog(small_catalog())
    pods = [Pod(name=f"p{i}",
                requests=Resources.parse({"cpu": ["500m", "1", "2"][i % 3],
                                          "memory": "1Gi"}))
            for i in range(200)]
    enc = encode_pods(pods, cat)
    R = enc.requests.shape[1]
    dcat = ref_solver.device_catalog(cat, R)
    n_max, Gp = 256, 16
    args = (np.asarray(dcat.alloc), np.asarray(dcat.price),
            np.asarray(dcat.avail),
            _pad_to(enc.requests.astype(np.float32), Gp),
            _pad_to(enc.counts.astype(np.int32), Gp),
            _pad_to(enc.compat, Gp), _pad_to(enc.allow_zone, Gp),
            _pad_to(enc.allow_cap, Gp),
            _pad_to(enc.max_per_node.astype(np.int32), Gp))
    want = [np.asarray(x) for x in ref_run_sharded(ref_make_mesh(8), *args,
                                                    n_max=n_max)]
    mesh = _cpu_mesh(8)
    assert mesh.size == 8 and mesh.virtual
    got = [x.numpy() for x in parallel.run_sharded_solve(mesh, *args,
                                                         n_max=n_max)]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ntype, cum, zmask, cmask, nopen, nused, takes, unsched, overflow = got
    h = solve_host(cat, enc)
    assert int(nused) == len(h.nodes)
    assert not bool(overflow)
    assert int(unsched.sum()) == 0
    for i, n in enumerate(h.nodes):
        assert ntype[i] == n.type_idx
        for g in range(enc.G):
            assert takes[g, i] == n.pods_by_group.get(g, 0)


def _launches(out):
    return [(l.instance_type, l.capacity_type, l.zone, l.price,
             sorted(l.pod_keys)) for l in out.launches]


def test_mesh_backend_facade_parity():
    """Solver(backend="mesh") — the facade call the provisioner makes — in
    both packages: 3,000 pods, the SolveOutputs equal to each other and to
    the host backend's; the port's mesh is 8 CPU shards and equals its
    own device backend's answer."""
    shapes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"),
              ("2", "4Gi"), ("4", "16Gi"), ("500m", "4Gi")]
    pods = [Pod(name=f"p{i}",
                requests=Resources.parse({"cpu": shapes[i % 6][0],
                                          "memory": shapes[i % 6][1]}))
            for i in range(3000)]
    pool = NodePool(name="mesh-pool")
    ref_mesh = RefSolver(RefProvider(lambda: small_catalog()),
                         backend="mesh")
    ref_host = RefSolver(RefProvider(lambda: small_catalog()),
                         backend="host")
    assert ref_mesh.mesh().size == 8
    m_ref = ref_mesh.solve(pods, pool)
    h_ref = ref_host.solve(pods, pool)
    ptypes = port_object(small_catalog())
    ppods, ppool = port_object(pods), port_object(pool)
    with parallel.virtual_devices(8, "cpu"):
        mesh_solver = PortSolver(PortProvider(lambda: ptypes),
                                 backend="mesh")
    assert mesh_solver.mesh() is not None and mesh_solver.mesh().size == 8
    assert mesh_solver.device.type == "cpu"
    m = mesh_solver.solve(ppods, ppool)
    h = PortSolver(PortProvider(lambda: ptypes), backend="host").solve(
        ppods, ppool)
    d = PortSolver(PortProvider(lambda: ptypes), backend="device",
                   device="cpu").solve(ppods, ppool)
    assert not m.unschedulable and not h.unschedulable
    assert _launches(m) == _launches(m_ref) == _launches(h_ref)
    assert _launches(m) == _launches(h) == _launches(d)


def _screen_views(P, cat, N, G):
    """The reference's N-node screen fixture, in package P's objects."""
    rng_views, counts = [], np.zeros((N, G), np.int32)
    for i in range(N):
        cum = np.zeros(len(cat.resources), np.float32)
        if i % 3 == 0:  # every third node carries load
            cum[0] = 30.0
            counts[i, 0] = 4
        v = VirtualNode(type_idx=i % cat.T, zone_mask=np.ones(cat.Z, bool),
                        cap_mask=np.ones(cat.C, bool), cum=cum,
                        existing_name=f"n{i}")
        rng_views.append(v)
    if P == "ref":
        views = [RefNodeView(claim=NodeClaim(name=f"n{i}", nodepool="p"),
                             node=None, pods=[], virtual=v, price=0.1)
                 for i, v in enumerate(rng_views)]
    else:
        views = [NodeView(claim=PNodeClaim(name=f"n{i}", nodepool="p"),
                          node=None, pods=[], virtual=v, price=0.1)
                 for i, v in enumerate(convert.nodes_from_arrays(
                     vars(v) for v in rng_views))]
    return views, counts


@pytest.mark.parametrize("requests_nothing", [False, True])
def test_mesh_screen_parity(requests_nothing):
    """The sharded screen at N=37 (not divisible by 8: padding rows): the
    port's mesh screen equals its own mesh=None screen exactly, and the
    reference's (screen equal, slack within rtol 1e-6, as the reference
    holds its own). With a group that requests nothing, k = BIG on its
    eligible nodes, its column sum passes 2^24 and f32 partial sums round
    in another order than one device's sum: every verdict is still exact,
    the requesting groups' slack equal element for element, and that
    group's slack within rtol 1e-6."""
    cat = encode_catalog(small_catalog())
    pods = [Pod(name=f"s{i}",
                requests=Resources.parse({"cpu": "1", "memory": "2Gi"}))
            for i in range(100)]
    if requests_nothing:
        pods += [Pod(name=f"z{i}", requests=Resources.parse({}))
                 for i in range(40)]
    enc = encode_pods(pods, cat)
    zero = ~enc.requests.any(axis=1)
    assert zero.any() == requests_nothing and not zero.all()
    N = 37
    views, counts = _screen_views("ref", cat, N, enc.G)
    pviews, _ = _screen_views("port", cat, N, enc.G)
    counts[1::4, zero] = 3
    s1, sl1 = ref_screen(cat, enc, views, counts)
    s2, sl2 = ref_screen(cat, enc, views, counts, mesh=ref_make_mesh(8))
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(vars(enc))
    p1, psl1 = consolidation_screen(pcat, penc, pviews, counts, device="cpu")
    for n in (8, 3):
        p2, psl2 = consolidation_screen(pcat, penc, pviews, counts,
                                        mesh=_cpu_mesh(n))
        np.testing.assert_array_equal(p2, p1)
        np.testing.assert_array_equal(psl2[:, ~zero], psl1[:, ~zero])
        np.testing.assert_allclose(psl2, psl1, rtol=1e-6)
        np.testing.assert_array_equal(p2, s2)
        np.testing.assert_allclose(psl2, sl2, rtol=1e-6)
    assert (s1 == s2).all()
    np.testing.assert_allclose(sl1, sl2, rtol=1e-6)


@pytest.mark.slow
def test_mesh_parity_bench_shape():
    """The bench-like shape (~5k nodes x 128 groups x the full catalog):
    the sharded solve equals solve_host node for node, and the sharded
    screen at [5k, 128] equals the port's mesh=None screen and the
    reference's mesh screen."""
    from karpenter_tpu.ops.binpack import split_spread_groups  # noqa: F401
    cat = encode_catalog(generate_catalog())
    pods = []
    for k in range(128):
        for i in range(40):
            pods.append(Pod(
                name=f"g{k}-{i}", labels={"app": f"g{k}"},
                requests=Resources.parse({"cpu": ["6", "7"][k % 2],
                                          "memory": "6Gi"}),
                affinity_terms=[PodAffinityTerm(
                    topology_key="kubernetes.io/hostname",
                    label_selector={"app": f"g{k}"}, anti=True)]))
    enc = encode_pods(pods, cat)
    h = solve_host(cat, enc)
    assert len(h.nodes) >= 5000
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(vars(enc))
    res = port_solver.solve_device(pcat, penc, mesh=_cpu_mesh(8))
    assert len(res.nodes) == len(h.nodes)
    for x, y in zip(res.nodes, h.nodes):
        assert x.type_idx == y.type_idx
        assert x.pods_by_group == y.pods_by_group
    views, pviews = [], []
    counts = np.zeros((len(h.nodes), enc.G), np.int32)
    for i, n in enumerate(h.nodes):
        v = VirtualNode(type_idx=n.type_idx,
                        zone_mask=np.asarray(n.zone_mask, bool),
                        cap_mask=np.asarray(n.cap_mask, bool),
                        cum=np.asarray(n.cum, np.float32))
        views.append(RefNodeView(claim=NodeClaim(name=f"n{i}", nodepool="p"),
                                 node=None, pods=[], virtual=v, price=0.1))
        pviews.append(NodeView(
            claim=PNodeClaim(name=f"n{i}", nodepool="p"), node=None,
            pods=[], virtual=convert.nodes_from_arrays([vars(v)])[0],
            price=0.1))
        for g, c in n.pods_by_group.items():
            counts[i, g] = c
    s2, sl2 = ref_screen(cat, enc, views, counts, mesh=ref_make_mesh(8))
    p1, psl1 = consolidation_screen(pcat, penc, pviews, counts, device="cpu")
    p2, psl2 = consolidation_screen(pcat, penc, pviews, counts,
                                    mesh=_cpu_mesh(8))
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_array_equal(psl2, psl1)
    np.testing.assert_array_equal(p2, s2)
    np.testing.assert_allclose(psl2, sl2, rtol=1e-5)


# --- kernel M's plain version at its hard places -----------------------------

CASES = ("straddle", "prior_banned", "conflicts", "zone_ovh", "overflow")
N_MAX = 120  # divisible by 1, 2, 3 and 8


def _hard_case(case: str, seed: int = 0):
    """(19 arguments of the reference's _solve_kernel, n_max, flags): a
    seeded workload over existing nodes whose headroom spans several
    shards (so first fits straddle shard boundaries), the new nodes
    opening from the last existing one (straddling too)."""
    rng = np.random.default_rng(seed)
    cat = encode_catalog(small_catalog())
    R = len(cat.resources)
    zone_ovh = case == "zone_ovh"
    if zone_ovh:
        zovh = np.zeros((cat.T, cat.Z, R), np.float32)
        zovh[:, 0, 0] = np.float32(0.5)
        zovh[:, 1, 1] = np.float32(256.0)
        cat = dataclasses.replace(cat, zone_overhead=zovh)
    cpus = ["250m", "500m", "1", "2", "3"]
    mems = ["512Mi", "1Gi", "2Gi", "4Gi"]
    n_pods = 900 if case == "overflow" else 300
    pods = []
    for i in range(n_pods):
        kw = {}
        if case == "conflicts" and i % 5 == 0:
            app = f"a{i % 3}"
            kw = dict(labels={"app": app}, affinity_terms=[PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": f"a{(i + 1) % 3}"}, anti=True)])
        pods.append(Pod(name=f"p{i}", requests=Resources.parse(
            {"cpu": cpus[int(rng.integers(0, 5))],
             "memory": mems[int(rng.integers(0, 4))]}), **kw))
    enc = encode_pods(pods, cat)
    track = enc.conflict is not None
    assert track == (case == "conflicts")
    Gp = -(-enc.G // 8) * 8
    # existing nodes: 70 four-core nodes (more than a shard holds at every
    # mesh size but 1), each loaded to a random share of its capacity, so
    # a group's first fit runs over many nodes and across shard boundaries
    n_ex = 70
    alloc = align_resources(cat.allocatable, R).astype(np.float32)
    node_type = np.zeros(N_MAX, np.int32)
    node_cum = np.zeros((N_MAX, R), np.float32)
    node_zmask = np.zeros((N_MAX, cat.Z), bool)
    node_cmask = np.zeros((N_MAX, cat.C), bool)
    node_open = np.zeros(N_MAX, bool)
    for i in range(n_ex):
        t = int(rng.choice([9, 13, 17]))
        node_type[i] = t
        node_cum[i, :2] = alloc[t, :2] * rng.uniform(0.0, 0.9, 2).astype(
            np.float32)
        node_zmask[i] = cat.available[t].any(axis=1)
        node_cmask[i] = cat.available[t].any(axis=0)
        node_open[i] = True
    prior = np.zeros((Gp, N_MAX), np.int32)
    banned = np.zeros((Gp, N_MAX), bool)
    if case == "prior_banned":
        prior[:, :n_ex] = rng.integers(0, 3, (Gp, n_ex))
        banned[:, :n_ex] = rng.random((Gp, n_ex)) < 0.3
        mpn = rng.integers(0, 4, enc.G).astype(np.int32)
        enc = dataclasses.replace(enc, max_per_node=mpn)
    (requests, counts, compat, allow_zone, allow_cap,
     max_per_node) = ref_solver._group_inputs(enc, Gp)
    conflict = (_pad_to(_pad_to(enc.conflict, Gp, 0), Gp, 1) if track
                else np.zeros((Gp, 1), bool))
    zo = (align_zone_overhead(cat, R) if zone_ovh
          else np.zeros((1, 1, R), np.float32))
    args = (alloc, cat.price.astype(np.float32), cat.available, requests,
            counts,
            compat, allow_zone, allow_cap, max_per_node, prior, banned,
            conflict, zo, node_type, node_cum, node_zmask, node_cmask,
            node_open, np.asarray(n_ex, np.int32))
    n_max = 72 if case == "overflow" else N_MAX
    if n_max != N_MAX:
        args = (args[:9] + (prior[:, :n_max], banned[:, :n_max])
                + args[11:13] + tuple(a[:n_max] for a in args[13:18])
                + args[18:])
    return args, n_max, dict(track_conflicts=track, zone_ovh=zone_ovh)


_REF_OUT: dict = {}


def _ref_kernel(case):
    if case not in _REF_OUT:
        args, n_max, kw = _hard_case(case)
        _REF_OUT[case] = [np.asarray(x) for x in ref_solver._solve_kernel(
            *(jnp.asarray(a) for a in args), n_max=n_max, **kw)]
    return _REF_OUT[case]


@pytest.mark.parametrize("size", [1, 2, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_mesh_scan_plain_equals_solve_kernel(case, size):
    args, n_max, kw = _hard_case(case)
    want = _ref_kernel(case)
    got = [x.numpy() for x in parallel.sharded_solve_fn(
        _cpu_mesh(size), n_max)(*args, **kw)]
    names = ("ntype", "cum", "zmask", "cmask", "nopen", "nused", "takes",
             "unsched", "overflow")
    for a, b, name in zip(got, want, names):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    ntype, cum, zmask, cmask, nopen, nused, takes = got[:7]
    Ns = n_max // size
    assert bool(got[8]) == (case == "overflow")
    if size > 1 and case != "overflow":
        # the hard places are really exercised: some group's takes on
        # existing nodes span a shard boundary, and nodes opened by one
        # group straddle one
        n_ex = int(args[18])
        spans = [g for g in range(takes.shape[0])
                 if len({n // Ns for n in np.nonzero(takes[g, :n_ex])[0]})
                 > 1]
        assert spans, "no first fit straddles a shard boundary"
        # the new nodes [n_ex, nused) cross a boundary wherever one lies
        # between them (at size 2 the first boundary is below n_ex)
        if int(nused) > (n_ex // Ns + 1) * Ns:
            opened = [g for g in range(takes.shape[0])
                      if len({n // Ns for n in np.nonzero(
                          takes[g, n_ex:])[0] + n_ex}) > 1]
            assert opened, "no group's new nodes straddle a shard boundary"
        else:
            assert size == 2


@pytest.mark.parametrize("size", [3, 8])
def test_mesh_solve_regrows_its_node_budget(monkeypatch, size):
    """solve_device(mesh=) from a node budget that overflows: n_max rounds
    up to a multiple of the mesh size and doubles until the solve fits,
    as the reference's loop does; the result equals mesh=None's and the
    reference's mesh solve."""
    cat = encode_catalog(small_catalog())
    pods = [Pod(name=f"p{i}", requests=Resources.parse(
        {"cpu": ["250m", "1", "2"][i % 3], "memory": "1Gi"}))
        for i in range(600)]
    enc = encode_pods(pods, cat)
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(vars(enc))
    budgets = []
    real = port_solver._scan_mesh

    def spy(st, n_max, *a):
        budgets.append(n_max)
        return real(st, n_max, *a)
    monkeypatch.setattr(ref_solver, "_auto_node_budget", lambda *a: 20)
    monkeypatch.setattr(port_solver, "_auto_node_budget", lambda *a: 20)
    monkeypatch.setattr(port_solver, "_scan_mesh", spy)
    want = ref_solver.solve_device(cat, enc, mesh=ref_make_mesh(size))
    got = port_solver.solve_device(pcat, penc, mesh=_cpu_mesh(size))
    monkeypatch.undo()
    one = port_solver.solve_device(pcat, penc, device="cpu")
    assert len(budgets) > 1 and budgets[0] == -(-20 // size) * size
    assert all(b % size == 0 for b in budgets)
    for res in (want, one):
        assert len(got.nodes) == len(res.nodes)
        for x, y in zip(got.nodes, res.nodes):
            assert x.type_idx == y.type_idx
            assert x.pods_by_group == y.pods_by_group
            np.testing.assert_array_equal(x.cum, y.cum)
        assert got.unschedulable == res.unschedulable
    assert got.launches == one.launches


def test_mesh_solve_resumes_existing_nodes():
    """solve_device(mesh=) onto existing nodes with priors and bans: the
    result equals mesh=None's and the reference's mesh solve, and the
    uploads count as the reference's (one _put_sharded each)."""
    cat = encode_catalog(small_catalog())
    pods = [Pod(name=f"p{i}", requests=Resources.parse(
        {"cpu": ["500m", "1"][i % 2], "memory": "2Gi"})) for i in range(120)]
    enc = encode_pods(pods, cat)
    existing = solve_host(cat, encode_pods(pods[:40], cat)).nodes[:6]
    for i, n in enumerate(existing):
        n.existing_name = f"n{i}"
        n.cum = n.cum * np.float32(0.5)
        n.prior_by_group = {0: 1} if i == 0 else {}
        n.banned_groups = (np.arange(enc.G) % 2 == 0) if i == 1 else None
    pexisting = convert.nodes_from_arrays([vars(n) for n in existing])
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(vars(enc))
    t0 = ref_solver.transfer_stats()[0]
    want = ref_solver.solve_device(cat, enc, existing, mesh=ref_make_mesh(8))
    ref_puts = ref_solver.transfer_stats()[0] - t0
    t0 = port_solver.transfer_stats()[0]
    got = port_solver.solve_device(pcat, penc, pexisting, mesh=_cpu_mesh(8))
    assert port_solver.transfer_stats()[0] - t0 == ref_puts
    one = port_solver.solve_device(pcat, penc, pexisting, device="cpu")
    for res in (want, one):
        assert len(got.nodes) == len(res.nodes)
        for x, y in zip(got.nodes, res.nodes):
            assert (x.type_idx, x.pods_by_group) == (y.type_idx,
                                                     y.pods_by_group)
        assert got.unschedulable == res.unschedulable


# --- the batch mesh, the resident grouped patch, the tournament ---------------

def test_batch_mesh_rows_equal_mesh_none_and_the_reference():
    """dispatch_batch over a batch mesh of 8 CPU shards: a bucket of 5
    requests (Bp 6 rounds up to 8, not a multiple of 8 before) gives the
    rows of mesh=None and of the reference's batch mesh."""
    import random
    rng = random.Random(3)
    cat = encode_catalog(small_catalog())
    encs = []
    for b in range(5):
        n = rng.randrange(6, 20)
        encs.append(encode_pods([Pod(name=f"b{b}-{i}", requests=Resources.parse(
            {"cpu": rng.choice(["250m", "500m", "1"]),
             "memory": rng.choice(["512Mi", "1Gi"])})) for i in range(n)],
            cat))
    ref_reqs = [ref_solver.prepare_batchable(cat, e) for e in encs]
    if len({r.signature for r in ref_reqs}) != 1:
        encs = [encs[0]] * 5
        ref_reqs = [ref_solver.prepare_batchable(cat, e) for e in encs]
    want = ref_solver.dispatch_batch(ref_reqs, mesh=ref_batch_mesh(8))
    want.block()
    pcat = convert.catalog_from_arrays(vars(cat))
    reqs = [port_solver.prepare_batchable(pcat, convert.pods_from_arrays(
        {k: v for k, v in vars(e).items() if k != "groups"}), device="cpu")
        for e in encs]
    mesh = _cpu_mesh(8, batch=True)
    assert mesh.axis == "batch"
    got = port_solver.dispatch_batch(reqs, mesh=mesh)
    rows = got.rows()
    assert rows.shape[0] == 8 and got.padded_size == 8
    np.testing.assert_array_equal(rows, want._buf)
    one = port_solver.dispatch_batch(reqs).rows()
    assert one.shape[0] == 6
    np.testing.assert_array_equal(rows[:5], one[:5])
    for i in range(5):
        a, b = got.decode(i), want.decode(i)
        assert [(n.type_idx, n.pods_by_group) for n in a.nodes] == \
            [(n.type_idx, n.pods_by_group) for n in b.nodes]


PATCH_STATS = ("patches", "full_uploads", "clean_hits", "rows_patched",
               "rows_total", "patched_bytes", "avoided_bytes", "full_bytes")


def test_resident_grouped_patch_of_a_sharded_stack():
    """A sharded resident stack over 8 shards, re-uploaded with 1% of its
    rows changed: the patch is grouped per shard, and the RESIDENT stats,
    the patch's bytes and rows and the patched content equal the
    reference's; a layout change re-seeds under shape_change."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from karpenter_tpu.metrics import RESIDENT_FALLBACKS as REF_FB
    from karpenter_tpu.obs import devicemem as ref_dm
    from karpenter_tpu_torch.metrics import RESIDENT_FALLBACKS as PORT_FB
    rng = np.random.default_rng(5)
    mat = rng.random((800, 12)).astype(np.float32)
    mat2 = mat.copy()
    mat2[rng.choice(800, 8, replace=False)] += 1.0
    rmesh, pmesh = ref_batch_mesh(8), _cpu_mesh(8, batch=True)
    rsh, psh = NamedSharding(rmesh, P("batch")), Sharding(pmesh, 0)
    ref_resident.RESIDENT.reset()
    port_resident.RESIDENT.reset()
    seen = {}
    for name, R, dm, sh, kw in (
            ("ref", ref_resident.RESIDENT, ref_dm, rsh, {}),
            ("port", port_resident.RESIDENT, port_dm, psh,
             {"device": "cpu"})):
        key = ("t", "stack")
        h0 = dm.TRANSFERS.totals()[0]
        R.upload(key, mat, donate=False, sharding=sh, **kw)
        h1 = dm.TRANSFERS.totals()[0]
        buf = R.upload(key, mat2, donate=False, sharding=sh, **kw)
        h2 = dm.TRANSFERS.totals()[0]
        content = (np.concatenate([p.numpy() for p in buf.parts])
                   if isinstance(buf, ShardedTensor) else np.asarray(buf))
        np.testing.assert_array_equal(content, mat2)
        fb = REF_FB if name == "ref" else PORT_FB
        sc0 = fb.value(reason="shape_change")
        R.upload(key, mat2, donate=False, **kw)   # replicated: re-seed
        # the audit keys appear lazily once any audit ran in the process
        # (see test_torch_resident.py): the patch's own counters compare
        seen[name] = ({k: R.stats[k] for k in PATCH_STATS}, h1 - h0, h2 - h1,
                      fb.value(reason="shape_change") - sc0)
    assert seen["port"] == seen["ref"]
    stats = seen["port"][0]
    assert stats["patches"] == 1 and stats["rows_patched"] == 8
    assert seen["port"][3] == 1


def _synthetic_views(seed, N, G):
    rng = np.random.default_rng(seed)
    cat = encode_catalog(small_catalog())
    pairs = rng.choice(3999 * 8, size=G, replace=False)
    pods = [Pod(name=f"g{i}", requests=Resources.parse(
        {"cpu": f"{1 + int(v) % 3999}m", "memory": f"{1 + int(v) // 3999}Gi"}))
        for i, v in enumerate(pairs)]
    enc = encode_pods(pods, cat)
    nodes = []
    for i in range(N):
        cum = np.zeros(enc.requests.shape[1], np.float32)
        cum[0] = rng.uniform(0, 6)
        cum[1] = rng.uniform(0, 8192)
        nodes.append(VirtualNode(type_idx=int(rng.integers(0, cat.T)),
                                 zone_mask=rng.random(cat.Z) < 0.8,
                                 cap_mask=rng.random(cat.C) < 0.8, cum=cum))
    prices = rng.uniform(0.05, 2.5, N).astype(np.float32)
    counts = (rng.random((N, enc.G)) < 3.0 / max(enc.G, 1)).astype(np.int32)
    counts *= rng.integers(1, 3, (N, enc.G)).astype(np.int32)
    slack = rng.normal(size=(N, enc.G)).astype(np.float32)
    views = [RefNodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"),
                         node=None, pods=[], virtual=n, price=float(p))
             for i, (n, p) in enumerate(zip(nodes, prices))]
    pviews = [NodeView(claim=PNodeClaim(name=f"n{i}", nodepool="d"),
                       node=None, pods=[], virtual=v, price=float(p))
              for i, (v, p) in enumerate(zip(
                  convert.nodes_from_arrays(vars(n) for n in nodes), prices))]
    return (cat, enc, views, counts, slack, prices,
            convert.catalog_from_arrays(vars(cat)),
            convert.pods_from_arrays(vars(enc)), pviews)


@pytest.mark.parametrize("size", [3, 8])
def test_mesh_tournament_equals_mesh_none(size):
    """score_subsets_device(mesh=) over 40 nodes: every output equal to
    mesh=None's (the price row reaches every shard; padding rows drop),
    feasibility equal to the reference's mesh tournament and savings as
    test_torch_optimizer.py holds them above 32 nodes; plan_repack(mesh=)
    gives mesh=None's plan with backend "mesh"."""
    (cat, enc, views, counts, slack, prices, pcat, penc,
     pviews) = _synthetic_views(7, 40, 6)
    rng = np.random.default_rng(1)
    masks = (rng.random((37, 40)) < 0.08).astype(np.float32)
    mesh = _cpu_mesh(size)
    one = port_tournament.score_subsets_device(pcat, penc, pviews, counts,
                                               prices, masks, device="cpu")
    got = port_tournament.score_subsets_device(pcat, penc, pviews, counts,
                                               prices, masks, mesh=mesh)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)
    want = ref_tournament.score_subsets_device(cat, enc, views, counts,
                                               prices, masks,
                                               mesh=ref_make_mesh(size))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-3, atol=1e-3)
    cand = list(range(40))
    kw = dict(max_k=3, use_device=True, max_subsets=64)
    plan = port_opt.plan_repack(pcat, penc, pviews, counts, slack, cand,
                                mesh=mesh, **kw)
    plan1 = port_opt.plan_repack(pcat, penc, pviews, counts, slack, cand,
                                 device="cpu", **kw)
    ref_plan = ref_opt.plan_repack(cat, enc, views, counts, slack, cand,
                                   mesh=ref_make_mesh(size), **kw)
    assert plan.subsets == plan1.subsets == ref_plan.subsets
    assert plan.backend == ref_plan.backend == "mesh"


def test_meshes_are_explicit():
    """make_mesh never builds CPU shards or fewer shards on its own: the
    virtual request is explicit and scoped; a mesh is hashable and says
    when its shards share a device."""
    with parallel.virtual_devices(4, "cpu"):
        a, b = parallel.make_mesh(4), parallel.make_mesh(4)
        assert a == b and hash(a) == hash(b) and a.virtual
        assert parallel.make_mesh().size == 4
        assert parallel.make_batch_mesh(2).axis_names == ("batch",)
        with pytest.raises(RuntimeError, match="needs 5 devices"):
            parallel.make_mesh(5)
    assert parallel.device_count() == (0 if not _cuda() else
                                       _cuda_count())
    with pytest.raises(ValueError, match="does not split"):
        parallel.sharded_solve_fn(a, 10)(*([np.zeros(1)] * 19))


def test_hybrid_routes_to_virtual_shards_only():
    """A "hybrid" facade takes the mesh on its own (solves from
    device_min_pods up, the screen from SCREEN_MESH_MIN_NODES) only when
    its shards are the virtual ones a caller asked for, as the reference's
    does on its virtual devices; over distinct cards it stays on one
    device until a multi-card machine has run the mesh, and
    backend="mesh" still takes it."""
    import torch
    from karpenter_tpu_torch.parallel.mesh import Mesh
    ptypes = port_object(small_catalog())
    with parallel.virtual_devices(8, "cpu"):
        virt = PortSolver(PortProvider(lambda: ptypes), backend="hybrid",
                          device="cpu")
        assert virt.mesh().virtual
    big, nodes = virt.device_min_pods, virt.SCREEN_MESH_MIN_NODES
    assert virt._resolve_backend_healthy(big) == "mesh"
    assert virt.screen_mesh(nodes) is virt.mesh()
    assert virt.screen_mesh(nodes - 1) is None
    cards = PortSolver(PortProvider(lambda: ptypes), backend="hybrid",
                       device="cpu")
    cards._mesh_obj = Mesh((torch.device("cuda", 0),
                            torch.device("cuda", 1)))
    assert not cards.mesh().virtual
    assert cards._resolve_backend_healthy(big) == "device"
    assert cards.screen_mesh(nodes) is None
    cards.backend = "mesh"
    assert cards.screen_mesh(nodes) is cards.mesh()


def _cuda():
    import torch
    return torch.cuda.is_available()


def _cuda_count():
    import torch
    return torch.cuda.device_count()


def test_sharded_upload_is_metered_once_and_audited():
    """A `_put_sharded` counts one upload of the logical array's bytes,
    attributed as mesh_shard (the reference's accounting), and the
    residency audit finds its shards' bytes accounted."""
    mesh = _cpu_mesh(4)
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    n0 = port_solver.transfer_stats()[0]
    h0 = port_dm.TRANSFERS.totals()[0]
    k0 = port_dm.DEVICEMEM.kind_bytes.get("mesh_shard", 0)
    split = port_solver._put_sharded(x, Sharding(mesh, 0))
    rep = port_solver._put_sharded(x, Sharding(mesh))
    assert port_solver.transfer_stats()[0] - n0 == 2
    assert port_dm.TRANSFERS.totals()[0] - h0 == 2 * x.nbytes
    assert port_dm.DEVICEMEM.kind_bytes["mesh_shard"] - k0 == 2 * x.nbytes
    assert [p.shape for p in split.parts] == [(4, 4)] * 4
    assert all(p is rep.parts[0] for p in rep.parts)
    np.testing.assert_array_equal(port_solver._read(split), x)
    np.testing.assert_array_equal(port_solver._read(rep), x)
    audit = port_dm.DEVICEMEM.audit(live_arrays=list(split.parts)
                                    + [rep.parts[0]])
    assert audit["unaccounted_bytes"] == 0
    assert audit["accounted_bytes"] > 0
