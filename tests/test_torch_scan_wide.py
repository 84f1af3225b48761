"""The provisioning solve past kernels B0's and B's old limits, held against
the JAX reference on the CPU: catalogs over 24 and 40 zones (Z * C past 64,
Z + C past 32), pods requesting 40 and 72 resource columns (past 32 and
64), and a catalog of 60,000 types (past 58,112).

The same seeded inputs, made with numpy, go through both packages: the
reference's `_solve_onebuf` and `solve_device` on JAX-CPU, the port's
`solve_packed` and `solve_device` with device="cpu" (the plain versions of
B0 and B). The packed int32 vectors must be equal element for element and
the decoded SolveResults node for node. The node-sharded scan's plain
version (kernel M's) is held against the reference's `sharded_solve_fn` on
8 virtual CPU devices at 40 zones and 40 columns. The kernels themselves
run these shapes on the card (tests/test_torch_kernels.py, chip_smoke.py
phase 4o).

Both packages' resource axes get EXTENDED for the module, and their
monotone unions of requested columns start empty for each case (so Rk is
the case's own, whatever ran before in the process); the axes, the unions
and both signature intern tables are left as found.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from karpenter_tpu.catalog import GeneratorConfig, generate_catalog
from karpenter_tpu.models import labels as L
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.pod import Pod, PodAffinityTerm
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.binpack import VirtualNode
from karpenter_tpu.ops.encode import encode_catalog, encode_pods
from karpenter_tpu.parallel import make_mesh as ref_make_mesh
from karpenter_tpu.parallel import run_sharded_solve as ref_run_sharded

from karpenter_tpu_torch import convert, parallel
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import solve_scan as ss
from karpenter_tpu_torch.ops import solver as port_solver

from test_torch_solver import ref_packed

# extended resources a long-lived operator meets (device plugins: MIG
# profiles, pod ENIs, EFA, Neuron, FPGAs, ...), enough for 72 columns
EXTENDED = tuple(f"devices.example.com/d{i:02d}" for i in range(70))
FAMILIES = ["m5", "c5", "r5"]


@pytest.fixture(scope="module", autouse=True)
def _extended_axes():
    """Both axes get EXTENDED, in one order; afterwards the axes, the
    requested-column unions and the intern tables are as found."""
    saved = [(m, list(m._RESOURCE_AXIS), dict(m._RESOURCE_INDEX))
             for m in (ref_res, port_res)]
    unions = [(m, set(m._cols_union)) for m in (ref_solver, port_solver)]
    encode_catalog(generate_catalog(GeneratorConfig(families=FAMILIES)))
    for name in ref_res.resource_axis() + EXTENDED:
        ref_res.register_resource(name)
        port_res.register_resource(name)
    assert port_res.resource_axis() == ref_res.resource_axis()
    yield
    for m, axis, index in saved:
        m._RESOURCE_AXIS[:] = axis
        m._RESOURCE_INDEX.clear()
        m._RESOURCE_INDEX.update(index)
    for m, cols in unions:
        m._cols_union.clear()
        m._cols_union.update(cols)
    ref_pod._sig_intern.clear()
    port_pod._sig_intern.clear()


@pytest.fixture(autouse=True)
def _fresh_unions():
    ref_solver._cols_union.clear()
    port_solver._cols_union.clear()


def _zones(Z):
    return [f"zone-{i:02d}" for i in range(Z)]


def _tiled(cat, copies: int, rng):
    """The catalog repeated `copies` times (distinct names, prices varied
    per copy by up to 10%, an offering in ten dropped): T * copies
    types."""
    T = cat.T
    price = np.concatenate([
        cat.price * rng.uniform(0.9, 1.1, (T, 1, 1)).astype(np.float32)
        for _ in range(copies)]).astype(np.float32)
    avail = np.tile(cat.available, (copies, 1, 1))
    avail &= rng.random(avail.shape) >= 0.1
    names = [f"{n}#{k}" for k in range(copies) for n in cat.names]
    return dataclasses.replace(
        cat, names=names, allocatable=np.tile(cat.allocatable, (copies, 1)),
        price=np.where(avail, price, np.float32(np.inf)).astype(np.float32),
        available=avail,
        reservation_cap=np.tile(cat.reservation_cap, (copies, 1, 1)),
        label_val=np.tile(cat.label_val, (copies, 1)),
        label_num=np.tile(cat.label_num, (copies, 1)),
        name_to_idx={n: i for i, n in enumerate(names)},
        is_block=(None if cat.is_block is None
                  else np.tile(cat.is_block, (copies, 1, 1))),
        cache_token=None)


def _catalog(seed: int, Z: int, n_ext: int, copies: int = 1,
             zone_ovh: bool = False):
    """The generator's m5/c5/r5 types over Z zones (3 capacity types),
    each given 2-16 of each of the first n_ext extended resources,
    repeated `copies` times; with zone_ovh a zone-varying daemonset
    reservation on three zones, the last one past zone 31 where Z is."""
    rng = np.random.default_rng(seed)
    types = generate_catalog(GeneratorConfig(zones=_zones(Z),
                                             families=FAMILIES))
    for it in types:
        for name in EXTENDED[:n_ext]:
            it.capacity[name] = float(rng.integers(2, 17))
    cat = encode_catalog(types)
    if copies > 1:
        cat = _tiled(cat, copies, rng)
    if zone_ovh:
        R = cat.allocatable.shape[1]
        zovh = np.zeros((cat.T, cat.Z, R), np.float32)
        zovh[:, 0, 0] = np.float32(0.5)
        zovh[:, 1, 1] = rng.choice([256.0, 512.0], cat.T).astype(np.float32)
        zovh[:, Z - 1, 0] = np.float32(1.0)
        cat = dataclasses.replace(cat, zone_overhead=zovh)
    return cat


def _pods(seed: int, Z: int, n_ext: int, n_groups: int, per_group: int,
          anti: bool = False):
    """n_groups distinct pod shapes of per_group pods each: cpu and
    memory, the extended columns j with j % n_groups == g and each other
    with probability 0.2 (so every column is requested); every fourth
    group pinned to a zone (the highest ones included), every fifth to
    spot; with anti group 3 anti-affine to group 4 (a conflict row)."""
    rng = np.random.default_rng(seed)
    cpus = ["250m", "500m", "1", "2", "3"]
    mems = ["512Mi", "1Gi", "2Gi", "4Gi"]
    pods = []
    for g in range(n_groups):
        req = {"cpu": cpus[g % 5], "memory": mems[(g // 5) % 4]}
        for j, name in enumerate(EXTENDED[:n_ext]):
            if j % n_groups == g or rng.random() < 0.2:
                req[name] = int(rng.integers(1, 3))
        sel = {}
        if g % 4 == 1:
            sel[L.ZONE] = _zones(Z)[Z - 1 - (g // 4) % Z]
        if g % 5 == 2:
            sel[L.CAPACITY_TYPE] = "spot"
        kw = dict(node_selector=sel) if sel else {}
        if anti and g in (3, 4):
            kw["labels"] = {"app": f"g{g}"}
        if anti and g == 3:
            kw["affinity_terms"] = [PodAffinityTerm(
                topology_key=L.HOSTNAME, label_selector={"app": "g4"},
                anti=True)]
        pods += [Pod(name=f"g{g}-{i}", requests=Resources.parse(req), **kw)
                 for i in range(per_group)]
    return pods


def _existing(seed: int, cat, n: int):
    """n open nodes of random types with random zone and captype masks
    (every bit position of the wide words in use), loaded to a random share
    of their cpu and memory."""
    rng = np.random.default_rng(seed)
    R = cat.allocatable.shape[1]
    nodes = []
    for i in range(n):
        t = int(rng.integers(0, cat.T))
        cum = np.zeros(R, np.float32)
        cum[:2] = cat.allocatable[t, :2] * rng.uniform(0.0, 0.8, 2)
        zm = rng.random(cat.Z) < 0.7
        zm[-1] = True
        node = VirtualNode(type_idx=t, zone_mask=zm,
                           cap_mask=rng.random(cat.C) < 0.8, cum=cum)
        node.existing_name = f"n{i}"
        nodes.append(node)
    return nodes


def _equal_results(a, b, what: str) -> None:
    """Two SolveResults node for node, exactly."""
    assert len(a.nodes) == len(b.nodes), (what, len(a.nodes), len(b.nodes))
    for i, (x, y) in enumerate(zip(a.nodes, b.nodes)):
        assert x.type_idx == y.type_idx, f"{what} node {i}: type"
        assert x.pods_by_group == y.pods_by_group, f"{what} node {i}: takes"
        np.testing.assert_array_equal(np.asarray(x.zone_mask),
                                      np.asarray(y.zone_mask))
        np.testing.assert_array_equal(np.asarray(x.cap_mask),
                                      np.asarray(y.cap_mask))
        np.testing.assert_array_equal(np.asarray(x.cum, np.float32),
                                      np.asarray(y.cum, np.float32))
        assert x.existing_name == y.existing_name
    assert a.unschedulable == b.unschedulable, what
    assert a.launches == b.launches, what


def _check(cat, enc, existing=()):
    """The port's packed vector == the reference's _solve_onebuf at the
    port's statics; the port's SolveResult == the reference's
    solve_device's. Returns (statics, the port's result)."""
    existing = list(existing)
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(
        {k: v for k, v in vars(enc).items() if k != "groups"})
    pex = convert.nodes_from_arrays(vars(n) for n in existing)
    got, st = port_solver.solve_packed(pcat, penc, pex, device="cpu")
    want = ref_packed(cat, enc, existing, st)
    np.testing.assert_array_equal(got, want)
    d = port_solver.solve_device(pcat, penc, pex, device="cpu")
    _equal_results(ref_solver.solve_device(cat, enc, existing or None), d,
                   "reference vs port")
    return st, d


# (Z, extended columns (Rk = 2 + them), copies of the catalog, groups,
# pods a group, existing nodes, zone overhead, an anti-affine group)
CASES = {
    "z24_rk40": (24, 38, 1, 24, 6, 0, False, False),
    "z40_rk40_resumed": (40, 38, 1, 24, 6, 8, False, True),
    "z40_rk72_zone_overhead": (40, 70, 1, 20, 5, 0, True, False),
    "t60000_rk72": (3, 70, 1_250, 12, 4, 0, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wide_solve_equals_the_reference(case):
    Z, n_ext, copies, groups, per, n_ex, zovh, anti = CASES[case]
    cat = _catalog(7, Z, n_ext, copies, zovh)
    enc = encode_pods(_pods(11, Z, n_ext, groups, per, anti), cat)
    existing = _existing(13, cat, n_ex)
    st, d = _check(cat, enc, existing)
    T, Rk = cat.T, len(st["cols"])
    assert (T, cat.Z, cat.C, Rk) == (48 * copies, Z, 3, 2 + n_ext)
    assert st["zone_ovh"] == zovh and st["track_conflicts"] == anti
    # the shapes kernels B0 and B once refused: the bits take as many
    # words as they need, and the layout still fits a block
    W = -(-st["Gp"] // 32) if anti else 0
    nb, aw = ss._node_words(Z, 3), ss._avail_words(Z, 3)
    assert (nb, aw) == (-(-(Z + 3) // 32), -(-(Z * 3) // 64))
    assert ss._rec_words(Rk, T, W, Z, 3) == -(-(ss.REC_HDR + 2 * nb + Rk
                                                 + -(-T // 32) + W) // 4) * 4
    lay = ss._scan_layout(st["n_max"], Rk, W, Z, 3, T, zovh)
    assert lay.smem_bytes + ss.STATIC_SMEM <= 232_448
    assert d.nodes and d.launches


def test_wide_sharded_scan_equals_the_reference():
    """The node-sharded scan at 40 zones and 40 columns over 8 virtual CPU
    shards (kernel M's plain version) equals the reference's
    sharded_solve_fn on 8 virtual devices, output for output, with the
    nodes spanning every shard."""
    rng = np.random.default_rng(5)
    T, Z, C, R, Gp, n_max = 64, 40, 3, 40, 24, 512
    alloc = rng.uniform(8.0, 64.0, (T, R)).astype(np.float32)
    alloc[rng.random((T, R)) < 0.25] = 0.0
    alloc[:, :2] = rng.uniform(16.0, 64.0, (T, 2)).astype(np.float32)
    price = rng.uniform(0.1, 5.0, (T, Z, C)).astype(np.float32)
    avail = rng.random((T, Z, C)) < 0.6
    requests = np.zeros((Gp, R), np.float32)
    for g in range(Gp):
        cols = [0, 1] + list(rng.choice(np.arange(2, R), size=4,
                                        replace=False))
        requests[g, cols] = rng.uniform(2.0, 16.0, len(cols))
    counts = rng.integers(20, 80, Gp).astype(np.int32)
    compat = rng.random((Gp, T)) < 0.7
    allow_zone = rng.random((Gp, Z)) < 0.5
    allow_zone[:, Z - 1] = True
    allow_cap = rng.random((Gp, C)) < 0.8
    allow_cap[:, 0] = True
    max_per_node = np.where(rng.random(Gp) < 0.2, rng.integers(1, 4, Gp),
                            0).astype(np.int32)
    args = (alloc, price, avail, requests, counts, compat, allow_zone,
            allow_cap, max_per_node)
    want = [np.asarray(x) for x in ref_run_sharded(ref_make_mesh(8), *args,
                                                    n_max=n_max)]
    with parallel.virtual_devices(8, "cpu"):
        mesh = parallel.make_mesh(8)
    got = [x.numpy() for x in parallel.run_sharded_solve(mesh, *args,
                                                         n_max=n_max)]
    names = ("ntype", "cum", "zmask", "cmask", "nopen", "nused", "takes",
             "unsched", "overflow")
    for a, b, name in zip(got, want, names):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    nused = int(got[5])
    assert not bool(got[8]) and nused > 7 * n_max // 8, nused
    assert ss._node_words(Z, C) == 2 and ss._avail_words(Z, C) == 2
