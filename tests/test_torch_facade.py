"""The port's solver facade held against the JAX reference's.

Each scenario builds one cluster (catalog, NodePool, NodeClass,
daemonsets, pods, existing nodes) from a seed with the reference's own
constructors and carries it across with `karpenter_tpu_torch.convert`, so
both facades see the same cluster. The reference's
`Solver(..., backend="device")` runs on JAX-CPU, the port's
`Solver(..., backend="device", device="cpu")` runs the kernels' plain
versions, and both packages' "host" and "native" rungs run too. Every
SolveOutput (stats excluded) must be equal element for element: launch
types, zones, capacity types, prices, override lists, pod keys, requests
and labels, existing placements and unschedulable keys. Tolerance: exact.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import pytest

from karpenter_tpu.catalog import CatalogProvider as RefProvider
from karpenter_tpu.catalog import GeneratorConfig, generate_catalog
from karpenter_tpu.catalog import small_catalog
from karpenter_tpu.metrics import SOLVER_FALLBACKS as REF_FALLBACKS
from karpenter_tpu.models import labels as L
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.instancetype import Offering
from karpenter_tpu.models.nodepool import NodeClassSpec, NodePool
from karpenter_tpu.models.overlay import NodeOverlay
from karpenter_tpu.models.pod import (DaemonSet, Pod, PodAffinityTerm, Taint,
                                      Toleration, TopologySpreadConstraint)
from karpenter_tpu.models.requirements import (Operator, Requirement,
                                               Requirements)
from karpenter_tpu.models.resources import NVIDIA_GPU, Resources
from karpenter_tpu.ops import native as ref_native
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.binpack import solve_host
from karpenter_tpu.ops.encode import encode_catalog, encode_pods
from karpenter_tpu.ops.facade import Solver as RefSolver

from karpenter_tpu_torch import convert
from karpenter_tpu_torch.catalog import CatalogProvider as PortProvider
from karpenter_tpu_torch.metrics import SOLVER_FALLBACKS as PORT_FALLBACKS
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import encode as port_encode
from karpenter_tpu_torch.ops import native as port_native
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.ops.encode_cache import EncodeArena, EncodeCache
from karpenter_tpu_torch.ops.facade import SharedCatalogCache
from karpenter_tpu_torch.ops.facade import Solver as PortSolver

port_object = convert.port_object
RUNGS = ("device", "host", "native")
BLOCK_TYPE, BLOCK_ZONE = "g5.4xlarge", "zone-b"
CPUS = ("100m", "250m", "500m", "1", "2", "3")
MEMS = ("128Mi", "512Mi", "1Gi", "2Gi", "4Gi")


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """The reference facades here touch its process-global planes. After
    this module: empty its signature intern table (a rotation; see
    test_torch_encode.py), and reset its device-resident state, delta
    memos and integrity meter, as its own test modules do between tests,
    so later modules in the same process start from clean planes."""
    yield
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
    """Give both packages' resource axes the same columns in the same
    order (see test_torch_encode.py): the two encodes must share column
    order. Encoding the generated catalog on the reference first puts the
    generator's resources in the order either package registers them,
    whichever module of this process encoded a catalog before."""
    encode_catalog(generate_catalog())
    ref_res.register_resource(NVIDIA_GPU)
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    assert port_res.resource_axis() == ref_res.resource_axis()


# --- scenarios -------------------------------------------------------------


@dataclass
class Cluster:
    """One cluster in the reference's objects. `pregrouped` and
    `existing_pods` hold indices into `pods` / `residents`, so the port's
    copy keeps the same object identities."""

    types: list
    pool: NodePool
    pods: list
    node_class: Optional[NodeClassSpec] = None
    daemonsets: Optional[list] = None
    capacity_cap: Optional[Resources] = None
    existing: Optional[list] = None
    residents: list = field(default_factory=list)
    existing_pods: Optional[Dict[str, List[int]]] = None
    pregrouped: Optional[List[List[int]]] = None
    overlays: Optional[list] = None
    marks: list = field(default_factory=list)


def grid_pods(rng: np.random.Generator, n: int, prefix: str, **kw):
    ci = rng.integers(0, len(CPUS), n)
    mi = rng.integers(0, len(MEMS), n)
    return [Pod(name=f"{prefix}{i}", requests=Resources.parse(
        {"cpu": CPUS[c], "memory": MEMS[m]}), **kw)
        for i, (c, m) in enumerate(zip(ci.tolist(), mi.tolist()))]


def _catalog(families=("m5", "c5", "r5", "m6")):
    return generate_catalog(GeneratorConfig(families=list(families)))


def _with_block(types):
    """small_catalog(8) plus one prepaid capacity block (the gate's
    subject): g5.4xlarge in zone-b at price 0."""
    for t in types:
        if t.name == BLOCK_TYPE:
            t.offerings.append(Offering(
                zone=BLOCK_ZONE, capacity_type=L.CAPACITY_RESERVED, price=0.0,
                reservation_id=f"cb-{BLOCK_TYPE}-{BLOCK_ZONE}",
                reservation_capacity=2, reservation_type="capacity-block"))
    return types


def _zone_term(sel, anti=False):
    return PodAffinityTerm(topology_key=L.ZONE, label_selector=sel, anti=anti)


def _host_term(sel, anti=False):
    return PodAffinityTerm(topology_key=L.HOSTNAME, label_selector=sel,
                           anti=anti)


def scenario(name: str, seed: int = 0) -> Cluster:
    rng = np.random.default_rng(seed)
    pool = NodePool(name="default")
    if name == "plain":
        return Cluster(_catalog(), pool, grid_pods(rng, 120, "p"))
    if name == "daemonsets":
        ds = [DaemonSet(name="logging", requests=Resources.parse(
                  {"cpu": "250m", "memory": "256Mi"})),
              DaemonSet(name="gpu-agent", requests=Resources.parse(
                  {"cpu": "1"}), node_selector={
                      L.INSTANCE_GPU_MANUFACTURER: "nvidia"})]
        return Cluster(small_catalog(8), pool, grid_pods(rng, 90, "p"),
                       daemonsets=ds)
    if name == "capacity_cap":
        return Cluster(_catalog(), pool, grid_pods(rng, 80, "p"),
                       capacity_cap=Resources.parse({"cpu": "8",
                                                     "memory": "64Gi"}))
    if name == "capacity_block":
        pool.requirements.add(Requirement(L.ZONE, Operator.IN, (BLOCK_ZONE,)))
        gpu = [Pod(name=f"g{i}", requests=Resources.parse(
            {"cpu": "2", "memory": "4Gi", NVIDIA_GPU: 1})) for i in range(3)]
        reserved = [Pod(name=f"r{i}", requests=Resources.parse(
            {"cpu": "2", "memory": "4Gi", NVIDIA_GPU: 1}),
            node_selector={L.CAPACITY_TYPE: L.CAPACITY_RESERVED})
            for i in range(2)]
        return Cluster(_with_block(small_catalog(8)), pool,
                       gpu + reserved + grid_pods(rng, 20, "p"))
    if name == "min_values":
        pool = NodePool(name="default", requirements=Requirements(
            Requirement(L.INSTANCE_TYPE, Operator.EXISTS, min_values=12),
            Requirement(L.ZONE, Operator.EXISTS, min_values=2)))
        return Cluster(_catalog(), pool, grid_pods(rng, 70, "p"))
    if name == "zone_affinity":
        a = grid_pods(rng, 6, "a", labels={"app": "a"},
                      affinity_terms=[_zone_term({"app": "b"}, anti=True)])
        b = grid_pods(rng, 6, "b", labels={"app": "b"})
        solo = grid_pods(rng, 5, "s", labels={"app": "solo"},
                         affinity_terms=[_zone_term({"app": "solo"},
                                                    anti=True)])
        near = grid_pods(rng, 4, "n", labels={"app": "near"},
                         affinity_terms=[_zone_term({"app": "b"})])
        pinned = grid_pods(rng, 8, "z", node_affinity=[{
            "key": L.ZONE, "operator": "In", "values": ("zone-c",)}])
        return Cluster(_catalog(), pool, a + b + solo + near + pinned
                       + grid_pods(rng, 30, "p"))
    if name == "spread":
        hard = grid_pods(rng, 14, "h", labels={"app": "web"},
                         topology_spread=[TopologySpreadConstraint(
                             topology_key=L.ZONE, max_skew=1,
                             label_selector={"app": "web"})])
        soft = grid_pods(rng, 9, "s", labels={"app": "api"},
                         topology_spread=[TopologySpreadConstraint(
                             topology_key=L.ZONE, max_skew=2,
                             when_unsatisfiable="ScheduleAnyway",
                             label_selector={"app": "api"})])
        return Cluster(_catalog(), pool, hard + soft + grid_pods(rng, 30, "p"))
    if name == "colocation":
        pods = []
        for b in range(4):
            pods += [Pod(name=f"b{b}-{i}", labels={"bundle": f"b{b}"},
                         requests=Resources.parse({"cpu": "500m",
                                                   "memory": "1Gi"}),
                         affinity_terms=[_host_term({"bundle": f"b{b}"})])
                     for i in range(3)]
        rider = [Pod(name="rider", requests=Resources.parse({"cpu": "1"}),
                     affinity_terms=[_host_term({"bundle": "b0"})])]
        anti = grid_pods(rng, 5, "x", labels={"app": "x"},
                         affinity_terms=[_host_term({"app": "x"}, anti=True)])
        return Cluster(_catalog(), pool, pods + rider + anti
                       + grid_pods(rng, 40, "p"))
    if name == "taint_dropped":
        pool = NodePool(name="tainted", taints=[
            Taint(key="team", value="ml", effect="NoSchedule")])
        ok = grid_pods(rng, 30, "t", tolerations=[
            Toleration(key="team", operator="Equal", value="ml",
                       effect="NoSchedule")])
        return Cluster(_catalog(), pool, ok + grid_pods(rng, 25, "d"))
    if name == "existing":
        types = _catalog()
        residents = grid_pods(rng, 40, "res", labels={"app": "r"})
        residents += grid_pods(rng, 3, "ra", labels={"app": "lonely"},
                               affinity_terms=[_host_term(
                                   {"app": "lonely"}, anti=True)])
        cat = encode_catalog(types)
        enc = encode_pods(residents, cat)
        base = solve_host(cat, enc)
        pos = {id(p): i for i, p in enumerate(residents)}
        cursor, on_node = {}, {}
        for i, n in enumerate(base.nodes):
            n.existing_name = f"node-{i}"
            idx = []
            for g, cnt in sorted(n.pods_by_group.items()):
                at = cursor.get(g, 0)
                cursor[g] = at + cnt
                idx += [pos[id(p)] for p in enc.groups[g].pods[at:at + cnt]]
            on_node[n.existing_name] = idx
        new = grid_pods(rng, 60, "p", labels={"app": "r"})
        new += grid_pods(rng, 4, "na", labels={"app": "lonely"},
                         affinity_terms=[_host_term({"app": "lonely"},
                                                    anti=True)])
        return Cluster(types, pool, new, existing=base.nodes,
                       residents=residents, existing_pods=on_node)
    if name == "zone_overhead":
        ds = [DaemonSet(name="zonal", requests=Resources.parse(
            {"cpu": "500m", "memory": "512Mi"}),
            node_selector={L.ZONE: "zone-a"})]
        return Cluster(_catalog(), pool, grid_pods(rng, 80, "p"),
                       daemonsets=ds)
    if name == "ice":
        types = _catalog()
        marks = [(t.name, "zone-a", L.CAPACITY_SPOT) for t in types[::3]]
        return Cluster(types, pool, grid_pods(rng, 80, "p"), marks=marks)
    if name == "pregrouped":
        pods, groups = [], []
        for g in range(6):
            cpu, mem = CPUS[g % len(CPUS)], MEMS[g % len(MEMS)]
            start = len(pods)
            pods += [Pod(name=f"g{g}-{i}", labels={"g": str(g)},
                         requests=Resources.parse({"cpu": cpu, "memory": mem}))
                     for i in range(int(rng.integers(3, 15)))]
            groups.append(list(range(start, len(pods))))
        return Cluster(_catalog(), pool, pods, pregrouped=groups)
    if name == "node_class":
        return Cluster(_catalog(), pool, grid_pods(rng, 60, "p"),
                       node_class=NodeClassSpec(name="two-zones",
                                                zones=["zone-a", "zone-c"]),
                       overlays=[NodeOverlay(
                           name="cheaper-m5",
                           requirements=Requirements(Requirement(
                               L.INSTANCE_FAMILY, Operator.IN, ("m5",))),
                           price_adjustment="-20%")])
    raise KeyError(name)


SCENARIOS = ("plain", "daemonsets", "capacity_cap", "capacity_block",
             "min_values", "zone_affinity", "spread", "colocation",
             "taint_dropped", "existing", "zone_overhead", "ice", "pregrouped",
             "node_class")


def _ref_side(c: Cluster):
    prov = RefProvider(lambda: c.types)
    if c.overlays:
        prov.set_overlays(c.overlays)
    return prov, c


def _port_side(c: Cluster):
    """The port's copy of the whole cluster."""
    types = port_object(c.types)
    prov = PortProvider(lambda: types)
    if c.overlays:
        prov.set_overlays(port_object(c.overlays))
    pods = port_object(c.pods)
    residents = port_object(c.residents)
    return prov, Cluster(
        types=types, pool=port_object(c.pool), pods=pods,
        node_class=port_object(c.node_class),
        daemonsets=port_object(c.daemonsets),
        capacity_cap=port_object(c.capacity_cap),
        existing=(convert.nodes_from_arrays(vars(n) for n in c.existing)
                  if c.existing is not None else None),
        residents=residents, existing_pods=c.existing_pods,
        pregrouped=c.pregrouped, marks=c.marks)


def _solve(solver, c: Cluster):
    ex_pods = ({k: [c.residents[i] for i in v]
                for k, v in c.existing_pods.items()}
               if c.existing_pods is not None else None)
    pre = ([[c.pods[i] for i in g] for g in c.pregrouped]
           if c.pregrouped is not None else None)
    return solver.solve(c.pods, c.pool, node_class=c.node_class,
                        existing=c.existing, capacity_cap=c.capacity_cap,
                        existing_pods=ex_pods, pregrouped=pre,
                        daemonsets=c.daemonsets)


def out_tuple(out):
    """Everything a SolveOutput decides, stats excluded."""
    return ([(l.instance_type, l.zone, l.capacity_type, l.price,
              list(l.overrides), list(l.pod_keys), dict(l.requests),
              dict(l.labels)) for l in out.launches],
            {k: list(v) for k, v in out.existing_placements.items()},
            list(out.unschedulable))


def _facades(rung: str, name: str, seed: int = 0):
    c = scenario(name, seed)
    rprov, rc = _ref_side(c)
    pprov, pc = _port_side(c)
    ref = RefSolver(rprov, backend=rung)
    port = PortSolver(pprov, backend=rung,
                      device="cpu" if rung == "device" else None)
    for t, z, ct in c.marks:
        rprov.unavailable.mark_unavailable(t, z, ct, reason="ICE")
        pprov.unavailable.mark_unavailable(t, z, ct, reason="ICE")
    return ref, rc, port, pc


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_facade_output_equal(name, rung):
    ref, rc, port, pc = _facades(rung, name)
    want = _solve(ref, rc)
    got = _solve(port, pc)
    assert out_tuple(got) == out_tuple(want)
    assert got.launches or got.existing_placements, "scenario placed nothing"
    assert port.stats == ref.stats
    if name == "ice":
        # one ICE mark more: the catalog view rebuilds once per epoch, not
        # once per solve, on both sides
        t, z, ct = rc.types[1].name, "zone-b", L.CAPACITY_ON_DEMAND
        ref.catalog.unavailable.mark_unavailable(t, z, ct)
        port.catalog.unavailable.mark_unavailable(t, z, ct)
        for _ in range(2):
            assert out_tuple(_solve(port, pc)) == out_tuple(_solve(ref, rc))
        assert port.stats["catalog_rebuilds"] == 2
        assert port.stats == ref.stats


def test_rungs_agree_with_each_other():
    """The port's three rungs give one answer (the ladder's premise)."""
    outs = []
    for rung in RUNGS:
        _, _, port, pc = _facades(rung, "zone_affinity")
        outs.append(out_tuple(_solve(port, pc)))
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("name", ("plain", "existing", "capacity_block"))
def test_resumed_solve_equal(name):
    """A second solve resumes from the first solve's launches, as the
    provisioner's next reconcile does: the launched nodes become existing
    VirtualNodes (virtual_node_from_claim) and their pods existing_pods."""
    from karpenter_tpu.models.nodeclaim import NodeClaim
    from karpenter_tpu.ops.facade import virtual_node_from_claim as ref_vn
    from karpenter_tpu_torch.ops.facade import virtual_node_from_claim as port_vn
    ref, rc, port, pc = _facades("device", name)
    first = _solve(ref, rc)
    assert out_tuple(_solve(port, pc)) == out_tuple(first)
    rcat, pcat = ref.tensors(rc.node_class), port.tensors(pc.node_class)
    by_key = {f"{p.namespace}/{p.name}": i for i, p in enumerate(rc.pods)}
    rex, pex, on_node = [], [], {}
    for i, l in enumerate(first.launches):
        claim = NodeClaim(name=f"claim-{i}", nodepool=rc.pool.name,
                          instance_type=l.instance_type, zone=l.zone,
                          capacity_type=l.capacity_type)
        rex.append(ref_vn(claim, rcat, l.requests))
        pex.append(port_vn(port_object(claim), pcat,
                           port_object(l.requests)))
        on_node[claim.name] = [by_key[k] for k in l.pod_keys]
    rng = np.random.default_rng(1)
    new = grid_pods(rng, 50, "q")
    rc2 = Cluster(rc.types, rc.pool, new, node_class=rc.node_class,
                  existing=rex, residents=rc.pods, existing_pods=on_node)
    pc2 = Cluster(pc.types, pc.pool, port_object(new),
                  node_class=pc.node_class, existing=pex, residents=pc.pods,
                  existing_pods=on_node)
    want, got = _solve(ref, rc2), _solve(port, pc2)
    assert out_tuple(got) == out_tuple(want)
    assert got.existing_placements


# --- the catalog provider and the encode cache ------------------------------


@pytest.mark.parametrize("nc", [
    None, dict(zones=["zone-b"]), dict(instance_store_policy="raid0"),
    dict(block_device_gib=20.0)])
def test_provider_list_equal(nc):
    """CatalogProvider.list() per NodeClassSpec, with an overlay and an
    ICE mark, equals the reference's type for type."""
    types = _with_block(small_catalog(8))
    ref = RefProvider(lambda: types)
    ptypes = port_object(types)
    port = PortProvider(lambda: ptypes)
    ov = [NodeOverlay(name="bias", requirements=Requirements(Requirement(
              L.INSTANCE_FAMILY, Operator.IN, ("c5", "g5"))),
              price_adjustment="+10%",
              capacity=Resources({"example.com/dongle": 2.0})),
          NodeOverlay(name="flat", weight=5, requirements=Requirements(
              Requirement(L.INSTANCE_FAMILY, Operator.IN, ("c5",))),
              price_adjustment="0.05")]
    ref.set_overlays(ov)
    port.set_overlays(port_object(ov))
    for p in (ref, port):
        p.unavailable.mark_unavailable("m5.large", "zone-a", "spot")
    rnc = NodeClassSpec(**nc) if nc else None
    pnc = port_object(rnc)
    want, got = ref.list(rnc), port.list(pnc)
    assert port.epoch == ref.epoch
    assert [vars(t)["name"] for t in got] == [t.name for t in want]
    for a, b in zip(got, want):
        assert dict(a.capacity) == dict(b.capacity), a.name
        assert [vars(o) for o in a.offerings] == \
            [vars(o) for o in b.offerings], a.name
        assert dict(a.allocatable()) == dict(b.allocatable()), a.name


def _enc_equal(a, b):
    for f in ("requests", "counts", "compat", "allow_zone", "allow_cap",
              "max_per_node", "spread_zone", "spread_soft", "conflict",
              "compat_hard", "zone_hard", "cap_hard"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [g.representative.name for g in a.groups] == \
        [g.representative.name for g in b.groups]
    assert a.dropped_keys == b.dropped_keys


def test_encode_cached_equal():
    """encode_pods with cache= and arena= equals the uncached call and the
    reference's, cold and warm, and the warm call is all hits."""
    c = scenario("zone_affinity", 3)
    rng = np.random.default_rng(3)
    c.pods += grid_pods(rng, 20, "t", tolerations=[Toleration(
        key="team", operator="Exists")])
    pool = NodePool(name="p", taints=[Taint(key="team", value="x",
                                            effect="NoSchedule")])
    pc = _port_side(Cluster(c.types, pool, c.pods))[1]
    ref_cat = encode_catalog(c.types)
    cat = port_encode.encode_catalog(pc.types)
    cat.cache_token = ("test", 1)
    ref_cat.cache_token = ("test", 1)
    cache, arena = EncodeCache(), EncodeArena()
    template = pc.pool.template_labels()
    ctx = cache.context_for(cat, pc.pool.requirements, pc.pool.taints,
                            template)
    kw = dict(extra_requirements=pc.pool.requirements, taints=pc.pool.taints,
              template_labels=template)
    plain = port_encode.encode_pods(pc.pods, cat, **kw)
    want = encode_pods(c.pods, ref_cat, extra_requirements=pool.requirements,
                       taints=pool.taints,
                       template_labels=pool.template_labels())
    _enc_equal(plain, want)
    assert plain.dropped_keys
    for round_ in range(2):
        got = port_encode.encode_pods(pc.pods, cat, cache=ctx, arena=arena,
                                      **kw)
        _enc_equal(got, plain)
        if round_:
            assert got.cache_misses == 0 and got.cache_hits > 0
    pre = port_encode.encode_pods(
        [], cat, pregrouped=[[p] for p in pc.pods[:4]], **kw)
    ref_pre = encode_pods([], ref_cat, pregrouped=[[p] for p in c.pods[:4]],
                          extra_requirements=pool.requirements,
                          taints=pool.taints,
                          template_labels=pool.template_labels())
    _enc_equal(pre, ref_pre)


# --- the native rung --------------------------------------------------------


def _fuzz_pods(rng: random.Random, n: int):
    """The reference fuzz's pod mix (as in test_torch_solver.py)."""
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
                topology_key=L.HOSTNAME,
                label_selector={"app": kw["labels"]["app"]}, anti=True)]
        pods.append(Pod(name=f"f{i}", **kw))
    return pods


def _same_result(a, b):
    assert len(a.nodes) == len(b.nodes)
    for x, y in zip(a.nodes, b.nodes):
        assert x.type_idx == y.type_idx and x.pods_by_group == y.pods_by_group
        assert np.array_equal(x.zone_mask, y.zone_mask)
        assert np.array_equal(x.cap_mask, y.cap_mask)
        assert np.array_equal(x.cum, y.cum)
        assert x.existing_name == y.existing_name
    assert a.unschedulable == b.unschedulable
    assert a.launches == b.launches


@pytest.mark.parametrize("seed", range(8))
def test_native_bridge_equal(seed):
    """The port's ctypes bridge equals the reference's solve_native on the
    fuzz seeds of test_torch_solver.py, fresh and resumed."""
    assert port_native.available() and ref_native.available()
    rng = random.Random(seed * 7919 + 13)
    cat = encode_catalog(generate_catalog(GeneratorConfig(
        families=rng.sample(["m5", "c5", "r5", "m6", "c6", "r6", "t3"], 4))))
    T, Z, C = cat.available.shape
    for _ in range(rng.randrange(0, 30)):
        cat.available[rng.randrange(T), rng.randrange(Z),
                      rng.randrange(C)] = False
    enc = encode_pods(_fuzz_pods(rng, rng.randrange(100, 400)), cat)
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(
        {k: v for k, v in vars(enc).items() if k != "groups"})
    want = ref_native.solve_native(cat, enc)
    got = port_native.solve_native(pcat, penc)
    _same_result(got, want)
    existing = [n for n in want.nodes[:6]]
    for i, n in enumerate(existing):
        n.existing_name = f"n{i}"
        n.prior_by_group = {0: 1} if i == 0 else {}
    pex = convert.nodes_from_arrays(vars(n) for n in existing)
    _same_result(port_native.solve_native(pcat, penc, pex),
                 ref_native.solve_native(cat, enc, existing))


def test_native_builds_outside_the_source_tree():
    """The bridge builds into build/karpenter_tpu_torch/, never beside
    native/ffd.cpp."""
    from karpenter_tpu_torch.ops import _build
    lib = _build.load_native()
    assert _build.BUILD_DIR in __import__("pathlib").Path(lib._name).parents


# --- degradation and integrity are visible ----------------------------------


def _corrupt(res):
    """A wrong answer: one extra pod of the first node's lowest group (pod
    accounting and, on small nodes, capacity)."""
    n = res.nodes[0]
    g = min(n.pods_by_group)
    n.pods_by_group[g] += 1
    return res


def _corrupting(real):
    """solve_device that returns a wrong answer (_corrupt)."""
    def corrupt(*a, **kw):
        return _corrupt(real(*a, **kw))
    return corrupt


def _failing(*a, **kw):
    raise RuntimeError("injected device fault")


def _inject_fault(backend):
    raise port_solver.InjectedFault(f"injected {backend} fault")


def _fallback_counts(metric):
    return {to: metric.value(from_backend="device", to_backend=to)
            for to in ("native", "host")}


@pytest.fixture
def _quiet_planes():
    """A fault test leaves violation markers in both flight-recorder rings
    and the solver's degraded-mode gauge at 1: give each package a fresh
    ring for the test and clear the gauge after it."""
    from karpenter_tpu.metrics import DEGRADED_MODE as REF_DEGRADED
    from karpenter_tpu.obs.tracer import TRACER as REF_TRACER
    from karpenter_tpu_torch.metrics import DEGRADED_MODE as PORT_DEGRADED
    from karpenter_tpu_torch.obs.tracer import TRACER as PORT_TRACER
    rings = [(t, t.recorder) for t in (REF_TRACER, PORT_TRACER)]
    for t, old in rings:
        t.recorder = type(old)(size=old.size)
    yield
    for t, old in rings:
        t.recorder = old
    for gauge in (REF_DEGRADED, PORT_DEGRADED):
        gauge.set(0, component="solver")


@pytest.mark.parametrize("fault", ("corrupt", "raise"))
def test_device_faults_are_metered_like_the_reference(fault, monkeypatch,
                                                      _quiet_planes):
    """An injected corruption of the device result (the port's corruption
    hook) is caught by the oracle (quarantine + recovery through the
    fallback rung); an injected device fault (the dispatch hook raising
    InjectedFault) degrades through _degrade. Either way the port's stats,
    its SOLVER_FALLBACKS delta and its shipped output equal the
    reference's, and the device path stays suspended for the cooldown."""
    if fault == "corrupt":
        monkeypatch.setattr(ref_solver, "solve_device",
                            _corrupting(ref_solver.solve_device))
        # the port's "result" seam; the hook also sees the request-matrix
        # and resident uploads ("gbuf", "resident"), which it leaves alone
        monkeypatch.setattr(
            port_solver, "_corruption_hook",
            lambda target, obj, *key: (_corrupt(obj) if target == "result"
                                       else None))
    else:
        monkeypatch.setattr(ref_solver, "solve_device", _failing)
        monkeypatch.setattr(port_solver, "_dispatch_fault_hook",
                            _inject_fault)
    ref, rc, port, pc = _facades("device", "plain")
    r0, p0 = _fallback_counts(REF_FALLBACKS), _fallback_counts(PORT_FALLBACKS)
    want, got = _solve(ref, rc), _solve(port, pc)
    assert out_tuple(got) == out_tuple(want)
    assert port.stats == ref.stats
    assert port.stats["device_fallbacks"] == 1
    if fault == "corrupt":
        assert port.stats["integrity_violations"] >= 1
        assert port.stats["integrity_recoveries"] == 1
    r1, p1 = _fallback_counts(REF_FALLBACKS), _fallback_counts(PORT_FALLBACKS)
    assert {k: p1[k] - p0[k] for k in p1} == {k: r1[k] - r0[k] for k in r1}
    assert port._device_suspended == ref._device_suspended == \
        PortSolver.FALLBACK_COOLDOWN
    # the next solve is rerouted while the cooldown burns down
    assert out_tuple(_solve(port, pc)) == out_tuple(_solve(ref, rc))
    assert port._device_suspended == ref._device_suspended


def _refuse_shapes(*a, **kw):
    raise ValueError("solve_scan supports 1..32 resource columns, got 40")


def _refuse_cluster(*a, **kw):
    raise RuntimeError("solve_scan: the card cannot co-schedule a cluster "
                       "of 16 blocks at 99000 bytes of shared memory a "
                       "block")


def _refuse_build(*a, **kw):
    raise RuntimeError("nvcc failed for solve_scan.cu (exit 1)")


@pytest.mark.parametrize("refusal", (_refuse_shapes, _refuse_cluster,
                                     _refuse_build))
def test_kernel_refusal_raises_out_of_solve(refusal, monkeypatch,
                                            _quiet_planes):
    """A kernel wrapper that refuses its shapes, cannot launch, or whose
    kernel does not build raises out of Solver.solve: the device rung
    does not degrade to another rung on its own (no fallback, no
    suspension, SOLVER_FALLBACKS unchanged)."""
    monkeypatch.setattr(port_solver, "solve_scan", refusal)
    _, _, port, pc = _facades("device", "plain")
    p0 = _fallback_counts(PORT_FALLBACKS)
    with pytest.raises((ValueError, RuntimeError)) as err:
        _solve(port, pc)
    assert err.value.args[0].startswith(("solve_scan", "nvcc"))
    assert port.stats["device_fallbacks"] == 0
    assert port._device_suspended == 0
    assert _fallback_counts(PORT_FALLBACKS) == p0


def test_wrong_device_answer_raises_out_of_solve(monkeypatch, _quiet_planes):
    """A device answer the oracle rejects, with no corruption injected, is
    a defect of the device path: IntegrityError out of Solver.solve, the
    violation metered, nothing served from another rung."""
    from karpenter_tpu_torch.integrity import IntegrityError
    monkeypatch.setattr(port_solver, "solve_device",
                        _corrupting(port_solver.solve_device))
    _, _, port, pc = _facades("device", "plain")
    p0 = _fallback_counts(PORT_FALLBACKS)
    with pytest.raises(IntegrityError) as err:
        _solve(port, pc)
    assert err.value.violations
    assert port.stats["integrity_violations"] >= 1
    assert port.stats["integrity_recoveries"] == 0
    assert port.stats["device_fallbacks"] == 0
    assert port._device_suspended == 0
    assert _fallback_counts(PORT_FALLBACKS) == p0


def test_over_capacity_input_recovers_like_the_reference(_quiet_planes):
    """An existing node already over its capacity (a state both packages'
    control loops reach after scale-downs, tests/test_torch_sim_overcap.py)
    fails the oracle on every rung. That is the input's fault, not the
    device's. The answer equals the reference's and the violations are
    metered the same, but the port keeps the device rung: it ships the
    device answer, as its native rung ships its own, with no rung swap and
    no cooldown. The reference quarantines and ships its fallback's
    (equal) answer (ROADMAP §3)."""
    c = scenario("existing")
    node = c.existing[0]
    node.cum = node.cum.copy()
    node.cum[0] += np.float32(1000.0)
    rprov, rc = _ref_side(c)
    pprov, pc = _port_side(c)
    ref = RefSolver(rprov, backend="device")
    port = PortSolver(pprov, backend="device", device="cpu")
    native = PortSolver(_port_side(c)[0], backend="native")
    counts = lambda m: {to: m.value(from_backend="device", to_backend=to)
                        for to in ("native", "host")}
    r0, p0 = counts(REF_FALLBACKS), counts(PORT_FALLBACKS)
    want, got = _solve(ref, rc), _solve(port, pc)
    assert out_tuple(got) == out_tuple(want)
    assert out_tuple(_solve(native, pc)) == out_tuple(got)
    assert port.stats["integrity_violations"] >= 1
    assert port.stats["integrity_violations"] == \
        ref.stats["integrity_violations"] == \
        native.stats["integrity_violations"]
    assert port.stats["device_fallbacks"] == 0
    assert ref.stats["device_fallbacks"] == 1
    r1, p1 = counts(REF_FALLBACKS), counts(PORT_FALLBACKS)
    assert p1 == p0 and r1 != r0
    assert port._device_suspended == 0
    assert ref._device_suspended == PortSolver.FALLBACK_COOLDOWN
    # the next solve of the same input stays on the device rung
    assert port._resolve_backend(len(pc.pods)) == "device"
    assert out_tuple(_solve(port, pc)) == out_tuple(got)
    assert port.stats["device_fallbacks"] == 0


def test_traced_solve_spans_every_stage(_quiet_planes):
    """With tracing on, one facade solve yields a span for each stage
    (the split chip_smoke.py prints): catalog view, colocation, encode,
    affinity and spread, the delta plane's lookup, the backend run with
    solve_device's own stages inside it, the integrity checks, the delta
    plane's record, the decode to launches and the explain recorder;
    tracing leaves the answer unchanged."""
    from karpenter_tpu_torch.obs.tracer import TRACER
    pprov, pc = _port_side(scenario("colocation"))
    f = PortSolver(pprov, backend="device", device="cpu")
    want = out_tuple(_solve(f, pc))
    # a second facade: f's delta memo would serve the repeat without a run
    g = PortSolver(pprov, backend="device", device="cpu")
    TRACER.configure(enabled=True)
    try:
        with TRACER.trace("facade.solve"):
            got = out_tuple(_solve(g, pc))
    finally:
        TRACER.configure(enabled=False)
    assert got == want
    tr, = TRACER.recorder.slowest(1)
    top = [s.name for s in tr.children(tr.root)]
    assert set(top) == {"solve.tensors", "solve.colocate", "solve.encode",
                        "solve.spread", "delta.lookup", "solve.run",
                        "integrity.verify", "delta.record", "solve.output",
                        "explain.record"}
    run, = [s for s in tr.children(tr.root) if s.name == "solve.run"]
    # the view's catalog upload (the facade's device cache was cold), then
    # solve_device's own stages under its solve.device span
    assert [s.name for s in tr.children(run)] == ["solve.catalog_put",
                                                  "solve.device"]
    dev, = [s for s in tr.children(run) if s.name == "solve.device"]
    assert [s.name for s in tr.children(dev)] == [
        "solve.prep", "solve.device_put", "solve.dispatch", "solve.readback",
        "solve.decode"]


def test_hybrid_routes_by_pod_count():
    """backend="hybrid" sends a solve of device_min_pods pods or more to
    the device rung and a smaller one to the native rung."""
    pprov, pc = _port_side(scenario("plain"))
    f = PortSolver(pprov, backend="hybrid", device="cpu", device_min_pods=100)
    assert f.prepare_solve(pc.pods[:50], pc.pool).backend == "native"
    assert f.prepare_solve(pc.pods, pc.pool).backend == "device"


def test_profile_dir_traces_each_solve(tmp_path):
    """profile_dir runs each backend run under torch.profiler and writes
    one Chrome trace a solve; the answer is unchanged."""
    pprov, pc = _port_side(scenario("plain"))
    traced = PortSolver(pprov, backend="device", device="cpu",
                        profile_dir=str(tmp_path))
    plain = PortSolver(_port_side(scenario("plain"))[0], backend="device",
                       device="cpu")
    assert out_tuple(_solve(traced, pc)) == out_tuple(_solve(plain, pc))
    traces = list(tmp_path.glob("solve-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


# --- device catalog sharing -------------------------------------------------


def test_shared_catalog_uploads_once_and_lru_evicts(monkeypatch):
    """Two facades on one SharedCatalogCache share the device upload of
    their common view (solve_device(dcat=), keyed on the content token) —
    even of the daemonset-derived copy each solve makes anew; a facade's
    LRU eviction of a view drops its device entries and meters
    DCAT_EVICTIONS{reason="facade_lru"}."""
    from karpenter_tpu_torch.metrics import DCAT_EVICTIONS
    uploads = []
    real = port_solver.device_catalog

    def counted(cat, R, device, **kw):
        uploads.append(cat.cache_token)
        return real(cat, R, device, **kw)
    monkeypatch.setattr(port_solver, "device_catalog", counted)
    types = port_object(_catalog())
    pods = port_object(grid_pods(np.random.default_rng(5), 40, "p"))
    pool = port_object(NodePool(name="default"))
    ds = port_object([DaemonSet(name="logging", requests=Resources.parse(
        {"cpu": "250m"}))])
    shared = SharedCatalogCache()
    a = PortSolver(PortProvider(lambda: types), backend="device",
                   device="cpu", shared_catalog=shared)
    b = PortSolver(PortProvider(lambda: types), backend="device",
                   device="cpu", shared_catalog=shared)
    outs = [f.solve(pods, pool, daemonsets=ds) for f in (a, b, a)]
    assert out_tuple(outs[0]) == out_tuple(outs[1]) == out_tuple(outs[2])
    assert len(uploads) == 1 and uploads[0][:1] == ("shared",)
    assert uploads[0][-2] == "ds"  # the derived view's token
    assert shared.stats == {"hits": 1, "misses": 1}

    # a facade without the shared cache keeps its own per-view entries,
    # and its catalog LRU takes them away with the view
    c = PortSolver(PortProvider(lambda: types), backend="device",
                   device="cpu")
    c.CAT_CACHE_SIZE = 1
    c.solve(pods, pool)
    assert len(c._dcat_cache) == 1
    e0 = DCAT_EVICTIONS.value(reason="facade_lru")
    c.solve(pods, pool, node_class=port_object(
        NodeClassSpec(name="other", zones=["zone-a"])))
    assert DCAT_EVICTIONS.value(reason="facade_lru") == e0 + 1
    assert len(c._dcat_cache) == 1
