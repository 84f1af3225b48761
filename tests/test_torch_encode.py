"""The port's own copies of the framework-free layers (models, catalog
generator, encode, spread split) held against the JAX package's: the same
seeded pod specs, built as each package's own Pod objects, must encode to
equal arrays."""

import numpy as np
import pytest

from karpenter_tpu import catalog as ref_catalog
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import requirements as ref_req
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops import binpack as ref_binpack
from karpenter_tpu.ops import encode as ref_encode

from karpenter_tpu_torch import catalog as port_catalog
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import requirements as port_req
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import binpack as port_binpack
from karpenter_tpu_torch.ops import encode as port_encode

ZONE = "topology.kubernetes.io/zone"
CAPTYPE = "karpenter.tpu/capacity-type"
FAMILY = "karpenter.tpu/instance-family"
HOST = "kubernetes.io/hostname"

CAT_ARRAYS = ("allocatable", "price", "available", "reservation_cap",
              "label_val", "label_num", "is_block")
ENC_ARRAYS = ("requests", "counts", "compat", "allow_zone", "allow_cap",
              "max_per_node", "spread_zone", "spread_soft")
ENC_OPTIONAL = ("conflict", "compat_hard", "zone_hard", "cap_hard",
                "zone_conflict")


@pytest.fixture(scope="module", autouse=True)
def _rotate_reference_intern_table():
    """Empty the reference's process-global signature intern table after
    this module: a rotation, which grouping tolerates by design, so that
    the signatures interned here do not leak into later modules of the
    same process (test_encode's rotation test needs its filler signature
    to be new)."""
    yield
    ref_pod._sig_intern.clear()


@pytest.fixture(scope="module", autouse=True)
def _shared_resource_axis():
    """Each package keeps a process-global resource axis that only grows
    (a pod requesting an unknown resource appends a column), and earlier
    modules in the same process may have grown the reference's. Give the
    port's axis the same columns in the same order before comparing arrays
    that each package encodes on its own."""
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    assert port_res.resource_axis() == ref_res.resource_axis()


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


@pytest.mark.parametrize("which", ["small_catalog", "generate_catalog"])
def test_encode_catalog_equal(which):
    ref = ref_encode.encode_catalog(getattr(ref_catalog, which)())
    got = port_encode.encode_catalog(getattr(port_catalog, which)())
    for f in CAT_ARRAYS:
        _equal(getattr(got, f), getattr(ref, f), f)
    for f in ("names", "zones", "captypes", "resources", "label_keys",
              "vocab", "numeric_keys", "name_to_idx"):
        assert getattr(got, f) == getattr(ref, f), f


def _pod_specs(seed: int, n: int):
    """Seeded pod specs: plain, zero-request, zone/family selectors,
    capacity-type affinity, preferred affinity, zone spread (hard and soft),
    hostname spread, self and cross-group anti-affinity, tolerations."""
    rng = np.random.default_rng(seed)
    cpus = ["0", "100m", "250m", "500m", "1", "2", "7"]
    mems = ["0", "128Mi", "512Mi", "1Gi", "4Gi", "12Gi"]
    specs = []
    for i in range(n):
        s = {"name": f"p{i}", "labels": {}, "requests": {}}
        c, m = cpus[rng.integers(len(cpus))], mems[rng.integers(len(mems))]
        if c != "0":
            s["requests"]["cpu"] = c
        if m != "0":
            s["requests"]["memory"] = m
        kind = int(rng.integers(10))
        app = f"a{int(rng.integers(3))}"
        if kind == 1:
            s["node_selector"] = {ZONE: ["zone-a", "zone-b", "zone-c"][
                int(rng.integers(3))]}
        elif kind == 2:
            s["node_affinity"] = [{"key": FAMILY, "operator": "In",
                                   "values": ["m5", "c5"]}]
        elif kind == 3:
            s["node_affinity"] = [{"key": CAPTYPE, "operator": "NotIn",
                                   "values": ["spot"]}]
        elif kind == 4:
            s["labels"] = {"app": app}
            s["spread"] = [{"topology_key": ZONE, "max_skew": 1,
                            "when_unsatisfiable": ["DoNotSchedule",
                                                   "ScheduleAnyway"][
                                int(rng.integers(2))]}]
        elif kind == 5:
            s["labels"] = {"app": app}
            s["anti"] = [{"topology_key": HOST, "label_selector": {"app": app}}]
        elif kind == 6:
            s["labels"] = {"tier": "db"}
            s["anti"] = [{"topology_key": HOST,
                          "label_selector": {"tier": "web"}}]
        elif kind == 7:
            s["labels"] = {"tier": "web"}
            s["spread"] = [{"topology_key": HOST, "max_skew": 2,
                            "when_unsatisfiable": "DoNotSchedule"}]
        elif kind == 8:
            s["preferred"] = [{"key": FAMILY, "operator": "In",
                               "values": ["r5"], "weight": 10},
                              {"key": ZONE, "operator": "In",
                               "values": ["zone-c"], "weight": 5}]
            s["tolerations"] = [{"key": "team", "operator": "Exists"}]
        specs.append(s)
    return specs


def _build(pod_mod, res_mod, specs):
    pods = []
    for s in specs:
        pods.append(pod_mod.Pod(
            name=s["name"], labels=dict(s["labels"]),
            requests=res_mod.Resources.parse(s["requests"]),
            node_selector=dict(s.get("node_selector", {})),
            node_affinity=[dict(t) for t in s.get("node_affinity", [])],
            preferred_node_affinity=[dict(t) for t in s.get("preferred", [])],
            tolerations=[pod_mod.Toleration(**t)
                         for t in s.get("tolerations", [])],
            topology_spread=[pod_mod.TopologySpreadConstraint(**t)
                             for t in s.get("spread", [])],
            affinity_terms=[pod_mod.PodAffinityTerm(anti=True, **t)
                            for t in s.get("anti", [])]))
    return pods


def _assert_enc_equal(got, ref):
    assert got.G == ref.G
    for f in ENC_ARRAYS:
        _equal(getattr(got, f), getattr(ref, f), f)
    for f in ENC_OPTIONAL:
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _equal(a, b, f)
    assert [g.representative.name for g in got.groups] == \
        [g.representative.name for g in ref.groups]
    assert (got.dropped_keys or None) == (ref.dropped_keys or None)


@pytest.fixture(scope="module")
def catalogs():
    return (ref_encode.encode_catalog(ref_catalog.generate_catalog()),
            port_encode.encode_catalog(port_catalog.generate_catalog()))


@pytest.mark.parametrize("seed", range(6))
def test_encode_pods_equal(catalogs, seed):
    rcat, pcat = catalogs
    specs = _pod_specs(seed, 300)
    ref = ref_encode.encode_pods(_build(ref_pod, ref_res, specs), rcat)
    got = port_encode.encode_pods(_build(port_pod, port_res, specs), pcat)
    _assert_enc_equal(got, ref)


@pytest.mark.parametrize("seed", range(4))
def test_split_spread_groups_equal(catalogs, seed):
    rcat, pcat = catalogs
    specs = _pod_specs(100 + seed, 200)
    ref = ref_binpack.split_spread_groups(
        ref_encode.encode_pods(_build(ref_pod, ref_res, specs), rcat), rcat)
    got = port_binpack.split_spread_groups(
        port_encode.encode_pods(_build(port_pod, port_res, specs), pcat), pcat)
    _assert_enc_equal(got, ref)
    assert not got.spread_zone.any()


def test_encode_pool_requirements_and_taints(catalogs):
    """NodePool template requirements conjoined into every group, and the
    taint filter dropping whole groups."""
    rcat, pcat = catalogs
    specs = _pod_specs(42, 150)

    def run(pod_mod, res_mod, req_mod, enc_mod, cat):
        extra = req_mod.Requirements(req_mod.Requirement(
            FAMILY, req_mod.Operator.IN, ("m5", "c5", "r5", "m6")))
        return enc_mod.encode_pods(
            _build(pod_mod, res_mod, specs), cat, extra_requirements=extra,
            taints=[pod_mod.Taint(key="team", effect="NoSchedule")],
            template_labels={"pool": "blue"})

    ref = run(ref_pod, ref_res, ref_req, ref_encode, rcat)
    got = run(port_pod, port_res, port_req, port_encode, pcat)
    assert ref.dropped_keys
    _assert_enc_equal(got, ref)


def test_resource_axis_and_quantities():
    for q in ("100m", "1.5Gi", "2", "7k", "3Mi", 250):
        assert port_res.parse_quantity(q) == ref_res.parse_quantity(q)
    assert port_res.resource_axis()[:9] == ref_res.resource_axis()[:9]
    r = {"cpu": "2", "memory": "3Gi", "nvidia.com/gpu": "1"}
    assert (port_res.Resources.parse(r).to_vector()[:9]
            == ref_res.Resources.parse(r).to_vector()[:9])
