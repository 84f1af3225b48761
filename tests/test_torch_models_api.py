"""The models' public API of the port (`karpenter_tpu_torch/models/`) held
against the JAX reference's: every name of the reference's
`models.__all__`, and the cases of the reference's `tests/test_resources.py`,
`tests/test_requirements.py` and the model cases of
`tests/test_review_fixes.py`, each run through both packages on the same
inputs with equal results (and each package held to the reference's own
assertions). Extra cases give the helpers no reference test reaches
(`merge`, `ceil_div`, `Requirements.from_node_selector_terms`,
`InstanceType.available_offerings` / `cheapest_price`, `sort_by_price`,
`Taint.evicts`) the same inputs in both packages.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

import karpenter_tpu.models as ref_models
import karpenter_tpu_torch.models as port_models


def _ns(pkg: str) -> SimpleNamespace:
    m = lambda name: importlib.import_module(f"{pkg}.models.{name}")  # noqa: E731
    return SimpleNamespace(name=pkg, models=importlib.import_module(
        f"{pkg}.models"), L=m("labels"), it=m("instancetype"), pod=m("pod"),
        rq=m("requirements"), res=m("resources"))


REF = _ns("karpenter_tpu")
PORT = _ns("karpenter_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _leave_the_interns_as_found():
    """Both packages' pods intern their signatures; clear both tables
    afterwards (ROADMAP §3's test-order hazard)."""
    yield
    for P in (REF, PORT):
        P.pod._sig_intern.clear()


def _both(case):
    want = case(REF)
    got = case(PORT)
    assert got == want
    return got


def _raises(fn, exc, match=None):
    """The exception's type name and message, asserted to be `exc`."""
    with pytest.raises(exc, match=match) as e:
        fn()
    return (type(e.value).__name__, str(e.value))


def test_models_export_every_reference_name():
    assert set(ref_models.__all__) <= set(port_models.__all__)
    for name in ref_models.__all__:
        assert getattr(port_models, name) is not None, name
    # the reference's public helpers, callable from the port's package
    for name in ("sort_by_price", "truncate", "pod_requests",
                 "new_nodeclaim_name", "tolerates_all"):
        assert callable(getattr(port_models, name))


# --- tests/test_resources.py ---------------------------------------------

def _parse_quantities(P):
    pq = P.res.parse_quantity
    out = [pq("100m"), pq("2"), pq("1.5Gi"), pq("512Mi"), pq("1k"),
           pq("2.5"), pq(4), pq("3e2")]
    assert out[0] == pytest.approx(0.1)
    assert out[1:] == [2.0, 1.5 * 2**30, 512 * 2**20, 1000.0, 2.5, 4.0,
                       300.0]
    return out


def _parse_invalid(P):
    return [_raises(lambda: P.res.parse_quantity(q), ValueError)
            for q in ("abc", "1Xx")]


def _format(P):
    f = P.res.format_quantity
    out = [f(0.1), f(2.0), f(2**30, binary=True), f(0), f(0.25),
           f(3 * 2**20, binary=True), f(1.5), f(1500.0)]
    assert out[:3] == ["100m", "2", "1Gi"]
    return out


def _resources_algebra(P):
    R, res = P.res.Resources, P.res
    a = R.parse({"cpu": "500m", "memory": "1Gi"})
    b = R.parse({"cpu": "250m", "memory": "512Mi", "pods": 1})
    s = a.add(b)
    assert s[res.CPU] == pytest.approx(0.75)
    assert s[res.MEMORY] == pytest.approx(1.5 * 2**30)
    d = s.sub(b)
    assert d[res.CPU] == pytest.approx(0.5)
    assert b.fits(a.add(R({res.PODS: 1})))
    assert not R({res.CPU: 10}).fits(a)
    return [dict(s), dict(d), dict(res.merge(a, b, {"pods": 2}))]


def _vector_roundtrip(P):
    res = P.res
    r = res.Resources.parse({"cpu": "2", "memory": "4Gi", "pods": 1})
    v = r.to_vector()
    assert v[res.resource_index(res.CPU)] == 2.0
    assert v[res.resource_index(res.MEMORY)] == 4096.0  # MiB device scale
    back = res.Resources.from_vector(v)
    assert back[res.MEMORY] == pytest.approx(4 * 2**30)
    assert back[res.CPU] == 2.0
    return [res.resource_index(n) for n in (res.CPU, res.MEMORY, res.PODS)], \
        dict(back)


def _pod_requests_aggregation(P):
    res = P.res
    req = res.pod_requests(
        containers=[res.Resources.parse({"cpu": "1", "memory": "1Gi"}),
                    res.Resources.parse({"cpu": "500m"})],
        init_containers=[res.Resources.parse({"cpu": "2"})],
    )
    assert req[res.CPU] == 2.0  # init container max dominates
    assert req[res.MEMORY] == 2**30
    assert req[res.PODS] == 1.0
    over = res.pod_requests([res.Resources.parse({"cpu": "1", "pods": 3})],
                            overhead={"cpu": 0.25})
    return dict(req), dict(over)


def _axis_stable(P):
    res = P.res
    assert res.resource_axis()[0] == res.CPU
    assert res.resource_axis()[1] == res.MEMORY
    return res.resource_axis()[:2]


def _ceil_div(P):
    cd = P.res.ceil_div
    return [cd(7, 2), cd(8, 2), cd(1, 0), cd(1, -3), cd(0.3, 0.1),
            cd(2.0000000001, 1)]


@pytest.mark.parametrize("case", [
    _parse_quantities, _parse_invalid, _format, _resources_algebra,
    _vector_roundtrip, _pod_requests_aggregation, _axis_stable, _ceil_div],
    ids=lambda c: c.__name__.lstrip("_"))
def test_resources_equal_the_reference(case):
    _both(case)


# --- tests/test_requirements.py ------------------------------------------

def _ops(P):
    O = P.rq.Operator
    return O.IN, O.NOT_IN, O.EXISTS, O.DOES_NOT_EXIST, O.GT, O.LT


def _req(P, key, op, *values, min_values=None):
    return P.rq.Requirement(key, op, tuple(values), min_values=min_values)


def _vs(vs):
    return (sorted(vs.values), vs.complement, vs.dne, vs.gt, vs.lt)


def _vs_in(P):
    IN = _ops(P)[0]
    vs = P.rq.ValueSet.of(IN, ["a", "b"])
    assert vs.contains("a") and not vs.contains("c")
    return _vs(vs)


def _vs_not_in(P):
    vs = P.rq.ValueSet.of(_ops(P)[1], ["a"])
    assert not vs.contains("a") and vs.contains("z")
    return _vs(vs)


def _vs_exists_universe(P):
    vs = P.rq.ValueSet.of(_ops(P)[2])
    assert vs.is_universe() and vs.contains("anything")
    return _vs(vs)


def _vs_does_not_exist(P):
    vs = P.rq.ValueSet.of(_ops(P)[3])
    assert vs.is_does_not_exist() and not vs.contains("x")
    return _vs(vs), vs.is_conflict()


def _vs_gt_lt(P):
    GT, LT = _ops(P)[4:]
    gt = P.rq.ValueSet.of(GT, ["4"])
    assert gt.contains("8") and not gt.contains("4") and not gt.contains("2")
    assert not gt.contains("xlarge")  # non-numeric fails bounds
    lt = P.rq.ValueSet.of(LT, ["16"])
    assert lt.contains("8") and not lt.contains("16")
    return _vs(gt), _vs(lt)


def _vs_intersection_finite(P):
    IN = _ops(P)[0]
    a = P.rq.ValueSet.of(IN, ["a", "b", "c"])
    b = P.rq.ValueSet.of(IN, ["b", "c", "d"])
    i = a.intersection(b)
    assert i.values == frozenset({"b", "c"})
    assert a.intersects(b)
    assert not a.intersects(P.rq.ValueSet.of(IN, ["z"]))
    return _vs(i), a.intersection(P.rq.ValueSet.of(IN, ["z"])).is_conflict()


def _vs_intersection_mixed(P):
    IN, NOT_IN = _ops(P)[:2]
    a = P.rq.ValueSet.of(IN, ["a", "b"])
    b = P.rq.ValueSet.of(NOT_IN, ["a"])
    assert a.intersection(b).values == frozenset({"b"})
    return _vs(a.intersection(b))


def _vs_intersection_bounds(P):
    IN, GT, LT = _ops(P)[0], _ops(P)[4], _ops(P)[5]
    a = P.rq.ValueSet.of(IN, ["2", "4", "8", "16"])
    i = a.intersection(P.rq.ValueSet.of(GT, ["3"]))
    assert i.values == frozenset({"4", "8", "16"})
    c = i.intersection(P.rq.ValueSet.of(LT, ["10"]))
    assert c.values == frozenset({"4", "8"})
    return _vs(i), _vs(c)


def _vs_complement_intersection(P):
    NOT_IN = _ops(P)[1]
    a = P.rq.ValueSet.of(NOT_IN, ["a"])
    b = P.rq.ValueSet.of(NOT_IN, ["b"])
    i = a.intersection(b)
    assert i.complement and i.values == frozenset({"a", "b"})
    assert a.intersects(b)
    return _vs(i)


def _tightening_add(P):
    IN, NOT_IN = _ops(P)[:2]
    r = P.rq.Requirements(_req(P, "k", IN, "a", "b", "c"))
    r.add(_req(P, "k", NOT_IN, "b"))
    assert r.get("k").values == frozenset({"a", "c"})
    return _vs(r.get("k"))


def _from_labels(P):
    L = P.L
    r = P.rq.Requirements.from_labels({L.ARCH: "arm64"})
    assert r.get(L.ARCH).contains("arm64")
    return _vs(r.get(L.ARCH))


def _compatible_basic(P):
    L, IN = P.L, _ops(P)[0]
    Rq = P.rq.Requirements
    itype = Rq.from_labels({L.ARCH: "amd64", L.INSTANCE_FAMILY: "m5"})
    pod = Rq(_req(P, L.ARCH, IN, "amd64"))
    assert pod.compatible(itype)
    pod2 = Rq(_req(P, L.ARCH, IN, "arm64"))
    assert not pod2.compatible(itype)
    return pod.compatible(itype), pod2.compatible(itype), \
        pod.intersect_ok(itype), pod2.intersect_ok(itype)


def _compatible_absent_key(P):
    L = P.L
    IN, NOT_IN, EXISTS, DNE = _ops(P)[:4]
    Rq = P.rq.Requirements
    itype = Rq.from_labels({L.ARCH: "amd64"})
    out = [Rq(_req(P, "custom", NOT_IN, "x")).compatible(itype),
           Rq(_req(P, "custom", EXISTS)).compatible(itype),
           Rq(_req(P, "custom", IN, "x")).compatible(itype),
           Rq(_req(P, "custom", DNE)).compatible(itype),
           Rq(_req(P, L.ARCH, DNE)).compatible(itype)]
    assert out == [True, False, False, True, False]
    return out


def _compatible_numeric(P):
    L = P.L
    GT, LT = _ops(P)[4:]
    Rq = P.rq.Requirements
    itype = Rq.from_labels({L.INSTANCE_CPU: "8"})
    out = [Rq(_req(P, L.INSTANCE_CPU, GT, "4")).compatible(itype),
           Rq(_req(P, L.INSTANCE_CPU, GT, "8")).compatible(itype),
           Rq(_req(P, L.INSTANCE_CPU, LT, "16")).compatible(itype)]
    assert out == [True, False, True]
    return out


def _union_with(P):
    IN, EXISTS = _ops(P)[0], _ops(P)[2]
    a = P.rq.Requirements(_req(P, "k", IN, "a", "b"))
    b = P.rq.Requirements(_req(P, "k", IN, "b", "c"), _req(P, "j", EXISTS))
    u = a.union_with(b)
    assert u.get("k").values == frozenset({"b"})
    assert u.get("j").is_universe()
    return _vs(u.get("k")), _vs(u.get("j"))


def _single_values(P):
    L, IN = P.L, _ops(P)[0]
    r = P.rq.Requirements(_req(P, L.ARCH, IN, "amd64"),
                          _req(P, L.INSTANCE_FAMILY, IN, "m5", "c5"))
    sv = r.single_values()
    assert sv == {L.ARCH: "amd64"}
    return sv


def _min_values_tracked(P):
    L, EXISTS = P.L, _ops(P)[2]
    r = P.rq.Requirements(_req(P, L.INSTANCE_TYPE, EXISTS, min_values=15))
    assert r.min_values(L.INSTANCE_TYPE) == 15
    return r.min_values(L.INSTANCE_TYPE)


def _labels_satisfy(P):
    L, IN, NOT_IN = P.L, *_ops(P)[:2]
    r = P.rq.Requirements(_req(P, L.ARCH, IN, "amd64"),
                          _req(P, "x", NOT_IN, "bad"))
    out = [r.labels_satisfy({L.ARCH: "amd64"}),
           r.labels_satisfy({L.ARCH: "arm64"}),
           r.labels_satisfy({L.ARCH: "amd64", "x": "bad"}),
           r.labels_satisfy({})]
    assert out[:3] == [True, False, False]
    return out


def _from_node_selector_terms(P):
    L = P.L
    terms = [{"key": L.ARCH, "operator": "In", "values": ["amd64", "arm64"]},
             {"key": L.INSTANCE_CPU, "operator": "Gt", "values": ["4"]},
             {"key": "team", "operator": "Exists"},
             {"key": L.ARCH, "operator": "NotIn", "values": ["arm64"]}]
    r = P.rq.Requirements.from_node_selector_terms(terms)
    itype = P.rq.Requirements.from_labels(
        {L.ARCH: "amd64", L.INSTANCE_CPU: "8", "team": "ml"})
    return ({k: _vs(r.get(k)) for k in sorted(r.keys())},
            r.compatible(itype), r.labels_satisfy({L.ARCH: "amd64"}))


def _toleration(P):
    Taint, Toleration = P.pod.Taint, P.pod.Toleration
    tolerates_all = P.pod.tolerates_all
    taint = Taint(key="team", value="ml", effect="NoSchedule")
    out = [tolerates_all([Toleration(key="team", value="ml",
                                     effect="NoSchedule")], [taint]),
           tolerates_all([Toleration(key="team", operator="Exists")], [taint]),
           tolerates_all([Toleration(operator="Exists")], [taint]),
           tolerates_all([], [taint]),
           # PreferNoSchedule never blocks
           tolerates_all([], [Taint(key="t", value="",
                                    effect="PreferNoSchedule")])]
    assert out == [True, True, True, False, True]
    return out


def _taint_evicts(P):
    return [P.pod.Taint(key="k", effect=e).evicts()
            for e in ("NoSchedule", "PreferNoSchedule", "NoExecute")]


@pytest.mark.parametrize("case", [
    _vs_in, _vs_not_in, _vs_exists_universe, _vs_does_not_exist, _vs_gt_lt,
    _vs_intersection_finite, _vs_intersection_mixed, _vs_intersection_bounds,
    _vs_complement_intersection, _tightening_add, _from_labels,
    _compatible_basic, _compatible_absent_key, _compatible_numeric,
    _union_with, _single_values, _min_values_tracked, _labels_satisfy,
    _from_node_selector_terms, _toleration, _taint_evicts],
    ids=lambda c: c.__name__.lstrip("_"))
def test_requirements_equal_the_reference(case):
    _both(case)


# --- tests/test_review_fixes.py (the model cases) ------------------------

def _contradictory_gt_lt_do_not_intersect(P):
    Rq, Rr, O = P.rq.Requirements, P.rq.Requirement, P.rq.Operator
    a = Rq(Rr("k", O.GT, ("16",)))
    b = Rq(Rr("k", O.LT, ("8",)))
    c = Rq(Rr("k", O.GT, ("7",)))
    d = Rq(Rr("k", O.LT, ("8",)))
    e = Rq(Rr("k", O.LT, ("9",)))
    out = [a.intersect_ok(b), c.intersect_ok(d), c.intersect_ok(e)]
    # adjacent integer bounds: Gt 7 & Lt 8 leaves no integer; Lt 9 leaves 8
    assert out == [False, False, True]
    return out


def _mk_types(P, n_families, sizes=2):
    types = []
    for f in range(n_families):
        fam = f"f{f}"
        for s in range(sizes):
            types.append(P.it.InstanceType(
                name=f"{fam}.s{s}",
                requirements=P.rq.Requirements.from_labels(
                    {P.L.INSTANCE_FAMILY: fam}),
                capacity=P.res.Resources.parse({"cpu": 4}),
                offerings=[P.it.Offering(zone="z1", capacity_type="on-demand",
                                         price=1.0 + f + 0.1 * s)]))
    return types


def _fam_req(P, op, values=(), min_values=None):
    return P.rq.Requirements(P.rq.Requirement(
        P.L.INSTANCE_FAMILY, op, tuple(values), min_values=min_values))


def _truncate_respects_hard_limit(P):
    kept = P.it.truncate(_mk_types(P, 8),
                         _fam_req(P, P.rq.Operator.EXISTS, min_values=6),
                         limit=6)
    assert len(kept) <= 6
    fams = {t.name.split(".")[0] for t in kept}
    assert len(fams) >= 6
    return [t.name for t in kept]


def _truncate_errors_when_minvalues_exceeds_limit(P):
    return _raises(lambda: P.it.truncate(
        _mk_types(P, 8), _fam_req(P, P.rq.Operator.EXISTS, min_values=7),
        limit=5), ValueError, "truncation limit")


def _minvalues_counts_only_compatible_values(P):
    # the requirement allows only f0/f1 but the catalog has f0..f3:
    # minValues=2 counts {f0, f1} only, and minValues=3 fails
    types = _mk_types(P, 4)
    IN = P.rq.Operator.IN
    kept = P.it.truncate(types, _fam_req(P, IN, ("f0", "f1"), 2), limit=10)
    assert {t.name.split(".")[0] for t in kept} >= {"f0", "f1"}
    err = _raises(lambda: P.it.truncate(
        types, _fam_req(P, IN, ("f0", "f1"), 3), limit=10), ValueError,
        "unsatisfiable")
    return [t.name for t in kept], err


def _truncate_without_min_values(P):
    types = _mk_types(P, 5)
    return [t.name for t in P.it.truncate(types[::-1], P.rq.Requirements(),
                                          limit=4)]


def _signature_distinguishes_labels_namespace_owner(P):
    Pod = P.pod.Pod
    a = Pod(name="a", labels={"app": "a"})
    b = Pod(name="b", labels={"app": "b"})
    c = Pod(name="c", namespace="ns1")
    d = Pod(name="d", namespace="ns2")
    e = Pod(name="e", labels={"app": "x"})
    f = Pod(name="f", labels={"app": "x"})
    out = [a.constraint_signature() != b.constraint_signature(),
           c.constraint_signature() != d.constraint_signature(),
           e.constraint_signature() == f.constraint_signature()]
    assert out == [True, True, True]
    return out


def _unknown_resource_auto_registered_in_vector(P):
    res = P.res
    r = res.Resources.parse({"amd.com/gpu": 1, "cpu": "500m"})
    vec = r.to_vector()
    assert "amd.com/gpu" in res.resource_axis()
    idx = res.resource_axis().index("amd.com/gpu")
    assert vec[idx] == 1.0
    # round-trips
    assert res.Resources.from_vector(vec)["amd.com/gpu"] == 1.0
    return dict(res.Resources.from_vector(vec))


def _conflict_distinct_from_does_not_exist(P):
    Rq, Rr, O = P.rq.Requirements, P.rq.Requirement, P.rq.Operator
    conflict = Rq(Rr("k", O.IN, ("a",)))
    conflict.add(Rr("k", O.IN, ("b",)))
    vs = conflict.get("k")
    assert vs.is_conflict() and not vs.is_does_not_exist()
    # a conflict matches nothing, not even absence
    assert not conflict.compatible(Rq())
    assert not conflict.compatible(Rq.from_labels({"k": "a"}))
    assert not conflict.labels_satisfy({})
    # a real DoesNotExist still accepts absence
    dne = Rq(Rr("k", O.DOES_NOT_EXIST))
    assert dne.compatible(Rq())
    assert dne.labels_satisfy({})
    # DoesNotExist ∩ NotIn stays DoesNotExist; ∩ In becomes a conflict
    d = dne.copy()
    d.add(Rr("k", O.NOT_IN, ("x",)))
    assert d.get("k").is_does_not_exist()
    d2 = dne.copy()
    d2.add(Rr("k", O.IN, ("x",)))
    assert d2.get("k").is_conflict()
    return _vs(vs), _vs(d.get("k")), _vs(d2.get("k"))


def _offerings_and_price_order(P):
    Offering = P.it.Offering
    types = _mk_types(P, 3)
    t = types[0]
    t.offerings = [Offering(zone="z1", capacity_type="spot", price=0.4),
                   Offering(zone="z2", capacity_type="on-demand", price=0.9),
                   Offering(zone="z3", capacity_type="spot", price=0.1,
                            available=False)]
    types[3].offerings = [Offering(zone="z1", capacity_type="on-demand",
                                   price=0.5, available=False)]
    return ([(o.zone, o.price) for o in t.available_offerings()],
            t.cheapest_price(), t.cheapest_price(zones={"z2"}),
            t.cheapest_price(capacity_types={"spot"}),
            t.cheapest_price(zones={"z3"}), types[3].cheapest_price(),
            [x.name for x in P.it.sort_by_price(types)],
            [x.name for x in P.it.sort_by_price(types, zones={"z2"})],
            [x.name for x in P.models.sort_by_price(
                types, capacity_types={"spot"})])


@pytest.mark.parametrize("case", [
    _contradictory_gt_lt_do_not_intersect, _truncate_respects_hard_limit,
    _truncate_errors_when_minvalues_exceeds_limit,
    _minvalues_counts_only_compatible_values, _truncate_without_min_values,
    _signature_distinguishes_labels_namespace_owner,
    _unknown_resource_auto_registered_in_vector,
    _conflict_distinct_from_does_not_exist, _offerings_and_price_order],
    ids=lambda c: c.__name__.lstrip("_"))
def test_review_fixes_equal_the_reference(case):
    _both(case)
