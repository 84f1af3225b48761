"""The reference agrees with the program's host rung on small draws of
each cell's traffic: node for node on plain pods, and with no broken
guarantee on the facade mix; its catalog is the program's."""

import numpy as np
import pytest

from benchmark.harness import pods as P
from benchmark.harness import port, registry
from benchmark.reference import audit as A
from benchmark.reference import catalog as K
from benchmark.reference import plan as R


@pytest.fixture(scope="module")
def types():
    return K.generate()


def host_answer(types, ps, conf):
    from karpenter_tpu_torch.ops.facade import Solver
    pool, ds = conf["pool"], conf.get("daemonsets", [])
    f = Solver(port.catalog_provider(port.instance_types(types)),
               backend="host")
    out = f.solve(port.pods(ps, pool), port.node_pool(pool),
                  daemonsets=port.daemon_sets(ds, pool))
    return port.output(out)


def test_catalog_is_the_programs(types):
    from karpenter_tpu_torch.catalog import generate_catalog
    mine = port.instance_types(types)
    theirs = generate_catalog()
    assert len(mine) == len(theirs) == 810
    for a, b in zip(mine, theirs):
        assert (a.name, a.capacity, a.overhead, a.offerings) == \
            (b.name, b.capacity, b.overhead, b.offerings)
        assert list(a.requirements.keys()) == list(b.requirements.keys())


@pytest.mark.parametrize("cell,n", [("scaleup-100k.grid", 4000),
                                    ("scaleup-100k.replicas", 4000),
                                    ("fleet-16.fresh", 700)])
def test_reference_agrees_with_the_host_rung(types, cell, n):
    w = registry.workload(cell)
    conf = w["configuration"]
    kinds = w["params"].get("kinds", [{"kind": "grid"}])
    ps = P.generate(kinds, n, 2**31 + 99)
    ans = host_answer(types, ps, conf)
    cat = R.build_catalog(types, conf["pool"], conf.get("daemonsets", []))
    assert A.audit(ans, ps, cat, conf["pool"]) == {
        "missing": 0, "infeasible": 0, "wrongly_unschedulable": 0}
    plan = R.solve(ps, cat, conf["pool"])
    if w["params"].get("compare", "plan") == "plan":
        assert A.plan_diff(ans, plan, ps, cat) == 0
        assert sorted(ans["unschedulable"]) == sorted(plan.unschedulable)
    else:
        # a yardstick there: the program's pre-passes place the terms
        # their own way
        cost = sum(l[3] for l in ans["launches"])
        assert abs(cost / plan.cost() - 1) < 0.15
        assert sorted(ans["unschedulable"]) == sorted(plan.unschedulable)


def test_the_plan_as_an_answer_passes_its_own_audit(types):
    w = registry.workload("scaleup-100k.replicas")
    conf = w["configuration"]
    ps = P.generate(w["params"]["kinds"], 3000, 5)
    cat = R.build_catalog(types, conf["pool"], conf["daemonsets"])
    plan = R.solve(ps, cat, conf["pool"])
    ans = R.answer(plan, ps, cat)
    assert A.audit(ans, ps, cat, conf["pool"]) == {
        "missing": 0, "infeasible": 0, "wrongly_unschedulable": 0}
    assert A.plan_diff(ans, plan, ps, cat) == 0


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.0e5], np.float32)
    got = R.bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0
    assert got[2] == np.float32(1.0078125)
    assert abs(got[3] - 3.0e5) / 3.0e5 < 2**-8
