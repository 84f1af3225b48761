"""Each traffic driver's inputs repeat from --seed, and a new seed gives
new inputs."""

import numpy as np

from benchmark.harness import pods as P
from benchmark.harness import registry

MIX = registry.workload("scaleup-100k.replicas")["params"]["kinds"]


def same(a, b):
    return (a.names == b.names and np.array_equal(a.cpu_idx, b.cpu_idx)
            and np.array_equal(a.mem_idx, b.mem_idx)
            and np.array_equal(a.cls, b.cls))


def test_pods_repeat_from_the_seed():
    a, b = P.generate(MIX, 3000, 2**31 + 7), P.generate(MIX, 3000, 2**31 + 7)
    assert same(a, b)
    c = P.generate(MIX, 3000, 2**31 + 8)
    assert not same(a, c)
    assert len(a) == 3000 and sorted(a.names) == sorted(c.names)


def test_templated_deployments_share_one_request():
    ps = P.generate(MIX, 6000, 11)
    for k, c in enumerate(ps.classes):
        if c.spread is not None:
            one = ps.cls == k
            assert len(set(ps.cpu_idx[one])) == 1
            assert len(set(ps.mem_idx[one])) == 1


def test_closed_solve_draws():
    drv = registry.driver("closed_solve")
    a = drv.draw(2**31 + 5, 0, 1200, 1000)
    assert np.array_equal(a, drv.draw(2**31 + 5, 0, 1200, 1000))
    assert not np.array_equal(a, drv.draw(2**31 + 5, 1, 1200, 1000))
    assert not np.array_equal(a, drv.draw(2**31 + 6, 0, 1200, 1000))
    assert len(set(a.tolist())) == 1000


def test_fleet_bursts():
    drv = registry.driver("fleet_rounds")
    cell = registry.workload("fleet-16.fresh")

    k = cell["params"]["tenants"]

    def bursts(seed, fresh=True):
        st = drv.State()
        st.seed, st.p = seed, dict(cell["params"], fresh=fresh)
        st.fixed = [drv._burst(st, i, -1) for i in range(k)]
        return [drv._burst(st, i, r) for r in range(3) for i in range(k)]
    a, b, c = bursts(2**32 + 1), bursts(2**32 + 1), bursts(2**32 + 2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))
    # every round of every seed deals the same sizes, in another order
    want = drv.sizes(cell["params"])
    for got in (a, c):
        for r in range(3):
            assert sorted(len(x) for x in got[r * k:(r + 1) * k]) == want
    assert [len(x) for x in a[:k]] != [len(x) for x in a[k:2 * k]]
    rep = bursts(2**32 + 1, fresh=False)
    assert all(np.array_equal(rep[i], rep[i + k]) for i in range(2 * k))
