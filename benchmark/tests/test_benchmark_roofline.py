"""The kernels' least work against hand-worked shapes."""

from benchmark.roofline import scan as S


def test_offer_argmin_counts():
    # G=2 groups, T=3 types, Z=2 zones, C=1 captype, R=3 resources
    nbytes, ops = S.offer_argmin(2, 3, 2, 1, 3)
    # catalog 3*3*4 + 3*2*1*4 + ceil(6/8) = 36 + 24 + 1; each group
    # 3*4 + 4 + 1 + 1 + 1 = 19 in, 8 out
    assert nbytes == 61 + 2 * 19 + 2 * 8
    assert ops == 2 * 3 * (2 * 3 + 3 * 2)


def test_solve_scan_counts():
    nbytes, ops = S.solve_scan(2, 3, 2, 1, 3, nodes=4, node_steps=5,
                               placements=6)
    assert nbytes == (36 + 1) + 2 * (12 + 4 + 1 + 1 + 1 + 8) \
        + 4 * (4 + 12 + 1 + 1) + 6 * 8
    assert ops == 5 * (2 * 3 + 2 + 4)


def test_bound_takes_the_larger_side():
    p = S.peaks()
    assert S.bound_s(int(p["hbm_bytes_per_s"]), 0) == 1.0
    assert S.bound_s(0, int(p["fp32_ops_per_s"])) == 1.0
    assert S.bound_s(10, 10**9) == 10**9 / p["fp32_ops_per_s"]
