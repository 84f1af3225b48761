"""The port's measurement seams in `ops/solver.py` and `ops/consolidate.py`:
`provenance()`, `kernel_args`, `slope_time`, `kernel_device_time` and
`screen_device_time`, held against the JAX reference where the reference
computes the same thing.

`kernel_args` must build the reference's packed group buffer, conflict
matrix, catalog and statics element for element from the same encoded
input, and one dispatch of them (`_run_onebuf`, the scan's plain version on
the CPU) must give the reference's `_solve_onebuf` packed vector. The
probes run here with device="cpu": positive, finite, over variants that
are distinct (the solve's packed results; the screen's node buffers, and
its packed results where a perturbation crosses a floor of kernel A).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.catalog import small_catalog
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models.pod import Pod, PodAffinityTerm
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.encode import encode_catalog, encode_pods

from karpenter_tpu_torch import convert, models as pm
from karpenter_tpu_torch.models import labels as PL
from karpenter_tpu_torch.ops import consolidate as port_consolidate
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.ops.encode import encode_catalog as port_catalog
from karpenter_tpu_torch.ops.encode import encode_pods as port_pods
from karpenter_tpu_torch.state.cluster import NodeView


@pytest.fixture(scope="module", autouse=True)
def _rotate_reference_intern_table():
    yield
    ref_pod._sig_intern.clear()


@pytest.fixture(autouse=True)
def _same_columns():
    """Both packages' monotone unions of requested resource columns hold
    the same columns: they set the packed matrices' widths."""
    cols = ref_solver._cols_union | port_solver._cols_union
    ref_solver._cols_union.update(cols)
    port_solver._cols_union.update(cols)


def mk_pods(n, cpu="500m", mem="1Gi", prefix="p", **kw):
    return [Pod(name=f"{prefix}-{i}",
                requests=Resources.parse({"cpu": cpu, "memory": mem}), **kw)
            for i in range(n)]


def _anti():
    return [PodAffinityTerm(topology_key="kubernetes.io/hostname",
                            label_selector={"app": "x"}, anti=True)]


CASES = {
    "single_group": lambda: mk_pods(100),
    "heterogeneous": lambda: (mk_pods(40, "250m", "512Mi", "s")
                              + mk_pods(25, "2", "4Gi", "l")
                              + mk_pods(30, "1", "16Gi", "m")),
    "conflicts": lambda: (mk_pods(7, "250m", "512Mi", "aa",
                                  labels={"app": "x"},
                                  affinity_terms=_anti())
                          + mk_pods(20, "1", "2Gi", "b")),
}


def _inputs(case):
    cat = encode_catalog(small_catalog())
    enc = encode_pods(CASES[case](), cat)
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(
        {k: v for k, v in vars(enc).items() if k != "groups"})
    return cat, enc, pcat, penc


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_args_equal_the_reference(case):
    cat, enc, pcat, penc = _inputs(case)
    (alloc, price, avail, gbuf, prior, banned, conflict, zovh, nbuf), \
        want = ref_solver.kernel_args(cat, enc)
    args, got = port_solver.kernel_args(pcat, penc, device="cpu")
    assert got == want
    dcat, pgbuf, pprior, pbanned, pconflict, pnbuf, n_existing = args
    np.testing.assert_array_equal(pgbuf.numpy(), np.asarray(gbuf))
    assert (pconflict is None) == (conflict is None) == \
        (not want["track_conflicts"])
    if conflict is not None:
        np.testing.assert_array_equal(pconflict.numpy(),
                                      np.asarray(conflict))
    for mine, ref in ((dcat.alloc, alloc), (dcat.price, price),
                      (dcat.avail, avail)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert (prior, banned, nbuf, zovh) == (None,) * 4
    assert (pprior, pbanned, pnbuf, n_existing) == (None, None, None, 0)
    # one dispatch of the probe's inputs: the reference's packed vector
    packed = ref_solver._solve_onebuf(alloc, price, avail, gbuf, prior,
                                      banned, conflict, zovh, nbuf, **want)
    np.testing.assert_array_equal(
        port_solver._run_onebuf(args, got).numpy(), np.asarray(packed))


def test_provenance_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prov = port_solver.provenance()
    assert prov == {"backend": "cpu", "device_kind": "cpu",
                    "device_count": 1, "host_count": 1,
                    "cpu_fallback": True, "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    # the reference's keys, plus torch's and CUDA's versions
    assert set(ref_solver.provenance()) | {"torch", "cuda"} == set(prov)
    from karpenter_tpu_torch.obs.perfarchive import run_stamp
    assert run_stamp(prov)["comparable"] is False


def test_provenance_never_raises(monkeypatch):
    def boom():
        raise RuntimeError("CUDA runtime gone")
    monkeypatch.setattr(torch.cuda, "is_available", boom)
    prov = port_solver.provenance()
    assert prov["error"] == "RuntimeError: CUDA runtime gone"
    assert prov["cpu_fallback"] is True


def test_slope_time_is_the_per_call_slope(monkeypatch):
    """On a clock where each call costs 2 ms and each loop pays a fixed 7 ms
    on its first call (the ramp and the one wait), the slope is exactly the
    2 ms a call; the loops run the warm-up, 2 x N and 2 x 2N calls, cycling
    every variant."""
    clock = {"t": 0.0}
    calls = []
    fake_time = SimpleNamespace(perf_counter=lambda: clock["t"])
    monkeypatch.setattr(port_solver, "time", fake_time)

    def dispatch(i):
        clock["t"] += 0.002 + (0.007 if i == 0 else 0.0)
        calls.append(i % 8)
        return torch.zeros(1)

    t = port_solver.slope_time(dispatch, iters=10)
    assert t == pytest.approx(0.002, rel=1e-9)
    assert len(calls) == 8 + 2 * 10 + 2 * 20
    assert set(calls) == set(range(8))


def _grid(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    cpus = ("100m", "250m", "500m", "1", "2", "4")
    mems = ("128Mi", "512Mi", "1Gi", "2Gi", "4Gi", "8Gi")
    return [pm.Pod(name=f"g{i}", requests=pm.Resources.parse(
        {"cpu": cpus[c], "memory": mems[m]}))
        for i, (c, m) in enumerate(zip(rng.integers(0, 6, n).tolist(),
                                       rng.integers(0, 6, n).tolist()))]


def _views(cat, enc):
    res = port_solver.solve_device(cat, enc, device="cpu")
    counts = np.zeros((len(res.nodes), enc.G), np.int32)
    for i, n in enumerate(res.nodes):
        for g, c in n.pods_by_group.items():
            counts[i, g] = c
    views = [NodeView(claim=pm.NodeClaim(name=f"n{i}", nodepool="d"),
                      node=None, pods=[], virtual=n, price=0.0)
             for i, n in enumerate(res.nodes)]
    return views, counts


def test_kernel_device_time_on_the_cpu():
    from karpenter_tpu_torch.catalog import generate_catalog
    cat = port_catalog(generate_catalog())
    enc = port_pods(_grid(), cat)
    dispatch = port_solver._kernel_dispatch(cat, enc, "cpu")
    outs = {dispatch(i).numpy().tobytes()
            for i in range(port_solver.PROBE_VARIANTS)}
    assert len(outs) == port_solver.PROBE_VARIANTS  # every variant distinct
    t = port_solver.kernel_device_time(cat, enc, iters=4, device="cpu")
    assert math.isfinite(t) and t > 0


def test_kernel_probe_refuses_a_variant_past_the_node_budget(monkeypatch):
    """A variant the production loop would re-scan at a larger budget is
    refused, not timed."""
    from karpenter_tpu_torch.catalog import generate_catalog
    cat = port_catalog(generate_catalog())
    enc = port_pods(_grid(), cat)
    monkeypatch.setattr(port_solver, "_auto_node_budget",
                        lambda cat, enc, n: 64)
    with pytest.raises(ValueError, match="overflows the node budget"):
        port_solver.kernel_device_time(cat, enc, iters=2, device="cpu")


def test_screen_device_time_on_the_cpu():
    """One 4-core type, no overhead, 7 one-core pods: the second node's
    1.0 cores of headroom fit one more pod, 1.0 - 0.001 x i fits none, so
    kernel A's k differs between variant 0 and the others."""
    types = [pm.InstanceType(
        name="f.s0", requirements=pm.Requirements.from_labels(
            {PL.INSTANCE_FAMILY: "f"}),
        capacity=pm.Resources.parse({"cpu": 4, "memory": "16Gi",
                                     "pods": 110}),
        offerings=[pm.Offering(zone="zone-a", capacity_type="on-demand",
                               price=1.0)])]
    cat = port_catalog(types)
    enc = port_pods([pm.Pod(name=f"p{i}", requests=pm.Resources.parse(
        {"cpu": "1", "memory": "1Gi"})) for i in range(7)], cat)
    views, counts = _views(cat, enc)
    dispatch = port_consolidate._screen_dispatch(cat, enc, views, counts,
                                                 "cpu")
    outs = [dispatch(i).numpy() for i in range(port_solver.PROBE_VARIANTS)]
    assert len({o.tobytes() for o in outs}) == 2
    t = port_consolidate.screen_device_time(cat, enc, views, counts,
                                            iters=4, device="cpu")
    assert math.isfinite(t) and t > 0


def test_screen_probe_variants_are_distinct_inputs(monkeypatch):
    """At a grid mix no 0.001 x i change of a node's cores crosses a floor
    of kernel A, so the packed screens agree; the probe still feeds the
    kernel PROBE_VARIANTS distinct node matrices, each the production one
    with cum[:, 0] raised by i x 0.001 (f32)."""
    from karpenter_tpu_torch.catalog import generate_catalog
    cat = port_catalog(generate_catalog())
    enc = port_pods(_grid(), cat)
    views, counts = _views(cat, enc)
    seen = []
    real = port_consolidate._screen_onebuf

    def spy(alloc, avail, nbuf, gbuf, cols):
        seen.append(nbuf.clone())
        return real(alloc, avail, nbuf, gbuf, cols)

    monkeypatch.setattr(port_consolidate, "_screen_onebuf", spy)
    dispatch = port_consolidate._screen_dispatch(cat, enc, views, counts,
                                                 "cpu")
    outs = [dispatch(i) for i in range(port_solver.PROBE_VARIANTS)]
    base = seen[0]
    for i, nb in enumerate(seen):
        d = (nb - base).numpy()
        np.testing.assert_allclose(d[:, 1], np.float32(i) * 0.001,
                                   rtol=1e-3, atol=1e-6)
        assert not d[:, 2:].any() and not d[:, 0].any()
    screen, _ = port_consolidate.consolidation_screen(cat, enc, views, counts,
                                                      device="cpu")
    np.testing.assert_array_equal(outs[0][:len(views)].numpy() > 0.5, screen)
