"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither jax nor the JAX package, so on a machine with
the card and without jax it runs alone:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import catalog, models
from karpenter_tpu_torch.models import labels as L
from karpenter_tpu_torch.ops import screen_k as sk
from karpenter_tpu_torch.ops import solve_scan as ss
from karpenter_tpu_torch.ops import solver as solver_mod
from karpenter_tpu_torch.ops.binpack import solve_host, validate_solution
from karpenter_tpu_torch.ops.encode import encode_catalog, encode_pods
from karpenter_tpu_torch.ops.solver import solve_device, solve_packed

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(300, 37, 6), (8, 1, 1), (257, 129, 9),
                                   (64, 128, 4), (4250, 90, 2), (7, 3, 2)])
def test_screen_k_kernel_matches_plain(cuda, shape):
    N, G, R = shape
    rng = np.random.default_rng(3)
    head = rng.uniform(-2.0, 12.0, (N, R)).astype(np.float32)
    req = rng.uniform(0.0, 3.0, (G, R)).astype(np.float32)
    req[rng.random((G, R)) < 0.3] = 0.0
    elig = rng.random((N, G)) < 0.8
    head, req, elig = (torch.as_tensor(a, device=cuda)
                       for a in (head, req, elig))
    n0 = sk.launches
    got = sk.screen_k(head, req, elig)
    torch.cuda.synchronize()
    assert sk.launches == n0 + 1
    assert torch.equal(got, sk.screen_k_plain(head, req, elig))


def _golden():
    cat = encode_catalog(catalog.small_catalog())
    anti = [models.PodAffinityTerm(topology_key=L.HOSTNAME,
                                   label_selector={"tier": "web"}, anti=True)]

    def mk(n, c, m, p, **kw):
        return [models.Pod(name=f"{p}{i}", requests=models.Resources.parse(
            {"cpu": c, "memory": m}), **kw) for i in range(n)]
    pods = (mk(40, "250m", "512Mi", "s") + mk(25, "2", "4Gi", "l")
            + mk(4, "1", "2Gi", "db", labels={"tier": "db"},
                 affinity_terms=anti)
            + mk(6, "500m", "1Gi", "web", labels={"tier": "web"})
            + mk(10, "500m", "1Gi", "z", node_selector={L.ZONE: "zone-b"})
            + [models.Pod(name=f"e{i}", requests=models.Resources())
               for i in range(5)])
    return cat, encode_pods(pods, cat)


def _golden_case(case):
    cat, enc = _golden()
    existing = []
    if case == "resumed":
        existing = solve_host(cat, enc).nodes[:4]
        for i, n in enumerate(existing):
            n.existing_name = f"n{i}"
            n.prior_by_group = {0: 1} if i == 0 else {}
            n.banned_groups = (np.arange(enc.G) % 2 == 0) if i == 1 else None
    if case == "zone_overhead":
        zovh = np.zeros((cat.T, cat.Z, cat.allocatable.shape[1]), np.float32)
        zovh[:, 0, 0] = np.float32(0.5)
        cat = dataclasses.replace(cat, zone_overhead=zovh)
    return cat, enc, existing


@pytest.mark.parametrize("case", ["fresh", "resumed", "zone_overhead"])
def test_solve_scan_kernel_matches_plain(cuda, case):
    cat, enc, existing = _golden_case(case)
    n0, b0 = ss.launches, ss.offer_launches
    got, _ = solve_packed(cat, enc, existing, device=cuda)
    assert ss.launches == n0 + 1 and ss.offer_launches == b0 + 1
    want, _ = solve_packed(cat, enc, existing, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["fresh", "resumed", "zone_overhead"])
def test_offer_argmin_kernel_matches_plain(cuda, case, monkeypatch):
    cat, enc, existing = _golden_case(case)
    calls = []
    real = solver_mod.solve_scan

    def rec(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    monkeypatch.setattr(solver_mod, "solve_scan", rec)
    solve_packed(cat, enc, existing, device=cuda)
    (a, kw), = calls
    bound = inspect.signature(ss.solve_scan_plain).bind(*a, **kw)
    bound.apply_defaults()
    oa = {k: bound.arguments[k]
          for k in inspect.signature(ss.offer_argmin_plain).parameters}
    got = ss.offer_argmin(**oa)
    torch.cuda.synchronize()
    for x, y in zip(got, ss.offer_argmin_plain(**oa)):
        assert torch.equal(x.to(y.dtype), y)


@pytest.mark.parametrize("n_max,cl,in_shared", [(64, 1, True),
                                                (16_384, 16, True),
                                                (262_144, 16, False)])
def test_solve_scan_cluster_layouts(cuda, n_max, cl, in_shared):
    """Kernel B at CL 1, at the largest cluster, and with its node slices
    in global scratch: the same packed vector as the plain version."""
    cat, enc, _ = _golden_case("fresh")
    _, st = solve_packed(cat, enc, n_max=n_max, device="cpu")
    W = -(-st["Gp"] // 32) if st["track_conflicts"] else 0
    lay = ss._scan_layout(n_max, len(st["cols"]), W, cat.Z, cat.C, cat.T,
                          st["zone_ovh"])
    assert (lay.cl, lay.nodes_smem) == (cl, in_shared)
    got, _ = solve_packed(cat, enc, n_max=n_max, device=cuda)
    want, _ = solve_packed(cat, enc, n_max=n_max, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_full_catalog_solve_on_the_card(cuda):
    cat = encode_catalog(catalog.generate_catalog())
    rng = np.random.default_rng(0)
    cpus = ("100m", "250m", "500m", "1", "2", "4")
    mems = ("256Mi", "1Gi", "2Gi", "4Gi", "8Gi")
    pods = [models.Pod(name=f"p{i}", requests=models.Resources.parse(
        {"cpu": cpus[c], "memory": mems[m]}))
        for i, (c, m) in enumerate(zip(rng.integers(0, 6, 5000).tolist(),
                                       rng.integers(0, 5, 5000).tolist()))]
    enc = encode_pods(pods, cat)
    d = solve_device(cat, enc)
    assert not validate_solution(cat, enc, d)
    h = solve_host(cat, enc)
    assert len(d.nodes) == len(h.nodes) and d.launches == h.launches
    for x, y in zip(d.nodes, h.nodes):
        assert x.type_idx == y.type_idx and x.pods_by_group == y.pods_by_group


@pytest.mark.parametrize("shape", [(232, 382, 90, 3), (20, 4250, 90, 2),
                                   (16, 31, 600, 9), (3, 5, 1, 1),
                                   (40, 33, 7, 16)])
def test_tournament_kernel_matches_plain(cuda, shape):
    """Kernel C against tournament_plain on the card: every packed output
    equal (the plain version adds in the kernel's orders: nodes in node
    order, groups in group order)."""
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    args = tk.seeded_inputs(1, *shape, cuda)
    n0 = tk.launches
    got = tk.tournament(*args)
    torch.cuda.synchronize()
    assert tk.launches == n0 + 1
    assert torch.equal(got, tk.tournament_plain(*args))


def test_tournament_kernel_reads_packed_views(cuda):
    """req, counts and masks as row-strided views of one packed buffer, as
    score_subsets_device hands them over: the same output as contiguous
    copies."""
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    args = tk.seeded_inputs(2, 50, 40, 12, 3, cuda)
    got = tk.tournament_cuda(*tk.packed_views(args))
    want = tk.tournament_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
