"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither jax nor the JAX package, so on a machine with
the card and without jax it runs alone:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import ctypes
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


def _bucket_args(dev, Bp: int, n_max: int, case: str):
    """solve_scan_batched's (args, kwargs) for a seeded bucket of Bp golden
    requests at n_max: each row's group counts drawn anew (up to 4x the
    golden's), the last row of a bucket zeroed as a padded row. case:
    "plain" (no conflicts), "conflicts" (the golden's db/web conflict) or
    "zone_overhead" (conflicts and a zone reservation)."""
    cat, enc, _ = _golden_case("zone_overhead" if case == "zone_overhead"
                               else "fresh")
    if case == "plain":
        enc = dataclasses.replace(enc, conflict=None)
    dcat = solver_mod.device_catalog(cat, enc.requests.shape[1], dev)
    Gp = solver_mod._bucket(enc.G, 8)
    cols = solver_mod._request_cols(enc, cat)
    g = solver_mod._pack_groups(*solver_mod._group_inputs(enc, Gp),
                                list(cols))
    rng = np.random.default_rng(Bp * 7 + n_max)
    stack = np.repeat(g[None], Bp, axis=0)
    stack[:, :enc.G, len(cols)] = rng.integers(0, 4 * enc.counts + 1,
                                               (Bp, enc.G))
    if Bp > 1:
        stack[-1, :, len(cols)] = 0.0
    track = enc.conflict is not None
    conf = None
    if track:
        c = solver_mod._pad_to(solver_mod._pad_to(enc.conflict, Gp, 0), Gp, 1)
        conf = torch.as_tensor(np.repeat(c[None], Bp, axis=0), device=dev)
    st = dict(n_max=n_max, cols=cols, track_conflicts=track,
              zone_ovh=dcat.ovh_z is not None)
    return solver_mod._scan_batched_args(
        dcat, torch.as_tensor(stack, device=dev), conf, st)


def _row(args, b: int):
    """Request b's arguments of solve_scan_batched as solve_scan's: the
    group inputs (positions 3-11) indexed, the rest shared."""
    return args[:3] + tuple(a[b] for a in args[3:12]) + args[12:]


_B0_ARGS = (0, 1, 2, 3, 5, 6, 7, 8, 12)  # offer_argmin's, by position


@pytest.mark.parametrize("Bp", [1, 3, 16])
@pytest.mark.parametrize("case", ["plain", "conflicts", "zone_overhead"])
@pytest.mark.parametrize("n_max,cl,in_shared", [(64, 1, True),
                                                (16_384, 16, True),
                                                (262_144, 16, False)])
def test_batched_scan_matches_plain(cuda, Bp, case, n_max, cl, in_shared):
    """ONE launch each of B0 and B over a bucket equals the per-row plain
    version at atol 0, and each row equals a serial launch, in every tier
    of kernel B's layout (one block; a cluster of 16 with the slices in
    shared memory; global scratch, taken at Bp = 2)."""
    if not in_shared:
        Bp = min(Bp, 2)
    args, kw = _bucket_args(cuda, Bp, n_max, case)
    Gp, Rk = args[3].shape[1:]
    W = -(-Gp // 32) if kw["track_conflicts"] else 0
    T, Z, C = args[1].shape
    lay = ss._scan_layout(n_max, Rk, W, Z, C, T, kw["zone_ovh"])
    assert (lay.cl, lay.nodes_smem) == (cl, in_shared)
    n0, b0 = ss.launches, ss.offer_launches
    got = ss.solve_scan_batched(*args, **kw)
    torch.cuda.synchronize()
    assert (ss.launches, ss.offer_launches) == (n0 + 1, b0 + 1)
    want = ss.solve_scan_batched_plain(*args, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x.to(y.dtype), y)
    k_max = solver_mod._bucket(2 * n_max)
    packed = ss.pack_solution_batched(*got, k_max)
    for b in range(Bp):
        serial = ss.solve_scan_cuda(*_row(args, b), **kw)
        torch.cuda.synchronize()
        for x, y in zip(got, serial):
            assert torch.equal(x[b], y)
        assert torch.equal(packed[b], ss.pack_solution(*serial, k_max))
    # B0 alone, batched, against offer_argmin_plain row by row
    oa = [args[i] for i in _B0_ARGS]
    got0 = ss.offer_argmin_batched_cuda(*oa, zone_ovh=kw["zone_ovh"])
    torch.cuda.synchronize()
    for b in range(Bp):
        want0 = ss.offer_argmin_plain(*[a[b] if 3 <= i <= 8 else a
                                        for i, a in zip(_B0_ARGS, oa)],
                                      zone_ovh=kw["zone_ovh"])
        for x, y in zip(got0, want0):
            assert torch.equal(x[b].to(y.dtype), y)


@pytest.mark.parametrize("Bp", [1, 3, 16])
def test_batched_offer_table_writes_availbits_once(cuda, Bp, monkeypatch):
    """B0 over a bucket writes ONE catalog-only availability table [T]:
    a debug build that counts the stores (-DSOLVE_SCAN_COUNT_WRITES) sees
    T of them a launch, not Bp * T; the table is right and the
    per-request records equal each row's serial launch."""
    from karpenter_tpu_torch.ops import _build
    dbg = _build.load("solve_scan", ("-DSOLVE_SCAN_COUNT_WRITES",))
    offer = dbg.offer_argmin_launch
    offer.argtypes, offer.restype = ss._lib()["offer"].argtypes, ctypes.c_int
    writes = dbg.offer_argmin_availbits_writes
    writes.argtypes, writes.restype = [], ctypes.c_longlong
    monkeypatch.setitem(ss._fns, "offer", offer)
    args, kw = _bucket_args(cuda, Bp, 64, "zone_overhead")
    avail = args[2]
    T = avail.shape[0]
    assert writes() >= 0
    recs, bits, _ = ss._offer_table(*args[:13], kw["zone_ovh"],
                                    kw["track_conflicts"])
    assert writes() == T
    ZC = avail[0].numel()
    want = (avail.reshape(T, ZC).to(torch.int64)
            << torch.arange(ZC, device=cuda)).sum(dim=1)
    assert tuple(bits.shape) == (T,)
    assert torch.equal(bits, want)
    for b in range(Bp):
        r_b, bits_b, _ = ss._offer_table(
            *[x[None] if 3 <= i <= 11 else x
              for i, x in enumerate(_row(args, b)[:13])],
            kw["zone_ovh"], kw["track_conflicts"])
        assert writes() == T
        assert torch.equal(recs[b], r_b[0]) and torch.equal(bits_b, want)


def test_batched_dispatch_does_not_wait_for_the_card(cuda):
    """dispatch_batch returns while the batch before it still runs: no
    copy or call in it synchronises (torch's sync debug mode raises on
    any it knows of, and the busy stream's event is still pending when
    the dispatch returns), and both batches' rows equal serial
    solve_packed vectors."""
    types = catalog.generate_catalog()[:64]
    cat = encode_catalog(types)
    rng = np.random.default_rng(7)
    sigs = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi")]
    encs = []
    for k in range(6):
        pods = [models.Pod(name=f"t{k}-p{i}", requests=models.Resources.parse(
            dict(zip(("cpu", "memory"), sigs[s]))))
            for i, s in enumerate(rng.integers(0, 4, 40).tolist())]
        encs.append(encode_pods(pods, cat))
    dcat = solver_mod.device_catalog(cat, encs[0].requests.shape[1], cuda)
    reqs = [solver_mod.prepare_batchable(cat, e, dcat=dcat) for e in encs]
    sig = reqs[0].signature
    assert all(r.signature == sig for r in reqs)
    first = solver_mod.dispatch_batch(reqs[:3])  # warms the column index
    first.block()
    inflight = solver_mod.dispatch_batch(reqs[:3])
    torch.cuda._sleep(1 << 30)  # keeps the stream busy for a while
    busy = torch.cuda.Event()
    busy.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = solver_mod.dispatch_batch(reqs[3:])
        pending = not busy.query()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pending
    rows = np.concatenate([inflight.rows(), second.rows()])
    for r, e, row in zip(reqs, encs, rows):
        want, st = solve_packed(cat, e, device=cuda)
        assert st["n_max"] == r.statics["n_max"]
        np.testing.assert_array_equal(row, want)


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


@pytest.mark.parametrize("shape,tier,cl,spb,k_smem", [
    ((64, 300, 90, 3), "block", 1, 1, True),       # one block, k resident
    ((232, 382, 90, 2), "block", 1, 1, False),     # one block, k streamed
    ((12, 600, 90, 2), "cluster", 2, 1, True),     # a cluster of 2
    ((6, 2001, 90, 2), "cluster", 8, 1, True),     # 8; N not a multiple
    ((20, 4250, 90, 2), "cluster", 16, 1, True),   # the grid-mix search
    ((4, 5000, 90, 2), "cluster", 16, 1, False),   # 16, k streamed
    ((4, 600, 1536, 2), "global", 16, 1, False),   # slices in global scratch
    ((1000, 382, 90, 2), "block", 1, 1, False),    # many waves of subsets
    ((600, 40, 7, 3), "block", 1, 4, True),        # several subsets a block
    ((40, 500, 30, 16), "block", 1, 1, True),      # Rk = 16
    ((10, 1500, 90, 16), "cluster", 8, 1, True),   # Rk = 16 in a cluster
])
def test_tournament_tiers(cuda, shape, tier, cl, spb, k_smem):
    """Kernel C on each tier of its layout: every packed output equal to
    tournament_plain (atol 0), contiguous and on row-strided packed
    views."""
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    lay = tk.tournament_layout(*shape)
    assert (lay.tier, lay.cl, lay.spb, lay.k_smem) == (tier, cl, spb, k_smem)
    args = tk.seeded_inputs(7, *shape, cuda)
    got = tk.tournament_cuda(*args)
    strided = tk.tournament_cuda(*tk.packed_views(args))
    torch.cuda.synchronize()
    want = tk.tournament_plain(*args)
    assert torch.equal(got, want)
    assert torch.equal(strided, want)
