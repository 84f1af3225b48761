"""Drive karpenter_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   the CUDA kernels from karpenter_tpu_torch/csrc/ with nvcc
  2. check   each kernel against its plain PyTorch version at small shapes
             (kernel A: the four reference test shapes, atol 0; kernels B0
             and B: golden-style solves incl. conflicts, resume and zone
             overhead, B0's outputs and the packed vectors equal; kernel B
             also at a node budget that takes the largest cluster and at
             one whose node slices live in global scratch)
  3. main    the full-width main path: the generated catalog (810 types)
             and 100,000 pods drawn from a seeded (cpu, memory) grid,
             solve_device on the card, validate_solution, the host oracle
             on a 10k-pod subset, then consolidation_screen over the placed
             nodes. Launch counts are zeroed just before and read just
             after; every kernel must have launched, the scan exactly once.
  4. check   each kernel against its plain version at the main path's own
             inputs (kernel A atol 0; kernels B0 and B outputs equal)
  5. time    median wall times of the solve and the screen, stage by stage;
             per-kernel device time from torch.profiler and CUDA events
             beside its bound, its plain version's time and one torch
             expression's time where one computes the same function;
             kernel B at every cluster size at the main path's inputs.

The last two lines of output are the kernels JSON line and
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys
import time

SEED = 0
N_PODS = 100_000
N_SUBSET = 10_000
CPU_GRID = ("100m", "250m", "500m", "750m", "1", "1500m", "2", "3", "4", "6")
MEM_GRID = ("128Mi", "256Mi", "512Mi", "1Gi", "2Gi", "3Gi", "4Gi", "8Gi",
            "16Gi")
N_MAX_LARGEST_CLUSTER = 16_384   # golden input at CL 16, slices in shared
N_MAX_GLOBAL_SLICES = 262_144    # golden input past the cluster's capacity
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def grid_pods(models, n: int, seed: int):
    """n pods, each a (cpu, memory) pair drawn from the seeded grid."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ci = rng.integers(0, len(CPU_GRID), n)
    mi = rng.integers(0, len(MEM_GRID), n)
    return [models.Pod(name=f"p{i}", requests=models.Resources.parse(
        {"cpu": CPU_GRID[c], "memory": MEM_GRID[m]}))
        for i, (c, m) in enumerate(zip(ci.tolist(), mi.tolist()))]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time per call of fn() from CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of fn() (fn ends in a host read)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def device_kernel_us(fn) -> dict:
    """{kernel name: (device microseconds, launches)} of the CUDA kernels
    fn() runs, from torch.profiler (CUPTI); {} when the trace holds no
    device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


def kernel_ms(events: dict, needle: str):
    """Mean device ms per launch of the kernels whose name holds needle."""
    hits = [(us, n) for name, (us, n) in events.items() if needle in name]
    if not hits:
        return None
    return sum(us for us, _ in hits) / 1e3 / sum(n for _, n in hits)


class Recorder:
    """Wraps a module attribute to keep the arguments of its calls (the
    main path's kernel inputs), calling through unchanged."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def shim(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.real(*args, **kwargs)
        setattr(self.module, self.name, shim)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def offer_args(ss, args, kwargs) -> dict:
    """offer_argmin's arguments, taken from one solve_scan call's."""
    bound = inspect.signature(ss.solve_scan_plain).bind(*args, **kwargs)
    bound.apply_defaults()
    names = inspect.signature(ss.offer_argmin_plain).parameters
    return {k: bound.arguments[k] for k in names}


def scan_layout_of(ss, args, kwargs):
    """The layout kernel B takes for one solve_scan call's arguments."""
    b = inspect.signature(ss.solve_scan_plain).bind(*args, **kwargs)
    b.apply_defaults()
    a = b.arguments
    T, Z, C = a["price"].shape
    Gp, Rk = a["requests"].shape
    W = -(-Gp // 32) if a["track_conflicts"] else 0
    return ss._scan_layout(a["n_max"], Rk, W, Z, C, T, a["zone_ovh"])


def check_offer(ss, args, kwargs, what: str) -> None:
    """Kernel B0 against offer_argmin_plain on one solve's inputs."""
    import torch
    oa = offer_args(ss, args, kwargs)
    got = ss.offer_argmin_cuda(**oa)
    torch.cuda.synchronize()
    want = ss.offer_argmin_plain(**oa)
    for x, y, name in zip(got, want, ("t_star", "s", "ok", "t_avail_z",
                                      "t_avail_c")):
        check(torch.equal(x.to(y.dtype), y),
              f"offer_argmin != plain ({what}: {name})")


def phase_build():
    from karpenter_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernel sources in {time.perf_counter() - t0:.1f} s "
        f"with {' '.join(_build.NVCC_FLAGS)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def screen_inputs(seed: int, N: int, G: int, R: int, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    head = rng.uniform(-2.0, 12.0, (N, R)).astype(np.float32)
    req = rng.uniform(0.0, 3.0, (G, R)).astype(np.float32)
    req[rng.random((G, R)) < 0.3] = 0.0
    elig = rng.random((N, G)) < 0.8
    return tuple(torch.as_tensor(a, device=dev) for a in (head, req, elig))


def phase_check_small(dev) -> None:
    import dataclasses
    import numpy as np
    import torch
    from karpenter_tpu_torch import catalog, models
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.ops import screen_k as sk
    from karpenter_tpu_torch.ops import solve_scan as ss, solver
    from karpenter_tpu_torch.ops.binpack import solve_host
    from karpenter_tpu_torch.ops.encode import encode_catalog, encode_pods

    for shape in [(300, 37, 6), (8, 1, 1), (257, 129, 9), (64, 128, 4),
                  (7, 3, 2)]:
        head, req, elig = screen_inputs(7, *shape, dev)
        got = sk.screen_k_cuda(head, req, elig)
        torch.cuda.synchronize()
        want = sk.screen_k_plain(head, req, elig)
        check(torch.equal(got, want), f"screen_k != plain at {shape}")
    log("[check] screen_k == plain (atol 0) at the four test shapes and a "
        "ragged 7x3")

    cat = encode_catalog(catalog.small_catalog())
    anti = [models.PodAffinityTerm(topology_key=L.HOSTNAME,
                                   label_selector={"tier": "web"}, anti=True)]
    mk = lambda n, c, m, p, **kw: [models.Pod(
        name=f"{p}{i}", requests=models.Resources.parse({"cpu": c, "memory": m}),
        **kw) for i in range(n)]
    pods = (mk(40, "250m", "512Mi", "s") + mk(25, "2", "4Gi", "l")
            + mk(4, "1", "2Gi", "db", labels={"tier": "db"}, affinity_terms=anti)
            + mk(6, "500m", "1Gi", "web", labels={"tier": "web"})
            + mk(10, "500m", "1Gi", "z", node_selector={L.ZONE: "zone-b"})
            + [models.Pod(name=f"e{i}", requests=models.Resources())
               for i in range(5)])
    enc = encode_pods(pods, cat)
    base = solve_host(cat, enc)
    existing = base.nodes[:4]
    for i, n in enumerate(existing):
        n.existing_name = f"n{i}"
        n.prior_by_group = {0: 1} if i == 0 else {}
        n.banned_groups = (np.arange(enc.G) % 2 == 0) if i == 1 else None
    zovh = np.zeros((cat.T, cat.Z, cat.allocatable.shape[1]), np.float32)
    zovh[:, 0, 0] = np.float32(0.5)
    zcat = dataclasses.replace(cat, zone_overhead=zovh)
    cases = {"fresh+conflicts": (cat, [], None),
             "resumed+prior+banned": (cat, existing, None),
             "zone_overhead": (zcat, [], None),
             "largest_cluster": (cat, [], N_MAX_LARGEST_CLUSTER),
             "global_slices": (cat, [], N_MAX_GLOBAL_SLICES)}
    for name, (c, ex, n_max) in cases.items():
        with Recorder(solver, "solve_scan") as rec:
            got, st = solver.solve_packed(c, enc, ex, n_max=n_max, device=dev)
        torch.cuda.synchronize()
        want, _ = solver.solve_packed(c, enc, ex, n_max=n_max, device="cpu")
        check(np.array_equal(got, want), f"solve_scan != plain ({name})")
        (args, kw), = rec.calls
        lay = scan_layout_of(ss, args, kw)
        check_offer(ss, args, kw, name)
        log(f"[check] {name}: offer_argmin == plain, solve_scan packed == "
            f"plain at n_max={st['n_max']}; layout cl={lay.cl} "
            f"slice={lay.slice} nodes_in_shared={lay.nodes_smem} "
            f"catalog_in_shared={lay.cat_smem} smem={lay.smem_bytes} B")
        if name == "largest_cluster":
            check(lay.cl == ss.CL_MAX and lay.nodes_smem,
                  f"{name} did not take the largest cluster: {lay}")
        if name == "global_slices":
            check(not lay.nodes_smem, f"{name} kept its slices in shared "
                  f"memory: {lay}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "port on an NVIDIA GPU")
    try:
        import numpy as np
        from karpenter_tpu_torch import catalog, models
        from karpenter_tpu_torch.ops import consolidate, screen_k as sk
        from karpenter_tpu_torch.ops import solve_scan as ss, solver
        from karpenter_tpu_torch.ops.binpack import solve_host, validate_solution
        from karpenter_tpu_torch.ops.encode import encode_catalog, encode_pods
    except ImportError as e:
        fail(f"karpenter_tpu_torch is not importable ({e}): run from the root "
             f"of a checkout")
    # the solve and the screen must not depend on TF32 (no matmul runs, but
    # state it: full-precision f32 everywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = solver.resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase_build()
    phase_check_small(dev)

    # --- 3. the main path at full width ---
    t0 = time.perf_counter()
    types = catalog.generate_catalog()
    cat = encode_catalog(types)
    pods = grid_pods(models, N_PODS, SEED)
    t1 = time.perf_counter()
    enc = encode_pods(pods, cat)
    encode_ms = (time.perf_counter() - t1) * 1e3
    Gp = solver._bucket(enc.G, 8)
    n_max0 = solver._auto_node_budget(cat, enc, 0)
    log(f"[main] catalog T={cat.T} Z={cat.Z} C={cat.C} R={cat.allocatable.shape[1]}"
        f"; {N_PODS} pods -> G={enc.G} (Gp={Gp}); n_max={n_max0}; "
        f"cols={solver._request_cols(enc, cat)}; setup {(t1 - t0):.1f} s, "
        f"encode {encode_ms:.1f} ms")

    ss.launches = 0
    ss.offer_launches = 0
    sk.launches = 0
    with Recorder(solver, "solve_scan") as rec_b:
        result = solver.solve_device(cat, enc)
    n_nodes = len(result.nodes)
    n_unsched = sum(result.unschedulable.values())
    errors = validate_solution(cat, enc, result)
    check(not errors, f"validate_solution: {errors[:5]}")
    counts = np.zeros((n_nodes, enc.G), np.int32)
    for i, n in enumerate(result.nodes):
        for g, c in n.pods_by_group.items():
            counts[i, g] = c
    views = [consolidate.NodeView(virtual=n) for n in result.nodes]
    with Recorder(consolidate, "screen_k") as rec_a:
        screen, slack = consolidate.consolidation_screen(cat, enc, views,
                                                         counts)
    launches = {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches}
    log(f"[main] solve: {n_nodes} nodes, {n_unsched} unschedulable, "
        f"{len(result.launches)} launches; screen: {int(screen.sum())} of "
        f"{n_nodes} candidates pass; kernel launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(launches["solve_scan"] == 1 and launches["offer_argmin"] == 1,
          f"one solve_device must scan once: {launches}")

    # the plain versions of the same solve, on the same card
    (sargs, skw), = rec_b.calls[-1:]
    lay = scan_layout_of(ss, sargs, skw)
    cl_max = ss.max_cluster(lay.smem_bytes)
    log(f"[main] kernel B layout: cl={lay.cl} slice={lay.slice} "
        f"nodes_in_shared={lay.nodes_smem} catalog_in_shared={lay.cat_smem} "
        f"smem={lay.smem_bytes} B a block, record {lay.rec_words} words; "
        f"largest cluster the card co-schedules at that smem: {cl_max}")
    check_offer(ss, sargs, skw, "main path")
    out_k = ss.solve_scan_cuda(*sargs, **skw)
    out_p = ss.solve_scan_plain(*sargs, **skw)
    torch.cuda.synchronize()
    for a, b, what in zip(out_k, out_p, ("ntype", "takes", "unsched", "nused",
                                         "overflow")):
        check(torch.equal(a.to(b.dtype).reshape(b.shape), b),
              f"solve_scan != plain at the main path ({what})")
    k_max = solver._bucket(2 * out_k[1].shape[1])
    check(torch.equal(ss.pack_solution(*out_k, k_max=k_max),
                      ss.pack_solution(*out_p, k_max=k_max)),
          "solve_scan packed vector != plain at the main path")
    plain_nodes, plain_unsched = int(out_p[3]), int(out_p[2].sum())
    check(plain_nodes == n_nodes, "node count differs from the plain version")
    check(plain_unsched == n_unsched,
          "unschedulable count differs from the plain version")
    log(f"[check] offer_argmin == plain and solve_scan == plain at the main "
        f"path: ntype/takes/unsched/nused/overflow and the packed vector "
        f"equal; plain: {plain_nodes} nodes, {plain_unsched} unschedulable")

    # the host oracle on a 10k-pod subset
    sub = encode_pods(pods[:N_SUBSET], cat)
    d = solver.solve_device(cat, sub)
    h = solve_host(cat, sub)
    check(len(d.nodes) == len(h.nodes), f"subset: {len(d.nodes)} nodes on the "
          f"card vs {len(h.nodes)} from solve_host")
    for i, (x, y) in enumerate(zip(d.nodes, h.nodes)):
        check(x.type_idx == y.type_idx and x.pods_by_group == y.pods_by_group,
              f"subset node {i} differs from solve_host")
    check(d.launches == h.launches and d.unschedulable == h.unschedulable,
          "subset launches/unschedulable differ from solve_host")
    log(f"[check] {N_SUBSET}-pod subset: {len(d.nodes)} nodes and launches "
        f"equal to solve_host")

    # the screen against its plain version (device='cpu')
    s_plain, sl_plain = consolidate.consolidation_screen(cat, enc, views,
                                                         counts, device="cpu")
    check(np.array_equal(screen, s_plain), "screen differs from the plain version")
    zero = ~enc.requests.any(axis=1)
    check(np.array_equal(slack[:, ~zero], sl_plain[:, ~zero]),
          "screen slack differs from the plain version")
    if zero.any():
        tol = max(n_nodes - 1, 1) * 2.0 ** -24
        check(np.allclose(slack[:, zero], sl_plain[:, zero], rtol=tol, atol=0),
              "screen slack (all-zero request groups) beyond rtol")
    (aargs, akw), = rec_a.calls[-1:]
    k_got = sk.screen_k_cuda(*aargs, **akw)
    torch.cuda.synchronize()
    k_want = sk.screen_k_plain(*aargs, **akw)
    err_a = float((k_got - k_want).abs().max()) if k_got.numel() else 0.0
    check(err_a == 0.0, f"screen_k differs from plain at the main path: {err_a}")
    head, req, elig = aargs
    log(f"[check] screen == plain (slack atol 0); screen_k == plain at the "
        f"main-path shape N={head.shape[0]} G={req.shape[0]} R={req.shape[1]}")

    # --- 5. times ---
    solve_ms = wall_ms(lambda: solver.solve_device(cat, enc), 5)
    screen_ms = wall_ms(lambda: consolidate.consolidation_screen(
        cat, enc, views, counts), 5)
    log(f"[time] solve_device median wall {solve_ms:.3f} ms (5 runs); "
        f"consolidation_screen median wall {screen_ms:.3f} ms (5 runs); "
        f"encode {encode_ms:.1f} ms (host)")

    # where one solve's time goes, stage by stage (host clock, synced)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out
    nb = timed("node_budget", lambda: solver._auto_node_budget(cat, enc, 0))
    st = timed("stage_upload", lambda: solver._stage(cat, enc, [], dev))
    scan_out = timed("scan", lambda: solver._scan(st, nb))
    kb = solver._bucket(2 * nb)
    buf = timed("pack_read", lambda: ss.pack_solution(
        *scan_out, kb).cpu().numpy())
    nnz0 = int(buf[2])
    if nnz0 > kb:
        kb = solver._bucket(nnz0)
        buf = timed("pack_read_regrown", lambda: ss.pack_solution(
            *scan_out, kb).cpu().numpy())
    nused, _, nnz, unsched, ntype, idx, vals = solver._parse_packed(
        buf, st.Gp, nb, kb)
    timed("decode", lambda: solver._decode_solution(
        cat, enc, [], st.node_cum, st.node_zmask, st.node_cmask, nused, ntype,
        idx, vals, nnz, unsched, nb))
    log(f"[time] solve stages (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + f"; n_max {nb}, nnz {nnz0} vs first k_max {solver._bucket(2 * nb)}"
        f" -> k_max {kb} (re-packed, not re-scanned)")
    ev = device_kernel_us(lambda: solver.solve_device(cat, enc))
    busy = sum(us for us, _ in ev.values()) / 1e3
    if ev:
        top = sorted(ev.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"[time] one solve_device: device busy {busy:.3f} ms of "
            f"{solve_ms:.3f} ms median wall (idle share "
            f"{1 - busy / solve_ms:.4f}); {sum(n for _, n in ev.values())} "
            f"device kernels; top (us, launches): "
            + "; ".join(f"{n[:48]} {us:.1f} x{c}" for n, (us, c) in top))
    else:
        log("[time] torch.profiler recorded no device events: device busy "
            "share not measured")

    oa = offer_args(ss, sargs, skw)
    sb = inspect.signature(ss.solve_scan_plain).bind(*sargs, **skw)
    sb.apply_defaults()
    sa = sb.arguments

    def offer_table():
        return ss._offer_table(
            sa["alloc"], sa["price"], sa["avail"], sa["requests"],
            sa["counts"], sa["compat"], sa["allow_zone"], sa["allow_cap"],
            sa["max_per_node"], sa["prior"], sa["banned"], sa["conflict"],
            sa["zovh"], sa["zone_ovh"], sa["track_conflicts"])
    ev_a = device_kernel_us(lambda: [sk.screen_k_cuda(head, req, elig)
                                     for _ in range(20)])
    ev_b = device_kernel_us(lambda: [ss.solve_scan_cuda(*sargs, **skw)
                                     for _ in range(5)])
    a_kernel = kernel_ms(ev_a, "screen_k_kernel")
    b0_kernel = kernel_ms(ev_b, "offer_argmin_kernel")
    b_kernel = kernel_ms(ev_b, "solve_scan_kernel")

    a_ms = cuda_ms(lambda: sk.screen_k_cuda(head, req, elig), 200)
    a_plain = cuda_ms(lambda: sk.screen_k_plain(head, req, elig), 50)
    eps = float(np.float32(1e-4))

    def library_k():
        safe = torch.where(req > 0, req, 1.0)
        return torch.where(elig, torch.where(
            req[None] > 0, torch.floor(head[:, None, :] / safe[None] + eps),
            1e9).amin(dim=2).clamp_min(0.0), 0.0)
    a_lib = cuda_ms(library_k, 200)
    N, R = head.shape
    G = req.shape[0]
    a_bytes = 4 * N * R + 4 * G * R + N * G + 4 * N * G
    a_ops = 4 * N * G * R
    a_bound = max(a_bytes / HBM_BYTES_PER_S, a_ops / FP32_OPS_PER_S) * 1e3

    T, Z, C = sa["price"].shape
    Gp_b, Rk = sa["requests"].shape
    n_max = out_k[1].shape[1]
    ZC = Z * C
    b0_ms = cuda_ms(offer_table, 100)
    b0_plain = cuda_ms(lambda: ss.offer_argmin_plain(**oa), 20)

    def library_cps():
        # the torch expression that builds cps and takes its argmin (the
        # yardstick for kernel B0; the port never calls it)
        rq, mp = oa["requests"], oa["max_per_node"]
        slots = torch.where(rq[:, None, :] > 0, torch.floor(
            oa["alloc"][None] / torch.where(rq > 0, rq, 1.0)[:, None, :]
            + eps), 1e9).amin(dim=2).clamp_min(0.0)
        slots = torch.minimum(slots, torch.where(mp == 0, 1e9, mp)[:, None])
        feas = (oa["avail"][None] & oa["compat"][:, :, None, None]
                & oa["allow_zone"][:, None, :, None]
                & oa["allow_cap"][:, None, None, :]
                & (slots >= 1)[:, :, None, None])
        cps = torch.where(feas, oa["price"][None]
                          / slots.clamp_min(1.0)[:, :, None, None],
                          torch.finfo(torch.float32).max)
        return torch.argmin(cps.reshape(Gp_b, -1), 1)
    b0_lib = cuda_ms(library_cps, 20)
    b0_bytes = (4 * T * ZC + T * ZC + 4 * T * Rk + Gp_b * (4 * Rk + T + Z + C
                                                            + 8)
                + 4 * Gp_b * lay.rec_words + 8 * T)
    b0_ops = Gp_b * (T * (4 * Rk) + T * ZC * 2)
    b0_bound = max(b0_bytes / HBM_BYTES_PER_S, b0_ops / FP32_OPS_PER_S) * 1e3

    b_ms = cuda_ms(lambda: ss.solve_scan_cuda(*sargs, **skw), 20)
    b_plain = cuda_ms(lambda: ss.solve_scan_plain(*sargs, **skw), 3)
    b_bytes = (4 * T * Rk + 4 * T * ZC + T * ZC
               + Gp_b * (4 * Rk + 4 + T + Z + C + 4)
               + n_max * (4 + 4 * Rk + Z + C + 1)
               + 4 * Gp_b * n_max + 4 * Gp_b + 8)
    b_ops = Gp_b * (n_max * (4 * Rk + ZC + 6) + T * (4 * Rk + 2 * ZC))
    b_bound = max(b_bytes / HBM_BYTES_PER_S, b_ops / FP32_OPS_PER_S) * 1e3
    log(f"[time] kernel-only device time (profiler): screen_k {a_kernel} ms, "
        f"offer_argmin {b0_kernel} ms, solve_scan {b_kernel} ms")
    log(f"[time] screen_k {a_ms:.4f} ms (bound {a_bound:.5f} ms, bytes "
        f"{a_bytes}); plain {a_plain:.4f} ms; one torch expression "
        f"{a_lib:.4f} ms")
    log(f"[time] offer_argmin {b0_ms:.4f} ms per wrapper call (bound "
        f"{b0_bound:.5f} ms, bytes {b0_bytes}, ops {b0_ops}); plain "
        f"{b0_plain:.4f} ms; cps + torch.argmin {b0_lib:.4f} ms")
    log(f"[time] solve_scan {b_ms:.4f} ms per wrapper call, B0 + B + "
        f"wrapper (bound {b_bound:.5f} ms, bytes {b_bytes}, ops {b_ops});"
        f" plain {b_plain:.3f} ms; wrapper beside the two kernels "
        + (f"{b_ms - b_kernel - b0_kernel:.4f} ms"
           if b_kernel is not None and b0_kernel is not None
           else "not measured"))

    # kernel B at every cluster size the node state fits, same inputs
    per_cl = {}
    W = -(-Gp_b // 32) if sa["track_conflicts"] else 0
    for cl in (1, 2, 4, 8, 16):
        if cl > cl_max or not lay.nodes_smem:
            continue
        S = ss._round_up(-(-n_max // cl), 4)
        slab = ss._round_up(S * (12 + 4 * Rk + 4 * W), 16)
        forced = ss.ScanLayout(cl=cl, slice=S, nodes_smem=True,
                               cat_smem=lay.cat_smem,
                               smem_bytes=lay.smem_bytes - lay.slab_bytes + slab,
                               slab_bytes=slab, rec_words=lay.rec_words)
        if forced.smem_bytes > ss.SMEM_LIMIT - ss.STATIC_SMEM:
            continue
        o = ss.solve_scan_cuda(*sargs, **skw, layout=forced)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(o, out_k)),
              f"kernel B at cl={cl} differs from the chosen layout's output")
        evc = device_kernel_us(lambda: [ss.solve_scan_cuda(
            *sargs, **skw, layout=forced) for _ in range(5)])
        per_cl[cl] = kernel_ms(evc, "solve_scan_kernel")
    log("[time] kernel B alone (profiler ms) by cluster size at the main "
        "path, outputs equal: " + ", ".join(
            f"cl={k} {v}" for k, v in per_cl.items()))

    def bound_by(nbytes, ops):
        return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
                else "operations")
    kernels = [
        {"name": "screen_k", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/screen_k.cu",
         "replaces": "karpenter_tpu/ops/pallas_screen.py:69",
         "launches": launches["screen_k"], "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": bound_by(a_bytes, a_ops),
         "library_ms": a_lib, "kernel_ms": a_kernel},
        {"name": "offer_argmin", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/solve_scan.cu",
         "replaces": "karpenter_tpu/ops/solver.py:425",
         "launches": launches["offer_argmin"], "max_abs_err": 0.0,
         "ms": b0_ms, "plain_ms": b0_plain, "bound_ms": b0_bound,
         "bound_by": bound_by(b0_bytes, b0_ops),
         "library_ms": b0_lib, "kernel_ms": b0_kernel},
        {"name": "solve_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/solve_scan.cu",
         "replaces": "karpenter_tpu/ops/solver.py:348",
         "launches": launches["solve_scan"], "max_abs_err": 0.0,
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
         "bound_by": bound_by(b_bytes, b_ops),
         "library_ms": None, "kernel_ms": b_kernel},
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
