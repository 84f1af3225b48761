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
  4b. facade the port's main path as users enter it: Solver(provider,
             backend="device").solve over the provider's catalog, one tainted
             NodePool, two daemonsets and 100,000 pods whose shares drive
             the zone-spread, zone-affinity, colocation and taint passes
             (facade_cluster). Its SolveOutput must equal the native rung's
             (and the host rung's on a 10k subset), and a resumed solve onto
             the first solve's launches too; B0 and B must launch inside it
             and equal their plain versions at its inputs; any fallback,
             integrity violation or logged degradation fails the phase.
             Then its median wall, one run split by stage (the facade's
             tracer spans), and the device/native wall from 1k to 100k pods
             on that mix and on the grid pods of phase 3 (the crossover
             that Solver.DEVICE_MIN_PODS is held against).
  4c. operator the control loop as users enter it: the port's
             make_sim(backend="device") on the 810-type catalog with the
             reference's fast cloud (its c8 cell), the global optimizer
             armed (the reference's default): 10,000 grid pods scaled up
             until bound, 60% of them deleted and the engine run until
             disruption is quiet (no pending decision, no new one for 3
             passes), then 5 bursts of 32 pods, each through one
             provisioner reconcile. The same run on the native rung (whose
             subset search scores in NumPy) must end in the same
             state_hash, disruption decisions and controller stats, with
             no device fallback, oracle flag or optimizer error; A, B0, B
             and C must launch inside the device run and equal their plain
             versions at inputs recorded there. Times: each stage's wall,
             the reconcile walls by controller, the tracer's spans, the
             card's idle share over one disruption reconcile.
  4d. optimizer bench c14's procedure (`optimizer.fixtures.
             measure_consolidation`, the squeeze fleet) on the device rung,
             armed and disarmed, and armed on the native rung, at 2 tiles
             and at OPT_TILES: joint consolidations >= tiles, the armed
             savings above the disarmed ones, device == native.
  5. time    median wall times of the solve and the screen, stage by stage;
             per-kernel device time from torch.profiler and CUDA events
             beside its bound, its plain version's time and one torch
             expression's time where one computes the same function;
             kernels B0 and B at the facade solve's scan inputs and at the
             solve_device cell's, kernel B at every cluster size at both;
             kernel C at the operator loop's first subset search and at a
             search over phase 3's 4,250-node cluster.

The kernels line reports each kernel's launches in the operator phase
and its times at a full-size input (A: the main path's screen; B0, B: the
facade's solve; C: the operator loop's first subset search); `by_phase`
holds each phase's launches (the main path, the facade, the operator and
the optimizer phases) and times. The last two lines of
output are that line and {"ok": true, "device": {...}}. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import copy
import inspect
import itertools
import json
import os
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


def profiled_ms(fn, *needles, tries: int = 3) -> list:
    """kernel_ms of each needle in fn()'s profile. A profile that misses
    one of them (the trace drops a kernel's events now and then) is taken
    again, up to `tries` times; a kernel never seen stays None."""
    for _ in range(tries):
        ev = device_kernel_us(fn)
        got = [kernel_ms(ev, n) for n in needles]
        if None not in got:
            break
    return got


class Recorder:
    """Wraps a module attribute to keep the arguments of its calls (the
    main path's kernel inputs), calling through unchanged. keep=2 keeps
    only the first call and the latest one; `n` counts every call."""

    def __init__(self, module, name: str, keep=None):
        self.module, self.name, self.keep = module, name, keep
        self.real = getattr(module, name)
        self.calls = []
        self.n = 0

    def __enter__(self):
        def shim(*args, **kwargs):
            self.n += 1
            if self.keep is None or len(self.calls) < self.keep:
                self.calls.append((args, kwargs))
            else:
                self.calls[-1] = (args, kwargs)
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


def rank(buf) -> list:
    """plan_repack's ranking (`optimizer.rank_subsets`) of one packed
    tournament output: the subset indices in verify order."""
    from karpenter_tpu_torch.optimizer import rank_subsets
    out = buf.reshape(-1, 4).cpu().numpy()
    return rank_subsets(out[:, 0] > 0.5, out[:, 1], out[:, 2], out[:, 3])[0]


def check_tournament(tk, args, what: str) -> float:
    """Kernel C against tournament_plain at one call's arguments: every
    packed output equal (both add in one order) and the ranked plan equal.
    Returns the largest absolute difference (0.0)."""
    import torch
    got = tk.tournament_cuda(*args)
    torch.cuda.synchronize()
    want = tk.tournament_plain(*args)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, want), f"tournament != plain ({what}): max abs "
          f"difference {err}")
    check(rank(got) == rank(want), f"tournament plan != plain ({what})")
    return err


def phase_check_small(dev) -> None:
    import dataclasses
    import numpy as np
    import torch
    from karpenter_tpu_torch import catalog, models
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.optimizer import tournament_k as tk
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
    for shape in [(3, 5, 1, 1), (40, 33, 7, 16), (16, 31, 600, 9),
                  (64, 300, 90, 3)]:
        check_tournament(tk, tk.seeded_inputs(5, *shape, dev),
                         f"S,N,G,Rk={shape}")
    args = tk.seeded_inputs(6, 50, 40, 12, 3, dev)
    strided = tk.tournament_cuda(*tk.packed_views(args))
    torch.cuda.synchronize()
    check(torch.equal(strided, tk.tournament_plain(*args)),
          "tournament on row-strided packed views != plain")
    log("[check] tournament == plain (every packed output, atol 0; the "
        "ranked plan equal) at four shapes and on row-strided packed views")

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


# --- the facade phase: Solver.solve, the entry point users call ----------

FACADE_SUBSET = 10_000       # pods checked against the host rung
FACADE_RESUME = 10_000       # new pods of the resumed solve
FACADE_REPS = 3             # runs of the median facade wall
CROSSOVER_SIZES = (1_000, 2_000, 4_000, 6_000, 8_000, 16_000, 32_000,
                   100_000)
CROSSOVER_REPS = 2  # keeps the whole script near half its time limit
TOLERATE = ("dedicated", "batch")    # the pool's taint (key, value)


def facade_cluster(models, n: int, seed: int):
    """(pool, daemonsets, pods): n pods, mostly (cpu, memory) grid pods,
    plus the shares that drive the facade's pre-passes (counts scale with
    n; at 100,000 pods): 3 zone-spread deployments of 1,000 pods, 2,000
    pods with required zone node-affinity, 200 with hostname
    anti-affinity, 99 with zone anti-affinity, 300 in 100 bundles of 3
    joined by required positive hostname affinity, and 1,000 that do not
    tolerate the pool's taint. The list is shuffled, so its prefixes keep
    the mix."""
    import numpy as np
    from karpenter_tpu_torch.models import labels as L
    rng = np.random.default_rng(seed)
    tol = [models.Toleration(key=TOLERATE[0], value=TOLERATE[1],
                             effect="NoSchedule")]
    pool = models.NodePool(
        name="default", labels={"team": "batch"},
        taints=[models.Taint(key=TOLERATE[0], value=TOLERATE[1],
                             effect="NoSchedule")])
    daemonsets = [
        models.DaemonSet(name="logging", tolerations=tol,
                         requests=models.Resources.parse(
                             {"cpu": "100m", "memory": "128Mi"})),
        models.DaemonSet(name="gpu-agent", tolerations=tol,
                         requests=models.Resources.parse({"cpu": "250m"}),
                         node_selector={L.INSTANCE_GPU_MANUFACTURER: "nvidia"})]
    scale = n / 100_000

    def cnt(c):
        return max(1, int(round(c * scale)))

    def grid(m, prefix, **kw):
        ci = rng.integers(0, len(CPU_GRID), m)
        mi = rng.integers(0, len(MEM_GRID), m)
        kw.setdefault("tolerations", tol)
        return [models.Pod(name=f"{prefix}{i}", requests=models.Resources.parse(
            {"cpu": CPU_GRID[c], "memory": MEM_GRID[mm]}), **kw)
            for i, (c, mm) in enumerate(zip(ci.tolist(), mi.tolist()))]
    pods = []
    for d in range(3):
        app = f"spread-{d}"
        pods += grid(cnt(1_000), f"{app}-", labels={"app": app}, owner=app,
                     topology_spread=[models.TopologySpreadConstraint(
                         topology_key=L.ZONE, max_skew=1,
                         label_selector={"app": app})])
    pods += grid(cnt(2_000), "zone-", node_affinity=[{
        "key": L.ZONE, "operator": "In", "values": ("zone-a", "zone-b")}])
    pods += grid(cnt(200), "solo-", labels={"app": "solo"},
                 affinity_terms=[models.PodAffinityTerm(
                     topology_key=L.HOSTNAME, label_selector={"app": "solo"},
                     anti=True)])
    for z in range(3):
        pods += grid(cnt(33), f"zanti{z}-", labels={"app": f"zanti{z}"},
                     affinity_terms=[models.PodAffinityTerm(
                         topology_key=L.ZONE, anti=True,
                         label_selector={"app": f"zanti{(z + 1) % 3}"})])
    for b in range(cnt(100)):
        pods += grid(3, f"bundle{b}-", labels={"bundle": f"b{b}"},
                     affinity_terms=[models.PodAffinityTerm(
                         topology_key=L.HOSTNAME,
                         label_selector={"bundle": f"b{b}"})])
    pods += grid(cnt(1_000), "untolerated-", tolerations=[])
    pods += grid(n - len(pods), "p")
    order = rng.permutation(len(pods))
    return pool, daemonsets, [pods[i] for i in order.tolist()]


def out_tuple(out):
    """Everything a SolveOutput decides, stats excluded."""
    return ([(l.instance_type, l.zone, l.capacity_type, l.price,
              list(l.overrides), list(l.pod_keys), dict(l.requests),
              dict(l.labels)) for l in out.launches],
            {k: list(v) for k, v in out.existing_placements.items()},
            list(out.unschedulable))


class FacadeWatch:
    """The facade phase's failure conditions, kept while it runs: the
    backend each run_prepared returned, the exceptions _degrade caught,
    and every warning the port logged."""

    def __init__(self, facade):
        import logging
        self.facade, self.backends, self.faults, self.records = facade, [], [], []
        real_run, real_degrade = facade.run_prepared, facade._degrade

        def run_prepared(prep):
            result, backend = real_run(prep)
            self.backends.append(backend)
            return result, backend

        def degrade(from_backend, cat, err, run_sp):
            self.faults.append(f"{type(err).__name__}: {err}")
            return real_degrade(from_backend, cat, err, run_sp)
        facade.run_prepared, facade._degrade = run_prepared, degrade
        watch = self

        class Keep(logging.Handler):
            def emit(self, record):
                watch.records.append(record.getMessage())
        self.handler = Keep(level=logging.WARNING)
        logging.getLogger("karpenter_tpu_torch").addHandler(self.handler)

    def check(self, what: str) -> None:
        for f in self.faults:
            log(f"[facade] _degrade caught {f}")
        for r in self.records:
            log(f"[facade] logged: {r}")
        st = self.facade.stats
        check(not self.faults and not self.records
              and set(self.backends) == {"device"}
              and st["device_fallbacks"] == 0
              and st["integrity_violations"] == 0,
              f"{what}: the facade left the device rung (backends "
              f"{sorted(set(self.backends))}, stats {st})")


def span_ms(spans) -> dict:
    """{span name: total ms} over the given spans."""
    out: dict = {}
    for sp in spans:
        out[sp.name] = out.get(sp.name, 0.0) + sp.duration * 1e3
    return out


def phase_facade():
    """Solver.solve at full width on the card against the native rung (and
    the host rung on a subset), a resumed solve, the launch counts, the
    wall and its stages, and the device/native crossover on two pod mixes.
    Returns B0's and B's launch counts in the first solve and the
    solve_scan arguments that solve gave them."""
    import torch
    from karpenter_tpu_torch import catalog, models
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.ops import facade as F
    from karpenter_tpu_torch.ops import solve_scan as ss, solver

    types = catalog.generate_catalog()
    pool, daemonsets, pods = facade_cluster(models, N_PODS, SEED)
    kw = dict(daemonsets=daemonsets)
    sync = torch.cuda.synchronize

    def facade(backend):
        return F.Solver(catalog.CatalogProvider(lambda: types),
                        backend=backend)
    dev_f, nat_f = facade("device"), facade("native")
    watch = FacadeWatch(dev_f)

    t0 = time.perf_counter()
    ss.launches = 0
    ss.offer_launches = 0
    with Recorder(solver, "solve_scan") as rec:
        got = dev_f.solve(pods, pool, **kw)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"offer_argmin": ss.offer_launches, "solve_scan": ss.launches}
    want = nat_f.solve(pods, pool, **kw)
    watch.check("100k solve")
    log(f"[facade] Solver.solve({N_PODS} pods, backend='device'): "
        f"{len(got.launches)} launches, "
        f"{sum(map(len, got.existing_placements.values()))} existing "
        f"placements, {len(got.unschedulable)} unschedulable; first call "
        f"{first_ms:.1f} ms (catalog view cold); kernel launches {launches}")
    check(out_tuple(got) == out_tuple(want),
          "facade device output != native rung output")
    check(all(n > 0 for n in launches.values()),
          f"B0/B did not launch inside the facade solve: {launches}")
    (sargs, skw), = rec.calls[-1:]
    check_offer(ss, sargs, skw, "facade path")
    out_k = ss.solve_scan_cuda(*sargs, **skw)
    out_p = ss.solve_scan_plain(*sargs, **skw)
    sync()
    for a, b, what in zip(out_k, out_p, ("ntype", "takes", "unsched",
                                         "nused", "overflow")):
        check(torch.equal(a.to(b.dtype).reshape(b.shape), b),
              f"solve_scan != plain at the facade path ({what})")
    b = inspect.signature(ss.solve_scan_plain).bind(*sargs, **skw)
    Gp, Rk = b.arguments["requests"].shape
    log(f"[check] facade device == native: every launch's type, zone, "
        f"captype, price, overrides, pod keys, requests, labels, and the "
        f"existing placements and unschedulable keys; B0 and B == plain at "
        f"the facade's scan inputs (Gp={Gp}, Rk={Rk}, "
        f"n_max={b.arguments['n_max']})")

    sub = pods[:FACADE_SUBSET]
    host = facade("host").solve(sub, pool, **kw)
    check(out_tuple(dev_f.solve(sub, pool, **kw)) == out_tuple(host),
          "facade device output != host rung output on the subset")
    log(f"[check] {FACADE_SUBSET}-pod subset: facade device == host rung "
        f"({len(host.launches)} launches)")

    # the next reconcile: the first solve's launches are in-flight claims
    vcat, by_key = dev_f.tensors(), {f"{p.namespace}/{p.name}": p for p in pods}
    existing, on_node = [], {}
    for i, l in enumerate(got.launches):
        claim = models.NodeClaim(name=f"claim-{i}", nodepool=pool.name,
                                 instance_type=l.instance_type, zone=l.zone,
                                 capacity_type=l.capacity_type)
        existing.append(F.virtual_node_from_claim(claim, vcat, l.requests))
        on_node[claim.name] = [by_key[k] for k in l.pod_keys]
    _, _, more = facade_cluster(models, FACADE_RESUME, SEED + 1)
    for p in more:
        p.name = "next-" + p.name
    rkw = dict(kw, existing_pods=on_node)
    r_dev = dev_f.solve(more, pool, existing=copy.deepcopy(existing), **rkw)
    r_nat = nat_f.solve(more, pool, existing=copy.deepcopy(existing), **rkw)
    watch.check("resumed solve")
    check(out_tuple(r_dev) == out_tuple(r_nat),
          "resumed facade device output != native rung output")
    log(f"[check] resumed solve ({FACADE_RESUME} new pods onto "
        f"{len(existing)} in-flight nodes): device == native; "
        f"{sum(map(len, r_dev.existing_placements.values()))} pods onto "
        f"existing nodes, {len(r_dev.launches)} new launches")

    # --- times ---
    walls = []
    for _ in range(FACADE_REPS):
        t0 = time.perf_counter()
        dev_f.solve(pods, pool, **kw)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    log(f"[time] Solver.solve {N_PODS} pods, backend='device', catalog view "
        f"and encode cache warm: median wall {wall:.3f} ms over {FACADE_REPS} "
        f"runs ({', '.join(f'{w:.1f}' for w in walls)})")

    # one solve split by stage: the facade's own tracer spans (host clock;
    # the card is synced at the trace's edges, and the scan's device time
    # lands in solve.readback, whose host read waits for it)
    TRACER.configure(enabled=True)
    TRACER.recorder.clear()
    sync()
    try:
        with TRACER.trace("facade.solve"):
            dev_f.solve(pods, pool, **kw)
            sync()
    finally:
        TRACER.configure(enabled=False)
    tr, = TRACER.recorder.slowest(1)
    top = tr.children(tr.root)
    top_ms = span_ms(top)
    inner_ms = span_ms([c for sp in top if sp.name == "solve.run"
                            for c in tr.children(sp)])
    split_wall = tr.root.duration * 1e3
    log(f"[time] facade stages of one solve (ms, spans; wall "
        f"{split_wall:.3f}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in top_ms.items())
        + f", unattributed {split_wall - sum(top_ms.values()):.3f}")
    log("[time] inside solve.run (solve_device): " + ", ".join(
        f"{k} {v:.3f}" for k, v in inner_ms.items())
        + f", the rest {top_ms.get('solve.run', 0.0) - sum(inner_ms.values()):.3f}")
    ev = device_kernel_us(lambda: dev_f.solve(pods, pool, **kw))
    busy = sum(us for us, _ in ev.values()) / 1e3
    log(f"[time] one Solver.solve: device busy {busy:.3f} ms of "
        f"{wall:.3f} ms median wall (idle share {1 - busy / wall:.5f})"
        if ev else "[time] torch.profiler recorded no device events")

    # the device/native crossover on two mixes: the facade mix above and
    # the solve_device cell's grid pods under an untainted pool; warm
    # facades, prefixes of one pod list, the rungs in turns (device,
    # native, native, device)
    mixes = {"facade mix": (pods, pool, kw),
             "grid mix": (grid_pods(models, N_PODS, SEED),
                          models.NodePool(name="default"), {})}
    for mix, (mpods, mpool, mkw) in mixes.items():
        cross = []
        for n in CROSSOVER_SIZES:
            part = mpods[:n]
            runs = {"device": [], "native": []}
            for r in range(CROSSOVER_REPS):
                for f in (dev_f, nat_f) if r % 2 == 0 else (nat_f, dev_f):
                    t0 = time.perf_counter()
                    f.solve(part, mpool, **mkw)
                    sync()
                    runs[f.backend].append((time.perf_counter() - t0) * 1e3)
            cross.append((n, statistics.median(runs["device"]),
                          statistics.median(runs["native"])))
        first = next((n for n, d, nt in cross
                      if all(d2 < nt2 for n2, d2, nt2 in cross if n2 >= n)),
                     None)
        log(f"[time] {mix}: facade wall by pods, median of {CROSSOVER_REPS} "
            f"in turns (ms): " + ", ".join(
                f"{n}: device {d:.2f} / native {nt:.2f}" for n, d, nt in cross)
            + f"; device faster from {first} pods on "
            f"(Solver.DEVICE_MIN_PODS = {F.Solver.DEVICE_MIN_PODS})")
    watch.check("crossover")
    return launches, (sargs, skw)


# --- the operator phase: make_sim, the control loop on the card -----------

# scale-up: grid pods (seed 0). Cut from 20,000 (804 nodes), where each
# rung of the phase took over 4 minutes of host-bound wall beside one
# NVIDIA H100 80GB HBM3 (PERF.md)
OP_PODS = 10_000
OP_DELETE = 0.6             # scale-down: share of the pods deleted (seed 1)
OP_QUIET = 3                # disruption passes without a new decision
OP_SCALE_UP_CAP = 900.0     # sim seconds
OP_SCALE_DOWN_CAP = 3600.0  # sim seconds
OP_BURSTS = 5               # steady state: bursts of OP_BURST pods
OP_BURST = 32
# the fast cloud of the reference's c8 cell (bench.py)
OP_CLOUD = dict(node_ready_delay=1.0, register_delay=0.5,
                create_fleet_rate=1e6, create_fleet_burst=10**6)
DECISION_STATS = ("empty", "drift", "expired", "consolidated",
                  "multi_consolidated", "optimizer_consolidated")


class OperatorRun:
    """One run of the operator phase on one rung of the port's make_sim:
    scale-up, scale-down until disruption is quiet, steady-state bursts.
    Times every controller reconcile (host wall; each one ends in host
    reads) and counts the solves and screens of each stage."""

    def __init__(self, backend: str, profile_pass: bool):
        from karpenter_tpu_torch import catalog, sim as S
        from karpenter_tpu_torch.cloud import fake
        from karpenter_tpu_torch.cloud.fake import FakeCloudConfig
        from karpenter_tpu_torch.models import nodeclaim, pod
        from karpenter_tpu_torch.optimizer import OPTIMIZER
        # the reference's default: the global optimizer armed
        os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)
        self.optimizer0 = OPTIMIZER.totals()
        # both rungs mint claim names, pod uids and instance ids from the
        # same start: names break ties in the loop's orderings
        nodeclaim._seq = itertools.count()
        pod._uid = itertools.count()
        fake._ids = itertools.count(1)
        self.backend, self.profile_pass = backend, profile_pass
        self.sim = S.make_sim(types=catalog.generate_catalog(),
                              backend=backend,
                              cloud_config=FakeCloudConfig(**OP_CLOUD))
        self.stage = "setup"
        self.walls: dict = {}     # (stage, controller) -> [ms]
        self.solves: dict = {}    # stage -> Solver.solve calls
        self.quiet = 0
        self.burst_ms = []        # the provisioner reconcile of each burst
        self.profiled = None      # (busy ms, wall ms) of one disruption pass
        for c in self.sim.engine.controllers:
            c.reconcile = self._timed(c, c.reconcile)
        real_solve = self.sim.solver.solve

        def solve(*a, **kw):
            self.solves[self.stage] = self.solves.get(self.stage, 0) + 1
            return real_solve(*a, **kw)
        self.sim.solver.solve = solve

    def _timed(self, c, reconcile):
        def run(now):
            profile = (self.profile_pass and c.name == "disruption"
                       and self.stage == "scale_down"
                       and self.profiled is None)
            box = []
            t0 = time.perf_counter()
            if profile:
                ev = device_kernel_us(lambda: box.append(reconcile(now)))
            else:
                box.append(reconcile(now))
            ms = (time.perf_counter() - t0) * 1e3
            self.walls.setdefault((self.stage, c.name), []).append(ms)
            if c.name == "disruption":
                self._after_pass()
            if profile:
                self.profiled = (sum(us for us, _ in ev.values()) / 1e3, ms)
            return box[0]
        return run

    def _after_pass(self) -> None:
        d = self.sim.disruption
        sig = (tuple(d.stats.get(k, 0) for k in DECISION_STATS),
               len(self.decisions()))
        quiet = (not d._pending and sig == getattr(self, "_sig", None)
                 and not any(c.is_deleting()
                             for c in self.sim.store.nodeclaims.values())
                 and self.bound_all())
        self.quiet = self.quiet + 1 if quiet else 0
        self._sig = sig

    def decisions(self):
        return [e for e in self.sim.store.events if e[0] == "disruption"]

    def bound_all(self) -> bool:
        return all(p.node_name is not None
                   for p in self.sim.store.pods.values())

    def drive(self) -> dict:
        import numpy as np
        from karpenter_tpu_torch import models
        s = self.sim
        t_phase = time.perf_counter()
        times = {}
        self.stage = "scale_up"
        pods = grid_pods(models, OP_PODS, SEED)
        for p in pods:
            s.store.add_pod(p)
        t0 = time.perf_counter()
        ok = s.engine.run_until(self.bound_all, timeout=OP_SCALE_UP_CAP,
                                step=1.0)
        check(ok, f"{self.backend}: {OP_PODS} pods not all bound within "
              f"{OP_SCALE_UP_CAP} sim seconds")
        times["scale_up_ms"] = (time.perf_counter() - t0) * 1e3
        times["nodes_after_scale_up"] = len(s.store.nodeclaims)

        self.stage = "scale_down"
        rng = np.random.default_rng(1)
        for i in rng.permutation(len(pods))[: int(len(pods) * OP_DELETE)]:
            s.store.delete_pod(pods[i].namespace, pods[i].name)
        self.quiet, self._sig = 0, None
        t0, sim0 = time.perf_counter(), s.clock.now()
        ok = s.engine.run_until(lambda: self.quiet >= OP_QUIET,
                                timeout=OP_SCALE_DOWN_CAP, step=5.0)
        check(ok, f"{self.backend}: disruption not quiet within "
              f"{OP_SCALE_DOWN_CAP} sim seconds")
        check(self.bound_all(), f"{self.backend}: pods unbound after the "
              f"scale-down")
        times["scale_down_ms"] = (time.perf_counter() - t0) * 1e3
        times["scale_down_sim_s"] = s.clock.now() - sim0
        times["nodes_after_scale_down"] = len(s.store.nodeclaims)

        self.stage = "burst"
        for b in range(OP_BURSTS):
            for i in range(OP_BURST):
                s.store.add_pod(models.Pod(
                    name=f"burst-{b}-{i}", requests=models.Resources.parse(
                        {"cpu": "100m", "memory": "128Mi"})))
            # one provisioner reconcile serves the burst, then the loop
            # binds it
            t0 = time.perf_counter()
            s.provisioner.reconcile(s.clock.now())
            self.burst_ms.append((time.perf_counter() - t0) * 1e3)
            check(s.engine.run_until(self.bound_all, timeout=120.0,
                                     step=1.0),
                  f"{self.backend}: burst {b} not bound")
        times["phase_ms"] = (time.perf_counter() - t_phase) * 1e3
        return times

    def stats(self) -> dict:
        return {c.name: dict(c.stats) for c in self.sim.engine.controllers
                if hasattr(c, "stats")}

    def optimizer(self) -> dict:
        """The optimizer meter's counts (subsets scored, exact verifies,
        accepts) since this run started; read it before another run."""
        from karpenter_tpu_torch.optimizer import OPTIMIZER
        now = OPTIMIZER.totals()
        return {k: now[k] - self.optimizer0[k]
                for k in ("scored", "verified", "accepted", "fallbacks")}


def phase_operator(dev):
    """The port's control loop as users enter it: make_sim(backend="device")
    on the full catalog, OP_PODS grid pods scaled up, 60% of them deleted
    and disruption run to quiet, then 5 bursts of 32 pods; the same run on
    the native rung must end in the same state, decisions and stats.
    Returns the kernels' launches in the device run and one recorded input
    of each (the scale-up solve's and the last re-solve's scan, the last
    screen's k, the first subset search's tournament)."""
    import numpy as np
    import torch
    from karpenter_tpu_torch import sim as S
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import consolidate, screen_k as sk
    from karpenter_tpu_torch.ops import solve_scan as ss, solver

    spans: dict = {}
    span_n: dict = {}

    def sink(trace):
        for sp in trace.spans:
            if sp.name.startswith(("reconcile:", "solve.", "disruption.",
                                   "provision.", "integrity.",
                                   "optimizer.")):
                spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration * 1e3
                span_n[sp.name] = span_n.get(sp.name, 0) + 1

    t0 = time.perf_counter()
    run_d = OperatorRun("device", profile_pass=True)
    TRACER.add_sink(sink)
    TRACER.configure(enabled=True)
    ss.launches = 0
    ss.offer_launches = 0
    sk.launches = 0
    tk.launches = 0
    try:
        with Recorder(solver, "solve_scan", keep=2) as rec_b, \
                Recorder(consolidate, "screen_k", keep=2) as rec_a, \
                Recorder(tk, "tournament", keep=2) as rec_c:
            times_d = run_d.drive()
            torch.cuda.synchronize()
    finally:
        TRACER.configure(enabled=False)
        TRACER._sinks.remove(sink)
    launches = {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches, "tournament": tk.launches}
    opt_d = run_d.optimizer()
    wall_d = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    run_n = OperatorRun("native", profile_pass=False)
    times_n = run_n.drive()
    wall_n = (time.perf_counter() - t0) * 1e3

    hd, hn = S.state_hash(run_d.sim), S.state_hash(run_n.sim)
    log(f"[operator] make_sim(backend='device') on {len(run_d.sim.cloud.types)} "
        f"types: {OP_PODS} pods -> {times_d['nodes_after_scale_up']} nodes; "
        f"{int(OP_DELETE * 100)}% deleted -> "
        f"{times_d['nodes_after_scale_down']} nodes after "
        f"{times_d['scale_down_sim_s']:.0f} sim s; {OP_BURSTS} bursts of "
        f"{OP_BURST}; disruption stats {run_d.sim.disruption.stats}; "
        f"decisions {len(run_d.decisions())}; kernel launches {launches}")
    check(hd == hn, f"operator state_hash device {hd} != native {hn}")
    check(run_d.decisions() == run_n.decisions(),
          "operator disruption decision log differs from the native rung")
    check(run_d.stats() == run_n.stats(),
          f"operator controller stats differ: {run_d.stats()} vs "
          f"{run_n.stats()}")
    # an uninjected device fault or wrong device answer raises out of the
    # loop; nothing may have moved a device solve to another rung or
    # degraded the screen, and the oracle must have flagged no solve (an
    # input over capacity would be flagged on both rungs:
    # tests/test_torch_sim_overcap.py)
    log(f"[operator] solver stats: device run {run_d.sim.solver.stats}; "
        f"native run {run_n.sim.solver.stats}")
    check("screen_errors" not in run_d.sim.disruption.stats,
          "the screen degraded in the device run")
    check(run_d.sim.solver.stats == run_n.sim.solver.stats,
          "operator solver stats differ between the device and native runs")
    check(run_d.sim.solver.stats["device_fallbacks"] == 0,
          "the device run served solves from another rung")
    check(run_d.sim.solver.stats["integrity_violations"] == 0,
          "the integrity oracle flagged solves of the operator phase")
    for run in (run_d, run_n):
        check("optimizer_errors" not in run.sim.disruption.stats,
              f"the subset search degraded in the {run.backend} run")
    opt_n = run_n.optimizer()
    log(f"[operator] optimizer meter: device run {opt_d}; native run {opt_n}")
    check(opt_d == opt_n, "the optimizer's counts differ between the device "
          "and native runs")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched inside the loop")
    log(f"[check] operator device == native: state_hash {hd[:16]}, "
        f"{len(run_d.decisions())} disruption decisions "
        f"({sum('optimizer' in str(e) for e in run_d.decisions())} naming "
        f"the optimizer) and every controller's stats equal")

    # each kernel against its plain version at inputs recorded in the loop
    where = ("scale-up solve", "last re-solve")
    for (sargs, skw), what in zip(rec_b.calls, where):
        check_offer(ss, sargs, skw, f"operator {what}")
        out_k = ss.solve_scan_cuda(*sargs, **skw)
        out_p = ss.solve_scan_plain(*sargs, **skw)
        torch.cuda.synchronize()
        for a, b, field in zip(out_k, out_p, ("ntype", "takes", "unsched",
                                              "nused", "overflow")):
            check(torch.equal(a.to(b.dtype).reshape(b.shape), b),
                  f"solve_scan != plain at the operator {what} ({field})")
        b = inspect.signature(ss.solve_scan_plain).bind(*sargs, **skw)
        log(f"[check] operator {what}: offer_argmin == plain and solve_scan "
            f"== plain (Gp={b.arguments['requests'].shape[0]}, "
            f"n_max={b.arguments['n_max']})")
    (aargs, akw) = rec_a.calls[-1]
    k_got = sk.screen_k_cuda(*aargs, **akw)
    torch.cuda.synchronize()
    k_want = sk.screen_k_plain(*aargs, **akw)
    err_a = float((k_got - k_want).abs().max()) if k_got.numel() else 0.0
    check(err_a == 0.0, f"screen_k != plain at the operator's screen: {err_a}")
    log(f"[check] operator screen: screen_k == plain (atol 0) at N="
        f"{aargs[0].shape[0]} G={aargs[1].shape[0]}; {rec_a.n} screens, "
        f"{run_d.solves} Solver.solve calls by stage")
    err_c = 0.0
    for (cargs, _), what in zip(rec_c.calls, ("first", "last")):
        err_c = max(err_c, check_tournament(tk, cargs, f"operator {what} "
                                            f"subset search"))
        S_, N_ = cargs[4].shape
        log(f"[check] operator {what} subset search: tournament == plain "
            f"(atol 0, plan equal) at S={S_} N={N_} G={cargs[2].shape[1]} "
            f"Rk={cargs[0].shape[1]}; {rec_c.n} searches on the card")

    # --- times ---
    dis = [ms for (st, c), v in run_d.walls.items() if c == "disruption"
           and st == "scale_down" for ms in v]
    prov_up = run_d.walls.get(("scale_up", "provisioner"), [])
    bursts = run_d.burst_ms
    log(f"[time] operator phase: device run {wall_d:.1f} ms, native run "
        f"{wall_n:.1f} ms; device run stages: scale-up "
        f"{times_d['scale_up_ms']:.1f} ms (provisioner reconciles "
        f"{len(prov_up)}, max {max(prov_up):.1f} ms, sum "
        f"{sum(prov_up):.1f} ms), scale-down {times_d['scale_down_ms']:.1f} "
        f"ms, bursts and the rest {times_d['phase_ms'] - times_d['scale_up_ms'] - times_d['scale_down_ms']:.1f} ms")
    log(f"[time] operator disruption reconciles in the scale-down: "
        f"{len(dis)} passes, median {statistics.median(dis):.1f} ms, max "
        f"{max(dis):.1f} ms, sum {sum(dis):.1f} ms; exact re-solves "
        f"{run_d.solves.get('scale_down', 0)} (the optimizer's verifies "
        f"over the whole run {opt_d['verified']}, in "
        f"{span_n.get('optimizer.verify', 0)} verify stages), subset "
        f"searches {span_n.get('optimizer.search', 0)}, screens (cache "
        f"misses) {rec_a.n}; burst provisioner reconcile median "
        f"{statistics.median(bursts):.2f} ms ({', '.join(f'{b:.1f}' for b in bursts)})")
    per_ctrl = {}
    for (st, c), v in run_d.walls.items():
        per_ctrl[c] = per_ctrl.get(c, 0.0) + sum(v)
    log("[time] operator device run, reconcile wall by controller (ms): "
        + ", ".join(f"{c} {v:.1f}" for c, v in
                    sorted(per_ctrl.items(), key=lambda kv: -kv[1])))
    log("[time] operator device run, tracer spans (ms, totals; nested spans "
        "are inside their parents): " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(spans.items(),
                                              key=lambda kv: -kv[1])))
    if run_d.profiled is not None and run_d.profiled[0] > 0:
        busy, wall = run_d.profiled
        log(f"[time] one disruption reconcile (the first of the scale-down, "
            f"under torch.profiler): device busy {busy:.3f} ms of {wall:.1f} "
            f"ms wall (idle share {1 - busy / wall:.5f})")
    else:
        log("[time] torch.profiler recorded no device events in the profiled "
            "disruption reconcile: idle share not measured")
    return (launches, rec_b.calls[-1], (aargs, akw), err_a,
            rec_c.calls[0][0], err_c)


# --- the optimizer phase: bench c14's procedure on the card ---------------

# the larger squeeze fleet: 96 nodes (24 tiles, 192 nodes, took 253 s of
# the script's wall on one H100; PERF.md)
OPT_TILES = 12
OPT_RUN_S = 900.0       # sim seconds a measurement runs (bench c14's)


def phase_optimizer() -> dict:
    """measure_consolidation("squeeze", tiles) on make_sim(backend=
    "device"), armed and disarmed, and armed on the native rung, at 2 tiles
    and at OPT_TILES. Returns kernel C's launches in the phase."""
    from karpenter_tpu_torch.cloud import fake
    from karpenter_tpu_torch.models import nodeclaim, pod
    from karpenter_tpu_torch.optimizer import fixtures, tournament_k as tk
    tk.launches = 0
    for tiles in (2, OPT_TILES):
        runs = {}
        for backend, armed in (("device", True), ("device", False),
                               ("native", True)):
            nodeclaim._seq = itertools.count()
            pod._uid = itertools.count()
            fake._ids = itertools.count(1)
            t0 = time.perf_counter()
            r = fixtures.measure_consolidation("squeeze", tiles, armed=armed,
                                               run_for=OPT_RUN_S,
                                               backend=backend)
            r["wall_ms"] = (time.perf_counter() - t0) * 1e3
            runs[(backend, armed)] = r
            log(f"[optimizer] squeeze x{tiles} on the {backend} rung, "
                f"{'armed' if armed else 'disarmed'}: {r}")
        on, off, nat = (runs[("device", True)], runs[("device", False)],
                        runs[("native", True)])
        check(on["joint_consolidations"] >= tiles,
              f"squeeze x{tiles}: {on['joint_consolidations']} joint "
              f"consolidations, fewer than the tiles")
        check(on["savings"] > off["savings"], f"squeeze x{tiles}: optimizer "
              f"savings {on['savings']} not above greedy {off['savings']}")
        check(on["all_bound"] and off["all_bound"],
              f"squeeze x{tiles}: pods left unbound")
        same = ("state_hash", "savings", "joint_consolidations",
                "nodes_after", "exact_verifies", "subsets_scored")
        check({k: on[k] for k in same} == {k: nat[k] for k in same},
              f"squeeze x{tiles}: device run != native run")
        log(f"[check] squeeze x{tiles} ({on['nodes_before']} nodes): "
            f"{on['joint_consolidations']} joint consolidations, savings "
            f"{on['savings']} $/hr armed vs {off['savings']} disarmed; device "
            f"== native (state hash, savings, decisions, verifies); walls "
            f"(ms) device armed {on['wall_ms']:.1f}, disarmed "
            f"{off['wall_ms']:.1f}, native armed {nat['wall_ms']:.1f}")
    check(tk.launches > 0, "kernel C was not launched in the optimizer phase")
    return {"tournament": tk.launches}


def grid_tournament_args(cat, enc, views, counts, slack):
    """Kernel C's arguments for one subset search over phase 3's cluster
    (every node a candidate, each node priced at its type's cheapest
    available offering), taken as score_subsets_device hands them over."""
    import numpy as np
    from karpenter_tpu_torch import optimizer as O
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.optimizer.tournament import (
        group_slot_prices, score_subsets_device)
    N = len(views)
    cheapest = np.where(cat.available, cat.price, np.inf).reshape(
        cat.T, -1).min(axis=1)
    prices = np.array([cheapest[v.virtual.type_idx] for v in views],
                      np.float32)
    cand = list(range(N))
    guide = O.evictability(slack, counts, prices, cand,
                           group_slot_prices(cat, enc))
    S = min(O.MAX_SUBSETS, max(16, O.RELAX_BUDGET // (N * max(enc.G, 1))))
    subs, _ = O.generate_subsets(N, guide, max_subsets=S)
    masks = np.zeros((len(subs), N), np.float32)
    for i, sub in enumerate(subs):
        masks[i, list(sub)] = 1.0
    with Recorder(tk, "tournament") as rec:
        score_subsets_device(cat, enc, views, counts, prices, masks)
    return rec.calls[0][0]


def tournament_kernel_times(tk, args, where: str) -> dict:
    """Kernel C at one tournament call's arguments: the kernel alone
    (torch.profiler), the wrapper call (CUDA events), the plain version,
    the three torch.matmul calls for need, supply and savings (the part
    of the function one library call computes; the relaxation has none),
    and the bound. Logs them and returns the row of the kernels line."""
    from karpenter_tpu_torch.optimizer import RELAX_ITERS
    head, req, k, counts, masks, prices, pslot = args
    # the kernel alone: the colsum prologue and the tournament, per call
    c_main, c_col = profiled_ms(lambda: [tk.tournament_cuda(*args)
                                         for _ in range(5)],
                                "tournament_kernel", "tournament_colsum")
    c_kernel = (None if None in (c_main, c_col) else c_main + c_col)
    c_ms = cuda_ms(lambda: tk.tournament_cuda(*args), 20)
    c_plain = cuda_ms(lambda: tk.tournament_plain(*args), 1)

    def library():
        return masks @ counts, k.sum(dim=0) - masks @ k, masks @ prices
    c_lib = cuda_ms(library, 50)
    S, N = masks.shape
    G, Rk = req.shape
    # inputs read once, the packed output written once; the operations the
    # function needs at this run's shapes and victims (tk.ops_needed)
    c_bytes = 4 * (N * Rk + G * Rk + 2 * N * G + S * N + N + G) + 16 * S
    c_ops = tk.ops_needed(S, N, G, Rk, int((masks != 0).sum()), RELAX_ITERS)
    c = {"ms": c_ms, "plain_ms": c_plain, **bound(c_bytes, c_ops),
         "library_ms": c_lib, "kernel_ms": c_kernel}
    log(f"[time] {where} (S={S}, N={N}, G={G}, Rk={Rk}): tournament kernel "
        f"{c_kernel} ms (colsum prologue {c_col} ms), wrapper call "
        f"{c_ms:.4f} ms (bound {c['bound_ms']:.5f} ms by {c['bound_by']}, "
        f"{c_bytes} bytes, "
        f"{c_ops} ops); plain {c_plain:.3f} ms; need/supply/savings as three "
        f"torch.matmul {c_lib:.4f} ms")
    return c


def screen_kernel_times(sk, head, req, elig, where: str) -> dict:
    """Kernel A at one screen_k call's arguments: the kernel alone
    (torch.profiler), the wrapper call (CUDA events), the plain version, one
    torch expression for the same function, and the bound. Logs them and
    returns the row of the kernels line."""
    import numpy as np
    import torch
    a_kernel, = profiled_ms(lambda: [sk.screen_k_cuda(head, req, elig)
                                     for _ in range(20)], "screen_k_kernel")
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
    a = {"ms": a_ms, "plain_ms": a_plain, **bound(a_bytes, a_ops),
         "library_ms": a_lib, "kernel_ms": a_kernel}
    log(f"[time] {where} (N={N}, G={G}, R={R}): screen_k {a_ms:.4f} ms, "
        f"kernel alone {a_kernel} ms (bound {a['bound_ms']:.5f} ms, bytes "
        f"{a_bytes}); plain {a_plain:.4f} ms; one torch expression "
        f"{a_lib:.4f} ms")
    return a


def bound(nbytes: int, ops: int) -> dict:
    """The least time for the work: bytes over the memory rate or fp32
    operations over the peak rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
    return {"bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / FP32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations"}


def scan_kernel_times(ss, sargs, skw, where: str):
    """Kernels B0 and B at one solve_scan call's arguments: the kernel
    alone (torch.profiler), the wrapper call (CUDA events), the plain
    version, a torch yardstick for B0, the bound, and kernel B at every
    cluster size its node state fits (outputs checked equal). Logs them
    and returns the two rows of the kernels line."""
    import numpy as np
    import torch
    oa = offer_args(ss, sargs, skw)
    sb = inspect.signature(ss.solve_scan_plain).bind(*sargs, **skw)
    sb.apply_defaults()
    sa = sb.arguments
    lay = scan_layout_of(ss, sargs, skw)
    T, Z, C = sa["price"].shape
    Gp, Rk = sa["requests"].shape
    n_max, ZC = sa["n_max"], Z * C
    eps = float(np.float32(1e-4))

    def offer_table():
        return ss._offer_table(
            sa["alloc"], sa["price"], sa["avail"], sa["requests"],
            sa["counts"], sa["compat"], sa["allow_zone"], sa["allow_cap"],
            sa["max_per_node"], sa["prior"], sa["banned"], sa["conflict"],
            sa["zovh"], sa["zone_ovh"], sa["track_conflicts"])

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
        return torch.argmin(cps.reshape(Gp, -1), 1)

    b0_kernel, b_kernel = profiled_ms(
        lambda: [ss.solve_scan_cuda(*sargs, **skw) for _ in range(5)],
        "offer_argmin_kernel", "solve_scan_kernel")
    b0_bytes = (4 * T * ZC + T * ZC + 4 * T * Rk + Gp * (4 * Rk + T + Z + C
                                                          + 8)
                + 4 * Gp * lay.rec_words + 8 * T)
    b0_ops = Gp * (T * (4 * Rk) + T * ZC * 2)
    b0 = {"ms": cuda_ms(offer_table, 100),
          "plain_ms": cuda_ms(lambda: ss.offer_argmin_plain(**oa), 10),
          **bound(b0_bytes, b0_ops), "library_ms": cuda_ms(library_cps, 10),
          "kernel_ms": b0_kernel}
    b_bytes = (4 * T * Rk + 4 * T * ZC + T * ZC
               + Gp * (4 * Rk + 4 + T + Z + C + 4)
               + n_max * (4 + 4 * Rk + Z + C + 1)
               + 4 * Gp * n_max + 4 * Gp + 8)
    b_ops = Gp * (n_max * (4 * Rk + ZC + 6) + T * (4 * Rk + 2 * ZC))
    bk = {"ms": cuda_ms(lambda: ss.solve_scan_cuda(*sargs, **skw), 20),
          "plain_ms": cuda_ms(lambda: ss.solve_scan_plain(*sargs, **skw), 2),
          **bound(b_bytes, b_ops), "library_ms": None,
          "kernel_ms": b_kernel}
    log(f"[time] {where} (Gp={Gp}, n_max={n_max}, Rk={Rk}, layout "
        f"cl={lay.cl} slice={lay.slice} nodes_in_shared={lay.nodes_smem}): "
        f"offer_argmin kernel {b0_kernel} ms, wrapper call {b0['ms']:.4f} ms "
        f"(bound {b0['bound_ms']:.5f} ms), plain {b0['plain_ms']:.4f} ms, "
        f"cps + torch.argmin {b0['library_ms']:.4f} ms; solve_scan kernel "
        f"{b_kernel} ms, wrapper call (B0 + B + wrapper) {bk['ms']:.4f} ms "
        f"(bound {bk['bound_ms']:.5f} ms), plain {bk['plain_ms']:.3f} ms")

    # kernel B at every cluster size the node state fits, same inputs
    out_k = ss.solve_scan_cuda(*sargs, **skw)
    W = -(-Gp // 32) if sa["track_conflicts"] else 0
    per_cl = {}
    for cl in (1, 2, 4, 8, 16) if lay.nodes_smem else ():
        S = ss._round_up(-(-n_max // cl), 4)
        slab = ss._round_up(S * (12 + 4 * Rk + 4 * W), 16)
        forced = ss.ScanLayout(cl=cl, slice=S, nodes_smem=True,
                               cat_smem=lay.cat_smem,
                               smem_bytes=lay.smem_bytes - lay.slab_bytes + slab,
                               slab_bytes=slab, rec_words=lay.rec_words)
        if (forced.smem_bytes > ss.SMEM_LIMIT - ss.STATIC_SMEM
                or cl > ss.max_cluster(forced.smem_bytes)):
            continue
        o = ss.solve_scan_cuda(*sargs, **skw, layout=forced)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(o, out_k)),
              f"kernel B at cl={cl} differs from the chosen layout's output "
              f"({where})")
        per_cl[cl], = profiled_ms(lambda: [ss.solve_scan_cuda(
            *sargs, **skw, layout=forced) for _ in range(5)],
            "solve_scan_kernel")
    log(f"[time] {where}: kernel B alone (profiler ms) by cluster size, "
        f"outputs equal: " + (", ".join(f"cl={k} {v}" for k, v in
                                        per_cl.items()) or "none fits"))
    return b0, bk


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "port on an NVIDIA GPU")
    try:
        import numpy as np
        from karpenter_tpu_torch import catalog, models
        from karpenter_tpu_torch.optimizer import tournament_k as tk
        from karpenter_tpu_torch.ops import consolidate, screen_k as sk
        from karpenter_tpu_torch.ops import solve_scan as ss, solver
        from karpenter_tpu_torch.ops.binpack import solve_host, validate_solution
        from karpenter_tpu_torch.ops.encode import encode_catalog, encode_pods
        from karpenter_tpu_torch.state.cluster import NodeView
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
    views = [NodeView(claim=models.NodeClaim(name=f"n{i}", nodepool="d"),
                      node=None, pods=[], virtual=n, price=0.0)
             for i, n in enumerate(result.nodes)]
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

    # --- 4b. the facade: Solver.solve, counts zeroed just before it ---
    facade_launches, facade_scan = phase_facade()

    # --- 4c. the operator: make_sim's loop, counts zeroed just before it ---
    (op_launches, op_scan, op_screen, op_err_a, op_tournament,
     op_err_c) = phase_operator(dev)

    # --- 4d. the optimizer: bench c14's procedure, counts zeroed inside ---
    opt_launches = phase_optimizer()

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

    # each kernel timed at the inputs of every phase that launches it: A at
    # the main path's 4,250-node screen and the operator loop's last
    # screen; B0 and B at the solve_device cell's inputs, the facade
    # solve's and the operator loop's last re-solve. The kernels line takes
    # its times at full size (A: the main path; B0, B: the facade, as in
    # earlier PRs), its launches from the operator phase, and carries
    # every phase's launches and times beside them
    a_main = screen_kernel_times(sk, head, req, elig, "main-path screen")
    b_main = scan_kernel_times(ss, sargs, skw, "solve_device cell")
    b_fac = scan_kernel_times(ss, *facade_scan, "facade")
    b_op = scan_kernel_times(ss, *op_scan, "operator loop re-solve")
    (ahead, areq, aelig), _ = op_screen
    a_op = screen_kernel_times(sk, ahead, areq, aelig, "operator loop screen")
    # kernel C at the operator loop's first subset search and at one over
    # phase 3's 4,250-node cluster (checked against its plain version first)
    grid_args = grid_tournament_args(cat, enc, views, counts, slack)
    err_c = max(op_err_c, check_tournament(tk, grid_args,
                                           "grid-mix cluster search"))
    log(f"[check] grid-mix cluster search: tournament == plain (atol 0, plan "
        f"equal) at S={grid_args[4].shape[0]} N={grid_args[4].shape[1]} "
        f"G={grid_args[2].shape[1]}")
    c_op = tournament_kernel_times(tk, op_tournament,
                                   "operator loop first subset search")
    c_grid = tournament_kernel_times(tk, grid_args, "grid-mix cluster search")
    times = {"screen_k": {"main": a_main, "operator": a_op},
             "tournament": {"operator": c_op, "grid": c_grid}}
    for i, k in enumerate(("offer_argmin", "solve_scan")):
        times[k] = {"main": b_main[i], "facade": b_fac[i],
                    "operator": b_op[i]}
    phase_launches = {"main": launches, "facade": facade_launches,
                      "operator": op_launches, "optimizer": opt_launches}
    by_phase = {k: {ph: {"launches": phase_launches[ph].get(k), **row}
                    for ph, row in times[k].items()
                    if ph in phase_launches} for k in times}
    by_phase["tournament"]["grid"] = c_grid
    by_phase["tournament"]["optimizer"] = {
        "launches": opt_launches["tournament"]}
    headline = {"screen_k": a_main, "offer_argmin": b_fac[0],
                "solve_scan": b_fac[1], "tournament": c_op}
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": op_launches[name],
         "max_abs_err": err, **headline[name],
         "by_phase": by_phase[name]}
        for name, source, replaces, err in (
            ("screen_k", "karpenter_tpu_torch/csrc/screen_k.cu",
             "karpenter_tpu/ops/pallas_screen.py:69", max(err_a, op_err_a)),
            ("offer_argmin", "karpenter_tpu_torch/csrc/solve_scan.cu",
             "karpenter_tpu/ops/solver.py:425", 0.0),
            ("solve_scan", "karpenter_tpu_torch/csrc/solve_scan.cu",
             "karpenter_tpu/ops/solver.py:348", 0.0),
            ("tournament", "karpenter_tpu_torch/csrc/tournament.cu",
             "karpenter_tpu/optimizer/tournament.py:140", err_c))]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
