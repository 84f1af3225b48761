"""Drive karpenter_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   the CUDA kernels from karpenter_tpu_torch/csrc/ with nvcc
  2. check   each kernel against its plain PyTorch version at small shapes
             (kernel A: the four reference test shapes, atol 0; kernels B0
             and B: golden-style solves incl. conflicts, resume and zone
             overhead, B0's outputs and the packed vectors equal; kernel B
             also at a node budget that takes the largest cluster and at
             one whose node slices live in global scratch; kernel C at
             seeded inputs, one for each tier of its layout that the
             recorded inputs do not reach: one block with k resident,
             clusters of 2 and of 16 with k streamed, the global tier,
             four subsets a block)
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
             Then its median wall served by the delta plane (the default:
             the repeat is answered from the solve memo, still verified);
             with the plane off (KARPENTER_TPU_DELTA=0, every solve
             dispatches) its median wall, one run split by stage (the
             facade's tracer spans), and the device/native wall at 100k
             pods (the sweep from 1k is cut) on that mix and on the grid
             pods of phase 3 (the crossover that Solver.DEVICE_MIN_PODS is
             held against).
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
             versions at inputs recorded there. The online watchdog and the
             explain recorder are armed (the reference's defaults): no
             finding on either rung, equal watchdog stats, and the explain
             record of one burst pod (funnel counts, chosen offering,
             runner-up, binding constraint) equal on both rungs. Times:
             each stage's wall, the reconcile walls by controller, the
             tracer's spans, the watchdog's share of the engine's tick wall,
             the pass and burst medians beside those measured before the
             watchdog and the recorder were armed, the card's idle
             share over one disruption reconcile.
  4d. optimizer bench c14's procedure (`optimizer.fixtures.
             measure_consolidation`, the squeeze fleet) on the device rung,
             armed and disarmed, and armed on the native rung, at 2 tiles
             and at OPT_TILES, the delta plane at its default (its audit
             passes re-run a memoized fruitless search): joint
             consolidations >= tiles, the armed savings above the disarmed
             ones, device == native (subsets scored included).
  4e. fleet  the port's SolverService (fleet/service.py) on the 810-type
             catalog: bench c12's procedure (16 tenants, 10 rounds of a
             48-pod burst) on a serial device service and a batched one
             (batch=True), each after a warm round, SolveOutputs equal to a
             native-rung service's every round: at the default the delta
             plane serves every repeated solve (no B0/B launch; 480 served
             solves), then with the plane off max batch 16 and exactly
             one B0 and one B launch a batched round; a wide pump of 32
             tenants x 8,192 grid pods (two buckets of 16, bucket 2
             dispatched before bucket 1 drains, every packed row equal to
             the tenant's serial solve_packed vector); batched B0 and B
             against their plain versions (atol 0) at the wide bucket's
             inputs and at 1, 5 (padded to 6) and 16 of its requests;
             bucket 2's dispatch returns with bucket 1 queued behind a
             busy stream, no synchronising call in it. Any
             fallback or fault_fallback fails it. Times: solves/s a regime,
             batch size, occupancy, pipeline_overlap_ratio, the idle share
             of one batched pump, and the batched kernels against 16
             serial launches at the same rows, beside the batch's bound.
  4f. chaos  the reference's `make chaos` and `make crash-audit` on the
             card (faults/runner.py): smoke, ice_storm, api_brownout,
             interruption_wave, device_loss, clock_skew, soak, warmpath_smoke,
             warmpath_storm, restart_smoke, crash_drain and
             crash_launch_storm replaced onto backend="device", each run twice
             at seed 0 (equal end hash and fault fingerprint: --repeat 2)
             and once on the native rung (equal; device_loss: its end state,
             the native rung makes no device dispatch for its fault), the
             restart group at seeds 0-4 on both rungs; every report ok, no
             fallback but device_loss's one injected fault, no integrity flag
             or optimizer degrade, no warm-path divergence, and every run's
             watchdog findings those of the reference's CPU run (none; the
             drills sdc_storm and resident_rot run in 4h, where they must
             fire integrity_breach). Then a storm at cluster scale: the
             soak's rules over the
             operator phase's grid pods, 5,000 (cut from 10,000) in waves of
             2,500, 1,250 and 1,250 at 0, 120 and 300 s, on 810 types, device
             then native
             rung: equal state hash, fault fingerprint, controller and
             solver stats; the only integrity flags allowed are the
             reference's over-capacity state's (ROADMAP §3), equal on both
             rungs, as are the watchdog findings they fire (integrity_breach
             alone); A, B0, B and C launched inside the device run and equal
             to their plain versions at inputs recorded there. Times: each
             run's wall, the storm's reconcile medians, the card's idle
             share over one disruption pass inside the ICE window.
  4g. fleet runner  the reference's `make fleet` on the card
             (fleet/runner.py): fleet_smoke at 50 tenants, serial and
             batched on the device rung and serial on native, per-tenant
             end hashes and fault fingerprints equal across the three;
             fleet_noisy_neighbor serial and batched (ok, victim p99 during
             the storm < 2x quiet, the noisy tenant throttled and alerted,
             one of its throttled pods explained, equal digests);
             federation_smoke in process, batched. Any fallback,
             fault_fallback, integrity flag or watchdog finding fails it.
             Prints
             each run's wall, solves, batches, tickets, solves/s, overlap,
             SLO alerts and B0/B launches.
  4h. planes the delta plane and the device-resident state: the facade mix's
             encoded groups (100,000 pods, Gp 1,536) solved through
             solve_device(resident_key=) at first sight, then with 1%, 10%
             and 60% of the group rows changed (a patch, a patch, the dense
             full upload), then unchanged (a clean hit: zero bytes and
             uploads, fewer HtoD copies under torch.profiler); every packed
             vector equal to the solve with KARPENTER_TPU_RESIDENT=0, each
             patch's resident_patch bytes the changed rows plus the index
             vector. c12's 16 tenants batched for four rounds (delta plane
             off): the stacked matrix seeded, repeated (clean hit), two
             tenants changed (a patch), every row equal to the disarmed
             run's. RESIDENT.audit over every entry (0 corrupt),
             DEVICEMEM.audit against the live CUDA tensors (coverage >=
             0.99), the PhaseLedger's coverage of one traced facade solve,
             RECOMPUTE's redundant fraction by stage over the operator
             phase. sdc_storm and resident_rot twice each at seed 0 on the
             device rung: ok (100% detected before commit), repeat-equal
             digests, the reference's detections and flags, one quarantine
             an injection. c14 at 2 tiles at the default: 3,676 subsets
             scored, savings and plans unchanged. The row scatter timed at
             the gbuf (k = 1% and 10% of Gp) and the conflict matrix beside
             its bound and a full upload of the same matrix.
  4i. warm   the reference's c8 cell (the warm path, bench.py:488-570):
             make_sim(backend="device", warmpath=True, warm_audit_every=64)
             with c8's fast cloud, 2,000 standing pods pinned one to a node
             by hostname self-anti-affinity, one prime burst, 24 warm bursts
             (c8 runs 5; 24 carry warm_integrity_tick past the integrity
             audit cadence of 16) and 3 forced-cold bursts of 32 pods, the
             auditor drained; then the same on the native rung. Zero
             divergence, >= 24 warm reconciles, at least one resident audit
             fired from warm_integrity_tick, B0 and B launched in the cold
             passes and the auditor's replay and equal to their plain
             versions at inputs recorded there, device == native (state
             hash, warm-path, auditor and watchdog stats, the explain record
             of a cold-burst pod), no watchdog finding, fallback or
             integrity flag. Times: warm admit p50, cold reconcile p50 and
             their ratio, the watchdog's share of the engine's tick wall and
             one forced full evaluation over the standing fleet.
  4j. soak   bench c13's procedure (bench.py:931-967): soak_smoke and
             soak_overload at seed 0 through loadgen.SoakRunner, twice on
             the device rung (every tenant's solves through one batched
             SolverService: a bucket is one launch of batched B0 and B;
             each shard's screen runs A) and once on native. The three
             digests (soak hash, fault fingerprint, load fingerprint)
             repeat-equal and device == native, every report ok, the
             watchdog findings the reference's CPU run's (none),
             soak_overload shedding within its budget (depth <= 60 + 8),
             with 0 overload_unbounded findings and at least one
             admission_availability burn alert; batched B0/B and A (and C
             when a subset search ran) against their plain versions at
             the largest bucket and screen captured in the runs. Prints
             c13's keys for each rung.
  4k. shell  the operator shell: build_operator(Options(solver_backend=
             "device", leader_elect=True, a file lease, a file intent
             journal, a metrics port)) over FakeCloud(generate_catalog())
             on a fast real clock (x600), its asyncio Runtime started
             under the reference runtime soak's churn (chaos kills, tight
             throttle buckets, pod deletions) scaled to 32 waves of 128
             pods: converged within SHELL_DEADLINE_S, no crash, coalesced
             terminations and describes, /metrics and /readyz served by
             the runtime, the lease released on stop(), every oracle flag
             a capacity flag on a consolidation replacement (the
             over-capacity state, ROADMAP §3), B0 and B launched and equal
             to their plain versions at the largest solve's inputs. Then `python -m karpenter_tpu_torch.main --soak
             --soak-scenario soak_smoke --solver-backend device` exits 0
             printing 4j's device digests.
  4l. federation  bench c17's procedure (bench.py:1158-1236): 3 processes
             x 40 tenants of federation_smoke at seed 0, every bucket over
             the in-memory wire (each payload through the JSON codec) to one
             SolverServer on the card; the federated digests equal an
             in-process device run's, a native run's and the reference's CPU
             run's (tools/ref_findings.py federation), 0 wire failures, 0
             local buckets, catalog uploads <= the distinct views, the
             server's stats the reference's (each shard solves
             synchronously, so every bucket carries one request, as in the
             reference). One full wire bucket: 16 tenants x 8,192 grid pods
             deferred into one pump, one [16, Gp, W] stack crossing the wire
             and one launch each of batched B0 and B on the server,
             SolveOutputs equal to an in-process batched service's, batched
             B0/B equal to their plain versions at that stack. Bench c18's
             drills, fed_flap and fed_server_restart at seed 0, twice each:
             repeat-equal, the reference's digests and findings, the
             restart's digests those of its in-process arm, no stale frame
             decoded, at least one rejoin. Then `python -m
             karpenter_tpu_torch.federation.server` in a subprocess (READY
             <port>), `python -m karpenter_tpu_torch.fleet federation_smoke
             --federate --server-addr` against it (exit 0, the in-process
             run's fleet hash), a client living across a kill and a restart
             with --generation 2 (one generation change, one re-handshake,
             the catalog re-uploaded once, 0 failures), the fleet CLI again.
             Prints c17's and c18's keys and the server's B0/B launches.
  4m. mesh  the multi-device path on 8 virtual shards of the card
             (parallel.virtual_devices(8, "cuda:0")), every answer held bit
             for bit against mesh=None on the card: run_sharded_solve at
             the grid mix (phase 3's pods) and at the reference's bench
             shape (128 self-anti-affine groups x 40 pods, ~5k nodes), kernel
             M equal to its plain version (atol 0), to kernel B on one
             device and to solve_host; Solver(backend="mesh") at 100,000
             grid pods == backend="device"; the mesh screen over phase 3's
             cluster == mesh=None; score_subsets_device(mesh=) at the
             operator loop's first subset search == mesh=None;
             dispatch_batch over a batch mesh on a 16 x 8,192 grid-pod
             bucket == mesh=None, then the bucket with one tenant's request
             changed: one row patched, one row scatter a shard;
             SolverServer(mesh=) serving 4l's deferred 16-row pump == the
             in-process batched service, c17_mesh_batch_capacity = 16 x 8.
             Where more than one card exists, the grid mix over the real
             cards too; otherwise one line says multi-card was not run.
             Prints M's time a solve and a step, the launches of A, B0, B,
             C and M per shard, and the mesh walls beside mesh=None's.
  5. time    median wall times of the solve and the screen, stage by stage;
             per-kernel device time from torch.profiler and CUDA events
             beside its bound, its plain version's time and one torch
             expression's time where one computes the same function;
             kernels B0 and B at the facade solve's scan inputs and at the
             solve_device cell's, kernel B at every cluster size at both;
             kernel C at the operator loop's first subset search (one
             block a subset) and at a search over phase 3's 4,250-node
             cluster (a cluster of 16), each row with its tier, cluster and
             shared memory.

The kernels line reports each kernel's launches in the operator phase
and its times at a full-size input (A: the main path's screen; B0, B: the
facade's solve; C: the operator loop's first subset search); `by_phase`
holds each phase's launches (the main path, the facade, the operator, the
optimizer, the chaos phase, the fleet runner, the warm path, the soak,
the operator shell, the federation phase and, for B0 and B, the fleet's
batched rounds, the soak's launches in batched buckets and the federation
server's launches, and the mesh phase's, with their count per shard) and
times (the fleet's at its wide bucket: 16 requests in one launch). Its
mesh_scan row is kernel M: launches and times from phase 4m (times at
the grid mix; by_phase also at the bench shape). Its resident_patch
row is the row scatter of ops/resident (the port of the reference's
_jit_scatter, a library index_copy_): launches from phase 4h, times at the
facade mix's gbuf with k = 1% of its rows, by_phase every phase's launches
and the other timed inputs. The last two lines of
output are that line and {"ok": true, "device": {...}}. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import ast
import copy
import inspect
import itertools
import json
import os
import shutil
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


class env_set:
    """Set environment switches for a block and restore them after."""

    def __init__(self, **kv):
        self.kv = {k: str(v) for k, v in kv.items()}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


# kernel C at the tiers that the recorded inputs (the operator loop's
# searches: one block a subset, k streamed; the grid-mix search: a cluster
# of 16, k resident) do not reach: (S, N, G, Rk)
TOURNAMENT_TIER_INPUTS = (
    (64, 300, 90, 3),     # one block a subset, k resident
    (12, 600, 90, 2),     # a cluster of 2
    (4, 5000, 90, 2),     # a cluster of 16, k streamed
    (4, 600, 1536, 2),    # 16 blocks, node slices in global scratch
    (600, 40, 7, 3),      # four subsets a block
)


def layout_note(tk, S: int, N: int, G: int, Rk: int) -> str:
    lay = tk.tournament_layout(S, N, G, Rk)
    return (f"tier {lay.tier}, cluster {lay.cl}, slice {lay.slice}, "
            f"{lay.spb} subset(s) a block, k "
            f"{'resident' if lay.k_smem else f'streamed in {lay.ch}-row chunks'}"
            f", {lay.smem_bytes} B shared")


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
                  (64, 300, 90, 3)] + list(TOURNAMENT_TIER_INPUTS):
        check_tournament(tk, tk.seeded_inputs(5, *shape, dev),
                         f"S,N,G,Rk={shape}, {layout_note(tk, *shape)}")
    args = tk.seeded_inputs(6, 50, 40, 12, 3, dev)
    strided = tk.tournament_cuda(*tk.packed_views(args))
    torch.cuda.synchronize()
    check(torch.equal(strided, tk.tournament_plain(*args)),
          "tournament on row-strided packed views != plain")
    log("[check] tournament == plain (every packed output, atol 0; the "
        "ranked plan equal) at four shapes, at one seeded input for each "
        "tier the recorded inputs do not reach ("
        + "; ".join(f"{sh}: {layout_note(tk, *sh)}"
                    for sh in TOURNAMENT_TIER_INPUTS)
        + ") and on row-strided packed views")

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
# the device/native crossover, cut to its 100k point to keep the script
# inside its time limit with the chaos phase's storm (the sweep from 1k
# pods is a finished measurement: PERF.md §5)
CROSSOVER_SIZES = (100_000,)
CROSSOVER_REPS = 2
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
    # at the default the delta plane serves a repeat of the first solve
    # (its result, still oracle-verified); every time after that is taken
    # with the plane off (KARPENTER_TPU_DELTA=0), so each solve dispatches
    # — the request matrix and catalog stay resident either way
    def facade_walls():
        walls = []
        for _ in range(FACADE_REPS):
            t0 = time.perf_counter()
            dev_f.solve(pods, pool, **kw)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls
    served = facade_walls()
    log(f"[time] Solver.solve {N_PODS} pods, backend='device', served by the "
        f"delta plane (the default): median wall "
        f"{statistics.median(served):.3f} ms over {FACADE_REPS} runs "
        f"({', '.join(f'{w:.1f}' for w in served)})")
    delta_off = env_set(KARPENTER_TPU_DELTA=0)
    delta_off.__enter__()
    walls = facade_walls()
    wall = statistics.median(walls)
    log(f"[time] Solver.solve {N_PODS} pods, backend='device', delta plane "
        f"off, catalog view, encode cache and resident request matrix warm: "
        f"median wall {wall:.3f} ms over {FACADE_REPS} runs "
        f"({', '.join(f'{w:.1f}' for w in walls)})")

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
                        for d in tr.children(sp) if d.name == "solve.device"
                        for c in tr.children(d)])
    split_wall = tr.root.duration * 1e3
    log(f"[time] facade stages of one solve (ms, spans; wall "
        f"{split_wall:.3f}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in top_ms.items())
        + f", unattributed {split_wall - sum(top_ms.values()):.3f}")
    log("[time] inside solve.run > solve.device (solve_device): " + ", ".join(
        f"{k} {v:.3f}" for k, v in inner_ms.items())
        + f", the rest of solve.run "
        f"{top_ms.get('solve.run', 0.0) - sum(inner_ms.values()):.3f}")
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
    delta_off.__exit__()
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
EXPLAINED_POD = f"default/burst-{OP_BURSTS - 1}-0"
# the watchdog findings of warning and above, (invariant, severity) ->
# count, that the reference's own CPU run of this phase's procedure fires
# (karpenter_tpu.sim.make_sim at OP_PODS on the native rung): the armed
# optimizer's exact verifies reject 16 ranked subsets in a row during the
# scale-down, past the divergence streak of 12
OP_REF_FINDINGS = {("optimizer_divergence", "warning"): 1}
# the info-severity meters of the tracer the device run turns on (the
# phase ledger's unattributed gap, the flight recorder's drops): timing,
# not the loop's state
TRACER_METERS = {"profile_unattributed", "trace_ring_overflow"}
# the operator medians measured before the watchdog and the explain
# recorder were armed (NVIDIA H100 80GB HBM3, 700 W; PERF.md §5)
UNARMED_MEDIANS_MS = {"disruption pass": 466.0, "burst reconcile": 281.0}


def time_calls(obj, name: str) -> list:
    """Wrap obj.name (an instance attribute shadowing the method) to sum
    its host wall: returns [total ms, calls], updated in place."""
    real = getattr(obj, name)
    box = [0.0, 0]

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            box[0] += (time.perf_counter() - t0) * 1e3
            box[1] += 1
    setattr(obj, name, timed)
    return box


class OperatorRun:
    """One run of the operator phase on one rung of the port's make_sim:
    scale-up, scale-down until disruption is quiet, steady-state bursts.
    Times every controller reconcile (host wall; each one ends in host
    reads) and counts the solves and screens of each stage."""

    def __init__(self, backend: str, profile_pass: bool):
        from karpenter_tpu_torch import catalog, sim as S
        from karpenter_tpu_torch.cloud.fake import FakeCloudConfig
        from karpenter_tpu_torch.optimizer import OPTIMIZER
        # the reference's default: the global optimizer armed
        os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)
        self.optimizer0 = OPTIMIZER.totals()
        reset_sequences()
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
        self.tick_ms = time_calls(self.sim.engine, "tick")
        self.watchdog_ms = (time_calls(self.sim.watchdog, "tick")
                            if self.sim.watchdog is not None else [0.0, 0])
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
        # decision provenance of one burst pod (the explain recorder is
        # process-wide: read it before the next run)
        from karpenter_tpu_torch.obs.explain import RECORDER
        self.explained = copy.deepcopy(RECORDER.explain(EXPLAINED_POD))
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


def check_scan_calls(rec_b, where: str,
                     b_what=("first solve", "last solve")) -> None:
    """B0 and B against their plain versions at the scan inputs a loop
    recorded (Recorder keep=2: its first and latest call)."""
    import torch
    from karpenter_tpu_torch.ops import solve_scan as ss
    for (sargs, skw), what in zip(rec_b.calls, b_what):
        check_offer(ss, sargs, skw, f"{where} {what}")
        out_k = ss.solve_scan_cuda(*sargs, **skw)
        out_p = ss.solve_scan_plain(*sargs, **skw)
        torch.cuda.synchronize()
        for a, b, field in zip(out_k, out_p, ("ntype", "takes", "unsched",
                                              "nused", "overflow")):
            check(torch.equal(a.to(b.dtype).reshape(b.shape), b),
                  f"solve_scan != plain at the {where} {what} ({field})")
        b = inspect.signature(ss.solve_scan_plain).bind(*sargs, **skw)
        log(f"[check] {where} {what}: offer_argmin == plain and solve_scan "
            f"== plain (Gp={b.arguments['requests'].shape[0]}, "
            f"n_max={b.arguments['n_max']})")


def check_recorded(rec_b, rec_a, rec_c, where: str,
                   b_what=("first solve", "last solve")) -> tuple:
    """B0, B, A and C against their plain versions at the inputs a loop
    recorded (Recorder keep=2: its first and latest call of each).
    Returns A's and C's largest absolute errors (both must be 0)."""
    import torch
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import screen_k as sk
    check_scan_calls(rec_b, where, b_what)
    (aargs, akw) = rec_a.calls[-1]
    k_got = sk.screen_k_cuda(*aargs, **akw)
    torch.cuda.synchronize()
    k_want = sk.screen_k_plain(*aargs, **akw)
    err_a = float((k_got - k_want).abs().max()) if k_got.numel() else 0.0
    check(err_a == 0.0, f"screen_k != plain at the {where}'s screen: {err_a}")
    log(f"[check] {where} screen: screen_k == plain (atol 0) at N="
        f"{aargs[0].shape[0]} G={aargs[1].shape[0]}; {rec_a.n} screens")
    err_c = 0.0
    for (cargs, _), what in zip(rec_c.calls, ("first", "last")):
        err_c = max(err_c, check_tournament(tk, cargs, f"{where} {what} "
                                            f"subset search"))
        S_, N_ = cargs[4].shape
        log(f"[check] {where} {what} subset search: tournament == plain "
            f"(atol 0, plan equal) at S={S_} N={N_} G={cargs[2].shape[1]} "
            f"Rk={cargs[0].shape[1]}; {rec_c.n} searches on the card")
    return err_a, err_c


def reset_sequences() -> None:
    """Claim names, pod uids and instance ids start from the same value in
    every run a phase compares (names break ties in the loop's orderings),
    and the delta and resident planes and the explain recorder start empty
    (their keys hold id(facade), which a later facade may reuse)."""
    from karpenter_tpu_torch.cloud import fake
    from karpenter_tpu_torch.models import nodeclaim, pod
    from karpenter_tpu_torch.obs.explain import RECORDER
    from karpenter_tpu_torch.ops.delta import DELTA
    from karpenter_tpu_torch.ops.resident import RESIDENT
    nodeclaim._seq = itertools.count()
    pod._uid = itertools.count()
    fake._ids = itertools.count(1)
    DELTA.reset()
    RESIDENT.reset()
    RECORDER.reset()


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
    from karpenter_tpu_torch import optimizer as O
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
                Recorder(tk, "tournament", keep=2) as rec_c, \
                Recorder(O, "score_subsets_device", keep=1) as rec_s:
            times_d = run_d.drive()
            torch.cuda.synchronize()
        # the first subset search's inputs, for phase 4m's mesh tournament
        OP_SEARCH[:] = rec_s.calls[:1]
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
    # the watchdog, armed by default: the same evaluations on both rungs
    # and, at warning and above, the reference's findings (OP_REF_FINDINGS);
    # the traced device run may add the tracer's own info meters
    fd, fn = findings_of(run_d.sim), findings_of(run_n.sim)
    log(f"[watchdog] operator: findings device {fd or 'none'}, native "
        f"{fn or 'none'} (the reference's CPU run: {OP_REF_FINDINGS})")
    for run, found in ((run_d, fd), (run_n, fn)):
        paged = {k: n for k, n in found.items() if k[1] != "info"}
        info = {k[0] for k in found if k[1] == "info"}
        check(paged == OP_REF_FINDINGS
              and info <= (TRACER_METERS if run is run_d else set()),
              f"operator {run.backend} run: watchdog findings {found}, the "
              f"reference's {OP_REF_FINDINGS}")
    check(run_d.sim.watchdog.stats["evals"]
          == run_n.sim.watchdog.stats["evals"],
          f"operator watchdog stats differ: {run_d.sim.watchdog.stats} vs "
          f"{run_n.sim.watchdog.stats}")
    # decision provenance of one burst pod: funnel counts, chosen offering,
    # runner-up and binding constraint equal on both rungs
    rd, rn = run_d.explained, run_n.explained
    check(rd is not None and rd == rn,
          f"operator: explain of {EXPLAINED_POD} device {rd} != native {rn}")
    log(f"[check] operator watchdog: {run_d.sim.watchdog.stats['evals']} "
        f"evaluations on both rungs, the reference's findings on both; "
        f"explain "
        f"{EXPLAINED_POD} equal on both rungs: {rd['outcome']}, chosen "
        f"{rd.get('chosen')}, runner-up {rd.get('runner_up')}, binding "
        f"{rd['binding_constraint']}, funnel offerings "
        f"{[f['offerings'] for f in rd['funnel'] or []]}")
    log(f"[check] operator device == native: state_hash {hd[:16]}, "
        f"{len(run_d.decisions())} disruption decisions "
        f"({sum('optimizer' in str(e) for e in run_d.decisions())} naming "
        f"the optimizer) and every controller's stats equal")

    # each kernel against its plain version at inputs recorded in the loop
    err_a, err_c = check_recorded(rec_b, rec_a, rec_c, "operator",
                                  ("scale-up solve", "last re-solve"))
    (aargs, akw) = rec_a.calls[-1]
    log(f"[check] operator: {run_d.solves} Solver.solve calls by stage")

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
    log(f"[time] operator device run: the watchdog's tick "
        f"{run_d.watchdog_ms[0]:.1f} ms over {run_d.watchdog_ms[1]} engine "
        f"ticks ({run_d.sim.watchdog.stats['evals']} evaluations) of "
        f"{run_d.tick_ms[0]:.1f} ms of engine tick wall: share "
        f"{run_d.watchdog_ms[0] / max(run_d.tick_ms[0], 1e-9):.6f}")
    log(f"[time] operator medians with the watchdog and the explain "
        f"recorder armed (the defaults): disruption pass "
        f"{statistics.median(dis):.1f} ms, burst reconcile "
        f"{statistics.median(bursts):.1f} ms; before they were armed "
        f"(NVIDIA H100 80GB HBM3, 700 W): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in UNARMED_MEDIANS_MS.items()))
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


# the operator loop's first subset search (score_subsets_device's
# arguments), kept for phase 4m's mesh tournament
OP_SEARCH: list = []


# --- the optimizer phase: bench c14's procedure on the card ---------------

# the larger squeeze fleet: 64 nodes, cut from 24 tiles (192 nodes took
# 253 s of the script's wall on one H100) and then from 12 (128 s for the
# three runs) to leave room for the federation phase; PERF.md §4
OPT_TILES = 8
OPT_RUN_S = 900.0       # sim seconds a measurement runs (bench c14's)
# c14 at 2 tiles at the reference's default, delta plane armed: the subsets
# scored, savings and joint consolidations that
# tests/test_torch_sim_optimizer.py holds equal to the reference's
C14_AT_2_TILES = {"subsets_scored": 3676, "savings": 0.2838,
                  "joint_consolidations": 2}


def phase_optimizer() -> tuple:
    """measure_consolidation("squeeze", tiles) on make_sim(backend=
    "device"), armed and disarmed, and armed on the native rung, at 2 tiles
    and at OPT_TILES, the delta plane at its default. Returns kernel C's
    launches in the phase and the armed device run at 2 tiles."""
    from karpenter_tpu_torch.optimizer import fixtures, tournament_k as tk
    tk.launches = 0
    for tiles in (2, OPT_TILES):
        runs = {}
        for backend, armed in (("device", True), ("device", False),
                               ("native", True)):
            reset_sequences()  # and the planes: each run starts empty
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
        if tiles == 2:
            c14 = on
    check(tk.launches > 0, "kernel C was not launched in the optimizer phase")
    return {"tournament": tk.launches}, c14


FLEET_TENANTS = 16     # bench c12's tenants, rounds and burst (bench.py:736)
FLEET_ROUNDS = 10
FLEET_BURST = 48
FLEET_SHAPES = (("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"),
                ("2", "4Gi"), ("4", "16Gi"), ("500m", "4Gi"),
                ("1", "8Gi"), ("250m", "1Gi"))     # bench.py:186
WIDE_TENANTS = 32      # two buckets of SolverService.MAX_BATCH
WIDE_PODS = 8_192      # grid pods a tenant (seed = the tenant's index)


class FleetWatch:
    """Keeps every batched dispatch of a pump and the order of dispatches
    and drains (first readbacks), by wrapping ops/solver.dispatch_batch and
    InFlightBatch.block."""

    def __init__(self, solver):
        self.solver, self.batches, self.order = solver, [], []

    def __enter__(self):
        s, watch = self.solver, self
        self.real = (s.dispatch_batch, s.InFlightBatch.block)
        real_dispatch, real_block = self.real

        def dispatch(reqs, mesh=None, resident_key=None):
            ifb = real_dispatch(reqs, mesh, resident_key=resident_key)
            watch.batches.append(ifb)
            watch.order.append(("dispatch", len(watch.batches) - 1))
            return ifb

        def block(ifb):
            if ifb._buf is None and any(b is ifb for b in watch.batches):
                watch.order.append(("drain", next(
                    i for i, b in enumerate(watch.batches) if b is ifb)))
            return real_block(ifb)
        s.dispatch_batch, s.InFlightBatch.block = dispatch, block
        return self

    def __exit__(self, *exc):
        self.solver.dispatch_batch, self.solver.InFlightBatch.block = self.real


def fleet_service(backend: str, batch: bool, n: int, types):
    """A SolverService on `backend` with n tenants t000.. on one catalog."""
    from karpenter_tpu_torch.catalog import CatalogProvider
    from karpenter_tpu_torch.fleet import SolverService
    from karpenter_tpu_torch.utils.clock import FakeClock
    svc = SolverService(FakeClock(), backend=backend, batch=batch)
    return svc, [svc.register(f"t{t:03d}", CatalogProvider(lambda: types))
                 for t in range(n)]


def serial_round(clients, bursts, pool) -> list:
    return [out_tuple(c.solve(b, pool)) for c, b in zip(clients, bursts)]


def batched_round(svc, clients, bursts, pool) -> list:
    tickets = [c.solve_async(b, pool) for c, b in zip(clients, bursts)]
    svc.pump()
    return [out_tuple(t.result()) for t in tickets]


def row_args(args, b: int):
    """Request b's solve_scan arguments from solve_scan_batched's (the
    group inputs, positions 3-11, indexed; the rest shared)."""
    return args[:3] + tuple(a[b] for a in args[3:12]) + args[12:]


def check_batched(ss, args, kw, what: str) -> None:
    """Batched B0 and B (one launch each) against the per-row plain
    versions at atol 0."""
    import torch
    got = ss.solve_scan_batched_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = ss.solve_scan_batched_plain(*args, **kw)
    for a, b, name in zip(got, want, ("ntype", "takes", "unsched", "nused",
                                      "overflow")):
        check(torch.equal(a.to(b.dtype), b),
              f"batched solve_scan != plain ({what}: {name})")
    oa = [args[i] for i in (0, 1, 2, 3, 5, 6, 7, 8, 12)]
    got0 = ss.offer_argmin_batched_cuda(*oa, zone_ovh=kw["zone_ovh"])
    torch.cuda.synchronize()
    for b in range(args[3].shape[0]):
        want0 = ss.offer_argmin_plain(
            *oa[:3], *(x[b] for x in oa[3:8]), oa[8], zone_ovh=kw["zone_ovh"])
        for x, y in zip(got0, want0):
            check(torch.equal(x[b].to(y.dtype), y),
                  f"batched offer_argmin != plain ({what}, row {b})")


def batched_kernel_times(ss, args, kw, where: str):
    """Kernels B0 and B at one solve_scan_batched call's arguments: each
    batched kernel alone (torch.profiler) and the wrapper call (CUDA
    events) against the same rows as Bp serial launches, the plain version,
    a torch yardstick for B0 and the bound (the catalog and the starting
    node state read once, each request's rows and outputs once). Logs them
    and returns the two rows of the kernels line."""
    import torch
    b = inspect.signature(ss.solve_scan_batched_plain).bind(*args, **kw)
    b.apply_defaults()
    a = b.arguments
    T, Z, C = a["price"].shape
    Bp, Gp, Rk = a["requests"].shape
    n_max, ZC = a["n_max"], Z * C
    W = -(-Gp // 32) if a["track_conflicts"] else 0
    lay = ss._scan_layout(n_max, Rk, W, Z, C, T, a["zone_ovh"])
    rows = [row_args(args, i) for i in range(Bp)]
    b0_in = [a[k] for k in ("alloc", "price", "avail", "requests", "counts",
                            "compat", "allow_zone", "allow_cap",
                            "max_per_node", "prior", "banned", "conflict",
                            "zovh")]
    b0_flags = (a["zone_ovh"], a["track_conflicts"])

    def serial_tables():
        for i in range(Bp):
            ss._offer_table(*b0_in[:3], *(x[i:i + 1] for x in b0_in[3:12]),
                            b0_in[12], *b0_flags)

    def serial_scans():
        for r in rows:
            ss.solve_scan_cuda(*r, **kw)

    b0_k, b_k = profiled_ms(
        lambda: [ss.solve_scan_batched_cuda(*args, **kw) for _ in range(5)],
        "offer_argmin_kernel", "solve_scan_kernel")
    s0_k, s_k = profiled_ms(serial_scans, "offer_argmin_kernel",
                            "solve_scan_kernel")
    oa = {"alloc": a["alloc"], "price": a["price"], "avail": a["avail"],
          "requests": a["requests"].reshape(Bp * Gp, Rk),
          "compat": a["compat"].reshape(Bp * Gp, T),
          "allow_zone": a["allow_zone"].reshape(Bp * Gp, Z),
          "allow_cap": a["allow_cap"].reshape(Bp * Gp, C),
          "max_per_node": a["max_per_node"].reshape(Bp * Gp)}
    cat0 = 4 * T * ZC + T * ZC + 4 * T * Rk + 8 * T
    req0 = Gp * (4 * Rk + T + Z + C + 8) + 4 * Gp * lay.rec_words
    b0 = {"ms": cuda_ms(lambda: ss._offer_table(*b0_in, *b0_flags), 50),
          "plain_ms": cuda_ms(lambda: [ss.offer_argmin_plain(
              *r[:4], *r[5:9], r[12], zone_ovh=a["zone_ovh"]) for r in rows],
              2),
          **bound(cat0 + Bp * req0, Bp * Gp * (T * 4 * Rk + T * ZC * 2)),
          "library_ms": cuda_ms(lambda: library_cps(oa), 10),
          "kernel_ms": b0_k, "serial_ms": cuda_ms(serial_tables, 10),
          "serial_kernel_ms": None if s0_k is None else s0_k * Bp,
          "requests": Bp}
    shared = 4 * T * Rk + 4 * T * ZC + T * ZC + n_max * (4 + 4 * Rk + Z + C
                                                         + 1)
    per_req = (Gp * (4 * Rk + 4 + T + Z + C + 4) + 4 * Gp * n_max + 4 * Gp
               + 8 + 4 * n_max)
    bk = {"ms": cuda_ms(lambda: ss.solve_scan_batched_cuda(*args, **kw), 20),
          "plain_ms": cuda_ms(lambda: ss.solve_scan_batched_plain(*args,
                                                                  **kw), 1),
          **bound(shared + Bp * per_req,
                  Bp * Gp * (n_max * (4 * Rk + ZC + 6)
                             + T * (4 * Rk + 2 * ZC))),
          "library_ms": None, "kernel_ms": b_k,
          "serial_ms": cuda_ms(serial_scans, 5),
          "serial_kernel_ms": None if s_k is None else s_k * Bp,
          "requests": Bp}
    log(f"[time] {where} (Bp={Bp}, Gp={Gp}, n_max={n_max}, Rk={Rk}, layout "
        f"cl={lay.cl} nodes_in_shared={lay.nodes_smem}): batched "
        f"offer_argmin kernel {b0_k} ms a launch vs {Bp} serial launches "
        f"{b0['serial_kernel_ms']} ms; wrapper call {b0['ms']:.4f} ms vs "
        f"{Bp} serial {b0['serial_ms']:.4f} ms (bound {b0['bound_ms']:.5f} "
        f"ms, {b0['bound_by']}), plain {b0['plain_ms']:.3f} ms, cps + "
        f"torch.argmin {b0['library_ms']:.4f} ms; batched solve_scan kernel "
        f"{b_k} ms a launch vs {Bp} serial launches {bk['serial_kernel_ms']} "
        f"ms; wrapper call (B0 + B) {bk['ms']:.4f} ms vs {Bp} serial "
        f"{bk['serial_ms']:.4f} ms (bound {bk['bound_ms']:.5f} ms, "
        f"{bk['bound_by']}), plain {bk['plain_ms']:.1f} ms")
    return b0, bk


def phase_fleet() -> tuple:
    """The port's SolverService on the card, three ways: bench c12 at the
    reference's sizes (16 tenants, 10 rounds of a 48-pod burst each) on a
    serial device service and a batched one, against a native-rung
    service; a wide pump of 32 tenants x 8,192 grid pods (two buckets of
    16, the second dispatched before the first drains, and without waiting
    for it); batched B0 and B against their plain versions at the wide
    bucket's inputs and at 1, 5 (padded to 6) and 16 of its requests.
    Returns the batched rounds' B0
    and B launches and the kernels' rows at the wide bucket."""
    import numpy as np
    import torch
    from karpenter_tpu_torch import catalog, models
    from karpenter_tpu_torch.metrics import FLEET_SHAPE_CLASS
    from karpenter_tpu_torch.ops import solve_scan as ss, solver

    t_phase = time.perf_counter()
    types = catalog.generate_catalog()
    pool = models.NodePool(name="default")
    bursts = [[models.Pod(name=f"c12-{t}-{i}", requests=models.Resources.parse(
        {"cpu": FLEET_SHAPES[(t + i) % len(FLEET_SHAPES)][0],
         "memory": FLEET_SHAPES[(t + i) % len(FLEET_SHAPES)][1]}))
        for i in range(FLEET_BURST)] for t in range(FLEET_TENANTS)]
    names = [f"t{t:03d}" for t in range(WIDE_TENANTS)]
    faults0 = sum(FLEET_SHAPE_CLASS.value(event="fault_fallback", tenant=n)
                  for n in names)

    # --- c12: serial device and batched services against native ---
    nat_svc, nat = fleet_service("native", False, FLEET_TENANTS, types)
    ser_svc, ser = fleet_service("device", False, FLEET_TENANTS, types)
    bat_svc, bat = fleet_service("device", True, FLEET_TENANTS, types)
    serial_round(nat, bursts, pool)                 # warm rounds
    serial_round(ser, bursts, pool)
    with Recorder(solver, "solve_scan_batched") as rec_c12:
        batched_round(bat_svc, bat, bursts, pool)
    from karpenter_tpu_torch.metrics import DELTA_MEMO

    def solve_serves():
        return DELTA_MEMO.value(stage="solve", event="served")

    def c12_rounds(regime: str):
        """FLEET_ROUNDS rounds on the three services; returns the solves/s
        of each, B0/B launches a batched round, the batched service's
        stats delta and the delta plane's serves."""
        walls = {"native": 0.0, "serial device": 0.0, "batched": 0.0}
        per_round = []
        serves0 = solve_serves()
        st0 = dict(bat_svc.stats)
        with FleetWatch(solver) as fw:
            for r in range(FLEET_ROUNDS):
                t0 = time.perf_counter()
                want = serial_round(nat, bursts, pool)
                t1 = time.perf_counter()
                got_s = serial_round(ser, bursts, pool)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                ss.launches = 0
                ss.offer_launches = 0
                got_b = batched_round(bat_svc, bat, bursts, pool)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                n = (ss.offer_launches, ss.launches)
                per_round.append(n)
                fleet_launches["offer_argmin"] += n[0]
                fleet_launches["solve_scan"] += n[1]
                walls["native"] += t1 - t0
                walls["serial device"] += t2 - t1
                walls["batched"] += t3 - t2
                check(got_s == want and got_b == want,
                      f"c12 {regime} round {r}: SolveOutputs differ across "
                      f"the serial device, batched and native services")
        check(sum(b.fallbacks for b in fw.batches) == 0,
              f"c12 {regime}: a batched row fell back to a serial re-run")
        st = {k: v - st0.get(k, 0) for k, v in bat_svc.stats.items()
              if isinstance(v, (int, float))}
        solves = FLEET_TENANTS * FLEET_ROUNDS
        log(f"[fleet] c12 {regime} ({FLEET_TENANTS} tenants x {FLEET_ROUNDS} "
            f"rounds of {FLEET_BURST} pods, 810 types): SolveOutputs equal "
            f"across the serial device, batched and native services every "
            f"round; solves/s "
            + ", ".join(f"{k} {solves / v:.1f}" for k, v in walls.items())
            + f"; batched: {st.get('batches', 0)} batches, "
            f"{st.get('batched_tickets', 0)} tickets, max "
            f"{bat_svc.stats['max_batch_size']}, pipeline_overlap_ratio "
            f"{bat_svc.pipeline_overlap_ratio():.4f}; B0/B launches a "
            f"batched round {sorted(set(per_round))}; solves the delta plane "
            f"served {solve_serves() - serves0:g}")
        return per_round, solve_serves() - serves0

    fleet_launches = {"offer_argmin": 0, "solve_scan": 0}
    # at the default the delta plane serves every repeated burst: the warm
    # rounds stored each tenant's solve, and no round reaches its audit
    # cadence (16 serves), so nothing is dispatched, in the reference too
    per_round, serves = c12_rounds("delta plane on (the default)")
    check(per_round == [(0, 0)] * FLEET_ROUNDS
          and serves == 3 * FLEET_TENANTS * FLEET_ROUNDS,
          f"c12: the delta plane served {serves} solves, launches "
          f"{per_round}; want every repeated solve served")
    # the plane off: every round dispatches, one bucket of 16. The
    # services' clocks move to their next scheduling window first: each
    # tenant may submit 16 solves a window, and the rounds above took 11
    for svc_ in (nat_svc, ser_svc, bat_svc):
        svc_.clock.step(5.0)
    with env_set(KARPENTER_TPU_DELTA=0):
        per_round, _ = c12_rounds("delta plane off")
    check(all(n == (1, 1) for n in per_round),
          f"c12: a batched round must launch B0 and B once each: {per_round}")
    check(bat_svc.stats["max_batch_size"] == FLEET_TENANTS,
          f"c12: max batch size {bat_svc.stats['max_batch_size']}, not "
          f"{FLEET_TENANTS}")
    box = {}

    def one_pump():
        t0 = time.perf_counter()
        batched_round(bat_svc, bat, bursts, pool)
        torch.cuda.synchronize()
        box["wall"] = (time.perf_counter() - t0) * 1e3
    with env_set(KARPENTER_TPU_DELTA=0):
        for _ in range(3):  # the trace drops a short run's events now and then
            ev = device_kernel_us(one_pump)
            if ev:
                break
    if ev:
        busy = sum(us for us, _ in ev.values()) / 1e3
        log(f"[time] one batched c12 pump under torch.profiler: device busy "
            f"{busy:.3f} ms of {box['wall']:.1f} ms wall (idle share "
            f"{1 - busy / box['wall']:.5f}); "
            f"{sum(n for _, n in ev.values())} device kernels")
    else:
        log("[time] torch.profiler recorded no device events: the batched "
            "pump's idle share not measured")

    # --- the wide pump: 32 tenants x 8,192 grid pods, one pump ---
    t_wide = time.perf_counter()
    wide = [grid_pods(models, WIDE_PODS, t) for t in range(WIDE_TENANTS)]
    _, w_nat = fleet_service("native", False, WIDE_TENANTS, types)
    _, w_ser = fleet_service("device", False, WIDE_TENANTS, types)
    w_svc, w_bat = fleet_service("device", True, WIDE_TENANTS, types)
    t0 = time.perf_counter()
    want = serial_round(w_nat, wide, pool)
    t1 = time.perf_counter()
    got_s = serial_round(w_ser, wide, pool)
    t2 = time.perf_counter()
    ss.launches = 0
    ss.offer_launches = 0
    with FleetWatch(solver) as fw, \
            Recorder(solver, "solve_scan_batched") as rec_wide:
        got_b = batched_round(w_svc, w_bat, wide, pool)
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    wide_launches = (ss.offer_launches, ss.launches)
    check(got_s == want and got_b == want,
          "wide pump: SolveOutputs differ across the serial device, "
          "batched and native services")
    check([b.size for b in fw.batches] == [16, 16]
          and fw.order == [("dispatch", 0), ("dispatch", 1), ("drain", 0),
                           ("drain", 1)],
          f"wide pump: buckets {[b.size for b in fw.batches]}, order "
          f"{fw.order} (two of 16, the second dispatched before the first "
          f"drains)")
    check(wide_launches == (2, 2),
          f"wide pump: B0/B launches {wide_launches}, not one a bucket")
    check(sum(b.fallbacks for b in fw.batches) == 0,
          "wide pump: a batched row fell back to a serial re-run")
    serial_vec = {}
    for k, ifb in enumerate(fw.batches):
        rows = ifb.rows()
        for i, req in enumerate(ifb.reqs):
            vec, _ = solver.solve_packed(req.cat, req.enc)
            serial_vec[(k, i)] = vec
            check(np.array_equal(rows[i], vec),
                  f"wide pump: bucket {k} row {i} != serial solve_packed")
    log(f"[fleet] wide pump ({WIDE_TENANTS} tenants x {WIDE_PODS} grid "
        f"pods): SolveOutputs equal across the three services; 2 buckets "
        f"of 16, bucket 2 dispatched before bucket 1 drained; B0/B "
        f"launches {wide_launches}; every packed row == its serial "
        f"solve_packed vector; solves/s native "
        f"{WIDE_TENANTS / (t1 - t0):.2f}, serial device "
        f"{WIDE_TENANTS / (t2 - t1):.2f}, batched "
        f"{WIDE_TENANTS / (t3 - t2):.2f}; pipeline_overlap_ratio "
        f"{w_svc.pipeline_overlap_ratio():.4f}")

    # --- the kernels at the wide bucket's inputs, and at 1, 5 and 16 ---
    (wargs, wkw), = rec_wide.calls[:1]
    check_batched(ss, wargs, wkw, "wide bucket")
    reqs = fw.batches[0].reqs
    for Bp in (1, 5, 16):
        with Recorder(solver, "solve_scan_batched") as rec:
            ifb = solver.dispatch_batch(reqs[:Bp])
            rows = ifb.rows()
        check(ifb.padded_size == solver._batch_bucket(Bp),
              f"Bp={Bp}: padded to {ifb.padded_size}")
        for i in range(ifb.padded_size):
            if i < Bp:
                check(np.array_equal(rows[i], serial_vec[(0, i)]),
                      f"Bp={Bp}: row {i} != serial solve_packed")
            else:
                check(rows[i][0] == 0 and rows[i][2] == 0,
                      f"Bp={Bp}: padded row {i} placed pods")
        (a, kw), = rec.calls
        check_batched(ss, a, kw, f"Bp={Bp}")
    log("[check] batched offer_argmin and solve_scan == plain (atol 0) at "
        "the wide bucket's inputs and at Bp 1, 5 (padded to 6) and 16 of "
        "its requests; rows == serial solve_packed, padded rows inert")
    # dispatching bucket 2 must not wait for bucket 1: with the stream held
    # busy behind bucket 1, the dispatch returns before the stream drains,
    # and torch's sync debug mode raises on any synchronising copy in it
    first = solver.dispatch_batch(reqs)
    torch.cuda._sleep(1 << 31)
    busy = torch.cuda.Event()
    busy.record()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = solver.dispatch_batch(fw.batches[1].reqs)
        pending = not busy.query()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t1 = time.perf_counter()
    check(pending, "dispatch_batch waited for the batch in flight")
    for k, ifb in enumerate((first, second)):
        rows = ifb.rows()
        for i in range(ifb.size):
            check(np.array_equal(rows[i], serial_vec[(k, i)]),
                  f"no-wait dispatch: bucket {k} row {i} != serial")
    log(f"[check] dispatch_batch of the wide pump's bucket 2 returned in "
        f"{(t1 - t0) * 1e3:.3f} ms with bucket 1 still queued behind a "
        f"busy stream, no synchronising call (sync debug mode 'error'); "
        f"rows == serial solve_packed")
    faults = sum(FLEET_SHAPE_CLASS.value(event="fault_fallback", tenant=n)
                 for n in names) - faults0
    dev_fallbacks = sum(c.facade.stats["device_fallbacks"]
                        for c in ser + bat + w_ser + w_bat)
    check(faults == 0 and dev_fallbacks == 0,
          f"fleet: {faults} fault_fallback events, {dev_fallbacks} device "
          f"fallbacks")
    (cargs, ckw), = rec_c12.calls[:1]
    batched_kernel_times(ss, cargs, ckw, "c12 bucket")
    times = batched_kernel_times(ss, wargs, wkw, "wide bucket")
    log(f"[fleet] phase wall {time.perf_counter() - t_phase:.1f} s (wide "
        f"pump and checks {time.perf_counter() - t_wide:.1f} s)")
    return fleet_launches, times


# --- phase 4f: chaos — the reference's `make chaos` and `make crash-audit`
# (Makefile:46-51) on the card ----------------------------------------------

# every scenario of the catalog but the two corruption drills (sdc_storm
# and resident_rot run in phase 4h); the restart scenarios run at seeds 0-4
CHAOS_SCENARIOS = ("smoke", "ice_storm", "api_brownout", "interruption_wave",
                   "device_loss", "clock_skew", "soak", "warmpath_smoke",
                   "warmpath_storm", "restart_smoke", "crash_drain",
                   "crash_launch_storm")
CRASH_AUDIT_SEEDS = 5    # `make crash-audit`: the restart group, seeds 0-4
# the watchdog findings (invariant, severity) -> count that the reference's
# own CPU run of each scenario fires at the seeds above, on the device rung
# (tests/test_torch_chaos.py and test_torch_watchdog.py hold the port's
# equal to them); every other scenario fires none. The drills fire
# integrity_breach, the invariant the runner's found-it-first cross-check
# requires for a detected corruption
REF_FINDINGS = {"sdc_storm": {("integrity_breach", "critical"): 2},
                "resident_rot": {("integrity_breach", "critical"): 2}}
# the storm: the soak scenario's rules over the operator phase's grid pods
# (seed 0) in three waves, (run-relative sim second, pods). Cut in half
# from 10,000 pods, whose rungs took 222.9 and 366.4 s beside one NVIDIA
# H100 80GB HBM3 (PERF.md §4)
STORM_WAVES = ((0.0, 2_500), (120.0, 1_250), (300.0, 1_250))
STORM_PROFILE_AT = 60.0  # profile the first disruption pass inside the ICE window
# the storm's watchdog findings in the reference's CPU run on its native
# rung (the port's native run ends in the same state; its device run, in
# node order, fires the same findings on the CPU; the reference's device
# rung sums in XLA's order, ends in another state after the subset-search
# near-tie and fires one optimizer_divergence fewer, ROADMAP §3)
STORM_REF_FINDINGS = {("optimizer_divergence", "warning"): 2,
                      ("integrity_breach", "critical"): 1}


def counter_totals() -> tuple:
    """(device fallbacks, optimizer fallbacks, integrity detections,
    batched-pump fault fallbacks) since import: a phase diffs these around
    its runs, so a fallback in any boot of a restarted stack counts."""
    from karpenter_tpu_torch.integrity import INTEGRITY
    from karpenter_tpu_torch.metrics import (FLEET_SHAPE_CLASS,
                                             OPTIMIZER_SUBSETS,
                                             SOLVER_FALLBACKS)
    return (SOLVER_FALLBACKS.sum(), OPTIMIZER_SUBSETS.sum(event="fallback"),
            INTEGRITY.detections(),
            FLEET_SHAPE_CLASS.sum(event="fault_fallback"))


def run_scenario(sc, seed: int, reset: bool = True) -> tuple:
    """(report, runner, wall ms, counter deltas) of one chaos run on the
    card, with the sequences restarted first unless `reset` is False (the
    reference CLI's --repeat runs back to back without a restart)."""
    from karpenter_tpu_torch.faults import RestartRunner, ScenarioRunner
    if reset:
        reset_sequences()
    runner = (RestartRunner if sc.restart else ScenarioRunner)(sc, seed=seed)
    c0 = counter_totals()
    t0 = time.perf_counter()
    rep = runner.run()
    wall = (time.perf_counter() - t0) * 1e3
    delta = tuple(b - a for a, b in zip(c0, counter_totals()))
    return rep, runner, wall, delta


def check_clean(rep, runner, delta, where: str, fallbacks: int = 0) -> None:
    """A chaos run's report must be ok (converged, no violation — the
    zero-false-positive integrity contract included) and nothing may have
    degraded but the `fallbacks` injected device faults."""
    check(rep.ok, f"{where}: {rep.summary()}")
    dis = runner.last_sim.disruption.stats
    check(delta == (fallbacks, 0, 0, 0) and "screen_errors" not in dis
          and "optimizer_errors" not in dis,
          f"{where}: fallbacks / optimizer fallbacks / integrity flags / "
          f"fault_fallbacks {delta}, disruption stats {dis}")


def digest(rep) -> tuple:
    return rep.end_hash, rep.fault_fingerprint, rep.faults_injected


def findings_of(sim) -> dict:
    """The watchdog's findings of one stack, (invariant, severity) ->
    count (a restarted stack's: its final boot's)."""
    wd = sim.watchdog
    check(wd is not None and wd.armed, "the stack runs without its watchdog")
    out: dict = {}
    for f in wd.findings:
        out[(f.invariant, f.severity)] = out.get((f.invariant, f.severity),
                                                 0) + 1
    return out


def check_findings(name: str, sim, where: str) -> dict:
    """Print a run's watchdog findings and fail on any the reference's CPU
    run of the same scenario does not fire (REF_FINDINGS)."""
    got = findings_of(sim)
    want = REF_FINDINGS.get(name, {})
    log(f"[watchdog] {where}: findings {got or 'none'} (evaluations "
        f"{sim.watchdog.stats['evals']}; the reference's CPU run: "
        f"{want or 'none'})")
    check(got == want, f"{where}: watchdog findings {got}, the reference's "
          f"{want}")
    return got


class StormWatch:
    """Times the storm run's disruption and provisioner reconciles and
    profiles the first disruption pass inside the ICE window."""

    def __init__(self, profile: bool):
        self.profile = profile
        self.walls = {"disruption": [], "provisioner": []}
        self.profiled = None

    def arm(self, sim) -> None:
        origin = sim.fault_plan.origin
        for c in (sim.disruption, sim.provisioner):
            c.reconcile = self._timed(c.name, c.reconcile, origin)

    def _timed(self, name, reconcile, origin):
        def run(now):
            prof = (self.profile and name == "disruption"
                    and self.profiled is None
                    and now - origin >= STORM_PROFILE_AT)
            box = []
            t0 = time.perf_counter()
            if prof:
                ev = device_kernel_us(lambda: box.append(reconcile(now)))
            else:
                box.append(reconcile(now))
            ms = (time.perf_counter() - t0) * 1e3
            self.walls[name].append(ms)
            if prof:
                self.profiled = (sum(us for us, _ in ev.values()) / 1e3, ms,
                                 now - origin)
            return box[0]
        return run


def storm_scenario(backend: str, types, watch: StormWatch):
    """The soak scenario replaced onto the full catalog and the grid pods'
    waves (a wave's pods are built when it arrives, after the run's
    sequences restarted)."""
    import dataclasses
    from karpenter_tpu_torch import models
    from karpenter_tpu_torch.faults import SCENARIOS

    def workload(sim):
        watch.arm(sim)
        origin = sim.fault_plan.origin
        pods = grid_pods(models, sum(n for _, n in STORM_WAVES), SEED)
        waves, i = [], 0
        for t, n in STORM_WAVES:
            waves.append((t, pods[i:i + n]))
            i += n
        fired = set()

        def arrivals(now: float) -> None:
            for k, (t, wave) in enumerate(waves):
                if k not in fired and now - origin >= t:
                    fired.add(k)
                    for p in wave:
                        sim.store.add_pod(p)
        arrivals(sim.clock.now())
        sim.engine.add_hook(arrivals)
    return dataclasses.replace(SCENARIOS["soak"], name="storm",
                               backend=backend, types=lambda: types,
                               workload=workload)


def storm_split(events_d, events_n):
    """Where the storm's device and native event logs part: None when they
    are equal, else (index, device event, native event), which must be the
    one kind of split the rungs may show (ROADMAP §3): the subset search's
    f32 scores summed in another order on each rung rank two near-equal
    subsets the other way, so one consolidation takes the same number of
    victims, one interchangeable victim apart, with the same reason and the
    same replacements. Anything else fails."""
    i = next((k for k, (a, b) in enumerate(zip(events_d, events_n))
              if a != b), None)
    if i is None:
        check(len(events_d) == len(events_n),
              f"storm: one rung's event log ends early ({len(events_d)} vs "
              f"{len(events_n)} events)")
        return None
    a, b = events_d[i], events_n[i]
    va, vb = set(a[1].split(",")), set(b[1].split(","))
    check(a[0] == b[0] == "disruption" and a[2] == b[2] and a[3] == b[3]
          and len(va) == len(vb) and len(va - vb) == 1,
          f"storm: device and native part at event {i} other than by a "
          f"subset-search tie: {a} vs {b}")
    return i, a, b


def controller_stats(sim) -> dict:
    return {c.name: dict(c.stats) for c in sim.engine.controllers
            if hasattr(c, "stats")}


def phase_chaos() -> dict:
    """The reference's chaos catalog on the card: every runnable scenario
    on the device rung twice (repeat-equal digests) and once on native
    (equal to the device runs), the restart group at seeds 0-4 on both
    rungs, the three unported scenarios raising, then the soak's storm at
    cluster scale on both rungs with A, B0, B and C checked at inputs
    recorded inside it. Returns the kernels' launches in the phase."""
    import dataclasses
    import torch
    from karpenter_tpu_torch import catalog
    from karpenter_tpu_torch.faults import SCENARIOS
    from karpenter_tpu_torch.metrics import INTEGRITY_VERDICTS
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import consolidate, resident
    from karpenter_tpu_torch.ops import screen_k as sk
    from karpenter_tpu_torch.ops import solve_scan as ss, solver

    t_phase = time.perf_counter()
    os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)  # the default: armed
    ss.launches = ss.offer_launches = sk.launches = tk.launches = 0
    for name in CHAOS_SCENARIOS:
        sc = SCENARIOS[name]
        dev_sc = dataclasses.replace(sc, backend="device")
        nat_sc = dataclasses.replace(sc, backend="native")
        seeds = range(CRASH_AUDIT_SEEDS) if sc.restart else (0,)
        for seed in seeds:
            where = f"chaos {name} seed {seed}"
            runs = [run_scenario(dev_sc, seed, reset=(k == 0))
                    for k in range(2 if seed == 0 else 1)]
            nat = run_scenario(nat_sc, seed)
            injected = 1 if name == "device_loss" else 0
            for k, (rep, runner, _, delta) in enumerate(runs):
                check_clean(rep, runner, delta, f"{where} (device)",
                            fallbacks=injected)
                check_findings(name, runner.last_sim,
                               f"{where} device run {k + 1}")
            check_clean(nat[0], nat[1], nat[3], f"{where} (native)")
            check_findings(name, nat[1].last_sim, f"{where} native run")
            d = [digest(r[0]) for r in runs]
            check(len(set(d)) == 1, f"{where}: --repeat 2 diverged: {d}")
            if name == "device_loss":
                # the native rung makes no device dispatch for the
                # DeviceFault to hit: the end state must still agree
                check(nat[0].end_hash == d[0][0] and nat[0].faults_injected
                      == 0, f"{where}: native {digest(nat[0])} vs device "
                      f"{d[0]}")
            else:
                check(digest(nat[0]) == d[0],
                      f"{where}: native {digest(nat[0])} != device {d[0]}")
            log(f"[chaos] {name} seed {seed}: faults_injected "
                f"{d[0][2]}, end {d[0][0][:16]}, fingerprint "
                f"{d[0][1][:16]}; wall device "
                + " / ".join(f"{r[2]:.1f}" for r in runs)
                + f" ms, native {nat[2]:.1f} ms; sim {runs[0][0].sim_seconds:g}"
                f" s; stats {runs[0][0].stats}")
            if SCENARIOS[name].warmpath:
                st = runs[0][0].stats
                check(st["warm_divergences"] == 0,
                      f"{where}: the warm path diverged {st}")
    log(f"[check] chaos: {len(CHAOS_SCENARIOS)} scenarios on the device "
        f"rung, repeat-equal and equal to the native rung (device_loss: its "
        f"end state), the restart group at seeds 0-{CRASH_AUDIT_SEEDS - 1}, "
        f"the warm-path scenarios included, each with the reference's "
        f"watchdog findings (none); catalog wall "
        f"{time.perf_counter() - t_phase:.1f} s")

    # --- the storm at cluster scale, device then native ---
    types = catalog.generate_catalog()
    verdicts0 = dict(INTEGRITY_VERDICTS._values)
    watch = StormWatch(profile=True)
    storm_launches0 = (sk.launches, ss.offer_launches, ss.launches,
                       tk.launches)
    with Recorder(solver, "solve_scan", keep=2) as rec_b, \
            Recorder(consolidate, "screen_k", keep=2) as rec_a, \
            Recorder(tk, "tournament", keep=2) as rec_c:
        rep_d, run_d, wall_d, delta_d = run_scenario(
            storm_scenario("device", types, watch), 0)
        torch.cuda.synchronize()
    storm_launches = dict(zip(
        ("screen_k", "offer_argmin", "solve_scan", "tournament"),
        (b - a for a, b in zip(storm_launches0, (
            sk.launches, ss.offer_launches, ss.launches, tk.launches)))))
    flags = {k[0]: v - verdicts0.get(k, 0.0)
             for k, v in INTEGRITY_VERDICTS._values.items()
             if k[1] == "violation" and v != verdicts0.get(k, 0.0)}
    watch_n = StormWatch(profile=False)
    rep_n, run_n, wall_n, delta_n = run_scenario(
        storm_scenario("native", types, watch_n), 0)
    sim_d, sim_n = run_d.last_sim, run_n.last_sim
    log(f"[chaos] storm: the soak's rules over {sum(n for _, n in STORM_WAVES)} "
        f"grid pods in waves {STORM_WAVES} on {len(sim_d.cloud.types)} types: "
        f"{len(sim_d.store.nodes)} nodes, {rep_d.faults_injected} faults "
        f"injected, sim {rep_d.sim_seconds:g} s, converged "
        f"{rep_d.converged}; stats {rep_d.stats}; solver {sim_d.solver.stats}"
        f"; disruption {sim_d.disruption.stats}; integrity flags by check "
        f"{flags}; kernel launches {storm_launches}")
    check(rep_d.converged and rep_n.converged,
          f"storm: device {rep_d.summary()} vs native {rep_n.summary()}")
    split = storm_split(sim_d.store.events, sim_n.store.events)
    if split is None:
        check(digest(rep_d) == digest(rep_n),
              f"storm: device {digest(rep_d)} != native {digest(rep_n)}")
        check(controller_stats(sim_d) == controller_stats(sim_n),
              f"storm: controller stats differ: {controller_stats(sim_d)} "
              f"vs {controller_stats(sim_n)}")
        check(sim_d.solver.stats == sim_n.solver.stats
              and rep_d.violations == rep_n.violations,
              f"storm: device {rep_d.summary()} vs native {rep_n.summary()}")
        log(f"[check] storm device == native: state_hash "
            f"{rep_d.end_hash[:16]}, fault fingerprint "
            f"{rep_d.fault_fingerprint[:16]}, controller and solver stats")
    else:
        i, ev_d, ev_n = split
        log(f"[chaos] storm: the rungs part at event {i} of "
            f"{len(sim_d.store.events)}, a subset-search tie (ROADMAP §3): "
            f"device victims {ev_d[1]} vs native {ev_n[1]} ({ev_d[2]}, the "
            f"same replacements); every earlier event equal; ends device "
            f"{digest(rep_d)[0][:16]} / native {digest(rep_n)[0][:16]}")
    # the storm may reach the reference's over-capacity state (ROADMAP §3:
    # an existing node over capacity, flagged by the oracle on every rung
    # and by the runner's zero-false-positive contract, equal in the JAX
    # package); no other flag, fallback or degrade is allowed
    overcap = ["integrity violation(s) on a corruption-free run" in v
               for v in rep_d.violations + rep_n.violations]
    check(set(flags) <= {"capacity"} and all(overcap)
          and delta_d[:2] == (0, 0) and delta_d[3] == 0
          and delta_n[:2] == (0, 0)
          and not any(k in sim.disruption.stats for sim in (sim_d, sim_n)
                      for k in ("screen_errors", "optimizer_errors")),
          f"storm: flags {flags}, violations {rep_d.violations} / "
          f"{rep_n.violations}, counter deltas {delta_d} / {delta_n}")
    # the watchdog's findings, equal on both rungs and to the reference's
    # CPU run of the storm (STORM_REF_FINDINGS): the over-capacity flags
    # page integrity_breach, the armed optimizer's reject streaks
    # optimizer_divergence
    fd, fn = findings_of(sim_d), findings_of(sim_n)
    log(f"[watchdog] storm: findings device {fd or 'none'}, native "
        f"{fn or 'none'} (the reference's CPU run: {STORM_REF_FINDINGS})")
    check(fd == fn == STORM_REF_FINDINGS,
          f"storm: watchdog findings device {fd} vs native {fn}, the "
          f"reference's {STORM_REF_FINDINGS}")
    for name, n in storm_launches.items():
        check(n > 0, f"kernel {name} was not launched inside the storm")
    check_recorded(rec_b, rec_a, rec_c, "storm")
    med = {k: statistics.median(v) for k, v in watch.walls.items() if v}
    log(f"[time] storm: device run {wall_d:.1f} ms, native run {wall_n:.1f} "
        f"ms; device run reconciles: disruption {len(watch.walls['disruption'])}"
        f" (median {med.get('disruption', 0):.1f} ms, max "
        f"{max(watch.walls['disruption'], default=0):.1f}), provisioner "
        f"{len(watch.walls['provisioner'])} (median "
        f"{med.get('provisioner', 0):.1f} ms, max "
        f"{max(watch.walls['provisioner'], default=0):.1f}); native medians "
        + ", ".join(f"{k} {statistics.median(v):.1f} ms"
                    for k, v in watch_n.walls.items() if v))
    if watch.profiled is not None and watch.profiled[0] > 0:
        busy, wall, at = watch.profiled
        log(f"[time] one disruption reconcile under weather (storm, sim "
            f"{at:.1f} s, torch.profiler): device busy {busy:.3f} ms of "
            f"{wall:.1f} ms wall (idle share {1 - busy / wall:.5f})")
    else:
        log("[time] the storm's profiled disruption reconcile recorded no "
            "device events: idle share not measured")
    launches = {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches, "tournament": tk.launches}
    log(f"[chaos] phase wall {time.perf_counter() - t_phase:.1f} s; kernel "
        f"launches in the phase {launches}")
    return launches


# --- phase 4g: the fleet runner — the reference's `make fleet`
# (Makefile:66-70) on the card ---------------------------------------------

FLEET_RUNNER_TENANTS = 50   # `make fleet` runs fleet_smoke at 50 tenants


def fleet_findings(runner) -> dict:
    """(invariant, severity) -> count over the fleet watchdog and every
    shard's (tools/ref_findings.py counts the reference's the same way)."""
    out: dict = {}
    for wd in [runner.watchdog] + [s.sim.watchdog for s in runner.shards]:
        for f in wd.findings:
            out[(f.invariant, f.severity)] = out.get(
                (f.invariant, f.severity), 0) + 1
    return out


def fleet_run(name: str, want_findings=None,
              wire_weather: bool = False, tag: str = "fleet-runner",
              **kw) -> tuple:
    """(report, runner, wall ms) of one FleetRunner run on the card with
    the sequences restarted; its report must be ok and nothing may have
    degraded (device fallbacks, integrity flags, fault_fallback buckets
    unless `wire_weather`: a dead wire re-runs its bucket's tickets
    through their facades), and its watchdogs must fire the reference's
    CPU run's findings: none, or `want_findings`. Logs the run's B0 and B
    launches; the kernels' counters are never reset here."""
    from karpenter_tpu_torch.fleet import FleetRunner
    from karpenter_tpu_torch.ops import solve_scan as ss
    reset_sequences()
    c0 = counter_totals()
    b0, b = ss.offer_launches, ss.launches
    t0 = time.perf_counter()
    runner = FleetRunner(name, **kw)
    rep = runner.run()
    wall = (time.perf_counter() - t0) * 1e3
    delta = tuple(b - a for a, b in zip(c0, counter_totals()))
    what = {k: v for k, v in kw.items() if k != "service_factory"}
    check(rep.ok, f"fleet {name} {what}: {rep.summary()}")
    check(delta[:3] == (0, 0, 0) and (wire_weather or delta[3] == 0),
          f"fleet {name} {what}: fallbacks / optimizer fallbacks / "
          f"integrity flags / fault_fallbacks {delta}")
    want = want_findings or {}
    got = fleet_findings(runner)
    check(got == want, f"fleet {name} {what}: watchdog findings {got}, the "
          f"reference's CPU run's {want}")
    st = rep.stats
    fed = (f", wire buckets {st['federated_wire_buckets']:g}, local "
           f"buckets {st['federated_local_buckets']:g}, wire failures "
           f"{st['federated_wire_failures']:g}, fault_fallbacks "
           f"{delta[3]:g}" if "federated_wire_buckets" in st else "")
    log(f"[{tag}] {name} {what}: tenants {rep.tenants}, wall "
        f"{wall:.1f} ms, sim {rep.sim_seconds:g} s; solves_dispatched "
        f"{st['solves_dispatched']:g}, solve_batches "
        f"{st.get('solve_batches', 0):g}, batched_tickets "
        f"{st.get('batched_tickets', 0):g}, aggregate_solves_per_wall_sec "
        f"{st.get('aggregate_solves_per_wall_sec', 0):g}, "
        f"pipeline_overlap_ratio {st.get('pipeline_overlap_ratio', '-')}, "
        f"slo_alerts {st['slo_alerts']:g}, watchdog_findings "
        f"{st['watchdog_findings']:g}, faults_injected "
        f"{st['faults_injected']:g}{fed}; B0 / B launches "
        f"{ss.offer_launches - b0} / {ss.launches - b}; fleet hash "
        f"{rep.fleet_hash[:16]}, wire {rep.wire_fingerprint[:16] or '-'}")
    return rep, runner, wall


def phase_fleet_runner() -> dict:
    """The reference's fleet scenarios on the card: fleet_smoke at 50
    tenants serial and batched on the device rung (per-tenant hashes and
    fingerprints equal to each other and to a native-rung run),
    fleet_noisy_neighbor serial and batched (ok, its isolation verdict
    held, equal digests), federation_smoke in process, batched. Returns
    the kernels' launches in the phase."""
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import screen_k as sk, solve_scan as ss

    t_phase = time.perf_counter()
    launches = dict.fromkeys(("screen_k", "offer_argmin", "solve_scan",
                              "tournament"), 0)

    def run(name, **kw):
        sk.launches = tk.launches = ss.launches = ss.offer_launches = 0
        out = fleet_run(name, **kw)
        for k, n in (("screen_k", sk.launches), ("tournament", tk.launches),
                     ("offer_argmin", ss.offer_launches),
                     ("solve_scan", ss.launches)):
            launches[k] += n
        return out

    smoke = [run("fleet_smoke", tenants=FLEET_RUNNER_TENANTS,
                 backend=backend, batch=batch)[0]
             for backend, batch in (("device", False), ("device", True),
                                    ("native", False))]
    for rep, what in zip(smoke[1:], ("batched device", "native")):
        check(rep.tenant_hashes == smoke[0].tenant_hashes
              and rep.tenant_fingerprints == smoke[0].tenant_fingerprints,
              f"fleet_smoke: {what} per-tenant digests != serial device")
    check(smoke[1].stats["solve_batches"] > 0,
          "fleet_smoke batched: no bucket was dispatched")
    noisy = [run("fleet_noisy_neighbor", backend="device", batch=batch)[0]
             for batch in (False, True)]
    for rep in noisy:
        check(rep.stats["victim_p99_storm_ms"]
              < 2 * rep.stats["victim_p99_quiet_ms"]
              and rep.stats["noisy_throttled"] > 0
              and rep.stats["noisy_burn_alerts"] > 0,
              f"fleet_noisy_neighbor: isolation verdict failed {rep.stats}")
        # the provenance verdict: a throttled pod of the noisy tenant is
        # explained (its throttle trail, then the solve that placed it)
        check(rep.stats["noisy_throttled_pod_explained"] == 1.0
              and all(r["throttles"] > 0 for r in rep.explain.values()),
              f"fleet_noisy_neighbor: provenance verdict failed "
              f"{rep.stats}, explain {rep.explain}")
    check(noisy[0].explain == noisy[1].explain,
          "fleet_noisy_neighbor: batched explain records != serial")
    (tenant, rec), = list(noisy[0].explain.items())[:1]
    log(f"[fleet-runner] noisy neighbor provenance: "
        f"noisy_throttled_pod_explained "
        f"{noisy[0].stats['noisy_throttled_pod_explained']:g}; {tenant}'s "
        f"{rec['pod']}: throttled {rec['throttles']}x, then "
        f"{rec['outcome']} (binding constraint "
        f"{rec.get('binding_constraint')})")
    check(noisy[0].tenant_hashes == noisy[1].tenant_hashes
          and noisy[0].tenant_fingerprints == noisy[1].tenant_fingerprints,
          "fleet_noisy_neighbor: batched per-tenant digests != serial")
    log(f"[fleet-runner] noisy neighbor: victim p99 quiet / storm "
        f"{noisy[0].stats['victim_p99_quiet_ms']} / "
        f"{noisy[0].stats['victim_p99_storm_ms']} ms (virtual), noisy "
        f"throttled {noisy[0].stats['noisy_throttled']:g}, burn alerts "
        f"{noisy[0].stats['noisy_burn_alerts']:g}")
    fed = run("federation_smoke", backend="device", batch=True)[0]
    check(fed.stats["solve_batches"] > 0,
          "federation_smoke: no bucket was dispatched")
    check(launches["offer_argmin"] > 0 and launches["solve_scan"] > 0,
          f"the fleet runner launched no batched solve: {launches}")
    log(f"[check] fleet runner: fleet_smoke x{FLEET_RUNNER_TENANTS} serial "
        f"== batched == native per tenant, fleet_noisy_neighbor isolated "
        f"and serial == batched, federation_smoke in process ok; kernel "
        f"launches {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# --- phase 4i: the warm path, the watchdog and provenance — the reference's
# c8 cell (bench.py:488-570) on the card -------------------------------------

WARM_STANDING = 2_000   # c8's standing pods, one to a node (self-anti-affinity)
WARM_BURSTS = 24        # c8 runs 5 warm bursts; 24 carry warm_integrity_tick
#                         past the integrity audit cadence (16) in the window
WARM_COLD = 3           # forced-cold bursts
WARM_BURST = 32
WARM_AUDIT_EVERY = 64   # c8's auditor cadence
WARM_EVALS = 5          # forced watchdog evaluations timed on the standing fleet


class WarmRun:
    """One run of c8's sequence on one rung of the port's make_sim with the
    warm path armed: the standing fleet brought up by the engine, one
    prime burst (cold: it commits the ledger), WARM_BURSTS warm bursts and
    WARM_COLD forced-cold bursts, each through one provisioner reconcile,
    then the auditor drained."""

    def __init__(self, backend: str):
        from karpenter_tpu_torch import sim as S
        from karpenter_tpu_torch.cloud.fake import FakeCloudConfig
        reset_sequences()
        self.backend = backend
        self.sim = S.make_sim(backend=backend, warmpath=True,
                              warm_audit_every=WARM_AUDIT_EVERY,
                              cloud_config=FakeCloudConfig(**OP_CLOUD))
        self.tick_ms = time_calls(self.sim.engine, "tick")
        self.watchdog_ms = time_calls(self.sim.watchdog, "tick")
        # resident audits fired from warm_integrity_tick: the solver's
        # audit, counted while a warm tick runs
        solver = self.sim.solver
        real_tick, real_audit = (solver.warm_integrity_tick,
                                 solver._audit_resident_state)
        self.warm_ticks, self.warm_audits, inside = 0, [], [False]

        def warm_tick():
            self.warm_ticks += 1
            inside[0] = True
            try:
                return real_tick()
            finally:
                inside[0] = False

        def audit(full: bool = False):
            out = real_audit(full)
            if inside[0]:
                self.warm_audits.append(len(out))
            return out
        solver.warm_integrity_tick = warm_tick
        solver._audit_resident_state = audit

    def _burst(self, tag: str) -> None:
        from karpenter_tpu_torch import models
        for i in range(WARM_BURST):
            self.sim.store.add_pod(models.Pod(
                name=f"burst-{tag}-{i}", requests=models.Resources.parse(
                    {"cpu": "100m", "memory": "128Mi"})))

    def _reconcile(self) -> float:
        t0 = time.perf_counter()
        self.sim.provisioner.reconcile(self.sim.clock.now())
        return (time.perf_counter() - t0) * 1e3

    def drive(self, launches_at=None) -> dict:
        """launches_at(): the kernels' launch counts, read just before the
        prime burst and just after the final audit (the cold passes and
        the auditor's replays)."""
        from karpenter_tpu_torch import models
        from karpenter_tpu_torch.integrity import INTEGRITY
        s, out = self.sim, {}
        t0 = time.perf_counter()
        for i in range(WARM_STANDING):
            s.store.add_pod(models.Pod(
                name=f"standing-{i}", labels={"app": "standing"},
                requests=models.Resources.parse({"cpu": "500m",
                                                 "memory": "512Mi"}),
                affinity_terms=[models.PodAffinityTerm(
                    topology_key="kubernetes.io/hostname",
                    label_selector={"app": "standing"}, anti=True)]))
        ok = s.engine.run_until(
            lambda: all(p.node_name for p in s.store.pods.values()),
            timeout=900.0, step=1.0)
        check(ok, f"warm {self.backend}: the standing fleet did not settle")
        out["bringup_s"] = time.perf_counter() - t0
        out["nodes"] = len(s.store.nodeclaims)
        n0 = launches_at() if launches_at else None
        self._burst("prime")
        out["prime_ms"] = self._reconcile()
        totals0 = INTEGRITY.snapshot()["totals"]
        out["warm_ms"] = []
        for rep in range(WARM_BURSTS):
            self._burst(f"warm{rep}")
            out["warm_ms"].append(self._reconcile())
        totals1 = INTEGRITY.snapshot()["totals"]
        out["window_audits"] = {k: totals1.get(k, 0) - totals0.get(k, 0)
                                for k in ("audits", "audit_rows",
                                          "audit_corrupt", "warm_checks",
                                          "warm_violations")}
        out["cold_ms"] = []
        for rep in range(WARM_COLD):
            self._burst(f"cold{rep}")
            s.warmpath.force_cold("bench-forced")
            out["cold_ms"].append(self._reconcile())
        out["divergences"] = s.warmpath.auditor.audit()
        if launches_at:
            n1 = launches_at()
            out["cold_launches"] = {k: n1[k] - n0[k] for k in n1}
        # the watchdog's share of the engine's ticks (the bring-up's),
        # then its full evaluation on the standing fleet, forced
        out["watchdog_tick"] = (self.watchdog_ms[0], self.watchdog_ms[1],
                                self.tick_ms[0])
        wd = s.watchdog
        t0 = time.perf_counter()
        for _ in range(WARM_EVALS):
            wd.tick(force=True)
        out["eval_ms"] = (time.perf_counter() - t0) * 1e3 / WARM_EVALS
        out["wall_s"] = (out["bringup_s"] + (sum(out["warm_ms"])
                         + sum(out["cold_ms"]) + out["prime_ms"]) / 1e3)
        return out


def phase_warm() -> dict:
    """Bench c8's steady-state admission on the card: the port's
    make_sim(backend="device", warmpath=True, warm_audit_every=64) over a
    standing fleet of WARM_STANDING nodes, one prime burst, WARM_BURSTS
    warm bursts and WARM_COLD forced-cold bursts of 32 pods, the auditor
    drained; then the same on the native rung. Device == native (state
    hash, warm-path and watchdog stats, the explain record of a cold-burst
    pod), zero divergence, at least one resident audit fired from
    warm_integrity_tick, B0 and B launched in the cold passes and equal to
    their plain versions at inputs recorded there, no watchdog finding,
    fallback or integrity flag. Returns the kernels' launches in the
    phase."""
    import torch
    from karpenter_tpu_torch import sim as S
    from karpenter_tpu_torch.obs.explain import RECORDER
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import screen_k as sk
    from karpenter_tpu_torch.ops import solve_scan as ss, solver

    t_phase = time.perf_counter()
    os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)  # the default: armed
    explained_pod = f"default/burst-cold{WARM_COLD - 1}-0"

    def counts():
        return {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches, "tournament": tk.launches}
    ss.launches = ss.offer_launches = sk.launches = tk.launches = 0
    runs = {}
    for backend in ("device", "native"):
        c0 = counter_totals()
        run = WarmRun(backend)
        if backend == "device":
            with Recorder(solver, "solve_scan", keep=2) as rec_b:
                out = run.drive(counts)
                torch.cuda.synchronize()
            launches = counts()
        else:
            out = run.drive()
        out["delta"] = tuple(b - a for a, b in zip(c0, counter_totals()))
        out["explained"] = copy.deepcopy(RECORDER.explain(explained_pod))
        runs[backend] = (run, out)
        sim = run.sim
        wp = sim.warmpath
        log(f"[warm] c8 on the {backend} rung: {out['nodes']} standing "
            f"nodes up in {out['bringup_s']:.1f} s; warm path {wp.stats}, "
            f"hit rate {wp.hit_rate:.4f}, auditor {wp.auditor.stats}; "
            f"warm_integrity_tick {run.warm_ticks} ticks, resident audits "
            f"from them {len(run.warm_audits)} (corrupt entries "
            f"{sum(run.warm_audits)}); integrity meter over the warm window "
            f"{out['window_audits']}; watchdog {sim.watchdog.stats}; solver "
            f"{sim.solver.stats}; counter deltas {out['delta']}")
        check(out["nodes"] >= WARM_STANDING,
              f"warm {backend}: {out['nodes']} standing nodes")
        check(out["divergences"] == [] and wp.stats["divergences"] == 0,
              f"warm {backend}: the auditor diverged {out['divergences']} "
              f"{wp.stats}")
        check(wp.stats["warm_reconciles"] >= WARM_BURSTS,
              f"warm {backend}: warm_reconciles {wp.stats}")
        check(wp.auditor.stats["audits"] >= 1,
              f"warm {backend}: the auditor never replayed the window")
        check(out["delta"] == (0, 0, 0, 0)
              and sim.solver.stats["device_fallbacks"] == 0
              and sim.solver.stats["integrity_violations"] == 0
              and out["window_audits"]["warm_violations"] == 0,
              f"warm {backend}: fallbacks / optimizer fallbacks / integrity "
              f"flags / fault_fallbacks {out['delta']}, solver "
              f"{sim.solver.stats}, window {out['window_audits']}")
        check(findings_of(sim) == {},
              f"warm {backend}: watchdog findings {findings_of(sim)}")
    (run_d, out_d), (run_n, out_n) = runs["device"], runs["native"]
    sim_d, sim_n = run_d.sim, run_n.sim
    check(len(run_d.warm_audits) >= 1 and sum(run_d.warm_audits) == 0
          and out_d["window_audits"]["audits"] >= 1
          and out_d["window_audits"]["audit_rows"] > 0,
          f"warm device: no resident audit fired from warm_integrity_tick "
          f"({run_d.warm_audits}, window {out_d['window_audits']})")
    cold = out_d["cold_launches"]
    check(cold["offer_argmin"] > 0 and cold["solve_scan"] > 0,
          f"warm device: B0 / B not launched in the cold passes: {cold}")
    check_scan_calls(rec_b, "warm", ("prime burst's cold pass",
                                     "last cold pass or audit replay"))
    del rec_b
    hd, hn = S.state_hash(sim_d), S.state_hash(sim_n)
    check(hd == hn, f"warm: state_hash device {hd} != native {hn}")
    check(sim_d.warmpath.stats == sim_n.warmpath.stats
          and sim_d.warmpath.auditor.stats == sim_n.warmpath.auditor.stats,
          f"warm: warm-path stats device {sim_d.warmpath.stats} != native "
          f"{sim_n.warmpath.stats}")
    check(sim_d.watchdog.stats == sim_n.watchdog.stats,
          f"warm: watchdog stats device {sim_d.watchdog.stats} != native "
          f"{sim_n.watchdog.stats}")
    rd, rn = out_d["explained"], out_n["explained"]
    check(rd is not None and rd == rn,
          f"warm: explain of {explained_pod} device {rd} != native {rn}")
    log(f"[check] warm device == native: state_hash {hd[:16]}, warm-path, "
        f"auditor and watchdog stats; 0 divergences; explain "
        f"{explained_pod}: {rd['outcome']}, chosen {rd.get('chosen')}, "
        f"runner-up {rd.get('runner_up')}, binding "
        f"{rd['binding_constraint']}; B0 / B launches in the cold passes "
        f"and audit replays {cold['offer_argmin']} / {cold['solve_scan']}; "
        f"kernel launches in the phase's device run {launches}")
    for backend, (run, out) in runs.items():
        wp50, cp50 = (statistics.median(out["warm_ms"]),
                      statistics.median(out["cold_ms"]))
        wdm, wdn, tkm = out["watchdog_tick"]
        log(f"[time] warm {backend}: warm admit p50 {wp50:.3f} ms (max "
            f"{max(out['warm_ms']):.3f}), cold reconcile p50 {cp50:.1f} ms "
            f"({', '.join(f'{c:.1f}' for c in out['cold_ms'])}), ratio "
            f"{cp50 / wp50:.1f}x; prime {out['prime_ms']:.1f} ms; bring-up "
            f"{out['bringup_s']:.1f} s; the watchdog's tick {wdm:.3f} ms of "
            f"{tkm:.1f} ms of the bring-up's engine tick wall (share "
            f"{wdm / max(tkm, 1e-9):.6f}, {wdn} ticks); one forced full "
            f"evaluation over {out['nodes']} claims {out['eval_ms']:.3f} ms")
    log(f"[warm] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- phase 4j: the soak — bench c13's open-loop traffic plane
# (bench.py:931-967) on the card --------------------------------------------

SOAK_SCENARIOS = ("soak_smoke", "soak_overload")
C13_SCENARIO = "soak_overload"   # bench c13: SoakRunner("soak_overload", seed=0)
# the watchdog findings (invariant, severity) -> count of the reference's
# own CPU run of each scenario at seed 0, the fleet watchdog's and every
# shard's together (tools/ref_findings.py soak karpenter_tpu device, and
# native): none. tests/test_torch_loadgen.py holds the port's equal to them
SOAK_REF_FINDINGS = {"soak_smoke": {}, "soak_overload": {}}


def detached(x):
    """x with every tensor in it cloned (tuples, lists and dicts walked):
    a kept copy of a call's inputs pins none of the caller's buffers."""
    import torch
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(detached(v) for v in x)
    if isinstance(x, dict):
        return {k: detached(v) for k, v in x.items()}
    return x


class Capture(Recorder):
    """A Recorder keeping one detached copy of the inputs of the call
    `size(args, kwargs)` ranks largest (the first of equals): a run that
    keeps a buffer it dropped alive would look to the watchdog like device
    memory outliving its owner (devicemem_leak)."""

    def __init__(self, module, name: str, size):
        super().__init__(module, name)
        self.size = size
        self.best = None

    def __enter__(self):
        def shim(*args, **kwargs):
            self.n += 1
            s = self.size(args, kwargs)
            if self.best is None or s > self.best:
                self.best = s
                self.calls = [(detached(args), detached(kwargs))]
            return self.real(*args, **kwargs)
        setattr(self.module, self.name, shim)
        return self


def findings_of_soak(runner) -> dict:
    """(invariant, severity) -> count over the fleet watchdog and every
    shard's watchdog of one soak run."""
    out: dict = {}
    for wd in [runner.watchdog] + [s.sim.watchdog for s in runner.shards]:
        check(wd is not None and wd.armed, "a soak runs without a watchdog")
        for f in wd.findings:
            k = (f.invariant, f.severity)
            out[k] = out.get(k, 0) + 1
    return out


def soak_digest(rep) -> tuple:
    return rep.soak_hash, rep.fault_fingerprint, rep.load_fingerprint


def soak_run(name: str, backend: str) -> tuple:
    """(report, runner, wall ms) of one SoakRunner run on the card with
    the sequences restarted: ok, nothing degraded, the reference's
    watchdog findings."""
    from karpenter_tpu_torch.loadgen import SoakRunner
    reset_sequences()
    c0 = counter_totals()
    t0 = time.perf_counter()
    runner = SoakRunner(name, seed=SEED, backend=backend)
    rep = runner.run()
    wall = (time.perf_counter() - t0) * 1e3
    delta = tuple(b - a for a, b in zip(c0, counter_totals()))
    where = f"soak {name} ({backend})"
    check(rep.ok, f"{where}: {rep.summary()}")
    check(delta == (0, 0, 0, 0), f"{where}: fallbacks / optimizer "
          f"fallbacks / integrity flags / fault_fallbacks {delta}")
    got = findings_of_soak(runner)
    want = SOAK_REF_FINDINGS[name]
    check(got == want, f"{where}: watchdog findings {got}, the reference's "
          f"{want}")
    return rep, runner, wall


def c13_keys(rep, wall_ms: float) -> dict:
    """bench c13's keys (bench.py:948-967) of one soak report."""
    st = rep.stats
    wall_s = wall_ms / 1e3
    return {"c13_tenants": rep.tenants,
            "c13_offered_pods": int(st["offered_pods"]),
            "c13_admitted_pods": int(st["admitted_pods"]),
            "c13_shed_pods": int(st["shed_pods"]),
            "c13_shed_frac": st["shed_frac"],
            "c13_max_waiting_depth": int(st["max_waiting_depth"]),
            "c13_overload_findings": int(st["overload_findings"]),
            "c13_slo_alerts": int(st["slo_alerts"]),
            "c13_soak_sim_seconds": round(rep.sim_seconds, 1),
            "c13_soak_wall_ms": round(wall_ms, 1),
            "c13_arrivals_per_sec": round(
                st["offered_pods"] / max(wall_s, 1e-9), 1),
            "c13_admitted_arrivals_per_sec": round(
                st["admitted_pods"] / max(wall_s, 1e-9), 1)}


def phase_soak() -> tuple:
    """soak_smoke and soak_overload at seed 0 through SoakRunner: twice on
    the device rung (one SolverService for every tenant, batched: a
    bucket is one launch of batched B0 and B; each shard's screen runs A)
    and once on native. Repeat-equal digests, device == native, every
    report ok with the reference's watchdog findings, soak_overload's own
    verdicts; batched B0/B, A (and C when a subset search ran) against
    their plain versions at inputs captured in the first device runs.
    Returns (launches in the phase, the device run's soak_smoke digests)."""
    import torch
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import consolidate, resident
    from karpenter_tpu_torch.ops import screen_k as sk
    from karpenter_tpu_torch.ops import solve_scan as ss, solver

    t_phase = time.perf_counter()
    os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)  # the default: armed
    ss.launches = ss.offer_launches = sk.launches = tk.launches = 0
    patches0 = resident.launches
    digests = {}
    with Capture(solver, "solve_scan_batched",
                 lambda a, kw: (a[3].shape[0], a[3].shape[1])) as cap_b, \
            Capture(consolidate, "screen_k",
                    lambda a, kw: (a[0].shape[0], a[1].shape[0])) as cap_a, \
            Capture(tk, "tournament",
                    lambda a, kw: tuple(a[4].shape)) as cap_c:
        for name in SOAK_SCENARIOS:
            dev_runs = [soak_run(name, "device") for _ in range(2)]
            nat = soak_run(name, "native")
            d = [soak_digest(r[0]) for r in dev_runs]
            check(d[0] == d[1], f"soak {name}: device --repeat 2 diverged: "
                  f"{d}")
            check(soak_digest(nat[0]) == d[0],
                  f"soak {name}: native {soak_digest(nat[0])} != device "
                  f"{d[0]}")
            rep = dev_runs[0][0]
            check(nat[0].stats == rep.stats
                  and nat[0].tenant_hashes == rep.tenant_hashes,
                  f"soak {name}: native stats {nat[0].stats} != device "
                  f"{rep.stats}")
            if name == "soak_overload":
                st = rep.stats
                budget = dev_runs[0][1].admission.shed_depth
                check(st["shed_pods"] > 0
                      and st["max_waiting_depth"] <= budget + 8
                      and st["overload_findings"] == 0
                      and st["admission_burn_alerts"] >= 1,
                      f"soak {name}: shed {st['shed_pods']:g}, depth "
                      f"{st['max_waiting_depth']:g} (budget {budget} + 8), "
                      f"overload findings {st['overload_findings']:g}, "
                      f"admission burn alerts "
                      f"{st.get('admission_burn_alerts')}")
            digests[name] = d[0]
            svc = dev_runs[0][1].service
            log(f"[soak] {name} seed {SEED}: ok; soak_hash {d[0][0][:16]}, "
                f"fault {d[0][1][:16]}, load {d[0][2][:16]} (device x2 == "
                f"native); solves dispatched {svc.stats['dispatched']:g}, "
                f"batches {svc.stats['batches']:g}, batched tickets "
                f"{svc.stats['batched_tickets']:g}, max batch "
                f"{svc.stats['max_batch_size']:g}; watchdog findings none "
                f"(the reference's CPU run: none)")
            for rung, (r, _, wall) in (("device", dev_runs[0]),
                                       ("device repeat", dev_runs[1]),
                                       ("native", nat)):
                log(f"[soak] {name} {rung}: "
                    + json.dumps(c13_keys(r, wall)))
    # B0/B launches split into the batched buckets' (one each) and the
    # serial solves'; the row scatter's read here too, before the profiled
    # run below
    launches = {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches, "tournament": tk.launches,
                "batched_buckets": cap_b.n,
                "resident_patch": resident.launches - patches0}
    # the card's share of one more c13 device run, under torch.profiler
    box = []
    ev = device_kernel_us(lambda: box.append(soak_run(C13_SCENARIO,
                                                      "device")))
    busy = sum(us for us, _ in ev.values()) / 1e3
    wall = box[0][2]
    check(soak_digest(box[0][0]) == digests[C13_SCENARIO],
          f"soak {C13_SCENARIO}: the profiled run's digests differ")
    if ev:
        log(f"[time] soak {C13_SCENARIO} device run under torch.profiler: "
            f"device busy {busy:.3f} ms of {wall:.1f} ms wall (idle share "
            f"{1 - busy / wall:.5f}), {sum(n for _, n in ev.values())} "
            f"device kernels")
    else:
        log("[time] the profiled soak recorded no device events: idle "
            "share not measured")
    log(f"[soak] kernel launches in the phase {launches}: B0/B in batched "
        f"buckets {cap_b.n}, in serial solves "
        f"{launches['solve_scan'] - cap_b.n}; screens {cap_a.n}, subset "
        f"searches {cap_c.n}")
    for k in ("screen_k", "offer_argmin", "solve_scan"):
        check(launches[k] > 0, f"kernel {k} was not launched in the soak")
    (bargs, bkw), = cap_b.calls
    check_batched(ss, bargs, bkw, "soak bucket")
    (aargs, akw), = cap_a.calls
    k_got = sk.screen_k_cuda(*aargs, **akw)
    torch.cuda.synchronize()
    k_want = sk.screen_k_plain(*aargs, **akw)
    err_a = float((k_got - k_want).abs().max()) if k_got.numel() else 0.0
    check(err_a == 0.0, f"screen_k != plain at the soak's screen: {err_a}")
    err_c = 0.0
    if cap_c.calls:
        (cargs, _), = cap_c.calls
        err_c = check_tournament(tk, cargs, "soak subset search")
    log(f"[check] soak: batched offer_argmin and solve_scan == plain (atol "
        f"0) at its largest bucket (Bp={bargs[3].shape[0]}, "
        f"Gp={bargs[3].shape[1]}); screen_k == plain (atol 0) at its "
        f"largest screen (N={aargs[0].shape[0]} G={aargs[1].shape[0]}); "
        + ("tournament == plain at its largest subset search"
           if cap_c.calls else "no subset search ran (no consolidation "
           "candidates: the soak's pods are never deleted), so no C")
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, digests, max(err_a, err_c)


# --- phase 4k: the operator shell — `python -m karpenter_tpu_torch.main`'s
# build_operator on the asyncio Runtime, under tests/test_runtime_soak.py's
# churn, on the card --------------------------------------------------------

# the reference's runtime soak adds 18 waves of 8 pods; scaled to 32 waves of
# 128 (4,096 pods) on the 810-type catalog
SHELL_WAVES = 32
SHELL_WAVE_PODS = 128
SHELL_WAVE_SLEEP = 0.35      # real seconds between waves (the reference's)
SHELL_DEADLINE_S = 300.0     # real seconds to converge after the churn
SHELL_CLOCK_SCALE = 600.0    # the reference's FastClock: x600 wall time
SHELL_CLOUD = dict(node_ready_delay=30.0, register_delay=10.0,
                   create_fleet_rate=0.05, create_fleet_burst=4,
                   describe_rate=0.2, describe_burst=40,
                   terminate_rate=0.1, terminate_burst=8)
SHELL_MAIN_ARGS = ("--soak", "--soak-scenario", "soak_smoke",
                   "--solver-backend", "device")
SHELL_MAIN_TIMEOUT = 300


def fast_clock():
    """The reference's FastClock (tests/test_runtime_soak.py): the wall
    clock x SHELL_CLOCK_SCALE from a fixed base, so boot delays, TTLs and
    batcher windows elapse in scaled time while asyncio stays concurrent."""
    from karpenter_tpu_torch.utils.clock import RealClock

    class FastClock(RealClock):
        def __init__(self):
            self._t0 = time.monotonic()
            self._base = 1_000_000.0

        def now(self) -> float:
            return (self._base
                    + (time.monotonic() - self._t0) * SHELL_CLOCK_SCALE)
    return FastClock()


class Turbo:
    """The reference runtime soak's requeue clamp: 50 ms real, so every
    controller runs many cycles within the window."""

    def __init__(self, inner):
        self.inner = inner
        self.name = getattr(inner, "name", type(inner).__name__)

    def reconcile(self, now: float) -> float:
        self.inner.reconcile(now)
        return 0.05


async def http_get(port: int, path: str) -> bytes:
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    out = await reader.read()
    writer.close()
    return out


def phase_shell(soak_digests: dict) -> dict:
    """build_operator(Options(solver_backend="device", leader_elect=True,
    ...)) over FakeCloud(generate_catalog()) on a fast real clock, its
    Runtime started under the reference runtime soak's churn scaled to
    4,096 pods: converged, no crash, coalesced terminations and describes,
    /metrics and /readyz served, the lease released on stop(), B0 and B
    launched and equal to their plain versions at a captured input. Then
    `python -m karpenter_tpu_torch.main --soak` must print phase 4j's
    soak_smoke digests. Returns the kernels' launches in the phase."""
    import asyncio
    import logging
    import random
    import socket
    import tempfile
    from karpenter_tpu_torch import catalog, integrity, models
    from karpenter_tpu_torch.cloud.fake import FakeCloud, FakeCloudConfig
    from karpenter_tpu_torch.main import build_operator
    from karpenter_tpu_torch.metrics import INTEGRITY_VERDICTS
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.nodeclaim import Phase
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import screen_k as sk, solve_scan as ss
    from karpenter_tpu_torch.ops import solver
    from karpenter_tpu_torch.utils.leaderelection import FileLeaseBackend
    from karpenter_tpu_torch.utils.options import Options

    t_phase = time.perf_counter()
    reset_sequences()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shell-", dir=root)
    lease = os.path.join(tmp, "leader.lease")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    clock = fast_clock()
    cloud = FakeCloud(catalog.generate_catalog(), clock=clock,
                      config=FakeCloudConfig(**SHELL_CLOUD))
    opts = Options(solver_backend="device", leader_elect=True,
                   leader_elect_lease_file=lease,
                   leader_elect_identity="chip-smoke",
                   intent_journal_file=os.path.join(tmp, "intents.wal"),
                   interruption_queue="soak-q", metrics_port=port)
    runtime, store, _ = build_operator(opts, cloud=cloud)
    check(runtime.clock is clock and runtime.elector is not None,
          "build_operator: one clock everywhere and an elector")
    bcloud = next(c for c in runtime.controllers
                  if getattr(c, "name", "") == "provisioner").cloud
    runtime.controllers = [Turbo(c) for c in runtime.controllers]
    served = {}

    async def churn():
        rng = random.Random(42)
        n = 0
        for wave in range(SHELL_WAVES):
            for _ in range(SHELL_WAVE_PODS):
                store.add_pod(models.Pod(
                    name=f"s{n}", requests=models.Resources.parse(
                        {"cpu": ["250m", "1", "2"][n % 3],
                         "memory": "1Gi"})))
                n += 1
            if wave % 2 == 0:
                running = [i for i in cloud.instances.values()
                           if i.state == "running"]
                if running:  # chaos kill mid-flight
                    cloud.kill_instance(rng.choice(running).id,
                                        reason="chaos")
            bound = [p for p in store.pods.values() if p.node_name]
            for p in rng.sample(bound, min(2, len(bound))):
                store.delete_pod(p.namespace, p.name)
            await asyncio.sleep(SHELL_WAVE_SLEEP)
        return n

    def converged():
        return store.pods and all(p.node_name for p in store.pods.values())

    async def drive():
        run = asyncio.create_task(runtime.start())
        t0 = time.perf_counter()
        added = await churn()
        t1 = time.perf_counter()
        for path in ("/metrics", "/readyz"):
            served[path] = await http_get(port, path)
        deadline = time.monotonic() + SHELL_DEADLINE_S
        while time.monotonic() < deadline and not converged():
            await asyncio.sleep(0.25)
        ok = converged()
        t2 = time.perf_counter()
        runtime.stop()
        await asyncio.wait_for(run, timeout=60)
        return ok, added, t1 - t0, t2 - t1

    # every oracle flag of the run, (check, the flagged existing node's
    # claim name): the over-capacity state's are consolidation replacements
    # (ROADMAP §3), as tests/test_torch_sim_overcap.py holds on the CPU
    oracle_flags = []
    verify = integrity.verify_result

    def spy(cat, enc, result):
        v = verify(cat, enc, result)
        oracle_flags.extend(
            (x.check, result.nodes[int(x.detail.split()[1])].existing_name
             if x.check == "capacity" else None) for x in v)
        return v

    ss.launches = ss.offer_launches = sk.launches = tk.launches = 0
    c0 = counter_totals()
    verdicts0 = dict(INTEGRITY_VERDICTS._values)
    # the over-capacity state's flags (below) each log a warning; their
    # count is logged once instead
    ilog = logging.getLogger("karpenter_tpu_torch.integrity")
    level = ilog.level
    ilog.setLevel(logging.ERROR)
    integrity.verify_result = spy
    try:
        with Capture(solver, "solve_scan",
                     lambda a, kw: (a[3].shape[0],
                                    kw.get("n_max", 0))) as cap_b:
            ok, added, churn_s, settle_s = asyncio.run(drive())
    finally:
        integrity.verify_result = verify
        ilog.setLevel(level)
    launches = {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches, "tournament": tk.launches}
    delta = tuple(b - a for a, b in zip(c0, counter_totals()))
    flags = {k[0]: v - verdicts0.get(k, 0.0)
             for k, v in INTEGRITY_VERDICTS._values.items()
             if k[1] == "violation" and v != verdicts0.get(k, 0.0)}
    unbound = sum(1 for p in store.pods.values() if not p.node_name)
    sim_s = clock.now() - 1_000_000.0
    replacements = {name for kind, _, _, note in store.events
                    if kind == "disruption"
                    and note.startswith("replacements: ")
                    for name in ast.literal_eval(note.split(": ", 1)[1])}
    flagged = {name for _, name in oracle_flags}
    log(f"[shell] build_operator on the device rung, {len(cloud.types)} "
        f"types: {added} pods added in {SHELL_WAVES} waves ({churn_s:.1f} s "
        f"of churn), converged {ok} {settle_s:.1f} s after it ({unbound} "
        f"unbound of {len(store.pods)}); {sim_s:.0f} scaled sim s; nodes "
        f"{len(store.nodes)}, claims {len(store.nodeclaims)}; crash counts "
        f"{runtime.crash_counts}, backoff counts {runtime.backoff_counts}; "
        f"batcher {bcloud.stats}; counter deltas {delta}; integrity flags by "
        f"check {flags}; oracle flags {len(oracle_flags)} on "
        f"{len(flagged)} nodes, of {len(replacements)} consolidation "
        f"replacements; kernel launches {launches}")
    check(added == SHELL_WAVES * SHELL_WAVE_PODS, f"shell: {added} pods added")
    check(ok, f"shell: not converged within {SHELL_DEADLINE_S:g} s of the "
          f"churn: {unbound} pods unbound")
    check(runtime.crash_counts == {}, f"shell: controller crashes "
          f"{runtime.crash_counts}")
    # the shell may reach the reference's over-capacity state (ROADMAP §3:
    # a consolidation replacement over capacity, flagged by the oracle, the
    # device answer shipped metered); no other flag, fallback or degrade
    check(delta[0] == 0 and delta[1] == 0 and delta[3] == 0
          and set(flags) <= {"capacity"},
          f"shell: fallbacks / optimizer fallbacks / integrity flags / "
          f"fault_fallbacks {delta}, flags by check {flags}")
    check({c for c, _ in oracle_flags} <= {"capacity"}
          and None not in flagged and flagged <= replacements,
          f"shell: oracle flags on nodes that are not consolidation "
          f"replacements: {sorted(map(str, flagged - replacements))}, "
          f"checks {sorted({c for c, _ in oracle_flags})}")
    check(bcloud.stats["terminate_batches"] >= 1
          and bcloud.stats["describe_coalesced"] >= 1,
          f"shell: no coalesced termination batch or describe "
          f"{bcloud.stats}")
    indexed = {k for g in store._pending_groups.values() for k in g}
    truth = {k for k, p in store.pods.items()
             if p.phase == "Pending" and p.node_name is None
             and L.NOMINATED not in p.annotations}
    check(indexed == truth, "shell: the pending-group index drifted")
    iids = {i.id for i in cloud.instances.values() if i.state == "running"}
    for c in store.nodeclaims.values():
        check(c.phase not in (Phase.FAILED, Phase.TERMINATED),
              f"shell: claim residue {c.name} {c.phase}")
        if not c.is_deleting() and c.provider_id:
            check(c.provider_id.rsplit("/", 1)[-1] in iids,
                  f"shell: claim {c.name} without a running instance")
    head = {p: served[p].split(b"\r\n", 1)[0].decode() for p in served}
    check(head["/metrics"] == "HTTP/1.1 200 OK"
          and b"karpenter_tpu_cloudprovider_api_duration_seconds"
          in served["/metrics"],
          f"shell: /metrics answered {head['/metrics']}")
    ready = json.loads(served["/readyz"].split(b"\r\n\r\n", 1)[1])
    check(head["/readyz"] in ("HTTP/1.1 200 OK",
                              "HTTP/1.1 503 Service Unavailable")
          and "ready" in ready, f"shell: /readyz answered {head['/readyz']}")
    held = FileLeaseBackend(lease).get()
    check(held is not None and held.holder == "",
          f"shell: the lease was not released on stop(): {held}")
    for k in ("offer_argmin", "solve_scan"):
        check(launches[k] > 0, f"kernel {k} was not launched in the shell")
    check_scan_calls(cap_b, "shell", ("largest solve",))
    log(f"[check] shell: converged, no crash, {bcloud.stats['terminate_batches']}"
        f" coalesced termination batches and "
        f"{bcloud.stats['describe_coalesced']} coalesced describes, /metrics "
        f"{head['/metrics']!r}, /readyz {head['/readyz']!r} "
        f"{ready.get('ready')}, the lease released (transitions "
        f"{held.transitions})")

    # the production entry point, in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.main", *SHELL_MAIN_ARGS],
        capture_output=True, text=True, timeout=SHELL_MAIN_TIMEOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m karpenter_tpu_torch.main "
          f"{' '.join(SHELL_MAIN_ARGS)} exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    got = dict(line.strip().split("=", 1) for line in proc.stdout.splitlines()
               if line.strip().startswith(("soak_hash=",
                                           "load_fingerprint=")))
    want = soak_digests["soak_smoke"]
    check(got.get("soak_hash") == want[0]
          and got.get("load_fingerprint") == want[2],
          f"python -m karpenter_tpu_torch.main --soak printed {got}, phase "
          f"4j's device run {want[0]} / {want[2]}")
    log(f"[check] python -m karpenter_tpu_torch.main "
        f"{' '.join(SHELL_MAIN_ARGS)}: exit 0 in {wall:.1f} s, soak_hash "
        f"{got['soak_hash'][:16]} and load_fingerprint "
        f"{got['load_fingerprint'][:16]} equal to phase 4j's device run")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"[shell] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- phase 4l: the federation plane — bench c17 and c18 on the card --------

FED_PROCS = 3            # c17's fleet processes sharing one server (bench.py:1178)
FED_TENANTS = 40         # tenants a process: c17's 120 on an attached slice
#                          (bench.py:1180); never cut
FED_DRILLS = ("fed_flap", "fed_server_restart")   # c18's drills (bench.py:1260)
FED_WIDE = 16            # tenants of one full wire bucket (SolverService.MAX_BATCH)
FED_WIDE_PODS = 8_192    # grid pods a tenant (seed = the tenant's index)
FED_READY_TIMEOUT = 120  # seconds for the subprocess server's READY line
FED_CLI_TIMEOUT = 300    # seconds for one `python -m karpenter_tpu_torch.fleet`
# The reference's CPU run of the same procedures (`JAX_PLATFORMS=cpu python3
# tools/ref_findings.py federation karpenter_tpu device`): the fleet hash,
# fleet fingerprint and wire fingerprint of c17 (every process's, equal),
# of each drill and of the fleet CLI's `federation_smoke --federate` (8
# tenants), each run's watchdog findings (invariant, severity) -> count,
# and c17's server stats
FED_REF = {
    "c17": ("168fab903e75c4634b8934719e3263fc96ee20b68058c131fe7bffb27dfa64b9",
            "03dc7a643a0419498ef45dfd0bdfa232caa25887ead1ef472a6e1ff5822ba14a",
            "", {}),
    "fed_flap": (
        "bb41aa378e4bd5238efa3775f5d4e8deb9907f7871e65f78adfe5218c42769e8",
        "e4c33136ea9afe1ab92807915b8df835de73586b4e5e29753254228413d18126",
        "a91ee0cc3753cda52b6e3c4db11924352d502aca9dd070ea2b4840647ed1354d",
        {("federation_degraded", "warning"): 1}),
    "fed_server_restart": (
        "bb41aa378e4bd5238efa3775f5d4e8deb9907f7871e65f78adfe5218c42769e8",
        "e4c33136ea9afe1ab92807915b8df835de73586b4e5e29753254228413d18126",
        "a74bb3e4e2a4105d13d6c1d685f88045b97fc03673b51b338223edd142b0b2e4",
        {}),
    "cli": ("faa1521bb81124e63a85d40210c6dcc7c36886f10ff513d20351c18127e4d352",
            "e4c33136ea9afe1ab92807915b8df835de73586b4e5e29753254228413d18126",
            "", {}),
}
# c17's server: the shards solve synchronously (each tick pumps its own
# solve), so every one of the 333 buckets carries one request, as in the
# reference; FED_WIDE's deferred pump is the full bucket
FED_REF_C17_SERVER = {"catalog_uploads": 1, "buckets": 333, "rows": 333,
                      "padded_rows": 333, "max_bucket_rows": 1,
                      "unknown_token": 0, "restarts": 0}


def fed_digest(rep) -> tuple:
    return rep.fleet_hash, rep.fleet_fingerprint, rep.wire_fingerprint


def fed_stats(rep) -> tuple:
    """A report's digests, per-tenant digests and stats but those read
    on the host clock: what a repeat must reproduce."""
    return (fed_digest(rep), rep.tenant_hashes, rep.tenant_fingerprints,
            {k: v for k, v in rep.stats.items()
             if k not in ("aggregate_solves_per_wall_sec",
                          "pipeline_overlap_ratio")})


class ServerLaunches:
    """Counts kernel B0's and B's launches inside the federation server's
    solve_bucket RPC (the server's share of the phase's launches), by
    wrapping SolverServer._rpc_solve_bucket."""

    def __enter__(self):
        from karpenter_tpu_torch.federation.server import SolverServer
        from karpenter_tpu_torch.ops import solve_scan as ss
        self.cls, self.real = SolverServer, SolverServer._rpc_solve_bucket
        self.offer_argmin = self.solve_scan = self.buckets = 0
        watch = self

        def counted(srv, payload):
            b0, b = ss.offer_launches, ss.launches
            try:
                return watch.real(srv, payload)
            finally:
                watch.offer_argmin += ss.offer_launches - b0
                watch.solve_scan += ss.launches - b
                watch.buckets += 1
        SolverServer._rpc_solve_bucket = counted
        return self

    def __exit__(self, *exc):
        self.cls._rpc_solve_bucket = self.real


def _ready_port(proc, timeout: float) -> int:
    """The port of a federation server subprocess's `READY <port>` line."""
    import select
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline().strip() if ready else ""
    check(line.startswith("READY "), f"federation server printed {line!r} "
          f"(exit {proc.poll()}) within {timeout} s, not READY <port>")
    return int(line.split()[1])


def _stop(proc) -> None:
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def phase_federation() -> tuple:
    """The federation plane on the card. Bench c17's procedure: FED_PROCS
    processes x FED_TENANTS tenants of federation_smoke at seed 0, every
    bucket crossing the in-memory wire to one SolverServer on the card;
    each process's digests equal the reference's CPU run's, an in-process
    device run's and a native run's; no wire failure, no local bucket,
    catalog uploads <= the distinct views, the server's stats the
    reference's. One full wire bucket: FED_WIDE tenants x FED_WIDE_PODS
    grid pods on the 810-type catalog deferred into one pump, so one
    [16, Gp, W] stack crosses the wire; its SolveOutputs equal an
    in-process batched service's. Bench c18's drills (fed_flap,
    fed_server_restart) twice each: repeat-equal, the reference's digests
    and findings, the restart's digests those of its in-process arm, no
    stale frame decoded. The process boundary: `python -m
    karpenter_tpu_torch.federation.server` in a subprocess, `python -m
    karpenter_tpu_torch.fleet federation_smoke --federate --server-addr`
    against it (exit 0, the in-process run's digests), a client living
    across a kill and a restart with --generation 2, the fleet CLI again.
    Then batched B0 and B against their plain versions at the wire
    bucket's stack. Returns (launches, the server's B0/B launches, c17's
    keys, c18's keys)."""
    from karpenter_tpu_torch import catalog, models
    from karpenter_tpu_torch.catalog import CatalogProvider
    from karpenter_tpu_torch.federation import build_federated_service
    from karpenter_tpu_torch.federation import server as fed_server
    from karpenter_tpu_torch.metrics import (FEDERATION_RPCS,
                                             FEDERATION_WIRE_BYTES)
    from karpenter_tpu_torch.models.nodepool import NodePool
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.ops import resident, screen_k as sk
    from karpenter_tpu_torch.ops import solve_scan as ss, solver
    from karpenter_tpu_torch.utils.clock import FakeClock

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sk.launches = tk.launches = ss.launches = ss.offer_launches = 0
    r0 = resident.launches
    srvl = ServerLaunches().__enter__()
    try:
        # --- c17: 3 processes x 40 tenants, one server on the card ---
        wire0 = (FEDERATION_WIRE_BYTES.value(direction="sent")
                 + FEDERATION_WIRE_BYTES.value(direction="received"))
        srv = fed_server.SolverServer(run_id="bench-c17")
        fed_reps, disp, tens, wall17, views = [], 0.0, 0, 0.0, 0
        t17 = time.perf_counter()
        for p in range(FED_PROCS):
            def factory(clock, kw, _proc=f"p{p:03d}"):
                return build_federated_service(
                    clock, run_id="bench-c17", process=_proc,
                    shared_server=srv, **kw)
            rep, runner, wall = fleet_run(
                "federation_smoke", FED_REF["c17"][3], tag="federation",
                tenants=FED_TENANTS, seed=SEED, backend="device",
                service_factory=factory)
            fs = runner.service.federation_state()
            check(fs["failures"] == 0 and fs["local_buckets"] == 0
                  and fs["wire_buckets"] > 0 and fs["stale_decoded"] == 0,
                  f"c17 process p{p:03d}: wire failures {fs['failures']}, "
                  f"local buckets {fs['local_buckets']}, wire buckets "
                  f"{fs['wire_buckets']}")
            fed_reps.append(rep)
            disp += float(runner.service.stats["dispatched"])
            tens += (runner.service.fed.stats["tensor_bytes_sent"]
                     + runner.service.fed.stats["tensor_bytes_received"])
            views = max(views, int(rep.stats["catalog_views_minted"]))
            wall17 += wall / 1e3
        c17_ms = (time.perf_counter() - t17) * 1e3
        wire = (FEDERATION_WIRE_BYTES.value(direction="sent")
                + FEDERATION_WIRE_BYTES.value(direction="received") - wire0)
        local, native = (fleet_run(
            "federation_smoke", tag="federation", tenants=FED_TENANTS,
            seed=SEED, backend=backend)[0] for backend in ("device",
                                                           "native"))
        for rep in fed_reps:
            check(rep.tenant_hashes == local.tenant_hashes == \
                  native.tenant_hashes
                  and rep.tenant_fingerprints == local.tenant_fingerprints
                  == native.tenant_fingerprints,
                  "c17: federated per-tenant digests != in-process device "
                  "!= native")
            check(fed_digest(rep) == FED_REF["c17"][:3],
                  f"c17: digests {fed_digest(rep)}, the reference's "
                  f"{FED_REF['c17'][:3]}")
        st17 = {k: srv.stats[k] for k in FED_REF_C17_SERVER}
        check(st17 == FED_REF_C17_SERVER, f"c17 server stats {st17}, the "
              f"reference's {FED_REF_C17_SERVER}")
        check(srv.stats["catalog_uploads"] <= views,
              f"c17: {srv.stats['catalog_uploads']} catalog uploads for "
              f"{views} distinct views")
        c17 = {"c17_fleet_settled": all(r.ok for r in fed_reps),
               "c17_federated_solves_per_sec": round(disp / wall17, 1),
               "c17_catalog_uploads_per_cluster":
                   int(srv.stats["catalog_uploads"]),
               "c17_wire_overhead_frac": round(1.0 - tens / wire, 4),
               "c17_mesh_batch_capacity": int(srv.stats["max_bucket_rows"]),
               "c17_wire_buckets": int(srv.stats["buckets"]),
               "c17_wall_ms": round(c17_ms, 1)}
        log(f"[federation] c17 ({FED_PROCS} processes x {FED_TENANTS} "
            f"tenants, one server on the card): {json.dumps(c17)}; server "
            f"stats {srv.stats}; wire {int(wire)} B for {tens} tensor B")

        # --- one full wire bucket: 16 tenants deferred into one pump ---
        types = catalog.generate_catalog()
        pool = NodePool(name="default")
        wide = [grid_pods(models, FED_WIDE_PODS, t) for t in range(FED_WIDE)]
        reset_sequences()
        srv_w = fed_server.SolverServer(run_id="fed-wide")
        svc_w = build_federated_service(
            FakeClock(), run_id="fed-wide", process="p100",
            shared_server=srv_w, backend="device", batch=True)
        cl_w = [svc_w.register(f"t{t:03d}", CatalogProvider(lambda: types))
                for t in range(FED_WIDE)]
        b0w, bw = srvl.offer_argmin, srvl.solve_scan
        with Recorder(fed_server, "dispatch_packed") as rec_stack, \
                Recorder(solver, "solve_scan_batched") as rec_scan:
            got = batched_round(svc_w, cl_w, wide, pool)
        wide_server = (srvl.offer_argmin - b0w, srvl.solve_scan - bw)
        fs = svc_w.federation_state()
        check(srv_w.stats["buckets"] == 1
              and srv_w.stats["max_bucket_rows"] == FED_WIDE
              and fs["wire_buckets"] == 1 and fs["wire_tickets"] == FED_WIDE
              and fs["failures"] == 0 and wide_server == (1, 1),
              f"full wire bucket: server stats {srv_w.stats}, client "
              f"{fs}, server B0/B launches {wide_server}")
        reset_sequences()
        svc_l, cl_l = fleet_service("device", True, FED_WIDE, types)
        want = batched_round(svc_l, cl_l, wide, pool)
        check(got == want, "full wire bucket: SolveOutputs differ from the "
              "in-process batched service's")
        (gstack, conf, *_), _ = rec_stack.calls[0]
        log(f"[federation] full wire bucket: {FED_WIDE} tenants x "
            f"{FED_WIDE_PODS} grid pods, one stack {list(gstack.shape)} f32"
            f" ({gstack.nbytes} B) and conflict stack "
            f"{None if conf is None else list(conf.shape)} over the wire, "
            f"one B0 and one B launch on the server; SolveOutputs equal the "
            f"in-process batched service's; server stats {srv_w.stats}")

        # --- c18: the wire-weather and crash-restart drills, twice each ---
        rpc0 = FEDERATION_RPCS.sum()
        t18 = time.perf_counter()
        c18_runs = {}
        for name in FED_DRILLS:
            want_d = FED_REF[name]
            runs = [fleet_run(name, want_d[3],
                              wire_weather=name == "fed_flap",
                              tag="federation", seed=SEED)
                    for _ in range(2)]
            for rep, runner, _ in runs:
                fs = runner.service.federation_state()
                check(fed_digest(rep) == want_d[:3] and fs["stale_decoded"] == 0,
                      f"c18 {name}: digests {fed_digest(rep)}, the "
                      f"reference's {want_d[:3]}; stale_decoded "
                      f"{fs['stale_decoded']}")
            a, b = (fed_stats(r[0]) for r in runs)
            check(a == b, f"c18 {name}: the repeat differs: {a} != {b}")
            c18_runs[name] = runs
        c18_ms = (time.perf_counter() - t18) * 1e3
        attempts = FEDERATION_RPCS.sum() - rpc0
        retries = sum(r[1].service.federation_state()["retries"]
                      for runs in c18_runs.values() for r in runs)
        fed_rst = c18_runs["fed_server_restart"][0][0]
        arm = fleet_run("fed_server_restart", tag="federation", seed=SEED,
                        federate=False)[0]
        check(arm.tenant_hashes == fed_rst.tenant_hashes
              and arm.tenant_fingerprints == fed_rst.tenant_fingerprints,
              "c18 fed_server_restart: federated digests != its in-process "
              "arm's")
        flap, rst = (c18_runs[n][0][1].service.federation_state()
                     for n in FED_DRILLS)
        check(flap["rejoins"] + rst["rejoins"] >= 1
              and rst["failures"] == 0 and rst["generation_changes"] == 1,
              f"c18: rejoins {flap['rejoins']} + {rst['rejoins']}, restart "
              f"failures {rst['failures']}, generation changes "
              f"{rst['generation_changes']}")
        c18 = {"c18_fleet_settled": True,
               "c18_rejoin_ms": round(float(flap["last_rejoin_ms"]), 3),
               "c18_retry_frac": (round(retries / attempts, 4)
                                  if attempts else 0.0),
               "c18_restart_reupload_bytes": int(rst["reupload_bytes"]),
               "c18_generation_changes": int(rst["generation_changes"]),
               "c18_rejoins": int(flap["rejoins"] + rst["rejoins"]),
               "c18_wall_ms": round(c18_ms / 2, 1)}
        log(f"[federation] c18 (each drill twice; wall a pass): "
            f"{json.dumps(c18)}")

        # --- the process boundary: a server subprocess on the card ---
        cli_want = fleet_run("federation_smoke", tag="federation",
                             seed=SEED, backend="device")[0]
        check(fed_digest(cli_want) == FED_REF["cli"][:3],
              f"federation_smoke in process: {fed_digest(cli_want)}, the "
              f"reference's federated {FED_REF['cli'][:3]}")
        server_cmd = [sys.executable, "-m",
                      "karpenter_tpu_torch.federation.server",
                      "--run-id", "fed-cli"]
        log_dir = os.path.join(root, "build", "federation")
        os.makedirs(log_dir, exist_ok=True)
        proc = None
        try:
            def spawn(port: int, generation: int):
                err = open(os.path.join(log_dir, f"server-gen{generation}"
                                                 f".log"), "w")
                p = subprocess.Popen(
                    server_cmd + ["--port", str(port), "--generation",
                                  str(generation)],
                    stdout=subprocess.PIPE, stderr=err, text=True, cwd=root)
                err.close()
                return p

            def fleet_cli(port: int, what: str) -> float:
                t0 = time.perf_counter()
                out = subprocess.run(
                    [sys.executable, "-m", "karpenter_tpu_torch.fleet",
                     "federation_smoke", "--federate", "--server-addr",
                     f"127.0.0.1:{port}"], capture_output=True, text=True,
                    timeout=FED_CLI_TIMEOUT, cwd=root)
                wall = time.perf_counter() - t0
                check(out.returncode == 0, f"fleet CLI {what} exited "
                      f"{out.returncode}: {out.stdout[-2000:]} "
                      f"{out.stderr[-2000:]}")
                got = dict(line.strip().split("=", 1)
                           for line in out.stdout.splitlines()
                           if line.strip().startswith(
                               ("fleet_hash=", "federated_wire_buckets=",
                                "federated_wire_failures=")))
                check(got.get("fleet_hash") == cli_want.fleet_hash
                      and float(got.get("federated_wire_buckets", 0)) > 0
                      and float(got.get("federated_wire_failures", 1)) == 0,
                      f"fleet CLI {what}: printed {got}, the in-process "
                      f"run's fleet hash {cli_want.fleet_hash}")
                log(f"[federation] python -m karpenter_tpu_torch.fleet "
                    f"federation_smoke --federate --server-addr "
                    f"127.0.0.1:{port} ({what}): exit 0 in {wall:.1f} s, "
                    f"fleet hash {got['fleet_hash'][:16]} (the in-process "
                    f"run's), wire buckets {got['federated_wire_buckets']}")
                return wall

            t0 = time.perf_counter()
            proc = spawn(0, 1)
            port = _ready_port(proc, FED_READY_TIMEOUT)
            ready_s = time.perf_counter() - t0
            fleet_cli(port, "generation 1")
            with env_set(KARPENTER_TPU_DELTA=0):
                svc_h = build_federated_service(
                    FakeClock(), server_addr=f"127.0.0.1:{port}",
                    run_id="fed-regen", backend="device", batch=True)
                small = catalog.small_catalog()
                ch = svc_h.register("a", CatalogProvider(lambda: small))
                burst = [models.Pod(name=f"w0-{i}", requests=models.Resources
                                    .parse({"cpu": "500m", "memory": "1Gi"}))
                         for i in range(4)]
                t = ch.solve_async(burst, pool)
                svc_h.pump()
                check(bool(t.result().launches) and svc_h.fed._server_gen == 1,
                      "HTTP client: the first solve failed")
                up0 = svc_h.fed.stats["uploads"]
                _stop(proc)
                proc = spawn(port, 2)
                _ready_port(proc, FED_READY_TIMEOUT)
                t = ch.solve_async([models.Pod(
                    name=f"w1-{i}", requests=models.Resources.parse(
                        {"cpu": "500m", "memory": "1Gi"})) for i in range(4)],
                    pool)
                svc_h.pump()
            cs, fs = svc_h.fed.stats, svc_h.federation_state()
            check(bool(t.result().launches) and svc_h.fed._server_gen == 2
                  and cs["generation_changes"] == 1
                  and cs["rehandshakes"] == 1 and cs["uploads"] == up0 + 1
                  and cs["reupload_bytes"] > 0
                  and cs["stale_decoded"] == 0 and fs["failures"] == 0,
                  f"HTTP client across the restart: generation "
                  f"{svc_h.fed._server_gen}, stats {cs}, failures "
                  f"{fs['failures']}")
            log(f"[federation] server subprocess READY in {ready_s:.1f} s; "
                f"a client across kill + restart --generation 2: generation "
                f"changes 1, re-handshakes 1, the catalog re-uploaded once "
                f"({cs['reupload_bytes']} B), stale decoded 0, wire "
                f"failures 0")
            fleet_cli(port, "generation 2")
        finally:
            _stop(proc)
    finally:
        srvl.__exit__(None, None, None)
    launches = {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches, "tournament": tk.launches,
                "resident_patch": resident.launches - r0}
    server = {"offer_argmin": srvl.offer_argmin,
              "solve_scan": srvl.solve_scan, "buckets": srvl.buckets}
    check(launches["offer_argmin"] > 0 and launches["solve_scan"] > 0
          and server["offer_argmin"] > 0 and server["solve_scan"] > 0,
          f"the federation phase launched no batched solve on the server: "
          f"{launches}, server {server}")

    # --- batched B0 and B against their plain versions at the wire stack ---
    (sargs, skw), = rec_scan.calls[:1]
    check_batched(ss, sargs, skw, "the full wire bucket")
    log(f"[check] federation: c17 x{FED_PROCS} processes == in-process == "
        f"native == the reference's digests, 0 wire failures, 0 local "
        f"buckets; one {FED_WIDE}-row wire bucket == in-process; c18 "
        f"drills repeat-equal with the reference's digests; the subprocess "
        f"server answered the fleet CLI across a restart; batched B0/B == "
        f"plain at the wire stack; launches {launches}, of them on the "
        f"server {server}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, server, c17, c18


# --- phase 4h: the delta plane and the device-resident state on the card --

PATCH_FRACTIONS = (0.01, 0.10, 0.60)   # of the facade mix's encoded groups
# the corruption drills at seed 0: the integrity plane's detections and
# violation flags by check, as tests/test_torch_chaos.py holds them equal
# to the reference's (each injection also quarantines the facade once)
DRILLS = {"sdc_storm": {"detections": 4,
                        "flags": {"accounting": 2.0, "resident_audit": 2.0}},
          "resident_rot": {"detections": 3,
                           "flags": {"capacity": 1.0, "resident_audit": 2.0}}}


class ReadKeeper:
    """Keeps what ops/solver._read returns (the last read of a solve is its
    packed result vector)."""

    def __init__(self, solver):
        self.solver, self.reads = solver, []

    def __enter__(self):
        real = self.real = self.solver._read

        def keep(t):
            out = real(t)
            self.reads.append(out)
            return out
        self.solver._read = keep
        return self

    def __exit__(self, *exc):
        self.solver._read = self.real


def h2d_events(ev: dict) -> int:
    return sum(n for name, (_, n) in ev.items() if "HtoD" in name)


def kernel_only_ms(fn, calls: int) -> float:
    """Device ms a call of fn() spends in kernels (memcpy excluded), from
    torch.profiler over `calls` calls: each kernel's mean time a launch,
    summed over the kernels a call launches once each (robust to the
    events the trace drops); None when the trace is empty."""
    for _ in range(3):
        ev = device_kernel_us(lambda: [fn() for _ in range(calls)])
        per = [u / n for name, (u, n) in ev.items()
               if "Memcpy" not in name and "Memset" not in name]
        if per:
            return sum(per) / 1e3
    return None


def scatter_times(resident, solver, buf, k: int, where: str) -> dict:
    """The resident patch's row scatter at one resident buffer: k seeded
    rows through _scatter_rows (the int32 index widened on the card, then
    index_copy_ in place), the kernels alone, the plain advanced-indexing
    assignment, index_copy_ alone, and a full upload of the same matrix
    beside the bytes bound. Returns the row of the kernels line."""
    import numpy as np
    import torch
    dev = buf.device
    rows_n = int(buf.shape[0])
    rng = np.random.default_rng(k)
    idx_np = np.sort(rng.choice(rows_n, size=k, replace=False)).astype(
        np.int32)
    host = buf.cpu().numpy()
    if host.dtype == bool:
        new_rows = ~host[idx_np]
    else:
        new_rows = host[idx_np] + np.float32(1.0)
    idx = torch.from_numpy(idx_np).to(dev)
    idx64 = idx.to(torch.int64)
    rows = torch.from_numpy(np.ascontiguousarray(new_rows)).to(dev)
    work = buf.clone()
    resident._scatter_rows(work, idx, rows, True)
    want = host.copy()
    want[idx_np] = new_rows
    got = work.cpu().numpy()
    err = float(np.abs(got.astype(np.float64)
                       - want.astype(np.float64)).max())
    check(err == 0.0, f"scatter at {where}: max abs err {err}")
    ms = cuda_ms(lambda: resident._scatter_rows(work, idx, rows, True), 200)
    kernel = kernel_only_ms(
        lambda: resident._scatter_rows(work, idx, rows, True), 20)
    plain = cuda_ms(lambda: work.index_put_((idx64,), rows), 200)
    lib = cuda_ms(lambda: work.index_copy_(0, idx64, rows), 200)
    # a full upload of the same matrix: the host wall of _put (pinning and
    # the copy, synchronised) and the copy's device time
    up_wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver._put(want, dev)
        torch.cuda.synchronize()
        up_wall.append((time.perf_counter() - t0) * 1e3)
    copy_us = []
    for _ in range(3):  # the trace drops a short run's events now and then
        ev = device_kernel_us(lambda: [solver._put(want, dev)
                                       for _ in range(5)])
        copy_us = [u / n for name, (u, n) in ev.items() if "HtoD" in name]
        if copy_us:
            break
    row_bytes = int(buf.element_size()) * (buf.numel() // rows_n)
    nbytes = 2 * k * row_bytes + k * 8
    out = {"ms": ms, "plain_ms": plain, **bound(nbytes, 0),
           "library_ms": lib, "kernel_ms": kernel, "max_abs_err": err,
           "k": k, "rows": rows_n,
           "row_bytes": row_bytes,
           "full_upload_ms": statistics.median(up_wall),
           "full_upload_copy_ms": (max(copy_us) / 1e3 if copy_us else None),
           "full_upload_bytes": int(want.nbytes)}
    log(f"[time] resident patch at {where} ({rows_n} rows of {row_bytes} B, "
        f"k={k}): _scatter_rows {ms:.5f} ms (kernels alone {kernel} ms), "
        f"bound {out['bound_ms']:.6f} ms ({nbytes} B); plain index_put_ "
        f"{plain:.5f} ms; index_copy_ alone {lib:.5f} ms; a full upload of "
        f"the matrix ({want.nbytes} B) {out['full_upload_ms']:.4f} ms wall, "
        f"copy {out['full_upload_copy_ms']} ms on the card")
    return out


def phase_planes(c14: dict, recompute_snap: dict) -> dict:
    """The delta plane and the device-resident state on the card (phase 4h):
    the resident request matrix patched at full width, the batched pump's
    resident stacks, the audits and ledgers, the corruption drills, c14 at
    the reference's default, and the row scatter timed. Returns the row
    scatter's launches in the phase and its rows of the kernels line."""
    import numpy as np
    import torch
    from karpenter_tpu_torch import catalog, models
    from karpenter_tpu_torch.faults import SCENARIOS
    from karpenter_tpu_torch.integrity import INTEGRITY
    from karpenter_tpu_torch.metrics import (INTEGRITY_VERDICTS,
                                             RESIDENT_FALLBACKS,
                                             SOLVER_FALLBACKS)
    from karpenter_tpu_torch.obs import devicemem as dm
    from karpenter_tpu_torch.obs.profile import LEDGER
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.ops import facade as F, resident, solver

    t_phase = time.perf_counter()
    R = resident.RESIDENT
    reset_sequences()
    launches0 = resident.launches

    def patch_bytes():
        return sum(r["bytes"] for r in dm.TRANSFERS.snapshot()["rows"]
                   if r["reason"] == "resident_patch")

    # --- 1. the resident request matrix at full width (the facade mix) ---
    types = catalog.generate_catalog()
    pool, daemonsets, pods = facade_cluster(models, N_PODS, SEED)
    f = F.Solver(catalog.CatalogProvider(lambda: types), backend="device")
    prep = f.prepare_solve(pods, pool, daemonsets=daemonsets)
    check(prep.output is None and prep.backend == "device",
          "planes: the facade mix did not stage a device solve")
    cat, enc = prep.cat, copy.copy(prep.enc)
    enc.counts = prep.enc.counts.copy()
    dcat = f._device_dcat(prep)
    G, Gp = enc.G, solver._bucket(enc.G, 8)
    n_max = solver._auto_node_budget(cat, enc, 0)
    key = ("planes", "facade-mix")
    gkey = key + ("gbuf", Gp)
    track = enc.conflict is not None
    rng = np.random.default_rng(SEED)
    order = rng.permutation(G)
    steps = [("first sight", 0)]
    for frac in PATCH_FRACTIONS:
        k = int(np.ceil(frac * G))
        if frac > resident.PATCH_MAX_FRAC:
            k = min(G, max(k, int(resident.PATCH_MAX_FRAC * Gp) + 1))
        steps.append((f"{frac:.0%} of the groups changed", k))
    steps.append(("nothing changed", 0))
    used = 0
    ent_stats0 = None
    for what, k in steps:
        if k:
            sel = order[used:used + k] if used + k <= G else \
                rng.choice(G, size=k, replace=False)
            used += k
            enc.counts = enc.counts.copy()
            enc.counts[sel] += 1
        b0, h0 = patch_bytes(), dm.TRANSFERS.totals()[0]
        u0 = solver.transfer_stats()[0]
        dense0 = RESIDENT_FALLBACKS.sum(reason="dense")
        with ReadKeeper(solver) as rk:
            if what == "nothing changed":
                ev = device_kernel_us(lambda: solver.solve_device(
                    cat, enc, n_max=n_max, dcat=dcat, resident_key=key))
            else:
                solver.solve_device(cat, enc, n_max=n_max, dcat=dcat,
                                    resident_key=key)
        got = rk.reads[-1]
        shipped, h2d = patch_bytes() - b0, dm.TRANSFERS.totals()[0] - h0
        uploads = solver.transfer_stats()[0] - u0
        ent = R._entries[gkey]
        st = dict(ent.stats)
        with env_set(KARPENTER_TPU_RESIDENT=0), ReadKeeper(solver) as rk0:
            if what == "nothing changed":
                ev0 = device_kernel_us(lambda: solver.solve_device(
                    cat, enc, n_max=n_max, dcat=dcat, resident_key=key))
            else:
                solver.solve_device(cat, enc, n_max=n_max, dcat=dcat,
                                    resident_key=key)
        check(np.array_equal(got, rk0.reads[-1]),
              f"planes: {what}: the resident solve's packed vector != the "
              f"disarmed one's")
        W = int(ent.buf.shape[1])
        if ent_stats0 is None:
            check(st["full"] == 1, f"planes: first sight {st}")
        elif what.startswith("60"):
            check(st["full"] == ent_stats0["full"] + 1
                  and RESIDENT_FALLBACKS.sum(reason="dense") == dense0 + 1,
                  f"planes: {what}: not a dense full upload {st}")
        elif k:
            check(st["patches"] == ent_stats0["patches"] + 1
                  and shipped == k * W * 4 + k * 4,
                  f"planes: {what}: patch {st}, shipped {shipped} B, want "
                  f"{k * W * 4 + k * 4}")
        else:
            n_res = 2 if track else 1
            check(st["clean"] == ent_stats0["clean"] + 1 and h2d == 0
                  and uploads == 0,
                  f"planes: {what}: clean hit {st}, {h2d} B / {uploads} "
                  f"uploads shipped")
            if ev and ev0:
                check(h2d_events(ev) + n_res <= h2d_events(ev0),
                      f"planes: {what}: HtoD copies {h2d_events(ev)} with "
                      f"residency vs {h2d_events(ev0)} without")
            log(f"[planes] {what}: 0 B shipped, 0 uploads; HtoD memcpy "
                f"events under torch.profiler {h2d_events(ev)} resident vs "
                f"{h2d_events(ev0)} disarmed (the gbuf"
                f"{' and the conflict matrix' if track else ''})")
        ent_stats0 = st
        log(f"[planes] facade mix G={G} Gp={Gp} W={W} n_max={n_max}: {what} "
            f"(k={k}): gbuf entry {st}; resident_patch {shipped} B, h2d "
            f"{h2d} B; packed vector == disarmed")

    # the facade mix's resident buffers, kept for step 6 (the drills reset
    # the manager)
    ckey = key + ("conflict", Gp)
    timed_bufs = {"gbuf": R._entries[gkey].buf,
                  "conflict": (R._entries[ckey].buf if ckey in R._entries
                               else None)}

    # --- 2. the batched pump's resident stacks (c12's 16 tenants) ---
    # delta plane off: it would serve an unchanged tenant before its pump
    burst = [[models.Pod(name=f"c12-{t}-{i}", requests=models.Resources.parse(
        {"cpu": FLEET_SHAPES[(t + i) % len(FLEET_SHAPES)][0],
         "memory": FLEET_SHAPES[(t + i) % len(FLEET_SHAPES)][1]}))
        for i in range(FLEET_BURST)] for t in range(FLEET_TENANTS)]
    # two tenants change 3 pods' shapes to another of their shapes: new
    # group rows, the same groups and shape class (one bucket still)
    changed = [list(b) for b in burst]
    for t in (0, 5):
        cpu, mem = FLEET_SHAPES[t % len(FLEET_SHAPES)]
        changed[t] = changed[t][:-3] + [
            models.Pod(name=p.name, requests=models.Resources.parse(
                {"cpu": cpu, "memory": mem})) for p in changed[t][-3:]]
    rounds = [burst, burst, burst, changed]
    c12_pool = models.NodePool(name="default")
    runs = {}
    for armed in ("1", "0"):
        with env_set(KARPENTER_TPU_DELTA=0, KARPENTER_TPU_RESIDENT=armed):
            svc, clients = fleet_service("device", True, FLEET_TENANTS, types)
            rows, stats = [], []
            for r, bursts in enumerate(rounds):
                s0 = dict(R.stats)
                with FleetWatch(solver) as fw:
                    batched_round(svc, clients, bursts, c12_pool)
                rows.append([ifb.rows().copy() for ifb in fw.batches])
                stats.append({k: R.stats[k] - s0[k] for k in
                              ("full_uploads", "patches", "clean_hits")})
            runs[armed] = (rows, stats, svc)
    rows, stats, svc = runs["1"]
    fleet_keys = [k for k in R._entries if k[:2] == ("fleet", id(svc))]
    for r in range(len(rounds)):
        check(len(rows[r]) == len(runs["0"][0][r]) and all(
            np.array_equal(a, b) for a, b in zip(rows[r], runs["0"][0][r])),
            f"planes: batched round {r}: resident rows != disarmed rows")
    check(stats[2]["full_uploads"] == 0 and stats[2]["clean_hits"] >= 1
          and stats[3]["full_uploads"] == 0 and stats[3]["patches"] >= 1,
          f"planes: batched rounds 3 and 4 were not served from the resident "
          f"stack: {stats}")
    log(f"[planes] c12's {FLEET_TENANTS} tenants, batched, delta plane off: "
        f"rounds' resident events {stats} (round 1 records the bucket's "
        f"membership, round 2 seeds the stack, round 3 repeats it, round 4 "
        f"changes 2 tenants); {len(fleet_keys)} resident stack(s); every "
        f"packed row == the run with residency disarmed")

    # --- 3. audits and ledgers ---
    rep = R.audit()
    check(not rep["corrupt"], f"planes: resident audit found {rep}")
    import gc
    gc.collect()
    audit = dm.DEVICEMEM.audit()
    live = dm.live_device_tensors()
    tracked = {dm._storage_key(t) for a in list(dm.DEVICEMEM._arrays.values())
               for t in getattr(a, "parts", (a,))}
    big = sorted(((dm._storage_nbytes(t), tuple(t.shape), str(t.dtype))
                  for t in live if dm._storage_key(t) not in tracked),
                 reverse=True)[:5]
    log(f"[planes] RESIDENT.audit over every entry: {rep['entries']} "
        f"entries, {rep['rows']} rows read back, 0 corrupt; DEVICEMEM.audit "
        f"against the live CUDA tensors: {audit}; largest unaccounted "
        f"storages {big}; residency {dm.DEVICEMEM.snapshot()['kinds']}")
    check(audit.get("coverage", 0.0) >= 0.99,
          f"planes: devicemem coverage {audit}")
    LEDGER.reset()
    with env_set(KARPENTER_TPU_DELTA=0):
        TRACER.configure(enabled=True)
        try:
            with TRACER.trace("reconcile:provisioner"):
                f.solve(pods, pool, daemonsets=daemonsets)
                torch.cuda.synchronize()
        finally:
            TRACER.configure(enabled=False)
    snap = LEDGER.snapshot()
    phases = snap["phases"].get("default", {}).get("reconcile", {})
    log(f"[planes] PhaseLedger over one traced {N_PODS}-pod facade solve "
        f"(root reconcile:provisioner, delta plane off): coverage "
        f"{LEDGER.coverage(kind='reconcile'):.4f}; buckets (ms) "
        + ", ".join(f"{b} {r['ms']:.1f}" for b, r in sorted(
            phases.items(), key=lambda kv: -kv[1]["ms"])))
    log("[planes] RECOMPUTE over the operator phase, redundant fraction by "
        "stage: " + ", ".join(
            f"{st} {row['redundant_frac']} ({row['units']})"
            for st, row in recompute_snap.get("stages", {}).items()))

    # --- 4. the corruption drills on the device rung ---
    import dataclasses
    for name, want in DRILLS.items():
        sc = dataclasses.replace(SCENARIOS[name], backend="device")
        digests = []
        for k in range(2):
            # each drill starts from an empty integrity meter, as the
            # reference's CPU run does: an earlier phase's unrecovered
            # flags (the storm's over-capacity state) would hold the
            # watchdog's integrity_breach excursion open, so a second
            # detection would not page again
            INTEGRITY.reset()
            v0 = dict(INTEGRITY_VERDICTS._values)
            f0, d0 = SOLVER_FALLBACKS.sum(), INTEGRITY.detections()
            rep_d, runner, wall, _ = run_scenario(sc, 0)
            flags = {kk[0]: v - v0.get(kk, 0.0)
                     for kk, v in INTEGRITY_VERDICTS._values.items()
                     if kk[1] == "violation" and v != v0.get(kk, 0.0)}
            det = INTEGRITY.detections() - d0
            fb = SOLVER_FALLBACKS.sum() - f0
            st = rep_d.stats
            check(rep_d.ok and st["corruptions_injected"] == 2
                  and st["corruptions_detected"] >= 2
                  and det == want["detections"] and flags == want["flags"]
                  and fb == 2
                  and runner.last_sim.solver.stats["device_fallbacks"] == 2,
                  f"planes: {name} run {k}: {rep_d.summary()}, stats {st}, "
                  f"detections {det}, flags {flags}, fallbacks {fb}")
            digests.append(digest(rep_d))
            check_findings(name, runner.last_sim,
                           f"planes: {name} run {k + 1}")
            log(f"[planes] {name} seed 0 run {k + 1}: ok, "
                f"{st['corruptions_injected']:g} injected, detections {det} "
                f"(flags {flags}), quarantines {fb:g} (this facade only); end "
                f"{rep_d.end_hash[:16]}, fingerprint "
                f"{rep_d.fault_fingerprint[:16]}; wall {wall:.1f} ms")
        check(digests[0] == digests[1], f"planes: {name}: the two runs "
              f"differ: {digests}")

    # --- 5. c14 at the reference's default (phase 4d's run) ---
    check({k: c14[k] for k in C14_AT_2_TILES} == C14_AT_2_TILES,
          f"planes: c14 at 2 tiles {c14}, want {C14_AT_2_TILES}")
    log(f"[planes] c14 at 2 tiles, delta plane armed (phase 4d's device "
        f"run): {C14_AT_2_TILES} as in the reference")
    phase_launches = resident.launches - launches0
    check(phase_launches > 0, "planes: the row scatter was not launched")

    # --- 6. the row scatter timed ---
    gbuf = timed_bufs["gbuf"]
    rows_t = {"gbuf_1pct": scatter_times(
        resident, solver, gbuf, max(1, int(np.ceil(0.01 * Gp))),
        "the facade mix's gbuf"),
        "gbuf_10pct": scatter_times(
        resident, solver, gbuf, int(np.ceil(0.10 * Gp)),
        "the facade mix's gbuf")}
    if timed_bufs["conflict"] is not None:
        rows_t["conflict_1pct"] = scatter_times(
            resident, solver, timed_bufs["conflict"],
            max(1, int(np.ceil(0.01 * Gp))), "the conflict matrix")
    log(f"[planes] phase wall {time.perf_counter() - t_phase:.1f} s; row "
        f"scatter launches in the phase {phase_launches}")
    return phase_launches, rows_t


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
    # the kernel alone (one launch a call)
    c_kernel, = profiled_ms(lambda: [tk.tournament_cuda(*args)
                                     for _ in range(5)], "tournament_kernel")
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
    lay = tk.tournament_layout(S, N, G, Rk)
    c = {"ms": c_ms, "plain_ms": c_plain, **bound(c_bytes, c_ops),
         "library_ms": c_lib, "kernel_ms": c_kernel, "tier": lay.tier,
         "cluster": lay.cl, "smem_bytes": lay.smem_bytes,
         "subsets_a_block": lay.spb, "slice": lay.slice,
         "k_resident": lay.k_smem}
    log(f"[time] {where} (S={S}, N={N}, G={G}, Rk={Rk}; "
        f"{layout_note(tk, S, N, G, Rk)}): tournament kernel "
        f"{c_kernel} ms, wrapper call "
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


def library_cps(oa: dict):
    """The torch expression that builds cps over [G, T, Z, C] and takes its
    argmin, at offer_argmin's arguments (the yardstick for kernel B0; the
    port never calls it)."""
    import numpy as np
    import torch
    eps = float(np.float32(1e-4))
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
    return torch.argmin(cps.reshape(rq.shape[0], -1), 1)


def scan_kernel_times(ss, sargs, skw, where: str):
    """Kernels B0 and B at one solve_scan call's arguments: the kernel
    alone (torch.profiler), the wrapper call (CUDA events), the plain
    version, a torch yardstick for B0, the bound, and kernel B at every
    cluster size its node state fits (outputs checked equal). Logs them
    and returns the two rows of the kernels line."""
    import torch
    oa = offer_args(ss, sargs, skw)
    sb = inspect.signature(ss.solve_scan_plain).bind(*sargs, **skw)
    sb.apply_defaults()
    sa = sb.arguments
    lay = scan_layout_of(ss, sargs, skw)
    T, Z, C = sa["price"].shape
    Gp, Rk = sa["requests"].shape
    n_max, ZC = sa["n_max"], Z * C

    def offer_table():
        return ss._offer_table(
            sa["alloc"], sa["price"], sa["avail"], sa["requests"][None],
            sa["counts"][None], sa["compat"][None], sa["allow_zone"][None],
            sa["allow_cap"][None], sa["max_per_node"][None],
            sa["prior"][None], sa["banned"][None], sa["conflict"][None],
            sa["zovh"], sa["zone_ovh"], sa["track_conflicts"])

    b0_kernel, b_kernel = profiled_ms(
        lambda: [ss.solve_scan_cuda(*sargs, **skw) for _ in range(5)],
        "offer_argmin_kernel", "solve_scan_kernel")
    b0_bytes = (4 * T * ZC + T * ZC + 4 * T * Rk + Gp * (4 * Rk + T + Z + C
                                                          + 8)
                + 4 * Gp * lay.rec_words + 8 * T)
    b0_ops = Gp * (T * (4 * Rk) + T * ZC * 2)
    b0 = {"ms": cuda_ms(offer_table, 100),
          "plain_ms": cuda_ms(lambda: ss.offer_argmin_plain(**oa), 10),
          **bound(b0_bytes, b0_ops),
          "library_ms": cuda_ms(lambda: library_cps(oa), 10),
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


# --- phase 4m: the mesh, 8 virtual shards of the card ----------------------

MESH_SHARDS = 8          # the reference's 8 virtual devices (tests/conftest.py)
MESH_DEVICE = "cuda:0"   # the device the virtual shards share
MESH_BENCH_GROUPS = 128  # the reference's bench shape (test_parallel.py):
MESH_BENCH_PODS = 40     # 128 self-anti-affine groups x 40 pods, ~5k nodes


class uncounted:
    """Leaves every kernel's launch count as it found it: the launches of
    a block that compares a kernel with its yardstick (mesh=None, the
    plain version, a timing loop) are not the path's."""

    def __enter__(self):
        from karpenter_tpu_torch.ops import mesh_scan, resident, screen_k
        from karpenter_tpu_torch.ops import solve_scan
        from karpenter_tpu_torch.optimizer import tournament_k
        self.fields = [(screen_k, "launches"), (solve_scan, "launches"),
                       (solve_scan, "offer_launches"),
                       (tournament_k, "launches"), (mesh_scan, "launches"),
                       (resident, "launches")]
        self.saved = [getattr(m, f) for m, f in self.fields]
        return self

    def __exit__(self, *exc):
        for (m, f), v in zip(self.fields, self.saved):
            setattr(m, f, v)


def mesh_scan_work(Gp: int, T: int, Z: int, C: int, R: int, n_max: int):
    """(bytes, operations) the sharded scan must move and do at least:
    kernel B's count (each input read once, takes written once) at R
    columns; the mesh adds no work, only launches and gathers."""
    ZC = Z * C
    nbytes = (4 * T * R + 4 * T * ZC + T * ZC
              + Gp * (4 * R + 4 + T + Z + C + 4)
              + n_max * (4 + 4 * R + Z + C + 1)
              + 4 * Gp * n_max + 4 * Gp + 8)
    ops = Gp * (n_max * (4 * R + ZC + 6) + T * (4 * R + 2 * ZC))
    return nbytes, ops


def sharded_inputs(solver, cat, enc, n_max: int):
    """run_sharded_solve's arguments (the reference's: all R columns, zero
    node state) and the same inputs as one-device tensors for kernel B."""
    import numpy as np
    import torch
    from karpenter_tpu_torch.ops.encode import align_resources
    R = enc.requests.shape[1]
    Gp = solver._bucket(enc.G, 8)
    args = (align_resources(cat.allocatable, R).astype(np.float32),
            cat.price.astype(np.float32), cat.available.astype(bool),
            *solver._group_inputs(enc, Gp))
    dev = torch.device(MESH_DEVICE)
    t = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in args]
    Z, C = cat.Z, cat.C
    one = (*t, torch.zeros((Gp, 1), dtype=torch.int32, device=dev),
           torch.zeros((Gp, 1), dtype=torch.bool, device=dev),
           torch.zeros((Gp, 1), dtype=torch.bool, device=dev),
           torch.zeros((1, 1, R), dtype=torch.float32, device=dev),
           *solver._fresh_nodes(n_max, R, Z, C, dev), 0, n_max)
    return args, one


def mesh_sharded_case(name, parallel, msc, ss, solver, cat, enc, mesh):
    """run_sharded_solve at one shape: kernel M equal to its plain version
    (atol 0), to kernel B on one device (mesh=None) and to solve_host.
    Returns M's times and walls at that shape."""
    import numpy as np
    import torch
    from karpenter_tpu_torch.ops.binpack import solve_host
    R = enc.requests.shape[1]
    Gp = solver._bucket(enc.G, 8)
    n_max = -(-solver._auto_node_budget(cat, enc, 0) // mesh.size) * mesh.size
    args, one = sharded_inputs(solver, cat, enc, n_max)
    zeros = (np.zeros((Gp, n_max), np.int32), np.zeros((Gp, n_max), bool),
             np.zeros((Gp, 1), bool), np.zeros((1, 1, R), np.float32),
             np.zeros(n_max, np.int32), np.zeros((n_max, R), np.float32),
             np.zeros((n_max, cat.Z), bool), np.zeros((n_max, cat.C), bool),
             np.zeros(n_max, bool), np.asarray(0, np.int32))
    parts = msc.shard_args(mesh, n_max, *args, *zeros)
    m0 = msc.launches
    out = parallel.run_sharded_solve(mesh, *args, n_max=n_max)
    torch.cuda.synchronize()
    check(msc.launches - m0 == (Gp + 1) * mesh.size,
          f"{name}: kernel M launched {msc.launches - m0} times, not "
          f"(Gp + 1) x shards = {(Gp + 1) * mesh.size}")
    plain = msc.mesh_scan_plain(mesh, *parts, n_max)
    names = ("ntype", "cum", "zmask", "cmask", "nopen", "nused", "takes",
             "unsched", "overflow")
    for a, b, what in zip(out, plain, names):
        check(torch.equal(a, b.to(a.dtype)),
              f"{name}: kernel M != its plain version ({what})")
    with uncounted():
        ref = ss.solve_scan_cuda(*one)
        torch.cuda.synchronize()
    for a, b, what in zip((out[0], out[6], out[7], out[5], out[8]), ref,
                          ("ntype", "takes", "unsched", "nused", "overflow")):
        check(torch.equal(a, b.to(a.dtype).reshape(a.shape)),
              f"{name}: the sharded scan != kernel B on one device ({what})")
    h = solve_host(cat, enc)
    nused = int(out[5])
    takes = out[6].cpu().numpy()
    ntype = out[0].cpu().numpy()
    check(nused == len(h.nodes) and not bool(out[8]),
          f"{name}: {nused} nodes, solve_host {len(h.nodes)}")
    want = np.zeros((Gp, nused), np.int32)
    for i, n in enumerate(h.nodes):
        for g, c in n.pods_by_group.items():
            want[g, i] = c
    check(np.array_equal(ntype[:nused], [n.type_idx for n in h.nodes])
          and np.array_equal(takes[:, :nused], want),
          f"{name}: the sharded solve differs from solve_host")
    with uncounted():
        m_ms = cuda_ms(lambda: msc.mesh_scan_cuda(mesh, *parts, n_max), 3)
        k_ms, = profiled_ms(lambda: msc.mesh_scan_cuda(mesh, *parts, n_max),
                            "mesh_step_kernel")
        plain_ms = cuda_ms(lambda: msc.mesh_scan_plain(mesh, *parts, n_max),
                           1)
        one_ms = cuda_ms(lambda: ss.solve_scan_cuda(*one), 10)
        wall = wall_ms(lambda: msc.mesh_scan_cuda(mesh, *parts,
                                                  n_max)[5].item(), 3)
        wall_one = wall_ms(lambda: ss.solve_scan_cuda(*one)[3].item(), 3)
    nb, ops = mesh_scan_work(Gp, cat.T, cat.Z, cat.C, R, n_max)
    row = {"ms": m_ms, "plain_ms": plain_ms, **bound(nb, ops),
           "library_ms": None, "kernel_ms": k_ms,
           "step_ms": m_ms / (Gp + 1), "mesh_none_ms": one_ms,
           "wall_ms": wall, "mesh_none_wall_ms": wall_one,
           "shape": {"Gp": Gp, "n_max": n_max, "R": R, "shards": mesh.size}}
    log(f"[mesh] {name}: run_sharded_solve over {mesh.describe()}, Gp={Gp} "
        f"n_max={n_max} R={R}: {nused} nodes; kernel M == plain (atol 0), "
        f"== kernel B on one device, == solve_host. M: {m_ms:.3f} ms a "
        f"solve ({(Gp + 1) * mesh.size} launches, {m_ms / (Gp + 1):.4f} ms "
        f"a step), one launch {k_ms} ms (profiler), plain {plain_ms:.1f} ms, "
        f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); B0 + B on "
        f"one device {one_ms:.3f} ms; wall {wall:.2f} ms vs mesh=None "
        f"{wall_one:.2f} ms")
    return row, (args, n_max)


def phase_mesh(cat, enc, views, counts) -> tuple:
    """Phase 4m: the port's multi-device path on MESH_SHARDS virtual shards
    of the card, every answer held bit for bit against mesh=None on the
    card: run_sharded_solve at the grid mix and at the bench shape (kernel
    M == its plain version == kernel B on one device == solve_host);
    Solver(backend="mesh") at N_PODS grid pods == backend="device"; the
    mesh screen at phase 3's cluster == mesh=None; score_subsets_device
    (mesh=) at the operator loop's first subset search == mesh=None;
    dispatch_batch over a batch mesh on a FED_WIDE x FED_WIDE_PODS bucket
    == mesh=None, then the bucket with one tenant's request changed: one
    row patched, one scatter per shard; SolverServer(mesh=) serving phase
    4l's deferred FED_WIDE-row pump == the in-process batched service,
    c17_mesh_batch_capacity == FED_WIDE x the mesh size. Over the real
    cards too where more than one exists. Returns (launches, M's row)."""
    import numpy as np
    import torch
    from karpenter_tpu_torch import catalog, models, parallel
    from karpenter_tpu_torch.catalog import CatalogProvider
    from karpenter_tpu_torch.federation import build_federated_service
    from karpenter_tpu_torch.federation import server as fed_server
    from karpenter_tpu_torch.models.nodepool import NodePool
    from karpenter_tpu_torch.ops import consolidate, resident
    from karpenter_tpu_torch.ops import mesh_scan as msc
    from karpenter_tpu_torch.ops import screen_k as sk, solve_scan as ss
    from karpenter_tpu_torch.ops import solver
    from karpenter_tpu_torch.ops.encode import encode_pods
    from karpenter_tpu_torch.ops.facade import Solver
    from karpenter_tpu_torch.optimizer import tournament as tmod
    from karpenter_tpu_torch.optimizer import tournament_k as tk
    from karpenter_tpu_torch.utils.clock import FakeClock

    t_phase = time.perf_counter()
    with parallel.virtual_devices(MESH_SHARDS, MESH_DEVICE):
        mesh = parallel.make_mesh(MESH_SHARDS)
        bmesh = parallel.make_batch_mesh(MESH_SHARDS)
    check(mesh.virtual and mesh.size == MESH_SHARDS,
          f"mesh: {mesh.describe()}")
    sk.launches = tk.launches = ss.launches = ss.offer_launches = 0
    msc.launches = 0
    r0 = resident.launches

    # --- run_sharded_solve: the grid mix and the bench shape ---
    m_grid, _ = mesh_sharded_case("grid mix", parallel, msc, ss, solver,
                                  cat, enc, mesh)
    bpods = [models.Pod(
        name=f"g{k}-{i}", labels={"app": f"g{k}"},
        requests=models.Resources.parse({"cpu": ["6", "7"][k % 2],
                                         "memory": "6Gi"}),
        affinity_terms=[models.PodAffinityTerm(
            topology_key="kubernetes.io/hostname",
            label_selector={"app": f"g{k}"}, anti=True)])
        for k in range(MESH_BENCH_GROUPS) for i in range(MESH_BENCH_PODS)]
    benc = encode_pods(bpods, cat)
    m_bench, _ = mesh_sharded_case("bench shape", parallel, msc, ss, solver,
                                   cat, benc, mesh)

    # --- Solver(backend="mesh") at the main path's pods ---
    types = catalog.generate_catalog()
    pods = grid_pods(models, N_PODS, SEED)
    pool = NodePool(name="default")
    with parallel.virtual_devices(MESH_SHARDS, MESH_DEVICE):
        msolver = Solver(CatalogProvider(lambda: types), backend="mesh")
    check(msolver.mesh() == mesh, f"Solver.mesh() {msolver.mesh()}")
    dsolver = Solver(CatalogProvider(lambda: types), backend="device")
    b0 = ss.offer_launches
    t0 = time.perf_counter()
    mo = msolver.solve(pods, pool)
    facade_mesh_ms = (time.perf_counter() - t0) * 1e3
    n_b0 = ss.offer_launches - b0
    check(n_b0 > 0 and n_b0 % MESH_SHARDS == 0,
          f"Solver(backend='mesh'): B0 launched {n_b0} times, not once a "
          f"shard a scan")
    with uncounted():
        t0 = time.perf_counter()
        do = dsolver.solve(pods, pool)
        facade_one_ms = (time.perf_counter() - t0) * 1e3
    check(out_tuple(mo) == out_tuple(do),
          "Solver(backend='mesh') != Solver(backend='device')")
    log(f"[mesh] Solver(backend='mesh') over {mesh.describe()} at "
        f"{N_PODS} grid pods: {len(mo.launches)} node launches, {n_b0} of "
        f"B0, SolveOutput == "
        f"backend='device'; wall {facade_mesh_ms:.1f} ms vs "
        f"{facade_one_ms:.1f} ms (first solves of each facade)")

    # --- the mesh screen at phase 3's cluster ---
    with uncounted():
        s0, sl0 = consolidate.consolidation_screen(cat, enc, views, counts)
    a0 = sk.launches
    s1, sl1 = consolidate.consolidation_screen(cat, enc, views, counts,
                                               mesh=mesh)
    check(sk.launches - a0 == MESH_SHARDS,
          f"mesh screen: A launched {sk.launches - a0} times, not once a "
          f"shard")
    # the column total is a psum of f32 partial sums: exact, so equal,
    # for every group that requests something; a group that requests
    # nothing (k = BIG) rounds in another order, within f32 rounding
    zero = ~enc.requests.any(axis=1)
    check(np.array_equal(s0, s1) and np.array_equal(sl0[:, ~zero],
                                                    sl1[:, ~zero]),
          "mesh screen != mesh=None screen")
    if zero.any():
        check(np.allclose(sl1[:, zero], sl0[:, zero], rtol=1e-6, atol=0),
              "mesh screen slack (all-zero request groups) beyond rtol 1e-6")
    with uncounted():
        screen_wall = wall_ms(lambda: consolidate.consolidation_screen(
            cat, enc, views, counts, mesh=mesh), 3)
        screen_one = wall_ms(lambda: consolidate.consolidation_screen(
            cat, enc, views, counts), 3)
    log(f"[mesh] consolidation_screen(mesh=) N={len(views)} G={enc.G}: "
        f"screen and slack == mesh=None (atol 0; {int(zero.sum())} "
        f"all-zero request groups at rtol 1e-6); wall {screen_wall:.2f} ms "
        f"vs {screen_one:.2f} ms")

    # --- score_subsets_device(mesh=) at the loop's first subset search ---
    check(bool(OP_SEARCH), "the operator loop ran no subset search")
    (sargs, skw), = OP_SEARCH
    skw = {k: v for k, v in skw.items() if k not in ("mesh", "device")}
    with uncounted():
        one = tmod.score_subsets_device(*sargs, **skw)
    c0 = tk.launches
    got = tmod.score_subsets_device(*sargs, **skw, mesh=mesh)
    n_c = tk.launches - c0
    check(1 <= n_c <= MESH_SHARDS, f"mesh tournament: {n_c} launches of C")
    for a, b in zip(got, one):
        check(np.array_equal(a, b), "mesh tournament != mesh=None")
    masks = sargs[5]
    log(f"[mesh] score_subsets_device(mesh=) at the loop's first search "
        f"(S={masks.shape[0]}, N={masks.shape[1]}): feasible, savings, "
        f"residual, repl_lb == mesh=None (atol 0); C launched {n_c} times "
        f"(one a shard with mask rows)")

    # --- the batch mesh: one wide bucket, then one tenant changed ---
    wide = [grid_pods(models, FED_WIDE_PODS, t) for t in range(FED_WIDE)]
    encs = [encode_pods(w, cat) for w in wide]
    R = enc.requests.shape[1]
    dcat = solver._auto_dcat(cat, R, torch.device(MESH_DEVICE))
    reqs = [solver.prepare_batchable(cat, e, dcat=dcat) for e in encs]
    check(len({r.signature for r in reqs}) == 1,
          "the wide bucket's requests do not share one signature")
    rkey = ("mesh-wide",)
    reset_sequences()
    st0 = dict(resident.RESIDENT.stats)
    rows_m = solver.dispatch_batch(reqs, mesh=bmesh, resident_key=rkey).rows()
    with uncounted():
        rows_1 = solver.dispatch_batch(reqs).rows()
    B = len(reqs)
    check(np.array_equal(rows_m[:B], rows_1[:B]),
          "batch mesh rows != mesh=None rows")
    changed = encode_pods(wide[3][: len(wide[3]) * 99 // 100], cat)
    reqs2 = list(reqs)
    reqs2[3] = solver.prepare_batchable(cat, changed, dcat=dcat)
    check(reqs2[3].signature == reqs[0].signature,
          "the changed request left the bucket's signature")
    st1 = dict(resident.RESIDENT.stats)
    sc0 = resident.launches
    rows_m2 = solver.dispatch_batch(reqs2, mesh=bmesh,
                                    resident_key=rkey).rows()
    st2 = dict(resident.RESIDENT.stats)
    patch_launches = resident.launches - sc0
    with uncounted():
        rows_12 = solver.dispatch_batch(reqs2).rows()
    check(np.array_equal(rows_m2[:B], rows_12[:B]),
          "batch mesh rows != mesh=None rows after the change")
    check(st1["full_uploads"] - st0["full_uploads"] == 1
          and st2["patches"] - st1["patches"] == 1
          and st2["rows_patched"] - st1["rows_patched"] == 1
          and patch_launches == MESH_SHARDS,
          f"batch mesh resident stack: stats {st0} -> {st1} -> {st2}, "
          f"scatter launches {patch_launches}")
    with uncounted():
        bm_wall = wall_ms(lambda: solver.dispatch_batch(
            reqs, mesh=bmesh).rows(), 3)
        b1_wall = wall_ms(lambda: solver.dispatch_batch(reqs).rows(), 3)
    log(f"[mesh] dispatch_batch over {bmesh.describe()}: {FED_WIDE} x "
        f"{FED_WIDE_PODS} grid pods, rows == mesh=None; then one tenant's "
        f"request changed (1% of its pods dropped): 1 row of "
        f"{rows_m.shape[0]} patched "
        f"({st2['patched_bytes'] - st1['patched_bytes']} B), "
        f"{patch_launches} scatters (one a shard), rows == mesh=None; "
        f"wall {bm_wall:.1f} ms vs {b1_wall:.1f} ms")

    # --- SolverServer(mesh=) serving phase 4l's deferred 16-row pump ---
    reset_sequences()
    srv = fed_server.SolverServer(run_id="fed-mesh", mesh=bmesh)
    svc = build_federated_service(FakeClock(), run_id="fed-mesh",
                                  process="p200", shared_server=srv,
                                  backend="device", batch=True)
    cl = [svc.register(f"t{t:03d}", CatalogProvider(lambda: types))
          for t in range(FED_WIDE)]
    got_w = batched_round(svc, cl, wide, pool)
    reset_sequences()
    with uncounted():
        svc_l, cl_l = fleet_service("device", True, FED_WIDE, types)
        want_w = batched_round(svc_l, cl_l, wide, pool)
    capacity = bmesh.size * srv.stats["max_bucket_rows"]
    hs = srv.handle("handshake", {"schema": fed_server.WIRE_SCHEMA_VERSION})
    check(got_w == want_w, "SolverServer(mesh=): SolveOutputs differ from "
          "the in-process batched service's")
    check(srv.stats["buckets"] == 1 and capacity == FED_WIDE * bmesh.size
          and hs.get("result", {}).get("mesh_devices") == bmesh.size,
          f"SolverServer(mesh=): stats {srv.stats}, capacity {capacity}, "
          f"handshake {hs}")
    log(f"[mesh] SolverServer(mesh={bmesh.describe()}) serving the deferred "
        f"{FED_WIDE}-row pump: SolveOutputs == in-process batched service; "
        f"c17_mesh_batch_capacity {capacity} = {FED_WIDE} x {bmesh.size}")

    # --- the real cards, where more than one exists ---
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        real = parallel.make_mesh(min(n_cards, MESH_SHARDS))
        with uncounted():
            mesh_sharded_case(f"grid mix, {real.size} cards", parallel, msc,
                              ss, solver, cat, enc, real)
    else:
        log(f"[mesh] multi-card not run: {n_cards} CUDA device on this "
            f"machine; the distinct-card collectives are unverified")

    launches = {"screen_k": sk.launches, "offer_argmin": ss.offer_launches,
                "solve_scan": ss.launches, "tournament": tk.launches,
                "mesh_scan": msc.launches,
                "resident_patch": resident.launches - r0}
    per_shard = {k: v / MESH_SHARDS for k, v in launches.items()}
    log(f"[mesh] phase 4m launches {launches}; per shard {per_shard}; "
        f"phase wall {(time.perf_counter() - t_phase):.1f} s")
    m_grid["by_shape"] = {"grid": dict(m_grid), "bench": m_bench}
    return launches, m_grid


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
    del out_k, out_p  # the scan's outputs: no later phase reads them
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
    del k_got, k_want
    check(err_a == 0.0, f"screen_k differs from plain at the main path: {err_a}")
    head, req, elig = aargs
    log(f"[check] screen == plain (slack atol 0); screen_k == plain at the "
        f"main-path shape N={head.shape[0]} G={req.shape[0]} R={req.shape[1]}")

    # the resident patch's row scatter (ops/resident._scatter_rows): its
    # launches in each phase, read around the phase
    from karpenter_tpu_torch.obs.recompute import RECOMPUTE
    from karpenter_tpu_torch.ops import resident
    scatter = {"main": 0}

    def counted(phase, fn, *a):
        n0 = resident.launches
        out = fn(*a)
        scatter[phase] = resident.launches - n0
        return out

    # --- 4b. the facade: Solver.solve, counts zeroed just before it ---
    facade_launches, facade_scan = counted("facade", phase_facade)

    # --- 4c. the operator: make_sim's loop, counts zeroed just before it;
    # the recompute ledger reads the phase's redundant work ---
    RECOMPUTE.reset()
    (op_launches, op_scan, op_screen, op_err_a, op_tournament,
     op_err_c) = counted("operator", phase_operator, dev)
    recompute_snap = RECOMPUTE.snapshot()

    # --- 4d. the optimizer: bench c14's procedure, counts zeroed inside ---
    opt_launches, c14 = counted("optimizer", phase_optimizer)

    # --- 4e. the fleet: SolverService serial and batched, counts zeroed
    # just before each batched round ---
    fleet_launches, b_fleet = counted("fleet", phase_fleet)

    # --- 4f. chaos: the reference's chaos catalog and a storm at cluster
    # scale, counts zeroed at the phase's start ---
    chaos_launches = counted("chaos", phase_chaos)

    # --- 4g. the fleet runner: FleetRunner's scenarios, counts zeroed
    # before each run and summed ---
    fleet_runner_launches = counted("fleet_runner", phase_fleet_runner)

    # --- 4i. the warm path, the watchdog and provenance: bench c8's
    # sequence, counts zeroed at the phase's start ---
    warm_launches = counted("warm", phase_warm)

    # --- 4j. the soak: bench c13's open-loop traffic plane, counts zeroed
    # at the phase's start ---
    soak_launches, soak_digests, soak_err = counted("soak", phase_soak)
    scatter["soak"] = soak_launches["resident_patch"]

    # --- 4k. the operator shell: build_operator on the asyncio Runtime,
    # counts zeroed just before the Runtime starts ---
    shell_launches = counted("shell", phase_shell, soak_digests)

    # --- 4l. the federation plane: bench c17 and c18 through the port's
    # SolverServer on the card, counts zeroed at the phase's start ---
    fed_launches, fed_server_launches, _, _ = counted("federation",
                                                      phase_federation)
    scatter["federation"] = fed_launches["resident_patch"]

    # --- 4m. the mesh: 8 virtual shards of the card, every answer held
    # against mesh=None, counts zeroed at the phase's start ---
    mesh_launches, m_row = counted("mesh", phase_mesh, cat, enc, views,
                                   counts)

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
    st = timed("stage_upload", lambda: solver._stage(cat, enc, [], dev,
                                                     n_max=nb))
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
                    "operator": b_op[i], "fleet": b_fleet[i]}
    phase_launches = {"main": launches, "facade": facade_launches,
                      "operator": op_launches, "optimizer": opt_launches,
                      "fleet": fleet_launches}
    by_phase = {k: {ph: {"launches": phase_launches[ph].get(k), **row}
                    for ph, row in times[k].items()
                    if ph in phase_launches} for k in times}
    for k in by_phase:
        by_phase[k]["chaos"] = {"launches": chaos_launches[k]}
        by_phase[k]["fleet_runner"] = {"launches": fleet_runner_launches[k]}
        by_phase[k]["warm"] = {"launches": warm_launches[k]}
        by_phase[k]["soak"] = {"launches": soak_launches[k]}
        if k in ("offer_argmin", "solve_scan"):
            by_phase[k]["soak"]["batched_launches"] = \
                soak_launches["batched_buckets"]
        by_phase[k]["shell"] = {"launches": shell_launches[k]}
        by_phase[k]["federation"] = {"launches": fed_launches[k]}
        by_phase[k]["mesh"] = {"launches": mesh_launches[k],
                               "per_shard": mesh_launches[k] / MESH_SHARDS}
        if k in ("offer_argmin", "solve_scan"):
            # the server's share: one batched launch of each per bucket
            by_phase[k]["federation"]["server_launches"] = \
                fed_server_launches[k]
    by_phase["tournament"]["grid"] = c_grid
    by_phase["tournament"]["optimizer"] = {
        "launches": opt_launches["tournament"]}
    headline = {"screen_k": a_main, "offer_argmin": b_fac[0],
                "solve_scan": b_fac[1], "tournament": c_op}

    # --- 4h. the delta plane and the resident state, after the times: the
    # kernel inputs kept for them above are dropped first, so the
    # residency audit sees the port's own live CUDA tensors only; the row
    # scatter's launches are counted inside the phase ---
    del (sargs, skw, rec_b, rec_a, aargs, akw, head, req, elig, facade_scan,
         op_scan, op_screen, op_tournament, grid_args, st, scan_out, ahead,
         areq, aelig)
    planes_launches, scatter_rows = phase_planes(c14, recompute_snap)
    scatter["planes"] = planes_launches
    log(f"[planes] row scatter launches by phase {scatter}")
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": op_launches[name],
         "max_abs_err": err, **headline[name],
         "by_phase": by_phase[name]}
        for name, source, replaces, err in (
            ("screen_k", "karpenter_tpu_torch/csrc/screen_k.cu",
             "karpenter_tpu/ops/pallas_screen.py:69",
             max(err_a, op_err_a, soak_err)),
            ("offer_argmin", "karpenter_tpu_torch/csrc/solve_scan.cu",
             "karpenter_tpu/ops/solver.py:425", 0.0),
            ("solve_scan", "karpenter_tpu_torch/csrc/solve_scan.cu",
             "karpenter_tpu/ops/solver.py:348", 0.0),
            ("tournament", "karpenter_tpu_torch/csrc/tournament.cu",
             "karpenter_tpu/optimizer/tournament.py:140", err_c))]
    # the resident patch: ops/resident._scatter_rows, the port of the
    # reference's _jit_scatter (a library index_copy_, ROADMAP §2 item 1);
    # its launches are phase 4h's, where the path drives it
    kernels.append({
        "name": "resident_patch", "route": "cuda",
        "source": "karpenter_tpu_torch/ops/resident.py",
        "replaces": "karpenter_tpu/ops/resident.py:107",
        "launches": planes_launches,
        "max_abs_err": 0.0, **scatter_rows["gbuf_1pct"],
        "by_phase": {**{ph: {"launches": n} for ph, n in scatter.items()},
                     **scatter_rows}})
    # kernel M: launches and times from phase 4m (its main path: the node
    # mesh's solves), times at the grid mix
    kernels.append({
        "name": "mesh_scan", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/mesh_scan.cu",
        "replaces": "karpenter_tpu/parallel/mesh.py:66",
        "also_replaces": "karpenter_tpu/ops/solver.py:1162",
        "launches": mesh_launches["mesh_scan"], "max_abs_err": 0.0,
        **{k: m_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "by_phase": {"mesh": {"launches": mesh_launches["mesh_scan"],
                              "per_shard": mesh_launches["mesh_scan"]
                              / MESH_SHARDS, **m_row["by_shape"]}}})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
