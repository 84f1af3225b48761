"""The repack tournament after k: kernel C (`csrc/tournament.cu`) and its
plain PyTorch version.

Replaces the reference's jitted XLA program
`karpenter_tpu/optimizer/tournament.py::_tournament_impl` (:140, from
:179 on) with the relaxation it calls,
`karpenter_tpu/optimizer/relax.py::relax_residuals` (:40-77), and
`replacement_lower_bound` (relax.py:80-91). For S victim subsets over N
nodes and G pod groups:

    need[s, g]   = sum_n masks[s, n] counts[n, g]
    supply[s, g] = sum_n k[n, g] - sum_n masks[s, n] k[n, g]
    feasible[s]  = all_g (need <= supply + EPS) or need == 0
    savings[s]   = sum_n masks[s, n] prices[n]
    residual     = 6 proportional-fitting iterations on x [S, N, G] and a
                   last capacity projection (relax.py:55-77)
    repl_lb[s]   = sum_g residual[s, g] per_slot[g]

and writes one packed f32 [S, 4]: feasible, savings, sum_g residual,
repl_lb. k itself (the screen's per-(node, group) cap) is kernel A's
(`ops/screen_k`), called at the tournament's inputs by
`tournament.tournament_onebuf`.

Bound on the H100: operations. The inputs (k and counts [N, G], masks
[S, N]) are read once, about 0.6 MB at the operator loop's first search
(S=232, N=382, G=90). The function needs, per (subset, node, group)
cell, 3 operations for the seed, 2·Rk+7 an iteration (the load over
resources, x·scale, the sum of x, the slack and its sum, the update) and
2·Rk+2 for the last projection and the residual's sum, plus colsum(k)
once: 75 a cell at Rk=2, ~0.6 GFLOP there, ~9 us at 67 TFLOP/s fp32
(`ops_needed` counts it from the inputs; chip_smoke.py reports the
kernel's time beside it, PERF.md). What limits the kernel is latency:
each sum over nodes is a chain of N dependent adds in node order, 8
passes a subset.

Design (`csrc/tournament.cu` says more): a subset's x [N, G] lives in
shared memory beside its per-node and per-group rows, in one of four
tiers that `tournament_layout` picks from (S, N, G, Rk) alone: one block
a subset (several subsets a block when N is small and S fills the card),
one thread-block cluster of 2-16 blocks a subset, each block owning a
contiguous node slice, or, past 16 blocks' shared memory, the same
cluster with the slices in a global scratch the wrapper allocates
("global"). Past what the global tier's group rows take (a few thousand
groups), the "stream" tier keeps nothing of a group resident: the
per-group rows go to a global row a subset, req streams through two
shared chunks of groups by cp.async in each node pass, and the chains
read k's rows from global memory (its instantiations are a second build
of the source, compiled beside the first). Elsewhere k streams through a
ring of chunks in each block's shared memory by TMA bulk copies (the
wrapper hands it over as [N, G4] rows, G rounded up to 4 and zero past
G). Every pass moves four groups a 16-byte access: the node pass (a
thread a node: the load over groups in group order), the
cell passes (every thread on (node, 4-group) cells) and the chains (a
thread a (4 groups, chain), each chain kind on whole warps, adding the
block's slice in node order and starting, in a cluster, from the
previous rank's running sums read through distributed shared memory).
colsum(k) rides the seed's chains in node order: k is integral, but BIG
for a group with no request column, so its sums pass 2^24. Every Rk is
taken: instantiations carry 2, 4, 8, 16 or 32 columns of a node's load in
registers, and past 32 the 32-column one walks tiles of 32 in a runtime
loop (each column's load in group order as before, the scale the minimum
over every tile).
`tournament_phases` (run on the card) splits the kernel's time by phase.

Numerics: f32 throughout, built with -fmad=false and explicit
__fadd_rn/__fmul_rn/__fdiv_rn, so every elementwise step rounds as the
reference's f32 expression does, and every sum runs in one fixed order:
over nodes in node order, over groups in group order. The plain version
adds in the same orders, so kernel and plain agree bit for bit on every
tier. savings in that order is what the reference's XLA dot gives on
the CPU below 32 nodes; need is a sum of integers below 2^24 and exact
in any order. The relaxation's sums run in another order than XLA's or
NumPy's, so against the reference the residual and repl_lb agree within
rtol 1e-3 / atol 1e-3 (the reference's own host-vs-device tolerance).

The wrapper takes the plain version for tensors on the CPU and launches the
kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..ops.binpack import EPS
from .relax import RELAX_ITERS, relax_residuals_plain

launches = 0  # kernel launches since import (chip_smoke resets and reads it)

RMAX = 32  # resource columns kernel C carries in registers (csrc RMAX);
           # past it, tiles of RMAX columns
SMEM_LIMIT = 232_448   # shared memory one block may use on an H100
STATIC_SMEM = 1_024    # kernel C's static shared arrays, rounded up
CL_MAX = 16            # the largest (non-portable) cluster on Hopper
SPB_MAX = 32           # subsets one block may hold (csrc SPB_MAX)
NT = 384               # threads a block (csrc NT)
SMS = 132              # streaming multiprocessors of an H100 SXM
CH_MAX = 64            # node rows of one chunk of k's ring, at most
CH_MIN = 8             # ... at least, where RING_BYTES allows
NBUF = 4               # the ring's chunks (csrc NBUF)
RING_BYTES = 65_536    # the ring's bytes, at most (one row a chunk, at least)


@dataclass(frozen=True)
class TournamentLayout:
    """How kernel C is launched for one problem size."""

    tier: str          # "block", "cluster", "global" or "stream"
    cl: int            # blocks in a subset's cluster (1, 2, 4, 8 or 16)
    slice: int         # nodes each block owns (the last block may own fewer)
    spb: int           # subsets a block holds (block tier only, else 1)
    xs: int            # row stride of x in floats (_x_stride)
    ch: int            # node rows of a chunk of k's ring (the slice's, k_smem
                       # or stream: one pass a slice)
    k_smem: bool       # the slice's k rows resident beside x (else a ring)
    smem_bytes: int    # dynamic shared memory a block
    gc: int = 0        # stream tier: groups of a req chunk (else 0)

    @property
    def x_smem(self) -> bool:
        return self.tier in ("block", "cluster")

    def blocks(self, S: int) -> int:
        return -(-S // self.spb) * self.cl

    def slices(self, N: int) -> list:
        """[start, stop) of each block's node slice, in rank order."""
        return [(min(r * self.slice, N), min((r + 1) * self.slice, N))
                for r in range(self.cl)]


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _x_stride(G: int) -> int:
    """Row stride of x in floats (csrc x_stride): G rounded up to a multiple
    of 4 whose quarter is odd, so that 16-byte reads of 8 node rows fall in
    distinct banks."""
    g4 = _round4(G)
    return g4 if (g4 // 4) % 2 == 1 else g4 + 4


def _lane_floats(sl: int, xs: int, G: int, x_smem: bool,
                 stream: bool = False) -> int:
    """Floats of one subset's shared region (csrc lane_floats): x on the
    shared tiers; survival, mask and scale a node; running sums, quotient
    and need a group (rows padded to 16 bytes; in global memory on the
    stream tier). The block's rows (req, the ring of k chunks) come before
    the subsets' regions."""
    return ((sl * xs if x_smem else 0) + 3 * _round4(sl)
            + (0 if stream else 6 * _round4(G) + 4))


def _rkb(Rk: int) -> int:
    """Rk rounded up to a power of two (>= 2), at most RMAX: the kernel's
    instantiation (csrc rk_bucket; 17 columns and more take 32, past 32
    in tiles of 32) and the row of the stream tier's req chunks."""
    return (2 if Rk <= 2 else 4 if Rk <= 4 else 8 if Rk <= 8 else 16
            if Rk <= 16 else 32)


def _req_width(Rk: int) -> int:
    """Floats of req's row in shared memory (csrc req_width): `_rkb(Rk)`,
    or past RMAX columns Rk rounded up to a whole tile of RMAX."""
    return _rkb(Rk) if Rk <= RMAX else -(-Rk // RMAX) * RMAX


def _group_row_floats(G: int) -> int:
    """Floats of one subset's group rows on the stream tier (its global
    row): running sums [4 G4 + 4], quotient and need [G4]."""
    return 6 * _round4(G) + 4


def _block_floats(G: int, rkw: int, ch: int, k_smem: bool = False) -> int:
    """Floats of the block's shared rows (csrc block_floats): req [G4, rkw]
    (rkw = `_req_width(Rk)`) and the ring of k chunks [NBUF, ch, G4], or
    with k_smem the slice's k rows [ch = slice, G4]; G4 = G rounded up to
    4."""
    return _round4(G) * rkw + (1 if k_smem else NBUF) * ch * _round4(G)


def _ring_fits(ch: int, G: int) -> bool:
    return NBUF * ch * _round4(G) * 4 <= RING_BYTES


def tournament_layout(S: int, N: int, G: int, Rk: int) -> TournamentLayout:
    """Kernel C's tier, cluster and node slice, from sizes alone.

    One block a subset while its x [N, G] and rows fit one block's shared
    memory, with several subsets a block (a power of two) when N leaves
    most of the block's threads without a node and S still fills the
    card. Else the smallest power-of-two cluster, up to CL_MAX, whose
    blocks hold the node slices of x and of k, else of x alone; past that,
    CL_MAX blocks with the slices of x in global scratch. On those tiers
    k's rows stay resident beside the rest where they fit, else stream
    through a ring of chunks. Where not even the global tier's group rows
    fit, the stream tier: CL_MAX blocks, x and the group rows in global
    memory, req through two shared chunks of `gc` groups (as many as fit
    beside the slice's node rows), k read from global memory. The cluster
    only grows with N and with G. Every G and every Rk >= 1 takes a layout
    (past RMAX columns req's row holds whole tiles of RMAX; nodes past
    ~300,000, whose slice's node rows alone pass a block's shared memory,
    raise)."""
    if Rk < 1:
        raise ValueError(f"tournament needs Rk >= 1, got {Rk}")
    budget = SMEM_LIMIT - STATIC_SMEM
    N, G = max(N, 1), max(G, 0)
    xs, rkb, rkw = _x_stride(G), _rkb(Rk), _req_width(Rk)
    ch0 = CH_MIN
    while ch0 > 1 and not _ring_fits(ch0, G):
        ch0 //= 2

    def chunk(lanes: int) -> int:
        """The largest ring chunk in [ch0, CH_MAX], a multiple of 4 past
        ch0, that fits beside `lanes` floats of subsets' regions."""
        ch = ch0
        while (ch + 4 <= CH_MAX and _ring_fits(ch + 4, G)
               and 4 * (_block_floats(G, rkw, ch + 4) + lanes) <= budget):
            ch += 4
        return ch

    def fits(lanes: int, ch: int, k_smem: bool) -> bool:
        return 4 * (_block_floats(G, rkw, ch, k_smem) + lanes) <= budget

    def layout(tier, cl, sl, spb, lanes, k_smem):
        ch = sl if k_smem else chunk(lanes)
        return TournamentLayout(tier, cl, sl, spb, xs, ch, k_smem,
                                4 * (_block_floats(G, rkw, ch, k_smem)
                                     + lanes))

    one = _lane_floats(N, xs, G, True)
    if fits(one, ch0, False):  # one block a subset
        k_smem = fits(one, N, True)
        spb = 1
        while (spb * 2 <= SPB_MAX and spb * 2 * N <= NT
               and fits(spb * 2 * one, N if k_smem else ch0, k_smem)
               and -(-S // (spb * 2)) >= SMS):
            spb *= 2
        return layout("block", 1, N, spb, spb * one, k_smem)
    # a cluster: the smallest that holds x's and k's slices, else x's
    for k_smem in (True, False):
        cl = 2
        while cl <= CL_MAX:
            sl = -(-N // cl)
            lanes = _lane_floats(sl, xs, G, True)
            if fits(lanes, sl if k_smem else ch0, k_smem):
                return layout("cluster", cl, sl, 1, lanes, k_smem)
            cl *= 2
    sl = -(-N // CL_MAX)
    lanes = _lane_floats(sl, xs, G, False)
    for k_smem in (True, False):
        if fits(lanes, sl if k_smem else ch0, k_smem):
            return layout("global", CL_MAX, sl, 1, lanes, k_smem)
    # the stream tier: two req chunks beside the slice's node rows
    lanes = _lane_floats(sl, xs, G, False, stream=True)
    gc = min(_round4(G), (budget // 4 - lanes) // (2 * rkb) // 4 * 4)
    if gc < 4:
        raise ValueError(f"tournament: the node rows of a slice of {sl} "
                         f"nodes do not fit in shared memory")
    return TournamentLayout("stream", CL_MAX, sl, 1, xs, sl, False,
                            4 * (2 * gc * rkb + lanes), gc)


def _node_order_sums(masks: torch.Tensor, counts: torch.Tensor,
                     k: torch.Tensor, prices: torch.Tensor):
    """(need [S, G], colsum(k) [G], masks@k [S, G], savings [S]), each
    added one node at a time in node order: kernel C's order (it skips the
    zero terms, which change no sum)."""
    S, N = masks.shape
    G = k.shape[1]
    z = dict(dtype=torch.float32, device=masks.device)
    need, sub = torch.zeros((S, G), **z), torch.zeros((S, G), **z)
    col, savings = torch.zeros(G, **z), torch.zeros(S, **z)
    for n in range(N):
        m = masks[:, n]
        need = need + m[:, None] * counts[n]
        sub = sub + m[:, None] * k[n]
        col = col + k[n]
        savings = savings + m * prices[n]
    return need, col, sub, savings


def tournament_plain(head: torch.Tensor, req: torch.Tensor, k: torch.Tensor,
                     counts: torch.Tensor, masks: torch.Tensor,
                     prices: torch.Tensor, pslot: torch.Tensor,
                     iters: int = RELAX_ITERS) -> torch.Tensor:
    """f32 [S*4] packed (feasible, savings, residual, repl_lb); the same
    function as the kernel, in PyTorch ops, with every sum in the kernel's
    order (so the two agree bit for bit).

    head: f32 [N, Rk] raw headroom (the relaxation clamps it at 0, k does
    not); req: f32 [G, Rk]; k, counts: f32 [N, G]; masks: f32 [S, N];
    prices: f32 [N]; pslot: f32 [G]."""
    need, col, sub, savings = _node_order_sums(masks, counts, k, prices)
    supply = col[None, :] - sub
    feasible = ((need <= supply + float(EPS)) | (need == 0)).all(dim=1)
    residual = relax_residuals_plain(head, req, k, masks, need, iters)
    rsum = torch.zeros_like(savings)
    repl_lb = torch.zeros_like(savings)
    for g in range(residual.shape[1]):
        rsum = rsum + residual[:, g]
        repl_lb = repl_lb + residual[:, g] * pslot[g]
    return torch.stack([feasible.to(torch.float32), savings, rsum, repl_lb],
                       dim=1).reshape(-1)


_fns: dict = {}  # the configured ctypes entry points, once loaded


def _lib():
    """The entry points of both builds of csrc/tournament.cu: the block,
    cluster and global tiers' ("launch", "max_cluster") and the stream
    tier's ("launch_stream", "max_cluster_stream")."""
    if _fns:
        return _fns
    from ..ops._build import TOURNAMENT_STREAM, load
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix, lib in (("", load("tournament")),
                        ("_stream", load("tournament", TOURNAMENT_STREAM))):
        fn = lib.tournament_launch
        fn.argtypes = [P, P, I, P, P, I, P, I, P, P, P, P, P] + [I] * 14 + [P]
        fn.restype = ctypes.c_int
        mc = lib.tournament_max_cluster
        mc.argtypes, mc.restype = [I, I], ctypes.c_int
        _fns.update({"launch" + suffix: fn, "max_cluster" + suffix: mc})
    return _fns


# the kernel's instantiation of each tier (csrc T_SHARED, T_GLOBAL, T_STREAM)
_TIER_CODE = {"block": 0, "cluster": 0, "global": 1, "stream": 2}


def max_cluster(smem_bytes: int, tier: str = "cluster") -> int:
    """The largest cluster of kernel C (a power of two <= CL_MAX) the card
    can co-schedule at `smem_bytes` of shared memory a block on `tier`; 0
    if none."""
    fn = _lib()["max_cluster_stream" if tier == "stream" else "max_cluster"]
    return int(fn(int(smem_bytes), _TIER_CODE[tier]))


def tournament_cuda(head: torch.Tensor, req: torch.Tensor, k: torch.Tensor,
                    counts: torch.Tensor, masks: torch.Tensor,
                    prices: torch.Tensor, pslot: torch.Tensor,
                    iters: int = RELAX_ITERS) -> torch.Tensor:
    """Launch kernel C on the current stream (no synchronisation), in the
    layout `tournament_layout` picks. The shapes of `tournament_plain`;
    req, counts and masks may be row-strided views of the packed upload
    (read in place), the rest is copied only where its layout does not
    fit."""
    global launches
    N, Rk = head.shape
    S = masks.shape[0]
    G = k.shape[1]
    if (tuple(req.shape) != (G, Rk) or tuple(k.shape) != (N, G)
            or tuple(counts.shape) != (N, G) or masks.shape[1] != N
            or tuple(prices.shape) != (N,) or tuple(pslot.shape) != (G,)):
        raise ValueError(
            f"tournament shapes: head {tuple(head.shape)}, req "
            f"{tuple(req.shape)}, k {tuple(k.shape)}, counts "
            f"{tuple(counts.shape)}, masks {tuple(masks.shape)}, prices "
            f"{tuple(prices.shape)}, pslot {tuple(pslot.shape)}")
    ins = (head, req, k, counts, masks, prices, pslot)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError("tournament takes f32 inputs")
    if any(t.device != head.device for t in ins):
        raise ValueError("tournament inputs must share one CUDA device")
    if iters < 0:
        raise ValueError(f"tournament iters must be >= 0, got {iters}")
    lay = tournament_layout(S, N, G, Rk)
    head, k, prices, pslot = (t.contiguous() for t in (head, k, prices,
                                                         pslot))
    req, counts, masks = (t if t.stride(1) == 1 else t.contiguous()
                          for t in (req, counts, masks))
    dev = head.device
    out = torch.empty(S * 4, dtype=torch.float32, device=dev)
    if S == 0:
        return out
    fns = _lib()
    stream = "_stream" if lay.tier == "stream" else ""
    if lay.cl > 1 and fns["max_cluster" + stream](
            lay.smem_bytes, _TIER_CODE[lay.tier]) < lay.cl:
        raise RuntimeError(f"tournament: the card cannot co-schedule a "
                           f"cluster of {lay.cl} blocks at {lay.smem_bytes} "
                           f"bytes of shared memory a block ({lay})")
    G4 = _round4(G)
    if G4 != G or k.data_ptr() % 16:
        # the kernel copies k in chunks of whole 16-byte rows: [N, G4], zero
        # past G
        kp = torch.zeros((N, G4), dtype=torch.float32, device=dev)
        kp[:, :G] = k
        k = kp
    xg = (None if lay.x_smem else
          torch.empty(S * lay.cl * lay.slice * lay.xs, dtype=torch.float32,
                      device=dev))
    # the stream tier's group rows, zero past G (the kernel writes the rest)
    rows = (torch.zeros(S * _group_row_floats(G), dtype=torch.float32,
                        device=dev) if lay.tier == "stream" else None)
    rc = fns["launch" + stream](
        head.data_ptr(), req.data_ptr(), req.stride(0), k.data_ptr(),
        counts.data_ptr(), counts.stride(0), masks.data_ptr(),
        masks.stride(0), prices.data_ptr(), pslot.data_ptr(),
        None if xg is None else xg.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(), S, N, G,
        Rk, int(iters), lay.cl, lay.slice, lay.spb, lay.xs, lay.ch, lay.gc,
        int(lay.x_smem), int(lay.k_smem),
        lay.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    if rc == -2:
        raise RuntimeError(f"tournament: the card cannot co-schedule a "
                           f"cluster of {lay.cl} blocks at {lay.smem_bytes} "
                           f"bytes of shared memory a block")
    if rc != 0:
        raise RuntimeError(f"tournament launch failed: cudaError {rc} "
                           f"(layout {lay})")
    launches += 1
    return out


def tournament(head: torch.Tensor, req: torch.Tensor, k: torch.Tensor,
               counts: torch.Tensor, masks: torch.Tensor,
               prices: torch.Tensor, pslot: torch.Tensor,
               iters: int = RELAX_ITERS) -> torch.Tensor:
    """The packed f32 [S*4] tournament: the plain version for CPU
    tensors, kernel C for CUDA tensors."""
    if head.device.type == "cpu":
        return tournament_plain(head, req, k, counts, masks, prices, pslot,
                                iters)
    if head.device.type != "cuda":
        raise ValueError(f"tournament runs on cpu or cuda, not {head.device}")
    return tournament_cuda(head, req, k, counts, masks, prices, pslot, iters)


def ops_needed(S: int, N: int, G: int, Rk: int, victims: int,
               iters: int = RELAX_ITERS) -> int:
    """The operations the tournament's function needs at these shapes,
    whatever computes it: per (subset, node, group) cell 3 for the seed
    (cap, its sum over nodes, cap·q), 2·Rk+7 an iteration (the load, x·scale,
    the sum of x, the slack (2) and its sum, the update (2)) and 2·Rk+2 for
    the last projection and the sum of x; colsum(k) once; per victim a
    group's need and supply term and its price; per (subset, group) 5 for
    the supply, the feasibility test and the seed's quotient, 4 an
    iteration for the deficit and its quotient, and 5 for the residual and
    its two sums. `victims` is the number of nonzero mask entries."""
    cells = S * N * G * (3 + iters * (2 * Rk + 7) + 2 * Rk + 2)
    per_group = S * G * (10 + 4 * iters)
    return cells + N * G + victims * (2 * G + 1) + per_group


def seeded_inputs(seed: int, S: int, N: int, G: int, Rk: int, device,
                  max_k: int = 5) -> tuple:
    """Seeded arguments of `tournament` on `device`, for its checks: raw
    headroom (some negative), requests with zero columns, integer caps and
    counts, victim masks of 2..max_k nodes, prices and per-slot prices (one
    BIG)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    head = rng.uniform(-1.0, 12.0, (N, Rk)).astype(np.float32)
    req = rng.uniform(0.0, 3.0, (G, Rk)).astype(np.float32)
    req[rng.random((G, Rk)) < 0.3] = 0.0
    k = rng.integers(0, 5, (N, G)).astype(np.float32)
    counts = (rng.random((N, G)) < 0.05).astype(np.float32)
    masks = np.zeros((S, N), np.float32)
    for row in masks:
        row[rng.choice(N, min(N, int(rng.integers(2, max_k + 1))),
                       replace=False)] = 1.0
    prices = rng.uniform(0.05, 3.0, N).astype(np.float32)
    pslot = rng.uniform(0.01, 0.5, G).astype(np.float32)
    pslot[0] = 1e9
    return tuple(torch.as_tensor(a, device=device) for a in
                 (head, req, k, counts, masks, prices, pslot))


def packed_views(args: tuple) -> tuple:
    """The same arguments with req, counts and masks (and prices) as
    row-strided views of wider packed buffers, as score_subsets_device
    hands them over: padding columns beside req and counts, prices as the
    row after masks."""
    head, req, k, counts, masks, prices, pslot = args
    (N, G), Rk = counts.shape, req.shape[1]
    wide = torch.zeros((N, 5 + G), device=counts.device)
    wide[:, 5:] = counts
    greq = torch.zeros((G, Rk + 8), device=req.device)
    greq[:, :Rk] = req
    mbuf = torch.cat([masks, prices[None]])
    return (head, greq[:, :Rk], k, wide[:, 5:], mbuf[:-1], mbuf[-1], pslot)
