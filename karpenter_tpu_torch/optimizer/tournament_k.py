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
(S=232, N=382, G~90). The function needs, per (subset, node, group)
cell, 3 operations for the seed, 2·Rk+7 an iteration (the load over
resources, x·scale, the sum of x, the slack and its sum, the update) and
2·Rk+2 for the last projection and the residual's sum, plus colsum(k)
once: 75 a cell at Rk=2, ~0.6 GFLOP there, ~9 us at 67 TFLOP/s fp32
(`ops_needed` counts it from the inputs; chip_smoke.py reports the
kernel's time beside it, PERF.md). The kernel does 2·Rk+11 an iteration:
a demand pass forms the slack twice rather than keep a second
[S, N, G] scratch.

Design (a simple kernel that is right first): a prologue kernel sums k
over nodes once per launch; then one block per subset. The block
compacts its mask row into its victims in ascending node order (one
warp, ballots), so need, the supply's victim term and savings are
gathers over at most a handful of nodes, not dense products, and keeps
each node's survival 1 - m in a scratch row, so a cell's cap is one
product. x [N, G] lives in a global scratch [S, N, G] the wrapper
allocates (32 MB at the relaxation budget, inside the 50 MB L2). Each
iteration is a node pass (thread per node: the load over groups, then
its scale) and a group pass (thread per group: the sums over nodes, the
deficit, the slack denominator, the update), separated by
__syncthreads(). Keeping x in shared memory or a cluster and wgmma for
the load are later work.

Numerics: f32 throughout, built with -fmad=false and explicit
__fadd_rn/__fmul_rn/__fdiv_rn, so every elementwise step rounds as the
reference's f32 expression does, and every sum runs in one fixed order:
over nodes in node order, over groups in group order. The plain version
adds in the same orders, so kernel and plain agree bit for bit. savings
in that order is what the reference's XLA dot gives on the CPU below 32
nodes; need and supply are sums of integers below 2^24 and exact in any
order. The relaxation's sums run in another order than XLA's or NumPy's,
so against the reference the residual and repl_lb agree within rtol 1e-3
/ atol 1e-3 (the reference's own host-vs-device tolerance).

The wrapper takes the plain version for tensors on the CPU and launches the
kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.binpack import EPS
from .relax import RELAX_ITERS, relax_residuals_plain

launches = 0  # kernel launches since import (chip_smoke resets and reads it)

RMAX = 16  # resource columns kernel C carries in registers (csrc RMAX)


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


_fn = None  # the configured ctypes entry point, once loaded


def _lib():
    global _fn
    if _fn is not None:
        return _fn
    from ..ops._build import load
    fn = load("tournament").tournament_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, P, P, I, P, I, P, P, P, P, P, P, P, P,
                   I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def tournament_cuda(head: torch.Tensor, req: torch.Tensor, k: torch.Tensor,
                    counts: torch.Tensor, masks: torch.Tensor,
                    prices: torch.Tensor, pslot: torch.Tensor,
                    iters: int = RELAX_ITERS) -> torch.Tensor:
    """Launch kernel C on the current stream (no synchronisation). The
    shapes of `tournament_plain`; req, counts and masks may be row-strided
    views of the packed upload (read in place), the rest is copied only
    where its layout does not fit."""
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
    if not 1 <= Rk <= RMAX:
        raise ValueError(f"tournament carries 1..{RMAX} resource columns, "
                         f"got {Rk}")
    if iters < 0:
        raise ValueError(f"tournament iters must be >= 0, got {iters}")
    head, k, prices, pslot = (t.contiguous() for t in (head, k, prices,
                                                         pslot))
    req, counts, masks = (t if t.stride(1) == 1 else t.contiguous()
                          for t in (req, counts, masks))
    dev = head.device
    out = torch.empty(S * 4, dtype=torch.float32, device=dev)
    if S == 0:
        return out
    f32 = dict(dtype=torch.float32, device=dev)
    col = torch.empty(max(G, 1), **f32)
    x = torch.empty((S, N, G), **f32)
    surv = torch.empty((S, max(N, 1)), **f32)
    need = torch.empty((S, max(G, 1)), **f32)
    vic = torch.empty((S, max(N, 1)), dtype=torch.int32, device=dev)
    rc = _lib()(head.data_ptr(), req.data_ptr(), req.stride(0),
                k.data_ptr(), counts.data_ptr(), counts.stride(0),
                masks.data_ptr(), masks.stride(0), prices.data_ptr(),
                pslot.data_ptr(), col.data_ptr(), x.data_ptr(),
                surv.data_ptr(), need.data_ptr(), vic.data_ptr(),
                out.data_ptr(), S, N, G, Rk, int(iters),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tournament launch failed: cudaError {rc}")
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
