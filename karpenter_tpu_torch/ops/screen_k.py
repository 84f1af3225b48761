"""The consolidation screen's k-cap: kernel A (`csrc/screen_k.cu`) and its
plain PyTorch version.

Replaces the Pallas TPU kernel `karpenter_tpu/ops/pallas_screen.py::screen_k`
(body `_k_kernel`):

    k[m, g] = elig[m, g] ? max(min_{r: req[g,r] > 0}
                                   floor(head[m,r] / req[g,r] + EPS), 0) : 0

with BIG = 1e9 when the group requests nothing. In the JAX package the
kernel is opt-in and a fused XLA expression is the default; here the
hand-written kernel is the only path on the card.

Bound: bytes (one elig byte read and one f32 written per (m, g)); at the
main path's shape the kernel is launch-bound. Its layout is one wave of
blocks striding over the flat N*G output, four outputs a thread. See
PERF.md for its time beside that bound.

The wrapper takes the plain version for tensors on the CPU and launches the
kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .binpack import BIG, EPS

launches = 0  # kernel launches since import (chip_smoke resets and reads it)

_EPS = float(np.float32(EPS))


def screen_k_plain(head: torch.Tensor, req: torch.Tensor,
                   elig: torch.Tensor) -> torch.Tensor:
    """f32 [N, G]; the same expression as the kernel, in PyTorch ops.

    head: f32 [N, R] headroom; req: f32 [G, R]; elig: bool [N, G]."""
    N, R = head.shape
    G = req.shape[0]
    k = torch.full((N, G), float(BIG), dtype=torch.float32,
                   device=head.device)
    for r in range(R):
        q = req[:, r][None, :]
        safe = torch.where(q > 0, q, torch.ones_like(q))
        ratio = torch.where(q > 0, torch.floor(head[:, r][:, None] / safe
                                               + _EPS),
                            torch.full_like(q, float(BIG)))
        k = torch.minimum(k, ratio)
    return torch.where(elig, k.clamp_min(0.0), torch.zeros_like(k))


_fn = None  # the configured ctypes entry point, once loaded


def _lib():
    global _fn
    if _fn is not None:
        return _fn
    from ._build import load
    lib = load("screen_k")
    fn = lib.screen_k_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, P, P, I, I, I, P]
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def screen_k_cuda(head: torch.Tensor, req: torch.Tensor,
                  elig: torch.Tensor) -> torch.Tensor:
    """Launch kernel A on the current stream (no synchronisation). head:
    f32 [N, R]; req: f32 [G, R] (a row-strided view of a packed upload is
    read in place); elig: bool [N, G]. An input is copied only where its
    layout does not fit."""
    global launches
    N, R = head.shape
    G = req.shape[0]
    if req.shape[1] != R or tuple(elig.shape) != (N, G):
        raise ValueError(f"screen_k shapes: head {tuple(head.shape)}, "
                         f"req {tuple(req.shape)}, elig {tuple(elig.shape)}")
    if (head.dtype, req.dtype, elig.dtype) != (torch.float32, torch.float32,
                                               torch.bool):
        raise ValueError("screen_k takes f32 head and req and bool elig")
    if not head.is_contiguous():
        head = head.contiguous()
    if not elig.is_contiguous():
        elig = elig.contiguous()
    if req.stride(1) != 1 and R > 1:
        req = req.contiguous()
    if req.device != head.device or elig.device != head.device:
        raise ValueError("screen_k inputs must share one CUDA device")
    out = torch.empty((N, G), dtype=torch.float32, device=head.device)
    if N == 0 or G == 0:
        return out
    if elig.data_ptr() % 4:
        elig = elig.clone()  # the kernel reads elig four bytes at a time
    rc = _lib()(head.data_ptr(), req.data_ptr(), req.stride(0),
                elig.data_ptr(), out.data_ptr(), N, G, R,
                torch.cuda.current_stream(head.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"screen_k launch failed: cudaError {rc}")
    launches += 1
    return out


def screen_k(head: torch.Tensor, req: torch.Tensor,
             elig: torch.Tensor) -> torch.Tensor:
    """f32 [N, G] per-(node, group) fit counts, eligibility-gated: the
    plain version for CPU tensors, kernel A for CUDA tensors."""
    if head.device.type == "cpu":
        return screen_k_plain(head, req, elig)
    if head.device.type != "cuda":
        raise ValueError(f"screen_k runs on cpu or cuda, not {head.device}")
    return screen_k_cuda(head, req, elig)
