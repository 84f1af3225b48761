"""Where kernel C's time goes, phase by phase, on the card.

    python -m karpenter_tpu_torch.optimizer.tournament_phases

Builds `csrc/tournament.cu` a second time with -DTOURNAMENT_PROFILE (thread
0 of block 0 stamps clock64() at each phase boundary), launches it through
`tournament_k.tournament_cuda` at seeded inputs of the shapes chip_smoke.py
records (the operator loop's first subset search, S=232, N=382, G=90; the
grid-mix search, S=20, N=4,250, G=90) and at the same shapes with few
subsets (8 and 1: whether the card's load changes a block's time), checks
each output against `tournament_plain`, and prints each phase's SM cycles
for block 0 and the kernel's time. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

SHAPES = ((232, 382, 90, 2), (8, 382, 90, 2), (20, 4250, 90, 2),
          (1, 4250, 90, 2))


def phase_names(iters: int) -> list:
    """The kernel's stamps in order (csrc STAMP), as spans between them."""
    return (["mask", "seed chains", "seed quotient and cap*q"]
            + [f"{p}{i}" for i in range(iters)
               for p in ("capacity", "chains", "quotient", "update")]
            + ["last capacity", "last chains", "residual and out"])


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("tournament_phases: needs a CUDA device")
    from ..ops import _build
    from . import tournament_k as tk
    from .relax import RELAX_ITERS

    lib = _build.load("tournament", ("-DTOURNAMENT_PROFILE",))
    fns = tk._lib()
    launch = lib.tournament_launch
    launch.argtypes, launch.restype = fns["launch"].argtypes, ctypes.c_int
    mc = lib.tournament_max_cluster
    mc.argtypes, mc.restype = fns["max_cluster"].argtypes, ctypes.c_int
    fns.update(launch=launch, max_cluster=mc)
    stamps = lib.tournament_profile
    stamps.argtypes, stamps.restype = [ctypes.c_void_p], ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    names = phase_names(RELAX_ITERS)
    dev = torch.device("cuda")
    for shape in SHAPES:
        args = tk.seeded_inputs(1, *shape, dev)
        got = tk.tournament_cuda(*args)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 128)()
        stamps(buf)
        st = list(buf)[:len(names) + 1]
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(10):
            tk.tournament_cuda(*args)
        end.record()
        torch.cuda.synchronize()
        lay = tk.tournament_layout(*shape)
        print(f"S,N,G,Rk={shape} tier {lay.tier} cluster {lay.cl} "
              f"slice {lay.slice} k resident {lay.k_smem} chunk {lay.ch} "
              f"smem {lay.smem_bytes}: "
              f"{start.elapsed_time(end) / 10:.4f} ms a call (CUDA events); "
              f"equal to plain: {torch.equal(got, tk.tournament_plain(*args))}"
              f"; block 0: {st[-1] - st[0]} cycles")
        print("  " + ", ".join(f"{n} {b - a}" for n, a, b in
                               zip(names, st, st[1:])))


if __name__ == "__main__":
    main()
