"""Kernel B (csrc/solve_scan.cu::solve_scan_kernel): its share of its roofline over
the traced window, in %: the least time the card needs for the work the
reference's plan says these requests hold (benchmark/roofline/scan.py,
against the published peaks), over the device time torch.profiler gives
the kernel. Nothing when the profile holds no launch of it, or when the
delta plane served a request (a served request runs no kernel)."""

from benchmark.roofline import scan as S

KERNEL = "solve_scan_kernel"
PART = "b"


def read(ctx):
    tr = ctx["trace"]
    if not tr or ctx["counters"]["delta_served"] or not ctx["work"]:
        return None
    t = sum(s for name, (s, n) in tr["kernels"].items() if KERNEL in name)
    if t <= 0:
        return None
    return 100.0 * sum(S.bound_s(*w[PART]) for w in ctx["work"]) / t
