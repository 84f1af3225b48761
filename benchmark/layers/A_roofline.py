"""Kernel A (csrc/screen_k.cu::screen_k_kernel): its share of its roofline
over the traced window, in %: the least time the card needs for the fit
counts of the passes' screens and tournaments, from the reference's
shapes (benchmark/roofline/consolidate.py, against the published peaks),
over the device time torch.profiler gives the kernel. Nothing when the
profile holds no launch of it."""

from benchmark.roofline import consolidate as RC

KERNEL = "screen_k_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["work"]:
        return None
    t = sum(s for name, (s, n) in tr["kernels"].items() if KERNEL in name)
    if t <= 0:
        return None
    least = 0.0
    for w in ctx["work"]:
        one = RC.bound_s(*RC.screen_k(w["N"], w["G"], w["R"]))
        least += one * (int(w["screen"]) + int(w["S"] > 0))
    return 100.0 * least / t
