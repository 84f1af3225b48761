"""Kernel C (csrc/tournament.cu::tournament_kernel): its share of its
roofline over the traced window, in %: the least time the card needs for
the passes' subset tournaments, from the reference's shapes
(benchmark/roofline/consolidate.py, against the published peaks), over
the device time torch.profiler gives the kernel. Nothing when the
profile holds no launch of it."""

from benchmark.roofline import consolidate as RC

KERNEL = "tournament_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["work"]:
        return None
    t = sum(s for name, (s, n) in tr["kernels"].items() if KERNEL in name)
    if t <= 0:
        return None
    least = sum(RC.bound_s(*RC.tournament(w["S"], w["N"], w["G"], w["R"]))
                for w in ctx["work"] if w["S"] > 0)
    return 100.0 * least / t
