"""Subset tournament (optimizer plan_repack's scoring, score_subsets_device: staging, kernels A and C, one readback): the program's span optimizer.tournament summed over the window, in ms a
pass. Nothing where the program emits no such span."""

NAMES = ("optimizer.tournament",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
