"""Consolidation screen (ops/consolidate.py consolidation_screen: staging, kernel A, the screen's tail, one readback): the program's span disruption.screen summed over the window, in ms a
pass. Nothing where the program emits no such span."""

NAMES = ("disruption.screen",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
