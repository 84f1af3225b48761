"""Disruption views (state/cluster.py build_node_views in DisruptionController._reconcile_pool): the pool's node views, each claim's pods and summed requests: the program's span disruption.views summed over the window, in ms a
pass. Nothing where the program emits no such span."""

NAMES = ("disruption.views",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
