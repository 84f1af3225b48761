"""Disruption encode (DisruptionController._screen_state): the daemonset overhead view, the occupancy fingerprint, encode_pods over every pod on the views and the [N, G] counts: the program's span disruption.encode summed over the window, in ms a
pass. Nothing where the program emits no such span."""

NAMES = ("disruption.encode",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
