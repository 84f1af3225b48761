"""Delta plane (ops/delta.py, the facade's _delta_serve_solve: the
standing fleet's fingerprint and the solve memo's answer): the program's
span delta.lookup summed over the window, in ms a request. A served
request's decode runs after the span, not in it."""

NAMES = ("delta.lookup",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
