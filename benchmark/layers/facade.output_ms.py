"""Facade output (ops/facade.py finish_solve: decode, overrides, labels): the
program's span solve.output summed over the window, in ms a request."""

NAMES = ("solve.output",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
