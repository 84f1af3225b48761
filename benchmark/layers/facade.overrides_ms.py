"""Facade output (ops/facade.py _decode, its second pass: each launch's
price-sorted alternates, _overrides): the program's span output.overrides
summed over the window, in ms a request."""

NAMES = ("output.overrides",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
