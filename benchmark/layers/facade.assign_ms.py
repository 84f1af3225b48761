"""Facade output (ops/facade.py _decode, its first pass: the pods onto the
nodes, their keys, request sums and labels): the program's span
output.assign summed over the window, in ms a request."""

NAMES = ("output.assign",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
