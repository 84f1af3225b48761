"""Device solve (ops/solver.py _auto_node_budget, on the serial and the
batched path): the program's span solve.prep summed over the window, in
ms a request."""

NAMES = ("solve.prep",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
