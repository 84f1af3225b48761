"""Facade pre-passes (ops/facade.py prepare_solve: the catalog view, colocation,
encode, affinity and spread split): the program's spans solve.tensors,
solve.colocate, solve.encode and solve.spread summed over the window, in
ms a request."""

NAMES = ("solve.tensors", "solve.colocate", "solve.encode", "solve.spread")


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
