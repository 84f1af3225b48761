"""Device solve (ops/solver.py): bytes uploaded host to device a request
over the window, from ops.solver.transfer_bytes()[0]."""


def read(ctx):
    if ctx["solves"] == 0:
        return None
    return ctx["counters"]["h2d_bytes"] / ctx["solves"]
