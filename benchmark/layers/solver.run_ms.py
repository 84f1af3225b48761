"""Device solve (ops/solver.py through Solver.run_prepared: staging, upload,
kernels B0 and B, the readback, the parse): the program's span
solve.run summed over the window, in ms a request. The fleet's batched
pump dispatches outside it, so it reads nothing there."""

NAMES = ("solve.run",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
