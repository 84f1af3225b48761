"""Exact verifies (DisruptionController._multi_node_optimizer: up to VERIFY_LIMIT Solver.solve calls against the standing nodes, and the execution of the first that passes): the program's span optimizer.verify summed over the window, in ms a
pass. Nothing where the program emits no such span."""

NAMES = ("optimizer.verify",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
