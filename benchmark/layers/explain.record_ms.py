"""Decision provenance (obs/explain.py record_solve, from the facade's
finish_solve): the program's span explain.record summed over the window,
in ms a request. The recorder skips a solve above its pod or group cap,
and then opens no span."""

NAMES = ("explain.record",)


def read(ctx):
    sums = ctx["spans"]
    if ctx["solves"] == 0 or not any(sums.count.get(n) for n in NAMES):
        return None
    return sum(sums.ms(n) for n in NAMES) / ctx["solves"]
