"""Fleet service (fleet/service.py): the 95th percentile, in ms, of every
request of the traced window, from its submission to its SolveOutput on
the host's clock (a per-layer metric: between runs of one tree it spreads
too widely for an end-to-end bound)."""

import statistics


def read(ctx):
    lat = [(r[1] - r[0]) * 1e3 for r in ctx["requests"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
