"""Device: the share of the traced window in which no operation ran on
the card (1 - the union of device operations / the window), from
torch.profiler."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
