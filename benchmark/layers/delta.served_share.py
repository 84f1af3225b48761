"""Delta plane (ops/delta.py): the share of the window's requests whose
solve the memo served, from the counter karpenter_tpu_delta_memo_total
{stage="solve", event="served"}."""


def read(ctx):
    if ctx["solves"] == 0:
        return None
    return ctx["counters"]["delta_served"] / ctx["solves"]
