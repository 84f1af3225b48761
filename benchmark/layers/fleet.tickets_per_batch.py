"""Fleet service (fleet/service.py): requests served a batched launch
over the window, from SolverService.stats (batched_tickets / batches)."""


def read(ctx):
    st = ctx["stats"]
    if not st.get("batches"):
        return None
    return st["batched_tickets"] / st["batches"]
