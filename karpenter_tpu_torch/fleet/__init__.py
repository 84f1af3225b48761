"""Fleet: many tenant control planes over one shared solver.

The port's copy of `karpenter_tpu/fleet/`'s shared `SolverService`: each
tenant registers its CatalogProvider and solves through one queue with a
fair (deficit-round-robin) scheduler and per-tenant in-flight caps; with
`batch=True` compatible tenants' solves share one launch of kernels B0
and B.

    from karpenter_tpu_torch.fleet import SolverService
    svc = SolverService(FakeClock(), backend="device", batch=True)
    client = svc.register("t000", CatalogProvider(lambda: types))
    ticket = client.solve_async(pods, NodePool(name="default"))
    svc.pump()
    out = ticket.result()

The tenant shards, the `FleetRunner` and the fleet scenarios come with
ROADMAP §1 item 3b.
"""

from .service import (SolverService, SolverServiceBusy, SolveTicket,
                      TenantSolverClient)

__all__ = ["SolverService", "SolverServiceBusy", "SolveTicket",
           "TenantSolverClient"]
