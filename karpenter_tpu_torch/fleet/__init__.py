"""Fleet: many tenant control planes over one shared solver.

The port's copy of `karpenter_tpu/fleet/`: N independent tenant control
planes — each a full `make_sim` stack with its own Store, fake cloud and
intent journal — multiplexed onto ONE `SolverService` behind a request
queue with a fair (deficit-round-robin) scheduler and per-tenant in-flight
caps; with `batch=True` compatible tenants' solves share one launch of
kernels B0 and B.

    from karpenter_tpu_torch.fleet import FleetRunner
    report = FleetRunner("fleet_smoke", tenants=50, seed=0).run()

or from the shell:

    python -m karpenter_tpu_torch.fleet fleet_smoke --tenants 50

One level down, the service alone:

    svc = SolverService(FakeClock(), backend="device", batch=True)
    client = svc.register("t000", CatalogProvider(lambda: types))
    ticket = client.solve_async(pods, NodePool(name="default"))
    svc.pump()
    out = ticket.result()
"""

from .service import (SolverService, SolverServiceBusy, SolveTicket,
                      TenantSolverClient)
from .tenant import (TenantShard, build_shard, tenant_journal_path,
                     tenant_seed)
from .runner import FleetReport, FleetRunner
from .scenarios import FLEET_SCENARIOS, FleetScenario, get_fleet_scenario

__all__ = [
    "SolverService", "SolverServiceBusy", "SolveTicket",
    "TenantSolverClient", "TenantShard", "build_shard", "tenant_seed",
    "tenant_journal_path", "FleetRunner", "FleetReport", "FleetScenario",
    "FLEET_SCENARIOS", "get_fleet_scenario",
]
