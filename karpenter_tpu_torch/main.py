"""Operator entrypoint — the cmd/controller/main.go analog.

The port's own copy of `karpenter_tpu/main.py` and its production entry
point:

    python -m karpenter_tpu_torch.main                   # the operator
    python -m karpenter_tpu_torch.main --device cpu      # ... on the host
    python -m karpenter_tpu_torch.main --soak --soak-scenario soak_smoke \
        --solver-backend device
    python -m karpenter_tpu_torch.main --fleet-tenants 4 --device cpu

The solver runs on the CUDA card unless `--device` names another
(`Options.device`); without a card and without `--device` the device rung
raises. `--fleet-tenants N --federate` routes the fleet's buckets through
the federation plane (`--server-addr host:port` dials a running
`python -m karpenter_tpu_torch.federation.server`).

Wires options → providers (dependency order mirrors the reference's
operator construction, pkg/operator/operator.go:127-199: pricing →
catalog (sync hydrate before start, :187-188) → solver → controllers) and
starts the async runtime with the metrics endpoint.

The cloud backend here is the in-memory fake (this framework's kwok): a
real cloud backend implements the same CloudProvider protocol +
`describe_types()` seam.
"""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

from .catalog.generator import GeneratorConfig, generate_catalog
from .catalog.provider import CatalogProvider
from .cloud.fake import FakeCloud, FakeCloudConfig
from .controllers.disruption import DisruptionController
from .controllers.gc import GarbageCollectionController
from .controllers.interruption import InterruptionController
from .controllers.lifecycle import BindingController, LifecycleController
from .controllers.metrics_controller import CloudProviderMetricsController
from .controllers.provisioner import Provisioner
from .controllers.runtime import Runtime
from .controllers.termination import TerminationController
from .models.nodepool import NodeClassSpec, NodePool
from .ops.facade import Solver
from .ops.solver import resolve_device
from .state.store import Store
from .utils.clock import RealClock
from .utils.options import Options


def build_operator(options: Optional[Options] = None,
                   cloud: Optional[FakeCloud] = None,
                   store: Optional[Store] = None,
                   clock=None):
    """Construct the full controller set; returns (runtime, store, cloud).

    clock: defaults to the passed cloud's clock (mixed clocks would
    desynchronize the batcher windows and TTL caches from the cloud's
    boot delays), else wall clock."""
    opts = options or Options.parse()
    clock = clock or (cloud.clock if cloud is not None else RealClock())
    store = store or Store()
    cloud = cloud or FakeCloud(generate_catalog(
        GeneratorConfig(region=opts.region)), clock=clock)
    # every controller speaks to the batching wrapper: terminations from
    # termination+gc+lifecycle coalesce into one wire call per window,
    # describe sweeps within a window share one call (reference
    # pkg/batcher/); the raw cloud stays the simulation/tick seam. The
    # metering middleware sits BELOW the batcher — one coalesced wire
    # call = one observation (aws-sdk-go-prometheus, operator.go:98)
    from .cloud.batcher import BatchingCloud
    from .cloud.metering import MeteredCloud
    mcloud = MeteredCloud(cloud)
    bcloud = BatchingCloud(mcloud, clock)
    # catalog refresh hits the wire too — meter it (DescribeInstanceTypes
    # is the reference middleware's dominant series)
    from .catalog.pricing import PricingProvider
    pricing = PricingProvider(
        snapshot_path=opts.pricing_snapshot_file or None, clock=clock,
        isolated=opts.isolated)
    catalog = CatalogProvider(lambda: mcloud.describe_types(), clock=clock,
                              pricing=pricing)
    catalog.raw_types()  # sync hydrate before controllers start
    solver = Solver(catalog, backend=opts.solver_backend,
                    profile_dir=opts.profile_dir,
                    device=resolve_device(opts.device or None))
    warm_engine = None
    if opts.gate("WarmPathAdmission"):
        from .warmpath import WarmPathEngine
        warm_engine = WarmPathEngine(store, solver, catalog,
                                     audit_every=opts.warmpath_audit_every)
    # provisioning write-ahead log: file-backed when configured, so a
    # restarted operator replays its predecessor's open launch intents
    from .state.journal import IntentJournal
    journal = IntentJournal(path=opts.intent_journal_file or None)
    provisioner = Provisioner(store=store, solver=solver, cloud=bcloud,
                              catalog=catalog,
                              batch_idle=opts.batch_idle_seconds,
                              warmpath=warm_engine, journal=journal)
    lifecycle = LifecycleController(store=store, cloud=bcloud)
    binding = BindingController(store=store)
    termination = TerminationController(store=store, cloud=bcloud,
                                        catalog=catalog)
    disruption = DisruptionController(store=store, solver=solver,
                                      catalog=catalog,
                                      provisioner=provisioner,
                                      termination=termination,
                                      spot_to_spot=opts.gate("SpotToSpotConsolidation"))
    gc = GarbageCollectionController(store=store, cloud=bcloud,
                                     journal=journal)
    metrics_c = CloudProviderMetricsController(catalog=catalog, store=store)
    from .cloud.image import ImageProvider
    from .controllers.auxiliary import (CatalogRefreshController,
                                        DiscoveredCapacityController,
                                        ReservationExpirationController,
                                        SpotPricingController,
                                        TaggingController)
    from .controllers.nodeclass import NodeClassController
    from .controllers.repair import NodeRepairController
    images = ImageProvider(lister=cloud.describe_images, clock=clock)
    nodeclass_c = NodeClassController(store=store, cloud=bcloud,
                                      images=images)
    repair = NodeRepairController(store=store, termination=termination,
                                  enabled=opts.gate("NodeRepair"))
    controllers: List[object] = [provisioner, lifecycle, binding, termination,
                                 disruption, gc, metrics_c, nodeclass_c,
                                 repair, TaggingController(store=store, cloud=bcloud),
                                 DiscoveredCapacityController(store=store, catalog=catalog),
                                 CatalogRefreshController(catalog=catalog, store=store,
                                                          images=images),
                                 ReservationExpirationController(
                                     store=store, cloud=bcloud,
                                     catalog=catalog, termination=termination),
                                 SpotPricingController(catalog=catalog, cloud=bcloud)]
    controllers.append(bcloud.flusher())
    if opts.interruption_queue:
        controllers.append(InterruptionController(
            store=store, cloud=bcloud, catalog=catalog,
            termination=termination))

    elector = None
    # empty lease path/endpoint disables election even when the flag is on
    # (the options docstring promises this; a FileLeaseBackend("") would
    # fail every write and leave the replica permanently standby)
    if opts.leader_elect and (opts.leader_elect_endpoint
                              or opts.leader_elect_lease_file):
        import socket
        from .utils.leaderelection import (Elector, FileLeaseBackend,
                                           HTTPLeaseBackend)
        if opts.leader_elect_endpoint:
            # elect through the cloud endpoint's CAS'd /lease — no shared
            # volume needed (the Lease-through-API-server analog)
            host, _, port = opts.leader_elect_endpoint.partition(":")
            backend = HTTPLeaseBackend(host, int(port or 80))
        else:
            os_dir = os.path.dirname(opts.leader_elect_lease_file)
            if os_dir:
                os.makedirs(os_dir, exist_ok=True)
            backend = FileLeaseBackend(opts.leader_elect_lease_file)
        elector = Elector(
            backend=backend,
            identity=opts.leader_elect_identity
            or f"{socket.gethostname()}-{os.getpid()}")
    runtime = Runtime(clock=clock, metrics_port=opts.metrics_port,
                      elector=elector)
    runtime.add(*controllers)
    # clean stop must ship any termination batch still waiting on its
    # idle window — dropping it would leak instances until the next
    # process's GC sweep
    runtime.on_stop.append(bcloud.shutdown)

    class _CloudTicker:
        name = "cloud.tick"

        def reconcile(self, now: float) -> float:
            cloud.tick()
            return 0.5
    cloud.on_node_created.append(store.add_node)
    runtime.add(_CloudTicker())

    store.add_nodeclass(NodeClassSpec(name="default"))
    store.add_nodepool(NodePool(name="default"))
    nodeclass_c.reconcile(clock.now())  # sync hydrate before start
    from .state.rehydrate import rehydrate
    rehydrate(store, cloud, catalog, clock.now(),
              journal=journal)  # adopt fleet + replay intents after restart
    if warm_engine is not None:
        warm_engine.on_restart()  # never trust a warm window across a boot
    return runtime, store, cloud


def run_fleet(opts: Options) -> int:
    """Fleet mode (--fleet-tenants N): N simulated tenant control planes
    through one process and one shared SolverService — the Omega-style
    multi-tenant construction (docs/fleet.md). Per-tenant intent-journal
    WAL files land next to --intent-journal-file when it is set (each
    tenant gets its own file: shards never share a WAL)."""
    from .fleet import FleetRunner
    journal_dir = (os.path.dirname(opts.intent_journal_file) or "."
                   if opts.intent_journal_file else None)
    if journal_dir:
        os.makedirs(journal_dir, exist_ok=True)
    backend = opts.solver_backend
    batch = opts.fleet_batch or None
    service_factory = None
    if opts.federate:
        # federation only engages for device-batchable buckets: --federate
        # implies the batched engine and a device backend unless the user
        # picked a non-default backend explicitly
        from .federation import build_federated_service
        if backend == "host":
            backend = "device"
        batch = True

        def service_factory(clock, kw, _addr=opts.server_addr):
            return build_federated_service(clock, server_addr=_addr,
                                           run_id="fed-fleet_smoke", **kw)
    runner = FleetRunner("fleet_smoke", tenants=opts.fleet_tenants,
                         backend=backend,
                         inflight_cap=opts.fleet_inflight_cap,
                         journal_dir=journal_dir,
                         batch=batch,
                         service_factory=service_factory,
                         device=opts.device or None)
    report = runner.run()
    print(report.summary())
    return 0 if report.ok else 1


def run_soak(opts: Options) -> int:
    """Long-soak serving mode (--soak): drive a tenant fleet through an
    OPEN-LOOP, seeded arrival process (loadgen/) — arrivals fire on the
    sim clock without waiting for drain, the admission controller in
    the shared SolverService sheds/defers load past saturation, and the
    run is judged by the SLO engine, the watchdog (overload_unbounded
    armed over the generator's depth observables), and the three-digest
    repeat contract. `--arrival-rate` / `--soak-duration` override the
    scenario; `--fleet-tenants` (when >0) overrides the shard count."""
    from .loadgen import SoakRunner
    runner = SoakRunner(
        opts.soak_scenario,
        tenants=opts.fleet_tenants or None,
        backend=opts.solver_backend,
        arrival_rate=opts.arrival_rate or None,
        duration=opts.soak_duration or None,
        admission=False if opts.soak_no_admission else None,
        batch=opts.fleet_batch or None,
        device=opts.device or None)
    report = runner.run()
    print(report.summary())
    return 0 if report.ok else 1


def main() -> None:
    import sys
    # parse the REAL command line: Options.parse(None) deliberately
    # parses an empty argv (library callers construct Options directly,
    # and pytest's argv must never leak in), so the entrypoint is the
    # one place that feeds sys.argv through
    opts = Options.parse(sys.argv[1:])
    if opts.soak:
        raise SystemExit(run_soak(opts))
    if opts.fleet_tenants > 0:
        raise SystemExit(run_fleet(opts))
    runtime, _store, _cloud = build_operator(options=opts)

    async def _run() -> None:
        # SIGTERM is what the kubelet sends on pod termination: a leader
        # that dies without runtime.stop() holds its lease until expiry,
        # stalling standby failover for the whole lease duration. Route
        # both signals through the clean-shutdown path (which releases
        # the lease in the elector task's finally).
        import signal
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, runtime.stop)
            except (NotImplementedError, RuntimeError):
                pass  # platforms without unix signal support
        await runtime.start()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        runtime.stop()


if __name__ == "__main__":
    main()
