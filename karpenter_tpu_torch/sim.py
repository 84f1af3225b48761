"""SimEnvironment: the full stack wired against the fake cloud.

The port's own copy of `karpenter_tpu/sim.py`. `make_sim` builds the
reference's stack — the same controllers in the same `Engine.add` order,
the same cloud→store tick hook, the same nodeclass hydrate and
`rehydrate` at start — with the port's `Solver` (kernels B0 and B) and
its consolidation screen (kernel A) on one device. Its seams differ from
the reference's in these places:
- `backend` defaults to "device" and `device=` says where the device
  rung and the screen run: the CUDA card unless the caller passes one
  (device="cpu" runs the kernels' plain versions, as the tests do).
  Without a card and without `device`, make_sim raises, on every rung,
  because the consolidation screen runs on the device on every rung;
- the cloud is the in-process `FakeCloud` (the reference's tick hook
  also polls a cloud in another process).
As in the reference, `warmpath=True` puts the warm path
(`warmpath.WarmPathEngine`) in front of the provisioner's solve, and the
online invariant watchdog (`obs.watchdog.Watchdog`, read-only over the
stack) is armed unless `watchdog=False`.
The global consolidation optimizer is armed by default, as in the
reference (KARPENTER_TPU_OPTIMIZER=0 runs the greedy path).

The pkg/test.Environment analog (reference environment.go:56-233): every
real controller + provider runs against in-memory fakes with an injectable
clock, so scale/flow tests run with zero cloud spend — and it doubles as
the kwok-style simulation backend for benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .catalog.generator import small_catalog
from .catalog.provider import CatalogProvider
from .cloud.fake import FakeCloud, FakeCloudConfig
from .controllers.disruption import DisruptionController
from .controllers.engine import Engine
from .controllers.gc import GarbageCollectionController
from .controllers.interruption import InterruptionController
from .controllers.lifecycle import BindingController, LifecycleController
from .controllers.provisioner import Provisioner
from .controllers.termination import TerminationController
from .models.instancetype import InstanceType
from .models.nodepool import NodeClassSpec, NodePool
from .ops.facade import Solver
from .ops.solver import resolve_device
from .state.store import Store
from .utils.clock import FakeClock


@dataclass
class SimEnvironment:
    clock: FakeClock
    store: Store
    cloud: FakeCloud
    catalog: CatalogProvider
    solver: Solver
    engine: Engine
    provisioner: Provisioner
    lifecycle: LifecycleController
    binding: BindingController
    termination: TerminationController
    disruption: DisruptionController
    interruption: InterruptionController
    gc: GarbageCollectionController
    # armed faults.FaultPlan when the stack was built with fault injection
    # (make_sim(fault_plan=...)); None in a healthy sim
    fault_plan: Optional[object] = None
    # warmpath.WarmPathEngine when built with make_sim(warmpath=True):
    # arrival-only reconciles admit against the standing headroom ledger
    # instead of paying a full solve; None = every reconcile is cold
    warmpath: Optional[object] = None
    # state.journal.IntentJournal: the provisioning write-ahead log.
    # Always present; pass the previous stack's journal to make_sim
    # (with its cloud) to simulate a crash-restart — open intents replay
    # during rehydration
    journal: Optional[object] = None
    # obs.watchdog.Watchdog: the online invariant monitor, armed on this
    # stack's store/cloud/journal/warmpath and ticked by the engine.
    # Read-only over everything it watches, so end-state hashes and
    # fault fingerprints are identical with it armed
    watchdog: Optional[object] = None

    def start_chaos(self, interval: float = 60.0, seed: int = 0) -> None:
        """kwok kill-node-thread analog (kwok/ec2/ec2.go:253-282): kill a
        random running instance every `interval` sim-seconds; the state-
        change interruption event + GC/liveness recover the cluster.
        stop_chaos() disarms it (tests quiesce before final invariants)."""
        import random
        rng = random.Random(seed)
        state = {"last": self.clock.now()}
        self._chaos_on = True

        def hook(now: float) -> None:
            if not getattr(self, "_chaos_on", False):
                return
            if now - state["last"] >= interval:
                state["last"] = now
                running = [i for i in self.cloud.instances.values()
                           if i.state == "running"]
                if running:
                    self.cloud.kill_instance(rng.choice(running).id,
                                             reason="chaos")
        self.engine.add_hook(hook)

    def stop_chaos(self) -> None:
        self._chaos_on = False


def make_sim(types: Optional[List[InstanceType]] = None,
             backend: str = "device",
             cloud_config: Optional[FakeCloudConfig] = None,
             nodepool: Optional[NodePool] = None,
             cloud: Optional[FakeCloud] = None,
             clock: Optional[FakeClock] = None,
             fault_plan: Optional[object] = None,
             warmpath: bool = False,
             warm_audit_every: int = 1,
             journal: Optional[object] = None,
             solver_factory: Optional[object] = None,
             watchdog: bool = True,
             device=None) -> SimEnvironment:
    """Passing an existing `cloud` (+ its clock) simulates an operator
    restart: the new stack rehydrates its fresh Store from the cloud's
    durable state instead of starting empty-world. Passing the previous
    stack's intent `journal` alongside replays its open launch intents
    (adopt-or-reap) during that rehydration — the crash-window recovery
    path (state/journal.py).

    fault_plan: an armed faults.FaultPlan — every controller then speaks
    to the cloud through a faults.injector.FaultyCloud decorator (injected
    throttles/server errors), the fake cloud honors the plan's ICE
    windows, the clock carries its skew jumps, and its interruption bursts
    are delivered by an engine hook. The raw FakeCloud stays on
    `sim.cloud` (node materialization and test introspection are not
    subject to API faults).

    device: where the device rung and the consolidation screen run — the
    CUDA card unless given; without a card and without `device` this
    raises. solver_factory(catalog) -> a Solver-compatible object (the
    fleet seam); `backend` is the factory's concern then. warmpath=True
    arms the warm path, whose auditor replays every warm_audit_every-th
    admission window through a full solve."""
    if cloud is not None and (types is not None or cloud_config is not None):
        raise ValueError("types/cloud_config are ignored when an existing "
                         "cloud is passed — configure the cloud directly")
    dev = resolve_device(device)
    # a passed cloud keeps its own clock: driving it from a fresh clock
    # would freeze its time (register delays never elapse, buckets never
    # refill), so default to the cloud's
    clock = clock or (cloud.clock if cloud is not None else FakeClock())
    store = Store()
    types = types if types is not None else small_catalog()
    cloud = cloud or FakeCloud(types, clock=clock, config=cloud_config)
    # api_cloud is what controllers hold; identical to `cloud` unless a
    # fault plan interposes the injection decorator
    api_cloud = cloud
    from .state.journal import IntentJournal
    journal = journal if journal is not None else IntentJournal()
    if fault_plan is not None:
        from .faults.injector import FaultyCloud
        # first install on this clock stamps the origin and schedules the
        # skew jumps; a RE-install (the restart harness rebuilding a
        # stack on the surviving clock) must do neither — rule times stay
        # relative to the ORIGINAL run start, and jumps already consumed
        # or scheduled must not double-apply
        first_install = fault_plan.clock is not clock
        fault_plan.clock = clock
        if first_install:
            fault_plan.origin = clock.now()    # rule times are run-relative
            for j in fault_plan.clock_jumps:   # skew
                clock.schedule_jump(fault_plan.origin + j.at, j.delta,
                                    fault_plan.on_jump)
        cloud.fault_plan = fault_plan          # ICE windows
        api_cloud = FaultyCloud(cloud, fault_plan, clock)
    # the catalog's backend listing goes through the gated view too, so
    # an ApiFault on "describe_types" really browns out catalog refresh
    catalog = CatalogProvider(lambda: api_cloud.describe_types(),
                              clock=clock)
    solver = (solver_factory(catalog) if solver_factory is not None
              else Solver(catalog, backend=backend, device=dev))
    # warm-path incremental admission (warmpath/): audit_every=1 means the
    # auditor replays EVERY warm admission through a full solve — the
    # always-on mode tier-1 tests and chaos scenarios run with
    warm_engine = None
    if warmpath:
        from .warmpath import WarmPathEngine
        warm_engine = WarmPathEngine(store, solver, catalog,
                                     audit_every=warm_audit_every)
    provisioner = Provisioner(store=store, solver=solver, cloud=api_cloud,
                              catalog=catalog, warmpath=warm_engine,
                              journal=journal)
    lifecycle = LifecycleController(store=store, cloud=api_cloud)
    binding = BindingController(store=store)
    termination = TerminationController(store=store, cloud=api_cloud,
                                        catalog=catalog)
    disruption = DisruptionController(store=store, solver=solver,
                                      catalog=catalog, provisioner=provisioner,
                                      termination=termination)
    interruption = InterruptionController(store=store, cloud=api_cloud,
                                          catalog=catalog,
                                          termination=termination)
    gc = GarbageCollectionController(store=store, cloud=api_cloud,
                                     journal=journal)
    from .cloud.image import ImageProvider
    from .controllers.auxiliary import (CatalogRefreshController,
                                        DiscoveredCapacityController,
                                        ReservationExpirationController,
                                        SpotPricingController,
                                        TaggingController)
    from .controllers.metrics_controller import CloudProviderMetricsController
    from .controllers.nodeclass import NodeClassController
    from .controllers.repair import NodeRepairController
    metrics_c = CloudProviderMetricsController(catalog=catalog, store=store)
    images = ImageProvider(lister=cloud.describe_images, clock=clock)
    nodeclass_c = NodeClassController(store=store, cloud=api_cloud,
                                      images=images)
    repair = NodeRepairController(store=store, termination=termination)
    tagging = TaggingController(store=store, cloud=api_cloud)
    discovered = DiscoveredCapacityController(store=store, catalog=catalog)
    refresh = CatalogRefreshController(catalog=catalog, store=store,
                                       images=images)
    res_exp = ReservationExpirationController(store=store, cloud=api_cloud,
                                              catalog=catalog,
                                              termination=termination)
    spot_pricing = SpotPricingController(catalog=catalog, cloud=api_cloud)
    engine = Engine(clock=clock).add(nodeclass_c, provisioner, lifecycle,
                                     binding, termination, disruption,
                                     interruption, gc, metrics_c, repair,
                                     tagging, discovered, refresh, res_exp,
                                     spot_pricing)
    # the verification plane's online monitor: armed BEFORE the workload
    # so the store watch feed sees every claim from birth; the engine
    # ticks it outside the traced window. Arming is read-only over the
    # whole stack — chaos end-state hashes and fault fingerprints are
    # byte-identical with it on
    wd = None
    if watchdog:
        from .obs.watchdog import Watchdog
        wd = Watchdog(clock, store=store, cloud=cloud, journal=journal,
                      warmpath=warm_engine).arm(clock.now())
        engine.watchdog = wd

    # cloud → store node materialization (kubelet joining the cluster).
    # The in-process fake pushes node events through a callback; a cloud
    # without that hook (RemoteCloud — another process, no shared memory)
    # is synced by POLLING its node/instance views each tick, the
    # watch-fallback analog.
    is_local = hasattr(cloud, "on_node_created")
    if is_local:
        cloud.on_node_created.append(store.add_node)

    def _tick(now: float) -> None:
        from .cloud.provider import CloudError
        try:
            cloud.tick()
            if is_local:
                insts = cloud.instances
            else:
                for node in cloud.describe_nodes():
                    cur = store.nodes.get(node.name)
                    if cur is None:
                        store.add_node(node)
                    else:
                        # sync kubelet-owned fields only — locally applied
                        # taints (cordons) must survive the poll
                        cur.ready = node.ready
                        cur.conditions.update(node.conditions)
                insts = {i.id: i for i in cloud.describe()}
        except CloudError as e:
            if e.retryable:
                return  # transient (throttle/transport): sync next tick
            raise
        # terminated instances drop their nodes (cloud-side node deletion).
        # The polled view (describe) omits terminated instances entirely,
        # so remotely the signal is ABSENCE; the local fast path sees the
        # fake's full instance map and checks state.
        for node in list(store.nodes.values()):
            iid = node.provider_id.rsplit("/", 1)[-1]
            inst = insts.get(iid)
            if inst is None:
                if not is_local:
                    store.delete_node(node.name)
            elif inst.state == "terminated":
                store.delete_node(node.name)
    engine.add_hook(_tick)
    if fault_plan is not None:
        from .faults.injector import install_bursts
        install_bursts(engine, cloud, fault_plan, store)

    store.add_nodeclass(NodeClassSpec(name="default"))
    store.add_nodepool(nodepool or NodePool(name="default"))
    nodeclass_c.reconcile(clock.now())  # sync hydrate (operator.go:151 analog)
    from .state.rehydrate import rehydrate
    rh = rehydrate(store, cloud, catalog, clock.now(),
                   journal=journal)  # adopt any pre-existing fleet
    if warm_engine is not None and (rh["claims_adopted"]
                                    or rh["intents_adopted"]
                                    or rh["intents_aborted"]
                                    or rh["intents_reaped"]):
        # this stack took over a live fleet: the warm window must open
        # cold (no predecessor ledger is trustworthy across a restart)
        warm_engine.on_restart()
    return SimEnvironment(clock=clock, store=store, cloud=cloud,
                          catalog=catalog, solver=solver, engine=engine,
                          provisioner=provisioner, lifecycle=lifecycle,
                          binding=binding, termination=termination,
                          disruption=disruption, interruption=interruption,
                          gc=gc, fault_plan=fault_plan,
                          warmpath=warm_engine, journal=journal,
                          watchdog=wd)


# the one copy of the canonical end-state digest is the chaos runner's
# (faults/runner.py); callers of `sim.state_hash` get that same function
from .faults.runner import state_hash  # noqa: E402
