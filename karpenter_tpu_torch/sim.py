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
- the fault plan (`fault_plan=`) and the warm path (`warmpath=True`) are
  not ported and raise NotImplementedError;
- the reference's read-only invariant monitor (`watchdog=`) is not
  ported and the parameter is left out: it never changes what a run
  does;
- the cloud is the in-process `FakeCloud` (the reference's tick hook
  also polls a cloud in another process).
The global consolidation optimizer is armed by default, as in the
reference (KARPENTER_TPU_OPTIMIZER=0 runs the greedy path).

The pkg/test.Environment analog (reference environment.go:56-233): every
real controller + provider runs against in-memory fakes with an injectable
clock, so scale/flow tests run with zero cloud spend — and it doubles as
the kwok-style simulation backend for benchmarks.
"""

from __future__ import annotations

import hashlib
import json
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
from .models import labels as L
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
    # state.journal.IntentJournal: the provisioning write-ahead log.
    # Always present; pass the previous stack's journal to make_sim
    # (with its cloud) to simulate a crash-restart — open intents replay
    # during rehydration
    journal: Optional[object] = None

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
             journal: Optional[object] = None,
             solver_factory: Optional[object] = None,
             device=None) -> SimEnvironment:
    """Passing an existing `cloud` (+ its clock) simulates an operator
    restart: the new stack rehydrates its fresh Store from the cloud's
    durable state instead of starting empty-world. Passing the previous
    stack's intent `journal` alongside replays its open launch intents
    (adopt-or-reap) during that rehydration — the crash-window recovery
    path (state/journal.py).

    device: where the device rung and the consolidation screen run — the
    CUDA card unless given; without a card and without `device` this
    raises. solver_factory(catalog) -> a Solver-compatible object (the
    fleet seam); `backend` is the factory's concern then. fault_plan and
    warmpath are not ported and raise."""
    if fault_plan is not None:
        raise NotImplementedError(
            "fault injection (fault_plan=) is not ported to "
            "karpenter_tpu_torch yet (ROADMAP item 4)")
    if warmpath:
        raise NotImplementedError(
            "the warm path (warmpath=True) is not ported to "
            "karpenter_tpu_torch yet (ROADMAP item 9)")
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
    # (the reference hands the controllers its fault-injection decorator
    # around the cloud here when a fault plan is armed)
    from .state.journal import IntentJournal
    journal = journal if journal is not None else IntentJournal()
    catalog = CatalogProvider(lambda: cloud.describe_types(),
                              clock=clock)
    solver = (solver_factory(catalog) if solver_factory is not None
              else Solver(catalog, backend=backend, device=dev))
    provisioner = Provisioner(store=store, solver=solver, cloud=cloud,
                              catalog=catalog, journal=journal)
    lifecycle = LifecycleController(store=store, cloud=cloud)
    binding = BindingController(store=store)
    termination = TerminationController(store=store, cloud=cloud,
                                        catalog=catalog)
    disruption = DisruptionController(store=store, solver=solver,
                                      catalog=catalog, provisioner=provisioner,
                                      termination=termination)
    interruption = InterruptionController(store=store, cloud=cloud,
                                          catalog=catalog,
                                          termination=termination)
    gc = GarbageCollectionController(store=store, cloud=cloud,
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
    nodeclass_c = NodeClassController(store=store, cloud=cloud,
                                      images=images)
    repair = NodeRepairController(store=store, termination=termination)
    tagging = TaggingController(store=store, cloud=cloud)
    discovered = DiscoveredCapacityController(store=store, catalog=catalog)
    refresh = CatalogRefreshController(catalog=catalog, store=store,
                                       images=images)
    res_exp = ReservationExpirationController(store=store, cloud=cloud,
                                              catalog=catalog,
                                              termination=termination)
    spot_pricing = SpotPricingController(catalog=catalog, cloud=cloud)
    engine = Engine(clock=clock).add(nodeclass_c, provisioner, lifecycle,
                                     binding, termination, disruption,
                                     interruption, gc, metrics_c, repair,
                                     tagging, discovered, refresh, res_exp,
                                     spot_pricing)

    # cloud → store node materialization (kubelet joining the cluster):
    # the in-process fake pushes node events through a callback. (The
    # reference also polls a cloud without that hook — its RemoteCloud in
    # another process, not ported.)
    cloud.on_node_created.append(store.add_node)

    def _tick(now: float) -> None:
        cloud.tick()
        # terminated instances drop their nodes (cloud-side node deletion)
        for node in list(store.nodes.values()):
            inst = cloud.instances.get(node.provider_id.rsplit("/", 1)[-1])
            if inst is not None and inst.state == "terminated":
                store.delete_node(node.name)
    engine.add_hook(_tick)

    store.add_nodeclass(NodeClassSpec(name="default"))
    store.add_nodepool(nodepool or NodePool(name="default"))
    nodeclass_c.reconcile(clock.now())  # sync hydrate (operator.go:151 analog)
    from .state.rehydrate import rehydrate
    # adopt any pre-existing fleet (the reference reopens its warm window
    # cold on adoption here; the port has no warm path)
    rehydrate(store, cloud, catalog, clock.now(), journal=journal)
    return SimEnvironment(clock=clock, store=store, cloud=cloud,
                          catalog=catalog, solver=solver, engine=engine,
                          provisioner=provisioner, lifecycle=lifecycle,
                          binding=binding, termination=termination,
                          disruption=disruption, interruption=interruption,
                          gc=gc, journal=journal)


def state_hash(sim) -> str:
    """Canonical digest of the end-of-run cluster state — a copy of the
    reference's `faults/runner.state_hash`. Deliberately id-free; covers
    node composition (type, zone, capacity type, readiness, the exact pod
    set on each node), the claim fleet summary, unbound pods, and live
    ICE marks."""
    store = sim.store
    node_entries = []
    for node in store.nodes.values():
        pods = tuple(sorted(p.name for p in store.pods_on_node(node.name)))
        node_entries.append([
            node.labels.get(L.INSTANCE_TYPE, ""),
            node.labels.get(L.ZONE, ""),
            node.labels.get(L.CAPACITY_TYPE, ""),
            bool(node.ready), pods])
    node_entries.sort()
    claim_entries = sorted(
        [c.nodepool, c.instance_type or "", c.zone or "",
         c.capacity_type or "", str(c.phase)]
        for c in store.nodeclaims.values())
    unbound = sorted(k for k, p in store.pods.items()
                     if p.node_name is None)
    live_instances = sorted(
        [i.instance_type, i.zone, i.capacity_type, i.state]
        for i in sim.cloud.instances.values() if i.state != "terminated")
    payload = json.dumps(
        {"nodes": node_entries, "claims": claim_entries,
         "unbound": unbound, "instances": live_instances,
         "ice_marks": sim.catalog.unavailable.active()},
        sort_keys=True, default=list)
    return hashlib.sha256(payload.encode()).hexdigest()
