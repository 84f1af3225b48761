"""Cloudprovider + cluster-state metrics controller.

The port's own copy of
`karpenter_tpu/controllers/metrics_controller.py`, unchanged in
semantics.

Reference: pkg/controllers/metrics/metrics.go:31-59 — exports per-offering
availability and price-estimate gauges for every (instanceType, zone,
capacityType) in the catalog, refreshed on a poll — plus the core metrics
controllers' cluster-state families (node/pod counts, utilization;
website reference/metrics.md cluster_state + nodes groups).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..catalog.provider import CatalogProvider
from ..metrics import (CLUSTER_NODES, CLUSTER_PODS, CLUSTER_UTILIZATION,
                       NODEPOOL_LIMIT, NODEPOOL_USAGE, OFFERING_AVAILABLE,
                       OFFERING_PRICE)
from ..state.store import Store


@dataclass
class CloudProviderMetricsController:
    catalog: CatalogProvider
    store: Optional[Store] = None
    name: str = "metrics.cloudprovider"
    requeue: float = 60.0
    _last_epoch: tuple = ()

    def reconcile(self, now: float) -> float:
        if self.store is not None:
            self._cluster_state()
        epoch = tuple(self.catalog.epoch)
        if epoch == self._last_epoch:
            return self.requeue
        self._last_epoch = epoch
        OFFERING_AVAILABLE.clear()
        OFFERING_PRICE.clear()
        for t in self.catalog.list():
            for o in t.offerings:
                labels = dict(instance_type=t.name, zone=o.zone,
                              capacity_type=o.capacity_type)
                OFFERING_AVAILABLE.set(1.0 if o.available else 0.0, **labels)
                OFFERING_PRICE.set(o.price, **labels)
        return self.requeue

    def _cluster_state(self) -> None:
        CLUSTER_NODES.set(float(len(self.store.nodes)))
        pending = sum(1 for p in self.store.pods.values()
                      if p.node_name is None)
        CLUSTER_PODS.set(float(pending), phase="pending")
        CLUSTER_PODS.set(float(len(self.store.pods) - pending),
                         phase="bound")
        # one pass over nodes + one over pods (pods_on_node per node would
        # be O(nodes x pods)); EVERY allocatable resource gets a series —
        # accelerator resources are the point of this framework
        ready = {n.name for n in self.store.nodes.values() if n.ready}
        allocatable: dict = {}
        for n in self.store.nodes.values():
            if n.name in ready:
                for k, v in n.allocatable.items():
                    allocatable[k] = allocatable.get(k, 0.0) + v
        requested: dict = {}
        for p in self.store.pods.values():
            if p.node_name in ready:
                for k, v in p.requests.items():
                    requested[k] = requested.get(k, 0.0) + v
        CLUSTER_UTILIZATION.clear()  # scale-to-zero must not leave stale %
        for k, total in allocatable.items():
            CLUSTER_UTILIZATION.set(
                100.0 * requested.get(k, 0.0) / total if total else 0.0,
                resource=k)
        # per-pool usage vs spec.limits (reference karpenter_nodepools_usage
        # / _limit) — same accounting as the provisioner's limit gate
        # (claim capacity summed per pool)
        NODEPOOL_USAGE.clear()
        NODEPOOL_LIMIT.clear()
        usage: dict = {}
        from ..models.nodeclaim import Phase
        for claim in self.store.nodeclaims.values():
            # same exclusions as Provisioner._pool_usage (the limit gate):
            # deleting AND failed claims don't consume the pool, so the
            # exported gauge must not over-report relative to the gate
            if claim.is_deleting() or claim.phase == Phase.FAILED:
                continue
            per = usage.setdefault(claim.nodepool, {})
            for k, v in claim.capacity.items():
                per[k] = per.get(k, 0.0) + v
        for pool in self.store.nodepools.values():
            for k, v in usage.get(pool.name, {}).items():
                NODEPOOL_USAGE.set(v, nodepool=pool.name, resource=k)
            for k, v in pool.limits.items():
                NODEPOOL_LIMIT.set(v, nodepool=pool.name, resource=k)
