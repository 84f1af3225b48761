"""NodeClass status controller.

The port's own copy of `karpenter_tpu/controllers/nodeclass.py`,
unchanged in semantics.

Reference: pkg/controllers/nodeclass/controller.go:64-166 — a status
reconciler chain resolving images → network groups → instance profile →
zones → readiness, with a dry-run launch-authorization validation; the
resolved sets feed both the launch path and drift detection (a node whose
image/network-group left the resolved set is drifted —
pkg/cloudprovider/drift.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..cloud.image import ImageProvider
from ..cloud.netgroup import ProfileProvider, resolve_network_groups
from ..state.store import Store


@dataclass
class NodeClassController:
    store: Store
    cloud: object
    images: ImageProvider
    name: str = "nodeclass"
    requeue: float = 30.0
    stats: Dict[str, int] = field(default_factory=lambda: {"reconciles": 0})

    def __post_init__(self):
        self.profiles = ProfileProvider(cloud=self.cloud)

    def reconcile(self, now: float) -> float:
        zones = sorted({o.zone for t in self.cloud.describe_types()
                        for o in t.offerings})
        groups = self.cloud.describe_network_groups()
        # one cloud snapshot per sweep — ensure/GC across N NodeClasses
        # must not issue N ListProfiles + DescribeInstances calls
        profile_list = self.cloud.describe_profiles()
        profile_map = {p.name: p for p in profile_list}
        used = {i.profile for i in self.cloud.describe()}
        for nc in self.store.nodeclasses.values():
            self.stats["reconciles"] += 1
            resolved_imgs = self.images.resolve(nc)
            nc.resolved_images = [i.id for i in resolved_imgs]
            nc.resolved_zones = [z for z in zones
                                 if not nc.zones or z in nc.zones]
            selectors = (nc.network_group_selectors
                         or [{"name": "default"}])
            nc.resolved_network_groups = resolve_network_groups(
                groups, selectors)
            if nc.node_profile:
                nc.resolved_profile = nc.node_profile  # unmanaged, as-is
            elif nc.role:
                nc.resolved_profile = self.profiles.ensure(
                    nc.name, nc.role, profiles=profile_map)
            else:
                nc.resolved_profile = ""
            ready = (bool(nc.resolved_images) and bool(nc.resolved_zones)
                     and bool(nc.resolved_network_groups))
            if ready != nc.ready:
                self.store.record_event("nodeclass", nc.name,
                                        "Ready" if ready else "NotReady")
            nc.ready = ready
        # orphaned managed profiles (reference nodeclass GC controller)
        for name in self.profiles.garbage_collect(
                list(self.store.nodeclasses.keys()),
                profiles=profile_list, used=used):
            self.store.record_event("profile", name, "GarbageCollected",
                                    "NodeClass gone, profile unused")
        return self.requeue
