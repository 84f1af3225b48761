"""PersistentVolumeClaims: zone topology + attachable-volume accounting.

The port's own copy of `karpenter_tpu/models/volume.py`, unchanged in
semantics.

Reference behavior (core scheduler volume topology + the storage e2e
suite, test/suites/storage/suite_test.go:71-120): a pod whose PVC is
bound to a zonal PersistentVolume must schedule into that PV's zone;
an unbound WaitForFirstConsumer claim constrains nothing (the
provisioner's node choice binds it). Per-node attachable-volume limits
(the EBS CSI attach limit) cap how many volume-bearing pods share a
node.

TPU-native lowering: both effects ride EXISTING machinery — the zone
constraint becomes a node_selector entry injected at admission (so it
participates in constraint signatures/grouping like any selector), and
volume attachments become a RESOURCE (`VOLUME_ATTACH_RESOURCE`): each
pod requests len(pvcs) of it, every instance type allocates its attach
limit, and the solver's ordinary resource packing enforces the cap with
zero kernel changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# the attachable-volumes resource (node.kubernetes.io/attachable-volumes
# analog; EBS CSI limit). Types allocate DEFAULT_ATTACH_LIMIT unless the
# generator says otherwise.
VOLUME_ATTACH_RESOURCE = "storage.karpenter.tpu/attachable-volumes"
DEFAULT_ATTACH_LIMIT = 27  # the classic EBS per-instance attach limit


@dataclass
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    storage_class: str = ""
    volume_name: str = ""       # non-empty = bound to a PV
    zone: Optional[str] = None  # the bound PV's topology (None = no pin)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def bound_zone(self) -> Optional[str]:
        """The zone this claim pins pods to, or None (unbound /
        WaitForFirstConsumer / non-zonal PV)."""
        return self.zone if self.volume_name and self.zone else None
