"""Node auto-repair controller.

The port's own copy of `karpenter_tpu/controllers/repair.py`, unchanged
in semantics.

Reference: RepairPolicies (pkg/cloudprovider/cloudprovider.go:268-309) —
unhealthy node conditions (kubelet Ready=False, monitoring-agent signals)
are tolerated for a policy window (10–30m) and then the node is forcibly
replaced. Gated on the NodeRepair feature gate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..state.store import Store
from .termination import TerminationController


@dataclass
class RepairPolicy:
    condition: str            # node condition type
    toleration: float         # seconds unhealthy before repair


DEFAULT_POLICIES = [
    RepairPolicy(condition="Ready", toleration=30 * 60),
    RepairPolicy(condition="NetworkUnavailable", toleration=10 * 60),
    RepairPolicy(condition="StorageReady", toleration=10 * 60),
]


@dataclass
class NodeRepairController:
    store: Store
    termination: TerminationController
    name: str = "node.repair"
    requeue: float = 30.0
    enabled: bool = True
    policies: List[RepairPolicy] = field(default_factory=lambda: list(DEFAULT_POLICIES))
    _unhealthy_since: Dict[Tuple[str, str], float] = field(default_factory=dict)
    stats: Dict[str, int] = field(default_factory=lambda: {"repaired": 0})

    def reconcile(self, now: float) -> float:
        if not self.enabled:
            return self.requeue
        for node in list(self.store.nodes.values()):
            if node.nodeclaim is None:
                continue
            for pol in self.policies:
                key = (node.name, pol.condition)
                healthy = node.conditions.get(pol.condition, True) \
                    if pol.condition != "Ready" else node.ready
                if healthy:
                    self._unhealthy_since.pop(key, None)
                    continue
                since = self._unhealthy_since.setdefault(key, now)
                if now - since >= pol.toleration:
                    claim = self.store.nodeclaims.get(node.nodeclaim)
                    if claim is not None and not claim.is_deleting():
                        self.store.record_event("node", node.name, "Unhealthy",
                                                f"{pol.condition} for "
                                                f"{now - since:.0f}s: repairing")
                        self.termination.delete_nodeclaim(claim, now, "Unhealthy")
                        self.stats["repaired"] += 1
                    self._unhealthy_since.pop(key, None)
        return self.requeue
