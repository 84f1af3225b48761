"""NodeClaim lifecycle + pod binding controllers.

The port's own copy of `karpenter_tpu/controllers/lifecycle.py`,
unchanged in semantics.

Mirrors the reference core's node-lifecycle controllers (SURVEY.md §2.3):
registration (instance → node object joins), initialization (node Ready +
startup taints cleared), liveness (launch that never registers is reaped
after a TTL), and — sim-only — a binding controller playing kube-scheduler
for nominated pods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..models import labels as L
from ..models.nodeclaim import Node, NodeClaim, Phase
from ..state.store import Store
from .provisioner import NOMINATED

REGISTRATION_TTL = 15 * 60  # reference liveness: 15m launch→registered


@dataclass
class LifecycleController:
    store: Store
    cloud: object
    name: str = "nodeclaim.lifecycle"
    registration_ttl: float = REGISTRATION_TTL
    requeue: float = 1.0

    def reconcile(self, now: float) -> float:
        # adopt newly created nodes (registration)
        for node in list(self.store.nodes.values()):
            if node.nodeclaim is None:
                claim = self.store.nodeclaim_by_provider_id(node.provider_id)
                if claim is not None:
                    self._register(claim, node, now)
        for claim in list(self.store.nodeclaims.values()):
            if claim.is_deleting():
                continue
            if claim.phase == Phase.LAUNCHED:
                node = self.store.node_for_nodeclaim(claim)
                if node is None and now - claim.launched_at > self.registration_ttl:
                    # liveness reap: instance never became a node
                    self.store.record_event("nodeclaim", claim.name,
                                            "RegistrationTimeout", "reaping")
                    self._reap(claim)
            elif (claim.phase == Phase.PENDING
                  and now - claim.created_at > self.registration_ttl):
                # safety net: a claim whose CreateFleet never succeeded
                # (crash between claim creation and launch) must not
                # live forever — the provisioner rolls these back on the
                # throttle path, this covers anything else
                self.store.record_event("nodeclaim", claim.name,
                                        "LaunchTimeout", "reaping")
                self._reap(claim)
            elif claim.phase == Phase.REGISTERED:
                node = self.store.node_for_nodeclaim(claim)
                if node is not None and node.ready:
                    self._initialize(claim, node, now)
        return self.requeue

    def _register(self, claim: NodeClaim, node: Node, now: float) -> None:
        node.nodeclaim = claim.name
        node.labels.update(claim.labels)
        node.labels[L.NODE_REGISTERED] = "true"
        node.taints = list(claim.taints) + list(claim.startup_taints)
        claim.node_name = node.name
        claim.phase = Phase.REGISTERED
        claim.registered_at = now
        claim.set_condition("Registered", True, now=now)
        from ..metrics import LIFECYCLE_DURATION
        LIFECYCLE_DURATION.observe(now - claim.created_at, phase="registered")

    def _initialize(self, claim: NodeClaim, node: Node, now: float) -> None:
        # startup taints cleared + node ready → Initialized
        node.taints = [t for t in node.taints
                       if t not in claim.startup_taints]
        node.labels[L.NODE_INITIALIZED] = "true"
        claim.phase = Phase.INITIALIZED
        claim.initialized_at = now
        claim.set_condition("Initialized", True, now=now)
        from ..metrics import LIFECYCLE_DURATION
        LIFECYCLE_DURATION.observe(now - claim.created_at, phase="initialized")

    def _reap(self, claim: NodeClaim) -> None:
        if claim.provider_id:
            iid = claim.provider_id.rsplit("/", 1)[-1]
            self.cloud.terminate([iid])
        for pod in self.store.pods.values():
            if pod.annotations.get(NOMINATED) == claim.name:
                self.store.unnominate_pod(pod)
        self.store.delete_nodeclaim(claim.name)


@dataclass
class BindingController:
    """Sim-side kube-scheduler: binds nominated pods once their node is
    ready (the kwok stack relies on real kube-scheduler; our in-memory sim
    needs this explicit stand-in)."""

    store: Store
    name: str = "binding"
    requeue: float = 0.5

    def reconcile(self, now: float) -> float:
        claims_by_name: Dict[str, NodeClaim] = self.store.nodeclaims
        for pod in list(self.store.pods.values()):
            if pod.node_name is not None:
                continue
            claim_name = pod.annotations.get(NOMINATED)
            if not claim_name:
                continue
            claim = claims_by_name.get(claim_name)
            if claim is None:
                # claim gone: back to pending (and the pending index)
                self.store.unnominate_pod(pod)
                continue
            if claim.phase in (Phase.REGISTERED, Phase.INITIALIZED) and claim.node_name:
                node = self.store.nodes.get(claim.node_name)
                if node is not None and node.ready:
                    self.store.bind_pod(pod, node.name)
        return self.requeue
