"""Termination controller: graceful drain + finalize.

The port's own copy of `karpenter_tpu/controllers/termination.py`,
unchanged in semantics.

Reference behavior (core termination controller + the provider's Delete
path, SURVEY.md §3.4): a NodeClaim with a deletion timestamp gets its node
tainted `disrupted:NoSchedule`, pods are evicted (respecting a grace
period), the cloud instance is terminated, and only then does the claim
disappear (finalizer semantics — nothing leaks even across restarts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..models import labels as L
from ..models.nodeclaim import NodeClaim, Phase
from ..models.pod import Taint
from ..state.store import Store
from ..utils import crashpoints
from .provisioner import NOMINATED

DISRUPTED_TAINT = Taint(key=L.DISRUPTED_TAINT_KEY, effect="NoSchedule")
DEFAULT_GRACE = 30.0


@dataclass
class TerminationController:
    store: Store
    cloud: object
    catalog: object = None  # optional: reservation bookkeeping
    name: str = "termination"
    requeue: float = 0.5
    drain_grace: float = DEFAULT_GRACE
    _drain_started: Dict[str, float] = field(default_factory=dict)

    def delete_nodeclaim(self, claim: NodeClaim, now: float, reason: str = "") -> None:
        """Entry point other controllers use (interruption, disruption,
        expiration): marks for deletion; reconcile drives the drain."""
        if claim.deletion_timestamp is None:
            claim.deletion_timestamp = now
            claim.phase = Phase.TERMINATING
            from ..metrics import NODECLAIMS_TERMINATED
            NODECLAIMS_TERMINATED.inc(nodepool=claim.nodepool,
                                      reason=reason or "unknown")
            self.store.record_event("nodeclaim", claim.name, "Terminating", reason)
            # in-place mutation: broadcast it, or the warm-path delta
            # feed keeps admitting arrivals onto the draining node
            self.store.touch_nodeclaim(claim, "deleting")

    def reconcile(self, now: float) -> float:
        for claim in list(self.store.nodeclaims.values()):
            if claim.deletion_timestamp is None:
                continue
            self._terminate_one(claim, now)
        return self.requeue

    def _evict_allowed(self, claim: NodeClaim, node, pods) -> None:
        """One eviction pass: unbind pods that PDBs allow and that don't
        carry do-not-disrupt (eviction-API semantics — PDB pacing per
        budget; blocked pods stay bound and are retried next reconcile)."""
        allowed = {name: self.store.pdb_disruptions_allowed(pdb)
                   for name, pdb in self.store.pdbs.items()}
        for p in pods:
            if p.do_not_disrupt():
                continue  # never voluntarily evicted (pod-level control)
            matching = [n for n, pdb in self.store.pdbs.items()
                        if pdb.matches(p)]
            if any(allowed[m] <= 0 for m in matching):
                continue  # blocked this pass; retry next reconcile
            for m in matching:
                allowed[m] -= 1
            if p.annotations.get(NOMINATED) == claim.name:
                self.store.unnominate_pod(p)
            self.store.unbind_pod(p)

    def _terminate_one(self, claim: NodeClaim, now: float) -> None:
        node = self.store.node_for_nodeclaim(claim)
        if node is not None:
            # taint so nothing schedules onto it mid-drain
            if not any(t.key == DISRUPTED_TAINT.key for t in node.taints):
                node.taints.append(DISRUPTED_TAINT)
            start = self._drain_started.setdefault(claim.name, now)
            grace = claim.termination_grace_period or self.drain_grace
            pods = self.store.pods_on_node(node.name)
            if (claim.termination_grace_period is None
                    and any(p.do_not_disrupt() for p in pods)):
                # reference semantics (disruption.md:181-182): pods with
                # the do-not-disrupt annotation block draining
                # INDEFINITELY — only an explicit terminationGracePeriod
                # on the claim forces them out. Keep waiting; evict what
                # is evictable meanwhile. The drain clock RESTARTS here:
                # when the block finally lifts, remaining pods get a full
                # grace window, not an instant force-evict
                self._drain_started[claim.name] = now
                self._evict_allowed(claim, node, pods)
                return
            if pods and now - start < grace:
                # evict: unbind, pods return to pending for rescheduling.
                # Keep nominations pointing at OTHER claims (a pre-spun
                # consolidation replacement) — only clear ones aimed here.
                # PDB pacing: each budget releases only disruptionsAllowed
                # pods per pass; blocked pods stay bound until the evicted
                # ones reschedule and restore health (k8s eviction-API
                # semantics). After `grace` the force path tears down
                # regardless — terminationGracePeriod outranks PDBs, as in
                # the reference.
                self._evict_allowed(claim, node, pods)
                return  # wait a tick for rescheduling before teardown
            # grace expired (or node empty): force path. Any pod still
            # bound — e.g. held through grace by a zero PDB budget — is
            # force-evicted NOW; deleting the node without unbinding
            # would strand it Running on a ghost node forever, silently
            # counting as healthy in every future PDB decision
            for p in self.store.pods_on_node(node.name):
                if p.annotations.get(NOMINATED) == claim.name:
                    self.store.unnominate_pod(p)
                self.store.unbind_pod(p)
            self.store.delete_node(node.name)
        # un-nominate pods still pointing at this claim
        for p in self.store.pods.values():
            if p.annotations.get(NOMINATED) == claim.name:
                self.store.unnominate_pod(p)
                self.store.unbind_pod(p)
        if claim.provider_id:
            # cut point: the node is gone from the store, the instance is
            # still running — a crash here must resurrect the claim from
            # the instance's adoption tags on restart, never leak it
            crashpoints.fire("mid_drain")
            iid = claim.provider_id.rsplit("/", 1)[-1]
            self.cloud.terminate([iid])
        rid = claim.annotations.get("karpenter.tpu/reservation-id")
        if rid and self.catalog is not None:
            self.catalog.mark_reservation_terminated(rid, 0)
        claim.phase = Phase.TERMINATED
        self._drain_started.pop(claim.name, None)
        self.store.delete_nodeclaim(claim.name)
        self.store.record_event("nodeclaim", claim.name, "Terminated")
        if claim.deletion_timestamp is not None:
            from ..metrics import TERMINATION_DURATION
            TERMINATION_DURATION.observe(now - claim.deletion_timestamp)
