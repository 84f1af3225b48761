"""ClusterState: the solver-facing view of live nodes.

The port's own copy of `karpenter_tpu/state/cluster.py`, unchanged in
semantics.

The reference keeps an in-memory cluster mirror (`state.NewCluster`,
cmd/controller/main.go:43) that the scheduler and disruption controllers
simulate against. Ours projects the Store into VirtualNodes (committed
type + occupancy) so provisioning fills real headroom and consolidation
re-solves against it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models import labels as L
from ..models.nodeclaim import Node, NodeClaim, Phase
from ..models.pod import Pod
from ..models.resources import Resources
from ..ops.binpack import VirtualNode
from ..ops.encode import CatalogTensors
from ..state.store import Store


@dataclass
class NodeView:
    claim: NodeClaim
    node: Optional[Node]
    pods: List[Pod]
    virtual: VirtualNode
    price: float

    @property
    def name(self) -> str:
        return self.claim.name

    def disruption_cost(self) -> float:
        """Candidate ordering (reference consolidation orders candidates by
        pod count / deletion cost / priority / remaining lifetime —
        designs/consolidation.md): cheaper-to-disrupt first."""
        cost = 0.0
        for p in self.pods:
            cost += 1.0 + p.deletion_cost / 1000.0 + p.priority / 1e6
        return cost

    def has_do_not_disrupt(self) -> bool:
        """Voluntary-disruption block: any resident pod carries the
        annotation, or the NODE/claim itself does (reference node-level
        controls, disruption.md:385-396 — karpenter.sh/do-not-disrupt on
        the Node object blocks all voluntary disruption)."""
        from ..models.pod import DO_NOT_DISRUPT
        if self.node is not None and \
                self.node.annotations.get(DO_NOT_DISRUPT) == "true":
            return True
        if self.claim.annotations.get(DO_NOT_DISRUPT) == "true":
            return True
        return any(p.do_not_disrupt() for p in self.pods)


def copy_virtual_node(vn: VirtualNode) -> VirtualNode:
    """Independent copy of a VirtualNode (masks/cum/placement maps are
    fresh objects): the one copy both the facade's colocation branch and
    the warm-path ledger/audit snapshots use, so a new VirtualNode field
    has a single place to be added to."""
    return VirtualNode(
        type_idx=vn.type_idx, zone_mask=vn.zone_mask.copy(),
        cap_mask=vn.cap_mask.copy(), cum=vn.cum.copy(),
        pods_by_group=dict(vn.pods_by_group),
        prior_by_group=dict(vn.prior_by_group),
        banned_groups=vn.banned_groups,
        existing_name=vn.existing_name)


def pool_node_views(store: Store, cat: CatalogTensors, clock_now: float,
                    pool_name: str) -> List[NodeView]:
    """The node views ONE NodePool's solve may fill: live + in-flight
    claims of the pool, minus nodes cordoned for disruption (reusing a
    disrupted node's headroom would rot the validated disruption while
    its replacement boots). The single filter the provisioner's cold
    path and the warm-path ledger share — the two headroom views must
    be identical or the warm auditor meters false divergence."""
    out = []
    for view in build_node_views(store, cat, clock_now):
        if view.claim.nodepool != pool_name:
            continue
        if view.node is not None and any(
                t.key == L.DISRUPTED_TAINT_KEY for t in view.node.taints):
            continue
        out.append(view)
    return out


def cluster_occupancy(store: Store,
                      by_claim: Optional[Dict[str, List[Pod]]] = None,
                      ) -> List[Tuple[Optional[str], List[Pod]]]:
    """Cluster-wide (zone, pods) per node — every pool's claims plus
    unmanaged nodes — for topology-spread domain counting (k8s counts
    matching pods wherever they run, not per NodePool). Moved here from
    the provisioner so the warm-path commit snapshots the same view the
    cold solve seeds spread constraints with.

    by_claim: optional out-param mapping claim name → its (shared) pods
    list in the returned view, so the warm path can append placements to
    a claim's entry in place instead of rebuilding the whole view."""
    out: List[Tuple[Optional[str], List[Pod]]] = []
    claim_node_names = set()
    # one pass over all pods: nominated-but-unbound pods per claim
    nominated: Dict[str, List[Pod]] = {}
    for p in store.pods.values():
        c = p.annotations.get(L.NOMINATED)
        if c is not None and p.node_name is None:
            nominated.setdefault(c, []).append(p)
    for claim in store.nodeclaims.values():
        if claim.node_name:
            # claim its node even when deleting, so the drained node's
            # pods aren't double-counted through the unmanaged loop
            claim_node_names.add(claim.node_name)
        if claim.is_deleting():
            continue
        pods = list(nominated.get(claim.name, []))
        if claim.node_name:
            pods.extend(store.pods_on_node(claim.node_name))
        if by_claim is not None:
            by_claim[claim.name] = pods
        out.append((claim.zone, pods))
    for node in store.nodes.values():
        if node.name in claim_node_names:
            continue
        out.append((node.labels.get(L.ZONE),
                    store.pods_on_node(node.name)))
    return out


def build_node_views(store: Store, cat: CatalogTensors,
                     clock_now: float) -> List[NodeView]:
    """A view of every live claim with a known type: its node's pods (in
    the store's order), then the pods nominated to it and still unbound
    (in the store's order), their summed requests as `cum`. One pass over
    the store's pods gathers the nominated ones of every claim; a node's
    pods come from the store's index."""
    views: List[NodeView] = []
    nominated: Dict[str, List[Pod]] = {}
    for p in store.pods.values():
        c = p.annotations.get(L.NOMINATED)
        if c is not None and p.node_name is None:
            nominated.setdefault(c, []).append(p)
    for claim in store.nodeclaims.values():
        if claim.is_deleting() or claim.phase not in (Phase.LAUNCHED,
                                                      Phase.REGISTERED,
                                                      Phase.INITIALIZED):
            continue
        t_idx = cat.name_to_idx.get(claim.instance_type or "")
        if t_idx is None:
            continue
        node = store.node_for_nodeclaim(claim)
        pods = store.pods_on_node(node.name) if node else []
        # nominated-but-unbound pods also occupy the claim
        pods.extend(nominated.get(claim.name, ()))
        # summed in place, in pod order: the same float64 sums (so the
        # same float32 cum) as adding one Resources at a time
        cum_res = Resources()
        for p in pods:
            for k, v in p.requests.items():
                cum_res[k] = cum_res.get(k, 0.0) + v
        vec = cum_res.to_vector()
        cum = np.zeros(len(cat.resources), np.float32)
        cum[: len(vec)] = vec[: len(cum)]
        zone_mask = np.array([z == claim.zone for z in cat.zones], bool) \
            if claim.zone else np.ones(cat.Z, bool)
        cap_mask = np.array([c == claim.capacity_type for c in cat.captypes], bool) \
            if claim.capacity_type else np.ones(cat.C, bool)
        views.append(NodeView(
            claim=claim, node=node, pods=pods,
            virtual=VirtualNode(type_idx=t_idx, zone_mask=zone_mask,
                                cap_mask=cap_mask, cum=cum,
                                existing_name=claim.name),
            price=claim.price))
    return views
