"""In-memory cluster state store — the sim's API server.

The port's own copy of `karpenter_tpu/state/store.py`, unchanged in
semantics.

Plays the role the Kubernetes API server plays for the reference (its
coordination bus; SURVEY.md §5 'distributed communication backend'):
controllers watch it via event hooks. Unlike the real API server the
store is process-local, so restart recovery rebuilds it from the cloud's
durable state (`state/rehydrate.py`: instance adoption tags + cluster
node objects); the `hydrated` flag gates destructive sweeps (GC) until
that adoption ran.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

from ..models import labels as L
from ..models.nodeclaim import Node, NodeClaim
from ..models.nodepool import NodeClassSpec, NodePool
from ..models.pod import Pod


class Store:
    def __init__(self) -> None:
        self.pods: Dict[str, Pod] = {}
        # admission-time pending-group index: gid -> {key -> pod} holding
        # exactly the provisioner's input set (Pending, unbound,
        # un-nominated). Maintained on every pod state transition so the
        # solve-time encode never walks O(pods) Python objects — the
        # delta-encode analogue of the reference caching resolved
        # instance types by hash (instancetype.go:219-229). All pod
        # state transitions MUST go through store methods (add/bind/
        # unbind/nominate/unnominate/delete) or the index goes stale.
        self._pending_groups: Dict[int, Dict[str, Pod]] = {}
        self.nodepools: Dict[str, NodePool] = {}
        self.nodeclasses: Dict[str, NodeClassSpec] = {}
        self.nodeclaims: Dict[str, NodeClaim] = {}
        # instance id (provider-id tail) -> claim name; maintained by
        # add/delete_nodeclaim + index_nodeclaim_instance so interruption
        # storms resolve claims O(1), not O(claims) per message
        self._claims_by_iid: Dict[str, str] = {}
        self.nodes: Dict[str, Node] = {}
        self.daemonsets: Dict[str, object] = {}
        self.pdbs: Dict[str, object] = {}
        self.pvcs: Dict[str, object] = {}  # PersistentVolumeClaims by key
        # pvc key -> referencing pod keys: add_pvc re-decoration must not
        # scan 100k pods per claim event
        self._pods_by_pvc: Dict[str, set] = {}
        self._watchers: Dict[str, List[Callable]] = defaultdict(list)
        self.events: List[tuple] = []  # (kind, object-name, reason, message)
        # set by state.rehydrate.rehydrate(); until then the store may be a
        # cold restart and GC must not reap (see controllers/gc.py)
        self.hydrated: bool = False
        # when rehydration adopted a live fleet, the time it did so —
        # disruption waits out a settle window from here so re-listing
        # workloads aren't raced by the empty-node pass
        self.adopted_at: Optional[float] = None

    # --- watch / events ---
    def watch(self, kind: str, fn: Callable) -> None:
        self._watchers[kind].append(fn)

    def _notify(self, kind: str, action: str, obj) -> None:
        for fn in self._watchers[kind]:
            fn(action, obj)

    def record_event(self, kind: str, name: str, reason: str, message: str = "") -> None:
        self.events.append((kind, name, reason, message))

    # --- pods ---
    def add_pod(self, pod: Pod) -> Pod:
        key = f"{pod.namespace}/{pod.name}"
        old = self.pods.get(key)
        if old is not None and old is not pod:
            # same-key replacement: evict the old OBJECT from the index
            # (its gid may differ — a stranded entry would be re-solved
            # as a ghost pod every reconcile, forever); its PVC refs go
            # too, or add_pvc events re-decorate a ghost forever
            self._index_discard(old, key)
            for pname in set(old.pvc_names):
                refs = self._pods_by_pvc.get(f"{old.namespace}/{pname}")
                if refs is not None:
                    refs.discard(key)
                    if not refs:
                        del self._pods_by_pvc[f"{old.namespace}/{pname}"]
        self.pods[key] = pod
        if old is not None and old is not pod:
            # a same-key replacement is a MUTATION of cluster state, not a
            # plain arrival — the warm-path delta tracker (and any other
            # watcher) must be able to tell the two apart
            self._notify("pod", "replace", pod)
        for name in set(pod.pvc_names):
            self._pods_by_pvc.setdefault(
                f"{pod.namespace}/{name}", set()).add(key)
        # volume constraints resolve BEFORE interning: the injected zone
        # affinity and attach-count request are part of the signature
        self._apply_volume_constraints(pod)
        # amortize constraint-signature interning to admission time: the
        # solve-time encode then groups 100k pods by one int read per pod
        # instead of re-walking Python constraint objects every reconcile
        pod.group_key()
        self._index_update(pod, key)
        self._notify("pod", "add", pod)
        return pod

    # --- persistent volume claims (volume topology + attach limits) ---
    def add_pvc(self, pvc) -> None:
        """Register/update a claim; pending pods referencing it are
        re-decorated via the pvc→pods index (a PV binding after pod
        admission must still pin the pod's zone before it schedules —
        core volume-topology behavior). A nominated pod whose nominated
        claim no longer satisfies the new pin is un-nominated so the
        provisioner re-solves with the constraint."""
        self.pvcs[pvc.key] = pvc
        self._notify("pvc", "add", pvc)
        for key in list(self._pods_by_pvc.get(pvc.key, ())):
            pod = self.pods.get(key)
            if pod is None or pod.node_name is not None:
                continue
            if pvc.bound_zone() is None and not pod.node_affinity:
                continue  # zoneless claim, nothing to re-derive
            self._index_discard(pod, key)
            self._apply_volume_constraints(pod)
            pod.invalidate_group_key()
            pod.group_key()
            self._index_update(pod, key)
            nominated = pod.annotations.get(L.NOMINATED)
            if nominated:
                claim = self.nodeclaims.get(nominated)
                want = pod.scheduling_requirements().get(L.ZONE)
                if (claim is None
                        or (want is not None
                            and (not claim.zone
                                 or not want.contains(claim.zone)))):
                    # the pre-binding nomination no longer satisfies the
                    # volume's zone — return the pod to pending. A claim
                    # whose zone is still UNKNOWN (launch in flight, the
                    # override list may span zones) is treated as not
                    # satisfying: keeping the nomination would gamble that
                    # the launch lands in the volume's zone, and a miss
                    # permanently separates the pod from its volume.
                    self.unnominate_pod(pod)

    def _apply_volume_constraints(self, pod: Pod) -> None:
        """Lower PVC effects onto existing scheduling machinery
        (models/volume.py docstring): each bound zonal claim contributes a
        required node-affinity IN term — the Requirements set-algebra then
        INTERSECTS it with user selectors and other claims, so conflicting
        zones make the pod unschedulable instead of silently landing where
        one of its volumes isn't. Unique claims each consume one
        attachable-volume resource unit (RWX claims shared across pods
        still charge per pod — the resource model is per-pod; noted
        limitation)."""
        if not pod.pvc_names:
            return
        from ..models import labels as L
        from ..models.volume import VOLUME_ATTACH_RESOURCE
        unique = sorted(set(pod.pvc_names))
        pod.requests[VOLUME_ATTACH_RESOURCE] = float(len(unique))
        # volume-injected terms are tagged so re-binding replaces, never
        # accumulates, stale pins (signature ignores the marker key)
        pod.node_affinity = [t for t in pod.node_affinity
                             if "_volume" not in t]
        for name in unique:
            pvc = self.pvcs.get(f"{pod.namespace}/{name}")
            if pvc is None:
                # referenced claim doesn't exist (informer-order race):
                # the pod must NOT schedule — if the claim later arrives
                # bound to some zone, a pod already running elsewhere is
                # permanently separated from its volume. An empty In()
                # is a requirements conflict: matches nothing, so the
                # pod stays pending until add_pvc re-decorates it.
                pod.node_affinity.append(
                    {"key": L.ZONE, "operator": "In", "values": (),
                     "_volume": f"{pod.namespace}/{name}"})
                continue
            zone = pvc.bound_zone()
            if zone is not None:
                pod.node_affinity.append(
                    {"key": L.ZONE, "operator": "In", "values": (zone,),
                     "_volume": f"{pod.namespace}/{name}"})

    def _index_update(self, pod: Pod, key: str) -> None:
        """Insert/remove a pod from the pending-group index according to
        its CURRENT state — the one reconciliation point every pod state
        transition funnels through."""
        if (pod.phase == "Pending" and pod.node_name is None
                and L.NOMINATED not in pod.annotations):
            self._pending_groups.setdefault(pod._gid, {})[key] = pod
        else:
            self._index_discard(pod, key)

    def _index_discard(self, pod: Pod, key: str) -> None:
        g = self._pending_groups.get(pod._gid)
        if g is not None:
            g.pop(key, None)
            if not g:
                del self._pending_groups[pod._gid]

    def delete_pod(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        pod = self.pods.pop(key, None)
        if pod:
            for pname in set(pod.pvc_names):
                refs = self._pods_by_pvc.get(f"{namespace}/{pname}")
                if refs is not None:
                    refs.discard(key)
                    if not refs:
                        del self._pods_by_pvc[f"{namespace}/{pname}"]
            self._index_discard(pod, key)
            self._notify("pod", "delete", pod)

    def pending_pods(self) -> List[Pod]:
        return [p for p in self.pods.values()
                if p.phase == "Pending" and p.node_name is None]

    def pending_unnominated_groups(self) -> List[List[Pod]]:
        """The provisioner's input, pre-grouped by constraint signature
        (gid) straight from the admission-time index — no per-pod pass.
        Returns fresh lists; callers may consume/mutate them freely."""
        return [list(g.values()) for g in self._pending_groups.values() if g]

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return [p for p in self.pods.values() if p.node_name == node_name]

    def bind_pod(self, pod: Pod, node_name: str) -> None:
        pod.node_name = node_name
        pod.phase = "Running"
        self._index_update(pod, f"{pod.namespace}/{pod.name}")
        self._notify("pod", "bind", pod)

    def unbind_pod(self, pod: Pod) -> None:
        """Eviction: the pod returns to the pending pool (and the
        pending-group index, unless still nominated elsewhere)."""
        pod.node_name = None
        pod.phase = "Pending"
        self._index_update(pod, f"{pod.namespace}/{pod.name}")
        self._notify("pod", "unbind", pod)

    def nominate_pod(self, pod: Pod, claim_name: str) -> None:
        pod.annotations[L.NOMINATED] = claim_name
        self._index_update(pod, f"{pod.namespace}/{pod.name}")
        self._notify("pod", "nominate", pod)

    def unnominate_pod(self, pod: Pod) -> None:
        pod.annotations.pop(L.NOMINATED, None)
        self._index_update(pod, f"{pod.namespace}/{pod.name}")
        self._notify("pod", "unnominate", pod)

    # --- daemonsets (namespaced, like the pod index — name-only keys
    # would let team-b's "agent" silently replace team-a's) ---
    def add_daemonset(self, ds) -> object:
        self.daemonsets[f"{ds.namespace}/{ds.name}"] = ds
        self._notify("daemonset", "add", ds)
        return ds

    def delete_daemonset(self, name: str,
                         namespace: str = "default") -> None:
        ds = self.daemonsets.pop(f"{namespace}/{name}", None)
        if ds is not None:
            self._notify("daemonset", "delete", ds)

    # --- pod disruption budgets (namespaced, same rationale) ---
    def add_pdb(self, pdb) -> object:
        self.pdbs[f"{pdb.namespace}/{pdb.name}"] = pdb
        self._notify("pdb", "add", pdb)
        return pdb

    def delete_pdb(self, name: str, namespace: str = "default") -> None:
        pdb = self.pdbs.pop(f"{namespace}/{name}", None)
        if pdb is not None:
            self._notify("pdb", "delete", pdb)

    def pdb_disruptions_allowed(self, pdb) -> int:
        """Live disruptionsAllowed for one PDB: matching pods across the
        cluster, healthy = bound + Running."""
        total = healthy = 0
        for p in self.pods.values():
            if pdb.matches(p):
                total += 1
                if p.node_name is not None and p.phase == "Running":
                    healthy += 1
        return pdb.disruptions_allowed(total, healthy)

    # --- nodepools / nodeclasses (validated at admission, like the
    # reference's CEL rules on the CRDs) ---
    def add_nodepool(self, np_: NodePool) -> NodePool:
        from ..models.validation import validate_nodepool
        validate_nodepool(np_)
        self.nodepools[np_.name] = np_
        self._notify("nodepool", "add", np_)
        return np_

    def add_nodeclass(self, nc: NodeClassSpec) -> NodeClassSpec:
        from ..models.validation import validate_nodeclass
        validate_nodeclass(nc)
        self.nodeclasses[nc.name] = nc
        self._notify("nodeclass", "add", nc)
        return nc

    def delete_nodeclass(self, name: str) -> None:
        nc = self.nodeclasses.pop(name, None)
        if nc is not None:
            self._notify("nodeclass", "delete", nc)

    def nodepools_by_weight(self) -> List[NodePool]:
        """Descending weight — provisioning tries heavier pools first
        (reference NodePool weight, karpenter.sh_nodepools.yaml:427-432)."""
        return sorted(self.nodepools.values(), key=lambda p: -p.weight)

    # --- nodeclaims ---
    def add_nodeclaim(self, nc: NodeClaim) -> NodeClaim:
        self.nodeclaims[nc.name] = nc
        self.index_nodeclaim_instance(nc)
        self._notify("nodeclaim", "add", nc)
        return nc

    def delete_nodeclaim(self, name: str) -> None:
        nc = self.nodeclaims.pop(name, None)
        if nc:
            if nc.provider_id:
                iid = nc.provider_id.rsplit("/", 1)[-1]
                if self._claims_by_iid.get(iid) == name:
                    del self._claims_by_iid[iid]
            self._notify("nodeclaim", "delete", nc)

    def touch_nodeclaim(self, nc: NodeClaim, action: str = "update") -> None:
        """Broadcast an IN-PLACE NodeClaim mutation to watchers. Claim
        state largely mutates on the object (phase, deletion timestamp),
        which no watcher can see — controllers making a mutation that
        changes what a solve may do (marking for deletion, cordoning)
        must call this so the warm-path delta feed observes it."""
        self._notify("nodeclaim", action, nc)

    def touch_node(self, node: Node, action: str = "update") -> None:
        """Broadcast an in-place Node mutation (e.g. a cordon taint) —
        same rationale as touch_nodeclaim."""
        self._notify("node", action, node)

    def index_nodeclaim_instance(self, nc: NodeClaim) -> None:
        """Register the claim's instance id in the lookup index — called
        when provider_id is assigned post-launch (the claim is added to the
        store before the cloud answers, so add-time indexing misses it)."""
        if nc.provider_id:
            self._claims_by_iid[nc.provider_id.rsplit("/", 1)[-1]] = nc.name

    def nodeclaims_for_pool(self, pool: str) -> List[NodeClaim]:
        return [c for c in self.nodeclaims.values() if c.nodepool == pool]

    def nodeclaim_by_provider_id(self, provider_id: str) -> Optional[NodeClaim]:
        """The provider-id index (reference operator.go:298-319)."""
        if not provider_id:
            return None
        c = self.nodeclaim_by_instance_id(provider_id.rsplit("/", 1)[-1])
        return c if c is not None and c.provider_id == provider_id else None

    def nodeclaims_by_instance_ids(self, instance_ids: Iterable[str],
                                   ) -> Dict[str, NodeClaim]:
        """Batch instance-id → NodeClaim resolution for the interruption
        drain: one pass over the maintained index for the whole batch,
        and AT MOST ONE fallback scan shared by every index miss (the
        per-message path paid a full-claims scan per unknown instance —
        at 15k-message storms that scan dominated the drain). Unknown
        ids are simply absent from the result."""
        out: Dict[str, NodeClaim] = {}
        misses: List[str] = []
        for iid in instance_ids:
            if iid in out:
                continue
            name = self._claims_by_iid.get(iid)
            if name is not None:
                c = self.nodeclaims.get(name)
                if (c is not None
                        and (c.provider_id or "").rsplit("/", 1)[-1] == iid):
                    out[iid] = c
                    continue
            misses.append(iid)
        if misses:
            want = set(misses)
            for c in self.nodeclaims.values():
                pid = c.provider_id or ""
                if not pid:
                    continue
                iid = pid.rsplit("/", 1)[-1]
                if iid in want:
                    self._claims_by_iid[iid] = c.name
                    out[iid] = c
                    want.discard(iid)
                    if not want:
                        break
        return out

    def nodeclaim_by_instance_id(self, instance_id: str) -> Optional[NodeClaim]:
        """Instance-id lookup: provider ids end in the instance id
        (tpu:///zone/i-xxx), mirroring the reference's id-from-provider-id
        parse (utils.ParseInstanceID). O(1) via the maintained index; the
        scan fallback covers claims whose provider_id was set without
        index_nodeclaim_instance (tests mutating claims directly)."""
        name = self._claims_by_iid.get(instance_id)
        if name is not None:
            c = self.nodeclaims.get(name)
            if (c is not None
                    and (c.provider_id or "").rsplit("/", 1)[-1] == instance_id):
                return c
        for c in self.nodeclaims.values():
            pid = c.provider_id or ""
            if pid and pid.rsplit("/", 1)[-1] == instance_id:
                self._claims_by_iid[instance_id] = c.name
                return c
        return None

    # --- nodes ---
    def add_node(self, node: Node) -> Node:
        self.nodes[node.name] = node
        self._notify("node", "add", node)
        return node

    def delete_node(self, name: str) -> None:
        node = self.nodes.pop(name, None)
        if node:
            self._notify("node", "delete", node)

    def node_for_nodeclaim(self, claim: NodeClaim) -> Optional[Node]:
        for n in self.nodes.values():
            if n.provider_id == claim.provider_id:
                return n
        return None
