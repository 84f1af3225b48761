"""Pod model: the demand side of scheduling.

The port's own copy of `karpenter_tpu/models/pod.py` (`Taint.evicts`,
which the port does not call, is left out). The signature intern table is
this package's own: pods of the two packages never share group ids.

Carries exactly the scheduling-relevant surface the reference's core
scheduler consumes (website/content/en/docs/concepts/scheduling.md):
resource requests, nodeSelector / requiredDuringScheduling nodeAffinity,
tolerations, topologySpreadConstraints, pod (anti-)affinity, priority, and
the do-not-disrupt annotation that gates voluntary disruption.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .requirements import Operator, Requirement, Requirements
from .resources import Resources

DO_NOT_DISRUPT = "karpenter.tpu/do-not-disrupt"

_uid = itertools.count()
# constraint-signature → int intern table backing Pod.group_key(). Bounded:
# per-pod-unique signatures (StatefulSet pod-name labels, rolling template
# hashes) would otherwise accrete one retained tuple per pod ever admitted.
# On overflow the table rotates (clears); ids are drawn from a monotonic
# counter and NEVER reused, so a pod's cached _gid stays valid across
# rotations — equal signatures in different generations may land in
# different groups, which only costs a little dedupe, never correctness.
_sig_intern: Dict[Tuple, int] = {}
_SIG_INTERN_MAX = 1_000_000
_next_gid = itertools.count()


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str
    effect: str  # NoSchedule | PreferNoSchedule | NoExecute
    value: str = ""


def tolerates_all(tolerations: List[Toleration], taints: List[Taint]) -> bool:
    """Pod schedulable w.r.t. taints (PreferNoSchedule is non-blocking)."""
    for t in taints:
        if t.effect == "PreferNoSchedule":
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


@dataclass
class TopologySpreadConstraint:
    topology_key: str
    max_skew: int = 1
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    # Selector semantics (k8s LabelSelectorAsSelector, one deviation):
    #   None (default) — the constraint spreads the pod's own dedupe group
    #     (in k8s a nil selector matches nothing, making the constraint
    #     vacuous; every real workload sets selector = its own labels, so
    #     the None default does what those workloads mean without the
    #     boilerplate)
    #   {}            — matches EVERY pod in the namespace
    #   non-empty     — matches pods whose labels contain all entries
    label_selector: Optional[Dict[str, str]] = None

    def matches(self, labels: Dict[str, str]) -> bool:
        """Does a pod with `labels` match this constraint's selector?
        (None → no external pods; callers handle the self-group case.)"""
        if self.label_selector is None:
            return False
        return all(labels.get(k) == v for k, v in self.label_selector.items())


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: Dict[str, str] = field(default_factory=dict)
    anti: bool = False  # True for podAntiAffinity
    # False = preferredDuringSchedulingIgnoredDuringExecution: best-effort,
    # never blocks placement (excluded from conflict matrices and per-node
    # caps; the solver may honor it when free)
    required: bool = True


def term_selects(term: PodAffinityTerm, same_ns: bool,
                 labels: Dict[str, str]) -> bool:
    """THE pod-affinity selector match (k8s LabelSelector semantics over a
    same-namespace gate). Single definition — every consumer (zone pre-pass,
    co-location planner, conflict matrices, resident bans) must route
    through here so selector semantics can never diverge."""
    return same_ns and all(labels.get(k) == v
                           for k, v in term.label_selector.items())


def required_anti_terms(p: "Pod", topology_key: str) -> List[PodAffinityTerm]:
    return [t for t in p.affinity_terms
            if t.anti and t.required and t.topology_key == topology_key]


def anti_blocks(a: "Pod", b: "Pod", topology_key: str) -> bool:
    """Required anti-affinity at `topology_key` forbids a and b sharing
    that topology domain — symmetric (k8s enforces both directions),
    same-namespace."""
    same_ns = a.namespace == b.namespace
    return (any(term_selects(t, same_ns, b.labels)
                for t in required_anti_terms(a, topology_key))
            or any(term_selects(t, same_ns, a.labels)
                   for t in required_anti_terms(b, topology_key)))


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    requests: Resources = field(default_factory=Resources)
    node_selector: Dict[str, str] = field(default_factory=dict)
    # requiredDuringSchedulingIgnoredDuringExecution terms ({key,operator,values})
    node_affinity: List[dict] = field(default_factory=list)
    # preferredDuringScheduling terms ({key,operator,values,weight}) — the
    # encoder narrows the group's compatible types to each preference in
    # descending weight order while at least one available offering
    # survives; an unsatisfiable preference is dropped, never blocking
    preferred_node_affinity: List[dict] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    affinity_terms: List[PodAffinityTerm] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    # PersistentVolumeClaim names (same namespace): the store resolves
    # bound claims into required zone node-affinity terms + an
    # attachable-volumes resource request at admission (models/volume.py);
    # a missing claim injects a conflict term that blocks scheduling
    pvc_names: List[str] = field(default_factory=list)
    priority: int = 0
    deletion_cost: int = 0
    owner: Optional[str] = None  # replicaset/deployment key, for spread selectors
    uid: int = field(default_factory=lambda: next(_uid))
    node_name: Optional[str] = None  # bound node (None = pending)
    phase: str = "Pending"
    _sig: Optional[Tuple] = field(default=None, repr=False, compare=False)
    _gid: Optional[int] = field(default=None, repr=False, compare=False)

    def scheduling_requirements(self) -> Requirements:
        """nodeSelector + required nodeAffinity as one Requirements conjunction."""
        r = Requirements.from_labels(self.node_selector)
        for term in self.node_affinity:
            r.add(Requirement(term["key"], Operator(term["operator"]),
                              tuple(term.get("values", ()))))
        return r

    def do_not_disrupt(self) -> bool:
        return self.annotations.get(DO_NOT_DISRUPT) == "true"

    def has_self_anti_affinity(self) -> bool:
        """Required hostname anti-affinity against the pod's own labels
        (max 1/node); preferred terms never block."""
        for t in self.affinity_terms:
            if t.anti and t.required and t.topology_key == "kubernetes.io/hostname":
                if all(self.labels.get(k) == v for k, v in t.label_selector.items()):
                    return True
        return False

    def constraint_signature(self) -> Tuple:
        """Hashable signature for exact-dedupe grouping in the solver.

        Two pods with equal signatures are interchangeable to the scheduler
        — same requests, same constraints — so the solver packs them as a
        (group, count) instead of row-per-pod. This is the key data reduction
        that lets the solver kernel scan over O(groups) not O(pods).

        Labels, namespace, and owner are part of the signature because other
        pods' anti-affinity / topology-spread selectors can distinguish pods
        by them; deduping across label sets would merge pods that must be
        spread apart.

        Cached after first computation (a pod's scheduling constraints are
        immutable post-creation) — this is the encode hot path at 100k pods.
        """
        if self._sig is not None:
            return self._sig
        # fast path: a plain pod (requests only — the overwhelmingly common
        # shape at 100k-pod scale) skips building eight empty fields; no
        # closure allocation here, this runs once per pod in the fleet
        if not (self.labels or self.node_selector or self.node_affinity
                or self.preferred_node_affinity or self.tolerations
                or self.topology_spread or self.affinity_terms):
            it = tuple(self.requests.items())
            self._sig = (self.namespace, self.owner,
                         it if len(it) <= 1 else tuple(sorted(it)))
            return self._sig
        empty = ()

        def items(d):  # most of these dicts have 0-2 entries; sorted() on
            if not d:  # a 1-tuple dominated the 100k-pod encode profile
                return empty
            it = tuple(d.items())
            return it if len(it) == 1 else tuple(sorted(it))

        self._sig = (
            self.namespace,
            self.owner,
            items(self.labels),
            items(self.requests),
            items(self.node_selector),
            tuple(sorted((t["key"], t["operator"], tuple(t.get("values", ())))
                         for t in self.node_affinity)) if self.node_affinity else empty,
            tuple(sorted((t["key"], t["operator"], tuple(t.get("values", ())),
                          t.get("weight", 1))
                         for t in self.preferred_node_affinity))
            if self.preferred_node_affinity else empty,
            tuple(sorted((t.key, t.operator, t.value, t.effect)
                         for t in self.tolerations)) if self.tolerations else empty,
            tuple(sorted(((c.topology_key, c.max_skew, c.when_unsatisfiable,
                           None if c.label_selector is None
                           else tuple(sorted(c.label_selector.items())))
                          for c in self.topology_spread),
                         key=repr)) if self.topology_spread else empty,
            tuple(sorted((t.topology_key, t.anti, t.required,
                          tuple(sorted(t.label_selector.items())))
                         for t in self.affinity_terms)) if self.affinity_terms else empty,
        )
        return self._sig

    def invalidate_group_key(self) -> None:
        """Drop the cached signature/intern id after a constraint-bearing
        field changed post-admission (e.g. a PVC binding injected a zone
        selector) — callers must re-run store indexing afterwards."""
        self._sig = None
        self._gid = None

    def group_key(self) -> int:
        """Process-interned int id of constraint_signature().

        Grouping 100k pods by nested-tuple signatures re-hashes every tuple
        per solve; interning to a small int once per pod lifetime (the store
        does it at admission) makes solve-time grouping an int-dict pass.
        Equal signatures map to the same id WITHIN one intern generation;
        the table rotates at capacity, so pods admitted across a rotation
        can hold different ids for equal signatures — group_pods merges
        such split groups by signature afterwards, keeping grouping
        exactly signature-equality.
        """
        gid = self._gid
        if gid is None:
            sig = self.constraint_signature()
            gid = _sig_intern.get(sig)
            if gid is None:
                if len(_sig_intern) >= _SIG_INTERN_MAX:
                    _sig_intern.clear()  # rotate; ids stay monotonic
                gid = next(_next_gid)
                _sig_intern[sig] = gid
            self._gid = gid
        return gid


def intern_pods(pods) -> None:
    """Batch group_key over a pod sequence — the cold-encode fast path.

    Semantically identical to calling p.group_key() per pod, but one
    fused loop with no per-pod method-call frames, plus a batch-local
    preliminary key for plain pods: the UNSORTED requests items-tuple.
    Equal-content request dicts built in the same key order (the
    overwhelmingly common case — one manifest stamped N times) hit the
    prelim dict and skip signature canonicalization entirely, so the
    sorted canonical tuple is built once per DISTINCT shape, not once
    per pod. Dicts whose keys arrived in different orders miss prelim
    and canonicalize — they still intern to the same gid (correctness
    never depends on the prelim hit). This is the analogue of the
    reference caching resolved instance types by hash so the hot path
    never re-derives (instancetype.go:219-229)."""
    intern = _sig_intern
    prelim: Dict[Tuple, int] = {}
    for p in pods:
        if p._gid is not None:
            continue
        sig = p._sig
        if sig is None:
            if not (p.labels or p.node_selector or p.node_affinity
                    or p.preferred_node_affinity or p.tolerations
                    or p.topology_spread or p.affinity_terms):
                it = tuple(p.requests.items())
                key = (p.namespace, p.owner, it)
                gid = prelim.get(key)
                if gid is not None:
                    p._gid = gid
                    continue  # _sig stays lazy; constraint_signature()
                    # recomputes it on demand from the same immutable data
                sig = (p.namespace, p.owner,
                       it if len(it) <= 1 else tuple(sorted(it)))
                p._sig = sig
                gid = intern.get(sig)
                if gid is None:
                    if len(intern) >= _SIG_INTERN_MAX:
                        intern.clear()  # rotate; ids stay monotonic
                    gid = next(_next_gid)
                    intern[sig] = gid
                p._gid = gid
                prelim[key] = gid
                continue
            # decorated pods (labels/affinity/spread/…): same prelim trick
            # with an UNSORTED content key. Sound on hit — equal insertion-
            # order content implies equal canonical signature — and hit by
            # the common fleet shape (one manifest stamped N times builds
            # every dict/list in the same order). Misses (same content,
            # different order) just canonicalize and intern to the same gid.
            key = (p.namespace, p.owner, tuple(p.labels.items()),
                   tuple(p.requests.items()), tuple(p.node_selector.items()),
                   tuple((t["key"], t["operator"], tuple(t.get("values", ())))
                         for t in p.node_affinity),
                   tuple((t["key"], t["operator"], tuple(t.get("values", ())),
                          t.get("weight", 1))
                         for t in p.preferred_node_affinity),
                   tuple((t.key, t.operator, t.value, t.effect)
                         for t in p.tolerations),
                   tuple((c.topology_key, c.max_skew, c.when_unsatisfiable,
                          None if c.label_selector is None
                          else tuple(c.label_selector.items()))
                         for c in p.topology_spread),
                   tuple((t.topology_key, t.anti, t.required,
                          tuple(t.label_selector.items()))
                         for t in p.affinity_terms))
            gid = prelim.get(key)
            if gid is not None:
                p._gid = gid
                continue
            sig = p.constraint_signature()
            gid = intern.get(sig)
            if gid is None:
                if len(intern) >= _SIG_INTERN_MAX:
                    intern.clear()  # rotate; ids stay monotonic
                gid = next(_next_gid)
                intern[sig] = gid
            p._gid = gid
            prelim[key] = gid
            continue
        gid = intern.get(sig)
        if gid is None:
            if len(intern) >= _SIG_INTERN_MAX:
                intern.clear()  # rotate; ids stay monotonic
            gid = next(_next_gid)
            intern[sig] = gid
        p._gid = gid


@dataclass
class DaemonSet:
    """A per-node workload whose pods run on every compatible node —
    the scheduler reserves its requests on each virtual node BEFORE
    placing workloads (reference core: daemonset overhead in the
    scheduling simulation; the scale suite's GetDaemonSetCount adjusts
    density expectations for it, test/suites/scale)."""

    name: str
    requests: Resources = field(default_factory=Resources)
    namespace: str = "default"
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)

    def scheduling_requirements(self) -> Requirements:
        return Requirements.from_labels(self.node_selector)


@dataclass
class PodDisruptionBudget:
    """Voluntary-disruption guard for a workload (the k8s PDB the
    reference core consults: nodes whose pods' PDBs would be violated
    are excluded from disruption candidates, and eviction during drain
    is paced to disruptionsAllowed — SURVEY §3 disruption call stack).

    Exactly one of min_available / max_unavailable should be set; each
    is an absolute count or a percent string over the matching-pod
    total."""

    name: str
    label_selector: Dict[str, str]
    namespace: str = "default"
    min_available: Optional[object] = None   # int | "50%"
    max_unavailable: Optional[object] = None

    def matches(self, pod: "Pod") -> bool:
        return (pod.namespace == self.namespace
                and all(pod.labels.get(k) == v
                        for k, v in self.label_selector.items()))

    @staticmethod
    def _abs(value, total: int) -> int:
        if isinstance(value, str) and value.endswith("%"):
            import math
            return math.ceil(total * float(value[:-1]) / 100.0)
        return int(value)

    def disruptions_allowed(self, total: int, healthy: int) -> int:
        """k8s semantics: healthy − desiredHealthy (never negative)."""
        if self.max_unavailable is not None:
            desired = total - self._abs(self.max_unavailable, total)
        elif self.min_available is not None:
            desired = self._abs(self.min_available, total)
        else:
            return total  # no constraint
        return max(0, healthy - desired)
