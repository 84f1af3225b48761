"""Tensorization: flatten catalog + pods into dense arrays for the solver.

The port's own copy of `karpenter_tpu/ops/encode.py`, cold and cached
paths (the encode cache and staging arena are `ops/encode_cache.py`), with
the recompute ledger's `encode` and `conflict` classifications. Every
array it produces equals the reference's byte for byte.

This is the host→device boundary of the build plan (SURVEY.md §7):

  catalog  →  allocatable[T,R], price[T,Z,C], available[T,Z,C],
              label_val[T,L] (int-coded categorical), label_num[T,Ln]
  pods     →  exact-dedupe groups (constraint_signature) →
              requests[G,R], counts[G], compat[G,T], allow_zone[G,Z],
              allow_cap[G,C], max_per_node[G]

The Requirements set-algebra (In/NotIn/Exists/DoesNotExist/Gt/Lt) lowers to
vocabulary-interned integer comparisons: each categorical label key gets a
vocab (value→id), each instance type a single value id per key (types are
built from single-valued labels), and each pod constraint becomes a boolean
allowed-vector over the vocab gathered through the type's value ids. Numeric
keys additionally keep float values so Gt/Lt stay exact. Zone and
capacity-type constraints map onto the offering axes (Z, C) instead of the
label mask — they vary per offering, not per type (reference models this the
same way: Offering carries its own zone/capacity-type requirements,
offering/offering.go:140-149).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models import labels as L
from ..models.instancetype import InstanceType
from ..models.pod import Pod, Taint, intern_pods, term_selects, tolerates_all
from ..models.requirements import (Operator, Requirement, Requirements,
                                   ValueSet, _tolerates_absence)
from ..models.resources import num_resources, resource_axis

ABSENT = -1
CAPACITY_TYPES = (L.CAPACITY_ON_DEMAND, L.CAPACITY_SPOT, L.CAPACITY_RESERVED)

# exotic-instance filter (reference filter.go:279 ExoticInstanceFilter):
# metal and accelerator-carrying types are excluded unless the pod requests
# the resource or its requirements show explicit intent via these keys
from ..models.resources import GPU as _R_GPU
from ..models.resources import NVIDIA_GPU as _R_NVIDIA
from ..models.resources import TPU_CHIP as _R_TPU

EXOTIC_RESOURCES = (_R_NVIDIA, _R_GPU, _R_TPU)
EXOTIC_INTENT_KEYS = frozenset({
    L.INSTANCE_TYPE, L.INSTANCE_FAMILY, L.INSTANCE_SIZE,
    L.INSTANCE_GPU_NAME, L.INSTANCE_GPU_MANUFACTURER, L.INSTANCE_GPU_COUNT,
    L.INSTANCE_GPU_MEMORY, L.INSTANCE_ACCELERATOR_NAME,
    L.INSTANCE_ACCELERATOR_MANUFACTURER, L.INSTANCE_ACCELERATOR_COUNT,
})


def wants_exotic(rep: Pod, reqs: "Requirements") -> bool:
    """Does a pod express intent for exotic (metal/accelerator) types —
    either by requesting an exotic resource or by constraining an
    exotic-intent label key? The ONE definition both the encoder and the
    co-location planner consult."""
    return (any(rep.requests.get(r, 0.0) > 0 for r in EXOTIC_RESOURCES)
            or any(k in EXOTIC_INTENT_KEYS for k in reqs.keys()))


def exotic_mask(cat: "CatalogTensors") -> np.ndarray:
    """bool [T]: metal or accelerator-carrying types (reference
    filter.go:279: these only serve pods that ask for them — a cheap spot
    GPU box must not absorb plain web pods)."""
    ex = np.zeros(cat.T, bool)
    for rname in EXOTIC_RESOURCES:
        if rname in cat.resources:
            ex |= cat.allocatable[:, cat.resources.index(rname)] > 0
    if L.INSTANCE_SIZE in cat.label_keys:
        metal_id = cat.vocab[L.INSTANCE_SIZE].get("metal")
        if metal_id is not None:
            ex |= cat.label_val[:, cat.label_keys.index(L.INSTANCE_SIZE)] == metal_id
    return ex


@dataclass
class CatalogTensors:
    names: List[str]                      # [T]
    zones: List[str]                      # [Z]
    captypes: Tuple[str, ...]             # [C]
    resources: Tuple[str, ...]            # [R] axis snapshot
    allocatable: np.ndarray               # f32 [T, R]
    price: np.ndarray                     # f32 [T, Z, C], +inf = no offering
    available: np.ndarray                 # bool [T, Z, C]
    reservation_cap: np.ndarray           # i32 [T, Z, C]
    label_keys: List[str]                 # [Lc] categorical keys
    vocab: Dict[str, Dict[str, int]]      # key -> value -> id
    label_val: np.ndarray                 # i32 [T, Lc], ABSENT where missing
    numeric_keys: List[str]               # [Ln]
    label_num: np.ndarray                 # f32 [T, Ln], nan where missing
    name_to_idx: Dict[str, int] = field(default_factory=dict)
    # bool [T, Z, C]: the offering is a capacity-block reservation
    # (reference CapacityReservationType capacity-block, filter.go:163-228
    # — blocks only serve launches that explicitly target reserved
    # capacity; the facade masks these out of `available` otherwise)
    is_block: Optional[np.ndarray] = None
    # f32 [T, Z, R]: zone-VARYING daemonset reservation (zone-pinned
    # daemonsets that only partially overlap the pool's zones). A node
    # reserves the elementwise max over its remaining zone mask, so a
    # node whose zones narrow away from the daemonset's zones gets its
    # headroom back — more accurate than the reference, which charges
    # any template-compatible daemonset unconditionally (core scheduler
    # daemonset simulation). Zone-invariant overhead is baked into
    # `allocatable` instead (apply_daemonset_overhead). None = absent.
    zone_overhead: Optional[np.ndarray] = None
    # encode-cache key for THIS immutable catalog view (ops/encode_cache):
    # the facade stamps it from the (nodeclass-hash, catalog-epoch) tensor
    # key and extends it for every derived view (block gating, daemonset
    # overhead). None = view not cache-addressable; encode_pods then
    # computes every row fresh. Callers that mutate tensors in place
    # (tests poking availability holes) must clear or re-key it.
    cache_token: Optional[tuple] = None

    @property
    def T(self) -> int:
        return len(self.names)

    @property
    def Z(self) -> int:
        return len(self.zones)

    @property
    def C(self) -> int:
        return len(self.captypes)


def encode_catalog(types: Sequence[InstanceType],
                   zones: Optional[Sequence[str]] = None) -> CatalogTensors:
    if zones is None:
        zs: List[str] = sorted({o.zone for t in types for o in t.offerings})
    else:
        zs = list(zones)
    zidx = {z: i for i, z in enumerate(zs)}
    cidx = {c: i for i, c in enumerate(CAPACITY_TYPES)}

    # collect label keys and vocabularies across the whole catalog
    label_keys: List[str] = []
    numeric_keys: List[str] = []
    seen_keys = set()
    for t in types:
        for k in t.requirements.keys():
            if k in L.OFFERING_LABELS or k in seen_keys:
                continue
            seen_keys.add(k)
            label_keys.append(k)
            if k in L.NUMERIC_LABELS:
                numeric_keys.append(k)
    vocab: Dict[str, Dict[str, int]] = {k: {} for k in label_keys}
    for t in types:
        for k in label_keys:
            vs = t.requirements.get(k)
            if vs is not None and not vs.complement:
                for v in vs.values:
                    vocab[k].setdefault(v, len(vocab[k]))

    # allocatable vectors first (to_vector may auto-register resources);
    # read the axis length only after all vectors are built
    alloc_vecs = [t.allocatable().to_vector() for t in types]
    R = num_resources()
    T = len(types)
    allocatable = np.zeros((T, R), np.float32)
    for i, v in enumerate(alloc_vecs):
        allocatable[i, : len(v)] = v

    kidx = {k: j for j, k in enumerate(label_keys)}
    nidx = {k: j for j, k in enumerate(numeric_keys)}
    label_val = np.full((T, len(label_keys)), ABSENT, np.int32)
    label_num = np.full((T, len(numeric_keys)), np.nan, np.float32)
    price = np.full((T, len(zs), len(CAPACITY_TYPES)), np.inf, np.float32)
    available = np.zeros((T, len(zs), len(CAPACITY_TYPES)), bool)
    reservation_cap = np.zeros((T, len(zs), len(CAPACITY_TYPES)), np.int32)
    is_block = np.zeros((T, len(zs), len(CAPACITY_TYPES)), bool)

    for i, t in enumerate(types):
        for k in label_keys:
            vs = t.requirements.get(k)
            if vs is None or vs.complement or len(vs.values) != 1:
                continue  # multi-valued/complement type labels stay ABSENT
            (v,) = vs.values
            label_val[i, kidx[k]] = vocab[k][v]
            if k in nidx:
                try:
                    label_num[i, nidx[k]] = float(v)
                except ValueError:
                    pass
        for o in t.offerings:
            zi = zidx.get(o.zone)
            ci = cidx.get(o.capacity_type)
            if zi is None or ci is None:
                continue
            price[i, zi, ci] = o.price
            available[i, zi, ci] = o.available
            reservation_cap[i, zi, ci] = o.reservation_capacity
            # last-write-wins like the sibling per-cell fields — a sticky
            # OR here could mark a colliding non-block reserved offering
            # as a block and gate it away for unconstrained pools
            is_block[i, zi, ci] = (o.reservation_id is not None
                                   and o.reservation_type == "capacity-block")

    return CatalogTensors(
        names=[t.name for t in types], zones=zs, captypes=CAPACITY_TYPES,
        resources=tuple(resource_axis()), allocatable=allocatable, price=price,
        available=available, reservation_cap=reservation_cap,
        is_block=is_block,
        label_keys=label_keys, vocab=vocab, label_val=label_val,
        numeric_keys=numeric_keys, label_num=label_num,
        name_to_idx={t.name: i for i, t in enumerate(types)},
    )


# --- pod grouping -----------------------------------------------------------


@dataclass
class PodGroup:
    pods: List[Pod]
    representative: Pod

    @property
    def count(self) -> int:
        return len(self.pods)


def group_pods(pods: Sequence[Pod]) -> List[PodGroup]:
    """Exact-dedupe pods into interchangeable groups (see
    Pod.constraint_signature). Order is deterministic: groups sorted by
    descending cpu-then-memory of the representative — the FFD 'decreasing'
    ordering (reference designs/bin-packing.md sorts pods by size desc).

    Grouping keys on the interned int group id (Pod.group_key): pods the
    store already admitted cost one attribute read each; raw pods go
    through the batched intern_pods fast path first."""
    intern_pods(pods)
    by_gid: Dict[int, List[Pod]] = {}
    for p in pods:
        lst = by_gid.get(p._gid)
        if lst is None:
            by_gid[p._gid] = [p]
        else:
            lst.append(p)
    return _finalize_groups(
        [PodGroup(pods=v, representative=v[0]) for v in by_gid.values()])


def groups_from_lists(lists: Sequence[Sequence[Pod]]) -> List[PodGroup]:
    """PodGroups from pre-bucketed pod lists (the store's admission-time
    pending-group index) — no per-pod pass. Each inner list must be one
    signature-equal set; the lists are consumed (may be mutated)."""
    return _finalize_groups(
        [PodGroup(pods=list(ps) if not isinstance(ps, list) else ps,
                  representative=ps[0]) for ps in lists if ps])


def _finalize_groups(groups: List[PodGroup]) -> List[PodGroup]:
    if len(groups) > 1:
        # intern-rotation safety: the gid table rotates at capacity, so
        # pods admitted across a rotation can hold DIFFERENT gids for
        # equal signatures; merge such split groups by the
        # representatives' (cached) signatures so grouping stays exactly
        # signature-equality — splitting one interchangeable set would
        # silently weaken combined topology-spread/anti-affinity caps
        by_sig: Dict[tuple, PodGroup] = {}
        merged: List[PodGroup] = []
        for g in groups:
            sig = g.representative.constraint_signature()
            prev = by_sig.get(sig)
            if prev is None:
                by_sig[sig] = g
                merged.append(g)
            else:
                prev.pods.extend(g.pods)
        groups = merged
    groups.sort(key=lambda g: (-g.representative.requests.get("cpu"),
                               -g.representative.requests.get("memory"),
                               g.representative.name))
    return groups


@dataclass
class EncodedPods:
    groups: List[PodGroup]
    requests: np.ndarray      # f32 [G, R]
    counts: np.ndarray        # i32 [G]
    compat: np.ndarray        # bool [G, T]
    allow_zone: np.ndarray    # bool [G, Z]
    allow_cap: np.ndarray     # bool [G, C]
    max_per_node: np.ndarray  # i32 [G], 0 = unlimited
    spread_zone: np.ndarray   # bool [G] — zone topology-spread requested
    # symmetric bool [G, G] (None = no cross-group anti-affinity anywhere):
    # conflict[i, j] → groups i and j may not share a node (hostname
    # anti-affinity whose selector matches the other group's labels).
    # The diagonal is False — within-group exclusion is max_per_node.
    conflict: Optional[np.ndarray] = None
    # bool [G] (None = all-False): the zone spread flagged in spread_zone is
    # ScheduleAnyway — split balances over feasible zones only and never
    # produces unschedulable subgroups
    spread_soft: Optional[np.ndarray] = None
    # bool [G, T] (None = identical to compat): the type mask BEFORE
    # preferred-node-affinity narrowing. Downstream narrowing (zone-split
    # pinning, NodePool-limit caps) can invalidate a preference that looked
    # feasible at encode time; the facade falls back to this row so a soft
    # preference never blocks scheduling.
    compat_hard: Optional[np.ndarray] = None
    # bool [G, Z] / [G, C] (None = identical to allow_zone / allow_cap):
    # the offering-axis masks before preferred narrowing — zone and
    # capacity-type preferences narrow these axes the way type preferences
    # narrow compat, with the same hard-row fallback.
    zone_hard: Optional[np.ndarray] = None
    cap_hard: Optional[np.ndarray] = None
    # symmetric bool [G, G] (None = none anywhere): groups that may not
    # share a ZONE (zone-topology anti-affinity; set by
    # affinity.apply_zone_affinity, consumed by validate_solution — the
    # solvers themselves rely on the pre-pass's disjoint allow_zone masks)
    zone_conflict: Optional[np.ndarray] = None
    # pod keys the taint filter dropped (whole signature-groups whose
    # representative doesn't tolerate the NodePool taints) — the facade
    # reads this instead of re-scanning O(pods) for the difference
    dropped_keys: Optional[List[str]] = None
    # encode-cache accounting for THIS encode (groups served from /
    # inserted into the EncodeContext); zero when encoded uncached.
    # Informational only — rebuilt encodings (affinity/spread splits)
    # don't carry it forward
    cache_hits: int = 0
    cache_misses: int = 0

    @property
    def G(self) -> int:
        return len(self.groups)


class TermMatcher:
    """Columnar batch twin of models.pod.term_selects over a fixed pod
    population: namespaces and every selector-queried label key are
    interned to int id columns ONCE, and each (namespace, selector)
    evaluates as one vectorized compare-and-reduce, memoized per
    distinct term. The ONE vectorized selector implementation — both
    the conflict-matrix build and the zone-affinity occupancy matching
    route through it, and its semantics MUST stay identical to the
    scalar `term_selects` oracle (same-namespace gate + full selector
    containment; a randomized agreement test pins the pair)."""

    def __init__(self, pods: Sequence[Pod]):
        self.pods = list(pods)
        n = len(self.pods)
        self._ns_vocab: Dict[str, int] = {}
        ns = np.empty(n, np.int32)
        for j, p in enumerate(self.pods):
            ns[j] = self._ns_vocab.setdefault(p.namespace,
                                              len(self._ns_vocab))
        self._ns = ns
        self._cols: Dict[str, Tuple[np.ndarray, Dict[str, int]]] = {}
        self._memo: Dict[tuple, np.ndarray] = {}

    def _col(self, key: str) -> Tuple[np.ndarray, Dict[str, int]]:
        hit = self._cols.get(key)
        if hit is None:
            vocab: Dict[str, int] = {}
            ids = np.empty(len(self.pods), np.int32)
            for j, p in enumerate(self.pods):
                v = p.labels.get(key)
                ids[j] = -1 if v is None else vocab.setdefault(v, len(vocab))
            hit = (ids, vocab)
            self._cols[key] = hit
        return hit

    def matches(self, namespace: str,
                selector: Dict[str, str]) -> np.ndarray:
        """bool [N]: pods a term with `selector`, evaluated from a pod
        in `namespace`, selects (== term_selects per pod)."""
        key = (namespace, tuple(sorted(selector.items())))
        m = self._memo.get(key)
        if m is not None:
            return m
        ns_id = self._ns_vocab.get(namespace)
        if ns_id is None:
            m = np.zeros(len(self.pods), bool)
        else:
            m = self._ns == ns_id
            for k, v in selector.items():
                if not m.any():
                    break
                ids, vocab = self._col(k)
                vid = vocab.get(v)
                m = (m & (ids == vid)) if vid is not None \
                    else np.zeros(len(self.pods), bool)
        self._memo[key] = m
        return m


def build_conflicts(groups: List[PodGroup]) -> Optional[np.ndarray]:
    """Symmetric cross-group hostname-anti-affinity conflicts.

    k8s enforces required anti-affinity symmetrically: an incoming pod is
    rejected from a node if an existing pod's anti-affinity selector matches
    it, not only the other way around — so conflict[i, j] is set when
    EITHER group's term selects the other's labels (same namespace).
    Returns None when no group carries anti terms (the common case), which
    lets every backend skip conflict tracking entirely.

    Vectorized through TermMatcher — the O(G² × terms) Python pair walk
    was the whole re-encode cost at 2000-signature fleets."""
    G = len(groups)
    anti = [[t for t in g.representative.affinity_terms
             if t.anti and t.required and t.topology_key == L.HOSTNAME]
            for g in groups]
    if not any(anti):
        return None
    reps = [g.representative for g in groups]
    matcher = TermMatcher(reps)
    per_group: Dict[int, np.ndarray] = {}  # i -> OR of its terms' matches
    for i in range(G):
        for t in anti[i]:
            m = matcher.matches(reps[i].namespace, t.label_selector)
            prev = per_group.get(i)
            per_group[i] = m if prev is None else (prev | m)
    if not per_group:
        return None
    # both symmetry directions land as two batched ORs (idx is unique, so
    # the fancy-index read-modify-write is safe) — per-term strided
    # column writes were the scaling wall at 2000-signature fleets
    conflict = np.zeros((G, G), bool)
    idx = np.fromiter(per_group.keys(), np.intp, len(per_group))
    M = np.stack([per_group[int(i)] for i in idx])
    conflict[idx] |= M
    conflict[:, idx] |= M.T
    np.fill_diagonal(conflict, False)
    return conflict if conflict.any() else None


def _vocab_values(cat: CatalogTensors, key: str) -> np.ndarray:
    """Unicode array of a key's vocab values ordered by id, memoized on
    the CatalogTensors instance — the columnar side of the set-algebra
    lowering (one np.isin pass replaces per-value ValueSet.contains)."""
    memo = getattr(cat, "_vocab_arrays", None)
    if memo is None:
        memo = {}
        cat._vocab_arrays = memo
    arr = memo.get(key)
    if arr is None:
        vocab = cat.vocab[key]
        arr = np.empty(len(vocab), dtype=object)
        for v, i in vocab.items():
            arr[i] = v
        arr = arr.astype(str) if len(vocab) else np.empty(0, dtype="<U1")
        memo[key] = arr
    return arr


def _allowed_vector(vs: ValueSet, vocab: Dict[str, int],
                    cat: Optional[CatalogTensors] = None,
                    key: Optional[str] = None) -> np.ndarray:
    if (cat is not None and key is not None
            and vs.gt is None and vs.lt is None and not vs.dne):
        # vectorized membership over the memoized id-ordered value array;
        # bounds/DoesNotExist fall through to the exact scalar oracle
        arr = _vocab_values(cat, key)
        if not vs.values:
            base = np.zeros(len(arr), bool)
        else:
            base = np.isin(arr, tuple(vs.values))
        return ~base if vs.complement else base
    out = np.zeros(len(vocab), bool)
    for v, i in vocab.items():
        out[i] = vs.contains(v)
    return out


def _key_mask(vs: ValueSet, key: str, cat: CatalogTensors,
              template: Optional[Dict[str, str]] = None) -> np.ndarray:
    """bool [T]: which instance types satisfy one requirement key.

    template: NodePool-template node labels (spec labels + single-valued
    requirements). A key NO instance type carries resolves against the
    template — every launched node wears those labels, so a pod
    nodeSelector on one must schedule (the reference satisfies pod
    requirements from the NodeClaimTemplate the same way,
    scheduling.md:17-31). Catalog-known keys ignore the template: node
    labels never override instance properties."""
    T = cat.T
    absent_ok = _tolerates_absence(vs)
    has_bounds = vs.gt is not None or vs.lt is not None
    if has_bounds and key in cat.numeric_keys:
        col = cat.label_num[:, cat.numeric_keys.index(key)]
        mask = np.ones(T, bool)
        if vs.gt is not None:
            mask &= col > vs.gt
        if vs.lt is not None:
            mask &= col < vs.lt
        # NaN comparisons are False already; absent handled below
        if vs.values and key in cat.vocab:  # bounds + In/NotIn combination
            mask &= _categorical_mask(vs, key, cat, handle_absent=False)
        absent = np.isnan(col)
        return np.where(absent, absent_ok, mask)
    if key not in cat.vocab or not cat.vocab[key]:
        if template is not None and key in template:
            return np.full(T, vs.contains(template[key]), bool)
        # key no instance type carries: satisfied only if absence tolerated
        return np.full(T, absent_ok, bool)
    return _categorical_mask(vs, key, cat)


def _categorical_mask(vs: ValueSet, key: str, cat: CatalogTensors,
                      handle_absent: bool = True) -> np.ndarray:
    ids = cat.label_val[:, cat.label_keys.index(key)]
    allowed = _allowed_vector(vs, cat.vocab[key], cat, key)
    mask = np.where(ids >= 0, allowed[np.clip(ids, 0, None)], False)
    if handle_absent:
        mask = np.where(ids == ABSENT, _tolerates_absence(vs), mask)
    return mask


def compat_mask(reqs: Requirements, cat: CatalogTensors,
                template: Optional[Dict[str, str]] = None) -> np.ndarray:
    """bool [T]: types compatible with a Requirements conjunction
    (zone/capacity-type keys excluded — they map to the offering axes;
    template = NodePool-template node labels, see _key_mask)."""
    mask = np.ones(cat.T, bool)
    for key in reqs.keys():
        if key in L.OFFERING_LABELS:
            continue
        mask &= _key_mask(reqs.get(key), key, cat, template)
    return mask


def _axis_allow(reqs: Requirements, key: str, axis_values: Sequence[str]) -> np.ndarray:
    vs = reqs.get(key)
    if vs is None:
        return np.ones(len(axis_values), bool)
    return np.array([vs.contains(v) for v in axis_values], bool)


@dataclass
class _Row:
    """One signature's tensor row — the pure function of
    (constraint_signature, catalog view, pool context) the EncodeContext
    persists. `differs_*` record whether preferred-affinity narrowing
    changed each axis (they reproduce the batch-level
    `(hard != work).any()` hard-rows-or-None decision on gather)."""
    compat: np.ndarray
    zone: np.ndarray
    capm: np.ndarray
    hard_t: np.ndarray
    hard_z: np.ndarray
    hard_c: np.ndarray
    req: np.ndarray
    max_per_node: int
    spread_zone: bool
    spread_soft: bool
    differs_t: bool
    differs_z: bool
    differs_c: bool


def _group_row(rep: Pod, cat: CatalogTensors,
               extra_requirements: Optional[Requirements],
               template_labels: Optional[Dict[str, str]],
               exotic: Optional[np.ndarray],
               raw_vec, R: int) -> _Row:
    reqs = rep.scheduling_requirements()
    if extra_requirements is not None:
        reqs = reqs.union_with(extra_requirements)
    compat = compat_mask(reqs, cat, template_labels)
    if exotic is not None and not wants_exotic(rep, reqs):
        compat &= ~exotic
    zone = _axis_allow(reqs, L.ZONE, cat.zones)
    capm = _axis_allow(reqs, L.CAPACITY_TYPE, cat.captypes)
    req = np.zeros(R, np.float32)
    req[: len(raw_vec)] = raw_vec
    hard_t, hard_z, hard_c = compat, zone, capm  # pre-preference rows
    narrowed = _apply_preferred(rep, compat, zone, capm, req, cat,
                                template_labels)
    if narrowed is not None:
        compat, zone, capm = narrowed  # fresh arrays; hard_* keep originals
    max_per_node = 1 if rep.has_self_anti_affinity() else 0
    spread_zone = False
    any_hard_zone = False
    for tsc in rep.topology_spread:
        if tsc.topology_key == L.ZONE:
            spread_zone = True
            if tsc.when_unsatisfiable == "DoNotSchedule":
                any_hard_zone = True
        if tsc.topology_key == L.HOSTNAME and tsc.when_unsatisfiable == "DoNotSchedule":
            # Conservative encoding of hostname maxSkew as a per-node
            # cap: while any eligible node has zero matching pods (always
            # true the moment the provisioner opens a fresh node), skew =
            # max-count − 0, so count per node may not exceed maxSkew.
            # This can over-spread relative to a cluster with no empty
            # eligible nodes (where k8s would allow denser layouts) but
            # never violates the constraint.
            cap = max(1, tsc.max_skew)
            max_per_node = cap if max_per_node == 0 else min(max_per_node, cap)
    return _Row(
        compat=compat, zone=zone, capm=capm,
        hard_t=hard_t, hard_z=hard_z, hard_c=hard_c, req=req,
        max_per_node=max_per_node, spread_zone=spread_zone,
        spread_soft=spread_zone and not any_hard_zone,
        differs_t=compat is not hard_t and bool((compat != hard_t).any()),
        differs_z=zone is not hard_z and bool((zone != hard_z).any()),
        differs_c=capm is not hard_c and bool((capm != hard_c).any()))


def encode_pods(pods: Sequence[Pod], cat: CatalogTensors,
                extra_requirements: Optional[Requirements] = None,
                taints: Optional[List[Taint]] = None,
                pregrouped: Optional[Sequence[Sequence[Pod]]] = None,
                template_labels: Optional[Dict[str, str]] = None,
                cache=None, arena=None,
                ) -> EncodedPods:
    """Group + tensorize pods against a catalog.

    extra_requirements: the NodePool template requirements, conjoined into
    every group (the reference scheduler layers NodePool requirements onto
    pod requirements the same way, scheduling.md:17-31). Pods that don't
    tolerate `taints` are dropped from the encoding per GROUP — tolerations
    are part of the constraint signature, so the representative's verdict
    is every member's verdict (caller routes dropped pods to another
    NodePool via EncodedPods.dropped_keys).

    pregrouped: optional pre-bucketed signature-equal pod lists (the
    store's admission-time pending-group index) — skips the per-pod
    grouping pass entirely; `pods` is then ignored for grouping.

    cache: an ops.encode_cache.EncodeContext for this exact
    (catalog view, extra_requirements, taints, template) combination —
    per-signature rows persist across solves and a warm re-encode
    becomes one gather. The caller owns the keying contract (the facade
    derives it from CatalogTensors.cache_token); rows returned are
    never aliased into the cache, so downstream in-place narrowing
    stays private to this encode.

    arena: an ops.encode_cache.EncodeArena supplying reusable staging
    buffers. Arrays in the returned EncodedPods are then valid only
    until the next encode that leases the same arena.
    """
    groups = (groups_from_lists(pregrouped) if pregrouped is not None
              else group_pods(pods))
    lease = arena is not None and arena.acquire()
    try:
        return _encode_groups(groups, cat, extra_requirements, taints,
                              template_labels, cache,
                              arena if lease else None)
    finally:
        if lease:
            arena.release()


def _take(arena, name, shape, dtype, zero=False):
    if arena is not None:
        return arena.take(name, shape, dtype, zero=zero)
    return np.zeros(shape, dtype) if zero else np.empty(shape, dtype)


def _encode_groups(groups: List[PodGroup], cat: CatalogTensors,
                   extra_requirements, taints, template_labels,
                   cache, arena) -> EncodedPods:
    from .encode_cache import DROPPED
    dropped_keys: List[str] = []
    hits = misses = 0

    if cache is not None:
        # --- cached path: lookup per signature, compute only the misses,
        # then ONE vectorized gather over the context's columnar rows ---
        cache.begin()  # batch boundary: a full row store rotates here
        kept: List[PodGroup] = []
        row_ids: List[Optional[int]] = []
        pend: List[Tuple[int, PodGroup, tuple]] = []  # (kept-slot, g, sig)
        miss_sigs: List[tuple] = []
        for g in groups:
            sig = g.representative.constraint_signature()
            rid = cache.lookup(sig)
            if rid is None:
                misses += 1
                miss_sigs.append(sig)
                if taints and not tolerates_all(
                        g.representative.tolerations, taints):
                    cache.insert_dropped(sig)
                    dropped_keys.extend(f"{p.namespace}/{p.name}"
                                        for p in g.pods)
                    continue
                pend.append((len(kept), g, sig))
                kept.append(g)
                row_ids.append(None)
            elif rid == DROPPED:
                hits += 1
                dropped_keys.extend(f"{p.namespace}/{p.name}"
                                    for p in g.pods)
            else:
                hits += 1
                kept.append(g)
                row_ids.append(rid)
        # settle the resource axis BEFORE computing rows: to_vector may
        # auto-register custom resources (cached reps registered theirs
        # at first encode — the axis only grows within a process)
        pend_vecs = [g.representative.requests.to_vector()
                     for _, g, _ in pend]
        R = num_resources()
        if pend:
            exotic = exotic_mask(cat)
            exotic = exotic if exotic.any() else None
            for (slot, g, sig), vec in zip(pend, pend_vecs):
                row = _group_row(g.representative, cat, extra_requirements,
                                 template_labels, exotic, vec, R)
                row_ids[slot] = cache.insert(sig, row)
        cache.stats["hits"] += hits
        cache.stats["misses"] += misses
        groups = kept
        G = len(groups)
        if G == 0:
            enc = EncodedPods(
                groups=[], requests=np.zeros((0, R), np.float32),
                counts=np.zeros(0, np.int32),
                compat=np.zeros((0, cat.T), bool),
                allow_zone=np.zeros((0, cat.Z), bool),
                allow_cap=np.zeros((0, cat.C), bool),
                max_per_node=np.zeros(0, np.int32),
                spread_zone=np.zeros(0, bool),
                spread_soft=np.zeros(0, bool),
                dropped_keys=dropped_keys or None)
        else:
            got = cache.gather(row_ids, R, arena)
            counts = np.fromiter((g.count for g in groups), np.int32, G)
            gs = groups  # bind for the memo-miss builder
            conflict = cache.conflicts(tuple(row_ids),
                                       lambda: build_conflicts(gs))
            enc = EncodedPods(groups=groups, counts=counts,
                              conflict=conflict,
                              dropped_keys=dropped_keys or None, **got)
        enc.cache_hits, enc.cache_misses = hits, misses
        _meter_cache(hits, misses)
        _meter_recompute_cached(hits, miss_sigs)
        return enc

    # --- cold path: every row computed fresh (identical bytes to the
    # cached path by construction — both run _group_row) ---
    if taints:
        filtered = []
        for g in groups:
            if tolerates_all(g.representative.tolerations, taints):
                filtered.append(g)
            else:
                dropped_keys.extend(f"{p.namespace}/{p.name}"
                                    for p in g.pods)
        groups = filtered

    req_vecs = [g.representative.requests.to_vector() for g in groups]
    R = num_resources()
    G = len(groups)
    requests = _take(arena, "requests", (G, R), np.float32, zero=True)
    counts = (np.fromiter((g.count for g in groups), np.int32, G)
              if G else np.zeros(0, np.int32))
    compat = _take(arena, "compat", (G, cat.T), bool)
    allow_zone = _take(arena, "zone", (G, cat.Z), bool)
    allow_cap = _take(arena, "capm", (G, cat.C), bool)
    max_per_node = np.zeros(G, np.int32)
    spread_zone = np.zeros(G, bool)
    spread_soft = np.zeros(G, bool)
    hard = _take(arena, "hard_t", (G, cat.T), bool)
    hard_z = _take(arena, "hard_z", (G, cat.Z), bool)
    hard_c = _take(arena, "hard_c", (G, cat.C), bool)
    any_dt = any_dz = any_dc = False

    exotic = exotic_mask(cat)
    exotic = exotic if exotic.any() else None
    for i, g in enumerate(groups):
        row = _group_row(g.representative, cat, extra_requirements,
                         template_labels, exotic, req_vecs[i], R)
        requests[i] = row.req
        compat[i] = row.compat
        allow_zone[i] = row.zone
        allow_cap[i] = row.capm
        hard[i] = row.hard_t
        hard_z[i] = row.hard_z
        hard_c[i] = row.hard_c
        max_per_node[i] = row.max_per_node
        spread_zone[i] = row.spread_zone
        spread_soft[i] = row.spread_soft
        any_dt |= row.differs_t
        any_dz |= row.differs_z
        any_dc |= row.differs_c

    from ..obs.tracer import TRACER
    with TRACER.span("encode.conflicts", groups=G):
        conflict = build_conflicts(groups)
    _meter_recompute_cold(requests, compat, allow_zone, allow_cap)
    return EncodedPods(groups=groups, requests=requests, counts=counts,
                       compat=compat, allow_zone=allow_zone, allow_cap=allow_cap,
                       max_per_node=max_per_node, spread_zone=spread_zone,
                       conflict=conflict, spread_soft=spread_soft,
                       compat_hard=hard if any_dt else None,
                       zone_hard=hard_z if any_dz else None,
                       cap_hard=hard_c if any_dc else None,
                       dropped_keys=dropped_keys or None)


def _meter_cache(hits: int, misses: int) -> None:
    from ..metrics import ENCODE_CACHE
    if hits:
        ENCODE_CACHE.inc(hits, event="hit")
    if misses:
        ENCODE_CACHE.inc(misses, event="miss")


def _meter_recompute_cached(hits: int, miss_sigs) -> None:
    """Work provenance of the cached encode path: hits are encodes an
    existing cache row served (delta_served); each miss is classified by
    its constraint signature — a signature re-lowered after eviction or
    a `begin()` rotation shows up as redundant encode work."""
    from ..obs.recompute import RECOMPUTE, fingerprint
    if hits:
        RECOMPUTE.classify("encode", served=True, units=hits)
    for sig in miss_sigs:
        RECOMPUTE.classify("encode", fingerprint(sig))


def _meter_recompute_cold(requests, compat, allow_zone, allow_cap) -> None:
    """Work provenance of the cold encode path: one vectorized combined
    row digest per group (NOT per-group constraint_signature calls — the
    cold path's cost profile must not change), plus one conflict-build
    classification over the folded row set."""
    from ..obs.recompute import (RECOMPUTE, fingerprint_fold,
                                 fingerprint_rows)
    if len(requests) == 0:
        return
    fps = fingerprint_rows(requests, compat, allow_zone, allow_cap)
    RECOMPUTE.classify_rows("encode", fps)
    RECOMPUTE.classify("conflict", fingerprint_fold(fps))


def _apply_preferred(rep: Pod, compat_row: np.ndarray, zone_row: np.ndarray,
                     cap_row: np.ndarray, req: np.ndarray,
                     cat: CatalogTensors,
                     template: Optional[Dict[str, str]] = None,
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Narrow a group's (type, zone, captype) masks to its preferred
    node-affinity terms, greedily in descending weight, keeping each
    narrowing only while ≥1 available offering that FITS the pod survives —
    'prefer, never block'. (k8s scores preferences per node; against a
    catalog the analogue is restricting the candidate axes when the
    restriction is satisfiable.) Zone-key preferences are skipped for pods
    carrying a zone topology-spread constraint: spread domains come from
    hard filters only (k8s likewise computes eligible domains before
    scoring). Returns (compat, zone, cap) rows, or None if no preference
    applied."""
    if not rep.preferred_node_affinity:
        return None
    fits = (align_resources(cat.allocatable, len(req))
            >= req[None, :] - 1e-6).all(axis=1)
    cur_t, cur_z, cur_c = compat_row, zone_row, cap_row
    has_zone_spread = any(t.topology_key == L.ZONE
                          for t in rep.topology_spread)
    terms = sorted(rep.preferred_node_affinity,
                   key=lambda t: -t.get("weight", 1))
    changed = False
    for term in terms:
        r = Requirements()
        r.add(Requirement(term["key"], Operator(term["operator"]),
                          tuple(term.get("values", ()))))
        cand_t, cand_z, cand_c = cur_t, cur_z, cur_c
        if term["key"] == L.ZONE:
            if has_zone_spread:
                continue
            cand_z = cur_z & _axis_allow(r, L.ZONE, cat.zones)
        elif term["key"] == L.CAPACITY_TYPE:
            cand_c = cur_c & _axis_allow(r, L.CAPACITY_TYPE, cat.captypes)
        else:
            cand_t = cur_t & compat_mask(r, cat, template)
        feasible = (cat.available & (cand_t & fits)[:, None, None]
                    & cand_z[None, :, None] & cand_c[None, None, :]).any()
        if feasible:
            cur_t, cur_z, cur_c = cand_t, cand_z, cand_c
            changed = True
    return (cur_t, cur_z, cur_c) if changed else None


def feasible_zones(enc: EncodedPods, cat: CatalogTensors, i: int,
                   zone_mask: np.ndarray) -> np.ndarray:
    """bool [Z]: zones in zone_mask where group i has ≥1 available,
    compatible, FITTING offering — judged on the HARD type/captype masks,
    so a soft node-affinity preference can neither steer a spread split
    nor fail a required zone-affinity pin (the facade relaxes infeasible
    preferences afterwards)."""
    alloc = align_resources(cat.allocatable, enc.requests.shape[1])
    fits = (alloc >= enc.requests[i][None, :] - 1e-6).all(axis=1)
    comp = enc.compat[i] if enc.compat_hard is None else enc.compat_hard[i]
    cap = enc.allow_cap[i] if enc.cap_hard is None else enc.cap_hard[i]
    ok_t = comp & fits
    per_zone = (cat.available & ok_t[:, None, None]
                & cap[None, None, :]).any(axis=(0, 2))
    return per_zone & zone_mask


def align_zone_overhead(cat: CatalogTensors, R: int) -> "Optional[np.ndarray]":
    """cat.zone_overhead ([T, Z, R_cat]) zero-padded to R resource columns,
    or None when absent — the shared accessor every backend uses."""
    z = cat.zone_overhead
    if z is None:
        return None
    if z.shape[2] >= R:
        return z
    return np.pad(z, ((0, 0), (0, 0), (0, R - z.shape[2])))


def align_resources(alloc: np.ndarray, R: int) -> np.ndarray:
    """Zero-pad the catalog's [T, R_cat] allocatable to R columns.

    The resource axis can grow between catalog encoding (cached on device)
    and pod encoding (auto-registers custom resources). Zero capacity for the
    new columns is the correct semantics: a type whose catalog entry predates
    the resource offers none of it, so pods requesting it can't fit there.
    """
    if alloc.shape[1] >= R:
        return alloc
    pad = np.zeros((alloc.shape[0], R - alloc.shape[1]), alloc.dtype)
    return np.concatenate([alloc, pad], axis=1)
