"""Host bin-packing oracle — the correctness reference for the solve kernel.

The port's own copy of `karpenter_tpu/ops/binpack.py`, unchanged in
semantics: the same f32 expressions and argmin tie-breaks, so the port's
device solve must agree with it node for node.

Semantics (the `Solve()` policy both backends implement; reference behavior:
designs/bin-packing.md:18-42 — sort pods by size desc, first-fit into
in-flight nodes, else open a new virtual node; launch picks the cheapest
offering):

 1. Pods are exact-dedupe grouped and FFD-ordered (encode.group_pods).
 2. Each pod first-fits into open nodes in creation order. A node accepts a
    pod iff the node's committed instance type is compatible with the pod's
    requirements, remaining allocatable covers the request, the node's
    deferred (zone, capacity-type) masks still intersect the pod's, at least
    one available offering survives the intersection, and the group's
    per-node cap (anti-affinity / hostname spread) is not exceeded.
 3. If no node fits, a new node opens committed to the instance type
    minimizing price-per-pod-slot over all available (type, zone, captype)
    offerings compatible with the pod — the cost-argmin. Zone and capacity
    type remain deferred rectangular masks; the launch step later picks the
    cheapest surviving offering (reserved offerings are priced ~0 by the
    catalog, so price-argmin reproduces the reference's reserved→spot→od
    preference, instance.go:530-546).
 4. Zone topology-spread groups are pre-split into zone-pinned subgroups by
    `split_spread_groups` before either backend runs.

Design note (TPU-first): committing the node's type at open (instead of the
reference's deferred multi-type nodes) keeps the device state rectangular —
type id + cum requests + zone/captype masks — which is what makes the group
scan a fixed-shape `lax.scan` with O(N·T) work per step and no ragged
structures. The cost is occasionally one extra node vs deferred-type FFD;
the benchmark grid tracks node-count parity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .encode import (CatalogTensors, EncodedPods, align_resources,
                     align_zone_overhead, build_conflicts, feasible_zones)

BIG = 10**9


@dataclass
class VirtualNode:
    type_idx: int
    zone_mask: np.ndarray      # bool [Z] — deferred zone choice
    cap_mask: np.ndarray       # bool [C]
    cum: np.ndarray            # f32 [R]
    # placements from THIS solve, keyed by the current enc's group indices
    pods_by_group: Dict[int, int] = field(default_factory=dict)
    existing_name: Optional[str] = None  # set for in-flight/live nodes
    # prior occupancy of an existing node, keyed by the CURRENT enc's group
    # indices (facade maps prior pods by constraint signature). Consumed by
    # the per-node caps (anti-affinity / hostname spread) so a node that
    # already hosts a matching pod can't take another across reconciles;
    # resources are accounted separately via cum.
    prior_by_group: Dict[int, int] = field(default_factory=dict)
    # bool [G] over the CURRENT enc's groups: groups this node may not take
    # because a resident pod's (or the group's own) required anti-affinity
    # forbids co-location. Facade-computed from the node's actual resident
    # pods — covers residents that map to NO current group (their labels
    # still repel incoming pods). None = nothing banned.
    banned_groups: Optional[np.ndarray] = None

    def pod_count(self) -> int:
        return sum(self.pods_by_group.values())


@dataclass
class SolveResult:
    nodes: List[VirtualNode]
    unschedulable: Dict[int, int]  # group idx -> count
    # resolved launch decisions (filled by finalize_offerings)
    launches: List[Tuple[int, int, int, float]] = field(default_factory=list)
    # (type_idx, zone_idx, cap_idx, price) per *new* node

    def new_nodes(self) -> List[VirtualNode]:
        return [n for n in self.nodes if n.existing_name is None]


def _water_fill(offsets: np.ndarray, total: int) -> np.ndarray:
    """Distribute `total` new pods over zones with existing per-zone counts
    `offsets` so every increment lands on a currently-least-occupied zone
    (the k8s topology-spread admission rule: placing on a min-count domain
    always keeps skew ≤ maxSkew). Returns per-zone additional counts.

    Closed form instead of a pod-by-pod loop: find the highest water level L
    with sum(max(0, L - offsets)) ≤ total, fill to L, then hand the
    remainder one-per-zone to zones sitting exactly at L (ascending index —
    deterministic)."""
    off = np.asarray(offsets, np.int64)
    k = len(off)
    if k == 0 or total <= 0:
        return np.zeros(k, np.int64)
    lo, hi = int(off.min()), int(off.min()) + total
    while lo < hi:  # binary search on the level
        mid = (lo + hi + 1) // 2
        if int(np.maximum(0, mid - off).sum()) <= total:
            lo = mid
        else:
            hi = mid - 1
    add = np.maximum(0, lo - off)
    rem = total - int(add.sum())
    at_level = np.flatnonzero(off + add == lo)
    add[at_level[:rem]] += 1
    return add


@dataclass
class SpreadConstraintCounts:
    """One zone-spread constraint of a group, with prior domain occupancy.

    counts: i64 [Z] — matching pods already in each zone (cluster-wide,
    computed by the facade from live + in-flight nodes).
    self_matches: whether the group's own pods match the constraint's
    selector — if so, each placement increments the domain count; if not,
    placements are checked against the (static) counts but don't move them
    (k8s computes skew over *matching* pods only).
    """

    counts: np.ndarray
    max_skew: int = 1
    self_matches: bool = True
    # ScheduleAnyway: never gates admission, only steers the zone choice
    soft: bool = False


def _assign_spread(zones: np.ndarray, total: int,
                   constraints: List[SpreadConstraintCounts],
                   ) -> Tuple[np.ndarray, int]:
    """Per-zone additional counts honoring every hard constraint; returns
    (adds [len(zones)], n_unassignable).

    Single self-matching constraint → closed-form water-fill (placing on a
    current-min domain always keeps skew ≤ maxSkew). Multiple constraints →
    per-pod greedy: a zone is admissible iff every HARD constraint passes
    the k8s rule (count_z + Δ − min ≤ maxSkew); among admissible zones the
    choice minimizes (soft-constraint violations, max domain count, index)
    so ScheduleAnyway constraints steer but never block — an element-wise
    merge of the count vectors cannot express either property."""
    if len(constraints) == 1 and constraints[0].self_matches:
        return _water_fill(constraints[0].counts[zones],
                           int(total)), 0
    cnt = [c.counts[zones].astype(np.int64).copy() for c in constraints]
    adds = np.zeros(len(zones), np.int64)
    for _ in range(int(total)):
        best, best_key = -1, None
        for j in range(len(zones)):
            ok = True
            soft_viol = 0
            for c, cc in zip(constraints, cnt):
                delta = 1 if c.self_matches else 0
                if cc[j] + delta - int(cc.min()) > c.max_skew:
                    if c.soft:
                        soft_viol += 1
                    else:
                        ok = False
                        break
            if not ok:
                continue
            key = (soft_viol,
                   max(int(cc[j]) for cc in cnt) if cnt else 0, j)
            if best_key is None or key < best_key:
                best, best_key = j, key
        if best < 0:
            return adds, int(total) - int(adds.sum())
        adds[best] += 1
        for c, cc in zip(constraints, cnt):
            if c.self_matches:
                cc[best] += 1
    return adds, 0


def split_spread_groups(enc: EncodedPods, cat: CatalogTensors,
                        spread_counts: Optional[
                            Dict[int, List[SpreadConstraintCounts]]] = None,
                        ) -> EncodedPods:
    """Expand zone-topology-spread groups into per-zone pinned subgroups with
    balanced counts (skew ≤ 1 ≤ maxSkew). Host-side transformation so the
    kernels never see spread constraints — only zone-pinned groups.

    spread_counts: optional per-group list of SpreadConstraintCounts
    (computed by the facade from cluster state). Balancing water-fills
    against these prior domain counts, so a cluster with 10 replicas in
    zone-a sends new replicas to the other zones first — the reference core
    scheduler seeds its topology domain counts from live nodes the same way
    (scheduling.md topology section). Pods no admissible zone can take are
    emitted as a zone-less subgroup (all-False allow_zone), which both
    solver backends report unschedulable.
    """
    idx_keep = [i for i in range(enc.G) if not enc.spread_zone[i]]
    if len(idx_keep) == enc.G:
        return enc
    rows = {"requests": [], "counts": [], "compat": [], "allow_zone": [],
            "allow_cap": [], "max_per_node": [], "spread_zone": [],
            "compat_hard": [], "zone_hard": [], "cap_hard": []}
    groups = []
    orig: List[int] = []  # original group index per output row

    def push(i, count, zone_row, pinned=False):
        groups.append(enc.groups[i])
        orig.append(i)
        rows["requests"].append(enc.requests[i])
        rows["counts"].append(count)
        rows["compat"].append(enc.compat[i])
        rows["allow_zone"].append(zone_row)
        rows["allow_cap"].append(enc.allow_cap[i])
        rows["max_per_node"].append(enc.max_per_node[i])
        rows["spread_zone"].append(False)
        rows["compat_hard"].append(
            enc.compat[i] if enc.compat_hard is None else enc.compat_hard[i])
        # a zone-pinned subgroup's pin IS hard (relaxing a soft zone
        # preference must not widen it); unpinned rows keep their hard row
        rows["zone_hard"].append(
            zone_row if pinned or enc.zone_hard is None else enc.zone_hard[i])
        rows["cap_hard"].append(
            enc.allow_cap[i] if enc.cap_hard is None else enc.cap_hard[i])

    for i in range(enc.G):
        if not enc.spread_zone[i]:
            push(i, int(enc.counts[i]), enc.allow_zone[i])
            continue
        zones = np.flatnonzero(enc.allow_zone[i])
        soft = enc.spread_soft is not None and bool(enc.spread_soft[i])
        if soft:
            # ScheduleAnyway: pin only to zones where the group actually
            # has an available, compatible, FITTING offering — an
            # infeasible zone must fall back to the others, never to
            # unschedulable. Judged on the HARD type/captype masks: a soft
            # preference must not steer (or collapse) the split.
            feas = feasible_zones(enc, cat, i, enc.allow_zone[i])
            zones = zones[feas[zones]]
        if len(zones) == 0:
            push(i, int(enc.counts[i]), enc.allow_zone[i])
            continue
        total = int(enc.counts[i])
        cons = (spread_counts or {}).get(i) or [
            SpreadConstraintCounts(counts=np.zeros(cat.Z, np.int64))]
        adds, n_unassignable = _assign_spread(zones, total, cons)
        if n_unassignable and soft:
            # preference exhausted: remaining pods go wherever fits
            push(i, n_unassignable, enc.allow_zone[i])
            n_unassignable = 0
        for j, z in enumerate(zones):
            cnt = int(adds[j])
            if cnt == 0:
                continue
            row = np.zeros(cat.Z, bool)
            row[z] = True
            push(i, cnt, row, pinned=True)
        if n_unassignable:
            push(i, n_unassignable, np.zeros(cat.Z, bool), pinned=True)

    n = len(groups)
    zone_conflict = None
    if enc.zone_conflict is not None:
        o = np.asarray(orig)
        zone_conflict = enc.zone_conflict[np.ix_(o, o)].copy()
        np.fill_diagonal(zone_conflict, False)
    return EncodedPods(groups=groups,
              requests=np.array(rows["requests"], np.float32).reshape(n, -1),
              counts=np.array(rows["counts"], np.int32),
              compat=np.array(rows["compat"], bool).reshape(n, -1),
              allow_zone=np.array(rows["allow_zone"], bool).reshape(n, -1),
              allow_cap=np.array(rows["allow_cap"], bool).reshape(n, -1),
              max_per_node=np.array(rows["max_per_node"], np.int32),
              spread_zone=np.array(rows["spread_zone"], bool),
              conflict=build_conflicts(groups),
              compat_hard=(
                  np.array(rows["compat_hard"], bool).reshape(n, -1)
                  if enc.compat_hard is not None else None),
              zone_hard=(
                  np.array(rows["zone_hard"], bool).reshape(n, -1)
                  if enc.zone_hard is not None else None),
              cap_hard=(
                  np.array(rows["cap_hard"], bool).reshape(n, -1)
                  if enc.cap_hard is not None else None),
              zone_conflict=zone_conflict)


EPS = np.float32(1e-4)  # f32 division slack; shared with the device kernel


def _fit_count(alloc_t: np.ndarray, cum: np.ndarray, req: np.ndarray) -> int:
    """Additional pods of `req` fitting in `alloc_t - cum` (f32 math, same
    expression as the kernel's k_cap so the two backends agree bitwise)."""
    with_req = np.where(req > 0, req, np.float32(1.0))
    k = np.where(req > 0,
                 np.floor((alloc_t - cum) / with_req + EPS),
                 np.float32(BIG)).min()
    return int(max(k, 0.0))


def clone_nodes(existing: Optional[List[VirtualNode]],
                R: int) -> List[VirtualNode]:
    """Solve-input copies of existing nodes: pods_by_group starts empty
    (result nodes report only THIS solve's placements); prior occupancy
    enters via cum and prior_by_group. Shared by solve_host and the
    warm-path admitter so the two build bit-identical node state."""
    for n in (existing or []):
        assert len(n.cum) <= R, (
            f"existing node cum has {len(n.cum)} resources but the current "
            f"axis is {R} — the resource axis only grows within a process")
    return [
        VirtualNode(type_idx=n.type_idx, zone_mask=n.zone_mask.copy(),
                    cap_mask=n.cap_mask.copy(),
                    cum=np.pad(n.cum, (0, max(0, R - len(n.cum)))).astype(np.float32),
                    pods_by_group={},
                    prior_by_group=dict(n.prior_by_group),
                    banned_groups=n.banned_groups,
                    existing_name=n.existing_name)
        for n in (existing or [])]


def first_fit_group(nodes: List[VirtualNode], g: int, enc: EncodedPods,
                    cat: CatalogTensors, alloc: np.ndarray,
                    zovh: Optional[np.ndarray], rem: int) -> int:
    """Fill open `nodes` in index order with group g's pods (step 1 of the
    solve policy — first-fit into existing/open nodes). Mutates the nodes
    it places on; returns the count it could NOT place. This is the ONE
    implementation of existing-node filling: solve_host runs it before
    opening new nodes, and the warm-path admitter runs it alone (its
    remainder escalates to the full solver instead of opening nodes), so
    warm and cold placement onto standing capacity cannot diverge."""
    avail = cat.available
    conflict = enc.conflict
    req = enc.requests[g].astype(np.float32)
    cap_per_node = int(enc.max_per_node[g]) or BIG
    for n in nodes:
        if rem == 0:
            break
        t = n.type_idx
        if not enc.compat[g, t]:
            continue
        if n.banned_groups is not None and n.banned_groups[g]:
            continue
        if conflict is not None and any(
                conflict[g, h] for h in n.pods_by_group):
            continue
        zmask = n.zone_mask & enc.allow_zone[g]
        cmask = n.cap_mask & enc.allow_cap[g]
        if not (avail[t] & zmask[:, None] & cmask[None, :]).any():
            continue
        alloc_t = alloc[t]
        if zovh is not None:
            # post-take zone mask (zmask): taking the pod commits the
            # node to it, so the reservation maxes over exactly those
            alloc_t = alloc_t - zovh[t][zmask].max(axis=0)
        take = min(_fit_count(alloc_t, n.cum, req),
                   cap_per_node - n.prior_by_group.get(g, 0)
                   - n.pods_by_group.get(g, 0), rem)
        if take < 1:
            continue
        n.cum = n.cum + np.float32(take) * req
        n.zone_mask = zmask
        n.cap_mask = cmask
        n.pods_by_group[g] = n.pods_by_group.get(g, 0) + take
        rem -= take
    return rem


def solve_host(cat: CatalogTensors, enc: EncodedPods,
               existing: Optional[List[VirtualNode]] = None) -> SolveResult:
    """Group-level first-fit-decreasing with the policy above — equivalent
    to per-pod FFD since pods within a group are interchangeable. Sequential
    and deliberately simple: this is the oracle the TPU kernel must agree
    with exactly (same f32 expressions, same argmin tie-breaks).

    `enc` must already be spread-free (callers run split_spread_groups
    first, so result group indices match the enc they hold). Existing nodes
    are copied, not mutated.
    """
    assert not enc.spread_zone.any(), "run split_spread_groups before solve"
    R = enc.requests.shape[1]
    alloc = align_resources(cat.allocatable, R)
    avail = cat.available  # [T, Z, C]
    price = cat.price
    # zone-varying daemonset reservation: a node charges the elementwise
    # max over its remaining zone mask (narrowing zones restores headroom)
    zovh = align_zone_overhead(cat, R)

    nodes: List[VirtualNode] = clone_nodes(existing, R)
    unschedulable: Dict[int, int] = {}

    for g in range(enc.G):
        req = enc.requests[g].astype(np.float32)
        cap_per_node = int(enc.max_per_node[g]) or BIG
        # 1. fill open nodes in index order (first-fit)
        rem = first_fit_group(nodes, g, enc, cat, alloc, zovh,
                              int(enc.counts[g]))
        if rem == 0:
            continue
        # 2. open new nodes at the cost-per-slot argmin offering, identical
        #    f32 arithmetic + flat-argmin tie-break as the kernel
        adm = (avail & enc.compat[g][:, None, None]
               & enc.allow_zone[g][None, :, None]
               & enc.allow_cap[g][None, None, :])
        with_req = np.where(req > 0, req, np.float32(1.0))
        alloc_eff = alloc
        if zovh is not None:
            # a new node's zone mask becomes gzone & type-available zones;
            # reserve the max over exactly those (same as the kernel)
            zm_open = enc.allow_zone[g][None, :] & avail.any(axis=2)  # [T, Z]
            alloc_eff = alloc - np.where(zm_open[:, :, None], zovh,
                                         np.float32(0.0)).max(axis=1)
        slots_t = np.where(req[None, :] > 0,
                           np.floor(alloc_eff / with_req[None, :] + EPS),
                           np.float32(BIG)).min(axis=1)
        slots_t = np.minimum(np.maximum(slots_t, 0.0).astype(np.int64), cap_per_node)
        feasible = adm & (slots_t[:, None, None] >= 1)
        cps = np.where(feasible,
                       price / np.maximum(slots_t, 1)[:, None, None].astype(np.float32),
                       np.float32(np.finfo(np.float32).max))
        flat = int(np.argmin(cps.reshape(-1)))
        if cps.reshape(-1)[flat] >= np.finfo(np.float32).max:
            unschedulable[g] = unschedulable.get(g, 0) + rem
            continue
        t_star = flat // (cat.Z * cat.C)
        s = max(int(slots_t[t_star]), 1)
        zmask_new = enc.allow_zone[g] & avail[t_star].any(axis=1)
        cmask_new = enc.allow_cap[g] & avail[t_star].any(axis=0)
        while rem > 0:
            take = min(s, rem)
            nodes.append(VirtualNode(
                type_idx=t_star, zone_mask=zmask_new.copy(),
                cap_mask=cmask_new.copy(),
                cum=np.float32(take) * req,
                pods_by_group={g: take}))
            rem -= take

    result = SolveResult(nodes=nodes, unschedulable=unschedulable)
    finalize_offerings(result, cat)
    return result


def cheapest_offerings(t: np.ndarray, zm: np.ndarray, cm: np.ndarray,
                       cat: CatalogTensors) -> List[Tuple[int, int, int, float]]:
    """The launch decision, array-level: cheapest available (zone, captype)
    per node given type ids [M], zone masks [M, Z], cap masks [M, C]
    (reference launch path picks cheapest via CreateFleet's lowest-price
    strategy over the override list). The ONE implementation both the host
    oracle (finalize_offerings) and solve_device's decode use, so a
    tie-break or pricing change can't diverge the two paths."""
    masked = np.where(zm[:, :, None] & cm[:, None, :] & cat.available[t],
                      cat.price[t], np.inf)            # [M, Z, C]
    flat = masked.reshape(t.shape[0], -1)
    k = np.argmin(flat, axis=1)
    prices = flat[np.arange(t.shape[0]), k]
    return [(int(ti), int(ki // cat.C), int(ki % cat.C), float(p))
            for ti, ki, p in zip(t.tolist(), k.tolist(), prices.tolist())]


def finalize_offerings(result: SolveResult, cat: CatalogTensors) -> None:
    """Pick the cheapest surviving (zone, captype) for each new node.
    Vectorized over all new nodes: this runs on every solve and a per-node
    Python loop costs more than the TPU kernel at 100k-pod scale."""
    new = result.new_nodes()
    result.launches = []
    if not new:
        return
    t = np.array([n.type_idx for n in new])
    zm = np.stack([n.zone_mask for n in new])          # [M, Z]
    cm = np.stack([n.cap_mask for n in new])           # [M, C]
    result.launches = cheapest_offerings(t, zm, cm, cat)


def validate_solution(cat: CatalogTensors, enc: EncodedPods,
                      result: SolveResult) -> List[str]:
    """Independent feasibility audit of a solve result (used by tests and
    the race-free double-check in the provisioner): every placement must be
    compatible, within capacity, and launchable on an available offering."""
    errors = []
    R = enc.requests.shape[1]
    alloc = align_resources(cat.allocatable, R)
    zovh = align_zone_overhead(cat, R)
    placed_per_group: Dict[int, int] = {}
    for idx, n in enumerate(result.nodes):
        t = n.type_idx
        gs = [g for g, c in n.pods_by_group.items() if c > 0]
        if n.banned_groups is not None:
            for g in gs:
                if n.banned_groups[g]:
                    errors.append(f"node {idx}: banned group {g} placed")
        if enc.conflict is not None:
            for a in range(len(gs)):
                for b in range(a + 1, len(gs)):
                    if enc.conflict[gs[a], gs[b]]:
                        errors.append(
                            f"node {idx}: conflicting groups {gs[a]},{gs[b]} colocated")
        for g, cnt in n.pods_by_group.items():
            placed_per_group[g] = placed_per_group.get(g, 0) + cnt
            if not enc.compat[g, t]:
                errors.append(f"node {idx}: group {g} incompatible with type {cat.names[t]}")
            if enc.max_per_node[g] and cnt > enc.max_per_node[g]:
                errors.append(f"node {idx}: group {g} count {cnt} > cap {enc.max_per_node[g]}")
            if not (n.zone_mask & enc.allow_zone[g]).any():
                errors.append(f"node {idx}: group {g} zone constraint violated")
            if not (n.cap_mask & enc.allow_cap[g]).any():
                errors.append(f"node {idx}: group {g} capacity-type constraint violated")
        # final cum (prior occupancy + this solve) must fit the committed
        # type, minus the zone-varying daemonset reservation the node's
        # final zone mask still exposes it to
        cap_t = alloc[t]
        if zovh is not None and n.zone_mask.any():
            cap_t = cap_t - zovh[t][n.zone_mask].max(axis=0)
        if np.any(n.cum[: alloc.shape[1]] > cap_t + 2e-3):
            errors.append(f"node {idx}: over capacity on {cat.names[t]}")
        if not (cat.available[t] & n.zone_mask[:, None] & n.cap_mask[None, :]).any():
            errors.append(f"node {idx}: no available offering survives masks")
    for g in range(enc.G):
        want = int(enc.counts[g])
        got = placed_per_group.get(g, 0) + result.unschedulable.get(g, 0)
        if got != want:
            errors.append(f"group {g}: {got} accounted != {want} pods")
    if enc.zone_conflict is not None:
        # zone anti-affinity: any node hosting group i must have a zone mask
        # disjoint from every node hosting a zone-conflicting group j
        # (deferred masks — overlap means the launch step COULD violate)
        hosts: Dict[int, List[int]] = {}
        for idx, n in enumerate(result.nodes):
            for g, c in n.pods_by_group.items():
                if c > 0:
                    hosts.setdefault(g, []).append(idx)
        for i in hosts:
            for j in hosts:
                if j <= i or not enc.zone_conflict[i, j]:
                    continue
                for a in hosts[i]:
                    for b in hosts[j]:
                        if (result.nodes[a].zone_mask
                                & result.nodes[b].zone_mask).any():
                            errors.append(
                                f"nodes {a},{b}: zone-conflicting groups "
                                f"{i},{j} may share a zone")
    return errors


def copy_virtual_node(vn: VirtualNode) -> VirtualNode:
    """Independent copy of a VirtualNode (masks/cum/placement maps are
    fresh objects) — the facade's colocation branch works on copies,
    since callers reuse their VirtualNodes across many solves. A copy of
    the reference's `state/cluster.copy_virtual_node` (the port has no
    `state` package)."""
    return VirtualNode(
        type_idx=vn.type_idx, zone_mask=vn.zone_mask.copy(),
        cap_mask=vn.cap_mask.copy(), cum=vn.cum.copy(),
        pods_by_group=dict(vn.pods_by_group),
        prior_by_group=dict(vn.prior_by_group),
        banned_groups=vn.banned_groups,
        existing_name=vn.existing_name)
