"""Zone-level required pod (anti-)affinity as allow_zone mask surgery.

The reference's core scheduler evaluates full k8s inter-pod (anti-)affinity
inside its per-node simulation loop (website/content/en/docs/concepts/
scheduling.md — "podAffinity/podAntiAffinity"; hostname-level terms are
handled by encode.build_conflicts + per-node caps). Zone-topology terms
couple placements through the *zone* axis instead of the node axis, so the
tensor-first lowering is a host-side pre-pass that rewrites each group's
allow_zone mask before the kernels run — the kernels never see affinity,
only zone masks:

  Positive zone affinity (anti=False, required, topology_key=zone):
    - zones already hosting a matching resident pod restrict allow_zone
      (k8s: the pod may only land in a topology domain with a match);
    - when the only matches arrive in the same solve (other incoming
      groups), the group and its targets are co-pinned to one common
      feasible zone — sound (constraint guaranteed) though narrower than
      k8s's sequential scheduler, which could use several zones;
    - a self-matching group with no other match anywhere bootstraps pinned
      to a single zone: k8s's first-pod special case places pod 1 anywhere
      and every later pod must join its domain, which at group granularity
      is exactly "all in one zone";
    - no match anywhere and no self-match → unschedulable (k8s rejects).

  Zone anti-affinity (anti=True, required, topology_key=zone):
    - zones hosting a conflicting resident are removed (both directions:
      the resident's own zone-anti terms repel the group symmetrically,
      matching k8s's symmetric enforcement);
    - mutually-conflicting incoming groups are greedily pinned to disjoint
      zones in group (FFD) order — disjoint masks are the only way a
      deferred-zone solver can *guarantee* the constraint;
    - a self-conflicting group (own selector matches own labels — max one
      pod per zone) splits into one-pod-per-zone subgroups across its
      feasible zones; excess pods become an all-False-zone subgroup, which
      every backend reports unschedulable.

Runs before split_spread_groups (spread then balances within the surviving
zones). Group splits here reference the SAME PodGroup object from multiple
rows; facade._decode draws disjoint pod slices per row by sharing one
cursor per PodGroup.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models import labels as L
from ..models.pod import Pod, PodAffinityTerm
from ..models.pod import term_selects as _selects
from .encode import (CatalogTensors, EncodedPods, TermMatcher,
                     build_conflicts, feasible_zones)

Occupancy = Sequence[Tuple[Optional[str], Sequence[Pod]]]


def _zone_terms(rep: Pod, anti: bool) -> List[PodAffinityTerm]:
    return [t for t in rep.affinity_terms
            if t.anti == anti and t.required and t.topology_key == L.ZONE]


class _OccupancyIndex:
    """Zone-scattering wrapper over the shared columnar TermMatcher
    (ops/encode.py — THE vectorized term_selects): the cluster's
    resident pods flatten once into matcher columns + a zone index, and
    each (namespace, selector) term resolves to the zones holding ≥1
    match, memoized per distinct term. At c8 scale (thousands of
    residents × a handful of terms) this replaces the
    O(pods × groups × terms) Python quadruple loop that dominated the
    affinity pre-pass."""

    def __init__(self, occupancy: Occupancy, zidx: Dict[str, int], Z: int):
        pods: List[Pod] = []
        zones: List[int] = []
        for zone, pods_on in occupancy:
            zi = zidx.get(zone or "")
            if zi is None or not pods_on:
                continue
            pods.extend(pods_on)
            zones.extend([zi] * len(pods_on))
        self.pods = pods
        self.Z = Z
        self.zone = np.asarray(zones, np.int32) if pods else \
            np.zeros(0, np.int32)
        self._matcher = TermMatcher(pods)
        self._zmemo: Dict[tuple, np.ndarray] = {}

    def zones_matching(self, term: PodAffinityTerm,
                       namespace: str) -> Optional[np.ndarray]:
        """bool [Z] zones holding ≥1 resident the term selects from
        `namespace` (term_selects semantics), or None when no resident
        matches anywhere."""
        if not self.pods:
            return None
        key = (namespace, tuple(sorted(term.label_selector.items())))
        hit = self._zmemo.get(key)
        if hit is not None:
            return hit if hit.any() else None
        m = self._matcher.matches(namespace, term.label_selector)
        out = np.zeros(self.Z, bool)
        if m.any():
            out[np.unique(self.zone[m])] = True
        self._zmemo[key] = out
        return out if out.any() else None


def apply_zone_affinity(enc: EncodedPods, cat: CatalogTensors,
                        occupancy: Optional[Occupancy] = None,
                        capture: Optional[dict] = None) -> EncodedPods:
    """Rewrite allow_zone for zone-topology (anti-)affinity; split
    self-conflicting groups. Returns enc unchanged when no group carries
    zone terms (the common fast path).

    capture: delta-plane out-param (ops/delta.py) — filled with the
    transformation DESCRIPTOR this pass decided (the _rebuild arguments,
    or a noop sentinel), so an unchanged-input pass can replay it
    against a future enc via `replay_zone_affinity` without redoing the
    occupancy matching. Captured arrays are copies: downstream passes
    (preference relaxation) mutate the returned enc's rows in place."""
    G = enc.G
    pos = [_zone_terms(g.representative, anti=False) for g in enc.groups]
    neg = [_zone_terms(g.representative, anti=True) for g in enc.groups]
    # residents' own zone-anti terms repel groups even when the group has
    # no terms of its own, so the fast path must also scan occupancy
    # (once per pod — this runs every solve; the truthiness guard keeps
    # the common no-affinity resident at one attribute read, no list
    # allocation)
    resident_anti = []
    for zone, pods_on in (occupancy or []):
        if zone not in cat.zones:
            continue
        for p in pods_on:
            if not p.affinity_terms:
                continue
            ts = _zone_terms(p, anti=True)
            if ts:
                resident_anti.append((zone, p, ts))
    if not any(pos) and not any(neg) and not resident_anti:
        if capture is not None:
            capture["noop"] = True
        return enc

    allow = enc.allow_zone.copy()
    # affinity decisions are HARD: they must survive the facade's
    # preferred-affinity relaxation, so the zone_hard rows get the same
    # surgery as the working rows
    allow_hard = enc.zone_hard.copy() if enc.zone_hard is not None else None
    zidx = {z: i for i, z in enumerate(cat.zones)}

    def set_row(i: int, mask: np.ndarray) -> None:
        allow[i] = mask
        if allow_hard is not None:
            allow_hard[i] = mask

    def and_row(i: int, mask) -> None:
        allow[i] = allow[i] & mask
        if allow_hard is not None:
            allow_hard[i] = allow_hard[i] & mask

    # --- resident matches per group ---------------------------------------
    # pos_resident[i][k]: bool [Z] zones holding a match for term k (or None
    # when no resident matches that term anywhere). Matching runs through
    # the columnar occupancy index — one interned-label pass per key,
    # memoized per distinct (namespace, selector) term
    pos_resident: List[List[Optional[np.ndarray]]] = [
        [None] * len(ts) for ts in pos]
    anti_resident = np.zeros((G, cat.Z), bool)
    occ = (_OccupancyIndex(occupancy, zidx, cat.Z)
           if occupancy and (any(pos) or any(neg)) else None)
    if occ is not None:
        for i in range(G):
            rep = enc.groups[i].representative
            for k, t in enumerate(pos[i]):
                pos_resident[i][k] = occ.zones_matching(t, rep.namespace)
            for t in neg[i]:
                zs = occ.zones_matching(t, rep.namespace)
                if zs is not None:
                    anti_resident[i] |= zs
    for zone, p, p_terms in resident_anti:
        zi = zidx[zone]
        for i in range(G):
            rep = enc.groups[i].representative
            if any(_selects(t, p.namespace == rep.namespace, rep.labels)
                   for t in p_terms):
                anti_resident[i, zi] = True

    # --- positive terms ----------------------------------------------------
    # union-find for co-pin clusters (group ↔ incoming targets)
    parent = list(range(G))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    must_pin = np.zeros(G, bool)   # group belongs to a co-pin cluster
    initiator = np.zeros(G, bool)  # group carries the positive term
    for i in range(G):
        if not pos[i]:
            continue
        rep = enc.groups[i].representative
        for k, t in enumerate(pos[i]):
            if pos_resident[i][k] is not None:
                and_row(i, pos_resident[i][k])
                continue
            incoming = [j for j in range(G) if j != i and _selects(
                t, enc.groups[j].representative.namespace == rep.namespace,
                enc.groups[j].representative.labels)]
            self_match = _selects(t, True, rep.labels)
            if incoming:
                must_pin[i] = initiator[i] = True
                for j in incoming:
                    must_pin[j] = True
                    union(i, j)
            elif self_match:
                # bootstrap: group colocates with itself in one zone
                must_pin[i] = initiator[i] = True
            else:
                # no match anywhere → unschedulable
                set_row(i, np.zeros(cat.Z, bool))

    # --- anti terms: resident bans ------------------------------------------
    allow &= ~anti_resident
    if allow_hard is not None:
        allow_hard &= ~anti_resident

    # --- co-pin clusters to one common feasible zone -------------------------
    if must_pin.any():
        clusters: Dict[int, List[int]] = {}
        for i in np.flatnonzero(must_pin):
            clusters.setdefault(find(int(i)), []).append(int(i))
        for members in clusters.values():
            common = np.ones(cat.Z, bool)
            for i in members:
                common &= feasible_zones(enc, cat, i, allow[i])
            zs = np.flatnonzero(common)
            if not len(zs) and allow_hard is not None:
                # a soft zone preference must never fail a required
                # affinity: retry the intersection on the hard rows
                common = np.ones(cat.Z, bool)
                for i in members:
                    common &= feasible_zones(enc, cat, i, allow_hard[i])
                zs = np.flatnonzero(common)
            if len(zs):
                pin = np.zeros(cat.Z, bool)
                pin[zs[0]] = True
                for i in members:
                    set_row(i, pin.copy())
            else:
                # no zone serves the whole cluster: the initiating groups
                # cannot satisfy their term; targets keep their own masks
                for i in members:
                    if initiator[i]:
                        set_row(i, np.zeros(cat.Z, bool))

    # --- anti terms: cross-group disjointness + self splits ------------------
    self_anti = np.zeros(G, bool)
    conflict = np.zeros((G, G), bool)
    for i in range(G):
        rep = enc.groups[i].representative
        if any(_selects(t, True, rep.labels) for t in neg[i]):
            self_anti[i] = True
        for j in range(i + 1, G):
            rj = enc.groups[j].representative
            same_ns = rep.namespace == rj.namespace
            if (any(_selects(t, same_ns, rj.labels) for t in neg[i])
                    or any(_selects(t, same_ns, rep.labels) for t in neg[j])):
                conflict[i, j] = conflict[j, i] = True

    # zones each group will occupy (for the greedy disjoint partition);
    # rows [G] of Optional[bool [Z]]
    claimed: List[Optional[np.ndarray]] = [None] * G
    # groups the positive pass (or resident restrictions) already pinned to
    # a single zone claim it up front, so the greedy routes their conflict
    # partners around them regardless of processing order. Two conflicting
    # groups both pre-pinned to the SAME zone cannot coexist — the later
    # one goes unschedulable rather than silently violating the term.
    # Pinned-ness is judged on the HARD row: a soft zone preference that
    # narrowed allow to one zone is not a pin — it can be relaxed.
    for j in range(G):
        hard_j = allow[j] if allow_hard is None else allow_hard[j]
        if not conflict[j].any() or hard_j.sum() != 1:
            continue
        partners = np.flatnonzero(conflict[j])
        taken = any(claimed[p] is not None
                    and bool((claimed[p] & hard_j).any())
                    for p in partners)
        if taken:
            set_row(j, np.zeros(cat.Z, bool))
            claimed[j] = np.zeros(cat.Z, bool)
        else:
            claimed[j] = hard_j.copy()
    split_zones: Dict[int, List[int]] = {}
    for i in range(G):
        partners = np.flatnonzero(conflict[i])
        if not len(partners) and not self_anti[i]:
            continue
        if claimed[i] is not None and not self_anti[i]:
            continue  # pre-pinned; partners avoid its zone instead

        def _feas(base: np.ndarray) -> np.ndarray:
            eff = base.copy()
            for j in partners:
                if claimed[j] is not None:
                    eff &= ~claimed[j]
            return np.flatnonzero(feasible_zones(enc, cat, i, eff))

        zs = _feas(allow[i])
        need = int(enc.counts[i]) if self_anti[i] else 1
        if len(zs) < need and allow_hard is not None and (
                allow_hard[i] != allow[i]).any():
            # soft preference starves the pin/split: widen to the hard
            # row, keeping preferred zones first (prefer, never block)
            zs = np.concatenate(
                [zs, np.setdiff1d(_feas(allow_hard[i]), zs)])
        if self_anti[i]:
            use = zs[: int(enc.counts[i])]
            split_zones[i] = use.tolist()
            claim = np.zeros(cat.Z, bool)
            claim[use] = True
            claimed[i] = claim
            # allow stays; the split below pins each subgroup
        elif len(partners):
            if len(zs) == 0:
                set_row(i, np.zeros(cat.Z, bool))
                claimed[i] = np.zeros(cat.Z, bool)
            else:
                pin = np.zeros(cat.Z, bool)
                pin[zs[0]] = True
                set_row(i, pin)
                claimed[i] = pin

    zc = conflict if conflict.any() else None
    if not split_zones:
        if capture is not None:
            capture.update(
                allow=allow.copy(),
                allow_hard=None if allow_hard is None else allow_hard.copy(),
                zone_conflict=None if zc is None else zc.copy(),
                rows=None, self_anti=None)
        return _rebuild(enc, allow, allow_hard=allow_hard, zone_conflict=zc)

    # --- expand self-anti groups into one-pod-per-zone subgroups -------------
    rows: List[Tuple[int, int, np.ndarray]] = []  # (orig idx, count, zone row)
    for i in range(G):
        if i not in split_zones:
            rows.append((i, int(enc.counts[i]), allow[i]))
            continue
        used = split_zones[i]
        for z in used:
            row = np.zeros(cat.Z, bool)
            row[z] = True
            rows.append((i, 1, row))
        excess = int(enc.counts[i]) - len(used)
        if excess > 0:
            rows.append((i, excess, np.zeros(cat.Z, bool)))
    if capture is not None:
        capture.update(
            allow=allow.copy(),
            allow_hard=None if allow_hard is None else allow_hard.copy(),
            zone_conflict=None if zc is None else zc.copy(),
            rows=[(i, c, r.copy()) for i, c, r in rows],
            self_anti=self_anti.copy())
    return _rebuild(enc, allow, rows, allow_hard=allow_hard, zone_conflict=zc,
                    self_anti=self_anti)


def replay_zone_affinity(enc: EncodedPods, cat: CatalogTensors,
                         desc: dict) -> Optional[EncodedPods]:
    """Apply a captured zone-affinity descriptor to the CURRENT enc —
    the delta plane's serve half. The memo key fingerprints the enc
    content, so the descriptor fits by construction; the shape checks
    are defensive (a mismatch returns None and the caller recomputes,
    treating it as a divergence). Arrays are copied on the way in:
    downstream mutation must never reach the stored descriptor."""
    if desc.get("noop"):
        return enc
    allow = desc.get("allow")
    if allow is None or allow.shape != enc.allow_zone.shape:
        return None
    allow_hard = desc.get("allow_hard")
    if (allow_hard is None) != (enc.zone_hard is None):
        return None
    zc = desc.get("zone_conflict")
    rows = desc.get("rows")
    if rows is None:
        return _rebuild(enc, allow.copy(),
                        allow_hard=None if allow_hard is None
                        else allow_hard.copy(),
                        zone_conflict=None if zc is None else zc.copy())
    if any(i >= enc.G for i, _, _ in rows):
        return None
    return _rebuild(enc, allow.copy(),
                    [(i, c, r.copy()) for i, c, r in rows],
                    allow_hard=None if allow_hard is None
                    else allow_hard.copy(),
                    zone_conflict=None if zc is None else zc.copy(),
                    self_anti=desc["self_anti"].copy())


def descriptor_fingerprint(desc: dict) -> int:
    """Content digest of a zone-affinity descriptor — the affinity
    memo's audit comparator (ops/delta.py)."""
    from ..obs.recompute import fingerprint, fingerprint_bytes

    def afp(a) -> int:
        if a is None:
            return 0x9E3779B97F4A7C15
        a = np.ascontiguousarray(a)
        return fingerprint_bytes(a.tobytes()) ^ fingerprint(a.dtype.str,
                                                            a.shape)

    rows = desc.get("rows")
    return fingerprint(
        bool(desc.get("noop")), afp(desc.get("allow")),
        afp(desc.get("allow_hard")), afp(desc.get("zone_conflict")),
        afp(desc.get("self_anti")),
        None if rows is None else [(i, c, afp(r)) for i, c, r in rows])


def _rebuild(enc: EncodedPods, allow: np.ndarray,
             rows: Optional[List[Tuple[int, int, np.ndarray]]] = None,
             allow_hard: Optional[np.ndarray] = None,
             zone_conflict: Optional[np.ndarray] = None,
             self_anti: Optional[np.ndarray] = None) -> EncodedPods:
    """New EncodedPods with rewritten allow_zone (+ its hard rows and the
    zone-conflict matrix); optionally re-rowed (orig_idx, count, zone_row)
    for self-anti group splits."""
    if rows is None:
        return EncodedPods(
            groups=enc.groups, requests=enc.requests, counts=enc.counts,
            compat=enc.compat, allow_zone=allow, allow_cap=enc.allow_cap,
            max_per_node=enc.max_per_node, spread_zone=enc.spread_zone,
            conflict=enc.conflict, spread_soft=enc.spread_soft,
            compat_hard=enc.compat_hard, zone_hard=allow_hard,
            cap_hard=enc.cap_hard, zone_conflict=zone_conflict)
    groups = [enc.groups[i] for i, _, _ in rows]
    n = len(rows)
    Z = allow.shape[1]
    orig = [i for i, _, _ in rows]
    oi = np.asarray(orig, np.intp)  # one fancy-index gather per tensor
    zc = None
    if zone_conflict is not None or (self_anti is not None and self_anti.any()):
        base = (zone_conflict if zone_conflict is not None
                else np.zeros((enc.G, enc.G), bool))
        if self_anti is not None:
            # subgroup rows of one self-anti group conflict with each other
            base = base.copy()
            base[np.diag_indices(enc.G)] = self_anti
        o = np.asarray(orig)
        zc = base[np.ix_(o, o)].copy()
        np.fill_diagonal(zc, False)
        if not zc.any():
            zc = None
    # a split row's single-zone pin is a hard decision; unsplit rows keep
    # their hard row
    hard_rows = None
    if allow_hard is not None:
        split = {i for i, _, _ in rows if self_anti is not None
                 and i < len(self_anti) and self_anti[i]}
        hard_rows = np.array(
            [r if i in split else allow_hard[i] for i, _, r in rows],
            bool).reshape(n, Z)
    return EncodedPods(
        groups=groups,
        requests=enc.requests[oi],
        counts=np.fromiter((c for _, c, _ in rows), np.int32, n),
        compat=enc.compat[oi],
        allow_zone=np.array([r for _, _, r in rows], bool).reshape(n, Z),
        allow_cap=enc.allow_cap[oi],
        max_per_node=enc.max_per_node[oi],
        spread_zone=enc.spread_zone[oi],
        conflict=build_conflicts(groups),
        spread_soft=(enc.spread_soft[oi]
                     if enc.spread_soft is not None else None),
        compat_hard=(enc.compat_hard[oi]
                     if enc.compat_hard is not None else None),
        zone_hard=hard_rows,
        cap_hard=(enc.cap_hard[oi]
                  if enc.cap_hard is not None else None),
        zone_conflict=zc)
