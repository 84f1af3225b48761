"""Feasibility oracle: vectorized host-side validation of a SolveResult.

The semantics are `ops.binpack.validate_solution`'s — the audit the
golden/fuzz tests have always trusted — re-expressed as numpy over the
already-encoded tensors so it can run ON EVERY SOLVE: the per-node
Python loop there is fine for a 50-node test fixture and ruinous inside
a 100k-pod production reconcile, while this pass is O(nodes +
placements + launches) array work.

Checks (the `CHECKS` taxonomy in `integrity/__init__.py`):

| check        | property                                                |
|---|---|
| capacity     | final node cum ≤ the committed type's allocatable minus the zone-varying daemonset reservation its final zone mask exposes |
| compat       | every hosted group is type-compatible and not banned    |
| zone/captype | the node's final masks intersect every hosted group's   |
| conflict     | no two anti-affine groups share a node                  |
| max_per_node | this solve's count + prior occupancy ≤ the encoded cap  |
| spread       | zone-anti-affine split rows never share a possible zone |
| offering     | an available offering survives every node's masks       |
| price        | each launch row is available and priced off the catalog |
| accounting   | per group: placed + unschedulable == encoded count      |

Tolerances match validate_solution (2e-3 capacity epsilon — f32
accumulation order) so the two validators agree verdict-for-verdict;
the fuzz suite asserts exactly that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

# same capacity epsilon as ops.binpack.validate_solution: cum is f32
# accumulated in kernel order, alloc is f32 — a tighter bound false-
# positives on legitimate rounding, a looser one misses real overpacks
CAP_EPS = 2e-3
# launch prices are copied verbatim from cat.price by both backends —
# a relative fuzz only absorbs float32 printing, not a different row
PRICE_RTOL = 1e-5


@dataclass(frozen=True)
class Violation:
    check: str
    detail: str

    def __str__(self) -> str:  # pragma: no cover — repr convenience
        return f"[{self.check}] {self.detail}"


def _placement_arrays(result):
    """Sparse (group, node, count) triples of every placement in the
    result — O(placements), which is O(groups x sharing), never
    O(pods)."""
    gs: List[int] = []
    ns: List[int] = []
    cs: List[int] = []
    for ni, node in enumerate(result.nodes):
        for g, cnt in node.pods_by_group.items():
            if cnt > 0:
                gs.append(g)
                ns.append(ni)
                cs.append(cnt)
    return (np.asarray(gs, np.int64), np.asarray(ns, np.int64),
            np.asarray(cs, np.int64))


def verify_result(cat, enc, result) -> List[Violation]:
    """Validate one SolveResult against its encoded problem. Returns the
    violations (empty = feasible). Read-only over every input."""
    from ..ops.encode import align_resources, align_zone_overhead
    v: List[Violation] = []
    G = int(enc.G)
    R = enc.requests.shape[1]
    nodes = result.nodes
    n = len(nodes)
    gi, ni, ci = _placement_arrays(result)

    # --- accounting: conservation of pods, group by group -----------------
    placed = np.zeros(G, np.int64)
    if gi.size:
        in_range = gi < G
        if not in_range.all():
            v.append(Violation(
                "accounting",
                f"{int((~in_range).sum())} placement(s) reference group "
                f"indices beyond G={G}"))
        np.add.at(placed, gi[in_range], ci[in_range])
    unsched = np.zeros(G, np.int64)
    for g, cnt in result.unschedulable.items():
        if 0 <= g < G:
            unsched[g] = cnt
    want = enc.counts.astype(np.int64)
    bad = np.nonzero(placed + unsched != want)[0]
    for g in bad[:8]:
        v.append(Violation(
            "accounting",
            f"group {int(g)}: placed {int(placed[g])} + unschedulable "
            f"{int(unsched[g])} != {int(want[g])} pods"))

    if n == 0:
        return v

    # --- stacked node state ----------------------------------------------
    ntype = np.fromiter((nd.type_idx for nd in nodes), np.int64, n)
    cum = np.stack([nd.cum for nd in nodes]).astype(np.float32)
    zmask = np.stack([nd.zone_mask for nd in nodes])
    cmask = np.stack([nd.cap_mask for nd in nodes])

    # --- capacity ---------------------------------------------------------
    alloc = align_resources(cat.allocatable, R)
    zovh = align_zone_overhead(cat, R)
    cap = alloc[ntype].astype(np.float32)                     # [n, R]
    if zovh is not None:
        has_zone = zmask.any(axis=1)
        ovh = np.where(zmask[:, :, None], zovh[ntype], 0.0).max(axis=1)
        cap = cap - np.where(has_zone[:, None], ovh, 0.0)
    Rc = min(cum.shape[1], cap.shape[1])
    over = (cum[:, :Rc] > cap[:, :Rc] + CAP_EPS).any(axis=1)
    for i in np.nonzero(over)[0][:8]:
        v.append(Violation(
            "capacity",
            f"node {int(i)} over capacity on {cat.names[int(ntype[i])]}"))

    # --- offering survives the node's masks -------------------------------
    # FRESH nodes only: a fresh node must be launchable at an available
    # offering, but an EXISTING node is already running — its offering
    # being ICE-marked after launch is weather, not a wrong placement
    fresh_mask = np.fromiter((nd.existing_name is None for nd in nodes),
                             bool, n)
    surv = (cat.available[ntype] & zmask[:, :, None]
            & cmask[:, None, :]).any(axis=(1, 2))
    for i in np.nonzero(fresh_mask & ~surv)[0][:8]:
        v.append(Violation(
            "offering",
            f"node {int(i)} ({cat.names[int(ntype[i])]}): no available "
            f"offering survives its zone/captype masks"))

    # --- per-placement mask checks ---------------------------------------
    if gi.size:
        ok = (gi >= 0) & (gi < G)
        pg, pn, pc = gi[ok], ni[ok], ci[ok]
        bad_c = ~enc.compat[pg, ntype[pn]]
        for j in np.nonzero(bad_c)[0][:8]:
            v.append(Violation(
                "compat",
                f"node {int(pn[j])}: group {int(pg[j])} incompatible "
                f"with {cat.names[int(ntype[pn[j]])]}"))
        bad_z = ~(zmask[pn] & enc.allow_zone[pg]).any(axis=1)
        for j in np.nonzero(bad_z)[0][:8]:
            v.append(Violation(
                "zone",
                f"node {int(pn[j])}: group {int(pg[j])} zone constraint "
                f"violated"))
        bad_cc = ~(cmask[pn] & enc.allow_cap[pg]).any(axis=1)
        for j in np.nonzero(bad_cc)[0][:8]:
            v.append(Violation(
                "captype",
                f"node {int(pn[j])}: group {int(pg[j])} capacity-type "
                f"constraint violated"))
        # max-per-node, charging prior occupancy from earlier reconciles
        caps = enc.max_per_node[pg].astype(np.int64)
        prior = np.zeros(pg.size, np.int64)
        for j in range(pg.size):
            nd = nodes[int(pn[j])]
            if nd.prior_by_group:
                prior[j] = nd.prior_by_group.get(int(pg[j]), 0)
        bad_m = (caps > 0) & (pc + prior > caps)
        for j in np.nonzero(bad_m)[0][:8]:
            v.append(Violation(
                "max_per_node",
                f"node {int(pn[j])}: group {int(pg[j])} count "
                f"{int(pc[j])} (+{int(prior[j])} prior) > cap "
                f"{int(caps[j])}"))
        # resident bans (rare: only nodes carrying banned_groups)
        for i, nd in enumerate(nodes):
            if nd.banned_groups is None:
                continue
            for g, cnt in nd.pods_by_group.items():
                if cnt > 0 and g < len(nd.banned_groups) \
                        and nd.banned_groups[g]:
                    v.append(Violation(
                        "compat",
                        f"node {i}: banned group {g} placed"))

    # --- conflict matrix --------------------------------------------------
    if enc.conflict is not None and gi.size:
        hosted = np.zeros((n, G), bool)
        ok = (gi >= 0) & (gi < G)
        hosted[ni[ok], gi[ok]] = True
        # a node hosting groups i and j with conflict[i, j] collides:
        # (hosted @ conflict) & hosted has a true cell exactly there
        coll = (hosted @ enc.conflict) & hosted
        for i in np.nonzero(coll.any(axis=1))[0][:8]:
            gs = np.nonzero(coll[i])[0]
            v.append(Violation(
                "conflict",
                f"node {int(i)}: conflicting groups "
                f"{[int(g) for g in gs[:4]]} colocated"))

    # --- zone-spread anti-affinity (split rows must not share a zone) -----
    if enc.zone_conflict is not None and gi.size:
        hosts: dict = {}
        ok = (gi >= 0) & (gi < G)
        for g, i in zip(gi[ok].tolist(), ni[ok].tolist()):
            hosts.setdefault(g, []).append(i)
        pairs = np.argwhere(enc.zone_conflict)
        seen = set()
        for a, b in pairs:
            a, b = int(a), int(b)
            if a >= b or (a, b) in seen or a not in hosts or b not in hosts:
                continue
            seen.add((a, b))
            za = np.zeros(cat.Z, bool)
            zb = np.zeros(cat.Z, bool)
            for i in hosts[a]:
                za |= zmask[i]
            for i in hosts[b]:
                zb |= zmask[i]
            if (za & zb).any():
                v.append(Violation(
                    "spread",
                    f"zone-conflicting groups {a},{b} share a possible "
                    f"zone"))

    # --- launch rows ------------------------------------------------------
    fresh = [i for i, nd in enumerate(nodes) if nd.existing_name is None]
    launches = result.launches or []
    if launches and len(launches) == len(fresh):
        lt = np.fromiter((l[0] for l in launches), np.int64, len(launches))
        lz = np.fromiter((l[1] for l in launches), np.int64, len(launches))
        lc = np.fromiter((l[2] for l in launches), np.int64, len(launches))
        lp = np.fromiter((l[3] for l in launches), np.float64,
                         len(launches))
        finite = np.isfinite(lp)
        avail_ok = cat.available[lt, lz, lc]
        cat_p = cat.price[lt, lz, lc].astype(np.float64)
        price_ok = np.isclose(lp, cat_p, rtol=PRICE_RTOL, atol=1e-9)
        fi = np.asarray(fresh, np.int64)
        type_ok = lt == ntype[fi]
        mask_ok = zmask[fi, lz] & cmask[fi, lc]
        bad_l = finite & ~(avail_ok & price_ok & type_ok & mask_ok)
        for j in np.nonzero(bad_l)[0][:8]:
            v.append(Violation(
                "price",
                f"launch {int(j)} ({cat.names[int(lt[j])]}/"
                f"{cat.zones[int(lz[j])]}/{cat.captypes[int(lc[j])]} @ "
                f"{float(lp[j]):.6f}): inconsistent with the catalog "
                f"(available={bool(avail_ok[j])}, "
                f"catalog_price={float(cat_p[j]):.6f}, "
                f"type_match={bool(type_ok[j])}, "
                f"mask_match={bool(mask_ok[j])})"))
    elif launches and len(launches) != len(fresh):
        v.append(Violation(
            "price",
            f"{len(launches)} launch rows for {len(fresh)} fresh nodes"))

    return v


def verify_warm_result(cat, enc, result) -> List[Violation]:
    """The warm-admit face of the oracle: identical checks, minus the
    launch-row pass (warm admissions never open nodes — a fresh node in
    a warm result is itself a violation)."""
    v = verify_result(cat, enc, result)
    fresh = [i for i, nd in enumerate(result.nodes)
             if nd.existing_name is None]
    if fresh:
        v.append(Violation(
            "accounting",
            f"warm admission opened {len(fresh)} fresh node(s) — the "
            f"warm path may only fill standing capacity"))
    return v
