"""Hostname-level required positive pod affinity: the co-location planner.

k8s semantics (the reference's core scheduler evaluates inter-pod affinity
inside its per-node simulation loop — website/content/en/docs/concepts/
scheduling.md "podAffinity"): a pod with a required podAffinity term at
topology_key=hostname may only land on a node already hosting a pod that
matches the term's selector (same namespace), with the standard bootstrap
exception — when NO pod in the cluster matches the selector, a pod whose
own labels match may seed a fresh domain and later pods join it.

tensor-first lowering: co-location couples placements through the NODE axis,
which the rectangular group-scan kernels deliberately do not model (they
track only per-node resource sums + deferred offering masks). Affinity-
coupled pods are rare and few, so this planner peels them OFF the tensor
path entirely and places them host-side before the kernels run — the hot
100k-pod path never pays for the feature. Decisions, in order:

  1. residents — existing nodes already hosting a match for EVERY term
     take the group's pods while type-compat/capacity/offering masks allow
     (k8s: any node of a matching topology domain qualifies);
  2. bundling — terms whose only matches are other PENDING groups open
     fresh nodes carrying >=1 pod of each term's target group plus as many
     initiator pods as fit; consumed target pods leave the tensor path.
     Multiple nodes may open while targets remain (each node independently
     hosts matches, so the real scheduler can bind in any order);
  3. self-match bootstrap — a group whose own labels satisfy a term, with
     no other match anywhere, packs onto ONE node: under sequential
     scheduling pod 1 places anywhere (bootstrap) and every later pod must
     join its node. Any self-only term therefore caps the group at one
     node; excess pods are unschedulable (k8s leaves them Pending);
  4. no resident, no target, no self-match — unschedulable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models import labels as L
from ..models.pod import Pod, PodAffinityTerm, Taint, tolerates_all
from ..models.pod import anti_blocks, term_selects as _selects
from ..models.requirements import Requirements
from .binpack import BIG, EPS, VirtualNode, _fit_count
from .encode import (CatalogTensors, _axis_allow, align_resources,
                     compat_mask, exotic_mask, group_pods, wants_exotic)


def _pos_terms(p: Pod) -> List[PodAffinityTerm]:
    return [t for t in p.affinity_terms
            if not t.anti and t.required and t.topology_key == L.HOSTNAME]


def _per_node_cap(rep: Pod) -> int:
    """Max pods of the group per node — mirrors encode_pods' max_per_node:
    self-anti-affinity caps at 1; hostname DoNotSchedule spread caps at
    maxSkew (conservative empty-node bound)."""
    cap = 1 if rep.has_self_anti_affinity() else BIG
    for tsc in rep.topology_spread:
        if (tsc.topology_key == L.HOSTNAME
                and tsc.when_unsatisfiable == "DoNotSchedule"):
            cap = min(cap, max(1, tsc.max_skew))
    return cap


def _anti_blocks(a: Pod, b: Pod) -> bool:
    return anti_blocks(a, b, L.HOSTNAME)


def has_colocation(pods: Sequence[Pod]) -> bool:
    return any(_pos_terms(p) for p in pods)


@dataclass
class BundleNode:
    """A host-planned node: committed type + deferred offering masks +
    the concrete pods riding on it (same contract as VirtualNode, plus the
    pod list and the AND of the members' compat rows for overrides)."""
    type_idx: int
    zone_mask: np.ndarray   # bool [Z]
    cap_mask: np.ndarray    # bool [C]
    pods: List[Pod]
    cum: np.ndarray         # f32 [R]
    group_compat: np.ndarray  # bool [T]


@dataclass
class ColocationPlan:
    bundles: List[BundleNode] = field(default_factory=list)
    # existing node name -> pods newly placed there by the planner
    existing_placements: Dict[str, List[Pod]] = field(default_factory=dict)
    unschedulable: List[Pod] = field(default_factory=list)
    remaining: List[Pod] = field(default_factory=list)


def plan_colocation(pods: Sequence[Pod], cat: CatalogTensors,
                    extra_requirements: Optional[Requirements] = None,
                    taints: Optional[List[Taint]] = None,
                    existing: Optional[List[VirtualNode]] = None,
                    existing_pods: Optional[Dict[str, List[Pod]]] = None,
                    type_cap: Optional[np.ndarray] = None,
                    template_labels: Optional[Dict[str, str]] = None,
                    ) -> ColocationPlan:
    """Place every pod carrying a required positive hostname-affinity term;
    everything else (including consumed-target leftovers) goes back out via
    `remaining` for the tensor path. Mutates `existing` nodes' cum/masks in
    place for resident placements so the SAME objects handed to the main
    solve see the consumed capacity — the facade passes throwaway copies
    (callers like disruption reuse their VirtualNodes across solves).

    type_cap: optional bool [T] — NodePool-limit headroom mask ANDed into
    every compat row (mirrors the facade's capacity_cap narrowing)."""
    plan = ColocationPlan()
    carriers = [p for p in pods if _pos_terms(p)]
    if not carriers:
        plan.remaining = list(pods)
        return plan
    # pods that don't tolerate the pool taints stay in `remaining`: the
    # encoder's taint filter reports them through the normal dropped path
    if taints:
        intolerant = [p for p in pods if not tolerates_all(p.tolerations, taints)]
        pods = [p for p in pods if tolerates_all(p.tolerations, taints)]
    else:
        intolerant = []

    groups = group_pods(pods)
    G = len(groups)
    terms = [_pos_terms(g.representative) for g in groups]
    # materialize every vector first: to_vector may auto-register resources,
    # growing the global axis (same ordering rule as encode_pods)
    vecs = {i: groups[i].representative.requests.to_vector() for i in range(G)}
    from ..models.resources import num_resources
    R = max(num_resources(), cat.allocatable.shape[1])
    alloc = align_resources(cat.allocatable, R)

    def g_req(i: int) -> np.ndarray:
        v = vecs[i]
        out = np.zeros(R, np.float32)
        out[: len(v)] = v[:R]
        return out

    reqs_cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    exotic = exotic_mask(cat)

    def g_masks(i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        hit = reqs_cache.get(i)
        if hit is None:
            rep = groups[i].representative
            r = rep.scheduling_requirements()
            if extra_requirements is not None:
                r = r.union_with(extra_requirements)
            comp = compat_mask(r, cat, template_labels)
            if type_cap is not None:
                comp = comp & type_cap
            if exotic.any() and not wants_exotic(rep, r):
                comp = comp & ~exotic  # same rule as encode_pods
            hit = (comp, _axis_allow(r, L.ZONE, cat.zones),
                   _axis_allow(r, L.CAPACITY_TYPE, cat.captypes))
            reqs_cache[i] = hit
        return hit

    # remaining pod budget per group, drawn front-to-back from group.pods
    rem = {i: groups[i].count for i in range(G)}
    cursor = {i: 0 for i in range(G)}

    def take(i: int, n: int) -> List[Pod]:
        at = cursor[i]
        cursor[i] = at + n
        rem[i] -= n
        return groups[i].pods[at: at + n]

    # --- per-term match discovery -------------------------------------------
    # resident_ok[i]: node indices (into `existing`) hosting a match for
    # EVERY term of group i; targets[i]: per term, the pending groups whose
    # labels match (excluding i itself); selfm[i]: per term, own-label match
    ex = list(existing or [])
    ex_pods = existing_pods or {}
    resident_ok: Dict[int, List[int]] = {}
    targets: Dict[int, List[List[int]]] = {}
    selfm: Dict[int, List[bool]] = {}
    for i in range(G):
        if not terms[i]:
            continue
        rep = groups[i].representative
        ok_nodes = []
        for ni, vn in enumerate(ex):
            residents = ex_pods.get(vn.existing_name or "", [])
            if residents and all(
                    any(_selects(t, p.namespace == rep.namespace, p.labels)
                        for p in residents) for t in terms[i]):
                ok_nodes.append(ni)
        resident_ok[i] = ok_nodes
        targets[i] = [[j for j in range(G) if j != i and _selects(
            t, groups[j].representative.namespace == rep.namespace,
            groups[j].representative.labels)] for t in terms[i]]
        selfm[i] = [_selects(t, True, rep.labels) for t in terms[i]]

    # --- placement, initiator groups in FFD order ---------------------------
    for i in range(G):
        if not terms[i] or rem[i] <= 0:
            continue
        req = g_req(i)
        comp, zmask, cmask = g_masks(i)

        rep = groups[i].representative
        cap_i = _per_node_cap(rep)

        # 1. fill resident-satisfying nodes
        for ni in resident_ok[i]:
            if rem[i] <= 0:
                break
            vn = ex[ni]
            t = vn.type_idx
            if not comp[t]:
                continue
            residents = ex_pods.get(vn.existing_name or "", [])
            if any(_anti_blocks(rep, p) for p in residents):
                continue  # required anti-affinity repels, symmetrically
            nz = vn.zone_mask & zmask
            nc = vn.cap_mask & cmask
            if not (cat.available[t] & nz[:, None] & nc[None, :]).any():
                continue
            cum = np.pad(vn.cum.astype(np.float32),
                         (0, max(0, R - len(vn.cum))))
            already = sum(1 for p in residents
                          if p.constraint_signature()
                          == rep.constraint_signature())
            k = min(_fit_count(alloc[t], cum, req), rem[i],
                    cap_i - already)
            if k < 1:
                continue
            placed = take(i, k)
            vn.cum = cum + np.float32(k) * req
            vn.zone_mask = nz
            vn.cap_mask = nc
            name = vn.existing_name or ""
            plan.existing_placements.setdefault(name, []).extend(placed)
        if rem[i] <= 0:
            continue

        # 1b. already-opened bundle nodes whose pods satisfy every term
        #     (an earlier initiator may have consumed this group's target;
        #     its node hosts the match, so later pods can join it)
        for b in plan.bundles:
            if rem[i] <= 0:
                break
            if not comp[b.type_idx]:
                continue
            if not all(any(_selects(t, p.namespace == rep.namespace,
                                    p.labels) for p in b.pods)
                       for t in terms[i]):
                continue
            if any(_anti_blocks(rep, p) for p in b.pods):
                continue
            nz = b.zone_mask & zmask
            nc = b.cap_mask & cmask
            if not (cat.available[b.type_idx]
                    & nz[:, None] & nc[None, :]).any():
                continue
            already = sum(1 for p in b.pods
                          if p.constraint_signature()
                          == rep.constraint_signature())
            k = min(_fit_count(alloc[b.type_idx], b.cum, req), rem[i],
                    cap_i - already)
            if k < 1:
                continue
            b.pods.extend(take(i, k))
            b.cum = b.cum + np.float32(k) * req
            b.zone_mask, b.cap_mask = nz, nc
            b.group_compat = b.group_compat & comp
        if rem[i] <= 0:
            continue

        # 2. classify the leftover terms
        need_target: List[int] = []   # term idx needing a pending target
        self_only = False
        dead = False
        for k_t in range(len(terms[i])):
            has_target = any(rem[j] > 0 for j in targets[i][k_t])
            if has_target:
                need_target.append(k_t)
            elif selfm[i][k_t]:
                self_only = True
            else:
                # no pending target, no self-match: resident capacity (if
                # any matched) ran out above — nowhere else qualifies
                dead = True
        if dead:
            plan.unschedulable.extend(take(i, rem[i]))
            continue

        # Adding a target to the bundle may pull in ITS OWN required
        # positive terms' targets transitively (a→b→c chains: k8s's
        # sequential scheduler can realize them, so the bundle must carry
        # the whole closure). _close adds group j plus whatever its terms
        # need, backtracking on failure; anti-affinity gates every add.
        def _close(j: int, members: List[Pod], adding: List[int]) -> bool:
            rj = groups[j].representative
            if any(_anti_blocks(rj, m) for m in members):
                return False
            m_len, a_len = len(members), len(adding)
            members.append(rj)
            adding.append(j)
            for t in _pos_terms(rj):
                if any(_selects(t, m.namespace == rj.namespace, m.labels)
                       for m in members if m is not rj):
                    continue
                ok = False
                for k in range(G):
                    rk = groups[k].representative
                    if rem[k] <= 0 or any(m is rk for m in members):
                        continue
                    if _selects(t, rk.namespace == rj.namespace, rk.labels) \
                            and _close(k, members, adding):
                        ok = True
                        break
                if not ok:
                    del members[m_len:]
                    del adding[a_len:]
                    return False
            return True

        # 3. open bundle nodes: one pod per needed target group (plus its
        #    closure) + fill with initiator pods; self-only terms cap the
        #    group at ONE node
        max_nodes = 1 if (self_only or not need_target) else BIG
        opened = 0
        while rem[i] > 0 and opened < max_nodes:
            picked: List[int] = []
            members: List[Pod] = [rep]
            ok = True
            for k_t in need_target:
                t = terms[i][k_t]
                if any(_selects(t, m.namespace == rep.namespace, m.labels)
                       for m in members if m is not rep):
                    continue  # an earlier pick already satisfies this term
                if not any(rem[j] > 0 and _close(j, members, picked)
                           for j in targets[i][k_t]
                           if not any(m is groups[j].representative
                                      for m in members)):
                    ok = False
                    break
            if not ok:
                break
            node = _open_bundle(cat, alloc, i, picked, g_req, g_masks,
                                rem, take, self_only, cap_i)
            if node is None:
                break
            plan.bundles.append(node)
            opened += 1
        if rem[i] > 0:
            plan.unschedulable.extend(take(i, rem[i]))

    # whatever was not consumed returns to the tensor path
    for i in range(G):
        if rem[i] > 0:
            plan.remaining.extend(take(i, rem[i]))
    plan.remaining.extend(intolerant)
    return plan


def _open_bundle(cat: CatalogTensors, alloc: np.ndarray, i: int,
                 target_groups: List[int], g_req, g_masks, rem, take,
                 one_shot: bool, cap_i: int = BIG) -> Optional[BundleNode]:
    """Open one node hosting 1 pod of each target group + initiator pods
    (at most cap_i — the initiator's per-node anti-affinity/spread cap).

    Offering choice mirrors binpack's new-node rule: cost-per-initiator-slot
    argmin over admissible (type, zone, captype); when the node is capped at
    one (`one_shot`, the self-match bootstrap), prefer fitting the WHOLE
    remaining group — cheapest among full-fit types, else max-slot types."""
    req_i = g_req(i)
    comp, zmask, cmask = g_masks(i)
    base = np.zeros_like(req_i)
    for j in target_groups:
        comp_j, zm_j, cm_j = g_masks(j)
        comp = comp & comp_j
        zmask = zmask & zm_j
        cmask = cmask & cm_j
        base = base + g_req(j)
    # the reserved target footprint must fit in EVERY resource dim —
    # including dims the initiator doesn't request (slots below only
    # guards dims where req_i > 0)
    comp = comp & (alloc >= base[None, :] - 1e-6).all(axis=1)
    adm = (cat.available & comp[:, None, None]
           & zmask[None, :, None] & cmask[None, None, :])
    if not adm.any():
        return None
    # initiator slots per type after reserving the target pods
    with_req = np.where(req_i > 0, req_i, np.float32(1.0))
    slots = np.where(req_i[None, :] > 0,
                     np.floor((alloc - base[None, :]) / with_req[None, :] + EPS),
                     np.float32(BIG)).min(axis=1)
    slots = np.minimum(np.maximum(slots, 0.0), np.float32(cap_i)).astype(np.int64)
    feasible = adm & (slots[:, None, None] >= 1)
    if not feasible.any():
        return None
    if one_shot and (feasible & (slots[:, None, None] >= rem[i])).any():
        feasible = feasible & (slots[:, None, None] >= rem[i])
    elif one_shot:
        best = slots[feasible.any(axis=(1, 2))].max()
        feasible = feasible & (slots[:, None, None] >= best)
    cps = np.where(feasible,
                   cat.price / np.maximum(slots, 1)[:, None, None].astype(np.float32),
                   np.float32(np.finfo(np.float32).max))
    flat = int(np.argmin(cps.reshape(-1)))
    t_star = flat // (cat.Z * cat.C)
    k = int(min(slots[t_star], rem[i]))
    members = take(i, k)
    for j in target_groups:
        members = take(j, 1) + members
    cum = np.float32(k) * req_i + base
    avail_t = (cat.available[t_star] & zmask[:, None] & cmask[None, :])
    return BundleNode(
        type_idx=t_star,
        zone_mask=zmask & avail_t.any(axis=1),
        cap_mask=cmask & avail_t.any(axis=0),
        pods=members, cum=cum, group_compat=comp)
