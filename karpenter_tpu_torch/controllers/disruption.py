"""Disruption controller: drift, expiration, emptiness, consolidation.

The port's own copy of `karpenter_tpu/controllers/disruption.py`. Its
seams differ from the reference's in these places, each marked where it
sits:
- every exact re-solve (`_simulate_removal`, `_revalidate`) goes through
  the port's `Solver.solve` (kernels B0 and B on the card's rung);
- the screen (`_screen_state`) calls the port's `consolidation_screen`
  (kernel A) on the solver's device on every rung, and degrades
  to cost order only for an injected fault (`ops/solver.InjectedFault`);
  a kernel's build, shape or launch error raises out of `reconcile`;
- the global optimizer (`_multi_node_optimizer`, armed by default as in
  the reference) scores on the solver's device through kernels A and C
  on the device rung and in NumPy on the host and native rungs; it
  degrades to the greedy path only for an `InjectedFault`, where the
  reference absorbs every exception. A fruitless search is memoized in
  the delta plane (`ops/delta`, audited every `audit_every`-th serve), or
  in `_optimizer_noop` with the plane disarmed, as in the reference.

Reference behavior (website/docs concepts/disruption.md:9-130 +
designs/consolidation.md): each pass builds disruptable candidates
(do-not-disrupt pods, budgets, consolidate-after stability gate), then in
order Drift → Expiration → Emptiness → Multi-node consolidation →
Single-node consolidation. Consolidation decisions pre-spin replacements
before the old node drains; spot→spot replacement requires a ≥15-type
flexibility floor (disruption.md:120-130).

Device-native: every "can the cluster absorb this node's pods" question is a
batched re-solve on the same kernel as provisioning — candidate pods are
re-encoded and solved against the other nodes' live headroom, with new
nodes allowed only below the candidate's price. Multi-node consolidation
binary-searches the largest disruptable prefix of the cost-ordered
candidate list, each probe one kernel call (the reference does a
sequential heuristic subset search on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..catalog.provider import CatalogProvider
from ..models import labels as L
from ..models.nodeclaim import NodeClaim, Phase
from ..models.nodepool import NodePool
from ..obs.tracer import NOOP_SPAN, TRACER
from ..ops.facade import Solver
from ..state.cluster import NodeView, build_node_views
from ..state.store import Store
from .termination import TerminationController

SPOT_TO_SPOT_MIN_TYPES = 15  # reference flexibility floor (disruption.md:129)
# settle window after restart adoption before any voluntary disruption:
# adopted nodes look empty until workloads re-list, and the empty pass must
# not reap them in that gap (reference: disruption requires cluster-state
# sync before acting)
ADOPTION_SETTLE = 120.0


@dataclass
class PendingDisruption:
    """A decided disruption waiting on its replacement to come up."""

    victim_claims: List[str]
    replacement_claims: List[str]
    reason: str
    decided_at: float
    # no default: constructing a decision without its pool would make
    # _revalidate silently vacuous (pool lookup misses → returns True)
    pool: str


@dataclass
class DisruptionController:
    store: Store
    solver: Solver
    catalog: CatalogProvider
    provisioner: object           # reuses its _launch machinery
    termination: TerminationController
    name: str = "disruption"
    requeue: float = 5.0
    spot_to_spot: bool = True  # SpotToSpotConsolidation feature gate
    _pending: List[PendingDisruption] = field(default_factory=list)
    # memoized consolidation-screen state per pool: (fingerprint,
    # (enc, counts, ok_names, slack)) — re-screening every reconcile
    # when nothing changed was pure waste (see _screen_state)
    _screen_cache: Dict[str, tuple] = field(default_factory=dict)
    # pool -> the (screen fingerprint, pending/deleting set, budget) a
    # subset search last proved FRUITLESS on: identical state skips the
    # search AND its exact verifies until something changes (a steady
    # cluster must not re-pay up to VERIFY_LIMIT solves per reconcile,
    # nor grow a fake divergence streak on unchanged state)
    _optimizer_noop: Dict[str, tuple] = field(default_factory=dict)
    stats: Dict[str, int] = field(default_factory=lambda: {
        "empty": 0, "drift": 0, "expired": 0, "consolidated": 0,
        "multi_consolidated": 0})

    def reconcile(self, now: float) -> float:
        self._advance_pending(now)
        if (self.store.adopted_at is not None
                and now - self.store.adopted_at < ADOPTION_SETTLE):
            return self.requeue
        for pool in self.store.nodepools_by_weight():
            sp = (TRACER.span("disruption.pool", pool=pool.name)
                  if TRACER.enabled else NOOP_SPAN)
            with sp:
                self._reconcile_pool(pool, now)
        return self.requeue

    # --- pending replacements: delete victims once replacements are up ---
    def _advance_pending(self, now: float) -> None:
        still = []
        for pd in self._pending:
            repl = [self.store.nodeclaims.get(r) for r in pd.replacement_claims]
            if any(r is None or r.phase == Phase.FAILED for r in repl):
                # replacement failed: abort the disruption, keep the victims
                self._uncordon(pd.victim_claims)
                self.store.record_event("disruption", ",".join(pd.victim_claims),
                                        "ReplacementFailed", pd.reason)
                continue
            if all(r.phase == Phase.INITIALIZED for r in repl):
                # re-validate against FRESH cluster state before touching
                # the victims (reference validates a consolidation command
                # again after its TTL, designs/consolidation.md:5-43): the
                # decision is minutes old and pods may have landed on a
                # victim (tolerated taint, direct bind) or other capacity
                # may have drained away in the meantime
                if not self._revalidate(pd, now):
                    self._uncordon(pd.victim_claims)
                    self.store.record_event(
                        "disruption", ",".join(pd.victim_claims),
                        "DisruptionAborted",
                        f"{pd.reason}: validation failed after replacement "
                        "boot; victims kept (idle replacements are reaped "
                        "by the emptiness pass)")
                    continue
                for v in pd.victim_claims:
                    claim = self.store.nodeclaims.get(v)
                    if claim is not None:
                        self.termination.delete_nodeclaim(claim, now, pd.reason)
                continue
            if now - pd.decided_at > 15 * 60:
                self._uncordon(pd.victim_claims)
                continue  # stale decision: drop
            still.append(pd)
        self._pending = still

    def _revalidate(self, pd: PendingDisruption, now: float) -> bool:
        """Fresh-state feasibility: every pod currently ON the victims must
        re-solve onto the surviving nodes (replacements included, they are
        INITIALIZED views now) without opening ANY new capacity."""
        pool = self.store.nodepools.get(pd.pool)
        if pool is None:
            return True  # pool deleted out from under us; nothing to check
        node_class = self.store.nodeclasses.get(pool.node_class)
        cat = self.solver.tensors(node_class)
        # scope to the victim's pool, like the decision solve was — other
        # pools' nodes carry taints/labels the VirtualNode view doesn't
        # model, so "fits on pool B" would be unsoundly lenient
        views = [v for v in build_node_views(self.store, cat, now)
                 if v.claim.nodepool == pd.pool]
        victim_set = set(pd.victim_claims)
        # a do-not-disrupt annotation applied (or a do-not-disrupt pod
        # landed) after the decision invalidates it — node-level controls
        # block voluntary disruption up to the last moment, unless the
        # claim's terminationGracePeriod forces it
        forced = (pd.reason in ("Drifted", "Expired"))
        for v in views:
            if v.name in victim_set and v.has_do_not_disrupt():
                # the grace-period override is scoped to drift/expiration
                # (disruption.md:260-268); a consolidation decision never
                # outlives a do-not-disrupt annotation
                if not (forced
                        and v.claim.termination_grace_period is not None):
                    return False
        pods = [p for v in views if v.name in victim_set for p in v.pods]
        if not pods:
            return True  # victims drained on their own: trivially safe
        other_pending = {name for q in self._pending if q is not pd
                         for name in q.victim_claims}
        others = [v for v in views
                  if v.name not in victim_set
                  and v.name not in other_pending
                  and not v.claim.is_deleting()]
        out = self.solver.solve(
            pods, pool, node_class,
            existing=[v.virtual for v in others],
            existing_pods={v.name: v.pods for v in others},
            daemonsets=list(self.store.daemonsets.values()))
        return not out.unschedulable and not out.launches

    # --- decision-time cordon (reference step order: taint victims FIRST,
    # then pre-spin, validate, delete — disruption.md:14-27) ---
    def _cordon(self, victims: List[NodeView]) -> None:
        from ..models.pod import Taint
        for v in victims:
            if v.node is not None and not any(
                    t.key == L.DISRUPTED_TAINT_KEY for t in v.node.taints):
                v.node.taints.append(
                    Taint(key=L.DISRUPTED_TAINT_KEY, effect="NoSchedule"))
                # in-place taint: broadcast, or the warm-path ledger
                # keeps filling a node the cold pass would now exclude
                self.store.touch_node(v.node, "cordon")

    def _uncordon(self, claim_names: List[str]) -> None:
        for name in claim_names:
            claim = self.store.nodeclaims.get(name)
            if claim is None or claim.is_deleting():
                continue  # draining nodes keep their taint
            node = self.store.node_for_nodeclaim(claim)
            if node is not None and any(t.key == L.DISRUPTED_TAINT_KEY
                                        for t in node.taints):
                node.taints = [t for t in node.taints
                               if t.key != L.DISRUPTED_TAINT_KEY]
                # capacity returned in place: broadcast (warm delta feed)
                self.store.touch_node(node, "uncordon")

    # --- per-pool pass ---
    def _reconcile_pool(self, pool: NodePool, now: float) -> None:
        self._hash_memo = {}  # templates may have mutated since last pass
        node_class = self.store.nodeclasses.get(pool.node_class)
        cat = self.solver.tensors(node_class)
        views = [v for v in build_node_views(self.store, cat, now)
                 if v.claim.nodepool == pool.name]
        if not views:
            return
        # work provenance of the drift/expiry/candidate classification
        # pass: one unit per node view, fingerprinted by everything the
        # pass's verdicts depend on — an unchanged candidate set
        # re-classified every reconcile is the redundant disrupt work a
        # delta layer would skip
        from ..obs.recompute import RECOMPUTE, fingerprint
        RECOMPUTE.classify("disrupt", fingerprint(
            pool.name,
            self._memo_hash(node_class) if node_class is not None else "",
            self._memo_hash(pool), self.catalog.epoch,
            tuple(sorted((v.name, len(v.pods),
                          v.claim.is_deleting()) for v in views))),
            units=len(views))
        budget_for = lambda reason: self._budget(pool, views, reason, now)
        # PDB gate for voluntary disruption (reference: candidates with
        # blocking PDBs are excluded from the disruption passes).
        # disruptionsAllowed computed once per pool pass — O(pods) per
        # PDB, not per candidate — then DECREMENTED as this pass commits
        # victims (in _replace): otherwise one pass could disrupt N
        # nodes against a budget of 1 and the drains would collide
        self._pdb_allowed = {key: self.store.pdb_disruptions_allowed(pdb)
                             for key, pdb in self.store.pdbs.items()}

        # 1. drift (nodeclass hash mismatch) + expiration.
        # do-not-disrupt (pod- or node-level) and PDBs gate these too —
        # UNLESS the claim carries a terminationGracePeriod, which the
        # reference treats as the operator's "this node WILL eventually
        # go" override (disruption.md:260-268: with it set, drift may
        # disrupt past blocking PDBs / do-not-disrupt)
        for v in views:
            if budget_for("Drifted") <= 0:
                break
            forced = v.claim.termination_grace_period is not None
            if not forced and (self._pdb_blocked(v)
                               or v.has_do_not_disrupt()):
                continue
            if self._is_drifted(v, node_class, pool):
                self._replace(pool, [v], "Drifted", now, cat, views,
                              forced=forced)
            elif (pool.expire_after is not None
                  and now - v.claim.created_at > pool.expire_after):
                self._replace(pool, [v], "Expired", now, cat, views,
                              stat="expired", forced=forced)

        if pool.disruption.consolidation_policy == "WhenEmpty":
            self._empty_pass(pool, views, now)
            return
        if pool.disruption.consolidation_policy not in (
                "WhenEmpty", "WhenEmptyOrUnderutilized"):
            return

        # 2. emptiness
        self._empty_pass(pool, views, now)

        # 3. consolidation (stability gate: node initialized long enough)
        settle = pool.disruption.consolidate_after
        candidates = [
            v for v in views
            if v.claim.phase == Phase.INITIALIZED
            and not v.has_do_not_disrupt()
            and v.pods
            and not v.claim.is_deleting()
            and not self._is_pending_victim(v.name)
            and not self._pdb_blocked(v)
            and now - v.claim.initialized_at >= settle]
        candidates.sort(key=lambda v: v.disruption_cost())
        if not candidates:
            return
        if budget_for("Underutilized") <= 0:
            return
        if len(candidates) > 1:
            if self._multi_node(pool, candidates, now, cat, views):
                return
        self._single_node(pool, candidates, now, cat, views,
                          budget_for("Underutilized"))

    # --- emptiness ---
    def _empty_pass(self, pool: NodePool, views: List[NodeView],
                    now: float) -> None:
        budget = self._budget(pool, views, "Empty", now)
        settle = pool.disruption.consolidate_after
        for v in views:
            if budget <= 0:
                break
            if (not v.pods and v.claim.phase == Phase.INITIALIZED
                    and not v.claim.is_deleting()
                    and not v.has_do_not_disrupt()  # node-level annotation
                    and not self._is_pending_victim(v.name)
                    and now - v.claim.initialized_at >= settle):
                self.termination.delete_nodeclaim(v.claim, now, "Empty")
                self.stats["empty"] += 1
                budget -= 1

    # --- drift ---
    def _memo_hash(self, obj) -> str:
        """Per-reconcile memo of template hashes: the object is fixed for
        the pass, so hash it once per object per reconcile. The memo is
        reset each _reconcile_pool (mutation between passes must land)."""
        memo = getattr(self, "_hash_memo", None)
        if memo is None:
            memo = self._hash_memo = {}
        key = id(obj)
        h = memo.get(key)
        if h is None:
            h = memo[key] = obj.hash()
        return h

    def _live_reservation_ids(self) -> set:
        """Reservation ids currently offered by the catalog, memoized per
        catalog epoch (the drift pass asks once per node)."""
        epoch = self.catalog.epoch
        cached = getattr(self, "_res_ids_cache", None)
        if cached is None or cached[0] != epoch:
            ids = {o.reservation_id for t in self.catalog.raw_types()
                   for o in t.offerings if o.reservation_id}
            self._res_ids_cache = (epoch, ids)
            return ids
        return cached[1]

    def _is_drifted(self, v: NodeView, node_class,
                    pool: Optional[NodePool] = None) -> bool:
        """Drift reasons (reference drift.go:35-41 — all five — plus the
        core's NodePool drift): static nodeclass-hash mismatch; static
        NODEPOOL-hash mismatch (template taints/labels changed); DYNAMIC
        requirements drift (the node's labels no longer satisfy the
        pool's live requirements); node image no longer in the resolved
        image set; node zone no longer in the resolved zones; node
        network-group set diverged from the resolved set (the
        security-group reason); and a reserved node whose capacity
        reservation vanished from the catalog (the capacity-reservation
        reason)."""
        if node_class is None:
            return False
        from ..models.nodepool import (NODECLASS_HASH_VERSION,
                                       NODEPOOL_HASH_VERSION)
        # the templates are fixed across the whole pool pass — hash once
        # per reconcile, not once per node (json+sha256 per node was
        # measurable at fleet scale)
        nc_hash = self._memo_hash(node_class)
        stamped = v.claim.annotations.get("karpenter.tpu/nodeclass-hash")
        stamped_ver = v.claim.annotations.get("karpenter.tpu/nodeclass-hash-version")
        if stamped is not None and stamped_ver != NODECLASS_HASH_VERSION:
            # hash-schema change (operator upgrade): the stored hash was
            # computed under a different field set, so a mismatch says
            # nothing about real drift — re-stamp instead of rolling the
            # fleet (reference ec2nodeclass-hash-version migration)
            v.claim.annotations["karpenter.tpu/nodeclass-hash"] = nc_hash
            v.claim.annotations["karpenter.tpu/nodeclass-hash-version"] = NODECLASS_HASH_VERSION
        elif stamped is not None and stamped != nc_hash:
            return True
        if pool is not None:
            p_hash = self._memo_hash(pool)
            pstamped = v.claim.annotations.get("karpenter.tpu/nodepool-hash")
            pver = v.claim.annotations.get("karpenter.tpu/nodepool-hash-version")
            if pstamped is not None and pver != NODEPOOL_HASH_VERSION:
                v.claim.annotations["karpenter.tpu/nodepool-hash"] = p_hash
                v.claim.annotations["karpenter.tpu/nodepool-hash-version"] = \
                    NODEPOOL_HASH_VERSION
            elif pstamped is not None and pstamped != p_hash:
                return True
            # dynamic requirements drift: the pool's LIVE requirements
            # must still accept this node's identity labels (the core
            # compares requirement-by-requirement, not by hash). Absence
            # counts as drift only for requirements that MATERIALIZE as
            # node labels — single-valued In pins (template_labels stamps
            # exactly those); judging absence for multi-valued/Exists
            # requirements would roll replacements forever, since they
            # never carry such labels either
            if v.node is not None and len(pool.requirements):
                for key in pool.requirements.keys():
                    want = pool.requirements.get(key)
                    have = v.node.labels.get(key)
                    if have is not None:
                        if not want.contains(have):
                            return True
                    elif (not want.complement and want.gt is None
                          and want.lt is None and not want.dne
                          and len(want.values) == 1):
                        return True  # pinned label the node never got
        if (node_class.resolved_images and v.claim.image_id
                and v.claim.image_id not in node_class.resolved_images):
            return True
        if (node_class.resolved_zones and v.claim.zone
                and v.claim.zone not in node_class.resolved_zones):
            return True
        # empty claim.network_groups is NOT exempt: a node launched before
        # the NodeClass's first resolution runs without its firewall groups
        # and must be remediated, not grandfathered
        if (node_class.resolved_network_groups
                and set(v.claim.network_groups)
                != set(node_class.resolved_network_groups)):
            return True
        if v.claim.capacity_type == L.CAPACITY_RESERVED:
            rid = v.claim.annotations.get("karpenter.tpu/reservation-id")
            if rid and rid not in self._live_reservation_ids():
                return True
        return False

    # --- consolidation simulations ---
    def _simulate_removal(self, pool: NodePool, victims: List[NodeView],
                          cat, views: List[NodeView],
                          max_new_price: Optional[float]):
        """Re-solve the victims' pods against the other nodes' headroom.
        Returns (launches, feasible) where feasible means nothing was left
        unschedulable and new nodes (if any) cost < max_new_price total."""
        victim_names = {v.name for v in victims}
        pods = [p for v in victims for p in v.pods]
        others = [v for v in views if v.name not in victim_names
                  and not v.claim.is_deleting()
                  and not self._is_pending_victim(v.name)]
        node_class = self.store.nodeclasses.get(pool.node_class)
        sp = (TRACER.span("disruption.simulate", victims=len(victims),
                          pods=len(pods), others=len(others))
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            out = self.solver.solve(
                pods, pool, node_class,
                existing=[v.virtual for v in others],
                existing_pods={v.name: v.pods for v in others},
                daemonsets=list(self.store.daemonsets.values()))
        if out.unschedulable:
            return out, False
        if max_new_price is not None:
            new_price = sum(l.price for l in out.launches)
            if new_price >= max_new_price - 1e-9:
                return out, False
        return out, True

    def _single_node(self, pool: NodePool, candidates: List[NodeView],
                     now: float, cat, views: List[NodeView],
                     budget: int) -> None:
        ordered = self._screen_order(pool, candidates, cat, views)
        done, sims = 0, 0
        max_sims = max(3 * budget, 10)  # exact-verification budget
        for v in ordered:
            if done >= budget or sims >= max_sims:
                break
            if self._pdb_blocked(v):  # earlier commits consumed budget
                continue
            sims += 1
            out, ok = self._simulate_removal(pool, [v], cat, views, v.price)
            if not ok:
                continue
            if out.launches and not self._spot_floor_ok(v, out, cat):
                continue
            self._execute(pool, [v], out, "Underutilized", now)
            self._pdb_commit([v])
            self.stats["consolidated"] += 1
            done += 1

    def _screen_fingerprint(self, pool: NodePool, cat,
                            views: List[NodeView]) -> str:
        """Content key for the memoized screen state: pool identity
        (hash + requirements/taints — NodePool.hash() deliberately
        excludes requirements), the DERIVED catalog view token (carries
        nodeclass hash, catalog epoch, block gating, and the daemonset
        overhead digest), and a per-view occupancy digest (claim name,
        committed type, resource cum, resident pod set). Any change a
        re-screen could observe moves the fingerprint."""
        import hashlib

        from ..ops.encode_cache import (labels_token, requirements_token,
                                        taints_token)
        h = hashlib.blake2b(digest_size=16)
        h.update(self._memo_hash(pool).encode())
        h.update(repr(requirements_token(pool.requirements)).encode())
        h.update(repr(taints_token(pool.taints
                                   + pool.startup_taints)).encode())
        h.update(repr(labels_token(pool.template_labels())).encode())
        tok = getattr(cat, "cache_token", None)
        h.update(repr(tok).encode() if tok is not None
                 else repr((id(cat), tuple(self.catalog.epoch))).encode())
        for v in views:
            h.update(v.name.encode())
            h.update(np.int64(v.virtual.type_idx).tobytes())
            h.update(v.virtual.cum.tobytes())
            for p in v.pods:
                h.update(f"|{p.namespace}/{p.name}".encode())
        return h.hexdigest()

    def _screen_state(self, pool: NodePool, cat,
                      views: List[NodeView]):
        """(enc, counts, ok_names, slack) for this pool pass, or None
        (no pods / no groups / screen fault). MEMOIZED on
        (pool fingerprint, catalog view token, occupancy digest): a
        steady cluster reconciling every few seconds re-screened the
        same state over and over — now only a store/catalog/occupancy
        change pays the encode + kernel call again."""
        import numpy as np

        from ..ops.consolidate import consolidation_screen
        from ..ops.encode import encode_pods
        all_pods = [p for v in views for p in v.pods]
        if not all_pods:
            return None
        # the screen judges other nodes' headroom — charge daemonset
        # overhead to their allocatable exactly like the solve does
        # (shared transform), or the screen over-admits candidates the
        # re-solve then rejects (wasted exact solves)
        from ..ops.facade import apply_daemonset_overhead
        template = pool.template_labels()
        cat = apply_daemonset_overhead(
            cat, list(self.store.daemonsets.values()), pool, template)
        from ..obs.recompute import RECOMPUTE, fingerprint_bytes
        fp = self._screen_fingerprint(pool, cat, views)
        hit = self._screen_cache.get(pool.name)
        if hit is not None and hit[0] == fp:
            self.stats["screen_cache_hits"] = (
                self.stats.get("screen_cache_hits", 0) + 1)
            RECOMPUTE.classify("optimizer", served=True)
            return hit[1]
        enc = encode_pods(all_pods, cat,
                          extra_requirements=pool.requirements,
                          taints=pool.taints + pool.startup_taints,
                          template_labels=template)
        if enc.G == 0:
            return None
        sig_to_g = {g.representative.constraint_signature(): i
                    for i, g in enumerate(enc.groups)}
        counts = np.zeros((len(views), enc.G), np.int32)
        for i, v in enumerate(views):
            for p in v.pods:
                gi = sig_to_g.get(p.constraint_signature())
                if gi is not None:
                    counts[i, gi] += 1
        sp = (TRACER.span("disruption.screen", nodes=len(views),
                          candidates=len(views))
              if TRACER.enabled else NOOP_SPAN)
        from ..ops.solver import InjectedFault
        try:
            with sp:
                # sharded over the solver's mesh where screen_mesh says
                # so (a mesh backend, or hybrid from 1,024 nodes), else on
                # the solver's device on every rung
                screen, slack = consolidation_screen(
                    cat, enc, views, counts, device=self.solver.device,
                    mesh=self.solver.screen_mesh(len(views)))
        except InjectedFault:
            # an injected device fault degrades to plain cost order,
            # metered like the facade's solve fallback so the event is
            # scrapeable (the span already carries outcome=error from its
            # exit). NEVER cached: the next pass re-probes the device.
            # The reference absorbs every exception here; the port only
            # the injected one — a kernel's build, shape or launch error
            # raises out of reconcile (and Engine.tick re-raises it)
            from ..metrics import SOLVER_FALLBACKS
            SOLVER_FALLBACKS.inc(from_backend="screen",
                                 to_backend="cost-order")
            self.stats["screen_errors"] = (
                self.stats.get("screen_errors", 0) + 1)
            return None
        ok = frozenset(v.name for i, v in enumerate(views) if screen[i])
        state = (cat, enc, counts, ok, slack)
        self._screen_cache[pool.name] = (fp, state)
        RECOMPUTE.classify("optimizer", fingerprint_bytes(fp.encode()))
        return state

    def _screen_order(self, pool: NodePool, candidates: List[NodeView],
                      cat, views: List[NodeView]) -> List[NodeView]:
        """Batched device screen over ALL candidates (one kernel call against
        the WHOLE cluster's headroom, memoized across unchanged
        reconciles), then order: screened-feasible by descending price
        (biggest savings first), then the rest (feasible only with
        replacements) by price."""
        state = self._screen_state(pool, cat, views)
        if state is None:
            return candidates
        _cat, _enc, _counts, ok, _slack = state
        first = [v for v in candidates if v.name in ok]
        rest = [v for v in candidates if v.name not in ok]
        first.sort(key=lambda v: -v.price)
        rest.sort(key=lambda v: -v.price)
        self.stats["screened"] = len(first)
        return first + rest

    def _multi_node(self, pool: NodePool, candidates: List[NodeView],
                    now: float, cat, views: List[NodeView]) -> bool:
        """Multi-node consolidation. With the global optimizer armed
        (KARPENTER_TPU_OPTIMIZER, default on) a combinatorial subset
        search over the candidates runs FIRST — savings that require
        joint eviction of a non-prefix subset are invisible to the
        greedy prefix search below. The optimizer only ever EXECUTES a
        subset that passed a real `Solver.solve()` verification under
        the same budget/PDB gates; when it proposes nothing provable,
        the greedy path runs unchanged, and with the flag off this
        method IS the greedy path byte-for-byte."""
        from ..optimizer import optimizer_enabled
        if optimizer_enabled():
            if self._multi_node_optimizer(pool, candidates, now, cat,
                                          views):
                return True
        return self._multi_node_greedy(pool, candidates, now, cat, views)

    def _multi_node_optimizer(self, pool: NodePool,
                              candidates: List[NodeView], now: float,
                              cat, views: List[NodeView]) -> bool:
        """Combinatorial repack search (karpenter_tpu_torch/optimizer):
        subset generation → one batched tournament + convex-relaxation
        dispatch → exact verification of the ranked winners. An injected
        device fault (`ops/solver.InjectedFault`) degrades to the greedy
        path and meters the fallback; any other error raises."""
        budget = self._budget(pool, views, "Underutilized", now)
        if budget < 2 or len(candidates) < 2:
            return False
        from ..metrics import OPTIMIZER_SUBSETS, SOLVER_FALLBACKS
        from ..optimizer import (MAX_K, VERIFY_LIMIT, OPTIMIZER,
                                 plan_repack)
        from ..ops.solver import InjectedFault
        state = self._screen_state(pool, cat, views)
        if state is None:
            return False
        scat, enc, counts, _ok, slack = state
        name_to_i = {v.name: i for i, v in enumerate(views)}
        cand_idx = [name_to_i[v.name] for v in candidates]
        exclude = np.array([self._is_pending_victim(v.name)
                            or v.claim.is_deleting() for v in views])
        # fruitless-search memo: same screen fingerprint + same
        # exclusions + same budget ⇒ the ranked subsets and every
        # verify verdict would repeat — skip the whole pass
        fp = self._screen_cache.get(pool.name, (None,))[0]
        noop_key = (fp,
                    frozenset(v.name for v, x in zip(views, exclude)
                              if x),
                    min(budget, 64))
        from ..obs.recompute import RECOMPUTE, fingerprint
        from ..ops.delta import DELTA
        # armed, the verdict lives in the delta plane: same serve as the
        # legacy dict, but policed — every audit_every-th serve is
        # refused and the search runs fresh for a confirm/diverge
        # verdict, and a diverged key (stored "fruitless", fresh pass
        # consolidated) opens the never-wrong-twice cooldown
        nfp = fingerprint(noop_key[0], tuple(sorted(noop_key[1])),
                          noop_key[2])
        dkey = ("disrupt", id(self), pool.name)
        opt_audit = False
        if DELTA.armed:
            hit = DELTA.serve("optimizer", dkey, nfp)
            if hit is not None:
                if not hit[1]:
                    RECOMPUTE.classify("optimizer", served=True)
                    return False
                opt_audit = True
        elif self._optimizer_noop.get(pool.name) == noop_key:
            RECOMPUTE.classify("optimizer", served=True)
            return False
        use_device = self.solver.backend in ("device", "mesh")
        # the device rungs score on the solver's mesh where screen_mesh
        # says so, else on its device (the card unless the solver was
        # given one); the host and native rungs in NumPy, as the
        # reference does
        mesh = (self.solver.screen_mesh(len(views)) if use_device
                else None)
        sp = (TRACER.span("optimizer.search", candidates=len(candidates),
                          nodes=len(views))
              if TRACER.enabled else NOOP_SPAN)
        try:
            with sp:
                plan = plan_repack(scat, enc, views, counts, slack,
                                   cand_idx, max_k=min(budget, MAX_K),
                                   exclude=exclude,
                                   use_device=use_device, mesh=mesh,
                                   device=self.solver.device)
            sp.set(scored=plan.scored, feasible=plan.feasible,
                   backend=plan.backend)
            RECOMPUTE.classify("optimizer", fingerprint(
                noop_key[0], tuple(sorted(noop_key[1])), noop_key[2]))
        except InjectedFault:
            # an injected device fault costs one greedy pass, not a
            # crashed reconcile (the dispatch hook is probed at
            # "optimizer" inside the device tournament). The reference
            # absorbs every exception here; the port only the injected
            # one — a kernel's build, shape or launch error raises out of
            # reconcile (and Engine.tick re-raises it)
            SOLVER_FALLBACKS.inc(from_backend="optimizer",
                                 to_backend="greedy")
            OPTIMIZER.record_fallback()
            OPTIMIZER_SUBSETS.inc(event="fallback")
            self.stats["optimizer_errors"] = (
                self.stats.get("optimizer_errors", 0) + 1)
            return False
        if not plan.subsets:
            self._optimizer_noop[pool.name] = noop_key
            self._delta_note_fruitless(dkey, nfp, opt_audit)
            return False
        vsp = (TRACER.span("optimizer.verify",
                           ranked=len(plan.subsets))
               if TRACER.enabled else NOOP_SPAN)
        executing = False
        try:
            with vsp:
                verified = 0
                for subset in plan.subsets:
                    if verified >= VERIFY_LIMIT:
                        break
                    victims = [views[i] for i in subset]
                    if len(victims) > budget:
                        continue
                    if any(self._is_pending_victim(v.name)
                           or v.claim.is_deleting()
                           or v.has_do_not_disrupt() for v in victims):
                        continue
                    if self._pdb_blocked_set(victims):
                        continue
                    verified += 1
                    total_price = sum(v.price for v in victims)
                    # the exact-verify contract: the optimizer proposes,
                    # Solver.solve() disposes — nothing executes on the
                    # relaxation's word alone
                    out, ok = self._simulate_removal(pool, victims, cat,
                                                     views, total_price)
                    if ok and out.launches and not all(
                            self._spot_floor_ok(v, out, cat)
                            for v in victims):
                        ok = False
                    OPTIMIZER.record_verify(bool(ok))
                    OPTIMIZER_SUBSETS.inc(
                        event="verify_pass" if ok else "verify_reject")
                    if not ok:
                        continue
                    executing = True
                    self._execute(pool, victims, out, "Underutilized",
                                  now, source="optimizer")
                    self._pdb_commit(victims)
                    self.stats["multi_consolidated"] += 1
                    self.stats["optimizer_consolidated"] = (
                        self.stats.get("optimizer_consolidated", 0) + 1)
                    self._optimizer_noop.pop(pool.name, None)
                    if opt_audit:
                        # the stored "fruitless" verdict was WRONG — the
                        # audit pass consolidated. Never-wrong-twice.
                        DELTA.diverge("optimizer", dkey)
                    else:
                        # executing moves the views: the memoized verdict
                        # (keyed on the pre-execute occupancy) is moot
                        DELTA.invalidate(("optimizer",) + dkey,
                                         reason="epoch")
                    vsp.set(verified=verified, accepted=len(subset))
                    return True
                vsp.set(verified=verified, accepted=0)
        except InjectedFault:
            # an injected device fault surfacing inside the verify stage
            # (the exact solve's own dispatch) degrades to greedy EXACTLY
            # like a search-stage fault — and the pass is NOT memoized as
            # fruitless: nothing proved the ranked subsets worthless, the
            # backend just died. The reference absorbs every exception
            # here; the port only the injected one
            if executing:
                # the winning subset's disruption PARTIALLY EXECUTED
                # (victims may already be cordoned/terminated): this is
                # not a verify-stage fault, and degrading to greedy here
                # would re-disrupt against stale views while hiding the
                # real bug — surface it
                raise
            SOLVER_FALLBACKS.inc(from_backend="optimizer",
                                 to_backend="greedy")
            OPTIMIZER.record_fallback()
            OPTIMIZER_SUBSETS.inc(event="fallback")
            self.stats["optimizer_errors"] = (
                self.stats.get("optimizer_errors", 0) + 1)
            return False
        self._optimizer_noop[pool.name] = noop_key
        self._delta_note_fruitless(dkey, nfp, opt_audit)
        return False

    def _delta_note_fruitless(self, dkey: tuple, nfp: int,
                              audit: bool) -> None:
        """Record a completed-but-fruitless optimizer pass in the delta
        plane: a fresh audit pass that STILL found nothing confirms the
        stored verdict (serve counter resets); a first-time verdict
        stores it. Fault-aborted passes never reach here — nothing
        proved the search fruitless, so nothing is memoized."""
        from ..ops.delta import DELTA
        if not DELTA.armed:
            return
        if audit:
            DELTA.confirm("optimizer", dkey, nfp, check_fp=nfp)
        else:
            DELTA.store("optimizer", dkey, nfp, True, check_fp=nfp)

    def _multi_node_greedy(self, pool: NodePool,
                           candidates: List[NodeView], now: float,
                           cat, views: List[NodeView]) -> bool:
        """Binary-search the largest prefix of cost-ordered candidates whose
        pods re-solve onto the rest + at most one cheaper replacement
        (reference multi-node consolidation, disruption.md:96-103)."""
        budget = self._budget(pool, views, "Underutilized", now)
        hi = min(len(candidates), max(budget, 0))
        if hi < 2:
            return False
        lo, best = 2, None
        while lo <= hi:
            mid = (lo + hi) // 2
            victims = candidates[:mid]
            total_price = sum(v.price for v in victims)
            out, ok = self._simulate_removal(pool, victims, cat, views,
                                             total_price)
            if ok and len(out.launches) <= 1:
                best = (victims, out)
                lo = mid + 1
            else:
                hi = mid - 1
        if best is None:
            return False
        victims, out = best
        if self._pdb_blocked_set(victims):
            return False  # collectively over the remaining allowance
        self._execute(pool, victims, out, "Underutilized", now)
        self._pdb_commit(victims)
        self.stats["multi_consolidated"] += 1
        return True

    def _spot_floor_ok(self, victim: NodeView, out, cat) -> bool:
        """Spot→spot replacement needs ≥15 distinct cheaper instance types
        of flexibility, else consolidation would chase the spot market
        (reference disruption.md:120-130)."""
        if victim.claim.capacity_type != "spot":
            return True
        for launch in out.launches:
            if launch.capacity_type != "spot":
                continue
            if not self.spot_to_spot:
                return False  # gate off: never replace spot with spot
            distinct = {o[0] for o in launch.overrides
                        if o[2] == "spot" and o[3] < victim.price}
            if len(distinct) < SPOT_TO_SPOT_MIN_TYPES:
                return False
        return True

    # --- execution: pre-spin replacement, then drain victims ---
    # --- PDB gate state for the current pool pass ---
    def _pdb_blocked(self, v: NodeView) -> bool:
        return self._pdb_blocked_set([v])

    def _pdb_blocked_set(self, victims: List[NodeView]) -> bool:
        """Would disrupting these victims TOGETHER exceed any PDB's
        remaining allowance this pass? Collective, not per-node: with
        allowed=1, two one-pod nodes each pass alone but not jointly."""
        allowed = getattr(self, "_pdb_allowed", None)
        if not allowed:
            return False
        for key, pdb in self.store.pdbs.items():
            n = sum(1 for v in victims for p in v.pods if pdb.matches(p))
            if n and n > allowed.get(key, 0):
                return True
        return False

    def _pdb_commit(self, victims: List[NodeView]) -> None:
        """Charge a committed disruption against this pass's remaining
        PDB allowances, so later candidates in the SAME pass see the
        reduced budget."""
        allowed = getattr(self, "_pdb_allowed", None)
        if not allowed:
            return
        for key, pdb in self.store.pdbs.items():
            n = sum(1 for v in victims for p in v.pods if pdb.matches(p))
            if n and key in allowed:
                allowed[key] = max(0, allowed[key] - n)

    def _replace(self, pool: NodePool, victims: List[NodeView], reason: str,
                 now: float, cat, views: List[NodeView],
                 stat: str = "drift", forced: bool = False) -> None:
        if self._is_pending_victim(victims[0].name) or victims[0].claim.is_deleting():
            return
        # final PDB check: the consolidation candidate list was filtered
        # with the allowances as of the top of the pass; earlier commits
        # in this pass may have consumed them. `forced` (claim carries a
        # terminationGracePeriod) bypasses it — the caller's gate already
        # waived PDBs per the reference override, and re-blocking here
        # would silently drop the forced disruption
        if not forced and self._pdb_blocked_set(victims):
            return
        out, ok = self._simulate_removal(pool, victims, cat, views, None)
        if not ok:
            return
        self._execute(pool, victims, out, reason, now)
        self._pdb_commit(victims)
        self.stats[stat if stat in self.stats else "drift"] += 1

    def _execute(self, pool: NodePool, victims: List[NodeView], out,
                 reason: str, now: float, source: str = "greedy") -> None:
        node_class = self.store.nodeclasses.get(pool.node_class)
        launched, failed = self.provisioner._launch(pool, node_class,
                                                    out.launches, now)
        if failed:
            # replacement launch failed; roll back what did launch and keep
            # the victims
            for claim in launched:
                self.termination.delete_nodeclaim(claim, now, "ReplacementAborted")
            return
        repl_names = [c.name for c in launched]
        if reason == "Underutilized":
            # realized $/hr delta of an EXECUTED consolidation, by
            # decision source — the optimizer-vs-greedy headline bench
            # c14 and `make disrupt-report` read
            savings = (sum(v.price for v in victims)
                       - sum(l.price for l in out.launches))
            if savings > 0:
                from ..metrics import CONSOLIDATION_SAVINGS
                CONSOLIDATION_SAVINGS.inc(savings, source=source)
        if not out.launches:
            # no replacement needed: drain immediately
            for v in victims:
                self.termination.delete_nodeclaim(v.claim, now, reason)
            return
        from ..metrics import DISRUPTION_DECISIONS
        DISRUPTION_DECISIONS.inc(
            reason=reason,
            consolidation_type="multi" if len(victims) > 1 else "single")
        # cordon victims NOW — between this decision and the replacement
        # becoming ready the victims must not absorb new pods, or the
        # validated decision rots while the replacement boots
        self._cordon(victims)
        self._pending.append(PendingDisruption(
            victim_claims=[v.name for v in victims],
            replacement_claims=repl_names, reason=reason, decided_at=now,
            pool=pool.name))
        self.store.record_event("disruption", ",".join(v.name for v in victims),
                                reason, f"replacements: {repl_names}")

    # --- budgets ---
    def _budget(self, pool: NodePool, views: List[NodeView], reason: str,
                now: Optional[float] = None) -> int:
        # in-flight drains MUST count against the budget, and views can't
        # show them — build_node_views excludes deleting claims — so read
        # the store (found by the combined-disruption budget sentinel:
        # every reconcile re-filled the budget, so a rolling drift took
        # 3x the budget down at once; the reference counts deleting nodes
        # from cluster state the same way)
        disrupting = sum(1 for c in self.store.nodeclaims.values()
                         if c.nodepool == pool.name and c.is_deleting())
        # percent budgets use the pool's FULL size (live + deleting) as
        # the denominator, like the reference — len(views) alone would
        # shrink the allowance as a roll proceeds, throttling it below
        # the configured rate
        allowed = pool.disruption.allowed_disruptions(
            reason, len(views) + disrupting, now=now)
        # pending decisions whose victims haven't started draining yet,
        # this pool's only — another pool's roll must not starve ours
        for pd in self._pending:
            for v in pd.victim_claims:
                c = self.store.nodeclaims.get(v)
                if (c is not None and c.nodepool == pool.name
                        and not c.is_deleting()):
                    disrupting += 1
        return max(0, allowed - disrupting)

    def _is_pending_victim(self, name: str) -> bool:
        return any(name in pd.victim_claims for pd in self._pending)
