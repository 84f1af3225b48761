"""WarmPathEngine: classify → admit → audit → commit.

The provisioner's entry points:

- `try_admit(groups, now)` at the top of every reconcile with pending
  pods: classifies the reconcile warm or cold and, when warm, places
  what the standing fleet absorbs (nominating pods to claims exactly
  the way the cold path's existing-placement branch does). Returns the
  groups the FULL solver must still handle — empty means the whole
  burst was admitted warm and the reconcile is done.
- `commit(now)` at the end of every cold pass: rebuilds the per-pool
  headroom ledgers and the cluster occupancy snapshot from post-solve
  state, clears the delta tracker, and hands the auditor its baseline.

The decision table, escalation rules, and auditor semantics are
documented in the reference's docs/warmpath.md.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Tuple

from ..catalog.provider import CatalogProvider
from ..metrics import (PODS_SCHEDULED, WARMPATH_ADMIT_DURATION,
                       WARMPATH_AUDITS, WARMPATH_DECISIONS,
                       WARMPATH_DIVERGENCE, WARMPATH_HIT_RATE)
from ..models.nodepool import NodeClassSpec
from ..models.pod import Pod
from ..obs.tracer import NOOP_SPAN, TRACER
from ..ops.facade import Solver
from ..state.store import Store
from ..utils import crashpoints
from .admitter import PoolLedger, WarmAdmitter, build_pool_ledger
from .auditor import Auditor
from .delta import DeltaTracker


class WarmPathEngine:
    def __init__(self, store: Store, solver: Solver,
                 catalog: CatalogProvider, audit_every: int = 1):
        self.store = store
        self.solver = solver
        self.catalog = catalog
        self.tracker = DeltaTracker(store)
        self.admitter = WarmAdmitter()
        self.auditor = Auditor(solver, audit_every=audit_every)
        self.ledgers: Dict[str, PoolLedger] = {}
        self._occupancy: List[Tuple[Optional[str], List[Pod]]] = []
        self._occ_by_claim: Dict[str, List[Pod]] = {}
        self.stats = {"warm_reconciles": 0, "cold_reconciles": 0,
                      "warm_pods": 0, "cold_pods": 0, "escalated_pods": 0,
                      "commits": 0, "divergences": 0}

    # --- classification ---
    def force_cold(self, reason: str) -> None:
        self.tracker.mark_dirty(reason)

    def classify(self) -> Optional[str]:
        """None = warm; otherwise the cold reason. Checks the delta
        tracker first, then everything events cannot carry: the catalog
        availability epoch (whose read also prunes expired ICE marks —
        a mark lapsing moves the epoch like a fresh mark does) and the
        NodePool/NodeClass config hashes."""
        if self.tracker.dirty:
            return self.tracker.dirty
        pools = self.store.nodepools_by_weight()
        if {p.name for p in pools} != set(self.ledgers):
            return "pool-set-changed"
        self.catalog.raw_types()  # TTL'd re-list: a changed backend catalog
        epoch = tuple(self.catalog.epoch)  # bumps the epoch checked here
        for pool in pools:
            led = self.ledgers[pool.name]
            if led.epoch != epoch:
                return "catalog-epoch"
            node_class = (self.store.nodeclasses.get(pool.node_class)
                          or NodeClassSpec())
            from .admitter import pool_fingerprint
            if (led.pool_fp != pool_fingerprint(pool)
                    or led.nodeclass_hash != node_class.hash()
                    or led.ready != node_class.ready):
                return "pool-config"
        return None

    # --- the warm pass ---
    def try_admit(self, groups: List[List[Pod]], now: float,
                  ) -> Tuple[bool, List[List[Pod]]]:
        """(admitted_any, leftover_groups). Leftover groups — escalated
        bundles, non-fitting remainders, or everything on a cold
        classification — go through the full solver."""
        total = sum(len(g) for g in groups)
        reason = self.classify()
        if reason is not None:
            self.stats["cold_reconciles"] += 1
            self.stats["cold_pods"] += total
            WARMPATH_DECISIONS.inc(path="cold", reason=reason)
            self._publish()
            return False, groups
        t0 = _time.perf_counter()
        sp = (TRACER.span("warmpath.admit", pods=total, groups=len(groups))
              if TRACER.enabled else NOOP_SPAN)
        admitted = 0
        escalated: List[List[Pod]] = []
        with sp, self.tracker.ignoring():
            remaining = groups
            for pool in self.store.nodepools_by_weight():
                if not remaining:
                    break
                led = self.ledgers[pool.name]
                adm = self.admitter.admit(self.solver, led, pool,
                                          remaining, self._occupancy)
                for claim_name, pods in adm.placements.items():
                    claim = self.store.nodeclaims.get(claim_name)
                    if claim is None or claim.is_deleting():
                        # the ledger named a claim the store no longer
                        # holds (or one now draining) — stale beyond
                        # what events explained; never place blind.
                        # Belt-and-braces: controllers broadcast these
                        # mutations (store.touch_nodeclaim), so the
                        # classifier should have gone cold already.
                        self.force_cold("ledger-claim-stale")
                        escalated.append(pods)
                        continue
                    for p in pods:
                        self.store.nominate_pod(p, claim.name)
                        claim.resource_requests = (
                            claim.resource_requests.add(p.requests))
                        self._occ_by_claim.setdefault(
                            claim.name, []).append(p)
                    admitted += len(pods)
                if adm.integrity_violations:
                    # the ledger produced a provably infeasible warm
                    # placement: never-wrong-twice — the window goes
                    # cold until the next full solve rebuilds it
                    self.force_cold("integrity-violation")
                if adm.want:
                    self.auditor.record(
                        pool.name,
                        [p for ps in adm.placements.values() for p in ps],
                        adm.want, now=now)
                escalated.extend(adm.escalated)
                remaining = adm.passthrough
            # groups every pool's taint filter dropped end up exactly
            # where the cold path sends them: the full pass, which
            # records FailedScheduling
            escalated.extend(remaining)
            sp.set(admitted=admitted,
                   escalated=sum(len(g) for g in escalated))
        WARMPATH_ADMIT_DURATION.observe(_time.perf_counter() - t0)
        n_esc = sum(len(g) for g in escalated)
        self.stats["warm_pods"] += admitted
        self.stats["escalated_pods"] += n_esc
        # path reflects what actually happened, matching the reconcile
        # span's attribute: "warm" = fully served from standing headroom,
        # "mixed" = partially, "escalated" = classified warm but nothing
        # fit (the full solver serves it all)
        if admitted:
            self.stats["warm_reconciles"] += 1
            path = "warm" if not n_esc else "mixed"
        else:
            path = "escalated"
        WARMPATH_DECISIONS.inc(path=path, reason="arrivals-only")
        if admitted:
            PODS_SCHEDULED.inc(admitted)  # nominations count as scheduled
            self.auditor.close_window()
            if self.auditor.due():
                self._run_audit()
        self._publish()
        return admitted > 0, escalated

    def on_restart(self, reason: str = "restart") -> None:
        """A rebuilt operator may NOT trust a warm window: the ledgers,
        baselines, and recorded-but-unaudited batches all described the
        dead process's view of the cluster. Drop them and force the next
        reconcile cold — the full solve + commit rebuilds coverage from
        the adopted fleet (called by make_sim/rehydrate after a restart
        adoption)."""
        self.auditor.reset()
        self.ledgers = {}
        self._occupancy = []
        self._occ_by_claim = {}
        self.force_cold(reason)

    def _run_audit(self) -> None:
        crashpoints.fire("mid_warm_audit")  # cut point: admissions
        divergences = self.auditor.audit()  # nominated, audit unproven
        if divergences:
            self.stats["divergences"] += len(divergences)
            WARMPATH_DIVERGENCE.inc(len(divergences))
            WARMPATH_AUDITS.inc(outcome="divergent")
            for d in divergences:
                self.store.record_event("warmpath", "auditor",
                                        "WarmPathDivergence", d)
            import logging
            logging.getLogger("karpenter_tpu_torch.warmpath").warning(
                "warm-path audit diverged from the full solver — forcing "
                "cold: %s", "; ".join(divergences))
            # never wrong twice: the path goes cold until the next
            # committed full solve rebuilds the ledger — and no
            # incremental DEVICE state may be trusted either: drop the
            # solver's resident delta buffers so the repair solve
            # re-seeds them from a clean cold upload
            inval = getattr(self.solver, "invalidate_resident", None)
            if inval is not None:
                inval("invalidated")
            self.force_cold("audit-divergence")
        else:
            WARMPATH_AUDITS.inc(outcome="clean")
            # rebase: the next audit window replays against the ledger
            # state its batches were actually admitted into
            self.auditor.on_commit(self.ledgers, self._occupancy)

    # --- commit (end of every cold solve) ---
    def commit(self, now: float) -> None:
        """Rebuild the standing ledgers from post-solve cluster state.
        This is the warm path's ONE expensive step — the same node-view
        walk a cold solve pays every reconcile — amortized over every
        warm tick that follows."""
        from ..state.cluster import cluster_occupancy
        sp = (TRACER.span("warmpath.commit") if TRACER.enabled
              else NOOP_SPAN)
        with sp:
            if self.auditor.has_pending():
                # a mixed reconcile reached its cold pass with recorded
                # warm batches still unaudited (audit_every > 1): replay
                # them NOW — resetting the baseline below would silently
                # drop them from audit coverage. Divergence here still
                # meters/flight-records; the rebuild below IS the forced
                # cold repair.
                self._run_audit()
            self.ledgers = {
                pool.name: build_pool_ledger(self.store, self.solver,
                                             pool, now)
                for pool in self.store.nodepools_by_weight()}
            self._occ_by_claim = {}
            self._occupancy = cluster_occupancy(self.store,
                                                by_claim=self._occ_by_claim)
            self.tracker.clear()
            self.auditor.on_commit(self.ledgers, self._occupancy)
            self.stats["commits"] += 1
            sp.set(pools=len(self.ledgers),
                   nodes=sum(len(l.nodes) for l in self.ledgers.values()))

    # --- observability ---
    def _publish(self) -> None:
        placed = self.stats["warm_pods"]
        seen = placed + self.stats["cold_pods"] + self.stats["escalated_pods"]
        if seen:
            WARMPATH_HIT_RATE.set(placed / seen)

    @property
    def hit_rate(self) -> float:
        placed = self.stats["warm_pods"]
        seen = placed + self.stats["cold_pods"] + self.stats["escalated_pods"]
        return placed / seen if seen else 0.0
