"""WarmAdmitter: first-fit arrival pods into the standing headroom ledger.

The ledger is a per-pool snapshot of exactly the solve inputs the cold
path would rebuild from scratch every reconcile: the pool's
availability-masked catalog tensors (capacity-block gate + daemonset
overhead already applied — `Solver.warm_catalog`), the standing virtual
nodes with resident occupancy (`state.cluster.pool_node_views` — the
same filter the provisioner's cold pass uses), and the residents per
claim. Between commits the ledger is advanced in place by each warm
admission, so admitting a 32-pod burst costs one small encode plus a
first-fit walk — no O(claims × pods) node-view rebuild, no full solve.

Placement semantics are the full solver's by construction: the encode
pipeline is `Solver.prepare_warm` (the same calls, in the same order,
as `Solver.solve`'s plain path) and the node-filling loop is
`ops.binpack.first_fit_group` — the code `solve_host` itself runs
before opening new nodes. What the warm path does NOT do is open nodes:
colocation bundles and any pods the standing fleet cannot absorb
escalate to the full solver untouched.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..models.nodepool import NodeClassSpec, NodePool
from ..models.pod import Pod
from ..ops.binpack import (SolveResult, VirtualNode, clone_nodes,
                           first_fit_group)
from ..ops.encode import (CatalogTensors, align_resources,
                          align_zone_overhead)


def _key(p: Pod) -> str:
    return f"{p.namespace}/{p.name}"


def pool_fingerprint(pool: NodePool) -> tuple:
    """Every solve-relevant NodePool field. Broader than pool.hash() —
    the drift hash deliberately covers only node-template fields (labels,
    taints, node_class), but the warm/cold decision must also notice
    requirements, limits, and weight changes: any of them changes what a
    solve would do."""
    reqs = pool.requirements
    req_sig = tuple(sorted(
        (k, tuple(sorted(vs.values)), vs.complement, vs.gt, vs.lt,
         vs.dne, reqs.min_values(k))
        for k, vs in ((k, reqs.get(k)) for k in reqs.keys())))
    limits = tuple(sorted(pool.limits.items())) if pool.limits else ()
    return (pool.hash(), req_sig, limits, pool.weight)


@dataclass
class PoolLedger:
    """One pool's standing headroom: everything a warm admission needs
    that a cold solve would otherwise recompute."""

    pool: NodePool
    node_class: NodeClassSpec
    pool_fp: tuple                    # pool_fingerprint(pool) at build
    nodeclass_hash: str
    ready: bool
    epoch: tuple                      # catalog availability version at build
    cat: Optional[CatalogTensors]     # gated + daemonset-reduced (None if not ready)
    nodes: List[VirtualNode] = field(default_factory=list)
    existing_pods: Dict[str, List[Pod]] = field(default_factory=dict)
    daemonsets: list = field(default_factory=list)


def build_pool_ledger(store, solver, pool: NodePool, now: float) -> PoolLedger:
    """Snapshot one pool's headroom from live cluster state — called at
    commit time (end of every cold solve). Uses the same view builder as
    the cold path (`pool_node_views`), so ledger and solve headroom
    cannot diverge."""
    from ..state.cluster import pool_node_views
    node_class = store.nodeclasses.get(pool.node_class) or NodeClassSpec()
    daemonsets = list(store.daemonsets.values())
    if not node_class.ready:
        # the cold path skips not-ready pools too; an empty ledger makes
        # the admitter pass every group through to the next pool
        return PoolLedger(pool=pool, node_class=node_class,
                          pool_fp=pool_fingerprint(pool),
                          nodeclass_hash=node_class.hash(), ready=False,
                          epoch=tuple(solver.catalog.epoch), cat=None,
                          daemonsets=daemonsets)
    cat = solver.warm_catalog(pool, node_class, daemonsets)
    views = pool_node_views(store, cat, now, pool.name)
    return PoolLedger(pool=pool, node_class=node_class,
                      pool_fp=pool_fingerprint(pool),
                      nodeclass_hash=node_class.hash(), ready=True,
                      epoch=tuple(solver.catalog.epoch), cat=cat,
                      nodes=[v.virtual for v in views],
                      existing_pods={v.claim.name: list(v.pods)
                                     for v in views},
                      daemonsets=daemonsets)


@dataclass
class WarmAdmission:
    """One pool's warm admission result."""

    placements: Dict[str, List[Pod]]   # claim name -> pods placed on it
    want: Dict[str, str]               # pod key -> claim name (audit record)
    passthrough: List[List[Pod]]       # taint-dropped groups -> next pool
    escalated: List[List[Pod]]         # bundles / non-fitting -> full solver
    # solution-integrity oracle findings on this admission's first-fit
    # result: >0 means NOTHING was placed (the whole batch escalated to
    # the full solver) and the engine must force the window cold
    integrity_violations: int = 0


class WarmAdmitter:
    def admit(self, solver, ledger: PoolLedger, pool: NodePool,
              groups: List[List[Pod]],
              occupancy: List[Tuple[Optional[str], List[Pod]]],
              ) -> WarmAdmission:
        """Place arrival `groups` (signature-grouped pod lists) onto the
        ledger's standing nodes. Mutates the ledger with successful
        placements. Escalation rules (never approximate):

        - a group carrying required positive hostname affinity (a
          colocation bundle) escalates whole — the bundle planner owns it;
        - a group the pool's taints drop passes through to the next pool
          (identical to the cold path's fall-through);
        - pods the standing fleet cannot absorb escalate to the full
          solver, which may open nodes for them."""
        from ..ops.colocate import has_colocation
        escalated: List[List[Pod]] = []
        plain: List[List[Pod]] = []
        for g in groups:
            (escalated if has_colocation([g[0]]) else plain).append(list(g))
        if not ledger.ready:
            # the cold path skips not-ready pools (pods fall through to
            # the next pool untouched) — mirror it
            return WarmAdmission({}, {}, plain, escalated)
        if not plain:
            return WarmAdmission({}, {}, [], escalated)
        if not ledger.nodes:
            # no standing fleet: every placement would need a new node
            escalated.extend(plain)
            return WarmAdmission({}, {}, [], escalated)
        cat = ledger.cat
        enc = solver.prepare_warm(plain, pool, cat, occupancy,
                                  ledger.nodes, ledger.existing_pods)
        passthrough: List[List[Pod]] = []
        if enc.dropped_keys:
            dropped = set(enc.dropped_keys)
            kept = []
            for g in plain:
                (passthrough if _key(g[0]) in dropped else kept).append(g)
            plain = kept
        if enc.G == 0 or not plain:
            escalated.extend(plain)
            return WarmAdmission({}, {}, passthrough, escalated)

        R = enc.requests.shape[1]
        alloc = align_resources(cat.allocatable, R)
        zovh = align_zone_overhead(cat, R)
        nodes = clone_nodes(ledger.nodes, R)
        unsched: Dict[int, int] = {}
        for g in range(enc.G):
            rem = first_fit_group(nodes, g, enc, cat, alloc, zovh,
                                  int(enc.counts[g]))
            if rem:
                unsched[g] = rem
        result = SolveResult(nodes=nodes, unschedulable=unsched)
        # solution-integrity oracle on the warm first-fit, BEFORE any
        # nomination commits — the same validation finish_solve applies
        # to cold results (karpenter_tpu/integrity/). A violation here
        # means the ledger's standing view produced an infeasible
        # placement: place nothing, escalate the whole batch to the
        # full solver, and let the engine force the window cold.
        from ..integrity import integrity_enabled
        if integrity_enabled():
            from ..integrity import INTEGRITY, verify_warm_result
            violations = verify_warm_result(cat, enc, result)
            INTEGRITY.record_warm(len(violations))
            # a warm commit advances the facade's resident-audit cadence
            # too: steady-state fleets are warm-dominated, and device-
            # resident rot must surface within one audit period, not at
            # the next (possibly hours-away) cold solve
            solver.warm_integrity_tick()
            if violations:
                INTEGRITY.record_breach_event()
                for vio in violations:
                    INTEGRITY.record_violation(vio.check, vio.detail)
                import logging
                logging.getLogger("karpenter_tpu_torch.integrity").warning(
                    "warm-admit integrity violation (%s) — escalating "
                    "the batch to the full solver",
                    "; ".join(str(v) for v in violations[:4]))
                escalated.extend(plain)
                return WarmAdmission({}, {}, passthrough, escalated,
                                     integrity_violations=len(violations))
        out = solver._decode(cat, enc, result, pool, [])

        by_key = {_key(p): p for g in plain for p in g}
        placements = {c: [by_key[k] for k in keys]
                      for c, keys in out.existing_placements.items()}
        want = {k: c for c, keys in out.existing_placements.items()
                for k in keys}
        un = set(out.unschedulable)
        for g in plain:
            rest = [p for p in g if _key(p) in un]
            if rest:
                escalated.append(rest)
        if want:
            # fold the batch into the standing ledger: the first-fit's
            # node copies (cum advanced, masks narrowed) become the new
            # standing nodes; placements become residents. prior_by_group
            # and bans are recomputed per batch from existing_pods, so
            # clearing pods_by_group loses nothing.
            for n in nodes:
                n.pods_by_group = {}
            ledger.nodes = nodes
            for c, pods in placements.items():
                ledger.existing_pods.setdefault(c, []).extend(pods)
            # solve work the standing ledger answered without a gbuf
            # dispatch — the delta-served outcome the c16 regime's
            # warm-admit floor measures
            from ..obs.recompute import RECOMPUTE
            RECOMPUTE.classify("solve", served=True, units=len(want))
        return WarmAdmission(placements, want, passthrough, escalated)
