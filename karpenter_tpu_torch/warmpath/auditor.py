"""Auditor: the warm path's full-solve correctness check.

At every ledger commit the auditor snapshots the per-pool baseline —
standing nodes, residents, and the cluster occupancy exactly as the
ledger saw them. Each warm admission is recorded as (pods, intended
placement map). Every K recorded batches (K=1, i.e. after every warm
admission, in tier-1 tests and chaos scenarios) it replays ALL
admissions accumulated since the commit through a fresh, full
`Solver.solve()` against the baseline and compares:

- every audited pod must land on the SAME existing node the warm path
  chose (`existing_placements` equality),
- the full solver must open no new nodes for them (`launches` empty —
  the warm path only admits what the standing fleet absorbs),
- none may be unschedulable.

Any difference is divergence: metered (`warmpath_divergence_total`),
flight-recorded as a `warmpath.divergence` trace when tracing is on,
and reported to the engine, which forces the path cold. The audit costs
one solve against snapshots — it never touches live cluster state.

After a clean audit the engine rebases the baseline to the CURRENT
ledger state (on_commit again), so every audit window replays exactly
the batches admitted since the window opened against the headroom they
were admitted into. With K=1 each window holds one batch and the
comparison is exact semantics parity; with K>1 the replay solves the
window's batches as ONE pod set, so the solver's global FFD ordering
can legitimately disagree with the order the batches arrived in — a
real (if rare) quality divergence of incremental admission, exactly
what the meter exists to surface, repaired by the forced cold solve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..models.pod import Pod
from ..obs.tracer import TRACER
from .admitter import PoolLedger


@dataclass
class _Baseline:
    ledger: PoolLedger           # pool/node_class/daemonset refs
    nodes: list                  # VirtualNode copies at commit
    pods: Dict[str, List[Pod]]   # residents per claim at commit
    occupancy: List[Tuple[Optional[str], List[Pod]]]


@dataclass
class _Batches:
    pods: List[Pod] = field(default_factory=list)
    want: Dict[str, str] = field(default_factory=dict)


class Auditor:
    def __init__(self, solver, audit_every: int = 1):
        self.solver = solver
        self.audit_every = max(1, int(audit_every))
        self._baselines: Dict[str, _Baseline] = {}
        self._batches: Dict[str, _Batches] = {}
        self._since_audit = 0
        # sim time of the OLDEST recorded-but-unaudited admission — the
        # audit-lag observable the invariant watchdog monitors (warm
        # coverage silently drifting behind is a finding, not a log line)
        self.pending_since: Optional[float] = None
        self.stats = {"audits": 0, "divergences": 0, "audited_pods": 0}

    def reset(self) -> None:
        """Restart: recorded-but-unaudited warm batches died with the
        old process, and the baselines they were admitted against
        describe a store that no longer exists — replaying them against
        a rebuilt baseline would manufacture false divergences. Drop
        everything; the forced-cold commit that follows a restart
        (WarmPathEngine.on_restart) re-establishes audit coverage."""
        self._baselines = {}
        self._batches = {}
        self._since_audit = 0
        self.pending_since = None

    # --- commit-time snapshot ---
    def on_commit(self, ledgers: Dict[str, PoolLedger],
                  occupancy: List[Tuple[Optional[str], List[Pod]]]) -> None:
        from ..ops.binpack import copy_virtual_node
        self._baselines = {
            name: _Baseline(
                ledger=led,
                nodes=[copy_virtual_node(n) for n in led.nodes],
                pods={k: list(v) for k, v in led.existing_pods.items()},
                occupancy=[(z, list(ps)) for z, ps in occupancy])
            for name, led in ledgers.items() if led.ready}
        self._batches = {}
        self._since_audit = 0
        self.pending_since = None

    # --- per-admission record ---
    def record(self, pool_name: str, pods: List[Pod],
               want: Dict[str, str],
               now: Optional[float] = None) -> None:
        b = self._batches.setdefault(pool_name, _Batches())
        b.pods.extend(pods)
        b.want.update(want)
        if self.pending_since is None and now is not None:
            self.pending_since = now

    def close_window(self) -> None:
        """One warm RECONCILE recorded admissions (possibly across
        several pools) — the engine calls this once per reconcile, so
        audit_every counts admission windows, not per-pool batches."""
        self._since_audit += 1

    def has_pending(self) -> bool:
        return bool(self._batches)

    def due(self) -> bool:
        return bool(self._batches) and self._since_audit >= self.audit_every

    # --- the replay ---
    def audit(self) -> List[str]:
        """Replay the window's accumulated admissions through the full
        solver; returns human-readable divergences (empty = parity).
        Batches are consumed; the engine rebases the baseline after a
        clean audit and forces cold (which recommits) on divergence."""
        self._since_audit = 0
        self.pending_since = None
        batches, self._batches = self._batches, {}
        divergences: List[str] = []
        for pool_name, b in batches.items():
            base = self._baselines.get(pool_name)
            if base is None:
                divergences.append(f"{pool_name}: no baseline for batch")
                continue
            self.stats["audits"] += 1
            self.stats["audited_pods"] += len(b.pods)
            from ..ops.binpack import copy_virtual_node
            led = base.ledger
            out = self.solver.solve(
                b.pods, led.pool, led.node_class,
                existing=[copy_virtual_node(n) for n in base.nodes],
                existing_pods={k: list(v) for k, v in base.pods.items()},
                spread_occupancy=[(z, list(ps))
                                  for z, ps in base.occupancy],
                daemonsets=list(led.daemonsets))
            got = {k: c for c, keys in out.existing_placements.items()
                   for k in keys}
            if out.launches:
                divergences.append(
                    f"{pool_name}: full solve opened {len(out.launches)} "
                    f"node(s) for warm-admitted pods")
            if out.unschedulable:
                divergences.append(
                    f"{pool_name}: full solve found "
                    f"{len(out.unschedulable)} warm-admitted pod(s) "
                    f"unschedulable: {sorted(out.unschedulable)[:3]}")
            if got != b.want:
                moved = sorted(k for k in set(got) | set(b.want)
                               if got.get(k) != b.want.get(k))
                divergences.append(
                    f"{pool_name}: {len(moved)} placement(s) differ "
                    f"(e.g. {moved[:3]})")
        if divergences:
            self.stats["divergences"] += len(divergences)
            self._flight_record(divergences)
        return divergences

    def _flight_record(self, divergences: List[str]) -> None:
        """Put the divergence into the flight recorder (a dedicated trace
        when the tracer is on — zero-cost otherwise) so /debug/traces can
        attribute the forced cold solve that follows."""
        if not TRACER.enabled:
            return
        with TRACER.trace("warmpath.divergence", count=len(divergences)):
            for d in divergences:
                with TRACER.span("warmpath.divergence.detail", detail=d):
                    pass
