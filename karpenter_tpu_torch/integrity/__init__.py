"""Solution-integrity plane: the port's own copy of
`karpenter_tpu/integrity/`, armed by default as the reference's is.

- **feasibility oracle** (`oracle.py`) — a vectorized host-side
  validator (numpy over the already-encoded tensors) that checks every
  `SolveResult` before `Solver.finish_solve` commits it: per-node
  capacity, compat/zone/captype masks, the conflict matrix, max-per-node
  caps, spread bounds, launch-row prices, and per-group pod accounting.
  O(nodes + placements), no device traffic.
- **canary dual-path solves** (`canary.py`) — a deterministic,
  rate-limited sampler re-solves ~1/K device solves through
  `solve_host` and compares cost-equivalence-wise (total launch cost +
  per-group unschedulable counts, never byte-wise — ties may break
  differently), catching systematic device-path wrongness the per-solve
  oracle structurally cannot see (a corrupted price tensor produces
  FEASIBLE but more expensive placements).

- **resident-state audits** — periodic readback of device-resident rows
  checked against the uint64 per-row digests `ops/resident.py` keeps
  (`ResidentStateManager.audit`, every `audit_every()` verified solves);
  a mismatch invalidates the entry, meters the event, and escalates the
  facade to its fallback rung under the never-wrong-twice suspension.

Every verdict meters `integrity_verdicts_total{check,outcome,tenant}`,
every violation lands an `integrity.violation` marker in the
flight-recorder ring, and `/debug/integrity` serves the live meter.

Opt-out: `KARPENTER_TPU_INTEGRITY=0` disarms the whole plane —
`finish_solve` then ships the backend's result unchecked.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Dict, List, Tuple

# flight-recorder marker id sequence (unique within a process; NOT
# derived from wall time — see IntegrityMeter._flight_record)
_marker_seq = itertools.count(1)

INTEGRITY_ENV = "KARPENTER_TPU_INTEGRITY"
# canary cadence: 1 host re-solve per this many verified device solves
# per facade (0 disables the canary; the oracle still runs)
CANARY_ENV = "KARPENTER_TPU_INTEGRITY_CANARY"
CANARY_EVERY = 64
# resident-audit cadence: one digest audit of the facade's resident
# views per this many verified solves (0 disables the audit)
AUDIT_ENV = "KARPENTER_TPU_INTEGRITY_AUDIT"
AUDIT_EVERY = 16
# rows read back per audit pass (round-robin across entries): bounds the
# steady-state device -> host cost of the audit
AUDIT_ROWS = 4096

# the check taxonomy (the reference's)
CHECKS: Tuple[str, ...] = (
    "capacity",       # node cum exceeds the committed type's allocatable
    "compat",         # group placed on an incompatible (or banned) type
    "zone",           # node zone mask disjoint from a hosted group's
    "captype",        # node captype mask disjoint from a hosted group's
    "conflict",       # anti-affine groups colocated
    "max_per_node",   # per-(node, group) count above the encoded cap
    "spread",         # zone-anti-affine spread rows share a zone
    "offering",       # no available offering survives a node's masks
    "price",          # launch row priced/available inconsistently
    "accounting",     # per-group placed + unschedulable != encoded count
    "canary",         # dual-path host re-solve disagreed on cost
    "resident_audit",  # device-resident row digests diverged from host
)


def integrity_enabled() -> bool:
    """The opt-out gate: KARPENTER_TPU_INTEGRITY=0 restores today's
    unverified path byte-for-byte (default: armed everywhere)."""
    return os.environ.get(INTEGRITY_ENV, "1") not in ("0", "false", "no")


def audit_every() -> int:
    try:
        return int(os.environ.get(AUDIT_ENV, AUDIT_EVERY))
    except ValueError:
        return AUDIT_EVERY


class IntegrityError(RuntimeError):
    """The device rung returned an answer the oracle or the canary
    rejects, with no fault injected: a defect of the port's device path,
    raised out of `Solver.solve` rather than served from another rung."""

    def __init__(self, violations):
        self.violations = list(violations)
        super().__init__("device-rung solve failed the integrity checks: "
                         + "; ".join(str(v) for v in self.violations[:4]))


def canary_every() -> int:
    try:
        return int(os.environ.get(CANARY_ENV, CANARY_EVERY))
    except ValueError:
        return CANARY_EVERY


class IntegrityMeter:
    """Process-global verdict meter (the `optimizer/stats.py` pattern):
    every facade's oracle/canary/audit outcomes record here under the
    live tenant scope, the watchdog's `integrity_breach` invariant reads
    the per-tenant violation counters, and the chaos runners diff
    `detections()` around a run for the injected-vs-detected table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict[str, float]] = {}

    def _row(self, tenant: str) -> Dict[str, float]:
        return self._tenants.setdefault(tenant, {
            "solves_verified": 0, "violations": 0, "breach_events": 0,
            "recovered": 0, "unrecovered": 0, "canary_solves": 0,
            "canary_agree": 0, "canary_disagree": 0, "audits": 0,
            "audit_rows": 0, "audit_corrupt": 0, "warm_checks": 0,
            "warm_violations": 0})

    @staticmethod
    def _tenant() -> str:
        from ..metrics.tenant import current_tenant
        return current_tenant()

    def record_ok(self, tenant: str = "") -> None:
        """One validated solve with every oracle check green."""
        from ..metrics import INTEGRITY_VERDICTS
        with self._lock:
            self._row(tenant or self._tenant())["solves_verified"] += 1
        INTEGRITY_VERDICTS.inc(check="oracle", outcome="ok")

    def record_violation(self, check: str, detail: str = "",
                         tenant: str = "") -> None:
        from ..metrics import INTEGRITY_VERDICTS
        with self._lock:
            row = self._row(tenant or self._tenant())
            row["violations"] += 1
        INTEGRITY_VERDICTS.inc(check=check, outcome="violation")
        self._flight_record(check, detail)

    def record_breach_event(self, tenant: str = "") -> None:
        """One violating CONTEXT (a solve, a warm batch, an audit pass)
        regardless of how many individual checks it tripped — the unit
        the chaos runners compare against injected corruption counts."""
        with self._lock:
            self._row(tenant or self._tenant())["breach_events"] += 1

    def record_recovery(self, ok: bool, tenant: str = "") -> None:
        """Outcome of the quarantine re-solve: ok = the fallback
        backend's result passed the oracle (the violation is contained);
        not ok = even the host path failed — an encode/solver bug, kept
        loudly visible on the 'unrecovered' outcome."""
        from ..metrics import INTEGRITY_VERDICTS
        with self._lock:
            row = self._row(tenant or self._tenant())
            row["recovered" if ok else "unrecovered"] += 1
        if not ok:
            INTEGRITY_VERDICTS.inc(check="oracle", outcome="unrecovered")

    def record_audit(self, rows: int, corrupt: int,
                     tenant: str = "") -> None:
        from ..metrics import INTEGRITY_VERDICTS
        with self._lock:
            row = self._row(tenant or self._tenant())
            row["audits"] += 1
            row["audit_rows"] += int(rows)
            row["audit_corrupt"] += int(corrupt)
        if not corrupt:
            INTEGRITY_VERDICTS.inc(check="resident_audit", outcome="ok")

    def record_warm(self, violations: int, tenant: str = "") -> None:
        from ..metrics import INTEGRITY_VERDICTS
        with self._lock:
            row = self._row(tenant or self._tenant())
            row["warm_checks"] += 1
            row["warm_violations"] += int(violations)
        if not violations:
            INTEGRITY_VERDICTS.inc(check="oracle", outcome="ok")

    def record_canary(self, agree: bool, tenant: str = "") -> None:
        from ..metrics import INTEGRITY_VERDICTS
        with self._lock:
            row = self._row(tenant or self._tenant())
            row["canary_solves"] += 1
            row["canary_agree" if agree else "canary_disagree"] += 1
        if agree:
            INTEGRITY_VERDICTS.inc(check="canary", outcome="ok")
        # disagreement meters through record_violation at the call site

    @staticmethod
    def _flight_record(check: str, detail: str) -> None:
        """integrity.violation marker in the flight-recorder ring —
        works with tracing disabled (direct offer), meter=False so a
        rejected marker never counts against the overflow meter. The
        timestamp comes from the tracer's injected clock (sim time when
        a harness configured one) and the trace id from a process-local
        sequence — a wall-clock-derived id made chaos `--repeat 2`
        artifacts differ between byte-identical runs."""
        from ..obs.tracer import TRACER, Span, Trace
        ts = TRACER.clock()
        marker = Span(name="integrity.violation",
                      trace_id=f"integrity-{check}-{next(_marker_seq)}",
                      span_id=0, parent_id=None, t0=0.0, t1=1e-6,
                      ts=ts, attrs={"check": check, "detail": detail[:400]})
        TRACER.recorder.offer(Trace(trace_id=marker.trace_id,
                                    spans=[marker]), meter=False)

    # --- read side (watchdog + runners + report) --------------------------
    def violations_by_tenant(self) -> Dict[str, int]:
        with self._lock:
            return {t: int(r["violations"])
                    for t, r in self._tenants.items()}

    def unrecovered(self, tenant: str) -> int:
        """Violations this tenant never recovered from (host-path oracle
        failures) — the watchdog clears an integrity_breach excursion
        only when this is zero."""
        with self._lock:
            row = self._tenants.get(tenant)
            if row is None:
                return 0
            return int(row["unrecovered"])

    def detections(self) -> int:
        """Total violating contexts across tenants — the chaos runners
        diff this around a run for the injected-vs-detected contract."""
        with self._lock:
            return int(sum(r["breach_events"]
                           for r in self._tenants.values()))

    def canary_agreement_rate(self) -> float:
        with self._lock:
            solves = sum(r["canary_solves"] for r in self._tenants.values())
            agree = sum(r["canary_agree"] for r in self._tenants.values())
        return agree / solves if solves else 1.0

    def snapshot(self) -> dict:
        with self._lock:
            tenants = {t: dict(r) for t, r in sorted(self._tenants.items())}
        totals: Dict[str, float] = {}
        for row in tenants.values():
            for k, v in row.items():
                totals[k] = totals.get(k, 0) + v
        return {"armed": integrity_enabled(),
                "checks": list(CHECKS),
                "canary_every": canary_every(),
                "audit_every": audit_every(),
                "canary_agreement_rate": round(
                    self.canary_agreement_rate(), 6),
                "totals": totals,
                "tenants": tenants}

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()


INTEGRITY = IntegrityMeter()

from ..obs.exposition import register_debug_route  # noqa: E402

register_debug_route("/debug/integrity",
                     lambda query: INTEGRITY.snapshot())

from .canary import CanarySampler  # noqa: E402
from .oracle import Violation, verify_result, verify_warm_result  # noqa: E402

__all__ = ["CHECKS", "INTEGRITY", "INTEGRITY_ENV", "CANARY_ENV",
           "AUDIT_ENV", "AUDIT_ROWS", "CanarySampler", "IntegrityError",
           "IntegrityMeter", "Violation", "audit_every", "canary_every",
           "integrity_enabled", "verify_result", "verify_warm_result"]
