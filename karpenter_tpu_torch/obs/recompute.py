"""Recompute observatory: the work-provenance ledger that measures WHO
redoes identical work (the port's copy of `karpenter_tpu/obs/recompute.py`;
its fingerprints are the reference's bit for bit, since memo keys and the
parity tests' counts depend on them).

The PhaseLedger (obs/profile.py) answers "where does the reconcile
wall go"; this plane answers the follow-up the zero-recompute roadmap
item needs: of the work each stage did, how much was a recomputation of
inputs it had already seen? Every unit of stage work registers an input
fingerprint (the same uint64 row-digest machinery the upload-redundancy
meter uses — obs/devicemem.UploadMeter._row_digests, never Python
`hash()`: PYTHONHASHSEED must not leak into a repeat-determinism
contract) and is classified into one of three outcomes:

- **fresh**        — a fingerprint this stage has not seen (real work);
- **redundant**    — the same fingerprint recomputed from scratch (the
                     measured headroom a memo/cache/residency layer can
                     spend — CvxCluster's "cost scales with the delta"
                     target, PAPERS.md);
- **delta_served** — the work was answered by an existing cache,
                     memo, or residency layer (encode-cache hit,
                     conflict memo, screen memo, optimizer no-op memo,
                     warm admission) instead of being recomputed.

Stage taxonomy (STAGES): `encode`, `conflict`, `affinity`, `spread`,
`solve`, `optimizer`, `disrupt` — every stage ROADMAP item 3 targets.
Outcome unit counters always move (classification is a dict update);
**ms and bytes attribution rides the PhaseLedger span buckets**: when
tracing is enabled, a tracer sink maps each finished span's SELF time
to a stage (profile.span_bucket + STAGE_OF, so the two ledgers cannot
disagree) and splits it across the outcomes the same trace classified,
proportionally by units. Stage wall with NO classification in its trace
is the coverage gap — metered as
`karpenter_tpu_recompute_unattributed_ms_total` and flight-recorded as
a `recompute.unattributed` marker (offer(meter=False), like every
observability plane's self-markers) when a trace's classified share of
its taxonomy wall drops below COVERAGE_TARGET.

Decision-output glue buckets (launch/bind/commit/journal/cloud_api/
hooks/batch/integrity/reconcile_other) are NOT taxonomy stages: they
are excluded from the coverage denominator by design — "traced solve
wall" here means wall spent in recompute-taxonomy stages.

Zero overhead when tracing is off beyond the unit-counter updates;
the sink only fires from Tracer._finish, which never runs disabled.
Seed-deterministic: same call sequence => same snapshot; the ledger is
read-only over everything it observes, so chaos `--repeat` hashes and
fault fingerprints are byte-identical with the plane armed
(tests/test_recompute.py + the chaos suites assert so).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..metrics.tenant import current_tenant
from .profile import PhaseLedger, span_bucket
from .tracer import TRACER, Span, Trace

# --- the work taxonomy ------------------------------------------------------
# Every stage of the reconcile whose work can be provenance-classified.
# docs/observability.md documents the table; `make obs-audit` asserts
# every stage AND outcome is exercised by tests/test_recompute.py.
STAGES: Tuple[str, ...] = (
    "encode",      # pod->tensor lowering (per signature group)
    "conflict",    # anti-affinity conflict-matrix build
    "affinity",    # zone-affinity pre-pass
    "spread",      # topology-spread split
    "solve",       # gbuf dispatch: prep/upload/kernel/readback/decode,
    #                or a warm admission serving the batch from the ledger
    "optimizer",   # disruption consolidation screen + subset search
    "disrupt",     # drift/expiration/disruption classification pass
)

OUTCOMES: Tuple[str, ...] = ("fresh", "redundant", "delta_served")

# PhaseLedger bucket -> taxonomy stage. Buckets absent here are
# decision-output glue: excluded from the coverage denominator.
STAGE_OF: Dict[str, str] = {
    "encode_cold": "encode",
    "encode_cached": "encode",
    "affinity": "affinity",
    "spread": "spread",
    "queue_wait": "solve",
    "batch_pack": "solve",
    "pipeline_wait": "solve",
    "resident_patch": "solve",
    "prep": "solve",
    "catalog_put": "solve",
    "device_put": "solve",
    "compile": "solve",
    "dispatch": "solve",
    "readback": "solve",
    "decode": "solve",
    "solve_host": "solve",
    "solver_overhead": "solve",
    "warm_admit": "solve",
    "optimizer_search": "optimizer",
    "optimizer_verify": "optimizer",
}

COVERAGE_TARGET = 0.99

# bounded per-(tenant, stage) fingerprint memory: enough to recognize a
# steady cluster's whole working set, small enough to never matter
SEEN_CAP = 4096
# bounded in-flight trace classifications (a trace that never finishes
# — tracing disabled mid-flight — must not leak its pending entry)
PENDING_CAP = 64

# the excluded-glue sentinel _stage_of returns for spans whose bucket is
# known but deliberately outside the taxonomy (no ancestor inheritance)
_GLUE = "_glue"


# --- fingerprint helpers ----------------------------------------------------
_MASK = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_FMIX = 0xFF51AFD7ED558CCD
_SMALL_WORDS = 16


def fingerprint_bytes(data: bytes) -> int:
    """Deterministic uint64 content fingerprint — the devicemem row
    digest applied to one byte string (weighted sum + fmix64 finalize).
    Never Python hash(): PYTHONHASHSEED would break repeat contracts."""
    import numpy as np
    if not data:
        return 0x9E3779B97F4A7C15
    # the row digest of a one-row matrix, inlined: the planes call this
    # per node and per array on every solve, where the matrix path's
    # padding and weight cache (one entry a byte length) cost more than
    # the digest itself. Same words, weights and finalizer, so the same
    # value bit for bit
    pad = -len(data) % 8
    if pad:
        data = data + b"\0" * pad
    if len(data) <= 8 * _SMALL_WORDS:
        # a few words: Python integers beat numpy's per-call overhead
        h = 0
        for k in range(len(data) // 8):
            word = int.from_bytes(data[8 * k:8 * k + 8], "little")
            h = (h + word * ((((k + 1) * _GOLDEN) & _MASK) | 1)) & _MASK
        h ^= h >> 33
        h = (h * _FMIX) & _MASK
        return h ^ (h >> 33)
    u = np.frombuffer(data, dtype=np.uint64)
    with np.errstate(over="ignore"):
        w = ((np.arange(1, u.size + 1, dtype=np.uint64)
              * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1))
        h = (u * w).sum(dtype=np.uint64)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
    return int(h)


def fingerprint(*parts) -> int:
    """Deterministic uint64 over a tuple of repr-stable values. Callers
    must pass ordered collections (sort sets first) — repr of an
    unordered container is only stable within one process."""
    return fingerprint_bytes(
        "\x1f".join(repr(p) for p in parts).encode())


def fingerprint_rows(*matrices) -> "object":
    """Vectorized per-row uint64 fingerprints over one or more aligned
    matrices (same row count): each matrix digests per row, then the
    stacked digest columns digest again — one combined fingerprint per
    logical row. Returns a uint64 numpy vector."""
    import numpy as np

    from .devicemem import UploadMeter
    cols = []
    for m in matrices:
        m = np.ascontiguousarray(m)
        if m.ndim == 1:
            m = m.reshape(-1, 1)
        cols.append(UploadMeter._row_digests(m))
    if len(cols) == 1:
        return cols[0]
    return UploadMeter._row_digests(
        np.ascontiguousarray(np.stack(cols, axis=1)))


def fingerprint_fold(values) -> int:
    """Order-sensitive fold of an iterable/vector of uint64
    fingerprints into one."""
    import numpy as np
    arr = np.asarray(list(values) if not hasattr(values, "dtype")
                     else values, dtype=np.uint64)
    if arr.size == 0:
        return 0x9E3779B97F4A7C15
    return fingerprint_bytes(np.ascontiguousarray(arr).tobytes())


def encoded_fingerprint(enc) -> int:
    """One uint64 over an EncodedPods' solve-relevant content: per-group
    combined row digests (requests/compat/zone/cap masks) folded with
    the group counts. The gbuf identity the solve stage classifies on —
    an unchanged fingerprint re-solved from scratch is redundant work a
    warm admission or resident state should have served."""
    import numpy as np
    if getattr(enc, "G", 0) == 0:
        return 0x9E3779B97F4A7C15
    rows = fingerprint_rows(enc.requests, enc.compat, enc.allow_zone,
                            enc.allow_cap)
    return fingerprint_fold(np.concatenate(
        [rows, np.ascontiguousarray(enc.counts).astype(np.uint64)]))


def _stage_of(span: Span, trace: Trace) -> Optional[str]:
    """Span -> taxonomy stage, or _GLUE (bucket known, deliberately
    excluded) or None (unmapped name: inherit the nearest classified
    ancestor's stage)."""
    name = span.name
    if name == "encode.conflicts":
        return "conflict"
    if name.startswith("disruption."):
        # the batched consolidation screen is optimizer work; the rest
        # of a disruption pass (drift/expiry/candidate classification)
        # is the disrupt stage
        return "optimizer" if name == "disruption.screen" else "disrupt"
    b = span_bucket(span, trace)
    if b is None:
        return None
    return STAGE_OF.get(b, _GLUE)


class RecomputeLedger:
    """Process-wide work-provenance ledger (module singleton RECOMPUTE,
    weakref /debug/recompute route, tenant-scoped, seed-deterministic).

    Call sites call `classify(stage, fp)` per unit of work — a bounded
    per-(tenant, stage) LRU of seen fingerprints decides fresh vs
    redundant; `served=True` marks work a cache/memo/residency layer
    answered (delta_served, no fingerprint needed). The tracer sink
    (`ingest`) attributes traced stage wall/bytes across the outcomes
    each trace classified."""

    def __init__(self, coverage_target: float = COVERAGE_TARGET,
                 seen_cap: int = SEEN_CAP):
        self.coverage_target = coverage_target
        self.seen_cap = seen_cap
        self._lock = threading.Lock()
        # (tenant, stage, outcome) -> units of work
        self._units: Dict[Tuple[str, str, str], int] = {}
        # (stage, outcome) -> units over every tenant: the watchdog reads
        # these on each evaluation, and a fleet holds one row of _units
        # per tenant
        self._stage_units: Dict[Tuple[str, str], int] = {}
        # (tenant, stage) -> LRU of seen fingerprints
        self._seen: Dict[Tuple[str, str], "OrderedDict[int, None]"] = {}
        # trace_id -> stage -> outcome -> units classified while that
        # trace was current (consumed by ingest; bounded)
        self._pending: Dict[str, Dict[str, Dict[str, int]]] = {}
        # (stage, outcome) -> attributed ms / bytes
        self._ms: Dict[Tuple[str, str], float] = {}
        self._bytes: Dict[Tuple[str, str], int] = {}
        # stage -> [taxonomy wall ms, unattributed ms]
        self._stage_wall: Dict[str, List[float]] = {}
        self.traces = 0
        self.errors = 0

    # --- classification (call sites) --------------------------------------
    def classify(self, stage: str, fp: Optional[int] = None, *,
                 served: bool = False, units: int = 1,
                 tenant: Optional[str] = None) -> str:
        """Register `units` of `stage` work with input fingerprint `fp`
        and return the outcome. served=True short-circuits to
        delta_served (fp unused). Cheap: two dict updates and a metric
        inc — safe on the hot path with tracing off."""
        if units <= 0:
            return "delta_served" if served else "fresh"
        t = tenant if tenant is not None else current_tenant()
        if served:
            outcome = "delta_served"
        else:
            with self._lock:
                seen = self._seen.get((t, stage))
                if seen is None:
                    seen = self._seen[(t, stage)] = OrderedDict()
                key = int(fp) if fp is not None else 0
                if key in seen:
                    seen.move_to_end(key)
                    outcome = "redundant"
                else:
                    seen[key] = None
                    if len(seen) > self.seen_cap:
                        seen.popitem(last=False)
                    outcome = "fresh"
        self._record(t, stage, outcome, units)
        return outcome

    def classify_rows(self, stage: str, fps, *,
                      tenant: Optional[str] = None) -> Tuple[int, int]:
        """Batch classification of a fingerprint vector (one unit each)
        under a single lock pass — the cold-encode path classifies a
        whole group matrix this way. Returns (fresh, redundant)."""
        t = tenant if tenant is not None else current_tenant()
        fresh = redundant = 0
        with self._lock:
            seen = self._seen.get((t, stage))
            if seen is None:
                seen = self._seen[(t, stage)] = OrderedDict()
            for fp in fps:
                key = int(fp)
                if key in seen:
                    seen.move_to_end(key)
                    redundant += 1
                else:
                    seen[key] = None
                    if len(seen) > self.seen_cap:
                        seen.popitem(last=False)
                    fresh += 1
        if fresh:
            self._record(t, stage, "fresh", fresh)
        if redundant:
            self._record(t, stage, "redundant", redundant)
        return fresh, redundant

    def _record(self, tenant: str, stage: str, outcome: str,
                units: int) -> None:
        with self._lock:
            key = (tenant, stage, outcome)
            self._units[key] = self._units.get(key, 0) + units
            agg = (stage, outcome)
            self._stage_units[agg] = self._stage_units.get(agg, 0) + units
            tid = TRACER.current_trace_id()
            if tid is not None:
                pend = self._pending.get(tid)
                if pend is None:
                    if len(self._pending) >= PENDING_CAP:
                        self._pending.pop(next(iter(self._pending)))
                    pend = self._pending[tid] = {}
                row = pend.setdefault(stage, {})
                row[outcome] = row.get(outcome, 0) + units
        from ..metrics import RECOMPUTE_WORK, REDUNDANT_WORK_FRAC
        RECOMPUTE_WORK.inc(units, stage=stage, outcome=outcome,
                           tenant=tenant)
        REDUNDANT_WORK_FRAC.set(self.redundant_frac(stage), stage=stage)

    # --- ingestion (tracer sink) -------------------------------------------
    def ingest(self, trace: Trace) -> None:
        """Tracer sink: attribute one finished trace's taxonomy wall.
        Defensive — observability must never take down the path it
        observes."""
        try:
            self._ingest(trace)
        except Exception:  # noqa: BLE001 — observability must not crash the path it observes
            with self._lock:
                self.errors += 1

    def _ingest(self, trace: Trace) -> None:
        with self._lock:
            pending = self._pending.pop(trace.trace_id, None)
        kind = PhaseLedger._kind_of(trace.root.name)
        if kind is None:
            return
        by_id = {s.span_id: s for s in trace.spans}
        child_dur: Dict[int, float] = {}
        for s in trace.spans:
            if s.parent_id is not None:
                child_dur[s.parent_id] = (child_dur.get(s.parent_id, 0.0)
                                          + s.duration)

        def resolve(span: Span) -> Optional[str]:
            st = _stage_of(span, trace)
            node = span
            while st is None and node.parent_id is not None:
                node = by_id.get(node.parent_id)
                if node is None:
                    break
                st = _stage_of(node, trace)
            return None if st in (None, _GLUE) else st

        stage_ms: Dict[str, float] = {}
        stage_bytes: Dict[str, int] = {}
        for s in trace.spans:
            st = resolve(s)
            if st is None:
                continue
            self_ms = max(0.0, s.duration
                          - child_dur.get(s.span_id, 0.0)) * 1e3
            stage_ms[st] = stage_ms.get(st, 0.0) + self_ms
            if s.name in ("solve.device_put", "solve.catalog_put",
                          "solve.batch_pack"):
                stage_bytes[st] = stage_bytes.get(st, 0) \
                    + int(s.attrs.get("h2d_bytes", 0) or 0)
            elif s.name == "solve.readback":
                stage_bytes[st] = stage_bytes.get(st, 0) \
                    + int(s.attrs.get("d2h_bytes", 0) or 0)

        pending = pending or {}
        total_ms = sum(stage_ms.values())
        attributed = 0.0
        red_ms: Dict[str, float] = {}
        unattr_by_stage: Dict[str, float] = {}
        with self._lock:
            self.traces += 1
            for st, ms in stage_ms.items():
                wall = self._stage_wall.setdefault(st, [0.0, 0.0])
                wall[0] += ms
                mix = pending.get(st)
                mix_units = sum(mix.values()) if mix else 0
                if not mix_units:
                    wall[1] += ms
                    unattr_by_stage[st] = ms
                    continue
                attributed += ms
                for outcome, n in mix.items():
                    share = ms * (n / mix_units)
                    key = (st, outcome)
                    self._ms[key] = self._ms.get(key, 0.0) + share
                    if outcome == "redundant":
                        red_ms[st] = red_ms.get(st, 0.0) + share
                    b = stage_bytes.get(st, 0)
                    if b:
                        self._bytes[key] = self._bytes.get(key, 0) \
                            + int(b * (n / mix_units))
        from ..metrics import (RECOMPUTE_UNATTRIBUTED_MS,
                               REDUNDANT_WORK_MS)
        for st, ms in red_ms.items():
            REDUNDANT_WORK_MS.inc(ms, stage=st)
        for st, ms in unattr_by_stage.items():
            if ms:
                RECOMPUTE_UNATTRIBUTED_MS.inc(ms, stage=st)
        coverage = (attributed / total_ms) if total_ms > 0 else 1.0
        if coverage < self.coverage_target and total_ms > 0:
            self._flight_record_gap(trace, unattr_by_stage, coverage)

    def _flight_record_gap(self, trace: Trace,
                           unattr: Dict[str, float],
                           coverage: float) -> None:
        """The coverage invariant tripped for one trace: land a marker
        in the flight-recorder ring naming the unclassified stages, so
        the gap is diagnosable from /debug/traces without re-running.
        meter=False: a plane's self-marker must not move the overflow
        meters it coexists with (the chaos determinism contract)."""
        gap_ms = sum(unattr.values())
        marker = Span(
            name="recompute.unattributed",
            trace_id=f"recompgap-{trace.trace_id}", span_id=0,
            parent_id=None, t0=0.0, t1=gap_ms / 1e3,
            ts=trace.root.ts,
            attrs={"source_trace": trace.trace_id,
                   "gap_ms": round(gap_ms, 3),
                   "coverage": round(coverage, 4),
                   "stages": {s: round(ms, 3)
                              for s, ms in sorted(unattr.items())},
                   "root": trace.root.name})
        TRACER.recorder.offer(Trace(trace_id=marker.trace_id,
                                    spans=[marker]), meter=False)

    # --- read side ---------------------------------------------------------
    def stage_units(self) -> Dict[str, Dict[str, int]]:
        """stage -> outcome -> units, aggregated over tenants — what the
        watchdog's recompute_runaway monitor baselines at arm."""
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for (st, outcome), n in self._stage_units.items():
                out.setdefault(st, {})[outcome] = n
        return out

    def redundant_frac(self, stage: str) -> float:
        """redundant units / total units for one stage (0.0 when the
        stage has seen no work)."""
        with self._lock:
            total = red = 0
            for (_t, st, outcome), n in self._units.items():
                if st != stage:
                    continue
                total += n
                if outcome == "redundant":
                    red += n
        return red / total if total else 0.0

    def coverage(self) -> float:
        """Classified share of all traced taxonomy-stage wall (1.0 when
        nothing was traced)."""
        with self._lock:
            wall = sum(w for (w, _u) in self._stage_wall.values())
            unattr = sum(u for (_w, u) in self._stage_wall.values())
        return 1.0 if wall <= 0 else 1.0 - unattr / wall

    def unattributed_ms(self) -> float:
        with self._lock:
            return sum(u for (_w, u) in self._stage_wall.values())

    def snapshot(self) -> dict:
        """JSON-ready aggregate view — /debug/recompute and the bench
        c16 artifact body."""
        with self._lock:
            units: Dict[str, Dict[str, int]] = {}
            tenants: set = set()
            for (t, st, outcome), n in self._units.items():
                tenants.add(t)
                row = units.setdefault(st, {o: 0 for o in OUTCOMES})
                row[outcome] = row.get(outcome, 0) + n
            stages: Dict[str, dict] = {}
            for st in STAGES:
                row = units.get(st)
                if row is None and st not in self._stage_wall:
                    continue
                row = row or {o: 0 for o in OUTCOMES}
                total = sum(row.values())
                wall, unattr = self._stage_wall.get(st, (0.0, 0.0))
                # delta-serving savings estimate: each served unit is
                # priced at the stage's mean PAID (fresh + redundant)
                # per-unit wall — the work the delta plane did not redo
                served = row.get("delta_served", 0)
                paid_units = row.get("fresh", 0) + row.get("redundant", 0)
                paid_ms = (self._ms.get((st, "fresh"), 0.0)
                           + self._ms.get((st, "redundant"), 0.0))
                saved_ms = (served * paid_ms / paid_units
                            if paid_units else 0.0)
                stages[st] = {
                    "units": dict(row),
                    "redundant_frac": round(
                        row.get("redundant", 0) / total, 4) if total
                    else 0.0,
                    "served_frac": round(served / total, 4) if total
                    else 0.0,
                    "saved_ms_est": round(saved_ms, 3),
                    "ms": {o: round(self._ms.get((st, o), 0.0), 3)
                           for o in OUTCOMES},
                    "bytes": {o: int(self._bytes.get((st, o), 0))
                              for o in OUTCOMES},
                    "wall_ms": round(wall, 3),
                    "unattributed_ms": round(unattr, 3),
                }
            wall = sum(w for (w, _u) in self._stage_wall.values())
            unattr = sum(u for (_w, u) in self._stage_wall.values())
            return {
                "stages": stages,
                "coverage": round(1.0 - (unattr / wall if wall > 0
                                         else 0.0), 4),
                "unattributed_ms": round(unattr, 3),
                "taxonomy": list(STAGES),
                "outcomes": list(OUTCOMES),
                "tenants": sorted(tenants),
                "seen_cap": self.seen_cap,
                "traces": self.traces,
                "errors": self.errors,
            }

    def payload(self, query: str = "") -> dict:
        return self.snapshot()

    def report(self) -> str:
        return format_report(self.snapshot())

    def reset(self) -> None:
        with self._lock:
            self._units.clear()
            self._stage_units.clear()
            self._seen.clear()
            self._pending.clear()
            self._ms.clear()
            self._bytes.clear()
            self._stage_wall.clear()
            self.traces = 0
            self.errors = 0


def format_report(snapshot: dict) -> str:
    """The `make recompute-report` table: per stage, the outcome unit
    split, the redundant fraction, the redundant wall (the headroom the
    delta plane spends), and the estimated wall the delta-served units
    did NOT pay (served units priced at the stage's mean paid
    per-unit cost)."""
    out: List[str] = []
    stages = snapshot.get("stages", {})
    if not stages:
        return ("recompute report: no work classified yet (drive a few "
                "reconciles first)")
    out.append("recompute observatory — who redoes identical work")
    out.append(f"  {'stage':<10} {'units':>9} {'fresh':>9} "
               f"{'redundant':>9} {'served':>9} {'red%':>7} "
               f"{'red ms':>10} {'saved ms':>10} {'gap ms':>9}")
    out.append("  " + "-" * 88)
    tot_red_ms = tot_gap = tot_saved = 0.0
    for st in snapshot.get("taxonomy", sorted(stages)):
        row = stages.get(st)
        if row is None:
            out.append(f"  {st:<10} {'-':>9}  (no work observed)")
            continue
        u = row["units"]
        total = sum(u.values())
        red_ms = row["ms"].get("redundant", 0.0)
        saved_ms = row.get("saved_ms_est", 0.0)
        tot_red_ms += red_ms
        tot_saved += saved_ms
        tot_gap += row["unattributed_ms"]
        out.append(
            f"  {st:<10} {total:>9,} {u.get('fresh', 0):>9,} "
            f"{u.get('redundant', 0):>9,} "
            f"{u.get('delta_served', 0):>9,} "
            f"{100.0 * row['redundant_frac']:>6.1f}% "
            f"{red_ms:>10.3f} {saved_ms:>10.3f} "
            f"{row['unattributed_ms']:>9.3f}")
    out.append("  " + "-" * 88)
    out.append(f"  coverage {snapshot.get('coverage', 1.0):.4f} "
               f"(target {COVERAGE_TARGET:g}) | redundant wall "
               f"{tot_red_ms:.3f}ms — the measured headroom | served "
               f"saved ~{tot_saved:.3f}ms | unattributed {tot_gap:.3f}ms")
    if snapshot.get("errors"):
        out.append(f"  WARNING: {snapshot['errors']} trace(s) failed to "
                   "ingest")
    return "\n".join(out)


# THE process-wide ledger, installed as a tracer sink at import (the
# sink only fires while tracing is enabled; classification counters are
# plain dict updates otherwise).
RECOMPUTE = RecomputeLedger()
TRACER.add_sink(RECOMPUTE.ingest)

from .exposition import register_debug_route  # noqa: E402 (after RECOMPUTE)

register_debug_route("/debug/recompute",
                     lambda ledger, query: ledger.payload(query),
                     owner=RECOMPUTE)
