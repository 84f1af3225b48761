"""Cross-run perf archive + regression gate: run artifacts, read back.

The port's own copy of `karpenter_tpu/obs/perfarchive.py`, unchanged in
semantics (the port imports nothing of the JAX package), with families of
the port's own.

- **PerfArchive**: a JSONL run ledger (`perf_archive.jsonl`, or
  `$KARPENTER_TPU_PERF_ARCHIVE`). Each record is one run keyed by
  (run_id, family) carrying its producer's provenance stamp
  (`ops/solver.provenance()`) and the comparable flag. Loading
  BOOTSTRAPS from the checked-in legacy `BENCH_r*.json` /
  `MULTICHIP_r*.json` wrappers of the JAX package's TPU rounds (families
  `bench` and `mesh`), so their trajectory renders without a migration
  step; runs without stamps are ingested with `stamped=False` and a
  comparability inferred from their platform marker.
- **Families**: `bench` and `mesh` are the JAX package's TPU history;
  `torch` (one card) and `torch-mesh` (a mesh) are the port's. Baselines
  and candidates never cross families, so a TPU-era record never enters
  a baseline of the port. The port's producers stamp `comparable`
  explicitly (`run_stamp`: not `cpu_fallback`), so a CPU run of the port
  never judges and is never judged.
- **Baselines**: per metric, median + MAD over COMPARABLE runs only.
- **The gate** (`python -m karpenter_tpu_torch.obs.perf_gate`): the
  newest STAMPED comparable run of a family is the candidate; each of its
  metrics is judged against the baseline of every other STAMPED
  comparable run of that family (legacy history renders in the
  trajectory but never judges). A regression verdict needs BOTH a
  relative breach (>= GATE_RATIO of the median, directional: `_ms` keys
  are lower-better, `_per_sec`/rate/speedup keys higher-better) AND a
  dispersion breach (>= GATE_K scaled-MADs beyond the median, MAD floored
  at MAD_FLOOR of the median so a dead-stable baseline still tolerates
  timer noise). A 1.5x latency regression trips both; an identical re-run
  trips neither. No stamped candidate gates nothing and passes.
"""

from __future__ import annotations

import glob
import json
import os
import re
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SCHEMA_VERSION = 1
# the JAX package's TPU history (bootstrapped) and the port's own runs
FAMILIES = ("bench", "mesh", "torch", "torch-mesh")
ARCHIVE_ENV = "KARPENTER_TPU_PERF_ARCHIVE"
ARCHIVE_NAME = "perf_archive.jsonl"

# gate thresholds (see module docstring): both must breach to flag
GATE_RATIO = 1.30     # relative breach vs the baseline median
GATE_K = 4.0          # scaled-MADs beyond the median
MAD_FLOOR = 0.02      # MAD floor as a fraction of the median
MIN_BASELINE = 2      # metrics with fewer comparable samples inform only

# metric-name direction classification; keys matching neither are
# informational (counts, booleans, ids) and never gate
_LOWER_BETTER = re.compile(
    r"(_ms|_ms_p\d+|headline_ms|_bytes|_watermark\w*|_overhead_frac)$")
_HIGHER_BETTER = re.compile(
    r"(_per_sec|_speedup|_vs_serial(_persistent)?|hit_rate|vs_baseline|"
    r"_cover(age)?|kernel_vs_native_cpp|pods_per_sec|_savings_total|"
    r"_detection_rate)$")
# informational regardless of suffix: the upload-redundancy fraction is
# a MEASUREMENT of delta-upload headroom, not a performance quantity —
# a workload-mix change moving it must never fail the gate in either
# direction (checked BEFORE the suffix rules: `_frac` isn't a latency).
# `*_rows_frac` (the resident patch-density measurement) is the same
# kind of quantity: churn in the workload moves it, the code does not.
# `*_shed_frac` (the c13 soak regime's admission-control drop rate) is a
# WORKLOAD property too — the scenario chooses how far past saturation
# it drives, so neither direction is a code regression; the gated soak
# quantities are the `*_arrivals_per_sec` throughput keys (higher-better
# via the `_per_sec` rule below). `integrity_*_total` keys are verdict
# COUNTS (how many checks ran/violated in a regime) — workload-shaped,
# informational; the gated integrity quantities are
# `c3_integrity_overhead_frac` (lower-better: the oracle's share of
# solve wall) and `c15_sdc_detection_rate` (higher-better: injected
# corruptions caught). `*_served_frac` (the c16 delta-plane serve rate)
# is informational for the same reason as the redundancy fractions:
# how much of a regime's work is servable is a workload-mix property —
# the gated delta quantity is the reconcile latency the serving buys
# (`c16_full_reconcile_p50_ms`, lower-better via the `_ms` rule).
_NEVER_GATES = re.compile(
    r"(_redundant_frac|_rows_frac|_shed_frac|_served_frac|"
    r"integrity_\w*_total)$")


def metric_direction(key: str) -> Optional[str]:
    """'lower' / 'higher' / None (ungated). `*_bytes`/`*_watermark*`
    keys (device-memory footprint, transfer volume) are lower-better;
    `*_redundant_frac` / `*_rows_frac` are informational, never gated."""
    if _NEVER_GATES.search(key):
        return None
    if _LOWER_BETTER.search(key):
        return "lower"
    if _HIGHER_BETTER.search(key):
        return "higher"
    return None


@dataclass
class RunRecord:
    run_id: str
    family: str                      # one of FAMILIES
    source: str                      # file / producer the run came from
    schema_version: int              # 0 = legacy (pre-stamp) ingest
    comparable: Optional[bool]       # None = unknowable (treated False)
    provenance: Dict[str, object] = field(default_factory=dict)
    seed: Optional[int] = None
    metrics: Dict[str, float] = field(default_factory=dict)

    @property
    def stamped(self) -> bool:
        return self.schema_version >= 1

    def to_dict(self) -> dict:
        return {"run_id": self.run_id, "family": self.family,
                "source": self.source,
                "schema_version": self.schema_version,
                "comparable": self.comparable,
                "provenance": self.provenance, "seed": self.seed,
                "metrics": self.metrics}

    @classmethod
    def from_dict(cls, d: dict) -> "RunRecord":
        return cls(run_id=str(d.get("run_id", "")),
                   family=str(d.get("family", "bench")),
                   source=str(d.get("source", "")),
                   schema_version=int(d.get("schema_version", 0)),
                   comparable=d.get("comparable"),
                   provenance=dict(d.get("provenance") or {}),
                   seed=d.get("seed"),
                   metrics={k: float(v)
                            for k, v in (d.get("metrics") or {}).items()
                            if isinstance(v, (int, float))
                            and not isinstance(v, bool)})


@dataclass
class Verdict:
    metric: str
    status: str            # "pass" | "regression" | "improvement" |
    #                        "insufficient-baseline"
    value: float
    median: float
    mad: float
    n: int
    ratio: float
    direction: str

    def line(self) -> str:
        return (f"{self.status:<22} {self.metric:<38} "
                f"value={self.value:g} median={self.median:g} "
                f"(n={self.n}, x{self.ratio:.2f})")


@dataclass
class GateReport:
    candidate: Optional[str]         # run_id, None = nothing to gate
    reason: str
    verdicts: List[Verdict] = field(default_factory=list)

    @property
    def regressions(self) -> List[Verdict]:
        return [v for v in self.verdicts if v.status == "regression"]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def summary(self) -> str:
        lines = [f"perf-gate: candidate={self.candidate or '-'} "
                 f"({self.reason})"]
        awaiting = []
        for v in sorted(self.verdicts,
                        key=lambda v: (v.status != "regression",
                                       v.metric)):
            if v.status == "insufficient-baseline":
                awaiting.append(v)
            elif v.status != "pass":
                lines.append("  " + v.line())
        gated = [v for v in self.verdicts
                 if v.status in ("pass", "regression", "improvement")]
        if awaiting:
            # keys too new to gate — surfaced explicitly instead of
            # silently skipped: a metric stuck here across many runs
            # means its earlier runs weren't comparable (or the key was
            # renamed) and nothing will ever gate it
            lines.append(f"  awaiting first comparable run "
                         f"({len(awaiting)} metric(s) with no gateable "
                         f"baseline yet — they gate once a second "
                         f"comparable run lands):")
            for v in awaiting:
                lines.append(f"    {v.metric:<38} value={v.value:g} "
                             f"(baseline n={v.n})")
        lines.append(f"  {len(gated)} metric(s) gated, "
                     f"{len(self.regressions)} regression(s)")
        lines.append("perf-gate: " + ("PASS" if self.ok else "FAIL"))
        return "\n".join(lines)


def _infer_comparable(parsed: dict, detail: dict) -> Optional[bool]:
    """Legacy comparability: an explicit flag wins; else the platform
    marker; else the run predates provenance stamping entirely — the
    TPU era, comparable (BENCH_r01..r04)."""
    if isinstance(parsed.get("comparable"), bool):
        return parsed["comparable"]
    prov = parsed.get("provenance") or {}
    platform = prov.get("platform") or detail.get("platform")
    if platform is not None:
        return platform == "accelerator"
    return True


def _flatten_metrics(parsed: dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    v = parsed.get("value")
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        out["headline_ms"] = float(v)
    vb = parsed.get("vs_baseline")
    if isinstance(vb, (int, float)) and not isinstance(vb, bool):
        out["vs_baseline"] = float(vb)
    for k, val in (parsed.get("detail") or {}).items():
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[k] = float(val)
    return out


def run_stamp(prov: dict, seed: int = 0) -> dict:
    """The stamp a producer of the port writes into its result:
    schema_version, a fresh run_id, the seed its workload was made from,
    its provenance (`ops/solver.provenance()`) and `comparable`, which is
    True only for a run on a card (not `cpu_fallback`)."""
    import uuid
    return {"schema_version": SCHEMA_VERSION,
            "run_id": uuid.uuid4().hex[:12], "seed": seed,
            "provenance": prov,
            "comparable": not prov.get("cpu_fallback", True)}

class PerfArchive:
    """The run ledger. `path` is the JSONL file; `root` the directory
    scanned for legacy artifact wrappers (defaults to path's dir)."""

    def __init__(self, path: Optional[str] = None,
                 root: Optional[str] = None):
        if path is None:
            path = os.environ.get(ARCHIVE_ENV) or os.path.join(
                root or os.getcwd(), ARCHIVE_NAME)
        self.path = path
        self.root = root or os.path.dirname(os.path.abspath(path))

    @classmethod
    def default(cls) -> "PerfArchive":
        """The repo-root archive."""
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        return cls(os.environ.get(ARCHIVE_ENV)
                   or os.path.join(here, ARCHIVE_NAME), root=here)

    # --- ingestion --------------------------------------------------------
    def ingest_bench_result(self, result: dict, family: str = "bench",
                            source: str = "bench.py") -> RunRecord:
        """One producer-side run -> RunRecord (already-stamped results
        carry their own run_id/seed/provenance)."""
        detail = result.get("detail") or {}
        return RunRecord(
            run_id=str(result.get("run_id")
                       or f"unstamped:{source}"),
            family=family, source=source,
            schema_version=int(result.get("schema_version", 0)),
            comparable=_infer_comparable(result, detail),
            provenance=dict(result.get("provenance") or {}),
            seed=result.get("seed"),
            metrics=_flatten_metrics(result))

    def append(self, record: RunRecord) -> RunRecord:
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record.to_dict(), sort_keys=True) + "\n")
        return record

    def _bootstrap(self) -> List[RunRecord]:
        """The checked-in legacy wrappers ({n, cmd, rc, tail, parsed})
        the bench archives per round."""
        runs: List[RunRecord] = []
        for pattern, family in (("BENCH_r*.json", "bench"),
                                ("MULTICHIP_r*.json", "mesh")):
            for fp in sorted(glob.glob(os.path.join(self.root, pattern))):
                name = os.path.basename(fp)
                try:
                    with open(fp, "r", encoding="utf-8") as f:
                        doc = json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue
                parsed = doc.get("parsed")
                if parsed is None and "detail" in doc:
                    parsed = doc  # a bare result file, not a wrapper
                if not isinstance(parsed, dict):
                    # mesh wrappers carry no parsed metrics — record the
                    # run for the trajectory (rc/ok) without gate input
                    runs.append(RunRecord(
                        run_id=f"legacy:{name}", family=family,
                        source=name, schema_version=0,
                        comparable=bool(doc.get("ok", doc.get("rc") == 0)),
                        metrics={}))
                    continue
                rec = self.ingest_bench_result(parsed, family=family,
                                               source=name)
                if not rec.stamped:
                    rec.run_id = f"legacy:{name}"
                runs.append(rec)
        return runs

    def load(self) -> List[RunRecord]:
        """Legacy bootstrap + the JSONL ledger, deduped by run_id (the
        ledger wins — a stamped re-ingest of a legacy run supersedes
        it). Order: bootstrap files sorted, then ledger append order —
        'newest last' is the candidate-selection order."""
        runs = self._bootstrap()
        if os.path.exists(self.path):
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        runs.append(RunRecord.from_dict(json.loads(line)))
                    except (json.JSONDecodeError, TypeError, ValueError):
                        continue  # truncated tail tolerant, like the WAL
        seen: Dict[str, int] = {}
        out: List[RunRecord] = []
        for rec in runs:
            if rec.run_id in seen:
                out[seen[rec.run_id]] = rec
                continue
            seen[rec.run_id] = len(out)
            out.append(rec)
        return out

    # --- baselines --------------------------------------------------------
    @staticmethod
    def baselines(runs: List[RunRecord], family: str = "bench",
                  exclude: Optional[str] = None,
                  stamped_only: bool = False
                  ) -> Dict[str, Dict[str, float]]:
        """metric -> {median, mad, n} over COMPARABLE runs of the family
        (optionally excluding one run_id — the candidate judges itself
        against everyone else). Non-comparable runs never contribute.
        `stamped_only` additionally drops legacy (pre-stamp) runs: the
        GATE uses this, because metric semantics drifted between legacy
        rounds (r03's c3_encode_50k_ms measured a different thing than
        r04's) and judging a new run against mixed-era baselines
        manufactures false regressions — legacy history renders in the
        trajectory, it never judges."""
        series: Dict[str, List[float]] = {}
        for rec in runs:
            if rec.family != family or not rec.comparable:
                continue
            if stamped_only and not rec.stamped:
                continue
            if exclude is not None and rec.run_id == exclude:
                continue
            for k, v in rec.metrics.items():
                series.setdefault(k, []).append(v)
        out: Dict[str, Dict[str, float]] = {}
        for k, vals in series.items():
            med = statistics.median(vals)
            mad = statistics.median([abs(v - med) for v in vals]) \
                if len(vals) > 1 else 0.0
            out[k] = {"median": med, "mad": mad, "n": len(vals)}
        return out

    # --- the gate ---------------------------------------------------------
    def gate(self, runs: Optional[List[RunRecord]] = None,
             candidate: Optional[str] = None,
             family: str = "bench") -> GateReport:
        runs = self.load() if runs is None else runs
        cand: Optional[RunRecord] = None
        if candidate is not None:
            cand = next((r for r in runs if r.run_id == candidate), None)
            if cand is None:
                return GateReport(candidate=candidate,
                                  reason="candidate not in archive")
        else:
            for rec in reversed(runs):
                if rec.family == family and rec.stamped and rec.comparable:
                    cand = rec
                    break
        if cand is None:
            return GateReport(
                candidate=None,
                reason="no stamped comparable run to gate — trajectory "
                       "only (run `make benchmark` to mint one)")
        if not cand.comparable:
            return GateReport(
                candidate=cand.run_id,
                reason=f"candidate is non-comparable "
                       f"({cand.provenance.get('platform', 'unknown')}) — "
                       f"not gated, never baselined")
        base = self.baselines(runs, family=cand.family,
                              exclude=cand.run_id, stamped_only=True)
        verdicts: List[Verdict] = []
        for key, value in sorted(cand.metrics.items()):
            direction = metric_direction(key)
            if direction is None:
                continue
            b = base.get(key)
            if b is None or b["n"] < MIN_BASELINE:
                verdicts.append(Verdict(
                    metric=key, status="insufficient-baseline",
                    value=value, median=b["median"] if b else value,
                    mad=b["mad"] if b else 0.0, n=b["n"] if b else 0,
                    ratio=1.0, direction=direction))
                continue
            med, mad = b["median"], b["mad"]
            madn = max(1.4826 * mad, MAD_FLOOR * abs(med))
            if med == 0:
                continue
            if direction == "lower":
                regressed = (value > med * GATE_RATIO
                             and value > med + GATE_K * madn)
                improved = value < med / GATE_RATIO
                ratio = value / med
            else:
                regressed = (value < med / GATE_RATIO
                             and value < med - GATE_K * madn)
                improved = value > med * GATE_RATIO
                ratio = value / med
            status = ("regression" if regressed
                      else "improvement" if improved else "pass")
            verdicts.append(Verdict(metric=key, status=status, value=value,
                                    median=med, mad=mad, n=b["n"],
                                    ratio=ratio, direction=direction))
        return GateReport(candidate=cand.run_id,
                          reason=f"newest stamped comparable "
                                 f"{cand.family} run ({cand.source})",
                          verdicts=verdicts)

    # --- trajectory -------------------------------------------------------
    def trajectory(self, runs: Optional[List[RunRecord]] = None,
                   family: str = "bench",
                   keys: Optional[List[str]] = None) -> str:
        """The BENCH_r01..rN table: headline keys across every run, with
        the comparable flag — the at-a-glance view the r05 pollution
        needed."""
        runs = self.load() if runs is None else runs
        rows = [r for r in runs if r.family == family]
        if not rows:
            return f"perf archive: no {family} runs"
        if keys is None:
            keys = ["headline_ms", "c5_kernel_device_ms",
                    "host_ffd_100k_ms", "warm_admit_p50_ms",
                    "encode_cached_ms", "fleet_solves_per_sec"]
            keys = [k for k in keys
                    if any(k in r.metrics for r in rows)]
        out = [f"perf trajectory — family={family} "
               f"({len(rows)} runs, {sum(1 for r in rows if r.comparable)}"
               f" comparable)"]
        head = f"  {'run':<22} {'cmp':<4}" + "".join(
            f" {k[:18]:>19}" for k in keys)
        out.append(head)
        out.append("  " + "-" * (len(head) - 2))
        for r in rows:
            cells = "".join(
                f" {r.metrics.get(k, float('nan')):>19g}"
                if k in r.metrics else f" {'-':>19}" for k in keys)
            out.append(f"  {r.run_id[:22]:<22} "
                       f"{'yes' if r.comparable else 'NO':<4}{cells}")
        return "\n".join(out)
