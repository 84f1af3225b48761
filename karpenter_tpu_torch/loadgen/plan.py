"""LoadPlan: seeded, declarative, replayable OPEN-LOOP traffic.

The port's own copy of `karpenter_tpu/loadgen/plan.py`, semantics unchanged.

The workload analog of `faults.plan.FaultPlan`, built to the same
contract: one plan = one seed + a list of rules; every probabilistic
decision draws from the plan's single `random.Random(seed)` at
MATERIALIZATION time (the schedule is fully computed before the first
tick, so runtime admission decisions can never perturb the draw
sequence); every emitted/offered/shed/deferred event is appended to
`timeline` as a CANONICAL entry. Same seed + same rules ⇒ byte-identical
schedule, timeline, and fingerprint — the reproducibility contract the
soak determinism tests assert (`--repeat 2` on any soak scenario).

The crucial difference from every existing load runner: arrivals are
OPEN-LOOP. The chaos/fleet runners' workloads wait for the system to
drain before the run can end; a LoadPlan's schedule fires on the shared
FakeClock whether or not the control plane has kept up — which is the
only regime that exposes saturation behavior (Gavel's and Tesserae's
trace-driven evaluations, PAPERS.md). What bounds the backlog is not
the generator but the admission controller the offers route through
(fleet/service.AdmissionController).

Arrival-process rules (any mix per plan):

- `PoissonArrivals` — homogeneous Poisson: exponential inter-arrival
  gaps at `rate` batches/sec over [t0, t1).
- `DiurnalArrivals` — inhomogeneous Poisson by thinning: intensity
  swings sinusoidally around `rate` with `amplitude` over `period`
  (the day/night traffic curve, compressed to sim scale).
- `BurstyArrivals` — a storm train: every `every` seconds (jittered),
  a burst of `burst` batches lands at once — the thundering-herd shape
  the DRR scheduler and admission budgets have to absorb.
- `TraceReplay` — verbatim (t, pods, cpu, mem) entries, from an inline
  tuple list or a JSONL trace file (`load_trace`/`save_trace`), the
  replay-a-production-trace mode.

Weather overlays (capacity-side traffic, not pod-side):

- `SpotWeather` — seeded spot-capacity fronts: recurring IceWindow
  spells over the spot tier, the "spot market dried up this hour"
  overlay; optionally a reclaim squall (InterruptionBurst) as each
  front opens.
- `IceWeather` — zone-scoped ICE spells against any capacity type —
  the stockout weather a long soak must fly through.

Overlays EXPAND into the existing `faults.plan` rule machinery
(IceWindow / InterruptionBurst) via `weather_rules()`, drawn from the
same plan RNG during materialization — so a soak shard arms them on its
ordinary tenant FaultPlan and every fault lands on the fault timeline
exactly like hand-written chaos rules.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

# pods-per-arrival-batch default shapes (cpu, mem) — modest requests so
# saturation comes from ARRIVAL RATE x weather, not giant pods
DEFAULT_CPU = "250m"
DEFAULT_MEM = "512Mi"


@dataclass(frozen=True)
class Arrival:
    """One materialized arrival batch on the canonical schedule. `t` is
    run-relative sim time; `key` is the plan-unique batch id (stable
    across repeats — it seeds the admission backoff jitter and names
    the ledger entries)."""

    t: float
    key: str
    pods: int
    cpu: str
    mem: str
    process: str              # poisson | diurnal | bursty | trace


@dataclass(frozen=True)
class PoissonArrivals:
    """`rate` batches/sec with exponential gaps over [t0, t1); each
    batch carries pods_min..pods_max pods (uniform draw)."""

    rate: float
    t0: float = 0.0
    t1: float = 60.0
    pods_min: int = 1
    pods_max: int = 4
    cpu: str = DEFAULT_CPU
    mem: str = DEFAULT_MEM


@dataclass(frozen=True)
class DiurnalArrivals:
    """Inhomogeneous Poisson by thinning: intensity
    rate * (1 + amplitude*sin(2*pi*(t-t0)/period)) over [t0, t1)."""

    rate: float
    amplitude: float = 0.5    # 0..1; peak = rate*(1+a), trough = rate*(1-a)
    period: float = 120.0
    t0: float = 0.0
    t1: float = 240.0
    pods_min: int = 1
    pods_max: int = 4
    cpu: str = DEFAULT_CPU
    mem: str = DEFAULT_MEM


@dataclass(frozen=True)
class BurstyArrivals:
    """Every ~`every` seconds (+-jitter), `burst` batches land at the
    same instant — the herd the fair queue and budgets must absorb."""

    every: float
    burst: int = 8
    jitter: float = 0.25      # fraction of `every` the gap may swing
    t0: float = 0.0
    t1: float = 120.0
    pods_min: int = 2
    pods_max: int = 6
    cpu: str = DEFAULT_CPU
    mem: str = DEFAULT_MEM


@dataclass(frozen=True)
class TraceReplay:
    """Verbatim entries: (t, pods, cpu, mem) tuples, run-relative."""

    entries: Tuple[Tuple[float, int, str, str], ...]


@dataclass(frozen=True)
class SpotWeather:
    """Recurring spot-capacity fronts over [t0, t1): each front is an
    IceWindow(capacity_type="spot") lasting ~`duration` (jittered),
    arriving every ~`every` seconds; `reclaim` > 0 additionally fires an
    InterruptionBurst of that many spot reclaims as each front opens
    (the market taking back what it sold)."""

    t0: float = 0.0
    t1: float = 300.0
    every: float = 120.0
    duration: float = 45.0
    jitter: float = 0.25
    reclaim: int = 0
    zone: Optional[str] = None


@dataclass(frozen=True)
class IceWeather:
    """Zone-scoped stockout spells against `capacity_type` (None = all)
    over [t0, t1), arriving every ~`every` seconds for ~`duration`."""

    t0: float = 0.0
    t1: float = 300.0
    every: float = 150.0
    duration: float = 60.0
    jitter: float = 0.25
    zone: Optional[str] = None
    instance_type: Optional[str] = None
    capacity_type: Optional[str] = None


def save_trace(path: str, entries: Sequence[Tuple[float, int, str, str]]
               ) -> None:
    """Write a replayable JSONL trace: one {"t","pods","cpu","mem"} per
    line — the interchange format `TraceReplay`/`load_trace` read."""
    with open(path, "w") as f:
        for t, pods, cpu, mem in entries:
            f.write(json.dumps({"t": round(float(t), 6), "pods": int(pods),
                                "cpu": cpu, "mem": mem}) + "\n")


def load_trace(path: str) -> TraceReplay:
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            entries.append((float(d["t"]), int(d["pods"]),
                            str(d.get("cpu", DEFAULT_CPU)),
                            str(d.get("mem", DEFAULT_MEM))))
    return TraceReplay(entries=tuple(sorted(entries)))


class LoadPlan:
    """Seeded schedule + canonical traffic ledger.

    `materialize()` (idempotent; called by the source at install) burns
    the plan RNG into a sorted arrival schedule and the weather-overlay
    fault rules. At runtime the source records every offered batch's
    fate on `timeline`; `fingerprint()` digests schedule + fates — the
    half of the soak repeat contract the fault fingerprint does not
    cover (two runs must agree on WHAT arrived and WHAT was shed, not
    just what faults fired)."""

    # draw-cap safety: an absurd rate x horizon cannot OOM the schedule
    MAX_ARRIVALS = 200_000

    def __init__(self, seed: int = 0, rules: Sequence[object] = ()):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.rules = list(rules)
        self.schedule: List[Arrival] = []
        self._weather: List[object] = []
        self._materialized = False
        # canonical (t, kind, detail) ledger, run-relative like the
        # FaultPlan's: kinds are arrive / admit / defer / shed
        self.timeline: List[Tuple[float, str, str]] = []
        self.origin = 0.0         # stamped when a source installs the plan

    # --- materialization --------------------------------------------------
    def materialize(self) -> "LoadPlan":
        if self._materialized:
            return self
        self._materialized = True
        arrivals: List[Tuple[float, int, str, str, str]] = []
        for r in self.rules:
            if isinstance(r, PoissonArrivals):
                self._gen_poisson(r, arrivals)
            elif isinstance(r, DiurnalArrivals):
                self._gen_diurnal(r, arrivals)
            elif isinstance(r, BurstyArrivals):
                self._gen_bursty(r, arrivals)
            elif isinstance(r, TraceReplay):
                for t, pods, cpu, mem in r.entries:
                    arrivals.append((float(t), int(pods), cpu, mem,
                                     "trace"))
            elif isinstance(r, (SpotWeather, IceWeather)):
                self._gen_weather(r)
            else:
                raise TypeError(f"unknown loadgen rule {type(r).__name__}")
        arrivals.sort(key=lambda a: (a[0], a[4], a[1]))
        self.schedule = [
            Arrival(t=round(t, 6), key=f"a{i:06d}", pods=pods, cpu=cpu,
                    mem=mem, process=proc)
            for i, (t, pods, cpu, mem, proc) in enumerate(arrivals)]
        return self

    def _cap(self, arrivals: List) -> bool:
        return len(arrivals) >= self.MAX_ARRIVALS

    def _gen_poisson(self, r: PoissonArrivals, out: List) -> None:
        t = r.t0
        while True:
            t += self.rng.expovariate(max(r.rate, 1e-9))
            if t >= r.t1 or self._cap(out):
                return
            out.append((t, self.rng.randint(r.pods_min, r.pods_max),
                        r.cpu, r.mem, "poisson"))

    def _gen_diurnal(self, r: DiurnalArrivals, out: List) -> None:
        peak = max(r.rate * (1.0 + abs(r.amplitude)), 1e-9)
        t = r.t0
        while True:
            t += self.rng.expovariate(peak)
            if t >= r.t1 or self._cap(out):
                return
            lam = r.rate * (1.0 + r.amplitude
                            * math.sin(2 * math.pi * (t - r.t0) / r.period))
            if self.rng.random() * peak >= max(lam, 0.0):
                continue  # thinned
            out.append((t, self.rng.randint(r.pods_min, r.pods_max),
                        r.cpu, r.mem, "diurnal"))

    def _gen_bursty(self, r: BurstyArrivals, out: List) -> None:
        t = r.t0
        while True:
            t += r.every * (1.0 + r.jitter * (2 * self.rng.random() - 1))
            if t >= r.t1 or self._cap(out):
                return
            for _ in range(r.burst):
                out.append((t, self.rng.randint(r.pods_min, r.pods_max),
                            r.cpu, r.mem, "bursty"))

    def _gen_weather(self, r) -> None:
        from ..faults.plan import IceWindow, InterruptionBurst
        t = r.t0
        while t < r.t1:
            gap = r.every * (1.0 + r.jitter * (2 * self.rng.random() - 1))
            dur = r.duration * (1.0 + r.jitter
                                * (2 * self.rng.random() - 1))
            w0 = round(t, 6)
            w1 = round(min(t + max(dur, 1.0), r.t1), 6)
            if isinstance(r, SpotWeather):
                self._weather.append(IceWindow(w0, w1, zone=r.zone,
                                               capacity_type="spot"))
                if r.reclaim > 0:
                    self._weather.append(InterruptionBurst(
                        at=w0, count=r.reclaim, kind="spot"))
            else:
                self._weather.append(IceWindow(
                    w0, w1, instance_type=r.instance_type, zone=r.zone,
                    capacity_type=r.capacity_type))
            t += max(gap, 1.0)

    def weather_rules(self) -> List[object]:
        """The expanded IceWindow/InterruptionBurst rules — merge these
        into the shard's FaultPlan rules so weather rides the existing
        fault machinery (and its fingerprint)."""
        self.materialize()
        return list(self._weather)

    @property
    def horizon(self) -> float:
        """Last scheduled arrival instant (run-relative) — the soak
        drive loop must stay open at least this long."""
        self.materialize()
        return self.schedule[-1].t if self.schedule else 0.0

    @property
    def total_pods(self) -> int:
        self.materialize()
        return sum(a.pods for a in self.schedule)

    # --- ledger -----------------------------------------------------------
    def record(self, now: float, kind: str, detail: str) -> None:
        """`now` is an absolute clock reading; stored run-relative like
        the FaultPlan ledger so repeats compare byte-for-byte."""
        self.timeline.append((round(float(now) - self.origin, 6), kind,
                              detail))

    def fingerprint(self) -> str:
        """Digest of the materialized schedule AND the runtime ledger:
        two runs with the same seed must agree on both (arrivals that
        were never offered — a run cut short — change the digest too,
        via the schedule half)."""
        self.materialize()
        h = hashlib.sha256()
        for a in self.schedule:
            h.update(f"S|{a.t:.6f}|{a.key}|{a.pods}|{a.cpu}|{a.mem}|"
                     f"{a.process}\n".encode())
        for t, kind, detail in self.timeline:
            h.update(f"L|{t:.6f}|{kind}|{detail}\n".encode())
        return h.hexdigest()

    def shed_defer_set(self) -> Tuple[Tuple[float, str, str], ...]:
        """The canonical shed/defer subset of the ledger — the
        determinism tests compare this across repeats directly (a
        human-readable witness when the fingerprint diverges)."""
        return tuple((t, k, d) for t, k, d in self.timeline
                     if k in ("shed", "defer"))
