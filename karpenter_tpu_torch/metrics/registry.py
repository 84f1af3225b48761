"""Minimal Prometheus-style metrics registry.

Mirrors the reference's metric surface (website/docs reference/metrics.md
catalogs ~19 groups: nodeclaims, pods, scheduler durations, disruption
decisions, cloudprovider offering gauges, batcher histograms...). No
external client dependency; text exposition matches the Prometheus format
so a scraper can consume `registry.expose()` verbatim — with one caveat:
histogram exemplars (`# {trace_id="..."} v` suffixes) are an OpenMetrics
feature the classic 0.0.4 text parser rejects, so the HTTP exposition
layer content-negotiates (obs/exposition.py): strict 0.0.4 via
`expose(exemplars=False)` by default, the exemplar-bearing OpenMetrics
document only for scrapers sending `Accept: application/openmetrics-text`.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str],
                 label_defaults: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        # per-label fallback values: a label omitted by BOTH the writer
        # and the reader resolves to its default, so retrofitting a
        # dimension (e.g. `tenant` on the hot-path families) keeps every
        # existing unlabeled inc()/value() call on one coherent series
        # instead of splitting writes ("default") from reads (""). A
        # callable default is resolved per sample — how the fleet's
        # tenant scope attributes shard samples without touching any
        # call site (metrics/tenant.py)
        self.label_defaults = dict(label_defaults or {})
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        out = []
        for k in self.label_names:
            v = labels.get(k)
            if v is None:
                v = self.label_defaults.get(k, "")
                if callable(v):
                    v = v()
            out.append(str(v))
        return tuple(out)

    def _fmt_labels(self, key: Tuple[str, ...]) -> str:
        if not self.label_names:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in zip(self.label_names, key))
        return "{" + inner + "}"


class Counter(_Metric):
    def __init__(self, name, help_, label_names=(), label_defaults=None):
        super().__init__(name, help_, label_names, label_defaults)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def sum(self, **labels) -> float:
        """Sum over every series matching the given label SUBSET (an
        omitted label matches all its values) — the aggregation the SLO
        indicators need over multi-dimensional families (e.g. all
        `warmpath_decisions_total` paths of one tenant). Unlike value(),
        omitted labels do NOT resolve through defaults here."""
        idx = {k: i for i, k in enumerate(self.label_names)}
        want = {idx[k]: str(v) for k, v in labels.items()}
        with self._lock:
            return sum(v for k, v in self._values.items()
                       if all(k[i] == s for i, s in want.items()))

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for k, v in sorted(self._values.items()):
            out.append(f"{self.name}{self._fmt_labels(k)} {v:g}")
        return out


class Gauge(_Metric):
    def __init__(self, name, help_, label_names=(), label_defaults=None):
        super().__init__(name, help_, label_names, label_defaults)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for k, v in sorted(self._values.items()):
            out.append(f"{self.name}{self._fmt_labels(k)} {v:g}")
        return out


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram(_Metric):
    def __init__(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS,
                 label_defaults=None):
        super().__init__(name, help_, label_names, label_defaults)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}
        # (labelset, bucket_index) -> (trace_id, value): last exemplar per
        # bucket, OpenMetrics-style — a fat latency bucket points at a
        # captured trace in the flight recorder
        self._exemplars: Dict[Tuple[Tuple[str, ...], int],
                              Tuple[str, float]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        """exemplar: a trace id to pin to the bucket this value lands in
        (e.g. obs.TRACER.current_trace_id()); None leaves exemplars
        untouched."""
        with self._lock:
            k = self._key(labels)
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            for j in range(i, len(self.buckets)):
                counts[j] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1
            if exemplar is not None:
                self._exemplars[(k, min(i, len(self.buckets)))] = (
                    str(exemplar), value)

    def total(self, **labels) -> int:
        """Observation count for a label set (the `_count` series)."""
        return self._totals.get(self._key(labels), 0)

    def cumulative_le(self, le: float, **labels) -> int:
        """Observations ≤ `le` for a label set — bucket counts are
        CDF-style, so this is one lookup. `le` snaps DOWN to the nearest
        bucket bound (a threshold between buckets under-counts rather
        than over-counts good events — conservative for SLOs)."""
        counts = self._counts.get(self._key(labels))
        if not counts:
            return 0
        i = bisect.bisect_right(self.buckets, le) - 1
        return counts[i] if i >= 0 else 0

    def percentile(self, q: float, **labels) -> Optional[float]:
        k = self._key(labels)
        total = self._totals.get(k, 0)
        if not total:
            return None
        counts = self._counts[k]
        target = q * total
        for b, c in zip(self.buckets, counts):
            if c >= target:
                return b
        return self.buckets[-1]

    def expose(self, exemplars: bool = True) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for k in sorted(self._totals):
            labels = self._fmt_labels(k)
            base = labels[1:-1] if labels else ""
            for i, (b, c) in enumerate(zip(self.buckets, self._counts[k])):
                sep = "," if base else ""
                line = f'{self.name}_bucket{{{base}{sep}le="{b:g}"}} {c}'
                ex = self._exemplars.get((k, i)) if exemplars else None
                if ex is not None:
                    # OpenMetrics exemplar syntax: the trace id a sample
                    # in this bucket came from
                    line += f' # {{trace_id="{ex[0]}"}} {ex[1]:g}'
                out.append(line)
            inf_line = (f'{self.name}_bucket{{{base}{"," if base else ""}'
                        f'le="+Inf"}} {self._totals[k]}')
            ex = (self._exemplars.get((k, len(self.buckets)))
                  if exemplars else None)
            if ex is not None:
                inf_line += f' # {{trace_id="{ex[0]}"}} {ex[1]:g}'
            out.append(inf_line)
            out.append(f"{self.name}_sum{labels} {self._sums[k]:g}")
            out.append(f"{self.name}_count{labels} {self._totals[k]}")
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: List[_Metric] = []

    def counter(self, name, help_, label_names=(),
                label_defaults=None) -> Counter:
        m = Counter(name, help_, label_names, label_defaults)
        self._metrics.append(m)
        return m

    def gauge(self, name, help_, label_names=(),
              label_defaults=None) -> Gauge:
        m = Gauge(name, help_, label_names, label_defaults)
        self._metrics.append(m)
        return m

    def histogram(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS,
                  label_defaults=None) -> Histogram:
        m = Histogram(name, help_, label_names, buckets, label_defaults)
        self._metrics.append(m)
        return m

    def expose(self, exemplars: bool = True) -> str:
        """exemplars=False renders a strictly Prometheus-0.0.4 document
        (the classic parser reads exemplar suffixes as a malformed
        timestamp and rejects the whole scrape); the default keeps them,
        and the HTTP layer advertises the OpenMetrics content type."""
        lines: List[str] = []
        for m in self._metrics:
            if isinstance(m, Histogram):
                lines.extend(m.expose(exemplars=exemplars))
            else:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"
