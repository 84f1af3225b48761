"""Span-based tracing + solver flight recorder (the port's copy of
`karpenter_tpu/obs/tracer.py`).

The stage-level instrumentation CvxCluster/Tesserae attribute their wins
to (PAPERS.md): one trace per engine tick, nested spans for every stage
of the reconcile/solve hot path (batching, encode, device-put, compile,
dispatch, readback, bind, wire calls), exported as Chrome trace-event
JSON and JSONL, with a bounded in-memory ring of the N slowest traces so
a latency regression always has a captured decomposition to point at.

Design constraints, in order:

- **Zero overhead when disabled.** `TRACER.span()`/`trace()` return a
  shared no-op context manager after one attribute check; no objects are
  allocated, no clocks are read. The engine tick runs thousands of times
  per scale test — tracing must be invisible when off.
- **Sim-clock aware**, like metrics/durations.DurationRecorder: span
  durations always come from `time.perf_counter` (real compute time is
  what a flame graph decomposes), while each span ALSO stamps `ts` from
  an injectable clock (FakeClock in the sim), so a trace aligns with the
  simulated timeline that produced it.
- **One clock with the device trace.** The Chrome export can place
  spans on torch.profiler's clock (wall microseconds less the profile's
  `baseTimeNanoseconds`) through a (wall, perf_counter) anchor that
  `utils/profiling.maybe_trace` reads when its profiled block starts, so
  it writes the block's spans as a host track beside its kernels.
- **Nesting via contextvars**, so the same tracer is correct under the
  asyncio runtime and plain synchronous engines without thread-locals.

Env vars:
  KARPENTER_TPU_TRACE_DIR   when set, the tracer auto-enables and every
                            finished trace appends to <dir>/traces.jsonl
  KARPENTER_TPU_TRACE_RING  flight-recorder capacity (default 16)
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    t0: float                 # perf_counter at start (duration basis)
    t1: float = 0.0           # perf_counter at end
    ts: float = 0.0           # injectable-clock timestamp at start
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "ts": round(self.ts, 6),
                "duration": round(self.duration, 6),
                "attrs": self.attrs}


@dataclass
class Trace:
    """One finished trace: the root span plus every descendant, in
    start order (the root is spans[0])."""

    trace_id: str
    spans: List[Span]

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def duration(self) -> float:
        return self.root.duration

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id,
                "root": self.root.name,
                "ts": round(self.root.ts, 6),
                "duration": round(self.duration, 6),
                "spans": [s.to_dict() for s in self.spans]}

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]


class FlightRecorder:
    """Bounded ring of the N slowest finished traces.

    A new trace always enters while there is room; once full, it must be
    slower than the current fastest resident to get a seat (and the
    fastest is evicted). `slowest()` returns residents by descending
    duration — the crash-dump view an operator reads after a latency
    report. Thread-safe: the async runtime's controllers and a scraping
    HTTP handler touch it concurrently.
    """

    def __init__(self, size: int = 16):
        self.size = max(1, size)
        self._traces: List[Trace] = []
        self._lock = threading.Lock()
        # lifetime count of rejected offers — the ring-overflow meter the
        # invariant watchdog reads (a hot ring too small to retain
        # evidence is an observability failure worth a finding); the
        # per-tenant split lets a fleet watchdog attribute WHOSE hot
        # loop is overflowing the ring
        self.dropped = 0
        self.dropped_by_tenant: Dict[str, int] = {}

    def offer(self, trace: Trace, meter: bool = True) -> bool:
        """`meter=False` is for the observability plane's OWN marker
        traces (watchdog findings, coverage-gap markers): the slowest-N
        ring legitimately rejects a near-zero-duration marker when full
        of real traces, and that self-inflicted rejection must not
        count toward the overflow meters the watchdog reads or export
        as a tenant's drop — findings would manufacture findings."""
        with self._lock:
            if len(self._traces) < self.size:
                self._traces.append(trace)
                return True
            fastest = min(range(len(self._traces)),
                          key=lambda i: self._traces[i].duration)
            if trace.duration > self._traces[fastest].duration:
                self._traces[fastest] = trace
                return True
            if not meter:
                return False
            self.dropped += 1
            try:
                from ..metrics.tenant import current_tenant
                tenant = current_tenant()
            except Exception:  # noqa: BLE001 — interpreter teardown
                tenant = "default"
            self.dropped_by_tenant[tenant] = \
                self.dropped_by_tenant.get(tenant, 0) + 1
        try:
            from ..metrics import TRACE_RING_DROPPED
            TRACE_RING_DROPPED.inc(tenant=tenant)
        except Exception:  # noqa: BLE001 — the ring must never raise
            pass
        return False

    def slowest(self, n: Optional[int] = None) -> List[Trace]:
        with self._lock:
            out = sorted(self._traces, key=lambda t: -t.duration)
        return out if n is None else out[:n]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class _NoopSpan:
    """Shared do-nothing span: the entire disabled-tracing cost is one
    `enabled` check and returning this singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


def clock_anchor() -> Tuple[float, float]:
    """(time.time(), time.perf_counter()) read together: puts spans'
    perf_counter stamps on the wall clock (to_chrome_events)."""
    return time.time(), time.perf_counter()


class _SpanCtx:
    """Context manager for one live span; pushes itself as the current
    span for the dynamic extent of the `with` block."""

    __slots__ = ("_tracer", "span", "_token", "_is_root")

    def __init__(self, tracer: "Tracer", span: Span, is_root: bool):
        self._tracer = tracer
        self.span = span
        self._is_root = is_root
        self._token = None

    def set(self, **attrs) -> "_SpanCtx":
        self.span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        self._token = self._tracer._current.set(self.span)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.span.t1 = time.perf_counter()
        if exc_type is not None:
            self.span.attrs.setdefault("outcome", "error")
            self.span.attrs.setdefault("error", exc_type.__name__)
        self._tracer._current.reset(self._token)
        if self._is_root:
            self._tracer._finish(self.span)
        return False


class Tracer:
    """Process-wide tracer producing nested spans under a trace id."""

    def __init__(self, enabled: bool = False, ring_size: Optional[int] = None,
                 trace_dir: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 drop_empty: bool = True):
        env_dir = os.environ.get("KARPENTER_TPU_TRACE_DIR", "")
        self.trace_dir = trace_dir if trace_dir is not None else env_dir
        self.enabled = enabled or bool(self.trace_dir)
        if ring_size is None:
            ring_size = int(os.environ.get("KARPENTER_TPU_TRACE_RING", "16"))
        self.recorder = FlightRecorder(ring_size)
        # injectable timestamp source for Span.ts (sim clock in tests);
        # durations always use perf_counter regardless
        self.clock: Callable[[], float] = clock or time.time
        # childless root traces (an engine tick where no controller was
        # due) carry no information — drop them instead of flooding sinks
        self.drop_empty = drop_empty
        self._current: contextvars.ContextVar[Optional[Span]] = \
            contextvars.ContextVar("karpenter_tpu_span", default=None)
        self._ids = itertools.count(1)
        self._open: Dict[str, List[Span]] = {}   # trace_id -> spans so far
        self._lock = threading.Lock()
        # sink I/O gets its own lock: a slow/hung filesystem appending
        # traces.jsonl must not block span creation (which takes _lock)
        self._file_lock = threading.Lock()
        self._sinks: List[Callable[[Trace], None]] = []

    # --- configuration ---
    def configure(self, enabled: Optional[bool] = None,
                  clock: Optional[Callable[[], float]] = None,
                  ring_size: Optional[int] = None,
                  trace_dir: Optional[str] = None) -> "Tracer":
        if enabled is not None:
            self.enabled = enabled
        if clock is not None:
            self.clock = clock
        if ring_size is not None:
            self.recorder = FlightRecorder(ring_size)
        if trace_dir is not None:
            self.trace_dir = trace_dir
        return self

    def add_sink(self, fn: Callable[[Trace], None]) -> None:
        self._sinks.append(fn)

    # --- span creation ---
    def span(self, name: str, **attrs):
        """Open a span under the current one; with no trace active, this
        starts a new root trace (so a bare solve_device call still yields
        a decomposed trace). No-op singleton when disabled."""
        if not self.enabled:
            return NOOP_SPAN
        parent = self._current.get()
        if parent is None:
            return self.trace(name, **attrs)
        span = Span(name=name, trace_id=parent.trace_id,
                    span_id=next(self._ids), parent_id=parent.span_id,
                    t0=time.perf_counter(), ts=self.clock(), attrs=attrs)
        with self._lock:
            self._open.setdefault(span.trace_id, []).append(span)
        return _SpanCtx(self, span, is_root=False)

    def trace(self, name: str, **attrs):
        """Open a new root span (fresh trace id), regardless of context."""
        if not self.enabled:
            return NOOP_SPAN
        trace_id = uuid.uuid4().hex[:16]
        span = Span(name=name, trace_id=trace_id, span_id=next(self._ids),
                    parent_id=None, t0=time.perf_counter(),
                    ts=self.clock(), attrs=attrs)
        with self._lock:
            self._open[trace_id] = [span]
        return _SpanCtx(self, span, is_root=True)

    def closed_since(self, t0: float) -> List[Span]:
        """The current trace's spans that opened at or after perf_counter
        `t0` and have closed, in start order (none while tracing is off
        or outside a trace)."""
        cur = self._current.get() if self.enabled else None
        if cur is None:
            return []
        with self._lock:
            spans = list(self._open.get(cur.trace_id, ()))
        return [s for s in spans if s.t0 >= t0 and s.t1 >= s.t0]

    def current_trace_id(self) -> Optional[str]:
        """Trace id of the active span, for histogram exemplars."""
        if not self.enabled:
            return None
        cur = self._current.get()
        return cur.trace_id if cur is not None else None

    # --- finishing ---
    def _finish(self, root: Span) -> None:
        with self._lock:
            spans = self._open.pop(root.trace_id, [root])
        if self.drop_empty and len(spans) == 1:
            return
        trace = Trace(trace_id=root.trace_id, spans=spans)
        self.recorder.offer(trace)
        if self.trace_dir:
            try:
                os.makedirs(self.trace_dir, exist_ok=True)
                line = json.dumps(trace.to_dict())
                with self._file_lock:
                    with open(os.path.join(self.trace_dir,
                                           "traces.jsonl"), "a") as f:
                        f.write(line + "\n")
            except OSError:
                pass  # tracing must never take the control plane down
        for sink in self._sinks:
            sink(trace)


# THE process-wide tracer every instrumentation point imports. Disabled
# unless KARPENTER_TPU_TRACE_DIR is set or a caller flips it on.
TRACER = Tracer()


# --- exporters ---------------------------------------------------------


def to_chrome_events(traces: List[Trace], base_ns: Optional[int] = None,
                     anchor: Optional[Tuple[float, float]] = None
                     ) -> List[dict]:
    """Chrome trace-event JSON (the `chrome://tracing` / Perfetto array
    format): complete events ("ph": "X") with microsecond ts/dur. Each
    trace gets its own tid so concurrent traces don't interleave; ts is
    relative to the earliest root so the file opens at t=0.

    base_ns: torch.profiler's clock instead: ts is wall microseconds less
    this `baseTimeNanoseconds` of the profile's export, each span put on
    the wall clock through `anchor` (a clock_anchor() read as near the
    profile's start as can be; by default, one read now), and the spans'
    process is named "host spans"."""
    events: List[dict] = []
    if not traces:
        return events
    if base_ns is None:
        epoch = min(t.root.t0 for t in traces)
    else:
        wall, pc = anchor or clock_anchor()
        # seconds from the profile's base to the anchor, kept small so
        # the microseconds keep their precision
        epoch = pc - (wall - base_ns * 1e-9)
        events.append({"name": "process_name", "ph": "M", "pid": 1,
                       "args": {"name": "host spans"}})
    for tid, trace in enumerate(traces, start=1):
        for s in trace.spans:
            events.append({
                "name": s.name,
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": round((s.t0 - epoch) * 1e6, 1),
                "dur": round((s.t1 - s.t0) * 1e6, 1),
                "args": {**s.attrs, "trace_id": s.trace_id,
                         "clock_ts": round(s.ts, 6)},
            })
    return events


def write_chrome_trace(traces: List[Trace], path: str,
                       metadata: Optional[dict] = None,
                       base_ns: Optional[int] = None,
                       anchor: Optional[Tuple[float, float]] = None) -> str:
    """Write {"traceEvents": [...]} — the schema both chrome://tracing
    and Perfetto ingest directly. `metadata` lands under the standard
    top-level "metadata" key (both viewers ignore it): the run stamp —
    schema_version/run_id/seed/provenance — that lets the perf archive
    key this artifact to the bench run that produced it. `base_ns` and
    `anchor` put the spans on torch.profiler's clock (to_chrome_events)."""
    payload = {"traceEvents": to_chrome_events(traces, base_ns, anchor),
               "displayTimeUnit": "ms"}
    if metadata:
        payload["metadata"] = dict(metadata)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def summarize(trace: Trace) -> Dict[str, float]:
    """Per-span-name total seconds — the trace-report aggregation."""
    out: Dict[str, float] = {}
    for s in trace.spans:
        out[s.name] = out.get(s.name, 0.0) + s.duration
    return out

