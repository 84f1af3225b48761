"""The traced run: the program's own spans, summed by name through a sink
on its tracer, and torch.profiler over the window for the card's side
(device activity only: the host's side is the spans).

From the profile: the union of device operations (busy seconds), the
device time and launches of each kernel, the operations that took most
time, and the idle gaps between device operations, each put down to the
innermost program span the host was in at the gap's middle ("harness"
where it was in none).
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional


TOP = 10


class SpanSums:
    """A sink on the program's tracer: per span name, total seconds and
    count; and each span's (name, start, end) on the host's clock."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.spans: List[tuple] = []
        self.on = False

    def __call__(self, trace) -> None:
        if not self.on:
            return
        for s in trace.spans:
            self.total[s.name] += s.duration
            self.count[s.name] += 1
            self.spans.append((s.name, s.t0, s.t1))

    def ms(self, name: str) -> float:
        return self.total.get(name, 0.0) * 1e3


class Traced:
    """Turns the tracer and the profiler on for the window."""

    def __init__(self, out_dir: str, tag: str):
        self.out_dir, self.tag = out_dir, tag
        self.sums = SpanSums()
        self.prof = None
        self.t_open = self.t_close = 0.0

    def __enter__(self):
        import torch
        from karpenter_tpu_torch.obs.tracer import TRACER
        from torch.profiler import ProfilerActivity, profile
        TRACER.configure(enabled=True)
        TRACER.add_sink(self.sums)
        self.sums.on = True
        _sync()
        on_card = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        # the marker: a spin kernel launched on an idle card at t_open
        # puts the host's clock on the profile's
        self.t_open = time.perf_counter()
        if on_card:
            torch.cuda._sleep(1000)
        return self

    def __exit__(self, *exc):
        import torch
        from karpenter_tpu_torch.obs.tracer import TRACER
        _sync()
        self.t_close = time.perf_counter()
        self.prof.__exit__(*exc)
        self.sums.on = False
        TRACER.configure(enabled=False)
        return False

    def summary(self) -> dict:
        """busy_s, window_s, kernels {name: (seconds, launches)},
        device_ops and idle_gaps (top ten each), and the files written."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        marker = None
        intervals = []
        kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        for e in self.prof.events():
            if e.device_type != cuda:
                continue
            s, t = e.time_range.start, e.time_range.end
            if "spin_kernel" in e.name and marker is None:
                marker = s
                continue
            intervals.append((s, t))
            k = kernels[e.name]
            k[0] += (t - s) * 1e-6
            k[1] += 1
        window_s = self.t_close - self.t_open
        busy, gaps = _union(intervals)
        if marker is not None:
            # the window's edges: idle before the first device operation
            # and after the last (the whole window when there is none)
            end = marker + window_s * 1e6
            if not intervals:
                gaps = [(marker, end)]
            else:
                lo = min(s for s, _ in intervals)
                hi = max(t for _, t in intervals)
                gaps += [(marker, lo)] if lo > marker else []
                gaps += [(hi, end)] if end > hi else []
        ops = sorted(([_short(n), v[0]] for n, v in kernels.items()),
                     key=lambda x: -x[1])[:TOP]
        idle = self._label(gaps, marker)
        os.makedirs(self.out_dir, exist_ok=True)
        trace_path = os.path.join(self.out_dir, f"{self.tag}.trace.json")
        self.prof.export_chrome_trace(trace_path)
        spans_path = os.path.join(self.out_dir, f"{self.tag}.spans.json")
        with open(spans_path, "w") as f:
            json.dump({"seconds": dict(self.sums.total),
                       "count": dict(self.sums.count),
                       "window_s": window_s, "busy_s": busy}, f, indent=1)
        return {"busy_s": busy, "window_s": window_s,
                "kernels": {n: tuple(v) for n, v in kernels.items()},
                "device_ops": ops, "idle_gaps": idle,
                "files": [trace_path, spans_path]}

    def _label(self, gaps: List[tuple], marker: Optional[float]) -> list:
        """Idle seconds by the innermost program span the host was in
        (a gap across several spans is split between them)."""
        if not gaps:
            return []
        by: Dict[str, float] = defaultdict(float)
        if marker is None or not self.sums.spans:
            by["unattributed"] = sum(t - s for s, t in gaps) * 1e-6
        else:
            segs = _innermost(self.sums.spans)
            starts = [a for a, _, _ in segs]
            for s, t in gaps:
                a = self.t_open + (s - marker) * 1e-6
                b = self.t_open + (t - marker) * 1e-6
                covered = 0.0
                j = max(0, bisect.bisect_right(starts, a) - 1)
                while j < len(segs) and segs[j][0] < b:
                    lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
                    if hi > lo:
                        by[segs[j][2]] += hi - lo
                        covered += hi - lo
                    j += 1
                by["harness"] += max(0.0, (b - a) - covered)
        return sorted(([n, v] for n, v in by.items() if v > 0),
                      key=lambda x: -x[1])[:TOP]


def _innermost(spans: List[tuple]) -> List[tuple]:
    """[(start, end, name)]: the host's timeline cut where the innermost
    open span (the latest started) changes; time in no span is left out."""
    events = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, _, b) in enumerate(spans)])
    open_: Dict[int, float] = {}
    segs: List[tuple] = []
    last = None
    for t, kind, i in events:
        if open_ and last is not None and t > last:
            top = max(open_, key=open_.get)
            segs.append((last, t, spans[top][0]))
        if kind:
            open_[i] = spans[i][1]
        else:
            open_.pop(i, None)
        last = t
    return segs


def _short(name: str) -> str:
    """A device operation's name without its C++ argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:120].strip()


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union(intervals: List[tuple]):
    """(busy seconds, idle gaps [(start, end)] in microseconds) of the
    device intervals."""
    if not intervals:
        return 0.0, []
    intervals.sort()
    busy = 0.0
    gaps = []
    cs, ce = intervals[0]
    for s, t in intervals[1:]:
        if s > ce:
            busy += ce - cs
            gaps.append((ce, s))
            cs, ce = s, t
        else:
            ce = max(ce, t)
    busy += ce - cs
    return busy * 1e-6, gaps
