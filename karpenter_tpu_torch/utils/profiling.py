"""Solve() profiling — the device-trace hook, over `torch.profiler`.

The port's counterpart of `karpenter_tpu/utils/profiling.py`: when a
facade's `profile_dir` is set, each solve runs under `torch.profiler`
with CPU and (when a card is attached) CUDA activities, and the trace is
written to `<profile_dir>/solve-<n>.json` in the Chrome trace-event
format (per-kernel device time, host gaps, transfers). With tracing on,
the spans of the current request that close inside the profiled block
join the file as a host track on the profiler's clock
(`obs/tracer.to_chrome_events`), so the gaps between kernels show what
the host was doing. Wall-clock timing is always on via the
SOLVE_DURATION histogram (`metrics/registry`), measured around the
solve's one blocking host read.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os

_seq = itertools.count()


@contextlib.contextmanager
def maybe_trace(profile_dir: str = ""):
    """Wrap a block in a torch profiler trace when profile_dir is set;
    zero-cost no-op otherwise."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..obs.tracer import TRACER, Trace, clock_anchor, to_chrome_events
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        # read beside the profile's own base time, so that a step of the
        # wall clock before the block moves neither
        anchor = clock_anchor()
        yield
    path = os.path.join(profile_dir, f"solve-{next(_seq)}.json")
    prof.export_chrome_trace(path)
    spans = TRACER.closed_since(anchor[1])
    if not spans:
        return
    # the block's spans as a host track, on the profile's own clock
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("traceEvents", []).extend(to_chrome_events(
        [Trace(trace_id=spans[0].trace_id, spans=spans)],
        base_ns=int(doc.get("baseTimeNanoseconds", 0)), anchor=anchor))
    with open(path, "w") as f:
        json.dump(doc, f)
