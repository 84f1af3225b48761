"""Solve() profiling — the device-trace hook, over `torch.profiler`.

The port's counterpart of `karpenter_tpu/utils/profiling.py`: when a
facade's `profile_dir` is set, each solve runs under `torch.profiler`
with CPU and (when a card is attached) CUDA activities, and the trace is
written to `<profile_dir>/solve-<n>.json` in the Chrome trace-event
format (per-kernel device time, host gaps, transfers). Wall-clock timing
is always on via the SOLVE_DURATION histogram (`metrics/registry`),
measured around the solve's one blocking host read.
"""

from __future__ import annotations

import contextlib
import itertools
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
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"solve-{next(_seq)}.json"))
