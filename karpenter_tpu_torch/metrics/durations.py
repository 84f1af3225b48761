"""Scale-test duration-event pipeline.

The port's own copy of `karpenter_tpu/metrics/durations.py`, semantics unchanged.

Reference: scale-suite durations flow to AWS Timestream
(test/pkg/environment/aws/metrics.go:36-38,65-110) and are graphed via the
CloudFormation-provisioned Grafana. Ours records the same shape of events
(test name, dimensions, duration) to a local JSONL file that any dashboard
can ingest.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

DEFAULT_PATH = os.environ.get("KARPENTER_TPU_DURATIONS",
                              os.path.join(os.path.dirname(os.path.dirname(
                                  os.path.dirname(os.path.abspath(__file__)))),
                                  "scale_durations.jsonl"))


class DurationRecorder:
    def __init__(self, path: str = DEFAULT_PATH):
        self.path = path
        # scale tests drive controllers from multiple threads; interleaved
        # appends would corrupt the JSONL (two writers, one line)
        self._lock = threading.Lock()

    def record(self, name: str, seconds: float,
               dimensions: Optional[Dict[str, str]] = None,
               clock=None) -> None:
        # recorded_at takes the injected clock when one is threaded (sim
        # runs stamp SIM time, so chaos/scale `--repeat` artifacts are
        # byte-identical across repeats); wall time is the host-only
        # fallback for un-clocked callers
        recorded_at = (clock.now() if clock is not None
                       else time.time())  # graftlint: disable=wallclock -- explicit fallback for callers with no sim clock; sim paths pass clock=
        evt = {"measure": "duration", "name": name, "seconds": round(seconds, 4),
               "dimensions": dimensions or {}, "recorded_at": recorded_at}
        line = json.dumps(evt) + "\n"  # serialize outside the lock
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)  # single buffered append per event

    @contextmanager
    def measure(self, name: str, sim_clock=None, **dimensions):
        """Measure wall (or sim) time of a block. The event records in a
        finally with an `outcome` dimension — a raising block used to
        drop its event entirely, hiding exactly the runs worth seeing."""
        t0 = sim_clock.now() if sim_clock else time.perf_counter()
        outcome = "ok"
        try:
            yield
        except BaseException:
            outcome = "error"
            raise
        finally:
            t1 = sim_clock.now() if sim_clock else time.perf_counter()
            dims = {k: str(v) for k, v in dimensions.items()}
            dims["outcome"] = outcome
            self.record(name, t1 - t0, dims, clock=sim_clock)
