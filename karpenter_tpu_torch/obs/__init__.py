"""Observability: the span tracer the facade's stages report through, the
HTTP exposition routes, the solver observatory's ledgers — the
phase-attribution profiler, the recompute observatory and the device
telemetry plane —, decision provenance (the explain recorder) and the
online invariant watchdog (the port's copies of `karpenter_tpu.obs`).
Importing the package installs the process ledgers as tracer sinks and
registers their /debug routes; all are free while tracing is off and
nothing touches the device. The cross-run perf archive and its gate
(`obs/perfarchive`, `python -m karpenter_tpu_torch.obs.perf_gate`) and the
device report (`python -m karpenter_tpu_torch.obs.device_report`) are
modules of their own, imported where they run."""

from .tracer import (NOOP_SPAN, TRACER, FlightRecorder, Span, Trace, Tracer,
                     summarize, to_chrome_events, write_chrome_trace)
from .devicemem import DEVICEMEM, TRANSFERS, UPLOADS
from .explain import RECORDER
from .profile import LEDGER, PHASES, PhaseLedger
from .recompute import OUTCOMES, RECOMPUTE, RecomputeLedger
from .recompute import STAGES as RECOMPUTE_STAGES
from .watchdog import INVARIANTS, Finding, Watchdog

__all__ = ["TRACER", "Tracer", "Span", "Trace", "FlightRecorder",
           "NOOP_SPAN", "to_chrome_events", "write_chrome_trace",
           "summarize", "LEDGER", "PHASES", "PhaseLedger", "RECORDER",
           "Watchdog", "Finding", "INVARIANTS", "DEVICEMEM", "TRANSFERS",
           "UPLOADS", "RECOMPUTE", "RecomputeLedger", "RECOMPUTE_STAGES",
           "OUTCOMES"]
