"""Observability: the span tracer the facade's stages report through, the
HTTP exposition routes, and the solver observatory's ledgers — the
phase-attribution profiler, the recompute observatory and the device
telemetry plane (the port's copies of `karpenter_tpu.obs`). Importing the
package installs the process ledgers as tracer sinks and registers their
/debug routes; all are free while tracing is off and nothing touches the
device. The reference's watchdog, explain recorder and perf archive are
ROADMAP items 16 and 8."""

from .tracer import (NOOP_SPAN, TRACER, FlightRecorder, Span, Trace, Tracer,
                     summarize, to_chrome_events, write_chrome_trace)
from .devicemem import DEVICEMEM, TRANSFERS, UPLOADS
from .profile import LEDGER, PHASES, PhaseLedger
from .recompute import OUTCOMES, RECOMPUTE, RecomputeLedger
from .recompute import STAGES as RECOMPUTE_STAGES

__all__ = ["TRACER", "Tracer", "Span", "Trace", "FlightRecorder",
           "NOOP_SPAN", "to_chrome_events", "write_chrome_trace",
           "summarize", "LEDGER", "PHASES", "PhaseLedger", "DEVICEMEM",
           "TRANSFERS", "UPLOADS", "RECOMPUTE", "RecomputeLedger",
           "RECOMPUTE_STAGES", "OUTCOMES"]
