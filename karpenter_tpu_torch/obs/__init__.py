"""Observability: the span tracer the facade's stages report through
(the port's copy of `karpenter_tpu.obs.tracer`)."""

from .tracer import NOOP_SPAN, TRACER, Span, Trace, Tracer

__all__ = ["NOOP_SPAN", "TRACER", "Span", "Trace", "Tracer"]
