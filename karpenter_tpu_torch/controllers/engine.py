"""Deterministic reconcile engine.

The port's own copy of `karpenter_tpu/controllers/engine.py`, every line
with the reference's semantics, including the optional leader-election
`elector`, the watchdog's tick outside the traced window and that only a
retryable `CloudError` is absorbed — a kernel's error raises out of
`tick`, after the watchdog has evaluated.

Controllers implement `reconcile(now) -> requeue_after_seconds`, mirroring
controller-runtime's Reconcile contract (the reference's 14+ controllers,
pkg/controllers/controllers.go:67). The engine runs them round-robin on an
injectable clock, so tests step simulated time; the async runtime
(controllers/runtime.py) drives the same controllers on wall-clock time.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol

from ..cloud.provider import CloudError
from ..metrics import RECONCILE_DURATION, RECONCILE_ERRORS
from ..obs.tracer import NOOP_SPAN, TRACER


class Controller(Protocol):
    name: str

    def reconcile(self, now: float) -> float:
        """Do one pass; return seconds until the next desired pass."""
        ...


@dataclass
class Engine:
    clock: object
    controllers: List[Controller] = field(default_factory=list)
    hooks: List[Callable[[float], None]] = field(default_factory=list)
    # optional utils.leaderelection.Elector: controllers reconcile only
    # while this replica holds the lease (hooks still run — they model the
    # environment, not the controller plane)
    elector: Optional[object] = None
    # optional obs.watchdog.Watchdog: ticked OUTSIDE the traced window
    # (it observes the control plane, it is not part of the reconcile
    # cost the phase ledger decomposes) and on every tick including
    # non-leader ones — invariants hold whether or not we lead
    watchdog: Optional[object] = None
    _next_run: Dict[str, float] = field(default_factory=dict)

    def add(self, *controllers: Controller) -> "Engine":
        self.controllers.extend(controllers)
        return self

    def add_hook(self, fn: Callable[[float], None]) -> "Engine":
        """Per-tick hook (e.g. FakeCloud.tick)."""
        self.hooks.append(fn)
        return self

    def tick(self) -> None:
        now = self.clock.now()
        # one trace per tick, one span per controller reconcile. Opened
        # only when a controller is actually due AND this replica leads,
        # so an idle tick (or a non-leader standby, whose controllers
        # stay permanently "due") still records nothing — but a BUSY
        # tick's trace now encloses the per-tick hooks too
        # (`engine.hooks`), so hook time (cloud tick, workload arrivals)
        # is attributable instead of an unexplained gap in the phase
        # ledger. Leadership is read BEFORE the elector's own
        # bookkeeping below (which keeps its original hooks-then-elector
        # order): the one tick where leadership is first acquired runs
        # untraced — a fair trade against a standby flooding every
        # tracer sink forever. When tracing is off everything here is
        # the shared no-op singleton and the tick is exactly as before.
        trace_on = (TRACER.enabled
                    and (self.elector is None or self.elector.is_leader())
                    and any(now >= self._next_run.get(c.name, 0.0)
                            for c in self.controllers))
        tick_sp = (TRACER.trace("engine.tick", sim_now=now)
                   if trace_on else NOOP_SPAN)
        try:
            self._tick_body(now, trace_on, tick_sp)
        finally:
            # the watchdog evaluates even when a controller pass raised —
            # a crashing reconcile is exactly when invariants need eyes
            if self.watchdog is not None:
                self.watchdog.tick(now)

    def _tick_body(self, now: float, trace_on: bool, tick_sp) -> None:
        with tick_sp:
            hooks_sp = (TRACER.span("engine.hooks", hooks=len(self.hooks))
                        if trace_on and self.hooks else NOOP_SPAN)
            with hooks_sp:
                for fn in self.hooks:
                    fn(now)
            if self.elector is not None:
                if now >= self._next_run.get(self.elector.name, 0.0):
                    self._next_run[self.elector.name] = (
                        now + max(0.0, self.elector.reconcile(now)))
                if not self.elector.is_leader():
                    return
            for c in self.controllers:
                if now >= self._next_run.get(c.name, 0.0):
                    # gated on trace_on, not TRACER.enabled: with no
                    # open tick trace (the leadership-acquisition edge
                    # above) a bare span would start its own root trace
                    # per controller — the tick must be truly untraced
                    sp = (TRACER.span(f"reconcile:{c.name}",
                                      controller=c.name)
                          if trace_on else NOOP_SPAN)
                    t0 = _time.perf_counter()
                    try:
                        with sp:
                            requeue = c.reconcile(now)
                            # controllers may publish per-pass attributes
                            # (e.g. the provisioner's warm/cold path
                            # decision) onto their reconcile span
                            if trace_on:
                                attrs = getattr(c, "span_attrs", None)
                                if attrs is not None:
                                    sp.set(**attrs())
                    except CloudError as e:
                        # retryable cloud errors (rate limits, server
                        # errors) model transient throttling: back off
                        # and retry, the way real clients do. Anything
                        # else is a bug — crash.
                        if not getattr(e, "retryable", False):
                            raise
                        RECONCILE_ERRORS.inc(controller=c.name,
                                             disposition="backoff")
                        requeue = 2.0
                    finally:
                        RECONCILE_DURATION.observe(
                            _time.perf_counter() - t0, controller=c.name,
                            exemplar=TRACER.current_trace_id())
                    self._next_run[c.name] = now + max(0.0, requeue)

    def run_for(self, seconds: float, step: float = 0.5) -> None:
        end = self.clock.now() + seconds
        while self.clock.now() < end:
            self.tick()
            self.clock.step(step)

    def run_until(self, cond: Callable[[], bool], timeout: float = 600.0,
                  step: float = 0.5) -> bool:
        end = self.clock.now() + timeout
        while self.clock.now() < end:
            self.tick()
            if cond():
                return True
            self.clock.step(step)
        return cond()
