"""Injectable clock (reference uses k8s.io/utils/clock the same way; the
fake clock drives TTL/expiry behavior in tests deterministically)."""

from __future__ import annotations

import time
from typing import Protocol


class Clock(Protocol):
    def now(self) -> float: ...


class RealClock:
    def now(self) -> float:
        return time.time()


class FakeClock:
    """Steppable clock. Besides step/set it supports SCHEDULED JUMPS — the
    fault-injection seam for clock skew (faults/plan.ClockJump: "clock
    jumps +90s at t=200"): once simulated time reaches `at`, now() applies
    the delta exactly once, so TTL caches, batcher windows, lease renewals
    and boot delays all see the same discontinuity a real clock step (NTP
    correction, VM migration) produces. Zero overhead with no jumps armed
    (one empty-list check)."""

    def __init__(self, start: float = 1_000_000.0):
        self._t = start
        # sorted [(at, delta, callback-or-None)], applied by now()
        self._jumps: list = []

    def schedule_jump(self, at: float, delta: float,
                      on_jump=None) -> None:
        """Arm a one-shot jump: when now() first observes t >= at, time
        becomes t + delta. on_jump(new_now, delta) fires as it applies."""
        import bisect
        bisect.insort(self._jumps, (at, delta, on_jump),
                      key=lambda j: j[0])

    def now(self) -> float:
        if self._jumps and self._t >= self._jumps[0][0]:
            # a jump can carry time past the next jump's `at` — drain all
            while self._jumps and self._t >= self._jumps[0][0]:
                _, delta, cb = self._jumps.pop(0)
                self._t += delta
                if cb is not None:
                    cb(self._t, delta)
        return self._t

    def step(self, seconds: float) -> None:
        self._t += seconds

    def set(self, t: float) -> None:
        self._t = t
