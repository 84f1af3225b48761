"""Debug monitor: stream cluster state transitions during runs.

The port's own copy of `karpenter_tpu/utils/debug.py`, semantics unchanged.

Reference: test/pkg/debug/monitor.go:31-71 — the e2e suites attach
observers that stream node/nodeclaim/pod/event changes while a scenario
runs, so a wedged run shows WHERE it wedged instead of a silent timeout.
Ours hooks the store's watch seams plus an engine hook for in-place
mutations the watches can't see (claim phases, node readiness, events).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class DebugMonitor:
    """Attach with `DebugMonitor.attach(sim)`; every transition goes to
    `sink` as one line. `lines` keeps the trace for assertions."""

    store: object
    clock: object
    sink: Callable[[str], None]
    lines: List[str] = field(default_factory=list)
    _phases: Dict[str, str] = field(default_factory=dict)
    _ready: Dict[str, bool] = field(default_factory=dict)
    _events_seen: int = 0

    @classmethod
    def attach(cls, sim, sink: Optional[Callable[[str], None]] = None
               ) -> "DebugMonitor":
        mon = cls(store=sim.store, clock=sim.clock,
                  sink=sink or (lambda s: print(s, file=sys.stderr)))
        sim.store.watch("nodeclaim", lambda a, o: mon._emit(
            f"nodeclaim/{o.name}", a, getattr(o.phase, "value", o.phase)))
        sim.store.watch("node", lambda a, o: mon._emit(
            f"node/{o.name}", a, "ready" if o.ready else "not-ready"))
        sim.store.watch("pod", lambda a, o: mon._emit(
            f"pod/{o.namespace}/{o.name}", a, o.node_name or "pending"))
        sim.engine.add_hook(mon._tick)
        return mon

    def _emit(self, obj: str, action: str, detail) -> None:
        line = f"[{self.clock.now():10.1f}] {action:6s} {obj} ({detail})"
        self.lines.append(line)
        self.sink(line)

    def _tick(self, now: float) -> None:
        """Diff in-place mutations the watch seams don't fire for."""
        for c in self.store.nodeclaims.values():
            phase = getattr(c.phase, "value", str(c.phase))
            if c.is_deleting():
                phase = "Terminating"
            if self._phases.get(c.name) != phase:
                self._phases[c.name] = phase
                self._emit(f"nodeclaim/{c.name}", "phase", phase)
        for n in self.store.nodes.values():
            if self._ready.get(n.name) != n.ready:
                self._ready[n.name] = n.ready
                self._emit(f"node/{n.name}", "cond",
                           "Ready" if n.ready else "NotReady")
        if len(self.store.events) > self._events_seen:
            for kind, name, reason, msg in self.store.events[self._events_seen:]:
                self._emit(f"{kind}/{name}", "event",
                           f"{reason}: {msg}" if msg else reason)
            self._events_seen = len(self.store.events)
