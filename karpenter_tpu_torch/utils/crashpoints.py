"""Crash-point seams: named cut points on the provisioning commit path.

The port's own copy of `karpenter_tpu/utils/crashpoints.py`, unchanged
in semantics; the hook is this package's own.

Borg/Omega-lineage controllers prove failover by dying at the worst
possible instants — between the intent write and the wire call, between
the wire call and the commit, mid-drain, mid-audit — and asserting the
rebuilt process converges without leaking or double-provisioning
(PAPERS.md: Borg §3.3 "Checkpointing and failover"). This module is the
seam those deaths flow through: production code calls `fire(point)` at
each cut point, and the call is a no-op (one `is None` check) unless a
restart chaos harness armed the hook (`faults/injector.crash_point_hook`
→ `FaultPlan.on_crash_point`, which raises `CrashInjected` when a
`CrashPoint` rule covers the firing).

The cut-point catalog (docs/robustness.md "Restart & crash recovery"):

- ``mid_launch_batch``  — Provisioner._launch, AFTER the intent journal
  records the batch, BEFORE the CreateFleet wire call (intents open,
  nothing launched).
- ``post_launch``       — Provisioner._launch, AFTER CreateFleet
  returned, BEFORE any result is committed to the store (instances
  exist, no claim knows about them).
- ``mid_drain``         — TerminationController._terminate_one,
  immediately before the instance terminate call (node gone from the
  store, instance still running).
- ``mid_warm_audit``    — WarmPathEngine._run_audit, before the warm
  window's accumulated admissions replay through the full solver.

Same nil-guarded shape as ops.solver's device-dispatch fault hook: an
un-armed process pays one attribute check per seam.
"""

from __future__ import annotations

from typing import Callable, Optional

CUT_POINTS = ("mid_launch_batch", "post_launch", "mid_drain",
              "mid_warm_audit")


class CrashInjected(RuntimeError):
    """The simulated operator process died at a cut point. Deliberately
    NOT a CloudError: the engine's retry machinery must not absorb it —
    it unwinds the whole engine, exactly like a real crash."""


_hook: Optional[Callable[[str], None]] = None


def set_crash_hook(fn: Optional[Callable[[str], None]]) -> None:
    """Arm/disarm the process-global crash hook (faults/injector scopes
    this with a context manager so a failed scenario can't leak it)."""
    global _hook
    _hook = fn


def fire(point: str) -> None:
    """Production seams call this at each cut point; armed plans may
    raise CrashInjected from inside the hook."""
    if _hook is not None:
        _hook(point)
