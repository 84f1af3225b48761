"""Deterministic fault injection + chaos scenarios (the port's copy of
`karpenter_tpu/faults/`).

A seeded `FaultPlan` (declarative rules + one RNG) drives injection hooks
threaded through the fake cloud (ICE windows), the CloudProvider seam
(throttles / server errors), the sim clock (skew jumps), the solver's
device dispatch (the card lost mid-solve) and the commit path's crash
points; a `ScenarioRunner` (or `RestartRunner`, for crash points)
executes named chaos scenarios on `sim.make_sim` and asserts end-of-run
invariants — every pod scheduled, no leaked NodeClaims, store/cloud
consistency, and an identical end-state hash for identical seeds.

    from karpenter_tpu_torch.faults import ScenarioRunner
    report = ScenarioRunner("smoke", seed=0, device="cpu").run()
"""

from .plan import (ApiFault, ClockJump, CorruptionFault, CrashPoint,
                   DeviceFault, FaultPlan, IceWindow, InjectedFault,
                   InterruptionBurst, WireFault)
from .runner import (RestartRunner, ScenarioReport, ScenarioRunner,
                     check_invariants, restart_invariants, state_hash)
from .scenarios import SCENARIOS, Scenario, get_scenario

__all__ = [
    "FaultPlan", "IceWindow", "ApiFault", "ClockJump", "CorruptionFault",
    "CrashPoint", "DeviceFault", "InterruptionBurst", "InjectedFault",
    "WireFault", "ScenarioRunner", "RestartRunner", "ScenarioReport",
    "check_invariants", "restart_invariants", "state_hash", "SCENARIOS",
    "Scenario", "get_scenario",
]
