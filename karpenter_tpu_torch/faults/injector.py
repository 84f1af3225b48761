"""Injection adapters: thread an armed FaultPlan through the live seams.

The port's own copy of `karpenter_tpu/faults/injector.py`:

- `FaultyCloud` wraps any CloudProvider and consults the plan before
  forwarding each intercepted API method — injected throttles/server
  errors surface as the exact taxonomy classes the controllers and the
  engine already branch on, so the degradation paths under test are the
  production ones.
- `install_bursts` registers an engine hook that drains the plan's
  InterruptionBursts into the fake cloud's event queue (spot warnings,
  outright kills, rebalance recommendations), choosing victims with the
  plan RNG over the creation-ordered instance list.
- `device_fault_hook`, `fleet_device_fault_hook` and `crash_point_hook`
  arm/disarm the process-global seams of `ops/solver` and
  `utils/crashpoints` (context managers, so a crashed scenario can't
  leave the process faulted).

ICE windows and clock jumps need no adapter here: FakeCloud._launch_one
and FakeClock.now() consult the plan/jump list directly (nil-guarded).
`corruption_fault_hook` arms `ops/solver.set_corruption_hook` with the
plan's `on_corruption`. `wire_fault_hook` (count-based) and
`wire_fault_plan_hook` (a plan's WireFault rules) arm the federation
transport's request and reply seams (`federation/transport.py`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

from .plan import FaultPlan

# CloudProvider methods the wrapper gates — the ONE list the interception
# is generated from; everything else passes through untouched. Extend it
# (profiles, images, network groups) and matching ApiFault rules start
# firing with no further wiring.
INTERCEPTED = ("create_fleet", "terminate", "describe", "describe_nodes",
               "describe_types", "poll_interruptions")


class FaultyCloud:
    """CloudProvider decorator raising plan-driven API faults. Method
    interception is generated from INTERCEPTED in __getattr__, so the
    gated surface cannot drift from the advertised list."""

    def __init__(self, inner, plan: FaultPlan, clock=None):
        self.inner = inner
        self.plan = plan
        self.clock = clock if clock is not None else inner.clock

    def _gate(self, method: str) -> None:
        err = self.plan.api_fault(method, self.clock.now())
        if err is not None:
            raise err

    def __getattr__(self, name: str):
        attr = getattr(self.inner, name)
        if name in INTERCEPTED:
            def gated(*args, **kwargs):
                self._gate(name)
                return attr(*args, **kwargs)
            return gated
        return attr


def install_bursts(engine, cloud, plan: FaultPlan, store=None) -> None:
    """Engine hook delivering the plan's InterruptionBursts into `cloud`
    (a FakeCloud). Victim selection is deterministic: running instances in
    creation order (insertion order of the instance map), filtered by the
    burst's target_pods pod-name prefixes (resolved via `store` when
    given), sampled with the plan RNG."""
    if not plan._bursts:
        return

    def victims(burst):
        running = [i for i in cloud.instances.values()
                   if i.state == "running"]
        if burst.target_pods is not None and store is not None:
            node_names = {f"node-{i.id}" for i in running}
            wanted = set()
            for p in store.pods.values():
                if (p.node_name in node_names
                        and any(p.name.startswith(pre)
                                for pre in burst.target_pods)):
                    wanted.add(p.node_name)
            running = [i for i in running if f"node-{i.id}" in wanted]
        n = min(burst.count, len(running))
        return plan.rng.sample(running, n) if n else []

    def hook(now: float) -> None:
        for burst in plan.due_bursts(now):
            for inst in victims(burst):
                detail = f"{burst.kind}:{inst.instance_type}/{inst.zone}"
                plan.record(now, "interruption", detail)
                if burst.kind == "kill":
                    cloud.kill_instance(inst.id, reason="fault-plan")
                elif burst.kind == "rebalance":
                    cloud.send_rebalance_recommendation(inst.id)
                else:
                    cloud.send_spot_interruption(inst.id)

    engine.add_hook(hook)


@contextlib.contextmanager
def crash_point_hook(plan: Optional[FaultPlan]):
    """Arm utils.crashpoints' process-global hook for the plan's
    CrashPoint rules; always disarms on exit (same contract as
    device_fault_hook — a crashed harness can't leave the seam armed).
    Only the restart harness (runner.RestartRunner) should arm this: a
    fired crash unwinds the engine, and nothing else rebuilds it."""
    from ..utils import crashpoints
    if plan is None or not plan.crash_points:
        yield
        return
    crashpoints.set_crash_hook(plan.on_crash_point)
    try:
        yield
    finally:
        crashpoints.set_crash_hook(None)


@contextlib.contextmanager
def device_fault_hook(plan: Optional[FaultPlan]):
    """Arm ops.solver's dispatch hook for the plan's DeviceFault rules;
    always disarms on exit so the process-global seam can't leak between
    scenarios."""
    from ..ops import solver as solver_mod
    if plan is None or not plan.has_device_faults:
        yield
        return
    solver_mod.set_dispatch_fault_hook(plan.on_dispatch)
    try:
        yield
    finally:
        solver_mod.set_dispatch_fault_hook(None)


@contextlib.contextmanager
def corruption_fault_hook(plan: Optional[FaultPlan]):
    """Arm the silent-data-corruption seam (ops.solver.set_corruption_hook,
    consulted by both the staged-gbuf uploads and ops/resident.py's
    post-patch seam) for the plan's CorruptionFault rules; always
    disarms on exit — same leak-proofing contract as the other seams."""
    from ..ops import solver as solver_mod
    if plan is None or not plan.has_corruption_faults:
        yield
        return
    solver_mod.set_corruption_hook(plan.on_corruption)
    try:
        yield
    finally:
        solver_mod.set_corruption_hook(None)


@contextlib.contextmanager
def fleet_device_fault_hook(plans: dict):
    """Tenant-scoped device faults for a fleet: the ONE process-global
    dispatch seam is armed with a router that consults the CURRENT
    tenant's plan (metrics/tenant.py scope — the fleet runner wraps every
    shard tick in one), so tenant A's DeviceFault rule fires only on
    tenant A's dispatches. Dispatches outside any armed tenant's scope
    (including "default") pass through untouched."""
    from ..metrics.tenant import current_tenant
    from ..ops import solver as solver_mod
    armed = {t: p for t, p in plans.items()
             if p is not None and p.has_device_faults}
    if not armed:
        yield
        return

    def route(backend: str) -> None:
        plan = armed.get(current_tenant())
        if plan is not None:
            plan.on_dispatch(backend)

    solver_mod.set_dispatch_fault_hook(route)
    try:
        yield
    finally:
        solver_mod.set_dispatch_fault_hook(None)


@contextlib.contextmanager
def wire_fault_hook(fail_methods=("solve_bucket",), after: int = 0,
                    error: Optional[type] = None):
    """Arm the federation transport's wire-fault seam: RPCs whose method
    is in `fail_methods` raise after `after` successful probes of those
    methods — `after=0` kills the first matching call (the mid-solve
    server-crash drill: the client's degrade ladder must host-solve the
    bucket, arm its cooldown, and trip the watchdog's
    federation_degraded invariant). Raises ConnectionError by default —
    exactly what a dead server produces at the socket. Always disarms
    on exit, same leak-proofing contract as the other seams."""
    from ..federation import transport as transport_mod
    state = {"seen": 0}
    err = error if error is not None else ConnectionError

    def probe(method: str) -> None:
        if method not in fail_methods:
            return
        state["seen"] += 1
        if state["seen"] > after:
            raise err(f"injected wire fault on {method} "
                      f"(call {state['seen']})")

    prev = transport_mod.set_wire_fault_hook(probe)
    try:
        yield state
    finally:
        transport_mod.set_wire_fault_hook(prev)


@contextlib.contextmanager
def wire_fault_plan_hook(plan: Optional[FaultPlan]):
    """Arm BOTH federation wire seams (pre-RPC request probe and the
    reply-frame garbler) for the plan's WireFault rules — the seeded
    counterpart of the count-based `wire_fault_hook` above, with every
    firing recorded on the plan's canonical timeline so wire weather
    rides the chaos fingerprints. Always disarms both seams on exit."""
    from ..federation import transport as transport_mod
    if plan is None or not plan.has_wire_faults:
        yield
        return
    prev_req = transport_mod.set_wire_fault_hook(plan.on_wire)
    prev_rep = transport_mod.set_wire_reply_hook(plan.on_wire_reply)
    try:
        yield
    finally:
        transport_mod.set_wire_fault_hook(prev_req)
        transport_mod.set_wire_reply_hook(prev_rep)
