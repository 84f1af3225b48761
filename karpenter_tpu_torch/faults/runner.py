"""ScenarioRunner: execute a chaos scenario and judge the wreckage.

The port's own copy of `karpenter_tpu/faults/runner.py`. Both runners take
`device=` and pass it to `make_sim`: the CUDA card unless the caller asks
for another (device="cpu" runs the kernels' plain versions, as the tests
do); without a card and without `device` they raise. Every run's stack
arms the online watchdog (`sim.watchdog`), which the found-it-first
cross-check below asks, as in the reference.

Builds a full SimEnvironment with the scenario's FaultPlan armed, injects
the workload, drives the engine until the cluster converges (or the sim
deadline passes), then:

- checks the END-OF-RUN INVARIANTS a correct control plane must restore
  no matter what weather it flew through: every pod bound, no leaked or
  stuck NodeClaims, no orphaned cloud instances, store/cloud state
  consistency;
- computes a CANONICAL end-state hash (id-free — instance ids and claim
  names carry process-global counters, so the hash is over types, zones,
  phases, and pod→node groupings, which ARE stable) plus the plan's fault
  timeline fingerprint. Two runs with the same seed must agree on both:
  that pair of digests is the reproducibility contract
  (`docs/robustness.md` — "reproduce a scenario from its seed").

Convergence is judged on QUIET state: no pending pods, no claims still
launching or draining, interruption queue drained. The runner keeps
ticking past the last scheduled fault until that holds.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@contextlib.contextmanager
def scenario_env(env: Optional[dict]):
    """Apply a scenario's env overrides for the run, restoring the
    previous values on exit (crash or not)."""
    if not env:
        yield
        return
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

from ..models import labels as L
from .injector import corruption_fault_hook, device_fault_hook
from .plan import FaultPlan


def _integrity_judgment(plan: FaultPlan, det0: int, wd,
                        violations: List[str],
                        stats: Dict[str, float]) -> None:
    """The solution-integrity plane's run contract, shared by both
    runners: every injected corruption detected BEFORE commit, zero
    integrity findings on a corruption-free run (the zero-false-positive
    contract over the existing catalog), and — found-it-first — any
    detection must have fired the watchdog's integrity_breach invariant.

    Detection is matched PER INJECTION, not by aggregate totals: the
    plan snapshots the detection counter at each injection's firing
    (`_corruption_pre`), and for the i-th of k injections at least
    (k - i) new detections must land after it — a single injection that
    was attributed twice (violating solve + forensic audit of the same
    rotted entry) can therefore never mask a later injection that went
    completely undetected. The flip side of the contract: scenario
    authors must keep injections attributable (two rules rotting the
    SAME buffer in one probe yield one detection and read as a miss —
    the judge errs loud)."""
    from ..integrity import INTEGRITY
    final = INTEGRITY.detections()
    detected = final - det0
    injected = sum(1 for _t, kind, _d in plan.timeline
                   if kind == "corruption")
    stats["corruptions_injected"] = float(injected)
    stats["corruptions_detected"] = float(detected)
    if wd is not None and wd.armed:
        # close the race between the last violation and the judgment —
        # the same forced final evaluation the generic cross-check does
        wd.tick(force=True)
    pre = list(plan._corruption_pre)
    if len(pre) == injected and injected > 0:
        k = injected
        undetected = max((k - i) - (final - p)
                         for i, p in enumerate(pre))
        if undetected > 0:
            violations.append(
                f"{undetected} of {injected} injected corruption(s) "
                f"went undetected by the integrity plane")
    elif injected > detected:  # pre-count ledger incomplete (a restart
        # rebuilt hooks mid-fire): fall back to the aggregate bound
        violations.append(
            f"{injected - detected} of {injected} injected corruption(s) "
            f"went undetected by the integrity plane")
    if injected == 0 and detected > 0:
        violations.append(
            f"{detected} integrity violation(s) on a corruption-free run "
            f"— the zero-false-positive contract broke")
    if detected > 0 and wd is not None and wd.armed \
            and not wd.fired("integrity_breach"):
        violations.append(
            "watchdog blind spot: integrity violations detected but the "
            "integrity_breach monitor never fired")


def state_hash(sim) -> str:
    """Canonical digest of the end-of-run cluster state. Deliberately
    id-free (see module docstring); covers node composition (type, zone,
    capacity type, readiness, the exact pod set on each node), the claim
    fleet summary, unbound pods, and live ICE marks."""
    store = sim.store
    node_entries = []
    for node in store.nodes.values():
        pods = tuple(sorted(p.name for p in store.pods_on_node(node.name)))
        node_entries.append([
            node.labels.get(L.INSTANCE_TYPE, ""),
            node.labels.get(L.ZONE, ""),
            node.labels.get(L.CAPACITY_TYPE, ""),
            bool(node.ready), pods])
    node_entries.sort()
    claim_entries = sorted(
        [c.nodepool, c.instance_type or "", c.zone or "",
         c.capacity_type or "", str(c.phase)]
        for c in store.nodeclaims.values())
    unbound = sorted(k for k, p in store.pods.items()
                     if p.node_name is None)
    live_instances = sorted(
        [i.instance_type, i.zone, i.capacity_type, i.state]
        for i in sim.cloud.instances.values() if i.state != "terminated")
    payload = json.dumps(
        {"nodes": node_entries, "claims": claim_entries,
         "unbound": unbound, "instances": live_instances,
         "ice_marks": sim.catalog.unavailable.active()},
        sort_keys=True, default=list)
    return hashlib.sha256(payload.encode()).hexdigest()


def check_invariants(sim) -> List[str]:
    """End-of-run invariants; returns human-readable violations (empty =
    healthy). These are the properties EVERY catalog scenario must
    restore after its faults expire."""
    store, cloud = sim.store, sim.cloud
    v: List[str] = []
    unbound = [k for k, p in store.pods.items() if p.node_name is None]
    if unbound:
        v.append(f"{len(unbound)} pods never scheduled: "
                 f"{sorted(unbound)[:5]}...")
    for p in store.pods.values():
        if p.node_name is not None and p.node_name not in store.nodes:
            v.append(f"pod {p.namespace}/{p.name} bound to vanished node "
                     f"{p.node_name}")
    live = {iid: inst for iid, inst in cloud.instances.items()
            if inst.state != "terminated"}
    claim_iids = set()
    from ..models.nodeclaim import Phase
    for c in store.nodeclaims.values():
        if c.is_deleting():
            v.append(f"claim {c.name} still draining at end of run")
        if not c.provider_id:
            v.append(f"claim {c.name} leaked: never launched "
                     f"(phase={c.phase})")
            continue
        iid = c.provider_id.rsplit("/", 1)[-1]
        claim_iids.add(iid)
        if iid not in live:
            v.append(f"claim {c.name} leaked: instance {iid} gone")
        elif c.phase != Phase.INITIALIZED:
            v.append(f"claim {c.name} stuck in phase {c.phase}")
    # orphaned instances: cloud capacity we pay for with no claim tracking
    # it (the GC sweep's job to reap)
    for iid, inst in live.items():
        if inst.tags.get(L.TAG_NODECLAIM) and iid not in claim_iids:
            v.append(f"instance {iid} orphaned: karpenter-tagged but no "
                     f"claim tracks it")
    # store nodes must mirror live cloud instances
    for node in store.nodes.values():
        iid = node.provider_id.rsplit("/", 1)[-1]
        if iid not in live:
            v.append(f"store node {node.name} backs a dead instance")
    if len(cloud.interruptions):
        v.append(f"{len(cloud.interruptions)} interruption messages never "
                 f"consumed")
    return v


@dataclass
class ScenarioReport:
    scenario: str
    seed: int
    converged: bool
    violations: List[str]
    end_hash: str
    fault_fingerprint: str
    faults_injected: int
    sim_seconds: float
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.converged and not self.violations

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        lines = [f"[{status}] scenario={self.scenario} seed={self.seed} "
                 f"faults={self.faults_injected} "
                 f"sim_seconds={self.sim_seconds:g}",
                 f"  end_hash={self.end_hash}",
                 f"  fault_fingerprint={self.fault_fingerprint}"]
        if not self.converged:
            lines.append("  DID NOT CONVERGE before the sim deadline")
        lines += [f"  violation: {x}" for x in self.violations]
        return "\n".join(lines)


def restart_invariants(sim) -> List[str]:
    """Extra end-of-run invariants for crash-restart runs, on top of
    check_invariants: the intent journal must be fully resolved, and the
    idempotency layer must have prevented every double-provision — no
    token ever minted two instances, no claim is backed by two live
    ones. A nonzero launch_dedup count is fine (that is the token layer
    WORKING on a replay); a duplicate instance is the failure."""
    v: List[str] = []
    journal = getattr(sim, "journal", None)
    if journal is not None:
        still_open = journal.open_intents()
        if still_open:
            v.append(f"{len(still_open)} launch intent(s) still open at "
                     f"end of run: "
                     f"{sorted(i.claim_name for i in still_open)[:5]}")
    by_token: Dict[str, list] = {}
    live_by_claim: Dict[str, list] = {}
    for inst in sim.cloud.instances.values():
        if inst.state == "terminated":
            # a token legitimately re-mints once its prior instance is
            # terminated (FakeCloud._launch_one dedupes to LIVE
            # instances only; the ledger then points at the
            # replacement) — only live duplicates are a double-provision
            continue
        tok = inst.tags.get(L.TAG_LAUNCH_TOKEN)
        if tok:
            by_token.setdefault(tok, []).append(inst.id)
        claim = inst.tags.get(L.TAG_NODECLAIM)
        if claim:
            live_by_claim.setdefault(claim, []).append(inst.id)
    dup_tokens = {t: ids for t, ids in by_token.items() if len(ids) > 1}
    if dup_tokens:
        v.append(f"duplicate launch: {len(dup_tokens)} idempotency "
                 f"token(s) minted more than one instance: "
                 f"{sorted(dup_tokens.values())[:3]}")
    dup_claims = {c: ids for c, ids in live_by_claim.items()
                  if len(ids) > 1}
    if dup_claims:
        v.append(f"duplicate launch: {len(dup_claims)} claim(s) backed "
                 f"by more than one live instance: "
                 f"{sorted(dup_claims.items())[:3]}")
    return v


def _watchdog_cross_check(sim, violations: List[str]) -> None:
    """The end-of-run asserts, reframed: with the online watchdog armed
    (make_sim default) the runner's job is no longer to DISCOVER a
    violation but to confirm the watchdog found it first. A final forced
    evaluation closes the race between the last engine tick and the
    judgment; any mapped violation the watchdog never fired on is
    appended as a blind-spot violation of its own. Mutates `violations`
    in place and stamps the watchdog's finding counts for the report."""
    wd = getattr(sim, "watchdog", None)
    if wd is None or not wd.armed:
        return
    wd.tick(sim.clock.now(), force=True)
    violations.extend(wd.cross_check(violations))


def _watchdog_stats(sim) -> Dict[str, float]:
    wd = getattr(sim, "watchdog", None)
    if wd is None:
        return {}
    return {"watchdog_findings": float(wd.stats["findings"]),
            "watchdog_findings_warning": float(
                wd.findings_at_least("warning")),
            "watchdog_evals": float(wd.stats["evals"])}


class ScenarioRunner:
    """Run one named scenario (faults/scenarios.py) at a seed, on
    `device` (the CUDA card unless given)."""

    def __init__(self, scenario, seed: int = 0, device=None):
        from .scenarios import Scenario, get_scenario
        self.scenario = (scenario if isinstance(scenario, Scenario)
                         else get_scenario(scenario))
        self.seed = seed
        self.device = device

    def build(self):
        """(sim, plan) with the workload injected and every hook armed
        except the process-global device seam (run() scopes that)."""
        from ..sim import make_sim
        sc = self.scenario
        plan = FaultPlan(seed=self.seed, rules=sc.build_rules())
        sim = make_sim(types=sc.types() if sc.types else None,
                       backend=sc.backend, fault_plan=plan,
                       warmpath=sc.warmpath, device=self.device)
        sc.workload(sim)
        return sim, plan

    @staticmethod
    def _fault_horizon(plan: FaultPlan) -> float:
        """Last run-relative instant a rule can still fire — the run must
        stay open at least this long, or an early-converging workload
        would 'pass' a scenario whose weather never arrived."""
        import math
        h = 0.0
        for r in plan.rules:
            for attr in ("t1", "at"):
                t = getattr(r, attr, None)
                if t is not None and not math.isinf(t):
                    h = max(h, float(t))
        return h

    def run(self) -> ScenarioReport:
        sim, plan = self.build()
        sc = self.scenario
        t0 = sim.clock.now()
        horizon = max(self._fault_horizon(plan), sc.horizon)

        def quiet() -> bool:
            if sim.clock.now() - plan.origin < horizon:
                return False  # faults still scheduled: keep flying
            if sim.store.pending_pods():
                return False
            from ..models.nodeclaim import Phase
            for c in sim.store.nodeclaims.values():
                if c.is_deleting() or c.phase != Phase.INITIALIZED:
                    return False
            return not len(sim.cloud.interruptions)

        from ..integrity import INTEGRITY
        det0 = INTEGRITY.detections()
        with scenario_env(sc.env), device_fault_hook(plan), \
                corruption_fault_hook(plan):
            converged = sim.engine.run_until(quiet, timeout=sc.timeout,
                                             step=sc.step)
        violations = check_invariants(sim)
        stats = {"solver_catalog_rebuilds":
                 sim.solver.stats["catalog_rebuilds"],
                 "solver_device_fallbacks":
                 sim.solver.stats["device_fallbacks"],
                 "ice_marks": sim.catalog.unavailable.stats["marks"],
                 "provisioner_ice_errors":
                 sim.provisioner.stats["ice_errors"]}
        stats.update(_watchdog_stats(sim))
        if sim.warmpath is not None:
            wp = sim.warmpath
            stats.update({
                "warm_pods": wp.stats["warm_pods"],
                "warm_reconciles": wp.stats["warm_reconciles"],
                "cold_reconciles": wp.stats["cold_reconciles"],
                "warm_audits": wp.auditor.stats["audits"],
                "warm_divergences": wp.stats["divergences"]})
            if wp.stats["divergences"]:
                # the warm path may fall cold under weather — it may
                # NEVER place a pod the full solver wouldn't have
                violations.append(
                    f"warm-path auditor diverged "
                    f"{wp.stats['divergences']} time(s)")
        _integrity_judgment(plan, det0,
                            getattr(sim, "watchdog", None), violations,
                            stats)
        _watchdog_cross_check(sim, violations)
        report = ScenarioReport(
            scenario=sc.name, seed=self.seed, converged=converged,
            violations=violations, end_hash=state_hash(sim),
            fault_fingerprint=plan.fingerprint(),
            faults_injected=len(plan.timeline),
            sim_seconds=sim.clock.now() - t0,
            stats=stats)
        self.last_sim = sim
        self.last_plan = plan
        return report


class RestartRunner:
    """Crash-restart chaos: run a scenario whose FaultPlan carries
    CrashPoint rules, tearing the engine down at each injected crash and
    rebuilding it the way a real operator restart would.

    What survives a crash (durable): the cloud (instances + their
    adoption tags and idempotency-token ledger), the clock, the armed
    FaultPlan, and the provisioning intent journal. What does not: the
    Store, the engine, every controller, the warm-path ledgers, and the
    process-local claim-name counter (reset to zero, like a fresh
    process — rehydration must advance it past adopted names).

    On each rebuild the scenario's workload is re-applied: pods are
    durable in real Kubernetes but our Store is operator-local, so the
    workload "re-listing" models the watch re-sync — re-listed pods must
    be absorbed into the adopted fleet's headroom, never re-launched
    (state/rehydrate + the idempotency tokens guarantee it; the
    restart_invariants duplicate-launch check asserts it).

    Convergence additionally requires every CrashPoint consumed and the
    intent journal fully resolved — a run that 'converged' before its
    scheduled deaths happened proves nothing."""

    def __init__(self, scenario, seed: int = 0, device=None):
        from .scenarios import Scenario, get_scenario
        self.scenario = (scenario if isinstance(scenario, Scenario)
                         else get_scenario(scenario))
        self.seed = seed
        self.device = device
        self.restarts = 0

    def build(self):
        from ..sim import make_sim
        from ..state.journal import IntentJournal
        sc = self.scenario
        plan = FaultPlan(seed=self.seed, rules=sc.build_rules())
        sim = make_sim(types=sc.types() if sc.types else None,
                       backend=sc.backend, fault_plan=plan,
                       warmpath=sc.warmpath, journal=IntentJournal(),
                       device=self.device)
        sc.workload(sim)
        return sim, plan

    def _restart(self, old_sim, plan):
        """Kill the operator, boot a successor on the surviving durable
        state. make_sim detects the plan is already installed on this
        clock (origin preserved, jumps not re-scheduled); rehydration
        inside it adopts the fleet and replays open intents."""
        import itertools

        from ..cloud.provider import CloudError
        from ..models import nodeclaim as ncmod
        from ..sim import make_sim
        ncmod._seq = itertools.count(0)  # fresh process, counter resets
        # no `types=` here even for scenarios that define one: types
        # configure the FakeCloud, which SURVIVES the crash — make_sim
        # rejects types alongside an existing cloud, and the rebuilt
        # catalog hydrates from that cloud's describe_types()
        delay = 0.5
        while True:
            try:
                sim = make_sim(cloud=old_sim.cloud, clock=old_sim.clock,
                               backend=self.scenario.backend,
                               fault_plan=plan,
                               warmpath=self.scenario.warmpath,
                               journal=old_sim.journal,
                               device=self.device)
                break
            except CloudError as e:
                if not getattr(e, "retryable", False):
                    raise
                # the restart landed inside a throttling window and the
                # boot-path hydrate got 429'd: a real operator crash-loops
                # here and the orchestrator restarts it with backoff —
                # model that by stepping sim time and booting again
                # (deterministic: fixed exponential schedule)
                old_sim.clock.step(delay)
                delay = min(delay * 2, 8.0)
        self.scenario.workload(sim)      # the watch re-sync / pod re-list
        return sim

    def run(self) -> ScenarioReport:
        from ..models.nodeclaim import Phase
        from ..utils.crashpoints import CrashInjected
        from .injector import crash_point_hook, device_fault_hook
        sim, plan = self.build()
        sc = self.scenario
        t0 = sim.clock.now()
        deadline = t0 + sc.timeout
        horizon = max(ScenarioRunner._fault_horizon(plan), sc.horizon)
        self.restarts = 0

        def quiet() -> bool:
            if plan.crashes_remaining:
                return False  # scheduled deaths outstanding: keep flying
            if sim.clock.now() - plan.origin < horizon:
                return False
            if sim.store.pending_pods():
                return False
            for c in sim.store.nodeclaims.values():
                if c.is_deleting() or c.phase != Phase.INITIALIZED:
                    return False
            if sim.journal.open_intents():
                return False
            return not len(sim.cloud.interruptions)

        from ..integrity import INTEGRITY
        det0 = INTEGRITY.detections()
        converged = False
        with scenario_env(sc.env), device_fault_hook(plan), \
                corruption_fault_hook(plan), crash_point_hook(plan):
            while True:
                remaining = deadline - sim.clock.now()
                if remaining <= 0:
                    converged = quiet()
                    break
                try:
                    converged = sim.engine.run_until(quiet,
                                                     timeout=remaining,
                                                     step=sc.step)
                    break
                except CrashInjected:
                    self.restarts += 1
                    sim = self._restart(sim, plan)
        violations = check_invariants(sim) + restart_invariants(sim)
        stats = {
            "restarts": float(self.restarts),
            "launch_dedups": float(sim.cloud.api_calls.get("launch_dedup",
                                                           0)),
            "intents_opened": float(sim.journal.stats["opened"]),
            "intents_committed": float(sim.journal.stats["committed"]),
            "intents_aborted": float(sim.journal.stats["aborted"]),
            "intents_reaped": float(sim.journal.stats["reaped"]),
            "gc_inflight_skipped": float(
                sim.gc.stats.get("inflight_skipped", 0)),
            "ice_marks": sim.catalog.unavailable.stats["marks"],
        }
        stats.update(_watchdog_stats(sim))
        if sim.warmpath is not None:
            stats["warm_divergences"] = float(
                sim.warmpath.stats["divergences"])
            if sim.warmpath.stats["divergences"]:
                violations.append(
                    f"warm-path auditor diverged "
                    f"{sim.warmpath.stats['divergences']} time(s) "
                    f"post-restart")
        _integrity_judgment(plan, det0,
                            getattr(sim, "watchdog", None), violations,
                            stats)
        # only the FINAL boot's watchdog survives — findings from
        # pre-crash stacks died with their process, so the cross-check
        # leans on the forced final evaluation (persisting conditions —
        # leaks, duplicate tokens, open intents — are all re-detectable
        # from the surviving durable state)
        _watchdog_cross_check(sim, violations)
        report = ScenarioReport(
            scenario=sc.name, seed=self.seed, converged=converged,
            violations=violations, end_hash=state_hash(sim),
            fault_fingerprint=plan.fingerprint(),
            faults_injected=len(plan.timeline),
            sim_seconds=sim.clock.now() - t0,
            stats=stats)
        self.last_sim = sim
        self.last_plan = plan
        return report
