"""TenantShard: one simulated cluster's whole control plane (the port's
copy of `karpenter_tpu/fleet/tenant.py`; `build_shard` also takes the
`device=` it hands make_sim).

Each shard is a full `make_sim` stack — its own Store, FakeCloud,
CatalogProvider, intent journal, warm-path engine, and controller set —
sharing only two things with the rest of the fleet: the process-wide
`FakeClock` (one timeline, Omega-style) and the `SolverService` (one
solver). Everything identity-bearing is derived DETERMINISTICALLY from
(fleet seed, tenant id):

- `tenant_seed` — the shard's RNG stream (its FaultPlan seed and its
  workload RNG), a sha256 split so no two shards ever share a stream
  and no shard's stream depends on how many neighbors exist;
- `tenant_journal_path` — the shard's write-ahead intent journal file,
  so two shards pointed at the same `--intent-journal-file` DIRECTORY
  can never interleave intents in one WAL (tests/test_fleet.py carries
  the regression test).
"""

from __future__ import annotations

import hashlib
import os
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..metrics.tenant import tenant_scope
from ..utils.clock import FakeClock


def tenant_seed(fleet_seed: int, tenant: str) -> int:
    """Deterministic per-tenant seed: a 63-bit sha256 split of
    (fleet seed, tenant id). Stable under fleet-size changes — tenant
    t007's stream is the same in an 8-shard and an 80-shard fleet."""
    h = hashlib.sha256(f"{fleet_seed}|{tenant}".encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def tenant_journal_path(journal_dir: str, tenant: str) -> str:
    """The shard's private WAL file under the fleet journal directory."""
    return os.path.join(journal_dir, f"intents-{tenant}.jsonl")


@dataclass
class TenantShard:
    name: str
    sim: object                      # SimEnvironment
    seed: int                        # this shard's derived seed
    plan: Optional[object] = None    # armed faults.FaultPlan, if any
    rng: Optional[random.Random] = None
    stats: Dict[str, float] = field(default_factory=dict)

    def tick(self) -> None:
        """One engine tick under this tenant's metric scope — every
        sample the shard's controllers emit lands on its tenant series."""
        with tenant_scope(self.name):
            self.sim.engine.tick()

    def quiet(self) -> bool:
        """The shard's convergence predicate (mirrors the chaos runner's:
        fault AND workload horizons passed, no pending pods, every claim
        settled, interruption queue drained, journal resolved)."""
        sim = self.sim
        if self.plan is not None:
            horizon = _fault_horizon(self.plan)
            if sim.clock.now() - self.plan.origin < horizon:
                return False
        # scheduled-but-unfired waves live in workload closures the
        # store cannot see — the workload publishes its last arrival
        # instant so the run stays open for it (fleet/scenarios._waved)
        if sim.clock.now() < getattr(sim, "fleet_workload_horizon", 0.0):
            return False
        if sim.store.pending_pods():
            return False
        from ..models.nodeclaim import Phase
        for c in sim.store.nodeclaims.values():
            if c.is_deleting() or c.phase != Phase.INITIALIZED:
                return False
        if sim.journal is not None and sim.journal.open_intents():
            return False
        return not len(sim.cloud.interruptions)


def _fault_horizon(plan) -> float:
    from ..faults.runner import ScenarioRunner
    return ScenarioRunner._fault_horizon(plan)


def build_shard(name: str, clock: FakeClock, service,
                fleet_seed: int = 0,
                rules: Optional[List[object]] = None,
                workload: Optional[Callable[[object, random.Random],
                                            None]] = None,
                warmpath: bool = False,
                journal_dir: Optional[str] = None,
                types: Optional[list] = None,
                device=None) -> TenantShard:
    """Assemble one tenant's stack on the shared clock + solver service.

    `rules` become the shard's own FaultPlan (seeded from the tenant
    seed, so tenant weather is reproducible independent of neighbors).
    ClockJump and CrashPoint rules are rejected: the clock is FLEET
    state (a per-tenant skew would bend every neighbor's timeline), and
    crash-restart sequencing is the RestartRunner's contract, not the
    fleet's (yet).

    `workload(sim, rng)` is applied under the tenant's metric scope with
    the tenant's own RNG stream. `device` goes to make_sim (the CUDA card
    unless given); the shard's solves and screens run on the service's
    facades, on the service's device.
    """
    from ..sim import make_sim
    from ..state.journal import IntentJournal

    seed = tenant_seed(fleet_seed, name)
    plan = None
    if rules:
        from ..faults.plan import ClockJump, CrashPoint, FaultPlan
        bad = [r for r in rules if isinstance(r, (ClockJump, CrashPoint))]
        if bad:
            raise ValueError(
                f"tenant {name}: {[type(r).__name__ for r in bad]} rules "
                f"are fleet-global/restart concerns — not valid in a "
                f"tenant-scoped plan")
        plan = FaultPlan(seed=seed, rules=rules)
    journal = IntentJournal(
        path=tenant_journal_path(journal_dir, name) if journal_dir else None)
    with tenant_scope(name):
        sim = make_sim(
            types=types, clock=clock, fault_plan=plan, warmpath=warmpath,
            journal=journal, device=device,
            solver_factory=lambda catalog: service.register(name, catalog))
        rng = random.Random(seed)
        if workload is not None:
            workload(sim, rng)
    return TenantShard(name=name, sim=sim, seed=seed, plan=plan, rng=rng)
