"""Online invariant watchdog: the chaos invariants, while they happen
(the port's copy of `karpenter_tpu/obs/watchdog.py`, unchanged in
semantics: the same 18 invariants, graces, edge triggers and clock-jump
absorption, reading the port's own planes).

Every correctness invariant this framework enforces — no leaked claims,
store<->cloud consistency, a fully resolved intent journal, warm-path
audit discipline, fleet fairness — has lived as an END-OF-RUN assert in
the chaos/restart/fleet runners: a violation is only visible after the
run, with no timestamp, no severity, and no way to observe it in a
deployed process at all. The watchdog reframes those asserts as
INCREMENTAL monitors evaluated on a sim-clock cadence:

- **claim_leak** — claims stuck launching (no provider id), stuck in a
  pre-Initialized phase, or draining forever, past a sim-time grace
  window; plus the idempotency-token ledger checks (one token minting
  two live instances, one claim backed by two live instances — never
  legitimate, so no grace).
- **store_cloud_drift** — store nodes backing dead/missing cloud
  instances, and karpenter-tagged live instances no claim tracks
  (shielded by open launch intents exactly like the GC sweep).
- **intent_age** — open launch intents older than `INTENT_GRACE`: a
  wedged crash-window launch the restart replay never resolved.
- **warm_audit_lag** — warm admissions recorded but unaudited for
  longer than the lag grace (audit coverage silently drifting behind).
- **warm_divergence** — the auditor's divergence counter moved: the
  incremental admitter disagreed with the full solver (self-repairing,
  but every occurrence must be visible the moment it happens).
- **fleet_starvation** — a tenant's worst virtual queueing delay
  crossed the starvation threshold, or the shared service's queue
  backlog crossed the backlog threshold.
- **pipeline_stall** — the batched dispatcher's async pipeline wedged:
  a device batch has been in flight longer than the pipeline grace
  (dispatched, never drained — a hung tunnel the synchronous pump
  cannot hang on), or a padded shape class keeps co-pending >=2
  tickets per pump without EVER co-batching them (the bucketing that
  justifies the batching's existence is silently not happening).
- **profile_unattributed** — the phase ledger's unattributed gap grew:
  an un-spanned seam appeared on a traced hot path. Baselined and
  evaluated PER TENANT, so a fleet finding names whose path grew it.
- **trace_ring_overflow** — the flight recorder rejected traces since
  arming faster than the overflow threshold: the ring is too small to
  retain the evidence the other monitors point at. Per tenant, like
  the profile meter.
- **devicemem_leak** — a residency-ledger group's OWNER (DeviceCatalog,
  InFlightBatch, ResidentEntry) died while its device buffers stay live
  past the devicemem grace: something else is pinning an evicted
  owner's upload — exactly the leak shape device-resident state can
  introduce, and it now governs ops/resident.py's buffers too. The
  ledger holds each tensor by weakref, so a buffer counts while a live
  tensor references it; bytes the CUDA caching allocator keeps reserved
  after the tensor died never count.
- **resident_staleness** — a device-resident delta buffer
  (ops/resident.py) whose catalog token no longer matches the newest
  one its facade resolved, lingering past a sim grace: device bytes
  encode an older catalog epoch than the store serves. The serving path
  cannot hand them out (upload() re-keys on token mismatch), so a
  persistent stale entry is held HBM plus a latent-bug signal — the
  refresh that should have re-seeded it never ran.
- **delta_staleness** — a delta-plane memo entry (ops/delta.py) that
  reached its audit cadence and never received a fresh confirm,
  lingering past a sim grace: `serve()` already refuses it, so a
  persistent stale entry means the owning loop stopped closing its
  serve-and-verify audit contract — the recompute that should have
  confirmed (or diverged) the shortcut never ran. Pre-arm residue is
  excluded and the window is ClockJump-absorbed like every other stamp.
- **optimizer_divergence** — the global disruption optimizer's exact
  verification keeps REJECTING the relaxation ranking's picks: a
  tenant's consecutive-reject streak (optimizer/stats.py, reset by any
  accept) crossed the divergence threshold. Every executed disruption
  still passes a real `Solver.solve()` — the invariant polices wasted
  exact solves and a scoring model that has drifted from solve
  semantics, not correctness.
- **overload_unbounded** — an open-loop tenant's waiting-pod depth
  (pending + deferred, loadgen/source.py) sits ABOVE the admission
  controller's shed budget and is still not shrinking (or its oldest
  parked arrival keeps aging) after the overload grace: admission
  control should have engaged and bounded the queue — with shedding
  armed this can never fire (the budgets hold by construction), with
  shedding disabled it is the page that says overload is degrading
  unboundedly instead of predictably.

Cost discipline: the claim watchlist is maintained from the store's
watch feed (O(delta) per event, settled claims leave the list), the
meters are counter deltas, and the cloud sweep is bounded by live
instances on a slower cadence — one rate-limited `tick()` per engine
tick is a single float compare when nothing is due. Findings are
severity-ranked and EDGE-TRIGGERED per (invariant, key): one finding
per excursion, re-armed when the condition clears. Each firing meters
`watchdog_findings_total{invariant,severity}`, lands a
`watchdog.finding` marker trace in the flight-recorder ring (works with
tracing disabled — the ring accepts direct offers), and is readable at
`/debug/watchdog` (weakref route). The watchdog also registers a
readiness probe: a critical verdict flips `/readyz` to 503.

Sim-clock jumps (chaos `ClockJump` rules) are absorbed: a tick that
observes time advancing far beyond the tick cadence shifts every
tracked timestamp by the jump, so skew cannot age a healthy launch into
a fake leak — the zero-false-positive contract over the existing chaos
catalogs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .exposition import register_debug_route, register_readiness
from .tracer import TRACER, Span, Trace

# the invariant taxonomy (the reference's): every name here is tripped
# by a seeded fault in tests/test_torch_watchdog.py, bar the two
# federation invariants, whose trips need the federation plane
INVARIANTS: Tuple[str, ...] = (
    "claim_leak",
    "store_cloud_drift",
    "intent_age",
    "warm_audit_lag",
    "warm_divergence",
    "fleet_starvation",
    "pipeline_stall",
    "profile_unattributed",
    "trace_ring_overflow",
    "devicemem_leak",
    "resident_staleness",
    "delta_staleness",
    "overload_unbounded",
    "optimizer_divergence",
    "integrity_breach",
    "recompute_runaway",
    "federation_degraded",
    "federation_rejoin",
)

SEVERITIES = ("info", "warning", "critical")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# substrings of end-of-run violation texts -> the invariant that should
# have seen the condition live (the runners' "watchdog found it first"
# cross-check); unmapped violations have no online monitor (yet)
_VIOLATION_MAP: Tuple[Tuple[str, str], ...] = (
    ("leaked", "claim_leak"),
    ("stuck in phase", "claim_leak"),
    ("still draining", "claim_leak"),
    ("duplicate launch", "claim_leak"),
    ("backs a dead instance", "store_cloud_drift"),
    ("orphaned", "store_cloud_drift"),
    ("intent(s) still open", "intent_age"),
    ("auditor diverged", "warm_divergence"),
    ("unbounded backlog", "overload_unbounded"),
    ("integrity violation", "integrity_breach"),
    ("wire failure", "federation_degraded"),
    ("stuck degraded", "federation_rejoin"),
)


@dataclass
class Finding:
    invariant: str
    severity: str
    key: str                  # the offending object (claim/tenant/...)
    message: str
    at: float                 # sim time of first detection
    attrs: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "severity": self.severity,
                "key": self.key, "message": self.message,
                "at": round(self.at, 3), "attrs": dict(self.attrs)}


class Watchdog:
    """One watchdog per control plane (or per shared fleet service).

    Pass whichever subsystems exist: `store`+`cloud` enable the leak and
    drift monitors, `journal` the intent-age monitor, `warmpath` the
    audit-lag/divergence monitors, `service` the fleet monitors. The
    profile/trace meters are process-global and always on (baselined at
    `arm()` so another run's residue never counts against this one).
    """

    INTERVAL = 5.0            # sim seconds between evaluations
    CLOUD_SWEEP = 30.0        # sim seconds between cloud drift sweeps
    CLAIM_GRACE = 900.0       # launching/draining age before a leak fires
    DRIFT_GRACE = 300.0       # store<->cloud disagreement age
    ORPHAN_GRACE = 900.0      # untracked tagged instance age (> GC sweep)
    AUDIT_LAG_GRACE = 120.0   # recorded-but-unaudited warm batch age
    STARVATION_S = 1.0        # virtual queueing delay (seconds)
    BACKLOG_MAX = 64          # queued tickets in the shared service
    PIPELINE_GRACE = 30.0     # sim seconds a batch may stay in flight
    COBATCH_MIN_PUMPS = 3     # co-pending pumps before a never-co-batched
    #                           shape class counts as a stall
    UNATTRIBUTED_MS = 5.0     # ledger gap growth per excursion
    RING_DROPS = 64           # recorder rejections since arm
    DEVICEMEM_GRACE = 120.0   # orphaned device buffers' age before a leak
    RESIDENT_GRACE = 900.0    # stale resident-state age before a finding
    #                           (generous: a healthy view refreshes at its
    #                           next solve — only a view that NEVER
    #                           refreshes after an epoch bump should fire)
    DELTA_GRACE = 900.0       # audit-due delta-memo age before a finding
    #                           (generous for the same reason: a healthy
    #                           loop closes the audit at its very next
    #                           pass — only a key whose owner stopped
    #                           confirming should fire)
    OVERLOAD_GRACE = 45.0     # sim seconds a tenant's waiting depth may
    #                           sit above the admission budget before a
    #                           still-growing backlog counts as unbounded
    OPTIMIZER_STREAK = 12     # consecutive exact-verify rejects of the
    #                           optimizer's ranked subsets before the
    #                           relaxation scoring counts as diverged —
    #                           deliberately ABOVE one pass's
    #                           VERIFY_LIMIT (8): a single unlucky
    #                           all-reject pass is the over-approximation
    #                           doing its job; persisting across passes
    #                           on CHANGED state (unchanged state skips
    #                           the search entirely) is the divergence
    RECOMPUTE_FRAC = 0.9      # a stage's redundant work fraction above
    #                           this arms a runaway excursion
    RECOMPUTE_GRACE = 900.0   # sim seconds the fraction may sit above
    #                           RECOMPUTE_FRAC before a STILL-RISING
    #                           fraction fires (a steady warm cluster
    #                           legitimately plateaus high — only
    #                           unbounded growth is the runaway)
    RECOMPUTE_RISE = 0.005    # the fraction must have risen by at least
    #                           this much over the grace window to count
    #                           as rising, not noise
    RECOMPUTE_MIN_UNITS = 256  # classified units (since arm) a stage
    #                           needs before its fraction is meaningful
    REJOIN_GRACE = 60.0       # sim seconds the federation wire may sit
    #                           degraded WITH passing healthz probes
    #                           before the recovery ladder counts as
    #                           stuck (probes failing = the server is
    #                           genuinely down, and degraded is the
    #                           correct steady state — only "healthy
    #                           but never rejoined" is the bug)
    JUMP_THRESHOLD = 60.0     # dt above this is a clock jump, not aging
    MAX_FINDINGS = 256        # bounded finding log

    def __init__(self, clock, store=None, cloud=None, journal=None,
                 warmpath=None, service=None, loadgen=None,
                 interval: Optional[float] = None,
                 claim_grace: Optional[float] = None,
                 drift_grace: Optional[float] = None,
                 audit_lag_grace: Optional[float] = None,
                 starvation_s: Optional[float] = None,
                 backlog_max: Optional[int] = None,
                 pipeline_grace: Optional[float] = None,
                 overload_grace: Optional[float] = None):
        self.clock = clock
        self.store = store
        self.cloud = cloud
        self.journal = journal
        self.warmpath = warmpath
        self.service = service
        # loadgen observable: an object with overload_state() ->
        # {tenant: {depth, oldest_age_s, budget, armed}} (the SoakRunner
        # or a single OpenLoopSource-compatible shim)
        self.loadgen = loadgen
        self.interval = self.INTERVAL if interval is None else interval
        self.claim_grace = (self.CLAIM_GRACE if claim_grace is None
                            else claim_grace)
        self.drift_grace = (self.DRIFT_GRACE if drift_grace is None
                            else drift_grace)
        self.audit_lag_grace = (self.AUDIT_LAG_GRACE
                                if audit_lag_grace is None
                                else audit_lag_grace)
        self.starvation_s = (self.STARVATION_S if starvation_s is None
                             else starvation_s)
        self.backlog_max = (self.BACKLOG_MAX if backlog_max is None
                            else int(backlog_max))
        self.pipeline_grace = (self.PIPELINE_GRACE if pipeline_grace is None
                               else float(pipeline_grace))
        self.overload_grace = (self.OVERLOAD_GRACE if overload_grace is None
                               else float(overload_grace))
        self._lock = threading.Lock()
        self.findings: List[Finding] = []
        # ACTIVE excursions: (invariant, key) -> severity. The verdict
        # derives from this map, never from the bounded findings log —
        # trimming old log entries must not amnesty a live violation
        self._active: Dict[Tuple[str, str], str] = {}
        self._fired: Dict[str, int] = {}     # invariant -> lifetime count
        self._claims: Dict[str, float] = {}  # in-transition claim -> since
        self._drift: Dict[str, float] = {}   # drift key -> first seen
        # (auditor.pending_since value, watchdog clock when first seen):
        # the lag is measured on the WATCHDOG's observation clock so a
        # chaos ClockJump can be absorbed like every other stamp
        self._audit_pending: Optional[Tuple[float, float]] = None
        self._last_tick: Optional[float] = None
        self._last_sweep: Optional[float] = None
        self.armed = False
        self.stats = {"ticks": 0, "evals": 0, "findings": 0,
                      "jump_absorbed": 0}
        # meter baselines (set at arm): deltas, never process totals.
        # PER TENANT for the process-global ring/ledger meters, so a
        # fleet finding attributes to the tenant whose path regressed
        self._base_dropped: Dict[str, int] = {}
        self._base_unattr: Dict[str, float] = {}
        self._base_div = 0.0
        # devicemem orphans: group-id -> first-seen (watchdog clock);
        # groups already orphaned at arm are another run's residue and
        # never fire here (zero-false-positive contract)
        self._devmem: Dict[int, float] = {}
        self._devmem_base: frozenset = frozenset()
        # resident-state staleness: entry key -> first-seen (watchdog
        # clock); stale at arm = another run's residue, excluded
        self._resident: Dict[tuple, float] = {}
        self._resident_base: frozenset = frozenset()
        # delta-memo staleness: internal memo key -> first-seen
        # (watchdog clock); audit-due at arm = another run's residue
        self._delta_stale: Dict[tuple, float] = {}
        self._delta_base: frozenset = frozenset()
        # overload excursions: tenant -> (first-seen-over-budget stamp on
        # the watchdog clock, depth at first sight) — jump-absorbed like
        # every other window
        self._overload: Dict[str, Tuple[float, int]] = {}
        # optimizer divergence: per-tenant reject-streak baseline at arm
        # (pre-arm residue from another run never counts here)
        self._optimizer_base: Dict[str, int] = {}
        # integrity breaches: per-tenant violation-counter baseline at
        # arm — counter-delta based like the optimizer monitor, so
        # another run's violations never page this one
        self._integrity_base: Dict[str, int] = {}
        # recompute runaway: stage -> (first-seen-above-frac stamp on the
        # watchdog clock, redundant fraction at that stamp); unit
        # baselines at arm so another run's classified work never counts
        self._recompute: Dict[str, Tuple[float, float]] = {}
        self._recompute_base: Dict[str, Dict[str, int]] = {}

    # --- arming -----------------------------------------------------------
    def arm(self, now: Optional[float] = None) -> "Watchdog":
        """Subscribe to the store watch feed, baseline the meters, and
        register the debug route + readiness probe. Idempotent."""
        if self.armed:
            return self
        self.armed = True
        now = float(self.clock.now()) if now is None else float(now)
        self._last_tick = now
        if self.store is not None:
            self.store.watch("nodeclaim", self._on_claim_event)
            # seed the watchlist with claims that predate arming (a
            # restarted watchdog must still see the adopted fleet)
            for nc in self.store.nodeclaims.values():
                if not self._settled(nc):
                    self._claims[nc.name] = now
        from .devicemem import DEVICEMEM
        from .profile import LEDGER
        self._base_dropped = dict(getattr(TRACER.recorder,
                                          "dropped_by_tenant", {}))
        self._base_unattr = dict(LEDGER.unattributed_by_tenant())
        self._base_div = (float(self.warmpath.stats.get("divergences", 0))
                          if self.warmpath is not None else 0.0)
        self._devmem_base = frozenset(o["group"]
                                      for o in DEVICEMEM.orphans())
        from ..ops.resident import RESIDENT
        self._resident_base = frozenset(s["key"] for s in RESIDENT.stale())
        from ..ops.delta import DELTA
        self._delta_base = frozenset((st,) + tuple(k)
                                     for st, k, _ in DELTA.stale())
        from ..optimizer.stats import OPTIMIZER
        self._optimizer_base = dict(OPTIMIZER.reject_streaks())
        from ..integrity import INTEGRITY
        self._integrity_base = dict(INTEGRITY.violations_by_tenant())
        from .recompute import RECOMPUTE
        self._recompute_base = RECOMPUTE.stage_units()
        register_debug_route("/debug/watchdog",
                             lambda wd, query: wd.payload(query),
                             owner=self)
        # unique probe name per watchdog: a fleet arms one per shard and
        # /readyz must aggregate every LIVE one (dead refs prune lazily)
        register_readiness(f"watchdog-{id(self):x}",
                           lambda wd: wd.readiness(), owner=self)
        return self

    # --- store feed (O(1) per event) --------------------------------------
    @staticmethod
    def _settled(nc) -> bool:
        from ..models.nodeclaim import Phase
        return (bool(nc.provider_id) and nc.phase == Phase.INITIALIZED
                and not nc.is_deleting())

    def _on_claim_event(self, action: str, nc) -> None:
        if action == "delete":
            self._claims.pop(nc.name, None)
            self._clear("claim_leak", nc.name)  # resolved: re-arm edge
            return
        # add/update/delete-mark: (re)open the transition window — age is
        # measured from the LAST observed transition, not claim birth
        self._claims[nc.name] = float(self.clock.now())

    # --- evaluation -------------------------------------------------------
    def tick(self, now: Optional[float] = None,
             force: bool = False) -> List[Finding]:
        """Rate-limited evaluation; returns the findings fired by THIS
        call. The engine calls this every tick — the common case is one
        float compare and out."""
        if not self.armed:
            return []
        now = float(self.clock.now()) if now is None else float(now)
        self.stats["ticks"] += 1
        last = self._last_tick
        if not force and last is not None and now - last < self.interval:
            return []
        if last is not None and now - last > self.JUMP_THRESHOLD:
            self._absorb_jump(now - last)
        self._last_tick = now
        self.stats["evals"] += 1
        fired: List[Finding] = []
        self._check_claims(now, fired)
        self._check_journal(now, fired)
        self._check_warmpath(now, fired)
        self._check_fleet(now, fired)
        self._check_meters(now, fired)
        self._check_devicemem(now, fired)
        self._check_resident(now, fired)
        self._check_delta(now, fired)
        self._check_overload(now, fired)
        self._check_optimizer(now, fired)
        self._check_integrity(now, fired)
        self._check_recompute(now, fired)
        if self._last_sweep is None or force \
                or now - self._last_sweep >= self.CLOUD_SWEEP:
            self._last_sweep = now
            self._check_cloud(now, fired)
        self._publish_verdict()
        return fired

    def _absorb_jump(self, dt: float) -> None:
        """A clock jump (or a long untick'd stretch) must not age every
        tracked window at once: shift the stamps forward so observed
        ages stay continuous with the tick cadence."""
        shift = dt - self.interval
        self.stats["jump_absorbed"] += 1
        self._claims = {k: v + shift for k, v in self._claims.items()}
        self._drift = {k: v + shift for k, v in self._drift.items()}
        self._devmem = {k: v + shift for k, v in self._devmem.items()}
        self._resident = {k: v + shift for k, v in self._resident.items()}
        self._delta_stale = {k: v + shift
                             for k, v in self._delta_stale.items()}
        self._overload = {k: (t + shift, d)
                          for k, (t, d) in self._overload.items()}
        self._recompute = {k: (t + shift, f)
                           for k, (t, f) in self._recompute.items()}
        if self._audit_pending is not None:
            ps, seen = self._audit_pending
            self._audit_pending = (ps, seen + shift)

    # --- monitors ---------------------------------------------------------
    def _check_claims(self, now: float, fired: List[Finding]) -> None:
        if self.store is None:
            return
        for name in list(self._claims):
            nc = self.store.nodeclaims.get(name)
            if nc is None:
                self._claims.pop(name, None)
                continue
            if self._settled(nc):
                self._claims.pop(name, None)
                self._clear("claim_leak", name)
                continue
            age = now - self._claims[name]
            if age < self.claim_grace:
                continue
            if nc.is_deleting():
                what = "draining"
            elif not nc.provider_id:
                what = "unlaunched"
            else:
                what = f"stuck in phase {nc.phase}"
            self._fire(fired, "claim_leak", "critical", name,
                       f"claim {name} {what} for {age:.0f}s "
                       f"(grace {self.claim_grace:g}s)",
                       now, age_s=round(age, 1))

    def _check_cloud(self, now: float, fired: List[Finding]) -> None:
        """The store<->cloud sweep: bounded by live instances + store
        nodes, run on the slow cadence. Also the token-ledger duplicate
        checks — graceless, a duplicate is never in flight."""
        if self.cloud is None or self.store is None:
            return
        from ..models import labels as L
        insts = getattr(self.cloud, "instances", None)
        if insts is not None:  # in-process cloud: the full state map
            live = {iid: inst for iid, inst in insts.items()
                    if inst.state != "terminated"}
        else:  # wire client (RemoteCloud): one describe per slow sweep;
            # a throttled/unreachable cloud skips this sweep, it never
            # takes the watchdog (or the control plane) down
            from ..cloud.provider import CloudError
            try:
                live = {i.id: i for i in self.cloud.describe()
                        if i.state != "terminated"}
            except CloudError:
                return
        claim_iids = {c.provider_id.rsplit("/", 1)[-1]
                      for c in self.store.nodeclaims.values()
                      if c.provider_id}
        open_tokens: frozenset = frozenset()
        open_claims: frozenset = frozenset()
        if self.journal is not None:
            open_tokens = self.journal.open_tokens()
            open_claims = self.journal.open_claim_names()
        seen: set = set()
        by_token: Dict[str, list] = {}
        by_claim: Dict[str, list] = {}
        for iid, inst in live.items():
            tags = getattr(inst, "tags", None) or {}
            tok = tags.get(L.TAG_LAUNCH_TOKEN)
            claim = tags.get(L.TAG_NODECLAIM)
            if tok:
                by_token.setdefault(tok, []).append(iid)
            if claim:
                by_claim.setdefault(claim, []).append(iid)
            if claim and iid not in claim_iids:
                if tok in open_tokens or claim in open_claims:
                    continue  # an open intent owns this instance's fate
                key = f"orphan/{iid}"
                seen.add(key)
                first = self._drift.setdefault(key, now)
                if now - first >= self.ORPHAN_GRACE:
                    self._fire(fired, "store_cloud_drift", "critical", key,
                               f"instance {iid} karpenter-tagged but no "
                               f"claim tracks it for {now - first:.0f}s",
                               now, age_s=round(now - first, 1))
        dup_seen: set = set()
        for tok, iids in by_token.items():
            if len(iids) > 1:
                key = f"token/{tok[:12]}"
                dup_seen.add(key)
                self._fire(fired, "claim_leak", "critical", key,
                           f"idempotency token minted {len(iids)} live "
                           f"instances: {sorted(iids)[:3]}", now)
        for claim, iids in by_claim.items():
            if len(iids) > 1:
                key = f"dup-claim/{claim}"
                dup_seen.add(key)
                self._fire(fired, "claim_leak", "critical", key,
                           f"claim {claim} backed by {len(iids)} live "
                           f"instances: {sorted(iids)[:3]}", now)
        # a resolved duplicate (one copy terminated) clears its
        # excursion — the verdict must not read critical forever
        for inv, key in list(self._active):
            if inv == "claim_leak" and (key.startswith("token/")
                                        or key.startswith("dup-claim/")) \
                    and key not in dup_seen:
                self._clear(inv, key)
        for node in self.store.nodes.values():
            iid = node.provider_id.rsplit("/", 1)[-1]
            if iid in live:
                continue
            key = f"deadnode/{node.name}"
            seen.add(key)
            first = self._drift.setdefault(key, now)
            if now - first >= self.drift_grace:
                self._fire(fired, "store_cloud_drift", "critical", key,
                           f"store node {node.name} backs dead instance "
                           f"{iid} for {now - first:.0f}s", now,
                           age_s=round(now - first, 1))
        for key in list(self._drift):
            if key not in seen:   # condition cleared: re-arm the edge
                self._drift.pop(key, None)
                self._clear("store_cloud_drift", key)

    def _check_journal(self, now: float, fired: List[Finding]) -> None:
        if self.journal is None:
            return
        from ..controllers.gc import INTENT_GRACE
        open_names = set()
        for intent in self.journal.open_intents():
            age = now - intent.created_at
            if age < INTENT_GRACE:
                continue
            key = f"intent/{intent.claim_name}#{intent.seq}"
            open_names.add(key)
            self._fire(fired, "intent_age", "critical", key,
                       f"launch intent for {intent.claim_name} open "
                       f"{age:.0f}s (INTENT_GRACE {INTENT_GRACE:g}s) — "
                       f"wedged past the GC shield", now,
                       age_s=round(age, 1))
        for inv, key in list(self._active):
            if inv == "intent_age" and key not in open_names:
                self._clear("intent_age", key)

    def _check_warmpath(self, now: float, fired: List[Finding]) -> None:
        wp = self.warmpath
        if wp is None:
            return
        pending_since = getattr(wp.auditor, "pending_since", None)
        if pending_since is not None:
            # lag on the watchdog's observation clock (first tick that
            # saw THIS pending window), so _absorb_jump covers it —
            # `now - pending_since` would let a ClockJump age a
            # seconds-old batch into a fake finding
            if (self._audit_pending is None
                    or self._audit_pending[0] != pending_since):
                self._audit_pending = (pending_since, now)
            lag = now - self._audit_pending[1]
            if lag >= self.audit_lag_grace:
                self._fire(fired, "warm_audit_lag", "warning", "auditor",
                           f"warm admissions unaudited for {lag:.0f}s "
                           f"(grace {self.audit_lag_grace:g}s)", now,
                           lag_s=round(lag, 1))
        else:
            self._audit_pending = None
            self._clear("warm_audit_lag", "auditor")
        div = float(wp.stats.get("divergences", 0))
        if div > self._base_div:
            latency = (now - self._audit_pending[1]) \
                if self._audit_pending is not None else 0.0
            self._fire(fired, "warm_divergence", "warning",
                       f"div/{int(div)}",
                       f"warm-path audit divergence #{int(div)} "
                       f"(detection latency {latency:.1f}s) — path forced "
                       f"cold", now, divergences=div)
            self._base_div = div

    def _check_fleet(self, now: float, fired: List[Finding]) -> None:
        svc = self.service
        if svc is None:
            return
        backlog = svc.backlog()
        if backlog > self.backlog_max:
            self._fire(fired, "fleet_starvation", "warning", "backlog",
                       f"solver service backlog {backlog} tickets "
                       f"(max {self.backlog_max})", now, backlog=backlog)
        else:
            self._clear("fleet_starvation", "backlog")
        for tenant, state in svc.tenants.items():
            if state.max_wait >= self.starvation_s:
                self._fire(fired, "fleet_starvation", "warning", tenant,
                           f"tenant {tenant} worst virtual queueing delay "
                           f"{state.max_wait * 1e3:.0f}ms this window "
                           f"(threshold {self.starvation_s * 1e3:g}ms)",
                           now, max_wait_ms=round(state.max_wait * 1e3, 1))
            else:
                self._clear("fleet_starvation", tenant)
        self._check_pipeline(now, fired)
        self._check_federation(now, fired)

    def _check_pipeline(self, now: float, fired: List[Finding]) -> None:
        """The batched dispatcher's pipeline invariants (no-op on a
        serial service): a wedged in-flight batch, and a shape class
        whose co-pending tickets never co-batch."""
        svc = self.service
        state_fn = getattr(svc, "pipeline_state", None)
        if state_fn is None or not getattr(svc, "batch", False):
            return
        st = state_fn()
        age = st.get("inflight_age")
        if age is not None and age >= self.pipeline_grace:
            self._fire(fired, "pipeline_stall", "warning", "inflight",
                       f"device batch in flight for {age:.0f}s without a "
                       f"drain (grace {self.pipeline_grace:g}s)", now,
                       age_s=round(age, 1))
        else:
            self._clear("pipeline_stall", "inflight")
        for sc, cs in st.get("classes", {}).items():
            key = f"class/{sc}"
            if (cs.get("copending_pumps", 0) >= self.COBATCH_MIN_PUMPS
                    and cs.get("cobatched_pumps", 0) == 0):
                self._fire(fired, "pipeline_stall", "warning", key,
                           f"shape class {sc} co-pended >=2 tickets in "
                           f"{cs['copending_pumps']} pumps but never "
                           f"co-batched them", now,
                           copending=cs["copending_pumps"])
            else:
                self._clear("pipeline_stall", key)

    def _check_federation(self, now: float,
                          fired: List[Finding]) -> None:
        """The federation plane's degrade ladder, surfaced ONLINE: a
        wire failure arms the client's cooldown, and this fires while
        any cooldown is armed — so the first degraded bucket pages
        before a tenant SLO burns, and the finding clears itself once
        buckets cross the wire again (no-op on in-process services)."""
        svc = self.service
        state_fn = getattr(svc, "federation_state", None)
        if state_fn is None:
            return
        fs = state_fn()
        if fs.get("degraded"):
            self._fire(fired, "federation_degraded", "warning", "wire",
                       f"federated dispatch degraded to the local path: "
                       f"{fs['failures']} wire failure(s), cooldown "
                       f"{fs['cooldown']} bucket(s) remaining "
                       f"(last: {fs['last_error']})", now,
                       failures=fs["failures"], cooldown=fs["cooldown"])
        else:
            self._clear("federation_degraded", "wire")
        # the LADDER's own invariant: degraded past the grace while the
        # healthz probes come back clean means the breaker is stuck —
        # the recovery machinery itself is the bug, not the server
        degraded_for = fs.get("degraded_for", 0.0)
        if (fs.get("degraded") and degraded_for >= self.REJOIN_GRACE
                and fs.get("probe_ok_degraded", 0) > 0):
            self._fire(fired, "federation_rejoin", "warning", "wire",
                       f"federation stuck degraded for "
                       f"{degraded_for:.0f}s (grace "
                       f"{self.REJOIN_GRACE:g}s) despite "
                       f"{fs['probe_ok_degraded']} clean healthz "
                       f"probe(s) — the rejoin ladder is not closing "
                       f"the breaker (state {fs.get('breaker', '?')})",
                       now, degraded_for=round(degraded_for, 1),
                       probes_ok=fs["probe_ok_degraded"],
                       breaker=fs.get("breaker", ""))
        else:
            self._clear("federation_rejoin", "wire")

    def _check_meters(self, now: float, fired: List[Finding]) -> None:
        from .profile import LEDGER
        cur_unattr = LEDGER.unattributed_by_tenant()
        tenant_fired = False
        for tenant, unattr in cur_unattr.items():
            gap = unattr - self._base_unattr.get(tenant, 0.0)
            if gap >= self.UNATTRIBUTED_MS:
                tenant_fired = True
                self._fire(fired, "profile_unattributed", "info",
                           f"ledger/{tenant}",
                           f"phase ledger unattributed gap for tenant "
                           f"{tenant} grew {gap:.1f}ms since last "
                           f"excursion", now, tenant=tenant,
                           gap_ms=round(gap, 3))
                self._base_unattr[tenant] = unattr
        # DIFFUSE growth: many tenants each under the per-tenant
        # threshold must still trip the process-aggregate one — the
        # per-tenant split must never RAISE the effective threshold by
        # the tenant count. Firing advances every baseline, so the same
        # diffuse excursion is counted once.
        agg_gap = sum(cur_unattr.values()) \
            - sum(self._base_unattr.get(t, 0.0) for t in cur_unattr)
        if not tenant_fired and agg_gap >= self.UNATTRIBUTED_MS:
            self._fire(fired, "profile_unattributed", "info", "ledger",
                       f"phase ledger unattributed gap grew "
                       f"{agg_gap:.1f}ms across tenants since last "
                       f"excursion", now, gap_ms=round(agg_gap, 3))
            self._base_unattr.update(cur_unattr)
        drops = dict(getattr(TRACER.recorder, "dropped_by_tenant", {}))
        tenant_fired = False
        for tenant, dropped in drops.items():
            delta = dropped - self._base_dropped.get(tenant, 0)
            if delta >= self.RING_DROPS:
                tenant_fired = True
                self._fire(fired, "trace_ring_overflow", "info",
                           f"ring/{tenant}",
                           f"flight recorder rejected {delta} of tenant "
                           f"{tenant}'s traces since last excursion "
                           f"(ring size {TRACER.recorder.size})",
                           now, tenant=tenant, dropped=delta)
                self._base_dropped[tenant] = dropped
        agg_drop = sum(drops.values()) \
            - sum(self._base_dropped.get(t, 0) for t in drops)
        if not tenant_fired and agg_drop >= self.RING_DROPS:
            self._fire(fired, "trace_ring_overflow", "info", "ring",
                       f"flight recorder rejected {agg_drop} traces "
                       f"across tenants since last excursion (ring "
                       f"size {TRACER.recorder.size})", now,
                       dropped=agg_drop)
            self._base_dropped.update(drops)

    def _check_devicemem(self, now: float, fired: List[Finding]) -> None:
        """Device buffers outliving their owner (residency-ledger
        orphans) past the devicemem grace — aged on the watchdog's
        observation clock like every other window, pre-arm residue
        excluded."""
        from .devicemem import DEVICEMEM
        seen: set = set()
        for o in DEVICEMEM.orphans():
            gid = o["group"]
            if gid in self._devmem_base:
                continue
            seen.add(gid)
            first = self._devmem.setdefault(gid, now)
            age = now - first
            if age < self.DEVICEMEM_GRACE:
                continue
            self._fire(fired, "devicemem_leak", "warning",
                       f"group/{gid}",
                       f"{o['bytes']} device bytes ({o['kind']}"
                       f"{', token ' + o['token'] if o['token'] else ''}) "
                       f"outlive their dead owner for {age:.0f}s "
                       f"(grace {self.DEVICEMEM_GRACE:g}s)", now,
                       tenant=o.get("tenant"), kind=o["kind"],
                       leaked_bytes=o["bytes"], age_s=round(age, 1))
        for gid in list(self._devmem):
            if gid not in seen:   # buffers finally freed: re-arm edge
                self._devmem.pop(gid, None)
                self._clear("devicemem_leak", f"group/{gid}")

    def _check_resident(self, now: float, fired: List[Finding]) -> None:
        """Device-resident delta buffers whose catalog token the world
        moved past (ops/resident.RESIDENT.stale()) — aged on the
        watchdog's observation clock, jump-absorbed, pre-arm residue
        excluded. A healthy view clears itself: its next solve re-keys
        the entry (full re-upload) or an invalidation drops it."""
        from ..ops.resident import RESIDENT
        seen: set = set()
        for s in RESIDENT.stale():
            key = s["key"]
            if key in self._resident_base:
                continue
            seen.add(key)
            first = self._resident.setdefault(key, now)
            age = now - first
            if age < self.RESIDENT_GRACE:
                continue
            kstr = "/".join(str(t) for t in key)
            self._fire(fired, "resident_staleness", "warning",
                       f"view/{kstr}",
                       f"resident buffer {kstr} encodes catalog token "
                       f"{s['token']} but the store serves {s['base']} — "
                       f"stale for {age:.0f}s "
                       f"(grace {self.RESIDENT_GRACE:g}s)", now,
                       age_s=round(age, 1))
        for key in list(self._resident):
            if key not in seen:   # refreshed or invalidated: re-arm edge
                self._resident.pop(key, None)
                kstr = "/".join(str(t) for t in key)
                self._clear("resident_staleness", f"view/{kstr}")

    def _check_delta(self, now: float, fired: List[Finding]) -> None:
        """Delta-plane memo entries stuck at audit-due
        (ops/delta.DELTA.stale()) — serve() refuses them, so the entry
        costs nothing to correctness, but a lingering one means its
        owning loop stopped running the fresh confirm/diverge pass the
        serve-and-verify contract promises. Aged on the watchdog's
        observation clock, jump-absorbed, pre-arm residue excluded. A
        healthy key clears itself: the owner's next pass confirms (the
        counter resets) or diverges (the entry drops)."""
        from ..ops.delta import DELTA
        seen: set = set()
        for stage, key, since in DELTA.stale():
            ik = (stage,) + tuple(key)
            if ik in self._delta_base:
                continue
            seen.add(ik)
            first = self._delta_stale.setdefault(ik, now)
            age = now - first
            if age < self.DELTA_GRACE:
                continue
            kstr = "/".join(str(t) for t in ik)
            self._fire(fired, "delta_staleness", "warning",
                       f"memo/{kstr}",
                       f"delta memo {kstr} audit-due for {since} serves "
                       f"and unconfirmed for {age:.0f}s "
                       f"(grace {self.DELTA_GRACE:g}s)", now,
                       stage=stage, since_confirm=int(since),
                       age_s=round(age, 1))
        for ik in list(self._delta_stale):
            if ik not in seen:   # confirmed, diverged, or evicted
                self._delta_stale.pop(ik, None)
                kstr = "/".join(str(t) for t in ik)
                self._clear("delta_staleness", f"memo/{kstr}")

    def _check_overload(self, now: float, fired: List[Finding]) -> None:
        """An open-loop tenant's waiting-pod depth above the admission
        budget and still not shrinking (or its oldest parked arrival
        still aging) past the overload grace — admission control should
        have engaged. Aged on the watchdog's observation clock so a
        chaos ClockJump cannot turn one slow window into a finding."""
        lg = self.loadgen
        if lg is None:
            return
        state = lg.overload_state() or {}
        over: set = set()
        for tenant, row in state.items():
            depth = int(row.get("depth", 0))
            budget = int(row.get("budget", 0) or 0)
            if budget <= 0 or depth <= budget:
                continue
            over.add(tenant)
            first = self._overload.get(tenant)
            if first is None:
                self._overload[tenant] = (now, depth)
                continue
            t0, d0 = first
            age = now - t0
            if age < self.overload_grace:
                continue
            oldest = float(row.get("oldest_age_s", 0.0))
            if depth >= d0 or oldest >= self.overload_grace:
                self._fire(fired, "overload_unbounded", "critical", tenant,
                           f"tenant {tenant} waiting-pod depth {depth} "
                           f"above the admission budget {budget} and not "
                           f"shrinking for {age:.0f}s (grace "
                           f"{self.overload_grace:g}s; shedding "
                           f"{'armed' if row.get('armed') else 'DISABLED'})",
                           now, tenant=tenant, depth=depth, budget=budget,
                           age_s=round(age, 1),
                           oldest_age_s=round(oldest, 1),
                           armed=bool(row.get("armed")))
        for tenant in list(self._overload):
            if tenant not in over:   # backlog back under budget: re-arm
                self._overload.pop(tenant, None)
                self._clear("overload_unbounded", tenant)

    def _check_optimizer(self, now: float, fired: List[Finding]) -> None:
        """The global disruption optimizer's exact-verify contract as a
        quality monitor: a tenant whose consecutive-reject streak (the
        relaxation ranking proposing, Solver.solve() refusing) grew past
        the divergence threshold since arm fires a warning; any accept
        resets the streak and clears the excursion. Counter-delta based
        like the ring/ledger meters — no clock window to jump-absorb."""
        from ..optimizer.stats import OPTIMIZER
        streaks = OPTIMIZER.reject_streaks()
        for tenant, streak in streaks.items():
            delta = streak - self._optimizer_base.get(tenant, 0)
            if delta >= self.OPTIMIZER_STREAK:
                self._fire(fired, "optimizer_divergence", "warning",
                           tenant,
                           f"tenant {tenant}: {delta} consecutive "
                           f"optimizer subsets rejected by exact "
                           f"verification (threshold "
                           f"{self.OPTIMIZER_STREAK}) — relaxation "
                           f"scoring has diverged from solve semantics",
                           now, tenant=tenant, streak=streak)
            else:
                self._clear("optimizer_divergence", tenant)
                # a cleared excursion re-baselines: the NEXT divergence
                # is a fresh streak, not the old one plus noise
                if streak == 0:
                    self._optimizer_base.pop(tenant, None)

    def _check_integrity(self, now: float, fired: List[Finding]) -> None:
        """The solution-integrity plane's violation counters as a page:
        a tenant whose oracle/canary/resident-audit violation count
        advanced since arm fires a critical finding (an answer the
        system was about to ship was provably wrong — the recovery path
        contains it, the page says it happened). Counter-delta based;
        the excursion clears once no new violations arrive and every
        past one was recovered (the host re-solve passed the oracle) —
        an UNRECOVERED violation holds the verdict critical."""
        from ..integrity import INTEGRITY
        cur = INTEGRITY.violations_by_tenant()
        for tenant, count in cur.items():
            delta = count - self._integrity_base.get(tenant, 0)
            if delta > 0:
                self._fire(fired, "integrity_breach", "critical", tenant,
                           f"tenant {tenant}: {delta} solution-integrity "
                           f"violation(s) since the last excursion — a "
                           f"device-path answer failed the feasibility "
                           f"oracle / canary / resident audit", now,
                           tenant=tenant, violations=delta)
                self._integrity_base[tenant] = count
            elif INTEGRITY.unrecovered(tenant) == 0:
                self._clear("integrity_breach", tenant)

    def _check_recompute(self, now: float, fired: List[Finding]) -> None:
        """A recompute-taxonomy stage whose REDUNDANT work fraction sits
        above RECOMPUTE_FRAC and is still RISING past the grace window —
        the stage is grinding identical inputs every reconcile and no
        memo/cache/residency layer is serving the delta. A warm steady
        cluster legitimately plateaus high (that plateau IS the measured
        headroom, not a fault), so a steady fraction never fires: only
        growth beyond RECOMPUTE_RISE over the grace does. Unit counts
        baseline at arm (another run's classified residue never counts)
        and the excursion stamp is jump-absorbed like every window."""
        from .recompute import RECOMPUTE
        units = RECOMPUTE.stage_units()
        for stage, row in units.items():
            base = self._recompute_base.get(stage, {})
            total = red = 0
            for outcome, n in row.items():
                d = n - base.get(outcome, 0)
                total += d
                if outcome == "redundant":
                    red += d
            if total < self.RECOMPUTE_MIN_UNITS:
                continue
            frac = red / total
            if frac <= self.RECOMPUTE_FRAC:
                self._recompute.pop(stage, None)
                self._clear("recompute_runaway", stage)
                continue
            first = self._recompute.get(stage)
            if first is None:
                self._recompute[stage] = (now, frac)
                continue
            t0, f0 = first
            age = now - t0
            if age >= self.RECOMPUTE_GRACE and frac > f0 + self.RECOMPUTE_RISE:
                self._fire(fired, "recompute_runaway", "warning", stage,
                           f"stage {stage}: redundant work fraction "
                           f"{frac:.3f} above {self.RECOMPUTE_FRAC:g} and "
                           f"still rising (was {f0:.3f} {age:.0f}s ago, "
                           f"grace {self.RECOMPUTE_GRACE:g}s) over "
                           f"{total} classified units — the stage "
                           f"recomputes unchanged inputs every pass and "
                           f"nothing serves the delta", now,
                           stage=stage, frac=round(frac, 4),
                           first_frac=round(f0, 4), units=total,
                           age_s=round(age, 1))

    # --- firing / clearing ------------------------------------------------
    def _fire(self, fired: List[Finding], invariant: str, severity: str,
              key: str, message: str, now: float, **attrs) -> None:
        edge = (invariant, key)
        with self._lock:
            if edge in self._active:
                return
            self._active[edge] = severity
            f = Finding(invariant=invariant, severity=severity, key=key,
                        message=message, at=now, attrs=attrs)
            self.findings.append(f)
            if len(self.findings) > self.MAX_FINDINGS:
                del self.findings[:len(self.findings) - self.MAX_FINDINGS]
            self._fired[invariant] = self._fired.get(invariant, 0) + 1
            self.stats["findings"] += 1
        fired.append(f)
        from ..metrics import WATCHDOG_FINDINGS
        tenant = attrs.get("tenant")
        if tenant:
            # a finding about a SPECIFIC tenant's meter attributes to
            # that tenant even when the ticking thread is unscoped (a
            # service-level watchdog watching process-global meters)
            WATCHDOG_FINDINGS.inc(invariant=invariant, severity=severity,
                                  tenant=str(tenant))
        else:
            WATCHDOG_FINDINGS.inc(invariant=invariant, severity=severity)
        self._flight_record(f)

    def _clear(self, invariant: str, key: str) -> None:
        with self._lock:
            self._active.pop((invariant, key), None)

    def _flight_record(self, f: Finding) -> None:
        marker = Span(name="watchdog.finding",
                      trace_id=f"watchdog-{f.invariant}-{f.key}-"
                               f"{int(f.at)}",
                      span_id=0, parent_id=None, t0=0.0, t1=1e-6,
                      ts=f.at, attrs=f.to_dict())
        # meter=False: a rejected self-marker must not count toward the
        # overflow meter the watchdog itself reads (findings would
        # manufacture findings) nor export as a tenant's drop
        TRACER.recorder.offer(Trace(trace_id=marker.trace_id,
                                    spans=[marker]), meter=False)

    # --- read side --------------------------------------------------------
    def fired(self, invariant: str) -> int:
        """Lifetime finding count for one invariant (the runners'
        found-it-first cross-check reads this)."""
        return self._fired.get(invariant, 0)

    def findings_at_least(self, severity: str = "warning") -> int:
        rank = _SEV_RANK[severity]
        with self._lock:
            return sum(1 for f in self.findings
                       if _SEV_RANK[f.severity] >= rank)

    def verdict(self) -> str:
        """Worst severity among ACTIVE excursions: 'ok', 'warning', or
        'critical' — the readiness signal. Reads the excursion map, not
        the bounded findings log: trimming old log entries must never
        amnesty a live violation."""
        with self._lock:
            worst = max((_SEV_RANK[s] for s in self._active.values()),
                        default=-1)
        if worst < 0:
            return "ok"
        return SEVERITIES[worst]

    def readiness(self) -> Tuple[bool, dict]:
        v = self.verdict()
        return v != "critical", {"verdict": v,
                                 "active": len(self._active),
                                 "findings": self.stats["findings"]}

    def _publish_verdict(self) -> None:
        from ..metrics import WATCHDOG_VERDICT
        WATCHDOG_VERDICT.set(float(_SEV_RANK.get(self.verdict(), 0)))

    def cross_check(self, violations: List[str]) -> List[str]:
        """The end-of-run asserts as 'watchdog found it first' checks:
        every violation with an online monitor must have fired a finding
        during (or at the end of) the run; a miss is a watchdog blind
        spot — itself a violation of the verification plane."""
        blind: List[str] = []
        missed: set = set()
        for v in violations:
            for needle, invariant in _VIOLATION_MAP:
                if needle in v and not self.fired(invariant):
                    missed.add((invariant, needle))
        for invariant, needle in sorted(missed):
            blind.append(f"watchdog blind spot: end-of-run '{needle}' "
                         f"violation but the {invariant} monitor never "
                         f"fired")
        return blind

    def payload(self, query: str = "") -> dict:
        with self._lock:
            findings = [f.to_dict() for f in self.findings]
        findings.sort(key=lambda f: (-_SEV_RANK[f["severity"]], -f["at"]))
        return {"armed": self.armed,
                "verdict": self.verdict(),
                "invariants": list(INVARIANTS),
                "interval_s": self.interval,
                "graces": {"claim_s": self.claim_grace,
                           "drift_s": self.drift_grace,
                           "orphan_s": self.ORPHAN_GRACE,
                           "audit_lag_s": self.audit_lag_grace,
                           "starvation_s": self.starvation_s,
                           "backlog_max": self.backlog_max,
                           "pipeline_s": self.pipeline_grace,
                           "devicemem_s": self.DEVICEMEM_GRACE,
                           "resident_s": self.RESIDENT_GRACE,
                           "delta_s": self.DELTA_GRACE,
                           "overload_s": self.overload_grace,
                           "optimizer_streak": self.OPTIMIZER_STREAK,
                           "recompute_s": self.RECOMPUTE_GRACE,
                           "recompute_frac": self.RECOMPUTE_FRAC},
                "stats": dict(self.stats),
                "fired": dict(self._fired),
                "watchlist": {"claims": len(self._claims),
                              "drift": len(self._drift)},
                "findings": findings}
