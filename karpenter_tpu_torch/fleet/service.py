"""SolverService: one solver, many tenants, fair dispatch.

The port's copy of `karpenter_tpu/fleet/service.py`. The fleet funnels
every tenant shard's solve through this service, so the expensive
resource (the device-backed solve path and its device-resident catalog
tensors) is owned once and multiplexed.

Mechanics:

- each tenant registers its CatalogProvider and gets back a
  `TenantSolverClient`, a drop-in `ops.facade.Solver` stand-in whose
  `solve()` submits a `SolveTicket` to the service queue and blocks on
  its future; everything host-side (tensors, encode, screens) delegates
  straight to the tenant's facade.
- the per-tenant facades share one `SharedCatalogCache`, so tenants
  running identical pools share encoded catalog tensors and device
  uploads.
- dispatch order is DEFICIT ROUND-ROBIN over tenants with queued work,
  lightest backlog first within a round: a tenant storming the queue
  cannot push another tenant's single solve behind its whole backlog.
- a per-tenant IN-FLIGHT CAP per scheduling window backpressures storms:
  submissions beyond it raise `SolverServiceBusy` (a retryable
  CloudError) and meter `fleet_throttled_total{tenant}`.

Determinism: every ticket executes synchronously at dispatch; the
scheduler's VIRTUAL device timeline (a deterministic per-request cost
model, not wall time) meters waits and starvation reproducibly.

Batched dispatch (`batch=True`): pump() stages every queued ticket first
(the facade's prepare_solve), then tickets whose padded shape class AND
device catalog agree pack into ONE launch of kernels B0 and B along a
request axis (ops/solver.dispatch_batch); while that batch runs on the
card, the pump stages and uploads the next bucket and runs non-batchable
tickets' host solves. Results equal serial dispatch, the DRR order decides
staging and bucket order, and the virtual timeline is untouched.

The port's fault contract differs from the reference's on purpose: a
bucket degrades to serial re-runs only on `ops/solver.InjectedFault` (the
fault-injection seam); a kernel's or a readback's error raises out of
`pump()` (ROADMAP §3). The open-loop `AdmissionController` gives each
offered arrival batch of loadgen/ its admit, defer or shed verdict. A refused submission's pods
are noted with the explain recorder, and the fleet watchdog reads
`backlog()`, each tenant's `max_wait` and `pipeline_state()`. A bucket
whose membership repeats the previous pump's keeps its stacked request
matrix resident on the card (`_bucket_resident_key`).
"""

from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..cloud.provider import CloudError
from ..metrics import (FLEET_BATCH_SIZE, FLEET_QUEUE_DEPTH,
                       FLEET_SHAPE_CLASS, FLEET_SOLVE_WAIT, FLEET_SOLVES,
                       FLEET_STARVATION, FLEET_THROTTLED, LOADGEN_ADMITTED,
                       LOADGEN_DEFERRED, LOADGEN_SHED, PIPELINE_INFLIGHT)
from ..metrics.tenant import tenant_scope
from ..obs.tracer import NOOP_SPAN, TRACER
from ..ops import solver as ops_solver


def _span(name: str, **attrs):
    return TRACER.span(name, **attrs) if TRACER.enabled else NOOP_SPAN


class SolverServiceBusy(CloudError):
    """The tenant already has its in-flight cap of solve requests in the
    current scheduling window. Retryable: the reconcile that hit it backs
    off and resubmits next window; pods stay pending, nothing is lost."""

    retryable = True


@dataclass
class SolveTicket:
    """One queued solve request: the future a shard blocks on."""

    tenant: str
    kind: str                 # "solve" (the only queued kind today)
    seq: int
    submitted_at: float       # sim time
    cost: float               # virtual device seconds (cost model)
    done: bool = False
    value: object = None
    error: Optional[BaseException] = None
    wait: float = 0.0         # virtual queueing delay, seconds
    # batched-dispatch provenance (0/-1/"" on the serial pump):
    batch_size: int = 0       # requests in the device call that served it
    shape_class: str = ""     # padded solve signature ("g<Gp>/n<n_max>")
    dispatch_rank: int = -1   # DRR drain position within its pump

    def result(self):
        """Block on the future. The fleet is single-threaded, so by the
        time a caller reaches this the service pump has already run the
        ticket: a not-done ticket is a service bug, not a race."""
        if not self.done:
            raise RuntimeError(f"ticket {self.tenant}#{self.seq} never "
                               f"dispatched")
        if self.error is not None:
            raise self.error
        return self.value


class TenantSolverClient:
    """Per-tenant `Solver` stand-in: `solve()` goes through the service
    queue; every other facade capability (`tensors`, `stats`, backend
    fields) delegates to the tenant's own facade."""

    def __init__(self, service: "SolverService", tenant: str, facade):
        self._service = service
        self.tenant = tenant
        self.facade = facade

    def solve(self, pods, *args, **kwargs):
        try:
            ticket = self._submit(pods, args, kwargs)
        except SolverServiceBusy:
            # decision provenance for the refusal: the solve never ran,
            # so the solver can't explain these pods — the throttle
            # itself is the causal trail (/debug/explain shows
            # binding_constraint=fleet_inflight_cap until a later solve
            # places them and preserves the throttle count)
            self._note_throttle(pods)
            raise
        self._service.pump()
        return ticket.result()

    def solve_async(self, pods, *args, **kwargs) -> SolveTicket:
        """Submit without pumping: the ticket resolves at the service's
        next pump(), co-batching with whatever else is queued by then.
        Throttles exactly like solve()."""
        try:
            return self._submit(pods, args, kwargs)
        except SolverServiceBusy:
            self._note_throttle(pods)
            raise

    def _note_throttle(self, pods) -> None:
        from ..obs.explain import RECORDER
        if RECORDER.enabled:
            RECORDER.note_throttle(
                self.tenant, [f"{p.namespace}/{p.name}" for p in pods])

    def _submit(self, pods, args, kwargs) -> SolveTicket:
        cost = self._service.cost_model(len(pods))
        return self._service.submit_solve(self.tenant, pods, args, kwargs,
                                          cost=cost)

    def __getattr__(self, name):
        return getattr(self.facade, name)


@dataclass
class _TenantState:
    # jobs dispatched this window, in arrival order: (seq, cost)
    window_jobs: List[Tuple[int, float]] = field(default_factory=list)
    window_cost: float = 0.0
    # tickets submitted but not yet picked by a pump: counted against the
    # in-flight cap alongside window_jobs, or solve_async could queue an
    # unbounded storm between pumps
    queued: int = 0
    max_wait: float = 0.0          # worst wait this window (starvation)
    solves: int = 0                # lifetime dispatches
    throttled: int = 0             # lifetime cap rejections
    wall_seconds: float = 0.0      # measured host time inside dispatches
    # (sim_time, virtual wait, virtual cost) per dispatch; a ring, so a
    # long-lived fleet process does not accumulate samples without bound
    samples: "deque[Tuple[float, float, float]]" = field(
        default_factory=lambda: deque(maxlen=8192))


@dataclass(frozen=True)
class AdmissionDecision:
    """One admission verdict for an offered arrival batch."""

    action: str               # "admit" | "defer" | "shed"
    reason: str = ""          # shed reason / defer trigger
    delay: float = 0.0        # re-offer backoff (defer only), sim seconds


class AdmissionController:
    """Per-tenant queue-depth and in-flight budgets for the OPEN-LOOP
    serving path (loadgen/): the closed-loop runners wait for drain, so
    the in-flight cap alone bounds them — an open-loop arrival process
    does not wait, and without an explicit admission verdict a saturated
    tenant's pending-pod backlog grows without bound. Three-way verdict
    per offered batch:

    - ADMIT while the tenant's PENDING depth (unplaced pods in its
      store) stays under the defer budget AND its solve tickets queued
      in the shared service stay under the in-flight budget;
    - DEFER past either soft budget: the batch is parked and re-offered
      after a SEED-DETERMINISTIC backoff (exponential schedule plus a
      jitter hashed from (seed, batch key, attempt) — no RNG stream is
      consumed, so arrivals and faults draw exactly what they would
      without backpressure, the repeat contract). The soft budget reads
      PENDING depth only — parked batches must not count against the
      budget their own re-offers are judged by, or the waiting room
      would wedge itself shut (every re-offer seeing the queue it is
      part of);
    - SHED past the hard budget — pending + deferred + arriving, the
      total work-in-system bound — or once a batch exhausts its
      re-offer attempts: the batch is dropped and metered
      `loadgen_shed_total{tenant,reason}` — overload degrades into a
      bounded queue plus an explicit, attributable drop rate instead of
      an unbounded backlog (the watchdog's overload_unbounded invariant
      polices exactly that bound).

    `enabled=False` keeps the verdicts flowing as ADMIT while still
    carrying the budgets — the watchdog reads them as the threshold the
    controller SHOULD have engaged at (the fires-with-shedding-disabled
    acceptance check).

    `rate_limit` (pods per sim second, per tenant) adds a RATE budget on
    top of the depth budgets: a token bucket refilled by sim time (burst
    capacity `rate_burst`, default 2x the rate) charged by first offers
    only — a tenant arriving faster than its configured rate sheds the
    excess with reason `rate` even while its queue is empty (depths
    bound work-in-system; rates bound work-per-second). Deterministic
    like everything else here: the bucket advances on the caller's sim
    clock, no RNG, so the repeat contract covers the shed set.
    """

    DEFER_DEPTH = 192         # waiting pods before soft backpressure
    SHED_DEPTH = 384          # waiting pods before drops (the hard bound)
    INFLIGHT_BUDGET = 8       # queued service tickets before deferring
    MAX_DEFERS = 6            # re-offers before a batch is shed
    BACKOFF_BASE = 2.0        # first defer delay, sim seconds
    BACKOFF_MAX = 30.0        # backoff ceiling

    def __init__(self, service: Optional["SolverService"] = None,
                 defer_depth: Optional[int] = None,
                 shed_depth: Optional[int] = None,
                 inflight_budget: Optional[int] = None,
                 max_defers: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_max: Optional[float] = None,
                 rate_limit: Optional[float] = None,
                 rate_burst: Optional[float] = None,
                 enabled: bool = True, seed: int = 0):
        self.service = service
        # per-tenant arrival-rate budget (None = no rate limiting):
        # tenant -> (tokens, last sim stamp). is-None checks throughout:
        # rate_limit=0.0 is a legitimate "admit nothing" budget, not an
        # unset one
        self.rate_limit = None if rate_limit is None else float(rate_limit)
        if rate_burst is not None:
            self.rate_burst: Optional[float] = float(rate_burst)
        elif self.rate_limit is not None:
            self.rate_burst = 2.0 * self.rate_limit
        else:
            self.rate_burst = None
        self._rate_buckets: Dict[str, Tuple[float, float]] = {}
        self.defer_depth = (self.DEFER_DEPTH if defer_depth is None
                            else int(defer_depth))
        self.shed_depth = (self.SHED_DEPTH if shed_depth is None
                           else int(shed_depth))
        self.inflight_budget = (self.INFLIGHT_BUDGET
                                if inflight_budget is None
                                else int(inflight_budget))
        self.max_defers = (self.MAX_DEFERS if max_defers is None
                           else int(max_defers))
        self.backoff_base = (self.BACKOFF_BASE if backoff_base is None
                             else float(backoff_base))
        self.backoff_max = (self.BACKOFF_MAX if backoff_max is None
                            else float(backoff_max))
        self.enabled = bool(enabled)
        self.seed = int(seed)
        self.stats: Dict[str, Dict[str, int]] = {}

    def _tstats(self, tenant: str) -> Dict[str, int]:
        return self.stats.setdefault(tenant, {
            "offered": 0, "admitted": 0, "deferred": 0, "shed": 0})

    def backoff(self, key: str, attempts: int) -> float:
        """Deterministic re-offer delay: exponential in the attempt
        count, jittered by a hash of (seed, batch key, attempt) so two
        tenants' deferred batches do not re-offer in lockstep — and no
        RNG stream is consumed (same seed, same delays, always)."""
        import hashlib
        base = min(self.backoff_base * (2 ** max(0, attempts)),
                   self.backoff_max)
        h = int.from_bytes(
            hashlib.sha256(f"{self.seed}|{key}|{attempts}".encode())
            .digest()[:4], "big")
        return round(base * (0.75 + 0.5 * h / 0xFFFFFFFF), 6)

    def _rate_exhausted(self, tenant: str, arriving: int,
                        now: Optional[float]) -> bool:
        """Advance the tenant's token bucket to `now` and try to charge
        `arriving` tokens; True = the rate budget is exhausted (shed).
        Only first offers are charged — a deferred batch paid on its
        original arrival."""
        if self.rate_limit is None or now is None:
            return False
        tokens, last = self._rate_buckets.get(
            tenant, (self.rate_burst, None))
        if last is not None:
            tokens = min(self.rate_burst,
                         tokens + (float(now) - last) * self.rate_limit)
        if arriving > tokens:
            self._rate_buckets[tenant] = (tokens, float(now))
            return True
        self._rate_buckets[tenant] = (tokens - arriving, float(now))
        return False

    def decide(self, tenant: str, pending: int, deferred: int,
               arriving: int, attempts: int = 0,
               key: str = "",
               now: Optional[float] = None) -> AdmissionDecision:
        """Verdict for one offered batch of `arriving` pods while the
        tenant has `pending` unplaced pods in its store and `deferred`
        pods parked in the generator's waiting room (EXCLUDING this
        batch when it is a re-offer). Meters the defer/shed families;
        the caller records the canonical ledger entry (the fingerprint
        lives with the LoadPlan). `now` (sim time) feeds the optional
        per-tenant arrival-rate budget."""
        st = self._tstats(tenant)
        if attempts == 0:
            st["offered"] += arriving
        if not self.enabled:
            st["admitted"] += arriving
            LOADGEN_ADMITTED.inc(arriving, tenant=tenant)
            return AdmissionDecision("admit")
        if attempts == 0 and self._rate_exhausted(tenant, arriving, now):
            st["shed"] += arriving
            LOADGEN_SHED.inc(arriving, tenant=tenant, reason="rate")
            return AdmissionDecision("shed", "rate")
        depth = pending + deferred + arriving
        if depth > self.shed_depth:
            st["shed"] += arriving
            LOADGEN_SHED.inc(arriving, tenant=tenant, reason="queue_depth")
            return AdmissionDecision("shed", "queue_depth")
        if attempts >= self.max_defers:
            st["shed"] += arriving
            LOADGEN_SHED.inc(arriving, tenant=tenant, reason="defer_budget")
            return AdmissionDecision("shed", "defer_budget")
        queued = 0
        if self.service is not None:
            state = self.service.tenants.get(tenant)
            queued = state.queued if state is not None else 0
        if pending + arriving > self.defer_depth \
                or queued >= self.inflight_budget:
            st["deferred"] += arriving
            LOADGEN_DEFERRED.inc(tenant=tenant)
            trigger = ("inflight" if queued >= self.inflight_budget
                       else "queue_depth")
            # tenant is part of the jitter key: batch keys are PLAN-local
            # (every tenant's schedule starts at a000000), so without it
            # tenants replaying one trace would re-offer in lockstep
            return AdmissionDecision(
                "defer", trigger,
                delay=self.backoff(f"{tenant}|{key}", attempts))
        st["admitted"] += arriving
        LOADGEN_ADMITTED.inc(arriving, tenant=tenant)
        return AdmissionDecision("admit")

    def snapshot(self) -> dict:
        return {"enabled": self.enabled,
                "defer_depth": self.defer_depth,
                "shed_depth": self.shed_depth,
                "inflight_budget": self.inflight_budget,
                "max_defers": self.max_defers,
                "rate_limit": self.rate_limit,
                "rate_burst": self.rate_burst,
                "tenants": {t: dict(s)
                            for t, s in sorted(self.stats.items())}}


class SolverService:
    """The shared solve queue + fair scheduler. One per fleet process."""

    # virtual scheduling quantum (seconds of modeled device time) each
    # tenant earns per DRR round: small relative to a solve so light
    # tenants are served ahead of a heavy tenant's backlog
    QUANTUM = 0.005
    # scheduling-window length in sim seconds: the in-flight cap and the
    # DRR backlog both reset each window
    WINDOW = 5.0
    # per-tenant dispatch cap per window
    INFLIGHT_CAP = 16
    # most requests one batched launch may pack (the request axis pads to
    # {1,2,3,4,6,8,12,16,...})
    MAX_BATCH = 16

    def __init__(self, clock, backend: str = "host",
                 inflight_cap: Optional[int] = None,
                 quantum: Optional[float] = None,
                 window: Optional[float] = None,
                 shared_catalog=None,
                 batch: bool = False,
                 max_batch: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 device=None):
        """device: where the tenant facades' device rung runs (the CUDA
        card unless given; "cpu" runs the kernels' plain versions)."""
        from ..ops.facade import SharedCatalogCache
        self.clock = clock
        self.backend = backend
        self.device = device
        self.inflight_cap = (self.INFLIGHT_CAP if inflight_cap is None
                             else int(inflight_cap))
        self.quantum = self.QUANTUM if quantum is None else float(quantum)
        self.window = self.WINDOW if window is None else float(window)
        self.shared_catalog = (shared_catalog if shared_catalog is not None
                               else SharedCatalogCache())
        # batched+pipelined dispatch: results and the virtual timeline are
        # identical either way; the flag swaps the execution engine
        self.batch = bool(batch)
        self.max_batch = (self.MAX_BATCH if max_batch is None
                          else int(max_batch))
        # open-loop admission/backpressure budgets (loadgen/ routes every
        # offered arrival through this when armed); None = closed-loop
        # runners, no admission layer
        self.admission = admission
        self.tenants: Dict[str, _TenantState] = {}
        self.clients: Dict[str, TenantSolverClient] = {}
        self._queue: List[SolveTicket] = []
        self._window_start = float(clock.now())
        self._seq = 0
        self.stats: Dict[str, float] = {"dispatched": 0, "throttled": 0,
                                        "windows": 0, "batches": 0,
                                        "batched_tickets": 0,
                                        "padded_slots": 0,
                                        "pipeline_wait_s": 0.0,
                                        "pipeline_span_s": 0.0,
                                        "max_batch_size": 0}
        # batched-pipeline observables: sim time the current in-flight
        # batch was dispatched at (None = pipeline drained), and per-shape-
        # class co-batching counters
        self._inflight_since: Optional[float] = None
        self.class_stats: Dict[str, Dict[str, int]] = {}
        # last pump's bucket membership per batch signature (the stable
        # batch-composition contract the resident stack keys on)
        self._bucket_members: Dict[tuple, tuple] = {}
        # /debug/fleet: the live per-tenant queue/throttle/starvation view
        # (last-built service wins). The route table holds the service by
        # WEAKREF, so a finished fleet is not pinned for the process
        # lifetime; a dead owner answers {"inactive": true}
        from ..obs.exposition import register_debug_route
        register_debug_route("/debug/fleet",
                             lambda svc, query: svc.debug_payload(),
                             owner=self)

    # --- registration -----------------------------------------------------
    def register(self, tenant: str, catalog) -> TenantSolverClient:
        """Build the tenant's facade (sharing the fleet catalog cache, on
        the service's device) and return the queue-fronted client."""
        from ..ops.facade import Solver
        if tenant in self.clients:
            raise ValueError(f"tenant {tenant!r} already registered")
        facade = Solver(catalog, backend=self.backend,
                        shared_catalog=self.shared_catalog,
                        device=self.device)
        client = TenantSolverClient(self, tenant, facade)
        self.tenants[tenant] = _TenantState()
        self.clients[tenant] = client
        return client

    # --- cost model -------------------------------------------------------
    @staticmethod
    def cost_model(pods: int) -> float:
        """Virtual device seconds one solve occupies the shared backend: a
        dispatch floor plus a per-pod term (the reference's constants).
        Deterministic by construction: wall time feeds `wall_seconds` for
        reporting, never scheduling."""
        return 0.002 + 2e-5 * max(0, pods)

    # --- submission / dispatch -------------------------------------------
    def call(self, tenant: str, kind: str, thunk: Callable[[], object],
             cost: float, pods: int = 0):
        """Submit + pump + block: the synchronous face of the queue."""
        ticket = self.submit(tenant, kind, thunk, cost, pods=pods)
        self.pump()
        return ticket.result()

    def submit(self, tenant: str, kind: str, thunk: Callable[[], object],
               cost: float, pods: int = 0) -> SolveTicket:
        now = float(self.clock.now())
        self._roll_window(now)
        state = self.tenants[tenant]
        if len(state.window_jobs) + state.queued >= self.inflight_cap:
            state.throttled += 1
            self.stats["throttled"] += 1
            FLEET_THROTTLED.inc(tenant=tenant)
            raise SolverServiceBusy(
                f"tenant {tenant} exceeded {self.inflight_cap} solves in "
                f"the current {self.window:g}s window")
        self._seq += 1
        ticket = SolveTicket(tenant=tenant, kind=kind, seq=self._seq,
                             submitted_at=now, cost=cost)
        ticket._thunk = thunk
        if TRACER.enabled:
            with TRACER.span("fleet.submit", tenant=tenant, kind=kind,
                             pods=pods, seq=ticket.seq):
                pass
        self._queue.append(ticket)
        state.queued += 1
        FLEET_QUEUE_DEPTH.set(float(state.queued), tenant=tenant)
        return ticket

    def submit_solve(self, tenant: str, pods, args=(), kwargs=None,
                     cost: Optional[float] = None) -> SolveTicket:
        """Queue a STRUCTURED solve request: unlike an opaque thunk, the
        batched pump can stage it (facade.prepare_solve), read its padded
        shape class, and pack it into a shared launch. The thunk keeps the
        serial pump equivalent."""
        kwargs = kwargs or {}
        if cost is None:
            cost = self.cost_model(len(pods))
        facade = self.clients[tenant].facade
        ticket = self.submit(
            tenant, "solve",
            lambda: facade.solve(pods, *args, **kwargs),
            cost=cost, pods=len(pods))
        ticket._request = (pods, tuple(args), dict(kwargs))
        return ticket

    def pump(self) -> None:
        """Dispatch every queued ticket in deficit-round-robin order.
        Execution is synchronous; the DRR replay decides each ticket's
        VIRTUAL start on the shared device timeline. With `batch=True` the
        batched pipeline serves the same contract while packing compatible
        requests into shared launches."""
        if self.batch:
            with _span("fleet.pump", queued=len(self._queue)):
                self._pump_batched()
            return
        while self._queue:
            ticket = self._pick_next()
            state = self.tenants[ticket.tenant]
            state.window_jobs.append((ticket.seq, ticket.cost))
            state.window_cost += ticket.cost
            ticket.wait = self._virtual_wait(ticket)
            sp = _span("fleet.dispatch", tenant=ticket.tenant,
                       kind=ticket.kind, seq=ticket.seq,
                       wait_ms=round(ticket.wait * 1e3, 3))
            t0 = time.perf_counter()
            try:
                # every sample the solve emits attributes to the ticket's
                # tenant even when the caller never entered a scope
                with tenant_scope(ticket.tenant), sp:
                    ticket.value = ticket._thunk()
            except BaseException as e:  # noqa: BLE001 — the future carries it
                ticket.error = e
            finally:
                self._complete(ticket, time.perf_counter() - t0)

    def _complete(self, ticket: SolveTicket, host_s: float) -> None:
        """Per-ticket completion bookkeeping: the ONE place both pumps
        settle a future."""
        state = self.tenants[ticket.tenant]
        ticket.done = True
        for attr in ("_thunk", "_request"):
            if hasattr(ticket, attr):
                delattr(ticket, attr)
        state.wall_seconds += host_s
        state.solves += 1
        self.stats["dispatched"] += 1
        now = float(self.clock.now())
        state.max_wait = max(state.max_wait, ticket.wait)
        state.samples.append((now, ticket.wait, ticket.cost))
        FLEET_SOLVES.inc(tenant=ticket.tenant)
        FLEET_SOLVE_WAIT.observe(ticket.wait * 1e3, tenant=ticket.tenant)
        FLEET_STARVATION.set(state.max_wait, tenant=ticket.tenant)

    # --- the batched, pipelined pump --------------------------------------
    def _pump_batched(self) -> None:
        """Stage -> bucket -> pipelined dispatch.

        1. Drain the queue in EXACTLY the serial pump's DRR order (same
           window bookkeeping, same virtual waits).
        2. Stage each structured ticket through its facade's prepare_solve
           and classify it: terminal (prepare produced the output),
           batchable (device backend, fresh solve), or serial.
        3. Bucket batchable tickets by (shape class, device catalog) in
           rank order: a bucket dispatches at its EARLIEST member's rank.
        4. Pipeline: dispatch bucket k+1 before draining bucket k; serial
           tickets run on the host while a batch is in flight. One batch
           in flight at a time (double buffering)."""
        ordered: List[SolveTicket] = []
        while self._queue:
            ticket = self._pick_next()
            state = self.tenants[ticket.tenant]
            state.window_jobs.append((ticket.seq, ticket.cost))
            state.window_cost += ticket.cost
            ticket.wait = self._virtual_wait(ticket)
            ticket.dispatch_rank = len(ordered)
            ordered.append(ticket)
        if not ordered:
            return
        # LEASE the encode arena of every facade staging MORE THAN ONE
        # ticket this pump: a staged EncodedPods holds views into its
        # facade's staging arena, valid only until the next encode leases
        # it, and this pump interleaves encodes before any dispatch. A
        # leased arena makes the staged encodes take fresh allocations.
        per_tenant = Counter(t.tenant for t in ordered)
        leases: List[object] = []
        try:
            for tenant, n in per_tenant.items():
                if n < 2:
                    continue
                client = self.clients.get(tenant)
                arena = getattr(getattr(client, "facade", None), "_arena",
                                None)
                if arena is not None and arena.acquire():
                    leases.append(arena)
            self._stage_and_dispatch(ordered)
        except BaseException as e:
            # a kernel or readback error raises out of pump(); every ticket
            # this pump took off the queue and has not settled carries it
            self._inflight_since = None
            PIPELINE_INFLIGHT.set(0.0)
            for ticket in ordered:
                if not ticket.done:
                    ticket.error = e
                    self._complete(ticket, 0.0)
            raise
        finally:
            for arena in leases:
                arena.release()

    def _stage_and_dispatch(self, ordered: List[SolveTicket]) -> None:
        # --- stage ---------------------------------------------------
        staged: List[dict] = []
        for ticket in ordered:
            entry = {"ticket": ticket, "prep": None, "batchable": None,
                     "mode": "thunk", "host_s": 0.0}
            req = getattr(ticket, "_request", None)
            client = self.clients.get(ticket.tenant)
            if req is not None and client is not None:
                pods, args, kwargs = req
                sp = _span("fleet.batch_stage", tenant=ticket.tenant,
                           seq=ticket.seq, pods=len(pods))
                t0 = time.perf_counter()
                try:
                    with tenant_scope(ticket.tenant), sp:
                        prep = client.facade.prepare_solve(pods, *args,
                                                           **kwargs)
                        entry["prep"] = prep
                        if prep.output is not None:
                            entry["mode"] = "done"
                        else:
                            b = client.facade.stage_batchable(prep)
                            entry["batchable"] = b
                            entry["mode"] = "batch" if b is not None \
                                else "serial"
                except BaseException as e:  # noqa: BLE001 — future carries it
                    ticket.error = e
                    entry["mode"] = "done"
                entry["host_s"] = time.perf_counter() - t0
                if entry["mode"] == "done":
                    if ticket.error is None:
                        ticket.value = prep.output
                    # prepare-terminal tickets keep their fleet.dispatch
                    # span, as the serial pump gives every ticket one
                    if TRACER.enabled:
                        with TRACER.span(
                                "fleet.dispatch", tenant=ticket.tenant,
                                kind=ticket.kind, seq=ticket.seq,
                                batched=True, terminal=True,
                                wait_ms=round(ticket.wait * 1e3, 3)):
                            pass
                    self._complete(ticket, entry["host_s"])
            staged.append(entry)
        # --- bucket in rank order -------------------------------------
        buckets: List[List[dict]] = []
        open_by_sig: Dict[tuple, List[dict]] = {}
        for e in staged:
            if e["mode"] == "batch":
                sig = e["batchable"].signature
                b = open_by_sig.get(sig)
                if b is None or len(b) >= self.max_batch:
                    b = []
                    open_by_sig[sig] = b
                    buckets.append(b)
                b.append(e)
            elif e["mode"] in ("serial", "thunk"):
                buckets.append([e])
        self._note_copending(staged, buckets)
        # --- pipelined dispatch ---------------------------------------
        inflight: Optional[tuple] = None   # (entries, InFlightBatch)
        for b in buckets:
            if b[0]["mode"] != "batch":
                # host-side work runs WHILE the in-flight batch executes
                # on the card: the overlap half of the pipeline
                self._run_serial(b[0])
                continue
            ifb = self._dispatch_bucket(b)
            if ifb is None:       # injected device fault: bucket settled
                continue
            if inflight is not None:
                self._drain(*inflight)
            inflight = (b, ifb)
            self._inflight_since = float(self.clock.now())
            PIPELINE_INFLIGHT.set(1.0)
        if inflight is not None:
            self._drain(*inflight)

    def _note_copending(self, staged: List[dict],
                        buckets: List[List[dict]]) -> None:
        """Per-shape-class co-batching effectiveness, counted on the FULL
        signature (shape class + device catalog): >= 2 tickets with the
        same signature queued in one pump should co-batch."""
        batchable = [e["batchable"] for e in staged if e["mode"] == "batch"]
        pend = Counter(b.signature for b in batchable)
        shape_of = {b.signature: b.shape_class for b in batchable}
        cob = {b[0]["batchable"].signature for b in buckets
               if len(b) >= 2 and b[0]["mode"] == "batch"}
        for sig, n in pend.items():
            cs = self.class_stats.setdefault(
                shape_of[sig], {"tickets": 0, "batches": 0,
                                "copending_pumps": 0,
                                "cobatched_pumps": 0})
            cs["tickets"] += n
            if n >= 2:
                cs["copending_pumps"] += 1
                if sig in cob:
                    cs["cobatched_pumps"] += 1

    def _bucket_resident_key(self, entries: List[dict]) -> Optional[tuple]:
        """Stable batch-composition contract: a bucket whose (tenant,
        facade-view) membership is IDENTICAL to the previous pump's
        bucket for the same batch signature gets a device-resident
        stacked gbuf — the solver's digest-diffed scatter then ships
        only the rows that changed, instead of a full [B, Gp, W] upload
        per pump. First-seen and changed memberships return None (the
        full-stack upload)."""
        from ..obs.recompute import fingerprint
        sig = entries[0]["batchable"].signature
        members = tuple((e["ticket"].tenant, e["batchable"].meter_key)
                        for e in entries)
        stable = self._bucket_members.get(sig) == members
        self._bucket_members[sig] = members
        if not stable:
            return None
        return ("fleet", id(self), entries[0]["batchable"].shape_class,
                fingerprint(members))

    def _dispatch_bucket(self, entries: List[dict]):
        """One bucket -> one async launch. An INJECTED device fault here
        aborts the whole call, so exactly the tickets in this batch degrade:
        each re-runs through its own facade, whose fallback machinery
        reroutes and meters the event; later buckets still try the device.
        Any other error (a kernel's build, shape or launch) raises out of
        pump()."""
        try:
            # probe the injected device-fault seam once per DISTINCT tenant
            # in the bucket, each under that tenant's scope: a fault router
            # consults current_tenant(), as the serial pump's probe does
            # inside the ticket's scoped thunk
            for tenant in dict.fromkeys(e["ticket"].tenant
                                        for e in entries):
                with tenant_scope(tenant):
                    ops_solver.probe_dispatch_fault("device")
            ifb = ops_solver.dispatch_batch(
                [e["batchable"] for e in entries],
                resident_key=self._bucket_resident_key(entries))
        except ops_solver.InjectedFault:
            for e in entries:
                self._run_serial(e, fault_fallback=True)
            return None
        cs = self.class_stats.setdefault(
            entries[0]["batchable"].shape_class,
            {"tickets": 0, "batches": 0, "copending_pumps": 0,
             "cobatched_pumps": 0})
        cs["batches"] += 1
        return ifb

    def _run_serial(self, entry: dict, fault_fallback: bool = False) -> None:
        """Execute one non-batchable (or fault-degraded) ticket under its
        tenant scope: the serial pump's semantics for exactly this
        ticket."""
        ticket = entry["ticket"]
        sp = _span("fleet.dispatch", tenant=ticket.tenant, kind=ticket.kind,
                   seq=ticket.seq, batched=False,
                   wait_ms=round(ticket.wait * 1e3, 3))
        t0 = time.perf_counter()
        try:
            with tenant_scope(ticket.tenant), sp:
                if entry["mode"] == "thunk":
                    ticket.value = ticket._thunk()
                else:
                    client = self.clients[ticket.tenant]
                    result, backend = client.facade.run_prepared(
                        entry["prep"])
                    # this solve's OWN cost: its stage + its run
                    ticket.value = client.facade.finish_solve(
                        entry["prep"], result, backend,
                        duration_s=(entry["host_s"]
                                    + time.perf_counter() - t0))
        except BaseException as e:  # noqa: BLE001 — the future carries it
            ticket.error = e
        finally:
            ticket.batch_size = 1
            event = "fault_fallback" if fault_fallback else "serial"
            FLEET_SHAPE_CLASS.inc(event=event, tenant=ticket.tenant)
            self._complete(ticket,
                           entry["host_s"] + time.perf_counter() - t0)

    def _drain(self, entries: List[dict], ifb) -> None:
        """Block on an in-flight batch, decode each request independently,
        and finish its ticket under its tenant scope. A row whose serial
        re-run raises an injected fault degrades alone; a readback or
        kernel error raises out of pump()."""
        self._inflight_since = None
        PIPELINE_INFLIGHT.set(0.0)
        with _span("fleet.pipeline_wait") as sp:
            waited = ifb.block()
            sp.set(batch=ifb.size, wait_ms=round(waited * 1e3, 3),
                   span_ms=round(ifb.span_s * 1e3, 3))
        self.stats["pipeline_wait_s"] += waited
        self.stats["pipeline_span_s"] += max(ifb.span_s, waited)
        self.stats["batches"] += 1
        self.stats["batched_tickets"] += ifb.size
        self.stats["padded_slots"] += ifb.padded_size
        self.stats["max_batch_size"] = max(self.stats["max_batch_size"],
                                           ifb.size)
        B = len(entries)
        for i, e in enumerate(entries):
            ticket = e["ticket"]
            shape = e["batchable"].shape_class
            sp = _span("fleet.dispatch", tenant=ticket.tenant,
                       kind=ticket.kind, seq=ticket.seq, batched=True,
                       batch=B, shape_class=shape,
                       wait_ms=round(ticket.wait * 1e3, 3))
            t0 = time.perf_counter()
            try:
                with tenant_scope(ticket.tenant), sp:
                    client = self.clients[ticket.tenant]
                    result = ifb.decode(i)
                    # this ticket's OWN cost: its stage, its 1/B share of
                    # the batch's device span, and its decode
                    ticket.value = client.facade.finish_solve(
                        e["prep"], result, "device",
                        duration_s=(e["host_s"] + ifb.span_s / B
                                    + time.perf_counter() - t0))
            except ops_solver.InjectedFault:
                # a row's serial re-run (budget regrow) hit the injected
                # fault: its own facade re-runs it, its peers' rows stand
                self._run_serial(e, fault_fallback=True)
                continue
            ticket.batch_size = B
            ticket.shape_class = shape
            FLEET_BATCH_SIZE.observe(float(B), tenant=ticket.tenant)
            FLEET_SHAPE_CLASS.inc(
                event="cobatched" if B > 1 else "solo",
                tenant=ticket.tenant)
            self._complete(ticket,
                           e["host_s"] + time.perf_counter() - t0)

    def pipeline_overlap_ratio(self) -> float:
        """1 - blocked-wait / in-flight span over every drained batch:
        0 = the pump blocked for the card's whole execution (no overlap),
        ->1 = host work fully hid the device time."""
        span = self.stats["pipeline_span_s"]
        if span <= 0:
            return 0.0
        return max(0.0, 1.0 - self.stats["pipeline_wait_s"] / span)

    def pipeline_state(self) -> dict:
        """The pipeline's observables (the reference's watchdog reads
        them for its pipeline_stall invariant)."""
        now = float(self.clock.now())
        return {
            "batch": self.batch,
            "inflight_age": (None if self._inflight_since is None
                             else now - self._inflight_since),
            "classes": {sc: dict(cs)
                        for sc, cs in self.class_stats.items()},
        }

    # --- fair scheduling --------------------------------------------------
    def _pick_next(self) -> SolveTicket:
        """Next ticket off the queue: among tenants with queued tickets,
        serve the lightest current-window backlog first (FIFO within a
        tenant)."""
        best_i, best_key = 0, None
        for i, t in enumerate(self._queue):
            key = (self.tenants[t.tenant].window_cost, t.seq)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        ticket = self._queue.pop(best_i)
        state = self.tenants[ticket.tenant]
        state.queued -= 1
        FLEET_QUEUE_DEPTH.set(float(state.queued), tenant=ticket.tenant)
        return ticket

    def _virtual_wait(self, ticket: SolveTicket) -> float:
        """Deficit-round-robin replay of the current window's job list:
        every tenant's queue is replayed from the window start, each round
        granting `quantum` virtual seconds per tenant (lightest total
        backlog first) and serving whole jobs the accumulated deficit
        covers. The returned wait is this ticket's virtual start minus its
        arrival offset."""
        jobs: Dict[str, List[Tuple[int, float]]] = {
            t: list(s.window_jobs) for t, s in self.tenants.items()
            if s.window_jobs}
        order = sorted(jobs, key=lambda t: (self.tenants[t].window_cost, t))
        deficit = {t: 0.0 for t in jobs}
        heads = {t: 0 for t in jobs}
        vt = 0.0
        start: Optional[float] = None
        # bounded: every round either serves a job or grows every deficit
        # by quantum, and total work is finite
        while any(heads[t] < len(jobs[t]) for t in jobs):
            for t in order:
                if heads[t] >= len(jobs[t]):
                    continue
                deficit[t] += self.quantum
                while heads[t] < len(jobs[t]):
                    seq, cost = jobs[t][heads[t]]
                    if deficit[t] + 1e-12 < cost:
                        break
                    if seq == ticket.seq:
                        start = vt
                    vt += cost
                    deficit[t] -= cost
                    heads[t] += 1
        if start is None:  # defensive: ticket not in its window list
            start = vt
        arrival = max(0.0, ticket.submitted_at - self._window_start)
        return max(0.0, start - arrival)

    def _roll_window(self, now: float) -> None:
        if now - self._window_start < self.window:
            return
        self._window_start = now
        self.stats["windows"] += 1
        for tenant, state in self.tenants.items():
            state.window_jobs = []
            state.window_cost = 0.0
            state.max_wait = 0.0
            FLEET_STARVATION.set(0.0, tenant=tenant)

    # --- introspection ----------------------------------------------------
    def backlog(self) -> int:
        """Queued-but-undispatched tickets."""
        return len(self._queue)

    def debug_payload(self) -> dict:
        """The /debug/fleet payload."""
        return {"tenants": self.snapshot(),
                "inflight_cap": self.inflight_cap,
                "window_seconds": self.window,
                "quantum_seconds": self.quantum,
                "stats": dict(self.stats),
                "batch": {"armed": self.batch,
                          "max_batch": self.max_batch,
                          "overlap_ratio": round(
                              self.pipeline_overlap_ratio(), 4),
                          **self.pipeline_state()},
                "admission": (self.admission.snapshot()
                              if self.admission is not None else None),
                "catalog_shared": dict(self.shared_catalog.stats)}

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant service view: each row carries its facade's
        encode-cache effectiveness."""
        out: Dict[str, dict] = {}
        for tenant, state in sorted(self.tenants.items()):
            row = {
                "solves": state.solves,
                "throttled": state.throttled,
                "queued": state.queued,
                "window_jobs": len(state.window_jobs),
                "max_wait_ms": round(state.max_wait * 1e3, 3),
                "wall_ms": round(state.wall_seconds * 1e3, 1),
            }
            client = self.clients.get(tenant)
            cache = (getattr(client.facade, "_encode_cache", None)
                     if client is not None else None)
            if cache is not None:
                row["encode_cache"] = cache.snapshot()
            out[tenant] = row
        return out
