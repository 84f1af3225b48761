"""Framework metrics: the port's own copy of the metric families the
facade path, the control loop and the fleet's SolverService touch
(`karpenter_tpu/metrics/__init__.py` defines them all).
Names, labels and buckets are the reference's, so a dashboard reads either
package the same way. The registry is this package's own: samples of the
two packages never mix."""

from .registry import (Counter, Gauge, Histogram, Registry, DEFAULT_BUCKETS)
from .tenant import current_tenant

REGISTRY = Registry()

# the hot-path families a fleet multiplexes across tenant shards carry a
# `tenant` dimension whose default RESOLVES through the live tenant scope
# (metrics/tenant.py): single-cluster processes never enter a scope, so
# every sample and every unlabeled read lands on tenant="default"
_TENANT = {"tenant": current_tenant}

SOLVE_DURATION = REGISTRY.histogram(
    "karpenter_tpu_solver_solve_duration_seconds",
    "Solve() wall time", ("backend",))
SOLVE_PODS = REGISTRY.histogram(
    "karpenter_tpu_solver_pods_per_solve",
    "pods per Solve()", (), buckets=(1, 10, 100, 1000, 10_000, 100_000))
PRICING_STALE = REGISTRY.gauge(
    "karpenter_tpu_pricing_stale",
    "1 while prices are served from the last good book/snapshot because "
    "the live pricing feed failed or returned nothing (reference "
    "pricing.go static-table fallback)",
    ("tenant",), label_defaults=_TENANT)
PRICING_LAST_UPDATE = REGISTRY.gauge(
    "karpenter_tpu_pricing_last_update_timestamp_seconds",
    "wall time of the last successful pricing feed update",
    ("tenant",), label_defaults=_TENANT)
DEGRADED_MODE = REGISTRY.gauge(
    "karpenter_tpu_degraded_mode",
    "1 (or the active-condition count) while a component serves in a "
    "degraded mode: solver = solves rerouted off the faulted TPU backend "
    "onto native/host, cloud-api = the terminate batcher is inside a "
    "throttle backoff window, capacity = live ICE marks in the "
    "UnavailableOfferings cache. SET-style per-cluster state, so it "
    "carries the tenant dimension: under a fleet, a healthy neighbor's "
    "0 must not clobber a degraded tenant's 1",
    ("component", "tenant"), label_defaults=_TENANT)
SOLVER_FALLBACKS = REGISTRY.counter(
    "karpenter_tpu_solver_backend_fallback_total",
    "Solves whose device/mesh dispatch faulted mid-solve and were re-run "
    "on the fallback backend (the degraded path — each increment is a "
    "solve that still returned a full placement)",
    ("from_backend", "to_backend", "tenant"), label_defaults=_TENANT)
ENCODE_CACHE = REGISTRY.counter(
    "karpenter_tpu_encode_cache_total",
    "Pod signature-groups by encode-cache outcome: a 'hit' gathered the "
    "group's tensor rows (compat/allow_zone/allow_cap/max_per_node/"
    "request vector) from the signature-keyed EncodeContext, a 'miss' "
    "paid the full lowering and persisted the row — on a steady cluster "
    "re-encode cost tracks this miss rate, not the pod population",
    ("event",))
ENCODE_CACHE_ROWS = REGISTRY.gauge(
    "karpenter_tpu_encode_cache_rows",
    "Signature rows resident across the solver's encode-cache contexts "
    "(bounded: a small context LRU × a per-context row cap with "
    "intern-style rotation)")
FLEET_CATALOG_SHARED = REGISTRY.counter(
    "karpenter_tpu_fleet_catalog_shared_total",
    "Catalog-tensor lookups served across tenant facades, by outcome: a "
    "'hit' reused another tenant's encoded view (identical nodeclass "
    "hash + availability fingerprint — the tenants then also share the "
    "device-resident tensors and compiled executables), a 'miss' paid "
    "the full encode_catalog",
    ("event",))
FLEET_SOLVES = REGISTRY.counter(
    "karpenter_tpu_fleet_solves_total",
    "Solve requests dispatched by the shared SolverService, per tenant "
    "shard (fleet/service.py) — the aggregate rate across tenants is the "
    "fleet's solves/sec headline (bench c12)",
    ("tenant",), label_defaults=_TENANT)
FLEET_SOLVE_WAIT = REGISTRY.histogram(
    "karpenter_tpu_fleet_solve_wait_ms",
    "Virtual queueing delay (milliseconds of modeled device time) a "
    "tenant's solve request spent behind other tenants' work before the "
    "shared solver served it — the deficit-round-robin scheduler bounds "
    "this for light tenants regardless of a neighbor's storm (the "
    "noisy-neighbor isolation invariant, docs/fleet.md)",
    ("tenant",),
    buckets=(.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500),
    label_defaults=_TENANT)
FLEET_STARVATION = REGISTRY.gauge(
    "karpenter_tpu_fleet_starvation_gauge",
    "Worst virtual queueing delay (seconds) any of this tenant's solve "
    "requests has seen in the current scheduling window — a persistently "
    "high value for one tenant while others read ~0 is starvation, which "
    "the fair scheduler exists to prevent",
    ("tenant",), label_defaults=_TENANT)
FLEET_THROTTLED = REGISTRY.counter(
    "karpenter_tpu_fleet_throttled_total",
    "Solve submissions the shared SolverService refused because the "
    "tenant already had its in-flight cap of requests in the current "
    "window (the noisy-neighbor backpressure: the shard's reconcile "
    "backs off and retries, exactly like a cloud 429, while other "
    "tenants' solves proceed)",
    ("tenant",), label_defaults=_TENANT)
FLEET_BATCH_SIZE = REGISTRY.histogram(
    "karpenter_tpu_fleet_batch_size",
    "Solve requests packed into the device dispatch that served this "
    "tenant's ticket (fleet/service.py batched pump): 1 = the ticket "
    "dispatched alone, N = it amortized one kernel call (and one tunnel "
    "round-trip) across N tenants' solves — the occupancy face of the "
    "shape-class bucketing",
    ("tenant",), buckets=(1, 2, 4, 8, 16, 32, 64), label_defaults=_TENANT)
FLEET_SHAPE_CLASS = REGISTRY.counter(
    "karpenter_tpu_fleet_shape_class_total",
    "Tickets through the batched dispatcher by outcome: 'cobatched' = "
    "shared one device call with peers of its padded shape class, "
    "'solo' = dispatched as a batch of one (no compatible peer queued), "
    "'serial' = not batchable (host/native backend, existing-node "
    "resume, legacy thunk), 'fault_fallback' = its batch's device "
    "dispatch faulted and the ticket re-ran through its facade's "
    "degradation path",
    ("event", "tenant"), label_defaults=_TENANT)
PIPELINE_INFLIGHT = REGISTRY.gauge(
    "karpenter_tpu_pipeline_inflight",
    "Batched device dispatches currently in flight (dispatched, not yet "
    "drained) in the solver service's async pipeline: 1 while host work "
    "for the next bucket overlaps device work for the current one, 0 "
    "when the pipeline is drained. Stuck at 1 across scheduling windows "
    "is the watchdog's pipeline_stall invariant",
    ("tenant",), label_defaults=_TENANT)
FLEET_QUEUE_DEPTH = REGISTRY.gauge(
    "karpenter_tpu_fleet_queue_depth",
    "Solve tickets a tenant has queued in the shared SolverService that "
    "no pump has picked yet — the live per-tenant face of the service "
    "backlog the watchdog's fleet_starvation monitor reads in aggregate. "
    "The serial fleet drains synchronously so this is ~0 between pumps; "
    "under the async/open-loop callers a persistently growing value for "
    "one tenant is the admission-control engage signal",
    ("tenant",), label_defaults=_TENANT)
LOADGEN_ARRIVALS = REGISTRY.counter(
    "karpenter_tpu_loadgen_arrivals_total",
    "Pods offered by the open-loop load generator (loadgen/), by arrival "
    "process (poisson / diurnal / bursty / trace) — offered load, before "
    "the admission controller's admit/defer/shed verdict, so "
    "offered - admitted - shed = currently deferred",
    ("process", "tenant"), label_defaults=_TENANT)
LOADGEN_ADMITTED = REGISTRY.counter(
    "karpenter_tpu_loadgen_admitted_total",
    "Offered pods the admission controller let into the store "
    "(fleet/service.AdmissionController): the load the control plane "
    "actually serves. admitted/offered is the soak acceptance ratio the "
    "bench c13 keys report",
    ("tenant",), label_defaults=_TENANT)
LOADGEN_SHED = REGISTRY.counter(
    "karpenter_tpu_loadgen_shed_total",
    "Offered pods the admission controller DROPPED, by reason: "
    "'queue_depth' = the tenant's waiting-pod depth (pending + deferred) "
    "already exceeded the shed budget, 'defer_budget' = the arrival "
    "exhausted its re-offer attempts without the backlog clearing, "
    "'rate' = the tenant's per-second arrival-rate token bucket was "
    "empty (rate limits are RATE budgets, not depth budgets — a "
    "steady trickle above the configured rate sheds even with an "
    "empty queue). "
    "Zero below saturation (the soak_smoke assert); nonzero past it is "
    "overload degrading PREDICTABLY — unbounded queue growth instead "
    "of shedding is the watchdog's overload_unbounded invariant",
    ("tenant", "reason"), label_defaults=_TENANT)
LOADGEN_DEFERRED = REGISTRY.counter(
    "karpenter_tpu_loadgen_deferred_total",
    "Arrival batches the admission controller deferred for a later "
    "re-offer with seed-deterministic backoff (each re-offer of the "
    "same batch counts again): soft backpressure — the load is delayed, "
    "not dropped, and the deferred backlog is bounded by the shed budget",
    ("tenant",), label_defaults=_TENANT)
LOADGEN_BACKLOG = REGISTRY.gauge(
    "karpenter_tpu_loadgen_backlog",
    "Pods currently held in the load generator's deferred queue "
    "awaiting re-offer (per tenant): the admission controller's "
    "waiting room. Bounded by the shed budget whenever shedding is "
    "armed; growth past that with shedding disabled is exactly the "
    "overload_unbounded excursion",
    ("tenant",), label_defaults=_TENANT)
DCAT_EVICTIONS = REGISTRY.counter(
    "karpenter_tpu_solver_dcat_evictions_total",
    "Device-resident catalog entries evicted, by reason: 'weakref' = "
    "the owning CatalogTensors died (id-keyed lifecycle), 'fifo' = the "
    "token-keyed bound trimmed the oldest shared view, 'stale' = an "
    "entry was rebuilt because its shape/overhead no longer served the "
    "request, 'view_evicted' = the SharedCatalogCache dropped the view "
    "so its device residency was released with it, 'facade_lru' = a "
    "facade's catalog LRU rolled its device variants out. Churn here "
    "is re-upload cost; a dead view pinning buffers would show as "
    "residency without evictions", ("reason",))
TRACE_RING_DROPPED = REGISTRY.counter(
    "karpenter_tpu_trace_ring_dropped_total",
    "Traces the flight-recorder ring rejected (full of slower "
    "residents), per tenant — the tenant-attributed face of the "
    "watchdog's trace_ring_overflow monitor: one tenant's hot loop "
    "overflowing the ring must point at that tenant, not at the fleet",
    ("tenant",), label_defaults=_TENANT)
INTEGRITY_VERDICTS = REGISTRY.counter(
    "karpenter_tpu_integrity_verdicts_total",
    "Solution-integrity plane verdicts (karpenter_tpu/integrity/), by "
    "check and outcome: 'ok' = the check passed (the oracle meters one "
    "aggregate ok per validated solve under check='oracle'; canary and "
    "resident-audit passes meter under their own check names), "
    "'violation' = an infeasible placement, a canary cost disagreement, "
    "or a resident-row digest mismatch — each violation quarantines the "
    "affected facade's device path and recovers through the host "
    "backend, 'unrecovered' = the fallback re-solve still failed the "
    "oracle (a host/encode bug, never silent). Nonzero violations on a "
    "healthy run are the zero-false-positive contract breaking; the "
    "watchdog's integrity_breach invariant pages on them",
    ("check", "outcome", "tenant"), label_defaults=_TENANT)

# the families the control loop touches (controllers/, state/, cloud/fake)
NODECLAIMS_CREATED = REGISTRY.counter(
    "karpenter_tpu_nodeclaims_created_total",
    "NodeClaims launched", ("nodepool", "instance_type", "capacity_type"))
NODECLAIMS_TERMINATED = REGISTRY.counter(
    "karpenter_tpu_nodeclaims_terminated_total",
    "NodeClaims terminated", ("nodepool", "reason"))
PODS_SCHEDULED = REGISTRY.counter(
    "karpenter_tpu_pods_scheduled_total", "pods nominated to nodes", ())
PODS_UNSCHEDULABLE = REGISTRY.gauge(
    "karpenter_tpu_pods_unschedulable", "pods no pool could place",
    ("tenant",), label_defaults=_TENANT)
DISRUPTION_DECISIONS = REGISTRY.counter(
    "karpenter_tpu_voluntary_disruption_decisions_total",
    "disruption decisions", ("reason", "consolidation_type"))
OFFERING_AVAILABLE = REGISTRY.gauge(
    "karpenter_tpu_cloudprovider_instance_type_offering_available",
    "offering availability", ("instance_type", "zone", "capacity_type"))
OFFERING_PRICE = REGISTRY.gauge(
    "karpenter_tpu_cloudprovider_instance_type_offering_price_estimate",
    "offering price", ("instance_type", "zone", "capacity_type"))
ICE_ERRORS = REGISTRY.counter(
    "karpenter_tpu_cloudprovider_insufficient_capacity_errors_total",
    "ICE launch failures", ("capacity_type",))
INTERRUPTION_MESSAGES = REGISTRY.counter(
    "karpenter_tpu_interruption_messages_total",
    "interruption queue messages", ("kind",))
INTERRUPTION_PARSE_FAILURES = REGISTRY.counter(
    "karpenter_tpu_interruption_message_parse_failures_total",
    "interruption payloads that failed wire-format parsing (counted and "
    "deleted, never retried — poison messages must not wedge the queue)")
LIFECYCLE_DURATION = REGISTRY.histogram(
    "karpenter_nodeclaims_lifecycle_duration_seconds",
    "Seconds from creation to each lifecycle phase (reference: "
    "karpenter_nodeclaims_instance_termination/registration duration "
    "families)", ("phase",),
    buckets=(1, 2, 5, 10, 30, 60, 120, 300, 600, 1800))
TERMINATION_DURATION = REGISTRY.histogram(
    "karpenter_nodeclaims_termination_duration_seconds",
    "Seconds from deletion timestamp to finalization",
    buckets=(1, 2, 5, 10, 30, 60, 120, 300, 600, 1800))
CLUSTER_NODES = REGISTRY.gauge(
    "karpenter_cluster_state_node_count",
    "Nodes currently in cluster state (reference cluster_state family)",
    ("tenant",), label_defaults=_TENANT)
CLUSTER_PODS = REGISTRY.gauge(
    "karpenter_cluster_state_pod_count",
    "Pods currently tracked, by phase", ("phase", "tenant"),
    label_defaults=_TENANT)
CLUSTER_UTILIZATION = REGISTRY.gauge(
    "karpenter_cluster_utilization_percent",
    "Requested / allocatable across ready nodes, per resource",
    ("resource", "tenant"), label_defaults=_TENANT)
BATCH_SIZE = REGISTRY.histogram(
    "karpenter_tpu_cloud_batcher_batch_size", "requests per wire call",
    ("op",), buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500))
RECONCILE_DURATION = REGISTRY.histogram(
    "karpenter_tpu_controller_reconcile_duration_seconds",
    "Per-controller reconcile pass wall time (the controller-runtime "
    "workqueue/reconcile families, reference metrics.md workqueue group)",
    ("controller",),
    buckets=(.0005, .001, .005, .01, .05, .1, .5, 1, 5, 30))
RECONCILE_ERRORS = REGISTRY.counter(
    "karpenter_tpu_controller_reconcile_errors_total",
    "Reconcile passes that raised, by disposition (backoff = retryable "
    "cloud throttle, crash = survived unexpected error)",
    ("controller", "disposition"))
CLOUD_API_DURATION = REGISTRY.histogram(
    "karpenter_tpu_cloudprovider_api_duration_seconds",
    "Wire-level cloud API call duration (the aws-sdk-go-prometheus "
    "middleware the reference wires at operator.go:98; sits BELOW the "
    "batcher, so one coalesced wire call = one observation)",
    ("method",),
    buckets=(.0005, .001, .005, .01, .05, .1, .5, 1, 5))
CLOUD_API_ERRORS = REGISTRY.counter(
    "karpenter_tpu_cloudprovider_api_errors_total",
    "Wire-level cloud API errors (raised, or returned in-band by "
    "create_fleet), by exception class", ("method", "error"))
NODEPOOL_USAGE = REGISTRY.gauge(
    "karpenter_nodepools_usage",
    "Resources consumed by a NodePool's claims — reference series name, "
    "so existing dashboards/alerts match", ("nodepool", "resource", "tenant"),
    label_defaults=_TENANT)
NODEPOOL_LIMIT = REGISTRY.gauge(
    "karpenter_nodepools_limit",
    "A NodePool's spec.limits (reference karpenter_nodepools_limit)",
    ("nodepool", "resource", "tenant"), label_defaults=_TENANT)
LAUNCH_DEDUP = REGISTRY.counter(
    "karpenter_tpu_launch_dedup_total",
    "CreateFleet requests the cloud deduplicated by idempotency token: a "
    "replayed launch (crash-restart resending a journaled request, or a "
    "retry racing its own in-flight attempt) returned the instance the "
    "token already minted instead of provisioning a second one — nonzero "
    "after a crash is the resilience layer WORKING; a double-provision "
    "would show up as a duplicate-launch invariant violation instead",
    ("tenant",), label_defaults=_TENANT)
INTENT_JOURNAL_OPEN = REGISTRY.gauge(
    "karpenter_tpu_intent_journal_open",
    "Provisioning intents currently open in the write-ahead intent "
    "journal (state/journal.py): launches recorded before their "
    "CreateFleet call whose commit has not resolved yet. Steady-state "
    "this is 0 between reconciles; a persistently nonzero value means a "
    "launch died between the wire call and the commit and is waiting "
    "for restart replay — the GC sweep will not touch its instance. "
    "Tenant-dimensioned (SET-style): each fleet shard's journal "
    "publishes its own open count",
    ("tenant",), label_defaults=_TENANT)
RESTART_ADOPTIONS = REGISTRY.counter(
    "karpenter_tpu_restart_adoptions_total",
    "Open-intent resolutions during restart rehydration "
    "(state/rehydrate.replay_intents), by outcome: adopted = a live "
    "token-tagged instance was re-bound to its rebuilt NodeClaim, "
    "aborted = the crash landed before the wire call (nothing "
    "launched), reaped = a live instance whose claim could not be "
    "rebuilt was terminated immediately instead of leaking until GC",
    ("outcome",))
CONSOLIDATION_SAVINGS = REGISTRY.counter(
    "karpenter_tpu_consolidation_savings_total",
    "Realized $/hr price delta of EXECUTED consolidation disruptions "
    "(victims' price minus replacements' price), by decision source: "
    "'greedy' = the reference-style screen + prefix selection, "
    "'optimizer' = the global subset search "
    "(karpenter_tpu/optimizer/). Only consolidations meter here — "
    "drift/expiration replacements are compliance, not savings. The "
    "optimizer-vs-greedy split is the bench c14 headline: optimizer "
    "savings above the greedy baseline are consolidations the prefix "
    "search structurally cannot see",
    ("source", "tenant"), label_defaults=_TENANT)
OPTIMIZER_SUBSETS = REGISTRY.counter(
    "karpenter_tpu_optimizer_subsets_total",
    "Global-optimizer search funnel, by event: 'scored' = candidate "
    "victim subsets scored by the batched repack tournament (one "
    "dispatch scores the whole batch), 'verify_pass' / 'verify_reject' "
    "= exact Solver.solve() verifications of ranked winners (every "
    "executed disruption passed one — the exact-verify contract), "
    "'fallback' = searches that degraded to the greedy path after a "
    "fault. A growing verify_reject share is the relaxation ranking "
    "diverging from solve semantics — the watchdog's "
    "optimizer_divergence invariant pages on the streak",
    ("event", "tenant"), label_defaults=_TENANT)

FAULTS_INJECTED = REGISTRY.counter(
    "karpenter_tpu_faults_injected_total",
    "Faults injected by an armed faults.FaultPlan, by kind (ice, api, "
    "clock_jump, device, interruption, corruption, crash — burst flavor, "
    "incl. kills, is in the timeline detail) — zero in production: the "
    "hooks are no-ops unless a plan is installed", ("kind",))
# the warm path (warmpath/engine.py) writes these; the SLO engine
# (obs/slo.py) reads WARMPATH_DECISIONS and WARMPATH_AUDITS for its
# warm_hit_rate and audit_divergence objectives
WARMPATH_DECISIONS = REGISTRY.counter(
    "karpenter_tpu_warmpath_decisions_total",
    "Provisioner reconciles with pending pods, by outcome: warm (whole "
    "burst served from standing headroom), mixed (partially), escalated "
    "(classified warm but nothing fit — the full solver served it all), "
    "cold (classification failed; the reason dimension names why — the "
    "delta tracker's first dirty event, a catalog-epoch move, a "
    "config-hash change, or an audit divergence)",
    ("path", "reason", "tenant"), label_defaults=_TENANT)
WARMPATH_ADMIT_DURATION = REGISTRY.histogram(
    "karpenter_tpu_warmpath_admit_duration_seconds",
    "Warm-path admission latency per reconcile (classify + encode + "
    "first-fit + nomination — the arrival-path cost a full solve would "
    "otherwise be)", ("tenant",),
    buckets=(.0001, .00025, .0005, .001, .0025, .005, .01, .025, .05,
             .1, .5, 1), label_defaults=_TENANT)
WARMPATH_HIT_RATE = REGISTRY.gauge(
    "karpenter_tpu_warmpath_warm_hit_rate",
    "Fraction of arrival pods admitted on the warm path (vs escalated "
    "or classified cold) since process start — the steady-state "
    "effectiveness of the incremental admitter",
    ("tenant",), label_defaults=_TENANT)
WARMPATH_DIVERGENCE = REGISTRY.counter(
    "karpenter_tpu_warmpath_divergence_total",
    "Warm-path audit divergences: accumulated warm admissions replayed "
    "through a fresh full Solver.solve() disagreed with the warm "
    "placements. Each increment forces the path cold and flight-records "
    "a warmpath.divergence trace — nonzero means the incremental "
    "admitter drifted from solve semantics and repaired itself",
    ("tenant",), label_defaults=_TENANT)
WARMPATH_AUDITS = REGISTRY.counter(
    "karpenter_tpu_warmpath_audits_total",
    "Warm-path auditor replays, by outcome (clean / divergent)",
    ("outcome", "tenant"), label_defaults=_TENANT)
# the online invariant watchdog (obs/watchdog.py)
WATCHDOG_FINDINGS = REGISTRY.counter(
    "karpenter_tpu_watchdog_findings_total",
    "Findings fired by the online invariant watchdog (obs/watchdog.py), "
    "by invariant and severity. Edge-triggered per (invariant, "
    "offending object): one firing per excursion. Nonzero critical "
    "findings mean a chaos-runner end-of-run invariant is being "
    "violated RIGHT NOW — each firing also lands a watchdog.finding "
    "marker trace in the flight-recorder ring and flips the readiness "
    "probe when critical",
    ("invariant", "severity", "tenant"), label_defaults=_TENANT)
WATCHDOG_VERDICT = REGISTRY.gauge(
    "karpenter_tpu_watchdog_verdict",
    "Worst severity among the watchdog's ACTIVE excursions: 0 = ok, "
    "1 = warning, 2 = critical. /readyz answers 503 while this reads 2 "
    "— the readiness face of the verification plane",
    ("tenant",), label_defaults=_TENANT)
SLO_ERROR_BUDGET = REGISTRY.gauge(
    "karpenter_tpu_slo_error_budget_remaining",
    "Fraction of a tenant's error budget remaining for one declared "
    "objective (obs/slo.py) since the SLO engine baselined: 1 = no bad "
    "events, 0 = budget exhausted, negative = overdrawn. The "
    "noisy-neighbor invariant reads as: the victim's gauge stays high "
    "while the noisy tenant's burns down",
    ("slo", "tenant"), label_defaults=_TENANT)
SLO_BURN_RATE = REGISTRY.gauge(
    "karpenter_tpu_slo_burn_rate",
    "Multi-window burn rate: bad-event rate over the window divided by "
    "the objective's allowance (1 = spending budget exactly at the "
    "sustainable rate; 14.4 = a 30d budget gone in 2d). Windows are "
    "sim-time (fast=5m, slow=1h) so chaos runs evaluate burn on the "
    "same timeline that produced the events",
    ("slo", "window", "tenant"), label_defaults=_TENANT)
SLO_BURN_ALERTS = REGISTRY.counter(
    "karpenter_tpu_slo_burn_alerts_total",
    "Burn-rate alerts fired by the SLO engine (fast AND slow window "
    "over threshold — the classic multi-window page condition). Each "
    "firing also lands an slo.burn trace in the flight-recorder ring "
    "so the alert arrives with its evidence",
    ("slo", "tenant"), label_defaults=_TENANT)

# --- the delta plane, the recompute and phase ledgers, and the device
# telemetry plane (obs/profile, obs/recompute, obs/devicemem,
# ops/delta, ops/resident) ---
TRANSFER_BYTES_H2D = REGISTRY.gauge(
    "karpenter_tpu_solver_transfer_host_to_device_bytes",
    "Bytes uploaded host-to-device by the last solve — the tunnel-budget "
    "observable ops/solver.transfer_stats() counts calls for, in bytes, "
    "visible without reading bench JSON")
TRANSFER_BYTES_D2H = REGISTRY.gauge(
    "karpenter_tpu_solver_transfer_device_to_host_bytes",
    "Bytes read device-to-host by the last solve (the packed result "
    "vector; growth here means the single-read output packing regressed)")
PROFILE_PHASE_MS = REGISTRY.counter(
    "karpenter_tpu_profile_phase_ms_total",
    "Milliseconds of wall time the phase-attribution ledger "
    "(obs/profile.py) attributed to each named phase bucket of a traced "
    "solve/reconcile, by enclosing kind — the scrapeable form of the "
    "'where does the 100ms go' table `make profile-report` prints. Only "
    "grows while tracing is enabled (the ledger ingests finished traces)",
    ("phase", "kind", "tenant"), label_defaults=_TENANT)
PROFILE_UNATTRIBUTED_MS = REGISTRY.counter(
    "karpenter_tpu_profile_unattributed_ms_total",
    "Milliseconds of a traced solve/reconcile's wall time NO ledger "
    "bucket claimed (the enclosing span's self-time outside every "
    "instrumented seam). The coverage invariant: buckets must sum to "
    ">=99% of the enclosing wall or the gap is flight-recorded as a "
    "profile.unattributed trace — growth here means an un-spanned seam "
    "appeared on the hot path",
    ("kind", "tenant"), label_defaults=_TENANT)
PROFILE_COVERAGE = REGISTRY.gauge(
    "karpenter_tpu_profile_attribution_coverage",
    "Running attribution coverage of the phase ledger (attributed wall "
    "/ enclosing wall, 0..1) per traced-root kind — the bench "
    "acceptance bar is >=0.99",
    ("kind", "tenant"), label_defaults=_TENANT)
DEVICEMEM_LIVE = REGISTRY.gauge(
    "karpenter_tpu_devicemem_live_bytes",
    "Bytes currently resident on the device per residency-ledger owner "
    "kind (obs/devicemem.py OWNER_KINDS: catalog tensors, per-solve "
    "uploads, batched request matrices, packed results, mesh shards) — "
    "the live face of the HBM accounting ROADMAP item 3's device-"
    "resident state will be judged against", ("kind",))
DEVICEMEM_WATERMARK = REGISTRY.gauge(
    "karpenter_tpu_devicemem_watermark_bytes",
    "High-water mark of total ledger-tracked device bytes since process "
    "start (or the last bench regime reset) — the HBM footprint budget "
    "observable; bench stamps it as c12_hbm_watermark_bytes")
DEVICEMEM_UNATTRIBUTED = REGISTRY.gauge(
    "karpenter_tpu_devicemem_unattributed_bytes",
    "Live device bytes the residency ledger could NOT account for at "
    "the last audit() cross-check against the live device tensors — the "
    "memory analog of the phase ledger's coverage invariant: growth "
    "means an untracked allocation path appeared; coverage below 99% "
    "also flight-records a devicemem.unattributed marker trace")
DEVICEMEM_TRANSFER = REGISTRY.counter(
    "karpenter_tpu_devicemem_transfer_bytes_total",
    "Device-boundary bytes by attribution reason (catalog_put / "
    "request_upload / batch_upload / screen_upload / readback) and "
    "tenant — the decomposed successor of the two aggregate transfer "
    "gauges: which tenant's which path moved the bytes, scrapeable "
    "without a bench run (per-shape-class rows live on /debug/device)",
    ("reason", "tenant"), label_defaults=_TENANT)
UPLOAD_BYTES = REGISTRY.counter(
    "karpenter_tpu_devicemem_upload_bytes_total",
    "Uploaded request-matrix bytes by redundancy outcome: 'identical' "
    "rows content-hash equal to the previous upload of the same "
    "facade/catalog-view key (bytes a delta upload would NOT ship), "
    "'changed' rows differ (the irreducible upload). The identical "
    "share is the measured ROADMAP-item-3 target",
    ("outcome", "tenant"), label_defaults=_TENANT)
UPLOAD_REDUNDANT_FRAC = REGISTRY.gauge(
    "karpenter_tpu_devicemem_upload_redundant_frac",
    "Fraction of the LAST observed request-matrix upload whose rows "
    "were content-identical to the previous upload for that catalog "
    "view (0..1): ~1.0 on a steady warm path means almost every "
    "uploaded byte is a byte the device already holds — informational "
    "(never perf-gated), it sizes the delta-upload win",
    ("tenant",), label_defaults=_TENANT)
DEVICEMEM_PATCH = REGISTRY.counter(
    "karpenter_tpu_devicemem_patch_bytes_total",
    "Device-resident state traffic by outcome (ops/resident.py): "
    "'patched' = changed-row bytes shipped as sparse scatter patches "
    "onto a resident buffer, 'avoided' = bytes content-identical to "
    "the resident copy and therefore NEVER shipped (the realized "
    "delta-upload win the upload-redundancy meter only predicted), "
    "'full' = fallback full re-uploads (epoch bumps, shape-class "
    "growth, dense patches, invalidations)",
    ("outcome", "tenant"), label_defaults=_TENANT)
RESIDENT_FALLBACKS = REGISTRY.counter(
    "karpenter_tpu_resident_fallback_total",
    "Resident-state full re-uploads by trigger: 'first_sight' (cold "
    "seeding), 'token_change' (catalog epoch bump / ICE-price view "
    "re-fingerprint), 'shape_change' (padded shape-class or resource-"
    "axis growth), 'dtype_change', 'dense' (patch would ship most of "
    "the matrix), 'invalidated' (SharedCatalogCache view split/"
    "eviction or warm-path audit divergence). Steady state is patches, "
    "not fallbacks — growth here is re-upload cost returning",
    ("reason", "tenant"), label_defaults=_TENANT)
RECOMPUTE_WORK = REGISTRY.counter(
    "karpenter_tpu_recompute_work_total",
    "Work-provenance units classified by the recompute observatory "
    "(obs/recompute.py), by taxonomy stage (encode, conflict, affinity, "
    "spread, solve, optimizer, disrupt) and outcome: 'fresh' = an input "
    "fingerprint the stage had not seen, 'redundant' = the same "
    "fingerprint recomputed from scratch (the measured headroom a memo/"
    "cache/residency layer can spend — ROADMAP item 3's target), "
    "'delta_served' = the work was answered by an existing cache, memo, "
    "or warm admission instead of recomputed",
    ("stage", "outcome", "tenant"), label_defaults=_TENANT)
REDUNDANT_WORK_FRAC = REGISTRY.gauge(
    "karpenter_tpu_redundant_work_frac",
    "Redundant share of each recompute-taxonomy stage's classified work "
    "units (redundant / total, cumulative). Above 0.9 and rising past a "
    "sim-time grace trips the watchdog's recompute_runaway invariant — "
    "a stage grinding the same inputs every reconcile with no layer "
    "serving the delta", ("stage",))
REDUNDANT_WORK_MS = REGISTRY.counter(
    "karpenter_tpu_redundant_work_ms_total",
    "Traced wall attributed to REDUNDANT stage work, per taxonomy "
    "stage: each ledger-material trace's per-stage self-time is split "
    "across the outcomes that trace classified, proportionally by "
    "units. This is the headroom table's ms column — the reconcile "
    "wall a delta-aware layer would delete", ("stage",))
RECOMPUTE_UNATTRIBUTED_MS = REGISTRY.counter(
    "karpenter_tpu_recompute_unattributed_ms_total",
    "Traced taxonomy-stage wall the recompute plane could NOT attribute "
    "to any classified work (the stage's spans ran but no classify() "
    "call landed in that trace), per stage. The ≥99% coverage "
    "invariant's gap meter: growth means a code path does stage work "
    "without registering its input fingerprint — each gap also lands a "
    "recompute.unattributed marker in the flight recorder", ("stage",))
DELTA_MEMO = REGISTRY.counter(
    "karpenter_tpu_delta_memo_total",
    "Delta-plane memo protocol events (ops/delta.py), by memo stage "
    "(solve, affinity, spread, optimizer) and event: 'served' = an "
    "unchanged-input pass answered from the memo (the matching work "
    "unit meters recompute_work_total{outcome='delta_served'}), "
    "'stored' = a freshly computed output memoized, 'audit' = a serve "
    "refused because the audit cadence expired (the caller recomputes "
    "fresh), 'confirmed' = that fresh recompute matched the stored "
    "output, byte-for-byte by content fingerprint. A confirmed/audit "
    "ratio below 1.0 means divergences — see "
    "delta_invalidations_total", ("stage", "event"))
DELTA_INVALIDATIONS = REGISTRY.counter(
    "karpenter_tpu_delta_invalidations_total",
    "Delta-memo entries dropped, by stage and ladder reason: "
    "'divergence' = an audit recompute disagreed with the stored "
    "output (opens the never-wrong-twice cooldown for that key), "
    "'epoch' = the key re-stored under a new input fingerprint (the "
    "world moved), 'quarantine' = an integrity violation quarantined "
    "the owning facade's device path and its memos with it, "
    "'capacity' = LRU bound, 'disarm' = explicit force-cold. "
    "Divergences on a healthy run mean a memo key is too weak — the "
    "audit cadence caught it, which is the design, but the rate "
    "should be zero", ("stage", "reason"))

__all__ = ["REGISTRY", "Registry", "Counter", "Gauge", "Histogram"]
