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

__all__ = ["REGISTRY", "Registry", "Counter", "Gauge", "Histogram"]
