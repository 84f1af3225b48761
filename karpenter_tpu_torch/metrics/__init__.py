"""Framework metrics: the port's own copy of the metric families the
facade path touches (`karpenter_tpu/metrics/__init__.py` defines them all).
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

__all__ = ["REGISTRY", "Registry", "Counter", "Gauge", "Histogram"]
