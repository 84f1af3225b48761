"""Solver facade: pods + NodePool + catalog → launch decisions.

The `Solver` interface of the north star: the control plane owns all
mutable state and calls solve() statelessly with (pods, catalog-epoch);
this module hides encoding, spread-splitting, device-tensor caching, and
backend selection (the CUDA kernels vs the native and host solvers —
identical semantics).

Output maps tensor results back to the object world: one NodeLaunch per
new virtual node, carrying the committed instance type, the cheapest
surviving offering, a price-sorted override list for launch resilience
(reference sends ≤60 override rows per CreateFleet, instance.go:58-63),
and the concrete pods nominated to it.

The port's copy of `karpenter_tpu/ops/facade.py`. The device rung is the
port's `ops/solver.solve_device` (kernels B0 and B on the card, or their
plain versions when the facade is built with `device="cpu"`);
`stage_batchable` stages a fresh device-rung solve for the fleet's batched
dispatch (`ops/solver.dispatch_batch`). Not ported yet, each with its call
site marked by the ROADMAP item that brings it: the delta plane
(serve-and-verify memos), the device-resident state and its audit, the
explain recorder and the warm path. None of these changes an answer.

The device rung serves from the card or raises: a kernel that fails to
build, refuses its shapes or fails to launch, and a device answer the
integrity oracle rejects, raise out of `Solver.solve`. The reference's
degradation ladder (`_degrade`, the integrity quarantine and their
cooldown) runs for injected faults only (`ops/solver.InjectedFault` and
the corruption hook), where it is metered as the reference meters it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..catalog.provider import CatalogProvider
from ..models import labels as L
from ..models.instancetype import InstanceType
from ..models.nodeclaim import NodeClaim
from ..models.nodepool import NodeClassSpec, NodePool
from ..models.pod import Pod, term_selects
from ..models.requirements import Requirements
from ..models.resources import Resources
from ..obs.tracer import NOOP_SPAN, TRACER
from .affinity import apply_zone_affinity
from .binpack import (SolveResult, SpreadConstraintCounts, VirtualNode,
                      copy_virtual_node, solve_host, split_spread_groups)
from .colocate import (BundleNode, ColocationPlan, has_colocation,
                       plan_colocation)
from .encode import (CatalogTensors, EncodedPods, align_resources,
                     encode_catalog, encode_pods)
from .solver import reject_mesh, resolve_device

MAX_OVERRIDES = 60  # reference MaxInstanceTypes (instance.go:62)


class SharedCatalogCache:
    """Content-keyed CatalogTensors shared across Solver facades — the
    fleet's one-catalog-many-tenants seam (docs/fleet.md).

    A fleet runs N tenant control planes, each with its own
    CatalogProvider (own ICE marks, own pricing clocks), through one
    process. Tenants running identical pools would each pay
    encode_catalog (and a device upload, and — via fresh shapes — an XLA
    compile) for byte-identical views. This cache keys views by
    (nodeclass-hash, availability fingerprint): tenants whose resolved
    catalogs AGREE share one CatalogTensors object, hence one
    device-resident DeviceCatalog (ops/solver._auto_dcat keys on the
    content token); tenants whose views
    diverge (an ICE mark, a price move) fingerprint differently and get
    their own entry — per-tenant isolation is preserved by content, not
    trust.

    Entries carry a content-authoritative `cache_token`
    ("shared", nodeclass-hash, fingerprint): unlike the per-facade
    (nodeclass-hash, epoch) token, it is collision-free ACROSS providers
    (two tenants' epoch counters can agree while their availability
    differs), which is what makes process-global device caching on the
    token sound."""

    MAX_ENTRIES = 16

    def __init__(self):
        from collections import OrderedDict
        self._entries: "OrderedDict[tuple, CatalogTensors]" = OrderedDict()
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0}

    @staticmethod
    def fingerprint(types: Sequence[InstanceType]) -> str:
        """Digest of everything encode_catalog reads from a resolved
        type list: names, requirements, capacity, overhead, and every
        offering's (zone, captype, price, availability, reservation)
        tuple. ~1e4 offerings hash in well under a millisecond — paid
        only on a facade-local epoch miss, never per solve."""
        import hashlib
        h = hashlib.blake2b(digest_size=16)
        for t in types:
            h.update(t.name.encode())
            for key in sorted(t.requirements.keys()):
                vs = t.requirements.get(key)
                h.update(f"|{key}:{sorted(vs.values)}:{vs.complement}"
                         f":{vs.gt}:{vs.lt}".encode())
            for k in sorted(t.capacity):
                h.update(f"|{k}={t.capacity.get(k)}".encode())
            for k, v in sorted(t.overhead.total().items()):
                h.update(f"|oh:{k}={v}".encode())
            for o in t.offerings:
                h.update(f"|{o.zone}/{o.capacity_type}/{o.price}"
                         f"/{o.available}/{o.reservation_id}"
                         f"/{o.reservation_capacity}/{o.reservation_type}"
                         f"/{o.reservation_ends}".encode())
            h.update(b";")
        return h.hexdigest()

    def get_or_encode(self, nc_hash: str,
                      types: Sequence[InstanceType]) -> CatalogTensors:
        from ..metrics import FLEET_CATALOG_SHARED
        key = (nc_hash, self.fingerprint(types))
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            FLEET_CATALOG_SHARED.inc(event="hit")
            return hit
        cat = encode_catalog(list(types))
        cat.cache_token = ("shared",) + key
        self._entries[key] = cat
        self.stats["misses"] += 1
        FLEET_CATALOG_SHARED.inc(event="miss")
        while len(self._entries) > self.MAX_ENTRIES:
            old_key, _old = self._entries.popitem(last=False)
            # a dead shared view must not pin device buffers until the
            # token FIFO happens to trim them: release every device-
            # resident variant of this view (base + noblocks/daemonset-
            # derived tokens) the moment the view itself is evicted
            from .solver import release_shared_views
            release_shared_views(("shared",) + old_key)
        return cat


def _daemonset_overhead_parts(
        cat: CatalogTensors, daemonsets, nodepool: NodePool,
        template: Dict[str, str],
        ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(base [T, R], zone_var [T, Z, R]) daemonset reservations.

    base: daemonsets that run in EVERY zone this pool's nodes can land
    in (no zone selector, or full overlap with the pool's zones) — a
    flat per-type reservation the solve bakes into allocatable.
    zone_var: zone-pinned daemonsets whose zones only PARTIALLY overlap
    the pool's — reserved per (type, zone); a node charges the
    elementwise max over its remaining zone mask, so nodes whose zones
    narrow away from the daemonset get their headroom back (the
    reference charges any template-compatible daemonset on every
    virtual node — core scheduler daemonset simulation — so this is
    strictly tighter packing at equal safety).

    Per-type, not per-pool: a gpu-selector daemonset reserves only on
    gpu-carrying types. Each compatible daemonset also consumes one pod
    slot. Either part is None when nothing applies."""
    from ..models.pod import tolerates_all
    from ..models.resources import PODS, Resources
    from .encode import compat_mask
    taints = nodepool.taints + nodepool.startup_taints
    pool_zvs = nodepool.requirements.get(L.ZONE)
    pool_zones = [z for z in cat.zones
                  if pool_zvs is None or pool_zvs.contains(z)]
    R = cat.allocatable.shape[1]
    base = None
    zvar = None
    for ds in daemonsets:
        if taints and not tolerates_all(ds.tolerations, taints):
            continue
        reqs = ds.scheduling_requirements()
        ds_zvs = reqs.get(L.ZONE)
        partial = None  # zone indices, when only partially overlapping
        if ds_zvs is not None:
            possible = [z for z in pool_zones if ds_zvs.contains(z)]
            if not possible:
                continue
            if len(possible) < len(pool_zones):
                partial = [cat.zones.index(z) for z in possible]
        mask = compat_mask(reqs, cat, template)
        if not mask.any():
            continue
        vec = ds.requests.add(Resources({PODS: 1.0})).to_vector()
        v = np.zeros(R, np.float32)
        n = min(len(vec), R)
        v[:n] = vec[:n]
        if partial is None:
            if base is None:
                base = np.zeros((cat.T, R), np.float32)
            base[mask] += v
        else:
            if zvar is None:
                zvar = np.zeros((cat.T, cat.Z, R), np.float32)
            for zi in partial:
                zvar[mask, zi] += v
    return base, zvar


def daemonset_overhead(cat: CatalogTensors, daemonsets, nodepool: NodePool,
                       template: Dict[str, str]) -> Optional[np.ndarray]:
    """f32 [T, R]: the zone-INVARIANT per-instance-type daemonset
    reservation (reference core: the scheduler adds daemonset pods to
    every virtual node before placing workloads). Zone-pinned daemonsets
    with partial pool overlap are excluded here — they live on
    CatalogTensors.zone_overhead (see _daemonset_overhead_parts).
    Returns None when nothing applies."""
    base, _ = _daemonset_overhead_parts(cat, daemonsets, nodepool, template)
    return base


def apply_daemonset_overhead(cat: CatalogTensors, daemonsets,
                             nodepool: NodePool,
                             template: Dict[str, str]) -> CatalogTensors:
    """Shrink the catalog's allocatable by the pool's zone-invariant
    daemonset overhead and attach the zone-varying part as
    `zone_overhead` — the ONE transformation both the solve and the
    consolidation screen apply, so their headroom views can't diverge.
    Returns `cat` itself when nothing applies."""
    if not daemonsets:
        return cat
    base, zvar = _daemonset_overhead_parts(cat, daemonsets, nodepool,
                                           template)
    if base is None and zvar is None:
        return cat
    from dataclasses import replace as _dc_replace
    alloc = (np.maximum(cat.allocatable - base, 0.0)
             if base is not None else cat.allocatable)
    # derived view → derived encode-cache token: the overhead bytes pin
    # the view's identity. A content DIGEST, not Python hash(): the
    # digest is the only part of the token carrying this identity, so a
    # collision would silently alias two different allocatable views
    # onto one EncodeContext — blake2b makes that a non-event
    token = None
    if cat.cache_token is not None:
        import hashlib
        h = hashlib.blake2b(digest_size=16)
        h.update(base.tobytes() if base is not None else b"-")
        h.update(zvar.tobytes() if zvar is not None else b"-")
        token = cat.cache_token + ("ds", h.hexdigest())
    return _dc_replace(cat, allocatable=alloc, zone_overhead=zvar,
                       cache_token=token)


def targets_reserved(requirements: Optional[Requirements]) -> bool:
    """Does a Requirements conjunction EXPLICITLY name the reserved
    capacity type (an In requirement listing "reserved")? This is the
    capacity-block gate of the reference launch filters
    (filter.go:163-228 shouldFilter: requirements.Get(capacity-type)
    .Has(reserved)): prepaid capacity blocks only serve launches that
    opted into reserved capacity — an unconstrained pool must never
    spill plain pods onto a block just because its price rounds to
    zero. Exists / NotIn do not count: they don't *name* reserved."""
    if requirements is None:
        return False
    vs = requirements.get(L.CAPACITY_TYPE)
    return (vs is not None and not vs.complement
            and L.CAPACITY_RESERVED in vs.values)


def min_values_floors(requirements: Optional[Requirements],
                      ) -> List[Tuple[str, int]]:
    """(key, minValues) floors of a Requirements conjunction — the single
    extraction both the node-opening caps and the override-row selection
    share, so the two enforcement points can't diverge."""
    if requirements is None:
        return []
    return [(k, requirements.min_values(k)) for k in requirements.keys()
            if requirements.min_values(k)]


@dataclass
class NodeLaunch:
    instance_type: str
    zone: str
    capacity_type: str
    price: float
    overrides: List[Tuple[str, str, str, float]]  # (type, zone, captype, price)
    pod_keys: List[str]
    requests: Resources
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class SolveOutput:
    launches: List[NodeLaunch]
    existing_placements: Dict[str, List[str]]  # existing node name -> pod keys
    unschedulable: List[str]                   # pod keys
    stats: Dict[str, float] = field(default_factory=dict)


@dataclass
class PreparedSolve:
    """A solve() staged up to (but not including) its backend run — the
    seam the fleet's batched dispatcher works through: prepare_solve()
    does every host-side step (catalog view, gates, colocation, encode,
    spread, backend choice), run_prepared()/a batched device call
    produces the SolveResult, finish_solve() decodes and applies the
    post-passes. solve() composes the three, so the serial path and the
    batched path are the same program by construction.

    `output` non-None means the solve terminated during preparation
    (empty catalog, colocation-only, zero groups) — the value is FINAL
    (merge + reserved-retry already applied)."""

    output: Optional[SolveOutput] = None
    cat: Optional[CatalogTensors] = None
    cat_key: tuple = ()              # facade catalog-LRU key AT prepare time
    enc: Optional[EncodedPods] = None
    existing: Optional[List[VirtualNode]] = None
    plan: Optional[ColocationPlan] = None
    dropped: List[str] = field(default_factory=list)
    blocks_gated: bool = False
    ds_fp: int = 0
    all_pods: Sequence[Pod] = ()
    nodepool: Optional[NodePool] = None
    node_class: Optional[NodeClassSpec] = None
    spread_occupancy: Optional[list] = None
    daemonsets: Optional[list] = None
    backend: str = ""
    t0: float = 0.0


def _span(name: str):
    return TRACER.span(name) if TRACER.enabled else NOOP_SPAN


def _pod_key(p: Pod) -> str:
    return f"{p.namespace}/{p.name}"


class Solver:
    # "hybrid" routes solves of fewer pods to the native/host rung and
    # reserves the card for larger ones. The reference's value, kept:
    # chip_smoke.py's facade phase measures the device/native crossover on
    # two pod mixes (NVIDIA H100 80GB HBM3, 700 W), and it moves with the
    # mix (the native rung's cost grows with the group count), so no one
    # measured value replaces it
    DEVICE_MIN_PODS = 4096

    # encoded-catalog views kept warm (LRU): clusters alternating a few
    # NodeClass views per reconcile must not re-encode the catalog (and
    # re-upload device tensors) on every flip — a single-slot cache
    # thrashed exactly that way
    CAT_CACHE_SIZE = 4

    def __init__(self, catalog: CatalogProvider, backend: str = "auto",
                 device_min_pods: Optional[int] = None,
                 profile_dir: str = "", encode_cache: bool = True,
                 shared_catalog: Optional[SharedCatalogCache] = None,
                 device=None):
        """device: where the device rung runs — the CUDA card unless the
        caller passes one (device="cpu" runs the kernels' plain versions,
        as the tests do). A "device" or "hybrid" facade without a card and
        without `device` raises, as solve_device does; "mesh" is not
        ported and raises."""
        from collections import OrderedDict
        self.catalog = catalog
        # fleet seam: when set, catalog views resolve through the
        # process-shared content-keyed cache, so facades of tenants with
        # identical pools share encoded tensors, device uploads, and
        # compiled executables (SolverService wires one cache across all
        # tenant facades); None = classic per-facade encoding
        self._shared_catalog = shared_catalog
        self.device_min_pods = (self.DEVICE_MIN_PODS if device_min_pods is None
                                else device_min_pods)
        # non-empty: every solve runs under torch.profiler (utils/profiling)
        self.profile_dir = profile_dir
        if backend == "auto":
            backend = self._detect_backend()
        if backend == "mesh":
            reject_mesh(backend)
        self.backend = backend
        self.device = (resolve_device(device)
                       if backend in ("device", "hybrid") or device is not None
                       else None)
        self._cat_cache: "OrderedDict[tuple, CatalogTensors]" = OrderedDict()
        self._dcat_cache: Dict[tuple, object] = {}  # device-resident tensors
        self._last_cat_key: tuple = ()
        # columnar encode pipeline (ops/encode_cache): per-signature rows
        # persist across solves, staged through one reusable arena
        from .encode_cache import EncodeArena, EncodeCache
        self._encode_cache = EncodeCache() if encode_cache else None
        self._arena = EncodeArena()
        # degraded mode: >0 while device dispatches are rerouted to
        # the fallback backend after a mid-solve device fault; decremented
        # per rerouted solve, so the device path is re-probed after
        # FALLBACK_COOLDOWN solves (count-based, hence sim-deterministic)
        self._device_suspended = 0
        # solution-integrity plane (integrity/): the canary sampler is per
        # facade, so quarantine only ever degrades the affected tenant's
        # path
        self._canary = None
        self.stats: Dict[str, int] = {"catalog_rebuilds": 0,
                                      "device_fallbacks": 0,
                                      "integrity_violations": 0,
                                      "integrity_recoveries": 0}

    @staticmethod
    def _accel_attached() -> bool:
        return torch.cuda.is_available()

    @classmethod
    def _detect_backend(cls) -> str:
        """auto: size-adaptive (hybrid) when a CUDA card is attached,
        else the compiled C++ solver, else the numpy oracle."""
        if cls._accel_attached():
            backend = "hybrid"
        else:
            from . import native
            backend = "native" if native.available() else "host"
        import logging
        logging.getLogger("karpenter_tpu_torch.solver").info(
            "backend=auto resolved to %s", backend)
        return backend

    # (the reference's mesh(), screen_mesh() and SCREEN_MESH_MIN_NODES sit
    # here: ROADMAP §1 item 13, multi-device)

    # solves routed to the fallback backend after a device fault before
    # the device path is probed again (count-based: deterministic in sim)
    FALLBACK_COOLDOWN = 8

    def _fallback_backend(self, cat: Optional[CatalogTensors] = None) -> str:
        """The degraded-mode target: the compiled C++ FFD when it can
        serve this solve, else the numpy host oracle."""
        if cat is not None and cat.zone_overhead is not None:
            return "host"  # native takes a flat [T, R] allocatable only
        from . import native
        return "native" if native.available() else "host"

    def _resolve_backend(self, total_pods: int) -> str:
        backend = self._resolve_backend_healthy(total_pods)
        if backend == "device" and self._device_suspended > 0:
            # degraded mode after a mid-solve device fault: reroute and
            # burn down the cooldown; the gauge clears when it reaches
            # zero (the NEXT device-sized solve re-probes the device)
            self._device_suspended -= 1
            if self._device_suspended == 0:
                from ..metrics import DEGRADED_MODE
                DEGRADED_MODE.set(0, component="solver")
            return self._fallback_backend()
        return backend

    def _degrade(self, from_backend: str, cat: CatalogTensors,
                 err: Exception, run_sp) -> str:
        """A device dispatch faulted mid-solve: pick the fallback
        backend, meter the event (fallback counter + degraded-mode gauge +
        trace attribution), and suspend the device path for a cooldown so
        every subsequent solve doesn't re-pay the fault latency while the
        backend is down. Returns the backend to re-run this solve on."""
        to = self._fallback_backend(cat)
        self._device_suspended = self.FALLBACK_COOLDOWN
        from ..metrics import DEGRADED_MODE, SOLVER_FALLBACKS
        DEGRADED_MODE.set(1, component="solver")
        SOLVER_FALLBACKS.inc(from_backend=from_backend, to_backend=to)
        self.stats["device_fallbacks"] += 1
        run_sp.set(backend=to, fallback_from=from_backend,
                   outcome="degraded", fault=type(err).__name__)
        import logging
        logging.getLogger("karpenter_tpu_torch.solver").warning(
            "%s backend faulted mid-solve (%s: %s); re-running on %s and "
            "suspending the device path for %d solves",
            from_backend, type(err).__name__, err, to,
            self.FALLBACK_COOLDOWN)
        return to

    def _resolve_backend_healthy(self, total_pods: int) -> str:
        if self.backend != "hybrid":
            return self.backend
        if total_pods >= self.device_min_pods:
            return "device"
        from . import native
        return "native" if native.available() else "host"

    def tensors(self, node_class: Optional[NodeClassSpec] = None) -> CatalogTensors:
        nc = node_class or NodeClassSpec()
        # hydrate BEFORE keying: the first raw-catalog pull bumps the
        # epoch (pricing hydration), and a key computed pre-pull would
        # cache the first view under a token no later solve reproduces
        self.catalog.raw_types()
        key = (nc.hash(),) + tuple(self.catalog.epoch)
        hit = self._cat_cache.get(key)
        if hit is None:
            types = self.catalog.list(nc)
            if self._shared_catalog is not None:
                # fleet: content-keyed lookup across every tenant facade
                # — a hit reuses another tenant's encoded view (its
                # "shared"-rooted cache_token makes the device tensors
                # shareable too); the local epoch-keyed LRU still fronts
                # it so the per-solve fast path stays two dict lookups
                hit = self._shared_catalog.get_or_encode(nc.hash(), types)
            else:
                hit = encode_catalog(types)
                hit.cache_token = key  # encode-cache lineage for derived views
            self._cat_cache[key] = hit
            # small LRU, not single-slot: two NodeClass views alternating
            # each reconcile must both stay resident (a clear-on-new-key
            # policy re-encoded — and re-uploaded — on every flip); the
            # evicted view's device-resident variants go with it
            while len(self._cat_cache) > self.CAT_CACHE_SIZE:
                old_key, _ = self._cat_cache.popitem(last=False)
                from ..metrics import DCAT_EVICTIONS
                for k in [k for k in self._dcat_cache
                          if k[: len(old_key)] == old_key]:
                    del self._dcat_cache[k]
                    DCAT_EVICTIONS.inc(reason="facade_lru")
            # availability-tensor rebuild counter: chaos tests assert an
            # ICE mark re-keys this (and the device upload cache) exactly
            # once per epoch change, not once per solve
            self.stats["catalog_rebuilds"] += 1
        else:
            self._cat_cache.move_to_end(key)
        self._last_cat_key = key
        # (the reference records the view's token for the device-resident
        # staleness feed here: ROADMAP §1 item 7, resident state)
        return hit

    def solve(self, pods: Sequence[Pod], nodepool: NodePool,
              node_class: Optional[NodeClassSpec] = None,
              existing: Optional[List[VirtualNode]] = None,
              capacity_cap: Optional[Resources] = None,
              existing_pods: Optional[Dict[str, List[Pod]]] = None,
              spread_occupancy: Optional[
                  List[Tuple[Optional[str], List[Pod]]]] = None,
              pregrouped: Optional[List[List[Pod]]] = None,
              daemonsets: Optional[list] = None,
              _gate_blocks: bool = True) -> SolveOutput:
        """capacity_cap: only open nodes whose total capacity fits within it
        (the NodePool-limits headroom; the reference scheduler stops opening
        virtual nodes that would breach spec.limits the same way).

        existing_pods: pods already on each existing node (by existing_name)
        — matched by constraint signature into the current groups so
        per-node caps (anti-affinity/hostname-spread) hold across
        reconciles, not just within one solve.

        spread_occupancy: cluster-wide (zone, pods) per node — ALL nodes
        including other pools' and unmanaged ones — used to seed topology-
        spread domain counts. Defaults to deriving from `existing` (this
        solve's nodes only), which under-counts in multi-pool clusters;
        the provisioner passes the full view."""
        prep = self.prepare_solve(
            pods, nodepool, node_class, existing, capacity_cap,
            existing_pods, spread_occupancy, pregrouped, daemonsets,
            _gate_blocks)
        if prep.output is not None:
            return prep.output
        result, backend = self.run_prepared(prep)
        return self.finish_solve(prep, result, backend)

    def prepare_solve(self, pods: Sequence[Pod], nodepool: NodePool,
                      node_class: Optional[NodeClassSpec] = None,
                      existing: Optional[List[VirtualNode]] = None,
                      capacity_cap: Optional[Resources] = None,
                      existing_pods: Optional[Dict[str, List[Pod]]] = None,
                      spread_occupancy: Optional[
                          List[Tuple[Optional[str], List[Pod]]]] = None,
                      pregrouped: Optional[List[List[Pod]]] = None,
                      daemonsets: Optional[list] = None,
                      _gate_blocks: bool = True) -> PreparedSolve:
        """Everything solve() does BEFORE the backend run: catalog view +
        gates, colocation planning, encode, spread split, backend choice.
        Host-side work only — safe to interleave across many requests
        (the batched dispatcher stages every queued solve through here
        before a single device call serves them all)."""
        with _span("solve.tensors"):
            cat = self.tensors(node_class)
        if cat.T == 0 or not pods:
            return PreparedSolve(
                output=SolveOutput([], {}, [_pod_key(p) for p in pods]))
        # capacity-block gate (reference filter.go:163-228): unless the
        # pool explicitly targets reserved capacity, block offerings are
        # removed from the availability tensor BEFORE the solve — the
        # cost-argmin must never commit a prepaid block for a pool that
        # didn't select it (and the override list can't resurrect one)
        blocks_gated = False
        if (_gate_blocks and cat.is_block is not None and cat.is_block.any()
                and not targets_reserved(nodepool.requirements)):
            from dataclasses import replace as _dc_replace
            cat = _dc_replace(cat, available=cat.available & ~cat.is_block,
                              cache_token=(cat.cache_token + ("noblocks",)
                                           if cat.cache_token is not None
                                           else None))
            blocks_gated = True
        all_pods = pods  # reference, captured before the colocation path
        # rebinds the local; only read if the reserved retry fires
        # NodePool-template node labels — pod selectors on keys the
        # catalog doesn't carry resolve against these (every launched
        # node wears them; NodePool.template_labels is the one source)
        template = nodepool.template_labels()
        # daemonset overhead: reserve per-node resources for daemonset
        # pods BEFORE placing workloads, by shrinking the allocatable
        # tensor (equivalent to starting every node's cum at the
        # overhead; covers every backend uniformly, and existing-node
        # views see the same reduced headroom since their daemonsets
        # run too)
        ds_fp = 0
        if daemonsets:
            reduced = apply_daemonset_overhead(cat, daemonsets, nodepool,
                                               template)
            if reduced is not cat:
                cat = reduced
                ds_fp = hash((cat.allocatable.tobytes(),
                              None if cat.zone_overhead is None
                              else cat.zone_overhead.tobytes()))
        fits_cap = None
        if capacity_cap is not None:
            types = self.catalog.list(node_class or NodeClassSpec())
            fits_cap = np.array(
                [all(t.capacity.get(k, 0.0) <= v + 1e-9
                     for k, v in capacity_cap.items())
                 for t in types], bool)
        # required positive hostname affinity: the host-side co-location
        # planner peels coupled pods off the tensor path (ops/colocate.py).
        # Positive affinity terms are part of the constraint signature, so
        # with pre-bucketed input probing one representative per group is
        # exact — no O(pods) scan
        plan = None
        bundle_occupancy: List[Tuple[Optional[str], List[Pod]]] = []
        colo_probe = ([ps[0] for ps in pregrouped if ps]
                      if pregrouped is not None else pods)
        with _span("solve.colocate"):  # the probe and the planner below
            has_colo = has_colocation(colo_probe)
        if has_colo:
            pregrouped = None  # the planner consumes the raw pod list
            # the planner writes resident placements into the nodes' cum /
            # masks so the main solve sees consumed capacity — work on
            # copies: callers (disruption) reuse their VirtualNodes across
            # many solves in one reconcile
            existing = [copy_virtual_node(vn) for vn in (existing or [])]
            existing_pods = dict(existing_pods or {})
            cat_plan = cat
            if cat.zone_overhead is not None:
                # the planner sizes concrete bundle nodes host-side;
                # give it the conservative (max-over-zones) reservation
                from dataclasses import replace as _dc_replace
                cat_plan = _dc_replace(
                    cat, allocatable=np.maximum(
                        cat.allocatable - cat.zone_overhead.max(axis=1),
                        0.0),
                    zone_overhead=None)
            with _span("solve.colocate"):
                plan = plan_colocation(
                    pods, cat_plan, extra_requirements=nodepool.requirements,
                    taints=nodepool.taints + nodepool.startup_taints,
                    existing=existing, existing_pods=existing_pods,
                    type_cap=fits_cap, template_labels=template)
            for name, placed in plan.existing_placements.items():
                # planner placements count as residents for the main solve's
                # per-node caps and occupancy
                existing_pods[name] = list(existing_pods.get(name, [])) + placed
            # pin each bundle to its concrete zone NOW so bundle pods are
            # visible to the zone-affinity pre-pass and topology-spread
            # domain counts of the same solve (a deferred zone cannot feed
            # either); launch keeps the cheapest offering within the pin
            for b in plan.bundles:
                zi = self._pin_bundle_zone(b, cat)
                bundle_occupancy.append((cat.zones[zi], b.pods))
            pods = plan.remaining
            if not pods:
                out = self._merge_plan(SolveOutput([], {}, []), plan,
                                       cat, nodepool)
                return PreparedSolve(output=self._retry_reserved_unschedulable(
                    out, blocks_gated, all_pods, nodepool, node_class,
                    spread_occupancy, daemonsets))
        taints = nodepool.taints + nodepool.startup_taints
        enc_ctx = (self._encode_cache.context_for(
                       cat, nodepool.requirements, taints, template)
                   if self._encode_cache is not None else None)
        sp = (TRACER.span("solve.encode", pods=len(pods),
                          pregrouped=pregrouped is not None)
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            lsp = (TRACER.span("encode.lower") if TRACER.enabled
                   else NOOP_SPAN)
            with lsp:
                enc = encode_pods(pods, cat,
                                  extra_requirements=nodepool.requirements,
                                  taints=taints,
                                  pregrouped=pregrouped,
                                  template_labels=template,
                                  cache=enc_ctx, arena=self._arena)
                lsp.set(groups=int(enc.G), cache_hits=enc.cache_hits,
                        cache_misses=enc.cache_misses)
            if TRACER.enabled and enc.cache_hits:
                # a dedicated marker span so the flight recorder can
                # attribute a fast encode to the gather path at a glance
                with TRACER.span("encode.cache_hit", rows=enc.cache_hits):
                    pass
            sp.set(groups=int(enc.G))
        self._meter_encode_rows(enc_ctx)
        if fits_cap is not None:
            enc.compat &= fits_cap[None, :]
            if enc.compat_hard is not None:
                enc.compat_hard = enc.compat_hard & fits_cap[None, :]
        self._apply_min_values_caps(enc, cat, nodepool.requirements)
        # pods dropped by the taint filter are unschedulable for this pool
        dropped = list(enc.dropped_keys or ())
        occupancy = (list(spread_occupancy) if spread_occupancy is not None
                     else self._occupancy_from_existing(existing, existing_pods, cat))
        if plan is not None:
            occupancy += bundle_occupancy
            if spread_occupancy is not None:
                # a caller-supplied cluster view predates the planner's
                # resident placements — append them (new pods only; the
                # resident pods themselves are already in the view)
                occupancy += [
                    (self._zone_of(name, existing, cat), placed)
                    for name, placed in plan.existing_placements.items()]
        sp = (TRACER.span("solve.spread") if TRACER.enabled else NOOP_SPAN)
        with sp:
            # the reference serves these two passes from the delta plane's
            # memos (ROADMAP §1 item 6, delta plane); its miss path, run
            # here, computes the same encoding
            asp = (TRACER.span("encode.affinity") if TRACER.enabled
                   else NOOP_SPAN)
            with asp:
                enc = apply_zone_affinity(enc, cat, occupancy)
            enc = split_spread_groups(
                enc, cat, self._spread_constraints(enc, cat, occupancy))
            sp.set(groups=int(enc.G))
        if enc.G == 0:
            out = self._merge_plan(SolveOutput([], {}, dropped), plan,
                                   cat, nodepool)
            return PreparedSolve(output=self._retry_reserved_unschedulable(
                out, blocks_gated, all_pods, nodepool, node_class,
                spread_occupancy, daemonsets))
        self._relax_infeasible_preferences(enc, cat)

        self.attach_existing_context(enc, existing, existing_pods)

        import time as _time
        t0 = _time.perf_counter()
        backend = self._resolve_backend(int(enc.counts.sum()))
        if backend == "native" and cat.zone_overhead is not None:
            # the C++ FFD takes a flat [T, R] allocatable; zone-varying
            # reservations need the masked-max path — host oracle instead
            backend = "host"
        prep = PreparedSolve(
            cat=cat, cat_key=self._last_cat_key, enc=enc,
            existing=existing, plan=plan, dropped=dropped,
            blocks_gated=blocks_gated, ds_fp=ds_fp, all_pods=all_pods,
            nodepool=nodepool, node_class=node_class,
            spread_occupancy=spread_occupancy, daemonsets=daemonsets,
            backend=backend, t0=t0)
        # (the reference serves an unchanged-input solve from the delta
        # plane's memo here: ROADMAP §1 item 6, delta plane)
        return prep

    def _device_dcat(self, prep: PreparedSolve):
        """Device-resident catalog tensors for a prepared solve — the ONE
        residency-cache policy the serial run and the batched stage
        share. Keys on prep.cat_key (captured at prepare time), so
        interleaved prepares of different views cannot cross-wire."""
        from .solver import _auto_dcat, device_catalog
        cat = prep.cat
        R = prep.enc.requests.shape[1]
        if (self._shared_catalog is not None
                and cat.cache_token is not None
                and cat.cache_token[0] == "shared"):
            # fleet: device residency keys on the content token in the
            # PROCESS-global cache (ops/solver._auto_dcat), so tenant
            # facades sharing this view — and its gated/daemonset-
            # derived tokens — share one upload
            return _auto_dcat(cat, R, self.device)
        # keyed on (nodeclass hash, catalog epoch, R, placement, block
        # gating) — NOT id(cat): a freed CatalogTensors' address can be
        # reused by its successor
        dkey = prep.cat_key + (R, False, prep.blocks_gated, prep.ds_fp)
        dcat = self._dcat_cache.get(dkey)
        if dcat is None:
            # device residency follows the host LRU: every variant
            # (block-gating states) of any CACHED
            # catalog view may stay — mixed pools and alternating
            # NodeClasses must not thrash a full host→device transfer
            # per solve
            n = len(prep.cat_key)
            from ..metrics import DCAT_EVICTIONS
            for k in [k for k in self._dcat_cache
                      if k[:n] not in self._cat_cache]:
                del self._dcat_cache[k]
                DCAT_EVICTIONS.inc(reason="facade_lru")
            # (the reference seeds a device-resident view here: ROADMAP
            # §1 item 7, resident state)
            dcat = device_catalog(cat, R, self.device)
            self._dcat_cache[dkey] = dcat
        return dcat

    def stage_batchable(self, prep: PreparedSolve):
        """ops.solver.BatchableSolve for a prepared solve, or None when it
        must run serially: its output is already set, its backend is not
        the device, it resumes existing nodes, or it is profiled. Staging
        uploads the catalog (residency only), so a pipelined caller
        overlaps it with the batch in flight. Unlike the reference, any
        other error raises instead of quietly turning the ticket serial."""
        if (prep.output is not None or prep.backend != "device"
                or prep.existing or self.profile_dir):
            return None
        from .solver import prepare_batchable
        # meter key: "the previous upload for this catalog view, from THIS
        # facade", so co-batched tenants sharing a device catalog still
        # key their own upload history
        return prepare_batchable(prep.cat, prep.enc,
                                 dcat=self._device_dcat(prep),
                                 meter_key=(("facade", id(self))
                                            + tuple(prep.cat_key)))

    def run_prepared(self, prep: PreparedSolve):
        """The backend run of a prepared solve, with the device-fault
        degradation machinery. Returns (SolveResult, backend actually
        used)."""
        from ..utils.profiling import maybe_trace
        cat, enc, existing = prep.cat, prep.enc, prep.existing
        backend = prep.backend
        run_sp = (TRACER.span("solve.run", backend=backend,
                              pods=int(enc.counts.sum()), groups=int(enc.G))
                  if TRACER.enabled else NOOP_SPAN)
        with run_sp, maybe_trace(self.profile_dir):
            if backend == "host":
                result = solve_host(cat, enc, existing)
            elif backend == "native":
                from .native import solve_native
                result = solve_native(cat, enc, existing)
            else:
                from .solver import InjectedFault, solve_device
                try:
                    dcat = self._device_dcat(prep)
                    result = solve_device(cat, enc, existing, dcat=dcat,
                                          device=self.device)
                except InjectedFault as e:
                    # an injected mid-solve device fault costs ONE rerouted
                    # solve, metered as the reference meters it. Anything
                    # else the device rung raises (a kernel's build, shape
                    # or launch error) propagates: the port never serves
                    # the card's work from another rung on its own
                    backend = self._degrade(backend, cat, e, run_sp)
                    if backend == "native":
                        from .native import solve_native
                        result = solve_native(cat, enc, existing)
                    else:
                        result = solve_host(cat, enc, existing)
        return result, backend

    def finish_solve(self, prep: PreparedSolve, result: SolveResult,
                     backend: str,
                     duration_s: Optional[float] = None) -> SolveOutput:
        """Decode + post-passes of a prepared solve whose SolveResult is
        in hand (serial run or a batched device call).

        duration_s: this solve's OWN cost, supplied by a pipelined
        caller — under batched dispatch, `now - prep.t0` spans other
        tickets' staging and other buckets' device work, which would
        inflate the histogram by up to the whole pump wall."""
        import time as _time

        from ..metrics import SOLVE_DURATION, SOLVE_PODS
        cat, enc = prep.cat, prep.enc
        # exemplar: a fat solve-duration bucket points at the captured
        # trace in the flight recorder (None when tracing is off)
        SOLVE_DURATION.observe(duration_s if duration_s is not None
                               else _time.perf_counter() - prep.t0,
                               backend=backend,
                               exemplar=TRACER.current_trace_id())
        SOLVE_PODS.observe(float(enc.counts.sum()))

        # solution-integrity oracle: every SolveResult — serial, a
        # batched row, or a warm-window cold pass — is validated here
        # BEFORE anything decodes into launches/nominations. A violation
        # quarantines this facade's device path and recovers the solve
        # through the fallback backend; KARPENTER_TPU_INTEGRITY=0 makes
        # this a single env check (today's path byte-for-byte)
        result, backend = self._verify_integrity(prep, result, backend)
        # (the reference memoizes the verified result in the delta plane
        # here: ROADMAP §1 item 6, delta plane)

        with _span("solve.output"):  # decode to launches, merge the plan
            out = self._decode(cat, enc, result, prep.nodepool, prep.dropped)
            out = self._merge_plan(out, prep.plan, cat, prep.nodepool)
        # (the reference records decision provenance here: ROADMAP §1
        # item 8, explain recorder)
        return self._retry_reserved_unschedulable(
            out, prep.blocks_gated, prep.all_pods, prep.nodepool,
            prep.node_class, prep.spread_occupancy, prep.daemonsets)

    def _retry_reserved_unschedulable(
            self, out: SolveOutput, blocks_gated: bool, all_pods: List[Pod],
            nodepool: NodePool, node_class: Optional[NodeClassSpec],
            spread_occupancy, daemonsets: Optional[list] = None,
            ) -> SolveOutput:
        """Pods the gated solve left unschedulable that EXPLICITLY target
        reserved capacity (a pod-level capacity-type selector naming
        "reserved" under a pool that doesn't) get one ungated re-solve
        onto fresh nodes: the reference gate evaluates the MERGED
        nodeclaim requirements (filter.go shouldFilter), so a pod's own
        reserved intent must open capacity blocks even when its pool
        stays silent. Fresh nodes only — blocks never live on existing
        capacity, and reusing the first solve's mutated node views would
        double-count headroom."""
        if not blocks_gated or not out.unschedulable:
            return out
        by_key = {_pod_key(p): p for p in all_pods}
        retry = [by_key[k] for k in out.unschedulable
                 if k in by_key
                 and targets_reserved(by_key[k].scheduling_requirements())]
        if not retry:
            return out
        second = self.solve(retry, nodepool, node_class,
                            spread_occupancy=spread_occupancy,
                            daemonsets=daemonsets, _gate_blocks=False)
        retried = {_pod_key(p) for p in retry}
        out.launches += second.launches
        for name, keys in second.existing_placements.items():
            out.existing_placements.setdefault(name, []).extend(keys)
        out.unschedulable = [k for k in out.unschedulable
                             if k not in retried] + second.unschedulable
        return out

    # --- solution-integrity plane (integrity/) ----------------------------
    def _verify_integrity(self, prep: PreparedSolve, result: SolveResult,
                          backend: str):
        """Feasibility oracle + canary for one solve (the reference's
        resident-state audit joins with the resident state, ROADMAP §1
        item 7).
        Returns the (possibly recovered) (result, backend). Read-only on
        the happy path. A device violation re-runs the solve on the
        fallback backend. Then:
        - with a corruption injected, ship the fallback's answer and
          suspend the device path (the same never-wrong-twice suspension
          a mid-solve device fault earns);
        - without one, when the fallback's answer fails the same checks,
          the violation lies in the input (an existing node already over
          its capacity): ship the device answer with the violation
          metered, as the native and host rungs do, and keep the device
          path. The reference quarantines here too (ROADMAP §3);
        - without one, otherwise, the device path itself answered
          wrongly: raise IntegrityError."""
        from ..integrity import integrity_enabled
        if not integrity_enabled() or prep.enc is None:
            return result, backend
        from ..integrity import CanarySampler, INTEGRITY, verify_result
        sp = (TRACER.span("integrity.verify", backend=backend)
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            violations = verify_result(prep.cat, prep.enc, result)
            device_backed = backend == "device"
            if not violations and device_backed and not prep.existing:
                if self._canary is None:
                    self._canary = CanarySampler()
                if self._canary.due():
                    violations = self._canary.check(prep.cat, prep.enc,
                                                    result)
            if not violations:
                INTEGRITY.record_ok()
                sp.set(outcome="ok")
                return result, backend
            # breach accounting: the violating SOLVE is one context
            INTEGRITY.record_breach_event()
            self.stats["integrity_violations"] += len(violations)
            for vio in violations:
                INTEGRITY.record_violation(vio.check, vio.detail)
            import logging
            logging.getLogger("karpenter_tpu_torch.integrity").warning(
                "integrity violation on %s-backed solve (%s) — "
                "quarantining the device path and recovering on the "
                "fallback backend",
                backend, "; ".join(str(v) for v in violations[:4]))
            sp.set(outcome="violation",
                   checks=",".join(sorted({v.check for v in violations})))
            if not device_backed:
                # the host/native result IS the ground truth path: there
                # is no better oracle to recover through — surface the
                # violation loudly (unrecovered outcome + watchdog
                # breach) and ship what we have
                INTEGRITY.record_recovery(False)
                return result, backend
            fallback = self._fallback_backend(prep.cat)
            if fallback == "native":
                from .native import solve_native
                recovered = solve_native(prep.cat, prep.enc, prep.existing)
            else:
                recovered = solve_host(prep.cat, prep.enc, prep.existing)
            still = verify_result(prep.cat, prep.enc, recovered)
            from . import solver as _solver
            if _solver._corruption_hook is None:
                INTEGRITY.record_recovery(False)
                if {str(x) for x in violations} <= {str(x) for x in still}:
                    # the input's fault: ship the device answer, metered,
                    # and keep the device path (no rung swap, no cooldown)
                    sp.set(outcome="input_violation")
                    return result, backend
                # the device path itself answered wrongly: raise instead
                # of serving another rung's answer
                from ..integrity import IntegrityError
                raise IntegrityError(violations)
            self._integrity_quarantine(prep, backend)
            INTEGRITY.record_recovery(not still)
            if still:
                for vio in still:
                    INTEGRITY.record_violation(vio.check, vio.detail)
                logging.getLogger("karpenter_tpu_torch.integrity").error(
                    "fallback re-solve STILL fails the oracle (%s) — "
                    "encode-level defect, shipping the host result",
                    "; ".join(str(v) for v in still[:4]))
            else:
                self.stats["integrity_recoveries"] += 1
            sp.set(recovered_backend=fallback)
            return recovered, fallback

    def _integrity_quarantine(self, prep: PreparedSolve,
                              backend: str) -> None:
        """Contain a device-path integrity violation: drop every device
        buffer this facade could have consumed (its cached DeviceCatalogs
        and the shared content-token variants of the offending view) and
        suspend the device path for the standard
        cooldown — only THIS facade degrades; co-tenants' paths are
        untouched until their own checks say otherwise."""
        from ..metrics import SOLVER_FALLBACKS
        tok = prep.cat.cache_token if prep.cat is not None else None
        self._quarantine_device_state(tok)
        SOLVER_FALLBACKS.inc(from_backend=backend,
                             to_backend=self._fallback_backend(prep.cat))
        self.stats["device_fallbacks"] += 1

    def _quarantine_device_state(self, tok=None) -> None:
        """The backend-independent half of the quarantine: drop this
        facade's cached DeviceCatalogs (they may reference corrupted
        buffers), release the shared content-token variants of the
        offending view, and suspend the device path for the standard
        never-wrong-twice cooldown. (The reference also drops the
        facade's resident views and solve memos: ROADMAP §1 items 7
        and 6.)"""
        from ..metrics import DEGRADED_MODE
        if self._dcat_cache:
            from ..metrics import DCAT_EVICTIONS
            for _ in range(len(self._dcat_cache)):
                DCAT_EVICTIONS.inc(reason="integrity")
            self._dcat_cache.clear()
        if tok and tok[0] == "shared":
            from .solver import release_shared_views
            release_shared_views(tuple(tok[:2]))
        self._device_suspended = self.FALLBACK_COOLDOWN
        DEGRADED_MODE.set(1, component="solver")

    def _meter_encode_rows(self, enc_ctx) -> None:
        """Refresh the resident-rows gauge after ANY cached encode —
        warm-path admissions dominate steady state, so solve()-only
        updates would report hours-stale residency there."""
        if enc_ctx is not None:
            from ..metrics import ENCODE_CACHE_ROWS
            ENCODE_CACHE_ROWS.set(float(self._encode_cache.resident_rows))

    # (the reference's warm-path seam — warm_catalog, prepare_warm — sits
    # here: ROADMAP §1 item 9, warm path)

    @staticmethod
    def attach_existing_context(enc: EncodedPods,
                                existing: Optional[List[VirtualNode]],
                                existing_pods: Optional[Dict[str, List[Pod]]],
                                ) -> None:
        """Map each existing node's resident pods onto the CURRENT enc's
        group indices (prior_by_group — per-node caps hold across
        reconciles) and compute resident anti-affinity bans."""
        if not (existing and existing_pods):
            return
        sig_to_groups: Dict[tuple, List[int]] = {}
        for gi, grp in enumerate(enc.groups):
            sig_to_groups.setdefault(
                grp.representative.constraint_signature(), []).append(gi)
        for vn in existing:
            counts: Dict[int, int] = {}
            for p in existing_pods.get(vn.existing_name or "", []):
                for gi in sig_to_groups.get(p.constraint_signature(), []):
                    counts[gi] = counts.get(gi, 0) + 1
            vn.prior_by_group = counts
        Solver._apply_resident_bans(enc, existing, existing_pods)

    def _merge_plan(self, out: SolveOutput, plan: Optional[ColocationPlan],
                    cat: CatalogTensors, nodepool: NodePool) -> SolveOutput:
        """Fold the co-location planner's decisions into a SolveOutput:
        bundle nodes become NodeLaunches (cheapest surviving offering +
        price-sorted overrides, same launch contract as solver nodes)."""
        if plan is None:
            return out
        for b in plan.bundles:
            vn = VirtualNode(type_idx=b.type_idx, zone_mask=b.zone_mask,
                             cap_mask=b.cap_mask, cum=b.cum)
            masked = np.where(
                b.zone_mask[:, None] & b.cap_mask[None, :]
                & cat.available[b.type_idx],
                cat.price[b.type_idx], np.inf)
            zi, ci = np.unravel_index(np.argmin(masked), masked.shape)
            reqs = Resources()
            for p in b.pods:
                reqs = reqs.add(p.requests)
            out.launches.append(NodeLaunch(
                instance_type=cat.names[b.type_idx], zone=cat.zones[int(zi)],
                capacity_type=cat.captypes[int(ci)],
                price=float(masked[zi, ci]),
                overrides=self._overrides(cat, vn, b.group_compat,
                                          nodepool.requirements),
                pod_keys=[_pod_key(p) for p in b.pods], requests=reqs,
                labels=self._node_labels(cat, vn, nodepool)))
        for name, placed in plan.existing_placements.items():
            keys = out.existing_placements.setdefault(name, [])
            keys.extend(_pod_key(p) for p in placed)
        out.unschedulable.extend(_pod_key(p) for p in plan.unschedulable)
        return out

    @staticmethod
    def _spread_constraints(enc: EncodedPods, cat: CatalogTensors,
                            occupancy: List[Tuple[Optional[str], List[Pod]]],
                            ) -> Optional[Dict[int, List[SpreadConstraintCounts]]]:
        """Per-group zone-spread constraints seeded with cluster-wide domain
        occupancy. `occupancy` is (zone, pods) per live/in-flight node —
        ALL nodes, not just this pool's, since k8s counts matching pods
        wherever they run; a node whose zone is still deferred (None)
        contributes to no domain yet.

        Selector semantics follow TopologySpreadConstraint.label_selector:
        None spreads the group against itself only (zero prior counts
        unless its own labels are visible in `occupancy` — they are not,
        by definition of None matching no external pods); {} counts every
        pod in the namespace; non-empty counts label matches. Matching is
        memoized per (namespace, selector) — one pass over the cluster's
        pods regardless of how many groups share a selector."""
        if not enc.spread_zone.any():
            return None
        # bucket the cluster's pods by zone once
        pods_by_zone: List[Tuple[int, List[Pod]]] = []
        for zone, pods_on in occupancy:
            zi = cat.zones.index(zone) if zone in cat.zones else -1
            if zi >= 0 and pods_on:
                pods_by_zone.append((zi, pods_on))
        memo: Dict[tuple, np.ndarray] = {}

        def counts_for(namespace: str, selector: Optional[Dict[str, str]],
                       ) -> np.ndarray:
            if selector is None:
                return np.zeros(cat.Z, np.int64)
            key = (namespace, tuple(sorted(selector.items())))
            hit = memo.get(key)
            if hit is None:
                hit = np.zeros(cat.Z, np.int64)
                for zi, pods_on in pods_by_zone:
                    for p in pods_on:
                        if p.namespace == namespace and all(
                                p.labels.get(k) == v for k, v in selector.items()):
                            hit[zi] += 1
                memo[key] = hit
            return hit

        out: Dict[int, List[SpreadConstraintCounts]] = {}
        for i, grp in enumerate(enc.groups):
            if not enc.spread_zone[i]:
                continue
            rep = grp.representative
            cons = []
            for tsc in rep.topology_spread:
                if tsc.topology_key != L.ZONE:
                    continue
                # ScheduleAnyway constraints also seed domain counts — they
                # steer balancing; the split's soft path guarantees they
                # never block
                cons.append(SpreadConstraintCounts(
                    counts=counts_for(rep.namespace, tsc.label_selector),
                    max_skew=max(1, tsc.max_skew),
                    self_matches=(tsc.label_selector is None
                                  or tsc.matches(rep.labels)),
                    soft=tsc.when_unsatisfiable != "DoNotSchedule"))
            if cons:
                out[i] = cons
        return out or None

    @staticmethod
    def _relax_infeasible_preferences(enc: EncodedPods,
                                      cat: CatalogTensors) -> None:
        """Preferred node affinity must never block: after zone-affinity
        surgery, zone-split pinning, and NodePool-limit caps have further
        narrowed the problem, any group whose preference-narrowed
        (type, zone, captype) masks no longer reach an available, fitting
        offering falls back to its hard rows (the pre-preference masks, as
        rewritten by the hard affinity passes). k8s drops unsatisfiable
        preferences the same way — they only score, never filter."""
        if (enc.compat_hard is None and enc.zone_hard is None
                and enc.cap_hard is None):
            return
        alloc = align_resources(cat.allocatable, enc.requests.shape[1])
        for i in range(enc.G):
            ch = enc.compat[i] if enc.compat_hard is None else enc.compat_hard[i]
            zh = enc.allow_zone[i] if enc.zone_hard is None else enc.zone_hard[i]
            cch = enc.allow_cap[i] if enc.cap_hard is None else enc.cap_hard[i]
            if ((enc.compat[i] == ch).all()
                    and (enc.allow_zone[i] == zh).all()
                    and (enc.allow_cap[i] == cch).all()):
                continue
            fits = (alloc >= enc.requests[i][None, :] - 1e-6).all(axis=1)
            ok = (cat.available
                  & (enc.compat[i] & fits)[:, None, None]
                  & enc.allow_zone[i][None, :, None]
                  & enc.allow_cap[i][None, None, :]).any()
            if not ok:
                enc.compat[i] = ch
                enc.allow_zone[i] = zh
                enc.allow_cap[i] = cch

    @staticmethod
    def _apply_resident_bans(enc: EncodedPods,
                             existing: List[VirtualNode],
                             existing_pods: Dict[str, List[Pod]]) -> None:
        """Set VirtualNode.banned_groups from actual resident pods: node n
        may not take group g if a resident's required hostname anti-affinity
        selects g's labels, or g's own term selects a resident's labels —
        k8s enforces both directions. Residents that map to NO current
        group (prior_by_group can't see them) still repel this way."""
        hostname_anti = [
            [t for t in grp.representative.affinity_terms
             if t.anti and t.required and t.topology_key == L.HOSTNAME]
            for grp in enc.groups]
        any_group_anti = any(hostname_anti)
        for vn in existing:
            vn.banned_groups = None  # never carry stale bans across encodings
            residents = existing_pods.get(vn.existing_name or "", [])
            res_anti = [(p, [t for t in p.affinity_terms
                             if t.anti and t.required
                             and t.topology_key == L.HOSTNAME])
                        for p in residents]
            if not any_group_anti and not any(ts for _, ts in res_anti):
                continue
            banned = np.zeros(enc.G, bool)
            for gi, grp in enumerate(enc.groups):
                rep = grp.representative
                for p, p_terms in res_anti:
                    same_ns = p.namespace == rep.namespace
                    if any(term_selects(t, same_ns, p.labels)
                           for t in hostname_anti[gi]) or \
                       any(term_selects(t, same_ns, rep.labels)
                           for t in p_terms):
                        banned[gi] = True
                        break
            if banned.any():
                vn.banned_groups = banned

    @staticmethod
    def _pin_bundle_zone(b: BundleNode, cat: CatalogTensors) -> int:
        """Narrow a bundle's deferred zone mask to its cheapest available
        zone; returns the zone index."""
        masked = np.where(
            b.zone_mask[:, None] & b.cap_mask[None, :]
            & cat.available[b.type_idx],
            cat.price[b.type_idx], np.inf)
        if np.isinf(masked).all():  # offerings vanished mid-solve: keep mask
            return int(np.flatnonzero(b.zone_mask)[0])
        zi = int(np.unravel_index(np.argmin(masked), masked.shape)[0])
        pin = np.zeros(cat.Z, bool)
        pin[zi] = True
        b.zone_mask = pin
        return zi

    @staticmethod
    def _zone_of(name: str, existing: Optional[List[VirtualNode]],
                 cat: CatalogTensors) -> Optional[str]:
        for vn in existing or []:
            if vn.existing_name == name:
                zs = np.flatnonzero(vn.zone_mask)
                return cat.zones[int(zs[0])] if len(zs) == 1 else None
        return None

    @staticmethod
    def _occupancy_from_existing(existing: Optional[List[VirtualNode]],
                                 existing_pods: Optional[Dict[str, List[Pod]]],
                                 cat: CatalogTensors,
                                 ) -> List[Tuple[Optional[str], List[Pod]]]:
        """Fallback occupancy when the caller didn't supply a cluster-wide
        view: derive (zone, pods) from the solve's own existing nodes."""
        out: List[Tuple[Optional[str], List[Pod]]] = []
        for vn in existing or []:
            zs = np.flatnonzero(vn.zone_mask)
            zone = cat.zones[int(zs[0])] if len(zs) == 1 else None
            out.append((zone, (existing_pods or {}).get(vn.existing_name or "", [])))
        return out

    # --- result mapping ---
    def _decode(self, cat: CatalogTensors, enc: EncodedPods,
                result: SolveResult, nodepool: NodePool,
                dropped: List[str]) -> SolveOutput:
        # Per-group pod cursors for deterministic nomination. Keyed by the
        # PodGroup object, not the row index: split_spread_groups emits
        # multiple rows referencing ONE PodGroup, and those rows must draw
        # disjoint pod slices from its list.
        cursors: Dict[int, int] = {}

        def take_pods(g: int, cnt: int) -> List[Pod]:
            grp = enc.groups[g]
            k = id(grp)
            at = cursors.get(k, 0)
            cursors[k] = at + cnt
            return grp.pods[at: at + cnt]
        launches: List[NodeLaunch] = []
        existing_placements: Dict[str, List[str]] = {}
        li = 0
        for node in result.nodes:
            keys = []
            reqs = Resources()
            for g, cnt in sorted(node.pods_by_group.items()):
                take = take_pods(g, cnt)
                keys.extend(_pod_key(p) for p in take)
                for p in take:
                    reqs = reqs.add(p.requests)
            if node.existing_name is not None:
                if keys:
                    existing_placements[node.existing_name] = keys
                continue
            t, zi, ci, price = result.launches[li]
            li += 1
            it_name = cat.names[node.type_idx]
            labels = self._node_labels(cat, node, nodepool)
            # alternates must satisfy every pod on the node, not just fit its
            # resource sum — AND the groups' compat masks
            group_compat = np.ones(cat.T, bool)
            for g in node.pods_by_group:
                group_compat &= enc.compat[g]
            launches.append(NodeLaunch(
                instance_type=it_name, zone=cat.zones[zi],
                capacity_type=cat.captypes[ci], price=price,
                overrides=self._overrides(cat, node, group_compat,
                                          nodepool.requirements),
                pod_keys=keys, requests=reqs, labels=labels))
        unschedulable = list(dropped)
        for g, cnt in result.unschedulable.items():
            unschedulable.extend(_pod_key(p) for p in take_pods(g, cnt))
        return SolveOutput(launches=launches,
                           existing_placements=existing_placements,
                           unschedulable=unschedulable)

    def _overrides(self, cat: CatalogTensors, node: VirtualNode,
                   group_compat: np.ndarray,
                   requirements: Optional[Requirements] = None,
                   ) -> List[Tuple[str, str, str, float]]:
        """Price-sorted alternate offerings for this node's pod set: any
        type compatible with every pod on the node that holds node.cum, and
        any surviving (zone, captype). Gives the launch path ICE resilience
        without a re-solve.

        requirements: the NodePool requirements; keys carrying minValues
        turn the 60-row cap into constrained selection (reference
        InstanceTypes.Truncate at instance.go:293) — the kept rows must
        span >= minValues distinct values per key, so a launch keeps its
        flexibility floor (e.g. the >=15-type spot-to-spot gate). Selection
        is best-effort: when the floor is unreachable within the cap, the
        plain cheapest rows ship rather than failing the launch."""
        alloc = align_resources(cat.allocatable, len(node.cum))
        fits = (alloc >= node.cum[None, :] - 1e-4).all(axis=1)  # [T]
        ok = fits & group_compat
        mask = (cat.available & ok[:, None, None]
                & node.zone_mask[None, :, None] & node.cap_mask[None, None, :])
        t_idx, z_idx, c_idx = np.nonzero(mask)
        prices = cat.price[t_idx, z_idx, c_idx]
        by_price = np.argsort(prices, kind="stable")
        order = self._floor_rows(cat, t_idx, z_idx, c_idx, by_price,
                                 min_values_floors(requirements))
        primary = node.type_idx
        rows = [(cat.names[t_idx[j]], cat.zones[z_idx[j]],
                 cat.captypes[c_idx[j]], float(prices[j])) for j in order]
        # ONE row of the committed type — its cheapest — leads (the
        # solver's pick); every alternate stays in global price order.
        # The cloud walks the list in order, so leading with ALL of the
        # committed type's rows would make an ICE fallback pay for a
        # pricier sibling of the committed type while a cheaper viable
        # row of another type sits further down.
        rows.sort(key=lambda r: r[3])
        for j, r in enumerate(rows):
            if r[0] == cat.names[primary]:
                rows.insert(0, rows.pop(j))
                break
        return rows[:MAX_OVERRIDES]

    @staticmethod
    def _apply_min_values_caps(enc: EncodedPods, cat: CatalogTensors,
                               requirements: Requirements) -> None:
        """minValues as a NODE-OPENING constraint (the reference scheduler
        keeps each virtual node's remaining compatible-type set above every
        minValues floor, opening a new node rather than shrinking below it):
        cap each group's pods-per-node so a node's load still fits the
        N-th-best compatible VALUE of each minValues key — then >= N
        distinct values survive into the launch overrides. Exact for
        single-group nodes (the dominant dense case); mixed-group nodes can
        combine loads that narrow further, where the override floor stays
        best-effort."""
        mv = min_values_floors(requirements)
        if not mv:
            return
        from .binpack import BIG, EPS
        alloc = align_resources(cat.allocatable, enc.requests.shape[1])
        for i in range(enc.G):
            req = enc.requests[i].astype(np.float32)
            with_req = np.where(req > 0, req, np.float32(1.0))
            slots = np.where(req[None, :] > 0,
                             np.floor(alloc / with_req[None, :] + EPS),
                             np.float32(BIG)).min(axis=1)       # [T]
            slots = np.where(enc.compat[i], np.maximum(slots, 0.0), 0.0)
            cap = BIG
            for key, need in mv:
                if key == L.INSTANCE_TYPE:
                    per_value = slots[slots > 0]
                elif key in cat.label_keys:
                    ids = cat.label_val[:, cat.label_keys.index(key)]
                    vals = np.unique(ids[(ids >= 0) & (slots > 0)])
                    per_value = np.array(
                        [slots[ids == v].max() for v in vals])
                else:
                    # offering-axis floors (zone/capacity-type) don't bound
                    # node SIZE — _floor_rows spans them in the override
                    # list instead
                    continue
                if len(per_value) < need:
                    continue  # floor unreachable: solver proceeds, launch
                    # ships best-effort rows (reference errors the create)
                nth = np.sort(per_value)[-need]  # N-th largest value's slots
                cap = min(cap, int(nth))
            if cap < BIG and cap >= 1:
                cur = int(enc.max_per_node[i])
                enc.max_per_node[i] = cap if cur == 0 else min(cur, cap)

    @staticmethod
    def _floor_rows(cat: CatalogTensors, t_idx, z_idx, c_idx, by_price,
                    mv: List[Tuple[str, int]]) -> np.ndarray:
        """Override-row order honoring every minValues floor within the
        60-row cap: reserve the cheapest row contributing each still-
        missing distinct value per key — INSTANCE_TYPE = the row's type,
        zone / capacity-type = the row's OFFERING axis (offering-axis
        floors are real: minValues=3 on zone must ship rows spanning 3
        zones), other keys = the row's type label — then fill the rest
        cheapest-first. A floor the candidate rows cannot span falls back
        to plain price order (best-effort; the reference errors the
        create)."""
        if not mv or len(by_price) == 0:
            return by_price[:MAX_OVERRIDES]

        def value_of(j: int, key: str):
            t = int(t_idx[j])
            if key == L.INSTANCE_TYPE:
                return cat.names[t]
            if key == L.ZONE:
                return int(z_idx[j])
            if key == L.CAPACITY_TYPE:
                return int(c_idx[j])
            if key in cat.label_keys:
                v = int(cat.label_val[t, cat.label_keys.index(key)])
                return v if v >= 0 else None
            return None

        selected: List[int] = []
        chosen = set()
        for key, need in mv:
            start = len(selected)
            have = {value_of(j, key) for j in selected} - {None}
            for j in by_price:
                if len(have) >= need:
                    break
                j = int(j)
                if j in chosen:
                    continue
                v = value_of(j, key)
                if v is not None and v not in have:
                    selected.append(j)
                    chosen.add(j)
                    have.add(v)
            if len(have) < need or len(selected) > MAX_OVERRIDES:
                # THIS floor is unreachable: drop only its reservations —
                # floors other keys already secured must still ship
                chosen.difference_update(selected[start:])
                del selected[start:]
        for j in by_price:
            if len(selected) >= MAX_OVERRIDES:
                break
            if int(j) not in chosen:
                selected.append(int(j))
        return np.array(selected, dtype=int)

    def _node_labels(self, cat: CatalogTensors, node: VirtualNode,
                     nodepool: NodePool) -> Dict[str, str]:
        labels = nodepool.template_labels()
        labels[L.INSTANCE_TYPE] = cat.names[node.type_idx]
        return labels


def virtual_node_from_claim(claim: NodeClaim, cat: CatalogTensors,
                            used: Resources) -> Optional[VirtualNode]:
    """Reconstruct an in-flight NodeClaim as solver input so repeated
    reconciles keep filling it instead of over-provisioning (the reference
    scheduler simulates against in-flight nodes the same way)."""
    idx = cat.name_to_idx.get(claim.instance_type or "")
    if idx is None:
        return None
    zone_mask = np.array([z == claim.zone for z in cat.zones], bool) \
        if claim.zone else np.ones(cat.Z, bool)
    cap_mask = np.array([c == claim.capacity_type for c in cat.captypes], bool) \
        if claim.capacity_type else np.ones(cat.C, bool)
    vec = used.to_vector()
    cum = np.zeros(len(cat.resources), np.float32)
    cum[: len(vec)] = vec[: len(cum)]
    return VirtualNode(type_idx=idx, zone_mask=zone_mask, cap_mask=cap_mask,
                       cum=cum, existing_name=claim.name)
