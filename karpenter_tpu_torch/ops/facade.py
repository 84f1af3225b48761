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
dispatch (`ops/solver.dispatch_batch`). The delta plane's serve-and-verify
memos (solve, affinity, spread: `ops/delta`) and the device-resident
request and catalog tensors with their digest audit (`ops/resident`) are
armed by default, as in the reference, and so is the explain recorder
(`obs/explain.RECORDER`, fed from `finish_solve`). The warm path's seam
(`warm_catalog`, `prepare_warm`, `warm_integrity_tick`) is the
reference's. None of these changes an answer.

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
from .solver import resolve_device

_MESH_UNSET = object()  # Solver.mesh() not built yet

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
    # delta-plane bookkeeping (ops/delta.py): the solve-memo key/fp
    # this prepared solve settles in finish_solve — store on a miss,
    # confirm/diverge on an audit-due recompute. delta_served marks a
    # result already answered FROM the memo (finish must not re-store).
    delta_key: Optional[tuple] = None
    delta_fp: int = 0
    delta_audit: bool = False
    delta_check: int = 0
    delta_served: bool = False


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
        without `device` raises, as solve_device does. A "mesh" facade
        shards its solves over `mesh()` and raises when fewer than two
        devices exist (a mesh request never runs on one device in
        silence); its `device` defaults to the mesh's first shard's."""
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
        self.backend = backend
        self._mesh_obj = _MESH_UNSET
        if backend == "mesh":
            if self.mesh() is None:
                from ..parallel.mesh import device_count
                raise RuntimeError(
                    f"backend='mesh' needs more than one device and "
                    f"{device_count()} exist; set_virtual_devices(n, device) "
                    f"asks for virtual shards of one device")
            self.device = (resolve_device(device) if device is not None
                           else self.mesh().devices[0])
        else:
            self.device = (resolve_device(device)
                           if backend in ("device", "hybrid")
                           or device is not None else None)
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
        # solution-integrity plane (integrity/): the canary sampler and
        # the resident-audit cadence counter are per facade, so
        # quarantine only ever degrades the affected tenant's path
        self._canary = None
        self._integrity_solves = 0
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

    def mesh(self):
        """The mesh this solver shards over, or None on one device. Built
        lazily on first use: a "nodes" mesh over every device
        `parallel.mesh.device_count()` reports (the CUDA cards, or the
        virtual shards a caller asked for), when there is more than
        one."""
        if self._mesh_obj is _MESH_UNSET:
            from ..parallel.mesh import device_count, make_mesh
            self._mesh_obj = make_mesh() if device_count() > 1 else None
        return self._mesh_obj

    def _auto_mesh(self):
        """The mesh "hybrid" routes to on its own: mesh() when its shards
        are the virtual ones a caller asked for. A mesh over distinct cards
        is taken only on request (backend="mesh", an explicit mesh=) until
        a machine with more than one card has run it (ROADMAP §3); there
        hybrid stays on one device."""
        m = self.mesh()
        return m if m is not None and m.virtual else None

    # screen sharding threshold in CANDIDATE NODES — deliberately separate
    # from device_min_pods (a pod-count calibration for solve routing):
    # the [N, G] screen's cost model is per-node rows, and tuning one
    # knob must not silently retune the other
    SCREEN_MESH_MIN_NODES = 1024

    def screen_mesh(self, n_nodes: int):
        """Mesh for the consolidation screen's node axis, or None when the
        single-device path is the right call (small clusters, no mesh)."""
        if self.backend == "mesh":
            return self.mesh()
        if (self.backend == "hybrid"
                and n_nodes >= self.SCREEN_MESH_MIN_NODES):
            return self._auto_mesh()
        return None

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
        if backend in ("device", "mesh") and self._device_suspended > 0:
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
            # virtual shards asked for: shard the node axis over them; the
            # same facade call the provisioner makes reaches every shard
            return "mesh" if self._auto_mesh() is not None else "device"
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
        # device-resident staleness feed (ops/resident.py): record the
        # newest catalog token this facade resolved for the view, so an
        # idle resident buffer whose epoch the world moved past is
        # visible to the watchdog's resident_staleness invariant. Both
        # the cold path (prepare_solve) and the warm path (prepare_warm
        # via warm_catalog) land here.
        # Facade-prefixed entries ONLY: one facade has exactly one
        # current token per nodeclass, so base and entry granularity
        # agree. The process-shared ("dcat", "shared", ...) entries are
        # deliberately NOT observed — during a persistent view split
        # two live fingerprints of one nodeclass legitimately alternate
        # through one resident key, and a single last-observer base
        # would flag that healthy state stale forever (their lifecycle
        # is governed by release_shared_views/invalidate_token instead).
        tok = hit.cache_token
        if tok:
            from .resident import RESIDENT
            RESIDENT.observe_view(("facade", id(self), key[0]), tuple(tok))
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
        from ..obs.recompute import RECOMPUTE, encoded_fingerprint, fingerprint
        occ_sig = tuple(sorted((zone, len(placed))
                               for zone, placed in occupancy))
        sp = (TRACER.span("solve.spread") if TRACER.enabled else NOOP_SPAN)
        with sp:
            asp = (TRACER.span("encode.affinity") if TRACER.enabled
                   else NOOP_SPAN)
            with asp:
                enc = self._delta_affinity(enc, cat, occupancy, occ_sig,
                                           nodepool.name)
            enc = self._delta_spread(enc, cat, occupancy, occ_sig,
                                     nodepool.name)
            sp.set(groups=int(enc.G))
        post_fp = encoded_fingerprint(enc)
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
        # delta plane: an unchanged-input solve serves the memoized
        # result (still oracle-verified in finish_solve) instead of
        # dispatching; miss/audit marks the prep so finish_solve
        # settles the memo protocol
        from .delta import existing_context_fingerprint
        ex_fp = existing_context_fingerprint(existing)
        served = self._delta_serve_solve(prep, post_fp, ex_fp)
        if served is not None:
            return served
        # the FULL solve input identity a dispatch is about to grind —
        # encoded content AND the standing-fleet context (two what-ifs
        # over the same pods against different hypothetical clusters
        # are different solves, not redundancy): an unchanged
        # fingerprint re-solved from scratch is the redundant work the
        # delta memo should have served
        RECOMPUTE.classify("solve", fingerprint(
            post_fp, self._last_cat_key, backend, int(enc.counts.sum()),
            ex_fp))
        return prep

    def _device_dcat(self, prep: PreparedSolve, mesh=None):
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
            return _auto_dcat(cat, R, self.device, mesh=mesh)
        # keyed on (nodeclass hash, catalog epoch, R, placement, block
        # gating) — NOT id(cat): a freed CatalogTensors' address can be
        # reused by its successor
        dkey = prep.cat_key + (R, mesh is not None, prep.blocks_gated,
                               prep.ds_fp)
        dcat = self._dcat_cache.get(dkey)
        if dcat is None:
            # device residency follows the host LRU: every variant
            # (block-gating states, mesh vs single) of any CACHED
            # catalog view may stay — mixed pools and alternating
            # NodeClasses must not thrash a full host→device transfer
            # per solve
            n = len(prep.cat_key)
            from ..metrics import DCAT_EVICTIONS
            for k in [k for k in self._dcat_cache
                      if k[:n] not in self._cat_cache]:
                del self._dcat_cache[k]
                DCAT_EVICTIONS.inc(reason="facade_lru")
            rk = None if mesh is not None else self._resident_key(prep)
            dcat = device_catalog(
                cat, R, self.device,
                resident_key=rk + ("dcat",) if rk is not None else None,
                mesh=mesh)
            self._dcat_cache[dkey] = dcat
        return dcat

    def _resident_key(self, prep: PreparedSolve) -> Optional[tuple]:
        """Key prefix for this facade's device-resident state (one per
        (nodeclass, block-gating, daemonset-view) — the catalog EPOCH is
        deliberately absent: an epoch bump is exactly the moment a delta
        patch beats a full re-upload, and the entry's stored cache_token
        forces the conservative full path when content lineage breaks."""
        if not prep.cat_key:
            return None
        return ("facade", id(self), prep.cat_key[0], prep.blocks_gated,
                prep.ds_fp)

    def invalidate_resident(self, reason: str = "invalidated") -> int:
        """Drop every device-resident view this facade seeded — called
        by the warm-path engine when its auditor diverges (the
        incremental pipeline disagreed with a cold solve, so no
        incremental device state may be trusted either) and available to
        chaos/restart machinery. Returns the entries dropped."""
        from .resident import RESIDENT
        return RESIDENT.invalidate(("facade", id(self)), reason=reason)

    # --- delta plane (ops/delta.py): serve-and-verify memos ----------------
    # The four prepare-time stages the c16 regime measured as >84%
    # redundant serve their prior outputs when the input fingerprints
    # are unchanged. Every shortcut is policed: served solves still run
    # the integrity oracle (finish_solve), and the plane's audit
    # cadence forces a fresh recompute with a confirm/diverge verdict
    # (divergence invalidates + opens the never-wrong-twice cooldown).

    def _delta_solve_key(self, prep: PreparedSolve, ex_fp: int) -> tuple:
        # the existing-context fingerprint is part of the KEY, not the
        # validation fingerprint: one reconcile runs many concurrent
        # solves against DIFFERENT hypothetical cluster contexts (the
        # disruption controller's what-ifs), and a single key would make
        # them evict each other every pass. Distinct contexts memoize
        # side by side; pod-content drift within one context re-stores
        # under a new fp (the metered epoch)
        return ("facade", id(self),
                prep.cat_key[0] if prep.cat_key else None,
                prep.nodepool.name if prep.nodepool is not None else None,
                prep.blocks_gated, prep.ds_fp, ex_fp)

    def _delta_serve_solve(self, prep: PreparedSolve, post_fp: int,
                           ex_fp: int) -> Optional[PreparedSolve]:
        """Solve-memo serve half. None = not served (miss, audit due,
        ineligible) — the caller dispatches normally and finish_solve
        settles the memo via the prep's delta_* fields. A clean hit
        decodes the memoized SolveResult against the CURRENT prep
        (fresh pod identities) through the full finish_solve pipeline —
        the integrity oracle validates every served result."""
        from .delta import (DELTA, copy_solve_result,
                            solve_memo_fingerprint,
                            solve_result_fingerprint)
        # colocation plans thread planner state through finish_solve
        # the memo cannot key — they always recompute. Existing-node
        # solves (full reconciles, disruption what-ifs — the bulk of
        # the c16 headroom) ARE served: attach_existing_context ran
        # before this point, so the prepared VirtualNodes carry the
        # full solver-visible standing-fleet state and the context
        # fingerprint below folds it into the memo key
        if (not DELTA.armed or prep.plan is not None
                or self.profile_dir):
            return None
        key = self._delta_solve_key(prep, ex_fp)
        fp = solve_memo_fingerprint(prep.enc, prep.cat_key, prep.backend,
                                    prep.blocks_gated, prep.ds_fp)
        hit = DELTA.serve("solve", key, fp)
        if hit is None:
            prep.delta_key, prep.delta_fp = key, fp
            return None
        (result, backend), audit_due = hit
        if audit_due:
            prep.delta_key, prep.delta_fp = key, fp
            prep.delta_audit = True
            prep.delta_check = solve_result_fingerprint(result)
            return None
        from ..obs.recompute import RECOMPUTE
        RECOMPUTE.classify("solve", served=True)
        prep.delta_served = True
        out = self.finish_solve(prep, copy_solve_result(result), backend)
        return PreparedSolve(output=out)

    def _delta_record_solve(self, prep: PreparedSolve,
                            result: SolveResult, backend: str) -> None:
        """Settle the solve memo for a freshly computed (and already
        integrity-verified) result: store on a miss, confirm/diverge on
        an audit-due recompute."""
        if prep.delta_key is None or prep.delta_served:
            return
        from .delta import (DELTA, copy_solve_result,
                            solve_result_fingerprint)
        check = solve_result_fingerprint(result)
        if prep.delta_audit:
            if check == prep.delta_check:
                DELTA.confirm("solve", prep.delta_key, prep.delta_fp,
                              value=(copy_solve_result(result), backend),
                              check_fp=check)
            else:
                DELTA.diverge("solve", prep.delta_key)
            return
        DELTA.store("solve", prep.delta_key, prep.delta_fp,
                    (copy_solve_result(result), backend), check_fp=check)

    def _delta_affinity(self, enc: EncodedPods, cat: CatalogTensors,
                        occupancy, occ_sig: tuple,
                        pool: str) -> EncodedPods:
        """Zone-affinity pre-pass through the delta memo: an unchanged
        (enc content, occupancy signature, zones) pass REPLAYS the
        memoized transformation descriptor against the CURRENT enc —
        pod identities stay fresh while the O(occupancy) selector
        matching and cluster/union-find work is served."""
        from ..obs.recompute import (RECOMPUTE, encoded_fingerprint,
                                     fingerprint)
        from .affinity import descriptor_fingerprint, replay_zone_affinity
        from .delta import DELTA, group_terms_fingerprint
        led_fp = fingerprint(encoded_fingerprint(enc), occ_sig)
        if not DELTA.armed:
            RECOMPUTE.classify("affinity", led_fp)
            return apply_zone_affinity(enc, cat, occupancy)
        # the occupancy signature is zone+count only — the group-terms
        # digest carries the selector semantics, and the audit cadence
        # polices what neither catches. The content fingerprint is part
        # of the KEY: one reconcile's what-if solves run this pass over
        # many (enc, occupancy) variants, and a per-(facade, pool)
        # entry would thrash instead of serving the repeats
        mfp = fingerprint(led_fp, tuple(cat.zones))
        key = ("facade", id(self), pool, group_terms_fingerprint(enc),
               mfp)
        hit = DELTA.serve("affinity", key, mfp)
        if hit is not None and not hit[1]:
            out = replay_zone_affinity(enc, cat, hit[0])
            if out is not None:
                RECOMPUTE.classify("affinity", served=True)
                return out
            # the descriptor no longer fits the enc it was keyed to —
            # a memo-key defect: treat exactly like an audit divergence
            DELTA.diverge("affinity", key)
            hit = None
        capture: dict = {}
        out = apply_zone_affinity(enc, cat, occupancy, capture=capture)
        RECOMPUTE.classify("affinity", led_fp)
        cfp = descriptor_fingerprint(capture)
        if hit is not None:  # audit-due: judge the stored descriptor
            if cfp == descriptor_fingerprint(hit[0]):
                DELTA.confirm("affinity", key, mfp, value=capture,
                              check_fp=cfp)
            else:
                DELTA.diverge("affinity", key)
        else:
            DELTA.store("affinity", key, mfp, capture, check_fp=cfp)
        return out

    def _delta_spread(self, enc: EncodedPods, cat: CatalogTensors,
                      occupancy, occ_sig: tuple, pool: str) -> EncodedPods:
        """Topology-spread pass through the delta memo: the memo serves
        the O(cluster pods) selector-counting half (_spread_constraints);
        the cheap structural split always runs against the current enc."""
        from ..obs.recompute import (RECOMPUTE, encoded_fingerprint,
                                     fingerprint)
        from .delta import (DELTA, copy_spread_constraints,
                            group_terms_fingerprint,
                            spread_constraints_fingerprint)

        def _classify_fresh(out_enc):
            RECOMPUTE.classify("spread", fingerprint(
                encoded_fingerprint(out_enc), occ_sig, "spread"))

        if not (DELTA.armed and enc.G and bool(enc.spread_zone.any())):
            out = split_spread_groups(
                enc, cat, self._spread_constraints(enc, cat, occupancy))
            _classify_fresh(out)
            return out
        mfp = fingerprint(encoded_fingerprint(enc), occ_sig,
                          tuple(cat.zones), "spread")
        # content fp in the KEY, same rationale as _delta_affinity:
        # concurrent what-if variants must memoize side by side
        key = ("facade", id(self), pool, group_terms_fingerprint(enc),
               mfp)
        hit = DELTA.serve("spread", key, mfp)
        if hit is not None and not hit[1]:
            out = split_spread_groups(
                enc, cat, copy_spread_constraints(hit[0]))
            RECOMPUTE.classify("spread", served=True)
            return out
        cons = self._spread_constraints(enc, cat, occupancy)
        cfp = spread_constraints_fingerprint(cons)
        if hit is not None:  # audit-due
            if cfp == spread_constraints_fingerprint(hit[0]):
                DELTA.confirm("spread", key, mfp,
                              value=copy_spread_constraints(cons),
                              check_fp=cfp)
            else:
                DELTA.diverge("spread", key)
        else:
            DELTA.store("spread", key, mfp,
                        copy_spread_constraints(cons), check_fp=cfp)
        out = split_spread_groups(enc, cat, cons)
        _classify_fresh(out)
        return out

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
                    mesh = self.mesh() if backend == "mesh" else None
                    dcat = self._device_dcat(prep, mesh)
                    result = solve_device(
                        cat, enc, existing, dcat=dcat, device=self.device,
                        mesh=mesh,
                        resident_key=(None if mesh is not None
                                      else self._resident_key(prep)))
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
        # delta plane: memoize (or audit-settle) the verified result —
        # an unchanged-input reconcile serves it without a dispatch
        self._delta_record_solve(prep, result, backend)

        with _span("solve.output"):  # decode to launches, merge the plan
            out = self._decode(cat, enc, result, prep.nodepool, prep.dropped)
            out = self._merge_plan(out, prep.plan, cat, prep.nodepool)
        # decision provenance: per-pod placement records + the constraint
        # elimination funnel, bounded and read-only (obs/explain.py) —
        # solves above the recorder's pod cap are skipped, and the
        # colocation-only early return in prepare_solve is not recorded
        # (bundle placement is the planner's, not the funnel's)
        from ..obs.explain import RECORDER
        if RECORDER.enabled:
            RECORDER.record_solve(cat, enc, out)
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
        """Feasibility oracle + canary + resident audit for one solve.
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
        from ..integrity import (CanarySampler, INTEGRITY, audit_every,
                                 verify_result)
        sp = (TRACER.span("integrity.verify", backend=backend)
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            violations = verify_result(prep.cat, prep.enc, result)
            device_backed = backend in ("device", "mesh")
            if not violations and device_backed and not prep.existing:
                if self._canary is None:
                    self._canary = CanarySampler()
                if self._canary.due():
                    violations = self._canary.check(prep.cat, prep.enc,
                                                    result)
            # resident-state digest audit, on a deterministic per-facade
            # cadence: corruption found there taints THIS solve too (its
            # inputs came off those buffers), so it recovers like an
            # oracle violation
            self._integrity_solves += 1
            every = audit_every()
            audit_violations = []
            if (device_backed and every > 0
                    and self._integrity_solves % every == 0):
                audit_violations = self._audit_resident_state()
            if not violations and not audit_violations:
                INTEGRITY.record_ok()
                sp.set(outcome="ok")
                return result, backend
            # breach accounting: the violating SOLVE is one context,
            # and each corrupt resident ENTRY is its own — a single
            # audit pass catching two rotted buffers must count as two
            # detections against two injected corruptions
            if violations:
                INTEGRITY.record_breach_event()
            for _ in audit_violations:
                INTEGRITY.record_breach_event()
            violations += audit_violations
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
            # forensic audit BEFORE the quarantine wipes the evidence:
            # a violating device solve may have consumed MORE rotted
            # buffers than the one that tripped the oracle (or than the
            # bounded cadence slice covered), and each corrupt entry is
            # its own breach context. The manager drops corrupt entries
            # on detection, so the sweep only ever reports NEW rot
            for vio in self._audit_resident_state(full=True):
                INTEGRITY.record_breach_event()
                INTEGRITY.record_violation(vio.check, vio.detail)
                self.stats["integrity_violations"] += 1
                violations.append(vio)
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

    def _audit_resident_state(self, full: bool = False):
        """Digest-audit this facade's device-resident views (and the
        shared catalog entries it may be consuming). Corrupt entries are
        dropped by the manager; the caller treats any finding as a
        violation of the in-flight solve. `full` lifts the per-pass row
        bound — the forensic sweep a violating solve triggers must cover
        every entry, not a round-robin slice."""
        from ..integrity import AUDIT_ROWS, INTEGRITY, Violation
        from .resident import RESIDENT
        if not RESIDENT.armed:
            return []
        rows = None if full else AUDIT_ROWS
        rep = RESIDENT.audit(("facade", id(self)), max_rows=rows)
        shared = RESIDENT.audit(("dcat",), max_rows=rows)
        corrupt = list(rep["corrupt"]) + list(shared["corrupt"])
        INTEGRITY.record_audit(rep["rows"] + shared["rows"], len(corrupt))
        return [Violation("resident_audit",
                          f"resident row digests diverged on "
                          f"{'/'.join(str(t) for t in key)}")
                for key in corrupt]

    def _integrity_quarantine(self, prep: PreparedSolve,
                              backend: str) -> None:
        """Contain a device-path integrity violation: drop every device
        buffer this facade could have consumed (its resident views, its
        cached DeviceCatalogs, and the shared content-token variants of
        the offending view) and
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
        facade's resident views and cached DeviceCatalogs (both may
        reference corrupted buffers), release the shared content-token
        variants of the offending view, and suspend the device path for
        the standard never-wrong-twice cooldown."""
        from ..metrics import DEGRADED_MODE
        from .delta import DELTA
        from .resident import RESIDENT
        RESIDENT.invalidate(("facade", id(self)), reason="corruption")
        # memoized solve results may have been decoded from the same
        # corrupted device state — they die with it (host-side
        # affinity/spread memos are untouched: nothing device-backed
        # feeds them)
        DELTA.invalidate(("solve", "facade", id(self)),
                         reason="quarantine")
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

    def warm_integrity_tick(self) -> int:
        """Advance the per-facade audit cadence by one verified commit.
        Cold solves tick inside _verify_integrity; warm admissions tick
        here — without this, a fleet whose arrivals the warm path fully
        absorbs would audit its device-resident state exactly once per
        catalog epoch, and resident rot could sit undetected until the
        next cold solve consumed it. Findings quarantine this facade's
        device path (the rotted entries are already invalidated by the
        audit itself) and return the corrupt-entry count; the warm
        result being judged is host-computed and stays shipped."""
        from ..integrity import INTEGRITY, audit_every, integrity_enabled
        if not integrity_enabled():
            return 0
        self._integrity_solves += 1
        every = audit_every()
        if every <= 0 or self._integrity_solves % every:
            return 0
        violations = self._audit_resident_state()
        if not violations:
            return 0
        self.stats["integrity_violations"] += len(violations)
        for vio in violations:
            INTEGRITY.record_breach_event()
            INTEGRITY.record_violation(vio.check, vio.detail)
        import logging
        logging.getLogger("karpenter_tpu_torch.integrity").warning(
            "resident-state audit found %d corrupt device entr%s during "
            "a warm window — quarantining this facade's device path",
            len(violations), "y" if len(violations) == 1 else "ies")
        self._quarantine_device_state()
        # the corruption never reached a shipped answer (the audit got
        # there first) — that IS the recovery
        INTEGRITY.record_recovery(True)
        return len(violations)

    def _meter_encode_rows(self, enc_ctx) -> None:
        """Refresh the resident-rows gauge after ANY cached encode —
        warm-path admissions dominate steady state, so solve()-only
        updates would report hours-stale residency there."""
        if enc_ctx is not None:
            from ..metrics import ENCODE_CACHE_ROWS
            ENCODE_CACHE_ROWS.set(float(self._encode_cache.resident_rows))

    # --- warm-path seam ---------------------------------------------------
    # The warm-path subsystem (warmpath/) admits arrival-only reconciles
    # against a standing headroom ledger instead of paying a full solve.
    # These two methods are the facade's contract with it: the ledger
    # snapshots warm_catalog() at commit time, and each warm batch is
    # encoded by prepare_warm() — the exact encode pipeline solve() runs
    # for the plain (no colocation, no capacity-cap) case, in the same
    # order. The Auditor replays accumulated warm admissions through
    # solve() itself (on the device rung: kernels B0 and B), so any drift
    # between this pipeline and solve()'s surfaces as metered divergence,
    # not silent misplacement.

    def warm_catalog(self, nodepool: NodePool,
                     node_class: Optional[NodeClassSpec],
                     daemonsets: Optional[list] = None) -> CatalogTensors:
        """The availability/headroom view solve() would compute for this
        (pool, class): capacity-block gate applied unless the pool targets
        reserved capacity, then daemonset overhead baked into allocatable
        (zone-varying part on zone_overhead)."""
        cat = self.tensors(node_class)
        if (cat.is_block is not None and cat.is_block.any()
                and not targets_reserved(nodepool.requirements)):
            from dataclasses import replace as _dc_replace
            # same token suffix as solve()'s gate — warm and cold paths
            # share one encode context per (pool, class) view
            cat = _dc_replace(cat, available=cat.available & ~cat.is_block,
                              cache_token=(cat.cache_token + ("noblocks",)
                                           if cat.cache_token is not None
                                           else None))
        if daemonsets:
            cat = apply_daemonset_overhead(cat, daemonsets, nodepool,
                                           nodepool.template_labels())
        return cat

    def prepare_warm(self, pregrouped: List[List[Pod]], nodepool: NodePool,
                     cat: CatalogTensors,
                     occupancy: List[Tuple[Optional[str], List[Pod]]],
                     existing: Optional[List[VirtualNode]] = None,
                     existing_pods: Optional[Dict[str, List[Pod]]] = None,
                     ) -> EncodedPods:
        """Encode an arrival batch exactly the way solve() would: group →
        minValues caps → zone-affinity pre-pass → topology-spread split →
        infeasible-preference relaxation → resident priors/bans. `cat`
        must be this pool's warm_catalog(). Taint-dropped pods surface on
        EncodedPods.dropped_keys (they fall through to the next pool, as
        in the cold path)."""
        template = nodepool.template_labels()
        taints = nodepool.taints + nodepool.startup_taints
        enc_ctx = (self._encode_cache.context_for(
                       cat, nodepool.requirements, taints, template)
                   if self._encode_cache is not None else None)
        lsp = (TRACER.span("encode.lower", warm=True) if TRACER.enabled
               else NOOP_SPAN)
        with lsp:
            enc = encode_pods([p for g in pregrouped for p in g], cat,
                              extra_requirements=nodepool.requirements,
                              taints=taints,
                              pregrouped=pregrouped,
                              template_labels=template,
                              cache=enc_ctx, arena=self._arena)
            lsp.set(groups=int(enc.G), cache_hits=enc.cache_hits,
                    cache_misses=enc.cache_misses)
        self._meter_encode_rows(enc_ctx)
        self._apply_min_values_caps(enc, cat, nodepool.requirements)
        dropped = enc.dropped_keys  # split_spread_groups rebuilds the enc
        occ_sig = tuple(sorted((zone, len(placed))
                               for zone, placed in occupancy))
        asp = (TRACER.span("encode.affinity", warm=True) if TRACER.enabled
               else NOOP_SPAN)
        with asp:
            enc = self._delta_affinity(enc, cat, occupancy, occ_sig,
                                       nodepool.name)
        enc = self._delta_spread(enc, cat, occupancy, occ_sig,
                                 nodepool.name)
        enc.dropped_keys = dropped
        if enc.G:
            self._relax_infeasible_preferences(enc, cat)
            self.attach_existing_context(enc, existing, existing_pods)
        return enc

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
