"""The provisioning solve on the card: `solve_device`.

The port of `karpenter_tpu/ops/solver.py`'s single-device path. The host
side is the reference's own numpy (copied here): group padding and
packing, the node-budget estimate, the projected resource columns, the
packed-result parse and the decode. The device side is one packed upload
of the group matrix (plus the node matrix when resuming), the group scan
(`ops/solve_scan`: kernels B0 and B on the card), the compaction into the
reference's int32 result layout, and ONE host read. The node-budget
regrow loop is the reference's; a sparse budget (k_max) too small for the
takes re-packs the same scan output instead of scanning again.

The batched half (`prepare_batchable`, `dispatch_batch`, `InFlightBatch`)
serves a bucket of fresh solves that share one device catalog as ONE
launch of kernels B0 and B along a request axis, asynchronously: the
fleet's `SolverService` stages the next bucket while one is in flight.

Every host -> device upload goes through `_put` and every host read
through `_read`, counted and attributed on the device telemetry plane
(`obs/devicemem`: the transfer and residency ledgers) as the reference's
are. With a `resident_key` (the facade's and the fleet's default), the
request matrices and the catalog tensors stay on the card across solves
and only their changed rows cross (`ops/resident`).

Entry points run on `cuda` unless the caller passes `device="cpu"`, which
runs the same path with the scan's plain PyTorch version.

With `mesh=` (`parallel/mesh`) the solve runs sharded: `solve_device`
splits the node axis over a "nodes" mesh (kernel M, `ops/mesh_scan`;
the uploads go through `_put_sharded`, one count each, as the
reference's), and `dispatch_batch` / `dispatch_packed` split a bucket's
request rows over a "batch" mesh (batched B0 and B on each shard, no
collectives). A mesh request runs sharded or raises; it never runs as
mesh=None.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..obs import devicemem as dm
from ..obs.tracer import NOOP_SPAN, TRACER
from .binpack import BIG, EPS, SolveResult, VirtualNode
from .encode import (CatalogTensors, EncodedPods, align_resources,
                     align_zone_overhead)
from .solve_scan import (ScanOut, pack_solution, pack_solution_batched,
                         solve_scan, solve_scan_batched)


class InjectedFault(RuntimeError):
    """A device fault raised by the dispatch-fault hook. It is the one
    exception the facade's device rung degrades on (metered, rerouted to
    the native or host rung for a cooldown); a kernel that fails to build,
    refuses its shapes or fails to launch raises its own error out of
    `Solver.solve` instead."""


# fault-injection seams, nil-guarded (None costs one identity check a
# solve). The dispatch hook is called with the backend name just before
# the scan and raises InjectedFault to model the card failing mid-solve.
# The corruption hook is the reference's silent-data-corruption seam
# (faults/plan.CorruptionFault): called as hook("gbuf", tensor) right
# after a non-resident request-matrix upload (the serial path with
# residency disarmed, and the batched stack), as hook("resident", tensor,
# key) by ops/resident after every resident upload, and — the port's own
# seam — as hook("result", SolveResult) after the decode. It returns a
# (silently wrong) replacement or None; while it is armed, an integrity
# violation on the device rung is treated as the injected corruption it
# is (quarantine and recovery) instead of raising.
_dispatch_fault_hook = None
_corruption_hook = None


def set_dispatch_fault_hook(fn) -> None:
    global _dispatch_fault_hook
    _dispatch_fault_hook = fn


def set_corruption_hook(fn) -> None:
    global _corruption_hook
    _corruption_hook = fn


def _maybe_corrupt(target: str, obj):
    if _corruption_hook is None:
        return obj
    out = _corruption_hook(target, obj)
    return obj if out is None else out


def _span(name: str):
    return TRACER.span(name) if TRACER.enabled else NOOP_SPAN


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card. Without a card and without an explicit device it raises —
    the port never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the host")
    return torch.device("cuda")


@dataclass(frozen=True)
class DeviceCatalog:
    """Catalog tensors resident on one device, or replicated over a mesh
    (each field then a `parallel.collectives.ShardedTensor`)."""

    alloc: torch.Tensor                   # f32 [T, R]
    price: torch.Tensor                   # f32 [T, Z, C], +inf = no offering
    avail: torch.Tensor                   # bool [T, Z, C]
    ovh_z: Optional[torch.Tensor] = None  # f32 [T, Z, R] or None

    @property
    def mesh(self):
        """The mesh this catalog is replicated over, or None."""
        return getattr(self.alloc, "mesh", None)

    def shard(self, s: int) -> "DeviceCatalog":
        """Shard s's replica of a mesh catalog, as a one-device catalog."""
        return DeviceCatalog(
            alloc=self.alloc.parts[s], price=self.price.parts[s],
            avail=self.avail.parts[s],
            ovh_z=self.ovh_z.parts[s] if self.ovh_z is not None else None)


# device-boundary crossings issued since import (uploads, reads): diff
# around a solve to count them, as the reference's transfer_stats()
_TRANSFERS = 0
_READS = 0


def transfer_stats() -> Tuple[int, int]:
    """(uploads, reads) issued by the solver since import."""
    return _TRANSFERS, _READS


def transfer_bytes() -> Tuple[int, int]:
    """(host->device, device->host) bytes since import, served from the
    transfer-attribution ledger (obs/devicemem.TRANSFERS), so the same
    bytes are decomposable per (reason, tenant, shape class)."""
    return dm.TRANSFERS.totals()


class _Staging(threading.local):
    """The pinned host buffers of this thread's uploads while a batched
    dispatch stages (None otherwise): the in-flight batch keeps them
    until its event."""
    keep: Optional[list] = None


_staging = _Staging()


def _h2d(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One uncounted host -> device copy. On the card the copy goes from a
    pinned host buffer with non_blocking=True, so an upload never makes
    the host wait for work already queued on the stream (the caching host
    allocator holds the pinned block until the copy has run; inside a
    batched staging the in-flight batch keeps it too). On the CPU the
    tensor is an independent copy, never a view of the caller's array."""
    if dev.type == "cuda":
        host = torch.from_numpy(arr.copy() if not arr.flags.writeable
                                else arr).pin_memory()
        out = host.to(dev, non_blocking=True)
        if _staging.keep is not None:
            _staging.keep.append(host)
        return out
    return torch.tensor(arr, device=dev)


def _put(x, dev: torch.device) -> torch.Tensor:
    """Host -> device upload of one numpy array, counted and attributed on
    the device telemetry plane (under the ambient `dm.attributed(...)`
    context)."""
    global _TRANSFERS
    _TRANSFERS += 1
    out = _h2d(np.ascontiguousarray(x), torch.device(dev))
    dm.on_upload(out)
    return out


def _put_sharded(x, sharding):
    """Host -> mesh upload of one numpy array under an explicit layout
    (`parallel.collectives.Sharding`): the mesh path's `_put`, counted once
    and attributed as `mesh_shard` with the logical array's bytes, as the
    reference's `_put_sharded` is. Each device receives its own blocks (a
    split) or one copy (replicated); the shards of a virtual mesh share
    one upload to their device and read blocks of it."""
    from ..parallel import collectives as col
    global _TRANSFERS
    _TRANSFERS += 1
    arr = np.ascontiguousarray(x)
    mesh = sharding.mesh
    if len(set(mesh.devices)) == 1:
        out = col.place(_h2d(arr, mesh.devices[0]), sharding)
    elif sharding.axis is None:
        copies = {d: _h2d(arr, d) for d in dict.fromkeys(mesh.devices)}
        out = col.ShardedTensor([copies[d] for d in mesh.devices], sharding,
                                arr.shape)
    else:
        blocks = np.split(arr, mesh.size, axis=sharding.axis)
        out = col.ShardedTensor(
            [_h2d(np.ascontiguousarray(b), d)
             for b, d in zip(blocks, mesh.devices)], sharding, arr.shape)
    dm.on_upload(out, sharded=True)
    return out


def _read(t) -> np.ndarray:
    """Device -> host read of one tensor (waits for the card), counted
    and attributed as a readback. A ShardedTensor reads as its logical
    tensor (a replicated one from its first shard)."""
    global _READS
    _READS += 1
    if not isinstance(t, torch.Tensor):
        from ..parallel.collectives import to_tensor
        t = to_tensor(t)
    out = t.cpu().numpy()
    dm.on_readback(out.nbytes)
    return out


def device_catalog(cat: CatalogTensors, R: int, device: torch.device = None,
                   resident_key: Optional[tuple] = None,
                   mesh=None) -> DeviceCatalog:
    """The catalog tensors on `device`.

    mesh: replicate the catalog over the mesh's shards instead (the
    sharded solve reads it on every shard); `device` is then unused.

    resident_key (one device only): route the four catalog tensors through the
    device-resident state manager (ops/resident.py) — an epoch bump then
    ships only the instance-type rows whose content changed (an ICE mark
    flips a few avail rows, not the catalog), as a NON-donated patch: a
    split shared view's predecessor DeviceCatalog may still serve a
    co-tenant, so its tensors keep their bytes and the patch lands in a
    copy."""
    from .resident import RESIDENT
    if mesh is not None:
        from ..parallel.collectives import Sharding
        rep = Sharding(mesh)

        def put(name, x):
            return _put_sharded(x, rep)
    elif resident_key is not None and RESIDENT.armed:
        tok = cat.cache_token

        def put(name, x):
            return RESIDENT.upload(resident_key + (name,), x, token=tok,
                                   donate=False, patch_across_tokens=True,
                                   device=device)
    else:
        def put(name, x):
            return _put(x, device)
    zovh = align_zone_overhead(cat, R)
    sp = (TRACER.span("solve.catalog_put", T=int(cat.T), R=int(R),
                      mesh=mesh is not None)
          if TRACER.enabled else NOOP_SPAN)
    with sp:
        b0 = transfer_bytes()[0]
        with dm.attributed(reason="catalog_put", kind="catalog",
                           token=cat.cache_token) as grp:
            dcat = DeviceCatalog(
                alloc=put("alloc", align_resources(cat.allocatable, R)
                          .astype(np.float32)),
                price=put("price", cat.price.astype(np.float32)),
                avail=put("avail", cat.available.astype(bool)),
                ovh_z=(put("ovh_z", zovh.astype(np.float32))
                       if zovh is not None else None))
        # the DeviceCatalog OWNS these tensors: the residency ledger's
        # leak invariant watches for the owner dying while the tensors
        # stay live
        dm.DEVICEMEM.adopt(grp, dcat)
        sp.set(h2d_bytes=transfer_bytes()[0] - b0)
    return dcat


# per-catalog device cache for callers without their own (bare solve_device
# and consolidation_screen calls): keyed on (id(cat), device) with a weakref
# finalizer so a freed CatalogTensors' reused address never aliases a stale
# entry. Callers that mutate a catalog's arrays in place after a solve must
# use a new object.
#
# Views minted by the facade's SharedCatalogCache carry a CONTENT-
# authoritative token ("shared", nodeclass-hash, fingerprint) and key here by
# token instead of id, so the per-solve derived copies (block gating,
# daemonset overhead) share ONE device upload across every tenant facade.
# Only "shared"-rooted tokens qualify: a facade's own (nodeclass-hash, epoch)
# token is unique per provider, not per content — two providers' epoch
# counters can agree while their availability differs.
_dcat_cache: dict = {}
_DCAT_TOKEN_MAX = 32  # bound for token-keyed entries (no weakref owner)
# evictions observed inside weakref finalizers queue here and flush to the
# metric from caller context: a finalizer runs inside GC, which can fire on
# a thread already holding the metric's (non-reentrant) lock
_dcat_evict_pending: list = []


def _count_dcat_eviction(reason: str) -> None:
    from ..metrics import DCAT_EVICTIONS
    DCAT_EVICTIONS.inc(reason=reason)


def _finalize_dcat(key) -> None:
    """weakref-finalizer eviction of an id-keyed entry (GC context: dict
    ops only, metric deferred)."""
    if _dcat_cache.pop(key, None) is not None:
        _dcat_evict_pending.append("weakref")


def release_shared_views(prefix: tuple) -> int:
    """Drop every token-keyed device-catalog entry whose content token
    starts with `prefix` — the SharedCatalogCache calls this when it evicts
    a view, so a dead shared view never pins device buffers past its own
    eviction. Returns the number of entries released."""
    victims = [k for k in _dcat_cache
               if isinstance(k[0], tuple) and k[0][:len(prefix)] == prefix]
    for k in victims:
        _dcat_cache.pop(k, None)
        _count_dcat_eviction("view_evicted")
    # the view's device-resident delta state goes with it: resident
    # tensors encoded against the dead view's ("shared", ...) token must
    # never outlive the view
    from .resident import RESIDENT
    RESIDENT.invalidate_token(prefix)
    return len(victims)


def _dcat_fits(dcat: DeviceCatalog, cat: CatalogTensors, R: int,
               device: torch.device = None, mesh=None) -> bool:
    """Can this device catalog serve a solve of `cat` at R resource
    columns on `device` (or replicated over `mesh`)?"""
    if dcat.alloc.shape[1] < R or ((dcat.ovh_z is not None)
                                   != (cat.zone_overhead is not None)):
        return False
    if mesh is not None or dcat.mesh is not None:
        return dcat.mesh == mesh
    on = dcat.alloc.device
    return (on.type == device.type
            and (device.index is None or on.index == device.index))


def _auto_dcat(cat: CatalogTensors, R: int, device: torch.device = None,
               mesh=None) -> DeviceCatalog:
    """Epoch-cached device catalog: on `device`, or replicated over `mesh`
    (keyed on the mesh itself, so one replicated upload serves every
    later solve on it). Every eviction path meters
    dcat_evictions_total{reason}: churn here is re-upload cost."""
    while _dcat_evict_pending:  # flush GC-deferred weakref evictions
        _count_dcat_eviction(_dcat_evict_pending.pop())
    if mesh is None:
        device = torch.device(device)
    tok = cat.cache_token
    by_token = tok is not None and len(tok) > 0 and tok[0] == "shared"
    place = mesh if mesh is not None else str(device)
    key = (tuple(tok), place) if by_token else (id(cat), place)
    ent = _dcat_cache.get(key)
    if ent is not None and _dcat_fits(ent, cat, R, device, mesh):
        return ent
    if ent is not None:
        # present but unusable (resource axis grew / overhead flipped)
        _count_dcat_eviction("stale")
    if ent is None and not by_token:
        weakref.finalize(cat, _finalize_dcat, key)
    # shared (content-token) views patch through the resident manager:
    # the key carries the nodeclass root + the FULL derived-view suffix
    # but NOT the availability fingerprint (tok[2]), so an epoch bump
    # ships only the changed type rows, and two distinct daemonset-
    # derived views never collide on one resident entry
    rkey = (("dcat", "shared", tok[1]) + tuple(tok[3:])
            if by_token and mesh is None else None)
    dcat = device_catalog(cat, R, device, resident_key=rkey, mesh=mesh)
    _dcat_cache[key] = dcat
    if by_token:
        # token-keyed entries deliberately OUTLIVE any one CatalogTensors
        # object (derived per-solve copies die at end of solve; their
        # upload must not) — bound them FIFO instead of by weakref
        tkeys = [k for k in _dcat_cache if isinstance(k[0], tuple)]
        for k in tkeys[:max(0, len(tkeys) - _DCAT_TOKEN_MAX)]:
            _dcat_cache.pop(k, None)
            _count_dcat_eviction("fifo")
    return dcat


# ---------------------------------------------------------------------------
# host-side helpers: copies of the reference's numpy (solver.py)
# ---------------------------------------------------------------------------


def _pack_groups(requests, counts, compat, allow_zone, allow_cap,
                 max_per_node, cols) -> np.ndarray:
    """One f32 [Gp, Rk+1+T+Z+C+1] matrix: requests (projected), counts,
    compat, allow_zone, allow_cap, max_per_node. Counts/caps are exact in
    f32 below 2^24 — far above any real pod count."""
    return np.concatenate([
        requests[:, cols].astype(np.float32),
        counts[:, None].astype(np.float32),
        compat.astype(np.float32),
        allow_zone.astype(np.float32),
        allow_cap.astype(np.float32),
        max_per_node[:, None].astype(np.float32),
    ], axis=1)


def _pack_nodes(node_type, node_cum, node_zmask, node_cmask, node_open,
                cols) -> np.ndarray:
    """One f32 [n, 1+Rk+Z+C+1] matrix of resumed-node state."""
    return np.concatenate([
        node_type[:, None].astype(np.float32),
        node_cum[:, cols].astype(np.float32),
        node_zmask.astype(np.float32),
        node_cmask.astype(np.float32),
        node_open[:, None].astype(np.float32),
    ], axis=1)


# monotone union of resource columns ever requested in this process (the
# reference keeps one per package so its jit statics stay stable; this
# package keeps its own, and results do not depend on it: a column no
# group requests can never bind)
_cols_union: set = {0}


def _request_cols(enc: EncodedPods, cat: CatalogTensors) -> tuple:
    """Resource columns the scan must carry: the process-lifetime union of
    columns any group has requested, plus any column a zone-overhead
    reservation charges. Clamped to the current resource axis; never
    empty."""
    used = enc.requests.any(axis=0)
    if cat.zone_overhead is not None:
        zc = cat.zone_overhead.any(axis=(0, 1))
        used[: zc.shape[0]] |= zc
    _cols_union.update(int(c) for c in np.nonzero(used)[0])
    R = enc.requests.shape[1]
    return tuple(c for c in sorted(_cols_union) if c < R)


def _group_inputs(enc: EncodedPods, Gp: int):
    """Pad the per-group arrays to the scan bucket."""
    return (_pad_to(enc.requests.astype(np.float32), Gp),
            _pad_to(enc.counts.astype(np.int32), Gp),
            _pad_to(enc.compat, Gp),
            _pad_to(enc.allow_zone, Gp),
            _pad_to(enc.allow_cap, Gp),
            _pad_to(enc.max_per_node.astype(np.int32), Gp))


def _auto_node_budget(cat: CatalogTensors, enc: EncodedPods,
                      n_existing: int) -> int:
    """Node-axis budget: the estimate commits the same cost-per-slot argmin
    type the scan does, so a 1.25x margin suffices; underestimates are
    safe — the scan reports overflow and solve_device retries doubled."""
    est = _estimate_nodes(cat, enc)
    return _bucket(n_existing + max(64, est + est // 4 + enc.G))


def _pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return np.pad(x, pad, constant_values=fill)


def _estimate_nodes(cat: CatalogTensors, enc: EncodedPods) -> int:
    """FFD node-count estimate: ceil(count / slots) per group, at the slots
    of the cost-per-slot-argmin type. Chunked over groups so the
    [chunk, T, R] broadcast stays small."""
    alloc = align_resources(cat.allocatable, enc.requests.shape[1])
    min_price = np.where(cat.available, cat.price, np.inf).min(axis=(1, 2))
    est = 0.0
    for lo in range(0, enc.G, 256):
        hi = min(lo + 256, enc.G)
        req = enc.requests[lo:hi].astype(np.float32)            # [g, R]
        with_req = np.where(req > 0, req, np.float32(1.0))
        slots = np.where(req[:, None, :] > 0,
                         np.floor(alloc[None, :, :] / with_req[:, None, :]
                                  + EPS),
                         np.float32(BIG)).min(axis=2)           # [g, T]
        cap = np.where(enc.max_per_node[lo:hi] > 0,
                       enc.max_per_node[lo:hi], BIG)[:, None]
        slots = np.clip(slots, 0.0, cap)
        ok = enc.compat[lo:hi] & (slots >= 1) & np.isfinite(min_price)[None, :]
        cps = np.where(ok, min_price[None, :] / np.maximum(slots, 1.0),
                       np.inf)                                  # [g, T]
        t_star = np.argmin(cps, axis=1)
        g_idx = np.arange(hi - lo)
        s = np.where(np.isfinite(cps[g_idx, t_star]),
                     slots[g_idx, t_star], np.float32(BIG))
        est += float(np.ceil(enc.counts[lo:hi] / np.maximum(s, 1.0)).sum())
    return int(est)


def _bucket(n: int, quantum: int = 64) -> int:
    """Round up to a padding bucket {2^k, 3·2^(k-1)} (worst-case padding
    waste 33%; the scan's per-step cost is O(n_max))."""
    n = max(n, 1)
    p = int(2 ** math.floor(math.log2(n)))
    for cand in (p, 3 * p // 2, 2 * p):
        if cand >= n:
            return max(quantum, cand)
    return max(quantum, 2 * p)


def _parse_packed(buf: np.ndarray, Gp: int, n_max: int, k_max: int):
    """Split one packed int32 result vector (layout: solve_scan.pack_solution)."""
    nused, overflowed, nnz = int(buf[0]), bool(buf[1]), int(buf[2])
    o = 3
    unsched = buf[o: o + Gp]; o += Gp
    ntype = buf[o: o + n_max]; o += n_max
    idx = buf[o: o + k_max]; o += k_max
    vals = buf[o: o + k_max]
    return nused, overflowed, nnz, unsched, ntype, idx, vals


def _decode_solution(cat: CatalogTensors, enc: EncodedPods,
                     existing: List[VirtualNode], node_cum: np.ndarray,
                     node_zmask: np.ndarray, node_cmask: np.ndarray,
                     nused: int, ntype: np.ndarray, idx: np.ndarray,
                     vals: np.ndarray, nnz: int, unsched: np.ndarray,
                     n_max: int) -> SolveResult:
    """Host-side reconstruction (vectorized, no device reads). cum is
    re-accumulated in ascending group order with the same f32 ops as the
    scan, so values agree bitwise."""
    R = enc.requests.shape[1]
    G = enc.G
    n_existing = len(existing)
    n_total = min(nused, n_max)
    take_g = idx[:nnz] // n_max
    take_n = idx[:nnz] % n_max
    take_v = vals[:nnz]

    cum = np.zeros((n_total, R), np.float32)
    cum[:n_existing] = node_cum[:n_existing]
    zmask = np.ones((n_total, cat.Z), bool)
    cmask = np.ones((n_total, cat.C), bool)
    zmask[:n_existing] = node_zmask[:n_existing]
    cmask[:n_existing] = node_cmask[:n_existing]
    fresh = np.ones(n_total, bool)
    fresh[:n_existing] = False
    t_avail_z = cat.available.any(axis=2)  # [T, Z]
    t_avail_c = cat.available.any(axis=1)  # [T, C]
    nt = ntype[:n_total]
    zmask[fresh] = t_avail_z[nt[fresh]]
    cmask[fresh] = t_avail_c[nt[fresh]]

    pods_by_node: List[dict] = [dict() for _ in range(n_total)]
    in_range = take_n < n_total
    for g in range(G):
        sel = (take_g == g) & in_range
        if not sel.any():
            continue
        ns = take_n[sel]
        vs = take_v[sel]
        cum[ns] = cum[ns] + vs[:, None].astype(np.float32) * enc.requests[g][None, :].astype(np.float32)
        zmask[ns] &= enc.allow_zone[g]
        cmask[ns] &= enc.allow_cap[g]
        for n, v in zip(ns.tolist(), vs.tolist()):
            pods_by_node[n][g] = v

    nodes: List[VirtualNode] = []
    for i in range(n_total):
        nodes.append(VirtualNode(
            type_idx=int(nt[i]), zone_mask=zmask[i], cap_mask=cmask[i],
            cum=cum[i], pods_by_group=pods_by_node[i],
            banned_groups=existing[i].banned_groups if i < n_existing else None,
            existing_name=existing[i].existing_name if i < n_existing else None))

    unschedulable = {g: int(unsched[g]) for g in range(G) if unsched[g] > 0}
    result = SolveResult(nodes=nodes, unschedulable=unschedulable)
    fi = np.nonzero(fresh)[0]
    if fi.size:
        from .binpack import cheapest_offerings
        result.launches = cheapest_offerings(nt[fi], zmask[fi], cmask[fi],
                                             cat)
    return result


# ---------------------------------------------------------------------------
# the device call
# ---------------------------------------------------------------------------


def _unpack_groups(buf: torch.Tensor, Rk: int, T: int, Z: int, C: int):
    """(requests, counts, compat, allow_zone, allow_cap, max_per_node) of a
    packed group matrix (_pack_groups' layout on the last axis: [Gp, W] or
    a bucket's [Bp, Gp, W]), by static offsets on the device."""
    requests = buf[..., :Rk]
    o = Rk
    counts = buf[..., o].to(torch.int32); o += 1
    compat = buf[..., o:o + T] > 0; o += T
    allow_zone = buf[..., o:o + Z] > 0; o += Z
    allow_cap = buf[..., o:o + C] > 0; o += C
    max_per_node = buf[..., o].to(torch.int32)
    return requests, counts, compat, allow_zone, allow_cap, max_per_node


def _fresh_nodes(n_max: int, Rk: int, Z: int, C: int, dev: torch.device):
    """(node_type, node_cum, node_zmask, node_cmask, node_open): n_max
    closed nodes, the start of a fresh solve."""
    return (torch.zeros(n_max, dtype=torch.int32, device=dev),
            torch.zeros((n_max, Rk), dtype=torch.float32, device=dev),
            torch.zeros((n_max, Z), dtype=torch.bool, device=dev),
            torch.zeros((n_max, C), dtype=torch.bool, device=dev),
            torch.zeros(n_max, dtype=torch.bool, device=dev))


# the scan's resource-column index on each device, uploaded once per
# (device, cols) from pinned memory: a pageable upload synchronises the
# stream, so every batched dispatch would wait for the batch in flight
_col_index: dict = {}


def _cols_on(cols: tuple, dev: torch.device) -> torch.Tensor:
    cix = _col_index.get((dev, cols))
    if cix is None:
        host = torch.tensor(cols, dtype=torch.int64)
        if dev.type == "cuda":
            host = host.pin_memory()
        cix = _col_index[(dev, cols)] = host.to(dev, non_blocking=True)
        # accounted on the residency ledger (the reference's column set is
        # a jit static and owns no device bytes)
        dm.DEVICEMEM.track("catalog", [cix])
    return cix


def _catalog_cols(dcat: DeviceCatalog, cols: tuple, zone_ovh: bool):
    """The device catalog's allocatable and zone overhead at the scan's
    resource columns (a [1, 1, Rk] zero overhead when there is none)."""
    dev = dcat.alloc.device
    cix = _cols_on(tuple(cols), dev)
    zovh = (dcat.ovh_z[:, :, cix] if zone_ovh
            else torch.zeros((1, 1, len(cols)), dtype=torch.float32,
                             device=dev))
    return dcat.alloc[:, cix], zovh


def _scan_onebuf(dcat: DeviceCatalog, gbuf: torch.Tensor,
                 prior: Optional[torch.Tensor],
                 banned: Optional[torch.Tensor],
                 conflict: Optional[torch.Tensor],
                 nbuf: Optional[torch.Tensor], n_existing: int,
                 n_max: int, cols: tuple, track_conflicts: bool,
                 zone_ovh: bool) -> ScanOut:
    """Unpack gbuf/nbuf by static offsets on the device, synthesize what
    was not shipped, run the scan. With pack_solution, the port of the
    reference's `_solve_onebuf_impl`."""
    dev = gbuf.device
    T, Z, C = dcat.price.shape
    Rk = len(cols)
    Gp = gbuf.shape[0]
    alloc_k, zovh_ = _catalog_cols(dcat, cols, zone_ovh)
    groups = _unpack_groups(gbuf, Rk, T, Z, C)
    prior_ = (prior if prior is not None
              else torch.zeros((Gp, 1), dtype=torch.int32, device=dev))
    banned_ = (banned if banned is not None
               else torch.zeros((Gp, 1), dtype=torch.bool, device=dev))
    conflict_ = (conflict if conflict is not None
                 else torch.zeros((Gp, 1), dtype=torch.bool, device=dev))
    if nbuf is None:
        (node_type, node_cum, node_zmask, node_cmask,
         node_open) = _fresh_nodes(n_max, Rk, Z, C, dev)
        n_used = 0
    else:
        node_type = nbuf[:, 0].to(torch.int32)
        node_cum = nbuf[:, 1:1 + Rk]
        node_zmask = nbuf[:, 1 + Rk:1 + Rk + Z] > 0
        node_cmask = nbuf[:, 1 + Rk + Z:1 + Rk + Z + C] > 0
        node_open = nbuf[:, 1 + Rk + Z + C] > 0
        # resumed nodes are exactly the open prefix
        n_used = n_existing
    return solve_scan(
        alloc_k, dcat.price, dcat.avail, *groups, prior_, banned_, conflict_,
        zovh_, node_type, node_cum, node_zmask, node_cmask, node_open,
        n_used, n_max, track_conflicts=track_conflicts, zone_ovh=zone_ovh)


@dataclass
class _Staged:
    """Host-side inputs of one solve, and the uploads that do not depend
    on the node budget."""

    dcat: DeviceCatalog
    Gp: int
    cols: tuple
    track: bool
    zone_ovh: bool
    gbuf: Optional[torch.Tensor]
    conflict: Optional[torch.Tensor]
    existing: List[VirtualNode]
    node_type: np.ndarray
    node_cum: np.ndarray
    node_zmask: np.ndarray
    node_cmask: np.ndarray
    has_prior: bool
    has_banned: bool
    shape_class: str = ""
    # a node mesh: its inputs are put per node budget (`_scan_mesh`), from
    # these host group inputs (the six of _group_inputs, then conflict)
    mesh: object = None
    groups_np: tuple = ()


def _stage(cat: CatalogTensors, enc: EncodedPods,
           existing: List[VirtualNode], dev: torch.device,
           dcat: Optional[DeviceCatalog] = None,
           resident_key: Optional[tuple] = None,
           n_max: Optional[int] = None, mesh=None) -> _Staged:
    R = enc.requests.shape[1]
    n_existing = len(existing)
    Gp = _bucket(enc.G, 8)
    if mesh is not None:
        # the reference's mesh catalog: replicated, at exactly R columns
        if (dcat is None or not _dcat_fits(dcat, cat, R, mesh=mesh)
                or dcat.alloc.shape[1] != R):
            dcat = device_catalog(cat, R, mesh=mesh)
    elif dcat is None or not _dcat_fits(dcat, cat, R, dev):
        dcat = _auto_dcat(cat, R, dev)
    node_type = np.zeros(n_existing, np.int32)
    node_cum = np.zeros((n_existing, R), np.float32)
    node_zmask = np.zeros((n_existing, cat.Z), bool)
    node_cmask = np.zeros((n_existing, cat.C), bool)
    for i, n in enumerate(existing):
        assert len(n.cum) <= R, (
            f"existing node cum has {len(n.cum)} resources but the "
            f"current axis is {R} — the resource axis only grows "
            f"within a process")
        node_type[i] = n.type_idx
        node_cum[i, : len(n.cum)] = n.cum
        node_zmask[i] = n.zone_mask
        node_cmask[i] = n.cap_mask
    track = enc.conflict is not None
    cols = _request_cols(enc, cat)
    shape_class = f"g{Gp}/n{n_max}"
    # pad group inputs; padded groups have count 0 -> no-ops in the scan
    groups_np = _group_inputs(enc, Gp)
    conflict_np = (_pad_to(_pad_to(enc.conflict, Gp, 0), Gp, 1) if track
                   else None)
    from .resident import RESIDENT
    if mesh is not None:
        gbuf = conflict = None
        groups_np = groups_np + (conflict_np if track
                                 else np.zeros((Gp, 1), bool),)
    elif resident_key is not None and RESIDENT.armed:
        gbuf_np = _pack_groups(*groups_np, list(cols))
        # device-resident delta path (ops/resident.py): the request
        # matrix stays on the card across reconciles and only CHANGED
        # group rows cross, patched in place (the reference donates these
        # two buffers); an unchanged warm solve ships zero upload bytes.
        # Fallbacks (epoch bump, shape-class growth, dense churn) re-upload
        # full — byte-parity with the cold path either way
        gbuf = RESIDENT.upload(resident_key + ("gbuf", Gp), gbuf_np,
                               token=cat.cache_token,
                               shape_class=shape_class, device=dev)
        conflict = (RESIDENT.upload(resident_key + ("conflict", Gp),
                                    conflict_np, token=cat.cache_token,
                                    shape_class=shape_class, device=dev)
                    if track else None)
    else:
        # redundancy meter: how much of this view's request matrix is
        # byte-identical to the previous solve's upload — the measured
        # headroom the resident path above spends
        gbuf_np = _pack_groups(*groups_np, list(cols))
        dm.UPLOADS.observe(("serial", id(dcat), Gp), gbuf_np)
        with dm.attributed(shape_class=shape_class):
            gbuf = _maybe_corrupt("gbuf", _put(gbuf_np, dev))
            conflict = _put(conflict_np, dev) if track else None
    return _Staged(dcat=dcat, Gp=Gp, cols=cols, track=track,
                   zone_ovh=dcat.ovh_z is not None, gbuf=gbuf,
                   conflict=conflict, existing=existing,
                   node_type=node_type, node_cum=node_cum,
                   node_zmask=node_zmask, node_cmask=node_cmask,
                   has_prior=any(n.prior_by_group for n in existing),
                   has_banned=any(n.banned_groups is not None
                                  for n in existing),
                   shape_class=shape_class, mesh=mesh,
                   groups_np=groups_np if mesh is not None else ())


def _scan(st: _Staged, n_max: int) -> ScanOut:
    """The group scan at one node budget: its outputs, still on the device
    (they do not depend on the sparse budget k_max; only the packing
    does)."""
    existing, Gp = st.existing, st.Gp
    n_existing = len(existing)
    prior = np.zeros((Gp, n_max if st.has_prior else 1), np.int32)
    banned = np.zeros((Gp, n_max if st.has_banned else 1), bool)
    for i, n in enumerate(existing):
        if st.has_prior:
            for g, cnt in n.prior_by_group.items():
                if g < Gp:
                    prior[g, i] = cnt
        if st.has_banned and n.banned_groups is not None:
            banned[: len(n.banned_groups), i] = n.banned_groups
    if st.mesh is not None:
        return _scan_mesh(st, n_max, prior, banned)
    dev = st.gbuf.device
    with dm.attributed(shape_class=st.shape_class):
        nbuf = (None if n_existing == 0 else
                _put(_pack_nodes(_pad_to(st.node_type, n_max),
                                 _pad_to(st.node_cum, n_max),
                                 _pad_to(st.node_zmask, n_max),
                                 _pad_to(st.node_cmask, n_max),
                                 _pad_to(np.ones(n_existing, bool), n_max),
                                 list(st.cols)), dev))
        prior_dev = _put(prior, dev) if st.has_prior else None
        banned_dev = _put(banned, dev) if st.has_banned else None
    return _scan_onebuf(
        st.dcat, st.gbuf, prior_dev, banned_dev, st.conflict, nbuf,
        n_existing, n_max, st.cols, st.track, st.zone_ovh)


def _scan_mesh(st: _Staged, n_max: int, prior: np.ndarray,
               banned: np.ndarray) -> ScanOut:
    """`_scan` on a node mesh (the reference's `_mesh_packed_fn` call):
    every input put once with the reference's layout (groups, conflict and
    the scalars replicated; node state split on the node axis; prior and
    banned split on it when they span the nodes), then the sharded scan
    (`parallel.mesh.sharded_solve_fn`, kernel M on the card), its outputs
    gathered on shard 0's device. Nothing compiles per shape, so the
    reference's executable cache has no counterpart."""
    from ..parallel.collectives import Sharding
    from ..parallel.mesh import sharded_solve_fn
    mesh, dcat = st.mesh, st.dcat
    rep, nodes, gn = Sharding(mesh), Sharding(mesh, 0), Sharding(mesh, 1)
    n_existing = len(st.existing)
    R = dcat.alloc.shape[1]
    put = _put_sharded
    with dm.attributed(shape_class=st.shape_class):
        args = (dcat.alloc, dcat.price, dcat.avail,
                *(put(x, rep) for x in st.groups_np[:6]),
                put(prior, gn if st.has_prior else rep),
                put(banned, gn if st.has_banned else rep),
                put(st.groups_np[6], rep),
                dcat.ovh_z if st.zone_ovh
                else put(np.zeros((1, 1, R), np.float32), rep),
                put(_pad_to(st.node_type, n_max), nodes),
                put(_pad_to(st.node_cum, n_max), nodes),
                put(_pad_to(st.node_zmask, n_max), nodes),
                put(_pad_to(st.node_cmask, n_max), nodes),
                put(_pad_to(np.ones(n_existing, bool), n_max), nodes),
                put(np.asarray(n_existing, np.int32), rep))
    (ntype, _cum, _zmask, _cmask, _nopen, nused, takes, unsched,
     overflow) = sharded_solve_fn(mesh, n_max)(
        *args, track_conflicts=st.track, zone_ovh=st.zone_ovh)
    return ntype, takes, unsched, nused, overflow


def _dispatch(st: _Staged, n_max: int, k_max: int) -> torch.Tensor:
    """The device call at one (n_max, k_max) budget: the packed int32
    result, still on the device."""
    return pack_solution(*_scan(st, n_max), k_max)


def solve_device(cat: CatalogTensors, enc: EncodedPods,
                 existing: Optional[List[VirtualNode]] = None,
                 n_max: Optional[int] = None,
                 dcat: Optional[DeviceCatalog] = None, device=None,
                 mesh=None,
                 resident_key: Optional[tuple] = None) -> SolveResult:
    """Run the solve on `device` (default: the CUDA card) and decode the
    result to the SolveResult solve_host produces. `enc` must be
    spread-free (split_spread_groups).

    mesh: split the node axis over a "nodes" mesh (`parallel/mesh`;
    `_scan_mesh`); `device` and `resident_key` are then unused.

    dcat: the catalog already on the device (the facade's per-view cache);
    one that cannot serve this solve (too few resource columns, another
    device, zone overhead flipped) is replaced by the process cache's.

    resident_key: keep the request matrix and the conflict matrix
    resident on the device under this key prefix (ops/resident.py): only
    their changed rows are uploaded, patched in place.

    With tracing on, the solve runs under a `solve.device` span whose
    children are the reference's stages: solve.prep (node budget),
    solve.device_put (staging and uploads), solve.dispatch (the scan,
    enqueued), solve.readback (packing and the one host read, which waits
    for the card), solve.decode. The per-solve transfer-byte deltas land
    on the two transfer gauges either way."""
    from ..metrics import TRANSFER_BYTES_D2H, TRANSFER_BYTES_H2D
    dev = resolve_device(device) if mesh is None else None
    u0, d0 = transfer_bytes()
    span = (TRACER.span("solve.device",
                        backend="mesh" if mesh is not None else "device",
                        pods=int(enc.counts.sum()), groups=int(enc.G))
            if TRACER.enabled else NOOP_SPAN)
    with span:
        result = _solve_device_impl(cat, enc, existing, n_max, dcat, dev,
                                    resident_key, mesh)
        u1, d1 = transfer_bytes()
        TRANSFER_BYTES_H2D.set(u1 - u0)
        TRANSFER_BYTES_D2H.set(d1 - d0)
        span.set(h2d_bytes=u1 - u0, d2h_bytes=d1 - d0)
    return result


def _solve_device_impl(cat: CatalogTensors, enc: EncodedPods,
                       existing: Optional[List[VirtualNode]],
                       n_max: Optional[int], dcat: Optional[DeviceCatalog],
                       dev: Optional[torch.device],
                       resident_key: Optional[tuple],
                       mesh=None) -> SolveResult:
    """The solve's loop: stage, scan, pack, one read; regrow the node
    budget and scan again on overflow. On a node mesh the node budget is a
    multiple of the mesh size (again after every regrow) and each scan
    puts its inputs sharded (`_scan_mesh`)."""
    assert not enc.spread_zone.any(), "run split_spread_groups before solve"
    existing = existing or []
    n_existing = len(existing)
    total_pods = int(enc.counts.sum())
    auto_n = n_max is None
    ms = int(mesh.size) if mesh is not None else 1
    with _span("solve.prep") as sp:
        if auto_n:
            n_max = _auto_node_budget(cat, enc, n_existing)
        n_max = -(-n_max // ms) * ms  # shardable node axis
        sp.set(n_max=int(n_max), groups_padded=int(_bucket(enc.G, 8)))
    with _span("solve.device_put") as sp:
        b0 = transfer_bytes()[0]
        st = _stage(cat, enc, existing, dev, dcat, resident_key, n_max,
                    mesh=mesh)
        sp.set(gbuf_shape=str(None if st.gbuf is None
                              else tuple(st.gbuf.shape)),
               h2d_bytes=transfer_bytes()[0] - b0)
    if _dispatch_fault_hook is not None:
        _dispatch_fault_hook("mesh" if mesh is not None else "device")
    while True:
        with _span("solve.dispatch") as sp:
            if mesh is not None:
                sp.set(backend="mesh", shards=ms, n_max=int(n_max),
                       note="includes replicated input puts")
            out = _scan(st, n_max)  # ONE scan per node budget
        packed = None
        with _span("solve.readback") as sp, \
                dm.attributed(shape_class=st.shape_class):
            # sparse-take budget: nnz ~ n_used + cross-node sharing, far
            # below the [Gp * n_max] flat size
            k_max = _bucket(2 * n_max)
            packed = pack_solution(*out, k_max)
            dm.DEVICEMEM.track("packed_result", [packed],
                               shape_class=st.shape_class)
            buf = _read(packed)  # ONE host read
            (nused, overflowed, nnz, unsched, ntype, idx,
             vals) = _parse_packed(buf, st.Gp, n_max, k_max)
            if nnz > k_max:
                # takes were truncated: re-pack the same scan at a larger
                # budget
                k_max = _bucket(nnz)
                packed = pack_solution(*out, k_max)
                buf = _read(packed)
                (nused, overflowed, nnz, unsched, ntype, idx,
                 vals) = _parse_packed(buf, st.Gp, n_max, k_max)
            sp.set(d2h_bytes=int(buf.nbytes), shape=str(tuple(buf.shape)))
        if not overflowed or not auto_n or n_max >= n_existing + total_pods:
            break
        # node budget too small: regrow it and scan again (the reference's
        # loop)
        n_max = min(_bucket(n_max * 2), _bucket(n_existing + total_pods))
        n_max = -(-n_max // ms) * ms

    with _span("solve.decode"):
        res = _decode_solution(cat, enc, existing, st.node_cum,
                               st.node_zmask, st.node_cmask, nused, ntype,
                               idx, vals, nnz, unsched, n_max)
    return _maybe_corrupt("result", res)


def solve_packed(cat: CatalogTensors, enc: EncodedPods,
                 existing: Optional[List[VirtualNode]] = None,
                 n_max: Optional[int] = None, device=None
                 ) -> Tuple[np.ndarray, dict]:
    """The packed int32 vector of solve_device's first device call for
    these inputs, with the statics it used (n_max, k_max, cols, flags, Gp)
    — the seam the parity tests hold against the reference's
    `_solve_onebuf` output."""
    dev = resolve_device(device)
    existing = existing or []
    if n_max is None:
        n_max = _auto_node_budget(cat, enc, len(existing))
    st = _stage(cat, enc, existing, dev, n_max=n_max)
    k_max = _bucket(2 * n_max)
    statics = dict(n_max=n_max, k_max=k_max, cols=st.cols,
                   track_conflicts=st.track, zone_ovh=st.zone_ovh, Gp=st.Gp)
    return _read(_dispatch(st, n_max, k_max)), statics


# ---------------------------------------------------------------------------
# batched dispatch: one device call, many solve requests
# ---------------------------------------------------------------------------
# The fleet funnels every tenant's solve through one queue and packs
# compatible requests (the same padded shape class and ONE shared device
# catalog) into one launch of kernels B0 and B along a leading request axis
# (solve_scan_batched, the port of the reference's vmapped
# `_solve_batched_impl`). Each request keeps its own padding (padded groups
# have count 0; padded batch rows have ALL counts zeroed), so rows decode
# independently and equal serial solves.
#
# With a batch mesh (`mesh=`, `parallel/mesh.make_batch_mesh`) Bp rounds
# up to a multiple of the mesh size, the stack splits its request rows
# over the shards, the catalog is replicated on the same mesh, and each
# shard runs batched B0 and B over its Bp/S rows; the rows are gathered
# for the one read. Not ported: the donated stack (the in-flight batch
# holds its uploads until its event instead). Nothing compiles per shape,
# so the reference's dispatch-cache hit/miss event has no counterpart.


@dataclass
class BatchableSolve:
    """One solve request staged for batched dispatch: the encoded problem
    plus the padded shape class that decides which requests may share a
    launch."""

    cat: CatalogTensors
    enc: EncodedPods
    dcat: DeviceCatalog
    Gp: int
    statics: dict          # n_max / k_max / cols / track_conflicts / zone_ovh
    signature: tuple       # full co-batch key (shape class + device catalog)
    shape_class: str       # "g<Gp>/n<n_max>"
    # identifies "the previous upload for this catalog view": per (facade,
    # view) when staged through a facade, per device catalog otherwise
    meter_key: tuple = ()


def prepare_batchable(cat: CatalogTensors, enc: EncodedPods,
                      dcat: Optional[DeviceCatalog] = None,
                      meter_key: Optional[tuple] = None,
                      device=None) -> Optional[BatchableSolve]:
    """Stage a FRESH solve (no existing nodes, no priors or bans) for
    batched dispatch; None when there is nothing to solve. The shape class
    mirrors solve_device's prep exactly (same _bucket, _auto_node_budget,
    _request_cols), so a staged request's row is the packed vector of a
    serial solve_device's first call. Runs on `device`, else on dcat's,
    else on the CUDA card."""
    assert not enc.spread_zone.any(), "run split_spread_groups before solve"
    if enc.G == 0:
        return None
    R = enc.requests.shape[1]
    dev = (dcat.alloc.device if device is None and dcat is not None
           else resolve_device(device))
    if dcat is None or not _dcat_fits(dcat, cat, R, dev):
        dcat = _auto_dcat(cat, R, dev)
    Gp = _bucket(enc.G, 8)
    n_max = _auto_node_budget(cat, enc, 0)
    k_max = _bucket(2 * n_max)
    cols = _request_cols(enc, cat)
    track = enc.conflict is not None
    zone_ovh = dcat.ovh_z is not None
    statics = dict(n_max=n_max, k_max=k_max, cols=cols,
                   track_conflicts=track, zone_ovh=zone_ovh)
    # the device catalog is part of the co-batch key: requests in one
    # launch share ONE resident catalog
    signature = ("batch", Gp, n_max, k_max, cols, track, zone_ovh,
                 tuple(dcat.alloc.shape), tuple(dcat.price.shape), id(dcat))
    return BatchableSolve(cat=cat, enc=enc, dcat=dcat, Gp=Gp,
                          statics=statics, signature=signature,
                          shape_class=f"g{Gp}/n{n_max}",
                          meter_key=(meter_key if meter_key is not None
                                     else ("dcat", id(dcat))))


class InFlightBatch:
    """A dispatched bucket whose device work may still be running: the
    async half of the stage -> upload -> dispatch -> decode pipeline. A
    CUDA event recorded after the launch marks its end; the caller
    overlaps host work with the card by delaying block()/decode(), and
    the batch holds its pinned upload buffers until then."""

    def __init__(self, reqs: List[BatchableSolve], packed,
                 dispatched_at: float, event=None, keep: tuple = (),
                 group: Optional[int] = None):
        self.reqs = reqs
        self._packed = packed       # device int32 [Bp, L]
        self._event = event         # torch.cuda.Event after the launch
        self._keep = keep           # host buffers the uploads read from
        # the residency-ledger group of the staged uploads: the batch owns
        # it, unless a caller (the federation server) adopts it
        self.group = group
        self.dispatched_at = dispatched_at
        self._buf: Optional[np.ndarray] = None
        self.wait_s = 0.0           # host time spent blocked on the device
        self.span_s = 0.0           # dispatch-return -> results ready
        self.fallbacks = 0          # rows re-run serially (budget regrow)

    @property
    def size(self) -> int:
        return len(self.reqs)

    @property
    def padded_size(self) -> int:
        return int(self._packed.shape[0]) if self._buf is None \
            else int(self._buf.shape[0])

    def block(self) -> float:
        """Wait for the batch's event, then read the packed [Bp, L] result
        back (the ONE read of the whole batch). Returns the blocked-wait
        seconds: ~zero when host work fully overlapped the card."""
        if self._buf is not None:
            return 0.0
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        self.wait_s = time.perf_counter() - t0
        with _span("solve.readback") as sp:
            self._buf = _read(self._packed)
            sp.set(batch=self.size, d2h_bytes=int(self._buf.nbytes))
        self._packed = self._event = None
        self._keep = ()
        self.span_s = time.perf_counter() - self.dispatched_at
        return self.wait_s

    def rows(self) -> np.ndarray:
        """The packed int32 rows [Bp, L] (waits for the card first); row i
        is request i's vector in pack_solution's layout."""
        self.block()
        return self._buf

    def decode(self, i: int) -> SolveResult:
        """Decode request i's row independently of its batch peers: the
        serial path's host-side reconstruction. A row whose sparse or node
        budget proved too small re-runs serially (solve_device's regrow
        loop), as a serial dispatch of that request would have."""
        self.block()
        req = self.reqs[i]
        st = req.statics
        Gp, n_max, k_max = req.Gp, st["n_max"], st["k_max"]
        (nused, overflowed, nnz, unsched, ntype, idx,
         vals) = _parse_packed(self._buf[i], Gp, n_max, k_max)
        total_pods = int(req.enc.counts.sum())
        if nnz > k_max or (overflowed and n_max < total_pods):
            self.fallbacks += 1
            return solve_device(req.cat, req.enc, dcat=req.dcat,
                                device=req.dcat.alloc.device)
        with _span("solve.decode") as sp:
            R = req.enc.requests.shape[1]
            result = _decode_solution(
                req.cat, req.enc, [], np.zeros((0, R), np.float32),
                np.zeros((0, req.cat.Z), bool),
                np.zeros((0, req.cat.C), bool),
                nused, ntype, idx, vals, nnz, unsched, n_max)
            sp.set(batch_index=i, nodes=len(result.nodes), nnz=int(nnz))
        return result

    def results(self) -> List[SolveResult]:
        return [self.decode(i) for i in range(self.size)]

    @classmethod
    def from_rows(cls, reqs: List[BatchableSolve], rows: np.ndarray,
                  span_s: float = 0.0) -> "InFlightBatch":
        """Rehydrate a drained batch from already-read packed rows (a
        federation client's path: the device half ran elsewhere and the
        [Bp, L] int32 rows arrived as bytes). decode() then runs here
        against the client's own cat/enc; block() is a no-op."""
        ifb = cls(reqs, None, 0.0)
        ifb._buf = np.ascontiguousarray(rows, dtype=np.int32)
        ifb.span_s = float(span_s)
        return ifb


def _batch_bucket(b: int) -> int:
    """Batch-axis padding bucket: {1, 2, 3, 4, 6, 8, 12, 16, ...}, the
    node axis's {2^k, 3·2^(k-1)} ladder, as the reference pads it."""
    return _bucket(b, 1)


def _stage_batch_stack(gstack_np: np.ndarray, conf_np: Optional[np.ndarray],
                       dev: torch.device,
                       resident_key: Optional[tuple] = None, token=None,
                       shape_class: str = "", mesh=None):
    """Upload one packed request stack ([Bp, Gp, W] f32, plus the optional
    [Bp, Gp, Gp] conflict stack) through the counted `_put` — or, with a
    resident_key, the stack through the resident manager (an unchanged
    tenant's rows patch instead of re-uploading). With a batch mesh both
    split their request rows over the shards (`_put_sharded`; a resident
    stack lives sharded and patches per shard). On the card every copy
    goes from a pinned host buffer with non_blocking=True: a pageable copy
    on the stream would make the host wait for the batch already in
    flight. Returns (gstack, conf, ledger group, the host buffers to keep
    until the batch's event). A resident stack is patched out of place:
    the next pump reads it while this batch may still run."""
    sharding = None
    if mesh is not None:
        from ..parallel.collectives import Sharding
        sharding = Sharding(mesh, 0)
    keep: list = []
    _staging.keep = keep
    try:
        with dm.attributed(reason="batch_upload", kind="batch_gbuf",
                           shape_class=shape_class) as grp:
            from .resident import RESIDENT
            if resident_key is not None and RESIDENT.armed:
                gstack = RESIDENT.upload(
                    resident_key + ("batch_gbuf",) + tuple(gstack_np.shape),
                    gstack_np, token=token, shape_class=shape_class,
                    donate=False, device=dev, sharding=sharding)
            elif sharding is not None:
                gstack = _maybe_corrupt("gbuf",
                                        _put_sharded(gstack_np, sharding))
            else:
                gstack = _maybe_corrupt("gbuf", _put(gstack_np, dev))
            conf = None
            if conf_np is not None:
                conf = (_put_sharded(conf_np, sharding)
                        if sharding is not None else _put(conf_np, dev))
    finally:
        _staging.keep = None
    return gstack, conf, grp, tuple(keep)


def _scan_batched_args(dcat: DeviceCatalog, gstack: torch.Tensor,
                       conf: Optional[torch.Tensor], st: dict):
    """(args, kwargs) of solve_scan_batched for a stacked bucket: the
    groups unpacked from gstack [Bp, Gp, W] by static offsets, no priors or
    bans, the conflict stack where the statics track conflicts, and fresh
    nodes."""
    dev = gstack.device
    T, Z, C = dcat.price.shape
    cols, n_max = st["cols"], st["n_max"]
    Rk = len(cols)
    Bp, Gp = gstack.shape[:2]
    track, zone_ovh = st["track_conflicts"], st["zone_ovh"]
    alloc_k, zovh = _catalog_cols(dcat, cols, zone_ovh)
    zeros_i = torch.zeros((Bp, Gp, 1), dtype=torch.int32, device=dev)
    zeros_b = torch.zeros((Bp, Gp, 1), dtype=torch.bool, device=dev)
    args = (alloc_k, dcat.price, dcat.avail,
            *_unpack_groups(gstack, Rk, T, Z, C), zeros_i, zeros_b,
            conf if track else zeros_b, zovh,
            *_fresh_nodes(n_max, Rk, Z, C, dev), 0, n_max)
    return args, dict(track_conflicts=track, zone_ovh=zone_ovh)


def _dispatch_stack(gstack: torch.Tensor, conf: Optional[torch.Tensor],
                    dcat: DeviceCatalog, st: dict,
                    mesh=None) -> torch.Tensor:
    """The device half shared by dispatch_batch and dispatch_packed: the
    batched scan (one launch each of B0 and B on the card) and the packing
    of every row. With a batch mesh, each shard runs its own launch of B0
    and B over its rows against its replica of the catalog, and the rows
    are gathered on shard 0's device (no collective between the shards).
    Returns the packed [Bp, L] int32, still on the device (no
    synchronisation).

    NO fault-hook probe here: one launch serves MANY tenants, so the
    caller probes through probe_dispatch_fault under each tenant's scope
    BEFORE dispatching (fleet/service._dispatch_bucket)."""
    with _span("solve.dispatch") as sp:
        sp.set(backend="device", batch=int(gstack.shape[0]),
               n_max=st["n_max"], mesh=mesh is not None)
        if mesh is None:
            args, kw = _scan_batched_args(dcat, gstack, conf, st)
            return pack_solution_batched(*solve_scan_batched(*args, **kw),
                                         st["k_max"])
        from ..parallel.collectives import gather, on_shard
        rows = []
        for s, d in enumerate(mesh.devices):
            with on_shard(d):
                args, kw = _scan_batched_args(
                    dcat.shard(s), gstack.parts[s],
                    conf.parts[s] if conf is not None else None, st)
                rows.append(pack_solution_batched(
                    *solve_scan_batched(*args, **kw), st["k_max"]))
        return gather(rows)


def _launch_stack(reqs: List[BatchableSolve], gstack_np: np.ndarray,
                  conf_np: Optional[np.ndarray], dcat: DeviceCatalog,
                  statics: dict, shape_class: str,
                  resident_key: Optional[tuple] = None,
                  token=None, mesh=None) -> InFlightBatch:
    """Pad the batch axis to its bucket (padded rows repeat row 0 with
    every count zeroed: no-ops in the scan; with a batch mesh, up to a
    multiple of its size, so every shard owns whole rows), upload,
    dispatch, record the batch's event; returns without waiting for the
    card."""
    if mesh is not None and dcat.mesh != mesh:
        raise ValueError("a batch-mesh dispatch needs a catalog replicated "
                         "on the same mesh")
    dev = dcat.alloc.device
    B = int(gstack_np.shape[0])
    Bp = _batch_bucket(B)
    if mesh is not None:
        Bp = -(-Bp // mesh.size) * mesh.size
    track = statics["track_conflicts"]
    with _span("solve.batch_pack") as sp:
        b0 = transfer_bytes()[0]
        if Bp > B:
            pad = np.repeat(gstack_np[:1], Bp - B, axis=0)
            pad[:, :, len(statics["cols"])] = 0.0  # zero counts: no-op rows
            gstack_np = np.concatenate([gstack_np, pad], axis=0)
            if track:
                conf_np = np.concatenate(
                    [conf_np, np.zeros((Bp - B,) + conf_np.shape[1:], bool)],
                    axis=0)
        gstack, conf, grp, keep = _stage_batch_stack(
            gstack_np, conf_np if track else None, dev,
            resident_key=resident_key, token=token,
            shape_class=shape_class, mesh=mesh)
        sp.set(requests=B, padded=Bp, shape_class=shape_class,
               h2d_bytes=transfer_bytes()[0] - b0)
    packed = _dispatch_stack(gstack, conf, dcat, statics, mesh=mesh)
    event = None
    if dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    ifb = InFlightBatch(reqs, packed, time.perf_counter(), event=event,
                        keep=keep, group=grp)
    # the in-flight batch OWNS the staged uploads and the pending packed
    # output: residency drops when it drains (block() frees _packed) or
    # when the batch object itself dies
    dm.DEVICEMEM.adopt(grp, ifb)
    dm.DEVICEMEM.track("packed_result", [packed], owner=ifb,
                       shape_class=shape_class)
    return ifb


def dispatch_batch(reqs: List[BatchableSolve], mesh=None,
                   resident_key: Optional[tuple] = None) -> InFlightBatch:
    """Pack one bucket of same-signature requests into a single device call
    and return without blocking (the card executes while the caller stages
    the next bucket).

    mesh: lay the REQUEST axis over a batch mesh
    (`parallel/mesh.make_batch_mesh`): Bp rounds up to a multiple of its
    size, the bucket's catalog is replicated on the same mesh (one upload
    per (view, mesh), cached), and rows decode exactly as on one device.

    resident_key: route the stacked request matrix through the
    device-resident manager (the fleet's stable buckets): tenant rows that
    did not change between pumps are not shipped again."""
    assert reqs, "empty batch"
    first = reqs[0]
    assert all(r.signature == first.signature for r in reqs), \
        "batched requests must share one shape-class signature"
    st = first.statics
    Gp, cols = first.Gp, list(st["cols"])
    gbufs = [_pack_groups(*_group_inputs(r.enc, Gp), cols) for r in reqs]
    # redundancy metering BEFORE the stack: each request's matrix hashes
    # against the previous upload under ITS OWN meter key (per
    # facade/view), so the identical-byte fraction measures exactly what a
    # per-view delta upload would save
    for r, g in zip(reqs, gbufs):
        dm.UPLOADS.observe(r.meter_key, g)
    gstack_np = np.stack(gbufs)
    conf_np = None
    if st["track_conflicts"]:
        conf_np = np.stack([_pad_to(_pad_to(r.enc.conflict, Gp, 0), Gp, 1)
                            if r.enc.conflict is not None
                            else np.zeros((Gp, Gp), bool) for r in reqs])
    dcat = first.dcat
    if mesh is not None:
        dcat = _auto_dcat(first.cat, first.enc.requests.shape[1], mesh=mesh)
    return _launch_stack(reqs, gstack_np, conf_np, dcat, st,
                         first.shape_class, resident_key=resident_key,
                         token=first.cat.cache_token, mesh=mesh)


def dispatch_packed(gstack_np: np.ndarray, conf_np: Optional[np.ndarray],
                    dcat: DeviceCatalog, statics: dict, shape_class: str = "",
                    mesh=None, resident_key: Optional[tuple] = None,
                    token=None) -> InFlightBatch:
    """Dispatch an ALREADY-PACKED request stack ([B, Gp, W] f32, plus the
    [B, Gp, Gp] conflict stack when the statics track conflicts): the
    federation server's entry point, whose clients packed the rows on
    their own hosts. Returns the in-flight batch without blocking; its
    rows() are the packed [Bp, L] int32 to ship back, decoded by the
    owning clients (`InFlightBatch.from_rows`), and its `group` the
    residency-ledger group of the staged uploads.

    resident_key: route the stack through the device-resident manager
    (the server's per-client-process key, with the catalog's content
    token): a client whose tenant rows did not change between pumps
    patches instead of re-shipping the stack to the card.

    mesh: a batch mesh the catalog `dcat` is replicated on (the server's
    `SolverServer(mesh=)`): the rows split over its shards."""
    return _launch_stack([], gstack_np, conf_np, dcat, statics, shape_class,
                         resident_key=resident_key, token=token, mesh=mesh)


def probe_dispatch_fault(backend: str) -> None:
    """Fire the injected device-fault seam, if armed. The batched
    dispatcher calls this once per distinct tenant in a bucket, each under
    that tenant's metric scope: the serial path's per-tenant probe."""
    if _dispatch_fault_hook is not None:
        _dispatch_fault_hook(backend)


def solve_device_batched(reqs: List[BatchableSolve]) -> List[SolveResult]:
    """Synchronous convenience: dispatch one bucket and decode every row.
    The pipelined overlap and the per-tenant fault probes live in the
    caller (fleet/service.py)."""
    probe_dispatch_fault("device")
    return dispatch_batch(reqs).results()
