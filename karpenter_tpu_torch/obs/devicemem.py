"""Device telemetry plane: what lives on the device, and why bytes move
(the port's copy of `karpenter_tpu/obs/devicemem.py`).

ROADMAP item 3 (device-resident cluster state with delta uploads and
buffer donation) is the next perf tier, but the device side of this
framework has been a black box: `_auto_dcat` residency, donated batch
gbufs, and the solver's two global byte counters are unattributed
aggregates, so there is no measured baseline proving how much of each
warm upload is redundant, and no way to see a device buffer outliving
its owner. This module is the accounting that must exist BEFORE the
optimization spends it (the Gavel lesson, PAPERS.md: measurement-driven
scheduling wins are only bankable with precise per-device accounting):

- **ResidencyLedger** (`DEVICEMEM`) — every device allocation the
  solver makes registers here with an owner kind (`OWNER_KINDS`), the
  owning object (weakref), its cache token / padded shape class, the
  tenant that caused it, and its byte size. Arrays are held by weakref
  with a finalizer, so live totals track reality without pinning a
  single buffer; the ledger publishes live bytes per kind, the process
  HBM watermark, and churn counters. `audit()` cross-checks the
  accounted set against the live device tensors (`live_device_tensors`:
  every CUDA tensor the garbage collector reaches, each storage counted
  once) — unaccounted bytes meter
  the `devicemem_unattributed_bytes` gauge and, below the coverage
  target, flight-record a `devicemem.unattributed` marker (the
  PhaseLedger >=99%-coverage idea applied to memory). A group whose
  OWNER died while its buffers stay live is an *orphan* — the watchdog's
  `devicemem_leak` invariant ages those past a sim grace.
- **TransferLedger** (`TRANSFERS`) — replaces the solver's two global
  byte counters as the source of truth: every counted `device_put` /
  readback attributes its bytes to a (reason, tenant, shape-class) row
  (reasons: `catalog_put`, `request_upload`, `batch_upload`,
  `screen_upload`, `readback`), threaded through the existing `_put`/
  `_read` wrappers via a thread-local attribution context
  (`attributed(...)`). `ops.solver.transfer_bytes()` now reads the
  ledger's totals — same numbers, now decomposable.
- **UploadMeter** (`UPLOADS`) — content-hashes every uploaded
  request-matrix row per facade/catalog-view key and reports the
  fraction of bytes identical to the PREVIOUS upload for that key: the
  number that sizes the delta-upload win of ROADMAP item 3 before we
  build it (`upload_redundant_frac` ~1.0 on a steady warm path means
  almost every byte we ship is a byte the device already has).

Finalizer discipline: weakref finalizers run inside GC, which can fire
while ANY lock is held on the same thread — so release callbacks never
touch the ledger lock or a metric; they append to a lock-free deque the
ledger drains on its next (caller-context) operation.

Read side: `/debug/device` (both exposition servers),
`tools/device_report.py` / `make device-report`, and the
`karpenter_tpu_devicemem_*` metric families.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from ..metrics.tenant import current_tenant

# the residency taxonomy: every tracked allocation wears one of these.
# `make obs-audit` asserts each kind is exercised by the canonical tests
# (tests/test_devicemem.py) — an owner kind nothing registers under is
# dead taxonomy wearing a green badge.
OWNER_KINDS: Tuple[str, ...] = (
    "catalog",        # DeviceCatalog tensors (alloc/price/avail/ovh_z)
    "solve_upload",   # per-solve gbuf/nbuf/prior/banned/conflict uploads
    "batch_gbuf",     # batched dispatch: stacked (donated) request matrix
    "packed_result",  # the packed int32 kernel output awaiting readback
    "mesh_shard",     # mesh-sharded uploads (P('nodes') / replicated)
    "resident_state",  # device-resident cross-reconcile state (the delta-
    #                    patched gbuf/conflict/catalog buffers ops/resident
    #                    holds; owner = the ResidentEntry)
)

# transfer-attribution reasons (the "why bytes move" axis)
TRANSFER_REASONS: Tuple[str, ...] = (
    "catalog_put",     # catalog tensors -> device (epoch miss only)
    "request_upload",  # per-solve serial uploads (gbuf/nbuf/prior/...)
    "batch_upload",    # batched dispatch's stacked request matrix
    "screen_upload",   # consolidation screen inputs
    "readback",        # device -> host packed-result reads
    "resident_patch",  # sparse row patches onto resident state (changed
    #                    rows + index vector only — ops/resident.py)
)

COVERAGE_TARGET = 0.99
_METER_MAX_ROWS = 8192   # UploadMeter skips pathological matrices
_METER_MAX_KEYS = 64     # per-view row-hash memory (LRU)
_MAX_GROUPS = 4096       # residency-group bound (churn guard)


# --- thread-local attribution context ----------------------------------
class _Ctx(threading.local):
    stack: Optional[List[dict]] = None


_ctx = _Ctx()


def _top() -> dict:
    stack = _ctx.stack
    return stack[-1] if stack else {}


@contextmanager
def attributed(reason: Optional[str] = None, kind: Optional[str] = None,
               token=None, shape_class: Optional[str] = None):
    """Attribute every counted device transfer inside the block.

    Unspecified fields inherit from the enclosing context (a nested
    `catalog_put` inside a shape-classed solve keeps the shape class).
    Yields a residency GROUP id — uploads inside the block register
    into it, so the caller can `adopt(group, owner)` once the owning
    object (DeviceCatalog, InFlightBatch) exists."""
    parent = _top()
    frame = {
        "reason": reason if reason is not None else parent.get("reason"),
        "kind": kind if kind is not None else parent.get("kind"),
        "token": token if token is not None else parent.get("token"),
        "shape_class": (shape_class if shape_class is not None
                        else parent.get("shape_class")),
        "group": DEVICEMEM.open_group(),
    }
    if _ctx.stack is None:
        _ctx.stack = []
    _ctx.stack.append(frame)
    try:
        yield frame["group"]
    finally:
        _ctx.stack.pop()


# --- residency ledger --------------------------------------------------
# finalizers append here (lock-free; deque appends are atomic) and the
# ledger drains on its next caller-context operation — see the module
# docstring's finalizer discipline
_RELEASES: "deque[Tuple[int, int, int]]" = deque()


class ResidencyLedger:
    """Live device allocations by owner kind — see module docstring."""

    def __init__(self, coverage_target: float = COVERAGE_TARGET):
        self.coverage_target = coverage_target
        self._lock = threading.Lock()
        self._gid = 0
        # gid -> {kind, token, tenant, shape_class, owner(weakref|None),
        #         live: {aid: nbytes}, bytes, created}
        self._groups: Dict[int, dict] = {}
        # the tracked-tensor set audit() compares against the live
        # device tensors; weak so tracking never pins
        self._arrays: "weakref.WeakValueDictionary[int, object]" = \
            weakref.WeakValueDictionary()
        self.live_bytes = 0
        self.watermark_bytes = 0
        self.kind_bytes: Dict[str, int] = {}
        self.stats: Dict[str, int] = {"tracked": 0, "released": 0,
                                      "groups": 0, "audits": 0}
        self.last_audit: Optional[dict] = None

    # --- write side ----------------------------------------------------
    def open_group(self) -> int:
        with self._lock:
            self._gid += 1
            return self._gid

    def track(self, kind: str, arrays, owner=None, token=None,
              shape_class: Optional[str] = None,
              group: Optional[int] = None) -> int:
        """Register device arrays under `kind`. Each array is finalized
        to auto-release its bytes when freed; `owner` (weakref'd) names
        the object whose death SHOULD free them — an owner dying while
        bytes stay live is the devicemem_leak orphan condition."""
        self._drain()
        tenant = current_tenant()
        with self._lock:
            if group is None:
                self._gid += 1
                group = self._gid
            g = self._groups.get(group)
            if g is None:
                if len(self._groups) >= _MAX_GROUPS:
                    # churn guard: drop the oldest EMPTY groups first;
                    # a group with live bytes is never silently dropped
                    for gid in [gid for gid, gg in self._groups.items()
                                if not gg["live"]][:64]:
                        self._groups.pop(gid, None)
                g = {"kind": kind, "token": token, "tenant": tenant,
                     "shape_class": shape_class, "owner": None,
                     "live": {}, "created": self.stats["tracked"]}
                self._groups[group] = g
                self.stats["groups"] += 1
            added = 0
            for arr in arrays:
                if arr is None:
                    continue
                aid = id(arr)
                if aid in g["live"] or aid in self._arrays:
                    continue  # torch.as_tensor may return its input unchanged
                try:
                    nbytes = int(arr.nbytes)
                except Exception:  # noqa: BLE001 — donated/deleted array
                    continue
                try:
                    self._arrays[aid] = arr
                    weakref.finalize(arr, _RELEASES.append,
                                     (group, aid, nbytes))
                except TypeError:
                    pass  # not weakref-able: tracked without auto-release
                g["live"][aid] = nbytes
                added += nbytes
                self.stats["tracked"] += 1
            self.live_bytes += added
            self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + added
            new_peak = self.live_bytes > self.watermark_bytes
            if new_peak:
                self.watermark_bytes = self.live_bytes
        self._publish(kind, new_peak)
        if owner is not None:
            self.adopt(group, owner)
        return group

    def adopt(self, group: int, owner) -> None:
        """Attach the owning object (by weakref) to a tracked group."""
        with self._lock:
            g = self._groups.get(group)
            if g is not None:
                try:
                    g["owner"] = weakref.ref(owner)
                except TypeError:
                    g["owner"] = None

    def _drain(self) -> None:
        """Apply finalizer-queued releases (caller context, never GC)."""
        if not _RELEASES:
            return
        touched: Dict[str, bool] = {}
        with self._lock:
            while True:
                try:
                    group, aid, nbytes = _RELEASES.popleft()
                except IndexError:
                    break
                g = self._groups.get(group)
                if g is None or aid not in g["live"]:
                    continue
                del g["live"][aid]
                self.live_bytes -= nbytes
                kind = g["kind"]
                self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) - nbytes
                touched[kind] = True
                self.stats["released"] += 1
                if not g["live"] and g["owner"] is None:
                    # ownerless and empty: pure churn, drop the group
                    self._groups.pop(group, None)
        for kind in touched:
            self._publish(kind, False)

    def _publish(self, kind: str, new_peak: bool) -> None:
        from ..metrics import DEVICEMEM_LIVE, DEVICEMEM_WATERMARK
        DEVICEMEM_LIVE.set(float(self.kind_bytes.get(kind, 0)), kind=kind)
        if new_peak:
            DEVICEMEM_WATERMARK.set(float(self.watermark_bytes))

    # --- read side -----------------------------------------------------
    def orphans(self) -> List[dict]:
        """Groups whose owner died while buffers stay live — the
        devicemem_leak watchdog invariant's raw observable."""
        self._drain()
        out: List[dict] = []
        with self._lock:
            for gid, g in self._groups.items():
                ref = g["owner"]
                if ref is None or not g["live"]:
                    continue
                if ref() is None:
                    out.append({"group": gid, "kind": g["kind"],
                                "tenant": g["tenant"],
                                "token": _fmt_token(g["token"]),
                                "bytes": sum(g["live"].values())})
        return out

    def audit(self, live_arrays=None) -> dict:
        """Cross-check accounted bytes against the live device tensors:
        unaccounted live bytes meter `devicemem_unattributed_bytes`;
        coverage below target flight-records a `devicemem.unattributed`
        marker so the gap arrives with evidence attached. Never raises —
        the audit must not take down the path it audits.

        live_arrays: the tensors to check (the CPU tests pass their own);
        by default `live_device_tensors()`. Tensors that share a storage
        (views) count once, at the storage's size: the bytes the device
        actually holds, not the caching allocator's rounded blocks."""
        self._drain()
        accounted = unaccounted = 0
        arrays = 0
        try:
            if live_arrays is None:
                live_arrays = live_device_tensors()
            with self._lock:
                # a mesh upload (parallel/collectives.ShardedTensor) is one
                # tracked array whose bytes live in its shards' parts
                tracked = {_storage_key(t) for a in list(self._arrays.values())
                           for t in getattr(a, "parts", (a,))}
            seen: set = set()
            for arr in live_arrays:
                try:
                    key = _storage_key(arr)
                    nbytes = _storage_nbytes(arr)
                except Exception:  # noqa: BLE001 — a freed storage
                    continue
                if key in seen:
                    continue
                seen.add(key)
                arrays += 1
                if key in tracked:
                    accounted += nbytes
                else:
                    unaccounted += nbytes
        except Exception:  # noqa: BLE001 — observability never crashes
            return {"error": "live tensors unavailable"}
        total = accounted + unaccounted
        coverage = 1.0 if total == 0 else accounted / total
        out = {"accounted_bytes": accounted,
               "unaccounted_bytes": unaccounted,
               "live_arrays": arrays,
               "coverage": round(coverage, 4)}
        self.stats["audits"] += 1
        self.last_audit = out
        from ..metrics import DEVICEMEM_UNATTRIBUTED
        DEVICEMEM_UNATTRIBUTED.set(float(unaccounted))
        if coverage < self.coverage_target and total > 0:
            self._flight_record_gap(out)
        return out

    def _flight_record_gap(self, audit: dict) -> None:
        from .tracer import TRACER, Span, Trace
        marker = Span(name="devicemem.unattributed",
                      trace_id=f"devmem-{self.stats['audits']}",
                      span_id=0, parent_id=None, t0=0.0,
                      t1=audit["unaccounted_bytes"] / 1e9 + 1e-6,
                      ts=0.0, attrs=dict(audit))
        TRACER.recorder.offer(Trace(trace_id=marker.trace_id,
                                    spans=[marker]), meter=False)

    def snapshot(self) -> dict:
        self._drain()
        with self._lock:
            kinds = {k: {"bytes": v,
                         "groups": sum(1 for g in self._groups.values()
                                       if g["kind"] == k and g["live"])}
                     for k, v in sorted(self.kind_bytes.items()) if v}
            return {"live_bytes": self.live_bytes,
                    "watermark_bytes": self.watermark_bytes,
                    "kinds": kinds,
                    "groups": len(self._groups),
                    "stats": dict(self.stats),
                    "last_audit": self.last_audit}

    def reset(self) -> None:
        """Forget history (watermark/stats) — bench regime isolation.
        Live tracking is untouched: groups and finalizers keep working."""
        self._drain()
        with self._lock:
            self.watermark_bytes = self.live_bytes
            self.stats.update(tracked=0, released=0, audits=0)


def _storage_key(t) -> tuple:
    """Identity of the storage a tensor's bytes live in: views of one
    allocation share it. An empty storage (data pointer 0) keys by the
    tensor itself."""
    ptr = t.untyped_storage().data_ptr()
    return (str(t.device), ptr) if ptr else ("id", id(t))


def _storage_nbytes(t) -> int:
    return int(t.untyped_storage().nbytes())


def live_device_tensors() -> list:
    """Every live CUDA tensor the garbage collector can reach: the port's
    counterpart of the reference's `jax.live_arrays()`. Empty without a
    card."""
    import gc
    import warnings

    import torch
    if not torch.cuda.is_available():
        return []
    out = []
    with warnings.catch_warnings():
        # isinstance() reads __class__, which some deprecated module-level
        # objects answer with a warning
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            try:
                if isinstance(o, torch.Tensor) and o.is_cuda:
                    out.append(o)
            except Exception:  # noqa: BLE001 — a half-built object
                continue
    return out


def _fmt_token(token) -> Optional[str]:
    if token is None:
        return None
    try:
        return "/".join(str(t) for t in token)
    except TypeError:
        return str(token)


# --- transfer attribution ledger ---------------------------------------
class TransferLedger:
    """Per-(reason, tenant, shape-class) byte/call accounting for every
    counted device-boundary crossing — the decomposable replacement for
    the solver's two global byte counters (whose totals it still
    serves, via `totals()`)."""

    def __init__(self):
        self._lock = threading.Lock()
        # (reason, tenant, shape_class) -> [bytes, calls]
        self._rows: Dict[Tuple[str, str, str], List[int]] = {}
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def record(self, reason: str, nbytes: int,
               shape_class: Optional[str] = None,
               tenant: Optional[str] = None) -> None:
        tenant = tenant if tenant is not None else current_tenant()
        key = (reason, tenant, shape_class or "-")
        with self._lock:
            row = self._rows.setdefault(key, [0, 0])
            row[0] += nbytes
            row[1] += 1
            if reason == "readback":
                self.d2h_bytes += nbytes
            else:
                self.h2d_bytes += nbytes
        from ..metrics import DEVICEMEM_TRANSFER
        DEVICEMEM_TRANSFER.inc(float(nbytes), reason=reason, tenant=tenant)

    def totals(self) -> Tuple[int, int]:
        """(host->device, device->host) bytes since import — the
        aggregate `ops.solver.transfer_bytes()` serves."""
        with self._lock:
            return self.h2d_bytes, self.d2h_bytes

    def snapshot(self) -> dict:
        with self._lock:
            rows = [{"reason": r, "tenant": t, "shape_class": s,
                     "bytes": b, "calls": c}
                    for (r, t, s), (b, c) in sorted(self._rows.items())]
            return {"h2d_bytes": self.h2d_bytes,
                    "d2h_bytes": self.d2h_bytes,
                    "rows": rows}


# --- upload-redundancy meter -------------------------------------------
_digest_weight_cache: dict = {}


def _digest_weights(width: int):
    """Memoized odd weight vector for the row-digest weighted sum —
    widths are few (one per matrix layout), the arange is not free."""
    import numpy as np
    w = _digest_weight_cache.get(width)
    if w is None:
        w = ((np.arange(1, width + 1, dtype=np.uint64)
              * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1))
        _digest_weight_cache[width] = w
    return w


class UploadMeter:
    """Row-level content hashing of uploaded request matrices, keyed
    per facade/catalog view: `observe(key, matrix)` compares each row's
    digest with the previous upload under the same key and accumulates
    identical vs changed bytes — `redundant_frac()` is the measured
    upper bound on what ROADMAP item 3's sparse row patches can save."""

    def __init__(self):
        self._lock = threading.Lock()
        # key -> uint64 per-row digest vector of the last upload
        self._rows: "OrderedDict[tuple, object]" = OrderedDict()
        self.identical_bytes = 0
        self.total_bytes = 0
        self.observations = 0
        self.skipped = 0

    @staticmethod
    def _row_digests(matrix):
        """64-bit per-row content digests, fully vectorized: each row's
        bytes (as uint32 words) enter a weighted sum with fmix64-style
        finalization. Not cryptographic — a telemetry checksum whose
        accidental-collision odds (~2^-64 per row pair) are far below
        anything that could skew a redundancy fraction; the vectorized
        form keeps a 512-row c3 matrix under ~100us where per-row
        blake2b cost >1ms (the <1%-overhead budget)."""
        import numpy as np
        with np.errstate(over="ignore"):
            words = np.ascontiguousarray(matrix).view(np.uint8).reshape(
                matrix.shape[0], -1)
            # pad the byte width to a uint64 boundary (zero bytes) and view
            # wide: no element widening, half the multiplies of a u32 walk.
            # A zeroed copy rather than np.pad, whose per-call overhead
            # dominates the small matrices the planes digest per solve
            w = words.shape[1]
            if w % 8:
                padded = np.zeros((words.shape[0], w + 8 - w % 8), np.uint8)
                padded[:, :w] = words
                words = padded
            u = words.view(np.uint64)
            weights = _digest_weights(u.shape[1])
            h = (u * weights[None, :]).sum(axis=1)
            h ^= h >> np.uint64(33)
            h *= np.uint64(0xFF51AFD7ED558CCD)
            h ^= h >> np.uint64(33)
        return h

    def observe(self, key: tuple, matrix) -> float:
        """Returns this upload's identical-byte fraction (0.0 on a
        first sight / skipped matrix)."""
        n = int(matrix.shape[0])
        if n == 0 or n > _METER_MAX_ROWS:
            with self._lock:
                self.skipped += 1
            return 0.0
        row_len = int(matrix.shape[1]) * matrix.itemsize
        digests = self._row_digests(matrix)
        with self._lock:
            prev = self._rows.get(key)
            identical = 0
            if prev is not None:
                m = min(prev.size, digests.size)
                identical = int((prev[:m] == digests[:m]).sum()) * row_len
            total = n * row_len
            self._rows[key] = digests
            self._rows.move_to_end(key)
            while len(self._rows) > _METER_MAX_KEYS:
                self._rows.popitem(last=False)
            self.identical_bytes += identical
            self.total_bytes += total
            self.observations += 1
        frac = identical / total if total else 0.0
        tenant = current_tenant()
        from ..metrics import UPLOAD_BYTES, UPLOAD_REDUNDANT_FRAC
        if identical:
            UPLOAD_BYTES.inc(float(identical), outcome="identical",
                             tenant=tenant)
        if total - identical:
            UPLOAD_BYTES.inc(float(total - identical), outcome="changed",
                             tenant=tenant)
        UPLOAD_REDUNDANT_FRAC.set(frac, tenant=tenant)
        return frac

    def totals(self) -> Tuple[int, int]:
        with self._lock:
            return self.identical_bytes, self.total_bytes

    def redundant_frac(self) -> float:
        with self._lock:
            return (self.identical_bytes / self.total_bytes
                    if self.total_bytes else 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"identical_bytes": self.identical_bytes,
                    "total_bytes": self.total_bytes,
                    "redundant_frac": round(
                        self.identical_bytes / self.total_bytes, 4)
                    if self.total_bytes else 0.0,
                    "observations": self.observations,
                    "skipped": self.skipped,
                    "keys": len(self._rows)}


# --- the counted-wrapper hooks (ops/solver._put/_put_sharded/_read) ----
def on_upload(arr, sharded: bool = False) -> None:
    """Attribute one counted host->device upload: transfer row +
    residency registration, under the ambient attribution context."""
    c = _top()
    reason = c.get("reason") or "request_upload"
    kind = c.get("kind") or ("mesh_shard" if sharded else "solve_upload")
    try:
        nbytes = int(arr.nbytes)
    except Exception:  # noqa: BLE001 — a deleted array meters nothing
        return
    TRANSFERS.record(reason, nbytes, shape_class=c.get("shape_class"))
    DEVICEMEM.track(kind, [arr], token=c.get("token"),
                    shape_class=c.get("shape_class"), group=c.get("group"))


def on_readback(nbytes: int) -> None:
    c = _top()
    TRANSFERS.record("readback", int(nbytes),
                     shape_class=c.get("shape_class"))


# --- process singletons + /debug/device --------------------------------
DEVICEMEM = ResidencyLedger()
TRANSFERS = TransferLedger()
UPLOADS = UploadMeter()


def payload(query: str = "") -> dict:
    return {"residency": DEVICEMEM.snapshot(),
            "orphans": DEVICEMEM.orphans(),
            "transfers": TRANSFERS.snapshot(),
            "uploads": UPLOADS.snapshot(),
            "owner_kinds": list(OWNER_KINDS),
            "reasons": list(TRANSFER_REASONS)}


from .exposition import register_debug_route  # noqa: E402 (after singletons)

register_debug_route("/debug/device", lambda query: payload(query))
