"""Signature-keyed encode cache + staging arena: the columnar encode
pipeline's persistence layer.

The port's copy of `karpenter_tpu/ops/encode_cache.py`.

On a steady cluster almost every
reconcile re-encodes the SAME constraint signatures against the SAME
catalog view: the per-group tensor rows (compat[T], allow_zone[Z],
allow_cap[C], max_per_node, spread flags, the padded request vector and
the pre-preference hard rows) are a pure function of

    (constraint_signature, catalog view, pool context)

so this module persists them columnarly and turns a warm re-encode into
one vectorized gather. Encode cost then scales with *churn* (new
signatures), not population — the same amortization CvxCluster gets
from keeping the problem dense end-to-end and Tesserae gets from
amortizing constraint lowering across placement rounds (PAPERS.md).

Keying & invalidation ride the machinery that already exists:

- the *catalog token* is `CatalogTensors.cache_token` — the facade
  stamps it from the `(nodeclass-hash, catalog-epoch)` key of
  `Solver.tensors()` and extends it for every derived view (capacity-
  block gating, daemonset-overhead baking). An ICE mark, price move,
  reservation change or overlay bump rotates the epoch, hence the
  token, hence the context — no bespoke invalidation protocol.
- the *pool token* appends the NodePool requirements / taints /
  template-labels fingerprints (they enter every row via
  `extra_requirements`, the taint filter and selector resolution).

One `EncodeContext` holds the rows for one full token; the cache keeps
a small LRU of contexts so clusters alternating a few (pool, class)
views every reconcile don't thrash. Within a context, rows live in
capacity-doubling row-major matrices — the gather is `np.take` over
row indices, and the cached row storage is never aliased into the
returned `EncodedPods` (downstream passes mutate enc arrays in place).

`EncodeArena` is the zero-realloc companion: encode staging arrays are
large (`[G, T]` at 850 types) and rebuilt every solve; the arena hands
out reusable buffers so cold encodes stop paying realloc + page-fault
cost. Arrays served from an arena stay valid only until the next encode
that leases the same arena — the facade's consumers are all transient
within one solve, and a nested solve (reserved-capacity retry) simply
bypasses a leased arena and allocates fresh.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

DROPPED = -1  # index sentinel: signature fails the pool's taint filter


def requirements_token(reqs) -> Optional[tuple]:
    """Hashable fingerprint of a Requirements conjunction (ValueSet is a
    frozen dataclass, so the per-key sets hash structurally)."""
    if reqs is None:
        return None
    return tuple(sorted(
        ((k, reqs.get(k), reqs.min_values(k)) for k in reqs.keys()),
        key=lambda kv: kv[0]))


def taints_token(taints) -> tuple:
    return tuple(sorted((t.key, t.value, t.effect) for t in (taints or ())))


def labels_token(labels) -> tuple:
    return tuple(sorted((labels or {}).items()))


class EncodeArena:
    """Reusable dense staging buffers for the encode pipeline.

    `take()` returns a view of a flat capacity-doubling buffer keyed by
    name. The arena is leased for the duration of one encode
    (`acquire`/`release`); a nested encode that finds the arena leased
    falls back to fresh allocations, so re-entrancy (the facade's
    reserved-capacity retry solves, auditor replays) can never hand two
    live `EncodedPods` the same memory. Arrays taken from the arena are
    valid until the NEXT encode leases it — every consumer in the solve
    pipeline is transient within one solve, which is the contract.
    """

    def __init__(self) -> None:
        self._bufs: Dict[str, np.ndarray] = {}
        self._leased = False

    def acquire(self) -> bool:
        if self._leased:
            return False
        self._leased = True
        return True

    def release(self) -> None:
        self._leased = False

    def take(self, name: str, shape: Tuple[int, ...], dtype,
             zero: bool = False) -> np.ndarray:
        need = 1
        for d in shape:
            need *= int(d)
        buf = self._bufs.get(name)
        if buf is None or buf.dtype != np.dtype(dtype) or buf.size < need:
            cap = need if buf is None else max(need, 2 * buf.size)
            buf = np.empty(max(cap, 1), dtype)
            self._bufs[name] = buf
        out = buf[:need].reshape(shape)
        if zero:
            out.fill(0)
        return out

    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._bufs.values())


class EncodeContext:
    """Columnar row store for ONE (catalog view, pool context) token.

    Rows are keyed by the pod group's constraint signature. Matrices
    grow by doubling; when the row population exceeds `max_rows`
    (per-pod-unique signatures — StatefulSet name labels, rolling
    template hashes — would otherwise accrete forever) the index
    rotates like the pod-signature intern table: cached rows are
    recomputed on next sight, correctness never depends on a hit.
    """

    GROW_START = 64

    def __init__(self, token: tuple, T: int, Z: int, C: int,
                 stats: Dict[str, int], max_rows: int = 4096) -> None:
        self.token = token
        self.T, self.Z, self.C = T, Z, C
        self.stats = stats
        self.max_rows = max_rows
        self._index: Dict[tuple, int] = {}
        self._n = 0
        self._cap = 0
        self._R = 0
        # row-major matrices, allocated on first insert
        self._compat = self._hard_t = None    # bool [cap, T]
        self._zone = self._hard_z = None      # bool [cap, Z]
        self._capm = self._hard_c = None      # bool [cap, C]
        self._req: Optional[np.ndarray] = None  # f32 [cap, R]
        self._maxpn: Optional[np.ndarray] = None  # i32 [cap]
        self._spread = self._soft = None      # bool [cap]
        # per-row "preferred narrowing changed this axis" flags — they
        # reproduce the cold encoder's hard-rows-or-None decision exactly
        self._dt = self._dz = self._dc = None  # bool [cap]
        # (row-id tuple, matrix-or-None): the cross-group anti-affinity
        # conflict matrix for the LAST row-id sequence — on a steady
        # cluster the group set is identical every reconcile, and the
        # O(G²)-shaped build is the one encode cost rows can't amortize
        self._conflict_memo: Optional[Tuple[tuple, object]] = None

    # --- index ---
    def begin(self) -> None:
        """Start one encode batch: rotate a full row store NOW, never
        mid-batch — row ids handed to an in-flight encode must stay
        valid until its gather. A single batch with more distinct
        signatures than max_rows grows past the cap transiently and
        rotates at the next batch boundary."""
        if len(self._index) >= self.max_rows:
            self._index.clear()
            self._n = 0
            self._conflict_memo = None  # row ids are reissued after rotation
            self.stats["rotations"] = self.stats.get("rotations", 0) + 1

    def lookup(self, sig: tuple) -> Optional[int]:
        return self._index.get(sig)

    def insert_dropped(self, sig: tuple) -> int:
        self._index[sig] = DROPPED
        return DROPPED

    def _grow(self, R: int) -> None:
        if self._n < self._cap and R <= self._R:
            return
        cap = max(self.GROW_START, self._cap * 2, self._n + 1)
        Rc = max(R, self._R)

        def regrow(old, cols, dtype):
            new = np.zeros((cap, cols), dtype)
            if old is not None and self._n:
                new[: self._n, : old.shape[1]] = old[: self._n]
            return new

        self._compat = regrow(self._compat, self.T, bool)
        self._hard_t = regrow(self._hard_t, self.T, bool)
        self._zone = regrow(self._zone, self.Z, bool)
        self._hard_z = regrow(self._hard_z, self.Z, bool)
        self._capm = regrow(self._capm, self.C, bool)
        self._hard_c = regrow(self._hard_c, self.C, bool)
        self._req = regrow(self._req, Rc, np.float32)
        for name in ("_maxpn", "_spread", "_soft", "_dt", "_dz", "_dc"):
            old = getattr(self, name)
            dtype = np.int32 if name == "_maxpn" else bool
            new = np.zeros(cap, dtype)
            if old is not None and self._n:
                new[: self._n] = old[: self._n]
            setattr(self, name, new)
        self._cap = cap
        self._R = Rc

    def insert(self, sig: tuple, row) -> int:
        """Persist one computed group row (see encode._group_row); the
        row's arrays are COPIED into the columnar store."""
        R = len(row.req)
        self._grow(R)
        i = self._n
        self._compat[i] = row.compat
        self._hard_t[i] = row.hard_t
        self._zone[i] = row.zone
        self._hard_z[i] = row.hard_z
        self._capm[i] = row.capm
        self._hard_c[i] = row.hard_c
        self._req[i, :R] = row.req
        if R < self._R:
            self._req[i, R:] = 0.0
        self._maxpn[i] = row.max_per_node
        self._spread[i] = row.spread_zone
        self._soft[i] = row.spread_soft
        self._dt[i] = row.differs_t
        self._dz[i] = row.differs_z
        self._dc[i] = row.differs_c
        self._n = i + 1
        self._index[sig] = i
        return i

    @property
    def rows(self) -> int:
        return self._n

    def conflicts(self, key: tuple, build):
        """The conflict matrix for this exact row-id sequence, memoized
        (1-deep — reconciles repeat the same group set back to back).
        The memoized matrix is shared read-only across encodes: every
        consumer reads it (splits/rebuilds derive NEW matrices), and the
        write lock turns a future in-place mutation into a loud error
        instead of silent cross-solve corruption."""
        from ..obs.recompute import RECOMPUTE, fingerprint
        hit = self._conflict_memo
        if hit is not None and hit[0] == key:
            RECOMPUTE.classify("conflict", served=True)
            return hit[1]
        from ..obs.tracer import TRACER
        with TRACER.span("encode.conflicts", groups=len(key)):
            m = build()
        RECOMPUTE.classify("conflict", fingerprint(key))
        if m is not None:
            m.setflags(write=False)
        self._conflict_memo = (key, m)
        return m

    def gather(self, ids: List[int], R: int,
               arena: Optional[EncodeArena] = None) -> dict:
        """One vectorized gather of cached rows → fresh (never aliased)
        encode arrays, padded to R resource columns. The hard arrays are
        materialized only when some row's preferred narrowing actually
        changed that axis — byte-identical to the cold encoder's
        `(hard != work).any()` decision."""
        idx = np.asarray(ids, np.intp)
        G = len(ids)

        def out(name, cols, dtype, src):
            if arena is not None:
                buf = arena.take(name, (G, cols), dtype)
            else:
                buf = np.empty((G, cols), dtype)
            np.take(src[: self._n], idx, axis=0, out=buf)
            return buf

        compat = out("compat", self.T, bool, self._compat)
        zone = out("zone", self.Z, bool, self._zone)
        capm = out("capm", self.C, bool, self._capm)
        Rc = min(self._R, R)
        if arena is not None:
            req = arena.take("requests", (G, R), np.float32, zero=R > Rc)
        else:
            req = np.zeros((G, R), np.float32) if R > Rc \
                else np.empty((G, R), np.float32)
        req[:, :Rc] = self._req[: self._n, :Rc][idx]
        dt = self._dt[: self._n][idx]
        dz = self._dz[: self._n][idx]
        dc = self._dc[: self._n][idx]
        return {
            "requests": req, "compat": compat,
            "allow_zone": zone, "allow_cap": capm,
            "max_per_node": self._maxpn[: self._n][idx].copy(),
            "spread_zone": self._spread[: self._n][idx].copy(),
            "spread_soft": self._soft[: self._n][idx].copy(),
            "compat_hard": (out("hard_t", self.T, bool, self._hard_t)
                            if dt.any() else None),
            "zone_hard": (out("hard_z", self.Z, bool, self._hard_z)
                          if dz.any() else None),
            "cap_hard": (out("hard_c", self.C, bool, self._hard_c)
                         if dc.any() else None),
        }


class EncodeCache:
    """LRU of EncodeContexts keyed by the full encode token.

    A handful of contexts stay warm so clusters that alternate a few
    (NodePool, NodeClass) views per reconcile don't thrash — the same
    rationale as the facade's catalog-tensor LRU. Stats are shared
    across contexts (hits/misses/rotations/evictions) and mirrored into
    the package's metrics by the encoder."""

    MAX_CONTEXTS = 4

    def __init__(self, max_contexts: Optional[int] = None) -> None:
        self.max_contexts = max_contexts or self.MAX_CONTEXTS
        self._ctxs: "OrderedDict[tuple, EncodeContext]" = OrderedDict()
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "rotations": 0, "evictions": 0}

    def context(self, token: tuple, T: int, Z: int, C: int) -> EncodeContext:
        ctx = self._ctxs.get(token)
        if ctx is None:
            ctx = EncodeContext(token, T, Z, C, self.stats)
            self._ctxs[token] = ctx
            while len(self._ctxs) > self.max_contexts:
                self._ctxs.popitem(last=False)
                self.stats["evictions"] += 1
        else:
            self._ctxs.move_to_end(token)
        return ctx

    def context_for(self, cat, extra_requirements=None, taints=None,
                    template_labels=None) -> Optional[EncodeContext]:
        """The context for a facade-derived CatalogTensors view, or None
        when the view carries no cache token (direct encode_catalog
        callers own their invalidation and must key explicitly)."""
        if getattr(cat, "cache_token", None) is None:
            return None
        token = cat.cache_token + (
            requirements_token(extra_requirements),
            taints_token(taints),
            labels_token(template_labels))
        return self.context(token, cat.T, cat.Z, cat.C)

    @property
    def resident_rows(self) -> int:
        return sum(c.rows for c in self._ctxs.values())

    def hit_rate(self) -> float:
        seen = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / seen if seen else 0.0

    def snapshot(self) -> dict:
        """JSON-ready effectiveness view — the per-tenant encode-cache
        panel the fleet's /debug/fleet serves (and the queryable form of
        the ledger's encode_cold vs encode_cached split): per-context
        resident rows plus the shared hit/miss/rotation/eviction
        counters."""
        return {
            "hit_rate": round(self.hit_rate(), 4),
            "resident_rows": self.resident_rows,
            "contexts": len(self._ctxs),
            "stats": dict(self.stats),
        }
