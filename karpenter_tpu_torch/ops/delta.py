"""Delta plane: serve-and-verify memos for the steady-state reconcile (the
port's copy of `karpenter_tpu/ops/delta.py`, armed by default and switched
by the same environment variables).

The recompute observatory (obs/recompute.py) measured the headroom —
under the c16 regime the solve stage is ~95% redundant, affinity ~86%,
spread ~84%: most of every reconcile recomputes inputs that did not
change. This module SPENDS that headroom (ROADMAP item 3, the
CvxCluster thesis: reconcile cost should scale with the delta, not the
population). The fingerprints the ledger already computes per stage
become MEMO KEYS: an unchanged-input pass serves the prior output
instead of recomputing it, and the outcome meters as
`recompute_work_total{outcome="delta_served"}`.

Serving is never trusted, it is POLICED — the Gavel template of letting
measurement, not hope, govern the shortcut:

- **integrity oracle on every served solve** — a served SolveResult
  still flows through `facade.finish_solve` → `_verify_integrity`, so
  the PR 14 feasibility oracle validates each served placement exactly
  like a freshly dispatched one;
- **audit cadence** — every `audit_every`-th serve of a key is refused:
  the caller recomputes fresh and calls `confirm()` (fingerprints
  match) or `diverge()` (they don't). A divergence invalidates the
  entry AND opens a per-key cooldown during which re-memoization is
  declined — the warm path's never-wrong-twice ladder;
- **watchdog** — an entry that reached its audit cadence and never got
  a fresh confirm is reported by `stale()`; the `delta_staleness`
  invariant (obs/watchdog.py) pages when one lingers past a sim-time
  grace;
- **invalidation ladder** — every eviction meters
  `delta_invalidations_total{stage,reason}` with a reason from
  INVALIDATION_REASONS; `make obs-audit` asserts each reason is
  constructed by tests/test_delta.py.

No wall-clock anywhere: staleness is counted in serves-since-confirm,
and the watchdog applies its own sim-time grace — a memo must never
make a repeat-determinism contract time-dependent.

Opt-out: `KARPENTER_TPU_DELTA=0` disarms the plane process-wide (every
stage recomputes, byte-identical to the pre-delta pipeline);
`KARPENTER_TPU_DELTA_AUDIT` sets the audit cadence (0 = audit every
serve, i.e. the memo never serves).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..obs.recompute import (encoded_fingerprint, fingerprint,
                             fingerprint_bytes, fingerprint_fold)

# Memo domains — the four high-redundancy stages the c16 regime
# measured (docs/delta.md). Keys are namespaced (stage, *owner_key).
DOMAINS: Tuple[str, ...] = ("solve", "affinity", "spread", "optimizer")

# Why an entry left the memo. docs/delta.md documents the ladder;
# `make obs-audit` asserts every reason is constructed by
# tests/test_delta.py (the same canonical-test contract as the
# recompute taxonomy).
INVALIDATION_REASONS: Tuple[str, ...] = (
    "divergence",   # audit recompute disagreed with the stored output
    "epoch",        # same key re-stored under a NEW input fingerprint
    "quarantine",   # integrity violation quarantined the owning facade
    "capacity",     # LRU bound pushed the entry out
    "disarm",       # explicit force-cold / plane-wide invalidation
)

# serves allowed between fresh confirms (KARPENTER_TPU_DELTA_AUDIT
# overrides; 0 = every pass recomputes)
AUDIT_EVERY = 16
# stores declined after a divergence before the key may memoize again —
# the same never-wrong-twice constant as facade.FALLBACK_COOLDOWN
COOLDOWN = 8
# memo entries kept (LRU). Entries are host-cheap (a decoded result or
# a mask descriptor), but unbounded growth across facades/pools would
# still be a leak; evictions meter reason="capacity".
MAX_ENTRIES = 1024


class _Entry:
    __slots__ = ("fp", "value", "check_fp", "serves", "since_confirm",
                 "confirms")

    def __init__(self, fp: int, value: Any, check_fp: Optional[int]):
        self.fp = fp
        self.value = value
        self.check_fp = check_fp
        self.serves = 0          # lifetime serves of this entry
        self.since_confirm = 0   # serves since the last fresh confirm
        self.confirms = 0


class DeltaPlane:
    """Process-wide serve-and-verify memo store (singleton DELTA,
    /debug/delta route). Thread-safe; seed-deterministic — outcomes
    depend only on the call sequence, never on time or RNG."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        # internal key (stage, *key) -> _Entry, LRU-ordered
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # internal key -> stores still to decline (never-wrong-twice)
        self._cooldown: Dict[tuple, int] = {}
        self.stats = {
            "serves": 0, "misses": 0, "stores": 0, "confirms": 0,
            "divergences": 0, "audits_due": 0, "declined": 0,
        }
        self._invalidations: Dict[Tuple[str, str], int] = {}

    # --- knobs (read per call: tests flip the env mid-process) -------------
    @property
    def armed(self) -> bool:
        return os.environ.get("KARPENTER_TPU_DELTA", "1") != "0"

    @property
    def audit_every(self) -> int:
        try:
            return int(os.environ.get("KARPENTER_TPU_DELTA_AUDIT",
                                      str(AUDIT_EVERY)))
        except ValueError:
            return AUDIT_EVERY

    # --- the serve/verify protocol -----------------------------------------
    def serve(self, stage: str, key: tuple,
              fp: int) -> Optional[Tuple[Any, bool]]:
        """Try to serve `stage` work for `key` at input fingerprint
        `fp`. Returns None on a miss (no entry, fingerprint changed,
        plane disarmed) — the caller computes fresh and `store()`s.
        Returns (value, audit_due): audit_due=False is a clean serve
        (the caller uses the value and meters delta_served);
        audit_due=True means the cadence expired — the caller must
        recompute fresh and call `confirm()` or `diverge()`, NOT use
        the value."""
        if not self.armed:
            return None
        ik = (stage,) + tuple(key)
        with self._lock:
            ent = self._entries.get(ik)
            if ent is None or ent.fp != int(fp):
                self.stats["misses"] += 1
                return None
            self._entries.move_to_end(ik)
            if ent.since_confirm >= self.audit_every:
                self.stats["audits_due"] += 1
                self._meter(stage, "audit")
                return ent.value, True
            ent.serves += 1
            ent.since_confirm += 1
            self.stats["serves"] += 1
        self._meter(stage, "served")
        return ent.value, False

    def store(self, stage: str, key: tuple, fp: int, value: Any,
              check_fp: Optional[int] = None) -> bool:
        """Memoize freshly computed `stage` output. Declined (False)
        while the key's divergence cooldown is open or the plane is
        disarmed. Replacing an entry under a NEW fingerprint meters an
        `epoch` invalidation (the world moved; the old output is
        unservable by construction)."""
        if not self.armed:
            return False
        ik = (stage,) + tuple(key)
        with self._lock:
            cd = self._cooldown.get(ik, 0)
            if cd > 0:
                self._cooldown[ik] = cd - 1
                if cd == 1:
                    del self._cooldown[ik]
                self.stats["declined"] += 1
                return False
            prior = self._entries.pop(ik, None)
            if prior is not None and prior.fp != int(fp):
                self._count_invalidation(stage, "epoch")
            self._entries[ik] = _Entry(int(fp), value, check_fp)
            self.stats["stores"] += 1
            evicted: List[tuple] = []
            while len(self._entries) > self.max_entries:
                old_ik, _ = self._entries.popitem(last=False)
                evicted.append(old_ik)
            for old_ik in evicted:
                self._count_invalidation(old_ik[0], "capacity")
        self._meter(stage, "stored")
        return True

    def confirm(self, stage: str, key: tuple, fp: int,
                value: Any = None,
                check_fp: Optional[int] = None) -> None:
        """An audit recompute MATCHED the stored output: reset the
        serve-since-confirm counter (and refresh the stored value —
        the fresh copy is at least as good as the old one)."""
        ik = (stage,) + tuple(key)
        with self._lock:
            ent = self._entries.get(ik)
            if ent is None or ent.fp != int(fp):
                return
            ent.since_confirm = 0
            ent.confirms += 1
            if value is not None:
                ent.value = value
            if check_fp is not None:
                ent.check_fp = check_fp
            self.stats["confirms"] += 1
        self._meter(stage, "confirmed")

    def diverge(self, stage: str, key: tuple) -> None:
        """An audit recompute DISAGREED with the stored output: drop
        the entry (reason `divergence`) and open the never-wrong-twice
        cooldown — the next COOLDOWN stores for this key are declined,
        so a systematically wrong shortcut cannot re-arm itself."""
        ik = (stage,) + tuple(key)
        with self._lock:
            self._entries.pop(ik, None)
            self._cooldown[ik] = COOLDOWN
            self.stats["divergences"] += 1
            self._count_invalidation(stage, "divergence")

    def invalidate(self, prefix: tuple = (), *,
                   reason: str = "disarm") -> int:
        """Drop every entry whose internal key starts with `prefix`
        (empty prefix = the whole plane). The facade's integrity
        quarantine calls this with reason="quarantine"; bench cold
        phases and force_cold hooks use reason="disarm"."""
        assert reason in INVALIDATION_REASONS, reason
        p = tuple(prefix)
        n = len(p)
        with self._lock:
            victims = [ik for ik in self._entries if ik[:n] == p]
            for ik in victims:
                del self._entries[ik]
                self._count_invalidation(ik[0], reason)
        return len(victims)

    # --- read side ----------------------------------------------------------
    def stale(self) -> List[Tuple[str, tuple, int]]:
        """Entries that reached their audit cadence and have NOT been
        freshly confirmed — `serve()` refuses them, but one lingering
        means the owning loop stopped closing its audit contract. The
        watchdog's `delta_staleness` invariant feeds on this (the
        sim-time grace lives there, not here)."""
        out: List[Tuple[str, tuple, int]] = []
        with self._lock:
            cadence = self.audit_every
            for ik, ent in self._entries.items():
                if ent.since_confirm >= cadence:
                    out.append((ik[0], ik[1:], ent.since_confirm))
        return out

    def entries(self, stage: Optional[str] = None) -> int:
        with self._lock:
            if stage is None:
                return len(self._entries)
            return sum(1 for ik in self._entries if ik[0] == stage)

    def snapshot(self) -> dict:
        with self._lock:
            per_stage: Dict[str, int] = {}
            for ik in self._entries:
                per_stage[ik[0]] = per_stage.get(ik[0], 0) + 1
            inval = {}
            for (st, reason), n in sorted(self._invalidations.items()):
                inval.setdefault(st, {})[reason] = n
            return {
                "armed": self.armed,
                "audit_every": self.audit_every,
                "entries": len(self._entries),
                "per_stage": per_stage,
                "cooldowns": len(self._cooldown),
                "invalidations": inval,
                "domains": list(DOMAINS),
                "reasons": list(INVALIDATION_REASONS),
                **self.stats,
            }

    def payload(self, query: str = "") -> dict:
        return self.snapshot()

    def reset(self) -> None:
        """Test/bench hook: forget everything WITHOUT metering — a
        reset models a fresh process, not an invalidation event."""
        with self._lock:
            self._entries.clear()
            self._cooldown.clear()
            for k in self.stats:
                self.stats[k] = 0
            self._invalidations.clear()

    # --- metering -----------------------------------------------------------
    def _count_invalidation(self, stage: str, reason: str) -> None:
        # under self._lock
        key = (stage, reason)
        self._invalidations[key] = self._invalidations.get(key, 0) + 1
        from ..metrics import DELTA_INVALIDATIONS
        DELTA_INVALIDATIONS.inc(stage=stage, reason=reason)

    def _meter(self, stage: str, event: str) -> None:
        from ..metrics import DELTA_MEMO
        DELTA_MEMO.inc(stage=stage, event=event)


# --- fingerprint / copy helpers for the solve memo --------------------------
# The ledger's solve fingerprint (encoded_fingerprint) deliberately
# digests only the request/compat/zone/cap rows — enough to meter
# redundancy, NOT enough to key a memo: max_per_node, conflict
# matrices, spread flags, and the hard-row fallbacks all change solver
# output without changing those rows. The memo key digests everything
# the solver reads.
_ENC_MEMO_ATTRS: Tuple[str, ...] = (
    "max_per_node", "spread_zone", "conflict", "spread_soft",
    "compat_hard", "zone_hard", "cap_hard", "zone_conflict",
)


# fingerprint(dtype, shape) by (dtype, shape): a handful of layouts recur
# on every solve (one per node mask and request width)
_layout_fp: Dict[tuple, int] = {}


def _array_fp(arr) -> int:
    if arr is None:
        return 0x9E3779B97F4A7C15
    import numpy as np
    a = np.ascontiguousarray(arr)
    key = (a.dtype.str, a.shape)
    lfp = _layout_fp.get(key)
    if lfp is None:
        if len(_layout_fp) >= 4096:
            _layout_fp.clear()
        lfp = _layout_fp[key] = fingerprint(a.dtype.str, a.shape)
    return fingerprint_bytes(a.tobytes()) ^ lfp


def solve_memo_fingerprint(enc, *extra) -> int:
    """The solve-memo key fingerprint: the ledger's encoded content
    digest folded with every remaining solver-visible encoding field
    plus caller context (catalog key, backend, gating flags)."""
    parts = [encoded_fingerprint(enc)]
    parts.extend(_array_fp(getattr(enc, name, None))
                 for name in _ENC_MEMO_ATTRS)
    if extra:
        parts.append(fingerprint(*extra))
    return fingerprint_fold(parts)


def group_terms_fingerprint(enc) -> int:
    """Digest of the per-group scheduling-constraint identity (each
    group representative's constraint signature, in encoding order):
    the occupancy signature the affinity/spread memos key on is
    zone+count only, so the group side must carry the selector
    semantics that decide what those occupants match. Signatures are
    name-free — same-signature pod churn keeps the memo warm."""
    return fingerprint(*[repr(g.representative.constraint_signature())
                         for g in getattr(enc, "groups", ())])


def solve_result_fingerprint(result) -> int:
    """Content digest of a SolveResult — the audit comparator AND the
    stored check fingerprint a divergence is judged against. Covers
    everything commit consumes: launches, unschedulable counts, and
    each virtual node's identity, masks, cumulative load, and
    placement maps."""
    parts: list = [tuple(tuple(l) for l in result.launches),
                   tuple(sorted(result.unschedulable.items()))]
    for n in result.nodes:
        parts.append((
            n.existing_name, int(n.type_idx),
            _array_fp(n.zone_mask), _array_fp(n.cap_mask),
            _array_fp(n.cum),
            tuple(sorted(n.pods_by_group.items())),
            tuple(sorted(n.prior_by_group.items())),
            _array_fp(n.banned_groups),
        ))
    return fingerprint(*parts)


def existing_context_fingerprint(existing) -> int:
    """Content digest of the standing-fleet context a solve consumes —
    the prepared VirtualNodes AFTER attach_existing_context populated
    prior_by_group (resident pods mapped onto the current enc's groups)
    and banned_groups (resident anti-affinity bans). Everything the
    packer reads off an existing node is covered, including its name
    (the memoized result's existing_placements reference it), so an
    unchanged-fingerprint serve replays against a byte-identical
    cluster context. Deliberately order-SENSITIVE: the packer walks the
    node list in order, so a reordered context is a different input
    even when the set matches."""
    if not existing:
        return 0
    return fingerprint(*[
        (vn.existing_name or "", int(vn.type_idx),
         _array_fp(vn.zone_mask), _array_fp(vn.cap_mask),
         _array_fp(vn.cum),
         tuple(sorted(vn.pods_by_group.items())),
         tuple(sorted(vn.prior_by_group.items())),
         _array_fp(vn.banned_groups))
        for vn in existing])


def copy_spread_constraints(cons):
    """Independent copy of a facade _spread_constraints() output
    (Dict[group idx -> List[SpreadConstraintCounts]] or None): the
    spread split water-fills against the counts vectors, so the memo
    must never hand out its own arrays."""
    if cons is None:
        return None
    from .binpack import SpreadConstraintCounts
    return {gi: [SpreadConstraintCounts(counts=c.counts.copy(),
                                        max_skew=c.max_skew,
                                        self_matches=c.self_matches,
                                        soft=c.soft)
                 for c in lst]
            for gi, lst in cons.items()}


def spread_constraints_fingerprint(cons) -> int:
    """Content digest of a _spread_constraints() output — the spread
    memo's audit comparator."""
    if cons is None:
        return 0x9E3779B97F4A7C15
    parts = []
    for gi in sorted(cons):
        for c in cons[gi]:
            parts.append((gi, _array_fp(c.counts), int(c.max_skew),
                          bool(c.self_matches), bool(c.soft)))
    return fingerprint(*parts)


def copy_solve_result(result):
    """Independent copy of a SolveResult: the memo must never alias
    node objects the caller goes on to mutate (bind/commit extends
    pods_by_group in place)."""
    from ..state.cluster import copy_virtual_node
    from .binpack import SolveResult
    return SolveResult(
        nodes=[copy_virtual_node(n) for n in result.nodes],
        unschedulable=dict(result.unschedulable),
        launches=[tuple(l) for l in result.launches])


# THE process-wide plane.
DELTA = DeltaPlane()

from ..obs.exposition import register_debug_route  # noqa: E402 (after DELTA)

register_debug_route("/debug/delta",
                     lambda plane, query: plane.payload(query),
                     owner=DELTA)
