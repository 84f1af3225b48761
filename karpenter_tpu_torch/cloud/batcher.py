"""Cross-controller wire-call coalescing — the reference's batcher.

The port's own copy of `karpenter_tpu/cloud/batcher.py`, semantics unchanged.

Reference: pkg/batcher/batcher.go:32-84 runs a generic Batcher[T, U] with
per-hash buckets and an idle/max-window trigger, instantiated for
CreateFleet (createfleet.go:47), DescribeInstances (describeinstances.go:50)
and TerminateInstances (terminateinstances.go:49); N goroutines' requests
fan into one wire call.

Our controllers are synchronous reconcilers on one event loop, so the same
coalescing inverts: `BatchingCloud` wraps the CloudProvider and

- **terminate** accumulates instance ids (fire-and-forget — no caller
  consumes a result) and a runtime flusher task sends ONE wire call per
  idle/max window for every controller's terminations combined
  (termination + GC + lifecycle reap within a window share the call);
  retryable cloud errors keep the batch pending for the next window.
- **describe** coalesces reads: calls with equal filters inside one idle
  window share a single wire sweep (the reference hashes DescribeInstances
  by filter set the same way). The cache invalidates whenever a
  termination batch flushes, so post-write reads never serve pre-write
  state beyond the window.
- **create_fleet** passes through — the provisioner already aggregates a
  whole reconcile's launches into one call (the natural batch; the
  reference's one-bucket CreateFleet batcher exists because its callers
  are per-claim goroutines, ours is already a list API) — and records the
  batch size on the same metric family.

Every other CloudProvider method delegates untouched. The deterministic
sim engine keeps the raw cloud (single sequential reconciler — nothing to
coalesce); the async runtime (main.build_operator) wraps the cloud and
registers `flusher()` as a high-frequency controller.
"""

from __future__ import annotations

from typing import List, Optional

from ..metrics import BATCH_SIZE, DEGRADED_MODE
from ..obs.tracer import NOOP_SPAN, TRACER
from .provider import CloudError

DEFAULT_IDLE = 0.100   # reference: 100ms idle window
DEFAULT_MAX = 1.0      # reference: 1s max window
DEFAULT_MAX_ITEMS = 500


class BatchingCloud:
    """CloudProvider wrapper coalescing wire calls across controllers."""

    def __init__(self, inner, clock, idle: float = DEFAULT_IDLE,
                 max_window: float = DEFAULT_MAX,
                 max_items: int = DEFAULT_MAX_ITEMS,
                 rng: Optional[object] = None):
        self.inner = inner
        self.clock = clock
        self.idle = idle
        self.max_window = max_window
        self.max_items = max_items
        # full-jitter source: N batchers doubling a deterministic backoff
        # retry in LOCKSTEP and re-hammer the throttled cloud together;
        # uniform(0, backoff) desynchronizes them (AWS full-jitter). The
        # default is entropy-seeded — a fixed default seed would put every
        # replica back in lockstep, the exact failure mode jitter exists
        # to prevent. Determinism is opt-in: tests (and any harness that
        # needs a replayable run, e.g. one driven by a faults.FaultPlan)
        # pass a seeded Random.
        import random
        self._rng = rng if rng is not None else random.Random()  # graftlint: disable=unseeded-rng -- full-jitter MUST be entropic across replicas (a fixed seed puts every backoff in lockstep); deterministic harnesses pass a seeded Random
        self._pending: List[str] = []      # terminate ids, insertion order
        self._pending_set: set = set()
        self._first_at = 0.0
        self._last_add = 0.0
        self._retry_after = 0.0            # throttle backoff gate
        self._backoff = 0.0                # current exponential ceiling
        # describe read-coalescing: filter-key -> result within one window
        from ..utils.cache import TTLCache
        self._describe_cache = TTLCache(idle, clock)
        self.stats = {"terminate_batches": 0, "terminate_items": 0,
                      "largest_batch": 0, "describe_calls": 0,
                      "describe_coalesced": 0, "terminate_errors": 0}

    # --- terminate: windowed write coalescing ---
    def terminate(self, instance_ids: List[str]) -> None:
        now = self.clock.now()
        if not self._pending:
            self._first_at = now
        for iid in instance_ids:
            if iid not in self._pending_set:
                self._pending.append(iid)
                self._pending_set.add(iid)
        self._last_add = now
        if len(self._pending) >= self.max_items and now >= self._retry_after:
            self._flush_terminations()

    def flush(self, now: Optional[float] = None) -> None:
        """Send the pending termination batch when its window has closed
        (idle since last add, or max window since first add). A throttled
        flush backs off exponentially — retrying every window would
        amplify the very throttling it hit."""
        if not self._pending:
            return
        now = self.clock.now() if now is None else now
        if now < self._retry_after:
            return
        if (now - self._last_add >= self.idle
                or now - self._first_at >= self.max_window):
            self._flush_terminations()

    def _note_throttle(self, err: Optional[CloudError] = None) -> None:
        """Raise the retry gate. The exponential CEILING doubles
        deterministically (idle..30s); the actual delay is full-jitter —
        uniform(0, ceiling) — so N batchers that throttled together don't
        retry in lockstep and re-trigger the very throttling they hit.
        The draw is floored at a tenth of the ceiling: a ~0 draw would
        leave the gate at `now`, and _flush_per_id's requeue relies on a
        genuinely-raised gate to stop terminate()'s max_items check from
        re-flushing in the same pass. A server-provided Retry-After hint
        (HTTP 429, cloud/remote.py) floors it higher still: the server
        knows its own recovery time better than our local guess."""
        now = self.clock.now()
        self._backoff = min(max(self._backoff * 2, self.idle), 30.0)
        delay = max(self._rng.uniform(0.0, self._backoff),
                    0.1 * self._backoff)
        hint = getattr(err, "retry_after", None)
        if hint:
            delay = max(delay, float(hint))
        self._retry_after = max(self._retry_after, now + delay)
        DEGRADED_MODE.set(1, component="cloud-api")

    def _clear_backoff(self) -> None:
        if self._backoff or self._retry_after:
            DEGRADED_MODE.set(0, component="cloud-api")
        self._backoff = 0.0
        self._retry_after = 0.0

    def _flush_terminations(self) -> None:
        batch, self._pending = self._pending, []
        self._pending_set = set()
        touched = False  # anything reached the wire (reads must resync)
        try:
            # a batch can exceed the wire cap when items accrued behind a
            # closed backoff gate — ship it in max_items chunks so the cap
            # is a real wire invariant and nothing enqueued during the
            # backoff is starved past it once the gate opens
            for lo in range(0, len(batch), self.max_items):
                chunk = batch[lo:lo + self.max_items]
                sp = (TRACER.span("cloud.terminate", batch=len(chunk))
                      if TRACER.enabled else NOOP_SPAN)
                try:
                    with sp:
                        self.inner.terminate(chunk)  # ONE wire call
                except CloudError as e:
                    self.stats["terminate_errors"] += 1
                    if getattr(e, "retryable", False):
                        # keep the failed chunk AND the untouched remainder
                        # for a later window — the callers that fired these
                        # already moved on, the flusher owns the retry. A
                        # partial-batch success resets nothing: chunks sent
                        # before this failure stay sent, the backoff grows
                        # from the failure, and only a fully-flushed batch
                        # clears it.
                        self._pending = batch[lo:]
                        self._pending_set = set(self._pending)
                        now = self.clock.now()
                        self._first_at = self._last_add = now
                        self._note_throttle(e)
                        return
                    touched = True
                    if self._flush_per_id(chunk,
                                          batch[lo + self.max_items:]):
                        return  # per-id retry raised the gate and requeued
                    continue  # chunk drained id-by-id; keep flushing
                touched = True
                BATCH_SIZE.observe(float(len(chunk)), op="terminate")
                self.stats["terminate_batches"] += 1
                self.stats["terminate_items"] += len(chunk)
                self.stats["largest_batch"] = max(self.stats["largest_batch"],
                                                  len(chunk))
            self._clear_backoff()
        finally:
            if touched:
                self._describe_cache.flush()  # reads must see the writes

    def _flush_per_id(self, chunk: List[str], rest: List[str]) -> bool:
        """Non-retryable chunk error: one bad id must not poison (and
        silently drop) the rest — fall back to per-id calls, letting
        individually-bad ids fail alone; a per-id RETRYABLE failure
        requeues the chunk remainder plus every unsent later chunk behind
        a raised gate (the GC sweep remains the final backstop for
        anything that still leaks). Returns True when it requeued — the
        caller must stop flushing."""
        for n, iid in enumerate(chunk):
            try:
                self.inner.terminate([iid])
            except CloudError as pe:
                self.stats["terminate_errors"] += 1
                if getattr(pe, "retryable", False):
                    # raise the gate BEFORE requeueing: a full-size
                    # remainder would otherwise trip terminate()'s
                    # max_items immediate-flush check against the
                    # still-cleared gate and re-hit the throttling
                    # cloud in the same tick; wiping the gate after
                    # would re-flush every half-idle tick — both are
                    # the amplification the backoff exists to prevent
                    self._note_throttle(pe)
                    self.terminate(chunk[n:] + rest)  # requeue remainder
                    return True
        return False

    # --- describe: windowed read coalescing ---
    def describe(self, instance_ids: Optional[List[str]] = None) -> list:
        key = ("all",) if instance_ids is None else tuple(sorted(instance_ids))
        hit = self._describe_cache.get(key)
        if hit is not None:
            self.stats["describe_coalesced"] += 1
            return hit
        sp = (TRACER.span("cloud.describe",
                          ids="all" if instance_ids is None
                          else len(instance_ids))
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            result = self.inner.describe(instance_ids)
        self._describe_cache.set(key, result)
        self.stats["describe_calls"] += 1
        return result

    # --- create_fleet: natural per-reconcile batch, metered ---
    def create_fleet(self, requests: list) -> list:
        BATCH_SIZE.observe(float(len(requests)), op="create_fleet")
        sp = (TRACER.span("cloud.create_fleet", requests=len(requests))
              if TRACER.enabled else NOOP_SPAN)
        try:
            with sp:
                return self.inner.create_fleet(requests)
        finally:
            self._describe_cache.flush()  # reads must see the new instances

    def shutdown(self) -> None:
        """Clean-stop flush: a queued termination batch whose idle/max
        window never closed must not die with the process — a clean stop
        that dropped it would leak every instance in it until the NEXT
        process's GC sweep. Ship it now, ignoring the window and any
        backoff gate (this is the last wire call this process gets; if
        the cloud still throttles it, the cross-restart GC sweep remains
        the backstop). Registered as a runtime stop hook by
        main.build_operator; idempotent — a drained batcher is a no-op."""
        if not self._pending:
            return
        self._retry_after = 0.0
        self._flush_terminations()

    def flusher(self):
        """A controller driving the window clock — register with the
        runtime (or engine) alongside the real controllers."""
        outer = self

        class _Flusher:
            name = "cloud.batcher.flush"

            def reconcile(self, now: float) -> float:
                outer.flush(now)
                return outer.idle / 2

        return _Flusher()

    def __getattr__(self, name: str):
        return getattr(self.inner, name)
