"""Interruption controller: queue consumer → graceful drain ahead of
capacity loss.

The port's own copy of `karpenter_tpu/controllers/interruption.py`,
unchanged in semantics.

Reference: pkg/controllers/interruption/controller.go:62-139 — long-polls
the SQS queue in 10-message batches, parses raw EventBridge JSON into
typed messages (parser.go + messages/*), maps instance → NodeClaim via
the provider-id index, deletes the NodeClaim (triggering graceful drain)
and marks the offering unavailable on spot interrupts so the next Solve
avoids the reclaimed pool.

The queue hands this controller RAW BYTES: cloud/messages.py owns the
parse (per-kind schemas, unknown-kind → no-op). Garbage payloads are
counted and DELETED — a poison message must not wedge the queue — and
duplicate deliveries (at-least-once queues redeliver) are dropped via a
bounded id window.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict

from ..catalog.provider import CatalogProvider
from ..cloud import messages as wire
from ..state.store import Store
from .termination import TerminationController

ACTIONABLE = {wire.SPOT_INTERRUPTION, wire.SCHEDULED_CHANGE,
              wire.STATE_CHANGE}
# rebalance recommendations are observability-only by default, like the
# reference (it deletes only for actionable kinds)

DEDUPE_WINDOW = 4096  # recent message ids remembered for duplicate drops


@dataclass
class InterruptionController:
    store: Store
    cloud: object
    catalog: CatalogProvider
    termination: TerminationController
    name: str = "interruption"
    requeue: float = 0.5
    batch_size: int = 10
    stats: Dict[str, int] = field(default_factory=dict)
    _seen_ids: deque = field(default_factory=lambda: deque(maxlen=DEDUPE_WINDOW))
    _seen_set: set = field(default_factory=set)

    def reconcile(self, now: float) -> float:
        from ..metrics import INTERRUPTION_MESSAGES, INTERRUPTION_PARSE_FAILURES
        # metric increments batch per drain, not per message — the
        # label-key build cost is visible at the 15k-message benchmark
        kind_counts: Dict[str, int] = {}
        parse_failures = 0
        try:
            while True:
                batch = self.cloud.poll_interruptions(self.batch_size)
                if not batch:
                    return self.requeue
                parsed = []
                want: list = []
                for raw in list(batch):
                    try:
                        msg = wire.parse(raw)
                    except wire.ParseError:
                        # poison message: count it, ack it, move on —
                        # never crash the consumer or wedge the queue head
                        self.stats["parse-failed"] = (
                            self.stats.get("parse-failed", 0) + 1)
                        parse_failures += 1
                        self.cloud.delete_message(raw)
                        continue
                    parsed.append((raw, msg))
                    if (msg.kind in ACTIONABLE
                            and not (msg.metadata.id
                                     and msg.metadata.id in self._seen_set)):
                        want.extend(msg.instance_ids)
                # ONE store-index pass resolves the whole batch's claims
                # (instead of a per-message lookup — and, for unknown
                # instances, a per-message full-claims scan)
                claims = (self.store.nodeclaims_by_instance_ids(want)
                          if want else {})
                for raw, msg in parsed:
                    if msg.metadata.id and msg.metadata.id in self._seen_set:
                        self.stats["duplicate"] = (
                            self.stats.get("duplicate", 0) + 1)
                    else:
                        # handle FIRST, register in the dedupe window only
                        # on success: a raising _handle leaves the message
                        # undeleted for redelivery, and that redelivery
                        # must not be swallowed as a "duplicate"
                        self._handle(msg, now, claims)
                        if msg.metadata.id:
                            self._register(msg.metadata.id)
                        self.stats[msg.kind] = self.stats.get(msg.kind, 0) + 1
                        kind_counts[msg.kind] = kind_counts.get(msg.kind, 0) + 1
                    self.cloud.delete_message(raw)
                if len(batch) < self.batch_size:
                    return self.requeue
        finally:
            for kind, n in kind_counts.items():
                INTERRUPTION_MESSAGES.inc(n, kind=kind)
            if parse_failures:
                INTERRUPTION_PARSE_FAILURES.inc(parse_failures)

    def _register(self, msg_id: str) -> None:
        if msg_id in self._seen_set:
            return
        if len(self._seen_ids) == self._seen_ids.maxlen:
            self._seen_set.discard(self._seen_ids[0])
        self._seen_ids.append(msg_id)
        self._seen_set.add(msg_id)

    def _handle(self, msg: wire.ParsedMessage, now: float,
                claims: Dict[str, object]) -> None:
        """`claims` is the drain batch's pre-resolved instance-id →
        NodeClaim map (store.nodeclaims_by_instance_ids). Resolution by
        instance id is equivalent to the old per-message envelope-pid
        walk: provider ids end in the instance id, and the pid path only
        added a full-pid verification before falling back to the same
        id index."""
        if msg.kind not in ACTIONABLE:
            return
        for iid in msg.instance_ids:
            claim = claims.get(iid)
            if claim is None:
                continue
            if msg.kind == wire.SPOT_INTERRUPTION and claim.instance_type:
                # the reclaimed pool will be tight for a while — offering
                # facts come from the CLAIM (the wire carries only ids)
                self.catalog.unavailable.mark_unavailable(
                    claim.instance_type, claim.zone or "",
                    claim.capacity_type or "spot",
                    reason="spot-interrupted")
            self.store.record_event("nodeclaim", claim.name, "Interrupted",
                                    msg.kind)
            self.termination.delete_nodeclaim(claim, now, msg.kind)

