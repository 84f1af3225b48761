"""Garbage collection: leaked-instance reaper.

The port's own copy of `karpenter_tpu/controllers/gc.py`, unchanged in
semantics.

Reference: pkg/controllers/nodeclaim/garbagecollection/controller.go:41-112
— a 2-minute polling sweep terminating cloud instances whose NodeClaim is
gone (launch raced a crash, claim deleted out-of-band), and dropping node
objects whose instance is gone.

Two gates protect live capacity from the sweep:

- `store.hydrated`: a freshly restarted operator must adopt its fleet
  (state/rehydrate) before anything is reaped.
- the provisioning intent journal: an instance whose launch intent is
  still OPEN is in flight, not leaked — the launch may be queued in a
  batcher window, or its commit simply hasn't landed yet. MIN_AGE alone
  cannot cover this (a throttle backoff can hold a launch open well past
  30s); the journal gate is exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..models import labels as L
from ..state.store import Store

SWEEP_INTERVAL = 120.0
MIN_AGE = 30.0  # don't reap instances still racing their claim creation
# how long an OPEN intent shields its instance from the sweep. Normal
# commits resolve within one reconcile and restarts replay at boot, so
# any intent still open this long is wedged (a bug, not an in-flight
# launch) — past the window the sweep's ordinary rules resume, keeping
# the pre-journal bounded-leak guarantee instead of an unbounded shield
INTENT_GRACE = 900.0


@dataclass
class GarbageCollectionController:
    store: Store
    cloud: object
    # optional state.journal.IntentJournal — the in-flight grace gate:
    # instances whose launch intent is still open are never reaped
    journal: Optional[object] = None
    name: str = "gc"
    requeue: float = SWEEP_INTERVAL
    stats: Dict[str, int] = field(default_factory=lambda: {
        "instances_reaped": 0, "nodes_reaped": 0, "inflight_skipped": 0})

    def reconcile(self, now: float) -> float:
        if not self.store.hydrated:
            # cold store: a freshly restarted operator has not adopted its
            # fleet yet — reaping now would terminate every live instance.
            # The reference GC only trusts the durable store's NodeClaim
            # list (controller.go:55-112); ours is trustworthy only after
            # state.rehydrate ran.
            return self.requeue
        claimed = {c.provider_id for c in self.store.nodeclaims.values()
                   if c.provider_id}
        open_tokens: Dict[str, float] = {}
        open_claims: Dict[str, float] = {}
        if self.journal is not None:
            for intent in self.journal.open_intents():
                open_tokens[intent.token] = intent.created_at
                open_claims[intent.claim_name] = intent.created_at
        for inst in self.cloud.describe():
            if inst.provider_id in claimed:
                continue
            if open_tokens or open_claims:
                opened_at = open_tokens.get(
                    inst.tags.get(L.TAG_LAUNCH_TOKEN, ""),
                    open_claims.get(inst.tags.get(L.TAG_NODECLAIM, "")))
                if opened_at is not None and now - opened_at < INTENT_GRACE:
                    # launch intent still open and inside its grace
                    # window: the commit (or the restart replay) owns
                    # this instance's fate, not the sweep — reaping here
                    # is the crash-window race this gate exists to close
                    self.stats["inflight_skipped"] += 1
                    continue
            if now - inst.launch_time < MIN_AGE:
                continue
            self.cloud.terminate([inst.id])
            self.stats["instances_reaped"] += 1
            self.store.record_event("instance", inst.id, "GarbageCollected",
                                    "no NodeClaim")
        live = {i.provider_id for i in self.cloud.describe()}
        for node in list(self.store.nodes.values()):
            if node.provider_id not in live:
                self.store.delete_node(node.name)
                self.stats["nodes_reaped"] += 1
        return self.requeue
