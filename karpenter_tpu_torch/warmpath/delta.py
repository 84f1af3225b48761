"""DeltaTracker: classify cluster change since the last committed solve.

Subscribes to the store's watch feed (state/store.py `_notify`) and
folds every event into one of two buckets:

- *warm-compatible*: a plain pod arrival (Pending, unbound,
  un-nominated), a pending never-nominated pod deleted before it was
  placed, or a nominated pod binding onto its nominated claim's node
  (the BindingController's steady-state work — it moves a pod from
  "nominated" to "bound" on the same node, so no headroom changes).
- *dirty*: everything else — claim/node lifecycle, un-nominations,
  unbinds, daemonset/PDB/NodePool/NodeClass/PVC changes. The FIRST
  dirty reason is kept (it names what broke the warm window).

Catalog-side change (ICE marks + expiry, pricing, reservations,
overlays) is deliberately NOT event-fed: the WarmPathEngine compares
`catalog.epoch` against the committed epoch at classify time, which
also prunes expired ICE marks — a TTL lapse bumps the epoch exactly
like a fresh mark does.

The tracker starts dirty ("uncommitted"): until a cold solve commits a
ledger there is nothing to admit against.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from ..models import labels as L
from ..state.store import Store

WATCHED_KINDS = ("pod", "nodeclaim", "node", "daemonset", "pdb",
                 "nodepool", "nodeclass", "pvc")


class DeltaTracker:
    def __init__(self, store: Store):
        self.store = store
        self._dirty: Optional[str] = "uncommitted"
        self._ignore = 0
        self.stats = {"events": 0, "dirty_marks": 0}
        for kind in WATCHED_KINDS:
            store.watch(kind, self._handler(kind))

    # --- classification state ---
    @property
    def dirty(self) -> Optional[str]:
        """The first dirty reason since the last clear(), or None."""
        return self._dirty

    def mark_dirty(self, reason: str) -> None:
        self.stats["dirty_marks"] += 1
        if self._dirty is None:
            self._dirty = reason

    def clear(self) -> None:
        """A cold solve just committed a fresh ledger — the baseline."""
        self._dirty = None

    @contextmanager
    def ignoring(self):
        """Suppress events for the warm path's OWN store mutations
        (nominations of warm-admitted pods) — they are part of the
        ledger, not drift from it."""
        self._ignore += 1
        try:
            yield
        finally:
            self._ignore -= 1

    # --- event feed ---
    def _handler(self, kind: str):
        def on_event(action: str, obj) -> None:
            if self._ignore:
                return
            self.stats["events"] += 1
            if kind == "pod":
                self._on_pod(action, obj)
            else:
                # claims/nodes appearing or vanishing, daemonset/PDB/
                # NodePool/NodeClass/PVC updates: all change the headroom
                # or constraint picture — cold
                self.mark_dirty(f"{kind}-{action}")
        return on_event

    def _on_pod(self, action: str, pod) -> None:
        if action == "add":
            if (pod.phase == "Pending" and pod.node_name is None
                    and L.NOMINATED not in pod.annotations):
                return  # a plain arrival — exactly what the warm path is for
            self.mark_dirty("pod-add-nonpending")
        elif action == "bind":
            # a nominated pod landing on its claim's node: the claim
            # already accounted for it (NodeView counts nominated pods),
            # so the ledger's headroom is unchanged
            if pod.annotations.get(L.NOMINATED):
                return
            self.mark_dirty("pod-bind")
        elif action == "delete":
            if pod.node_name is None and L.NOMINATED not in pod.annotations:
                return  # a pending arrival withdrawn before placement
            self.mark_dirty("pod-delete")
        else:
            # unbind (eviction returns capacity), unnominate (ledger
            # resident vanishes), replace (mutation), nominate (someone
            # other than the warm path placed a pod), future actions
            self.mark_dirty(f"pod-{action}")
