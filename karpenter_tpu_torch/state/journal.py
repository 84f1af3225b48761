"""Provisioning intent journal: the write-ahead log of the launch path.

The port's own copy of `karpenter_tpu/state/journal.py`, unchanged in
semantics.

The reference survives operator crashes because its durable state is the
Kubernetes API — NodeClaims are written *before* CreateFleet, so a crash
between the cloud call and the status commit leaves a durable record the
GC can reconcile against (reference pkg/controllers/nodeclaim/
garbagecollection/controller.go). Our Store is process-local, so the
same discipline needs an explicit intent log: `Provisioner._launch`
opens one `LaunchIntent` per request BEFORE the CreateFleet wire call
and resolves it after the result commits. The journal is the Borg/Omega
intent-log idiom (PAPERS.md): every state the process can die in is
recoverable from (journal, cloud) alone —

- intent open + no instance carrying its token  → the crash landed
  before the wire call; nothing launched; the intent aborts and the
  re-listed pods simply re-solve.
- intent open + a live token-tagged instance    → the crash landed
  after the wire call but before the commit; restart ADOPTS the
  instance (`state/rehydrate.replay_intents`) and marks the intent
  committed — no double launch (the idempotency token dedupes any
  replayed CreateFleet as well).
- intent open + claim unrecoverable             → the instance is
  reaped immediately instead of waiting out the GC sweep.

While an intent is open, the GC sweep MUST NOT reap its instance (the
launch may still be in flight in a batcher window, or the commit may
simply not have happened yet): `controllers/gc.py` gates on
`open_tokens()`/`open_claim_names()`.

The journal is append-only: opens and resolutions are appended to
`records` (and, when a path is given, fsync'd as JSON lines BEFORE the
wire call they protect), never rewritten. `IntentJournal(path=...)`
replays an existing file on construction, so a restarted operator
resumes with its predecessor's open intents — the sim passes the
journal OBJECT across restarts instead (faults/runner.RestartRunner).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, FrozenSet, List, Optional

OPEN = "open"
COMMITTED = "committed"
ABORTED = "aborted"   # the launch never produced an instance
REAPED = "reaped"     # restart replay terminated an unadoptable instance


def launch_token(claim_name: str, pool_fingerprint: str,
                 attempt: int) -> str:
    """Deterministic idempotency token for one launch attempt: a replay
    of the SAME (claim, pool config, attempt) — e.g. a crash-restart
    re-sending a journaled request — maps to the same token and dedupes
    cloud-side; a genuinely new attempt (new claim name, or a bumped
    attempt counter) mints a new one."""
    h = hashlib.sha256(
        f"{claim_name}|{pool_fingerprint}|{attempt}".encode())
    return h.hexdigest()[:32]


@dataclass
class LaunchIntent:
    seq: int
    claim_name: str
    nodepool: str
    node_class: str
    token: str
    attempt: int
    created_at: float
    status: str = OPEN
    provider_id: str = ""
    resolved_at: Optional[float] = None


class IntentJournal:
    """Append-only provisioning intent log. One journal per operator
    process lineage: it must survive the process (file backing in the
    real runtime, object handoff in the sim) to be worth anything."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[dict] = []      # append-only ledger
        self._open: Dict[int, LaunchIntent] = {}   # seq -> intent
        self._attempts: Dict[str, int] = {}        # claim -> opens so far
        self._seq = 0
        self.stats = {"opened": 0, "committed": 0, "aborted": 0,
                      "reaped": 0}
        if path and os.path.exists(path):
            self._replay_file(path)

    # --- write side -------------------------------------------------------
    def next_attempt(self, claim_name: str) -> int:
        """1-based attempt number the NEXT open for this claim gets —
        part of the token preimage, so a deliberate relaunch of the same
        claim (attempt bump) is distinguishable from a crash replay."""
        return self._attempts.get(claim_name, 0) + 1

    def open_launch(self, claim_name: str, nodepool: str, node_class: str,
                    token: str, now: float,
                    attempt: Optional[int] = None) -> LaunchIntent:
        return self.open_batch([{
            "claim_name": claim_name, "nodepool": nodepool,
            "node_class": node_class, "token": token,
            "attempt": attempt}], now)[0]

    def open_batch(self, specs: List[dict], now: float) -> List[LaunchIntent]:
        """Open one intent per spec ({claim_name, nodepool, node_class,
        token, attempt?}) with a SINGLE durability boundary: the whole
        batch's records land in one write+fsync. The boundary that
        matters is the one CreateFleet wire call AFTER all opens —
        per-record fsyncs would buy nothing but N× the latency on the
        launch hot path."""
        intents: List[LaunchIntent] = []
        records: List[dict] = []
        for spec in specs:
            attempt = spec.get("attempt")
            if attempt is None:
                attempt = self.next_attempt(spec["claim_name"])
            self._seq += 1
            intent = LaunchIntent(seq=self._seq,
                                  claim_name=spec["claim_name"],
                                  nodepool=spec["nodepool"],
                                  node_class=spec["node_class"],
                                  token=spec["token"], attempt=attempt,
                                  created_at=now)
            self._attempts[intent.claim_name] = attempt
            self._open[intent.seq] = intent
            self.stats["opened"] += 1
            intents.append(intent)
            records.append({"op": "open", **asdict(intent)})
        self._append_many(records)
        self._publish()
        return intents

    def resolve(self, intent: LaunchIntent, status: str,
                provider_id: str = "", now: float = 0.0) -> None:
        intent.status = status
        intent.provider_id = provider_id or intent.provider_id
        intent.resolved_at = now
        self._open.pop(intent.seq, None)
        self.stats[status] = self.stats.get(status, 0) + 1
        # resolutions are written but NOT fsync'd: losing one in a crash
        # merely leaves the intent open for restart replay, which
        # re-resolves it idempotently (a committed instance re-adopts) —
        # whereas a lost OPEN record would leave a launch unprotected,
        # so only opens pay the fsync
        self._append_many([{"op": "resolve", "seq": intent.seq,
                            "status": status,
                            "provider_id": intent.provider_id,
                            "resolved_at": now}], sync=False)
        self._publish()

    # --- read side --------------------------------------------------------
    def open_intents(self) -> List[LaunchIntent]:
        return list(self._open.values())

    def open_tokens(self) -> FrozenSet[str]:
        return frozenset(i.token for i in self._open.values())

    def open_claim_names(self) -> FrozenSet[str]:
        return frozenset(i.claim_name for i in self._open.values())

    # --- persistence ------------------------------------------------------
    def _append_many(self, records: List[dict], sync: bool = True) -> None:
        self.records.extend(records)
        if self.path and records:
            # opens are written + flushed + fsync'd BEFORE the wire call
            # they protect: an intent that only lived in a page cache
            # when the process died protects nothing. One fsync covers
            # the whole batch; resolutions pass sync=False (see resolve).
            # The span feeds the phase ledger's journal_fsync bucket —
            # fsync latency on the launch hot path is exactly the kind
            # of host-side cost the profiler exists to attribute.
            from ..obs.tracer import NOOP_SPAN, TRACER
            sp = (TRACER.span("journal.fsync", records=len(records),
                              sync=sync)
                  if TRACER.enabled else NOOP_SPAN)
            with sp:
                with open(self.path, "a", encoding="utf-8") as f:
                    for record in records:
                        f.write(json.dumps(record, sort_keys=True) + "\n")
                    f.flush()
                    if sync:
                        os.fsync(f.fileno())

    def _replay_file(self, path: str) -> None:
        """Rebuild the open set from an existing journal file (operator
        restart in the real runtime). Truncated trailing lines — the
        process died mid-append — are skipped: an unreadable OPEN is a
        launch whose request never shipped."""
        by_seq: Dict[int, LaunchIntent] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                # the restored journal carries its predecessor's full
                # ledger and stats, not just the open set — consumers of
                # `records`/`stats` see one continuous history
                self.records.append(rec)
                if rec.get("op") == "open":
                    intent = LaunchIntent(
                        **{k: v for k, v in rec.items() if k != "op"})
                    by_seq[intent.seq] = intent
                    self._seq = max(self._seq, intent.seq)
                    self._attempts[intent.claim_name] = max(
                        self._attempts.get(intent.claim_name, 0),
                        intent.attempt)
                    self.stats["opened"] += 1
                elif rec.get("op") == "resolve":
                    by_seq.pop(rec.get("seq"), None)
                    status = rec.get("status", "")
                    if status in self.stats:
                        self.stats[status] += 1
        self._open = {seq: i for seq, i in by_seq.items()}
        self._publish()

    def _publish(self) -> None:
        from ..metrics import INTENT_JOURNAL_OPEN
        INTENT_JOURNAL_OPEN.set(float(len(self._open)))
