"""Restart-safe state rehydration.

The port's own copy of `karpenter_tpu/state/rehydrate.py`, unchanged in
semantics.

The reference's durable state is the Kubernetes API: on operator restart
everything rebuilds from watches, and the GC only reaps instances whose
NodeClaim is verifiably gone in that durable store
(reference pkg/controllers/nodeclaim/garbagecollection/controller.go:55-112,
cmd/controller/main.go:43 state.NewCluster). Our durable stores are the
cloud itself — instances carry adoption tags stamped at launch — and the
cluster's node objects (kubelet/API-server side). This module rebuilds
`Store` from both, so a restarted operator adopts its fleet instead of
reaping it, and `Store.hydrated` gates the GC sweep until adoption ran.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..models import labels as L
from ..models.nodeclaim import NodeClaim, Phase
from ..models.requirements import Requirements
from ..models.resources import Resources
from .store import Store

from ..models.labels import (TAG_NODECLAIM, TAG_NODECLASS, TAG_NODECLASS_HASH,
                             TAG_NODECLASS_HASH_VERSION, TAG_NODEPOOL,
                             TAG_NODEPOOL_HASH, TAG_NODEPOOL_HASH_VERSION)


def rehydrate(store: Store, cloud, catalog=None, now: float = 0.0,
              journal=None) -> Dict[str, int]:
    """Rebuild Store from the cloud's durable state; marks the store hydrated.

    Idempotent: instances already backed by a NodeClaim (matched on
    provider_id) and nodes already present are skipped, so calling this on
    a warm store is a no-op. Untagged instances are not ours — they are
    left alone (the reference GC likewise only considers instances carrying
    the cluster's ownership tags).

    journal: the predecessor process's provisioning intent journal
    (state/journal.IntentJournal). Open intents — launches the dead
    process recorded but never resolved — are replayed AFTER tag
    adoption: each either adopts the instance its token actually minted,
    aborts (the crash landed before the wire call), or reaps a live
    instance whose claim could not be rebuilt. Replaying twice is a
    no-op (resolved intents leave the open set).
    """
    stats = {"nodes_adopted": 0, "claims_adopted": 0,
             "intents_adopted": 0, "intents_aborted": 0,
             "intents_reaped": 0}
    # 1. nodes: node objects live with the cluster and survive operator
    #    restarts (in k8s they sit in the API server; our fake cloud plays
    #    the kubelet/API-server side and exposes them via describe_nodes)
    instances = _describe_with_retry(cloud)
    for node in cloud.describe_nodes():
        if node.name not in store.nodes:
            store.add_node(node)
            stats["nodes_adopted"] += 1
    nodes_by_pid = {n.provider_id: n for n in store.nodes.values()}
    # capacity must come from the instance's NODECLASS view of the
    # catalog, not the raw catalog: per-NodeClass overrides (block-device
    # ephemeral storage) would otherwise vanish on every restart and the
    # adopted node would appear over-committed
    types_by_nc: Dict[str, Dict[str, object]] = {}

    def types_for(nc_name: str) -> Dict[str, object]:
        hit = types_by_nc.get(nc_name)
        if hit is None:
            if catalog is None:
                hit = {}
            else:
                nc = store.nodeclasses.get(nc_name)
                src = (catalog.list(nc) if nc is not None
                       else catalog.raw_types())
                hit = {t.name: t for t in src}
            types_by_nc[nc_name] = hit
        return hit
    claimed_pids = {c.provider_id for c in store.nodeclaims.values()
                    if c.provider_id}
    # 2. instances → NodeClaims via adoption tags (untagged = not ours)
    max_suffix = -1
    for inst in instances:
        if inst.state == "terminated" or inst.provider_id in claimed_pids:
            continue
        name = inst.tags.get(TAG_NODECLAIM)
        if not name:
            continue
        claim = _adopt(store, inst, name, nodes_by_pid.get(inst.provider_id),
                       types_for(inst.tags.get(TAG_NODECLASS, "default")),
                       now)
        store.add_nodeclaim(claim)
        store.record_event("nodeclaim", claim.name, "Adopted",
                           f"rehydrated from instance {inst.id}")
        stats["claims_adopted"] += 1
        tail = name.rsplit("-", 1)[-1]
        if tail.isdigit():
            max_suffix = max(max_suffix, int(tail))
    if max_suffix >= 0:
        # a restarted process's name sequence restarts at 0; advance it past
        # every adopted name so fresh launches can't mint a colliding name
        # (which would overwrite the adopted claim and expose its live
        # instance to GC)
        from ..models.nodeclaim import advance_name_sequence
        advance_name_sequence(max_suffix)
    if journal is not None and journal.open_intents():
        replay_intents(store, cloud, journal, instances, now, stats)
    store.hydrated = True
    if stats["claims_adopted"]:
        # disruption honors a settle window after adoption so workloads can
        # re-list before the empty pass sees pod-less adopted nodes (the
        # reference's analog: disruption waits for cluster-state sync)
        store.adopted_at = now
    return stats


def replay_intents(store: Store, cloud, journal, instances, now: float,
                   stats: Dict[str, int]) -> None:
    """Resolve the dead process's open launch intents deterministically:

    - a live instance carrying the intent's token tag + a rebuilt claim
      tracking it → the crash landed between the wire call and the
      commit; the tag adoption above already rebuilt the claim, so the
      intent simply commits (``adopted``);
    - a live token-tagged instance with NO rebuilt claim (adoption tags
      stripped, nodepool gone) → reap it NOW instead of leaking it until
      the GC sweep (``reaped``);
    - no instance for the token → the crash landed before the wire call
      (or the launch failed); nothing exists, the intent closes
      (``aborted``) and the re-listed pods re-solve normally.

    Metered per outcome (`karpenter_tpu_restart_adoptions_total`) and
    trace-visible as a `restart.adopt` span."""
    from ..cloud.provider import CloudError
    from ..metrics import RESTART_ADOPTIONS
    from ..obs.tracer import NOOP_SPAN, TRACER
    open_intents = journal.open_intents()
    sp = (TRACER.span("restart.adopt", intents=len(open_intents))
          if TRACER.enabled else NOOP_SPAN)
    with sp:
        by_token = {}
        for inst in instances:
            tok = inst.tags.get(L.TAG_LAUNCH_TOKEN)
            if tok and inst.state != "terminated":
                by_token[tok] = inst
        for intent in open_intents:
            inst = by_token.get(intent.token)
            if inst is None:
                journal.resolve(intent, "aborted", now=now)
                stats["intents_aborted"] += 1
                RESTART_ADOPTIONS.inc(outcome="aborted")
                continue
            claim = store.nodeclaims.get(intent.claim_name)
            if claim is not None and claim.provider_id == inst.provider_id:
                journal.resolve(intent, "committed",
                                provider_id=inst.provider_id, now=now)
                stats["intents_adopted"] += 1
                RESTART_ADOPTIONS.inc(outcome="adopted")
                store.record_event("nodeclaim", intent.claim_name,
                                   "IntentAdopted",
                                   f"open intent resolved to {inst.id}")
            else:
                try:
                    cloud.terminate([inst.id])
                except CloudError:
                    pass  # intent closes either way; GC backstops the reap
                journal.resolve(intent, "reaped", now=now)
                stats["intents_reaped"] += 1
                RESTART_ADOPTIONS.inc(outcome="reaped")
                store.record_event("instance", inst.id, "IntentReaped",
                                   f"unadoptable launch of {intent.claim_name}")
        sp.set(adopted=stats["intents_adopted"],
               aborted=stats["intents_aborted"],
               reaped=stats["intents_reaped"])


def _describe_with_retry(cloud, attempts: int = 6):
    """Boot-path DescribeInstances with backoff: a restart that lands in a
    throttling window must not crash-loop the operator (controllers get
    engine-level retry for RateLimitedError; this one-shot path needs its
    own)."""
    import time

    from ..cloud.provider import RateLimitedError, ServerError
    delay = 0.5
    clk = getattr(cloud, "clock", None)
    for i in range(attempts):
        try:
            return cloud.describe()
        except (RateLimitedError, ServerError):
            if i == attempts - 1:
                raise
            if clk is not None and hasattr(clk, "step"):
                # injected fake clock: the throttle bucket refills on IT,
                # not on wall time — stepping it is the only useful wait
                clk.step(delay)
            else:
                time.sleep(delay)
            delay = min(delay * 2, 8.0)


def _adopt(store: Store, inst, name: str, node, types: Dict[str, object],
           now: float) -> NodeClaim:
    pool = store.nodepools.get(inst.tags.get(TAG_NODEPOOL, ""))
    claim = NodeClaim(
        name=name,
        nodepool=inst.tags.get(TAG_NODEPOOL, ""),
        requirements=pool.requirements.copy() if pool else Requirements(),
        taints=list(pool.taints) if pool else [],
        startup_taints=list(pool.startup_taints) if pool else [],
        node_class=inst.tags.get(TAG_NODECLASS, "default"),
        expire_after=pool.expire_after if pool else None,
        termination_grace_period=pool.termination_grace_period if pool else None,
        created_at=inst.launch_time)
    claim.provider_id = inst.provider_id
    claim.instance_type = inst.instance_type
    claim.zone = inst.zone
    claim.capacity_type = inst.capacity_type
    claim.price = inst.price
    claim.image_id = inst.image_id
    claim.network_groups = list(inst.network_groups)
    claim.profile = inst.profile
    claim.launched_at = inst.launch_time
    claim.phase = Phase.LAUNCHED
    if inst.reservation_id:
        claim.annotations["karpenter.tpu/reservation-id"] = inst.reservation_id
    for tag, anno in ((TAG_NODECLASS_HASH, TAG_NODECLASS_HASH),
                      (TAG_NODECLASS_HASH_VERSION, TAG_NODECLASS_HASH_VERSION),
                      (TAG_NODEPOOL_HASH, TAG_NODEPOOL_HASH),
                      (TAG_NODEPOOL_HASH_VERSION, TAG_NODEPOOL_HASH_VERSION)):
        if tag in inst.tags:
            claim.annotations[anno] = inst.tags[tag]
    it = types.get(inst.instance_type)
    if it is not None:
        claim.capacity = Resources(it.capacity)
        claim.allocatable = it.allocatable()
        claim.labels.update(it.node_labels(inst.zone, inst.capacity_type))
    claim.labels[L.ZONE] = inst.zone
    claim.labels[L.CAPACITY_TYPE] = inst.capacity_type
    claim.labels[L.INSTANCE_TYPE] = inst.instance_type
    if pool is not None:
        claim.labels[L.NODEPOOL] = pool.name
    if node is not None:
        node.nodeclaim = claim.name
        claim.node_name = node.name
        claim.registered_at = inst.launch_time
        if node.labels.get(L.NODE_INITIALIZED) == "true":
            claim.phase = Phase.INITIALIZED
            claim.initialized_at = inst.launch_time
            claim.set_condition("Initialized", True, now=now)
        else:
            claim.phase = Phase.REGISTERED
        claim.set_condition("Registered", True, now=now)
    return claim
