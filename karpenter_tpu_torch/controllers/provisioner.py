"""Provisioning controller: pending pods → Solve → NodeClaims → launches.

The port's own copy of `karpenter_tpu/controllers/provisioner.py`. Every
solve goes through the port's `ops/facade.Solver` (kernels B0 and B on
the card's rung). The reference's optional warm path (`warmpath`, an
admitter in front of the solve) is not ported: its field and its two
call sites are left out, so every reconcile takes the reference's cold
path; every other line keeps the reference's semantics.

The core loop (reference: the core provisioner controller batches
unschedulable pods, runs the scheduling simulation over the instance-type
catalog, creates NodeClaims, and calls CloudProvider.Create — SURVEY.md
§2.3/§3.2). TPU-native difference: Solve() is the tensor kernel behind the
Solver facade; everything else here is lifecycle bookkeeping.

Multi-NodePool: pools are tried in descending weight; pods a pool cannot
schedule (taints, requirements, limits) fall through to the next pool.
ICE feedback: launch failures mark (type, zone, captype) unavailable for
3m (reference instance.go:469-512) and the pods return to pending —
the next solve avoids the marked offerings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..catalog.provider import CatalogProvider
from ..cloud.provider import (CapacityTypeUnfulfillableError, CloudError,
                              Instance, InsufficientCapacityError,
                              LaunchOverride, LaunchRequest,
                              ZoneExhaustedError)
from ..models import labels as L
from ..models.nodeclaim import NodeClaim, Phase, new_nodeclaim_name
from ..models.nodepool import NodeClassSpec, NodePool
from ..models.pod import Pod
from ..metrics import (ICE_ERRORS, NODECLAIMS_CREATED, PODS_SCHEDULED,
                       PODS_UNSCHEDULABLE)
from ..obs.tracer import NOOP_SPAN, TRACER
from ..models.resources import Resources
from ..ops.facade import NodeLaunch, Solver, virtual_node_from_claim
from ..state.store import Store
from ..utils import crashpoints

NOMINATED = L.NOMINATED  # canonical home: models/labels.py


@dataclass
class Provisioner:
    store: Store
    solver: Solver
    cloud: object  # CloudProvider
    catalog: CatalogProvider
    name: str = "provisioner"
    batch_idle: float = 1.0
    requeue: float = 1.0
    # (the reference's optional warmpath.WarmPathEngine field sits here:
    # not ported, ROADMAP §1 item 9 — every reconcile is cold)
    # optional state.journal.IntentJournal: the provisioning write-ahead
    # log. When set, every launch batch records its intents BEFORE the
    # CreateFleet wire call and resolves them after the commit, so a
    # crash anywhere in between is recoverable (restart replay adopts or
    # aborts; the GC sweep skips instances with open intents). None =
    # no journaling (tests exercising the bare launch path).
    journal: Optional[object] = None
    stats: Dict[str, int] = field(default_factory=lambda: {
        "solves": 0, "launches": 0, "ice_errors": 0, "unschedulable": 0})
    _throttled: bool = False  # set by a throttled _launch within a pass
    _last_path: str = "idle"  # warm | mixed | cold | idle (span attribute)

    def span_attrs(self) -> Dict[str, str]:
        """Attributes the engine attaches to this controller's reconcile
        span (engine.py) — the warm/cold decision, trace-visible."""
        return {"path": self._last_path}

    def reconcile(self, now: float) -> float:
        self._throttled = False
        self._last_path = "idle"
        # the store's admission-time index IS the pending-unnominated set,
        # already bucketed by constraint signature — the first pool's
        # encode skips its per-pod grouping pass entirely
        batch_sp = (TRACER.span("provision.batch")
                    if TRACER.enabled else NOOP_SPAN)
        with batch_sp:
            groups = self.store.pending_unnominated_groups()
            batch_sp.set(groups=len(groups),
                         pods=sum(len(g) for g in groups))
        if not groups:
            return self.requeue
        # (the reference's warm-path admission sits here)
        self._last_path = "cold"
        pending = [p for g in groups for p in g]
        remaining: List[Pod] = pending
        pregrouped: Optional[List[List[Pod]]] = groups
        for pool in self.store.nodepools_by_weight():
            if not remaining:
                break
            pool_sp = (TRACER.span("provision.pool", pool=pool.name,
                                   pods=len(remaining))
                       if TRACER.enabled else NOOP_SPAN)
            with pool_sp:
                out = self._provision_pool(pool, remaining, now, pregrouped)
                pool_sp.set(leftover=len(out))
            if out is not remaining:
                # the pool actually solved (a not-ready NodeClass gate
                # returns the identical list object untouched — keep the
                # index's grouping for the next pool in that case);
                # leftovers of a real solve are regrouped, they're small
                pregrouped = None
            remaining = out
        self.stats["unschedulable"] = len(remaining)
        PODS_UNSCHEDULABLE.set(len(remaining))
        for p in remaining:
            self.store.record_event("pod", f"{p.namespace}/{p.name}",
                                    "FailedScheduling", "no nodepool could schedule")
        # (the reference's warm-path ledger commit sits here)
        # a throttled CreateFleet left pods pending on purpose: retry at
        # the retryable backoff, not the normal cadence
        return max(self.requeue, 2.0) if self._throttled else self.requeue

    def _cluster_occupancy(self, now: float):
        """Cluster-wide (zone, pods) per node — canonical implementation
        in state/cluster.py, shared with the warm-path commit snapshot."""
        from ..state.cluster import cluster_occupancy
        return cluster_occupancy(self.store)

    # --- per-pool pass ---
    def _provision_pool(self, pool: NodePool, pods: List[Pod],
                        now: float,
                        pregrouped: Optional[List[List[Pod]]] = None,
                        ) -> List[Pod]:
        node_class = self.store.nodeclasses.get(pool.node_class) or NodeClassSpec()
        if not node_class.ready:
            return pods  # NodeClass readiness gate (cloudprovider.go:102-111)
        # fresh per pool: claims + nominations created by earlier pools this
        # reconcile must count toward later pools' topology domains
        spread_occupancy = self._cluster_occupancy(now)
        cat = self.solver.tensors(node_class)
        # live + in-flight claims of this pool absorb pods first (real-node
        # headroom reuse; reference simulates against cluster state the same
        # way); their current pods ride along so anti-affinity caps hold
        # across reconciles. pool_node_views applies the cordon filter —
        # the same view the warm-path ledger is built from.
        from ..state.cluster import pool_node_views
        existing, existing_pods = [], {}
        for view in pool_node_views(self.store, cat, now, pool.name):
            existing.append(view.virtual)
            existing_pods[view.claim.name] = view.pods
        daemonsets = list(self.store.daemonsets.values())
        out = self.solver.solve(pods, pool, node_class, existing,
                                existing_pods=existing_pods,
                                spread_occupancy=spread_occupancy,
                                pregrouped=pregrouped,
                                daemonsets=daemonsets)
        self.stats["solves"] += 1

        by_key = {f"{p.namespace}/{p.name}": p for p in pods}
        # nominate pods placed on in-flight claims
        for claim_name, keys in out.existing_placements.items():
            claim = self.store.nodeclaims.get(claim_name)
            if claim is None:
                continue
            for k in keys:
                self._nominate(by_key[k], claim)
                claim.resource_requests = claim.resource_requests.add(by_key[k].requests)

        # enforce NodePool limits on new launches
        usage = self._pool_usage(pool)
        launches, over_limit_pods, usage = self._filter_by_limits(
            pool, node_class, out.launches, usage, by_key)

        # limit-aware retry: re-solve rejected pods allowing only types whose
        # capacity fits the remaining headroom (the reference's scheduler
        # stops opening over-limit virtual nodes during the simulation)
        if over_limit_pods and pool.limits:
            headroom = Resources({k: v - usage.get(k, 0.0)
                                  for k, v in pool.limits.items()})
            if all(v > 0 for v in headroom.values()):
                # the first solve's accepted launches aren't claims yet
                # (they launch below), so their placements are synthesized
                # into the occupancy the re-solve sees
                occ2 = self._cluster_occupancy(now) + [
                    (l.zone, [by_key[k] for k in l.pod_keys if k in by_key])
                    for l in launches]
                out2 = self.solver.solve(over_limit_pods, pool, node_class,
                                         capacity_cap=headroom,
                                         spread_occupancy=occ2,
                                         daemonsets=daemonsets)
                by_key2 = {f"{p.namespace}/{p.name}": p for p in over_limit_pods}
                by_key.update(by_key2)
                l2, over_limit_pods, usage = self._filter_by_limits(
                    pool, node_class, out2.launches, usage, by_key2)
                launches += l2
                over_limit_pods += [by_key2[k] for k in out2.unschedulable]
            for p in over_limit_pods:
                self.store.record_event("nodepool", pool.name, "LimitExceeded",
                                        f"cannot schedule {p.name}")

        _, failed_pods = self._launch(pool, node_class, launches, now)
        leftover = [by_key[k] for k in out.unschedulable] + over_limit_pods + failed_pods
        return leftover

    def _filter_by_limits(self, pool, node_class, launches_in, usage, by_key):
        launches: List[NodeLaunch] = []
        over_limit_pods: List[Pod] = []
        types = {t.name: t for t in self.catalog.list(node_class)}
        for launch in launches_in:
            cap = types[launch.instance_type].capacity if launch.instance_type in types else Resources()
            if not pool.within_limits(usage, cap):
                over_limit_pods.extend(by_key[k] for k in launch.pod_keys)
                continue
            usage = usage.add(cap)
            launches.append(launch)
        return launches, over_limit_pods, usage

    def _pods_of_claim(self, claim: NodeClaim) -> List[Pod]:
        seen: Dict[int, Pod] = {}
        for p in self.store.pods.values():
            if p.annotations.get(NOMINATED) == claim.name:
                seen[p.uid] = p
        if claim.node_name:
            for p in self.store.pods_on_node(claim.node_name):
                seen[p.uid] = p
        return list(seen.values())

    def _pool_usage(self, pool: NodePool) -> Resources:
        usage = Resources()
        for claim in self.store.nodeclaims_for_pool(pool.name):
            if not claim.is_deleting() and claim.phase != Phase.FAILED:
                usage = usage.add(claim.capacity)
        return usage

    # --- launch ---
    def _launch(self, pool: NodePool, node_class: NodeClassSpec,
                launches: List[NodeLaunch], now: float):
        """Returns (created_claims, pods_of_failed_launches)."""
        if not launches:
            return [], []
        from ..ops.facade import min_values_floors
        floors = min_values_floors(pool.requirements)
        # reservation ids + flavors ride along so reserved launches can be
        # attributed, counted, and type-partitioned; loop-invariant, built
        # once per batch
        res_ids = {(t.name, o.zone, o.capacity_type):
                   (o.reservation_id, o.reservation_type)
                   for t in self.catalog.raw_types()
                   for o in t.offerings if o.reservation_id}
        from ..state.journal import launch_token
        pool_hash = pool.hash()  # the token's pool-fingerprint component
        attempts: Dict[str, int] = {}  # claim -> the attempt its token bakes in
        requests, claims = [], []
        for launch in launches:
            claim = NodeClaim(
                name=new_nodeclaim_name(pool.name), nodepool=pool.name,
                requirements=pool.requirements.copy(),
                resource_requests=launch.requests,
                taints=list(pool.taints), startup_taints=list(pool.startup_taints),
                labels=dict(launch.labels), node_class=node_class.name,
                expire_after=pool.expire_after,
                termination_grace_period=pool.termination_grace_period,
                created_at=now)
            from ..models.nodepool import (NODECLASS_HASH_VERSION,
                                           NODEPOOL_HASH_VERSION)
            claim.annotations["karpenter.tpu/nodeclass-hash"] = node_class.hash()
            claim.annotations["karpenter.tpu/nodeclass-hash-version"] = NODECLASS_HASH_VERSION
            claim.annotations["karpenter.tpu/nodepool-hash"] = pool.hash()
            claim.annotations["karpenter.tpu/nodepool-hash-version"] = NODEPOOL_HASH_VERSION
            claim.instance_type = launch.instance_type
            self.store.add_nodeclaim(claim)
            claims.append((claim, launch))
            # idempotency token: hash of claim name + pool fingerprint +
            # attempt. Deterministic, so a request replayed after a
            # crash-restart maps to the same token and the cloud dedupes
            # it instead of double-provisioning; stamped as an instance
            # tag too, so restart replay can match intents to instances
            attempt = (self.journal.next_attempt(claim.name)
                       if self.journal is not None else 1)
            attempts[claim.name] = attempt
            token = launch_token(claim.name, pool_hash, attempt)
            overrides = [
                LaunchOverride(*o,
                               reservation_id=res_ids.get(o[:3], (None, ""))[0],
                               reservation_type=res_ids.get(o[:3],
                                                            (None, "default"))[1])
                for o in launch.overrides]
            requests.append(LaunchRequest(
                nodeclaim_name=claim.name,
                overrides=self._prioritize_capacity_type(
                    self._partition_reservation_overrides(overrides,
                                                          floors)),
                image_id=(node_class.resolved_images[0]
                          if node_class.resolved_images else "img-default"),
                user_data=self._user_data(pool, node_class, launch),
                # adoption tags: enough for state.rehydrate to rebuild the
                # NodeClaim from the instance after an operator restart
                idempotency_token=token,
                tags={**node_class.tags,
                      L.TAG_NODEPOOL: pool.name,
                      L.TAG_NODECLAIM: claim.name,
                      L.TAG_NODECLASS: node_class.name,
                      L.TAG_LAUNCH_TOKEN: token,
                      L.TAG_NODECLASS_HASH:
                          claim.annotations["karpenter.tpu/nodeclass-hash"],
                      L.TAG_NODECLASS_HASH_VERSION:
                          claim.annotations["karpenter.tpu/nodeclass-hash-version"],
                      L.TAG_NODEPOOL_HASH:
                          claim.annotations["karpenter.tpu/nodepool-hash"],
                      L.TAG_NODEPOOL_HASH_VERSION:
                          claim.annotations["karpenter.tpu/nodepool-hash-version"]},
                network_groups=list(node_class.resolved_network_groups),
                profile=node_class.resolved_profile))
        # single launch-floor choke point (reference contract: Truncate +
        # the whole filter chain run BEFORE CreateFleet, instance.go:293):
        # any mutation downstream of override selection — here, in-flight
        # IP accounting — that would drop a reachable minValues floor is
        # rolled back, so no wire request ever ships below a floor its
        # pre-mutation rows satisfied. (The reservation partition above is
        # a hard cloud constraint and does its own floor-aware fallback.)
        baseline = {req.nodeclaim_name: list(req.overrides)
                    for req in requests} if floors else {}
        self._apply_inflight_ip_accounting(requests)
        if floors:
            for req in requests:
                pre = baseline[req.nodeclaim_name]
                if (self._floors_hold(pre, floors)
                        and not self._floors_hold(req.overrides, floors)):
                    req.overrides = pre
        # write-ahead intent record: one open intent per request, written
        # (and fsync'd when file-backed) BEFORE the wire call — the only
        # reason a crash between here and the commit below is recoverable.
        # A non-retryable create_fleet raise deliberately leaves the
        # intents open: the engine crashes, and restart replay
        # (state/rehydrate.replay_intents) adopts whatever the wire call
        # actually minted and aborts the rest.
        intents: Dict[str, object] = {}
        if self.journal is not None:
            # attempt is passed through explicitly: it MUST be the one
            # the idempotency token baked in above, not a recount
            opened = self.journal.open_batch(
                [{"claim_name": req.nodeclaim_name, "nodepool": pool.name,
                  "node_class": node_class.name,
                  "token": req.idempotency_token,
                  "attempt": attempts[req.nodeclaim_name]}
                 for req in requests],
                now=now)
            intents = {i.claim_name: i for i in opened}
        crashpoints.fire("mid_launch_batch")  # cut point: intents open,
        fleet_sp = (TRACER.span("provision.launch", pool=pool.name,  # no wire call yet
                                requests=len(requests))
                    if TRACER.enabled else NOOP_SPAN)
        try:
            with fleet_sp:
                results = self.cloud.create_fleet(requests)
        except CloudError as e:
            if not getattr(e, "retryable", False):
                # the call was rejected wholesale (auth/validation —
                # a raise, unlike the per-request in-band errors, means
                # nothing was processed): roll back the claims and close
                # the intents before re-raising. Crucially this must NOT
                # leave intents open: the production Runtime SURVIVES
                # this raise (it is not a process death), so an
                # open-forever intent would both leak the gauge and
                # shield any stray instance from GC for the process's
                # whole lifetime. If a misbehaving cloud minted anything
                # anyway, its adoption tags keep it recoverable: GC
                # reaps it after MIN_AGE in-process, restart adopts it.
                self._rollback_launch(claims, intents, now)
                raise
            # throttled/5xx batch: roll back and leave the pods pending
            # for the NEXT reconcile. They are
            # deliberately NOT handed to later pools: that would re-solve
            # and re-hammer the throttled cloud once per pool and record
            # bogus FailedScheduling events for pods that are merely
            # throttled. The reconcile requeues at the retryable backoff.
            self._rollback_launch(claims, intents, now)
            self.stats["throttled"] = self.stats.get("throttled", 0) + 1
            self._throttled = True
            self.store.record_event("provisioner", pool.name,
                                    "CreateFleetThrottled", str(e))
            return [], []

        crashpoints.fire("post_launch")  # cut point: instances may exist,
        launched: List[NodeClaim] = []   # nothing committed to the store
        failed_pods: List[Pod] = []
        bind_sp = (TRACER.span("provision.bind", claims=len(claims))
                   if TRACER.enabled else NOOP_SPAN)
        with bind_sp:
            for (claim, launch), res in zip(claims, results):
                if isinstance(res, Instance):
                    claim.phase = Phase.LAUNCHED
                    claim.provider_id = res.provider_id
                    self.store.index_nodeclaim_instance(claim)
                    claim.instance_type = res.instance_type
                    claim.zone = res.zone
                    claim.capacity_type = res.capacity_type
                    claim.price = res.price
                    claim.launched_at = now
                    claim.image_id = res.image_id
                    claim.network_groups = list(res.network_groups)
                    claim.profile = res.profile
                    itype = next((t for t in self.catalog.list(node_class)
                                  if t.name == res.instance_type), None)
                    if itype is not None:
                        claim.capacity = Resources(itype.capacity)
                        claim.allocatable = itype.allocatable()
                    claim.labels[L.ZONE] = res.zone
                    claim.labels[L.CAPACITY_TYPE] = res.capacity_type
                    claim.labels[L.INSTANCE_TYPE] = res.instance_type
                    if res.reservation_id:
                        claim.annotations["karpenter.tpu/reservation-id"] = res.reservation_id
                        cap = next((o.reservation_capacity for t in self.catalog.raw_types()
                                    if t.name == res.instance_type
                                    for o in t.offerings
                                    if o.reservation_id == res.reservation_id), 0)
                        self.catalog.mark_reservation_launched(res.reservation_id, cap)
                    for k in launch.pod_keys:
                        pod = self.store.pods.get(k)
                        if pod is not None:
                            self._nominate(pod, claim)
                    self.stats["launches"] += 1
                    launched.append(claim)
                    NODECLAIMS_CREATED.inc(nodepool=claim.nodepool,
                                           instance_type=claim.instance_type,
                                           capacity_type=claim.capacity_type)
                    intent = intents.get(claim.name)
                    if intent is not None:
                        # the commit above is what the intent guarded;
                        # it lands, the intent closes
                        self.journal.resolve(intent, "committed",
                                             provider_id=res.provider_id,
                                             now=now)
                else:
                    self._handle_launch_error(claim, res)
                    failed_pods.extend(self.store.pods[k] for k in launch.pod_keys
                                       if k in self.store.pods)
                    intent = intents.get(claim.name)
                    if intent is not None:
                        # the cloud answered with an error: no instance
                        # exists for this token, nothing to recover
                        self.journal.resolve(intent, "aborted", now=now)
            return launched, failed_pods

    def _rollback_launch(self, claims, intents: Dict[str, object],
                         now: float) -> None:
        """Unwind a launch batch whose CreateFleet call RAISED (throttle
        or wholesale rejection — nothing reached the wire): delete the
        pre-created claims (a PENDING claim with no instance would live
        forever; the liveness reaper only covers LAUNCHED ones) and close
        their intents aborted (an open-forever intent would leak the
        gauge and shield strays from GC for the process's lifetime). The
        retry path mints fresh claims, hence fresh tokens."""
        for claim, _launch in claims:
            self.store.delete_nodeclaim(claim.name)
            intent = intents.get(claim.name)
            if intent is not None:
                self.journal.resolve(intent, "aborted", now=now)

    def _handle_launch_error(self, claim: NodeClaim, err: CloudError) -> None:
        claim.phase = Phase.FAILED
        claim.set_condition("Launched", False, type(err).__name__, str(err))
        self.store.record_event("nodeclaim", claim.name, "LaunchFailed", str(err))
        self.store.delete_nodeclaim(claim.name)
        if isinstance(err, ZoneExhaustedError):
            # InsufficientFreeAddresses → AZ-wide mark (errors.go:180): the
            # next solve's availability tensor zeroes the whole zone
            self.stats["ice_errors"] += 1
            for z in err.zones:
                ICE_ERRORS.inc(capacity_type="zone-wide")
                self.catalog.unavailable.mark_zone_unavailable(z)
                self.store.record_event("zone", z, "Exhausted",
                                        "no free addresses")
        elif isinstance(err, CapacityTypeUnfulfillableError):
            # fleet-wide UnfulfillableCapacity → capacity-type-wide mark
            # (errors.go:172): reroutes the next solve off e.g. spot
            self.stats["ice_errors"] += 1
            for c in err.capacity_types:
                ICE_ERRORS.inc(capacity_type=c)
                self.catalog.unavailable.mark_capacity_type_unavailable(c)
                self.store.record_event("capacity-type", c, "Unfulfillable",
                                        "fleet-wide")
        elif isinstance(err, InsufficientCapacityError):
            self.stats["ice_errors"] += 1
            for (t, z, c) in err.offerings:
                ICE_ERRORS.inc(capacity_type=c)
                self.catalog.unavailable.mark_unavailable(t, z, c, reason="ICE")

    @staticmethod
    def _floors_hold(overrides: List[LaunchOverride],
                     floors) -> bool:
        """Do the override rows span every evaluable minValues floor?
        Only the three offering-visible keys (instance-type, zone,
        capacity-type) can be judged from wire rows; label-key floors
        were already secured by the facade's constrained selection."""
        for key, need in floors:
            if key == L.INSTANCE_TYPE:
                vals = {o.instance_type for o in overrides}
            elif key == L.ZONE:
                vals = {o.zone for o in overrides}
            elif key == L.CAPACITY_TYPE:
                vals = {o.capacity_type for o in overrides}
            else:
                continue
            if len(vals) < need:
                return False
        return True

    @staticmethod
    def _prioritize_capacity_type(
            overrides: List[LaunchOverride]) -> List[LaunchOverride]:
        """Explicit reserved-capacity preference stage (reference
        getCapacityType, instance.go:530-546, prioritizes reserved
        before the market types): reserved rows lead the wire list
        regardless of price — so a reserved offering whose price an
        overlay distorted still wins over spot/OD. Before this stage the
        preference was only an artifact of reserved prices rounding to
        zero. Spot-vs-on-demand stays with the solver's cost argmin (the
        committed row leads the remainder): unlike the reference's
        blanket spot-first rule, this framework's contract is
        cost-optimal placement, and paying 20x for a spot drought to
        honor a market-type preference would invert that contract. The
        sort is stable — price order survives within each class — and
        the cloud's allocation walks the list in order."""
        return sorted(overrides,
                      key=lambda o: o.capacity_type != L.CAPACITY_RESERVED)

    @staticmethod
    def _partition_reservation_overrides(
            overrides: List[LaunchOverride],
            floors=()) -> List[LaunchOverride]:
        """Reservation-type partition (reference filter.go:73-228): one
        launch may not mix reservation flavors. When the committed row
        (first override — the solver's pick) is a capacity block, the
        request targets exactly the cheapest block's rows and nothing
        else; otherwise capacity-block rows are dropped from the
        alternates (blocks only serve launches that explicitly chose
        them — a spot/OD launch must not spill into a prepaid block).

        floors: minValues floors of the launching pool. Collapsing to a
        single block would ship one instance type; when that breaks a
        floor the full list still satisfied, the launch falls back to
        the drop-block-rows branch instead — flexibility floors outrank
        block affinity (the reference never reaches this conflict: its
        block filter only runs for explicitly reserved launches, which
        don't carry type-flex floors)."""
        is_block = lambda o: (o.reservation_id is not None
                              and o.reservation_type == "capacity-block")
        blocks = [o for o in overrides if is_block(o)]
        if not blocks:
            return overrides
        nonblock = [o for o in overrides if not is_block(o)]
        if overrides and is_block(overrides[0]):
            best = min(blocks, key=lambda o: o.price).reservation_id
            kept = [o for o in overrides if o.reservation_id == best]
            if (floors and nonblock
                    and Provisioner._floors_hold(overrides, floors)
                    and not Provisioner._floors_hold(kept, floors)
                    and Provisioner._floors_hold(nonblock, floors)):
                return nonblock
            return kept
        return nonblock

    def _apply_inflight_ip_accounting(self, requests: List[LaunchRequest],
                                      ) -> None:
        """In-flight address accounting across one launch batch (reference
        subnet.go:183-230 UpdateInflightIPs): walk the batch in order,
        predict each request's zone (its FIRST surviving override — the
        cloud allocates in priority order, so after the reserved-first
        stage this may not be the cheapest row) and
        decrement that zone's free-address budget; once a zone's budget is
        consumed by earlier requests in the SAME batch, later requests drop
        their overrides in that zone so a burst can't exhaust it mid-batch.
        A request whose every override sits in consumed zones keeps its
        list untouched (the cloud's error path + zone marks take over)."""
        describe = getattr(self.cloud, "describe_zone_capacity", None)
        if describe is None or not requests:
            return
        try:
            free = dict(describe())
        except CloudError:
            return  # accounting is an optimization; throttled reads skip it
        import math
        if all(v == math.inf for v in free.values()):
            return
        for req in requests:
            kept = [ov for ov in req.overrides if free.get(ov.zone, math.inf) > 0]
            if kept and len(kept) < len(req.overrides):
                req.overrides = kept
            if req.overrides:
                # the cloud walks the list in priority order, so the
                # first surviving row IS the predicted allocation
                pick = req.overrides[0]
                if free.get(pick.zone, math.inf) != math.inf:
                    free[pick.zone] -= 1

    def _user_data(self, pool: NodePool, node_class: NodeClassSpec,
                   launch: NodeLaunch) -> str:
        from ..cloud.image import FAMILIES, BootstrapConfig
        fam = FAMILIES.get(node_class.image_family)
        if fam is None:
            return node_class.user_data  # custom family: verbatim userdata
        return fam.user_data(BootstrapConfig(
            cluster_name="karpenter-tpu",
            cluster_endpoint="https://cluster.internal",
            labels=launch.labels, taints=pool.taints,
            kubelet_max_pods=node_class.kubelet_max_pods,
            kube_reserved=node_class.kubelet_kube_reserved,
            custom_user_data=node_class.user_data))

    def _nominate(self, pod: Pod, claim: NodeClaim) -> None:
        self.store.nominate_pod(pod, claim.name)
        PODS_SCHEDULED.inc()
