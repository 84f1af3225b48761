"""Fake cloud — the kwok-equivalent simulation backend.

The port's own copy of `karpenter_tpu/cloud/fake.py`, unchanged in
semantics.

Runs the REAL provider/controller code against an in-memory cloud, like the
reference's kwok stack (kwok/ec2/ec2.go): stateful instances, CreateFleet
that picks the lowest-price override (kwok/strategy/strategy.go:28-45),
simulated Node materialization after a boot delay, finite capacity pools
for ICE injection (pkg/fake/ec2api.go CapacityPool:41), per-API token-bucket
rate limits (kwok/ec2/ratelimiting.go:86-135), a kill-instance chaos hook
(kwok/ec2/ec2.go:253-282), and snapshot/restore state persistence
(ec2.go:118-236).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..models import labels as L
from ..models.instancetype import InstanceType
from ..models.nodeclaim import Node
from ..models.resources import Resources
from ..utils.clock import Clock, RealClock
from .provider import (CapacityTypeUnfulfillableError, CloudError, Instance,
                       InsufficientCapacityError, LaunchRequest, NetworkGroup,
                       NodeProfile, NotFoundError, RateLimitedError,
                       UnauthorizedError, ZoneExhaustedError)


def default_network_groups() -> List[NetworkGroup]:
    return [
        NetworkGroup(id="ng-default", name="default",
                     tags={"karpenter.tpu/discovery": "my-cluster"}),
        NetworkGroup(id="ng-nodes", name="cluster-nodes",
                     tags={"karpenter.tpu/discovery": "my-cluster",
                           "role": "node"}),
        NetworkGroup(id="ng-restricted", name="restricted",
                     tags={"env": "prod"}),
    ]

_ids = itertools.count(1)


class TokenBucket:
    def __init__(self, rate: float, burst: int, clock: Clock):
        self.rate, self.burst, self.clock = rate, burst, clock
        self.tokens = float(burst)
        self.last = clock.now()

    def allow(self, n: int = 1) -> bool:
        now = self.clock.now()
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: int = 1) -> float:
        """Seconds until `n` tokens will be available — the server-side
        Retry-After hint a throttled call carries back to the client."""
        return max(0.0, (n - self.tokens) / self.rate)


@dataclass
class FakeCloudConfig:
    node_ready_delay: float = 2.0     # seconds from launch to Ready node
    register_delay: float = 1.0       # launch -> node object exists
    create_fleet_rate: float = 50.0   # calls/sec token refill
    create_fleet_burst: int = 100
    # per-API buckets mimicking EC2's per-action throttles (reference kwok
    # ratelimiting.go:86-135 keeps one bucket per API); generous defaults —
    # only abusive polling trips them
    describe_rate: float = 100.0
    describe_burst: int = 500
    terminate_rate: float = 100.0
    terminate_burst: int = 500
    unlimited_capacity: bool = True   # pools default to infinite
    # per-zone network/IP capacity (the subnet free-address model,
    # reference subnet.go:135): zones absent from the map are unlimited;
    # each running instance consumes one address, terminations return it
    zone_ip_capacity: Optional[Dict[str, int]] = None


class FakeCloud:
    """In-memory cloud + node simulator."""

    def __init__(self, types: List[InstanceType],
                 clock: Optional[Clock] = None,
                 config: Optional[FakeCloudConfig] = None):
        self.clock = clock or RealClock()
        self.config = config or FakeCloudConfig()
        self.types: Dict[str, InstanceType] = {t.name: t for t in types}
        self.instances: Dict[str, Instance] = {}
        # finite capacity per (type, zone, captype); absent = unlimited when
        # config.unlimited_capacity else 0
        self.capacity_pools: Dict[Tuple[str, str, str], int] = {}
        self._bucket = TokenBucket(self.config.create_fleet_rate,
                                   self.config.create_fleet_burst, self.clock)
        self._describe_bucket = TokenBucket(self.config.describe_rate,
                                            self.config.describe_burst,
                                            self.clock)
        self._terminate_bucket = TokenBucket(self.config.terminate_rate,
                                             self.config.terminate_burst,
                                             self.clock)
        self.on_node_ready: List[Callable[[Node], None]] = []
        self.on_node_created: List[Callable[[Node], None]] = []
        self._nodes_created: Dict[str, Node] = {}
        self.api_calls: Dict[str, int] = {"create_fleet": 0, "terminate": 0,
                                          "describe": 0, "launch_dedup": 0}
        # idempotency-token ledger: token -> instance id it minted. A
        # replayed request whose token already produced a live instance
        # dedupes to it (the crash-restart double-launch guard); the
        # ledger is cloud-side durable state, like the instances
        self._token_instances: Dict[str, str] = {}
        # queued interruption events; deque so FIFO acks are O(1)
        self.interruptions: "deque[dict]" = deque()
        self.expired_reservations: set = set()
        self.unhealthy: set = set()  # instance ids with a dead kubelet
        # remaining free addresses per zone (absent = unlimited)
        self.zone_ips: Dict[str, int] = dict(self.config.zone_ip_capacity or {})
        # capacity types in a fleet-wide drought (UnfulfillableCapacity)
        self.captype_outages: set = set()
        # live zonal spot price book (DescribeSpotPriceHistory analog),
        # seeded from the catalog's static spot offerings
        self.spot_prices: Dict[Tuple[str, str], float] = {
            (t.name, o.zone): o.price for t in types
            for o in t.offerings if o.capacity_type == "spot"}
        from .image import default_images
        self.images = default_images(self.clock.now())
        self.network_groups: Dict[str, NetworkGroup] = {
            g.id: g for g in default_network_groups()}
        self.profiles: Dict[str, NodeProfile] = {}
        # armed fault-injection plan (faults/plan.FaultPlan) or None; the
        # only hook on the launch path is one None-check per override row
        self.fault_plan = None

    # --- capacity pool control (tests / chaos) ---
    def set_capacity(self, instance_type: str, zone: str, capacity_type: str,
                     count: int) -> None:
        self.capacity_pools[(instance_type, zone, capacity_type)] = count

    def _take_capacity(self, key: Tuple[str, str, str]) -> bool:
        if key not in self.capacity_pools:
            return self.config.unlimited_capacity
        if self.capacity_pools[key] > 0:
            self.capacity_pools[key] -= 1
            return True
        return False

    def _return_capacity(self, key: Tuple[str, str, str]) -> None:
        if key in self.capacity_pools:
            self.capacity_pools[key] += 1

    # --- CloudProvider API ---
    def create_fleet(self, requests: List[LaunchRequest]) -> List["Instance | CloudError"]:
        self.api_calls["create_fleet"] += 1
        if not self._bucket.allow():
            raise RateLimitedError("CreateFleet throttled",
                                   retry_after=self._bucket.retry_after())
        out: List["Instance | CloudError"] = []
        for req in requests:
            out.append(self._launch_one(req))
        return out

    def _launch_one(self, req: LaunchRequest) -> "Instance | CloudError":
        # idempotency gate FIRST (before auth/capacity: a replay must
        # return the original instance even if the pool has since
        # exhausted or the request's profile was deleted — EC2's
        # client-token semantics): a token that already minted a live
        # instance dedupes instead of double-provisioning
        tok = getattr(req, "idempotency_token", "")
        if tok:
            prior = self._token_instances.get(tok)
            if prior is not None:
                inst = self.instances.get(prior)
                if inst is not None and inst.state != "terminated":
                    self.api_calls["launch_dedup"] += 1
                    from ..metrics import LAUNCH_DEDUP
                    LAUNCH_DEDUP.inc()
                    return inst
        # authorization/validity gates before capacity (reference: RunInstances
        # rejects unknown SGs / instance profiles before placement)
        for ng in req.network_groups:
            if ng not in self.network_groups:
                return NotFoundError(f"network group {ng} not found")
        if req.profile and req.profile not in self.profiles:
            return UnauthorizedError(
                f"node profile {req.profile} does not exist")
        exhausted = []
        no_ip_zones = set()
        outage_types = set()
        # priority allocation: the list arrives prioritized by the
        # provisioner (reserved rows first — the reference's explicit
        # reserved→spot→OD capacity-type preference, instance.go:530-546
        # — then the committed type's cheapest row, then price order), so
        # walking in order IS the lowest-price strategy with the
        # capacity-type preference layered on top
        for ov in req.overrides:
            key = (ov.instance_type, ov.zone, ov.capacity_type)
            if ov.instance_type not in self.types:
                continue
            if (self.fault_plan is not None
                    and self.fault_plan.ice_active(
                        ov.instance_type, ov.zone, ov.capacity_type,
                        self.clock.now())):
                # injected ICE window: the pool behaves exhausted
                exhausted.append(key)
                continue
            if ov.capacity_type in self.captype_outages:
                outage_types.add(ov.capacity_type)
                continue
            if not self._zone_has_ip(ov.zone):
                no_ip_zones.add(ov.zone)
                continue
            # expiry check BEFORE taking capacity: the old order leaked a
            # unit of the pool on every expired-reservation attempt
            if ov.reservation_id and ov.reservation_id in self.expired_reservations:
                exhausted.append(key)
                continue
            if not self._take_capacity(key):
                exhausted.append(key)
                continue
            if ov.zone in self.zone_ips:
                self.zone_ips[ov.zone] -= 1
            inst = Instance(
                id=f"i-{next(_ids):08d}", instance_type=ov.instance_type,
                zone=ov.zone, capacity_type=ov.capacity_type,
                image_id=req.image_id, state="pending",
                launch_time=self.clock.now(), tags=dict(req.tags),
                price=ov.price, nodeclaim=req.nodeclaim_name,
                reservation_id=ov.reservation_id,
                network_groups=list(req.network_groups),
                profile=req.profile)
            self.instances[inst.id] = inst
            if tok:
                self._token_instances[tok] = inst.id
            return inst
        # failure taxonomy (reference errors.go:68-227): pure address
        # exhaustion → InsufficientFreeAddresses analog; pure capacity-type
        # drought → UnfulfillableCapacity analog; anything mixed falls back
        # to per-offering ICE (the provisioner marks pools individually)
        if no_ip_zones and not exhausted and not outage_types:
            return ZoneExhaustedError(sorted(no_ip_zones))
        if outage_types and not exhausted and not no_ip_zones:
            return CapacityTypeUnfulfillableError(sorted(outage_types))
        return InsufficientCapacityError(exhausted or
                                         [(o.instance_type, o.zone, o.capacity_type)
                                          for o in req.overrides])

    def _zone_has_ip(self, zone: str) -> bool:
        return zone not in self.zone_ips or self.zone_ips[zone] > 0

    def terminate(self, instance_ids: List[str]) -> None:
        self.api_calls["terminate"] += 1
        if not self._terminate_bucket.allow():
            raise RateLimitedError(
                "TerminateInstances throttled",
                retry_after=self._terminate_bucket.retry_after())
        for iid in instance_ids:
            inst = self.instances.get(iid)
            if inst and inst.state != "terminated":
                inst.state = "terminated"
                self._return_capacity((inst.instance_type, inst.zone,
                                       inst.capacity_type))
                if inst.zone in self.zone_ips:
                    self.zone_ips[inst.zone] += 1  # address freed

    def describe_types(self) -> List[InstanceType]:
        """DescribeInstanceTypes analog — the catalog provider's backend."""
        return list(self.types.values())

    def describe_images(self):
        """DescribeImages analog — the image provider's backend."""
        return list(self.images)

    def describe_network_groups(self) -> List[NetworkGroup]:
        """DescribeSecurityGroups analog — the netgroup resolver's backend."""
        return list(self.network_groups.values())

    # --- node profile API (IAM CreateInstanceProfile/Delete analog) ---
    def create_profile(self, name: str, role: str) -> NodeProfile:
        if name in self.profiles:
            from .provider import AlreadyExistsError
            raise AlreadyExistsError(name)
        p = NodeProfile(name=name, role=role, created_at=self.clock.now())
        self.profiles[name] = p
        return p

    def delete_profile(self, name: str) -> None:
        if name not in self.profiles:
            raise NotFoundError(name)
        del self.profiles[name]

    def update_profile_role(self, name: str, role: str) -> None:
        """Swap the role bound to a profile in place (the reference swaps
        roles on live instance profiles rather than delete/recreate —
        instanceprofile.go attaches the new role to the existing profile)."""
        if name not in self.profiles:
            raise NotFoundError(name)
        self.profiles[name].role = role

    def describe_profiles(self) -> List[NodeProfile]:
        return list(self.profiles.values())

    def describe_nodes(self) -> List[Node]:
        """The cluster's durable node objects — in k8s these live in the
        API server and survive operator restarts; the fake cloud plays that
        side too. Restart rehydration (state/rehydrate.py) rebuilds
        Store.nodes from this seam."""
        out = []
        for iid, node in self._nodes_created.items():
            inst = self.instances.get(iid)
            if inst is not None and inst.state != "terminated":
                out.append(node)
        return out

    def describe(self, instance_ids: Optional[List[str]] = None) -> List[Instance]:
        self.api_calls["describe"] += 1
        if not self._describe_bucket.allow():
            raise RateLimitedError(
                "DescribeInstances throttled",
                retry_after=self._describe_bucket.retry_after())
        if instance_ids is None:
            return [i for i in self.instances.values() if i.state != "terminated"]
        return [self.instances[i] for i in instance_ids if i in self.instances]

    # --- simulation: node materialization (kwok toNode, ec2.go:884) ---
    def tick(self) -> List[Node]:
        """Advance the simulated kubelet side; returns newly created nodes."""
        now = self.clock.now()
        created = []
        for inst in self.instances.values():
            if inst.state != "pending":
                continue
            if now - inst.launch_time >= self.config.register_delay:
                inst.state = "running"
                node = self._to_node(inst)
                self._nodes_created[inst.id] = node
                created.append(node)
                for fn in self.on_node_created:
                    fn(node)
        for iid, node in list(self._nodes_created.items()):
            inst = self.instances.get(iid)
            if inst is None or inst.state == "terminated":
                continue
            if iid in self.unhealthy:
                node.ready = False
                continue
            if not node.ready and now - inst.launch_time >= self.config.node_ready_delay:
                node.ready = True
                for fn in self.on_node_ready:
                    fn(node)
        return created

    def _to_node(self, inst: Instance) -> Node:
        it = self.types[inst.instance_type]
        labels = it.node_labels(inst.zone, inst.capacity_type)
        return Node(
            name=f"node-{inst.id}", provider_id=inst.provider_id,
            labels=labels, capacity=Resources(it.capacity),
            allocatable=it.allocatable(), ready=False,
            created_at=self.clock.now())

    def describe_zone_capacity(self) -> Dict[str, float]:
        """Free addresses per zone (DescribeSubnets available-IP analog,
        reference subnet.go:135) — the provisioner's in-flight accounting
        reads this once per launch batch. Unconfigured zones are
        unlimited."""
        import math
        zones = {o.zone for t in self.types.values() for o in t.offerings}
        return {z: float(self.zone_ips.get(z, math.inf)) for z in zones}

    def describe_spot_prices(self) -> Dict[Tuple[str, str], float]:
        """DescribeSpotPriceHistory analog: the live zonal spot book."""
        return dict(self.spot_prices)

    def set_spot_price(self, instance_type: str, zone: str, price: float) -> None:
        self.spot_prices[(instance_type, zone)] = price

    def walk_spot_prices(self, seed: int = 0, pct: float = 0.2) -> None:
        """Chaos: jitter every spot price by ±pct (market movement)."""
        import random
        rng = random.Random(seed)
        for k, v in self.spot_prices.items():
            self.spot_prices[k] = max(1e-4, v * (1 + rng.uniform(-pct, pct)))

    def set_capacity_type_outage(self, capacity_type: str,
                                 active: bool = True) -> None:
        """Chaos: fleet-wide drought for a capacity type — every launch
        whose overrides are all this type fails UnfulfillableCapacity."""
        if active:
            self.captype_outages.add(capacity_type)
        else:
            self.captype_outages.discard(capacity_type)

    def expire_reservation(self, reservation_id: str) -> None:
        self.expired_reservations.add(reservation_id)

    def make_unhealthy(self, instance_id: str) -> None:
        """Chaos: the instance's kubelet stops reporting Ready."""
        self.unhealthy.add(instance_id)

    # --- chaos (kwok StartKillNodeThread analog) ---
    def kill_instance(self, instance_id: str, reason: str = "chaos") -> None:
        inst = self.instances.get(instance_id)
        if not inst:
            raise NotFoundError(instance_id)
        inst.state = "terminated"
        from .messages import state_change_event
        self.interruptions.append(state_change_event(
            instance_id, inst.provider_id, "terminated", self.clock.now()))

    def send_spot_interruption(self, instance_id: str) -> None:
        """Queue a 2-minute spot reclaim warning as RAW event-bus JSON —
        the consumer gets wire bytes, not pre-parsed structures."""
        inst = self.instances.get(instance_id)
        if not inst:
            raise NotFoundError(instance_id)
        from .messages import spot_interruption_event
        self.interruptions.append(spot_interruption_event(
            instance_id, inst.provider_id, self.clock.now()))

    def send_rebalance_recommendation(self, instance_id: str) -> None:
        inst = self.instances.get(instance_id)
        if not inst:
            raise NotFoundError(instance_id)
        from .messages import rebalance_recommendation_event
        self.interruptions.append(rebalance_recommendation_event(
            instance_id, inst.provider_id, self.clock.now()))

    def send_scheduled_change(self, instance_ids: List[str]) -> None:
        missing = [i for i in instance_ids if i not in self.instances]
        if missing or not instance_ids:
            # same contract as the other senders — silently filtering
            # would enqueue an empty-entity event our own parser rejects
            raise NotFoundError(",".join(missing) or "<no instances>")
        insts = [self.instances[i] for i in instance_ids]
        from .messages import scheduled_change_event
        self.interruptions.append(scheduled_change_event(
            [i.id for i in insts], [i.provider_id for i in insts],
            self.clock.now()))

    def send_raw_message(self, raw: str) -> None:
        """Inject arbitrary queue bytes (garbage, unknown kinds) — the
        consumer must survive anything that lands here."""
        self.interruptions.append(raw)

    def poll_interruptions(self, max_messages: int = 10) -> List[str]:
        """SQS-style receive of raw JSON payloads (messages must be acked
        with delete_message)."""
        return list(itertools.islice(self.interruptions, max_messages))

    def delete_message(self, msg: str) -> None:
        # acks arrive in poll order, so the head-pop fast path is O(1);
        # a 15k-message drain through list.remove was O(n^2) and dominated
        # the interruption throughput benchmark
        q = self.interruptions
        if q and q[0] is msg:
            q.popleft()
        elif msg in q:
            q.remove(msg)

    # --- snapshot / restore (kwok ConfigMap backup analog) ---
    def snapshot(self) -> dict:
        return {
            "instances": {k: vars(v).copy() for k, v in self.instances.items()},
            "capacity_pools": dict(self.capacity_pools),
            "zone_ips": dict(self.zone_ips),
            "token_instances": dict(self._token_instances),
        }

    def restore(self, snap: dict) -> None:
        self.instances = {k: Instance(**v) for k, v in snap["instances"].items()}
        self.capacity_pools = dict(snap["capacity_pools"])
        self.zone_ips = dict(snap.get("zone_ips", {}))
        self._token_instances = dict(snap.get("token_instances", {}))
