"""Auxiliary controllers: tagging, discovered capacity, polling refreshes,
capacity-reservation expiration.

The port's own copy of `karpenter_tpu/controllers/auxiliary.py`,
unchanged in semantics.

Reference parity:
 - tagging: pkg/controllers/nodeclaim/tagging/controller.go:48-131 — tags
   instances with Name + nodeclaim after registration.
 - discovered capacity: pkg/controllers/providers/instancetype/capacity/
   controller.go:70 — corrects the catalog's memory capacity for a type
   from real registered nodes (VM overhead estimates are conservative;
   live nodes tell the truth). 60-day cache TTL.
 - polling refresh: pkg/controllers/providers/{pricing,instancetype}/ —
   12h pricing refresh, 5m catalog refresh.
 - reservation expiration: pkg/controllers/capacityreservation/
   {capacitytype,expiration}/ — demote reserved claims to on-demand when
   their reservation expires.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..catalog.provider import CatalogProvider
from ..models import labels as L
from ..models.nodeclaim import Phase
from ..models.resources import MEMORY
from ..state.store import Store
from ..utils.cache import DISCOVERED_CAPACITY_TTL, TTLCache
from ..utils.clock import Clock

RESERVATION_ANNOTATION = "karpenter.tpu/reservation-id"


@dataclass
class TaggingController:
    store: Store
    cloud: object
    name: str = "nodeclaim.tagging"
    requeue: float = 5.0
    _tagged: set = field(default_factory=set)

    def reconcile(self, now: float) -> float:
        for claim in self.store.nodeclaims.values():
            if claim.phase not in (Phase.REGISTERED, Phase.INITIALIZED):
                continue
            if claim.name in self._tagged or not claim.provider_id:
                continue
            iid = claim.provider_id.rsplit("/", 1)[-1]
            inst = getattr(self.cloud, "instances", {}).get(iid)
            if inst is None:
                continue
            inst.tags["Name"] = claim.node_name or claim.name
            inst.tags["karpenter.tpu/nodeclaim"] = claim.name
            self._tagged.add(claim.name)
        return self.requeue


@dataclass
class DiscoveredCapacityController:
    """Learn true allocatable memory per instance type from live nodes and
    feed it back into the catalog (overrides the 7.5% VM-overhead guess)."""

    store: Store
    catalog: CatalogProvider
    name: str = "instancetype.capacity"
    requeue: float = 60.0
    _cache: Optional[TTLCache] = None
    stats: Dict[str, int] = field(default_factory=lambda: {"discovered": 0})

    def reconcile(self, now: float) -> float:
        if self._cache is None:
            self._cache = TTLCache(DISCOVERED_CAPACITY_TTL, self.catalog.clock)
        changed = False
        for node in self.store.nodes.values():
            t = node.labels.get(L.INSTANCE_TYPE)
            if not t or not node.ready:
                continue
            mem = node.capacity.get(MEMORY)
            if mem <= 0:
                continue
            known = self._cache.get(t)
            if known is None or abs(known - mem) > 1:
                self._cache.set(t, mem)
                changed = True
                self.stats["discovered"] += 1
        if changed:
            self.apply()
        return self.requeue

    def apply(self) -> None:
        for it in self.catalog.raw_types():
            mem = self._cache.get(it.name) if self._cache else None
            if mem is not None and abs(it.capacity.get(MEMORY) - mem) > 1:
                it.capacity[MEMORY] = mem
        self.catalog.bump_epoch()


@dataclass
class CatalogRefreshController:
    """5m instance-type/offering refresh + 12h pricing refresh (staleness
    SLOs from pkg/cache/cache.go). A ChangeMonitor dedupes discovery
    logging the way the reference's pretty.ChangeMonitor does
    (instancetype.go:261-266)."""

    catalog: CatalogProvider
    store: Optional[Store] = None
    # optional cloud.image.ImageProvider: invalidated every cycle so an
    # alias repoint lands within one refresh period (the reference's SSM
    # cache-invalidation controller, ssm/invalidation/controller.go:55)
    images: Optional[object] = None
    name: str = "providers.refresh"
    requeue: float = 300.0
    pricing_interval: float = 12 * 3600
    _last_pricing: float = 0.0
    _monitor: object = None

    def reconcile(self, now: float) -> float:
        from ..utils.changemonitor import ChangeMonitor
        if self._monitor is None:
            self._monitor = ChangeMonitor(clock=self.catalog.clock)
        self.catalog.refresh()
        types = self.catalog.raw_types()
        if self.store is not None and self._monitor.has_changed(
                "instance-types", sorted(t.name for t in types)):
            self.store.record_event("catalog", "instance-types", "Discovered",
                                    f"{len(types)} instance types")
        if now - self._last_pricing >= self.pricing_interval:
            # hydrate flags staleness itself when the backend hands back
            # an empty book (degraded feed ≠ new truth)
            self.catalog.pricing.hydrate(types)
            self._last_pricing = now
        if self.images is not None:
            self.images.invalidate()  # alias repoints land next resolve
        return self.requeue


@dataclass
class SpotPricingController:
    """Live zonal spot-price feed: polls the cloud's spot price book into
    the pricing provider (reference pricing.go:379 UpdateSpotPricing via
    DescribeSpotPriceHistory). A price change bumps pricing.updates, which
    rolls the catalog's availability version — the next solve (and the
    consolidation pass) sees the new prices without any explicit flush."""

    catalog: CatalogProvider
    cloud: object
    name: str = "providers.pricing.spot"
    requeue: float = 300.0  # reference polls spot pricing on minutes scale
    stats: Dict[str, int] = field(default_factory=lambda: {"updates": 0})

    def reconcile(self, now: float) -> float:
        from ..cloud.provider import CloudError
        describe = getattr(self.cloud, "describe_spot_prices", None)
        if describe is None:
            return self.requeue
        try:
            book = describe()
        except CloudError:
            # feed down: solves keep running on the last good book; the
            # staleness gauge is the operator's signal (pricing.go keeps
            # the previous prices on DescribeSpotPriceHistory failure)
            self.catalog.pricing.feed_failed("spot")
            self.stats["feed_failures"] = self.stats.get("feed_failures", 0) + 1
            return self.requeue
        if not book:
            self.catalog.pricing.feed_failed("spot")
            return self.requeue
        changed = any(self.catalog.pricing.spot_price(t, z) != p
                      for (t, z), p in book.items())
        # a successful non-empty poll is fresh truth even when the prices
        # match the retained book — SPOT staleness must not latch on after
        # a recovered feed (a dead catalog feed's staleness is its own and
        # stays up until the hydrate recovers)
        if changed or self.catalog.pricing.spot_stale:
            self.catalog.pricing.update_spot(book)
            if changed:
                self.stats["updates"] += 1
        else:
            # unchanged prices from a live feed still REFRESH freshness:
            # advance last-update (timestamp + gauge) without bumping the
            # availability version, so age-based staleness alerting can't
            # fire falsely on a quiet-but-healthy spot market
            self.catalog.pricing.touch("spot")
        return self.requeue


# capacity-block claims drain this long before the block's end time (the
# reference drains ahead of the block's scheduled teardown; AWS emits the
# interruption warning ~10 minutes out)
BLOCK_DRAIN_LEAD = 10 * 60


@dataclass
class ReservationExpirationController:
    """Two reservation flavors, two expirations (reference
    pkg/controllers/capacityreservation/{capacitytype,expiration}):

    - DEFAULT reservations: claims demote to on-demand when the
      reservation lapses (billing falls back; the node keeps running).
    - CAPACITY BLOCKS: prepaid time-boxed capacity — claims DRAIN starting
      BLOCK_DRAIN_LEAD before the block's end (the hardware goes away),
      and the block is marked expired cloud-side at its end time."""

    store: Store
    cloud: object
    catalog: Optional[CatalogProvider] = None
    termination: object = None
    name: str = "capacityreservation.expiration"
    requeue: float = 60.0
    stats: Dict[str, int] = field(default_factory=lambda: {
        "demoted": 0, "blocks_drained": 0})

    def _reservation_offerings(self) -> Dict[str, object]:
        if self.catalog is None:
            return {}
        return {o.reservation_id: o for t in self.catalog.raw_types()
                for o in t.offerings if o.reservation_id}

    def reconcile(self, now: float) -> float:
        rids = self._reservation_offerings()
        # blocks whose end time arrived are expired cloud-side (launch
        # attempts into them fail from here on)
        expired = getattr(self.cloud, "expired_reservations", set())
        for rid, o in rids.items():
            if (o.reservation_ends is not None and now >= o.reservation_ends
                    and rid not in expired
                    and hasattr(self.cloud, "expire_reservation")):
                self.cloud.expire_reservation(rid)
        for claim in list(self.store.nodeclaims.values()):
            rid = claim.annotations.get(RESERVATION_ANNOTATION)
            if not rid or claim.capacity_type != L.CAPACITY_RESERVED:
                continue
            o = rids.get(rid)
            is_block = (o is not None
                        and o.reservation_type == "capacity-block")
            if is_block:
                ends = o.reservation_ends
                ending = ((ends is not None
                           and now >= ends - BLOCK_DRAIN_LEAD)
                          or rid in expired)
                if (ending and not claim.is_deleting()
                        and self.termination is not None):
                    # blocks never demote: the prepaid hardware goes away,
                    # so the claim drains ahead of (or at) the end
                    self.termination.delete_nodeclaim(
                        claim, now, "CapacityBlockExpiring")
                    self.stats["blocks_drained"] += 1
            elif rid in expired:
                claim.capacity_type = L.CAPACITY_ON_DEMAND
                claim.labels[L.CAPACITY_TYPE] = L.CAPACITY_ON_DEMAND
                # demotion ends the reservation attachment — keeping the
                # annotation would trip capacity-reservation drift on a
                # node that is now a plain on-demand node
                del claim.annotations[RESERVATION_ANNOTATION]
                node = self.store.node_for_nodeclaim(claim)
                if node is not None:
                    node.labels[L.CAPACITY_TYPE] = L.CAPACITY_ON_DEMAND
                self.stats["demoted"] += 1
                self.store.record_event("nodeclaim", claim.name,
                                        "ReservationExpired", rid)
        return self.requeue
