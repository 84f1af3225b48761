"""Instance-type catalog provider.

Reference: pkg/providers/instancetype/instancetype.go — the catalog. Pulls
raw types from a backend (fake cloud / generator), applies NodeClass zone
filtering, injects offering availability (pricing + ICE cache + reservation
bookkeeping; reference offering/offering.go:103-196), and caches the result
keyed on (nodeclass hash, ICE seqnum) so any launch failure invalidates
exactly like the reference's seqnum-keyed offering cache.

The provider is also the host→device boundary: `tensors()` returns the
flattened CatalogTensors for the solver, rebuilt only when the catalog or
availability changes (epoch counter).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from ..models.instancetype import InstanceType, Offering
from ..models.nodepool import NodeClassSpec
from ..utils.cache import INSTANCE_TYPES_TTL, TTLCache
from ..utils.clock import Clock, RealClock
from .pricing import PricingProvider
from .unavailable import UnavailableOfferings


class CatalogProvider:
    def __init__(self,
                 list_types: Callable[[], List[InstanceType]],
                 pricing: Optional[PricingProvider] = None,
                 unavailable: Optional[UnavailableOfferings] = None,
                 clock: Optional[Clock] = None):
        self.clock = clock or RealClock()
        self._list_types = list_types
        # the pricing provider shares the catalog's clock for the same
        # reason the ICE cache below does: freshness timestamps (the
        # age-based staleness alert input) must follow sim time under a
        # FakeClock, not the wall
        self.pricing = pricing or PricingProvider(clock=self.clock)
        # the ICE cache must share the provider's clock: under a sim's
        # FakeClock a wall-clock default would make 3-minute marks expire
        # on real time — never inside the sim, or mid-test at random
        self.unavailable = unavailable or UnavailableOfferings(clock=self.clock)
        self._raw_cache = TTLCache(INSTANCE_TYPES_TTL, self.clock)
        self._resolved_cache = TTLCache(INSTANCE_TYPES_TTL, self.clock)
        self._epoch = 0  # bumps when the raw catalog changes
        self._reservation_remaining: dict = {}
        self._reservation_version = 0
        self._overlays: list = []
        self._overlay_version = 0

    # --- raw catalog (UpdateInstanceTypes analog, 5m TTL) ---
    def raw_types(self) -> List[InstanceType]:
        cached = self._raw_cache.get("raw")
        if cached is None:
            cached = self._list_types()
            self._raw_cache.set("raw", cached)
            self.pricing.hydrate(cached)
            self._epoch += 1
        return cached

    def set_overlays(self, overlays: list) -> None:
        """NodeOverlay price/capacity overrides, applied at resolution."""
        self._overlays = list(overlays)
        self._overlay_version += 1

    def bump_epoch(self) -> None:
        """Force downstream re-resolution (e.g. discovered-capacity writes
        mutate raw InstanceType objects in place)."""
        self._epoch += 1
        self._resolved_cache.flush()

    def refresh(self) -> None:
        """Forced refresh (the polling controller calls this; reference
        pkg/controllers/providers/instancetype/controller.go:43)."""
        self._raw_cache.flush()
        self._resolved_cache.flush()
        self.raw_types()

    # --- resolved, availability-injected catalog (List analog) ---
    def list(self, node_class: Optional[NodeClassSpec] = None) -> List[InstanceType]:
        nc = node_class or NodeClassSpec()
        self.raw_types()  # ensure hydrated so the key sees current versions
        key = (nc.hash(),) + self._availability_version()
        cached = self._resolved_cache.get(key)
        if cached is not None:
            return cached
        from ..models.overlay import apply_overlays
        resolved = []
        from ..models import labels as L
        from ..models.resources import EPHEMERAL_STORAGE, Resources
        gib = 1024.0 ** 3
        block_bytes = (nc.block_device_gib or 0.0) * gib
        raid0 = nc.instance_store_policy == "raid0"
        for t in self.raw_types():
            offerings = self._inject_offerings(t, nc)
            if not offerings:
                continue
            capacity = t.capacity
            # ephemeral-storage capacity per NodeClass (reference
            # types.go ephemeralStorage): instanceStorePolicy=raid0 on a
            # type with local NVMe uses the NVMe array's size; otherwise
            # the block-device size. The per-NodeClass resolved cache
            # key covers both via nc.hash()
            eph = block_bytes
            if raid0:
                nvme = t.requirements.get(L.INSTANCE_LOCAL_NVME)
                if (nvme is not None and not nvme.complement
                        and len(nvme.values) == 1):
                    # a malformed label from a custom backend (multi-
                    # valued, non-numeric, non-positive) falls back to
                    # the block device rather than crashing the whole
                    # catalog list()
                    (v,) = nvme.values
                    try:
                        size = float(v)
                    except ValueError:
                        size = 0.0
                    if size > 0:
                        eph = size * gib
            if eph and capacity.get(EPHEMERAL_STORAGE) != eph:
                capacity = Resources(capacity)
                capacity[EPHEMERAL_STORAGE] = eph
            resolved.append(InstanceType(
                name=t.name, requirements=t.requirements, capacity=capacity,
                overhead=t.overhead, offerings=offerings))
        # overlays apply LAST so price adjustments act on the live injected
        # prices, not the raw catalog's
        resolved = apply_overlays(resolved, self._overlays)
        self._resolved_cache.set(key, resolved)
        return resolved

    def _availability_version(self) -> tuple:
        """Everything that can change a resolved offering: raw catalog epoch,
        ICE marks, price updates, reservation bookkeeping. (The review found
        the original (hash, seqnum) key served stale prices/reservations.)"""
        return (self._epoch, self.unavailable.seqnum, self.pricing.updates,
                self._reservation_version, self._overlay_version)

    def _inject_offerings(self, t: InstanceType, nc: NodeClassSpec) -> List[Offering]:
        out = []
        for o in t.offerings:
            if nc.zones and o.zone not in nc.zones:
                continue
            price = self.pricing.price(t.name, o.zone, o.capacity_type)
            if price is None:
                price = o.price
            available = not self.unavailable.is_unavailable(t.name, o.zone, o.capacity_type)
            rem = o.reservation_capacity
            if o.reservation_id is not None:
                rem = self._reservation_remaining.get(o.reservation_id, o.reservation_capacity)
                available = available and rem > 0
                if o.reservation_ends is not None:
                    # a capacity block past (or at) its end no longer
                    # offers anything (reference expiration semantics)
                    available = available and self.clock.now() < o.reservation_ends
            out.append(Offering(zone=o.zone, capacity_type=o.capacity_type,
                                price=price, available=available,
                                reservation_id=o.reservation_id,
                                reservation_capacity=rem,
                                reservation_type=o.reservation_type,
                                reservation_ends=o.reservation_ends))
        return out

    @property
    def epoch(self) -> tuple:
        """Changes whenever list() results may differ — cache key for the
        device-resident tensors."""
        return self._availability_version()

    # --- capacity-reservation bookkeeping (reference provider.go:34-67) ---
    def mark_reservation_launched(self, reservation_id: str, initial: int) -> None:
        rem = self._reservation_remaining.get(reservation_id, initial)
        self._reservation_remaining[reservation_id] = max(0, rem - 1)
        self._reservation_version += 1

    def mark_reservation_terminated(self, reservation_id: str, initial: int) -> None:
        rem = self._reservation_remaining.get(reservation_id, initial)
        self._reservation_remaining[reservation_id] = rem + 1
        self._reservation_version += 1
