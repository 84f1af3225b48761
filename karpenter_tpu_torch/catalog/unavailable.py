"""UnavailableOfferings — the ICE (insufficient-capacity) feedback cache.

Reference: pkg/cache/unavailableofferings.go:35-136. Launch failures mark
(instanceType, zone, capacityType) unavailable for 3 minutes so the next
Solve() avoids them; capacity-type-wide and zone-wide marks are supported;
an atomic sequence number invalidates downstream offering caches and — in
our build — triggers re-upload of the availability tensor to device.

Observability seams (used by the faults/ chaos harness and the degraded-
mode surface): `on_mark` callbacks fire on every mark with its key, and
the live-mark count is published on the degraded-mode gauge
(component="capacity") so an ICE storm is visible in /metrics while it
lasts and clears as the marks expire.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..utils.cache import UNAVAILABLE_OFFERINGS_TTL, TTLCache
from ..utils.clock import Clock


class UnavailableOfferings:
    def __init__(self, clock: Optional[Clock] = None, ttl: float = UNAVAILABLE_OFFERINGS_TTL):
        self._cache = TTLCache(ttl, clock)
        self._seqnum = 0
        # fired on every mark with (kind, key-tuple, reason); kind is one
        # of "offering" / "capacity-type" / "zone"
        self.on_mark: List[Callable[[str, tuple, str], None]] = []
        self.stats = {"marks": 0}

    @property
    def seqnum(self) -> int:
        """Monotonic change counter; embed in downstream cache keys
        (reference offering.go:113-121 keys its cache on this). A mark
        EXPIRING is a change too — without the prune-and-bump here, the
        resolved catalog would keep serving the baked-in unavailability
        long after the 3-minute mark lapsed."""
        if self._cache.prune():
            self._seqnum += 1
            self._publish()
        return self._seqnum

    def active(self) -> int:
        """Live (unexpired) marks right now."""
        return len(self._cache)

    def _publish(self) -> None:
        from ..metrics import DEGRADED_MODE
        DEGRADED_MODE.set(float(len(self._cache)), component="capacity")

    def _marked(self, kind: str, key: tuple, reason: str) -> None:
        self._seqnum += 1
        self.stats["marks"] += 1
        self._publish()
        for fn in self.on_mark:
            fn(kind, key, reason)

    def mark_unavailable(self, instance_type: str, zone: str,
                         capacity_type: str, reason: str = "") -> None:
        self._cache.set(("o", instance_type, zone, capacity_type), reason or True)
        self._marked("offering", (instance_type, zone, capacity_type), reason)

    def mark_capacity_type_unavailable(self, capacity_type: str) -> None:
        """E.g. a fleet-wide spot UnfulfillableCapacity error."""
        self._cache.set(("c", capacity_type), True)
        self._marked("capacity-type", (capacity_type,), "")

    def mark_zone_unavailable(self, zone: str) -> None:
        """E.g. InsufficientFreeAddresses in a subnet (errors.go:180)."""
        self._cache.set(("z", zone), True)
        self._marked("zone", (zone,), "")

    def is_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> bool:
        return (self._cache.get(("o", instance_type, zone, capacity_type)) is not None
                or self._cache.get(("c", capacity_type)) is not None
                or self._cache.get(("z", zone)) is not None)

    def flush(self) -> None:
        self._cache.flush()
        self._seqnum += 1
        self._publish()
