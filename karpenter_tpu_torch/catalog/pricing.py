"""Pricing provider with degraded-mode resilience.

Reference: pkg/providers/pricing/pricing.go — on-demand prices from the
Pricing API (12h refresh), zonal spot prices from DescribeSpotPriceHistory,
and a generated STATIC price table it falls back to when the Pricing API
is unreachable or the process runs isolated from it (pricing.go:58-135,
NewDefaultProvider seeds from the static table; UpdateOnDemandPricing
keeps serving the old book on API failure).

Ours reads from the cloud backend's price book and supports live spot
updates pushed by the backend. Resilience mirrors the reference's shape:
the last good book persists to a snapshot file (the static-table analog —
nothing to generate offline, so the previous run's truth is the table);
a failed or empty feed keeps serving the in-memory book, reloads the
snapshot on a cold start, and raises a staleness gauge either way so
operators can alert on old prices instead of discovering them in a bill.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

from ..models.instancetype import InstanceType


class PricingProvider:
    def __init__(self, snapshot_path: Optional[str] = None,
                 clock=None, isolated: bool = False) -> None:
        from ..utils.clock import RealClock
        self._on_demand: Dict[str, float] = {}
        self._spot: Dict[Tuple[str, str], float] = {}  # (type, zone)
        self._reserved: Dict[Tuple[str, str], float] = {}
        self.updates = 0
        self.snapshot_path = snapshot_path
        self.clock = clock or RealClock()
        # isolated mode (reference isolated-vpc): never expect a live feed;
        # serve the snapshot without flagging staleness
        self.isolated = isolated
        self.last_update: Optional[float] = None
        # which FEEDS are stale ("catalog" = the 12h hydrate, "spot" =
        # the live spot poll): a healthy spot poll must not clear a
        # staleness raised by a dead catalog feed — they fail
        # independently and the gauge is the OR
        self._stale_feeds: set = set()
        if snapshot_path:
            self._load_snapshot()

    @property
    def stale(self) -> bool:
        return bool(self._stale_feeds)

    @property
    def spot_stale(self) -> bool:
        return "spot" in self._stale_feeds

    # --- live feed ---
    def hydrate(self, types: Iterable[InstanceType]) -> None:
        """Initial/periodic sync load (reference hydrates before start,
        operator.go:151). An EMPTY book from the backend is a degraded
        feed, not new truth: keep serving the current (or snapshotted)
        prices and flag staleness."""
        od: Dict[str, float] = {}
        spot: Dict[Tuple[str, str], float] = {}
        res: Dict[Tuple[str, str], float] = {}
        for t in types:
            for o in t.offerings:
                if o.capacity_type == "on-demand":
                    od[t.name] = o.price
                elif o.capacity_type == "spot":
                    spot[(t.name, o.zone)] = o.price
                else:
                    res[(t.name, o.zone)] = o.price
        if not od and not spot and not res:
            self.feed_failed("catalog")
            return
        self._on_demand, self._spot, self._reserved = od, spot, res
        # the hydrate carries every book, so it refreshes BOTH feeds
        self._mark_fresh("catalog", "spot")

    def update_spot(self, prices: Dict[Tuple[str, str], float]) -> None:
        if not prices:
            self.feed_failed("spot")
            return
        self._spot.update(prices)
        self._mark_fresh("spot")

    def touch(self, feed: str = "spot") -> None:
        """A successful poll whose prices matched the retained book: the
        feed is ALIVE, so freshness advances (last-update timestamp +
        gauge) — otherwise age-based staleness alerting fires on a
        healthy feed that simply had nothing new to say. Deliberately
        does NOT bump `updates`: prices didn't change, and rolling the
        availability version would invalidate every downstream resolved/
        tensor cache (and the warm path) for nothing."""
        self.last_update = self.clock.now()
        self._stale_feeds.discard(feed)
        from ..metrics import PRICING_LAST_UPDATE, PRICING_STALE
        PRICING_LAST_UPDATE.set(self.last_update)
        PRICING_STALE.set(1.0 if self._stale_feeds else 0.0)

    def feed_failed(self, feed: str = "catalog") -> None:
        """The live feed errored or returned nothing: keep serving what we
        have (loading the snapshot if we have nothing), raise the gauge.
        Matches pricing.go's behavior of retaining the previous book on
        UpdateOnDemandPricing/UpdateSpotPricing failure."""
        if not self._on_demand and not self._spot and not self._reserved:
            self._load_snapshot()
        if not self.isolated:
            self._stale_feeds.add(feed)
            from ..metrics import PRICING_STALE
            PRICING_STALE.set(1.0)

    # --- bookkeeping ---
    def _mark_fresh(self, *feeds: str) -> None:
        self.updates += 1
        self.last_update = self.clock.now()
        self._stale_feeds.difference_update(feeds)
        from ..metrics import PRICING_LAST_UPDATE, PRICING_STALE
        PRICING_STALE.set(1.0 if self._stale_feeds else 0.0)
        PRICING_LAST_UPDATE.set(self.last_update)
        self._save_snapshot()

    def _save_snapshot(self) -> None:
        if not self.snapshot_path:
            return
        try:
            tmp = self.snapshot_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "on_demand": self._on_demand,
                    "spot": {f"{t}|{z}": p
                             for (t, z), p in self._spot.items()},
                    "reserved": {f"{t}|{z}": p
                                 for (t, z), p in self._reserved.items()},
                    "time": self.last_update,
                }, f)
            os.replace(tmp, self.snapshot_path)
        except OSError:
            pass  # snapshotting is best-effort; serving prices is not

    def _load_snapshot(self) -> bool:
        if not self.snapshot_path:
            return False
        try:
            with open(self.snapshot_path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False

        def unkey(m):
            return {tuple(k.split("|", 1)): float(v) for k, v in m.items()}

        self._on_demand = {k: float(v) for k, v in d.get("on_demand", {}).items()}
        self._spot = unkey(d.get("spot", {}))
        self._reserved = unkey(d.get("reserved", {}))
        self.last_update = d.get("time")
        self.updates += 1
        return True

    # --- reads ---
    def on_demand_price(self, instance_type: str) -> Optional[float]:
        return self._on_demand.get(instance_type)

    def spot_price(self, instance_type: str, zone: str) -> Optional[float]:
        return self._spot.get((instance_type, zone))

    def price(self, instance_type: str, zone: str, capacity_type: str) -> Optional[float]:
        if capacity_type == "spot":
            return self.spot_price(instance_type, zone)
        if capacity_type == "reserved":
            return self._reserved.get((instance_type, zone))
        return self.on_demand_price(instance_type)
