"""NodeOverlay: user-supplied price/capacity overrides on catalog entries.

Reference: the core NodeOverlay CRD (karpenter.sh_nodeoverlays.yaml:71,
shipped by the provider; NodeOverlay feature gate): a requirements
selector picks instance types, then `price` / `priceAdjustment` override
their offering prices and `capacity` injects extra (custom) resources —
e.g. advertising device plugins the cloud API doesn't report, or biasing
the solver away from types with known issues.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .instancetype import InstanceType, Offering
from .requirements import Requirements
from .resources import Resources


@dataclass
class NodeOverlay:
    name: str
    requirements: Requirements = field(default_factory=Requirements)
    # "+10%" | "-5%" | "0.25" (absolute $/hr); None = no price change
    price_adjustment: Optional[str] = None
    capacity: Resources = field(default_factory=Resources)
    weight: int = 0  # higher wins on conflicting adjustments

    def matches(self, it: InstanceType) -> bool:
        return self.requirements.compatible(it.requirements)

    def adjust_price(self, price: float) -> float:
        a = (self.price_adjustment or "").strip()
        if not a:
            return price
        if a.endswith("%"):
            return max(0.0, price * (1.0 + float(a[:-1]) / 100.0))
        return max(0.0, float(a))


def apply_overlays(types, overlays) -> list:
    """Return a catalog view with overlays applied (pure; originals
    untouched). Overlays sort by weight descending; the heaviest matching
    overlay wins per instance type for price, while capacity injections
    merge across all matching overlays."""
    if not overlays:
        return list(types)
    ordered = sorted(overlays, key=lambda o: -o.weight)
    out = []
    for t in types:
        matching = [o for o in ordered if o.matches(t)]
        if not matching:
            out.append(t)
            continue
        price_overlay = next((o for o in matching if o.price_adjustment), None)
        capacity = Resources(t.capacity)
        for o in matching:
            for k, v in o.capacity.items():
                capacity[k] = v
        offerings = [
            Offering(zone=o.zone, capacity_type=o.capacity_type,
                     price=price_overlay.adjust_price(o.price)
                     if price_overlay else o.price,
                     available=o.available, reservation_id=o.reservation_id,
                     reservation_capacity=o.reservation_capacity)
            for o in t.offerings]
        out.append(InstanceType(name=t.name, requirements=t.requirements,
                                capacity=capacity, overhead=t.overhead,
                                offerings=offerings))
    return out
