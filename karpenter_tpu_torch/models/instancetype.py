"""InstanceType + Offering: the supply side of scheduling.

The port's own copy of `karpenter_tpu/models/instancetype.py`, unchanged
in semantics (the port imports nothing of the JAX package).

Mirrors the reference core's `cloudprovider.InstanceType{Name, Requirements,
Offerings, Capacity, Overhead}` and `Offering{Price, Available, Requirements,
ReservationCapacity}` (constructed by the reference at
pkg/providers/instancetype/types.go:123-300 and
pkg/providers/instancetype/offering/offering.go:103-196).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import labels as L
from .requirements import Operator, Requirement, Requirements, ValueSet
from .resources import Resources


RESERVATION_DEFAULT = "default"
RESERVATION_CAPACITY_BLOCK = "capacity-block"


@dataclass
class Offering:
    zone: str
    capacity_type: str  # on-demand | spot | reserved
    price: float  # $/hr
    available: bool = True
    reservation_id: Optional[str] = None
    reservation_capacity: int = 0  # remaining instances for reserved offerings
    # reservation flavor (reference CapacityReservationType,
    # filter.go:73-228): "default" ODCRs fall back freely; "capacity-block"
    # reservations are prepaid time-boxed blocks — a launch targets exactly
    # one block and its instances drain before the block ends
    reservation_type: str = RESERVATION_DEFAULT
    # absolute end time for capacity blocks (None = open-ended)
    reservation_ends: Optional[float] = None

    def requirements(self) -> Requirements:
        r = Requirements(
            Requirement(L.ZONE, Operator.IN, (self.zone,)),
            Requirement(L.CAPACITY_TYPE, Operator.IN, (self.capacity_type,)),
        )
        return r


@dataclass
class Overhead:
    """Reserved-out capacity (reference types.go:493-559: kube-reserved,
    system-reserved, eviction thresholds)."""

    kube_reserved: Resources = field(default_factory=Resources)
    system_reserved: Resources = field(default_factory=Resources)
    eviction_threshold: Resources = field(default_factory=Resources)

    def total(self) -> Resources:
        return self.kube_reserved.add(self.system_reserved).add(self.eviction_threshold)


@dataclass
class InstanceType:
    name: str
    requirements: Requirements
    capacity: Resources
    overhead: Overhead = field(default_factory=Overhead)
    offerings: List[Offering] = field(default_factory=list)

    def allocatable(self) -> Resources:
        alloc = self.capacity.sub(self.overhead.total())
        return Resources({k: max(0.0, v) for k, v in alloc.items()})

    def available_offerings(self) -> List[Offering]:
        return [o for o in self.offerings if o.available]

    def cheapest_price(self, zones: Optional[set] = None,
                       capacity_types: Optional[set] = None) -> Optional[float]:
        prices = [
            o.price for o in self.offerings
            if o.available
            and (zones is None or o.zone in zones)
            and (capacity_types is None or o.capacity_type in capacity_types)
        ]
        return min(prices) if prices else None

    def zones(self) -> List[str]:
        return sorted({o.zone for o in self.offerings})

    def node_labels(self, zone: str, capacity_type: str) -> Dict[str, str]:
        out = self.requirements.single_values()
        out[L.INSTANCE_TYPE] = self.name
        out[L.ZONE] = zone
        out[L.CAPACITY_TYPE] = capacity_type
        return out


def sort_by_price(types: List[InstanceType], zones: Optional[set] = None,
                  capacity_types: Optional[set] = None) -> List[InstanceType]:
    """Cheapest-first ordering (reference InstanceTypes.OrderByPrice)."""
    def key(it: InstanceType):
        p = it.cheapest_price(zones, capacity_types)
        return (p is None, p if p is not None else 0.0)
    return sorted(types, key=key)


def truncate(types: List[InstanceType], requirements: Requirements,
             limit: int = 60) -> List[InstanceType]:
    """Cheapest-`limit` types, honoring minValues flexibility floors.

    Reference: InstanceTypes.Truncate (used at
    pkg/providers/instance/instance.go:293, MaxInstanceTypes=60
    instance.go:62). minValues turns truncation into constrained selection:
    after truncation every keyed minValues must still count >= that many
    distinct compatible values; raise if unsatisfiable.
    """
    ordered = sort_by_price(types)
    mv_keys = [k for k in requirements.keys() if requirements.min_values(k)]
    if not mv_keys:
        return ordered[:limit]
    # Constrained selection under the hard `limit` cap: first reserve slots
    # for types contributing missing distinct values (cheapest contributor per
    # value, only values the requirement actually allows), then fill the rest
    # cheapest-first. Error (like the reference's Truncate) if minValues can't
    # be met within `limit`.
    selected: List[InstanceType] = []
    chosen = set()
    for key in mv_keys:
        need = requirements.min_values(key) or 0
        want = requirements.get(key)
        have = _distinct_values(selected, key, want)
        for cand in ordered:
            if len(have) >= need:
                break
            if id(cand) in chosen:
                continue
            new = _distinct_values([cand], key, want) - have
            if new:
                selected.append(cand)
                chosen.add(id(cand))
                have |= new
        if len(have) < need:
            raise ValueError(
                f"minValues {need} for {key} unsatisfiable: only {len(have)} "
                f"distinct compatible values across {len(ordered)} instance types")
    if len(selected) > limit:
        raise ValueError(
            f"minValues requirements need {len(selected)} instance types but "
            f"truncation limit is {limit}")
    for cand in ordered:
        if len(selected) >= limit:
            break
        if id(cand) not in chosen:
            selected.append(cand)
            chosen.add(id(cand))
    return sort_by_price(selected)


def _distinct_values(types: List[InstanceType], key: str,
                     want: "ValueSet | None" = None) -> set:
    """Distinct values of `key` across `types`, filtered to those the
    requirement's own value set allows (minValues counts compatible values,
    not just any values)."""
    out = set()
    for it in types:
        vs = it.requirements.get(key)
        if vs is not None and not vs.complement:
            for v in vs.values:
                if want is None or want.contains(v):
                    out.add(v)
    return out
