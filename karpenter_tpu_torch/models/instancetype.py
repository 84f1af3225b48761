"""InstanceType + Offering: the supply side of scheduling.

The port's own copy of `karpenter_tpu/models/instancetype.py` (the
price-ordering and truncation helpers, which the port does not run, are
left out).

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
from .requirements import Operator, Requirement, Requirements
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

    def zones(self) -> List[str]:
        return sorted({o.zone for o in self.offerings})

    def node_labels(self, zone: str, capacity_type: str) -> Dict[str, str]:
        out = self.requirements.single_values()
        out[L.INSTANCE_TYPE] = self.name
        out[L.ZONE] = zone
        out[L.CAPACITY_TYPE] = capacity_type
        return out
