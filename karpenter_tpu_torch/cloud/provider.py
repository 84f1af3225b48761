"""CloudProvider interface + error taxonomy.

The port's own copy of `karpenter_tpu/cloud/provider.py`, unchanged in
semantics.

The L2 seam (reference: pkg/cloudprovider/cloudprovider.go implements the
core CloudProvider interface — Create/Delete/Get/List; pkg/errors/errors.go
classifies AWS errors into the taxonomy the controllers branch on).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple


@dataclass
class LaunchOverride:
    """One (instanceType, zone, capacityType) candidate for a launch —
    the CreateFleet override row (reference instance.go:420-467)."""

    instance_type: str
    zone: str
    capacity_type: str
    price: float
    reservation_id: Optional[str] = None
    reservation_type: str = "default"  # default | capacity-block


@dataclass
class LaunchRequest:
    nodeclaim_name: str
    overrides: List[LaunchOverride]
    image_id: str = "img-default"
    user_data: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    # network groups attached to the instance's interfaces (the security-
    # group analog; reference: launch templates carry the NodeClass's
    # resolved SGs) and the identity profile it boots with (the IAM
    # instance-profile analog, reference spec.role/spec.instanceProfile)
    network_groups: List[str] = field(default_factory=list)
    profile: str = ""
    # launch idempotency token (state/journal.launch_token — hash of
    # claim name + pool fingerprint + attempt): a cloud that has already
    # minted an instance for this token returns THAT instance instead of
    # provisioning a second one, so a request replayed across an
    # operator crash-restart cannot double-launch. Empty = no dedupe
    # (legacy callers); the provisioner always sets it.
    idempotency_token: str = ""


@dataclass
class Instance:
    id: str
    instance_type: str
    zone: str
    capacity_type: str
    image_id: str
    state: str = "pending"  # pending | running | terminated
    launch_time: float = 0.0
    tags: Dict[str, str] = field(default_factory=dict)
    price: float = 0.0
    nodeclaim: str = ""
    reservation_id: Optional[str] = None
    network_groups: List[str] = field(default_factory=list)
    profile: str = ""

    @property
    def provider_id(self) -> str:
        return f"tpu:///{self.zone}/{self.id}"


@dataclass
class NetworkGroup:
    """Security-group analog (reference pkg/providers/securitygroup):
    a named firewall/connectivity group instances attach to, discovered by
    id/name/tag selector terms."""

    id: str
    name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class NodeProfile:
    """IAM instance-profile analog (reference pkg/providers/
    instanceprofile): a managed identity binding a role to instances."""

    name: str
    role: str
    created_at: float = 0.0
    tags: Dict[str, str] = field(default_factory=dict)


# --- error taxonomy (reference pkg/errors/errors.go:68-227) ---


class CloudError(Exception):
    retryable = False


class NotFoundError(CloudError):
    pass


class AlreadyExistsError(CloudError):
    pass


class RateLimitedError(CloudError):
    """Throttled. `retry_after` is the server's own hint, in seconds (the
    HTTP 429 Retry-After header; None when the server sent none) — the
    batcher's gate honors it over the purely local exponential backoff."""

    retryable = True

    def __init__(self, msg: str = "throttled",
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


class ServerError(CloudError):
    retryable = True


class UnauthorizedError(CloudError):
    pass


class InsufficientCapacityError(CloudError):
    """ICE: specific (type, zone, captype) pools had no capacity
    (reference UnfulfillableCapacity, errors.go:172)."""

    retryable = True

    def __init__(self, offerings: Sequence[Tuple[str, str, str]], msg: str = ""):
        super().__init__(msg or f"insufficient capacity: {offerings}")
        self.offerings = list(offerings)


class ReservationExceededError(CloudError):
    retryable = True

    def __init__(self, reservation_id: str):
        super().__init__(f"reservation {reservation_id} capacity exceeded")
        self.reservation_id = reservation_id


class ZoneExhaustedError(CloudError):
    """Per-zone network/IP capacity exhausted — every candidate zone of the
    launch had no free addresses (reference InsufficientFreeAddresses,
    errors.go:180, mapped to AZ-wide unavailability). The provisioner marks
    each zone unavailable zone-wide so the next Solve avoids it."""

    retryable = True

    def __init__(self, zones: Sequence[str]):
        super().__init__(f"no free addresses in zones: {list(zones)}")
        self.zones = list(zones)


class CapacityTypeUnfulfillableError(CloudError):
    """Fleet-wide UnfulfillableCapacity: every override of the launch was a
    capacity type the cloud cannot currently fulfill at all (reference
    errors.go:172 — e.g. a spot-only fleet during a spot drought). The
    provisioner marks the capacity type unavailable cluster-wide."""

    retryable = True

    def __init__(self, capacity_types: Sequence[str]):
        super().__init__(f"unfulfillable capacity types: {list(capacity_types)}")
        self.capacity_types = list(capacity_types)


class CloudProvider(Protocol):
    """The seam controllers speak to. A real TPU-cloud backend implements
    every method here; the controllers call all of them unconditionally
    (NodeClassController/ProfileProvider drive the network-group and
    profile methods; state.rehydrate drives describe_nodes)."""

    def create_fleet(self, requests: List[LaunchRequest]) -> List["Instance | CloudError"]:
        """One instance (or error) per request; the cloud picks among each
        request's overrides (lowest-price strategy, like EC2 Fleet's
        price-capacity-optimized and kwok's LowestPrice stand-in)."""
        ...

    def terminate(self, instance_ids: List[str]) -> None: ...

    def describe(self, instance_ids: Optional[List[str]] = None) -> List[Instance]: ...

    def describe_types(self) -> List[object]:
        """DescribeInstanceTypes analog — the catalog provider's backend."""
        ...

    def describe_images(self) -> List[object]:
        """DescribeImages analog — the image provider's backend."""
        ...

    def describe_nodes(self) -> List[object]:
        """The cluster's durable node objects (API-server side); restart
        rehydration rebuilds Store.nodes from this."""
        ...

    # network-group discovery (DescribeSecurityGroups analog)
    def describe_network_groups(self) -> List[NetworkGroup]: ...

    # node-profile lifecycle (IAM instance-profile analog)
    def create_profile(self, name: str, role: str) -> NodeProfile: ...

    def delete_profile(self, name: str) -> None: ...

    def update_profile_role(self, name: str, role: str) -> None: ...

    def describe_profiles(self) -> List[NodeProfile]: ...
