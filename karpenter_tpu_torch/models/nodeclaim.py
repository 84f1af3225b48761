r"""NodeClaim: the node lifecycle object.

The reconcile loop's unit of work (reference ships the core NodeClaim CRD,
karpenter.sh_nodeclaims.yaml; the AWS provider converts instances <->
NodeClaims at pkg/cloudprovider/cloudprovider.go:381-444). Lifecycle:

  Pending -> Launched -> Registered -> Initialized            (happy path)
           \-> Failed (launch error / registration timeout)
  any      -> Terminating -> Terminated                       (deletion)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from .pod import Taint
from .requirements import Requirements
from .resources import Resources

_seq = itertools.count()


class Phase(str, Enum):
    PENDING = "Pending"
    LAUNCHED = "Launched"
    REGISTERED = "Registered"
    INITIALIZED = "Initialized"
    FAILED = "Failed"
    TERMINATING = "Terminating"
    TERMINATED = "Terminated"


@dataclass
class Condition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition: float = 0.0


@dataclass
class NodeClaim:
    name: str
    nodepool: str
    requirements: Requirements = field(default_factory=Requirements)
    resource_requests: Resources = field(default_factory=Resources)  # aggregated pod demand
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_class: str = "default"
    termination_grace_period: Optional[float] = None
    expire_after: Optional[float] = None

    # status
    phase: Phase = Phase.PENDING
    provider_id: Optional[str] = None  # tpu:///zone/instance-id
    instance_type: Optional[str] = None
    zone: Optional[str] = None
    capacity_type: Optional[str] = None
    price: float = 0.0
    capacity: Resources = field(default_factory=Resources)
    allocatable: Resources = field(default_factory=Resources)
    node_name: Optional[str] = None
    image_id: Optional[str] = None
    network_groups: List[str] = field(default_factory=list)
    profile: str = ""
    conditions: Dict[str, Condition] = field(default_factory=dict)
    created_at: float = 0.0
    launched_at: float = 0.0
    registered_at: float = 0.0
    initialized_at: float = 0.0
    deletion_timestamp: Optional[float] = None
    uid: int = field(default_factory=lambda: next(_seq))

    def set_condition(self, ctype: str, status: bool, reason: str = "",
                      message: str = "", now: float = 0.0) -> None:
        self.conditions[ctype] = Condition(ctype, status, reason, message, now)

    def is_deleting(self) -> bool:
        return self.deletion_timestamp is not None or self.phase in (
            Phase.TERMINATING, Phase.TERMINATED)

    def is_running(self) -> bool:
        return self.phase in (Phase.LAUNCHED, Phase.REGISTERED, Phase.INITIALIZED)
