"""Scheduling models (the port's own copies of `karpenter_tpu.models`)."""

from . import labels
from .instancetype import InstanceType, Offering, Overhead, sort_by_price, truncate
from .nodeclaim import Node, NodeClaim, Phase, new_nodeclaim_name
from .nodepool import Budget, DisruptionSpec, NodeClassSpec, NodePool
from .pod import (DO_NOT_DISRUPT, DaemonSet, Pod, PodAffinityTerm, Taint,
                  Toleration, TopologySpreadConstraint, tolerates_all)
from .requirements import Operator, Requirement, Requirements, ValueSet
from .resources import Resources, parse_quantity, pod_requests

__all__ = [
    "labels", "InstanceType", "Offering", "Overhead", "sort_by_price",
    "truncate", "Node", "NodeClaim", "Phase", "new_nodeclaim_name", "Budget",
    "DisruptionSpec", "NodeClassSpec", "NodePool", "DO_NOT_DISRUPT",
    "DaemonSet", "Pod", "PodAffinityTerm", "Taint", "Toleration",
    "TopologySpreadConstraint", "tolerates_all", "Operator", "Requirement",
    "Requirements", "ValueSet", "Resources", "parse_quantity", "pod_requests",
]
