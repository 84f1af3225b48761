"""Scheduling models (the port's own copies of `karpenter_tpu.models`)."""

from . import labels
from .instancetype import InstanceType, Offering, Overhead
from .nodeclaim import NodeClaim
from .nodepool import NodeClassSpec, NodePool
from .pod import (DaemonSet, Pod, PodAffinityTerm, Taint, Toleration,
                  TopologySpreadConstraint)
from .requirements import Operator, Requirement, Requirements, ValueSet
from .resources import Resources, parse_quantity

__all__ = ["labels", "InstanceType", "Offering", "Overhead", "NodeClaim",
           "NodeClassSpec", "NodePool", "DaemonSet", "Pod",
           "PodAffinityTerm", "Taint", "Toleration",
           "TopologySpreadConstraint", "Operator", "Requirement",
           "Requirements", "ValueSet", "Resources", "parse_quantity"]
