"""NodePool + NodeClass: the user-facing provisioning policy API.

Parity targets:
 - NodePool CRD (reference ships karpenter.sh_nodepools.yaml): template
   requirements (with minValues), taints/startupTaints, labels, limits,
   weight, disruption policy (consolidationPolicy, consolidateAfter,
   expireAfter, budgets), nodeClassRef.
 - EC2NodeClass CRD (pkg/apis/v1/ec2nodeclass.go:32-480): zone/subnet
   selection, image selection, userdata, tags, block devices, kubelet
   config, metadata options → our TPUNodeClass analog keeps the same roles
   with cloud-neutral names (zone selectors, image family, bootstrap config).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .pod import Taint
from .requirements import Requirement, Requirements
from .resources import Resources

# Hash-schema version stamped alongside the nodeclass hash. When the set of
# fields feeding NodeClassSpec.hash() changes, bump this: drift detection
# re-stamps (instead of rolling the fleet) on nodes whose stored version
# differs (reference: karpenter.k8s.aws/ec2nodeclass-hash-version,
# ec2nodeclass.go:480 hash version v4 + the hash controller's migration).
NODECLASS_HASH_VERSION = "v3"  # v3: instance_store_policy joined the blob
NODEPOOL_HASH_VERSION = "v1"   # template static-field hash (drift)


@dataclass
class Budget:
    """Disruption budget: max simultaneous voluntary disruptions.

    nodes is an int or a percent string ("10%"); reasons limits which
    disruption methods the budget applies to; schedule/duration give a cron
    window (reference: karpenter.sh_nodepools.yaml:78-160).
    """

    nodes: str = "10%"
    reasons: Optional[List[str]] = None  # Underutilized | Empty | Drifted
    schedule: Optional[str] = None
    duration: Optional[float] = None  # seconds

    def allows(self, reason: str) -> bool:
        return self.reasons is None or reason in self.reasons

    def is_active(self, now: Optional[float]) -> bool:
        """A budget with a schedule constrains disruption only inside
        an open cron window (reference karpenter.sh_nodepools.yaml:126);
        schedule-less budgets are always active."""
        if self.schedule is None:
            return True
        if now is None or self.duration is None:
            return True  # window undecidable: stay conservative (active)
        from ..utils.cron import in_window
        return in_window(self.schedule, self.duration, now)

    def max_disruptions(self, total_nodes: int) -> int:
        s = self.nodes.strip()
        if s.endswith("%"):
            # ceil so a small pool under a percentage budget can still make
            # progress (a floor would freeze a 1-node pool at "10%" forever)
            import math
            return math.ceil(total_nodes * float(s[:-1]) / 100.0)
        return int(s)


@dataclass
class DisruptionSpec:
    consolidation_policy: str = "WhenEmptyOrUnderutilized"  # or WhenEmpty
    consolidate_after: float = 0.0  # seconds; pods must be stable this long
    budgets: List[Budget] = field(default_factory=lambda: [Budget()])

    def allowed_disruptions(self, reason: str, total_nodes: int,
                            now: Optional[float] = None) -> int:
        vals = [b.max_disruptions(total_nodes) for b in self.budgets
                if b.allows(reason) and b.is_active(now)]
        return min(vals) if vals else total_nodes


@dataclass
class NodeClassSpec:
    """Cloud-launch template (our EC2NodeClass analog)."""

    name: str = "default"
    zones: List[str] = field(default_factory=list)  # empty = all discovered
    image_family: str = "standard"  # bootstrap/image strategy selector
    image_selector: Dict[str, str] = field(default_factory=dict)
    # security-group analog: selector terms ({id}|{name}|{tag:val...}, OR'd)
    # resolved by the nodeclass controller; empty = the cloud's "default"
    # named group (the reference REQUIRES explicit terms; our abstract
    # cloud ships a default so zero-config clusters work)
    network_group_selectors: List[Dict[str, str]] = field(default_factory=list)
    # instance-profile analog: role → managed profile, or an explicit
    # pre-existing profile name (reference spec.role vs spec.instanceProfile)
    role: str = "default-node-role"
    node_profile: str = ""  # non-empty = unmanaged, used as-is
    user_data: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    block_device_gib: float = 100.0
    kubelet_max_pods: Optional[int] = None
    # instance-store policy (reference spec.instanceStorePolicy,
    # ec2nodeclass.go:441-448): "raid0" = nodes with local NVMe expose
    # the NVMe array as ephemeral storage instead of the block device
    instance_store_policy: str = ""  # "" | "raid0"
    kubelet_system_reserved: Dict[str, str] = field(default_factory=dict)
    kubelet_kube_reserved: Dict[str, str] = field(default_factory=dict)
    kubelet_eviction_hard: Dict[str, str] = field(default_factory=dict)
    metadata_http_tokens: str = "required"
    detailed_monitoring: bool = False

    def _hash_fields(self) -> dict:
        """The EXACT field set the static drift hash covers. Adding or
        removing a key here without bumping NODECLASS_HASH_VERSION would
        silently roll (or freeze) every fleet on upgrade — the hygiene
        test (tests/test_hash_version.py) pins this dict's keys to the
        version so the pair can only change together (the reference
        enforces the same discipline by bumping its hash version,
        ec2nodeclass.go:480)."""
        # selector terms (network groups) are hash-EXEMPT: their effect is
        # covered by the dynamic resolved-set drift comparison, so a
        # cosmetic selector rewrite that resolves to the same groups must
        # not roll the fleet (the reference marks securityGroupSelectorTerms
        # hash:"ignore" for exactly this reason); role/profile stay static
        return {
            "zones": sorted(self.zones),
            "image_family": self.image_family,
            "image_selector": dict(sorted(self.image_selector.items())),
            "role": self.role,
            "node_profile": self.node_profile,
            "user_data": self.user_data,
            "tags": dict(sorted(self.tags.items())),
            "block_device_gib": self.block_device_gib,
            "instance_store_policy": self.instance_store_policy,
            "kubelet": [self.kubelet_max_pods, dict(sorted(self.kubelet_system_reserved.items())),
                        dict(sorted(self.kubelet_kube_reserved.items())),
                        dict(sorted(self.kubelet_eviction_hard.items()))],
            "metadata_http_tokens": self.metadata_http_tokens,
            "detailed_monitoring": self.detailed_monitoring,
        }

    def hash(self) -> str:
        """Static drift hash (reference EC2NodeClass.Hash(),
        ec2nodeclass.go:482 — drift detection compares this against the
        hash annotation stamped on launched nodes)."""
        blob = json.dumps(self._hash_fields(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # status (populated by the nodeclass controller)
    ready: bool = True
    resolved_zones: List[str] = field(default_factory=list)
    resolved_images: List[str] = field(default_factory=list)
    resolved_network_groups: List[str] = field(default_factory=list)
    resolved_profile: str = ""


@dataclass
class NodePool:
    name: str
    requirements: Requirements = field(default_factory=Requirements)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    limits: Resources = field(default_factory=Resources)  # empty = unlimited
    weight: int = 0  # higher = preferred (reference nodepools.yaml:427-432)
    node_class: str = "default"
    disruption: DisruptionSpec = field(default_factory=DisruptionSpec)
    expire_after: Optional[float] = None  # seconds; node max lifetime
    termination_grace_period: Optional[float] = None

    def add_requirement(self, req: Requirement) -> "NodePool":
        self.requirements.add(req)
        return self

    def _hash_fields(self) -> dict:
        """The static template fields the NodePool drift hash covers
        (reference: the core stamps karpenter.sh/nodepool-hash from the
        template's static fields; requirements/limits are NOT hashed —
        requirement changes are DYNAMIC drift, compared live against the
        node's labels, and limits gate provisioning only). Pinned to
        NODEPOOL_HASH_VERSION by tests/test_hash_version.py — the pair
        changes together or not at all."""
        return {
            "labels": dict(sorted(self.labels.items())),
            "taints": sorted((t.key, t.value, t.effect)
                             for t in self.taints),
            "startup_taints": sorted((t.key, t.value, t.effect)
                                     for t in self.startup_taints),
            "node_class": self.node_class,
            "termination_grace_period": self.termination_grace_period,
        }

    def hash(self) -> str:
        """Static drift hash stamped on launched claims; a template
        change (new taint, relabel) rolls the pool via the drift pass."""
        blob = json.dumps(self._hash_fields(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def template_labels(self) -> Dict[str, str]:
        """Node labels every launched node of this pool wears: spec
        labels + single-valued requirements + the pool identity label.
        The ONE definition shared by the launch path (actual node
        labels) and the encoders (pod-selector resolution for keys the
        catalog doesn't carry) — diverging the two would schedule pods
        onto nodes that never match their selectors."""
        from . import labels as L
        return {**self.labels, **self.requirements.single_values(),
                L.NODEPOOL: self.name}

    def within_limits(self, current_usage: Resources, adding: Resources) -> bool:
        if not self.limits:
            return True
        total = current_usage.add(adding)
        for k, lim in self.limits.items():
            if total.get(k, 0.0) > lim + 1e-9:
                return False
        return True
