"""API validation: the reference's CEL-rule analog.

The port's own copy of `karpenter_tpu/models/validation.py`, unchanged
in semantics.

The reference enforces these via CEL expressions injected into the CRDs
(hack/validation/{kubelet,requirements,labels}.sh; tested by the big
ec2nodeclass_validation_cel_test.go suites). Ours validates the same
invariants at object-admission time (Store.add_* call these).
"""

from __future__ import annotations

import re
from typing import List

from . import labels as L
from .nodepool import NodeClassSpec, NodePool
from .requirements import Operator


class ValidationError(ValueError):
    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


_NAME_RE = re.compile(r"^[a-z0-9]([a-z0-9.-]*[a-z0-9])?$")
_LABEL_KEY_RE = re.compile(
    r"^([a-z0-9A-Z]([a-z0-9A-Z.-]*[a-z0-9A-Z])?/)?[a-z0-9A-Z]([a-z0-9A-Z._-]*[a-z0-9A-Z])?$")

# label domains users may never set directly (reference labels.go:97-100
# restricted-tag/label regexes)
RESTRICTED_DOMAINS = ("kubernetes.io", "k8s.io")


def _restricted_domain(key: str) -> bool:
    """True for keys under a restricted domain INCLUDING subdomains
    (node.kubernetes.io/foo is restricted, mykubernetes.io/foo is not)."""
    domain = key.split("/", 1)[0] if "/" in key else ""
    return any(domain == d or domain.endswith("." + d)
               for d in RESTRICTED_DOMAINS)


def validate_nodepool(pool: NodePool) -> None:
    errors: List[str] = []
    if not _NAME_RE.match(pool.name or ""):
        errors.append(f"invalid nodepool name {pool.name!r}")
    if pool.weight < 0 or pool.weight > 100:
        errors.append("weight must be in [0, 100]")
    for k in list(pool.labels):
        if k in L.RESTRICTED_LABELS:
            errors.append(f"label {k} is restricted")
        elif _restricted_domain(k) and k not in L.WELL_KNOWN:
            errors.append(f"label domain of {k} is restricted")
        elif not _LABEL_KEY_RE.match(k):
            errors.append(f"invalid label key {k!r}")
    for key in pool.requirements.keys():
        if key in L.RESTRICTED_LABELS:
            errors.append(f"requirement on {key} is restricted")
        mv = pool.requirements.min_values(key)
        if mv is not None and (mv < 1 or mv > 50):
            errors.append(f"minValues for {key} must be in [1, 50]")
        vs = pool.requirements.get(key)
        if key in L.NUMERIC_LABELS and vs is not None and not vs.complement:
            for v in vs.values:
                try:
                    float(v)
                except ValueError:
                    errors.append(f"{key} requires numeric values, got {v!r}")
    for t in pool.taints + pool.startup_taints:
        if t.effect not in ("NoSchedule", "PreferNoSchedule", "NoExecute"):
            errors.append(f"invalid taint effect {t.effect!r}")
        if not t.key:
            errors.append("taint key must be set")
    for b in pool.disruption.budgets:
        s = b.nodes.strip()
        if s.endswith("%"):
            try:
                pct = float(s[:-1])
                if pct < 0 or pct > 100:
                    errors.append(f"budget percentage {s!r} out of range")
            except ValueError:
                errors.append(f"invalid budget {s!r}")
        else:
            try:
                if int(s) < 0:
                    errors.append(f"budget {s!r} must be >= 0")
            except ValueError:
                errors.append(f"invalid budget {s!r}")
        # reference CEL: "'schedule' must be set with 'duration'"
        # (karpenter.sh_nodepools.yaml:140-141)
        if (b.schedule is None) != (b.duration is None):
            errors.append("budget schedule must be set with duration")
        if b.schedule is not None:
            from ..utils.cron import CronError, parse
            try:
                parse(b.schedule)
            except CronError as e:
                errors.append(f"invalid budget schedule: {e}")
        if b.duration is not None and b.duration <= 0:
            errors.append("budget duration must be positive")
    if pool.expire_after is not None and pool.expire_after <= 0:
        errors.append("expireAfter must be positive")
    if pool.disruption.consolidation_policy not in (
            "WhenEmpty", "WhenEmptyOrUnderutilized"):
        errors.append(
            f"invalid consolidationPolicy {pool.disruption.consolidation_policy!r}")
    if errors:
        raise ValidationError(errors)


def validate_nodeclass(nc: NodeClassSpec) -> None:
    errors: List[str] = []
    if not _NAME_RE.match(nc.name or ""):
        errors.append(f"invalid nodeclass name {nc.name!r}")
    if nc.block_device_gib <= 0:
        errors.append("blockDevice size must be positive")
    if nc.instance_store_policy not in ("", "raid0"):
        errors.append("instanceStorePolicy must be '' or 'raid0'")
    if nc.kubelet_max_pods is not None and not 1 <= nc.kubelet_max_pods <= 1024:
        errors.append("kubelet maxPods must be in [1, 1024]")
    if nc.metadata_http_tokens not in ("required", "optional"):
        errors.append(f"invalid metadata_http_tokens {nc.metadata_http_tokens!r}")
    if "alias" in nc.image_selector and len(nc.image_selector) > 1:
        errors.append("image alias cannot be combined with other selectors")
    for term in nc.network_group_selectors:
        if not term:
            errors.append("network group selector term must not be empty")
        if "id" in term and len(term) > 1:
            # reference CEL on securityGroupSelectorTerms: 'id' is exclusive
            errors.append("network group 'id' term cannot combine with others")
    if nc.node_profile and nc.role != type(nc)().role and nc.role:
        # reference: spec.role and spec.instanceProfile are mutually
        # exclusive (an explicit non-default role next to a profile is a
        # config contradiction)
        errors.append("node_profile and a non-default role are exclusive")
    for k in nc.tags:
        if k.startswith("karpenter.tpu/") and k != "karpenter.tpu/cluster":
            errors.append(f"tag {k} is restricted")
    if errors:
        raise ValidationError(errors)
