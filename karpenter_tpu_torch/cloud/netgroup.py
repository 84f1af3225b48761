"""Network-group resolution + node-profile management.

The port's own copy of `karpenter_tpu/cloud/netgroup.py`, unchanged in
semantics.

Network groups are the security-group analog (reference
pkg/providers/securitygroup/securitygroup.go:36-56: discovery by tag / id /
name selector terms, resolved into NodeClass status, attached at launch,
and a drift reason when the resolved set changes).

Node profiles are the IAM instance-profile analog (reference
pkg/providers/instanceprofile/instanceprofile.go:37-66: a profile is
created from `spec.role` per NodeClass, attached to instances at launch,
protected from deletion while in use, and garbage-collected when its
NodeClass is gone — pkg/controllers/nodeclass/garbagecollection).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .provider import AlreadyExistsError, NetworkGroup, NodeProfile

PROFILE_PREFIX = "karpenter-tpu"


def resolve_network_groups(groups: Sequence[NetworkGroup],
                           selectors: List[Dict[str, str]]) -> List[str]:
    """Selector terms OR together; within a term, keys AND (the reference's
    securityGroupSelectorTerms CEL shape: each term is {id} | {name} |
    {tags...}). Returns sorted group ids; empty selectors resolve nothing
    (the reference requires explicit SG terms on every EC2NodeClass)."""
    out = set()
    for term in selectors:
        for g in groups:
            if "id" in term and g.id != term["id"]:
                continue
            if "name" in term and g.name != term["name"]:
                continue
            tags = {k: v for k, v in term.items() if k not in ("id", "name")}
            if any(g.tags.get(k) != v for k, v in tags.items()):
                continue
            out.add(g.id)
    return sorted(out)


def profile_name(node_class_name: str, region: str = "region-1") -> str:
    return f"{PROFILE_PREFIX}-{node_class_name}-{region}"


@dataclass
class ProfileProvider:
    """Ensures/garbage-collects managed node profiles against the cloud.

    Protected-profile semantics (reference instanceprofile.go:239-251): a
    profile attached to any live instance is never deleted, even when its
    NodeClass is gone — the GC retries next sweep. Role changes swap the
    role on the live profile in place (the reference detaches/attaches the
    role on the existing profile; delete/recreate would deadlock on the
    in-use protection in a steadily-occupied cluster)."""

    cloud: object  # needs create/update/delete/describe_profiles + describe()

    def ensure(self, node_class_name: str, role: str,
               profiles: Optional[Dict[str, NodeProfile]] = None) -> str:
        """profiles: optional snapshot ({name: profile}) so a reconcile
        over N NodeClasses lists the cloud once, not N times."""
        name = profile_name(node_class_name)
        if profiles is None:
            profiles = {p.name: p for p in self.cloud.describe_profiles()}
        cur = profiles.get(name)
        if cur is None:
            try:
                self.cloud.create_profile(name, role)
            except AlreadyExistsError:
                pass  # lost a create race: the profile exists, which is fine
        elif cur.role != role:
            self.cloud.update_profile_role(name, role)
        return name

    def garbage_collect(self, live_node_classes: Sequence[str],
                        profiles: Optional[Sequence[NodeProfile]] = None,
                        used: Optional[set] = None) -> List[str]:
        """Delete managed profiles whose NodeClass no longer exists and
        that no live instance still uses; returns deleted names.
        profiles/used: optional snapshots shared with the caller's sweep."""
        keep = {profile_name(nc) for nc in live_node_classes}
        if profiles is None:
            profiles = self.cloud.describe_profiles()
        if used is None:
            used = {i.profile for i in self.cloud.describe()}  # one sweep
        deleted = []
        for p in list(profiles):
            if not p.name.startswith(PROFILE_PREFIX + "-"):
                continue  # unmanaged profile: never touch
            if p.name in keep or p.name in used:
                continue
            self.cloud.delete_profile(p.name)
            deleted.append(p.name)
        return deleted
