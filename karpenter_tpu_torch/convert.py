"""Carry state across from plain data.

For this system the "weights" are the cluster a solve runs against: the
catalog, the NodePool and NodeClass, the daemonsets, the pods and the
existing nodes. Two levels carry it across without this package importing
the JAX one:

- the encoded level: `catalog_from_arrays`, `pods_from_arrays` and
  `nodes_from_arrays` take plain numpy arrays, lists and dicts (for
  instance `vars()` of the JAX package's CatalogTensors, EncodedPods and
  VirtualNode) and build this package's dataclasses;
- the object level: `port_object` rebuilds any model object (InstanceType,
  NodePool, NodeClassSpec, Pod, DaemonSet, NodeClaim, NodeOverlay and
  everything they hold) from an object of the same class name, read
  through `vars()`, so both facades can be handed one cluster.

Arrays are copied; keys that are not fields of the target (caches, memos,
interned signature ids) are ignored.
"""

from __future__ import annotations

import copy
import dataclasses
from enum import Enum
from typing import Any, Iterable, List, Mapping

import numpy as np

from .models import instancetype, nodeclaim, nodepool, overlay, pod
from .models.requirements import Operator, Requirements, ValueSet
from .models.resources import Resources
from .ops.binpack import VirtualNode
from .ops.encode import CatalogTensors, EncodedPods, PodGroup


def _fields(cls, d: Mapping) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (np.array(v, copy=True) if isinstance(v, np.ndarray)
                else copy.deepcopy(v) if isinstance(v, (dict, list)) else v)
            for k, v in d.items() if k in names}


def catalog_from_arrays(d: Mapping) -> CatalogTensors:
    """CatalogTensors from its fields (names, zones, captypes, resources,
    allocatable, price, available, reservation_cap, label_keys, vocab,
    label_val, numeric_keys, label_num, and optionally name_to_idx,
    is_block, zone_overhead)."""
    kw = _fields(CatalogTensors, d)
    kw["captypes"] = tuple(kw["captypes"])
    kw["resources"] = tuple(kw["resources"])
    return CatalogTensors(**kw)


def pods_from_arrays(d: Mapping) -> EncodedPods:
    """EncodedPods from its array fields. `groups` may be omitted: the
    solve reads only the group count, so each row then gets an empty
    placeholder group (such an encoding cannot be spread-split again)."""
    d = dict(d)
    groups = d.pop("groups", None)
    kw = _fields(EncodedPods, d)
    if groups is None:
        G = len(kw["counts"])
        groups = [PodGroup(pods=[], representative=None) for _ in range(G)]
    return EncodedPods(groups=list(groups), **kw)


def nodes_from_arrays(nodes: Iterable[Mapping]) -> List[VirtualNode]:
    """VirtualNodes from per-node field dicts (type_idx, zone_mask,
    cap_mask, cum, and optionally pods_by_group, existing_name,
    prior_by_group, banned_groups)."""
    out = []
    for d in nodes:
        kw = _fields(VirtualNode, d)
        kw["type_idx"] = int(kw["type_idx"])
        kw["zone_mask"] = np.asarray(kw["zone_mask"], bool)
        kw["cap_mask"] = np.asarray(kw["cap_mask"], bool)
        kw["cum"] = np.asarray(kw["cum"], np.float32)
        if kw.get("banned_groups") is not None:
            kw["banned_groups"] = np.asarray(kw["banned_groups"], bool)
        out.append(VirtualNode(**kw))
    return out


# the model classes port_object rebuilds, by class name
_MODEL_TYPES = {cls.__name__: cls for cls in (
    instancetype.Offering, instancetype.Overhead, instancetype.InstanceType,
    pod.Toleration, pod.Taint, pod.TopologySpreadConstraint,
    pod.PodAffinityTerm, pod.Pod, pod.DaemonSet, nodepool.Budget,
    nodepool.DisruptionSpec, nodepool.NodeClassSpec, nodepool.NodePool,
    nodeclaim.Condition, nodeclaim.NodeClaim, nodeclaim.Phase,
    overlay.NodeOverlay, ValueSet, Operator)}


def port_object(obj: Any) -> Any:
    """This package's copy of a model object (or a list, tuple, dict or
    set of them): the same class by name, its fields read through
    `vars()` and converted in turn. Plain values pass through, arrays
    are copied, and fields whose names start with an underscore (a pod's
    cached signature and intern id) are left to their defaults."""
    if obj is None or isinstance(obj, (bool, int, float, str)) \
            and not isinstance(obj, Enum):
        return obj
    if isinstance(obj, np.ndarray):
        return obj.copy()
    name = type(obj).__name__
    if isinstance(obj, Enum):
        return _MODEL_TYPES[name](obj.value)
    if name == "Resources":
        return Resources({k: float(v) for k, v in obj.items()})
    if name == "Requirements":
        src = vars(obj)
        out = Requirements()
        out._sets = {k: port_object(v) for k, v in src["_sets"].items()}
        out._min_values = dict(src["_min_values"])
        return out
    cls = _MODEL_TYPES.get(name)
    if cls is not None:
        src = vars(obj)
        kw = {f.name: port_object(src[f.name])
              for f in dataclasses.fields(cls)
              if f.init and not f.name.startswith("_") and f.name in src}
        return cls(**kw)
    if isinstance(obj, dict):
        return {port_object(k): port_object(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(port_object(v) for v in obj)
    raise TypeError(f"port_object: no counterpart for {name}")
