"""Carry encoded state across from plain arrays.

For this system the "weights" are the encoded catalog, the encoded pods and
the existing nodes. These constructors take plain numpy arrays, lists and
dicts — for instance `vars()` of the JAX package's CatalogTensors,
EncodedPods and VirtualNode — and build this package's own dataclasses, so
a caller can feed both packages the same encoded input without this
package importing the other. Arrays are copied; keys that are not fields
of the target (caches, memos) are ignored.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, List, Mapping

import numpy as np

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
