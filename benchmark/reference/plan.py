"""The reference's scale-up plan: plain first-fit-decreasing in NumPy.

The autoscaler's documented policy (Karpenter's designs/bin-packing.md):
pods that share requests and terms form a group; groups go in
decreasing (cpu, memory) order; each group first fills the nodes already
opened, in the order they opened, and then opens new nodes of the type
whose cheapest fitting offering costs least per pod it holds; a launched
node takes its cheapest offering left in its zones and capacity types.
Metal and accelerator types serve no pod that does not ask for one,
capacity blocks serve no pool that does not target reserved capacity,
and each daemonset the pool's nodes run is reserved on every type it
selects. The arithmetic is float32 in device units (cores, MiB, pods),
with the same 1e-4 slack on a division, so that on plain pods this plan
is the program's node for node.

Pod terms are handled by simple rules that keep every guarantee, not by
the program's pre-passes: a zone-spread deployment is split evenly over
its zones; app k of a zone anti-affinity ring is pinned to zone k; a pod
with hostname anti-affinity to its own label takes a node of its own
among its kind; a bundle joined by hostname affinity is one unit. On
such pods the plan is a yardstick of cost, not the program's answer.

Nothing here imports the program: it reads the catalog's and the pods'
plain data (`reference/catalog.py`, the harness's pod columns).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import catalog as K

EPS = np.float32(1e-4)
BIG = 10**9
F32_MAX = np.float32(np.finfo(np.float32).max)
RES = (K.CPU, K.MEMORY, K.PODS)          # the resources pods here request
SCALE = {K.CPU: 1.0, K.MEMORY: K.MIB, K.PODS: 1.0}


@dataclass
class Catalog:
    names: List[str]
    zones: List[str]
    alloc: np.ndarray       # f32 [T, 3] after the daemonsets' reservation
    price: np.ndarray       # f32 [T, Z, C], inf where no offering
    avail: np.ndarray       # bool [T, Z, C], capacity blocks removed
    exotic: np.ndarray      # bool [T]
    index: Dict[str, int] = field(default_factory=dict)


def tolerates(tolerates_pool: bool, pool: dict) -> bool:
    return tolerates_pool or not pool.get("taints")


def build_catalog(types: List[dict], pool: dict,
                  daemonsets: List[dict]) -> Catalog:
    zones = sorted({o["zone"] for t in types for o in t["offerings"]})
    zi = {z: i for i, z in enumerate(zones)}
    ci = {c: i for i, c in enumerate(K.CAPACITY_TYPES)}
    T, Z, C = len(types), len(zones), len(K.CAPACITY_TYPES)
    alloc = np.zeros((T, len(RES)), np.float32)
    price = np.full((T, Z, C), np.inf, np.float32)
    avail = np.zeros((T, Z, C), bool)
    block = np.zeros((T, Z, C), bool)
    exotic = np.zeros(T, bool)
    for i, t in enumerate(types):
        kube, system, evict = t["overhead"]
        for j, r in enumerate(RES):
            total = ((kube.get(r, 0.0) + system.get(r, 0.0))
                     + evict.get(r, 0.0))
            alloc[i, j] = max(0.0, t["capacity"].get(r, 0.0) - total) / SCALE[r]
        for o in t["offerings"]:
            a, b = zi[o["zone"]], ci[o["capacity_type"]]
            price[i, a, b] = o["price"]
            avail[i, a, b] = True
            block[i, a, b] = (o["reservation_id"] is not None
                              and o["reservation_type"] == K.CAPACITY_BLOCK)
        cap = t["capacity"]
        exotic[i] = (cap.get(K.NVIDIA_GPU, 0) > 0 or cap.get(K.TPU_CHIP, 0) > 0
                     or t["labels"].get(K.SIZE) == "metal")
    avail &= ~block
    base = np.zeros((T, len(RES)), np.float32)
    for ds in daemonsets:
        if not tolerates(ds.get("tolerates_pool", False), pool):
            continue
        sel = ds.get("node_selector", {})
        mask = np.array([all(t["labels"].get(k) == v for k, v in sel.items())
                         for t in types], bool)
        if not mask.any():
            continue
        req = {r: quantity(v) for r, v in ds["requests"].items()}
        req[K.PODS] = req.get(K.PODS, 0.0) + 1.0
        v = np.array([req.get(r, 0.0) / SCALE[r] for r in RES], np.float32)
        base[mask] += v
    alloc = np.maximum(alloc - base, np.float32(0.0))
    return Catalog([t["name"] for t in types], zones, alloc, price, avail,
                   exotic, {t["name"]: i for i, t in enumerate(types)})


def quantity(q) -> float:
    if isinstance(q, (int, float)):
        return float(q)
    units = {"m": 1e-3, "Ki": 2.0**10, "Mi": 2.0**20, "Gi": 2.0**30}
    for suffix, scale in units.items():
        if q.endswith(suffix):
            return float(q[: -len(suffix)]) * scale
    return float(q)


@dataclass
class Group:
    """Pods the plan treats as one: same requests, same class; a bundle
    is one group whose unit is the whole bundle."""
    cls: int
    req: np.ndarray          # f32 [3] a unit's request
    sort_key: tuple
    keys: List[str]          # pod keys, in input order
    unit: int = 1            # pods a unit holds
    zones: Optional[np.ndarray] = None   # bool [Z]
    max_per_node: int = 0
    solo: bool = False


@dataclass
class Plan:
    nodes: List[Tuple[int, int, int, float]]    # (type, zone, captype, $/hr)
    members: List[Dict[Tuple[int, int, int], int]]  # node -> {signature: n}
    unschedulable: List[str]
    groups: int = 0          # group steps of the scan
    node_steps: int = 0      # open nodes a step's first fit looks at, summed
    placements: int = 0      # (group, node) pairs that took pods

    def cost(self) -> float:
        return float(sum(p for _, _, _, p in self.nodes))


def pod_signatures(pods) -> List[Tuple[int, int, int]]:
    """Each pod's (class, cpu index, memory index): pods with the same
    signature are interchangeable."""
    return list(zip(pods.cls.tolist(), pods.cpu_idx.tolist(),
                    pods.mem_idx.tolist()))


def groups_of(pods, cat: Catalog, pool: dict) -> Tuple[List[Group], List[str]]:
    cpu, mem = pods.cpu(), pods.mem()
    keys = pods.keys()
    by: Dict[tuple, List[int]] = {}
    bundles: Dict[int, List[int]] = {}
    for i, sig in enumerate(pod_signatures(pods)):
        if pods.classes[sig[0]].affinity is not None:
            bundles.setdefault(sig[0], []).append(i)
        else:
            by.setdefault(sig, []).append(i)
    out, dropped = [], []
    Z = len(cat.zones)
    for (c, _, _), idx in list(by.items()) + [((c, 0, 0), idx)
                                               for c, idx in bundles.items()]:
        pc = pods.classes[c]
        if not tolerates(pc.tolerates, pool):
            dropped.extend(keys[i] for i in idx)
            continue
        units = [idx] if pc.affinity is not None else [[i] for i in idx]
        r = np.zeros(len(RES), np.float64)
        for i in units[0]:
            r += (cpu[i], mem[i] / K.MIB, 1.0)
        zones = None
        if pc.zones is not None:
            zones = np.array([z in pc.zones for z in cat.zones], bool)
        solo = (pc.anti is not None and pc.anti["topology"] == "hostname"
                and all(pc.labels.get(k) == v
                        for k, v in pc.anti["selector"].items()))
        first = units[0][0]
        g = Group(cls=c, req=r.astype(np.float32),
                  sort_key=(-float(r[0]), -float(r[1] * K.MIB), pods.names[first]),
                  keys=[keys[i] for u in units for i in u], unit=len(units[0]),
                  zones=zones, max_per_node=1 if solo else 0, solo=solo)
        if pc.anti is not None and pc.anti["topology"] == "zone":
            # a ring of apps: app k keeps to zone k (mod the zones)
            k = int(pc.labels["app"][len("zanti"):])
            g.zones = np.zeros(Z, bool)
            g.zones[k % Z] = True
        if pc.spread is not None:
            out.extend(_spread(g, len(units), cat))
            continue
        out.append(g)
    out.sort(key=lambda g: g.sort_key)
    return out, dropped


def _spread(g: Group, n: int, cat: Catalog) -> List[Group]:
    """A zone-spread group split evenly over its zones, lowest index
    first with the remainder."""
    zones = np.flatnonzero(g.zones if g.zones is not None
                           else np.ones(len(cat.zones), bool))
    out, at = [], 0
    for j, z in enumerate(zones):
        m = n // len(zones) + (1 if j < n % len(zones) else 0)
        if m == 0:
            continue
        row = np.zeros(len(cat.zones), bool)
        row[z] = True
        out.append(Group(g.cls, g.req, g.sort_key, g.keys[at: at + m],
                         g.unit, row, g.max_per_node, g.solo))
        at += m
    return out


def bf16(x):
    """float32 values rounded to bfloat16 (to nearest, ties to even),
    kept as float32."""
    a = np.asarray(x, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


def solve(pods, cat: Catalog, pool: dict,
          precision: str = "float32") -> Plan:
    """The plan for `pods`. The control's precision "bfloat16" rounds
    every value of the fit and each price per slot to bfloat16."""
    q = bf16 if precision == "bfloat16" else (lambda x: x)
    groups, dropped = groups_of(pods, cat, pool)
    sigs = pod_signatures(pods)
    sig_of = dict(zip(pods.keys(), sigs))
    alloc = q(cat.alloc)
    price = q(cat.price)
    T, Z, C = cat.price.shape
    zones_any = cat.avail.any(axis=2)              # [T, Z]
    caps_any = cat.avail.any(axis=1)               # [T, C]
    n_max = 1024
    ntype = np.zeros(n_max, np.int64)
    cum = np.zeros((n_max, len(RES)), np.float32)
    zmask = np.zeros((n_max, Z), bool)
    solo_on = np.zeros(n_max, bool)
    members: List[Dict] = []
    N = 0
    unsched: List[str] = list(dropped)
    node_steps = placements = 0
    for g in groups:
        node_steps += N
        req = q(g.req)
        with_req = np.where(req > 0, req, np.float32(1.0))
        gz = g.zones if g.zones is not None else np.ones(Z, bool)
        compat = ~cat.exotic
        rem = len(g.keys) // g.unit
        cap = g.max_per_node or BIG
        placed: List[Tuple[int, int]] = []
        if N:
            t = ntype[:N]
            zm = zmask[:N] & gz[None, :]
            ok = compat[t] & (cat.avail[t] & zm[:, :, None]).any(axis=(1, 2))
            if g.solo:
                ok &= ~solo_on[:N]
            k = np.where(req[None, :] > 0,
                         np.floor(q(q(alloc[t] - cum[:N]) / with_req[None, :])
                                  + EPS), np.float32(BIG)).min(axis=1)
            take = np.minimum(np.maximum(k, 0).astype(np.int64), cap)
            take = np.where(ok & (take >= 1), take, 0)
            before = np.cumsum(take) - take
            take = np.clip(rem - before, 0, take)
            for n in np.flatnonzero(take).tolist():
                placed.append((n, int(take[n])))
            rem -= int(take.sum())
        if rem:
            adm = (cat.avail & compat[:, None, None] & gz[None, :, None])
            slots = np.where(req[None, :] > 0,
                             np.floor(q(alloc / with_req[None, :]) + EPS),
                             np.float32(BIG)).min(axis=1)
            slots = np.minimum(np.maximum(slots, 0.0).astype(np.int64), cap)
            feas = adm & (slots[:, None, None] >= 1)
            cps = np.where(feas, q(price / np.maximum(slots, 1)[:, None, None]
                                   .astype(np.float32)), F32_MAX)
            flat = int(np.argmin(cps.reshape(-1)))
            if cps.reshape(-1)[flat] >= F32_MAX:
                unsched.extend(g.keys[len(g.keys) - rem * g.unit:])
                rem = 0
            else:
                ts = flat // (Z * C)
                s = max(int(slots[ts]), 1)
                while rem:
                    if N == n_max:
                        n_max *= 2
                        ntype = np.resize(ntype, n_max)
                        cum = np.concatenate([cum, np.zeros_like(cum)])
                        zmask = np.concatenate([zmask, np.zeros_like(zmask)])
                        solo_on = np.resize(solo_on, n_max)
                        solo_on[N:] = False
                    m = min(s, rem)
                    ntype[N], cum[N] = ts, 0
                    zmask[N] = gz & zones_any[ts]
                    solo_on[N] = False
                    members.append({})
                    placed.append((N, m))
                    N += 1
                    rem -= m
        placements += len(placed)
        at = 0
        for n, m in placed:
            if n < len(members) and n < N:
                cum[n] = q(cum[n] + q(np.float32(m) * req))
                zmask[n] &= gz
                solo_on[n] |= g.solo
                for key in g.keys[at: at + m * g.unit]:
                    sig = sig_of[key]
                    members[n][sig] = members[n].get(sig, 0) + 1
                at += m * g.unit
    nodes = []
    for n in range(N):
        t = int(ntype[n])
        masked = np.where(zmask[n][:, None] & caps_any[t][None, :]
                          & cat.avail[t], cat.price[t], np.inf)
        k = int(np.argmin(masked.reshape(-1)))
        nodes.append((t, k // C, k % C, float(masked.reshape(-1)[k])))
    return Plan(nodes, members, unsched, len(groups), node_steps, placements)


def answer(plan: Plan, pods, cat: Catalog) -> dict:
    """The plan in the program's answer form (launches with pod keys,
    no existing nodes, the unschedulable keys): pods of a signature go to
    the nodes that hold it in input order."""
    left: Dict[tuple, List[str]] = {}
    for k, sig in zip(pods.keys(), pod_signatures(pods)):
        left.setdefault(sig, []).append(k)
    gone = set(plan.unschedulable)
    for sig in left:
        left[sig] = [k for k in left[sig] if k not in gone]
    launches = []
    for (t, z, c, price), m in zip(plan.nodes, plan.members):
        keys = []
        for sig, n in m.items():
            keys += left[sig][:n]
            left[sig] = left[sig][n:]
        launches.append((cat.names[t], cat.zones[z], K.CAPACITY_TYPES[c],
                         price, keys))
    return {"launches": launches, "existing": {},
            "unschedulable": list(plan.unschedulable)}
