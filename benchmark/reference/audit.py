"""The reference's audit of one scale-up answer, from the pods and the
catalog alone.

`audit` judges a plain answer (launches of (type, zone, capacity type,
price, pod keys), placements onto existing nodes, unschedulable keys) by
the guarantees the autoscaler gives, and counts what breaks:

- `missing`: pods not accounted for exactly once, and keys that are no
  pod of the request;
- `infeasible`: broken guarantees, one count per node and guarantee: an
  offering that does not exist, is not available, is a capacity block or
  is priced otherwise than the catalog; a metal or accelerator type for
  pods that did not ask for one; requests over the type's allocatable
  once the pool's daemonsets are reserved (cpu, memory, pod slots); a pod
  that does not tolerate the pool's taints; a zone outside a pod's
  required zones; two pods on a node where one's hostname anti-affinity
  selects the other; two pods in a zone where one's zone anti-affinity
  selects the other; a bundle joined by hostname affinity spread over
  more than one node; a zone-spread deployment whose zones differ by more
  than its skew; a placement onto a node that does not exist;
- `wrongly_unschedulable`: pods left unschedulable that a fresh node of
  the pool could take alone.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List

import numpy as np

from . import catalog as K
from .plan import RES, Catalog, pod_signatures, tolerates

PRICE_RTOL = 1e-6          # prices travel as float32
SLACK = np.array([1e-3, 1.0, 0.0])   # cores, MiB, pod slots: float32 sums


def audit(answer: dict, pods, cat: Catalog, pool: dict) -> Dict[str, int]:
    keys = pods.keys()
    index = {k: i for i, k in enumerate(keys)}
    cpu, mem = pods.cpu(), pods.mem()
    cls = pods.cls
    classes = pods.classes
    seen = Counter()
    for *_, ks in answer["launches"]:
        seen.update(ks)
    for ks in answer["existing"].values():
        seen.update(ks)
    seen.update(answer["unschedulable"])
    missing = sum(1 for k in keys if seen.get(k, 0) != 1)
    missing += sum(1 for k in seen if k not in index)

    bad = 0
    bad += len(answer["existing"])        # no node exists before the solve
    zi = {z: i for i, z in enumerate(cat.zones)}
    ci = {c: i for i, c in enumerate(K.CAPACITY_TYPES)}
    zone_of_pod: Dict[int, str] = {}
    node_of_pod: Dict[int, int] = {}
    for n, (tname, zone, ctype, price, ks) in enumerate(answer["launches"]):
        t = cat.index.get(tname)
        if t is None or zone not in zi or ctype not in ci:
            bad += 1
            continue
        z, c = zi[zone], ci[ctype]
        if not cat.avail[t, z, c]:
            bad += 1
        elif abs(price - float(cat.price[t, z, c])) > PRICE_RTOL * max(
                1.0, abs(float(cat.price[t, z, c]))):
            bad += 1
        if cat.exotic[t]:
            bad += 1
        idx = [index[k] for k in ks if k in index]
        use = np.zeros(len(RES))
        for i in idx:
            use += (cpu[i], mem[i] / K.MIB, 1.0)
            zone_of_pod[i] = zone
            node_of_pod[i] = n
        if np.any(use > cat.alloc[t].astype(np.float64) + SLACK):
            bad += 1
        pcs = [classes[cls[i]] for i in idx]
        if any(not tolerates(pc.tolerates, pool) for pc in pcs):
            bad += 1
        if any(pc.zones is not None and zone not in pc.zones for pc in pcs):
            bad += 1
        # hostname anti-affinity: no other pod on the node it selects
        for j, pc in enumerate(pcs):
            if pc.anti is not None and pc.anti["topology"] == "hostname":
                if any(_selects(pc.anti["selector"], q.labels)
                       for m, q in enumerate(pcs) if m != j):
                    bad += 1
                    break
    # zone anti-affinity: no pod it selects in its zone
    by_zone = defaultdict(list)
    for i, z in zone_of_pod.items():
        by_zone[z].append(classes[cls[i]])
    for z, pcs in by_zone.items():
        labels = [q.labels for q in pcs]
        for pc in {id(p): p for p in pcs}.values():
            if (pc.anti is not None and pc.anti["topology"] == "zone"
                    and any(_selects(pc.anti["selector"], lab)
                            for lab in labels)):
                bad += 1
    # bundles: the pods of a hostname-affinity selector share one node
    nodes_of = defaultdict(set)
    for i, n in node_of_pod.items():
        pc = classes[cls[i]]
        if pc.affinity is not None and pc.affinity["topology"] == "hostname":
            nodes_of[tuple(sorted(pc.affinity["selector"].items()))].add(n)
    bad += sum(len(v) - 1 for v in nodes_of.values() if len(v) > 1)
    # zone spread: per selector, zone counts within the skew
    spread = defaultdict(Counter)
    skew = {}
    for i, z in zone_of_pod.items():
        pc = classes[cls[i]]
        if pc.spread is not None and pc.spread["topology"] == "zone":
            sel = tuple(sorted(pc.spread["selector"].items()))
            spread[sel][z] += 1
            skew[sel] = pc.spread["max_skew"]
    for sel, counts in spread.items():
        vals = [counts.get(z, 0) for z in cat.zones]
        if max(vals) - min(vals) > skew[sel]:
            bad += 1

    wrong = 0
    fresh = {}
    for k in answer["unschedulable"]:
        i = index.get(k)
        if i is None:
            continue
        pc = classes[cls[i]]
        if not tolerates(pc.tolerates, pool):
            continue
        sig = (int(cls[i]), float(cpu[i]), float(mem[i]))
        if sig not in fresh:
            fresh[sig] = _fits_fresh(cpu[i], mem[i], pc, cat)
        wrong += fresh[sig]
    return {"missing": int(missing), "infeasible": int(bad),
            "wrongly_unschedulable": int(wrong)}


def _selects(selector: dict, labels: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def _fits_fresh(cpu: float, mem: float, pc, cat: Catalog) -> bool:
    """Could a fresh node of an admissible type and offering take the pod
    alone?"""
    req = np.array([cpu, mem / K.MIB, 1.0])
    fits = (~cat.exotic) & np.all(cat.alloc.astype(np.float64) + SLACK
                                  >= req[None, :], axis=1)
    zones = np.array([pc.zones is None or z in pc.zones for z in cat.zones])
    return bool((cat.avail & fits[:, None, None]
                 & zones[None, :, None]).any())


def canonical(launches: List[tuple], signatures: Dict[str, tuple]) -> Counter:
    """The answer's nodes as a multiset of (type, zone, capacity type, the
    signatures of the pods it holds, counted): pods of one signature are
    interchangeable, so two answers that differ only in which of them went
    where are the same answer."""
    out = Counter()
    for tname, zone, ctype, _, ks in launches:
        out[(tname, zone, ctype,
             tuple(sorted(Counter(signatures[k] for k in ks
                                  if k in signatures).items())))] += 1
    return out


def plan_diff(answer: dict, plan, pods, cat: Catalog) -> int:
    """Nodes in one answer and not in the other, both ways."""
    sig = dict(zip(pods.keys(), pod_signatures(pods)))
    mine = Counter()
    for (t, z, c, _), m in zip(plan.nodes, plan.members):
        mine[(cat.names[t], cat.zones[z], K.CAPACITY_TYPES[c],
              tuple(sorted(m.items())))] += 1
    theirs = canonical(answer["launches"], sig)
    return int(sum((mine - theirs).values()) + sum((theirs - mine).values()))


def blank(compare: str) -> Dict[str, float]:
    """The numbers `compare` adds to, before the first solve."""
    if compare == "plan":
        return {"plan_diff": 0}
    return {"cost_gap": float("-inf"), "node_gap": float("-inf")}


def compare(nums: Dict[str, float], how: str, answer: dict, plan, pods,
            cat: Catalog) -> None:
    """One solve against the reference's plan: "plan" adds the nodes that
    differ; "cost" keeps the largest gap of the answer's $/hr and of its
    node count over the plan's, each less 1."""
    if how == "plan":
        nums["plan_diff"] += plan_diff(answer, plan, pods, cat)
        return
    cost = sum(l[3] for l in answer["launches"])
    nums["cost_gap"] = max(nums["cost_gap"], cost / plan.cost() - 1)
    nums["node_gap"] = max(nums["node_gap"],
                           len(answer["launches"]) / len(plan.nodes) - 1)
