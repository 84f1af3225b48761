"""The reference's judgement of one disruption pass over a standing
cluster, from the harness's plain mirror of the cluster and the catalog
alone.

Karpenter's consolidation (concepts/disruption.md, designs/consolidation
.md) asks, for a node or a set of nodes, whether the pods on it could run
on the other nodes of the pool. The program answers that in three steps
and the reference judges each from the semantics:

- the screen: for every node n and request group g, k[n, g] is the count
  of g's pods that n's headroom takes (float32 in device units: the
  type's allocatable with the daemonsets charged, less the requests of
  the pods bound there, divided by g's request with the same 1e-4 slack
  as the scale-up plan, the least over cpu, memory and pod slots), 0
  where n may not host g (a metal or accelerator type, or no available
  offering in its zone and capacity type). Node n passes when every
  group's count on n is at most the column total of k less n's own k;
- a subset of victims: replacement-free when every group's need (its
  pods on the victims) is at most the supply of the surviving nodes (the
  column total of k over the nodes neither a victim nor being deleted);
  its savings are the sum of its victims' prices;
- the audit of each executed decision, in device units: every victim's
  pod placed once, on a surviving node or on a replacement; every node
  within its allocatable (cpu, memory, pod slots, the daemonsets
  reserved) once its new pods are on it; each replacement an available
  offering, of no metal or accelerator type, at the catalog's price (as
  every node's claim); the replacements cheaper than their victims,
  strictly; emptiness deleting only nodes with no pods; no more nodes
  disrupted in one pass than the budget (10% of the pool, rounded up).

A pass has to answer the screen when a node with pods is a candidate
and the budget lets one node go, and the subset search when two of each
(`expected`): Karpenter's pass consolidates whenever it can, so a pass
that gives no answer there is judged as a wrong one.

The mirror is plain data the harness keeps: each pod's node (an int32
array, -1 where it is bound nowhere) and each node's type, zone,
capacity type, its price in the catalog and the price the program gave
its claim. Every price the reference sums is the catalog's; a claim
priced otherwise is a broken guarantee. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from . import catalog as K
from .audit import PRICE_RTOL, SLACK
from .plan import EPS, Catalog, bf16

SAVINGS_RTOL = 1e-5       # the program sums savings in node order, f32
BUDGET_SHARE = 0.10       # the pool's default budget: nodes "10%"


@dataclass
class Mirror:
    """The cluster as the harness keeps it: pods by their index in the
    cell's pod set, nodes by the order they came up (a removed node keeps
    its index, dead)."""
    pod_node: np.ndarray                  # int32 [P], -1: bound nowhere
    node_type: List[int] = field(default_factory=list)
    node_zone: List[int] = field(default_factory=list)
    node_cap: List[int] = field(default_factory=list)
    node_price: List[float] = field(default_factory=list)   # the catalog's
    node_claimed: List[float] = field(default_factory=list)  # the claim's
    node_live: List[bool] = field(default_factory=list)
    names: List[str] = field(default_factory=list)

    def add_node(self, name: str, t: int, z: int, c: int, price: float,
                 claimed: float) -> int:
        self.names.append(name)
        self.node_type.append(t)
        self.node_zone.append(z)
        self.node_cap.append(c)
        self.node_price.append(float(price))
        self.node_claimed.append(float(claimed))
        self.node_live.append(True)
        return len(self.names) - 1

    def snapshot(self) -> "Snapshot":
        return Snapshot(self.pod_node.copy(),
                        np.asarray(self.node_type, np.int64),
                        np.asarray(self.node_zone, np.int64),
                        np.asarray(self.node_cap, np.int64),
                        np.asarray(self.node_price, np.float64),
                        np.asarray(self.node_claimed, np.float64),
                        np.asarray(self.node_live, bool), list(self.names))


@dataclass
class Snapshot:
    pod_node: np.ndarray
    node_type: np.ndarray
    node_zone: np.ndarray
    node_cap: np.ndarray
    node_price: np.ndarray
    node_claimed: np.ndarray
    node_live: np.ndarray
    names: List[str]


@dataclass
class Decision:
    """One executed decision as plain data: victims and replacements by
    node index in the mirror after the pass (replacements are new
    indices), and each moved pod's new node."""
    reason: str
    victims: List[int]
    placements: Dict[int, int] = field(default_factory=dict)   # pod -> node
    replacements: List[int] = field(default_factory=list)


def pod_requests(cpu_cores: np.ndarray, mem_bytes: np.ndarray) -> np.ndarray:
    """float64 [P, 3]: each pod's request in device units (cores, MiB,
    pod slots)."""
    return np.stack([np.asarray(cpu_cores, np.float64),
                     np.asarray(mem_bytes, np.float64) / K.MIB,
                     np.ones(len(cpu_cores))], axis=1)


def _q(precision: str):
    return bf16 if precision == "bfloat16" else (lambda x: x)


def k_caps(snap: Snapshot, req: np.ndarray, group: np.ndarray,
           cat: Catalog, precision: str = "float32"):
    """(live node indices [L], group ids [G], k [L, G] f32, counts [L, G])
    of the snapshot: each live node's per-group fit count and the pods of
    each group bound to it."""
    q = _q(precision)
    live = np.flatnonzero(snap.node_live)
    row = np.full(len(snap.node_live), -1, np.int64)
    row[live] = np.arange(len(live))
    bound = np.flatnonzero(snap.pod_node >= 0)
    gids, ginv = np.unique(group[bound], return_inverse=True)
    r = row[snap.pod_node[bound]]
    cum = np.zeros((len(live), 3), np.float64)
    np.add.at(cum, r, req[bound])
    counts = np.zeros((len(live), len(gids)), np.int64)
    np.add.at(counts, (r, ginv), 1)
    greq = np.zeros((len(gids), 3), np.float32)
    first = np.zeros(len(gids), np.int64)
    first[ginv[::-1]] = bound[::-1]
    greq[:] = req[first].astype(np.float32)
    t = snap.node_type[live]
    head = q(q(cat.alloc[t]) - q(cum.astype(np.float32)))       # [L, 3]
    greq = q(greq)
    with_req = np.where(greq > 0, greq, np.float32(1.0))
    ratio = np.where(greq[None, :, :] > 0,
                     np.floor(q(head[:, None, :] / with_req[None, :, :])
                              + EPS), np.float32(1e9))
    k = np.maximum(ratio.min(axis=2), np.float32(0.0)).astype(np.float32)
    elig = (~cat.exotic[t]
            & cat.avail[t, snap.node_zone[live], snap.node_cap[live]])
    k = np.where(elig[:, None], k, np.float32(0.0))
    return live, gids, k, counts


def screen(snap: Snapshot, req: np.ndarray, group: np.ndarray,
           cat: Catalog, precision: str = "float32") -> Dict[str, bool]:
    """Each live node's screen verdict, by name."""
    live, _g, k, counts = k_caps(snap, req, group, cat, precision)
    others = k.astype(np.float64).sum(axis=0)[None, :] - k
    ok = ((counts <= others) | (counts == 0)).all(axis=1)
    return {snap.names[n]: bool(v) for n, v in zip(live.tolist(),
                                                   ok.tolist())}


def subsets(snap: Snapshot, req: np.ndarray, group: np.ndarray,
            cat: Catalog, victims: Sequence[Sequence[int]],
            deleting: Sequence[int] = (), precision: str = "float32"):
    """(feasible [S] bool, savings [S] f64) of victim subsets (node
    indices): replacement-free when each group's need is at most the
    supply of the live nodes neither a victim nor being deleted."""
    q = _q(precision)
    live, _g, k, counts = k_caps(snap, req, group, cat, precision)
    row = {int(n): i for i, n in enumerate(live.tolist())}
    gone = np.zeros(len(live), bool)
    for n in deleting:
        if int(n) in row:
            gone[row[int(n)]] = True
    total = np.where(gone[:, None], 0.0, k.astype(np.float64)).sum(axis=0)
    price = q(snap.node_price.astype(np.float32)).astype(np.float64)
    feas, sav = [], []
    for s in victims:
        rows = [row[int(n)] for n in s if int(n) in row]
        if len(rows) != len(s):
            feas.append(False)
            sav.append(float("nan"))
            continue
        need = counts[rows].sum(axis=0)
        supply = total - np.where(gone[rows, None], 0.0,
                                  k[rows].astype(np.float64)).sum(axis=0)
        feas.append(bool(((need <= supply) | (need == 0)).all()))
        sav.append(float(price[list(s)].sum()))
    return np.asarray(feas, bool), np.asarray(sav, np.float64)


def audit(before: Snapshot, decisions: List[Decision], after: Snapshot,
          req: np.ndarray, cat: Catalog) -> Dict[str, int]:
    """`missing` and `infeasible` of one pass's executed decisions (see
    the module's docstring), carried out in the order the pass executed
    them from the mirror before the pass; `after` holds the nodes the
    pass added (the replacements)."""
    missing = 0
    bad = mispriced(before, np.flatnonzero(before.node_live))
    pod_node = before.pod_node.astype(np.int64)
    live = np.zeros(len(after.node_live), bool)
    live[: len(before.node_live)] = before.node_live
    disrupted = 0
    touched = set()
    for d in decisions:
        disrupted += len(d.victims)
        vset = set(d.victims)
        on = np.flatnonzero(np.isin(pod_node, list(vset))).tolist()
        if d.reason == "Empty":
            bad += len({int(pod_node[p]) for p in on})
            live[list(vset)] = False
            continue
        cost = 0.0
        for n in d.replacements:
            if not (0 <= n < len(after.node_type)):
                bad += 1
                continue
            live[n] = True
            t, z, c = (int(after.node_type[n]), int(after.node_zone[n]),
                       int(after.node_cap[n]))
            cost += float(cat.price[t, z, c])
            if not cat.avail[t, z, c] or cat.exotic[t]:
                bad += 1
            else:
                bad += mispriced(after, [n])
        if d.replacements and not cost < float(
                after.node_price[list(vset)].sum()):
            bad += 1
        onset = set(on)
        missing += sum(1 for p in on if p not in d.placements)
        missing += sum(1 for p in d.placements if p not in onset)
        for p in on:
            pod_node[p] = -1
        for p, n in d.placements.items():
            if not (0 <= n < len(live) and live[n] and n not in vset):
                bad += 1
                continue
            pod_node[p] = n
            touched.add(n)
        live[list(vset)] = False
    # every node that took pods, within its allocatable afterwards
    for n in sorted(touched):
        if not live[n]:
            continue
        use = req[pod_node == n].sum(axis=0)
        if np.any(use > cat.alloc[after.node_type[n]].astype(np.float64)
                  + SLACK):
            bad += 1
    if disrupted > math.ceil(int(before.node_live.sum()) * BUDGET_SHARE):
        bad += 1
    return {"missing": int(missing), "infeasible": int(bad)}


def mispriced(snap: Snapshot, nodes) -> int:
    """Nodes whose claim's price is not the catalog's (beyond
    PRICE_RTOL)."""
    idx = np.asarray(nodes, np.int64)
    want, got = snap.node_price[idx], snap.node_claimed[idx]
    ok = np.abs(got - want) <= PRICE_RTOL * np.maximum(1.0, np.abs(want))
    return int((~ok).sum())


def expected(snap: Snapshot, decisions: List[Decision],
             disrupting: int = 0):
    """(screen, search): whether a pass over `snap` has to answer the
    screen and the subset search. A node with pods is a candidate; the
    budget is 10% of the pool (rounded up) less the nodes disrupting:
    `disrupting` at the pass's start and the pass's empty nodes. The
    screen needs a candidate and a node of budget, the multi-node search
    two of each."""
    live = np.asarray(snap.node_live, bool)
    used = np.zeros(len(live), bool)
    used[snap.pod_node[snap.pod_node >= 0]] = True
    cand = int((used & live).sum())
    empty = sum(len(d.victims) for d in decisions if d.reason == "Empty")
    budget = (math.ceil(int(live.sum()) * BUDGET_SHARE) - empty
              - int(disrupting))
    return cand >= 1 and budget >= 1, cand >= 2 and budget >= 2


def verify_shapes(snap: Snapshot, group: np.ndarray, victims: Sequence[int],
                  deleting: Sequence[int] = ()):
    """(groups, standing nodes) of the exact solve that verifies a
    subset: the request groups of the victims' pods, re-solved against
    every live node that is neither a victim nor being deleted."""
    on = np.isin(snap.pod_node, np.asarray(list(victims), np.int64))
    gone = set(int(n) for n in victims) | set(int(n) for n in deleting)
    standing = int(snap.node_live.sum()) - sum(
        1 for n in gone if 0 <= n < len(snap.node_live) and snap.node_live[n])
    return int(len(np.unique(group[on]))), standing


def compare_screen(program_ok: set, ref: Dict[str, bool]) -> int:
    """Nodes whose screen verdict differs: the program's passing names
    against the reference's verdict of every live node."""
    return (sum(1 for n, v in ref.items() if (n in program_ok) != v)
            + sum(1 for n in program_ok if n not in ref))


def compare_subsets(feasible: Sequence[bool], savings: Sequence[float],
                    ref_feasible: np.ndarray, ref_savings: np.ndarray
                    ) -> int:
    """Scored subsets whose feasibility differs from the reference's, or
    whose savings differ beyond SAVINGS_RTOL."""
    diff = 0
    for f, s, rf, rs in zip(feasible, savings, ref_feasible.tolist(),
                            ref_savings.tolist()):
        if bool(f) != bool(rf) or not abs(s - rs) <= SAVINGS_RTOL * max(
                abs(rs), 1e-12):
            diff += 1
    return diff + abs(len(feasible) - len(ref_feasible))
