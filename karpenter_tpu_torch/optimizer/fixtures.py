"""Synthetic joint-consolidation fleets — the optimizer's proving ground.

The port of `karpenter_tpu/optimizer/fixtures.py`, against the port's
`make_sim`; `measure_consolidation` also takes the rung and the device.
Builds a deterministic underutilized fleet whose savings are INVISIBLE
to the greedy multi-node prefix search but provable by the global
optimizer, the reference's bench c14 procedure. The structure, per
6-node tile (all nodes one pinned instance type, allocatable cpu = c):

    A, B, C   anchor pods of c-2 cpu (free 2): too big for ANY
              survivor's headroom AND two per fresh node — every greedy
              prefix {A,B,...} needs ≥2 replacement launches and is
              rejected (the >1-launch rule);
    D         two 3-cpu pods (free c-6);
    E, F      one 3-cpu pod each (free c-3).

Greedy multi-node (cost-ordered prefixes always start at the anchors)
finds NOTHING. The joint pair {E, F} repacks replacement-free onto D
(3+3 ≤ c-6 for c ≥ 12) — the 2-node consolidation only a subset search
sees. Deletion costs order the candidates anchors-first, so the miss is
structural, not a tie-break accident.
"""

from __future__ import annotations

from typing import Dict

from ..models import labels as L
from ..models.nodepool import Budget, DisruptionSpec
from ..models.pod import Pod
from ..models.requirements import Operator, Requirement, Requirements
from ..models.resources import Resources

ITYPE = "c5.4xlarge"   # 16 vcpu in the small catalog; allocatable ~15
SQUEEZE_SMALL = "c5.xlarge"   # 4 vcpu — the squeeze fleet's victim type


def _pod(name: str, cpu: float, deletion_cost: int = 0) -> Pod:
    return Pod(name=name,
               requests=Resources.parse({"cpu": f"{cpu:g}",
                                         "memory": "1Gi"}),
               deletion_cost=deletion_cost)


def build_joint_fleet(sim, tiles: int = 1, itype: str = ITYPE,
                      settle_timeout: float = 600.0) -> Dict[str, object]:
    """Provision `tiles` 6-node tiles on `sim` (host backend), then
    rewrite three nodes per tile into the D/E/F shape by direct store
    binds. Returns {"alloc_cpu", "nodes", "pair_savings"} for asserts.

    The pool is pinned to one instance type (uniform arithmetic) and
    given an explicit node budget so the multi-node pass is never
    budget-starved."""
    pool = sim.store.nodepools["default"]
    pool.requirements = Requirements(
        Requirement(L.INSTANCE_TYPE, Operator.IN, (itype,)))
    pool.disruption = DisruptionSpec(budgets=[Budget(nodes="30")])
    cat = sim.solver.tensors(sim.store.nodeclasses["default"])
    t_idx = cat.name_to_idx[itype]
    alloc_cpu = float(cat.allocatable[t_idx, 0])
    assert alloc_cpu >= 12.0, f"{itype} allocatable {alloc_cpu} < 12"
    anchor_cpu = alloc_cpu - 2.0
    n_nodes = 6 * tiles
    for i in range(n_nodes):
        sim.store.add_pod(_pod(f"anchor-{i:03d}", anchor_cpu))
    ok = sim.engine.run_until(
        lambda: all(p.node_name is not None
                    for p in sim.store.pods.values()),
        timeout=settle_timeout)
    assert ok, "anchor fleet failed to settle"
    claims = sorted(sim.store.nodeclaims.values(), key=lambda c: c.name)
    assert len(claims) == n_nodes, (len(claims), n_nodes)
    pair_savings = 0.0
    for tile in range(tiles):
        d, e, f = claims[6 * tile + 3: 6 * tile + 6]
        pair_savings += e.price + f.price
        for role, claim, pods in (
                ("d", d, [("x", 3.0, 800), ("y", 3.0, 800)]),
                ("e", e, [("x", 3.0, 500)]),
                ("f", f, [("x", 3.0, 600)])):
            node = sim.store.node_for_nodeclaim(claim)
            assert node is not None
            for p in list(sim.store.pods_on_node(node.name)):
                sim.store.delete_pod(p.namespace, p.name)
            for suffix, cpu, cost in pods:
                pod = _pod(f"{role}{tile}-{suffix}", cpu,
                           deletion_cost=cost)
                sim.store.add_pod(pod)
                sim.store.bind_pod(pod, node.name)
    return {"alloc_cpu": alloc_cpu, "nodes": n_nodes,
            "pair_savings": pair_savings / max(tiles, 1),
            "claims": [c.name for c in claims]}


def build_squeeze_fleet(sim, tiles: int = 1,
                        settle_timeout: float = 600.0) -> Dict[str, object]:
    """The bench c14 fleet: savings GREEDY REALIZES NOTHING OF. Per
    tile: 3 big anchors (c-2 cpu on the pinned 16-vcpu type — every
    greedy multi-node prefix starts with two of them and needs >=2
    replacement launches, rejected) plus 5 one-pod `c5.xlarge` victims
    (3 cpu each, free ~0.9). Single-node consolidation fails everywhere:
    no survivor holds 3 free cpu, and the cheapest fresh node for one
    3-cpu pod IS another c5.xlarge — `new_price >= victim price` is
    rejected. Replacing k<5 victims fails the same price test (linear
    in-family pricing: k xlarge == one (4k/4)xlarge). ONLY the joint
    5-victim squeeze onto one fresh c5.4xlarge is strictly cheaper
    (5 x 0.17 > 0.68) — a replacement-backed joint eviction no prefix
    search and no single-node pass can represent. The pool pins
    on-demand capacity so the spot flexibility floor is out of frame."""
    pool = sim.store.nodepools["default"]
    cat = sim.solver.tensors(sim.store.nodeclasses["default"])
    alloc_cpu = float(cat.allocatable[cat.name_to_idx[ITYPE], 0])
    anchor_cpu = alloc_cpu - 2.0
    od = Requirement(L.CAPACITY_TYPE, Operator.IN, ("on-demand",))
    # zero budget during construction: the per-phase type pins below
    # would otherwise read as requirements drift on the OTHER phase's
    # nodes and roll them mid-build
    pool.disruption = DisruptionSpec(budgets=[Budget(nodes="0")])

    def settle():
        ok = sim.engine.run_until(
            lambda: all(p.node_name is not None
                        for p in sim.store.pods.values()),
            timeout=settle_timeout)
        assert ok, "squeeze fleet failed to settle"

    # phase 1: victims on the SMALL type (one 3-cpu pod per c5.xlarge —
    # 3+3 exceeds its allocatable, so they cannot share); the pin is
    # what a dedicated small-pool or an arrival-fragmented history
    # produces, which is exactly the shape consolidation exists to fix
    pool.requirements = Requirements(
        Requirement(L.INSTANCE_TYPE, Operator.IN, (SQUEEZE_SMALL,)), od)
    for tile in range(tiles):
        for i in range(5):
            # deletion costs order the victims AFTER the anchors in the
            # greedy cost order — the structural blind spot
            sim.store.add_pod(_pod(f"squeeze-{tile}-{i}", 3.0,
                                   deletion_cost=500 + i))
    settle()
    # phase 2: the big anchors
    pool.requirements = Requirements(
        Requirement(L.INSTANCE_TYPE, Operator.IN, (ITYPE,)), od)
    for tile in range(tiles):
        for i in range(3):
            sim.store.add_pod(_pod(f"anchor-{tile}-{i}", anchor_cpu))
    settle()
    # final shape: both types allowed (no drift — every node's label is
    # in the live set), real disruption budget restored
    pool.requirements = Requirements(
        Requirement(L.INSTANCE_TYPE, Operator.IN, (ITYPE, SQUEEZE_SMALL)),
        od)
    pool.disruption = DisruptionSpec(budgets=[Budget(nodes="30")])
    claims = list(sim.store.nodeclaims.values())
    small = [c for c in claims if c.instance_type == SQUEEZE_SMALL]
    big = [c for c in claims if c.instance_type == ITYPE]
    assert len(small) == 5 * tiles and len(big) == 3 * tiles, (
        sorted(c.instance_type for c in claims))
    od_i = cat.captypes.index("on-demand")
    ti = cat.name_to_idx[ITYPE]
    big_price = float(cat.price[ti, :, od_i][
        cat.available[ti, :, od_i]].min())
    victims_price = sum(c.price for c in small)
    return {"alloc_cpu": alloc_cpu, "nodes": len(claims),
            "victims_price": victims_price,
            "big_price": big_price,
            "squeeze_savings": victims_price - tiles * big_price}


def measure_consolidation(fleet: str = "squeeze", tiles: int = 2,
                          armed: bool = True,
                          run_for: float = 900.0, backend: str = "host",
                          device=None) -> Dict[str, object]:
    """Build one fleet, run it for `run_for` sim seconds with the
    optimizer armed or disarmed, and return what that decision path
    realized — the reference's bench c14 procedure (identical windows for
    both modes, so the compared savings are measured under identical
    conditions). `backend` is make_sim's rung ("host", as bench c14 runs
    it); `device` where the screen and the device rung run (the CUDA card
    unless given). Saves and restores KARPENTER_TPU_OPTIMIZER."""
    import os
    import time

    from ..metrics import CONSOLIDATION_SAVINGS
    from ..sim import make_sim, state_hash
    from . import OPTIMIZER_ENV
    from .stats import OPTIMIZER
    build = build_squeeze_fleet if fleet == "squeeze" else build_joint_fleet
    source = "optimizer" if armed else "greedy"
    prev = os.environ.get(OPTIMIZER_ENV)
    os.environ[OPTIMIZER_ENV] = "1" if armed else "0"
    try:
        base = CONSOLIDATION_SAVINGS.sum(source=source)
        tot0 = OPTIMIZER.totals()
        sim = make_sim(backend=backend, device=device)
        build(sim, tiles=tiles)
        n0 = len(sim.store.nodeclaims)
        t0 = time.perf_counter()
        sim.engine.run_for(run_for, step=5)
        wall = time.perf_counter() - t0
        tot1 = OPTIMIZER.totals()
    finally:
        if prev is None:
            os.environ.pop(OPTIMIZER_ENV, None)
        else:
            os.environ[OPTIMIZER_ENV] = prev
    st = sim.disruption.stats
    return {
        "mode": source,
        "nodes_before": n0,
        "nodes_after": len(sim.store.nodeclaims),
        "savings": round(CONSOLIDATION_SAVINGS.sum(source=source) - base,
                         4),
        "multi_consolidated": int(st.get("multi_consolidated", 0)),
        "single_consolidated": int(st.get("consolidated", 0)),
        "joint_consolidations": int(st.get("optimizer_consolidated", 0)),
        "subsets_scored": int(tot1["scored"] - tot0["scored"]),
        "exact_verifies": int(tot1["verified"] - tot0["verified"]),
        "verify_accepts": int(tot1["accepted"] - tot0["accepted"]),
        "search_s": round(tot1["search_s"] - tot0["search_s"], 4),
        "screen_cache_hits": int(st.get("screen_cache_hits", 0)),
        "wall_s": round(wall, 2),
        "all_bound": all(p.node_name is not None
                         for p in sim.store.pods.values()),
        # the port's addition: the end state, to hold two rungs equal
        "state_hash": state_hash(sim),
    }
