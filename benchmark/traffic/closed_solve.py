"""Closed loop, one solve at a time: one cluster's provisioner hands its
whole pending set to `Solver.solve` and waits for the SolveOutput before
the next.

Parameters (the cell's "params"):
- "pool": pods in the seeded pool set-up builds;
- "pods": pods a solve takes, a fresh seeded draw from the pool each
  time (so no two solves of a run are the same input);
- "kinds": the pod mix (harness/pods.py);
- "compare": "plan" (the reference's plan node for node) or "cost" (the
  reference's plan as a yardstick: `cost_gap`, the answer's $/hr over
  the plan's less 1, and `node_gap`, its nodes over the plan's less 1,
  each the largest over the judged solves);
- "sample": solves the reference judges, drawn from the seed as they
  complete (harness/sample.py).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark.harness import pods as P
from benchmark.harness import port
from benchmark.harness.sample import Reservoir, rng
from benchmark.reference import audit as A
from benchmark.reference import catalog as K
from benchmark.reference import plan as R
from benchmark.roofline import scan as S

WARM_STREAM = 1 << 20   # the warm-up draw's stream, apart from the window's


class State:
    pass


def setup(cell: dict, seed: int, device: str) -> State:
    from karpenter_tpu_torch.ops.facade import Solver
    p, conf = cell["params"], cell["configuration"]
    st = State()
    st.cell, st.seed = cell, seed
    st.pool, st.ds = conf["pool"], conf.get("daemonsets", [])
    st.types = K.generate()
    st.podset = P.generate(p["kinds"], p["pool"], seed)
    st.pods = port.pods(st.podset, st.pool)
    st.n = p["pods"]
    st.np_pool = port.node_pool(st.pool)
    st.np_ds = port.daemon_sets(st.ds, st.pool)
    st.facade = Solver(port.catalog_provider(port.instance_types(st.types)),
                       backend="device", device=device)
    st.kept = Reservoir(p["sample"], seed)    # (draw, SolveOutput)
    st.work = []           # the window's draws, in order
    warm = draw(seed, WARM_STREAM, p["pool"], st.n)
    st.facade.solve([st.pods[i] for i in warm], st.np_pool,
                    daemonsets=st.np_ds)
    return st


def draw(seed: int, k: int, pool: int, n: int) -> np.ndarray:
    """Solve k's pods: n of the pool, in a seeded order."""
    return rng(seed, 6, k).permutation(pool)[:n]


def inputs(cell: dict, seed: int) -> list:
    """The pods of as many solves as a run judges (the window's first
    draws), without the program: the control's requests."""
    p = cell["params"]
    ps = P.generate(p["kinds"], p["pool"], seed)
    return [ps.take(draw(seed, k, p["pool"], p["pods"]))
            for k in range(p["sample"])]


def stats(st: State) -> dict:
    return dict(st.facade.stats)


def window(st: State, seconds: float) -> list:
    reqs = []
    t_end = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < t_end:
        idx = draw(st.seed, k, len(st.pods), st.n)
        batch = [st.pods[i] for i in idx]
        t0 = time.perf_counter()
        try:
            with port.request_span("bench.solve"):
                out = st.facade.solve(batch, st.np_pool,
                                      daemonsets=st.np_ds)
        except Exception as e:  # noqa: BLE001 — a failed request is counted
            print(f"solve {k} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            reqs.append((t0, time.perf_counter(), None))
        else:
            reqs.append((t0, time.perf_counter(), port.decided(out)))
            st.kept.add((idx, out), len(idx))
            st.work.append(idx)
        k += 1
    return reqs


def release(st: State) -> None:
    st.fallbacks = (st.facade.stats.get("device_fallbacks", 0)
                    + st.facade.stats.get("integrity_violations", 0))
    st.facade = st.pods = st.np_ds = None


def judge(st: State, seed: int, want_work: bool = False):
    """The sampled solves against the reference: the audit's counts
    summed, and the plan's node difference (summed) or the cost and node
    gaps (the largest). With `want_work`, the reference plan's scan work
    of every solve of the window."""
    cat = R.build_catalog(st.types, st.pool, st.ds)
    nums = {"missing": 0, "infeasible": 0, "wrongly_unschedulable": 0,
            "fallbacks": st.fallbacks}
    compare = st.cell["params"].get("compare", "plan")
    nums.update(A.blank(compare))
    picked = st.kept.sample()
    if not picked:
        return {k: float("inf") for k in nums}, []
    plans = {}
    for idx, out in picked:
        ps = st.podset.take(idx)
        ans = port.output(out)
        for k, v in A.audit(ans, ps, cat, st.pool).items():
            nums[k] += v
        plan = plans[idx.tobytes()] = R.solve(ps, cat, st.pool)
        A.compare(nums, compare, ans, plan, ps, cat)
    T, Z, C = cat.price.shape
    work = []
    for idx in (st.work if want_work else []):
        plan = plans.get(idx.tobytes())
        if plan is None:
            plan = R.solve(st.podset.take(idx), cat, st.pool)
        work.append({"b0": S.offer_argmin(plan.groups, T, Z, C, len(R.RES)),
                     "b": S.solve_scan(plan.groups, T, Z, C, len(R.RES),
                                       len(plan.nodes), plan.node_steps,
                                       plan.placements)})
    return nums, work
