"""Closed loop per tenant on one shared `SolverService`, in lock-step
rounds: each tenant submits its next request when its last SolveOutput
has returned, as a provisioner waits on its solve. The service is
single-threaded and synchronous: `pump()` runs every queued ticket, and
a ticket's result can be read only once that pump has returned. So every
tenant whose ticket was in a pump gets its answer at the same moment and
resubmits at the same moment: a closed loop per tenant over this service
is a loop of rounds. Each round queues every tenant's request, pumps
once and reads every SolveOutput; a request's latency is the round's
wall, from its submission to the pump's return, which is when its caller
can first read it. The fleet's clock then moves on by one batch window,
as the program's FleetRunner steps every shard once a step on one clock.
All tenants arrive together each round, batching's best case: arrivals
staggered across pumps are another mix (PERF.md, Open questions).

Parameters (the cell's "params"):
- "tenants": clusters sharing the service;
- "burst": {"min", "max"}: a round's requests take the tenants' count of
  sizes spaced log-uniformly from min to max (32, 40, 51, ... 1,024 for
  16 tenants), dealt to the tenants in a seeded order, so that every
  round and every seed has the same sizes;
- "tenant_pool": grid pods each tenant's requests are drawn from;
- "fresh": true: a new seeded draw every round; false: each tenant
  re-submits one pending set, drawn at set-up, every round (pods that
  stay pending under limits or insufficient capacity);
- "warm_rounds": rounds set-up runs before the window;
- "sample": requests the reference judges, drawn from the seed as they
  complete (harness/sample.py; the largest is always among them).

The configuration gives the batch window the clock moves by
("batch_idle_s") and the pool.
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


class State:
    pass


def setup(cell: dict, seed: int, device: str) -> State:
    from karpenter_tpu_torch.fleet import SolverService
    from karpenter_tpu_torch.utils.clock import FakeClock
    p, conf = cell["params"], cell["configuration"]
    st = State()
    st.cell, st.seed, st.p = cell, seed, p
    st.pool = conf["pool"]
    st.step = float(conf["batch_idle_s"])
    st.types = K.generate()
    ptypes = port.instance_types(st.types)
    st.clock = FakeClock()
    st.svc = SolverService(st.clock, backend="device", batch=True,
                           device=device)
    st.np_pool = port.node_pool(st.pool)
    st.tenants = []
    for i in range(p["tenants"]):
        ps = _pool(seed, p, i)
        client = st.svc.register(f"t{i:02d}",
                                 port.catalog_provider(ptypes))
        st.tenants.append((client, ps, port.pods(ps, st.pool)))
    st.fixed = [_burst(st, i, -1) for i in range(p["tenants"])]
    st.kept = Reservoir(p["sample"], seed)   # (tenant, draw, SolveOutput)
    st.work = []             # (tenant, draw) of every request of the window
    for r in range(p["warm_rounds"]):
        _round(st, -2 - r, keep=False)
    return st


def sizes(p: dict) -> list:
    """A round's request sizes: one a tenant, log-uniformly spaced."""
    lo, hi, k = p["burst"]["min"], p["burst"]["max"], p["tenants"]
    return [int(round(lo * (hi / lo) ** (i / max(1, k - 1))))
            for i in range(k)]


def inputs(cell: dict, seed: int) -> list:
    """The pods of as many requests as a run judges (the window's first
    rounds), without the program: the control's requests."""
    p = cell["params"]
    st = State()
    st.seed, st.p = seed, p
    st.fixed = [_burst(st, i, -1) for i in range(p["tenants"])]
    pools = [_pool(seed, p, i) for i in range(p["tenants"])]
    out = []
    rnd = 0
    while len(out) <= p["sample"]:
        out += [pools[i].take(_burst(st, i, rnd))
                for i in range(p["tenants"])]
        rnd += 1
    return out[: p["sample"] + 1]


def _pool(seed: int, p: dict, tenant: int):
    """A tenant's grid pods."""
    return P.generate([{"kind": "grid"}], p["tenant_pool"],
                      int(rng(seed, 1, tenant).integers(2**62)),
                      prefix=f"t{tenant:02d}-")


def _burst(st: State, tenant: int, rnd: int) -> np.ndarray:
    """A request's pods: the size the round deals this tenant, a seeded
    draw of its pool."""
    if not st.p["fresh"] and rnd >= 0:
        return st.fixed[tenant]
    deal = rng(st.seed, 4, rnd + 16).permutation(st.p["tenants"])
    n = sizes(st.p)[int(deal[tenant])]
    return rng(st.seed, 2, tenant, rnd + 16).permutation(
        st.p["tenant_pool"])[:n]


def _round(st: State, rnd: int, keep: bool) -> list:
    draws = [_burst(st, i, rnd) for i in range(len(st.tenants))]
    t0 = time.perf_counter()
    with port.request_span("bench.round"):
        tickets = [client.solve_async([pods[j] for j in d], st.np_pool)
                   for (client, _, pods), d in zip(st.tenants, draws)]
        st.svc.pump()
    outs = []
    for tk in tickets:
        try:
            outs.append(tk.result())
        except Exception as e:  # noqa: BLE001 — a failed request is counted
            print(f"round {rnd}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            outs.append(None)
    t1 = time.perf_counter()
    st.clock.step(st.step)
    if keep:
        for i, (d, out) in enumerate(zip(draws, outs)):
            if out is not None:
                st.kept.add((i, d, out), len(d))
                st.work.append((i, d))
    return [(t0, t1, None if out is None else port.decided(out))
            for out in outs]


def stats(st: State) -> dict:
    s = st.svc.stats
    return {"batches": s["batches"], "batched_tickets": s["batched_tickets"],
            "dispatched": s["dispatched"]}


def window(st: State, seconds: float) -> list:
    reqs = []
    t_end = time.perf_counter() + seconds
    rnd = 0
    while time.perf_counter() < t_end:
        reqs += _round(st, rnd, keep=True)
        rnd += 1
    return reqs


def release(st: State) -> None:
    st.fallbacks = sum(c.facade.stats.get("device_fallbacks", 0)
                       + c.facade.stats.get("integrity_violations", 0)
                       for c, _, _ in st.tenants)
    st.tenants = [(None, ps, None) for _, ps, _ in st.tenants]
    st.svc = None


def judge(st: State, seed: int, want_work: bool = False):
    """The sampled requests against the reference: the audit's counts and
    the plan's node difference, summed. With `want_work`, the reference
    plan's scan work of every request of the window."""
    cat = R.build_catalog(st.types, st.pool, [])
    nums = {"missing": 0, "infeasible": 0, "wrongly_unschedulable": 0,
            "plan_diff": 0, "fallbacks": st.fallbacks}
    picked = st.kept.sample()
    if not picked:
        return {k: float("inf") for k in nums}, []
    T, Z, C = cat.price.shape
    plans = {}

    def plan_of(i, d):
        key = (i, d.tobytes())
        if key not in plans:
            plans[key] = R.solve(st.tenants[i][1].take(d), cat, st.pool)
        return plans[key]
    for i, d, out in picked:
        ps = st.tenants[i][1].take(d)
        ans = port.output(out)
        for name, v in A.audit(ans, ps, cat, st.pool).items():
            nums[name] += v
        nums["plan_diff"] += A.plan_diff(ans, plan_of(i, d), ps, cat)
    work = []
    for i, d in (st.work if want_work else []):
        plan = plan_of(i, d)
        work.append({"b0": S.offer_argmin(plan.groups, T, Z, C, len(R.RES)),
                     "b": S.solve_scan(plan.groups, T, Z, C, len(R.RES),
                                       len(plan.nodes), plan.node_steps,
                                       plan.placements)})
    return nums, work
