"""Closed loop, one disruption pass at a time over a standing cluster:
the disruption controller's `reconcile` over a cluster the autoscaler
provisioned and a scale-down then thinned, while jobs keep finishing.

Set-up builds the catalog and a seeded draw of grid pods, runs the
program's provisioner over them once (its `Solver` on the device rung,
the claims launched on its fake cloud), brings every node up
(registered, initialized) and binds every pod where the solve placed it,
then deletes a seeded share of the bound pods (the scale-down) and runs
one warm pass. Each request: a seeded share of the still-bound pods
finish, then one `DisruptionController.reconcile(now)` runs, timed; the
clock then moves by the controller's requeue and the harness carries out
what the pass executed, as the cluster would: the replacements come up
initialized, the exact solve's placements are bound, the victims go. A
pass that outlives the deadline (SIGALRM) fails the run.

Pods decided: the bound pods the pass judged, every pod on the pool's
node views. The reference judges a seeded sample of the passes from the
harness's own mirror of the cluster (reference/consolidate.py): the
screen's verdicts (`screen_diff`), the scored subsets' feasibility and
savings (`subset_diff`) and every executed decision (`violations`). The
verdicts and subsets judged are those the pass used, computed in it or
served from the controller's memos; a pass that had to answer the
screen or the search (`RC.expected`) and holds no answer counts one
difference.

Parameters (the cell's "params"): "pods" (the grid draw provisioned),
"kinds" (the mix, harness/pods.py), "scale_down" (the share of bound
pods deleted after provisioning), "churn" (the share of still-bound pods
that finish before each pass), "sample" (passes judged), "deadline_s".
"""

from __future__ import annotations

import contextlib
import signal
import sys
import time

import numpy as np

from benchmark.harness import pods as P
from benchmark.harness import port
from benchmark.harness.sample import Reservoir, rng
from benchmark.reference import catalog as K
from benchmark.reference import consolidate as RC
from benchmark.reference import plan as R
from benchmark.roofline import scan as S

SCALE_DOWN_STREAM = 8
CHURN_STREAM = 9
WARM_PASS = -1
VERIFY_LIMIT = 8   # exact verifies a search may run (the program's own cap)
READY_S = 3.0      # past the fake cloud's register and ready delays


class State:
    pass


class PassTimeout(RuntimeError):
    pass


@contextlib.contextmanager
def deadline(seconds: float, what: str):
    """SIGALRM after `seconds`: a pass that cannot finish fails the run
    instead of hanging it."""
    def fire(signum, frame):
        raise PassTimeout(f"{what} passed its {seconds:g}-s deadline")
    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def node_pool(pool: dict):
    """The program's NodePool with the configuration's disruption spec."""
    from karpenter_tpu_torch import models as M
    np_ = port.node_pool(pool)
    d = pool["disruption"]
    np_.disruption = M.DisruptionSpec(
        consolidation_policy=d["consolidation_policy"],
        consolidate_after=float(d["consolidate_after"]),
        budgets=[M.Budget(nodes=b["nodes"]) for b in d["budgets"]])
    return np_


def setup(cell: dict, seed: int, device: str) -> State:
    from karpenter_tpu_torch.sim import make_sim
    p, conf = cell["params"], cell["configuration"]
    pool, ds = conf["pool"], conf.get("daemonsets", [])
    st = State()
    st.cell, st.seed, st.p = cell, seed, p
    st.pool_name = pool["name"]
    st.types = K.generate()
    st.cat = R.build_catalog(st.types, pool, ds)
    st.podset = P.generate(p["kinds"], p["pods"], seed)
    st.req = RC.pod_requests(st.podset.cpu(), st.podset.mem())
    st.group = (st.podset.cpu_idx * len(P.MEM_GRID)
                + st.podset.mem_idx).astype(np.int64)
    st.index = {k: i for i, k in enumerate(st.podset.keys())}
    if device != "cpu":
        # kernels A, B0/B and C built (in a fresh checkout) or loaded here,
        # outside any pass's deadline: nvcc takes minutes
        from karpenter_tpu_torch.ops import _build
        _build.build_all([b for b in _build.BUILDS if b[0] != "mesh_scan"])
    st.sim = sim = make_sim(types=port.instance_types(st.types),
                            backend="device", nodepool=node_pool(pool),
                            watchdog=False, device=device)
    for d in port.daemon_sets(ds, pool):
        sim.store.add_daemonset(d)
    st.pods = port.pods(st.podset, pool)
    for pod in st.pods:
        sim.store.add_pod(pod)
    # the cluster from the program's own plan: one provisioning pass,
    # the nodes up, every pod bound where the solve nominated it
    sim.provisioner.reconcile(sim.clock.now())
    sim.clock.step(READY_S)
    now = sim.clock.now()
    sim.cloud.tick()
    sim.lifecycle.reconcile(now)
    sim.binding.reconcile(now)
    for pod in st.pods:
        if pod.node_name is not None:
            _bind(sim.store, pod, pod.node_name)
    st.mirror = RC.Mirror(np.full(len(st.pods), -1, np.int32))
    st.node_of = {}                        # claim name -> mirror index
    for claim in sim.store.nodeclaims.values():
        _add_node(st, claim)
    by_node = {sim.store.nodeclaims[c].node_name: n
               for c, n in st.node_of.items()}
    unbound = 0
    for i, pod in enumerate(st.pods):
        if pod.node_name is None:
            unbound += 1
        else:
            st.mirror.pod_node[i] = by_node[pod.node_name]
    if unbound:
        raise RuntimeError(f"set-up left {unbound} pods unbound")
    # the scale-down: a seeded share of the bound pods deleted
    gone = rng(seed, SCALE_DOWN_STREAM).permutation(len(st.pods))[
        : int(round(p["scale_down"] * len(st.pods)))]
    for i in np.sort(gone).tolist():
        _finish(st, i)
    st.kept = Reservoir(p["sample"], seed)
    st.work = []
    st.counts = {"passes": 0, "decisions": 0, "victims": 0,
                 "replacements": 0}
    with deadline(p["deadline_s"], "the warm pass"):
        _pass(st, WARM_PASS)
    st.counts = dict.fromkeys(st.counts, 0)
    return st


def _add_node(st: State, claim) -> int:
    """A node into the mirror: priced from the catalog, beside the
    price the program gave its claim (the audit holds one to the
    other)."""
    t = st.cat.index[claim.instance_type]
    z = st.cat.zones.index(claim.zone)
    c = K.CAPACITY_TYPES.index(claim.capacity_type)
    n = st.mirror.add_node(claim.name, t, z, c, float(st.cat.price[t, z, c]),
                           claim.price)
    st.node_of[claim.name] = n
    return n


def _bind(store, pod, node_name: str) -> None:
    """Bind as the scheduler does: the binding clears the pod's
    nomination (a claim that later terminates evicts the pods still
    nominated to it)."""
    from karpenter_tpu_torch.models import labels as L
    if L.NOMINATED in pod.annotations:
        store.unnominate_pod(pod)
    if pod.node_name != node_name:
        store.bind_pod(pod, node_name)


def _finish(st: State, i: int) -> None:
    pod = st.pods[i]
    st.sim.store.delete_pod(pod.namespace, pod.name)
    st.mirror.pod_node[i] = -1


def _pass(st: State, k: int):
    """One request: the churn, the timed reconcile, then the pass's
    decisions carried out. (submitted, answered, pods decided, record)."""
    sim, m = st.sim, st.mirror
    ctl = sim.disruption
    bound = np.flatnonzero(m.pod_node >= 0)
    fin = rng(st.seed, CHURN_STREAM, k & 0xFFFFFFFF).choice(
        bound, int(round(st.p["churn"] * len(bound))), replace=False)
    for i in np.sort(fin).tolist():
        _finish(st, i)
    before = m.snapshot()
    decided = int((before.pod_node >= 0).sum())
    # nodes already disrupting when the pass starts count against its
    # budget (`RC.expected`)
    disrupting = sum(1 for c in sim.store.nodeclaims.values()
                     if c.nodepool == st.pool_name and c.is_deleting())
    disrupting += sum(len(pd.victim_claims)
                      for pd in getattr(ctl, "_pending", []))
    # a program without the pass's records still runs the pass (and
    # meets the deadline); its answers then judge as missing
    plans = getattr(ctl, "plans", {})
    screen0 = ctl._screen_cache.get(st.pool_name)
    plan0 = plans.get(st.pool_name)
    now = sim.clock.now()
    t0 = time.perf_counter()
    with port.request_span("bench.pass"):
        ctl.reconcile(now)
    t1 = time.perf_counter()
    # what the pass used: the screen's verdicts and the subset search
    # the controller holds after it, computed in this pass ("fresh") or
    # served from its memo (the screen's, the fruitless-search memo's)
    screen1 = ctl._screen_cache.get(st.pool_name)
    ok = set(screen1[1][3]) if screen1 is not None else None
    plan = plans.get(st.pool_name)
    sim.clock.step(ctl.requeue)
    decisions = _carry_out(st, getattr(ctl, "decisions", []))
    rec = {"before": before, "after": m.snapshot(), "decisions": decisions,
           "disrupting": disrupting, "screen": ok,
           "screen_fresh": screen1 is not None and screen1 is not screen0,
           "plan": _plain_plan(st, plan),
           "plan_fresh": plan is not None and plan is not plan0}
    st.counts["passes"] += 1
    st.counts["decisions"] += len(decisions)
    st.counts["victims"] += sum(len(d.victims) for d in decisions)
    st.counts["replacements"] += sum(len(d.replacements) for d in decisions)
    return t0, t1, decided, rec


def _plain_plan(st: State, plan):
    if plan is None:
        return None
    idx = [st.node_of.get(n, -1) for n in plan.nodes]
    return {"subsets": [[idx[i] for i in s] for s in plan.scored_subsets],
            "feasible": list(plan.scored_feasible),
            "savings": list(plan.scored_savings),
            "ranked": [[idx[i] for i in s] for s in plan.subsets]}


def _carry_out(st: State, decisions) -> list:
    """What the cluster does with a pass's decisions: replacements come
    up initialized, the exact solve's placements are bound, any pod left
    on a victim is evicted, the victims go. Returns them as plain data."""
    sim, m = st.sim, st.mirror
    store = sim.store
    now = sim.clock.now()
    sim.cloud.tick()
    sim.lifecycle.reconcile(now)
    plain = []
    for d in decisions:
        victims = [st.node_of[v] for v in d.victims]
        rd = RC.Decision(d.reason, victims)
        out = d.output
        if out is not None:
            targets = [(store.nodeclaims[name], keys) for name, keys in
                       out.existing_placements.items()]
            for launch, rname in zip(out.launches, d.replacements):
                claim = store.nodeclaims[rname]
                if claim.node_name is None:
                    raise RuntimeError(f"replacement {rname} did not come "
                                       "up")
                rd.replacements.append(_add_node(st, claim))
                targets.append((claim, launch.pod_keys))
            for claim, keys in targets:
                n = st.node_of[claim.name]
                for key in keys:
                    i = st.index[key]
                    _bind(store, st.pods[i], claim.node_name)
                    m.pod_node[i] = n
                    rd.placements[i] = n
        for v, n in zip(d.victims, victims):
            claim = store.nodeclaims.get(v)
            node = store.nodes.get(claim.node_name) if claim else None
            for pod in (store.pods_on_node(node.name) if node else []):
                store.unbind_pod(pod)
                m.pod_node[st.index[f"{pod.namespace}/{pod.name}"]] = -1
            if claim is not None and not claim.is_deleting():
                sim.termination.delete_nodeclaim(claim, now, d.reason)
            m.node_live[n] = False
        plain.append(rd)
    sim.termination.reconcile(now)
    return plain


def stats(st: State) -> dict:
    return dict(st.counts)


def window(st: State, seconds: float) -> list:
    reqs = []
    t_end = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < t_end:
        try:
            with deadline(st.p["deadline_s"], f"pass {k}"):
                t0, t1, decided, rec = _pass(st, k)
        except PassTimeout:
            raise
        except Exception as e:  # noqa: BLE001 — a failed request is counted
            print(f"pass {k} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            reqs.append((time.perf_counter(), time.perf_counter(), None))
            k += 1
            continue
        reqs.append((t0, t1, decided))
        st.kept.add(rec, decided)
        st.work.append(_work(st, rec))
        k += 1
    return reqs


def _work(st: State, rec: dict) -> dict:
    """The reference's shapes of one pass: live nodes N, request groups
    G and resource columns R of the screen, the subsets S the tournament
    scored (kernel A runs once in a fresh screen and once in a fresh
    tournament), and the (bytes, operations) of B0 and B over the pass's
    optimizer verifies (`roofline/scan.py`, summed): the ranked subsets
    in order, at most VERIFY_LIMIT, up to the one the pass executed. A
    verify re-solves the victims' groups against the standing nodes, so
    every group step looks at each of them; the nodes it opens and the
    placements past one a group are not counted."""
    b = rec["before"]
    groups = int(np.count_nonzero(np.bincount(st.group[b.pod_node >= 0],
                                              minlength=1)))
    plan = rec["plan"] if rec["plan_fresh"] else None
    b0 = bb = (0, 0)
    if plan is not None:
        done = {tuple(sorted(d.victims)) for d in rec["decisions"]
                if d.reason == "Underutilized"}
        T, Z, C = st.cat.price.shape
        for s in plan["ranked"][:VERIFY_LIMIT]:
            g, n = RC.verify_shapes(b, st.group, s, _deleting(rec))
            one = S.offer_argmin(g, T, Z, C, len(R.RES))
            b0 = (b0[0] + one[0], b0[1] + one[1])
            one = S.solve_scan(g, T, Z, C, len(R.RES), n, g * n, g)
            bb = (bb[0] + one[0], bb[1] + one[1])
            if tuple(sorted(s)) in done:
                break
    return {"N": int(b.node_live.sum()), "G": groups, "R": len(R.RES),
            "screen": rec["screen_fresh"],
            "S": len(plan["subsets"]) if plan is not None else 0,
            "b0": b0, "b": bb}


def release(st: State) -> None:
    f = st.sim.solver.stats
    ds = st.sim.disruption.stats
    st.fallbacks = (f.get("device_fallbacks", 0)
                    + f.get("integrity_violations", 0)
                    + ds.get("screen_errors", 0)
                    + ds.get("optimizer_errors", 0))
    st.sim = st.pods = None


def _answers(st: State, rec: dict, control: str):
    """The pass's screen verdicts and scored subsets: the program's, or
    with `control` the reference's own in that precision."""
    plan = rec["plan"]
    if not control:
        return rec["screen"], plan
    b = rec["before"]
    ok = None
    if rec["screen"] is not None:
        ref = RC.screen(b, st.req, st.group, st.cat, precision=control)
        ok = {n for n, v in ref.items() if v}
    if plan is not None:
        f, s = RC.subsets(b, st.req, st.group, st.cat, plan["subsets"],
                          _deleting(rec), precision=control)
        plan = dict(plan, feasible=f.tolist(), savings=s.tolist())
    return ok, plan


def _deleting(rec: dict) -> list:
    return [v for d in rec["decisions"] if d.reason == "Empty"
            for v in d.victims]


def judge(st: State, seed: int, want_work: bool = False,
          control: str = ""):
    """The sampled passes against the reference: the audit's counts, the
    screen verdicts and the scored subsets that differ (summed), and the
    largest relative difference of a subset's savings. With `control`
    ("bfloat16") the reference in that precision stands in for the
    program's screen and subsets: the control, which has to come out as
    not correct. With `want_work`, the reference's shapes of every pass
    of the window."""
    nums = {"missing": 0, "infeasible": 0, "wrongly_unschedulable": 0,
            "fallbacks": st.fallbacks, "screen_diff": 0, "subset_diff": 0,
            "savings_rdiff_max": 0.0}
    picked = st.kept.sample()
    if not picked:
        return {k: float("inf") for k in nums}, []
    for rec in picked:
        b = rec["before"]
        ok, plan = _answers(st, rec, control)
        need_screen, need_search = RC.expected(b, rec["decisions"],
                                               rec["disrupting"])
        # the answers the pass used, fresh or served from a memo, against
        # the reference on the pass's own snapshot; a pass that had to
        # answer and holds no answer counts one difference
        if need_screen or rec["screen_fresh"]:
            nums["screen_diff"] += 1 if ok is None else RC.compare_screen(
                ok, RC.screen(b, st.req, st.group, st.cat))
        if (need_search or rec["plan_fresh"]) and plan is None:
            nums["subset_diff"] += 1
        elif need_search or rec["plan_fresh"]:
            f, s = RC.subsets(b, st.req, st.group, st.cat, plan["subsets"],
                              _deleting(rec))
            nums["subset_diff"] += RC.compare_subsets(
                plan["feasible"], plan["savings"], f, s)
            for got, want in zip(plan["savings"], s.tolist()):
                nums["savings_rdiff_max"] = max(
                    nums["savings_rdiff_max"],
                    abs(got - want) / max(abs(want), 1e-12))
        for key, v in RC.audit(b, rec["decisions"], rec["after"], st.req,
                               st.cat).items():
            nums[key] += v
    return nums, (st.work if want_work else [])


def inputs(cell: dict, seed: int) -> list:
    """The pods the cluster is provisioned from, without the program."""
    p = cell["params"]
    return [P.generate(p["kinds"], p["pods"], seed)]
