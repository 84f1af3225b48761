"""The benchmark cell consolidate-5k.scaledown at a small size on the CPU
(the port's plain kernels): a sound run is `correct`, each fault planted
in the timed path makes it not correct, the control (the reference in
bfloat16 in the program's place) is not correct, a pass past its
deadline fails the run, and the roofline counts of kernels A and C match
a hand-worked case."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import time

import numpy as np
import pytest

from benchmark.harness import check as V
from benchmark.harness import registry
from benchmark.roofline import consolidate as RF

CELL = "consolidate-5k.scaledown"
SMALL = {"pods": 1700}
SEED = 2**31 + 3


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", os.path.join(registry.ROOT, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_root(tmp_path, **params):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    w = json.load(open(root / "workloads" / f"{CELL}.json"))
    w["params"].update(SMALL, **params)
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    shutil.copy(os.path.join(os.path.dirname(registry.ROOT),
                             "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    return str(root)


def _result(tmp_path, monkeypatch, seconds=1.5, **params):
    root = _small_root(tmp_path, **params)
    monkeypatch.chdir(tmp_path)
    run = _run_module()
    args = run.parse(["--workload", CELL, "--seed", str(SEED),
                      "--seconds", str(seconds), "--trace", "0"])
    return run.run(args, device="cpu", root=root)


# --- planted faults, each where the program produces its answer ------------

def flipped_screen(monkeypatch):
    """The first node's screen verdict flipped."""
    from karpenter_tpu_torch.ops import consolidate
    real = consolidate.consolidation_screen

    def fn(*a, **k):
        screen, slack = real(*a, **k)
        screen = screen.copy()
        screen[0] = not screen[0]
        return screen, slack
    monkeypatch.setattr(consolidate, "consolidation_screen", fn)


def flipped_subset(monkeypatch):
    """The first scored subset's feasibility flipped."""
    from karpenter_tpu_torch import optimizer
    real = optimizer.score_subsets_device

    def fn(*a, **k):
        feasible, savings, residual, repl_lb = real(*a, **k)
        feasible = feasible.copy()
        feasible[0] = not feasible[0]
        return feasible, savings, residual, repl_lb
    monkeypatch.setattr(optimizer, "score_subsets_device", fn)


def _priciest(cat_types):
    best = None
    for t in cat_types:
        if (t.capacity.get("nvidia.com/gpu", 0)
                or t.capacity.get("google.com/tpu", 0) or "metal" in t.name):
            continue
        for o in t.offerings:
            if (o.capacity_type == "on-demand" and o.available
                    and not o.reservation_id
                    and (best is None or o.price > best[3])):
                best = (t.name, o.zone, o.capacity_type, o.price)
    return best


def dearer(monkeypatch):
    """An executed consolidation's pods all moved onto one new node of
    the catalog's priciest offering instead."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController
    from karpenter_tpu_torch.models.resources import Resources
    from karpenter_tpu_torch.ops.facade import NodeLaunch
    real = DisruptionController._execute

    def fn(self, pool, victims, out, reason, now, source="greedy",
           views=None):
        if reason == "Underutilized" and out.existing_placements:
            o = _priciest(self.catalog.raw_types())
            keys = [k for ks in out.existing_placements.values() for k in ks]
            req = Resources()
            for v in victims:
                for p in v.pods:
                    req = req.add(p.requests)
            out.launches = list(out.launches) + [NodeLaunch(
                instance_type=o[0], zone=o[1], capacity_type=o[2],
                price=o[3], overrides=[o], pod_keys=keys, requests=req)]
            out.existing_placements = {}
        return real(self, pool, victims, out, reason, now, source, views)
    monkeypatch.setattr(DisruptionController, "_execute", fn)


def dropped(monkeypatch):
    """One victim pod left out of an executed decision's placements."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController
    real = DisruptionController._execute

    def fn(self, pool, victims, out, reason, now, source="greedy",
           views=None):
        for name, keys in out.existing_placements.items():
            if keys:
                out.existing_placements[name] = keys[1:]
                break
        return real(self, pool, victims, out, reason, now, source, views)
    monkeypatch.setattr(DisruptionController, "_execute", fn)


def over_budget(monkeypatch):
    """The budget ignored after set-up's warm pass, where the greedy
    multi-node pass (the optimizer off) takes the longest cost-ordered
    prefix of candidates that repacks."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController as D
    real = (D.reconcile, D._budget)
    passes = []

    def reconcile(self, now):
        passes.append(now)
        return real[0](self, now)

    def budget(self, *a, **k):
        return 10**6 if len(passes) > 1 else real[1](self, *a, **k)
    monkeypatch.setattr(D, "reconcile", reconcile)
    monkeypatch.setattr(D, "_budget", budget)
    monkeypatch.setattr(D, "_multi_node_optimizer",
                        lambda self, *a, **k: False)


def stale_screen(monkeypatch):
    """The screen served from the controller's memo whatever changed: every
    pass after set-up's warm pass uses the warm pass's verdicts (a
    fingerprint that misses every change)."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController as D
    real = D._screen_state

    def fn(self, pool, cat, views):
        prev = self._screen_cache.get(pool.name)
        state = real(self, pool, cat, views)
        if prev is None or state is None:
            return state
        self._screen_cache[pool.name] = prev
        self.stats["screen_cache_hits"] = (
            self.stats.get("screen_cache_hits", 0) + 1)
        return state[:3] + (prev[1][3],) + state[4:]
    monkeypatch.setattr(D, "_screen_state", fn)


def served_search(monkeypatch):
    """The fruitless-search memo served in place of A and C: after the
    warm pass's search, every pass keeps that search's answer."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController as D
    real = D._multi_node_optimizer

    def fn(self, pool, *a, **k):
        if pool.name in self.plans:
            return False
        return real(self, pool, *a, **k)
    monkeypatch.setattr(D, "_multi_node_optimizer", fn)


def no_search(monkeypatch):
    """The subset search never runs and leaves no record (the program as
    it stood before the controller kept its plans)."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController as D
    monkeypatch.setattr(D, "_multi_node_optimizer",
                        lambda self, *a, **k: False)


def mispriced(monkeypatch):
    """Every claim the provisioner launches priced 10% under its
    offering."""
    from karpenter_tpu_torch.controllers.provisioner import Provisioner
    real = Provisioner._launch

    def fn(self, *a, **k):
        launched, failed = real(self, *a, **k)
        for claim in launched:
            claim.price *= 0.9
        return launched, failed
    monkeypatch.setattr(Provisioner, "_launch", fn)


# each fault, and the check that has to see it
FAULTS = [(None, None), (flipped_screen, "screen_diff"),
          (flipped_subset, "subset_diff"), (dearer, "violations"),
          (dropped, "violations"), (over_budget, "violations"),
          (stale_screen, "screen_diff"), (served_search, "subset_diff"),
          (no_search, "subset_diff"), (mispriced, "violations")]


@pytest.mark.parametrize("fault,seen_by", FAULTS,
                         ids=[f.__name__ if f else "None" for f, _ in FAULTS])
def test_run_with_a_broken_path(tmp_path, monkeypatch, fault, seen_by):
    if fault is not None:
        fault(monkeypatch)
    result = _result(tmp_path, monkeypatch)
    checks = result["checks"]
    assert result["correct"] is (fault is None), checks
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"
    assert result["failed"] == 0
    if fault is None:
        assert checks["violations"]["value"] == 0
        assert checks["screen_diff"]["value"] == 0
        assert checks["subset_diff"]["value"] == 0
        assert result["metrics"]["pods_per_s"]["value"] > 0
    else:
        assert checks[seen_by]["value"] > checks[seen_by]["limit"], checks


def test_the_control_is_not_correct():
    """The reference's own screen and subsets, in bfloat16, judged against
    the reference in float32: not correct, on the same passes a run
    judges; the program's answers on those passes are."""
    cell = registry.workload(CELL)
    cell["params"].update(SMALL)
    drv = registry.driver(cell["driver"])
    st = drv.setup(cell, SEED, "cpu")
    drv.window(st, 1.0)
    drv.release(st)
    nums, _ = drv.judge(st, SEED)
    assert V.verdict(nums, cell["limits"])[0], nums
    assert nums["savings_rdiff_max"] < 1e-6
    ctl, _ = drv.judge(st, SEED, control="bfloat16")
    assert not V.verdict(ctl, cell["limits"])[0]
    assert ctl["subset_diff"] > 0 and ctl["savings_rdiff_max"] > 1e-4


def test_a_pass_past_its_deadline_fails_the_run(monkeypatch):
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController
    monkeypatch.setattr(DisruptionController, "reconcile",
                        lambda self, now: time.sleep(30))
    cell = registry.workload(CELL)
    cell["params"].update(pods=300, deadline_s=0.5)
    drv = registry.driver(cell["driver"])
    t0 = time.perf_counter()
    with pytest.raises(drv.PassTimeout):
        drv.setup(cell, SEED, "cpu")
    assert time.perf_counter() - t0 < 20


def test_roofline_counts_by_hand():
    # A at N=3 nodes, G=2 groups, R=3 resources: headroom 3*3*4 = 36
    # bytes, requests 2*3*4 = 24, eligibility 6 bytes, k 6*4 = 24 out;
    # per pair 3 resources x (div, add, floor, min) + clamp + select = 14
    assert RF.screen_k(3, 2, 3) == (36 + 24 + 6 + 24, 6 * 14)
    # C at S=2 subsets, N=3, G=2, R=3, 6 iterations: k and counts
    # 2*(3*2)*4 = 48, masks 2*3*4 = 24, headroom 36, requests 24, prices
    # 12, per-slot prices 8, out 2*4*4 = 32; per cell 3 + 6*(2*3+7) +
    # (2*3+2) = 89, 12 cells, plus colsum(k) 6
    assert RF.tournament(2, 3, 2, 3) == (48 + 24 + 36 + 24 + 12 + 8 + 32,
                                         12 * 89 + 6)
    assert RF.tournament(2, 3, 2, 3, iters=0)[1] == 12 * (3 + 8) + 6
    t = RF.bound_s(*RF.screen_k(5000, 90, 3))
    assert 0 < t < 1e-5


def test_reference_screen_on_a_hand_case():
    """Two nodes of one type, one group of 1-core, 128Mi pods, two on a
    and five on b: a passes when b's headroom takes its two pods, b when
    a's takes its five; the pair has no survivor to take anything."""
    from benchmark.reference import consolidate as RC
    from benchmark.reference import plan as R
    from benchmark.reference.catalog import generate
    cat = R.build_catalog(generate(), {"name": "d"}, [])
    t = next(i for i in range(len(cat.names))
             if not cat.exotic[i] and cat.avail[i, 0, 0]
             and cat.alloc[i, 0] >= 8)
    m = RC.Mirror(np.array([0, 0, 1, 1, 1, 1, 1, -1], np.int32))
    m.add_node("a", t, 0, 0, 1.0, 1.0)
    m.add_node("b", t, 0, 0, 2.0, 2.0)
    req = RC.pod_requests(np.full(8, 1.0), np.full(8, 128 * 2.0**20))
    group = np.zeros(8, np.int64)
    snap = m.snapshot()
    cpu, mem, slots = (float(x) for x in cat.alloc[t])

    def k(n):   # pods of the group a node with n of them still takes
        return min(np.floor(cpu - n), np.floor((mem - 128 * n) / 128),
                   slots - n)
    assert RC.screen(snap, req, group, cat) == {"a": k(5) >= 2,
                                                "b": k(2) >= 5}
    feas, sav = RC.subsets(snap, req, group, cat, [[0], [0, 1]])
    assert feas.tolist() == [bool(k(5) >= 2), False]
    assert sav.tolist() == [1.0, 3.0]
