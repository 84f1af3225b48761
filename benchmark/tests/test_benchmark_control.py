"""The comparison that decides `correct` fails what it must: the control
(the reference planned in bfloat16 in the program's place) at a size a
test run holds, and a whole run, its look for a card skipped, with the
timed path broken underneath."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import control
from benchmark.harness import check as V
from benchmark.harness import registry

ROOT = registry.ROOT
SMALL = {
    "scaleup-100k.grid": {"pool": 3000, "pods": 2500},
    "scaleup-100k.replicas": {"pool": 3000, "pods": 2500},
    "fleet-16.fresh": {"tenants": 4, "tenant_pool": 600, "sample": 8,
                       "warm_rounds": 1, "burst": {"min": 32, "max": 256}},
    "fleet-16.repeat": {"tenants": 4, "tenant_pool": 600, "sample": 8,
                        "warm_rounds": 1, "burst": {"min": 32, "max": 256}},
}


def small(cell):
    w = registry.workload(cell)
    w["params"].update(SMALL[cell])
    return w


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    w = small(cell)
    for seed in (1, 2, 3):
        ok, rows = V.verdict(control.judge(w, seed), w["limits"])
        assert not ok


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_cost_faults_are_not_correct(fault):
    """Answers that keep every guarantee and cost more: each reference
    answer with one fault planted fails `cost_gap` or `node_gap`."""
    w = small("scaleup-100k.replicas")
    for seed in (1, 2, 3):
        nums = control.judge(w, seed, fault=fault)
        ok, rows = V.verdict(nums, w["limits"])
        assert not ok
        assert nums["missing"] + nums["infeasible"] == 0


def run_module():
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", os.path.join(ROOT, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_root(tmp_path, cell):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("tests"))
    w = json.load(open(root / "workloads" / f"{cell}.json"))
    w["params"].update(SMALL[cell])
    (root / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    shutil.copy(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    return str(root)


def unchanged(real):
    """A step that returns its state unchanged: every solve after the
    first answers with the first's output."""
    first = []

    def fn(self, *a, **k):
        out = real(self, *a, **k)
        if not first:
            first.append(out)
        return first[0]
    return fn


def half(real):
    """Half the batch left out: the answer keeps the first half of its
    launches."""
    def fn(self, *a, **k):
        out = real(self, *a, **k)
        out.launches = out.launches[: len(out.launches) // 2]
        return out
    return fn


def altered(real):
    """An answer altered where it is produced: the first launch's type
    becomes the catalog's first."""
    def fn(self, *a, **k):
        out = real(self, *a, **k)
        if out.launches:
            out.launches[0].instance_type = "c5.medium"
        return out
    return fn


def dearer(real):
    """The capacity type lost where the answer is produced: every node at
    its type's on-demand offering in its zone, at that offering's price."""
    from benchmark.reference import catalog as K
    od = {(t["name"], o["zone"]): o["price"] for t in K.generate()
          for o in t["offerings"] if o["capacity_type"] == K.ON_DEMAND}

    def fn(self, *a, **k):
        out = real(self, *a, **k)
        for l in out.launches:
            if (l.instance_type, l.zone) in od:
                l.capacity_type = K.ON_DEMAND
                l.price = od[(l.instance_type, l.zone)]
        return out
    return fn


@pytest.mark.parametrize("cell", ["scaleup-100k.grid", "fleet-16.fresh",
                                  "scaleup-100k.replicas"])
@pytest.mark.parametrize("fault", [None, unchanged, half, altered, dearer])
def test_run_with_a_broken_path(tmp_path, monkeypatch, cell, fault):
    from karpenter_tpu_torch.ops.facade import Solver
    if fault is not None:
        monkeypatch.setattr(Solver, "finish_solve",
                            fault(Solver.finish_solve))
    root = small_root(tmp_path, cell)
    monkeypatch.chdir(tmp_path)
    run = run_module()
    args = run.parse(["--workload", cell, "--seed", str(2**31 + 3),
                      "--seconds", "1", "--trace", "0"])
    result = run.run(args, device="cpu", root=root)
    assert result["correct"] is (fault is None)
    assert list(result)[-1] == "checks"


PLANTED = """
import importlib.util, os, sys
spec = importlib.util.spec_from_file_location(
    "benchmark_run", os.path.join(sys.argv[1], "run.py"))
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
run.card_or_exit = lambda chips: None
sys.exit(run.main(sys.argv[2:], device="cpu", root=sys.argv[1]))
"""


def test_jax_loaded_after_the_window_gives_no_result(tmp_path):
    """A per-layer reader that imports a module named jax: the run reads
    its metrics after the window has closed, and the check made just
    before the result is printed still sees it."""
    cell = "fleet-16.fresh"
    root = small_root(tmp_path, cell)
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    with open(os.path.join(root, "layers", "planted.py"), "w") as f:
        f.write("import jax  # noqa: F401\n\n\ndef read(ctx):\n"
                "    return 1.0\n")
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["per_layer"].append({
        "name": "planted", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "planted",
        "moves": "pods_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(ROOT), str(tmp_path / "stub")]))
    out = subprocess.run(
        [sys.executable, "-c", PLANTED, root, "--workload", cell,
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "jax loaded" in out.stderr
    assert '"correct"' not in out.stdout


@pytest.mark.cuda
def test_a_run_on_the_card(tmp_path):
    """The command as the check runs it, on a short window; skips where
    there is no card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    repo = os.path.dirname(ROOT)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fleet-16.fresh",
         "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
