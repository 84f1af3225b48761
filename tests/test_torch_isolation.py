"""karpenter_tpu_torch stands alone: it imports neither jax nor the JAX
package, and without a CUDA device its entry points raise instead of
dropping to the CPU on their own."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "karpenter_tpu_torch"


def test_import_leaves_jax_out():
    """A fresh interpreter imports every module of the port and loads
    chip_smoke.py as a module: neither jax nor karpenter_tpu is loaded."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        sys.path.insert(0, {str(REPO)!r})
        import karpenter_tpu_torch
        for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__,
                                       "karpenter_tpu_torch."):
            importlib.import_module(m.name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(REPO / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "karpenter_tpu" or m.startswith("karpenter_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO / "tests"), env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        list(PKG.rglob("*.py"))
                                        + [REPO / "chip_smoke.py"]))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(REPO / path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "karpenter_tpu"), (path, mod)


def _tiny_problem():
    from karpenter_tpu_torch.catalog import GeneratorConfig, generate_catalog
    from karpenter_tpu_torch.models import Pod, Resources
    from karpenter_tpu_torch.ops.encode import encode_catalog, encode_pods
    cat = encode_catalog(generate_catalog(GeneratorConfig(families=["m5"])))
    enc = encode_pods([Pod(name=f"p{i}", requests=Resources.parse(
        {"cpu": "1", "memory": "1Gi"})) for i in range(5)], cat)
    return cat, enc


def test_entry_points_raise_without_cuda():
    """device=None means the card: with no CUDA device both entry points
    raise, and device='cpu' is the only way to run them on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from karpenter_tpu_torch.models.nodeclaim import NodeClaim
    from karpenter_tpu_torch.ops.consolidate import consolidation_screen
    from karpenter_tpu_torch.state.cluster import NodeView
    from karpenter_tpu_torch.ops.solver import solve_device
    cat, enc = _tiny_problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_device(cat, enc)
    res = solve_device(cat, enc, device="cpu")
    views = [NodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"), node=None,
                      pods=[], virtual=n, price=0.0)
             for i, n in enumerate(res.nodes)]
    counts = np.zeros((len(views), enc.G), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        consolidation_screen(cat, enc, views, counts)
    screen, _ = consolidation_screen(cat, enc, views, counts, device="cpu")
    assert screen.shape == (len(views),)


def test_solver_facade_needs_a_card_or_a_device():
    """Solver(prov, backend="device") — and "hybrid" — without a card and
    without device= raises, as solve_device does; device="cpu" runs the
    plain versions, "auto" resolves to a host rung. "mesh" needs more than
    one device: make_mesh(n) raises when fewer than n cards exist, and
    never builds CPU shards in their place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from karpenter_tpu_torch.catalog import CatalogProvider, small_catalog
    from karpenter_tpu_torch.models import NodePool, Pod, Resources
    from karpenter_tpu_torch.ops.facade import Solver
    types = small_catalog()
    prov = CatalogProvider(lambda: types)
    for backend in ("device", "hybrid"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Solver(prov, backend=backend)
    from karpenter_tpu_torch.parallel import make_mesh
    for n in (1, 2, 8):
        with pytest.raises(RuntimeError, match=f"needs {n} devices and 0 "
                                               f"CUDA devices exist"):
            make_mesh(n)
    with pytest.raises(RuntimeError, match="needs more than one device"):
        Solver(prov, backend="mesh")
    assert Solver(prov, backend="auto").backend in ("native", "host")
    out = Solver(prov, backend="device", device="cpu").solve(
        [Pod(name="p", requests=Resources.parse({"cpu": "1"}))],
        NodePool(name="default"))
    assert len(out.launches) == 1 and not out.unschedulable


def test_make_sim_needs_a_card_or_a_device(monkeypatch):
    """The port's sim without a card and without device= raises on every
    rung (the consolidation screen runs on the device on every rung);
    device="cpu" builds it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from karpenter_tpu_torch.sim import make_sim
    for backend in ("device", "native", "host"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_sim(backend=backend)
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER", raising=False)
    sim = make_sim(backend="device", device="cpu")
    assert sim.solver.device.type == "cpu"


def test_operator_and_soak_need_a_card_or_a_device():
    """The operator shell and the soak without a card and without a device
    raise; Options(device="cpu") / device="cpu" build them on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from karpenter_tpu_torch.catalog import small_catalog
    from karpenter_tpu_torch.cloud.fake import FakeCloud
    from karpenter_tpu_torch.loadgen import SoakRunner
    from karpenter_tpu_torch.main import build_operator
    from karpenter_tpu_torch.utils.options import Options
    for backend in ("device", "host"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_operator(Options(solver_backend=backend, metrics_port=0),
                           cloud=FakeCloud(small_catalog()))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SoakRunner("soak_smoke", backend=backend).build()
    # the defaults solve on the device rung, as make_sim's does
    assert Options().solver_backend == "device"
    assert SoakRunner("soak_smoke").backend == "device"
    from karpenter_tpu_torch.loadgen.__main__ import main as loadgen_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen_main(["soak_smoke"])
    runtime, _, _ = build_operator(Options(metrics_port=0, device="cpu"),
                                   cloud=FakeCloud(small_catalog()))
    prov = next(c for c in runtime.controllers
                if getattr(c, "name", "") == "provisioner")
    assert prov.solver.backend == "device"
    runtime, _, _ = build_operator(
        Options(solver_backend="device", metrics_port=0, device="cpu"),
        cloud=FakeCloud(small_catalog()))
    assert runtime.controllers
    runner = SoakRunner("soak_smoke", backend="device", device="cpu")
    runner.build()
    assert runner.service.device == "cpu"


def test_optimizer_tournament_needs_a_card_or_a_device():
    """The optimizer's device tournament (kernels A and C) without a card
    and without device= raises, as the screen does; device="cpu" runs
    the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from karpenter_tpu_torch.models.nodeclaim import NodeClaim
    from karpenter_tpu_torch.optimizer.tournament import score_subsets_device
    from karpenter_tpu_torch.ops.solver import solve_device
    from karpenter_tpu_torch.state.cluster import NodeView
    cat, enc = _tiny_problem()
    res = solve_device(cat, enc, device="cpu")
    views = [NodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"), node=None,
                      pods=[], virtual=n, price=1.0)
             for i, n in enumerate(res.nodes * 2)]
    counts = np.ones((len(views), enc.G), np.int32)
    prices = np.ones(len(views), np.float32)
    masks = np.eye(len(views), dtype=np.float32)[:1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_subsets_device(cat, enc, views, counts, prices, masks)
    feasible, savings, _res, _lb = score_subsets_device(
        cat, enc, views, counts, prices, masks, device="cpu")
    assert feasible.shape == (1,) and savings[0] == 1.0


def test_wrappers_refuse_other_devices():
    """The kernel wrappers take the plain version only for CPU tensors."""
    from karpenter_tpu_torch.ops.screen_k import screen_k
    from karpenter_tpu_torch.optimizer.tournament_k import tournament
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        screen_k(meta, torch.empty((3, 2), device="meta"),
                 torch.empty((4, 3), dtype=torch.bool, device="meta"))
    g3 = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tournament(meta, torch.empty((3, 2), device="meta"), g3, g3,
                   torch.empty((1, 4), device="meta"),
                   torch.empty(4, device="meta"), torch.empty(3, device="meta"))


def test_chip_smoke_fails_without_cuda():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    """Alone in a directory, chip_smoke.py cannot import the port and
    exits non-zero (before or after its CUDA check) with no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


PLANES = ("obs/exposition.py", "obs/profile.py", "obs/devicemem.py",
          "obs/recompute.py", "ops/delta.py", "ops/resident.py")


def test_delta_and_resident_planes_are_the_ports_own():
    """The delta plane, the resident state and their telemetry ledgers
    are files of the port (the import scan above covers each one), their
    process singletons are the port's own, and the resident entry points
    without a card and without device= raise."""
    import importlib
    for rel in PLANES:
        assert (PKG / rel).is_file(), rel
        mod = importlib.import_module(
            "karpenter_tpu_torch." + rel[:-3].replace("/", "."))
        assert mod.__name__.startswith("karpenter_tpu_torch.")
    if torch.cuda.is_available():
        return
    from karpenter_tpu_torch.ops.resident import RESIDENT
    from karpenter_tpu_torch.ops.solver import device_catalog
    cat, _ = _tiny_problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RESIDENT.upload(("isolation",), np.ones((2, 2), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_catalog(cat, cat.allocatable.shape[1], None,
                       resident_key=("isolation",))
    RESIDENT.reset()


def test_measurement_plane_needs_a_card_or_a_device():
    """The device-time probes, their kernel inputs and the device report
    without a card and without a device raise; device="cpu" /
    --device cpu runs them on the host. provenance() says the run is a
    CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from karpenter_tpu_torch.models.nodeclaim import NodeClaim
    from karpenter_tpu_torch.obs import device_report
    from karpenter_tpu_torch.ops import consolidate, solver
    from karpenter_tpu_torch.state.cluster import NodeView
    cat, enc = _tiny_problem()
    res = solver.solve_device(cat, enc, device="cpu")
    views = [NodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"), node=None,
                      pods=[], virtual=n, price=0.0)
             for i, n in enumerate(res.nodes)]
    counts = np.zeros((len(views), enc.G), np.int32)
    for call in (lambda: solver.kernel_args(cat, enc),
                 lambda: solver.kernel_device_time(cat, enc, iters=2),
                 lambda: consolidate.screen_device_time(cat, enc, views,
                                                        counts, iters=2),
                 lambda: device_report.main(["--pods", "16", "--rounds",
                                             "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert solver.kernel_device_time(cat, enc, iters=2, device="cpu") > 0
    assert solver.provenance()["cpu_fallback"] is True
