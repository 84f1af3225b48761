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
    plain versions, "auto" resolves to a host rung, "mesh" is not
    ported."""
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
    with pytest.raises(NotImplementedError, match="not ported"):
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
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    sim = make_sim(backend="device", device="cpu")
    assert sim.solver.device.type == "cpu"


def test_wrappers_refuse_other_devices():
    """The kernel wrappers take the plain version only for CPU tensors."""
    from karpenter_tpu_torch.ops.screen_k import screen_k
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        screen_k(meta, torch.empty((3, 2), device="meta"),
                 torch.empty((4, 3), dtype=torch.bool, device="meta"))


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
