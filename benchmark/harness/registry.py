"""Everything of one cell, configuration, traffic driver or per-layer
metric is a file of its own, found by its name."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, root: str = ROOT) -> dict:
    """The cell `benchmark/workloads/<name>.json` with its configuration
    (`benchmark/configs/<config>.json`) under "configuration"."""
    cell = _json(os.path.join(root, "workloads", f"{name}.json"))
    cell["configuration"] = _json(os.path.join(root, "configs",
                                               f"{cell['config']}.json"))
    return cell


def _module(kind: str, name: str, root: str) -> ModuleType:
    path = os.path.join(root, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: str = ROOT) -> ModuleType:
    """The traffic driver `benchmark/traffic/<name>.py`."""
    return _module("traffic", name, root)


def reader(metric: str, root: str = ROOT) -> ModuleType:
    """The per-layer metric's reader `benchmark/layers/<metric>.py`."""
    return _module("layers", metric, root)


def spec(root: str = ROOT) -> dict:
    """BENCHMARK.json, beside the benchmark's folder."""
    return _json(os.path.join(os.path.dirname(root), "BENCHMARK.json"))


def metrics_of(cell: str, per_layer: bool, bench: Optional[dict] = None,
               root: str = ROOT) -> list:
    """The metrics a cell reports: its end-to-end ones, or with a trace
    its per-layer ones (a metric with `workloads` only in those cells)."""
    bench = bench if bench is not None else spec(root)
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]
