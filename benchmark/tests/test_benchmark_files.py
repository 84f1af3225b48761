"""Every cell, configuration, traffic driver and per-layer metric of
BENCHMARK.json loads by its name, and a cell added only as files loads
as well."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness import registry

ROOT = registry.ROOT
BENCH = registry.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    w = registry.workload(cell)
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["config"] == entry["config"]
    assert w["configuration"]["name"] == entry["config"]
    drv = registry.driver(w["driver"])
    for fn in ("setup", "window", "stats", "release", "judge", "inputs"):
        assert callable(getattr(drv, fn))
    assert w["limits"] and all(v >= 0 for v in w["limits"].values())
    assert registry.metrics_of(cell, False)
    assert registry.metrics_of(cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(registry.reader(metric).read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    c = next(x for x in BENCH["configs"] if x["name"] == config)
    with open(os.path.join(os.path.dirname(ROOT), c["file"])) as f:
        body = json.load(f)
    assert body["name"] == config and body["source"] == c["source"]
    assert list(body["reduced"]) == c["reduced"]


def test_cell_added_as_files_only(tmp_path):
    """A later PR adds a cell by a workload file (and a configuration
    file): the harness finds both by name, and the cell reports every
    metric that lists no cells."""
    root = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "configs"), root / "configs")
    (root / "workloads").mkdir()
    cell = json.load(open(os.path.join(ROOT, "workloads",
                                       "fleet-16.fresh.json")))
    cell["name"] = "fleet-16.later"
    cell["params"]["tenants"] = 4
    (root / "workloads" / "fleet-16.later.json").write_text(json.dumps(cell))
    w = registry.workload("fleet-16.later", str(root))
    assert w["params"]["tenants"] == 4
    assert w["configuration"]["name"] == "fleet-16"
    names = {m["name"] for m in registry.metrics_of("fleet-16.later", True,
                                                    BENCH)}
    assert {m["name"] for m in BENCH["per_layer"]
            if "workloads" not in m} <= names
