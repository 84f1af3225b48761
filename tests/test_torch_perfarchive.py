"""The port's perf archive and regression gate
(`karpenter_tpu_torch/obs/perfarchive.py`, `obs/perf_gate.py`) held
against the JAX reference's (`karpenter_tpu/obs/perfarchive.py`,
`tools/perf_gate.py`).

Every case of the reference's `tests/test_perfgate.py`, of
`tests/test_loadgen.py::TestPerfGateClassification` and the two perfarchive
cases of `tests/test_integrity.py` runs through both packages on the same
inputs (each in its own temporary directory), keeps the reference's own
assertions, and requires equal observables: metric directions, RunRecord
dicts, baselines, GateReport verdicts and summaries, trajectories. Then
the port's own families: a `torch` or `torch-mesh` candidate is never
baselined against `bench`, `mesh` or `legacy:` runs, a CPU run of the port
(`run_stamp` of a `cpu_fallback` provenance) never judges or is judged,
and the gate's CLI follows `tools/perf_gate.py`'s exit-code rule.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from karpenter_tpu.obs import perfarchive as ref_pa
from karpenter_tpu_torch.obs import perfarchive as port_pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", pa=ref_pa)
PORT = SimpleNamespace(name="port", pa=port_pa)


@pytest.fixture(autouse=True)
def _no_archive_env(monkeypatch):
    """Every case resolves its archive from its arguments, never from an
    ambient $KARPENTER_TPU_PERF_ARCHIVE (restored after the case)."""
    monkeypatch.delenv(ref_pa.ARCHIVE_ENV, raising=False)


def _both(case, tmp_path):
    out = []
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        out.append(case(P, d))
    assert out[1] == out[0]
    return out[1]


def _run(P, run_id, metrics, comparable=True, schema=None,
         platform="accelerator", family="bench"):
    return P.pa.RunRecord(
        run_id=run_id, family=family, source=f"{run_id}.json",
        schema_version=P.pa.SCHEMA_VERSION if schema is None else schema,
        comparable=comparable,
        provenance={"platform": platform, "backend": "tpu"},
        seed=0, metrics=dict(metrics))


def _archive(P, d, runs):
    arch = P.pa.PerfArchive(str(d / "perf_archive.jsonl"), root=str(d))
    for r in runs:
        arch.append(r)
    return arch


def _report(report):
    return (report.candidate, report.reason, report.ok, report.summary(),
            [vars(v) for v in report.verdicts])


BASE = {"c5_100k_full_ms": 100.0, "host_ffd_100k_ms": 200.0,
        "pods_per_sec": 1_000_000.0, "headline_ms": 100.0}


def test_constants_equal_the_reference():
    for name in ("SCHEMA_VERSION", "ARCHIVE_ENV", "ARCHIVE_NAME",
                 "GATE_RATIO", "GATE_K", "MAD_FLOOR", "MIN_BASELINE"):
        assert getattr(port_pa, name) == getattr(ref_pa, name), name
    for name in ("_LOWER_BETTER", "_HIGHER_BETTER", "_NEVER_GATES"):
        assert getattr(port_pa, name).pattern == \
            getattr(ref_pa, name).pattern, name
    assert port_pa.GATE_RATIO < 1.5  # a 1.5x regression clears the bar
    assert port_pa.FAMILIES == ("bench", "mesh", "torch", "torch-mesh")


# --- TestDirections (and the loadgen / integrity classification cases) ---

DIRECTION_KEYS = {
    "classification": {
        "c5_100k_full_ms": "lower", "headline_ms": "lower",
        "pods_per_sec": "higher", "fleet_vs_serial": "higher",
        "warm_hit_rate": "higher", "c5_uploads_per_solve": None,
        "c8_standing_nodes": None},
    "device_telemetry": {
        "c12_hbm_watermark_bytes": "lower", "devicemem_watermark": "lower",
        "c12_batched_h2d_bytes": "lower", "c12_batched_d2h_bytes": "lower",
        "devicemem_unattributed_bytes": "lower",
        "c3_upload_redundant_frac": None, "c12_upload_redundant_frac": None},
    "optimizer": {
        "c14_optimizer_savings_total": "higher",
        "c14_greedy_savings_total": "higher",
        "c14_subsets_per_sec": "higher", "c14_exact_verifies": None,
        "c14_subsets_scored": None, "c14_joint_consolidations": None},
    "loadgen_c13": {
        "c13_arrivals_per_sec": "higher",
        "c13_admitted_arrivals_per_sec": "higher",
        "soak_arrivals_per_sec": "higher", "c13_shed_frac": None,
        "soak_shed_frac": None, "c13_soak_wall_ms": "lower",
        "c13_max_waiting_depth": None},
    "integrity": {
        "c3_integrity_overhead_frac": "lower",
        "c15_sdc_detection_rate": "higher",
        "integrity_verdicts_total": None, "integrity_violations_total": None,
        "c8_resident_h2d_bytes": "lower", "c13_arrivals_per_sec": "higher"},
    "port": {
        "solve_wall_ms": "lower", "facade_wall_ms": "lower",
        "screen_wall_ms": "lower", "kernel_device_ms": "lower",
        "screen_device_ms": "lower", "resident_rows_frac": None,
        "c17_federated_solves_per_sec": "higher", "x_ms_p99": "lower"},
}


@pytest.mark.parametrize("group", sorted(DIRECTION_KEYS))
def test_metric_direction_equals_the_reference(group):
    for key, want in DIRECTION_KEYS[group].items():
        assert ref_pa.metric_direction(key) == want, key
        assert port_pa.metric_direction(key) == want, key


def _redundant_frac_never_gates(P, d):
    """A wild swing in the redundancy fraction produces NO verdict; a
    byte-key regression does."""
    base = {"headline_ms": 100.0, "c12_hbm_watermark_bytes": 1e6,
            "c3_upload_redundant_frac": 0.9}
    runs = [_run(P, f"r{i}", base) for i in range(3)]
    cand = dict(base)
    cand["c3_upload_redundant_frac"] = 0.01   # collapsed: ungated
    cand["c12_hbm_watermark_bytes"] = 5e6     # 5x footprint: gated
    runs.append(_run(P, "cand", cand))
    arch = _archive(P, d, runs)
    report = arch.gate(arch.load())
    assert not report.ok
    assert {v.metric for v in report.regressions} == \
        {"c12_hbm_watermark_bytes"}
    return _report(report)


def _overhead_regression_gates(P, d):
    """test_integrity.py's case: a 3x overhead-fraction jump fails the
    gate; an identical re-run passes; a detection-rate DROP fails."""
    def rec(run_id, frac=0.01, rate=1.0):
        return P.pa.RunRecord(
            run_id=run_id, family="bench", source="test",
            schema_version=1, comparable=True, seed=0,
            metrics={"c3_integrity_overhead_frac": frac,
                     "c15_sdc_detection_rate": rate})

    arch = P.pa.PerfArchive(str(d / "archive.jsonl"))
    for i in range(3):
        arch.append(rec(f"r-{i}"))
    arch.append(rec("r-same"))
    same = arch.gate(candidate="r-same")
    assert not same.regressions, same.regressions
    arch.append(rec("r-slow", frac=0.03))
    slow = arch.gate(candidate="r-slow")
    assert any(v.metric == "c3_integrity_overhead_frac"
               for v in slow.regressions)
    arch.append(rec("r-drop", rate=0.5))
    drop = arch.gate(candidate="r-drop")
    assert any(v.metric == "c15_sdc_detection_rate"
               for v in drop.regressions)
    return [_report(r) for r in (same, slow, drop)]


# --- TestGate -------------------------------------------------------------

def _baseline_runs(P):
    return [_run(P, f"r{i}", {k: v * f for k, v in BASE.items()})
            for i, f in enumerate((1.0, 0.97, 1.03, 1.01))]


def _identical_rerun_passes(P, d):
    runs = _baseline_runs(P)
    runs.append(_run(P, "rerun", dict(runs[-1].metrics)))
    report = _archive(P, d, runs).gate()
    assert report.candidate == "rerun"
    assert report.ok, report.summary()
    assert not report.regressions
    return _report(report)


def _synthetic_1p5x_latency_regression_flagged(P, d):
    runs = _baseline_runs(P)
    bad = {k: (v * 1.5 if k.endswith("_ms") else v) for k, v in BASE.items()}
    runs.append(_run(P, "regressed", bad))
    report = _archive(P, d, runs).gate()
    assert report.candidate == "regressed"
    assert not report.ok
    names = {v.metric for v in report.regressions}
    assert "c5_100k_full_ms" in names and "headline_ms" in names
    assert "pods_per_sec" not in names  # throughput untouched
    return _report(report)


def _throughput_collapse_flagged(P, d):
    runs = _baseline_runs(P)
    runs.append(_run(P, "slow", {**BASE, "pods_per_sec": 500_000.0}))
    report = _archive(P, d, runs).gate()
    assert {v.metric for v in report.regressions} == {"pods_per_sec"}
    return _report(report)


def _cpu_fallback_excluded_from_baselines(P, d):
    """A 10x-faster CPU run must not drag the baseline down and flag an
    honest accelerator run."""
    runs = _baseline_runs(P)
    runs.append(_run(P, "cpu", {k: v * 0.1 for k, v in BASE.items()},
                     comparable=False, platform="cpu-fallback"))
    runs.append(_run(P, "honest", dict(BASE)))
    arch = _archive(P, d, runs)
    base = arch.baselines(arch.load(), exclude="honest")
    assert 95 < base["c5_100k_full_ms"]["median"] < 105
    report = arch.gate()
    assert report.candidate == "honest"
    assert report.ok, report.summary()
    return base, _report(report)


def _cpu_fallback_never_candidate(P, d):
    runs = _baseline_runs(P)
    runs.append(_run(P, "cpu-last", {k: v * 0.1 for k, v in BASE.items()},
                     comparable=False, platform="cpu-fallback"))
    report = _archive(P, d, runs).gate()
    # the newest run is non-comparable: the gate takes the newest stamped
    # comparable one instead
    assert report.candidate == "r3"
    assert report.ok
    return _report(report)


def _explicit_noncomparable_candidate_not_gated(P, d):
    runs = _baseline_runs(P)
    runs.append(_run(P, "cpu", {k: v * 0.1 for k, v in BASE.items()},
                     comparable=False, platform="cpu-fallback"))
    report = _archive(P, d, runs).gate(candidate="cpu")
    assert report.ok and "non-comparable" in report.reason
    missing = _archive(P, d, []).gate(candidate="nope")
    return _report(report), _report(missing)


def _unstamped_runs_never_gate(P, d):
    runs = [_run(P, f"legacy:{i}", dict(BASE), schema=0) for i in range(3)]
    report = _archive(P, d, runs).gate()
    assert report.candidate is None and report.ok
    return _report(report)


def _legacy_runs_never_judge_a_stamped_candidate(P, d):
    runs = [_run(P, f"legacy:{i}", dict(BASE), schema=0) for i in range(4)]
    # the candidate is 2x the legacy values: a fresh measurement
    # definition, not a regression; with no stamped baseline it gates
    # nothing
    runs.append(_run(P, "fresh", {k: v * 2 for k, v in BASE.items()}))
    (d / "a").mkdir()
    report = _archive(P, d / "a", runs).gate()
    assert report.candidate == "fresh"
    assert report.ok, report.summary()
    assert all(v.status == "insufficient-baseline" for v in report.verdicts)
    # once a stamped history exists, it judges
    runs.append(_run(P, "fresh2", {k: v * 2 for k, v in BASE.items()}))
    runs.append(_run(P, "fresh3", {k: v * 2 for k, v in BASE.items()}))
    runs.append(_run(P, "bad", {k: v * 2 * (1.5 if k.endswith("_ms") else 1)
                                for k, v in BASE.items()}))
    (d / "b").mkdir()
    later = _archive(P, d / "b", runs[4:]).gate()
    assert not later.ok
    assert {v.metric for v in later.regressions} >= {"headline_ms"}
    return _report(report), _report(later)


def _insufficient_baseline_informs_not_fails(P, d):
    report = _archive(P, d, [_run(P, "only", dict(BASE))]).gate()
    assert report.ok
    assert all(v.status == "insufficient-baseline" for v in report.verdicts)
    return _report(report)


def _awaiting_baseline_rendered_explicitly(P, d):
    runs = [_run(P, f"r{i}", dict(BASE)) for i in range(3)]
    runs.append(_run(P, "cand", dict(BASE, c16_full_reconcile_p50_ms=12.5)))
    report = _archive(P, d, runs).gate()
    assert report.ok
    text = report.summary()
    assert "awaiting first comparable run" in text
    assert "c16_full_reconcile_p50_ms" in text
    assert "value=12.5" in text
    # gated metrics never land in the awaiting section
    assert "headline_ms" not in text.split(
        "awaiting first comparable run", 1)[1]
    return _report(report)


def _all_gated_summary_has_no_awaiting_section(P, d):
    report = _archive(P, d, [_run(P, f"r{i}", dict(BASE))
                             for i in range(4)]).gate()
    assert report.ok
    assert "awaiting first comparable run" not in report.summary()
    return _report(report)


def _noise_within_mad_floor_passes(P, d):
    """A dead-stable baseline (MAD 0) still tolerates timer noise."""
    runs = [_run(P, f"r{i}", dict(BASE)) for i in range(4)]
    runs.append(_run(P, "wiggle", {k: v * 1.05 for k, v in BASE.items()}))
    report = _archive(P, d, runs).gate()
    assert report.ok, report.summary()
    return _report(report)


# --- TestArchive ----------------------------------------------------------

def _append_load_roundtrip(P, d):
    (rec,) = _archive(P, d, [_run(P, "a", BASE)]).load()
    assert rec.run_id == "a" and rec.stamped
    assert rec.metrics["c5_100k_full_ms"] == 100.0
    assert rec.provenance["platform"] == "accelerator"
    with open(d / "perf_archive.jsonl", encoding="utf-8") as f:
        line = f.read()
    return rec.to_dict(), line


def _truncated_tail_tolerated(P, d):
    arch = _archive(P, d, [_run(P, "a", BASE)])
    with open(arch.path, "a") as f:
        f.write('{"run_id": "torn", "metr')  # died mid-append
    assert [r.run_id for r in arch.load()] == ["a"]
    return [r.to_dict() for r in arch.load()]


def _ledger_supersedes_bootstrap(P, d):
    wrapper = {"parsed": {"value": 50.0, "detail": {"c5_100k_full_ms": 50.0}}}
    with open(d / "BENCH_r01.json", "w") as f:
        json.dump(wrapper, f)
    with open(d / "MULTICHIP_r01.json", "w") as f:
        json.dump({"rc": 0, "tail": "ok"}, f)
    arch = P.pa.PerfArchive(str(d / "perf_archive.jsonl"), root=str(d))
    rec, mesh = arch.load()
    assert rec.run_id == "legacy:BENCH_r01.json" and not rec.stamped
    assert mesh.family == "mesh" and mesh.comparable and not mesh.metrics
    first = [r.to_dict() for r in arch.load()]
    arch.append(_run(P, "legacy:BENCH_r01.json", {"c5_100k_full_ms": 60.0}))
    rec, _ = arch.load()
    assert rec.metrics["c5_100k_full_ms"] == 60.0 and rec.stamped
    return first, [r.to_dict() for r in arch.load()]


def _trajectory_rendering(P, d):
    runs = [_run(P, "r0", BASE),
            _run(P, "cpu", {k: v * 0.1 for k, v in BASE.items()},
                 comparable=False)]
    arch = _archive(P, d, runs)
    text = arch.trajectory(arch.load())
    assert "r0" in text and "cpu" in text
    assert "NO" in text  # the non-comparable flag is visible
    return text, arch.trajectory(arch.load(), family="mesh"), \
        arch.trajectory(arch.load(), keys=["pods_per_sec", "absent_ms"])


def _mesh_family_isolated(P, d):
    """Mesh runs never leak into bench baselines (and vice versa)."""
    runs = [_run(P, f"b{i}", BASE) for i in range(3)]
    runs.append(_run(P, "m0", {"solve_100k_8dev_ms": 1.0}, family="mesh",
                     platform="cpu-mesh"))
    arch = _archive(P, d, runs)
    base = arch.baselines(arch.load(), family="bench")
    assert "solve_100k_8dev_ms" not in base
    report = arch.gate(family="mesh")
    assert report.candidate == "m0"
    return base, _report(report)


def _bench_result_ingest_stamped(P, d):
    """What bench.py appends: a stamped result round-trips with
    run_id/seed/provenance intact (one stamp, fed to both packages)."""
    prov = {"backend": "tpu", "platform": "accelerator", "comparable": True}
    stamp = {"schema_version": 1, "run_id": "0123456789ab", "seed": 0,
             "provenance": prov, "comparable": True}
    result = {"metric": "x", "value": 95.0, "unit": "ms",
              "vs_baseline": 2.0, **stamp,
              "detail": {"c5_100k_full_ms": 95.0, "platform": "accelerator",
                         "flag": True}}
    rec = P.pa.PerfArchive(str(d / "unused.jsonl")).ingest_bench_result(
        result)
    assert rec.stamped and rec.comparable
    assert rec.run_id == stamp["run_id"] and rec.seed == 0
    assert rec.metrics["headline_ms"] == 95.0
    assert rec.metrics["vs_baseline"] == 2.0
    unstamped = P.pa.PerfArchive(str(d / "u.jsonl")).ingest_bench_result(
        {"value": 10.0, "detail": {"platform": "cpu-fallback"}},
        family="mesh", source="bench_mesh.py")
    assert unstamped.comparable is False and not unstamped.stamped
    return rec.to_dict(), unstamped.to_dict()


GATE_CASES = [
    _redundant_frac_never_gates, _overhead_regression_gates,
    _identical_rerun_passes, _synthetic_1p5x_latency_regression_flagged,
    _throughput_collapse_flagged, _cpu_fallback_excluded_from_baselines,
    _cpu_fallback_never_candidate,
    _explicit_noncomparable_candidate_not_gated, _unstamped_runs_never_gate,
    _legacy_runs_never_judge_a_stamped_candidate,
    _insufficient_baseline_informs_not_fails,
    _awaiting_baseline_rendered_explicitly,
    _all_gated_summary_has_no_awaiting_section,
    _noise_within_mad_floor_passes, _append_load_roundtrip,
    _truncated_tail_tolerated, _ledger_supersedes_bootstrap,
    _trajectory_rendering, _mesh_family_isolated,
    _bench_result_ingest_stamped]


@pytest.mark.parametrize("case", GATE_CASES,
                         ids=lambda c: c.__name__.lstrip("_"))
def test_gate_equals_the_reference(case, tmp_path):
    _both(case, tmp_path)


def test_bootstrap_from_repo_legacy_wrappers():
    """The checked-in BENCH_r01..r05 and MULTICHIP_r01..r05 load equal in
    both packages: r01-r04 comparable (the pre-provenance TPU era), r05
    excluded (its cpu-fallback marker), its 10 ms headline never touching
    the TPU-era median."""
    loaded = []
    for pa in (ref_pa, port_pa):
        arch = pa.PerfArchive(os.path.join(REPO, "no_such_archive.jsonl"),
                              root=REPO)
        runs = arch.load()
        bench = [r for r in runs if r.family == "bench"
                 and r.run_id.startswith("legacy:")]
        assert len(bench) >= 5
        by_id = {r.run_id: r for r in bench}
        assert by_id["legacy:BENCH_r05.json"].comparable is False
        for i in (1, 2, 3, 4):
            assert by_id[f"legacy:BENCH_r0{i}.json"].comparable is True
        base = arch.baselines(bench)
        assert base["c5_100k_full_ms"]["median"] > 90
        loaded.append(([r.to_dict() for r in runs], base,
                       arch.trajectory(runs), arch.trajectory(runs, "mesh")))
    assert loaded[1] == loaded[0]


def test_default_resolves_the_repo_root_and_the_env(monkeypatch, tmp_path):
    for pa in (ref_pa, port_pa):
        arch = pa.PerfArchive.default()
        assert arch.root == REPO
        assert arch.path == os.path.join(REPO, pa.ARCHIVE_NAME)
    monkeypatch.setenv(port_pa.ARCHIVE_ENV, str(tmp_path / "x.jsonl"))
    for pa in (ref_pa, port_pa):
        arch = pa.PerfArchive.default()
        assert arch.root == REPO and arch.path == str(tmp_path / "x.jsonl")
        assert pa.PerfArchive().path == str(tmp_path / "x.jsonl")


# --- the port's families --------------------------------------------------

def _stamped(prov, metrics, family="torch"):
    stamp = port_pa.run_stamp(prov)
    result = {**stamp, "detail": dict(metrics)}
    return port_pa.PerfArchive("unused.jsonl").ingest_bench_result(
        result, family=family, source="test")


CARD = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1, "host_count": 1, "cpu_fallback": False}
HOST = {"backend": "cpu", "device_kind": "cpu", "device_count": 1,
        "host_count": 1, "cpu_fallback": True}


def test_run_stamp_is_comparable_only_on_a_card():
    card, host = port_pa.run_stamp(CARD, seed=3), port_pa.run_stamp(HOST)
    assert card["comparable"] is True and host["comparable"] is False
    assert card["seed"] == 3 and host["seed"] == 0
    assert card["schema_version"] == port_pa.SCHEMA_VERSION
    assert card["run_id"] != host["run_id"] and len(card["run_id"]) == 12
    assert port_pa.run_stamp({})["comparable"] is False


@pytest.mark.parametrize("family", ["torch", "torch-mesh"])
def test_port_family_never_baselined_against_tpu_history(tmp_path, family):
    """The repo's legacy TPU wrappers bootstrap as bench/mesh; stamped TPU
    runs sit in the ledger beside three port runs. The port's candidate is
    judged against its own family only: no legacy, bench or mesh run in
    its baseline, and a 1.5x latency key fails on exactly that key."""
    arch = port_pa.PerfArchive(str(tmp_path / "a.jsonl"), root=REPO)
    m = {"solve_wall_ms": 30.0, "screen_wall_ms": 12.0,
         "kernel_device_ms": 0.4}
    for i in range(3):
        arch.append(_run(PORT, f"tpu{i}", {k: v * 10 for k, v in m.items()},
                         family="bench"))
        arch.append(_run(PORT, f"tpumesh{i}", m, family="mesh"))
        arch.append(_stamped(CARD, m, family))
    runs = arch.load()
    assert any(r.run_id.startswith("legacy:") for r in runs)
    ok = arch.gate(runs, family=family)
    assert ok.ok and ok.candidate == runs[-1].run_id, ok.summary()
    port_ids = {r.run_id for r in runs if r.family == family}
    assert all(v.n == 2 for v in ok.verdicts)  # the other two port runs
    base = arch.baselines(runs, family=family, stamped_only=True)
    assert base["solve_wall_ms"]["median"] == 30.0
    assert not any(k.startswith("headline") for k in base)
    arch.append(_stamped(CARD, dict(m, solve_wall_ms=45.0), family))
    bad = arch.gate(family=family)
    assert {v.metric for v in bad.regressions} == {"solve_wall_ms"}
    assert bad.candidate not in port_ids
    # the TPU families' gates never see the port's runs
    for fam in ("bench", "mesh"):
        tpu = arch.gate(family=fam)
        assert tpu.candidate.startswith("tpu")


def test_cpu_run_of_the_port_never_judges_nor_is_judged(tmp_path):
    arch = port_pa.PerfArchive(str(tmp_path / "a.jsonl"), root=str(tmp_path))
    m = {"solve_wall_ms": 30.0}
    for _ in range(3):
        arch.append(_stamped(CARD, m))
    cpu = arch.append(_stamped(HOST, {"solve_wall_ms": 3.0}))
    report = arch.gate(family="torch")
    assert report.candidate != cpu.run_id and report.ok
    assert arch.baselines(arch.load(), "torch")["solve_wall_ms"]["n"] == 3
    judged = arch.gate(candidate=cpu.run_id)
    assert judged.ok and "non-comparable" in judged.reason
    assert not judged.verdicts


def _cli(*args, env_archive=None):
    env = {k: v for k, v in os.environ.items()
           if k not in (port_pa.ARCHIVE_ENV, "PYTHONPATH")}
    if env_archive is not None:
        env[port_pa.ARCHIVE_ENV] = env_archive
    return subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.obs.perf_gate", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)


def test_repo_gate_passes():
    """The port's gate on the working tree exits 0 in every family, and in
    the TPU families its report equals tools/perf_gate.py's."""
    for fam in ("torch", "torch-mesh", "bench", "mesh"):
        proc = _cli("--json", "--family", fam)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["ok"] is True
        if fam in ("bench", "mesh"):
            ref = subprocess.run(
                [sys.executable, os.path.join(REPO, "tools", "perf_gate.py"),
                 "--json", "--family", fam], capture_output=True, text=True,
                cwd=REPO, timeout=120)
            assert ref.returncode == 0
            assert json.loads(ref.stdout) == doc
    proc = _cli()
    assert proc.returncode == 0
    assert "perf archive: no torch runs" in proc.stdout
    assert "perf-gate: PASS" in proc.stdout


def test_gate_cli_exit_codes(tmp_path):
    """0 on identical runs (and on nothing stamped), 1 when one key
    regressed; --candidate, --root and the archive env are honoured."""
    path = str(tmp_path / "a.jsonl")
    arch = port_pa.PerfArchive(path, root=str(tmp_path))
    m = {"solve_wall_ms": 30.0, "facade_wall_ms": 5000.0}
    recs = [arch.append(_stamped(CARD, m)) for _ in range(3)]
    proc = _cli("--archive", path, "--root", str(tmp_path))
    assert proc.returncode == 0, proc.stdout
    assert "perf-gate: PASS" in proc.stdout
    bad = arch.append(_stamped(CARD, dict(m, facade_wall_ms=7500.0)))
    proc = _cli("--json", env_archive=path)
    assert proc.returncode == 1, proc.stdout
    doc = json.loads(proc.stdout)
    assert doc["candidate"] == bad.run_id and doc["ok"] is False
    assert [v["metric"] for v in doc["verdicts"]
            if v["status"] == "regression"] == ["facade_wall_ms"]
    proc = _cli("--archive", path, "--candidate", recs[-1].run_id)
    assert proc.returncode == 0, proc.stdout
    proc = _cli("--archive", path, "--family", "bench")
    assert proc.returncode == 0 and "no stamped comparable run" in proc.stdout
    proc = _cli("--family", "tpu")
    assert proc.returncode == 2  # argparse: not a family
