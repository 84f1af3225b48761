"""The port's recompute observatory (`karpenter_tpu_torch/obs/recompute.py`)
held against the JAX reference's: every case of the reference's
`tests/test_recompute.py` runs through both packages.

Fingerprints are the reference's bit for bit (memo keys and the parity
tests' counts depend on them): each is compared as an integer, on the
reference's inputs and on seeded random matrices. Classification
outcomes, unit counters, snapshots without wall time, and the metric
families' deltas must be equal, exactly. The attribution cases time real
spans (sleeps), so their milliseconds are held to the reference's
properties on each package, not to each other.
"""

from __future__ import annotations

import json
import time
import types
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_tpu import metrics as ref_metrics
from karpenter_tpu.models.pod import Pod
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.obs import exposition as ref_expo
from karpenter_tpu.obs import recompute as ref_recompute
from karpenter_tpu.obs import tracer as ref_tracer

from karpenter_tpu_torch import metrics as port_metrics
from karpenter_tpu_torch.convert import port_object
from karpenter_tpu_torch.obs import exposition as port_expo
from karpenter_tpu_torch.obs import recompute as port_recompute
from karpenter_tpu_torch.obs import tracer as port_tracer

REF = SimpleNamespace(R=ref_recompute, T=ref_tracer, M=ref_metrics,
                      E=ref_expo, name="ref")
PORT = SimpleNamespace(R=port_recompute, T=port_tracer, M=port_metrics,
                       E=port_expo, name="port")
EMPTY_FP = 0x9E3779B97F4A7C15


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    """Both singletons start and end empty, and each package's
    flight-recorder ring is a fresh one for the test (gap markers land
    there)."""
    saved = [(P.T.TRACER, P.T.TRACER.recorder, P.T.TRACER.enabled)
             for P in (REF, PORT)]
    for P in (REF, PORT):
        P.R.RECOMPUTE.reset()
        P.T.TRACER.recorder = P.T.FlightRecorder(8)
    yield
    for tracer, ring, enabled in saved:
        tracer.recorder = ring
        tracer.configure(enabled=enabled)
    for P in (REF, PORT):
        P.R.RECOMPUTE.reset()


def _both(case):
    want = case(REF)
    got = case(PORT)
    assert got == want
    return got


# --- fingerprints -----------------------------------------------------------


def _deterministic(P):
    f = P.R
    out = [f.fingerprint("a", 1), f.fingerprint("a", 2), f.fingerprint("a1"),
           f.fingerprint_bytes(b"x"), f.fingerprint_bytes(b"")]
    assert out[0] == f.fingerprint("a", 1) and len(set(out[:3])) == 3
    assert 0 <= out[3] < 2**64 and out[4] == EMPTY_FP
    return out


def _per_row(P):
    m = np.asarray([[1.0, 2.0], [3.0, 4.0], [1.0, 2.0]], dtype=np.float32)
    fps = P.R.fingerprint_rows(m)
    assert fps.shape == (3,) and int(fps[0]) == int(fps[2]) != int(fps[1])
    combined = P.R.fingerprint_rows(m, np.zeros(3, dtype=np.float32))
    assert combined.shape == (3,) and int(combined[0]) != int(fps[0])
    return [fps.tolist(), combined.tolist()]


def _fold(P):
    f = P.R.fingerprint_fold
    out = [f([1, 2, 3]), f([3, 2, 1]), f([])]
    assert out[0] != out[1] and out[2] == EMPTY_FP
    return out


def _enc(seed=0.0):
    return types.SimpleNamespace(
        G=2,
        requests=np.asarray([[1.0 + seed, 2.0], [3.0, 4.0]],
                            dtype=np.float32),
        compat=np.asarray([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32),
        allow_zone=np.ones((2, 3), dtype=np.float32),
        allow_cap=np.ones((2, 2), dtype=np.float32),
        counts=np.asarray([4, 8], dtype=np.int32))


def _encoded(P):
    f = P.R.encoded_fingerprint
    changed = _enc()
    changed.counts = np.asarray([4, 9], dtype=np.int32)
    out = [f(_enc()), f(_enc(seed=0.5)), f(changed),
           f(types.SimpleNamespace(G=0))]
    assert len(set(out[:3])) == 3 and out[3] == EMPTY_FP
    return out


def _seeded_matrices(P):
    """Random matrices of every dtype the planes digest: bit-equal."""
    rng = np.random.default_rng(11)
    mats = [rng.random((17, 9), np.float32),
            rng.integers(-5, 5, (6, 13)).astype(np.int32),
            rng.random((8, 31)) > 0.5,
            rng.random((5, 3, 7), np.float32),
            rng.random((4, 1), np.float32)]
    out = [P.R.fingerprint_rows(m.reshape(m.shape[0], -1)).tolist()
           for m in mats]
    out.append(P.R.fingerprint_rows(mats[0], mats[0][:, :3]).tolist())
    out.append(P.R.fingerprint_fold(np.asarray(out[0], np.uint64)))
    out.append(P.R.fingerprint_bytes(mats[2].tobytes()))
    return out


@pytest.mark.parametrize("case", [_deterministic, _per_row, _fold, _encoded,
                                  _seeded_matrices],
                         ids=lambda c: c.__name__[1:])
def test_fingerprints_equal_the_reference(case):
    _both(case)


# --- the classification taxonomy --------------------------------------------

STAGE_CASES = [
    ("encode", 11), ("conflict", 22), ("affinity", 33), ("spread", 44),
    ("solve", 55), ("optimizer", 66), ("disrupt", 77),
]
OUTCOME_CASES = ["fresh", "redundant", "delta_served"]


def test_tables_cover_taxonomy_exactly():
    for P in (REF, PORT):
        assert [s for s, _ in STAGE_CASES] == list(P.R.STAGES)
        assert OUTCOME_CASES == list(P.R.OUTCOMES)
    assert port_recompute.STAGE_OF == ref_recompute.STAGE_OF


def _all_outcomes(P):
    led = P.R.RecomputeLedger()
    out = []
    for stage, fp in STAGE_CASES:
        out += [led.classify(stage, fp), led.classify(stage, fp),
                led.classify(stage, served=True)]
    units = led.stage_units()
    for stage, _fp in STAGE_CASES:
        assert units[stage] == {"fresh": 1, "redundant": 1,
                                "delta_served": 1}
        assert led.redundant_frac(stage) == pytest.approx(1 / 3)
    return out + [units]


def _rows_batch(P):
    led = P.R.RecomputeLedger()
    got = led.classify_rows("encode", np.asarray([1, 2, 3, 1, 2],
                                                 dtype=np.uint64))
    assert got == (3, 2)
    return [got, led.stage_units()]


def _zero_units(P):
    led = P.R.RecomputeLedger()
    led.classify("solve", 1, units=0)
    led.classify("solve", served=True, units=-3)
    assert led.stage_units() == {}
    return [led.snapshot()]


def _seen_lru(P):
    led = P.R.RecomputeLedger(seen_cap=4)
    out = [led.classify("encode", fp) for fp in range(1, 9)]
    out += [led.classify("encode", 8), led.classify("encode", 1)]
    assert out[-2:] == ["redundant", "fresh"]
    assert led.snapshot()["seen_cap"] == 4
    return out


def _tenants(P):
    led = P.R.RecomputeLedger()
    out = [led.classify("solve", 9, tenant="a"),
           led.classify("solve", 9, tenant="b"),
           led.classify("solve", 9, tenant="a")]
    assert out == ["fresh", "fresh", "redundant"]
    assert {"a", "b"} <= set(led.snapshot()["tenants"])
    return out + [led.snapshot()["tenants"]]


def _repeat(P):
    def drive(led):
        for stage, fp in STAGE_CASES:
            led.classify(stage, P.R.fingerprint(stage, fp))
            led.classify(stage, P.R.fingerprint(stage, fp))
            led.classify(stage, served=True, units=2)
        led.classify_rows("encode",
                          P.R.fingerprint_rows(np.eye(3, dtype=np.float32)))
        return led.snapshot()
    snap = drive(P.R.RecomputeLedger())
    assert snap == drive(P.R.RecomputeLedger())
    return snap


def _metrics(P):
    led = P.R.RecomputeLedger()
    work = P.M.RECOMPUTE_WORK
    base = work.value(stage="spread", outcome="fresh", tenant="metric-probe")
    red0 = work.value(stage="spread", outcome="redundant",
                      tenant="metric-probe")
    led.classify("spread", 5, tenant="metric-probe")
    led.classify("spread", 5, tenant="metric-probe")
    out = [work.value(stage="spread", outcome="fresh",
                      tenant="metric-probe") - base,
           work.value(stage="spread", outcome="redundant",
                      tenant="metric-probe") - red0,
           P.M.REDUNDANT_WORK_FRAC.value(stage="spread")]
    assert out == [1, 1, 0.5]
    return out


@pytest.mark.parametrize("case", [_all_outcomes, _rows_batch, _zero_units,
                                  _seen_lru, _tenants, _repeat, _metrics],
                         ids=lambda c: c.__name__[1:])
def test_classification_equals_the_reference(case):
    _both(case)


# --- attribution (tracer sink) ----------------------------------------------


def _armed(P):
    P.T.TRACER.configure(enabled=True)
    return P.R.RECOMPUTE, P.T.TRACER


def _units_only(snap):
    return {st: row["units"] for st, row in snap["stages"].items()}


def _proportional(P):
    led, tr = _armed(P)
    with tr.trace("engine.tick"):
        with tr.span("encode.lower", cache_hits=0, cache_misses=1):
            time.sleep(0.01)
            led.classify("encode", P.R.fingerprint("g1"))
            led.classify("encode", P.R.fingerprint("g1"))
        with tr.span("solve.run", backend="host"):
            time.sleep(0.005)
            led.classify("solve", P.R.fingerprint("batch"))
    snap = led.snapshot()
    enc = snap["stages"]["encode"]
    assert enc["wall_ms"] >= 10.0 and enc["unattributed_ms"] == 0.0
    assert enc["ms"]["fresh"] == pytest.approx(enc["ms"]["redundant"])
    assert snap["stages"]["solve"]["ms"]["fresh"] >= 5.0
    assert snap["coverage"] >= P.R.COVERAGE_TARGET
    assert not [t for t in tr.recorder.slowest()
                if t.root.name == "recompute.unattributed"]
    return [_units_only(snap), snap["coverage"], led.traces]


def _bytes(P):
    led, tr = _armed(P)
    with tr.trace("engine.tick"):
        with tr.span("solve.device_put", h2d_bytes=512):
            led.classify("solve", P.R.fingerprint("up"))
        with tr.span("solve.readback", d2h_bytes=128):
            pass
    b = led.snapshot()["stages"]["solve"]["bytes"]
    assert b["fresh"] == 512 + 128 and b["redundant"] == 0
    return [b]


def _gap(P):
    led, tr = _armed(P)
    with tr.trace("engine.tick"):
        with tr.span("encode.lower", cache_hits=0, cache_misses=1):
            time.sleep(0.02)
    assert led.coverage() < P.R.COVERAGE_TARGET
    assert led.unattributed_ms() >= 15.0
    markers = [t for t in tr.recorder.slowest()
               if t.root.name == "recompute.unattributed"]
    assert markers
    attrs = markers[0].root.attrs
    assert attrs["coverage"] < P.R.COVERAGE_TARGET
    assert attrs["gap_ms"] >= 15.0
    assert attrs["source_trace"] and "encode" in attrs["stages"]
    return [len(markers), sorted(attrs["stages"])]


def _glue(P):
    led, tr = _armed(P)
    with tr.trace("engine.tick"):
        with tr.span("provision.launch"):
            time.sleep(0.01)
    assert led.coverage() == 1.0 and led.snapshot()["stages"] == {}
    return [led.traces]


def _inherits(P):
    led, tr = _armed(P)
    with tr.trace("engine.tick"):
        with tr.span("optimizer.search", candidates=2):
            led.classify("optimizer", P.R.fingerprint("subset"))
            with tr.span("totally.unmapped.child"):
                time.sleep(0.005)
    st = led.snapshot()["stages"]["optimizer"]
    assert st["wall_ms"] >= 5.0 and st["unattributed_ms"] == 0.0
    return [st["units"]]


def _conflict(P):
    led, tr = _armed(P)
    with tr.trace("engine.tick"):
        with tr.span("encode.conflicts", groups=3):
            led.classify("conflict", P.R.fingerprint("key"))
    st = led.snapshot()["stages"]["conflict"]
    assert st["wall_ms"] > 0 and st["unattributed_ms"] == 0.0
    return [st["units"]]


def _disruption_split(P):
    led, tr = _armed(P)
    with tr.trace("reconcile:disruption"):
        with tr.span("disruption.screen"):
            led.classify("optimizer", served=True)
        with tr.span("disruption.candidates"):
            led.classify("disrupt", P.R.fingerprint("pool"))
    snap = led.snapshot()
    assert snap["stages"]["optimizer"]["units"]["delta_served"] == 1
    assert snap["stages"]["disrupt"]["units"]["fresh"] == 1
    assert snap["stages"]["optimizer"]["wall_ms"] > 0
    assert snap["stages"]["disrupt"]["wall_ms"] > 0
    return [_units_only(snap)]


def _adhoc(P):
    led, tr = _armed(P)
    with tr.trace("my-adhoc-trace"):
        with tr.span("encode.lower", cache_hits=0, cache_misses=1):
            led.classify("encode", P.R.fingerprint("x"))
            time.sleep(0.002)
    assert led.traces == 0 and led.coverage() == 1.0
    assert led._pending == {}
    return [led.stage_units()]


def _reset(P):
    led, tr = _armed(P)
    with tr.trace("engine.tick"):
        with tr.span("solve.run", backend="host"):
            led.classify("solve", P.R.fingerprint("r"))
    led.reset()
    snap = led.snapshot()
    assert snap["stages"] == {} and snap["traces"] == 0
    assert led.coverage() == 1.0 and led.unattributed_ms() == 0.0
    return [snap]


@pytest.mark.parametrize("case", [_proportional, _bytes, _gap, _glue,
                                  _inherits, _conflict, _disruption_split,
                                  _adhoc, _reset],
                         ids=lambda c: c.__name__[1:])
def test_attribution_equals_the_reference(case):
    _both(case)


# --- read side ----------------------------------------------------------------


def _route(P):
    led = P.R.RECOMPUTE
    led.classify("affinity", P.R.fingerprint("zone"), tenant="route-probe")
    status, ctype, body = P.E.render("/debug/recompute")
    assert status == 200 and "json" in ctype
    doc = json.loads(body)
    assert doc["taxonomy"] == list(P.R.STAGES)
    assert doc["outcomes"] == list(P.R.OUTCOMES)
    assert "route-probe" in doc["tenants"]
    return doc


def _report(P):
    led = P.R.RecomputeLedger()
    led.classify("encode", 1)
    led.classify("encode", 1)
    led.classify("solve", served=True)
    txt = led.report()
    assert "recompute observatory" in txt
    assert "encode" in txt and "coverage" in txt
    assert "(no work observed)" in txt
    assert P.R.format_report({}).startswith(
        "recompute report: no work classified yet")
    return txt


def _defensive(P):
    led = P.R.RecomputeLedger()
    led.classify("disrupt", 3)
    led.ingest(object())
    assert led.errors == 1 and "WARNING" in led.report()
    return led.report()


@pytest.mark.parametrize("case", [_route, _report, _defensive],
                         ids=lambda c: c.__name__[1:])
def test_read_side_equals_the_reference(case):
    _both(case)


# --- end to end ---------------------------------------------------------------


def test_real_reconcile_classifies_encode_and_solve():
    """A plain sim reconcile moves each singleton's encode and solve
    stages with no test-side classification — the same units in both
    packages, on the host rung (the port's screen on the CPU)."""
    from karpenter_tpu.sim import make_sim as ref_make_sim
    from karpenter_tpu_torch.sim import make_sim as port_make_sim
    got = {}
    for P, make in ((REF, lambda: ref_make_sim(backend="host")),
                    (PORT, lambda: port_make_sim(backend="host",
                                                 device="cpu"))):
        P.R.RECOMPUTE.reset()
        sim = make()
        for i in range(12):
            p = Pod(name=f"rc-{i}", requests=Resources.parse(
                {"cpu": "500m", "memory": "1Gi"}))
            sim.store.add_pod(p if P is REF else port_object(p))
        assert sim.engine.run_until(
            lambda: all(p.node_name for p in sim.store.pods.values()),
            timeout=60)
        units = P.R.RECOMPUTE.stage_units()
        assert sum(units["encode"].values()) > 0
        assert sum(units["solve"].values()) > 0
        got[P.name] = units
        P.R.RECOMPUTE.reset()
    assert got["port"] == got["ref"]
