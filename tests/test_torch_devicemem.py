"""The port's device telemetry plane (`karpenter_tpu_torch/obs/devicemem.py`)
held against the JAX reference's: the cases of the reference's
`tests/test_devicemem.py` run through both packages.

The residency ledger tracks torch tensors where the reference tracks
jax arrays (each case builds the same-sized buffers in each package);
the transfer ledger and the upload meter see the same numpy bytes. What
each case observes — live bytes per kind, watermarks, orphans, audit
coverage, transfer rows per reason, redundancy fractions, eviction
meters — must be equal, exactly. The solver cases run the reference's
`solve_device` on JAX-CPU and the port's with `device="cpu"` on the same
encoded input and compare the bytes each moved per reason.

The reference's `TestDeviceReport` case drives its `tools/device_report.py`;
here the same arguments drive it and the port's counterpart,
`karpenter_tpu_torch/obs/device_report.py` with `--device cpu`: the same
JSON keys, and equal transfer counts and bytes, upload-redundancy fraction
and resident breakdown.
"""

from __future__ import annotations

import gc
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.catalog import CatalogProvider as RefProvider
from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.catalog.generator import small_catalog
from karpenter_tpu.fleet.service import SolverService as RefService
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.nodepool import NodePool
from karpenter_tpu.models.pod import Pod
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.obs import devicemem as ref_dm
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.encode import encode_catalog, encode_pods
from karpenter_tpu.utils.clock import FakeClock as RefClock

from karpenter_tpu_torch.catalog import CatalogProvider as PortProvider
from karpenter_tpu_torch.convert import port_object
from karpenter_tpu_torch.fleet.service import SolverService as PortService
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.obs import devicemem as port_dm
from karpenter_tpu_torch.ops import encode as port_encode
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.utils.clock import FakeClock as PortClock

POOL = NodePool(name="default")


def _ref_zeros(n, fill=0.0):
    return jnp.full(n, fill, jnp.float32)


def _port_zeros(n, fill=0.0):
    return torch.full((n,), fill, dtype=torch.float32)


REF = SimpleNamespace(
    name="ref", dm=ref_dm, S=ref_solver, zeros=_ref_zeros,
    encode_catalog=encode_catalog, encode_pods=encode_pods,
    conv=lambda x: x, kw={}, Service=RefService, Clock=RefClock,
    Provider=RefProvider, pkg="karpenter_tpu")
PORT = SimpleNamespace(
    name="port", dm=port_dm, S=port_solver, zeros=_port_zeros,
    encode_catalog=port_encode.encode_catalog,
    encode_pods=port_encode.encode_pods, conv=port_object,
    kw={"device": "cpu"}, Service=PortService, Clock=PortClock,
    Provider=PortProvider, pkg="karpenter_tpu_torch")


def _mod(P, name):
    import importlib
    return importlib.import_module(f"{P.pkg}.{name}")


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """Both resource axes get the same columns; afterwards the reference's
    intern table and planes are reset (ROADMAP §3's test-order hazard)."""
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    ref_pod._sig_intern.clear()
    for P in (REF, PORT):
        _mod(P, "ops.delta").DELTA.reset()
        _mod(P, "ops.resident").RESIDENT.reset()
        _mod(P, "integrity").INTEGRITY.reset()


@pytest.fixture(autouse=True)
def _fresh_planes():
    for P in (REF, PORT):
        _mod(P, "ops.delta").DELTA.reset()
        _mod(P, "ops.resident").RESIDENT.reset()
        _mod(P, "integrity").INTEGRITY.reset()
    # both packages' monotone unions of requested resource columns hold
    # the same columns: they set the request matrices' widths
    cols = REF.S._cols_union | PORT.S._cols_union
    REF.S._cols_union.update(cols)
    PORT.S._cols_union.update(cols)
    yield


def mk_pods(n, prefix="p", cpu="500m", mem="1Gi"):
    return [Pod(name=f"{prefix}-{i}",
                requests=Resources.parse({"cpu": cpu, "memory": mem}))
            for i in range(n)]


def _both(case):
    want = case(REF)
    got = case(PORT)
    assert got == want
    return got


class _Owner:
    pass


# --- the residency ledger ---------------------------------------------------


def _track_release(P):
    led = P.dm.ResidencyLedger()
    arr = P.zeros(1024)
    led.track("solve_upload", [arr])
    out = [led.live_bytes, led.kind_bytes["solve_upload"],
           led.watermark_bytes]
    assert out == [4096, 4096, 4096]
    del arr
    gc.collect()
    led._drain()
    out += [led.live_bytes, led.kind_bytes["solve_upload"],
            led.watermark_bytes]
    assert out[3:] == [0, 0, 4096]
    return out + [led.snapshot()]


def _no_double_count(P):
    led = P.dm.ResidencyLedger()
    arr = P.zeros(16)
    led.track("solve_upload", [arr])
    led.track("batch_gbuf", [arr])
    assert led.live_bytes == 64
    return [led.live_bytes, led.snapshot()["kinds"]]


def _orphans(P):
    led = P.dm.ResidencyLedger()
    owner = _Owner()
    arr = P.zeros(32)
    gid = led.track("catalog", [arr], owner=owner, token=("t", "x"))
    out = [led.orphans()]
    del owner
    orphans = led.orphans()
    assert out[0] == [] and len(orphans) == 1
    assert orphans[0]["group"] == gid and orphans[0]["kind"] == "catalog"
    assert orphans[0]["bytes"] == 128 and orphans[0]["token"] == "t/x"
    out.append(orphans)
    del arr
    gc.collect()
    out.append(led.orphans())
    assert out[-1] == []
    return out


def _audit(P):
    led = P.dm.ResidencyLedger()
    tracked, foreign = P.zeros(64), P.zeros(64, 1.0)
    led.track("packed_result", [tracked])
    a = led.audit(live_arrays=[tracked, foreign])
    assert (a["accounted_bytes"], a["unaccounted_bytes"],
            a["coverage"]) == (256, 256, 0.5)
    b = led.audit(live_arrays=[tracked])
    assert b["coverage"] == 1.0
    return [a, b, led.snapshot()["stats"]]


def _audit_gap(P):
    tracer = _mod(P, "obs.tracer")
    saved = tracer.TRACER.recorder
    try:
        tracer.TRACER.recorder = tracer.FlightRecorder(8)
        led = P.dm.ResidencyLedger()
        led.audit(live_arrays=[P.zeros(1024)])
        names = [t.root.name for t in tracer.TRACER.recorder.slowest()]
        assert "devicemem.unattributed" in names
        return names
    finally:
        tracer.TRACER.recorder = saved


def _mesh_kind(P):
    led = P.dm.ResidencyLedger()
    arr = P.zeros(8)
    led.track("mesh_shard", [arr])
    assert led.kind_bytes["mesh_shard"] == 32
    return [led.kind_bytes]


@pytest.mark.parametrize("case", [_track_release, _no_double_count,
                                  _orphans, _audit, _audit_gap, _mesh_kind],
                         ids=lambda c: c.__name__[1:])
def test_residency_ledger_equals_the_reference(case):
    _both(case)


def test_owner_kinds_frozen():
    assert port_dm.OWNER_KINDS == ref_dm.OWNER_KINDS == (
        "catalog", "solve_upload", "batch_gbuf", "packed_result",
        "mesh_shard", "resident_state")
    assert port_dm.TRANSFER_REASONS == ref_dm.TRANSFER_REASONS == (
        "catalog_put", "request_upload", "batch_upload", "screen_upload",
        "readback", "resident_patch")


def test_audit_counts_each_storage_once():
    """Views share their base's storage: the audit counts its bytes once,
    at the storage's size, and a view of a tracked tensor is accounted."""
    led = port_dm.ResidencyLedger()
    base = torch.zeros(256, dtype=torch.float32)
    led.track("catalog", [base])
    views = [base[:64], base[64:], base.view(16, 16)]
    foreign = torch.ones(32, dtype=torch.float32)
    a = led.audit(live_arrays=[base, *views, foreign, foreign[:8]])
    assert (a["accounted_bytes"], a["unaccounted_bytes"],
            a["live_arrays"]) == (1024, 128, 2)


# --- transfer attribution ---------------------------------------------------


def _rows(P):
    tenant_scope = _mod(P, "metrics.tenant").tenant_scope
    led = P.dm.TransferLedger()
    led.record("request_upload", 100, shape_class="g8/n64")
    with tenant_scope("t7"):
        led.record("readback", 40, shape_class="g8/n64")
    snap = led.snapshot()
    assert snap["h2d_bytes"] == 100 and snap["d2h_bytes"] == 40
    rows = {(r["reason"], r["tenant"], r["shape_class"]):
            (r["bytes"], r["calls"]) for r in snap["rows"]}
    assert rows[("request_upload", "default", "g8/n64")] == (100, 1)
    assert rows[("readback", "t7", "g8/n64")] == (40, 1)
    return snap


def _metric_family(P):
    metric = _mod(P, "metrics").DEVICEMEM_TRANSFER
    before = metric.value(reason="request_upload")
    P.dm.TRANSFERS.record("request_upload", 77)
    assert metric.value(reason="request_upload") == before + 77
    return [metric.value(reason="request_upload") - before]


@pytest.mark.parametrize("case", [_rows, _metric_family],
                         ids=lambda c: c.__name__[1:])
def test_transfer_ledger_equals_the_reference(case):
    _both(case)


def _by_reason(P):
    return {r: sum(x["bytes"] for x in P.dm.TRANSFERS.snapshot()["rows"]
                   if x["reason"] == r) for r in P.dm.TRANSFER_REASONS}


def test_solver_wrappers_thread_through_the_ledger():
    """A real solve attributes catalog_put / request_upload / readback
    rows, transfer_bytes() equals the ledger's totals, the readback row
    carries the padded shape class — and each reason's bytes equal the
    reference's for the same input."""
    got = {}
    types = small_catalog()
    pods = mk_pods(8)
    for P in (REF, PORT):
        cat = P.encode_catalog(P.conv(types))
        enc = P.encode_pods(P.conv(pods), cat)
        r0 = _by_reason(P)
        h0, d0 = P.S.transfer_bytes()
        P.S.solve_device(cat, enc, **P.kw)
        h1, d1 = P.S.transfer_bytes()
        assert h1 > h0 and d1 > d0
        assert (h1, d1) == P.dm.TRANSFERS.totals()
        snap = P.dm.TRANSFERS.snapshot()
        assert {"catalog_put", "request_upload", "readback"} <= {
            r["reason"] for r in snap["rows"]}
        assert any(r["reason"] == "readback"
                   and r["shape_class"].startswith("g")
                   for r in snap["rows"])
        r1 = _by_reason(P)
        got[P.name] = {k: r1[k] - r0[k] for k in r1}
    assert got["port"] == got["ref"]


# --- the upload-redundancy meter ----------------------------------------------


def _identical(P):
    m = P.dm.UploadMeter()
    mat = np.arange(64, dtype=np.float32).reshape(8, 8)
    out = [m.observe(("k",), mat), m.observe(("k",), mat.copy()),
           m.totals()]
    assert out == [0.0, 1.0, (mat.nbytes, 2 * mat.nbytes)]
    return out


def _changed(P):
    m = P.dm.UploadMeter()
    mat = np.zeros((8, 8), np.float32)
    m.observe(("k",), mat)
    mat2 = mat.copy()
    mat2[3] = 9.0
    out = m.observe(("k",), mat2)
    assert out == pytest.approx(7 / 8)
    return [out, m.snapshot()]


def _keys(P):
    m = P.dm.UploadMeter()
    m.observe(("a",), np.zeros((4, 4), np.float32))
    out = [m.observe(("b",), np.ones((4, 4), np.float32)),
           m.observe(("a",), np.zeros((4, 4), np.float32))]
    assert out == [0.0, 1.0]
    return out


def _key_lru(P):
    m = P.dm.UploadMeter()
    mat = np.zeros((2, 2), np.float32)
    for i in range(P.dm._METER_MAX_KEYS + 10):
        m.observe((i,), mat)
    assert m.snapshot()["keys"] == P.dm._METER_MAX_KEYS
    return m.snapshot()


@pytest.mark.parametrize("case", [_identical, _changed, _keys, _key_lru],
                         ids=lambda c: c.__name__[1:])
def test_upload_meter_equals_the_reference(case):
    _both(case)


def test_warm_resolve_meters_redundancy():
    """Re-solving the same encoded problem re-uploads a byte-identical
    request matrix: 100% redundant, the same bytes in both packages."""
    got = {}
    types, pods = small_catalog(), mk_pods(12)
    for P in (REF, PORT):
        cat = P.encode_catalog(P.conv(types))
        enc = P.encode_pods(P.conv(pods), cat)
        P.S.solve_device(cat, enc, **P.kw)
        i0, t0 = P.dm.UPLOADS.totals()
        P.S.solve_device(cat, enc, **P.kw)
        i1, t1 = P.dm.UPLOADS.totals()
        assert t1 > t0 and (i1 - i0) == (t1 - t0)
        got[P.name] = (i1 - i0, t1 - t0)
    assert got["port"] == got["ref"]


# --- the device-catalog cache's evictions --------------------------------------


def _dcat_key(P, cat):
    tok = tuple(cat.cache_token)
    return (tok, None) if P is REF else (tok, "cpu")


def _cache(P):
    return P.S._dcat_auto if P is REF else P.S._dcat_cache


def _auto(P, cat, R):
    return P.S._auto_dcat(cat, R, *(["cpu"] if P is PORT else []))


def _view_evicted(P):
    from importlib import import_module
    SharedCatalogCache = import_module(f"{P.pkg}.ops.facade") \
        .SharedCatalogCache
    metric = _mod(P, "metrics").DCAT_EVICTIONS
    cache = SharedCatalogCache()
    types = P.conv(small_catalog())
    cat = cache.get_or_encode("nc0", types)
    _auto(P, cat, cat.allocatable.shape[1])
    key = _dcat_key(P, cat)
    assert key in _cache(P)
    before = metric.value(reason="view_evicted")
    for i in range(cache.MAX_ENTRIES):
        cache.get_or_encode(f"nc{i + 1}", types)
    assert key not in _cache(P)
    assert metric.value(reason="view_evicted") > before
    return [metric.value(reason="view_evicted") - before]


def _fifo(P):
    metric = _mod(P, "metrics").DCAT_EVICTIONS
    types = P.conv(small_catalog())
    before = metric.value(reason="fifo")
    cats = []
    for i in range(P.S._DCAT_TOKEN_MAX + 4):
        cat = P.encode_catalog(types)
        cat.cache_token = ("shared", f"fifo-test-{i}", "fp")
        cats.append(cat)
        _auto(P, cat, cat.allocatable.shape[1])
    assert metric.value(reason="fifo") >= before + 4
    tkeys = [k for k in _cache(P) if isinstance(k[0], tuple)]
    assert len(tkeys) <= P.S._DCAT_TOKEN_MAX
    return [len(tkeys)]


def _weakref(P):
    metric = _mod(P, "metrics").DCAT_EVICTIONS
    types = P.conv(small_catalog())
    cat = P.encode_catalog(types)
    _auto(P, cat, cat.allocatable.shape[1])
    del cat
    gc.collect()
    assert "weakref" in P.S._dcat_evict_pending or not \
        P.S._dcat_evict_pending
    before = metric.value(reason="weakref")
    cat2 = P.encode_catalog(types)
    _auto(P, cat2, cat2.allocatable.shape[1])
    assert metric.value(reason="weakref") >= before
    return [not P.S._dcat_evict_pending]


def _stale(P):
    metric = _mod(P, "metrics").DCAT_EVICTIONS
    cat = P.encode_catalog(P.conv(small_catalog()))
    cat.cache_token = ("shared", "stale-test", "fp")
    R = cat.allocatable.shape[1]
    _auto(P, cat, R)
    before = metric.value(reason="stale")
    _auto(P, cat, R + 3)
    assert metric.value(reason="stale") == before + 1
    return [metric.value(reason="stale") - before]


@pytest.mark.parametrize("case", [_view_evicted, _fifo, _weakref, _stale],
                         ids=lambda c: c.__name__[1:])
def test_dcat_evictions_equal_the_reference(case):
    _both(case)


# --- the batched pump's transfers (delta memos off: a repeated solve
# would be served at the facade and never reach the pump) --------------------


def _service(P, batch=True):
    svc = P.Service(P.Clock(), backend="device", batch=batch, **P.kw)
    return svc


def _one_upload_per_bucket(P):
    types = P.conv(small_catalog())
    pool = P.conv(POOL)
    svc = _service(P)
    clients = [svc.register(f"t{i}", P.Provider(lambda: types))
               for i in range(4)]
    warm = [c.solve_async(P.conv(mk_pods(6, f"w{i}")), pool)
            for i, c in enumerate(clients)]
    svc.pump()
    for t in warm:
        assert t.result().launches
    u0, r0 = P.S.transfer_stats()
    batches0 = svc.stats["batches"]
    tickets = [c.solve_async(P.conv(mk_pods(6, f"x{i}")), pool)
               for i, c in enumerate(clients)]
    svc.pump()
    for t in tickets:
        assert t.result().launches
    u1, r1 = P.S.transfer_stats()
    buckets = svc.stats["batches"] - batches0
    assert buckets == 1 and u1 - u0 == buckets and r1 - r0 == buckets
    assert all(t.batch_size == 4 for t in tickets)
    return [buckets, u1 - u0, r1 - r0]


def _bytes_on_off(P):
    types = P.conv(small_catalog())
    pool = P.conv(POOL)

    def run(batch):
        svc = _service(P, batch)
        clients = [svc.register(f"t{i}", P.Provider(lambda: types))
                   for i in range(2)]
        warm = [c.solve_async(P.conv(mk_pods(5, f"w{i}")), pool)
                for i, c in enumerate(clients)]
        svc.pump()
        [t.result() for t in warm]
        h0, d0 = P.S.transfer_bytes()
        tickets = [c.solve_async(P.conv(mk_pods(5, f"x{i}")), pool)
                   for i, c in enumerate(clients)]
        svc.pump()
        for t in tickets:
            assert t.result().launches
        h1, d1 = P.S.transfer_bytes()
        return h1 - h0, d1 - d0

    batched, serial = run(True), run(False)
    assert batched == serial
    return [batched, serial]


def _fault_scope(P):
    injector = _mod(P, "faults.injector")
    plan_mod = _mod(P, "faults.plan")
    fallbacks = _mod(P, "metrics").SOLVER_FALLBACKS
    types = P.conv(small_catalog())
    pool = P.conv(POOL)
    svc = _service(P)
    a = svc.register("a", P.Provider(lambda: types))
    b = svc.register("b", P.Provider(lambda: types))
    warm = [a.solve_async(P.conv(mk_pods(4, "wa")), pool),
            b.solve_async(P.conv(mk_pods(4, "wb")), pool)]
    svc.pump()
    [t.result() for t in warm]
    fb0 = fallbacks.sum(from_backend="device", tenant="a")

    def rows_for(tenant, reason):
        return sum(r["bytes"] for r in P.dm.TRANSFERS.snapshot()["rows"]
                   if r["tenant"] == tenant and r["reason"] == reason)

    before = {(t, r): rows_for(t, r) for t in "ab"
              for r in ("request_upload", "readback")}
    plan = plan_mod.FaultPlan(seed=0, rules=[
        plan_mod.DeviceFault(dispatch=1, count=2)])
    plan.clock = svc.clock
    with injector.fleet_device_fault_hook({"a": plan}):
        ta = a.solve_async(P.conv(mk_pods(4, "xa")), pool)
        tb = b.solve_async(P.conv(mk_pods(4, "xb")), pool)
        svc.pump()
        assert ta.result().launches and tb.result().launches
    deltas = {k: rows_for(*k) - v for k, v in sorted(before.items())}
    assert deltas[("a", "request_upload")] > 0
    assert a.facade.stats["device_fallbacks"] == 1
    assert fallbacks.sum(from_backend="device", tenant="a") == fb0 + 1
    assert b.facade.stats["device_fallbacks"] == 0
    assert deltas[("b", "request_upload")] > 0
    assert deltas[("b", "readback")] > 0
    return [deltas, a.facade.stats, b.facade.stats]


@pytest.mark.parametrize("case", [_one_upload_per_bucket, _bytes_on_off,
                                  _fault_scope],
                         ids=lambda c: c.__name__[1:])
def test_batched_pump_transfers_equal_the_reference(case, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    if case is _bytes_on_off:
        monkeypatch.setenv("KARPENTER_TPU_RESIDENT", "0")
    _both(case)


def test_batch_residency_kinds_tracked():
    """A batched dispatch registers its stacked request matrix and its
    pending output (packed_result) in the residency ledger, owned by the
    in-flight batch; the rows decode."""
    got = {}
    types = small_catalog()
    for P in (REF, PORT):
        cat = P.encode_catalog(P.conv(types))
        encs = [P.encode_pods(P.conv(mk_pods(4, f"r{i}")), cat)
                for i in range(2)]
        reqs = [P.S.prepare_batchable(cat, e, **P.kw) for e in encs]
        assert all(r is not None for r in reqs)
        tracked0 = P.dm.DEVICEMEM.stats["tracked"]
        ifb = P.S.dispatch_batch(reqs)
        assert P.dm.DEVICEMEM.stats["tracked"] > tracked0
        with P.dm.DEVICEMEM._lock:
            kinds = {g["kind"] for g in P.dm.DEVICEMEM._groups.values()
                     if g["live"]}
        assert "packed_result" in kinds
        results = ifb.results()
        assert all(r.nodes for r in results)
        got[P.name] = [sorted((n.type_idx, tuple(sorted(
            n.pods_by_group.items()))) for n in r.nodes) for r in results]
    assert got["port"] == got["ref"]


def _resident_plane(P):
    RESIDENT = _mod(P, "ops.resident").RESIDENT
    RESIDENT.reset()

    def patch_bytes():
        return sum(r["bytes"] for r in P.dm.TRANSFERS.snapshot()["rows"]
                   if r["reason"] == "resident_patch")

    try:
        mat = np.arange(32, dtype=np.float32).reshape(8, 4)
        RESIDENT.upload(("dm-kind",), mat, token=("t",), **P.kw)
        with P.dm.DEVICEMEM._lock:
            kinds = {g["kind"] for g in P.dm.DEVICEMEM._groups.values()
                     if g["live"]}
        assert "resident_state" in kinds
        b0 = patch_bytes()
        mat2 = mat.copy()
        mat2[5] += 9.0
        RESIDENT.upload(("dm-kind",), mat2, token=("t",), **P.kw)
        assert patch_bytes() - b0 == 4 * 4 + 4
        return [patch_bytes() - b0]
    finally:
        RESIDENT.reset()


def test_resident_state_kind_and_patch_reason():
    _both(_resident_plane)


def test_debug_device_serves_the_plane():
    for P in (REF, PORT):
        status, ctype, body = _mod(P, "obs.exposition").render(
            "/debug/device")
        assert status == 200 and "json" in ctype
        payload = json.loads(body)
        assert payload["owner_kinds"] == list(P.dm.OWNER_KINDS)
        assert payload["reasons"] == list(P.dm.TRANSFER_REASONS)
        assert "residency" in payload and "transfers" in payload
        assert "uploads" in payload and "orphans" in payload
        assert payload["residency"]["watermark_bytes"] >= 0


def _report_doc(P, argv, capsys, monkeypatch):
    """One run of the package's device report: its JSON line. The report
    prints the transfer ledger's totals since import, so each run gets a
    fresh ledger (restored after the test): what the worker's earlier
    tests moved is not the report's."""
    for Q in (REF, PORT):
        _mod(Q, "ops.delta").DELTA.reset()
        _mod(Q, "ops.resident").RESIDENT.reset()
        _mod(Q, "integrity").INTEGRITY.reset()
        monkeypatch.setattr(Q.dm, "TRANSFERS", Q.dm.TransferLedger())
    if P is REF:
        import tools.device_report as dr
        rc = dr.main(argv)
    else:
        from karpenter_tpu_torch.obs import device_report as dr
        rc = dr.main(argv + ["--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.strip().splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def _resident(doc):
    """The resident breakdown, its counters read as missing == 0: the
    audit counters join the stats at a package's first resident audit and
    reset() zeroes them without removing them, so whether they are listed
    depends on what ran earlier in the process."""
    res = doc["resident"]
    if res is None:
        return None
    return {**res, "stats": {k: v for k, v in res["stats"].items() if v}}


def _keys(doc):
    return {k: sorted(v) if isinstance(v, dict) and k != "kinds" else None
            for k, v in doc.items()}


@pytest.mark.parametrize("argv", [
    ["--pods", "64", "--rounds", "2"],
    ["--pods", "400", "--rounds", "3", "--churn-pct", "5"],
    ["--pods", "200", "--rounds", "3", "--churn-pct", "0", "--no-resident"]],
    ids=["reference_case", "churn", "warm_no_resident"])
def test_device_report_equals_the_reference(argv, capsys, monkeypatch):
    want = _report_doc(REF, argv, capsys, monkeypatch)
    got = _report_doc(PORT, argv, capsys, monkeypatch)
    assert got["rounds"] == int(argv[3])
    if argv[3] == "2":
        # the reference's case: 64 pods at 1% churn churn none, so the
        # single warm round re-uploads a byte-identical matrix, and the
        # cold seeding round must not dilute the reported fraction
        assert got["upload_redundant_frac"] >= 0.99
    assert got["residency"]["watermark_bytes"] > 0
    assert got["audit"]["coverage"] >= 0.0
    assert _keys(got) == _keys(want)
    assert sorted(got["audit"]) == sorted(want["audit"])
    for k in ("pods", "rounds", "churn_pct", "uploads", "reads",
              "upload_redundant_frac", "transfers"):
        assert got[k] == want[k], k
    assert _resident(got) == _resident(want)
    assert (got["resident"] is None) == ("--no-resident" in argv)
