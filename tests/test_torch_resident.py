"""The port's device-resident state (`karpenter_tpu_torch/ops/resident.py`)
held against the JAX reference's: the cases of the reference's
`tests/test_resident.py` run through both packages (the port with
`device="cpu"`).

- The manager: the same uploads give the same buffers (byte for byte,
  and equal to a cold upload of the same matrix), the same transfer
  counts and bytes (changed rows + an int32 index vector), the same
  fallback reasons and the same stats, in both packages.
- Solves: resident-patched solves equal cold ones and the reference's,
  through the facade and the fleet service, batched and serial.
- The port's own contracts: the serial request matrices are patched in
  place (the reference donates them); the catalog tensors and the
  batched stacks are patched into a copy, so a co-tenant's DeviceCatalog
  keeps its bytes; a failed patch drops the entry and raises; the audit
  reads back through the counted `_read` and finds injected rot.

The delta plane is disarmed here, as in the reference's module: it would
serve repeated solves before they reach the upload path.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

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
from karpenter_tpu.models.pod import Pod, PodAffinityTerm
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.encode import encode_catalog
from karpenter_tpu.ops.facade import Solver as RefSolver
from karpenter_tpu.utils.clock import FakeClock as RefClock

from karpenter_tpu_torch.catalog import CatalogProvider as PortProvider
from karpenter_tpu_torch.convert import port_object
from karpenter_tpu_torch.fleet.service import SolverService as PortService
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import resident as port_resident
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.ops.facade import Solver as PortSolver
from karpenter_tpu_torch.utils.clock import FakeClock as PortClock

POOL = NodePool(name="default")
_CPUS = ["100m", "250m", "500m", "1", "2"]
_MEMS = ["128Mi", "512Mi", "1Gi", "2Gi"]


def _pkg(name):
    import importlib
    return importlib.import_module(name)


REF = SimpleNamespace(
    name="ref", pkg="karpenter_tpu", S=ref_solver,
    R=_pkg("karpenter_tpu.ops.resident"), dm=_pkg("karpenter_tpu.obs.devicemem"),
    M=_pkg("karpenter_tpu.metrics"), conv=lambda x: x, kw={}, fkw={},
    Solver=RefSolver, Provider=RefProvider, Service=RefService,
    Clock=RefClock, host=np.asarray)
PORT = SimpleNamespace(
    name="port", pkg="karpenter_tpu_torch", S=port_solver, R=port_resident,
    dm=_pkg("karpenter_tpu_torch.obs.devicemem"),
    M=_pkg("karpenter_tpu_torch.metrics"), conv=port_object,
    kw={"device": "cpu"}, fkw={"device": "cpu"}, Solver=PortSolver,
    Provider=PortProvider, Service=PortService, Clock=PortClock,
    host=lambda t: t.numpy())


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
        P.R.RESIDENT.reset()
        _drop_audit_keys(P)
        _pkg(P.pkg + ".ops.delta").DELTA.reset()
        _pkg(P.pkg + ".integrity").INTEGRITY.reset()


# ``ResidentStateManager.audit`` creates these stats keys on first use and
# ``reset()`` keeps them (zeroed), so a manager that audited earlier in the
# process carries three keys the other package's may lack (ROADMAP §3's
# test-order hazard). This module compares whole stats dicts.
_AUDIT_KEYS = ("audits", "audit_rows", "audit_corrupt")


def _drop_audit_keys(P):
    for key in _AUDIT_KEYS:
        P.R.RESIDENT.stats.pop(key, None)


@pytest.fixture(autouse=True)
def _fresh_resident(monkeypatch):
    """Each test starts from empty resident planes in both packages, with
    no shared view's device catalog cached at process level (a cached one
    would skip the catalog's resident upload this module counts)."""
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    for P in (REF, PORT):
        _pkg(P.pkg + ".ops.delta").DELTA.reset()
        P.S.release_shared_views(("shared",))
        P.R.RESIDENT.reset()
        _drop_audit_keys(P)
    # both packages' monotone unions of requested resource columns hold
    # the same columns: they set the request matrices' widths
    cols = REF.S._cols_union | PORT.S._cols_union
    REF.S._cols_union.update(cols)
    PORT.S._cols_union.update(cols)
    yield
    for P in (REF, PORT):
        P.R.RESIDENT.reset()


def mk_pods(n, prefix="p", gen=0, manifests=4, anti=False):
    pods = []
    for i in range(n):
        s = (i + gen) % manifests
        kw = dict(requests=Resources.parse(
            {"cpu": _CPUS[s % len(_CPUS)], "memory": _MEMS[s % len(_MEMS)]}),
            labels={"app": f"{prefix}-m{s}"})
        if anti and s % 3 == 0:
            kw["affinity_terms"] = [PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": f"{prefix}-m{s}"}, anti=True)]
        pods.append(Pod(name=f"{prefix}-{gen}-{i}", **kw))
    return pods


def _out_tuple(out):
    return ([(l.instance_type, l.zone, l.capacity_type, l.price,
              tuple(l.pod_keys), tuple(l.overrides)) for l in out.launches],
            {k: tuple(v) for k, v in out.existing_placements.items()},
            tuple(out.unschedulable))


def _both(case):
    want = case(REF)
    got = case(PORT)
    assert got == want
    return got


def _up(P, *a, **kw):
    return P.R.RESIDENT.upload(*a, **kw, **P.kw)


def _bytes(P, buf):
    return P.host(buf).tobytes()


# --- the manager -------------------------------------------------------------


def _clean_hit(P):
    mat = np.arange(64, dtype=np.float32).reshape(8, 8)
    buf = _up(P, ("k",), mat, token=("t", 1))
    u0 = P.S.transfer_stats()[0]
    buf2 = _up(P, ("k",), mat.copy(), token=("t", 1))
    assert P.S.transfer_stats()[0] == u0 and buf2 is buf
    st = P.R.RESIDENT.stats
    assert st["clean_hits"] == 1 and st["avoided_bytes"] == mat.nbytes
    return [dict(st), _bytes(P, buf2)]


def _changed_rows(P):
    mat = np.arange(80, dtype=np.float32).reshape(10, 8)
    _up(P, ("k",), mat, token=("t", 1))
    mat2 = mat.copy()
    mat2[3] += 100.0
    mat2[7] += 5.0
    h0 = P.dm.TRANSFERS.totals()[0]
    u0 = P.S.transfer_stats()[0]
    buf = _up(P, ("k",), mat2, token=("t", 1))
    shipped = P.dm.TRANSFERS.totals()[0] - h0
    assert shipped == 2 * 8 * 4 + 2 * 4
    assert np.array_equal(P.host(buf), mat2)
    assert P.R.RESIDENT.stats["rows_patched"] == 2
    assert 0 < P.R.RESIDENT.patched_rows_frac() < 1
    return [shipped, P.S.transfer_stats()[0] - u0, dict(P.R.RESIDENT.stats),
            P.R.RESIDENT.patched_rows_frac()]


def _random_rounds(P):
    rng = np.random.default_rng(7)
    mat = rng.random((16, 6), np.float32)
    _up(P, ("k",), mat, token=("t", 1))
    out = []
    for _ in range(8):
        rows = rng.choice(16, size=rng.integers(0, 6), replace=False)
        mat = mat.copy()
        mat[rows] = rng.random((len(rows), 6), np.float32)
        buf = _up(P, ("k",), mat, token=("t", 1))
        assert np.array_equal(P.host(buf), mat)
        out.append(_bytes(P, buf))
    return out + [dict(P.R.RESIDENT.stats)]


def _fallback(P, reason):
    return P.M.RESIDENT_FALLBACKS.sum(reason=reason)


def _token_change(P):
    mat = np.ones((4, 4), np.float32)
    _up(P, ("k",), mat, token=("t", 1))
    n0 = _fallback(P, "token_change")
    _up(P, ("k",), mat, token=("t", 2))
    assert _fallback(P, "token_change") == n0 + 1
    assert P.R.RESIDENT.stats["full_uploads"] == 2
    return [dict(P.R.RESIDENT.stats)]


def _shape_growth(P):
    _up(P, ("k",), np.ones((4, 4), np.float32), token=("t", 1))
    buf = _up(P, ("k",), np.ones((8, 4), np.float32), token=("t", 1))
    assert P.host(buf).shape == (8, 4)
    assert P.R.RESIDENT.stats["full_uploads"] == 2
    return [dict(P.R.RESIDENT.stats), _bytes(P, buf)]


def _dense(P):
    mat = np.zeros((10, 4), np.float32)
    _up(P, ("k",), mat, token=("t", 1))
    n0 = _fallback(P, "dense")
    _up(P, ("k",), mat + 1.0, token=("t", 1))
    assert _fallback(P, "dense") == n0 + 1
    return [dict(P.R.RESIDENT.stats)]


def _bool_3d(P):
    conf = np.zeros((6, 6), bool)
    _up(P, ("c",), conf, token=None)
    conf2 = conf.copy()
    conf2[2, 3] = conf2[3, 2] = True
    buf = _up(P, ("c",), conf2, token=None)
    assert np.array_equal(P.host(buf), conf2)
    cat3 = np.zeros((5, 3, 2), np.float32)
    _up(P, ("p",), cat3, token=None)
    cat3b = cat3.copy()
    cat3b[4] = 9.0
    buf3 = _up(P, ("p",), cat3b, token=None, donate=False)
    assert np.array_equal(P.host(buf3), cat3b)
    assert P.R.RESIDENT.stats["patches"] == 2
    return [_bytes(P, buf), _bytes(P, buf3), dict(P.R.RESIDENT.stats)]


def _invalidate_key(P):
    mat = np.ones((2, 2), np.float32)
    _up(P, ("facade", 1, "a"), mat, token=("t",))
    _up(P, ("facade", 2, "a"), mat, token=("t",))
    i0, f0 = _fallback(P, "invalidated"), _fallback(P, "first_sight")
    out = [P.R.RESIDENT.invalidate(("facade", 1)),
           len(P.R.RESIDENT.snapshot()["entries"]),
           _fallback(P, "invalidated") - i0]
    _up(P, ("facade", 1, "a"), mat, token=("t",))
    out += [_fallback(P, "invalidated") - i0, _fallback(P, "first_sight") - f0]
    assert out == [1, 1, 0, 1, 0]
    return out


def _invalidate_token(P):
    mat = np.ones((2, 2), np.float32)
    _up(P, ("x",), mat, token=("shared", "nc1", "fp1"))
    _up(P, ("y",), mat, token=("shared", "nc2", "fp9"))
    out = [P.R.RESIDENT.invalidate_token(("shared", "nc1")),
           len(P.R.RESIDENT.snapshot()["entries"])]
    assert out == [1, 1]
    return out


def _release_shared(P):
    _up(P, ("z",), np.ones((2, 2), np.float32),
        token=("shared", "ncX", "fpX", "ds"))
    P.S.release_shared_views(("shared", "ncX"))
    assert P.R.RESIDENT.snapshot()["entries"] == []
    return [P.R.RESIDENT.snapshot()["stats"]]


def _ledger_kind(P):
    _up(P, ("led",), np.ones((6, 6), np.float32), token=("t",))
    with P.dm.DEVICEMEM._lock:
        kinds = {g["kind"] for g in P.dm.DEVICEMEM._groups.values()
                 if g["live"]}
    assert "resident_state" in kinds
    return ["resident_state" in kinds]


def _debug_route(P):
    import json
    _up(P, ("dbg",), np.ones((2, 2), np.float32), token=("t",))
    status, ctype, body = _pkg(P.pkg + ".obs.exposition").render(
        "/debug/resident")
    assert status == 200 and "json" in ctype
    snap = json.loads(body)
    assert snap["armed"] is True and snap["stats"]["full_uploads"] == 1
    return snap


@pytest.mark.parametrize("case", [
    _clean_hit, _changed_rows, _random_rounds, _token_change, _shape_growth,
    _dense, _bool_3d, _invalidate_key, _invalidate_token, _release_shared,
    _ledger_kind, _debug_route], ids=lambda c: c.__name__[1:])
def test_manager_equals_the_reference(case):
    _both(case)


def test_constants_equal_the_reference():
    assert port_resident.MAX_ENTRIES == REF.R.MAX_ENTRIES == 512
    assert port_resident.PATCH_MAX_FRAC == REF.R.PATCH_MAX_FRAC == 0.5
    assert port_resident.FALLBACK_REASONS == REF.R.FALLBACK_REASONS


@pytest.mark.parametrize("seed", range(3))
def test_patched_buffer_is_byte_equal_to_a_cold_upload(seed):
    """Resident buffers after random churn (bool, f32, 3-D, donated or
    not) are byte-equal to a cold upload of the same matrix, and to the
    reference's resident buffer."""
    rng = np.random.default_rng(seed)
    shapes = [((24, 7), np.float32), ((12, 12), bool), ((9, 4, 3),
                                                        np.float32)]
    for (shape, dtype), donate in zip(shapes, (True, False, True)):
        mat = (rng.random(shape) > 0.5) if dtype is bool else \
            rng.random(shape).astype(dtype)
        key = ("fuzz", str(shape))
        for _ in range(6):
            rows = rng.choice(shape[0], size=rng.integers(0, shape[0] // 2),
                              replace=False)
            mat = mat.copy()
            fresh = (rng.random((len(rows),) + shape[1:]) > 0.5) \
                if dtype is bool else rng.random(
                    (len(rows),) + shape[1:]).astype(dtype)
            mat[rows] = fresh
            want = np.asarray(REF.R.RESIDENT.upload(key, mat, token=("t",),
                                                    donate=donate))
            got = port_resident.RESIDENT.upload(key, mat, token=("t",),
                                                donate=donate, device="cpu")
            cold = port_solver._put(mat, torch.device("cpu"))
            assert got.numpy().tobytes() == cold.numpy().tobytes() \
                == want.tobytes() == mat.tobytes()
    assert port_resident.RESIDENT.stats == REF.R.RESIDENT.stats


def test_mid_patch_fault_drops_the_entry(monkeypatch):
    """A fault mid-patch may have left the resident buffer half-written:
    the entry is dropped, the error raises, and the next upload re-seeds
    cold (metered as 'invalidated') — as in the reference."""
    got = {}
    for P in (REF, PORT):
        mat = np.zeros((8, 4), np.float32)
        _up(P, ("flt",), mat, token=("t",))
        mat2 = mat.copy()
        mat2[2] += 1.0
        real_put = P.S._put

        def boom(*a, **kw):
            raise RuntimeError("device lost mid-patch")

        monkeypatch.setattr(P.S, "_put", boom)
        with pytest.raises(RuntimeError):
            _up(P, ("flt",), mat2, token=("t",))
        assert not P.R.RESIDENT.snapshot()["entries"]
        monkeypatch.setattr(P.S, "_put", real_put)
        i0 = _fallback(P, "invalidated")
        buf = _up(P, ("flt",), mat2, token=("t",))
        assert np.array_equal(P.host(buf), mat2)
        got[P.name] = _fallback(P, "invalidated") - i0
    assert got["port"] == got["ref"] == 1


def test_failed_scatter_raises_and_drops_the_entry(monkeypatch):
    """The scatter itself failing (a launch error on the card) raises out
    of upload — no fallback hides the device — and drops the entry."""
    _up(PORT, ("sc",), np.zeros((8, 4), np.float32), token=("t",))

    def refuse(*a, **kw):
        raise RuntimeError("index_copy_ launch failed")

    monkeypatch.setattr(port_resident, "_scatter_rows", refuse)
    mat = np.zeros((8, 4), np.float32)
    mat[1] = 1.0
    with pytest.raises(RuntimeError, match="launch failed"):
        _up(PORT, ("sc",), mat, token=("t",))
    assert not port_resident.RESIDENT.snapshot()["entries"]


def test_donated_patch_is_in_place_and_shared_patch_is_a_copy():
    """The serial request matrices are patched in place (the reference
    donates them); a non-donated patch (catalog tensors, batched stacks)
    lands in a copy, and the predecessor keeps its bytes."""
    R = port_resident.RESIDENT
    mat = np.zeros((8, 4), np.float32)
    a = R.upload(("don",), mat, token=("t",), device="cpu")
    b = R.upload(("keep",), mat, token=("t",), device="cpu", donate=False)
    mat2 = mat.copy()
    mat2[3] = 7.0
    a2 = R.upload(("don",), mat2, token=("t",), device="cpu")
    b2 = R.upload(("keep",), mat2, token=("t",), device="cpu", donate=False)
    assert a2 is a and np.array_equal(a.numpy(), mat2)
    assert b2 is not b and np.array_equal(b2.numpy(), mat2)
    assert np.array_equal(b.numpy(), mat)


def test_audit_reads_back_through_the_counted_read():
    """audit() is the one place that reads resident rows back: each entry
    is one counted read, and injected rot (a replacement buffer whose
    bytes differ from the stored digests) is found and dropped, with the
    reference's verdicts."""
    got = {}
    for P in (REF, PORT):
        for name in ("a", "b"):
            _up(P, ("aud", name), np.arange(24, dtype=np.float32)
                .reshape(6, 4), token=("t",))
        ent = P.R.RESIDENT._entries[("aud", "b")]
        rot = P.host(ent.buf).copy()
        rot[2] = 0.0
        ent.buf = (torch.from_numpy(rot) if P is PORT
                   else _pkg("jax.numpy").asarray(rot))
        r0 = P.S.transfer_stats()[1]
        rep = P.R.RESIDENT.audit(("aud",))
        assert rep["corrupt"] == [("aud", "b")] and rep["entries"] == 2
        assert P.S.transfer_stats()[1] - r0 == 2
        assert ("aud", "b") not in P.R.RESIDENT._entries
        got[P.name] = rep
    assert got["port"] == got["ref"]


def test_failed_audit_readback_raises(monkeypatch):
    _up(PORT, ("rd",), np.ones((4, 4), np.float32), token=("t",))

    def lost(t):
        raise RuntimeError("device lost at readback")

    monkeypatch.setattr(port_solver, "_read", lost)
    with pytest.raises(RuntimeError, match="readback"):
        port_resident.RESIDENT.audit(("rd",))


def test_upload_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_resident.RESIDENT.upload(("nocard",), np.ones((2, 2)))


# --- solves ------------------------------------------------------------------


def _facade(P, provider):
    return P.Solver(provider, backend="device", **P.fkw)


@pytest.mark.parametrize("seed", range(4))
def test_resident_solve_byte_identical_to_cold(seed):
    """Churn, shape-class regrowth and shrink, and ICE epoch bumps: each
    resident solve equals a fresh cold facade's, and the reference's."""
    outs = {}
    for P in (REF, PORT):
        rng = random.Random(seed * 6151 + 5)
        types = P.conv(small_catalog())
        provider = P.Provider(lambda: types)
        resident = _facade(P, provider)
        pool = P.conv(POOL)
        n = rng.randrange(8, 24)
        gen = 0
        anti = rng.random() < 0.5
        rows = []
        for rnd in range(6):
            move = rng.random()
            if move < 0.25:
                gen += 1
            elif move < 0.40:
                n = n * 3
            elif move < 0.55 and rnd:
                n = max(6, n // 3)
            elif move < 0.70:
                t = types[rng.randrange(len(types))]
                o = t.offerings[rng.randrange(len(t.offerings))]
                provider.unavailable.mark_unavailable(
                    t.name, o.zone, o.capacity_type, reason="fuzz")
            pods = P.conv(mk_pods(n, prefix=f"s{seed}", gen=gen,
                                  manifests=rng.choice([3, 4, 6]),
                                  anti=anti))
            got = resident.solve(pods, pool)
            cold = _facade(P, provider).solve(pods, pool)
            assert _out_tuple(got) == _out_tuple(cold), (P.name, rnd)
            rows.append(_out_tuple(got))
        st = P.R.RESIDENT.stats
        assert st["clean_hits"] + st["patches"] > 0
        # outputs, not the manager's counts: a cold facade made and
        # dropped each round may reuse a dead one's id, and so its
        # resident keys, differently in each package
        outs[P.name] = rows
    assert outs["port"] == outs["ref"]


@pytest.mark.parametrize("batch", [False, True])
def test_service_parity_batch_on_off(batch):
    """The same tenant rows through the fleet service with residency
    armed, batched and serial, equal fresh cold facades' and the
    reference's."""
    outs = {}
    for P in (REF, PORT):
        types = P.conv(small_catalog())
        pool = P.conv(POOL)
        svc = P.Service(P.Clock(), backend="device", batch=batch, **P.kw)
        clients = {f"t{i}": svc.register(f"t{i}", P.Provider(lambda: types))
                   for i in range(3)}
        rows = []
        for rnd in range(3):
            podsets = {name: P.conv(mk_pods(8 + rnd, prefix=name, gen=rnd))
                       for name in clients}
            if batch:
                tickets = {name: clients[name].solve_async(pods, pool)
                           for name, pods in podsets.items()}
                svc.pump()
                got = {name: t.result() for name, t in tickets.items()}
            else:
                got = {name: clients[name].solve(pods, pool)
                       for name, pods in podsets.items()}
            for name, pods in podsets.items():
                cold = _facade(P, P.Provider(lambda: types)).solve(pods,
                                                                   pool)
                assert _out_tuple(got[name]) == _out_tuple(cold)
                rows.append(_out_tuple(got[name]))
        outs[P.name] = rows  # (the counts: see the test above)
    assert outs["port"] == outs["ref"]


def test_warm_identical_solve_ships_zero_upload_bytes():
    got = {}
    for P in (REF, PORT):
        types = P.conv(small_catalog())
        f = _facade(P, P.Provider(lambda: types))
        pool = P.conv(POOL)
        f.solve(P.conv(mk_pods(12)), pool)
        u0, h0 = P.S.transfer_stats()[0], P.dm.TRANSFERS.totals()[0]
        out = f.solve(P.conv(mk_pods(12)), pool)
        assert out.launches
        assert P.S.transfer_stats()[0] == u0
        assert P.dm.TRANSFERS.totals()[0] == h0
        assert P.R.RESIDENT.stats["clean_hits"] >= 1
        got[P.name] = dict(P.R.RESIDENT.stats)
    assert got["port"] == got["ref"]


def test_memo_served_solve_after_a_resident_reset_uploads_nothing(
        monkeypatch):
    """A resident reset leaves the delta plane's memo, whose keys hold
    id(facade): a solve it serves uploads nothing, so the facade has no
    resident row (ROADMAP §3: a later facade that reuses a freed one's id
    meets this state)."""
    monkeypatch.delenv("KARPENTER_TPU_DELTA", raising=False)
    got = {}
    for P in (REF, PORT):
        delta = _pkg(P.pkg + ".ops.delta").DELTA
        types = P.conv(small_catalog())
        f = _facade(P, P.Provider(lambda: types))
        pods, pool = P.conv(mk_pods(16)), P.conv(POOL)
        first = _out_tuple(f.solve(pods, pool))
        key = ("facade", id(f))
        assert any(k[:2] == key for k in P.R.RESIDENT._entries)
        P.R.RESIDENT.reset()
        s0 = delta.stats["serves"]
        assert _out_tuple(f.solve(pods, pool)) == first
        assert delta.stats["serves"] > s0
        assert not any(k[:2] == key for k in P.R.RESIDENT._entries)
        got[P.name] = (first, delta.stats["serves"] - s0)
    assert got["port"] == got["ref"]


def test_disarmed_env_restores_classic_path(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_RESIDENT", "0")
    for P in (REF, PORT):
        types = P.conv(small_catalog())
        f = _facade(P, P.Provider(lambda: types))
        f.solve(P.conv(mk_pods(10)), P.conv(POOL))
        u0 = P.S.transfer_stats()[0]
        f.solve(P.conv(mk_pods(10)), P.conv(POOL))
        assert P.S.transfer_stats()[0] == u0 + 1
        assert P.R.RESIDENT.stats["full_uploads"] == 0


def test_audit_divergence_invalidates_resident_state():
    got = {}
    for P in (REF, PORT):
        types = P.conv(small_catalog())
        f = _facade(P, P.Provider(lambda: types))
        f.solve(P.conv(mk_pods(10)), P.conv(POOL))
        n = len(P.R.RESIDENT.snapshot()["entries"])
        dropped = f.invalidate_resident()
        assert n and dropped >= 1
        assert not any(e["key"].startswith("facade/")
                       for e in P.R.RESIDENT.snapshot()["entries"])
        got[P.name] = (n, dropped)
    assert got["port"] == got["ref"]


def test_cobatched_tenant_divergence_mid_run():
    """A shared view split by an ICE mark mid-run: the diverged tenant
    splits off the bucket, its resident catalog re-keys, and each tenant
    equals a cold facade seeing exactly its own marks — as in the
    reference."""
    outs = {}
    for P in (REF, PORT):
        types = P.conv(small_catalog())
        pool = P.conv(POOL)
        svc = P.Service(P.Clock(), backend="device", batch=True, **P.kw)
        a = svc.register("a", P.Provider(lambda: types))
        b = svc.register("b", P.Provider(lambda: types))
        t1 = {c: c_.solve_async(P.conv(mk_pods(8, prefix=c)), pool)
              for c, c_ in (("a", a), ("b", b))}
        svc.pump()
        for t in t1.values():
            assert t.result().launches
        assert svc.stats["batches"] == 1
        ty = types[0]
        o = ty.offerings[0]
        b.catalog.unavailable.mark_unavailable(ty.name, o.zone,
                                               o.capacity_type,
                                               reason="divergence")
        p0 = (P.R.RESIDENT.stats["patches"]
              + P.R.RESIDENT.stats["full_uploads"])
        t2 = {c: c_.solve_async(P.conv(mk_pods(8, prefix=c, gen=1)), pool)
              for c, c_ in (("a", a), ("b", b))}
        batches0 = svc.stats["batches"]
        svc.pump()
        got = {c: t.result() for c, t in t2.items()}
        assert svc.stats["batches"] - batches0 >= 2
        assert (P.R.RESIDENT.stats["patches"]
                + P.R.RESIDENT.stats["full_uploads"]) > p0
        for name in ("a", "b"):
            cold = _facade(P, P.Provider(lambda: types))
            if name == "b":
                cold.catalog.unavailable.mark_unavailable(
                    ty.name, o.zone, o.capacity_type, reason="divergence")
            want = cold.solve(P.conv(mk_pods(8, prefix=name, gen=1)), pool)
            assert _out_tuple(got[name]) == _out_tuple(want), name
        marked = (ty.name, o.zone, o.capacity_type)
        assert all((l.instance_type, l.zone, l.capacity_type) != marked
                   for l in got["b"].launches)
        outs[P.name] = {c: _out_tuple(v) for c, v in got.items()}
    assert outs["port"] == outs["ref"]


def test_cotenant_catalog_survives_a_non_donated_patch():
    """Two facades share one view's DeviceCatalog (the fleet's shared
    cache); one ICE-diverges, and its catalog is patched from the shared
    resident copy. The patch lands in a copy: the co-tenant's
    DeviceCatalog keeps its bytes, and its next solve equals a cold
    one."""
    from karpenter_tpu_torch.ops.facade import SharedCatalogCache
    types = port_object(small_catalog())
    pool = port_object(POOL)
    shared = SharedCatalogCache()
    a = PortSolver(PortProvider(lambda: types), backend="device",
                   device="cpu", shared_catalog=shared)
    b = PortSolver(PortProvider(lambda: types), backend="device",
                   device="cpu", shared_catalog=shared)
    pods = port_object(mk_pods(10))
    a.solve(pods, pool)
    b.solve(pods, pool)
    dcats = [d for d in port_solver._dcat_cache.values()]
    before = [(d.alloc.clone(), d.price.clone(), d.avail.clone())
              for d in dcats]
    ty = types[0]
    o = ty.offerings[0]
    b.catalog.unavailable.mark_unavailable(ty.name, o.zone,
                                           o.capacity_type,
                                           reason="divergence")
    p0 = port_resident.RESIDENT.stats["patches"]
    b.solve(port_object(mk_pods(10, gen=1)), pool)
    assert port_resident.RESIDENT.stats["patches"] > p0  # patched, not full
    for d, (al, pr, av) in zip(dcats, before):
        assert torch.equal(d.alloc, al) and torch.equal(d.price, pr)
        assert torch.equal(d.avail, av)
    cold = PortSolver(PortProvider(lambda: types), backend="device",
                      device="cpu")
    assert _out_tuple(a.solve(port_object(mk_pods(10, gen=2)), pool)) == \
        _out_tuple(cold.solve(port_object(mk_pods(10, gen=2)), pool))


def test_repeat_run_identical_with_residency_armed():
    def run(P):
        P.R.RESIDENT.reset()
        types = P.conv(small_catalog())
        svc = P.Service(P.Clock(), backend="device", batch=True, **P.kw)
        clients = [svc.register(f"t{i}", P.Provider(lambda: types))
                   for i in range(2)]
        outs = []
        for rnd in range(3):
            tickets = [c.solve_async(P.conv(
                mk_pods(6 + rnd, prefix=f"t{i}", gen=rnd)), P.conv(POOL))
                for i, c in enumerate(clients)]
            svc.pump()
            outs.append([_out_tuple(t.result()) for t in tickets])
        return outs

    assert run(PORT) == run(PORT) == run(REF)


def test_chaos_smoke_green_with_residency_armed(monkeypatch):
    import dataclasses
    from karpenter_tpu.faults.runner import ScenarioRunner as RefRunner
    from karpenter_tpu_torch.faults import SCENARIOS, ScenarioRunner
    monkeypatch.delenv("KARPENTER_TPU_DELTA", raising=False)
    assert port_resident.RESIDENT.armed
    sc = dataclasses.replace(SCENARIOS["smoke"], backend="device")
    a = ScenarioRunner(sc, seed=3, device="cpu").run()
    b = ScenarioRunner(sc, seed=3, device="cpu").run()
    want = RefRunner("smoke", seed=3).run()
    assert a.ok and b.ok
    assert a.end_hash == b.end_hash == want.end_hash
    assert a.fault_fingerprint == b.fault_fingerprint == \
        want.fault_fingerprint
