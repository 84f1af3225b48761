"""The port's batched dispatch and fleet SolverService held against the
JAX reference's.

Every cluster here is built with the reference's constructors from a seed
and carried across with `karpenter_tpu_torch.convert`, so both packages
see the same pods and catalog. The reference runs on JAX-CPU; the port
runs with `device="cpu"`, where kernels B0 and B take their plain
versions. Tolerance: exact everywhere (packed rows at atol 0, SolveOutputs
element for element).

- `dispatch_batch` on seeded buckets: the port's packed [Bp, L] rows equal
  the reference's and the port's serial `solve_packed` vectors.
- `tests/test_batch_parity.py` through the port (not the two cases that
  need the watchdog, the delta plane and the phase ledger: ROADMAP §1
  items 16 and 6); the seeded fuzz also holds the port's batched outputs
  equal to the reference's `SolverService`'s.
- `tests/test_fleet.py`'s SolverService cases (those that build no
  FleetRunner) through the port.
- The port's fault contract (ROADMAP §3): only `InjectedFault` degrades a
  bucket; a readback or kernel error raises out of `pump()`.
"""

from __future__ import annotations

import itertools
import random

import numpy as np
import pytest

from karpenter_tpu.catalog import CatalogProvider as RefProvider
from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.catalog.generator import small_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.fleet.service import SolverService as RefService
from karpenter_tpu.models import labels as L
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.nodepool import NodePool
from karpenter_tpu.models.pod import Pod, PodAffinityTerm
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.encode import encode_catalog, encode_pods
from karpenter_tpu.utils.clock import FakeClock as RefClock

from karpenter_tpu_torch import convert
from karpenter_tpu_torch.catalog import CatalogProvider
from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.fleet import SolverService, SolverServiceBusy
from karpenter_tpu_torch.metrics import FLEET_SHAPE_CLASS, FLEET_THROTTLED
from karpenter_tpu_torch.metrics.tenant import current_tenant
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.ops.solver import InFlightBatch, InjectedFault
from karpenter_tpu_torch.utils.clock import FakeClock

port_object = convert.port_object
_CPUS = ["100m", "250m", "500m", "1", "2"]
_MEMS = ["128Mi", "512Mi", "1Gi", "2Gi"]


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """After this module: give the reference back its claim-name, pod-uid
    and instance-id sequences, empty its signature intern table (a
    rotation, see test_torch_encode.py; this keeps the module from feeding
    test_encode.py's order hazard, ROADMAP §3) and reset its
    device-resident state, delta memos and integrity meter, as its own
    test modules do."""
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids)
    yield
    from karpenter_tpu.integrity import INTEGRITY
    from karpenter_tpu.ops.delta import DELTA
    from karpenter_tpu.ops.resident import RESIDENT
    ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids = saved
    ref_pod._sig_intern.clear()
    RESIDENT.reset()
    DELTA.reset()
    INTEGRITY.reset()


@pytest.fixture(scope="module", autouse=True)
def _shared_resource_axis():
    """Both packages' resource axes get the same columns in the same
    order (see test_torch_facade.py)."""
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    assert port_res.resource_axis() == ref_res.resource_axis()


@pytest.fixture(autouse=True)
def _same_start():
    """Before each case: both packages' claim-name, pod-uid and
    instance-id sequences restart at the same value, and their monotone
    column unions (`_cols_union`) hold the same columns."""
    for P in ((ref_nodeclaim, ref_pod, ref_fake),
              (port_nodeclaim, port_pod, port_fake)):
        P[0]._seq = itertools.count()
        P[1]._uid = itertools.count()
        P[2]._ids = itertools.count(1)
    cols = ref_solver._cols_union | port_solver._cols_union
    ref_solver._cols_union.update(cols)
    port_solver._cols_union.update(cols)
    yield
    port_solver.set_dispatch_fault_hook(None)


def out_tuple(out):
    """Everything a SolveOutput decides, stats excluded (either package)."""
    return ([(l.instance_type, l.zone, l.capacity_type, l.price,
              list(l.overrides), list(l.pod_keys), dict(l.requests),
              dict(l.labels)) for l in out.launches],
            {k: list(v) for k, v in out.existing_placements.items()},
            list(out.unschedulable))


def _tenant_pods(rng: random.Random, tenant: str, n: int, manifests: int,
                 anti: bool):
    """The reference test's pods (tests/test_batch_parity.py): n pods from
    `manifests` signatures; `anti` adds hostname anti-affinity."""
    pods = []
    for i in range(n):
        s = i % manifests
        kw = dict(requests=Resources.parse(
            {"cpu": _CPUS[s % len(_CPUS)], "memory": _MEMS[s % len(_MEMS)]}),
            labels={"app": f"{tenant}-m{s}"})
        if s % 3 == 0:
            kw["node_selector"] = {L.ZONE: rng.choice(["zone-a", "zone-b"])}
        if anti and s % 4 == 1:
            kw["affinity_terms"] = [PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": f"{tenant}-m{s}"}, anti=True)]
        pods.append(Pod(name=f"{tenant}-p{i}", **kw))
    return pods


def _mk_fleet(rng: random.Random, n_tenants: int):
    """(tenant, pods, ice?) rows: a randomized mix of shape classes; one
    tenant may take an ICE mark (catalog divergence)."""
    rows = []
    ice_at = rng.randrange(n_tenants) if rng.random() < 0.7 else -1
    for t in range(n_tenants):
        name = f"t{t:02d}"
        manifests = rng.choice([3, 5, 8, 12])
        n = rng.randrange(4, 28)
        anti = rng.random() < 0.3
        rows.append((name, _tenant_pods(rng, name, n, manifests, anti),
                     t == ice_at))
    return rows


def _port_rows(rows):
    return [(n, port_object(p), ice) for n, p, ice in rows]


def _register(svc, rows, types, provider):
    clients = {}
    for name, _, ice in rows:
        clients[name] = svc.register(name, provider(lambda: types))
        if ice:
            clients[name].catalog.unavailable.mark_unavailable(
                types[0].name, "zone-a", "spot", reason="fuzz")
    return clients


def _serial(rows, types, pool):
    svc = SolverService(FakeClock(), backend="device", device="cpu")
    clients = _register(svc, rows, types, CatalogProvider)
    return {name: clients[name].solve(pods, pool) for name, pods, _ in rows}


def _batched(rows, types, pool, svc=None):
    svc = svc or SolverService(FakeClock(), backend="device", batch=True,
                               device="cpu")
    clients = _register(svc, rows, types, CatalogProvider)
    tickets = {name: clients[name].solve_async(pods, pool)
               for name, pods, _ in rows}
    svc.pump()
    return {name: t.result() for name, t in tickets.items()}, svc


def _assert_identical(a, b, what):
    assert a.keys() == b.keys()
    for name in a:
        assert out_tuple(a[name]) == out_tuple(b[name]), (what, name)


# --- dispatch_batch: packed rows at atol 0 ---------------------------------


def _conflict_pods(rng: random.Random, tenant: str, n: int):
    """Three manifests; the first is hostname-anti-affine to a label the
    second shares with it: a cross-group conflict (the conflict-tracking
    scan)."""
    pods = []
    for i in range(n):
        s = i % 3
        kw = dict(requests=Resources.parse(
            {"cpu": _CPUS[s + rng.randrange(2)], "memory": _MEMS[s]}),
            labels={"app": f"{tenant}-x" if s < 2 else f"{tenant}-m2"})
        if s == 0:
            kw["affinity_terms"] = [PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": f"{tenant}-x"}, anti=True)]
        pods.append(Pod(name=f"{tenant}-p{i}", **kw))
    return pods


def _bucket_case(case: str):
    """(reference catalog, reference encodes) of one seeded bucket whose
    requests share one shape class."""
    cat = encode_catalog(small_catalog())
    rng = random.Random({"plain": 1, "conflicts": 2, "padded": 3}[case])
    n_req = 5 if case == "padded" else 4
    if case == "conflicts":
        return cat, [encode_pods(_conflict_pods(rng, f"b{i}", 12), cat)
                     for i in range(n_req)]
    return cat, [encode_pods(_tenant_pods(rng, f"b{i}", rng.randrange(6, 20),
                                          3, False), cat)
                 for i in range(n_req)]


@pytest.mark.parametrize("case", ["plain", "conflicts", "padded"])
def test_dispatch_batch_rows_equal_the_reference(case):
    cat, encs = _bucket_case(case)
    ref_reqs = [ref_solver.prepare_batchable(cat, e) for e in encs]
    assert len({r.signature for r in ref_reqs}) == 1
    ref_ifb = ref_solver.dispatch_batch(ref_reqs)
    ref_ifb.block()
    want = ref_ifb._buf

    pcat = convert.catalog_from_arrays(vars(cat))
    pencs = [convert.pods_from_arrays(
        {k: v for k, v in vars(e).items() if k != "groups"}) for e in encs]
    reqs = [port_solver.prepare_batchable(pcat, e, device="cpu")
            for e in pencs]
    assert len({r.signature for r in reqs}) == 1
    assert reqs[0].statics["track_conflicts"] == (case == "conflicts")
    ifb = port_solver.dispatch_batch(reqs)
    got = ifb.rows()
    assert got.shape == want.shape
    assert ifb.padded_size == (6 if case == "padded" else 4)
    np.testing.assert_array_equal(got, want)
    for i, e in enumerate(pencs):
        serial, st = port_solver.solve_packed(pcat, e, device="cpu")
        assert st["n_max"] == reqs[i].statics["n_max"]
        np.testing.assert_array_equal(got[i], serial)
    # the padded row places nothing
    for row in got[len(encs):]:
        assert row[0] == 0 and row[2] == 0
    # decoded rows (and the synchronous solve_device_batched) equal the
    # serial solves
    results = port_solver.solve_device_batched(reqs)
    for i, e in enumerate(pencs):
        d = port_solver.solve_device(pcat, e, device="cpu")
        for b in (ifb.decode(i), results[i]):
            assert [n.pods_by_group for n in b.nodes] == \
                [n.pods_by_group for n in d.nodes]
            assert b.launches == d.launches and \
                b.unschedulable == d.unschedulable
    assert ifb.fallbacks == 0


def test_dispatch_packed_and_from_rows_equal_dispatch_batch():
    """The federation seam: an already-packed stack dispatches to the same
    rows, and rows rehydrated with from_rows decode as the batch does."""
    cat, encs = _bucket_case("conflicts")
    pcat = convert.catalog_from_arrays(vars(cat))
    reqs = [port_solver.prepare_batchable(pcat, convert.pods_from_arrays(
        {k: v for k, v in vars(e).items() if k != "groups"}), device="cpu")
        for e in encs]
    ifb = port_solver.dispatch_batch(reqs)
    st, Gp = reqs[0].statics, reqs[0].Gp
    gstack = np.stack([port_solver._pack_groups(
        *port_solver._group_inputs(r.enc, Gp), list(st["cols"]))
        for r in reqs])
    conf = np.stack([port_solver._pad_to(port_solver._pad_to(
        r.enc.conflict, Gp, 0), Gp, 1) for r in reqs])
    packed = port_solver.dispatch_packed(gstack, conf, reqs[0].dcat, st)
    np.testing.assert_array_equal(packed.rows(), ifb.rows())
    again = InFlightBatch.from_rows(reqs, packed.rows())
    for i in range(len(reqs)):
        assert again.decode(i).launches == ifb.decode(i).launches


def test_overflowed_row_reruns_serially():
    """A row whose node budget proved too small (overflow) re-runs through
    solve_device's regrow loop, counted in `fallbacks`, and decodes to the
    serial answer."""
    cat = encode_catalog(small_catalog())
    pods = [Pod(name=f"a{i}", labels={"app": "x"},
                requests=Resources.parse({"cpu": "250m"}),
                affinity_terms=[PodAffinityTerm(
                    topology_key="kubernetes.io/hostname",
                    label_selector={"app": "x"}, anti=True)])
            for i in range(100)]
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays({k: v for k, v in vars(
        encode_pods(pods, cat)).items() if k != "groups"})
    req = port_solver.prepare_batchable(pcat, penc, device="cpu")
    assert req.statics["n_max"] >= 100
    req.statics = dict(req.statics, n_max=64, k_max=128)
    ifb = port_solver.dispatch_batch([req])
    assert ifb.rows()[0][1] == 1  # the overflow flag
    got = ifb.decode(0)
    assert ifb.fallbacks == 1
    want = port_solver.solve_device(pcat, penc, device="cpu")
    assert len(got.nodes) == len(want.nodes) == 100
    assert got.launches == want.launches


# --- tests/test_batch_parity.py through the port --------------------------


@pytest.mark.parametrize("seed", range(4))
def test_batched_dispatch_byte_identical_to_serial(seed):
    rng = random.Random(seed * 7919 + 13)
    types = small_catalog()
    rows = _mk_fleet(rng, n_tenants=rng.randrange(3, 7))
    # the reference's batched service on the same fleet
    ref_svc = RefService(RefClock(), backend="device", batch=True)
    ref_clients = _register(ref_svc, rows, types, RefProvider)
    ref_tickets = {n: ref_clients[n].solve_async(p, NodePool(name="default"))
                   for n, p, _ in rows}
    ref_svc.pump()
    ref_out = {n: t.result() for n, t in ref_tickets.items()}

    ptypes, prows = port_object(types), _port_rows(rows)
    pool = port_object(NodePool(name="default"))
    serial = _serial(prows, ptypes, pool)
    batched, svc = _batched(prows, ptypes, pool)
    _assert_identical(serial, batched, f"seed {seed}: serial vs batched")
    _assert_identical(ref_out, batched, f"seed {seed}: reference vs port")
    assert svc.stats["dispatched"] == len(rows)
    assert svc.stats["batches"] == ref_svc.stats["batches"]
    assert svc.stats["batched_tickets"] == ref_svc.stats["batched_tickets"]


def test_padding_remainder_rows_are_inert():
    """A 5-request bucket pads its request axis to 6: the padded row
    places nothing, and every real row decodes as if dispatched alone."""
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    rows = _port_rows([(f"t{i:02d}", _tenant_pods(
        random.Random(i), f"t{i:02d}", 6 + i, 3, False), False)
        for i in range(5)])
    serial = _serial(rows, types, pool)
    batched, svc = _batched(rows, types, pool)
    _assert_identical(serial, batched, "pad")
    assert svc.stats["batches"] == 1
    assert svc.stats["batched_tickets"] == 5
    assert svc.stats["padded_slots"] == 6  # {1,2,3,4,6,8,...} ladder


def test_mid_batch_ice_divergence_splits_the_bucket():
    """A tenant whose ICE mark re-fingerprints its catalog view cannot
    share the batch's device catalog: it dispatches in its own bucket, and
    only its result reflects the mark."""
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    rng = random.Random(99)
    rows = _port_rows([("t00", _tenant_pods(rng, "t00", 8, 3, False), False),
                       ("t01", _tenant_pods(rng, "t01", 8, 3, False), True),
                       ("t02", _tenant_pods(rng, "t02", 8, 3, False), False)])
    serial = _serial(rows, types, pool)
    batched, svc = _batched(rows, types, pool)
    _assert_identical(serial, batched, "ice")
    assert svc.stats["batches"] >= 2


def test_two_staged_encodes_of_one_tenant_do_not_alias():
    """Two same-tenant tickets in one pump decode to what two serial
    solves produce: the pump leases the tenant's encode arena, so each
    staged encode owns its memory."""
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    rng = random.Random(21)
    pods_a = port_object(_tenant_pods(rng, "x", 14, 6, True))
    pods_b = port_object(_tenant_pods(rng, "y", 9, 4, False))
    sc = SolverService(FakeClock(), backend="device", device="cpu").register(
        "t", CatalogProvider(lambda: types))
    ser_a, ser_b = sc.solve(pods_a, pool), sc.solve(pods_b, pool)

    svc = SolverService(FakeClock(), backend="device", batch=True,
                        device="cpu")
    client = svc.register("t", CatalogProvider(lambda: types))
    ta = client.solve_async(pods_a, pool)
    tb = client.solve_async(pods_b, pool)
    svc.pump()
    assert out_tuple(ta.result()) == out_tuple(ser_a)
    assert out_tuple(tb.result()) == out_tuple(ser_b)
    assert not client.facade._arena._leased
    assert out_tuple(client.solve(pods_a, pool)) == out_tuple(ser_a)


def test_solve_async_counts_against_the_inflight_cap():
    """The window cap gates SUBMISSION: queued-but-unpumped async tickets
    count."""
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    svc = SolverService(FakeClock(), backend="device", batch=True,
                        inflight_cap=2, device="cpu")
    client = svc.register("a", CatalogProvider(lambda: types))
    pods = port_object(_tenant_pods(random.Random(1), "a", 4, 2, False))
    t1 = client.solve_async(pods, pool)
    t2 = client.solve_async(pods, pool)
    with pytest.raises(SolverServiceBusy):
        client.solve_async(pods, pool)
    svc.pump()
    assert t1.result().launches and t2.result().launches
    with pytest.raises(SolverServiceBusy):
        client.solve_async(pods, pool)
    svc.clock.step(svc.window + 1)
    assert client.solve(pods, pool).launches


def test_tenant_targeted_fault_spares_cobatched_neighbors():
    """The fault seam is probed under EACH bucket tenant's scope: an
    injected fault targeting tenant b aborts the shared call, but only b's
    facade degrades; a's serial re-run keeps the device path."""
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    svc = SolverService(FakeClock(), backend="device", batch=True,
                        device="cpu")
    a = svc.register("a", CatalogProvider(lambda: types))
    b = svc.register("b", CatalogProvider(lambda: types))

    def hook(backend):
        if current_tenant() == "b":
            raise InjectedFault("injected: tenant b's device is gone")

    port_solver.set_dispatch_fault_hook(hook)
    ta = a.solve_async(port_object(_tenant_pods(random.Random(3), "a", 5, 2,
                                                False)), pool)
    tb = b.solve_async(port_object(_tenant_pods(random.Random(4), "b", 5, 2,
                                                False)), pool)
    svc.pump()
    assert ta.result().launches and tb.result().launches
    assert a.facade.stats["device_fallbacks"] == 0
    assert b.facade.stats["device_fallbacks"] == 1


def test_sync_solve_through_batched_pump_matches_serial_pump():
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    pods = port_object(_tenant_pods(random.Random(5), "x", 10, 5, True))
    serial = SolverService(FakeClock(), backend="device", device="cpu") \
        .register("x", CatalogProvider(lambda: types)).solve(pods, pool)
    batched = SolverService(FakeClock(), backend="device", batch=True,
                            device="cpu") \
        .register("x", CatalogProvider(lambda: types)).solve(pods, pool)
    assert out_tuple(serial) == out_tuple(batched)


# --- the port's fault contract (ROADMAP §3) --------------------------------


def _two_bucket_fleet():
    """Tenants a, b in one shape class and c, d in another (more groups):
    two buckets in one pump."""
    rng = random.Random(11)
    return _port_rows(
        [(n, _tenant_pods(rng, n, 8, 3, False), False) for n in ("a", "b")]
        + [(n, _tenant_pods(rng, n, 24, 12, False), False)
           for n in ("c", "d")])


def test_injected_fault_degrades_only_its_bucket():
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    rows = _two_bucket_fleet()
    clean, clean_svc = _batched(rows, types, pool)
    assert clean_svc.stats["batches"] == 2

    fb = {t: FLEET_SHAPE_CLASS.value(event="fault_fallback", tenant=t)
          for t in "abcd"}

    def hook(backend):
        if current_tenant() == "a":
            raise InjectedFault("injected: tenant a's device is gone")

    port_solver.set_dispatch_fault_hook(hook)
    svc = SolverService(FakeClock(), backend="device", batch=True,
                        device="cpu")
    clients = _register(svc, rows, types, CatalogProvider)
    tickets = {n: clients[n].solve_async(p, pool) for n, p, _ in rows}
    svc.pump()
    out = {n: t.result() for n, t in tickets.items()}
    _assert_identical(clean, out, "fault")
    for t in "ab":
        assert FLEET_SHAPE_CLASS.value(event="fault_fallback",
                                       tenant=t) == fb[t] + 1
        assert tickets[t].batch_size == 1
    for t in "cd":
        assert FLEET_SHAPE_CLASS.value(event="fault_fallback",
                                       tenant=t) == fb[t]
        assert tickets[t].batch_size == 2
    assert clients["a"].facade.stats["device_fallbacks"] == 1
    assert clients["b"].facade.stats["device_fallbacks"] == 0
    assert svc.stats["batches"] == 1


def test_readback_error_raises_out_of_pump(monkeypatch):
    """A real device error surfaces at block(): unlike the reference, which
    re-runs the batch through its facades, the port raises it out of
    pump() (the reference's test_block_failure_degrades_only_that_batch
    pins the opposite). Every ticket the pump took carries that error: the
    bucket being drained and the one already dispatched behind it."""
    def boom(self):
        raise RuntimeError("device lost at readback")

    monkeypatch.setattr(InFlightBatch, "block", boom)
    dispatched = []
    dispatch = port_solver.dispatch_batch

    def counted(reqs, mesh=None):
        dispatched.append(len(reqs))
        return dispatch(reqs, mesh)

    monkeypatch.setattr(port_solver, "dispatch_batch", counted)
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    svc = SolverService(FakeClock(), backend="device", batch=True,
                        device="cpu")
    names = ("a", "b", "c")
    clients = {t: svc.register(t, CatalogProvider(lambda: types))
               for t in names}
    fb = {t: FLEET_SHAPE_CLASS.value(event="fault_fallback", tenant=t)
          for t in names}
    # a and b share one shape class; c's 12 pod signatures take another,
    # so c rides a second bucket, dispatched before the first one drains
    tickets = {t: clients[t].solve_async(port_object(_tenant_pods(
        random.Random(i + 1), t, 24 if t == "c" else 5,
        12 if t == "c" else 2, False)), pool)
        for i, t in enumerate(names)}
    with pytest.raises(RuntimeError, match="device lost at readback"):
        svc.pump()
    assert dispatched == [2, 1]
    for t in names:
        assert tickets[t].done
        with pytest.raises(RuntimeError, match="device lost at readback"):
            tickets[t].result()
        assert FLEET_SHAPE_CLASS.value(event="fault_fallback",
                                       tenant=t) == fb[t]
        assert clients[t].facade.stats["device_fallbacks"] == 0
        assert svc.tenants[t].solves == 1
    assert svc.pipeline_state()["inflight_age"] is None
    assert svc.stats["batches"] == 0


def test_dispatch_error_raises_out_of_pump(monkeypatch):
    """A kernel's launch error at dispatch raises out of pump() too."""
    def refuse(reqs, mesh=None):
        raise RuntimeError("solve_scan launch failed: cudaError 1")

    monkeypatch.setattr(port_solver, "dispatch_batch", refuse)
    types = port_object(small_catalog())
    pool = port_object(NodePool(name="default"))
    svc = SolverService(FakeClock(), backend="device", batch=True,
                        device="cpu")
    a = svc.register("a", CatalogProvider(lambda: types))
    a.solve_async(port_object(_tenant_pods(random.Random(1), "a", 5, 2,
                                           False)), pool)
    with pytest.raises(RuntimeError, match="launch failed"):
        svc.pump()
    assert a.facade.stats["device_fallbacks"] == 0


# --- tests/test_fleet.py's SolverService cases through the port -----------


def mk_pods(n, prefix="p", cpu="500m", mem="1Gi"):
    return port_object([Pod(name=f"{prefix}-{i}", requests=Resources.parse(
        {"cpu": cpu, "memory": mem})) for i in range(n)])


def mk_service(**kw):
    kw.setdefault("backend", "host")
    if kw["backend"] == "device":
        kw.setdefault("device", "cpu")
    return SolverService(FakeClock(), **kw)


@pytest.fixture
def ptypes():
    return port_object(small_catalog())


@pytest.fixture
def pool():
    return port_object(NodePool(name="default"))


class TestSolverService:
    def test_client_solve_round_trips_through_queue(self, ptypes, pool):
        svc = mk_service()
        client = svc.register("a", CatalogProvider(lambda: ptypes))
        out = client.solve(mk_pods(4), pool)
        assert out.launches and not out.unschedulable
        assert svc.stats["dispatched"] == 1
        assert svc.tenants["a"].solves == 1

    def test_client_delegates_facade_surface(self, ptypes, pool):
        """The reference's case also calls warm_catalog, which comes with
        ROADMAP §1 item 9; the delegation itself is the same."""
        svc = mk_service()
        client = svc.register("a", CatalogProvider(lambda: ptypes))
        cat = client.tensors()
        assert cat.T > 0
        assert client.stats["catalog_rebuilds"] >= 1
        prep = client.prepare_solve(mk_pods(3), pool)
        assert prep.backend == "host"
        assert client.stage_batchable(prep) is None  # not the device rung

    def test_duplicate_registration_rejected(self, ptypes):
        svc = mk_service()
        svc.register("a", CatalogProvider(lambda: ptypes))
        with pytest.raises(ValueError):
            svc.register("a", CatalogProvider(lambda: ptypes))

    def test_inflight_cap_throttles_with_retryable_error(self, ptypes, pool):
        svc = mk_service(inflight_cap=2)
        client = svc.register("a", CatalogProvider(lambda: ptypes))
        before = FLEET_THROTTLED.value(tenant="a")
        client.solve(mk_pods(2, "x"), pool)
        client.solve(mk_pods(2, "y"), pool)
        with pytest.raises(SolverServiceBusy) as ei:
            client.solve(mk_pods(2, "z"), pool)
        assert ei.value.retryable
        assert FLEET_THROTTLED.value(tenant="a") == before + 1
        other = svc.register("b", CatalogProvider(
            lambda: port_object(small_catalog())))
        assert other.solve(mk_pods(2, "w"), pool).launches

    def test_cap_resets_when_the_window_rolls(self, ptypes, pool):
        svc = mk_service(inflight_cap=1, window=5.0)
        client = svc.register("a", CatalogProvider(lambda: ptypes))
        client.solve(mk_pods(2, "x"), pool)
        with pytest.raises(SolverServiceBusy):
            client.solve(mk_pods(2, "y"), pool)
        svc.clock.step(6.0)
        assert client.solve(mk_pods(2, "z"), pool).launches

    def test_shared_catalog_across_tenants(self, ptypes):
        svc = mk_service()
        a = svc.register("a", CatalogProvider(lambda: ptypes))
        b = svc.register("b", CatalogProvider(lambda: list(ptypes)))
        ca, cb = a.tensors(), b.tensors()
        assert ca is cb
        assert ca.cache_token[0] == "shared"
        assert svc.shared_catalog.stats == {"hits": 1, "misses": 1}

    def test_ice_divergence_splits_shared_views(self, ptypes):
        svc = mk_service()
        a = svc.register("a", CatalogProvider(lambda: ptypes))
        b = svc.register("b", CatalogProvider(lambda: list(ptypes)))
        shared = a.tensors()
        assert b.tensors() is shared
        a.catalog.unavailable.mark_unavailable("c5.large", "zone-a",
                                               "spot", reason="test")
        ca2 = a.tensors()
        assert ca2 is not shared
        assert not ca2.available[ca2.name_to_idx["c5.large"], 0, :].all()
        assert b.tensors() is shared

    def test_solve_error_propagates_through_future(self, ptypes):
        svc = mk_service()

        def thunk():
            raise RuntimeError("boom")
        svc.register("a", CatalogProvider(lambda: ptypes))
        with pytest.raises(RuntimeError):
            svc.call("a", "solve", thunk, cost=0.001)
        assert not svc._queue


class TestFairScheduling:
    def _submit_jobs(self, svc, plan):
        tickets = [svc.submit(tenant, "solve", lambda: None, cost=cost)
                   for tenant, cost in plan]
        svc.pump()
        return tickets

    def test_light_tenant_waits_bounded_behind_storm(self, ptypes):
        svc = mk_service(quantum=0.005)
        svc.register("noisy", CatalogProvider(lambda: ptypes))
        svc.register("victim", CatalogProvider(lambda: ptypes))
        plan = [("noisy", 0.004)] * 10 + [("victim", 0.002)]
        tickets = self._submit_jobs(svc, plan)
        victim = tickets[-1]
        assert victim.wait < 0.010, victim.wait
        assert max(t.wait for t in tickets[:10]) > victim.wait

    def test_waits_are_deterministic(self, ptypes):
        def run():
            svc = mk_service(quantum=0.005)
            svc.register("a", CatalogProvider(lambda: ptypes))
            svc.register("b", CatalogProvider(lambda: ptypes))
            plan = [("a", 0.004)] * 6 + [("b", 0.002)] * 2 + [("a", 0.003)]
            return [round(t.wait, 9) for t in self._submit_jobs(svc, plan)]
        assert run() == run()

    def test_waits_equal_the_reference(self):
        """The DRR replay's virtual waits, ticket for ticket."""
        plan = [("a", 0.004)] * 6 + [("b", 0.002)] * 2 + [("a", 0.003)]

        def run(svc, provider):
            for t in ("a", "b"):
                svc.register(t, provider(lambda: []))
            tickets = [svc.submit(t, "solve", lambda: None, cost=c)
                       for t, c in plan]
            svc.pump()
            return [t.wait for t in tickets]
        assert run(mk_service(quantum=0.005), CatalogProvider) == run(
            RefService(RefClock(), backend="host", quantum=0.005),
            RefProvider)


class TestBatchedDispatch:
    def _svc(self, **kw):
        kw.setdefault("backend", "device")
        kw.setdefault("batch", True)
        return mk_service(**kw)

    def test_compatible_tenants_share_one_device_call(self, ptypes, pool):
        svc = self._svc()
        clients = [svc.register(f"t{i}", CatalogProvider(lambda: ptypes))
                   for i in range(4)]
        tickets = [c.solve_async(mk_pods(6, f"p{i}"), pool)
                   for i, c in enumerate(clients)]
        svc.pump()
        for t in tickets:
            assert t.result().launches
            assert t.batch_size == 4
            assert t.shape_class.startswith("g")
        assert svc.stats["batches"] == 1
        assert svc.stats["batched_tickets"] == 4
        cs = svc.class_stats[tickets[0].shape_class]
        assert cs["cobatched_pumps"] == 1 and cs["copending_pumps"] == 1

    def test_odd_shape_tenant_rides_its_rank_not_the_back(self, ptypes,
                                                          pool):
        svc = self._svc()
        big = [svc.register(f"b{i}", CatalogProvider(lambda: ptypes))
               for i in range(3)]
        odd = svc.register("odd", CatalogProvider(lambda: ptypes))
        odd_pods = port_object([Pod(name=f"o{i}", requests=Resources.parse(
            {"cpu": f"{100 + 50 * i}m", "memory": f"{256 + 64 * i}Mi"}))
            for i in range(10)])
        t0 = big[0].solve_async(mk_pods(6, "b0"), pool)
        t_odd = odd.solve_async(odd_pods, pool)
        t1 = big[1].solve_async(mk_pods(6, "b1"), pool)
        t2 = big[2].solve_async(mk_pods(6, "b2"), pool)
        svc.pump()
        assert t_odd.result().launches
        assert t_odd.dispatch_rank == 1
        assert t_odd.batch_size == 1
        for t in (t0, t1, t2):
            assert t.result().launches
            assert t.batch_size == 3
        assert svc.stats["batches"] == 2

    def test_device_fault_mid_batch_degrades_only_that_batch(self, ptypes,
                                                             pool):
        """The reference's case with the port's fault: the hook raises
        InjectedFault (the port degrades on nothing else)."""
        svc = self._svc()
        a = svc.register("a", CatalogProvider(lambda: ptypes))
        b = svc.register("b", CatalogProvider(lambda: ptypes))
        c = svc.register("c", CatalogProvider(lambda: ptypes))
        armed = {"on": True}

        def hook(backend):
            if armed["on"]:
                raise InjectedFault("injected device loss")

        port_solver.set_dispatch_fault_hook(hook)

        def fb(t):
            return FLEET_SHAPE_CLASS.value(event="fault_fallback", tenant=t)

        def solo(t):
            return FLEET_SHAPE_CLASS.value(event="solo", tenant=t)
        fb_a0, fb_b0, solo_c0 = fb("a"), fb("b"), solo("c")
        ta = a.solve_async(mk_pods(4, "a"), pool)
        tb = b.solve_async(mk_pods(4, "b"), pool)
        svc.pump()
        assert ta.result().launches and tb.result().launches
        assert fb("a") == fb_a0 + 1
        assert fb("b") == fb_b0 + 1
        assert a.facade.stats["device_fallbacks"] == 1
        assert b.facade.stats["device_fallbacks"] == 1
        armed["on"] = False
        tc = c.solve_async(mk_pods(4, "c"), pool)
        svc.pump()
        assert tc.result().launches
        assert tc.batch_size == 1
        assert solo("c") == solo_c0 + 1
        assert c.facade.stats["device_fallbacks"] == 0
        ta2 = a.solve_async(mk_pods(4, "a2"), pool)
        svc.pump()
        assert ta2.result().launches
        assert FLEET_SHAPE_CLASS.value(event="serial", tenant="a") >= 1

    def test_debug_fleet_reports_pipeline_state(self, ptypes, pool):
        svc = self._svc()
        client = svc.register("a", CatalogProvider(lambda: ptypes))
        client.solve(mk_pods(4, "x"), pool)
        payload = svc.debug_payload()
        assert payload["batch"]["armed"] is True
        assert payload["batch"]["inflight_age"] is None
        assert payload["batch"]["classes"]
        assert 0.0 <= payload["batch"]["overlap_ratio"] <= 1.0
        assert payload["tenants"]["a"]["solves"] == 1
        assert payload["inflight_cap"] == svc.inflight_cap


# --- the port's own rules: the card unless device=, no mesh --------------


def test_fleet_entry_points_need_a_card_or_a_device():
    """Without a card and without device=, a device-rung service's tenant
    facade and prepare_batchable raise, as solve_device does; a mesh is
    not ported; the batched scan takes the plain version only for CPU
    tensors."""
    import torch
    from karpenter_tpu_torch.ops import solve_scan as ss
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    types = port_object(small_catalog())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverService(FakeClock(), backend="device").register(
            "a", CatalogProvider(lambda: types))
    cat, encs = _bucket_case("plain")
    pcat = convert.catalog_from_arrays(vars(cat))
    penc = convert.pods_from_arrays(
        {k: v for k, v in vars(encs[0]).items() if k != "groups"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_solver.prepare_batchable(pcat, penc)
    req = port_solver.prepare_batchable(pcat, penc, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        port_solver.dispatch_batch([req], mesh=object())
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ss.solve_scan_batched(meta)
