"""The port's delta plane (`karpenter_tpu_torch/ops/delta.py`) held against
the JAX reference's: every case of the reference's `tests/test_delta.py`
runs through both packages.

- The serve/verify protocol and the invalidation ladder: each case drives
  a `DeltaPlane` of each package through the same calls and returns what
  it observed (serve results, stats, snapshots, stale lists, the
  invalidation meter's deltas); the two records must be equal, exactly,
  and the reference's own assertions hold on each.
- The facade byte-parity fuzz: the same seeded schedule of solves through
  the reference's `Solver(backend="device")` (JAX-CPU) and the port's
  (`device="cpu"`), armed and forced cold. Every SolveOutput digest is
  equal across packages and across armed/cold, and the plane's outcomes
  (serves, misses, stores, confirms, divergences, invalidations) are equal
  across packages.
- The controllers, the chaos `smoke` scenario and `fleet_smoke` with the
  memos armed: the same end hashes in both packages, armed and cold.
- The fleet's stable batch-composition key.

Every module resets both packages' planes (memo keys hold id(facade)).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import random
import types as _t

import pytest

from karpenter_tpu.catalog import CatalogProvider as RefProvider
from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.catalog.generator import small_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.models import labels as L
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.nodepool import NodePool
from karpenter_tpu.models.pod import (Pod, PodAffinityTerm,
                                      TopologySpreadConstraint)
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import delta as ref_delta
from karpenter_tpu.ops.encode import encode_catalog
from karpenter_tpu.ops.facade import Solver as RefSolver

from karpenter_tpu_torch.catalog import CatalogProvider as PortProvider
from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.convert import port_object
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.ops import delta as port_delta
from karpenter_tpu_torch.ops.facade import Solver as PortSolver

POOL = NodePool(name="default")
PACKAGES = {"ref": ref_delta, "port": port_delta}


def _planes():
    from karpenter_tpu.ops.resident import RESIDENT as REF_RESIDENT
    from karpenter_tpu_torch.ops.resident import RESIDENT as PORT_RESIDENT
    return (ref_delta.DELTA, port_delta.DELTA, REF_RESIDENT, PORT_RESIDENT)


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_as_found():
    """Both resource axes get the same columns; afterwards the reference
    gets its sequences back and its intern table, resident state, delta
    memos and integrity meter reset (ROADMAP §3's test-order hazard)."""
    saved = (ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids)
    encode_catalog(generate_catalog())
    for name in port_res.resource_axis():
        ref_res.register_resource(name)
    for name in ref_res.resource_axis():
        port_res.register_resource(name)
    yield
    ref_nodeclaim._seq, ref_pod._uid, ref_fake._ids = saved
    from karpenter_tpu.integrity import INTEGRITY
    ref_pod._sig_intern.clear()
    for plane in _planes():
        plane.reset()
    INTEGRITY.reset()


@pytest.fixture(autouse=True)
def _fresh_planes():
    """The planes are process-global: isolate every test's memo set."""
    for plane in _planes():
        plane.reset()
    yield
    for plane in _planes():
        plane.reset()


def _reset_sequences() -> None:
    for nodeclaim, pod, fake in ((ref_nodeclaim, ref_pod, ref_fake),
                                 (port_nodeclaim, port_pod, port_fake)):
        nodeclaim._seq = itertools.count()
        pod._uid = itertools.count()
        fake._ids = itertools.count(1)
    for plane in _planes():
        plane.reset()


def _both(case, monkeypatch):
    """Run one protocol case through each package's delta module (with
    the environment it set undone in between); the records must match."""
    records = {}
    for name, D in PACKAGES.items():
        with monkeypatch.context() as m:
            records[name] = case(D, m)
    assert records["port"] == records["ref"]
    return records["port"]


# --- the serve/verify protocol ---------------------------------------------


def _miss_store_serve(D, m):
    p = D.DeltaPlane()
    out = [p.serve("solve", ("k",), 1)]
    assert out[0] is None                                   # cold miss
    out.append(p.store("solve", ("k",), 1, "payload", check_fp=9))
    out.append(p.serve("solve", ("k",), 1))
    assert out[-1] == ("payload", False)
    assert p.stats["serves"] == 1 and p.stats["misses"] == 1
    return out + [dict(p.stats)]


def _changed_fingerprint(D, m):
    p = D.DeltaPlane()
    p.store("spread", ("k",), 1, "old")
    out = [p.serve("spread", ("k",), 2)]
    assert out[0] is None
    p.store("spread", ("k",), 2, "new")
    out.append(p.serve("spread", ("k",), 2))
    assert out[-1][0] == "new"
    return out + [p.snapshot()]


def _audit_cadence(D, m):
    m.setenv("KARPENTER_TPU_DELTA_AUDIT", "3")
    p = D.DeltaPlane()
    p.store("affinity", ("k",), 5, "desc", check_fp=7)
    out = [p.serve("affinity", ("k",), 5) for _ in range(3)]
    assert all(a is False for _, a in out)
    out.append(p.serve("affinity", ("k",), 5))
    assert out[-1] == ("desc", True)          # recompute, don't use
    p.confirm("affinity", ("k",), 5, value="desc2", check_fp=7)
    out.append(p.serve("affinity", ("k",), 5))
    assert out[-1] == ("desc2", False)
    assert p.stats["audits_due"] == 1 and p.stats["confirms"] == 1
    return out + [dict(p.stats)]


def _audit_zero(D, m):
    m.setenv("KARPENTER_TPU_DELTA_AUDIT", "0")
    p = D.DeltaPlane()
    p.store("solve", ("k",), 1, "v")
    out = p.serve("solve", ("k",), 1)
    assert out[1] is True and p.stats["serves"] == 0
    return [out, dict(p.stats)]


def _disarmed(D, m):
    m.setenv("KARPENTER_TPU_DELTA", "0")
    p = D.DeltaPlane()
    out = [p.store("solve", ("k",), 1, "v"), p.serve("solve", ("k",), 1),
           p.entries()]
    assert out == [False, None, 0]
    return out + [p.snapshot()]


def _stale(D, m):
    m.setenv("KARPENTER_TPU_DELTA_AUDIT", "2")
    p = D.DeltaPlane()
    p.store("optimizer", ("pool-a",), 1, True)
    p.serve("optimizer", ("pool-a",), 1)
    out = [p.stale()]
    p.serve("optimizer", ("pool-a",), 1)
    out.append(p.stale())
    p.confirm("optimizer", ("pool-a",), 1)
    out.append(p.stale())
    assert out == [[], [("optimizer", ("pool-a",), 2)], []]
    return out


def _snapshot_route(D, m):
    import importlib
    render = importlib.import_module(
        D.__name__.split(".")[0] + ".obs.exposition").render
    p = D.DeltaPlane()
    p.store("solve", ("k",), 1, "v")
    snap = p.snapshot()
    assert snap["entries"] == 1 and snap["per_stage"] == {"solve": 1}
    assert snap["domains"] == list(D.DOMAINS)
    assert snap["reasons"] == list(D.INVALIDATION_REASONS)
    status, ctype, body = render("/debug/delta")
    assert status == 200 and "json" in ctype
    doc = json.loads(body)
    assert doc["armed"] is True and doc["domains"] == list(D.DOMAINS)
    return [snap, status, ctype, doc]


@pytest.mark.parametrize("case", [
    _miss_store_serve, _changed_fingerprint, _audit_cadence, _audit_zero,
    _disarmed, _stale, _snapshot_route], ids=lambda c: c.__name__[1:])
def test_protocol_equals_the_reference(case, monkeypatch):
    _both(case, monkeypatch)


def test_constants_equal_the_reference():
    for name in ("DOMAINS", "INVALIDATION_REASONS", "AUDIT_EVERY",
                 "COOLDOWN", "MAX_ENTRIES"):
        assert getattr(port_delta, name) == getattr(ref_delta, name), name
    assert (port_delta.AUDIT_EVERY, port_delta.COOLDOWN,
            port_delta.MAX_ENTRIES) == (16, 8, 1024)


# --- the invalidation ladder ------------------------------------------------
INVALIDATION_CASES = [
    "divergence", "epoch", "quarantine", "capacity", "disarm",
]


def _metric(D):
    import importlib
    return importlib.import_module(
        D.__name__.split(".")[0] + ".metrics").DELTA_INVALIDATIONS


def _divergence(D, m):
    p = D.DeltaPlane()
    p.store("solve", ("k",), 1, "wrong")
    p.diverge("solve", ("k",))
    out = [p.serve("solve", ("k",), 1)]
    assert out[0] is None
    assert p.snapshot()["invalidations"]["solve"]["divergence"] == 1
    out += [p.store("solve", ("k",), 1, f"retry-{i}")
            for i in range(D.COOLDOWN)]
    assert not any(out[1:]) and p.stats["declined"] == D.COOLDOWN
    out.append(p.store("solve", ("k",), 1, "after-cooldown"))
    out.append(p.serve("solve", ("k",), 1))
    assert out[-1][0] == "after-cooldown"
    return out + [p.snapshot()]


def _epoch(D, m):
    p = D.DeltaPlane()
    p.store("affinity", ("k",), 1, "old")
    p.store("affinity", ("k",), 2, "new")
    assert p.snapshot()["invalidations"]["affinity"]["epoch"] == 1
    return [p.snapshot()]


def _quarantine(D, m):
    p = D.DeltaPlane()
    p.store("solve", ("facade", 1, "np-a"), 1, "a")
    p.store("solve", ("facade", 2, "np-b"), 1, "b")
    out = [p.invalidate(("solve", "facade", 1), reason="quarantine"),
           p.serve("solve", ("facade", 1, "np-a"), 1),
           p.serve("solve", ("facade", 2, "np-b"), 1)]
    assert out[0] == 1 and out[1] is None and out[2][0] == "b"
    assert p.snapshot()["invalidations"]["solve"]["quarantine"] == 1
    return out + [p.snapshot()]


def _capacity(D, m):
    p = D.DeltaPlane(max_entries=2)
    p.store("solve", ("a",), 1, "a")
    p.store("spread", ("b",), 1, "b")
    p.serve("solve", ("a",), 1)              # touch: a is now MRU
    p.store("optimizer", ("c",), 1, "c")     # evicts b (LRU)
    out = [p.serve("spread", ("b",), 1), p.serve("solve", ("a",), 1)]
    assert out[0] is None and out[1][0] == "a"
    assert p.snapshot()["invalidations"]["spread"]["capacity"] == 1
    return out + [p.snapshot()]


def _disarm(D, m):
    metric = _metric(D)
    p = D.DeltaPlane()
    for st in D.DOMAINS:
        p.store(st, ("k",), 1, st)
    v0 = metric.value(stage="solve", reason="disarm")
    out = [p.invalidate((), reason="disarm"), p.entries(),
           metric.value(stage="solve", reason="disarm") - v0]
    assert out == [len(D.DOMAINS), 0, 1]
    return out + [p.snapshot()]


def _unknown_reason(D, m):
    p = D.DeltaPlane()
    with pytest.raises(AssertionError):
        p.invalidate((), reason="because")
    return [p.snapshot()]


def test_table_covers_ladder_exactly():
    assert INVALIDATION_CASES == list(port_delta.INVALIDATION_REASONS) \
        == list(ref_delta.INVALIDATION_REASONS)


@pytest.mark.parametrize("case", [
    _divergence, _epoch, _quarantine, _capacity, _disarm, _unknown_reason],
    ids=lambda c: c.__name__[1:])
def test_invalidation_ladder_equals_the_reference(case, monkeypatch):
    _both(case, monkeypatch)


# --- facade byte-parity fuzz, both packages ---------------------------------

_CPUS = ["100m", "250m", "500m", "1"]
_MEMS = ["128Mi", "512Mi", "1Gi"]


def _mk_pods(n, manifests, gen, spread, anti):
    """Content is a function of (n, manifests, spread, anti) only — `gen`
    moves pod NAMES, modelling same-shape churn (the reference's test)."""
    pods = []
    for i in range(n):
        s = i % manifests
        kw = dict(requests=Resources.parse(
            {"cpu": _CPUS[s % len(_CPUS)], "memory": _MEMS[s % len(_MEMS)]}),
            labels={"app": f"m{s}"})
        if spread and s % 3 == 0:
            kw["topology_spread"] = [TopologySpreadConstraint(
                topology_key=L.ZONE, max_skew=1)]
        if anti and s % 4 == 1:
            kw["affinity_terms"] = [PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": f"m{s}"}, anti=True)]
        pods.append(Pod(name=f"dp-{gen}-{i}", **kw))
    return pods


def _digest(out):
    """Canonical, order-free content digest of a SolveOutput."""
    return (
        tuple(sorted(
            (l.instance_type, l.zone, l.capacity_type, round(l.price, 6),
             tuple(sorted(l.pod_keys)),
             tuple((o[0], o[1], o[2], round(o[3], 6))
                   for o in l.overrides))
            for l in out.launches)),
        tuple(sorted((k, tuple(sorted(v)))
                     for k, v in out.existing_placements.items())),
        tuple(sorted(out.unschedulable)),
    )


def _drive_rounds(side, seed):
    """One seeded mutation schedule through one package's device-rung
    facade: blocks of same-content rounds (churned names — the served
    steady state) separated by content changes. Returns the digests."""
    rng = random.Random(seed)
    types = small_catalog()
    if side == "ref":
        f = RefSolver(RefProvider(lambda: types), backend="device")
        conv, pool = (lambda x: x), POOL
    else:
        ptypes = port_object(types)
        f = PortSolver(PortProvider(lambda: ptypes), backend="device",
                       device="cpu")
        conv, pool = port_object, port_object(POOL)
    digests = []
    gen = 0
    for _block in range(3):
        n = rng.randint(6, 14)
        manifests = rng.randint(2, 4)
        spread = rng.random() < 0.7
        anti = rng.random() < 0.7
        for _rep in range(3):
            gen += 1
            out = f.solve(conv(_mk_pods(n, manifests, gen, spread, anti)),
                          pool)
            digests.append(_digest(out))
    return digests


_OUTCOMES = ("serves", "misses", "stores", "confirms", "divergences",
             "audits_due", "declined")


def _plane_record(D):
    snap = D.DELTA.snapshot()
    return ({k: snap[k] for k in _OUTCOMES}, snap["per_stage"],
            snap["invalidations"], snap["entries"])


def _armed_and_cold(seed, monkeypatch, audit=None):
    """(cold digests, armed digests, armed plane record) of each
    package."""
    out = {}
    for side, D in PACKAGES.items():
        monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
        D.DELTA.reset()
        cold = _drive_rounds(side, seed)
        monkeypatch.setenv("KARPENTER_TPU_DELTA", "1")
        if audit is not None:
            monkeypatch.setenv("KARPENTER_TPU_DELTA_AUDIT", audit)
        D.DELTA.reset()
        warm = _drive_rounds(side, seed)
        out[side] = (cold, warm, _plane_record(D))
        monkeypatch.delenv("KARPENTER_TPU_DELTA_AUDIT", raising=False)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_served_equals_forced_cold(seed, monkeypatch):
    """With the memos armed every solve's output equals the forced-cold
    run's, in both packages, and the two packages' outputs and memo
    outcomes are equal (the armed run really served)."""
    got = _armed_and_cold(seed, monkeypatch)
    ref, port = got["ref"], got["port"]
    assert port[0] == port[1] == ref[0] == ref[1]
    assert port[2] == ref[2]
    assert port[2][0]["serves"] >= 2 and port[2][0]["divergences"] == 0


@pytest.mark.parametrize("seed", [0, 3])
def test_audit_every_pass_still_byte_identical(seed, monkeypatch):
    """KARPENTER_TPU_DELTA_AUDIT=1 audits every other serve: each fresh
    recompute confirms the stored output, with the reference's counts."""
    got = _armed_and_cold(seed, monkeypatch, audit="1")
    ref, port = got["ref"], got["port"]
    assert port[0] == port[1] == ref[0] == ref[1]
    assert port[2] == ref[2]
    assert port[2][0]["confirms"] >= 1 and port[2][0]["divergences"] == 0


# --- controller parity: optimizer + the full reconcile ----------------------


def _drive_sim(side, seed, rounds=3, quiet=3):
    """The reference's miniature c16 regime through one package's
    device-rung make_sim: a standing anti-affinity fleet + churnable
    residents, settled, then churned reconciles and quiet disruption
    passes. Returns the end-of-run state hash."""
    if side == "ref":
        from karpenter_tpu.faults.runner import state_hash
        from karpenter_tpu.sim import make_sim
        conv, kw = (lambda x: x), {}
        cfg = ref_fake.FakeCloudConfig
    else:
        from karpenter_tpu_torch.faults.runner import state_hash
        from karpenter_tpu_torch.sim import make_sim
        conv, kw = port_object, {"device": "cpu"}
        cfg = port_fake.FakeCloudConfig
    rng = random.Random(seed)
    sim = make_sim(backend="device", cloud_config=cfg(
        node_ready_delay=1.0, register_delay=0.5,
        create_fleet_rate=1e6, create_fleet_burst=10**6), **kw)
    for i in range(8):
        sim.store.add_pod(conv(Pod(
            name=f"standing-{i}", labels={"app": "standing"},
            requests=Resources.parse({"cpu": "500m", "memory": "512Mi"}),
            affinity_terms=[PodAffinityTerm(
                topology_key="kubernetes.io/hostname",
                label_selector={"app": "standing"}, anti=True)])))
    n = 40
    live = conv(_mk_pods(n, 4, 0, True, False))
    for p in live:
        sim.store.add_pod(p)
    assert sim.engine.run_until(
        lambda: all(p.node_name for p in sim.store.pods.values()),
        timeout=600.0, step=1.0)
    churn = max(2, n // 10)
    for rnd in range(1, rounds + 1):
        k = rng.randint(1, churn)
        for p in live[:k]:
            sim.store.delete_pod(p.namespace, p.name)
        fresh = conv(_mk_pods(k, 4, rnd, True, False))
        for p in fresh:
            sim.store.add_pod(p)
        live = live[k:] + fresh
        sim.provisioner.reconcile(sim.clock.now())
        sim.disruption.reconcile(sim.clock.now())
    for _ in range(quiet):
        sim.disruption.reconcile(sim.clock.now())
    return state_hash(sim)


@pytest.mark.parametrize("seed", [0, 7])
def test_full_reconcile_state_hash_parity(seed, monkeypatch):
    """Armed and disarmed through the real controllers (provisioner,
    disruption with the optimizer's fruitless-search memo): one end
    state in both packages, and the same memo outcomes; the solve memo
    engages on the existing-node reconciles."""
    got = {}
    for side, D in PACKAGES.items():
        monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
        _reset_sequences()
        cold = _drive_sim(side, seed)
        monkeypatch.setenv("KARPENTER_TPU_DELTA", "1")
        _reset_sequences()
        warm = _drive_sim(side, seed)
        got[side] = (cold, warm, _plane_record(D))
    ref, port = got["ref"], got["port"]
    assert port[0] == port[1] == ref[0] == ref[1]
    assert port[2] == ref[2]
    assert port[2][0]["serves"] >= 1 and port[2][0]["divergences"] == 0
    assert port[2][1].get("solve", 0) >= 1


# --- chaos digest parity (memo armed) ---------------------------------------


def test_smoke_repeat_digest_equality_with_memo_armed(monkeypatch):
    """`smoke` twice with the memos armed (the second run's plane still
    holds the first run's entries) and once forced cold: the three end
    hashes are one, and the reference's."""
    from karpenter_tpu.faults import ScenarioRunner as RefRunner
    from karpenter_tpu_torch.faults import SCENARIOS, ScenarioRunner
    sc = dataclasses.replace(SCENARIOS["smoke"], backend="device")
    _reset_sequences()
    want = RefRunner("smoke", seed=3).run()
    _reset_sequences()
    a = ScenarioRunner(sc, seed=3, device="cpu").run()
    b = ScenarioRunner(sc, seed=3, device="cpu").run()
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    c = ScenarioRunner(sc, seed=3, device="cpu").run()
    assert want.ok and a.ok and b.ok and c.ok
    assert a.end_hash == b.end_hash == c.end_hash == want.end_hash


def test_fleet_smoke_repeat_digest_equality_with_memo_armed(monkeypatch):
    """The same contract for the fleet pump (bucketed batched dispatch and
    the stable batch-composition residency)."""
    from karpenter_tpu.fleet import FleetRunner as RefRunner
    from karpenter_tpu_torch.fleet import FleetRunner
    _reset_sequences()
    want = RefRunner("fleet_smoke", tenants=4, seed=0, backend="device",
                     batch=True).run()
    _reset_sequences()
    a = FleetRunner("fleet_smoke", tenants=4, seed=0, backend="device",
                    batch=True, device="cpu").run()
    b = FleetRunner("fleet_smoke", tenants=4, seed=0, backend="device",
                    batch=True, device="cpu").run()
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    c = FleetRunner("fleet_smoke", tenants=4, seed=0, backend="device",
                    batch=True, device="cpu").run()
    assert want.ok and a.ok and b.ok and c.ok
    assert a.fleet_hash == b.fleet_hash == c.fleet_hash == want.fleet_hash
    assert a.tenant_hashes == b.tenant_hashes == want.tenant_hashes


# --- the stable batch-composition contract ----------------------------------


def _bucket_keys(SolverService, FakeClock):
    svc = SolverService(FakeClock())

    def entry(tenant, mk):
        return {"ticket": _t.SimpleNamespace(tenant=tenant),
                "batchable": _t.SimpleNamespace(
                    signature=("sig", 8), meter_key=mk,
                    shape_class="small")}

    keys = [svc._bucket_resident_key([entry("a", 1), entry("b", 2)])
            for _ in range(3)]
    keys += [svc._bucket_resident_key([entry("a", 1)]) for _ in range(2)]
    # id(service) differs between the packages: compare the rest
    return [None if k is None else (k[0], k[2], k[3]) for k in keys]


def test_membership_must_repeat_before_residency():
    """First sight of a bucket composition is a full upload (None), an
    IDENTICAL next-pump composition gets the resident key, a membership
    change drops back to a full upload for one pump — the same keys in
    both packages."""
    from karpenter_tpu.fleet.service import SolverService as RefService
    from karpenter_tpu.utils.clock import FakeClock as RefClock
    from karpenter_tpu_torch.fleet.service import SolverService
    from karpenter_tpu_torch.utils.clock import FakeClock
    got = _bucket_keys(SolverService, FakeClock)
    assert got == _bucket_keys(RefService, RefClock)
    assert got[0] is None and got[1] is not None and got[1][0] == "fleet"
    assert got[2] == got[1] and got[3] is None and got[4] is not None
