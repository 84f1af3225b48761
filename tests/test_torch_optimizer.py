"""The port's global consolidation optimizer held against the JAX reference.

Numbers: the host path (`generate_subsets`, `evictability`,
`group_slot_prices`, `repack_inputs`, `score_subsets_host`) equal at atol
0; the port's `score_subsets_device(device="cpu")` (kernel A's and kernel
C's plain versions) against the reference's `score_subsets_device` (XLA
on the CPU) and its `score_subsets_host`: feasibility equal, savings equal
to the reference's device path (the sequential sum XLA's dot gives below
32 nodes; the reference's own host path adds in another order, so against
it the reference's tolerance rtol 1e-5 holds), residual and repl_lb within
rtol 1e-3 / atol 1e-3 (tests/test_optimizer.py:115-117), and
`plan_repack(...).subsets` equal element for element.

Loops: the joint-consolidation, fallback and determinism cases of
tests/test_optimizer.py, each run through both packages' `make_sim` and
held equal (state hash, store events, every controller's stats, the
savings metered). Kernel C itself runs only on the card: its test is in
test_torch_kernels.py.
"""

from __future__ import annotations

import copy
import random

import numpy as np
import pytest
import torch

from karpenter_tpu import optimizer as ref_opt
from karpenter_tpu.catalog import GeneratorConfig, generate_catalog
from karpenter_tpu.catalog import small_catalog as ref_small_catalog
from karpenter_tpu.metrics import CONSOLIDATION_SAVINGS as REF_SAVINGS
from karpenter_tpu.metrics import SOLVER_FALLBACKS as REF_FALLBACKS
from karpenter_tpu.models.nodeclaim import NodeClaim
from karpenter_tpu.models.pod import Pod
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.binpack import VirtualNode
from karpenter_tpu.ops.encode import encode_catalog, encode_pods
from karpenter_tpu.optimizer import fixtures as ref_fixtures
from karpenter_tpu.optimizer import subsets as ref_subsets
from karpenter_tpu.optimizer import tournament as ref_tournament
from karpenter_tpu.optimizer.stats import OPTIMIZER as REF_OPTIMIZER
from karpenter_tpu.state.cluster import NodeView as RefNodeView

from karpenter_tpu_torch import convert
from karpenter_tpu_torch import optimizer as port_opt
from karpenter_tpu_torch.metrics import CONSOLIDATION_SAVINGS as PORT_SAVINGS
from karpenter_tpu_torch.metrics import SOLVER_FALLBACKS as PORT_FALLBACKS
from karpenter_tpu_torch.models.nodeclaim import NodeClaim as PNodeClaim
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.optimizer import fixtures as port_fixtures
from karpenter_tpu_torch.optimizer import relax as port_relax
from karpenter_tpu_torch.optimizer import subsets as port_subsets
from karpenter_tpu_torch.optimizer import tournament as port_tournament
from karpenter_tpu_torch.optimizer import tournament_k
from karpenter_tpu_torch.state.cluster import NodeView

from test_torch_sim import (PORT, REF,  # noqa: F401 (fixtures)
                            _leave_the_reference_as_found, _reset_sequences,
                            _shared_resource_axis, assert_same_run)

RTOL = ATOL = 1e-3          # residual and repl_lb (test_optimizer.py:115)
HOST_SAVINGS_RTOL = 1e-5    # savings against the reference's host path
FIXTURES = {id(REF): ref_fixtures, id(PORT): port_fixtures}
SAVINGS = {id(REF): REF_SAVINGS, id(PORT): PORT_SAVINGS}


@pytest.fixture(scope="module", autouse=True)
def _restore_reference_optimizer_meter():
    """The reference's process-global optimizer meter goes back to its
    state before this module (its watchdog reads the reject streaks)."""
    saved = copy.deepcopy(REF_OPTIMIZER._tenants)
    yield
    REF_OPTIMIZER._tenants = saved


@pytest.fixture(autouse=True)
def _armed(monkeypatch):
    """The reference's default: the optimizer armed."""
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER", raising=False)


# --- the host path, atol 0 --------------------------------------------------


@pytest.mark.parametrize("n,max_k,max_subsets,seed", [
    (5, 3, 256, 0), (40, 3, 500, 7), (40, 3, 500, 8), (40, 2, 20, 0),
    (12, 5, 256, 0), (31, 5, 16, 3), (1, 5, 256, 0), (60, 5, 232, 0)])
def test_generate_subsets_matches_reference(n, max_k, max_subsets, seed):
    guide = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    guide[::7] = 0.0  # ties: the stable order decides
    want = ref_subsets.generate_subsets(n, guide, max_k=max_k,
                                        max_subsets=max_subsets, seed=seed)
    got = port_subsets.generate_subsets(n, guide, max_k=max_k,
                                        max_subsets=max_subsets, seed=seed)
    assert got == want
    for draw in range(20):
        assert (port_subsets._hash_draw(seed, draw, 3, n + 2)
                == ref_subsets._hash_draw(seed, draw, 3, n + 2))


def test_evictability_matches_reference():
    rng = np.random.default_rng(5)
    N, G = 23, 9
    slack = rng.normal(size=(N, G)).astype(np.float32)
    counts = rng.integers(0, 3, (N, G)).astype(np.int32)
    counts[4] = 0  # a node with no resident pods
    prices = rng.uniform(0.05, 3.0, N).astype(np.float32)
    per_slot = rng.uniform(0.01, 0.5, G).astype(np.float32)
    per_slot[2] = 1e9  # a group no type can host
    cand = [1, 4, 7, 8, 15, 22]
    np.testing.assert_array_equal(
        port_subsets.evictability(slack, counts, prices, cand, per_slot),
        ref_subsets.evictability(slack, counts, prices, cand, per_slot))


def test_relax_residuals_host_copy_and_plain():
    """The host copy equals the reference's NumPy relaxation at atol 0;
    the torch plain version within the stated tolerance, on the
    reference's two hand cases and a random one."""
    from karpenter_tpu.optimizer.relax import relax_residuals as ref_relax
    rng = np.random.default_rng(2)
    S, N, G, R = 7, 11, 5, 3
    head = rng.uniform(-1.0, 8.0, (N, R)).astype(np.float32)
    req = rng.uniform(0.0, 3.0, (G, R)).astype(np.float32)
    k = rng.integers(0, 4, (N, G)).astype(np.float32)
    masks = (rng.random((S, N)) < 0.3).astype(np.float32)
    need = masks @ rng.integers(0, 3, (N, G)).astype(np.float32)
    cases = [(head, req, k, masks, need)]
    for cap in (4.0, 8.0):  # test_optimizer.py TestRelaxation
        hk = np.array([[cap], [0.0], [0.0]], np.float32)
        m = np.array([[0.0, 1.0, 1.0]], np.float32)
        cases.append((hk, np.array([[3.0], [3.0]], np.float32),
                      np.array([[cap // 4, cap // 4], [0, 0], [0, 0]],
                               np.float32), m,
                      m @ np.array([[0, 0], [1, 0], [0, 1]], np.float32)))
    for args in cases:
        want = ref_relax(np, *args)
        np.testing.assert_array_equal(port_relax.relax_residuals(*args), want)
        got = port_relax.relax_residuals_plain(
            *(torch.as_tensor(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# --- scoring and plans: fleets and seeded inputs ---------------------------


def _fleet(P, build, tiles):
    """(cat, enc, views, counts, slack) of the pool after `build` on one
    package's host-rung sim: the disruption controller's screen state."""
    _reset_sequences(P)
    sim = P.make_sim(backend="host", **P.extra)
    getattr(FIXTURES[id(P)], build)(sim, tiles=tiles)
    pool = sim.store.nodepools["default"]
    cat = sim.solver.tensors(sim.store.nodeclasses["default"])
    views = [v for v in P.build_node_views(sim.store, cat, sim.clock.now())
             if v.claim.nodepool == pool.name]
    sim.disruption._hash_memo = {}
    scat, enc, counts, _ok, slack = sim.disruption._screen_state(pool, cat,
                                                                 views)
    return scat, enc, views, counts, slack


def _synthetic(seed, N, n_groups, exclude_frac=0.2):
    """Seeded random nodes (type, zone and captype masks, load) with
    random prices and pod counts over `n_groups` distinct pod groups, in
    both packages; slack and the exclusion mask random too."""
    rng = np.random.default_rng(seed)
    cat = encode_catalog(ref_small_catalog())
    # distinct (cpu, memory) pairs: one group a pod
    pairs = rng.choice(3999 * 8, size=n_groups, replace=False)
    pods = [Pod(name=f"g{i}", requests=Resources.parse(
        {"cpu": f"{1 + int(v) % 3999}m", "memory": f"{1 + int(v) // 3999}Gi"}))
        for i, v in enumerate(pairs)]
    enc = encode_pods(pods, cat)
    nodes = []
    for i in range(N):
        cum = np.zeros(enc.requests.shape[1], np.float32)
        cum[0] = rng.uniform(0, 6)
        cum[1] = rng.uniform(0, 8192)  # MiB
        nodes.append(VirtualNode(type_idx=int(rng.integers(0, cat.T)),
                                 zone_mask=rng.random(cat.Z) < 0.8,
                                 cap_mask=rng.random(cat.C) < 0.8, cum=cum))
    prices = rng.uniform(0.05, 2.5, N).astype(np.float32)
    counts = (rng.random((N, enc.G)) < 3.0 / max(enc.G, 1)).astype(np.int32)
    counts *= rng.integers(1, 3, (N, enc.G)).astype(np.int32)
    slack = rng.normal(size=(N, enc.G)).astype(np.float32)
    exclude = rng.random(N) < exclude_frac
    views = [RefNodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"),
                         node=None, pods=[], virtual=n, price=float(p))
             for i, (n, p) in enumerate(zip(nodes, prices))]
    pviews = [NodeView(claim=PNodeClaim(name=f"n{i}", nodepool="d"),
                       node=None, pods=[], virtual=v, price=float(p))
              for i, (v, p) in enumerate(zip(
                  convert.nodes_from_arrays(vars(n) for n in nodes), prices))]
    ref = (cat, enc, views, counts, slack)
    port = (convert.catalog_from_arrays(vars(cat)),
            convert.pods_from_arrays(vars(enc)), pviews, counts, slack)
    return ref, port, exclude


def _masks(views, counts, slack, cat, enc, max_k, max_subsets):
    prices = np.array([v.price for v in views], np.float32)
    cand = list(range(len(views)))
    guide = ref_subsets.evictability(
        slack, counts, prices, cand, ref_tournament.group_slot_prices(cat,
                                                                      enc))
    subs, _ = ref_subsets.generate_subsets(len(cand), guide, max_k=max_k,
                                           max_subsets=max_subsets)
    masks = np.zeros((len(subs), len(views)), np.float32)
    for si, s in enumerate(subs):
        masks[si, list(s)] = 1.0
    return prices, masks


def _check_scoring(ref, port, exclude, max_k, max_subsets=256,
                   dev_savings_rtol=0.0):
    cat, enc, views, counts, slack = ref
    pcat, penc, pviews, pcounts, pslack = port
    np.testing.assert_array_equal(pcounts, counts)
    np.testing.assert_array_equal(pslack, slack)
    per_slot = ref_tournament.group_slot_prices(cat, enc)
    np.testing.assert_array_equal(
        port_tournament.group_slot_prices(pcat, penc), per_slot)
    want_in = ref_tournament.repack_inputs(cat, enc, views, counts,
                                           exclude=exclude)
    got_in = port_tournament.repack_inputs(pcat, penc, pviews, pcounts,
                                           exclude=exclude)
    for a, b in zip(got_in, want_in):
        np.testing.assert_array_equal(a, b)
    prices, masks = _masks(views, counts, slack, cat, enc, max_k,
                           max_subsets)
    headroom, group_req, _elig, k, _active = want_in
    host = ref_tournament.score_subsets_host(headroom, group_req, k, counts,
                                             prices, masks, per_slot)
    for a, b in zip(port_tournament.score_subsets_host(
            *got_in[:2], got_in[3], pcounts, prices, masks, per_slot), host):
        np.testing.assert_array_equal(a, b)
    dev = ref_tournament.score_subsets_device(cat, enc, views, counts,
                                              prices, masks, exclude=exclude)
    got = port_tournament.score_subsets_device(
        pcat, penc, pviews, pcounts, prices, masks, exclude=exclude,
        device="cpu")
    for want, savings_rtol in ((dev, dev_savings_rtol),
                               (host, HOST_SAVINGS_RTOL)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=savings_rtol,
                                   atol=0)
        for i in (2, 3):
            np.testing.assert_allclose(got[i], want[i], rtol=RTOL,
                                       atol=ATOL)
    cand = list(range(len(views)))
    for use_device in (False, True):
        kw = dict(max_k=max_k, exclude=exclude, use_device=use_device,
                  max_subsets=max_subsets)
        want = ref_opt.plan_repack(cat, enc, views, counts, slack, cand,
                                   **kw)
        plan = port_opt.plan_repack(pcat, penc, pviews, pcounts, pslack,
                                    cand, device="cpu", **kw)
        assert plan.subsets == want.subsets
        assert (plan.scored, plan.feasible, plan.exhaustive,
                plan.backend) == (want.scored, want.feasible,
                                  want.exhaustive, want.backend)
        np.testing.assert_allclose(
            plan.savings, want.savings, atol=0,
            rtol=dev_savings_rtol if use_device else HOST_SAVINGS_RTOL)
        np.testing.assert_allclose(plan.residuals, want.residuals,
                                   rtol=RTOL, atol=ATOL)
    return masks.shape[0], got


@pytest.mark.parametrize("build,tiles", [("build_joint_fleet", 1),
                                         ("build_joint_fleet", 2),
                                         ("build_squeeze_fleet", 1),
                                         ("build_squeeze_fleet", 2)])
def test_scoring_and_plan_on_fleets(build, tiles):
    """The joint and squeeze fleets (the reference's bench c14 shapes):
    the controller's own screen state from both packages' sims."""
    ref = _fleet(REF, build, tiles)
    port = _fleet(PORT, build, tiles)
    S, (feasible, _s, residual, _r) = _check_scoring(ref, port, None,
                                                     max_k=5)
    # the joint pair repacks replacement-free; every squeeze subset needs
    # a replacement
    joint = build == "build_joint_fleet"
    assert S > 1 and (feasible.any() if joint else (residual > 0).all())


@pytest.mark.parametrize("seed", range(4))
def test_scoring_and_plan_on_seeded_inputs_with_exclusions(seed):
    ref, port, exclude = _synthetic(seed, N=17 + 4 * seed, n_groups=12)
    assert exclude.any()
    _check_scoring(ref, port, exclude, max_k=4)


@pytest.mark.parametrize("seed,N,n_groups", [(0, 64, 12), (1, 64, 30),
                                              (2, 400, 12), (3, 400, 40)])
def test_scoring_and_plan_above_32_nodes(seed, N, n_groups):
    """Above 32 nodes the reference's XLA dot on the CPU adds masks @
    prices in a vectorised order, not node by node, so its savings differ
    from the port's node-order sum in the last bit or two of some subsets
    (ROADMAP §3): savings within HOST_SAVINGS_RTOL of both reference
    paths. Feasibility, residuals and repl_lb hold as below 32 nodes, and
    every plan, host and device, equals the reference's element for
    element."""
    ref, port, exclude = _synthetic(seed, N=N, n_groups=n_groups)
    assert exclude.any()
    S, _ = _check_scoring(ref, port, exclude, max_k=5,
                          dev_savings_rtol=HOST_SAVINGS_RTOL)
    assert S == 256


def test_relax_budget_floor_binds():
    """N * G = 31 * 16,130 > RELAX_BUDGET / 16: the subset batch is the
    floor of 16, not RELAX_BUDGET // (N * G) = 15."""
    N, G = 31, 16_130
    assert port_opt.RELAX_BUDGET // (N * G) < 16
    ref, port, exclude = _synthetic(11, N=N, n_groups=G, exclude_frac=0.0)
    assert ref[1].G == G
    S, _ = _check_scoring(ref, port, None, max_k=5,
                          max_subsets=max(16, port_opt.RELAX_BUDGET
                                          // (N * G)))
    assert S == 16


def test_score_subsets_device_rejects_a_mesh():
    """Once a raise-test of `mesh=` (the name is kept): the tournament over
    a mesh of 8 CPU shards (6 nodes, the price row on the last shard's
    block) equals mesh=None's, and the reference's mesh tournament at the
    device path's tolerances."""
    from karpenter_tpu.parallel import make_mesh as ref_make_mesh
    from karpenter_tpu_torch import parallel
    ref, port, _ = _synthetic(1, N=6, n_groups=3)
    cat, enc, views, _, _ = ref
    pcat, penc, pviews, counts, _slack = port
    prices = np.ones(6, np.float32)
    masks = np.eye(6, dtype=np.float32)[:2]
    with parallel.virtual_devices(8, "cpu"):
        mesh = parallel.make_mesh(8)
    got = port_tournament.score_subsets_device(pcat, penc, pviews, counts,
                                               prices, masks, mesh=mesh)
    one = port_tournament.score_subsets_device(pcat, penc, pviews, counts,
                                               prices, masks, device="cpu")
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)
    want = ref_tournament.score_subsets_device(cat, enc, views, counts,
                                               prices, masks,
                                               mesh=ref_make_mesh(8))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=RTOL, atol=ATOL)


def test_sequential_savings_is_xla_dot_below_32_nodes():
    """The savings order kernel C and its plain version take: one victim
    at a time in ascending node order, which is the reference's XLA dot
    on the CPU below 32 nodes (its NumPy path adds in another order)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    # the reference's own expression: masks and the price row of one
    # packed upload (tournament.py:160-182)
    dot = jax.jit(lambda mbuf: mbuf[:-1] @ mbuf[-1])
    for _ in range(30):
        N = int(rng.integers(2, 32))
        prices = rng.uniform(0.01, 5.0, N).astype(np.float32)
        masks = np.zeros((64, N), np.float32)
        for row in masks:
            row[rng.choice(N, min(N, int(rng.integers(1, 6))),
                           replace=False)] = 1.0
        want = np.asarray(dot(jnp.asarray(np.concatenate(
            [masks, prices[None]]))))
        tm, tp = torch.as_tensor(masks), torch.as_tensor(prices)
        got = tournament_k._node_order_sums(tm, tm.T, tm.T, tp)[3]
        np.testing.assert_array_equal(got.numpy(), want)


# --- the loop: test_optimizer.py's cases through both packages -------------


def _run(P, build, drive, backend="host", tiles=1):
    """One package: build the fleet on make_sim(backend), then drive it.
    Returns (sim, fleet info, optimizer savings metered, greedy savings
    metered)."""
    if P is REF:
        from karpenter_tpu.ops.delta import DELTA
    else:
        from karpenter_tpu_torch.ops.delta import DELTA
    DELTA.reset()  # each run starts with an empty delta plane
    _reset_sequences(P)
    sim = P.make_sim(backend=backend, **P.extra)
    info = getattr(FIXTURES[id(P)], build)(sim, tiles=tiles)
    met = SAVINGS[id(P)]
    base = met.sum(source="optimizer"), met.sum(source="greedy")
    drive(sim)
    return (sim, info, met.sum(source="optimizer") - base[0],
            met.sum(source="greedy") - base[1])


def _both(build, drive, backend="host", tiles=1):
    ref = _run(REF, build, drive, backend, tiles)
    port = _run(PORT, build, drive, backend, tiles)
    assert_same_run(ref[0], port[0])
    assert port[2] == pytest.approx(ref[2], abs=1e-9)
    assert port[3] == pytest.approx(ref[3], abs=1e-9)
    return port


def _run_for(seconds):
    return lambda sim: sim.engine.run_for(seconds, step=5)


def _reconcile(sim):
    sim.disruption.reconcile(sim.clock.now())


@pytest.mark.parametrize("backend", ["host", "native", "device"])
def test_optimizer_finds_pair_greedy_misses(backend):
    """The joint pair {E, F} repacks onto D: greedy's prefixes miss it,
    the optimizer's pick passes an exact verify and executes, in both
    packages alike on every rung."""
    sim, _info, opt, _greedy = _both("build_joint_fleet", _run_for(240),
                                     backend)
    stats = sim.disruption.stats
    assert stats["multi_consolidated"] >= 1
    assert stats.get("optimizer_consolidated", 0) >= 1
    assert len(sim.store.nodeclaims) < 6
    assert all(p.node_name is not None for p in sim.store.pods.values())
    assert opt > 0


def test_greedy_multi_node_returns_none(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    sim, *_ = _both("build_joint_fleet", _reconcile)
    assert sim.disruption.stats["multi_consolidated"] == 0
    assert sim.disruption.stats.get("optimizer_consolidated", 0) == 0


@pytest.mark.parametrize("backend", ["host", "device"])
def test_squeeze_replacement_backed_joint_eviction(backend):
    """Bench c14's shape at one tile: five c5.xlarge victims squeeze onto
    one fresh c5.4xlarge, found only by the subset search."""
    sim, info, opt, _ = _both("build_squeeze_fleet", _run_for(900), backend)
    assert sim.disruption.stats["multi_consolidated"] >= 1
    types = sorted(c.instance_type for c in sim.store.nodeclaims.values())
    assert port_fixtures.SQUEEZE_SMALL not in types
    assert types.count(port_fixtures.ITYPE) == 4
    assert abs(opt - info["squeeze_savings"]) < 0.01


def test_squeeze_above_32_nodes_on_the_device_rung(monkeypatch):
    """Six squeeze tiles (48 nodes) on the device rung: the subset
    searches run above the 32 nodes from which the reference's XLA dot
    adds the savings in another order than the port (ROADMAP §3), and the
    loop still makes the reference's decisions, in its order."""
    searches = []
    real = port_opt.plan_repack

    def counted(*a, **kw):
        plan = real(*a, **kw)
        searches.append((plan.backend, len(a[2])))
        return plan
    monkeypatch.setattr(port_opt, "plan_repack", counted)
    sim, _info, opt, _ = _both("build_squeeze_fleet", _run_for(300),
                               "device", tiles=6)
    assert {b for b, _ in searches} == {"device"}
    assert max(n for _, n in searches) == 48
    assert sim.disruption.stats["optimizer_consolidated"] >= 3
    assert opt > 0


def test_squeeze_greedy_finds_nothing(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    sim, _info, _opt, greedy = _both("build_squeeze_fleet", _run_for(240))
    assert len(sim.store.nodeclaims) == 8
    assert sim.disruption.stats["consolidated"] == 0
    assert sim.disruption.stats["multi_consolidated"] == 0
    assert greedy == 0


def test_budget_bounds_subset_size():
    def drive(sim):
        pool = sim.store.nodepools["default"]
        P = PORT if type(sim).__module__.startswith("karpenter_tpu_torch") \
            else REF
        pool.disruption = P.DisruptionSpec(budgets=[P.Budget(nodes="1")])
        _reconcile(sim)
    sim, *_ = _both("build_joint_fleet", drive)
    assert sim.disruption.stats["multi_consolidated"] == 0


def test_pdb_blocks_optimizer_pick():
    def drive(sim):
        from karpenter_tpu.models.pod import PodDisruptionBudget as RefPDB
        from karpenter_tpu_torch.models.pod import PodDisruptionBudget as PDB
        port = type(sim).__module__.startswith("karpenter_tpu_torch")
        sim.store.add_pdb((PDB if port else RefPDB)(
            name="all", label_selector={}, max_unavailable=0))
        _reconcile(sim)
    sim, *_ = _both("build_joint_fleet", drive)
    assert sim.disruption.stats["multi_consolidated"] == 0


def test_injected_optimizer_fault_degrades_to_greedy(monkeypatch):
    """A dispatch-hook fault at "optimizer" on the device rung (the
    reference's seam, the port's InjectedFault): one greedy pass instead,
    with the reference's optimizer_errors stat and SOLVER_FALLBACKS
    {from_backend="optimizer"} delta, and the same end state."""
    from karpenter_tpu.faults.plan import InjectedFault as RefInjected

    def hook(exc):
        def fire(backend):
            if backend == "optimizer":
                raise exc("injected optimizer fault")
        return fire
    monkeypatch.setattr(ref_solver, "_dispatch_fault_hook", hook(RefInjected))
    monkeypatch.setattr(port_solver, "_dispatch_fault_hook",
                        hook(port_solver.InjectedFault))

    def count(metric):
        return metric.value(from_backend="optimizer", to_backend="greedy")
    r0, p0 = count(REF_FALLBACKS), count(PORT_FALLBACKS)
    ref = _run(REF, "build_joint_fleet", _reconcile, "device")
    port = _run(PORT, "build_joint_fleet", _reconcile, "device")
    assert count(PORT_FALLBACKS) - p0 == count(REF_FALLBACKS) - r0 > 0
    assert port[0].disruption.stats["optimizer_errors"] >= 1
    assert port[0].disruption.stats["multi_consolidated"] == 0
    assert_same_run(ref[0], port[0])


def test_tournament_error_raises_out_of_tick(monkeypatch):
    """Kernel C failing inside the loop is not absorbed: the error leaves
    DisruptionController.reconcile and Engine.tick, and nothing is
    metered as an optimizer fallback."""
    def refuse(*a, **kw):
        raise RuntimeError("tournament launch failed: cudaError 700")
    monkeypatch.setattr(tournament_k, "tournament", refuse)
    _reset_sequences(PORT)
    sim = PORT.make_sim(backend="device", **PORT.extra)
    port_fixtures.build_joint_fleet(sim, tiles=1)
    p0 = PORT_FALLBACKS.value(from_backend="optimizer", to_backend="greedy")
    with pytest.raises(RuntimeError, match="^tournament launch failed"):
        sim.engine.run_for(60, step=5)
    assert PORT_FALLBACKS.value(from_backend="optimizer",
                                to_backend="greedy") == p0
    assert "optimizer_errors" not in sim.disruption.stats


def test_flag_off_never_enters_the_optimizer(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    assert not port_opt.optimizer_enabled()

    def boom(*a, **kw):  # pragma: no cover — must not run
        raise AssertionError("optimizer entered with the flag off")
    monkeypatch.setattr(port_opt, "plan_repack", boom)
    _reset_sequences(PORT)
    sim = PORT.make_sim(backend="host", **PORT.extra)
    port_fixtures.build_joint_fleet(sim, tiles=1)
    _reconcile(sim)
    assert sim.disruption.stats.get("optimizer_errors", 0) == 0


def test_repeat_identical_on_joint_fleet():
    """Two port runs of the joint fleet agree on every decision (the
    subset search draws from keyed hashes, never an RNG stream), and
    with the reference's."""
    a = _run(PORT, "build_joint_fleet", _run_for(240))[0]
    b = _run(PORT, "build_joint_fleet", _run_for(240))[0]
    assert (PORT.state_hash(a), a.disruption.stats) == (
        PORT.state_hash(b), b.disruption.stats)
    assert a.store.events == b.store.events
    ref = _run(REF, "build_joint_fleet", _run_for(240))[0]
    assert_same_run(ref, a)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_device_tournament_on_the_card_matches_plain(seed):
    """The whole device path on the card (one upload, kernel A for k,
    kernel C, one read) equal to its plain versions on the CPU, output for
    output; kernel C's own tests are in test_torch_kernels.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels A and C run only on the card")
    _ref, port, exclude = _synthetic(seed, N=40, n_groups=30)
    pcat, penc, pviews, counts, slack = port
    prices = np.array([v.price for v in pviews], np.float32)
    masks = np.zeros((64, len(pviews)), np.float32)
    rng = np.random.default_rng(seed)
    for row in masks:
        row[rng.choice(len(pviews), 3, replace=False)] = 1.0
    n0 = tournament_k.launches
    got = port_tournament.score_subsets_device(
        pcat, penc, pviews, counts, prices, masks, exclude=exclude,
        device="cuda")
    assert tournament_k.launches == n0 + 1
    want = port_tournament.score_subsets_device(
        pcat, penc, pviews, counts, prices, masks, exclude=exclude,
        device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
