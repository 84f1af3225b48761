"""The port's control loop with the global optimizer armed, held against
the JAX reference's.

The scenarios of tests/test_torch_sim.py that reach multi-node
consolidation (some with a wider disruption budget, so the subset search
has room: it needs a budget of 2 nodes or more) run through both
packages' `make_sim` with KARPENTER_TPU_OPTIMIZER unset, the reference's
default: the subset search runs first, greedy after. On the device rung
the port scores subsets with kernel A's and kernel C's plain versions
(device="cpu"); on the host and native rungs both packages score in NumPy.
The reference runs at its default, delta plane armed (a fresh plane each
run), and with KARPENTER_TPU_DELTA=0; the port has no delta plane and
always takes the reference's disarmed branch.

What must be equal, exactly, as in test_torch_sim.py: both state hashes,
the store's events (the disruption decisions among them, optimizer ones
included), every controller's stats, plus the optimizer savings metered.
The same file holds bench c14's measurement (`measure_consolidation(
"squeeze", 2)`) equal to the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.metrics import CONSOLIDATION_SAVINGS as REF_SAVINGS
from karpenter_tpu.optimizer import fixtures as ref_fixtures
from karpenter_tpu.optimizer.stats import OPTIMIZER as REF_OPTIMIZER

from karpenter_tpu_torch import optimizer as port_opt
from karpenter_tpu_torch.metrics import CONSOLIDATION_SAVINGS as PORT_SAVINGS
from karpenter_tpu_torch.optimizer import fixtures as port_fixtures

from test_torch_sim import (PORT, REF, SCENARIOS,  # noqa: F401 (fixtures)
                            _leave_the_reference_as_found, _reset_sequences,
                            _shared_resource_axis, add_pods, assert_same_run,
                            settle)


@pytest.fixture(scope="module", autouse=True)
def _restore_reference_optimizer_meter():
    import copy
    saved = copy.deepcopy(REF_OPTIMIZER._tenants)
    yield
    REF_OPTIMIZER._tenants = saved


@pytest.fixture(autouse=True)
def _armed(monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER", raising=False)


def wide_pool(P, nodes="50%"):
    return {"nodepool": P.NodePool(name="default", disruption=P.DisruptionSpec(
        budgets=[P.Budget(nodes=nodes)]))}


def sc_consolidation_order(P, sim):
    """test_torch_sim's consolidation_order waves (half the pods deleted),
    with a budget of 3 nodes a pass: the subset search decides first."""
    rng = np.random.default_rng(0)
    pods = []
    for w in range(4):
        for i in range(int(rng.integers(3, 8))):
            pods += add_pods(P, sim, 1, prefix=f"w{w}-{i}",
                             cpu=str(rng.choice(["500m", "1", "2", "3"])),
                             mem=str(rng.choice(["1Gi", "2Gi", "4Gi"])))
        settle(sim)
    for i in rng.permutation(len(pods))[: len(pods) // 2]:
        sim.store.delete_pod(pods[i].namespace, pods[i].name)
    sim.engine.run_for(400, step=5)


LOOPS = {
    "multi_node_consolidation": SCENARIOS["multi_node_consolidation"],
    "scale_down_consolidation": (SCENARIOS["scale_down_consolidation"][0],
                                 wide_pool),
    "discovered_capacity": (SCENARIOS["discovered_capacity"][0], wide_pool),
    "consolidation_order": (sc_consolidation_order,
                            lambda P: wide_pool(P, "3")),
}
CASES = ([(name, rung, "default") for name in LOOPS
          for rung in ("device", "host", "native")]
         + [(name, "device", "0") for name in LOOPS])
SAVINGS = {id(REF): REF_SAVINGS, id(PORT): PORT_SAVINGS}


def run(P, name, backend):
    drive, kwargs = LOOPS[name]
    if P is REF:
        from karpenter_tpu.ops.delta import DELTA
        DELTA.reset()  # each run starts with an empty delta plane
    _reset_sequences(P)
    sim = P.make_sim(backend=backend, **(kwargs(P) if kwargs else {}),
                     **P.extra)
    base = SAVINGS[id(P)].sum(source="optimizer")
    drive(P, sim)
    return sim, SAVINGS[id(P)].sum(source="optimizer") - base


@pytest.mark.parametrize("name,backend,delta", CASES)
def test_armed_loop_matches_reference(name, backend, delta, monkeypatch):
    if delta == "0":
        monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    searches = []
    real = port_opt.plan_repack

    def counted(*a, **kw):
        plan = real(*a, **kw)
        searches.append(plan.backend)
        return plan
    monkeypatch.setattr(port_opt, "plan_repack", counted)
    ref, ref_saved = run(REF, name, backend)
    port, port_saved = run(PORT, name, backend)
    assert searches, "the scenario never reached the subset search"
    assert set(searches) == {"device" if backend == "device" else "host"}
    assert_same_run(ref, port)
    assert port_saved == pytest.approx(ref_saved, abs=1e-9)


def test_c14_squeeze_measurement_matches_reference():
    """Bench c14's procedure at 2 tiles, optimizer armed, on the host rung
    as the bench runs it: the savings and the joint consolidations equal
    the reference's (the reference's delta plane audits re-run the search,
    so its subsets_scored is larger at its default; the decisions are
    not)."""
    from karpenter_tpu.ops.delta import DELTA
    DELTA.reset()
    _reset_sequences(REF)
    want = ref_fixtures.measure_consolidation("squeeze", 2, armed=True)
    _reset_sequences(PORT)
    got = port_fixtures.measure_consolidation("squeeze", 2, armed=True,
                                              device="cpu")
    keys = ("nodes_before", "nodes_after", "savings", "multi_consolidated",
            "single_consolidated", "joint_consolidations", "exact_verifies",
            "verify_accepts", "screen_cache_hits", "all_bound")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["joint_consolidations"] >= 2 and got["savings"] > 0


def test_armed_scale_down_keeps_the_references_nodes(monkeypatch):
    """chip_smoke's operator phase at a tenth of its size on the native
    rung (tests/test_torch_sim_overcap.py's scale-down), optimizer armed:
    both packages end in the same state, with the optimizer's decisions
    first. Armed, the loop keeps more nodes than greedy alone (whose run
    test_torch_sim_overcap.py holds equal to the reference's): a pass in
    which the search executes skips greedy's prefix search."""
    from karpenter_tpu import integrity as ref_integrity
    from karpenter_tpu.catalog import generate_catalog as ref_catalog
    from karpenter_tpu_torch import integrity as port_integrity
    from karpenter_tpu_torch.catalog import generate_catalog as port_catalog

    from test_torch_sim_overcap import scale_down
    ref, ref_flags = scale_down(REF, "native", ref_integrity, ref_catalog,
                                monkeypatch)
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER", raising=False)
    port, port_flags = scale_down(PORT, "native", port_integrity,
                                  port_catalog, monkeypatch)
    assert_same_run(ref, port)
    # the same nodes flagged, in the same order; the reference's delta
    # plane adds its audit re-solves' oracle calls (ROADMAP §3), so the
    # lists are held equal call for call without it (below)
    assert [c for c in port_flags if c] == [c for c in ref_flags if c]
    assert len(port_flags) <= len(ref_flags)
    assert port.disruption.stats["optimizer_consolidated"] > 0
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    greedy, _ = scale_down(PORT, "native", port_integrity, port_catalog,
                           monkeypatch)
    assert len(port.store.nodeclaims) > len(greedy.store.nodeclaims)


def test_armed_scale_down_flags_without_the_delta_plane(monkeypatch):
    """The armed scale-down on the native rung with the reference's delta
    plane off (the port has none): both packages make the same oracle
    calls on the same solves and flag the same nodes, call for call."""
    from karpenter_tpu import integrity as ref_integrity
    from karpenter_tpu.catalog import generate_catalog as ref_catalog
    from karpenter_tpu_torch import integrity as port_integrity
    from karpenter_tpu_torch.catalog import generate_catalog as port_catalog

    from test_torch_sim_overcap import scale_down
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "0")
    ref, ref_flags = scale_down(REF, "native", ref_integrity, ref_catalog,
                                monkeypatch)
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER", raising=False)
    port, port_flags = scale_down(PORT, "native", port_integrity,
                                  port_catalog, monkeypatch)
    assert_same_run(ref, port)
    assert port_flags == ref_flags and len(port_flags) > 0
    assert port.solver.stats == ref.solver.stats


def test_armed_scale_down_on_the_device_rung(monkeypatch):
    """The same scale-down, optimizer armed, on the device rung: the
    port's subset searches score through kernel A's and kernel C's plain
    versions (device="cpu"), the first ones above the 32 nodes from which
    the reference's XLA dot stops adding the savings in node order
    (ROADMAP §3), and still pick the reference's subsets: both packages
    end in the same state, decisions and stats."""
    from karpenter_tpu import integrity as ref_integrity
    from karpenter_tpu.catalog import generate_catalog as ref_catalog
    from karpenter_tpu_torch import integrity as port_integrity
    from karpenter_tpu_torch.catalog import generate_catalog as port_catalog

    from test_torch_sim_overcap import scale_down
    ref, ref_flags = scale_down(REF, "device", ref_integrity, ref_catalog,
                                monkeypatch)
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER", raising=False)
    searches = []
    real = port_opt.plan_repack

    def counted(*a, **kw):
        plan = real(*a, **kw)
        searches.append((plan.backend, len(a[2])))
        return plan
    monkeypatch.setattr(port_opt, "plan_repack", counted)
    port, port_flags = scale_down(PORT, "device", port_integrity,
                                  port_catalog, monkeypatch)
    assert_same_run(ref, port)
    # the same nodes are flagged; the reference also re-checks its
    # fallback's answer where it flags one, the port stays on the card
    # (tests/test_torch_sim_overcap.py)
    flagged = {name for call in port_flags for _, _, name in call}
    assert flagged == {name for call in ref_flags for _, _, name in call}
    if ref.solver.stats["device_fallbacks"] == 0:
        assert [c for c in port_flags if c] == [c for c in ref_flags if c]
    assert port.solver.stats["device_fallbacks"] == 0
    assert port.disruption.stats["optimizer_consolidated"] > 0
    assert {b for b, _ in searches} == {"device"}
    assert max(n for _, n in searches) > 32
