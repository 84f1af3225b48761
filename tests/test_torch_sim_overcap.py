"""The control loop's over-capacity state, held equal in both packages.

A scale-down of 1,000 grid pods on the full catalog (the operator phase of
`chip_smoke.py` at a tenth of its size) leaves existing nodes whose pods
exceed their type's allocatable. The
cause lies in the loop both packages share: `build_node_views` counts a
claim's nominated pods only while they are unbound, so a pre-spun
consolidation replacement whose pods still run on the victims shows its
whole capacity as free. The provisioner and the exact re-solves then
place other pods there, and when the victims drain the replacement holds
both. The integrity oracle flags every later solve that carries such a
node, on every rung.

Both packages' `make_sim` run the same scale-down here, with
KARPENTER_TPU_OPTIMIZER=0, and must end equal (state hash, store events
with the disruption decisions, controller stats), with the oracle flagging
the same nodes of the same solves. On the device rung the reference
quarantines its device path at each flag and ships the fallback's answer;
the port ships its device answer (the violation lies in the input) and
keeps the device rung. The answers are the same, so the runs are too.
"""

from __future__ import annotations

import ast

import numpy as np
import pytest

from karpenter_tpu import integrity as ref_integrity
from karpenter_tpu.catalog import generate_catalog as ref_generate_catalog
from karpenter_tpu_torch import integrity as port_integrity
from karpenter_tpu_torch.catalog import generate_catalog as port_generate_catalog

from test_torch_sim import (PORT, REF, _greedy,  # noqa: F401 (fixtures)
                            _leave_the_reference_as_found, _reset_sequences,
                            _shared_resource_axis, all_bound, assert_same_run,
                            decisions)

N_PODS = 1_000
DELETE = 0.6               # share of the pods deleted (seed 1)
SCALE_DOWN_S = 300.0       # sim seconds of the scale-down
# the fast cloud of the reference's c8 cell (bench.py), as chip_smoke.py
CLOUD = dict(node_ready_delay=1.0, register_delay=0.5,
             create_fleet_rate=1e6, create_fleet_burst=10**6)
CPU_GRID = ("100m", "250m", "500m", "750m", "1", "1500m", "2", "3", "4", "6")
MEM_GRID = ("128Mi", "256Mi", "512Mi", "1Gi", "2Gi", "3Gi", "4Gi", "8Gi",
            "16Gi")


def grid_pods(P, n: int, seed: int):
    """chip_smoke.py's grid mix: n (cpu, memory) pairs from the seeded
    grid."""
    rng = np.random.default_rng(seed)
    ci = rng.integers(0, len(CPU_GRID), n)
    mi = rng.integers(0, len(MEM_GRID), n)
    return [P.Pod(name=f"p{i}", requests=P.Resources.parse(
        {"cpu": CPU_GRID[c], "memory": MEM_GRID[m]}))
        for i, (c, m) in enumerate(zip(ci.tolist(), mi.tolist()))]


def scale_down(P, backend, integrity, generate_catalog, monkeypatch):
    """One package's run. Returns the sim and, for every oracle call, the
    violations with the claim each flagged node belongs to."""
    flags = []
    real = integrity.verify_result

    def spy(cat, enc, result):
        v = real(cat, enc, result)
        flags.append([(x.check, x.detail,
                       result.nodes[int(x.detail.split()[1])].existing_name
                       if x.check == "capacity" else None) for x in v])
        return v
    monkeypatch.setattr(integrity, "verify_result", spy)
    _reset_sequences(P)
    sim = P.make_sim(types=generate_catalog(), backend=backend,
                     cloud_config=P.fake.FakeCloudConfig(**CLOUD), **P.extra)
    pods = grid_pods(P, N_PODS, 0)
    for p in pods:
        sim.store.add_pod(p)
    assert sim.engine.run_until(lambda: all_bound(sim), timeout=900.0,
                                step=1.0)
    rng = np.random.default_rng(1)
    for i in rng.permutation(len(pods))[: int(len(pods) * DELETE)]:
        sim.store.delete_pod(pods[i].namespace, pods[i].name)
    sim.engine.run_for(SCALE_DOWN_S, step=5.0)
    monkeypatch.undo()
    return sim, flags


@pytest.mark.parametrize("backend", ["native", "device"])
def test_over_capacity_state_is_the_references(backend, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    ref, ref_flags = scale_down(REF, backend, ref_integrity,
                                ref_generate_catalog, monkeypatch)
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    port, port_flags = scale_down(PORT, backend, port_integrity,
                                  port_generate_catalog, monkeypatch)
    assert_same_run(ref, port)
    flagged = {name for call in port_flags for _, _, name in call}
    # the state is reached: existing nodes (claims), none a new launch,
    # each one a consolidation's pre-spun replacement
    assert flagged and None not in flagged
    replacements = {name for _, _, _, note in decisions(port)
                    if note.startswith("replacements: ")
                    for name in ast.literal_eval(note.split(": ", 1)[1])}
    assert flagged <= replacements
    assert {c for call in port_flags for c, _, _ in call} == {"capacity"}
    assert (port.solver.stats["integrity_violations"]
            == ref.solver.stats["integrity_violations"] > 0)
    if backend == "native":
        # the same oracle calls on the same solves flag the same nodes
        assert port_flags == ref_flags
        assert port.solver.stats == ref.solver.stats
    else:
        # the reference also re-checks its fallback's answer and then
        # routes the next solves to the native rung; the port re-checks the
        # fallback's answer only to classify the violation and stays on
        # the device rung. The same nodes are flagged.
        assert flagged == {name for call in ref_flags for _, _, name in call}
        assert ref.solver.stats["device_fallbacks"] > 0
        assert port.solver.stats["device_fallbacks"] == 0
