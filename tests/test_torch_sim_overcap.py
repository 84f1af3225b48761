"""The control loop's over-capacity state: the reference's, which the
port no longer reaches (a recorded difference, ROADMAP §6), and the port
held equal to the reference with that difference taken out.

A scale-down of 1,000 grid pods on the full catalog (the operator phase of
`chip_smoke.py` at a tenth of its size) leaves the reference with existing
nodes whose pods exceed their type's allocatable. Its cause lies in the
single-node pass both packages once shared: a pass builds its node views
once, and each exact re-solve of the pass fills the same free headroom,
so two consolidations of one pass can each count on it (and a pre-spun
replacement holds both decisions' pods once the victims drain). The
integrity oracle then flags every later solve that carries such a node,
on every rung. The port charges each executed decision's placements to
the views the rest of its pass solves against
(`controllers/disruption._charge`).

Both packages' `make_sim` run the same scale-down here, with
KARPENTER_TPU_OPTIMIZER=0: the reference reaches the state (the oracle
flags its consolidation replacements, on the device rung it quarantines
its device path at each flag); the port ends with every pod bound, no
flag and no fallback. The reference run again with its single-node and
drift executions charged to the pass's views as the port's are must end
equal to the port (state hash, store events with the disruption
decisions, controller stats, the same oracle calls).
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
                            _shared_resource_axis, all_bound,
                            assert_same_run, decisions)

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


def charge_like_the_port(monkeypatch):
    """The reference's controller with each executed single-node or drift
    decision's placements put onto the views the rest of its pass solves
    against, as the port's `controllers/disruption._charge` does: the
    moved pods join the surviving view's pods and their summed requests
    its float32 `cum`. Only where the launch succeeded, as in the port."""
    from karpenter_tpu.controllers.disruption import \
        DisruptionController as D
    from karpenter_tpu.models.resources import Resources
    real = (D._single_node, D._replace, D._execute)

    def charge(views, victims, out):
        if not out.existing_placements:
            return
        moved = {f"{p.namespace}/{p.name}": p for v in victims
                 for p in v.pods}
        by_name = {v.name: v for v in views}
        for name, keys in out.existing_placements.items():
            view = by_name.get(name)
            pods = [moved[k] for k in keys if k in moved]
            if view is None or not pods:
                continue
            add = Resources()
            for p in pods:
                add = add.add(p.requests)
            vec = np.asarray(add.to_vector(), np.float32)
            n = min(len(view.virtual.cum), len(vec))
            view.virtual.cum[:n] += vec[:n]
            view.pods = view.pods + pods

    def single_node(self, pool, candidates, now, cat, views, budget):
        self._pass_views = views
        try:
            return real[0](self, pool, candidates, now, cat, views, budget)
        finally:
            self._pass_views = None

    def replace(self, pool, victims, reason, now, cat, views, *a, **k):
        self._pass_views = views
        try:
            return real[1](self, pool, victims, reason, now, cat, views,
                           *a, **k)
        finally:
            self._pass_views = None

    def execute(self, pool, victims, out, reason, now, source="greedy"):
        failed = []
        prov = self.provisioner
        launch = prov._launch

        def spy(*a, **k):
            launched, bad = launch(*a, **k)
            failed.append(bool(bad))
            return launched, bad
        prov._launch = spy
        try:
            real[2](self, pool, victims, out, reason, now, source)
        finally:
            del prov._launch
        views = getattr(self, "_pass_views", None)
        if views is not None and not any(failed):
            charge(views, victims, out)
    monkeypatch.setattr(D, "_single_node", single_node)
    monkeypatch.setattr(D, "_replace", replace)
    monkeypatch.setattr(D, "_execute", execute)


@pytest.mark.parametrize("backend", ["native", "device"])
def test_over_capacity_state_is_the_references(backend, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    ref, ref_flags = scale_down(REF, backend, ref_integrity,
                                ref_generate_catalog, monkeypatch)
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    charge_like_the_port(monkeypatch)
    charged, charged_flags = scale_down(REF, backend, ref_integrity,
                                        ref_generate_catalog, monkeypatch)
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    port, port_flags = scale_down(PORT, backend, port_integrity,
                                  port_generate_catalog, monkeypatch)
    # with the views charged, the reference's run is the port's
    assert_same_run(charged, port)
    assert port_flags == charged_flags
    assert port.solver.stats == charged.solver.stats
    # the reference reaches the state: existing nodes (claims), none a
    # new launch, each one a consolidation's pre-spun replacement
    flagged = {name for call in ref_flags for _, _, name in call}
    assert flagged and None not in flagged
    replacements = {name for _, _, _, note in decisions(ref)
                    if note.startswith("replacements: ")
                    for name in ast.literal_eval(note.split(": ", 1)[1])}
    assert flagged <= replacements
    assert {c for call in ref_flags for c, _, _ in call} == {"capacity"}
    assert ref.solver.stats["integrity_violations"] > 0
    if backend == "device":
        assert ref.solver.stats["device_fallbacks"] > 0
    # the port's same scale-down never does, and still consolidates
    assert not any(port_flags)
    assert port.solver.stats["integrity_violations"] == 0
    assert port.solver.stats["device_fallbacks"] == 0
    assert all_bound(port)
    assert port.disruption.stats["consolidated"] > 0
