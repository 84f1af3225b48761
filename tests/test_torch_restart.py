"""The port's crash-restart runner (`faults/runner.RestartRunner`) held
against the JAX reference's.

`restart_smoke`, `crash_drain` and `crash_launch_storm` (the warm-path
crash drill; with the first two, the reference's `make crash-audit`
group) run at seeds 0 and 1 through both packages — the reference at its
own backend, the port on the device rung with `device="cpu"` — with the
claim-name, pod-uid and instance-id sequences restarted at the same value
in both before each run. End hash, fault fingerprint, fault count and the
restart stats, the final boot's watchdog findings included, must be
equal, exactly. Then the reference's
`tests/test_chaos.py` restart cases rerun through the port.
"""

from __future__ import annotations

import dataclasses
import itertools

import pytest

from karpenter_tpu.catalog import generate_catalog
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.faults import RestartRunner as RefRunner
from karpenter_tpu.models import nodeclaim as ref_nodeclaim
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.ops.encode import encode_catalog

from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.faults import SCENARIOS, RestartRunner
from karpenter_tpu_torch.models import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res

RESTART = ("crash_drain", "crash_launch_storm", "restart_smoke")
STATS = ("restarts", "launch_dedups", "intents_opened", "intents_committed",
         "intents_aborted", "intents_reaped", "gc_inflight_skipped",
         "ice_marks", "watchdog_findings", "watchdog_findings_warning",
         "watchdog_evals")


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
    from karpenter_tpu.ops.delta import DELTA
    from karpenter_tpu.ops.resident import RESIDENT
    ref_pod._sig_intern.clear()
    RESIDENT.reset()
    DELTA.reset()
    from karpenter_tpu_torch.ops.delta import DELTA as PORT_DELTA
    from karpenter_tpu_torch.ops.resident import RESIDENT as PORT_RESIDENT
    PORT_RESIDENT.reset()
    PORT_DELTA.reset()
    INTEGRITY.reset()
    _reset_planes()


def _reset_sequences() -> None:
    _reset_planes()
    for nodeclaim, pod, fake in ((ref_nodeclaim, ref_pod, ref_fake),
                                 (port_nodeclaim, port_pod, port_fake)):
        nodeclaim._seq = itertools.count()
        pod._uid = itertools.count()
        fake._ids = itertools.count(1)


def _reset_planes() -> None:
    """Both packages' delta and resident planes and explain recorders
    start each run empty: memo keys hold id(facade), and a reused id must
    not meet a dead facade's entry in one package and not in the other."""
    from karpenter_tpu.obs.explain import RECORDER as REF_RECORDER
    from karpenter_tpu.ops.delta import DELTA as REF_DELTA
    from karpenter_tpu.ops.resident import RESIDENT as REF_RESIDENT
    from karpenter_tpu_torch.obs.explain import RECORDER as PORT_RECORDER
    from karpenter_tpu_torch.ops.delta import DELTA as PORT_DELTA
    from karpenter_tpu_torch.ops.resident import RESIDENT as PORT_RESIDENT
    for plane in (REF_DELTA, REF_RESIDENT, REF_RECORDER, PORT_DELTA,
                  PORT_RESIDENT, PORT_RECORDER):
        plane.reset()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", RESTART)
def test_restart_scenario_equals_the_reference(name, seed):
    _reset_sequences()
    ref = RefRunner(name, seed=seed).run()
    _reset_sequences()
    port = RestartRunner(dataclasses.replace(SCENARIOS[name],
                                             backend="device"),
                         seed=seed, device="cpu").run()
    assert ref.ok, ref.summary()
    assert port.ok, port.summary()
    assert port.end_hash == ref.end_hash
    assert port.fault_fingerprint == ref.fault_fingerprint
    assert port.faults_injected == ref.faults_injected
    assert port.sim_seconds == ref.sim_seconds
    for k in STATS:
        assert port.stats[k] == ref.stats[k], k
    assert port.stats["watchdog_findings_warning"] == 0
    assert port.stats == ref.stats


@pytest.mark.parametrize("name", RESTART)
def test_restart_scenarios_converge(name):
    """Every restart scenario converges with clean invariants, actually
    crashed, and resolved every intent it opened."""
    rep = RestartRunner(name, seed=0, device="cpu").run()
    assert rep.ok, rep.summary()
    assert rep.stats["restarts"] >= 1
    assert rep.stats["intents_opened"] > 0
    assert (rep.stats["intents_committed"] + rep.stats["intents_aborted"]
            + rep.stats["intents_reaped"] == rep.stats["intents_opened"])


def test_restart_smoke_reproducible():
    a = RestartRunner("restart_smoke", seed=5, device="cpu").run()
    b = RestartRunner("restart_smoke", seed=5, device="cpu").run()
    assert a.ok and b.ok, (a.summary(), b.summary())
    assert a.fault_fingerprint == b.fault_fingerprint
    assert a.end_hash == b.end_hash
    assert a.stats["restarts"] == b.stats["restarts"] >= 1


def test_restart_resets_the_ports_claim_sequence():
    """A rebuilt process mints claim names from zero again in the port's
    own models.nodeclaim (rehydration then advances past adopted names);
    the reference's sequence is never touched."""
    ref_seq, port_seq = ref_nodeclaim._seq, port_nodeclaim._seq
    rep = RestartRunner("restart_smoke", seed=0, device="cpu").run()
    assert rep.ok and rep.stats["restarts"] == 2
    assert ref_nodeclaim._seq is ref_seq
    assert port_nodeclaim._seq is not port_seq
