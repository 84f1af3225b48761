"""The watchdog findings that chip_smoke holds its operator phase, its
storm and its soak to (`OP_REF_FINDINGS`, `STORM_REF_FINDINGS`,
`SOAK_REF_FINDINGS`): the same procedures run on the CPU through one
package's `make_sim`, `ScenarioRunner` and `SoakRunner`.

    JAX_PLATFORMS=cpu python3 tools/ref_findings.py operator karpenter_tpu native
    JAX_PLATFORMS=cpu python3 tools/ref_findings.py storm karpenter_tpu native
    JAX_PLATFORMS=cpu python3 tools/ref_findings.py soak karpenter_tpu device
    python3 tools/ref_findings.py storm karpenter_tpu_torch device

The package is `karpenter_tpu` (the reference) or `karpenter_tpu_torch`
(the port, its device rung on the CPU: the kernels' plain versions). The
operator and storm runs take minutes, the soak seconds. It prints the end
state hash and every finding (the soak: for each of chip_smoke's
`SOAK_SCENARIOS` at seed 0, the fleet watchdog's and every shard's).
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402


def _mod(pkg: str, path: str):
    return importlib.import_module(f"{pkg}.{path}")


def _restart(pkg: str) -> dict:
    """The sequences chip_smoke restarts, and the reference's catalog
    encoded once (its resource axis); returns make_sim's device kwarg."""
    _mod(pkg, "models.nodeclaim")._seq = itertools.count()
    _mod(pkg, "models.pod")._uid = itertools.count()
    _mod(pkg, "cloud.fake")._ids = itertools.count(1)
    if pkg == "karpenter_tpu":
        from karpenter_tpu.catalog import generate_catalog
        from karpenter_tpu.ops.encode import encode_catalog
        encode_catalog(generate_catalog())
        return {}
    return {"device": "cpu"}


def operator(pkg: str, backend: str):
    """chip_smoke.OperatorRun's procedure: OP_PODS grid pods up, 60%
    deleted, disruption to quiet (OP_QUIET passes), OP_BURSTS bursts."""
    kw = _restart(pkg)
    models = _mod(pkg, "models")
    sim = _mod(pkg, "sim").make_sim(
        types=_mod(pkg, "catalog").generate_catalog(), backend=backend,
        cloud_config=_mod(pkg, "cloud.fake").FakeCloudConfig(**C.OP_CLOUD),
        **kw)
    d, state = sim.disruption, {"quiet": 0, "sig": None}
    real = d.reconcile

    def bound():
        return all(p.node_name is not None for p in sim.store.pods.values())

    def reconcile(now):
        out = real(now)
        sig = (tuple(d.stats.get(k, 0) for k in C.DECISION_STATS),
               sum(e[0] == "disruption" for e in sim.store.events))
        quiet = (not d._pending and sig == state["sig"] and bound()
                 and not any(c.is_deleting()
                             for c in sim.store.nodeclaims.values()))
        state["quiet"] = state["quiet"] + 1 if quiet else 0
        state["sig"] = sig
        return out
    d.reconcile = reconcile
    pods = C.grid_pods(models, C.OP_PODS, C.SEED)
    for p in pods:
        sim.store.add_pod(p)
    assert sim.engine.run_until(bound, timeout=C.OP_SCALE_UP_CAP, step=1.0)
    import numpy as np
    rng = np.random.default_rng(1)
    for i in rng.permutation(len(pods))[: int(len(pods) * C.OP_DELETE)]:
        sim.store.delete_pod(pods[i].namespace, pods[i].name)
    state["quiet"], state["sig"] = 0, None
    assert sim.engine.run_until(lambda: state["quiet"] >= C.OP_QUIET,
                                timeout=C.OP_SCALE_DOWN_CAP, step=5.0)
    for b in range(C.OP_BURSTS):
        for i in range(C.OP_BURST):
            sim.store.add_pod(models.Pod(
                name=f"burst-{b}-{i}", requests=models.Resources.parse(
                    {"cpu": "100m", "memory": "128Mi"})))
        sim.provisioner.reconcile(sim.clock.now())
        assert sim.engine.run_until(bound, timeout=120.0, step=1.0)
    return sim


def storm(pkg: str, backend: str):
    """chip_smoke's storm: the soak's rules over STORM_WAVES of grid pods
    on the 810-type catalog."""
    kw = _restart(pkg)
    models = _mod(pkg, "models")
    types = _mod(pkg, "catalog").generate_catalog()

    def workload(sim):
        origin = sim.fault_plan.origin
        pods = C.grid_pods(models, sum(n for _, n in C.STORM_WAVES), C.SEED)
        waves, at, fired = [], 0, set()
        for t, n in C.STORM_WAVES:
            waves.append((t, pods[at:at + n]))
            at += n

        def arrivals(now):
            for k, (t, wave) in enumerate(waves):
                if k not in fired and now - origin >= t:
                    fired.add(k)
                    for p in wave:
                        sim.store.add_pod(p)
        arrivals(sim.clock.now())
        sim.engine.add_hook(arrivals)
    faults = _mod(pkg, "faults")
    sc = dataclasses.replace(faults.SCENARIOS["soak"], name="storm",
                             backend=backend, types=lambda: types,
                             workload=workload)
    runner = faults.ScenarioRunner(sc, seed=0, **kw)
    runner.run()
    return runner.last_sim


def soak(pkg: str, backend: str) -> None:
    """chip_smoke's soak phase: each of SOAK_SCENARIOS at seed 0 through
    the package's SoakRunner; prints the three digests and the findings
    of the fleet watchdog and of every shard's."""
    for name in C.SOAK_SCENARIOS:
        kw = _restart(pkg)
        t0 = time.perf_counter()
        runner = _mod(pkg, "loadgen").SoakRunner(name, seed=0,
                                                 backend=backend, **kw)
        rep = runner.run()
        print(f"soak {name} {pkg} {backend}: wall "
              f"{time.perf_counter() - t0:.1f} s, ok {rep.ok}, soak_hash "
              f"{rep.soak_hash[:16]}, fault {rep.fault_fingerprint[:16]}, "
              f"load {rep.load_fingerprint[:16]}")
        for where, wd in [("fleet", runner.watchdog)] + [
                (s.name, s.sim.watchdog) for s in runner.shards]:
            for f in wd.findings:
                print(f"  {where}: {f.invariant} {f.severity} {f.key}: "
                      f"{f.message}")


def main() -> None:
    what, pkg, backend = sys.argv[1:4]
    os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)  # armed: the default
    if what == "soak":
        soak(pkg, backend)
        return
    t0 = time.perf_counter()
    sim = {"operator": operator, "storm": storm}[what](pkg, backend)
    wd = sim.watchdog
    print(f"{what} {pkg} {backend}: wall {time.perf_counter() - t0:.1f} s, "
          f"end {_mod(pkg, 'faults.runner').state_hash(sim)[:16]}, "
          f"watchdog {wd.stats}")
    for f in wd.findings:
        print(f"  {f.invariant} {f.severity} {f.key}: {f.message}")


if __name__ == "__main__":
    main()
