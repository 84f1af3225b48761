"""One A/B sample of the port's loop on the card, in the tree it runs in:
chip_smoke's operator procedure on the device rung (its disruption-pass
and burst-reconcile medians) and fleet_noisy_neighbor serial (its wall).
Compare two trees only inside one call, in turns (parent, change, change,
parent): unpack the parent with `git archive` into a directory that
.gitignore lists and run this from each tree's root,

    (cd build/parent && python3 ../../tools/port_ab.py)
    python3 tools/port_ab.py
    python3 tools/port_ab.py off    # the watchdog and explain recorder off

Prints one line `AB {json}`. Needs a CUDA card.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())   # the tree this runs in


def main() -> None:
    import chip_smoke as C
    if sys.argv[1:] == ["off"]:
        from karpenter_tpu_torch import sim as S
        from karpenter_tpu_torch.obs.explain import RECORDER
        RECORDER.enabled = False
        S.make_sim = functools.partial(S.make_sim, watchdog=False)
    C.phase_build()
    run = C.OperatorRun("device", profile_pass=False)
    times = run.drive()
    passes = [ms for (stage, c), walls in run.walls.items()
              if c == "disruption" and stage == "scale_down" for ms in walls]
    out = {"tree": C.__file__, "pass_median_ms": statistics.median(passes),
           "burst_median_ms": statistics.median(run.burst_ms),
           "passes": len(passes), "phase_ms": times["phase_ms"]}
    from karpenter_tpu_torch.fleet import FleetRunner
    C.reset_sequences()
    t0 = time.perf_counter()
    FleetRunner("fleet_noisy_neighbor", backend="device", batch=False).run()
    out["noisy_ms"] = (time.perf_counter() - t0) * 1e3
    print("AB", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
