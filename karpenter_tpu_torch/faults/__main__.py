"""Chaos CLI: run catalog scenarios and print their reports.

    python -m karpenter_tpu_torch.faults                  # list the catalog
    python -m karpenter_tpu_torch.faults smoke            # one scenario
    python -m karpenter_tpu_torch.faults all              # whole catalog
    python -m karpenter_tpu_torch.faults restart          # crash-restart group
    python -m karpenter_tpu_torch.faults ice_storm --seed 7 --repeat 2
    python -m karpenter_tpu_torch.faults restart --seeds 5 --repeat 2
    python -m karpenter_tpu_torch.faults fleet            # fleet scenario group
    python -m karpenter_tpu_torch.faults smoke --device cpu

The port's copy of the reference's chaos CLI (`python -m
karpenter_tpu.faults`), plus `--device`: runs go on the CUDA card unless
it names another (`--device cpu` runs the kernels' plain versions).

--repeat N re-runs the same (scenario, seed) and fails unless every run
produced the identical end-state hash and fault-timeline fingerprint.
--seeds N widens the matrix to seeds 0..N-1 (each still honoring
--repeat). Scenarios carrying CrashPoint rules are driven by
RestartRunner (the engine is torn down and rebuilt at each injected
crash); everything else runs under ScenarioRunner. Exit status is
non-zero when any run fails its invariants.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..fleet.__main__ import run_matrix as fleet_run_matrix
    from ..fleet.scenarios import FLEET_SCENARIOS
    from .runner import RestartRunner, ScenarioRunner
    from .scenarios import SCENARIOS

    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.faults",
        description="run chaos scenarios from the catalog")
    ap.add_argument("scenario", nargs="?", default="",
                    help="scenario name, 'all', or 'restart' (the "
                         "crash-restart group; empty: list catalog)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=0,
                    help="run seeds 0..N-1 instead of the single --seed "
                         "(the crash-audit matrix)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="re-run and require identical hashes")
    ap.add_argument("--skip-slow", action="store_true",
                    help="with 'all': skip soak scenarios")
    ap.add_argument("--device", default=None,
                    help="torch device of the device rung and the "
                         "consolidation screen (default: the CUDA card)")
    args = ap.parse_args(argv)

    if not args.scenario:
        for sc in SCENARIOS.values():
            tag = (" [slow]" if sc.slow else "") + \
                (" [restart]" if sc.restart else "")
            print(f"{sc.name}{tag}: {sc.description}")
        for fsc in FLEET_SCENARIOS.values():
            print(f"{fsc.name} [fleet x{fsc.tenants}]: {fsc.description}")
        return 0

    if args.scenario == "all":
        names = sorted(SCENARIOS)
        if args.skip_slow:
            names = [n for n in names if not SCENARIOS[n].slow]
    elif args.scenario == "restart":
        names = sorted(n for n, sc in SCENARIOS.items() if sc.restart)
    elif args.scenario == "fleet":
        names = sorted(FLEET_SCENARIOS)
    else:
        names = [args.scenario]

    seeds = (list(range(args.seeds)) if args.seeds > 0 else [args.seed])
    failed = False
    for name in names:
        if name in FLEET_SCENARIOS:
            failed |= fleet_run_matrix(name, seeds, repeat=args.repeat,
                                       device=args.device)
            continue
        runner_cls = (RestartRunner if SCENARIOS[name].restart
                      else ScenarioRunner)
        for seed in seeds:
            reports = [runner_cls(name, seed=seed, device=args.device).run()
                       for _ in range(max(1, args.repeat))]
            for rep in reports:
                print(rep.summary())
                failed |= not rep.ok
            if args.repeat > 1:
                hashes = {(r.end_hash, r.fault_fingerprint)
                          for r in reports}
                if len(hashes) != 1:
                    print(f"[FAIL] {name}: {args.repeat} runs at seed "
                          f"{seed} diverged: {sorted(hashes)}")
                    failed = True
                else:
                    print(f"  reproducible: {args.repeat} runs identical")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
