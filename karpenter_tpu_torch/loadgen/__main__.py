"""Soak CLI: drive the fleet open-loop and report.

    python -m karpenter_tpu_torch.loadgen                  # list catalog
    python -m karpenter_tpu_torch.loadgen soak_smoke --repeat 2
    python -m karpenter_tpu_torch.loadgen soak_overload --seed 7 --tenants 8
    python -m karpenter_tpu_torch.loadgen soak_overload --no-admission
    python -m karpenter_tpu_torch.loadgen soak_smoke --backend device \
        --device cpu

The flags are the reference's (`python -m karpenter_tpu.loadgen`), plus
`--device`: the service and the shards run on the CUDA card unless it
names another (`--device cpu` runs the kernels' plain versions).
`--backend` defaults to the device rung (the reference's to host).
With --repeat > 1 every repeat must produce identical end-state hashes,
fault fingerprints, AND load fingerprints (the three-digest soak repeat
contract); exit status is non-zero when any run fails its invariants or
a repeat diverges.
"""

from __future__ import annotations

import argparse
import sys


def run_matrix(scenario: str, seeds, repeat: int = 1,
               **runner_kwargs) -> bool:
    """Run a soak scenario across seeds x repeats, printing every
    report; returns True when anything FAILED (the fleet CLI's matrix
    semantics, extended to the third digest)."""
    from .soak import SoakRunner
    failed = False
    for seed in seeds:
        reports = []
        for _ in range(max(1, repeat)):
            rep = SoakRunner(scenario, seed=seed, **runner_kwargs).run()
            reports.append(rep)
            print(rep.summary())
            failed |= not rep.ok
        if repeat > 1:
            digests = {(r.soak_hash, r.fault_fingerprint,
                        r.load_fingerprint) for r in reports}
            if len(digests) != 1:
                print(f"[FAIL] {scenario}: {repeat} runs at seed {seed} "
                      f"diverged: {sorted(digests)}")
                failed = True
            else:
                print(f"  reproducible: {repeat} runs identical "
                      f"({reports[0].tenants} tenants, "
                      f"{reports[0].stats['offered_pods']:g} pods offered)")
    return failed


def main(argv=None) -> int:
    from .soak import SOAK_SCENARIOS

    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.loadgen",
        description="run open-loop soak scenarios")
    ap.add_argument("scenario", nargs="?", default="",
                    help="soak scenario name (empty: list catalog)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="shard count (0: the scenario's default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=0,
                    help="run seeds 0..N-1 instead of the single --seed")
    ap.add_argument("--repeat", type=int, default=1,
                    help="re-run each (scenario, seed) and require the "
                         "three repeat digests to agree")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="batches/sec per tenant (0: scenario default)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="open-loop drive window in sim seconds "
                         "(0: scenario default; arrivals scheduled past "
                         "it still fire — the window only extends)")
    ap.add_argument("--backend", default="device",
                    help="shared solver backend (device | native | host "
                         "| hybrid | mesh; default: device, on the card "
                         "unless --device names another)")
    ap.add_argument("--batch", action="store_true",
                    help="arm the service's batched+pipelined dispatch "
                         "(soak_smoke/soak_overload default to it)")
    ap.add_argument("--no-batch", action="store_true",
                    help="escape hatch: force the serial pump even for "
                         "scenarios that default to batched dispatch")
    ap.add_argument("--no-admission", action="store_true",
                    help="disarm shedding/deferral — the negative "
                         "harness: the watchdog's overload_unbounded "
                         "invariant must fire past saturation")
    ap.add_argument("--device", default=None,
                    help="torch device of the service and the shards "
                         "(default: the CUDA card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    if not args.scenario:
        for sc in SOAK_SCENARIOS.values():
            print(f"{sc.name} [{sc.tenants} tenants, "
                  f"{sc.duration:g}s drive]: {sc.description}")
        return 0

    seeds = (list(range(args.seeds)) if args.seeds > 0 else [args.seed])
    failed = run_matrix(args.scenario, seeds, repeat=args.repeat,
                        tenants=args.tenants or None,
                        backend=args.backend,
                        batch=(False if args.no_batch
                               else (args.batch or None)),
                        arrival_rate=args.arrival_rate or None,
                        duration=args.duration or None,
                        admission=False if args.no_admission else None,
                        device=args.device)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
