"""Fleet CLI: drive a tenant fleet through one process and report.

    python -m karpenter_tpu_torch.fleet                          # list catalog
    python -m karpenter_tpu_torch.fleet fleet_smoke --tenants 50
    python -m karpenter_tpu_torch.fleet fleet_noisy_neighbor --seed 7
    python -m karpenter_tpu_torch.fleet fleet_smoke --seeds 2 --repeat 2
    python -m karpenter_tpu_torch.fleet fleet_smoke --batch --device cpu
    python -m karpenter_tpu_torch.fleet federation_smoke --federate \
        --server-addr 127.0.0.1:<port>

The port's copy of the reference's fleet CLI (`python -m
karpenter_tpu.fleet`), plus `--device`: the service and the shards run on
the CUDA card unless it names another (`--device cpu` runs the kernels'
plain versions). `--federate` routes the batched buckets through the
federation plane: an embedded `SolverServer` on the same device unless
`--server-addr` dials one (`python -m
karpenter_tpu_torch.federation.server`). Exit status is non-zero when any
run fails its invariants or a repeat diverges.
"""

from __future__ import annotations

import argparse
import sys


def run_matrix(scenario: str, seeds, repeat: int = 1, **runner_kwargs) -> bool:
    """Run a fleet scenario across `seeds`, `repeat` times each, printing
    every report; with repeat > 1, require identical per-tenant end-state
    hashes AND fault-timeline fingerprints (and the fleet-level wire
    fingerprint). Returns True when anything FAILED — the ONE
    implementation both this CLI and the faults CLI's `fleet` group
    dispatch through."""
    from .runner import FleetRunner
    failed = False
    for seed in seeds:
        reports = []
        for _ in range(max(1, repeat)):
            rep = FleetRunner(scenario, seed=seed, **runner_kwargs).run()
            reports.append(rep)
            print(rep.summary())
            failed |= not rep.ok
        if repeat > 1:
            digests = {(rep.fleet_hash, rep.fleet_fingerprint,
                        rep.wire_fingerprint)
                       for rep in reports}
            if len(digests) != 1:
                print(f"[FAIL] {scenario}: {repeat} runs at seed {seed} "
                      f"diverged: {sorted(digests)}")
                failed = True
            else:
                print(f"  reproducible: {repeat} runs identical "
                      f"({reports[0].tenants} tenants)")
    return failed


def main(argv=None) -> int:
    from .scenarios import FLEET_SCENARIOS

    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.fleet",
        description="run multi-tenant fleet scenarios")
    ap.add_argument("scenario", nargs="?", default="",
                    help="fleet scenario name (empty: list catalog)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="shard count (0: the scenario's default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=0,
                    help="run seeds 0..N-1 instead of the single --seed")
    ap.add_argument("--repeat", type=int, default=1,
                    help="re-run each (scenario, seed) and require "
                         "identical per-tenant hashes")
    ap.add_argument("--inflight-cap", type=int, default=0,
                    help="per-tenant solve cap per scheduling window "
                         "(0: scenario/service default)")
    ap.add_argument("--backend", default="host",
                    help="shared solver backend (host | native | device "
                         "| hybrid | mesh)")
    ap.add_argument("--batch", action="store_true",
                    help="arm the service's batched+pipelined dispatch "
                         "engine (per-tenant hashes and fingerprints are "
                         "identical with it on or off)")
    ap.add_argument("--journal-dir", default="",
                    help="directory for per-tenant intent-journal WAL "
                         "files (empty: in-memory journals)")
    ap.add_argument("--device", default=None,
                    help="torch device of the service and the shards "
                         "(default: the CUDA card)")
    ap.add_argument("--federate", action="store_true",
                    help="route batched buckets through the federation "
                         "plane (karpenter_tpu_torch/federation): an "
                         "embedded SolverServer behind an in-memory wire "
                         "unless --server-addr dials a real one. Implies "
                         "--batch and a device backend — per-tenant "
                         "hashes and fingerprints must match the "
                         "in-process run (the cross-process determinism "
                         "contract)")
    ap.add_argument("--server-addr", default="",
                    help="host:port of a running federation solver "
                         "server (python -m karpenter_tpu_torch."
                         "federation.server); empty with --federate "
                         "embeds one")
    args = ap.parse_args(argv)

    if not args.scenario:
        for sc in FLEET_SCENARIOS.values():
            print(f"{sc.name} [{sc.tenants} tenants]: {sc.description}")
        return 0

    seeds = (list(range(args.seeds)) if args.seeds > 0 else [args.seed])
    runner_kwargs = dict(tenants=args.tenants or None,
                         backend=args.backend,
                         batch=args.batch or None,
                         inflight_cap=args.inflight_cap or None,
                         journal_dir=args.journal_dir or None,
                         device=args.device)
    sc_meta = FLEET_SCENARIOS.get(args.scenario)
    if args.federate and sc_meta is not None and sc_meta.federate \
            and not args.server_addr:
        # federate-by-default scenarios (fed_*) already build their own
        # embedded server inside FleetRunner — and must, so mid-run
        # actuators (the fed_server_restart drive hook) can reach it.
        # --federate is then redundant; a --server-addr still overrides.
        pass
    elif args.federate:
        from ..federation import build_federated_service
        # federation only engages for device-batchable buckets: a host
        # backend would stage nothing for the wire and silently test the
        # local path, so --federate picks device unless overridden
        if args.backend == "host":
            runner_kwargs["backend"] = "device"
        runner_kwargs["batch"] = True

        def service_factory(clock, kw,
                            _addr=args.server_addr, _sc=args.scenario):
            # run_id from scenario name, never wall clock: envelopes
            # must be byte-identical across seeded repeats
            return build_federated_service(clock, server_addr=_addr,
                                           run_id=f"fed-{_sc}", **kw)
        runner_kwargs["service_factory"] = service_factory
    failed = run_matrix(args.scenario, seeds, repeat=args.repeat,
                        **runner_kwargs)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
