"""Cross-run perf regression gate of the port:
`python -m karpenter_tpu_torch.obs.perf_gate`.

The counterpart of the JAX package's `tools/perf_gate.py`, with the same
arguments and exit-code rule. Loads the perf archive (the
`perf_archive.jsonl` ledger plus the checked-in legacy
`BENCH_r*.json` / `MULTICHIP_r*.json` wrappers), prints one family's run
trajectory, and gates that family's newest STAMPED comparable run against
the robust (median/MAD) baselines of every other comparable run of the
family. `--family torch` (the default) is the port's runs on one card,
`torch-mesh` its mesh runs; `bench` and `mesh` are the JAX package's TPU
history. Non-comparable runs (a CPU run of the port) are excluded from
baselines and never selected as candidates.

Exit 0 = no regression verdicts (including "nothing stamped to gate
yet"); exit 1 = at least one metric regressed past both the relative and
the dispersion threshold (obs/perfarchive.py documents the rule).

Usage:
    python -m karpenter_tpu_torch.obs.perf_gate [--archive PATH]
        [--root DIR] [--candidate RUN_ID]
        [--family bench|mesh|torch|torch-mesh] [--json]
"""

from __future__ import annotations

import argparse
import json

from .perfarchive import FAMILIES, PerfArchive


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archive", default=None,
                    help="archive JSONL path (default: repo root "
                         "perf_archive.jsonl or $KARPENTER_TPU_PERF_ARCHIVE)")
    ap.add_argument("--root", default=None,
                    help="directory scanned for legacy BENCH_r*/MULTICHIP_r* "
                         "wrappers (default: the archive's directory)")
    ap.add_argument("--candidate", default=None,
                    help="gate a specific run_id instead of the newest "
                         "stamped comparable run")
    ap.add_argument("--family", default="torch", choices=FAMILIES)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    if args.archive is not None:
        archive = PerfArchive(args.archive, root=args.root)
    elif args.root is not None:
        archive = PerfArchive(root=args.root)
    else:
        archive = PerfArchive.default()
    runs = archive.load()
    report = archive.gate(runs, candidate=args.candidate,
                          family=args.family)
    if args.json:
        print(json.dumps({
            "candidate": report.candidate, "reason": report.reason,
            "ok": report.ok,
            "verdicts": [vars(v) for v in report.verdicts]}))
    else:
        print(archive.trajectory(runs, family=args.family))
        print()
        print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
