"""Device telemetry report of the port:
`python -m karpenter_tpu_torch.obs.device_report`.

The counterpart of the JAX package's `tools/device_report.py`, with the
same flags, the same human table and one JSON line with the same keys. It
runs a few warm solve rounds against a synthetic cluster and prints

- the residency table (live/watermark bytes per owner kind),
- the transfer-attribution breakdown (reason x tenant x shape class),
- the upload-redundancy meter (how much of each warm upload of the
  request matrix is byte-identical to the previous one),
- the live-tensor cross-check (`DEVICEMEM.audit()` over the live CUDA
  tensors: accounted vs unaccounted bytes), and
- the device-resident breakdown: the same warm rounds through a facade
  with delta patching armed, rows patched vs re-uploaded vs clean
  (zero-transfer), bytes shipped vs avoided (ops/resident.py).

It runs on the card; `--device cpu` runs the same rounds with the
kernels' plain versions on the host (no live CUDA tensor to audit there).

Usage:
    python -m karpenter_tpu_torch.obs.device_report [--pods 2000]
        [--rounds 4] [--churn-pct 1.0] [--no-resident] [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pods", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--churn-pct", type=float, default=1.0,
                    help="%% of pods whose requests change each round "
                         "(0 = perfectly warm re-uploads)")
    ap.add_argument("--no-resident", action="store_true",
                    help="skip the device-resident patched-vs-reuploaded "
                         "breakdown phase")
    ap.add_argument("--device", default=None,
                    help="where the solves run (default: the CUDA card; "
                         "cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from ..catalog import generate_catalog
    from ..models.pod import Pod
    from ..models.resources import Resources
    from ..ops.encode import encode_catalog, encode_pods
    from ..ops.solver import resolve_device, solve_device, transfer_stats
    from . import devicemem as dm

    dev = resolve_device(args.device)

    shapes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"),
              ("2", "4Gi")]
    manifests = max(8, args.pods // 50)

    def mk(i: int, gen: int = 0) -> Pod:
        s = (i + gen) % manifests
        cpu, mem = shapes[s % len(shapes)]
        return Pod(name=f"d-{i}-g{gen}",
                   requests=Resources.parse({"cpu": cpu, "memory": mem}),
                   labels={"app": f"svc-{s}"})

    cat = encode_catalog(generate_catalog())
    churn = max(0, int(args.pods * args.churn_pct / 100.0))
    pods = [mk(i) for i in range(args.pods)]
    u0, r0 = transfer_stats()
    # round 0 is the COLD upload: it seeds the view's row hashes and
    # must not dilute the warm-round redundancy fraction (all its
    # bytes are first-sight "changed" by definition)
    solve_device(cat, encode_pods(pods, cat), device=dev)
    i0, t0 = dm.UPLOADS.totals()
    for rnd in range(1, args.rounds):
        if churn:
            # churn the tail: a few manifests change, the rest of the
            # request matrix should read as redundant upload bytes
            for j in range(churn):
                pods[-(j + 1)] = mk(args.pods + j, gen=rnd)
        enc = encode_pods(pods, cat)
        solve_device(cat, enc, device=dev)
    uploads, reads = (transfer_stats()[0] - u0,
                      transfer_stats()[1] - r0)
    ident, total = dm.UPLOADS.totals()
    warm_ident, warm_total = ident - i0, total - t0
    frac = warm_ident / warm_total if warm_total else 0.0
    audit = dm.DEVICEMEM.audit()
    res = dm.DEVICEMEM.snapshot()
    xfer = dm.TRANSFERS.snapshot()

    print(f"device telemetry on {dev} — {args.pods} pods x {args.rounds} "
          f"rounds ({args.churn_pct:g}% churn), {uploads} uploads / "
          f"{reads} reads")
    print(f"\n  residency (live {res['live_bytes']:,} B, watermark "
          f"{res['watermark_bytes']:,} B)")
    print(f"  {'kind':<16} {'bytes':>14} {'groups':>7}")
    for kind, row in res["kinds"].items():
        print(f"  {kind:<16} {row['bytes']:>14,} {row['groups']:>7}")
    print(f"\n  transfers (h2d {xfer['h2d_bytes']:,} B, d2h "
          f"{xfer['d2h_bytes']:,} B)")
    print(f"  {'reason':<16} {'tenant':<10} {'shape class':<14} "
          f"{'bytes':>14} {'calls':>6}")
    for row in xfer["rows"]:
        print(f"  {row['reason']:<16} {row['tenant']:<10} "
              f"{row['shape_class']:<14} {row['bytes']:>14,} "
              f"{row['calls']:>6}")
    print(f"\n  upload redundancy: {frac:.4f} of warm-round request-"
          f"matrix bytes identical to the previous upload "
          f"({warm_ident:,}/{warm_total:,} B) — the delta-upload "
          f"headroom")
    if "coverage" in audit:
        print(f"  live-tensor audit: coverage {audit['coverage']:.4f} "
              f"({audit['unaccounted_bytes']:,} B unaccounted of "
              f"{audit['live_arrays']} live arrays)")

    resident = None
    if not args.no_resident:
        # phase 2: SPEND the measured headroom — the same warm rounds
        # through a facade with device-resident delta patching armed,
        # reported as a patched-vs-reuploaded breakdown
        from ..catalog import CatalogProvider
        from ..models.nodepool import NodePool
        from ..ops.facade import Solver
        from ..ops.resident import RESIDENT
        RESIDENT.reset()
        pool = NodePool(name="device-report")
        facade = Solver(CatalogProvider(generate_catalog),
                        backend="device", device=dev)
        rpods = [mk(i) for i in range(args.pods)]
        facade.solve(rpods, pool)              # cold seed
        h_res0 = dm.TRANSFERS.totals()[0]
        for rnd in range(1, args.rounds):
            for j in range(churn):
                rpods[-(j + 1)] = mk(args.pods + j, gen=rnd)
            facade.solve(rpods, pool)
        h_res = dm.TRANSFERS.totals()[0] - h_res0
        snap = RESIDENT.snapshot()
        st = snap["stats"]
        shipped = st["patched_bytes"] + st["full_bytes"]
        print(f"\n  device-resident breakdown ({args.rounds - 1} warm "
              f"rounds, residency {'armed' if snap['armed'] else 'OFF'})")
        print(f"  {'outcome':<16} {'rows':>10} {'bytes':>14}")
        print(f"  {'patched':<16} {st['rows_patched']:>10,} "
              f"{st['patched_bytes']:>14,}")
        print(f"  {'avoided':<16} "
              f"{st['rows_total'] - st['rows_patched']:>10,} "
              f"{st['avoided_bytes']:>14,}")
        print(f"  {'full reupload':<16} {st['full_uploads']:>10,} "
              f"{st['full_bytes']:>14,}")
        print(f"  patched-rows fraction {snap['patched_rows_frac']:.4f}; "
              f"warm h2d {h_res:,} B shipped vs "
              f"{st['avoided_bytes']:,} B avoided "
              f"(clean zero-transfer solves: {st['clean_hits']})")
        resident = {"patched_rows_frac": snap["patched_rows_frac"],
                    "warm_h2d_bytes": h_res,
                    "shipped_bytes": shipped,
                    "stats": st}
    print()
    print(json.dumps({
        "pods": args.pods, "rounds": args.rounds,
        "churn_pct": args.churn_pct,
        "uploads": uploads, "reads": reads,
        "upload_redundant_frac": round(frac, 4),
        "residency": {"live_bytes": res["live_bytes"],
                      "watermark_bytes": res["watermark_bytes"],
                      "kinds": res["kinds"]},
        "transfers": {"h2d_bytes": xfer["h2d_bytes"],
                      "d2h_bytes": xfer["d2h_bytes"]},
        "audit": audit,
        "resident": resident,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
