"""One run of one benchmark cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's inputs from the seed and the program's objects,
loads (or, in a fresh checkout, builds) the kernels and warms the cell's
shapes; then the traffic driver measures for --seconds. With --trace 1
the program's tracer and torch.profiler run over the window and the
per-layer metrics are reported instead of the end-to-end ones. After the
window the reference judges what the window produced. The last line of
standard output is the result: correct, attempted, failed, metrics,
device (breakdown when traced) and, last, each number compared with its
limit; the comparisons are also the last lines on standard error.

Exits 2 without a result when there is no CUDA card (or fewer than the
cell asks for), and 3 when JAX or the JAX package is loaded once the
window has closed: looked for last, after the judgement and every
reader, just before the result would be printed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.harness import check as V  # noqa: E402
from benchmark.harness import registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")
OUT_DIR = "bench_out"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_or_exit(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card (torch.cuda.is_available() is "
              "false); no result", file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} cards and "
              f"{torch.cuda.device_count()} exist; no result",
              file=sys.stderr)
        sys.exit(2)


def loaded_forbidden() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(args, device: str = "cuda", root: str = registry.ROOT) -> dict:
    """Set-up, window, judgement and metrics of one run; the result line
    as a dict. `device` is where the program runs ("cpu" runs its plain
    versions: the CPU tests drive a run this way)."""
    import torch
    from benchmark.harness import port
    cell = registry.workload(args.workload, root)
    bench = registry.spec(root)
    drv = registry.driver(cell["driver"], root)
    on_card = device != "cpu"
    state = drv.setup(cell, args.seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = port.counters()
    stats0 = drv.stats(state)
    traced = None
    if args.trace:
        from benchmark.harness.trace import Traced
        traced = Traced(OUT_DIR, f"{args.workload}.s{args.seed}")
    t_setup = time.perf_counter() - T0
    with traced if traced is not None else contextlib.nullcontext():
        # each request: (submitted, answered, pods decided or None)
        reqs = drv.window(state, args.seconds)
    after = port.counters()
    stats1 = drv.stats(state)
    summary = traced.summary() if traced is not None else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # the program's state goes before the reference runs
    drv.release(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, work = drv.judge(state, args.seed, bool(args.trace))
    ok, rows = V.verdict(numbers, cell["limits"])

    done = [r for r in reqs if r[2] is not None]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{args.workload}.s{args.seed}"
                           f".t{args.trace}.requests.json"), "w") as f:
        # each request: submitted (s after the first), latency (s), pods
        json.dump([[r[0] - reqs[0][0], r[1] - r[0], r[2]] for r in reqs],
                  f)
    window_s = max(r[1] for r in done) - min(r[0] for r in reqs) \
        if done else args.seconds
    e2e = {"pods_per_s": sum(r[2] for r in done) / window_s,
           "setup_s": t_setup}
    metrics = {}
    if not args.trace:
        for m in registry.metrics_of(args.workload, False, bench, root):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"requests": done, "solves": len(reqs),
               "spans": traced.sums, "trace": summary,
               "counters": {k: after[k] - before[k] for k in after},
               "stats": {k: stats1[k] - stats0[k] for k in stats1},
               "work": work}
        for m in registry.metrics_of(args.workload, True, bench, root):
            value = registry.reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # a request whose answer never came is not correct either
    result = {"correct": bool(ok) and len(done) == len(reqs),
              "attempted": len(reqs),
              "failed": len(reqs) - len(done), "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": cell.get("chips", 1),
                         "memory_peak_bytes": int(peak)}}
    if on_card:
        result["device"]["power_limit"] = power_limit()
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]}
                        for r in rows}
    V.print_rows(rows, numbers)
    return result


def main(argv=None, device: str = "cuda", root: str = registry.ROOT) -> int:
    args = parse(argv)
    cell = registry.workload(args.workload, root)
    card_or_exit(cell.get("chips", 1))
    result = run(args, device, root)
    # last of all, after the judgement and every reader have run
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: {', '.join(bad)} loaded in the process that "
              f"reports; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
