"""The control of a cell's comparison: the reference put in the program's
place with one guarantee of the configuration broken, judged as a run's
answers are. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
    python3 benchmark/control.py --workload <cell> --seeds <n> ... --fault own_node

The control plans in bfloat16, the precision below the float32 the
configuration states for the fit and the price per slot: every value of
the fit and each price per slot rounded to bfloat16, the shortcut a
faster fit would be tempted by. At the cell's own size it judges the
same requests a run judges (a scale-up cell's draw, a fleet cell's
sample) and prints, per seed, each number beside the cell's limit. Runs
on the host alone: the control needs no card.

With --fault the reference plans in float32 and one fault that keeps
every guarantee but costs more is planted in its answer (FAULTS): what
`cost_gap` and `node_gap` have to catch where no plan of the reference is
the program's.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.harness import check as V  # noqa: E402
from benchmark.harness import registry  # noqa: E402
from benchmark.reference import audit as A  # noqa: E402
from benchmark.reference import catalog as K  # noqa: E402
from benchmark.reference import plan as R  # noqa: E402

PRECISION = "bfloat16"


def own_node(ans: dict, ps, cat) -> dict:
    """Colocation lost: each zone-spread replica and each bundle moves to
    a node of its own that no other pod joins, the cheapest available
    offering in its zone that fits it; a node it leaves empty is not
    launched."""
    keys = ps.keys()
    cls = dict(zip(keys, ps.cls.tolist()))
    need = dict(zip(keys, zip(ps.cpu().tolist(),
                              (ps.mem() / K.MIB).tolist())))
    launches = []
    for tname, zone, ctype, price, ks in ans["launches"]:
        units, stay = {}, []
        for k in ks:
            pc = ps.classes[cls[k]]
            if pc.spread is not None:
                units[k] = [k]
            elif pc.affinity is not None:
                units.setdefault(("bundle", cls[k]), []).append(k)
            else:
                stay.append(k)
        if stay:
            launches.append((tname, zone, ctype, price, stay))
        z = cat.zones.index(zone)
        for u in units.values():
            req = np.array([sum(need[k][0] for k in u),
                            sum(need[k][1] for k in u), len(u)], np.float32)
            fits = (cat.alloc >= req[None, :]).all(axis=1) & ~cat.exotic
            p = np.where(fits[:, None] & cat.avail[:, z, :],
                         cat.price[:, z, :], np.inf)
            t, c = divmod(int(np.argmin(p)), p.shape[1])
            launches.append((cat.names[t], zone, K.CAPACITY_TYPES[c],
                             float(p[t, c]), u))
    return dict(ans, launches=launches)


def on_demand(ans: dict, ps, cat) -> dict:
    """The capacity type lost in the decode: every node launches at its
    type's on-demand offering in its zone, where there is one."""
    od = K.CAPACITY_TYPES.index(K.ON_DEMAND)
    launches = []
    for tname, zone, ctype, price, ks in ans["launches"]:
        t, z = cat.index[tname], cat.zones.index(zone)
        if cat.avail[t, z, od]:
            ctype, price = K.ON_DEMAND, float(cat.price[t, z, od])
        launches.append((tname, zone, ctype, price, ks))
    return dict(ans, launches=launches)


FAULTS = {"own_node": own_node, "on_demand": on_demand}


def judge(cell: dict, seed: int, precision: str = PRECISION,
          fault: str = "") -> dict:
    conf = cell["configuration"]
    pool, ds = conf["pool"], conf.get("daemonsets", [])
    cat = R.build_catalog(K.generate(), pool, ds)
    nums = {"missing": 0, "infeasible": 0, "wrongly_unschedulable": 0,
            "fallbacks": 0}
    compare = cell["params"].get("compare", "plan")
    nums.update(A.blank(compare))
    drv = registry.driver(cell["driver"])
    for ps in drv.inputs(cell, seed):
        ref = R.solve(ps, cat, pool)
        if fault:
            ans = FAULTS[fault](R.answer(ref, ps, cat), ps, cat)
        else:
            ans = R.answer(R.solve(ps, cat, pool, precision=precision), ps,
                           cat)
        for k, v in A.audit(ans, ps, cat, pool).items():
            nums[k] += v
        A.compare(nums, compare, ans, ref, ps, cat)
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), default="")
    args = ap.parse_args(argv)
    cell = registry.workload(args.workload)
    failed_all = True
    for seed in args.seeds:
        nums = judge(cell, seed, fault=args.fault)
        ok, rows = V.verdict(nums, cell["limits"])
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault or PRECISION,
                          "control_correct": ok, "numbers": nums,
                          "checks": {r["name"]: r["value"] for r in rows}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
