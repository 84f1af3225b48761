"""What decides `correct`: each number the reference compares, beside
its limit. A number passes when it is at most its limit."""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple


PARTS = ("missing", "infeasible", "wrongly_unschedulable", "fallbacks")


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[dict]]:
    """`violations` is the sum of the reference audit's counts (pods not
    accounted for once, broken guarantees, pods wrongly left
    unschedulable) and the solves the program moved off the card."""
    numbers = dict(numbers)
    numbers["violations"] = sum(numbers.get(k, 0) for k in PARTS)
    rows = []
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value <= limit
        ok &= good
        rows.append({"name": name, "value": value, "limit": limit,
                     "ok": good})
    return ok, rows


def print_rows(rows: List[dict], numbers: Dict[str, float]) -> None:
    print("reference: " + ", ".join(f"{k} {v}" for k, v in numbers.items()),
          file=sys.stderr, flush=True)
    for r in rows:
        print(f"check {r['name']}: {r['value']} (limit {r['limit']}) "
              f"{'ok' if r['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
