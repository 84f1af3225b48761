"""Minimal 5-field cron matcher (UTC) for disruption-budget windows.

Reference: NodePool disruption budgets carry `schedule` (crontab) +
`duration`; the budget constrains disruption only while inside an open
window (karpenter.sh_nodepools.yaml:126-141 — 'schedule must be set
with duration'). Supported syntax: `*`, numbers, ranges `a-b`, lists
`a,b,c`, steps `*/n` and `a-b/n`, plus the standard dom/dow OR rule
(when BOTH day fields are restricted, either matching suffices). No
external cron library exists in this image; windows are minutes-grained
so the matcher only ever needs per-minute checks.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import FrozenSet, Tuple

_BOUNDS = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))


class CronError(ValueError):
    pass


def _parse_field(spec: str, lo: int, hi: int) -> FrozenSet[int]:
    vals = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, s = part.split("/", 1)
            if not s.isdigit() or int(s) < 1:
                raise CronError(f"bad step {s!r}")
            step = int(s)
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            if not (a.isdigit() and b.isdigit()):
                raise CronError(f"bad range {part!r}")
            start, end = int(a), int(b)
        elif part.isdigit():
            start = end = int(part)
        else:
            raise CronError(f"bad field {part!r}")
        if not (lo <= start <= end <= hi):
            raise CronError(f"{part!r} out of [{lo}, {hi}]")
        vals.update(v for v in range(start, end + 1)
                    if (v - start) % step == 0)
    return frozenset(vals)


@lru_cache(maxsize=256)
def parse(expr: str) -> Tuple[FrozenSet[int], ...]:
    fields = expr.split()
    if len(fields) != 5:
        raise CronError(f"cron needs 5 fields, got {len(fields)}: {expr!r}")
    return tuple(_parse_field(f, lo, hi)
                 for f, (lo, hi) in zip(fields, _BOUNDS))


def matches(expr: str, t: float) -> bool:
    """Does minute t (epoch seconds, UTC) match the expression?"""
    minute, hour, dom, month, dow = parse(expr)
    g = time.gmtime(t)
    if g.tm_min not in minute or g.tm_hour not in hour:
        return False
    if g.tm_mon not in month:
        return False
    # dom/dow OR rule: when both are restricted, either matching passes
    cron_dow = (g.tm_wday + 1) % 7  # cron: 0 = Sunday; tm_wday: 0 = Monday
    dom_restricted = dom != frozenset(range(1, 32))
    dow_restricted = dow != frozenset(range(0, 7))
    dom_ok = g.tm_mday in dom
    dow_ok = cron_dow in dow
    if dom_restricted and dow_restricted:
        return dom_ok or dow_ok
    return dom_ok and dow_ok


@lru_cache(maxsize=4096)
def _in_window_bucket(expr: str, duration: float, minute: int) -> bool:
    start_minute = minute * 60
    for i in range(int(duration // 60) + 1):
        t = start_minute - i * 60
        if t + duration <= start_minute:
            break
        if matches(expr, t):
            return True
    return False


def in_window(expr: str, duration: float, now: float) -> bool:
    """Is `now` inside a window opened by the most recent matching
    minute? (A window opens at every matching minute and stays open for
    `duration` seconds.) Memoized per minute: the scan is linear in
    duration, and disruption evaluates budgets once per candidate per
    pass — a month-long freeze must not cost 43k gmtime calls per
    candidate. Minute granularity: a non-minute-aligned duration's
    close rounds up to the end of its minute (cron windows are
    minute-grained; erring open is the conservative side for a
    freeze)."""
    return _in_window_bucket(expr, float(duration), int(now) // 60)
