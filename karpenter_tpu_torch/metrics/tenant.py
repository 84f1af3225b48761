"""Tenant attribution for process-shared metrics.

A fleet runs many tenant control planes in ONE process against one
metric registry (docs/fleet.md), so the hot-path series the dashboards
already watch (`warmpath_*`, `launch_dedup_total`,
`solver_backend_fallback_total`) gain a `tenant` dimension. Single-
cluster operators never set a scope, so every sample lands on the
`"default"` tenant — and the registry's label defaults make unlabeled
reads (`COUNTER.value()`) resolve to that same series, keeping existing
dashboards and tests byte-compatible.

The scope is THREAD-LOCAL: the fleet runner drives shards strictly
serially on one thread (the determinism contract), but the exposition
servers scrape from their own threads, and a future threaded fleet must
not let tenant A's scope leak into a sample tenant B's thread is
writing (tests/test_obs.py hammers exactly this). A thread that never
entered a scope reads the class-level default — one attribute lookup,
no contextvar machinery on the metric hot path.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator

DEFAULT_TENANT = "default"


class _Scope(threading.local):
    # class attribute = the per-thread default until a scope is entered
    value: str = DEFAULT_TENANT


_scope = _Scope()


def current_tenant() -> str:
    """The tenant every tenant-dimensioned metric sample is attributed
    to right now on THIS thread; "default" outside any fleet scope."""
    return _scope.value


@contextmanager
def tenant_scope(name: str) -> Iterator[None]:
    """Attribute metric samples inside the block to `name` — the fleet
    runner wraps each shard's engine tick in one, and the SolverService
    wraps each dispatched solve. Re-entrant: nested scopes restore the
    outer tenant on exit. Per-thread: a scope entered on one thread is
    invisible to every other."""
    prev = _scope.value
    _scope.value = name
    try:
        yield
    finally:
        _scope.value = prev
