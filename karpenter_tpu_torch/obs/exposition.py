"""HTTP exposition: /metrics, /debug/*, /healthz (the port's copy of
`karpenter_tpu/obs/exposition.py`).

One route table (`render`) for every server: the stdlib
ThreadingHTTPServer here (`ExpositionServer`, for bench runs and anything
without an event loop) answers it, and the reference's asyncio operator
shares the same table (its port is ROADMAP item 15). The reference ships
the same trio: controller-runtime's metrics endpoint + health probes;
/debug/* is the observatory window this framework adds on top.

Content negotiation (/metrics): the DEFAULT document is strict
Prometheus 0.0.4 text (no exemplars — the classic parser reads the
`# {trace_id=...}` suffix as a malformed timestamp and fails the whole
scrape). A scraper that advertises `Accept: application/openmetrics-text`
gets the OpenMetrics rendering WITH histogram exemplars and the
required `# EOF` terminator — so trace-id exemplars reach the scrapers
that can use them without breaking the ones that can't.

Debug-route contract: every registered /debug/* route holds its owner
by WEAKREF only. `register_debug_route(route, payload, owner=obj)`
stores `payload` (a plain callable taking `(owner, query)`) plus a
weak reference; once the owner dies the route answers
`{"inactive": true}` instead of pinning a dead subsystem (or serving
its corpse). Ownerless routes take `(query)`. Last registration wins —
a rebuilt subsystem replaces its predecessor. `/debug` (no suffix)
enumerates every route with its owner-liveness status, so discovering
the observatory surface never means guessing at 404s.

Health probes are SPLIT, kubelet-style:
- `/healthz` is LIVENESS: the process is serving — always 200 "ok".
  Restarting on anything weaker than process death just loses state.
- `/readyz` is READINESS: consults every live registered readiness
  probe (`register_readiness`, weakref like the debug routes — the
  armed invariant watchdog registers one: a critical verdict means the
  control plane is violating its own invariants RIGHT NOW) plus the
  `degraded_mode` gauges. Any failing probe → 503; degraded components
  are reported in the body but do not flip readiness (degradation is
  designed-for operation: the fallback path is serving).
"""

from __future__ import annotations

import json
import threading
import weakref
from typing import Optional, Tuple

from .tracer import TRACER, Tracer, to_chrome_events

# route -> (payload, owner_weakref | None); see module docstring
DEBUG_ROUTES: dict = {}

# name -> (probe, owner_weakref | None): readiness probes consulted by
# /readyz. A probe returns (ready: bool, detail: dict); dead owners are
# pruned lazily — a vanished subsystem stops gating readiness
READINESS_PROBES: dict = {}

OPENMETRICS_CTYPE = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")
TEXT_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def register_debug_route(route: str, payload, owner=None) -> None:
    """Serve a JSON payload at `route` on both servers.

    - `owner=None`: `payload(query)` is called per request.
    - `owner=obj`: `payload(owner, query)` is called with the LIVE
      owner; the table keeps only a weakref, and a dead owner renders
      `{"inactive": true}` — the uniform lifecycle every subsystem route
      (fleet service, SLO engine, profiler, explain recorder) follows.
      `payload` must not close over the owner, or the weakref is moot.
    """
    ref = weakref.ref(owner) if owner is not None else None
    DEBUG_ROUTES[route] = (payload, ref)


def register_readiness(name: str, probe, owner=None) -> None:
    """Gate /readyz on `probe` — called as `probe(owner)` (live owner)
    or `probe()` when ownerless; must return (ready, detail). Weakref
    semantics match the debug routes: a dead owner's probe is dropped,
    never failed — readiness reflects subsystems that EXIST. Dead
    owners' probes are dropped here too, so a process that builds many
    stacks (each watchdog registers one) never accumulates them."""
    for stale in [k for k, (_, r) in READINESS_PROBES.items()
                  if r is not None and r() is None]:
        READINESS_PROBES.pop(stale, None)
    ref = weakref.ref(owner) if owner is not None else None
    READINESS_PROBES[name] = (probe, ref)


def _readiness() -> Tuple[bool, dict]:
    """Aggregate readiness: every live probe must pass. The
    `degraded_mode` gauge rides along in the body (the operator-facing
    'why is this replica slow' answer) without flipping the verdict."""
    from ..metrics import DEGRADED_MODE
    ready = True
    probes: dict = {}
    for name, (probe, ref) in list(READINESS_PROBES.items()):
        if ref is not None:
            owner = ref()
            if owner is None:
                READINESS_PROBES.pop(name, None)
                continue
            ok, detail = probe(owner)
        else:
            ok, detail = probe()
        ready = ready and bool(ok)
        probes[name] = {"ready": bool(ok), **detail}
    with DEGRADED_MODE._lock:
        items = list(DEGRADED_MODE._values.items())
    degraded = {"/".join(k): v for k, v in items if v}
    return ready, {"ready": ready, "probes": probes, "degraded": degraded}


def _debug_index() -> dict:
    """The /debug index: every registered route with owner liveness —
    dead-weakref routes are listed as inactive instead of 404-guessed."""
    routes = [{"route": "/metrics", "builtin": True, "active": True},
              {"route": "/healthz", "builtin": True, "active": True,
               "probe": "liveness"},
              {"route": "/readyz", "builtin": True, "active": True,
               "probe": "readiness"},
              {"route": "/debug", "builtin": True, "active": True},
              {"route": "/debug/traces", "builtin": True, "active": True}]
    for route, (_payload, ref) in sorted(DEBUG_ROUTES.items()):
        routes.append({"route": route, "builtin": False,
                       "active": ref is None or ref() is not None})
    return {"routes": routes,
            "readiness_probes": sorted(READINESS_PROBES)}


def render(path: str, tracer: Optional[Tracer] = None,
           accept: str = "") -> Tuple[int, str, bytes]:
    """(status, content_type, body) for an exposition route. Unknown
    paths 404 — both servers answer identically. `accept` is the
    request's Accept header (content negotiation for /metrics)."""
    tracer = tracer or TRACER
    route, _, query = path.partition("?")
    if route == "/metrics":
        from ..metrics import REGISTRY
        if "application/openmetrics-text" in (accept or ""):
            body = REGISTRY.expose().encode() + b"# EOF\n"
            return 200, OPENMETRICS_CTYPE, body
        return 200, TEXT_CTYPE, REGISTRY.expose(exemplars=False).encode()
    if route == "/healthz":
        return 200, "text/plain", b"ok\n"
    if route == "/readyz":
        ready, body = _readiness()
        return (200 if ready else 503, "application/json",
                json.dumps(body).encode())
    if route == "/debug":
        return 200, "application/json", json.dumps(_debug_index()).encode()
    if route == "/debug/traces":
        traces = tracer.recorder.slowest()
        if "format=chrome" in query:
            body = json.dumps({"traceEvents": to_chrome_events(traces),
                               "displayTimeUnit": "ms"})
        else:
            body = json.dumps({"enabled": tracer.enabled,
                               "ring_size": tracer.recorder.size,
                               "dropped": tracer.recorder.dropped,
                               "dropped_by_tenant": dict(
                                   getattr(tracer.recorder,
                                           "dropped_by_tenant", {})),
                               "count": len(traces),
                               "traces": [t.to_dict() for t in traces]})
        return 200, "application/json", body.encode()
    entry = DEBUG_ROUTES.get(route)
    if entry is not None:
        payload, ref = entry
        if ref is not None:
            owner = ref()
            out = ({"inactive": True} if owner is None
                   else payload(owner, query))
        else:
            out = payload(query)
        return 200, "application/json", json.dumps(out).encode()
    return 404, "text/plain", b"not found\n"


class ExpositionServer:
    """Stdlib threaded HTTP server for the exposition routes — no event
    loop required (bench.py, ad-hoc debugging). Daemon threads; stop()
    is clean but the process exiting without it is also fine."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 tracer: Optional[Tracer] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        tr = tracer or TRACER

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                status, ctype, body = render(
                    self.path, tr, accept=self.headers.get("Accept", ""))
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrapes must not spam stderr

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ExpositionServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="karpenter-tpu-exposition",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
