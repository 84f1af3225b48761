"""Async runtime: wall-clock loop for the same controllers the sim runs.

The port's own copy of `karpenter_tpu/controllers/runtime.py`.

The deployment shape (reference: controller-runtime manager with leader
election + health probes, cmd/controller/main.go): each controller gets
its own asyncio task honoring its requeue interval; a metrics endpoint
serves the Prometheus registry; shutdown drains cleanly. Controllers are
sync (reconcile(now) -> requeue) and fast; long waits live between
reconciles, so a single event loop suffices — the device solve itself
releases the loop only at call granularity.
"""

from __future__ import annotations

import asyncio
import logging
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..cloud.provider import CloudError
from ..metrics import RECONCILE_DURATION, RECONCILE_ERRORS
from ..obs.tracer import NOOP_SPAN, TRACER
from ..utils.clock import RealClock

log = logging.getLogger("karpenter_tpu_torch.runtime")


@dataclass
class Runtime:
    clock: object = field(default_factory=RealClock)
    controllers: List[object] = field(default_factory=list)
    metrics_port: int = 0  # 0 = no endpoint
    # optional utils.leaderelection.Elector: controllers reconcile only
    # while this replica leads; the standby keeps serving metrics and
    # retrying the lease (reference: controller-runtime leader election,
    # 2-replica Helm chart)
    elector: Optional[object] = None
    # per-controller crash counter (reconcile exceptions survived) — the
    # observable the soak test asserts stays zero
    crash_counts: Dict[str, int] = field(default_factory=dict)
    # per-controller retryable-throttle counter: a controller leaking a
    # retryable CloudError every cycle would otherwise spin silently,
    # indistinguishable from healthy idle
    backoff_counts: Dict[str, int] = field(default_factory=dict)
    # clean-shutdown hooks, run AFTER every controller task has stopped
    # (so nothing re-enqueues work behind the flush) and before the
    # metrics server closes — e.g. BatchingCloud.shutdown, which ships
    # any termination batch still waiting on an idle window
    on_stop: List[object] = field(default_factory=list)
    _stop: Optional[asyncio.Event] = None
    _server: object = None

    def add(self, *controllers) -> "Runtime":
        self.controllers.extend(controllers)
        return self

    async def _run_elector(self) -> None:
        # release in finally: start() cancels this task on shutdown, so the
        # loop usually exits via CancelledError, not the while condition —
        # the clean lease handover must survive both paths.
        # tick/release run OFF the event loop (to_thread): the HTTP lease
        # backend does blocking I/O with multi-second timeouts against a
        # possibly-unreachable gateway, and stalling the loop would take
        # the metrics server down exactly when operators need it
        try:
            while not self._stop.is_set():
                # shield the tick thread and, if we are cancelled while it
                # runs, WAIT for it before falling into release(): the
                # Elector has no internal locking, and a tick thread still
                # CASing a renew while release() runs would re-take the
                # lease the release just tried to clear
                tick = asyncio.ensure_future(
                    asyncio.to_thread(self.elector.tick, self.clock.now()))
                try:
                    await asyncio.shield(tick)
                except asyncio.CancelledError:
                    await self._join_thread(tick, "elector tick")
                    raise
                except Exception:
                    self.crash_counts["elector"] = \
                        self.crash_counts.get("elector", 0) + 1
                    log.exception("elector tick failed")
                try:
                    await asyncio.wait_for(self._stop.wait(),
                                           timeout=self.elector.retry_period)
                except asyncio.TimeoutError:
                    pass
        finally:
            # the original exception (if any) resumes after this completes
            rel = asyncio.ensure_future(
                asyncio.to_thread(self.elector.release, self.clock.now()))
            await self._join_thread(rel, "lease release")

    @staticmethod
    async def _join_thread(fut: "asyncio.Future", what: str) -> None:
        """Await a to_thread future to COMPLETION, surviving any number of
        cancellations delivered while waiting (the thread's I/O has finite
        timeouts, so this terminates): the lease invariants — tick joined
        before release runs, release outcome observed before the task dies
        — must hold even when shutdown cancels the elector task twice."""
        while True:
            try:
                await asyncio.shield(fut)
                return
            except asyncio.CancelledError:
                if fut.done():
                    # observe the outcome even on this path, or a failed
                    # release is silently dropped (plus an asyncio
                    # "exception was never retrieved" warning at GC)
                    if not fut.cancelled() and fut.exception() is not None:
                        log.error("%s failed: %r", what, fut.exception())
                    return
                continue
            except Exception:
                log.exception("%s failed", what)
                return

    async def _run_controller(self, c) -> None:
        while not self._stop.is_set():
            if self.elector is not None and not self.elector.is_leader():
                try:
                    await asyncio.wait_for(self._stop.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue
            name = getattr(c, "name", type(c).__name__)
            sp = (TRACER.trace(f"reconcile:{name}", controller=name,
                               loop="runtime")
                  if TRACER.enabled else NOOP_SPAN)
            t0 = _time.perf_counter()
            try:
                with sp:
                    requeue = c.reconcile(self.clock.now())
            except Exception as e:
                # same contract as the engine: RETRYABLE cloud errors
                # (throttles, server errors) model transient conditions —
                # back off and retry. Anything else is a crash the
                # runtime survives, counts, and logs.
                if isinstance(e, CloudError) and getattr(e, "retryable",
                                                         False):
                    self.backoff_counts[name] = \
                        self.backoff_counts.get(name, 0) + 1
                    RECONCILE_ERRORS.inc(controller=name,
                                         disposition="backoff")
                    log.debug("controller %s backing off on %s", name, e)
                    requeue = 2.0
                else:
                    self.crash_counts[name] = \
                        self.crash_counts.get(name, 0) + 1
                    RECONCILE_ERRORS.inc(controller=name,
                                         disposition="crash")
                    log.exception("controller %s reconcile crashed", name)
                    requeue = 5.0
            finally:
                RECONCILE_DURATION.observe(
                    _time.perf_counter() - t0, controller=name,
                    exemplar=getattr(getattr(sp, "span", None),
                                     "trace_id", None))
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       timeout=max(0.01, requeue))
            except asyncio.TimeoutError:
                pass

    async def _serve_metrics(self) -> None:
        # routes come from obs.exposition.render — the same table the
        # stdlib ExpositionServer serves, so /metrics, /debug/traces and
        # /healthz behave identically on both servers
        from ..obs.exposition import render

        async def handle(reader, writer):
            try:
                line = await reader.readline()
                parts = line.decode("latin-1", "replace").split()
                path = parts[1] if len(parts) >= 2 else "/metrics"
                # drain headers for the Accept value — /metrics content
                # negotiation (OpenMetrics exemplars vs classic 0.0.4)
                accept = ""
                while True:
                    h = await reader.readline()
                    if not h or h in (b"\r\n", b"\n"):
                        break
                    if h.lower().startswith(b"accept:"):
                        accept = h.split(b":", 1)[1].strip().decode(
                            "latin-1", "replace")
                status, ctype, body = render(path, accept=accept)
                reason = {200: "OK", 404: "Not Found",
                          503: "Service Unavailable"}.get(status, "OK")
                writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                              f"Content-Type: {ctype}\r\n"
                              f"Content-Length: {len(body)}\r\n\r\n"
                              ).encode() + body)
                await writer.drain()
            finally:
                writer.close()
        self._server = await asyncio.start_server(handle, "127.0.0.1",
                                                  self.metrics_port)

    async def start(self) -> None:
        self._stop = asyncio.Event()
        if self.metrics_port:
            await self._serve_metrics()
        tasks = [asyncio.create_task(self._run_controller(c))
                 for c in self.controllers]
        if self.elector is not None:
            tasks.append(asyncio.create_task(self._run_elector()))
        await self._stop.wait()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for fn in self.on_stop:
            try:
                fn()
            except Exception:  # noqa: BLE001 — one failed hook must not
                log.exception("shutdown hook failed")  # skip the rest
        if self._server is not None:
            self._server.close()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
