"""Federation transports: how envelope dicts cross the process gap.

The port's own copy of `karpenter_tpu/federation/transport.py`, semantics
unchanged: the same seams, deadline knob, generation guard and metering.

Both transports speak the same RPC shape — ``call(method, payload)``
where payload is a JSON-safe dict (usually an `encode_envelope` result)
and the reply is the server's ``{"result": ...}`` unwrapped, or the
reconstructed exception from its ``{"error": ...}`` envelope.

`InMemoryTransport` is the tier-1 workhorse: it round-trips EVERY
payload through ``json.dumps``/``loads`` in both directions before
touching the server, so serialization bugs, non-JSON-safe fields, and
codec asymmetries fail in deterministic CPU tests — not on a real
socket at 2am. It still meters wire bytes and RPC outcomes, so the
bench's wire-overhead fraction is measurable without opening a port.

`HTTPTransport` is the real thing: POST /fed/<method> against a
`make_fed_server` process, with the `X-Wire-Schema` header the
cloud/remote.py wire layer already enforces (skew → 426 + a
WireVersionError envelope, checked before the body is parsed).
Transport-level failures map to retryable `ServerError` — the exact
taxonomy the client's degrade ladder branches on.

Every RPC runs under a ``federation.wire`` tracer span, which the
observatory buckets into the "wire" phase — the numerator of the
bench's ``c17_wire_overhead_frac``.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Callable, Optional

from ..cloud.remote import (WIRE_SCHEMA_VERSION, ServerError,
                            WireVersionError, decode_error)
from ..metrics import FEDERATION_RPCS, FEDERATION_WIRE_BYTES
from ..obs.tracer import NOOP_SPAN, TRACER


def fed_timeout() -> float:
    """Per-RPC wire deadline in seconds — the KARPENTER_TPU_FED_TIMEOUT
    env knob (utils/options.ENV_KNOBS). Read per-transport-construction
    so tests can tighten it without rebuilding module state."""
    try:
        return float(os.environ.get("KARPENTER_TPU_FED_TIMEOUT", "") or 10.0)
    except ValueError:
        return 10.0


class StaleGenerationError(RuntimeError):
    """A reply frame carried a boot generation OLDER than the one this
    client has already observed — a split-brain server (or a delayed
    frame from a dead boot). The frame is rejected by the generation
    guard BEFORE any envelope decoding; the client never acts on state
    from a superseded boot. Not retryable: a stale peer does not heal
    by re-asking it."""

    def __init__(self, known, got, method: str = ""):
        self.known, self.got, self.method = known, got, method
        super().__init__(
            f"stale federation generation on {method or 'rpc'}: reply "
            f"from boot generation {got}, but generation {known} was "
            f"already observed — split-brain guard rejected the frame")


# Test seam: faults/injector.py arms this to kill the wire mid-run (the
# "server crash" fault family). Called with the method name before every
# RPC; raising simulates the transport failing at that point.
_wire_fault_hook: Optional[Callable[[str], None]] = None

# Reply-side seam: called with (method, raw reply bytes) after the reply
# is serialized/read and before it is parsed; returns the (possibly
# garbled) bytes — the corrupt_frame WireFault family fires here.
_wire_reply_hook: Optional[Callable[[str, bytes], bytes]] = None


def set_wire_fault_hook(hook: Optional[Callable[[str], None]]):
    """Install (or clear, with None) the wire-fault probe. Returns the
    previous hook so context managers can restore it."""
    global _wire_fault_hook
    prev = _wire_fault_hook
    _wire_fault_hook = hook
    return prev


def set_wire_reply_hook(hook: Optional[Callable[[str, bytes], bytes]]):
    """Install (or clear, with None) the reply-frame seam. Returns the
    previous hook so context managers can restore it."""
    global _wire_reply_hook
    prev = _wire_reply_hook
    _wire_reply_hook = hook
    return prev


def _probe_wire_fault(method: str):
    if _wire_fault_hook is not None:
        _wire_fault_hook(method)


def _probe_wire_reply(method: str, raw: bytes) -> bytes:
    if _wire_reply_hook is not None:
        return _wire_reply_hook(method, raw)
    return raw


class InMemoryTransport:
    """Same-process transport with full wire fidelity.

    Holds a `SolverServer` directly but refuses to hand it anything
    that did not survive a JSON round trip — and symmetrically refuses
    to hand the caller a reply that did not. Byte counts are taken on
    the serialized forms, so `FEDERATION_WIRE_BYTES` means the same
    thing here as over a socket (minus HTTP framing).
    """

    def __init__(self, server):
        self.server = server
        # last boot generation seen on a reply frame, and the client's
        # split-brain guard (FederatedSolverClient installs it) — called
        # with (gen, method) BEFORE the frame's result/error is decoded
        self.last_gen = None
        self.gen_guard: Optional[Callable] = None

    def call(self, method: str, payload: dict) -> dict:
        _probe_wire_fault(method)
        sp = (TRACER.span("federation.wire", method=method)
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            body = json.dumps(payload, sort_keys=True).encode("utf-8")
            FEDERATION_WIRE_BYTES.inc(len(body), direction="sent")
            reply = self.server.handle(method, json.loads(body.decode("utf-8")))
            raw = json.dumps(reply, sort_keys=True).encode("utf-8")
            FEDERATION_WIRE_BYTES.inc(len(raw), direction="received")
            raw = _probe_wire_reply(method, raw)
            try:
                obj = json.loads(raw.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                FEDERATION_RPCS.inc(method=method, outcome="transport")
                raise ServerError(
                    f"federation RPC {method}: corrupt reply frame ({e})")
        _check_generation(self, method, obj)
        if "error" in obj:
            FEDERATION_RPCS.inc(method=method, outcome="error")
            raise decode_error(obj["error"])
        FEDERATION_RPCS.inc(method=method, outcome="ok")
        return obj.get("result")


def _check_generation(transport, method: str, obj) -> None:
    """Record the reply frame's boot generation and run the client's
    split-brain guard (when installed) before the frame is decoded. A
    StaleGenerationError from the guard is metered as its own RPC
    outcome and propagates — the frame is never interpreted."""
    gen = obj.get("gen") if isinstance(obj, dict) else None
    if gen is None:
        return
    transport.last_gen = gen
    if transport.gen_guard is None:
        return
    try:
        transport.gen_guard(gen, method)
    except StaleGenerationError:
        FEDERATION_RPCS.inc(method=method, outcome="stale")
        raise


class HTTPTransport:
    """POST /fed/<method> against a federation server in another process.

    Modeled on RemoteCloud._call: the same error taxonomy (timeouts and
    dropped connections → retryable ServerError; structured envelopes
    reconstruct their original class, including the non-retryable
    WireVersionError) and the same X-Wire-Schema header contract. The
    per-RPC deadline defaults to the KARPENTER_TPU_FED_TIMEOUT knob.
    """

    # real wall waits between retry attempts happen only on this
    # transport — the in-memory transport has no socket to wait out, so
    # the client's backoff there is pure bookkeeping
    retry_sleep = staticmethod(time.sleep)

    def __init__(self, host: str, port: int,
                 timeout: Optional[float] = None):
        self.host, self.port = host, port
        self.timeout = fed_timeout() if timeout is None else timeout
        self.last_gen = None
        self.gen_guard: Optional[Callable] = None

    def call(self, method: str, payload: dict) -> dict:
        import http.client
        _probe_wire_fault(method)
        sp = (TRACER.span("federation.wire", method=method)
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            body = json.dumps(payload, sort_keys=True).encode("utf-8")
            FEDERATION_WIRE_BYTES.inc(len(body), direction="sent")
            try:
                conn = http.client.HTTPConnection(self.host, self.port,
                                                  timeout=self.timeout)
                try:
                    conn.request(
                        "POST", f"/fed/{method}", body=body,
                        headers={"Content-Type": "application/json",
                                 "X-Wire-Schema": str(WIRE_SCHEMA_VERSION)})
                    resp = conn.getresponse()
                    raw = resp.read()
                    status = resp.status
                finally:
                    conn.close()
            except socket.timeout as e:
                FEDERATION_RPCS.inc(method=method, outcome="transport")
                raise ServerError(f"federation RPC {method} timed out: {e}")
            except (ConnectionError, OSError, http.client.HTTPException) as e:
                FEDERATION_RPCS.inc(method=method, outcome="transport")
                raise ServerError(
                    f"federation RPC {method} transport failure: {e}")
            FEDERATION_WIRE_BYTES.inc(len(raw), direction="received")
            raw = _probe_wire_reply(method, raw)
            try:
                obj = json.loads(raw) if raw else {}
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                # a frame that does not parse is indistinguishable from
                # line noise: reject as a retryable transport failure,
                # never guess at its contents
                FEDERATION_RPCS.inc(method=method, outcome="transport")
                raise ServerError(
                    f"federation RPC {method}: corrupt reply frame ({e})")
        _check_generation(self, method, obj)
        if "error" in obj:
            FEDERATION_RPCS.inc(method=method, outcome="error")
            raise decode_error(obj["error"])
        if status != 200:
            FEDERATION_RPCS.inc(method=method, outcome="error")
            raise ServerError(f"federation RPC {method}: HTTP {status}")
        FEDERATION_RPCS.inc(method=method, outcome="ok")
        return obj.get("result")

    def handshake(self) -> int:
        """Schema negotiation on connect, same ladder as RemoteCloud:
        missing version field means v0 (explicitly skewed), mismatch
        raises WireVersionError, transport failure is retryable."""
        import http.client
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            try:
                conn.request("GET", "/healthz")
                payload = conn.getresponse().read()
            finally:
                conn.close()
        except socket.timeout as e:
            raise ServerError(f"federation handshake timed out: {e}")
        except (ConnectionError, OSError, http.client.HTTPException) as e:
            raise ServerError(f"federation handshake transport failure: {e}")
        try:
            obj = json.loads(payload) if payload else {}
        except json.JSONDecodeError:
            obj = {}
        theirs = obj.get("wire_schema", 0)
        if theirs != WIRE_SCHEMA_VERSION:
            raise WireVersionError(WIRE_SCHEMA_VERSION, theirs)
        return theirs
