"""Remote CloudProvider: the L2 seam across a real process boundary.

The port's own copy of `karpenter_tpu/cloud/remote.py`, semantics unchanged.

The CloudProvider protocol (cloud/provider.py) is proven here the way the
reference's narrow SDK interface is proven by a real AWS backend behind it
(pkg/aws/sdk.go:29-75): a second implementation that speaks HTTP/JSON to a
cloud served from ANOTHER PROCESS. Everything the in-process fake hides
becomes explicit — dataclass/Requirements serialization, the error
taxonomy surviving the wire (each taxonomy class reconstructs with its
payload: ICE offerings, exhausted zones, reservation ids), connection
failures and timeouts mapping onto retryable ServerError, HTTP 429 onto
RateLimitedError, and a /healthz connectivity probe (the reference
operator pings STS/EC2 before serving, operator.go:239).

Wire shape: POST /rpc/<method> with {"args": [...]} → 200 {"result": ...}
or an error status with {"error": {"type": ..., ...}}. Values encode as
JSON with small type tags for the model classes ("__dc__" dataclasses,
"__res__" Resources, "__req__" Requirements, "__tu__" tuples).
"""

from __future__ import annotations

import json
import socket
import threading
from dataclasses import fields, is_dataclass
from typing import Dict, List, Optional

from .provider import (AlreadyExistsError, CapacityTypeUnfulfillableError,
                       CloudError, Instance, InsufficientCapacityError,
                       LaunchOverride, LaunchRequest, NetworkGroup,
                       NodeProfile, NotFoundError, RateLimitedError,
                       ReservationExceededError, ServerError,
                       UnauthorizedError, ZoneExhaustedError)

# ---------------------------------------------------------------------------
# wire schema negotiation
# ---------------------------------------------------------------------------
# Bumped whenever the codec's envelope shapes change incompatibly (a new
# type tag, a field rename in a registered dataclass, an error-envelope
# shape change). Negotiated ONCE per connection instead of discovered
# mid-payload: without the handshake a drifted peer fails deep inside
# decode() with a KeyError/TypeError that looks like data corruption —
# with it, the mismatch is an explicit WireVersionError naming both
# versions before any RPC body crosses.
WIRE_SCHEMA_VERSION = 1


class WireVersionError(CloudError):
    """The two ends of the wire speak different codec schema versions.
    NOT retryable — a version skew never heals by waiting, so this
    deliberately does not subclass ServerError (the batcher/backoff
    machinery must surface it, not spin on it)."""

    def __init__(self, ours: int, theirs) -> None:
        self.ours, self.theirs = ours, theirs
        super().__init__(
            f"wire schema mismatch: local speaks v{ours}, peer speaks "
            f"v{theirs} — upgrade the older end before reconnecting")


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


def _wire_classes() -> Dict[str, type]:
    from ..cloud.image import Image
    from ..models.instancetype import InstanceType, Offering, Overhead
    from ..models.nodeclaim import Node
    from ..models.pod import Taint
    return {c.__name__: c for c in (
        Instance, NetworkGroup, NodeProfile, LaunchRequest, LaunchOverride,
        InstanceType, Offering, Overhead, Node, Taint, Image)}


_CLASSES: Optional[Dict[str, type]] = None


def _classes() -> Dict[str, type]:
    global _CLASSES
    if _CLASSES is None:
        _CLASSES = _wire_classes()
    return _CLASSES


def encode(obj):
    from ..models.requirements import Requirements, ValueSet
    from ..models.resources import Resources
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Resources):
        return {"__res__": dict(obj)}
    if isinstance(obj, Requirements):
        return {"__req__": {
            "sets": {k: encode_valueset(obj.get(k)) for k in obj.keys()},
            "min": {k: obj.min_values(k) for k in obj.keys()
                    if obj.min_values(k) is not None}}}
    if isinstance(obj, ValueSet):
        return encode_valueset(obj)
    if is_dataclass(obj) and type(obj).__name__ in _classes():
        return {"__dc__": type(obj).__name__,
                "f": {f.name: encode(getattr(obj, f.name))
                      for f in fields(obj)}}
    if isinstance(obj, tuple):
        return {"__tu__": [encode(x) for x in obj]}
    if isinstance(obj, (list,)):
        return [encode(x) for x in obj]
    if isinstance(obj, (set, frozenset)):
        # distinct tag: a set must come back as a set — round-tripping as
        # a tuple silently broke membership/equality semantics downstream
        return {"__set__": [encode(x) for x in sorted(obj)]}
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    raise TypeError(f"unencodable wire value: {type(obj)}")


def encode_valueset(vs) -> dict:
    return {"__vs__": {"values": sorted(vs.values),
                       "complement": vs.complement, "gt": vs.gt,
                       "lt": vs.lt, "dne": vs.dne}}


def decode(obj):
    from ..models.requirements import Requirements, ValueSet
    from ..models.resources import Resources
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode(x) for x in obj]
    if isinstance(obj, dict):
        if "__res__" in obj:
            r = Resources()
            r.update(obj["__res__"])
            return r
        if "__vs__" in obj:
            d = obj["__vs__"]
            return ValueSet(values=frozenset(d["values"]),
                            complement=d["complement"], gt=d["gt"],
                            lt=d["lt"], dne=d["dne"])
        if "__req__" in obj:
            d = obj["__req__"]
            r = Requirements()
            r._sets = {k: decode(v) for k, v in d["sets"].items()}
            r._min_values = dict(d["min"])
            return r
        if "__tu__" in obj:
            return tuple(decode(x) for x in obj["__tu__"])
        if "__set__" in obj:
            # frozenset fields decode to set too — set/frozenset compare
            # equal in Python, and no wire consumer mutates them
            return {decode(x) for x in obj["__set__"]}
        if "__dc__" in obj:
            cls = _classes()[obj["__dc__"]]
            return cls(**{k: decode(v) for k, v in obj["f"].items()})
        return {k: decode(v) for k, v in obj.items()}
    raise TypeError(f"undecodable wire value: {type(obj)}")


# --- error taxonomy over the wire ---


def encode_error(e: CloudError) -> dict:
    env: dict = {"type": type(e).__name__, "msg": str(e)}
    for attr in ("offerings", "zones", "capacity_types", "reservation_id",
                 "retry_after", "ours", "theirs"):
        if getattr(e, attr, None) is not None:
            env[attr] = encode(getattr(e, attr))
    return env


_ERROR_TYPES = {c.__name__: c for c in (
    CloudError, NotFoundError, AlreadyExistsError, RateLimitedError,
    ServerError, UnauthorizedError, InsufficientCapacityError,
    ReservationExceededError, ZoneExhaustedError,
    CapacityTypeUnfulfillableError, WireVersionError)}


def decode_error(env: dict) -> CloudError:
    cls = _ERROR_TYPES.get(env.get("type", ""), ServerError)
    if cls is WireVersionError:
        # envelope is authored by the REJECTING end: its "ours" is our
        # peer's version, so swap perspective on reconstruction
        return WireVersionError(env.get("theirs", WIRE_SCHEMA_VERSION),
                                env.get("ours", "?"))
    if cls is InsufficientCapacityError:
        return InsufficientCapacityError(
            [tuple(o) for o in decode(env.get("offerings", []))],
            env.get("msg", ""))
    if cls is ZoneExhaustedError:
        return ZoneExhaustedError(decode(env.get("zones", [])))
    if cls is CapacityTypeUnfulfillableError:
        return CapacityTypeUnfulfillableError(
            decode(env.get("capacity_types", [])))
    if cls is ReservationExceededError:
        return ReservationExceededError(env.get("reservation_id", ""))
    if cls is RateLimitedError:
        ra = env.get("retry_after")
        return RateLimitedError(env.get("msg", "throttled"),
                                retry_after=float(ra) if ra else None)
    return cls(env.get("msg", ""))


def _http_status(e: CloudError) -> int:
    if isinstance(e, WireVersionError):
        return 426  # Upgrade Required — the protocol itself is wrong
    if isinstance(e, NotFoundError):
        return 404
    if isinstance(e, UnauthorizedError):
        return 403
    if isinstance(e, AlreadyExistsError):
        return 409
    if isinstance(e, RateLimitedError):
        return 429
    if isinstance(e, ServerError):
        return 500
    return 422  # capacity-class errors: the request was understood


# ---------------------------------------------------------------------------
# server: any CloudProvider behind HTTP
# ---------------------------------------------------------------------------


def make_server(cloud, host: str = "127.0.0.1", port: int = 0,
                lease_backend=None):
    """An http.server wrapping `cloud`; returns the server object (its
    .server_address[1] is the bound port). Run with serve_forever().

    Besides the /rpc/* CloudProvider surface it serves a CAS'd leader
    LEASE at /lease (get/update) — the coordination.k8s.io Lease-object
    analog, so multi-replica deploys elect through the cloud endpoint
    instead of needing a shared RWX volume for the file lease.

    lease_backend: the record behind /lease. Production MUST pass a
    durable backend (FileLeaseBackend on the gateway's own volume — see
    the `main()` entrypoint's --lease-file): with the in-memory default
    a gateway restart forgets the holder, and the standby can acquire
    while the old leader is still inside its renew window. The gateway
    itself must be a SINGLE instance (or share storage): two gateways
    with independent backends are two independent leases."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..utils.leaderelection import InMemoryLeaseBackend, Lease
    lease_backend = lease_backend or InMemoryLeaseBackend()
    # ThreadingHTTPServer runs one thread per connection, but FakeCloud
    # (and its TokenBuckets/instance maps) is plain mutable Python with
    # no internal locking: concurrent batcher/controller RPCs could
    # interleave mid-mutation. One dispatch lock serializes the cloud
    # calls — the wire I/O itself stays parallel.
    rpc_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, status: int, payload: dict,
                  headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                # the handshake rides the connectivity probe: clients read
                # wire_schema here BEFORE issuing any /rpc body
                self._send(200, {"ok": True,
                                 "wire_schema": WIRE_SCHEMA_VERSION})
            elif self.path == "/lease":
                lease = lease_backend.get()
                self._send(200, {"lease": lease.__dict__ if lease else None})
            else:
                self._send(404, {"error": {"type": "NotFoundError",
                                           "msg": self.path}})

        def do_POST(self):
            if self.path == "/lease":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    ok = lease_backend.update(
                        Lease(**body["lease"]), body.get("expected_version"))
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError) as e:
                    # malformed/version-skewed lease body: structured 400,
                    # not a handler-thread traceback
                    self._send(400, {"error": {"type": "CloudError",
                                               "msg": f"bad lease body: {e}"}})
                    return
                self._send(200, {"ok": ok})
                return
            if not self.path.startswith("/rpc/"):
                self._send(404, {"error": {"type": "NotFoundError",
                                           "msg": self.path}})
                return
            method = self.path[len("/rpc/"):]
            # schema check BEFORE touching the body: a drifted client is
            # told explicitly instead of tripping a decode() error that
            # masquerades as data corruption. Header-less clients (old or
            # third-party) pass — the check only fires on a declared skew.
            declared = self.headers.get("X-Wire-Schema")
            if declared is not None and declared != str(WIRE_SCHEMA_VERSION):
                err = WireVersionError(WIRE_SCHEMA_VERSION, declared)
                self._send(_http_status(err), {"error": encode_error(err)})
                return
            if method.startswith("_") or not hasattr(cloud, method):
                self._send(404, {"error": {"type": "NotFoundError",
                                           "msg": f"no method {method}"}})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                args = json.loads(self.rfile.read(n) or b"{}").get("args", [])
                args = [decode(a) for a in args]
                # encode inside the lock too: result objects are live
                # fake-cloud state another request could mutate mid-walk
                if method == "create_fleet":
                    with rpc_lock:
                        out = cloud.create_fleet(*args)
                        result = [{"error": encode_error(r)}
                                  if isinstance(r, CloudError)
                                  else {"instance": encode(r)} for r in out]
                else:
                    with rpc_lock:
                        result = encode(getattr(cloud, method)(*args))
                self._send(200, {"result": result})
            except CloudError as e:
                # a throttled backend's recovery hint travels as the
                # standard HTTP 429 Retry-After header (and in the error
                # envelope) so ANY client — ours or a plain HTTP one —
                # can pace its retries off the server's own estimate.
                # RFC 7231 delta-seconds is an INTEGER: the header ships
                # ceil(hint) for conformant third-party parsers, while
                # the JSON envelope keeps the exact float for our client
                headers = None
                ra = getattr(e, "retry_after", None)
                if ra is not None:
                    import math
                    headers = {"Retry-After":
                               str(int(math.ceil(max(0.0, float(ra)))))}
                self._send(_http_status(e), {"error": encode_error(e)},
                           headers)
            except Exception as e:  # noqa: BLE001 — the boundary
                self._send(500, {"error": {"type": "ServerError",
                                           "msg": f"{type(e).__name__}: {e}"}})

    return ThreadingHTTPServer((host, port), Handler)


def serve_in_thread(cloud, host: str = "127.0.0.1", port: int = 0):
    """(server, port) with serve_forever running on a daemon thread —
    the in-test harness; the subprocess path is `python -m ...remote`."""
    srv = make_server(cloud, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


# ---------------------------------------------------------------------------
# client: the CloudProvider implementation controllers actually hold
# ---------------------------------------------------------------------------


class RemoteCloud:
    """CloudProvider speaking HTTP/JSON to a cloud in another process.

    Transport failures surface as the taxonomy the controllers already
    branch on: timeouts and refused/briefly-dropped connections become
    retryable ServerError (the batcher/backoff machinery treats them like
    any throttled cloud call), HTTP 429 becomes RateLimitedError, and
    structured error envelopes reconstruct their original class."""

    def __init__(self, host: str, port: int, timeout: float = 5.0,
                 clock=None):
        from ..utils.clock import RealClock
        self.host, self.port, self.timeout = host, port, timeout
        self.clock = clock or RealClock()  # sim-assembly compatibility

    # --- transport ---
    def _call(self, method: str, *args):
        import http.client
        body = json.dumps({"args": [encode(a) for a in args]})
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            try:
                conn.request("POST", f"/rpc/{method}", body=body,
                             headers={"Content-Type": "application/json",
                                      "X-Wire-Schema":
                                      str(WIRE_SCHEMA_VERSION)})
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
                retry_hdr = resp.getheader("Retry-After")
            finally:
                conn.close()
        except socket.timeout as e:
            raise ServerError(f"cloud RPC {method} timed out: {e}")
        except (ConnectionError, OSError, http.client.HTTPException) as e:
            # HTTPException covers the server dying mid-response
            # (IncompleteRead/BadStatusLine) — retryable like any drop
            raise ServerError(f"cloud RPC {method} transport failure: {e}")
        try:
            obj = json.loads(payload) if payload else {}
        except json.JSONDecodeError:
            obj = {}
        if status == 429:
            # server-provided recovery hint: our error envelope carries
            # the exact float, the (integer, RFC 7231) Retry-After header
            # is the fallback for 429s minted by proxies — either way it
            # rides the exception into the batcher's gate
            ra = obj.get("error", {}).get("retry_after") or retry_hdr
            try:
                ra = float(ra) if ra is not None else None
            except (TypeError, ValueError):
                ra = None
            raise RateLimitedError(
                obj.get("error", {}).get("msg", "throttled"),
                retry_after=ra)
        if "error" in obj:
            raise decode_error(obj["error"])
        if status != 200:
            raise ServerError(f"cloud RPC {method}: HTTP {status}")
        return obj.get("result")

    def healthz(self) -> bool:
        """Connectivity probe (reference operator.go:239 — the operator
        verifies it can reach the cloud before serving)."""
        import http.client
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            try:
                conn.request("GET", "/healthz")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            return False

    def handshake(self) -> int:
        """Negotiate the wire schema on connect: reads the server's
        version from /healthz and raises WireVersionError on skew —
        an explicit refusal instead of a mid-payload decode failure.
        Returns the negotiated version. Transport failures map to
        retryable ServerError like any other call."""
        import http.client
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                payload = resp.read()
            finally:
                conn.close()
        except socket.timeout as e:
            raise ServerError(f"handshake timed out: {e}")
        except (ConnectionError, OSError, http.client.HTTPException) as e:
            raise ServerError(f"handshake transport failure: {e}")
        try:
            obj = json.loads(payload) if payload else {}
        except json.JSONDecodeError:
            obj = {}
        # a server predating the handshake ships no version field; treat
        # it as v0 — explicitly skewed, not silently compatible
        theirs = obj.get("wire_schema", 0)
        if theirs != WIRE_SCHEMA_VERSION:
            raise WireVersionError(WIRE_SCHEMA_VERSION, theirs)
        return theirs

    # --- CloudProvider surface ---
    def create_fleet(self, requests: List[LaunchRequest]):
        out = self._call("create_fleet", list(requests))
        return [decode_error(item["error"]) if "error" in item
                else decode(item["instance"]) for item in out]

    def terminate(self, instance_ids: List[str]) -> None:
        self._call("terminate", list(instance_ids))

    def describe(self, instance_ids: Optional[List[str]] = None):
        return decode(self._call("describe", instance_ids))

    def describe_types(self):
        return decode(self._call("describe_types"))

    def describe_images(self):
        return decode(self._call("describe_images"))

    def describe_nodes(self):
        return decode(self._call("describe_nodes"))

    def describe_network_groups(self):
        return decode(self._call("describe_network_groups"))

    def create_profile(self, name: str, role: str):
        return decode(self._call("create_profile", name, role))

    def delete_profile(self, name: str) -> None:
        self._call("delete_profile", name)

    def update_profile_role(self, name: str, role: str) -> None:
        self._call("update_profile_role", name, role)

    def describe_profiles(self):
        return decode(self._call("describe_profiles"))

    # interruption queue (SQS seam)
    def poll_interruptions(self, max_messages: int = 10) -> List[str]:
        return self._call("poll_interruptions", max_messages) or []

    def delete_message(self, msg: str) -> None:
        self._call("delete_message", msg)

    def tick(self) -> None:
        """Advance the served cloud's simulation step (no-op against a
        real backend; the fake materializes nodes/boot progress here)."""
        self._call("tick")


# ---------------------------------------------------------------------------
# subprocess entrypoint: serve a fake cloud over HTTP
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    import argparse

    from ..catalog.generator import small_catalog
    from ..utils.clock import RealClock
    from .fake import FakeCloud, FakeCloudConfig

    ap = argparse.ArgumentParser(description="serve a FakeCloud over HTTP")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--ready-delay", type=float, default=0.05)
    ap.add_argument("--lease-file", default="",
                    help="durable backing for the /lease endpoint — set "
                         "in production so a gateway restart keeps the "
                         "leader record (empty = in-memory, test only)")
    args = ap.parse_args(argv)
    cloud = FakeCloud(small_catalog(), clock=RealClock(),
                      config=FakeCloudConfig(
                          node_ready_delay=args.ready_delay,
                          register_delay=args.ready_delay / 2))
    lease_backend = None
    if args.lease_file:
        from ..utils.leaderelection import FileLeaseBackend
        lease_backend = FileLeaseBackend(args.lease_file)
    srv = make_server(cloud, port=args.port, lease_backend=lease_backend)
    # the parent waits for this line before connecting
    print(f"READY {srv.server_address[1]}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
