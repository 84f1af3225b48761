"""SolverServer: the one real solver stack, serving a cluster.

The port's own copy of `karpenter_tpu/federation/server.py`. The server
owns exactly the device half of the solve pipeline: a content-token-keyed
store of device-resident catalogs and the batched dispatcher
(`ops/solver.dispatch_packed`: one launch each of kernels B0 and B per
bucket on the card). It never sees tenant stores, encodings, or catalog
VIEWS — clients ship packed [B, Gp, W] request stacks plus the statics and
get raw packed int32 rows back. The server's working set is O(distinct
catalog contents + one stack in flight), not O(tenants), so one card
serves a whole fleet of processes.

Catalog protocol (the "upload once per cluster" contract):

1. client announces a SharedCatalogCache token via ``has_catalog``
2. miss → client ships tensors via ``put_catalog``; the server builds
   a DeviceCatalog straight from the raw arrays under the same
   `catalog_put` ledger attribution as an in-process upload
3. ``solve_bucket`` references catalogs by token only; an unknown
   token (server restarted, LRU-evicted) is a structured
   NotFoundError the client answers by re-announcing and retrying once

``handle(method, payload)`` is transport-agnostic — InMemoryTransport
calls it directly (through a JSON round trip), `make_fed_server` wraps
it in the same HTTP shape as cloud/remote.py (POST /fed/<method>,
X-Wire-Schema enforced before the body is parsed, errors as the
standard taxonomy envelopes with their HTTP statuses).

Every RPC runs under the server's lock, and all of the server's device
work (catalog uploads, the stack's upload, the launch, the event and the
one read of the rows) goes to the card's default stream, whichever
handler thread runs it: RPCs are ordered on the card as they are under
the lock. The batch mesh of the reference (``mesh=``, ``--mesh``) is not
ported: it raises through `ops/solver.reject_mesh`.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..cloud.remote import (WIRE_SCHEMA_VERSION, CloudError, NotFoundError,
                            ServerError, WireVersionError, _http_status,
                            encode_error)
from ..metrics import FEDERATION_CATALOG
from ..obs import devicemem as dm
from ..ops.solver import (DeviceCatalog, _put, dispatch_packed, reject_mesh,
                          resolve_device)
from .envelopes import (CatalogUploadEnvelope, ReportAck, SolveBucketRequest,
                        SolveBucketResult, decode_envelope, encode_envelope,
                        pack_array, unpack_array)

# catalog store bound: tokens are content-keyed, so entries only multiply
# with DISTINCT catalog contents (nodeclass roots x derived views), not
# with clients; 64 covers a large cluster with room for churn
MAX_CATALOGS = 64


class SolverServer:
    """Transport-agnostic federation endpoint around dispatch_packed.

    device: where the catalogs live and the buckets run (the CUDA card
    unless given; "cpu" runs the kernels' plain versions).
    mesh: the reference's batch mesh; not ported, so anything but None
    raises (`ops/solver.reject_mesh`).
    use_resident: route request stacks through the device-resident
    manager (per-client-process keys), so a steady-state client whose
    tenant rows barely change between pumps patches instead of
    re-shipping the whole stack to the device.
    """

    def __init__(self, mesh=None, run_id: str = "",
                 use_resident: bool = True,
                 max_catalogs: int = MAX_CATALOGS,
                 generation: int = 1,
                 compress_capability: bool = True,
                 device=None):
        reject_mesh(mesh)
        self.device = resolve_device(device)
        self.run_id = run_id
        self.use_resident = use_resident
        self.max_catalogs = max_catalogs
        # boot generation: minted at start, stamped into EVERY reply
        # frame, advanced by restart() — the client's generation guard
        # rejects frames from an older boot (split-brain) and treats a
        # newer one as "the server restarted: re-handshake, re-announce"
        self.generation = int(generation)
        # capability, not schema: whether this boot decodes zlib'd
        # pack_array payloads. A version-skew restart can come back
        # WITHOUT it — the re-handshake is what tells clients to drop
        # to uncompressed frames
        self.compress_capability = bool(compress_capability)
        self._catalogs: "OrderedDict[tuple, DeviceCatalog]" = OrderedDict()
        # one dispatch at a time: the solver stack (resident manager,
        # ledgers) is plain mutable Python — same serialization decision
        # as remote.make_server's rpc_lock
        self._lock = threading.Lock()
        self.reports: list = []   # mirrored verdicts/findings (envelopes)
        self.stats = {
            "handshakes": 0, "catalog_hits": 0, "catalog_misses": 0,
            "catalog_uploads": 0, "buckets": 0, "rows": 0,
            "padded_rows": 0, "reports": 0, "unknown_token": 0,
            # largest padded batch one launch carried — the bench's
            # c17_mesh_batch_capacity observable (one device: x1)
            "max_bucket_rows": 0, "healthz": 0, "restarts": 0,
            "compress_rejected": 0,
        }

    # --- lifecycle ---------------------------------------------------------

    def restart(self, generation: Optional[int] = None,
                compress_capability: Optional[bool] = None) -> None:
        """The in-process crash-restart drill: drop everything a process
        death loses — the catalog store and the mirrored-report ledger —
        and come back under a NEW boot generation (next integer unless
        pinned). compress_capability models a version-skew restart: the
        rebooted binary may no longer speak the compression capability,
        and only the client's re-handshake can discover that. Cumulative
        stats survive on purpose (they model the operator's external
        view, and the reupload accounting reads them across the boot)."""
        with self._lock:
            self._catalogs.clear()
            self.reports.clear()
            self.generation = (int(generation) if generation is not None
                               else self.generation + 1)
            if compress_capability is not None:
                self.compress_capability = bool(compress_capability)
            self.stats["restarts"] += 1

    # --- dispatch boundary -------------------------------------------------

    def handle(self, method: str, payload: dict) -> dict:
        """One RPC: {"result": ...} or {"error": <taxonomy envelope>},
        plus the boot generation stamped into EVERY reply frame (errors
        included — a NotFoundError from a rebooted server is exactly the
        frame that tells the client to re-announce). Schema skew is
        rejected before the body is interpreted, same contract as the
        HTTP layer's X-Wire-Schema check."""
        try:
            fn = getattr(self, f"_rpc_{method}", None)
            if fn is None:
                raise NotFoundError(f"no federation method {method!r}")
            declared = None
            if isinstance(payload, dict):
                declared = payload.get("f", {}).get("schema",
                                                    payload.get("schema"))
            if declared is not None and declared != WIRE_SCHEMA_VERSION:
                raise WireVersionError(WIRE_SCHEMA_VERSION, declared)
            with self._lock, self._stream():
                return {"result": fn(payload), "gen": self.generation}
        except CloudError as e:
            return {"error": encode_error(e), "gen": self.generation}
        except Exception as e:  # noqa: BLE001 — the process boundary
            return {"error": encode_error(
                ServerError(f"{type(e).__name__}: {e}")),
                "gen": self.generation}

    def _stream(self):
        """The card's default stream for this RPC's device work, in
        whichever thread handles it (a no-op on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.default_stream(self.device))

    # --- RPCs --------------------------------------------------------------

    def _rpc_handshake(self, payload: dict) -> dict:
        self.stats["handshakes"] += 1
        return {"wire_schema": WIRE_SCHEMA_VERSION, "run_id": self.run_id,
                "mesh_devices": 1,
                "resident": bool(self.use_resident),
                "generation": self.generation,
                # capability, not schema: this server decodes zlib'd
                # pack_array payloads ("z": 1). Old clients ignore the
                # key and keep sending uncompressed — which still decodes
                "compress": self.compress_capability}

    def _rpc_healthz(self, payload: dict) -> dict:
        """The circuit-breaker's probe target: cheap (no tensors) and
        generation-stamped like every reply, so a probe against a
        rebooted server doubles as the restart-discovery RPC."""
        self.stats["healthz"] += 1
        return {"ok": True, "wire_schema": WIRE_SCHEMA_VERSION}

    def _reject_compressed(self, *packed) -> None:
        """A boot without the compress capability cannot decode a "z"
        payload — fail LOUDLY with a structured error (carrying the new
        generation in the frame) instead of feeding zlib bytes to the
        codec; the client answers by re-handshaking and dropping to
        uncompressed frames."""
        if self.compress_capability:
            return
        for p in packed:
            if isinstance(p, dict) and p.get("z"):
                self.stats["compress_rejected"] += 1
                raise CloudError(
                    "compressed frame against a server without the "
                    "compress capability — re-handshake required")

    def _rpc_has_catalog(self, payload: dict) -> dict:
        """Token announce. `R` is the client's resource width: the same
        content token can be announced at different widths by different
        processes (width follows requests, not catalog content), and a
        stored catalog narrower than the asker's R cannot serve it — so
        that counts as a miss and the asker re-ships at its width."""
        token = self._token(payload.get("token"))
        need_r = int(payload.get("R", 0))
        ent = self._catalogs.get(token)
        present = ent is not None and int(ent.alloc.shape[1]) >= need_r
        if present:
            self._catalogs.move_to_end(token)  # LRU touch
            self.stats["catalog_hits"] += 1
        else:
            self.stats["catalog_misses"] += 1
        return {"present": present}

    def _rpc_put_catalog(self, payload: dict) -> dict:
        env = decode_envelope(payload)
        if not isinstance(env, CatalogUploadEnvelope):
            raise CloudError(f"put_catalog carries {type(env).__name__}")
        self._reject_compressed(env.alloc, env.price, env.avail, env.ovh_z)
        token = self._token(env.token)
        ent = self._catalogs.get(token)
        if ent is not None and int(ent.alloc.shape[1]) >= int(env.R):
            # idempotent: tokens are content-keyed, so a duplicate upload
            # at the same (or narrower) width carries no new information
            # — keep the resident copy; a WIDER upload replaces below
            self._catalogs.move_to_end(token)
            return {"stored": True, "duplicate": True}
        zovh = unpack_array(env.ovh_z) if env.ovh_z else None
        dev = self.device
        # the dtypes of an in-process upload (ops/solver.device_catalog)
        with dm.attributed(reason="catalog_put", kind="catalog",
                           token=token) as grp:
            dcat = DeviceCatalog(
                alloc=_put(unpack_array(env.alloc).astype(np.float32), dev),
                price=_put(unpack_array(env.price).astype(np.float32), dev),
                avail=_put(unpack_array(env.avail).astype(bool), dev),
                ovh_z=(_put(zovh.astype(np.float32), dev)
                       if zovh is not None else None))
        dm.DEVICEMEM.adopt(grp, dcat)
        self._catalogs[token] = dcat
        while len(self._catalogs) > self.max_catalogs:
            self._catalogs.popitem(last=False)  # LRU out
        self.stats["catalog_uploads"] += 1
        FEDERATION_CATALOG.inc(event="upload")
        return {"stored": True, "duplicate": False}

    def _rpc_solve_bucket(self, payload: dict) -> dict:
        import time as _time
        env = decode_envelope(payload)
        if not isinstance(env, SolveBucketRequest):
            raise CloudError(f"solve_bucket carries {type(env).__name__}")
        self._reject_compressed(env.gbuf, env.conf)
        token = self._token(env.token)
        dcat = self._catalogs.get(token)
        if dcat is None:
            # structured miss the client answers by re-announcing: the
            # token may have been LRU-evicted or the server restarted
            self.stats["unknown_token"] += 1
            raise NotFoundError(f"unknown catalog token {token!r}")
        self._catalogs.move_to_end(token)
        gstack = unpack_array(env.gbuf)
        conf = unpack_array(env.conf) if env.conf else None
        statics = _statics(env.statics)
        rkey = (("fed", env.process) if self.use_resident else None)
        t0 = _time.perf_counter()
        ifb = dispatch_packed(
            gstack, conf, dcat, statics, shape_class=env.shape_class,
            resident_key=rkey, token=token)
        # the server is the owner of record of the staged uploads (a
        # resident stack outlives the batch); the batch's event, then the
        # ONE read of the packed rows
        dm.DEVICEMEM.adopt(ifb.group, self)
        with dm.attributed(shape_class=env.shape_class):
            rows = ifb.rows()
        del ifb
        span_s = _time.perf_counter() - t0
        self.stats["buckets"] += 1
        self.stats["rows"] += int(env.B)
        self.stats["padded_rows"] += int(rows.shape[0])
        self.stats["max_bucket_rows"] = max(self.stats["max_bucket_rows"],
                                            int(rows.shape[0]))
        # echo the client's compression choice: a request whose gbuf
        # arrived zlib'd proves the peer decodes it, so the reply rows
        # may compress too; an uncompressed request gets uncompressed
        # rows (old clients never see a "z" payload)
        zcap = (self.compress_capability
                and bool(isinstance(env.gbuf, dict) and env.gbuf.get("z")))
        return encode_envelope(SolveBucketResult(
            schema=WIRE_SCHEMA_VERSION, run_id=env.run_id,
            rows=pack_array(rows, compress=zcap), span_s=span_s,
            padded=int(rows.shape[0])))

    def _rpc_report(self, payload: dict) -> dict:
        """Mirror client-side verdicts (admission, integrity, watchdog)
        into the server's ledger, so the cluster has ONE place that saw
        every process's findings."""
        envs = [decode_envelope(p) for p in payload.get("items", [])]
        self.reports.extend(envs)
        self.stats["reports"] += len(envs)
        return encode_envelope(ReportAck(
            schema=WIRE_SCHEMA_VERSION,
            run_id=payload.get("run_id", self.run_id),
            accepted=len(envs)))

    # --- helpers -----------------------------------------------------------

    @staticmethod
    def _token(tok) -> tuple:
        if tok is None:
            raise CloudError("catalog token required")
        return tuple(tok)


def _statics(wire_statics: dict) -> dict:
    """The launch statics of a wire frame, as the in-process bucket's:
    `cols` a tuple of ints (a frame may carry it as a list), and no key
    the launch does not read (the reference's frames carry no `Gp`; the
    stack's shape is authoritative)."""
    st = dict(wire_statics)
    return {"n_max": int(st["n_max"]), "k_max": int(st["k_max"]),
            "cols": tuple(int(c) for c in st["cols"]),
            "track_conflicts": bool(st["track_conflicts"]),
            "zone_ovh": bool(st["zone_ovh"])}


# ---------------------------------------------------------------------------
# HTTP wrapper — same wire shape as cloud/remote.make_server
# ---------------------------------------------------------------------------


def make_fed_server(server: SolverServer, host: str = "127.0.0.1",
                    port: int = 0):
    """An http.server exposing a SolverServer at POST /fed/<method>;
    returns the server object (.server_address[1] is the bound port).
    The X-Wire-Schema header is enforced BEFORE the body is parsed —
    declared skew answers 426 with a WireVersionError envelope, exactly
    like the /rpc surface — and GET /healthz carries the wire_schema
    field the HTTPTransport.handshake() ladder reads."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True,
                                 "wire_schema": WIRE_SCHEMA_VERSION,
                                 "gen": server.generation})
            else:
                self._send(404, {"error": {"type": "NotFoundError",
                                           "msg": self.path}})

        def do_POST(self):
            if not self.path.startswith("/fed/"):
                self._send(404, {"error": {"type": "NotFoundError",
                                           "msg": self.path}})
                return
            declared = self.headers.get("X-Wire-Schema")
            if declared is not None and declared != str(WIRE_SCHEMA_VERSION):
                err = WireVersionError(WIRE_SCHEMA_VERSION, declared)
                self._send(_http_status(err), {"error": encode_error(err)})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                self._send(400, {"error": {"type": "CloudError",
                                           "msg": f"bad body: {e}"}})
                return
            out = server.handle(self.path[len("/fed/"):], payload)
            if "error" in out:
                from ..cloud.remote import decode_error
                self._send(_http_status(decode_error(out["error"])), out)
            else:
                self._send(200, out)

    return ThreadingHTTPServer((host, port), Handler)


def serve_in_thread(server: SolverServer, host: str = "127.0.0.1",
                    port: int = 0):
    """(http server, port) with serve_forever on a daemon thread — the
    in-test harness; the subprocess path is `python -m
    karpenter_tpu_torch.federation.server`."""
    srv = make_fed_server(server, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


def main(argv: Optional[list] = None) -> int:
    """Standalone federation solver server. Prints ``READY <port>`` once
    bound (the same subprocess protocol as cloud/remote.py's gateway),
    then serves until killed. Runs on the CUDA card unless ``--device``
    names another."""
    import argparse
    import time

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--run-id", default="")
    p.add_argument("--device", default=None,
                   help="torch device of the catalogs and the launches "
                        "(default: the CUDA card; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--mesh", action="store_true",
                   help="lay bucket batch axes over all local devices "
                        "(not ported: raises)")
    p.add_argument("--no-resident", action="store_true",
                   help="disable the device-resident stack path")
    p.add_argument("--generation", type=int, default=1,
                   help="boot generation stamped into every reply frame "
                        "(a restarted server MUST come back with a "
                        "higher one — the crash-restart drill passes "
                        "prior+1)")
    p.add_argument("--no-compress", action="store_true",
                   help="model a version-skew restart: this boot does "
                        "not speak the compression capability")
    p.add_argument("--ready-delay", type=float, default=0.0,
                   help="test hook: sleep before binding")
    args = p.parse_args(argv)
    if args.ready_delay:
        time.sleep(args.ready_delay)
    server = SolverServer(mesh=True if args.mesh else None,
                          run_id=args.run_id,
                          use_resident=not args.no_resident,
                          generation=args.generation,
                          compress_capability=not args.no_compress,
                          device=args.device)
    srv = make_fed_server(server, args.host, args.port)
    print(f"READY {srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
