"""Federation client: a full fleet process minus the device.

The port's own copy of `karpenter_tpu/federation/client.py`. One
difference, on purpose: the port's fault contract (ROADMAP §3). The
ladder below degrades a bucket on what crosses a wire can raise (the
taxonomy's `CloudError`s, socket-level `OSError`s, the split-brain
guard's `StaleGenerationError`) and, on the local path, on an injected
device fault (`ops/solver.InjectedFault`); any other error — a bug in the
client's packing, a kernel's failure on the local path — raises out of
`pump()`.

`FederatedSolverClient` speaks the wire protocol (handshake, catalog
token announce/upload, bucket solves, verdict mirroring);
`FederatedSolverService` plugs it under the fleet's batched pump by
subclassing `fleet/service.SolverService` and overriding exactly ONE
seam — `_dispatch_bucket` — so every other behavior (DRR order, arena
leasing, staging, draining, ticket completion, SLO samples) is the
in-process code, not a copy of it.

The client packs each bucket's [B, Gp, W] request stack with the SAME
`_pack_groups`/`_group_inputs` calls `ops/solver.dispatch_batch` uses,
ships the bytes, and rehydrates the reply rows into an
`InFlightBatch.from_rows` — decode then runs locally against the
client's own catalogs. In-process and federated runs therefore share
every byte of the encode and decode paths; only the device hop moves.

Resilience ladder (ordered, each rung observable):

1. a retryable transport failure on an IDEMPOTENT RPC (handshake /
   has_catalog / report / healthz) retries in place — bounded attempts,
   seed-deterministic full-jitter backoff (the cloud batcher's
   discipline, rng seeded from (run_id, process)). `solve_bucket` never
   blind-retries: a failed solve re-dispatches through the degrade path
   below, so a non-idempotent RPC is never replayed on a guess.
2. wire failure mid-solve → exactly that bucket's tickets host-solve
   through their own facades (`_run_serial(fault_fallback=True)`, the
   SAME containment as a device fault), `federation_fallbacks_total
   {reason="error"}` increments, and the circuit breaker OPENS
3. while the breaker is open, buckets dispatch on the LOCAL device
   path (reason="cooldown"); every FED_COOLDOWN-th bucket issues one
   cheap `healthz` probe — a clean probe half-opens the breaker and the
   NEXT bucket is the trial: success rejoins the wire immediately
   (metered, with the degraded→rejoin latency), failure re-opens. A
   healed server is rejoined without waiting out a blind cooldown.
4. a catalog view without a content token cannot federate (tokens are
   the cross-process identity) — local dispatch, reason="no_token"
5. an unknown-token rejection (server restarted / FIFO-evicted) is NOT
   a failure: the client re-announces the catalog and retries once

Generation protocol (crash-restart recovery): every reply frame carries
the server's boot generation. A NEWER generation than the handshake
negotiated means the server restarted — the client invalidates every
token announcement, re-handshakes (re-negotiating the compress
capability: a version-skew reboot may no longer speak it), and lazily
re-announces catalogs, so tensors re-cross the wire exactly once per
view per boot. An OLDER generation is split-brain: the frame is
rejected by the transport-level guard before any envelope decoding
(StaleGenerationError), never acted on.

`federation_state()` feeds the watchdog's `federation_degraded` and
`federation_rejoin` invariants, so the ladder's first rung pages before
any tenant SLO burns — and a ladder that stops climbing (degraded past
the grace while probes succeed) pages too.
"""

from __future__ import annotations

import random
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..cloud.remote import (WIRE_SCHEMA_VERSION, CloudError, NotFoundError,
                            WireVersionError)
from ..metrics import (FEDERATION_BREAKER, FEDERATION_CATALOG,
                       FEDERATION_FALLBACKS, FEDERATION_GENERATION,
                       FEDERATION_RETRIES)
from ..fleet.service import SolverService
from .envelopes import (AdmissionVerdictEnvelope, CatalogUploadEnvelope,
                        IntegrityVerdictEnvelope, SolveBucketRequest,
                        SolveBucketResult, WatchdogFindingEnvelope,
                        decode_envelope, encode_envelope, pack_array,
                        tensor_bytes, unpack_array)
from .transport import StaleGenerationError

# what a wire can raise: the degrade ladder's trigger (module docstring)
WIRE_ERRORS = (CloudError, OSError, StaleGenerationError)

# buckets between healthz probes while the circuit breaker is open —
# count-based (virtual-clock-safe), the same shape as the facade's
# device FALLBACK_COOLDOWN; a clean probe short-circuits the wait
FED_COOLDOWN = 8
# bounded retries for idempotent RPCs, with the batcher's full-jitter
# exponential-ceiling backoff (base doubles toward the cap; the actual
# delay is uniform(0, ceiling) floored at ceiling/10)
FED_RETRIES = 3
RETRY_BASE = 0.05
RETRY_CAP = 2.0
# solve_bucket is deliberately absent: replaying a solve on a transport
# error risks double execution — failed solves take the degrade path
IDEMPOTENT_METHODS = frozenset({"handshake", "has_catalog", "report",
                                "healthz"})


def _retryable(e: BaseException) -> bool:
    """Transport-shaped failures worth a bounded retry: the taxonomy's
    retryable flag (ServerError and friends) plus raw socket-level
    exceptions an armed wire-fault hook or a dying connection raise."""
    return bool(getattr(e, "retryable", False)) or isinstance(
        e, (ConnectionError, OSError, TimeoutError))


class FederatedSolverClient:
    """The wire-side half: protocol state for ONE fleet process.

    Tracks which catalog tokens this process has already announced (and
    at what resource width), so steady state is zero catalog RPCs per
    bucket; the server's content-keyed store makes the aggregate
    cluster cost one tensor upload per distinct catalog view.
    """

    def __init__(self, transport, run_id: str = "", process: str = ""):
        self.transport = transport
        self.run_id = run_id
        self.process = process
        # handshake-negotiated: True once the server advertised it
        # decodes zlib'd pack_array payloads; stays False against old
        # servers, and every send then rides uncompressed
        self.compress = False
        self._announced: dict = {}   # token -> max resource width announced
        # generation protocol state: the server boot generation this
        # client negotiated at handshake (None until one completes), a
        # recursion guard for the recovery path, and whether the LAST
        # _wire_call observed a generation advance (set for callers
        # deciding whether a CloudError deserves a post-recovery replay)
        self._server_gen = None
        self._recovering = False
        self.regen_on_last_call = False
        self._regen_epoch = 0   # completed recoveries — gates reupload_bytes
        # retry backoff rng: seed-deterministic per (run_id, process), the
        # same derivation shape as the fleet's per-process fault plans
        self._rng = random.Random(
            zlib.crc32(f"{run_id}|{process}".encode()))
        # only the HTTP transport has a real socket to wait out; the
        # in-memory transport's backoff is pure bookkeeping
        self._sleep = getattr(transport, "retry_sleep", None)
        transport.gen_guard = self._gen_guard
        self.stats = {"solve_rpcs": 0, "catalog_rpcs": 0,
                      "announce_hits": 0, "announce_misses": 0,
                      "uploads": 0, "retried_unknown_token": 0,
                      "reports": 0,
                      # resilience-ladder meters
                      "retries": 0, "probes": 0,
                      "generation_changes": 0, "rehandshakes": 0,
                      "retried_generation": 0,
                      "stale_rejected": 0, "stale_decoded": 0,
                      "reupload_bytes": 0,
                      # raw (pre-base64, pre-JSON) tensor payload bytes
                      # this client shipped + received — the denominator
                      # of the wire-overhead ratio (wire bytes carry
                      # ~4/3 base64 inflation plus envelope framing)
                      "tensor_bytes_sent": 0, "tensor_bytes_received": 0}

    # --- generation protocol ----------------------------------------------

    def _gen_guard(self, gen, method: str) -> None:
        """Transport-installed split-brain guard: runs on every reply
        frame BEFORE its result/error is decoded. An OLDER generation
        than the negotiated one is a frame from a superseded boot —
        rejected, metered, never interpreted."""
        if gen is None or self._server_gen is None:
            return
        if gen < self._server_gen:
            self.stats["stale_rejected"] += 1
            FEDERATION_GENERATION.inc(event="stale_rejected")
            raise StaleGenerationError(self._server_gen, gen, method)

    def _maybe_recover_generation(self) -> bool:
        """Check the last reply frame's boot generation; on an advance,
        run crash-restart recovery: invalidate every token announcement,
        re-handshake (re-negotiating compress), and bump the regen
        epoch so subsequent re-uploads are accounted as restart cost.
        Returns True when a recovery ran."""
        if self._recovering:
            return False
        g = getattr(self.transport, "last_gen", None)
        if g is None:
            return False
        if self._server_gen is None:
            # first generation observation (pre-handshake reply): adopt
            self._server_gen = g
            return False
        if g <= self._server_gen:
            return False
        self._recovering = True
        try:
            self.stats["generation_changes"] += 1
            FEDERATION_GENERATION.inc(event="observed_change")
            self._announced.clear()
            self._server_gen = None   # adopt the new boot's generation
            self.handshake()
            self.stats["rehandshakes"] += 1
            FEDERATION_GENERATION.inc(event="rehandshake")
            self._regen_epoch += 1
        finally:
            self._recovering = False
        return True

    # --- retry ladder ------------------------------------------------------

    def _wire_call(self, method: str, payload: dict) -> dict:
        """All client RPCs funnel here: bounded seed-deterministic
        retries for idempotent methods, generation observation on every
        outcome (error frames carry the boot generation too — a
        NotFoundError from a rebooted server triggers recovery BEFORE
        the caller's re-announce). `regen_on_last_call` reports whether
        this call's final attempt observed a restart."""
        attempts = 0
        backoff = 0.0
        idem = method in IDEMPOTENT_METHODS
        while True:
            try:
                out = self.transport.call(method, payload)
            except StaleGenerationError:
                # split-brain is not a transport hiccup: no retry, no
                # recovery — the GUARD's generation is the newer one
                self.regen_on_last_call = False
                raise
            except BaseException as e:  # noqa: BLE001 — wire boundary
                self.regen_on_last_call = self._maybe_recover_generation()
                if not (idem and attempts < FED_RETRIES and _retryable(e)):
                    raise
                attempts += 1
                self.stats["retries"] += 1
                FEDERATION_RETRIES.inc(method=method)
                # the batcher discipline: the CEILING doubles
                # deterministically; the delay is full-jitter under it,
                # floored at a tenth so it never degenerates to zero
                backoff = min(max(backoff * 2, RETRY_BASE), RETRY_CAP)
                delay = max(self._rng.uniform(0.0, backoff), 0.1 * backoff)
                if self._sleep is not None:
                    self._sleep(delay)
                continue
            self.regen_on_last_call = self._maybe_recover_generation()
            return out

    def probe(self) -> bool:
        """One cheap healthz round trip — the circuit breaker's
        half-open test. Observes the boot generation like any RPC, so a
        restart is discovered at probe time, not first real traffic."""
        self.stats["probes"] += 1
        try:
            self._wire_call("healthz", {"schema": WIRE_SCHEMA_VERSION})
        except BaseException:  # noqa: BLE001 — a probe never raises
            return False
        return True

    def handshake(self) -> dict:
        """Negotiate schema + learn the server's shape. The reply's
        wire_schema is checked even on transports whose HTTP layer
        already enforced the header (in-memory has no header). Adopts
        the server's boot generation and compress capability — the two
        facts a crash-restart re-negotiates."""
        out = self._wire_call("handshake", {
            "schema": WIRE_SCHEMA_VERSION, "run_id": self.run_id,
            "process": self.process})
        theirs = out.get("wire_schema", 0)
        if theirs != WIRE_SCHEMA_VERSION:
            raise WireVersionError(WIRE_SCHEMA_VERSION, theirs)
        self.compress = bool(out.get("compress", False))
        self._server_gen = out.get(
            "generation", getattr(self.transport, "last_gen", None))
        return out

    # --- catalog token protocol -------------------------------------------

    def ensure_catalog(self, cat, R: int) -> Optional[tuple]:
        """Make the server hold a DeviceCatalog for `cat`'s content
        token at resource width >= R; returns the token (None when the
        catalog has no content token and cannot federate). Announce
        first, ship tensors only on miss — the once-per-cluster
        contract."""
        tok = getattr(cat, "cache_token", None)
        if tok is None:
            return None
        token = tuple(tok)
        if self._announced.get(token, -1) >= R:
            return token
        self.stats["catalog_rpcs"] += 1
        out = self._wire_call("has_catalog", {
            "schema": WIRE_SCHEMA_VERSION, "token": list(token),
            "R": int(R)})
        if out.get("present"):
            self.stats["announce_hits"] += 1
            FEDERATION_CATALOG.inc(event="announce_hit")
        else:
            self.stats["announce_misses"] += 1
            FEDERATION_CATALOG.inc(event="announce_miss")
            self._upload_catalog(cat, R, token)
        self._announced[token] = R
        return token

    def _upload_catalog(self, cat, R: int, token: tuple) -> None:
        from ..ops.encode import align_resources, align_zone_overhead
        zovh = align_zone_overhead(cat, R)

        def build() -> CatalogUploadEnvelope:
            # reads self.compress at CALL time: a generation recovery
            # mid-upload may have renegotiated it (version-skew restart
            # without the compress capability), so the replay must
            # re-pack, not resend stale compressed frames
            z = self.compress
            return CatalogUploadEnvelope(
                schema=WIRE_SCHEMA_VERSION, run_id=self.run_id,
                process=self.process, token=token,
                alloc=pack_array(align_resources(cat.allocatable, R),
                                 compress=z),
                price=pack_array(np.asarray(cat.price), compress=z),
                avail=pack_array(np.asarray(cat.available), compress=z),
                ovh_z=(pack_array(zovh, compress=z)
                       if zovh is not None else None),
                R=int(R))

        env = build()
        try:
            self._wire_call("put_catalog", encode_envelope(env))
        except CloudError:
            if not self.regen_on_last_call:
                raise
            # the server rebooted under this upload and recovery already
            # re-handshook — rebuild against the renegotiated capability
            # and replay once
            self.stats["retried_generation"] += 1
            FEDERATION_GENERATION.inc(event="replayed")
            env = build()
            self._wire_call("put_catalog", encode_envelope(env))
        self.stats["uploads"] += 1
        nbytes = (tensor_bytes(env.alloc) + tensor_bytes(env.price)
                  + tensor_bytes(env.avail) + tensor_bytes(env.ovh_z))
        self.stats["tensor_bytes_sent"] += nbytes
        if self._regen_epoch:
            # uploads after the first recovery are restart COST — the
            # bench's c18_restart_reupload_bytes bound
            self.stats["reupload_bytes"] += nbytes

    def forget(self, token: tuple) -> None:
        """Drop local announce state (server said unknown-token)."""
        self._announced.pop(tuple(token), None)

    # --- bucket solves -----------------------------------------------------

    def solve_bucket(self, reqs: List) -> Tuple[np.ndarray, float]:
        """Ship one same-signature bucket; returns (packed int32 rows
        [Bp, L], server device span seconds). Packs the stack with the
        exact calls dispatch_batch uses, so the bytes on the wire are
        the bytes an in-process dispatch would have uploaded. Retries
        ONCE through a catalog re-announce on unknown-token."""
        from ..ops.solver import _group_inputs, _pack_groups
        first = reqs[0]
        st = first.statics
        Gp, cols = first.Gp, list(st["cols"])
        R = int(first.enc.requests.shape[1])
        token = self.ensure_catalog(first.cat, R)
        if token is None:
            raise NotFoundError("catalog has no content token")
        gbufs = [_pack_groups(*_group_inputs(r.enc, Gp), cols)
                 for r in reqs]
        conf_np = None
        if st["track_conflicts"]:
            from ..ops.solver import _pad_to
            conf_np = np.stack(
                [_pad_to(_pad_to(r.enc.conflict, Gp, 0), Gp, 1)
                 if r.enc.conflict is not None
                 else np.zeros((Gp, Gp), bool) for r in reqs])

        def build() -> SolveBucketRequest:
            # compress read at call time — see _upload_catalog.build
            return SolveBucketRequest(
                schema=WIRE_SCHEMA_VERSION, run_id=self.run_id,
                process=self.process, token=token,
                shape_class=first.shape_class, Gp=int(Gp), B=len(reqs),
                statics=dict(st),
                gbuf=pack_array(np.stack(gbufs), compress=self.compress),
                conf=(pack_array(conf_np, compress=self.compress)
                      if conf_np is not None else None),
                tenants=tuple(getattr(r, "tenant", "") for r in reqs))

        env = build()
        self.stats["solve_rpcs"] += 1
        self.stats["tensor_bytes_sent"] += (tensor_bytes(env.gbuf)
                                            + tensor_bytes(env.conf))
        try:
            out = self._wire_call("solve_bucket", encode_envelope(env))
        except NotFoundError:
            # server lost the token (restart / FIFO eviction): any
            # generation recovery already ran inside _wire_call, so
            # re-announce + ONE retry — a protocol event, not a degrade
            self.forget(token)
            self.stats["retried_unknown_token"] += 1
            self.ensure_catalog(first.cat, R)
            out = self._wire_call("solve_bucket", encode_envelope(build()))
        except CloudError:
            if not self.regen_on_last_call:
                raise
            # rebooted server rejected the frame (e.g. a compressed
            # payload against a boot without the capability); recovery
            # renegotiated — re-announce, rebuild, replay once
            self.stats["retried_generation"] += 1
            FEDERATION_GENERATION.inc(event="replayed")
            self.ensure_catalog(first.cat, R)
            out = self._wire_call("solve_bucket", encode_envelope(build()))
        # belt check behind the transport guard: a frame from an older
        # boot must never reach this decode (chip_smoke.py fails
        # on any stale_decoded)
        g = getattr(self.transport, "last_gen", None)
        if (g is not None and self._server_gen is not None
                and g < self._server_gen):
            self.stats["stale_decoded"] += 1
        res = decode_envelope(out)
        assert isinstance(res, SolveBucketResult)
        self.stats["tensor_bytes_received"] += tensor_bytes(res.rows)
        return unpack_array(res.rows), float(res.span_s)

    # --- verdict mirroring -------------------------------------------------

    def report(self, items: List) -> int:
        """Mirror admission/integrity/watchdog envelopes to the server
        ledger; returns the accepted count (0 if nothing to send)."""
        if not items:
            return 0
        for it in items:
            assert isinstance(it, (AdmissionVerdictEnvelope,
                                   IntegrityVerdictEnvelope,
                                   WatchdogFindingEnvelope))
        out = self._wire_call("report", {
            "schema": WIRE_SCHEMA_VERSION, "run_id": self.run_id,
            "items": [encode_envelope(it) for it in items]})
        ack = decode_envelope(out)
        self.stats["reports"] += ack.accepted
        return ack.accepted


class FederatedSolverService(SolverService):
    """The fleet's SolverService with the device hop moved server-side.

    Only `_dispatch_bucket` changes: batchable buckets cross the wire
    and rehydrate as `InFlightBatch.from_rows`; everything upstream
    (staging, bucketing, DRR) and downstream (drain, decode, finish)
    is the parent's code, which is what makes the federated and the
    in-process digests byte-identical.
    """

    def __init__(self, clock, fed: FederatedSolverClient, **kwargs):
        super().__init__(clock, **kwargs)
        self.fed = fed
        self._fed_cooldown = 0
        self._fed_failures = 0
        self._fed_last_error = ""
        # circuit breaker: closed (wire live) → open (wire failure;
        # local dispatch, probe every FED_COOLDOWN buckets) → half_open
        # (probe passed; next bucket is the wire trial) → closed
        self._breaker = "closed"
        self._degraded_since = None       # sim time the wire degraded
        self._probe_ok_degraded = 0       # clean probes while degraded
        self.fed_stats = {"wire_buckets": 0, "wire_tickets": 0,
                          "local_buckets": 0, "cooldown_skips": 0,
                          "no_token": 0,
                          "probes_ok": 0, "probes_fail": 0,
                          "half_open": 0, "rejoins": 0,
                          "rejoin_ms_total": 0.0, "last_rejoin_ms": 0.0}

    def _dispatch_bucket(self, entries: List[dict]):
        from ..metrics.tenant import tenant_scope
        from ..ops import solver as ops_solver
        # the per-tenant device-fault probe KEEPS its in-process
        # semantics: a tenant-targeted fault plan aborts the bucket
        # before any dispatch, wire or local — the containment tests
        # rely on the probe order being identical on both paths
        try:
            for tenant in dict.fromkeys(e["ticket"].tenant
                                        for e in entries):
                with tenant_scope(tenant):
                    ops_solver.probe_dispatch_fault("device")
        except ops_solver.InjectedFault:  # degrade only this batch
            for e in entries:
                self._run_serial(e, fault_fallback=True)
            return None
        reqs = [e["batchable"] for e in entries]
        if self._breaker == "open":
            self._fed_cooldown -= 1
            if self._fed_cooldown > 0:
                self.fed_stats["cooldown_skips"] += 1
                FEDERATION_FALLBACKS.inc(reason="cooldown")
                return self._local_bucket(entries, reqs)
            # probe window: one cheap healthz decides whether the NEXT
            # traffic is a wire trial or another local stretch
            if self.fed.probe():
                self.fed_stats["probes_ok"] += 1
                self._probe_ok_degraded += 1
                FEDERATION_BREAKER.inc(event="probe_ok")
                self._breaker = "half_open"
                self.fed_stats["half_open"] += 1
                FEDERATION_BREAKER.inc(event="half_open")
                # fall through: THIS bucket is the trial
            else:
                self.fed_stats["probes_fail"] += 1
                FEDERATION_BREAKER.inc(event="probe_fail")
                self._fed_cooldown = FED_COOLDOWN
                self.fed_stats["cooldown_skips"] += 1
                FEDERATION_FALLBACKS.inc(reason="cooldown")
                return self._local_bucket(entries, reqs)
        elif self._fed_cooldown > 0:
            # legacy manually-armed cooldown (breaker closed): pure
            # countdown, no probes — kept for direct-state tests and
            # operator-forced local stretches
            self._fed_cooldown -= 1
            self.fed_stats["cooldown_skips"] += 1
            FEDERATION_FALLBACKS.inc(reason="cooldown")
            return self._local_bucket(entries, reqs)
        if getattr(reqs[0].cat, "cache_token", None) is None:
            # no content token = no cross-process catalog identity; the
            # local device path still serves the bucket
            self.fed_stats["no_token"] += 1
            FEDERATION_FALLBACKS.inc(reason="no_token")
            return self._local_bucket(entries, reqs)
        try:
            rows, span_s = self.fed.solve_bucket(reqs)
        except WireVersionError:
            # schema skew never heals by waiting or retrying — surface
            # it instead of degrading into a silent local-only fleet
            raise
        except WIRE_ERRORS as e:  # the wire is a boundary
            self._fed_failures += 1
            self._fed_cooldown = FED_COOLDOWN
            self._fed_last_error = f"{type(e).__name__}: {e}"
            if self._breaker != "open":
                self._breaker = "open"
                FEDERATION_BREAKER.inc(event="open")
            if self._degraded_since is None:
                self._degraded_since = self.clock.now()
            FEDERATION_FALLBACKS.inc(reason="error")
            # the failed bucket's tickets host-solve NOW through their
            # own facades — the device-fault containment contract
            for e2 in entries:
                self._run_serial(e2, fault_fallback=True)
            return None
        if self._breaker == "half_open":
            # the trial bucket came back clean: the wire is rejoined,
            # and the degraded→rejoin latency is the c18 headline
            self._breaker = "closed"
            since = self._degraded_since
            rejoin_ms = (0.0 if since is None
                         else (self.clock.now() - since) * 1e3)
            self.fed_stats["rejoins"] += 1
            self.fed_stats["last_rejoin_ms"] = rejoin_ms
            self.fed_stats["rejoin_ms_total"] += rejoin_ms
            FEDERATION_BREAKER.inc(event="rejoin")
            self._degraded_since = None
            self._probe_ok_degraded = 0
        ifb = ops_solver.InFlightBatch.from_rows(reqs, rows, span_s=span_s)
        cs = self.class_stats.setdefault(
            reqs[0].shape_class,
            {"tickets": 0, "batches": 0, "copending_pumps": 0,
             "cobatched_pumps": 0})
        cs["batches"] += 1
        self.fed_stats["wire_buckets"] += 1
        self.fed_stats["wire_tickets"] += len(entries)
        return ifb

    def _local_bucket(self, entries: List[dict], reqs: List):
        """Cooldown/no-token path: the parent's local device dispatch
        with the parent's containment (probe already ran above)."""
        from ..ops import solver as ops_solver
        try:
            ifb = ops_solver.dispatch_batch(
                reqs, resident_key=self._bucket_resident_key(entries))
        except ops_solver.InjectedFault:  # degrade only this batch
            for e in entries:
                self._run_serial(e, fault_fallback=True)
            return None
        cs = self.class_stats.setdefault(
            reqs[0].shape_class,
            {"tickets": 0, "batches": 0, "copending_pumps": 0,
             "cobatched_pumps": 0})
        cs["batches"] += 1
        self.fed_stats["local_buckets"] += 1
        return ifb

    def federation_state(self) -> dict:
        """The watchdog's federation_degraded + federation_rejoin
        observables, plus every client/service resilience meter (the
        key sets are disjoint by construction)."""
        now = self.clock.now()
        return {"federated": True,
                "degraded": (self._breaker != "closed"
                             or self._fed_cooldown > 0),
                "breaker": self._breaker,
                "cooldown": self._fed_cooldown,
                "failures": self._fed_failures,
                "last_error": self._fed_last_error,
                "degraded_for": ((now - self._degraded_since)
                                 if self._degraded_since is not None
                                 else 0.0),
                "probe_ok_degraded": self._probe_ok_degraded,
                **self.fed_stats,
                **self.fed.stats}


def build_federated_service(clock, server_addr: str = "", run_id: str = "",
                            process: str = "p000", shared_server=None,
                            mesh=None, **service_kwargs):
    """Assemble the client stack: transport → handshake → service.

    server_addr "host:port" dials a `make_fed_server` process over HTTP;
    empty embeds a SolverServer on the service's `device` (or over the
    batch `mesh`) behind an InMemoryTransport (full wire fidelity, no
    socket). shared_server lets several
    services in one process model several fleet processes against ONE
    server (pass each a distinct `process` name). The handshake runs
    here, so schema skew fails assembly, not the first bucket."""
    from .server import SolverServer
    from .transport import HTTPTransport, InMemoryTransport
    if server_addr:
        host, _, port = server_addr.rpartition(":")
        transport = HTTPTransport(host or "127.0.0.1", int(port))
        transport.handshake()
    else:
        server = shared_server if shared_server is not None else \
            SolverServer(run_id=run_id, mesh=mesh,
                         device=service_kwargs.get("device"))
        transport = InMemoryTransport(server)
    fed = FederatedSolverClient(transport, run_id=run_id, process=process)
    fed.handshake()
    return FederatedSolverService(clock, fed, **service_kwargs)
