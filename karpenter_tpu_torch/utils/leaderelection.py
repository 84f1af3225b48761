"""Lease-based leader election — the HA story for multi-replica deploys.

The port's own copy of `karpenter_tpu/utils/leaderelection.py`, semantics unchanged.

Reference behavior: the controller-runtime manager's leader election
(cmd/controller/main.go wires `operator.NewOperator()` whose manager runs
client-go's leaderelection over a coordination.k8s.io Lease; the Helm chart
ships 2 replicas so one warm standby waits on the lease). This module
implements the same algorithm — client-go's tryAcquireOrRenew — over a
compare-and-swap'd lease record:

  - the lease names a holder with acquire/renew timestamps; writers CAS on
    a version counter (the resourceVersion analog);
  - expiry is judged from when THIS observer last saw the record CHANGE,
    never from the holder's timestamps directly (holders' clocks may skew —
    client-go's observedTime rule);
  - a holder renews every retry_period; failing to renew for renew_deadline
    steps it down locally (it stops reconciling before the lease expires,
    so two leaders never overlap: renew_deadline < lease_duration);
  - a non-holder acquires only after the observed record has not changed
    for lease_duration; transitions count leadership changes;
  - release() on clean shutdown hands the lease over immediately.

Backends: InMemoryLeaseBackend (sim/tests — deterministic with FakeClock),
FileLeaseBackend (flock'd JSON file: real mutual exclusion for replicas
sharing a volume; a Kubernetes backend would CAS a Lease object through the
API server the same way).

Timing defaults match client-go/controller-runtime: 15s lease, 10s renew
deadline, 2s retry.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional, Protocol, Tuple


@dataclass(frozen=True)
class Lease:
    holder: str
    acquire_time: float
    renew_time: float
    lease_duration: float
    transitions: int = 0
    version: int = 0  # CAS token, assigned by the backend on every write


class LeaseBackend(Protocol):
    def get(self) -> Optional[Lease]:
        ...

    def update(self, lease: Lease, expected_version: Optional[int]) -> bool:
        """Write iff the stored version matches (None = create iff absent).
        Returns success; the backend assigns the new version itself."""
        ...


class InMemoryLeaseBackend:
    """Thread-safe CAS lease for tests and the single-process sim."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lease: Optional[Lease] = None
        self._next_version = 1
        self.fail_writes = False  # fault injection: partition the backend

    def get(self) -> Optional[Lease]:
        with self._lock:
            return self._lease

    def update(self, lease: Lease, expected_version: Optional[int]) -> bool:
        with self._lock:
            if self.fail_writes:
                return False
            cur = self._lease.version if self._lease is not None else None
            if cur != expected_version:
                return False
            self._lease = replace(lease, version=self._next_version)
            self._next_version += 1
            return True


class FileLeaseBackend:
    """flock'd JSON lease file: real cross-process mutual exclusion for
    replicas sharing a volume (the k8s Lease-object analog)."""

    def __init__(self, path: str) -> None:
        self.path = path

    def _locked(self):
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def cm():
            fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
        return cm()

    def _read(self) -> Optional[Lease]:
        try:
            with open(self.path) as f:
                return Lease(**json.load(f))
        except (FileNotFoundError, json.JSONDecodeError, TypeError):
            return None

    def get(self) -> Optional[Lease]:
        with self._locked():
            return self._read()

    def update(self, lease: Lease, expected_version: Optional[int]) -> bool:
        with self._locked():
            cur = self._read()
            cur_ver = cur.version if cur is not None else None
            if cur_ver != expected_version:
                return False
            out = replace(lease, version=(cur_ver or 0) + 1)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(out.__dict__, f)
            os.replace(tmp, self.path)  # atomic publish
            return True


class HTTPLeaseBackend:
    """CAS lease through the remote cloud server's /lease endpoint — the
    coordination.k8s.io Lease-through-API-server analog. Replicas elect
    over the network instead of a shared RWX volume (the FileLeaseBackend
    caveat in deploy/karpenter-tpu.yaml). Transport failures read as
    'can't reach the lease': get() → None-safe False paths and update() →
    False, so a partitioned leader steps down within renew_deadline, the
    same way losing the API server does in client-go."""

    def __init__(self, host: str, port: int, timeout: float = 2.0) -> None:
        self.host, self.port, self.timeout = host, port, timeout

    def _request(self, method: str, body: Optional[dict] = None):
        import http.client
        import json as _json
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            try:
                conn.request(method, "/lease",
                             body=_json.dumps(body) if body else None,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return _json.loads(resp.read())
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException):
            # HTTPException covers a connection dropped mid-response
            # (IncompleteRead/BadStatusLine) — same "can't reach the
            # lease" semantics as a refused connection
            return None

    def get(self) -> Optional[Lease]:
        out = self._request("GET")
        if not out or out.get("lease") is None:
            return None
        return Lease(**out["lease"])

    def update(self, lease: Lease, expected_version: Optional[int]) -> bool:
        out = self._request("POST", {"lease": lease.__dict__,
                                     "expected_version": expected_version})
        return bool(out and out.get("ok"))


@dataclass
class Elector:
    backend: LeaseBackend
    identity: str
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    on_started_leading: List[Callable[[], None]] = field(default_factory=list)
    on_stopped_leading: List[Callable[[], None]] = field(default_factory=list)

    _leading: bool = False
    _renewed_at: float = 0.0
    # (version, first-seen-at) of the last observed record — expiry is
    # judged from OUR clock at the moment the record last changed
    _observed: Optional[Tuple[int, float]] = None

    name = "leader-election"  # lets the Engine drive it as a controller

    def is_leader(self) -> bool:
        return self._leading

    def reconcile(self, now: float) -> float:
        self.tick(now)
        return self.retry_period

    def tick(self, now: float) -> bool:
        """One tryAcquireOrRenew pass; returns leadership after the pass."""
        acquired = self._try_acquire_or_renew(now)
        if acquired:
            self._renewed_at = now
            if not self._leading:
                self._leading = True
                for fn in self.on_started_leading:
                    fn()
        elif self._leading and now - self._renewed_at >= self.renew_deadline:
            # can't reach/CAS the lease: step down BEFORE it expires so a
            # new leader elected elsewhere never overlaps with us
            self._step_down()
        return self._leading

    def _step_down(self) -> None:
        self._leading = False
        for fn in self.on_stopped_leading:
            fn()

    def _observe(self, lease: Optional[Lease], now: float) -> None:
        if lease is None:
            self._observed = None
        elif self._observed is None or self._observed[0] != lease.version:
            self._observed = (lease.version, now)

    def _try_acquire_or_renew(self, now: float) -> bool:
        lease = self.backend.get()
        self._observe(lease, now)
        if lease is None or not lease.holder:
            return self.backend.update(
                Lease(holder=self.identity, acquire_time=now, renew_time=now,
                      lease_duration=self.lease_duration,
                      transitions=(lease.transitions + 1) if lease else 0),
                lease.version if lease else None)
        if lease.holder != self.identity:
            seen_at = self._observed[1] if self._observed else now
            if now - seen_at < lease.lease_duration:
                return False  # current holder still within its lease
            return self.backend.update(
                Lease(holder=self.identity, acquire_time=now, renew_time=now,
                      lease_duration=self.lease_duration,
                      transitions=lease.transitions + 1),
                lease.version)
        return self.backend.update(
            replace(lease, renew_time=now,
                    lease_duration=self.lease_duration),
            lease.version)

    def release(self, now: float) -> None:
        """Clean handover on shutdown (client-go's ReleaseOnCancel): clear
        the holder so the standby acquires on its next retry, not after a
        full lease_duration."""
        if not self._leading:
            return
        lease = self.backend.get()
        if lease is not None and lease.holder == self.identity:
            self.backend.update(
                replace(lease, holder="", renew_time=now), lease.version)
        self._step_down()
