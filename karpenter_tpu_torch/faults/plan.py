"""FaultPlan: seeded, declarative, replayable fault injection.

The port's own copy of `karpenter_tpu/faults/plan.py`. One plan = one
seed + a list of rules; every probabilistic decision draws from the
plan's single `random.Random(seed)`, and every injected fault is
appended to `timeline` as a CANONICAL entry (no instance ids, no claim
names — those carry process-global counters and would differ between two
runs in one process). Same seed + same rules + same sim ⇒ byte-identical
timeline and fingerprint; that is the reproducibility contract the chaos
tests assert.

Where the port differs from the reference:
- `InjectedFault` is `ops/solver.InjectedFault`, re-exported: the one
  exception the facade, the optimizer and the fleet's batched pump
  degrade on (ROADMAP §3);
- `_corrupt_buffer` damages a torch tensor: it reads the tensor back,
  damages one row on the host and commits a NEW tensor on the same
  device, never the caller's in place (an aliased DeviceCatalog must not
  rot with it);
- `WireFault` rules fire through the federation transport's seams
  (`on_wire`, `on_wire_reply`; armed by `injector.wire_fault_plan_hook`).

The hooks the plan drives are all nil-guarded at their call sites
(`FakeCloud.fault_plan`, `ops.solver._dispatch_fault_hook`,
`FakeClock._jumps`, `utils.crashpoints._hook`), so an un-armed process
pays one attribute check per seam.

Every injection also lands on the observability layers: the
`karpenter_tpu_faults_injected_total{kind=...}` counter, and — when the
process tracer is on — a zero-width `fault.<kind>` child span inside
whatever trace is active.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..ops.solver import InjectedFault


@dataclass(frozen=True)
class IceWindow:
    """Offerings matching the selectors have no capacity during [t0, t1)
    of SIM time. None selectors match everything, so
    IceWindow(120, 300, zone="us-east1-b", capacity_type="spot") is the
    'zone ICEs for spot at t=[120,300)' rule."""

    t0: float
    t1: float
    instance_type: Optional[str] = None
    zone: Optional[str] = None
    capacity_type: Optional[str] = None

    def matches(self, instance_type: str, zone: str, capacity_type: str,
                now: float) -> bool:
        return (self.t0 <= now < self.t1
                and (self.instance_type is None
                     or self.instance_type == instance_type)
                and (self.zone is None or self.zone == zone)
                and (self.capacity_type is None
                     or self.capacity_type == capacity_type))


@dataclass(frozen=True)
class ApiFault:
    """Cloud API calls to `methods` fail with probability `p` during
    [t0, t1): error="rate_limited" raises a retryable 429 (carrying
    `retry_after` when set — exercising the server-hint path through the
    batcher), error="server" a retryable 5xx."""

    methods: Tuple[str, ...]
    t0: float = 0.0
    t1: float = math.inf
    p: float = 1.0
    error: str = "rate_limited"  # rate_limited | server
    retry_after: Optional[float] = None


@dataclass(frozen=True)
class ClockJump:
    """Sim time jumps by `delta` seconds when it first reaches `at`."""

    at: float
    delta: float


@dataclass(frozen=True)
class DeviceFault:
    """Device/mesh solve dispatches number [dispatch, dispatch+count)
    (1-based, counted per plan) raise InjectedFault — the TPU disappearing
    mid-solve. The facade falls back to native/host and suspends the
    device backend for a cooldown."""

    dispatch: int = 1
    count: int = 1


@dataclass(frozen=True)
class CorruptionFault:
    """Silent data corruption (SDC / bit-rot) in a device buffer the
    solve path is about to consume — the fault family the solution-
    integrity plane (integrity/) exists to catch. Unlike
    DeviceFault (the backend dying loudly), nothing raises: the buffer's
    bytes silently diverge from what the host staged, and the run only
    stays correct if the oracle, the canary, or the resident digest
    audit detects it BEFORE a placement commits.

    target: which upload seam — "gbuf" (non-resident staged request
    matrices: the serial path with residency disarmed, and the batched
    dispatcher's stacked gstack; ops/solver._maybe_corrupt) or
    "resident" (ops/resident.py buffers: request matrices, conflict
    matrices, and the resident catalog tensors — the post-patch seam).
    key_contains: for "resident", only corrupt uploads whose entry key
    carries this substring (e.g. "price" rots the resident price
    tensor, "gbuf" the request matrix); None matches every key.
    nth/count: 1-based count of ELIGIBLE seam probes (per rule) the
    corruption fires on — deterministic, like DeviceFault's dispatch
    numbering. at: the rule's arming time — probes before this
    run-relative sim instant do NOT count, so (at=30, nth=1) reads
    "the first matching upload after t=30" regardless of how many
    uploads the warm-up burned (and it carries the scenario's fault
    horizon, like an IceWindow's t1).

    kind: "bitflip" XORs bit 30 of every 32-bit word in the victim row
    (exponent-scale damage — guaranteed behavioral for live rows, and
    inverts a bool row), "zero_row" zeroes it, "stale_patch" overwrites
    it with its successor row (a patch applied at the wrong index).
    Every kind guarantees a REAL byte change (zero_row of an already-
    zero row and stale_patch of an identical successor both fall back
    to the bit flip) — a no-op injection would count against the
    100%-detection contract while corrupting nothing. The victim row is
    row 0 of the leading axis for "gbuf" (group 0 is always live) and a
    plan-RNG LIVE (non-zero) row for "resident" — live rows keep the
    damage behaviorally reachable, and the digest audit detects the rot
    regardless."""

    target: str = "gbuf"       # gbuf | resident
    kind: str = "bitflip"      # bitflip | zero_row | stale_patch
    nth: int = 1
    count: int = 1
    at: float = 0.0
    key_contains: Optional[str] = None


@dataclass(frozen=True)
class WireFault:
    """Federation wire weather: the transport between a fleet process
    and the solver server misbehaving — the fault family the federation
    resilience plane (retry ladder, circuit breaker, generation
    protocol) exists to absorb. Fires through the nil-guarded seams in
    `federation/transport.py` (`set_wire_fault_hook` before every RPC,
    `set_wire_reply_hook` on every reply frame), armed by
    `faults/injector.wire_fault_plan_hook`.

    kind:
      - "blackhole": EVERY matching RPC during the window fails with a
        ConnectionError — a network partition; healthz probes fail too
        unless `methods` excludes them, so the breaker stays open until
        the window lifts.
      - "latency": the nth..nth+count-1 eligible probes raise a
        retryable deadline-exceeded ServerError — a transient stall the
        idempotent-RPC retry ladder should absorb without a degrade.
      - "reset": same counting, but a ConnectionResetError — the peer
        dropping the socket mid-RPC.
      - "flap": the wire alternates down/up in runs of `nth` eligible
        probes (probes 1..nth fail, nth+1..2*nth pass, ...) for the
        whole window — the oscillating-server drill the half-open
        breaker must rejoin from without a full cooldown per flap.
      - "slow_handshake": like "latency" but only handshake/healthz
        RPCs are eligible — connect/probe paths stall while solves
        (once connected) would be fine.
      - "corrupt_frame": the nth..nth+count-1 eligible REPLY frames are
        garbled at the byte level (reply seam) — the transport must
        reject the frame as a transport failure, never decode it.

    window: the rule is armed during [at, at+window) of run-relative
    sim time; probes outside do not count (CorruptionFault's `at`
    discipline, plus an explicit close). nth/count: 1-based counts of
    ELIGIBLE probes per rule, deterministic like every other family.
    methods: restrict eligibility to these RPC method names (None
    matches every method). Every firing lands on the plan's canonical
    timeline, so wire weather rides the same fingerprint contract as
    corruption — `--repeat 2` must reproduce it byte-for-byte."""

    kind: str = "reset"   # blackhole | latency | reset | flap | slow_handshake | corrupt_frame
    at: float = 0.0
    window: float = math.inf
    nth: int = 1
    count: int = 1
    methods: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class CrashPoint:
    """The operator process dies at a named commit-path cut point
    (utils/crashpoints.CUT_POINTS: mid_launch_batch, post_launch,
    mid_drain, mid_warm_audit). `nth` is the 1-based cumulative firing
    count of that point — counted across the whole run, INCLUDING
    firings in rebuilt processes, so a plan's crashes sequence
    deterministically through restarts; `at` arms the gate only from
    that run-relative sim time (a firing before `at` still counts but
    cannot crash). Each rule fires at most once. CrashInjected unwinds
    the whole engine — only faults/runner.RestartRunner (which rebuilds
    the stack on the surviving cloud/clock/journal) can run a plan
    carrying these rules."""

    point: str
    nth: int = 1
    at: float = 0.0


@dataclass(frozen=True)
class InterruptionBurst:
    """At sim time `at`, `count` running instances receive an interruption:
    kind="spot" queues a 2-minute spot reclaim warning, kind="kill"
    terminates the instance outright (state-change event), kind="rebalance"
    queues a rebalance recommendation. target_pods: only instances whose
    node hosts a pod with one of these name prefixes qualify (how the
    interruption-wave scenario aims at a colocated bundle); None = any
    running instance. Targets are chosen with the plan RNG over the
    creation-ordered instance list, so the same seed picks the same
    victims."""

    at: float
    count: int = 1
    kind: str = "spot"  # spot | kill | rebalance
    target_pods: Optional[Tuple[str, ...]] = None


class FaultPlan:
    """Seeded rule engine + fault ledger. Thread a plan through
    `sim.make_sim(fault_plan=...)` (or wire the hooks by hand) and every
    seam consults it; `timeline` / `fingerprint()` afterwards describe
    exactly what was injected and when."""

    def __init__(self, seed: int = 0, rules: Sequence[object] = ()):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules = list(rules)
        self.ice_windows = [r for r in self.rules if isinstance(r, IceWindow)]
        self.api_faults = [r for r in self.rules if isinstance(r, ApiFault)]
        self.clock_jumps = sorted(
            (r for r in self.rules if isinstance(r, ClockJump)),
            key=lambda r: r.at)
        self.device_faults = [r for r in self.rules
                              if isinstance(r, DeviceFault)]
        self.corruption_faults = [r for r in self.rules
                                  if isinstance(r, CorruptionFault)]
        self._corruption_counts: dict = {}  # rule idx -> eligible probes
        self.wire_faults = [r for r in self.rules
                            if isinstance(r, WireFault)]
        self._wire_counts: dict = {}  # (seam, rule idx) -> eligible probes
        # per-FIRED-injection snapshot of the integrity plane's
        # detection counter at injection time, in firing order — the
        # runners' judgment matches detections to injections through
        # these (an aggregate injected<=detected comparison would let an
        # over-attributed early injection mask a later undetected one)
        self._corruption_pre: List[int] = []
        self.crash_points = [r for r in self.rules
                             if isinstance(r, CrashPoint)]
        self._point_fires: dict = {}   # point -> cumulative firing count
        self._crashed: set = set()     # indices of consumed CrashPoints
        self._bursts = sorted(
            (r for r in self.rules if isinstance(r, InterruptionBurst)),
            key=lambda r: r.at)
        self._dispatches = 0
        # set when the plan is installed (make_sim / injector) so hooks
        # without a `now` argument (device dispatch) can stamp the ledger
        self.clock = None
        # rule times are RELATIVE to the run start; make_sim stamps the
        # install-time clock reading here so "t=[120,300)" means 120-300
        # sim-seconds into the run regardless of the clock's epoch
        self.origin = 0.0
        # canonical (sim_time, kind, detail) ledger — see module docstring
        self.timeline: List[Tuple[float, str, str]] = []

    # --- ledger -----------------------------------------------------------
    def record(self, now: float, kind: str, detail: str) -> None:
        """`now` is an absolute clock reading; the ledger stores run-
        relative time so two runs' timelines compare byte-for-byte."""
        self.timeline.append((round(float(now) - self.origin, 6), kind,
                              detail))
        from ..metrics import FAULTS_INJECTED
        FAULTS_INJECTED.inc(kind=kind)
        from ..obs.tracer import TRACER
        if TRACER.enabled:
            # zero-width child span in whatever trace is live: the fault-
            # attribution mark /debug/traces shows next to the stage that
            # absorbed it
            with TRACER.span(f"fault.{kind}", detail=detail):
                pass

    def fingerprint(self) -> str:
        """Digest of the injected-fault timeline — two runs with the same
        seed must produce the same value (the reproducibility assert)."""
        h = hashlib.sha256()
        for t, kind, detail in self.timeline:
            h.update(f"{t:.6f}|{kind}|{detail}\n".encode())
        return h.hexdigest()

    # --- hook surfaces ----------------------------------------------------
    def ice_active(self, instance_type: str, zone: str, capacity_type: str,
                   now: float) -> bool:
        """Consulted by FakeCloud._launch_one per override row; a hit makes
        the pool behave exhausted (ICE) for that row."""
        rel = now - self.origin
        for w in self.ice_windows:
            if w.matches(instance_type, zone, capacity_type, rel):
                self.record(now, "ice",
                            f"{instance_type}/{zone}/{capacity_type}")
                return True
        return False

    def api_fault(self, method: str, now: float):
        """Consulted by injector.FaultyCloud before forwarding `method`;
        returns a CloudError to raise, or None. Draws the RNG once per
        matching probabilistic rule — call order is deterministic in the
        sim, so the draw sequence is too."""
        from ..cloud.provider import RateLimitedError, ServerError
        rel = now - self.origin
        for r in self.api_faults:
            if method not in r.methods or not (r.t0 <= rel < r.t1):
                continue
            if r.p < 1.0 and self.rng.random() >= r.p:
                continue
            self.record(now, "api", f"{method}:{r.error}")
            if r.error == "server":
                return ServerError(f"injected server error on {method}")
            return RateLimitedError(f"injected throttle on {method}",
                                    retry_after=r.retry_after)
        return None

    def on_dispatch(self, backend: str) -> None:
        """The ops.solver dispatch hook: raises InjectedFault when a
        DeviceFault rule covers this (1-based) dispatch number."""
        self._dispatches += 1
        for r in self.device_faults:
            if r.dispatch <= self._dispatches < r.dispatch + r.count:
                now = self.clock.now() if self.clock is not None else 0.0
                self.record(now, "device",
                            f"{backend}:dispatch#{self._dispatches}")
                raise InjectedFault(
                    f"injected {backend} fault on dispatch "
                    f"#{self._dispatches}")

    def on_corruption(self, target: str, buf, key: tuple = ()):
        """The ops.solver/ops.resident corruption seam: returns `buf`
        unchanged, or a silently corrupted replacement when a
        CorruptionFault rule covers this (per-rule, 1-based) eligible
        probe. Never raises — SDC is quiet by definition; detection is
        the integrity plane's job."""
        out = buf
        now = self.clock.now() if self.clock is not None else 0.0
        rel = now - self.origin
        for i, r in enumerate(self.corruption_faults):
            if r.target != target:
                continue
            if r.key_contains is not None and not any(
                    r.key_contains in str(part) for part in key):
                continue
            if rel < r.at:
                continue  # not armed yet: pre-`at` probes don't count
            n = self._corruption_counts.get(i, 0) + 1
            self._corruption_counts[i] = n
            if not (r.nth <= n < r.nth + r.count):
                continue
            out = self._corrupt_buffer(out, r.kind, target)
            detail = f"{target}:{r.kind}#{n}"
            if r.key_contains:
                detail += f":{r.key_contains}"
            self.record(now, "corruption", detail)
            from ..integrity import INTEGRITY
            self._corruption_pre.append(INTEGRITY.detections())
        return out

    def _corrupt_buffer(self, buf, kind: str, target: str):
        """Apply one corruption to a device buffer: read it back,
        damage one row, re-commit. The victim row is row 0 for "gbuf"
        (always a live group — padding rows would be inert, and an
        inert injection breaks the 100%-detection contract) and a
        plan-RNG LIVE row for "resident" (behaviorally reachable; the
        digest audit sees every row either way)."""
        import numpy as np
        import torch
        # a host copy, damaged there and committed as a NEW tensor: the
        # caller's tensor keeps its bytes (an aliased holder must not rot)
        arr = buf.detach().cpu().numpy().copy()
        rows = arr.reshape(-1, arr.shape[-1]) if arr.ndim > 1 \
            else arr.reshape(1, -1)
        if target == "gbuf":
            r = 0
        else:
            lead = arr.shape[0] if arr.ndim > 1 else 1
            if arr.ndim > 2:  # [T, Z, C]-style: flatten trailing axes
                rows = arr.reshape(arr.shape[0], -1)
            else:
                rows = arr if arr.ndim > 1 else arr.reshape(1, -1)
            live = np.nonzero(rows.any(axis=1))[0]
            r = (int(live[self.rng.randrange(live.size)]) if live.size
                 else self.rng.randrange(max(lead, 1)))
        if kind == "zero_row":
            if rows[r].any():
                rows[r] = 0
            else:  # already zero: a no-op is not an injection
                self._flip_row(rows, r)
        elif kind == "stale_patch":
            src = (r + 1) % rows.shape[0]
            if src != r and rows[src].tobytes() != rows[r].tobytes():
                rows[r] = rows[src]
            else:  # successor identical: degenerate no-op — keep the
                # injection REAL by falling back to a bit flip
                self._flip_row(rows, r)
        else:
            self._flip_row(rows, r)
        return torch.from_numpy(arr).to(buf.device)

    @staticmethod
    def _flip_row(rows, r: int) -> None:
        import numpy as np
        if rows.dtype == bool:
            rows[r] = ~rows[r]
            return
        row = rows[r]
        if row.dtype.itemsize == 4:
            words = row.view(np.uint32)
            words ^= np.uint32(1 << 30)
        else:
            as_bytes = row.view(np.uint8)
            as_bytes ^= np.uint8(0x40)

    @property
    def has_corruption_faults(self) -> bool:
        return bool(self.corruption_faults)

    def on_wire(self, method: str) -> None:
        """The federation transport's request-side seam
        (`transport.set_wire_fault_hook`): raises the rule taxonomy's
        exception when a WireFault covers this (per-rule, 1-based)
        eligible probe inside its armed window. corrupt_frame rules are
        reply-seam only and never fire here."""
        if not self.wire_faults:
            return
        now = self.clock.now() if self.clock is not None else 0.0
        rel = now - self.origin
        for i, r in enumerate(self.wire_faults):
            if r.kind == "corrupt_frame":
                continue
            if r.kind == "slow_handshake":
                if method not in ("handshake", "healthz"):
                    continue
            elif r.methods is not None and method not in r.methods:
                continue
            if not (r.at <= rel < r.at + r.window):
                continue
            if r.kind == "blackhole":
                # a partition has no nth: every matching RPC in the
                # window fails, probes included
                self.record(now, "wire", f"blackhole:{method}")
                raise ConnectionError(
                    f"injected wire blackhole on {method}")
            n = self._wire_counts.get(("req", i), 0) + 1
            self._wire_counts[("req", i)] = n
            if r.kind == "flap":
                # runs of `nth` eligible probes: down, up, down, ...
                if ((n - 1) // max(r.nth, 1)) % 2 == 0:
                    self.record(now, "wire", f"flap:{method}#{n}")
                    raise ConnectionError(
                        f"injected wire flap on {method} (probe {n})")
                continue
            if not (r.nth <= n < r.nth + r.count):
                continue
            self.record(now, "wire", f"{r.kind}:{method}#{n}")
            if r.kind in ("latency", "slow_handshake"):
                from ..cloud.provider import ServerError
                raise ServerError(
                    f"injected wire {r.kind} on {method} (probe {n}): "
                    f"deadline exceeded")
            raise ConnectionResetError(
                f"injected wire reset on {method} (probe {n})")

    def on_wire_reply(self, method: str, raw: bytes) -> bytes:
        """The reply-side seam (`transport.set_wire_reply_hook`):
        returns the reply frame's bytes, garbled when a corrupt_frame
        WireFault covers this eligible reply — the first byte is XORed
        so the frame can no longer parse as JSON, forcing the transport
        to reject it as a transport failure instead of decoding it."""
        if not self.wire_faults:
            return raw
        now = self.clock.now() if self.clock is not None else 0.0
        rel = now - self.origin
        out = raw
        for i, r in enumerate(self.wire_faults):
            if r.kind != "corrupt_frame":
                continue
            if r.methods is not None and method not in r.methods:
                continue
            if not (r.at <= rel < r.at + r.window):
                continue
            n = self._wire_counts.get(("reply", i), 0) + 1
            self._wire_counts[("reply", i)] = n
            if not (r.nth <= n < r.nth + r.count):
                continue
            self.record(now, "wire", f"corrupt_frame:{method}#{n}")
            out = (bytes([out[0] ^ 0xFF]) + out[1:]) if out else b"\xff"
        return out

    @property
    def has_wire_faults(self) -> bool:
        return bool(self.wire_faults)

    def on_crash_point(self, point: str) -> None:
        """The utils.crashpoints hook (armed by injector.crash_point_hook):
        counts the firing and raises CrashInjected when an unconsumed
        CrashPoint rule covers it. Counts and consumed rules live on the
        plan, which SURVIVES the crash — the restart harness re-arms the
        same plan on the rebuilt stack, so firing numbers keep advancing
        monotonically through process lifetimes."""
        if not self.crash_points:
            return
        n = self._point_fires.get(point, 0) + 1
        self._point_fires[point] = n
        now = self.clock.now() if self.clock is not None else 0.0
        rel = now - self.origin
        for i, r in enumerate(self.crash_points):
            if i in self._crashed or r.point != point:
                continue
            if rel >= r.at and n >= r.nth:
                self._crashed.add(i)
                self.record(now, "crash", f"{point}#{n}")
                from ..utils.crashpoints import CrashInjected
                raise CrashInjected(
                    f"injected operator crash at {point} (firing #{n})")

    @property
    def crashes_remaining(self) -> int:
        """CrashPoint rules not yet consumed — the restart harness keeps
        the run open until every scheduled death has happened."""
        return len(self.crash_points) - len(self._crashed)

    def on_jump(self, new_now: float, delta: float) -> None:
        """FakeClock.schedule_jump callback — records the applied skew."""
        self.record(new_now, "clock_jump", f"{delta:+g}s")

    def due_bursts(self, now: float) -> List[InterruptionBurst]:
        """One-shot: bursts whose time has come, removed from the queue
        (the injector's engine hook drains this each tick)."""
        due = []
        while self._bursts and self._bursts[0].at <= now - self.origin:
            due.append(self._bursts.pop(0))
        return due

    @property
    def has_device_faults(self) -> bool:
        return bool(self.device_faults)
