"""Layered configuration: flags < env vars < explicit overrides.

The port's own copy of `karpenter_tpu/utils/options.py`: the same fields,
flags, env vars and precedence, plus one field, `device` (empty = the
CUDA card; `--device cpu` runs the solver's kernels' plain versions on the
host), and one other default: `solver_backend` is "device" (the
reference's is "auto"), so the operator's solver runs on the card.

Reference pattern: pkg/operator/options/options.go:30-58 — provider
options layered onto core options via an Injectable interface, every flag
mirrored by an env var, plus feature gates (Makefile:21-24: NodeRepair,
ReservedCapacity, SpotToSpotConsolidation, ...).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field, fields
from typing import Dict, Optional


def _env_name(flag: str) -> str:
    return flag.upper().replace("-", "_")


# Process-environment knobs that live OUTSIDE the Options dataclass —
# subsystem gates and artifact sinks read directly from os.environ at
# their use sites (module import order and subprocess scenarios make
# flag plumbing the wrong seam for these). This registry is the single
# documentation source: tools/gen_docs.py renders it into
# docs/reference/settings.md, and graftlint's `undocumented-env` rule
# fails the build when a KARPENTER_TPU_* literal appears in the package
# without a row here (docs/static-analysis.md). The port's table lists
# the knobs the port reads. Rows: (name, default, description).
ENV_KNOBS: tuple = (
    ("KARPENTER_TPU_DELTA", "1",
     "delta-plane master gate (ops/delta.py) — 0 disarms every "
     "serve-and-verify memo (solve/affinity/spread/optimizer) and the "
     "steady state recomputes from scratch, byte-for-byte identical"),
    ("KARPENTER_TPU_DELTA_AUDIT", "16",
     "delta-memo audit cadence: every this-many serves of a key is "
     "refused and recomputed fresh for a confirm/diverge verdict "
     "(0 audits every pass, i.e. the memo never serves)"),
    ("KARPENTER_TPU_DURATIONS", "<repo>/scale_durations.jsonl",
     "duration-event JSONL sink for the scale suite "
     "(metrics/durations.py, the Timestream analog)"),
    ("KARPENTER_TPU_FED_TIMEOUT", "10",
     "federation per-RPC wire deadline in seconds (federation/"
     "transport.py) — every HTTP transport call and handshake respects "
     "it; a timed-out RPC surfaces as a retryable ServerError and "
     "feeds the client's retry/breaker ladder"),
    ("KARPENTER_TPU_INTEGRITY", "1",
     "solution-integrity plane master gate — 0 restores the unverified "
     "solve path byte-for-byte (integrity/)"),
    ("KARPENTER_TPU_INTEGRITY_AUDIT", "16",
     "resident-state digest-audit cadence: one readback audit per this "
     "many verified solves (0 disables the audit)"),
    ("KARPENTER_TPU_INTEGRITY_CANARY", "64",
     "canary dual-path cadence: one host re-solve per this many device "
     "solves per facade (0 disables the canary)"),
    ("KARPENTER_TPU_OPTIMIZER", "1",
     "global disruption optimizer gate — 0 restores greedy "
     "consolidation byte-for-byte (optimizer/)"),
    ("KARPENTER_TPU_RESIDENT", "1",
     "device-resident cluster state — 0 disarms the manager and every "
     "upload falls back to the classic full-upload path (ops/resident.py)"),
    ("KARPENTER_TPU_TRACE_DIR", "",
     "when set, the tracer auto-enables and writes traces.jsonl here "
     "(obs/tracer.py)"),
    ("KARPENTER_TPU_TRACE_RING", "16",
     "flight-recorder ring capacity (traces kept in memory for "
     "post-mortem dumps)"),
)


@dataclass
class Options:
    cluster_name: str = "karpenter-tpu"
    region: str = "region-1"
    # reference default vmMemoryOverheadPercent=0.075 (options.go)
    vm_memory_overhead_percent: float = 0.075
    interruption_queue: str = ""          # empty = interruption handling off
    # device | auto | hybrid | native | host — the port defaults to the
    # device rung, so every solve runs on the card named by `device`
    # (the reference's default, auto, resolves to the size-adaptive
    # hybrid, which sends solves under 4,096 pods to the host)
    solver_backend: str = "device"
    # torch device of the solver's device rung and screens: empty = the
    # CUDA card (raises without one); "cpu" runs the kernels' plain
    # versions on the host
    device: str = ""
    # non-empty: every Solve() runs under torch.profiler — Chrome-trace
    # device traces per solve (utils/profiling.py)
    profile_dir: str = ""
    batch_idle_seconds: float = 1.0
    batch_max_seconds: float = 10.0
    max_instance_types: int = 60
    isolated: bool = False                # static pricing only (isolated-vpc)
    # last-good price book persisted here (the reference's generated
    # static price table analog); empty disables persistence
    pricing_snapshot_file: str = ""
    metrics_port: int = 8080
    log_level: str = "info"
    # HA: lease-based leader election (reference: controller-runtime
    # manager election, 2-replica chart). The file backend gives replicas
    # sharing a volume real mutual exclusion; empty path disables election.
    leader_elect: bool = False
    leader_elect_lease_file: str = "/var/run/karpenter-tpu/leader.lease"
    # host:port of a cloud endpoint serving the CAS'd /lease (the
    # Lease-through-API-server analog); non-empty overrides the file
    # backend and removes the shared-RWX-volume requirement
    leader_elect_endpoint: str = ""
    leader_elect_identity: str = ""       # default: hostname-pid
    # provisioning intent journal (state/journal.py): the write-ahead
    # log of launches, fsync'd before every CreateFleet call. Set a path
    # in production — a restarted operator replays the file's open
    # intents (adopt-or-reap) during rehydration; empty keeps the
    # journal in-memory (crash recovery then rests on adoption tags +
    # idempotency tokens alone)
    intent_journal_file: str = ""
    # warm-path audit cadence: every K-th warm admission window is
    # replayed through a full solve (docs/warmpath.md; tier-1 tests and
    # chaos scenarios run at 1 = always-on). Only read when the
    # WarmPathAdmission gate is on.
    warmpath_audit_every: int = 16
    # fleet mode (docs/fleet.md): >0 runs N simulated tenant control
    # planes through one process and ONE shared SolverService instead of
    # the single-cluster operator (`make fleet` drives 50). Each tenant
    # gets its own store/cloud/journal/warm path; per-tenant WAL files
    # derive from the --intent-journal-file DIRECTORY when set.
    fleet_tenants: int = 0
    # per-tenant solve-dispatch cap per fleet scheduling window — the
    # noisy-neighbor backpressure knob (fleet/service.py); only read in
    # fleet mode
    fleet_inflight_cap: int = 16
    # arm the shared SolverService's batched + pipelined dispatch engine
    # (fleet/service.py): compatible tenants' solves pack into one
    # vmapped device call, encode/decode for batch k+1 overlaps device
    # work for batch k. Results, hashes, and fault fingerprints are
    # identical either way; only read in fleet mode
    fleet_batch: bool = False
    # federation mode (docs/federation.md): route the fleet's batched
    # buckets through the federation plane (federation/) —
    # the device half of every solve runs in a SolverServer process
    # reached over the cloud/remote.py wire, catalogs cross once per
    # cluster via content tokens, and wire failures degrade buckets to
    # the local host-solve path under the watchdog's
    # federation_degraded invariant. Implies --fleet-batch and a device
    # backend; only read in fleet mode
    federate: bool = False
    # host:port of a running federation solver server (python -m
    # <package>.federation.server); empty with --federate embeds a
    # SolverServer behind an in-memory transport (full wire fidelity —
    # every payload round-trips the codec — without a socket); only
    # read with --federate
    server_addr: str = ""
    # long-soak serving mode (loadgen/, docs/loadgen.md): --soak drives
    # a tenant fleet OPEN-LOOP — seeded arrival processes fire on the
    # sim clock without waiting for drain, admission control sheds or
    # defers load past saturation, and the run is judged by the SLO
    # burn rates + the watchdog's overload_unbounded invariant
    soak: bool = False
    # soak scenario from loadgen.SOAK_SCENARIOS (soak_smoke |
    # soak_overload | soak_diurnal); only read with --soak
    soak_scenario: str = "soak_smoke"
    # arrival-rate override in batches/sec per tenant (0 = the
    # scenario's default); only read with --soak
    arrival_rate: float = 0.0
    # open-loop drive window in sim seconds (0 = scenario default; a
    # shorter value never truncates scheduled arrivals — the window
    # only ever extends); only read with --soak
    soak_duration: float = 0.0
    # disarm the admission controller's shed/defer verdicts (the
    # negative harness — overload then degrades unboundedly and the
    # watchdog must page); only read with --soak
    soak_no_admission: bool = False
    # feature gates (reference Makefile:21-24 + settings.md)
    feature_gates: Dict[str, bool] = field(default_factory=lambda: {
        "SpotToSpotConsolidation": True,
        "ReservedCapacity": True,
        "NodeRepair": True,
        "NodeOverlay": False,
        # arrival-only reconciles admit against the standing headroom
        # ledger instead of paying a full solve (warmpath/)
        "WarmPathAdmission": False,
    })

    def gate(self, name: str) -> bool:
        return self.feature_gates.get(name, False)

    @classmethod
    def parse(cls, argv: Optional[list] = None,
              env: Optional[Dict[str, str]] = None) -> "Options":
        env = dict(os.environ if env is None else env)
        parser = argparse.ArgumentParser("karpenter-tpu")
        defaults = cls()
        for f in fields(cls):
            if f.name == "feature_gates":
                parser.add_argument("--feature-gates", type=str, default=None,
                                    help="Gate=true,Gate2=false")
                continue
            flag = "--" + f.name.replace("_", "-")
            default = getattr(defaults, f.name)
            if f.type in ("bool", bool):
                # bare `--soak` arms the flag; `--soak false` still
                # disarms (there are no positionals, so nargs="?" is
                # unambiguous)
                parser.add_argument(flag, nargs="?", const=True,
                                    type=lambda s: s.lower() in ("1", "true", "yes"),
                                    default=None)
            elif f.type in ("float", float):
                parser.add_argument(flag, type=float, default=None)
            elif f.type in ("int", int):
                parser.add_argument(flag, type=int, default=None)
            else:
                parser.add_argument(flag, type=str, default=None)
        args = parser.parse_args(argv or [])

        out = cls()
        for f in fields(cls):
            if f.name == "feature_gates":
                continue
            # precedence: explicit flag > env var > default
            val = getattr(args, f.name, None)
            if val is None:
                ev = env.get(_env_name(f.name))
                if ev is not None:
                    cur = getattr(out, f.name)
                    if isinstance(cur, bool):
                        val = ev.lower() in ("1", "true", "yes")
                    elif isinstance(cur, float):
                        val = float(ev)
                    elif isinstance(cur, int):
                        val = int(ev)
                    else:
                        val = ev
            if val is not None:
                setattr(out, f.name, val)
        gates_str = args.feature_gates or env.get("FEATURE_GATES")
        if gates_str:
            for part in gates_str.split(","):
                if "=" in part:
                    k, v = part.split("=", 1)
                    out.feature_gates[k.strip()] = v.strip().lower() in ("1", "true", "yes")
        return out
