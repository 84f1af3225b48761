"""Warm-path incremental admission engine with full-solve audit (the
port's copy of `karpenter_tpu/warmpath/`, unchanged in semantics: the
same classification, first-fit, escalation and audit as the reference's,
so a warm window's decisions, stats and state equal the reference's).
The admitter's first-fit runs on the host, as in the reference; the
auditor's replay and every cold pass go through `Solver.solve()`, which
on the device rung launches kernels B0 and B on the card.

The north-star headline is the cold case — 100k pending pods against the
full catalog in one kernel solve — but production steady state is the
opposite shape: a few pods arrive per engine tick against a standing
fleet, and a full [G, N, T, Z, C, R] solve per trickle pays the whole
encode + node-view rebuild + solve cost for a placement a first-fit into
known headroom decides in microseconds. This subsystem splits the two
regimes (the CvxCluster structure-reuse insight, PAPERS.md; the
Tesserae incremental-vs-periodic-global split):

- `DeltaTracker` (delta.py) watches the store's event feed and
  classifies each reconcile: *warm* when only pod arrivals happened
  since the last committed solve, *cold* when anything else changed
  (claims, nodes, daemonsets, catalog epoch, ICE marks, config hashes).
- `WarmAdmitter` (admitter.py) places warm arrivals against the
  standing per-pool headroom ledger using the SAME first-fit policy and
  offering masks as the full solver's existing-node pass
  (ops/binpack.first_fit_group — shared code, not a reimplementation).
  Colocation bundles and any non-fitting remainder escalate to the full
  solver; the warm path never approximates.
- `Auditor` (auditor.py) replays accumulated warm admissions through a
  fresh full `Solver.solve()` every K batches (always, in tier-1 tests)
  and meters divergence; divergence forces the path cold and
  flight-records a trace. The auditor is what makes the warm path a
  correctness tool instead of a fast-path gamble.
- `WarmPathEngine` (engine.py) orchestrates: classify → admit →
  audit → commit, wired into the provisioner (controllers/provisioner).

See the reference's docs/warmpath.md for the decision table and
escalation rules.
"""

from .admitter import PoolLedger, WarmAdmitter, build_pool_ledger
from .auditor import Auditor
from .delta import DeltaTracker
from .engine import WarmPathEngine

__all__ = ["DeltaTracker", "WarmAdmitter", "PoolLedger",
           "build_pool_ledger", "Auditor", "WarmPathEngine"]
