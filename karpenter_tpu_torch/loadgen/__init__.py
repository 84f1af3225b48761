"""Open-loop traffic plane: trace-driven load generation, admission
control/backpressure, and the long-soak serving mode.

The port's own copy of `karpenter_tpu/loadgen/`, with numpy and Python
semantics unchanged. The shared `SolverService` and every shard run on
`device=` (the CUDA card unless given; "cpu" runs the kernels' plain
versions), as the port's fleet runner does.

Every other load runner in this framework is CLOSED-LOOP — bench bursts,
chaos scenarios, and the fleet runner all wait for the system to drain
before offering more load, which hides saturation behavior entirely.
This package is the open-loop counterpart (Gavel/Tesserae's trace-driven
evaluation methodology, PAPERS.md):

- `LoadPlan` (plan.py) — seeded, replayable arrival processes
  (Poisson / diurnal / bursty / trace replay) plus spot- and ICE-
  weather overlays that expand into the existing fault machinery; one
  RNG, a canonical timeline, and a fingerprint, exactly like
  `faults.FaultPlan`;
- `OpenLoopSource` (source.py) — emits a plan's arrivals onto a live
  shard WITHOUT waiting for drain, routing every batch through the
  fleet's `AdmissionController` (fleet/service.py): admit, defer with
  seed-deterministic backoff, or shed (metered
  `loadgen_shed_total{tenant,reason}`);
- `SoakRunner` (soak.py) — the long-soak serving mode: drive the fleet
  at sustained arrival rates past saturation for bounded sim-hours,
  judged by the SLO burn rates, the watchdog's `overload_unbounded`
  invariant, and a three-digest repeat contract (end-state hash, fault
  fingerprint, load fingerprint).

    from karpenter_tpu_torch.loadgen import SoakRunner
    report = SoakRunner("soak_overload", seed=7, backend="device").run()

    python -m karpenter_tpu_torch.loadgen soak_smoke --repeat 2
    python -m karpenter_tpu_torch.loadgen soak_smoke --backend device \
        --device cpu
    python -m karpenter_tpu_torch.main --soak --arrival-rate 2 \
        --soak-duration 120
"""

from .plan import (Arrival, BurstyArrivals, DiurnalArrivals, IceWeather,
                   LoadPlan, PoissonArrivals, SpotWeather, TraceReplay,
                   load_trace, save_trace)
from .soak import (SOAK_SCENARIOS, SoakReport, SoakRunner, SoakScenario,
                   admission_slo, get_soak_scenario)
from .source import OpenLoopSource

__all__ = [
    "LoadPlan", "Arrival", "PoissonArrivals", "DiurnalArrivals",
    "BurstyArrivals", "TraceReplay", "SpotWeather", "IceWeather",
    "load_trace", "save_trace", "OpenLoopSource", "SoakRunner",
    "SoakReport", "SoakScenario", "SOAK_SCENARIOS", "get_soak_scenario",
    "admission_slo",
]
