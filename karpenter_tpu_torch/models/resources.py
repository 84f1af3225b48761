"""Resource quantities and resource lists.

The port's own copy of `karpenter_tpu/models/resources.py`, unchanged in
semantics (the port imports nothing of the JAX package).

Kubernetes-style quantity parsing ("100m", "1.5Gi", "2") and a fixed resource
axis used to flatten pod requests / instance capacity into dense vectors for
the solver.

Reference parity: the capacity/overhead math lives in the reference's
instancetype resolver (pkg/providers/instancetype/types.go:320-559); here we
only define the quantity algebra + the dense axis. The axis is extensible via
`register_resource` (reference supports nvidia/amd/neuron/habana/efa custom
resources the same open-ended way).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Mapping

# --- quantity parsing -------------------------------------------------------

_BIN_SUFFIX = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC_SUFFIX = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}

_QTY_RE = re.compile(r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)\s*$")


def parse_quantity(q: "str | int | float") -> float:
    """Parse a Kubernetes quantity into a float of base units.

    "100m" -> 0.1, "1.5Gi" -> 1610612736.0, "2" -> 2.0, 250 -> 250.0
    """
    if isinstance(q, (int, float)):
        return float(q)
    m = _QTY_RE.match(q)
    if not m:
        raise ValueError(f"invalid quantity: {q!r}")
    num, suffix = float(m.group(1)), m.group(2)
    if suffix == "":
        return num
    if suffix == "m":
        return num / 1000.0
    if suffix in _BIN_SUFFIX:
        return num * _BIN_SUFFIX[suffix]
    if suffix in _DEC_SUFFIX:
        return num * _DEC_SUFFIX[suffix]
    raise ValueError(f"invalid quantity suffix: {q!r}")


def format_quantity(v: float, binary: bool = False) -> str:
    """Human-readable quantity (for logs/events only; not round-trip exact)."""
    if v == 0:
        return "0"
    if binary:
        for suf in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
            if abs(v) >= _BIN_SUFFIX[suf]:
                return f"{v / _BIN_SUFFIX[suf]:g}{suf}"
    if abs(v) < 1 and v == round(v * 1000) / 1000:
        return f"{round(v * 1000)}m"
    return f"{v:g}"


# --- resource names ---------------------------------------------------------

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
GPU = "gpu.karpenter.tpu/accelerator"  # generic accelerator resource
NVIDIA_GPU = "nvidia.com/gpu"
TPU_CHIP = "google.com/tpu"
EFA = "networking.karpenter.tpu/interface"

# Dense resource axis for the solver. Order is load-bearing: it defines axis R
# of every capacity/requests tensor. Extensible at runtime (before tensors are
# built) via register_resource().
_RESOURCE_AXIS: list = [CPU, MEMORY, PODS, EPHEMERAL_STORAGE, NVIDIA_GPU, GPU, TPU_CHIP, EFA]
_RESOURCE_INDEX: Dict[str, int] = {r: i for i, r in enumerate(_RESOURCE_AXIS)}

# Memory-scale resources are stored in MiB in device tensors so float32 holds
# them exactly (bytes overflow f32 mantissa at ~16GiB granularity).
_MIB_SCALED = {MEMORY, EPHEMERAL_STORAGE}
_MIB = float(2**20)


def resource_axis() -> tuple:
    return tuple(_RESOURCE_AXIS)


def resource_index(name: str) -> int:
    return _RESOURCE_INDEX[name]


def num_resources() -> int:
    return len(_RESOURCE_AXIS)


def register_resource(name: str) -> int:
    """Add a custom resource to the dense axis; returns its index."""
    if name in _RESOURCE_INDEX:
        return _RESOURCE_INDEX[name]
    _RESOURCE_AXIS.append(name)
    _RESOURCE_INDEX[name] = len(_RESOURCE_AXIS) - 1
    return _RESOURCE_INDEX[name]


def device_scale(name: str) -> float:
    """Divisor applied when placing this resource into a device tensor."""
    return _MIB if name in _MIB_SCALED else 1.0


# --- ResourceList -----------------------------------------------------------


class Resources(Dict[str, float]):
    """A resource list: name -> base-unit float. Missing keys are zero."""

    @classmethod
    def parse(cls, m: "Mapping[str, str | int | float] | None") -> "Resources":
        r = cls()
        for k, v in (m or {}).items():
            r[k] = parse_quantity(v)
        return r

    def get(self, key: str, default: float = 0.0) -> float:  # type: ignore[override]
        return super().get(key, default)

    def add(self, other: Mapping[str, float]) -> "Resources":
        out = Resources(self)
        for k, v in other.items():
            out[k] = out.get(k, 0.0) + v
        return out

    def sub(self, other: Mapping[str, float]) -> "Resources":
        out = Resources(self)
        for k, v in other.items():
            out[k] = out.get(k, 0.0) - v
        return out

    def fits(self, capacity: Mapping[str, float]) -> bool:
        """True if self <= capacity on every named resource."""
        for k, v in self.items():
            if v > 0 and v > capacity.get(k, 0.0) + 1e-9:
                return False
        return True

    def nonzero(self) -> "Resources":
        return Resources({k: v for k, v in self.items() if v != 0})

    def to_vector(self) -> list:
        """Dense [R] vector in device scale (memory in MiB).

        Unknown resource names are auto-registered rather than dropped: a
        custom resource silently vanishing from the feasibility tensor would
        make the solver bind pods onto nodes that can never run them. The
        encoder reads num_resources() once per solve, after all vectors are
        built, so late registration stays consistent within a solve.
        """
        for k in self:
            if k not in _RESOURCE_INDEX:
                register_resource(k)
        vec = [0.0] * len(_RESOURCE_AXIS)
        for k, v in self.items():
            vec[_RESOURCE_INDEX[k]] = v / device_scale(k)
        return vec

    @staticmethod
    def from_vector(vec: Iterable[float]) -> "Resources":
        out = Resources()
        for i, v in enumerate(vec):
            if v and i < len(_RESOURCE_AXIS):
                name = _RESOURCE_AXIS[i]
                out[name] = float(v) * device_scale(name)
        return out


def merge(*rs: Mapping[str, float]) -> Resources:
    out = Resources()
    for r in rs:
        out = out.add(r)
    return out


def pod_requests(containers: Iterable[Mapping[str, float]],
                 init_containers: Iterable[Mapping[str, float]] = (),
                 overhead: "Mapping[str, float] | None" = None) -> Resources:
    """Effective pod request: max(sum(containers), max(initContainers)) + overhead.

    Same aggregation Kubernetes (and the reference's scheduling simulation)
    uses for pod resource accounting.
    """
    total = Resources()
    for c in containers:
        total = total.add(c)
    for ic in init_containers:
        for k, v in ic.items():
            if v > total.get(k, 0.0):
                total[k] = v
    if overhead:
        total = total.add(overhead)
    if total.get(PODS, 0.0) == 0:
        total[PODS] = 1.0  # every pod consumes one pod slot
    return total


def ceil_div(a: float, b: float) -> int:
    if b <= 0:
        return 0
    return int(math.ceil(a / b - 1e-9))
