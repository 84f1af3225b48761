"""Multi-device distribution of the solver.

The port of `karpenter_tpu/parallel/mesh.py`. Pods interact through
shared node state, so the group scan stays sequential, but each step's
node-axis work — the part that grows with cluster size — splits across
the mesh's shards: shard s owns the contiguous node range
[s*n_max/S, (s+1)*n_max/S). The catalog and the group inputs are
replicated; the per-shard totals of each step are all-gathered between
steps (`parallel/collectives`), outside the kernel. The scan itself is
kernel M (`csrc/mesh_scan.cu`, wrapper `ops/mesh_scan`).

A `Mesh` is an ordered tuple of shard devices and one axis name
("nodes" from `make_mesh`, "batch" from `make_batch_mesh`, whose shards
each run whole requests of a batched bucket with no collective at all).
It is hashable: the solver keys its catalog caches on it.

`make_mesh(n)` lays n shards over the first n CUDA devices and raises
when fewer exist; it never builds fewer shards, or shards on the CPU.
The counterpart of the reference's host-device-count flag is
`set_virtual_devices(n, device)`: an explicit request for n shards of one
named device ("cpu" in the tests, "cuda:0" on a single card), never set
by default. A mesh built on it reports `virtual` (its shards share a
device), and `device_count()` — what `Solver.mesh()` reads, as the
reference reads `len(jax.devices())` — returns its n.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of shard devices along one named axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "nodes"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def virtual(self) -> bool:
        """True when two of its shards share a device."""
        return len(set(self.devices)) < len(self.devices)

    def describe(self) -> str:
        kinds = sorted({str(d) for d in self.devices})
        return (f"{self.size} {'virtual ' if self.virtual else ''}shards "
                f"on {', '.join(kinds)} (axis {self.axis!r})")


# the explicit virtual-shard request: (n, device) or None
_virtual: Optional[Tuple[int, torch.device]] = None


def _norm(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def set_virtual_devices(n: int, device) -> None:
    """Ask for n shards of one named device (the reference's
    --xla_force_host_platform_device_count, made explicit): "cpu" in the
    tests, "cuda:0" on a single card. Meshes made after this call lay
    their shards over these n virtual devices."""
    global _virtual
    if n < 1:
        raise ValueError(f"virtual devices: n must be >= 1, got {n}")
    _virtual = (int(n), _norm(device))


@contextlib.contextmanager
def virtual_devices(n: int, device):
    """set_virtual_devices for the duration of a block."""
    global _virtual
    prev = _virtual
    set_virtual_devices(n, device)
    try:
        yield
    finally:
        _virtual = prev


def device_count() -> int:
    """Devices a mesh can span: the virtual shards when they were asked
    for, else the CUDA devices."""
    if _virtual is not None:
        return _virtual[0]
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _devices(n: Optional[int]) -> Tuple[torch.device, ...]:
    if _virtual is not None:
        devs = (_virtual[1],) * _virtual[0]
        where = f"{_virtual[0]} virtual shards of {_virtual[1]}"
    else:
        k = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = tuple(torch.device("cuda", i) for i in range(k))
        where = f"{k} CUDA device{'s' if k != 1 else ''}"
    n = n or len(devs)
    if n < 1 or n > len(devs):
        want = f"{n} devices" if n else "devices"
        raise RuntimeError(
            f"a mesh of {n or 'all'} shards needs {want} and {where} exist;"
            f" set_virtual_devices(n, device) asks for virtual shards of "
            f"one device")
    return devs[:n]


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A "nodes" mesh over the first n devices (all of them by default)."""
    return Mesh(_devices(n_devices), "nodes")


def make_batch_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the batched dispatcher's REQUEST axis (axis name
    "batch"): a bucket of independent solves, whole requests per shard,
    no collectives. A bucket of B requests costs ceil(B / size) rows of
    kernel work per shard."""
    return Mesh(_devices(n_devices), "batch")


# sharded-solve callables, keyed on the (hashable) Mesh + n_max — the
# reference's bound-cache discipline (nothing compiles here; the bound
# keeps the cache from pinning dead meshes)
_sharded_fn_cache: dict = {}
_SHARDED_FN_CACHE_MAX = 16


def sharded_solve_fn(mesh: Mesh, n_max: int):
    """The group scan with its node axis split over `mesh`: a callable of
    the reference's `_solve_kernel` arguments (alloc, price, avail, the
    six group inputs, prior_counts [G, N], banned [G, N], conflict, zovh,
    node_type, node_cum, node_zmask, node_cmask, node_open, n_used; kw
    track_conflicts, zone_ovh) returning its nine outputs gathered on
    shard 0's device. Arguments are numpy arrays, tensors or
    ShardedTensors; they are laid out as the reference's in_shardings say
    (catalog and groups replicated, prior and banned split on axis 1 when
    they span n_max nodes, node state split on axis 0)."""
    key = (mesh, n_max)
    fn = _sharded_fn_cache.get(key)
    if fn is None:
        if len(_sharded_fn_cache) >= _SHARDED_FN_CACHE_MAX:
            _sharded_fn_cache.clear()
        from ..ops.mesh_scan import sharded_solve
        fn = _sharded_fn_cache[key] = functools.partial(sharded_solve, mesh,
                                                        n_max)
    return fn


def run_sharded_solve(mesh: Mesh, alloc, price, avail, requests, counts,
                      compat, allow_zone, allow_cap, max_per_node,
                      n_max: int, n_existing: int = 0):
    """Convenience wrapper: zero node state, one solve (the reference's
    run_sharded_solve). Returns (ntype, cum, zmask, cmask, nopen, nused,
    takes, unsched, overflow) on shard 0's device."""
    import numpy as np
    R = np.asarray(alloc).shape[1]
    Z, C = np.asarray(price).shape[1], np.asarray(price).shape[2]
    Gp = np.asarray(requests).shape[0]
    fn = sharded_solve_fn(mesh, n_max)
    return fn(alloc, price, avail, requests, counts, compat, allow_zone,
              allow_cap, max_per_node,
              np.zeros((Gp, n_max), np.int32), np.zeros((Gp, n_max), bool),
              np.zeros((Gp, 1), bool), np.zeros((1, 1, R), np.float32),
              np.zeros(n_max, np.int32), np.zeros((n_max, R), np.float32),
              np.zeros((n_max, Z), bool), np.zeros((n_max, C), bool),
              np.zeros(n_max, bool), np.asarray(n_existing, np.int32))
