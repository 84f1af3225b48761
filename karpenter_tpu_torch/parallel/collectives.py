"""The mesh's data movement, written out: placement, all-gather, psum and
the gather of replicated outputs.

The reference lets GSPMD insert its collectives (an all-gather of the
scan's per-shard totals at every group step, a psum of the screen's [G]
totals, the gather of replicated outputs). Here each is a plain tensor
operation over the shards' parts: `.to(device)` copies, a sum, a cat.
Where every shard sits on one device (a virtual mesh) they are on-device
operations, and one result serves every shard; across distinct cards the
copies are peer copies, which PyTorch orders against both devices'
current streams. The distinct-card code runs only where more than one
card exists.

A `Sharding` says how one logical tensor lies over a mesh: replicated
(axis None) or split into equal contiguous blocks along one axis, shard s
owning block s. A `ShardedTensor` holds the parts, one per shard, each on
its shard's device. Replicated parts on one device are the same tensor:
a virtual mesh holds one copy of replicated bytes, and its meters count
the logical array once per upload, as a jax.Array's `nbytes` does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh


@dataclass(frozen=True)
class Sharding:
    """The layout of one tensor over `mesh`: replicated (axis None) or
    split along `axis` into mesh.size equal blocks."""

    mesh: Mesh
    axis: Optional[int] = None


class ShardedTensor:
    """One logical tensor over a mesh: `parts[s]` lives on
    `sharding.mesh.devices[s]`. `shape`, `dtype` and `nbytes` describe the
    logical tensor (nbytes counts it once, replicated or split)."""

    def __init__(self, parts: Sequence[torch.Tensor], sharding: Sharding,
                 shape: Tuple[int, ...]):
        self.parts = tuple(parts)
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.dtype = self.parts[0].dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * \
            torch.empty((), dtype=self.dtype).element_size()

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"axis={self.sharding.axis}, shards={len(self.parts)})")


def on_shard(dev: torch.device):
    """Make a shard's device the current one for a block of its work: a
    kernel launched through ctypes runs on the current device, so on a
    mesh of distinct cards each shard's staging and launches go inside
    this (a no-op for CPU shards)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def block(n: int, size: int) -> int:
    """Rows of one shard's block when n rows split over `size` shards."""
    if n % size:
        raise ValueError(f"an axis of {n} does not split over {size} shards")
    return n // size


def place(x: torch.Tensor, sharding: Sharding) -> ShardedTensor:
    """Lay a tensor over the mesh (no metering: the solver's
    `_put_sharded` meters uploads). Replicated: one copy per distinct
    device, shared by that device's shards. Split: shard s gets block s,
    a view where it already sits on the shard's device (contiguous for
    axis 0; other axes are copied contiguous)."""
    mesh = sharding.mesh
    copies = {}

    def on(dev):
        t = copies.get(dev)
        if t is None:
            t = copies[dev] = x if x.device == dev else x.to(dev)
        return t
    if sharding.axis is None:
        return ShardedTensor([on(d) for d in mesh.devices], sharding,
                             x.shape)
    ax = sharding.axis
    q = block(x.shape[ax], mesh.size)
    parts = []
    for s, d in enumerate(mesh.devices):
        blk = x.narrow(ax, s * q, q)
        if blk.device != d:
            blk = blk.to(d)
        parts.append(blk if blk.is_contiguous() else blk.contiguous())
    return ShardedTensor(parts, sharding, x.shape)


def parts_of(x, mesh: Mesh, axis: Optional[int] = None) -> List[torch.Tensor]:
    """Per-shard parts of `x`: its own parts when it is a ShardedTensor
    over `mesh`, else `x` placed with `Sharding(mesh, axis)`."""
    if isinstance(x, ShardedTensor):
        if x.mesh != mesh:
            raise ValueError("a ShardedTensor over another mesh")
        return list(x.parts)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x))
    return list(place(x, Sharding(mesh, axis)).parts)


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh
               ) -> List[torch.Tensor]:
    """Every shard gets cat(parts) on its device. Parts on one device
    yield one cat that all of that device's shards read."""
    out, done = [], {}
    for d in mesh.devices:
        t = done.get(d)
        if t is None:
            t = done[d] = torch.cat([p if p.device == d else p.to(d)
                                     for p in parts])
        out.append(t)
    return out


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Every shard gets the elementwise sum of parts, added in shard
    order on its device (exact for integer parts)."""
    out, done = [], {}
    for d in mesh.devices:
        t = done.get(d)
        if t is None:
            acc = None
            for p in parts:
                p = p if p.device == d else p.to(d)
                acc = p.clone() if acc is None else acc + p
            t = done[d] = acc
        out.append(t)
    return out


def broadcast(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """`x` (on one shard's device) on every shard's device."""
    return parts_of(x, mesh, None)


def gather(parts: Sequence[torch.Tensor], dim: int = 0,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """The logical tensor of split parts, on one device (shard 0's by
    default): the gather of a replicated output, read once by the host."""
    dev = device if device is not None else parts[0].device
    return torch.cat([p if p.device == dev else p.to(dev) for p in parts],
                     dim=dim)


def to_tensor(x: ShardedTensor, device: Optional[torch.device] = None
              ) -> torch.Tensor:
    """A ShardedTensor as one tensor on one device: a replicated one's
    first part, a split one's blocks concatenated."""
    if x.sharding.axis is None:
        t = x.parts[0]
        return t if device is None or t.device == device else t.to(device)
    return gather(x.parts, x.sharding.axis, device)
