"""Meshes of devices for sharded containers (port of
``bitmagic_tpu/parallel/mesh.py``).

A ``Mesh`` is an ordered list of ``torch.device``s, one per shard, plus an
axis name: the counterpart of a one-axis ``jax.sharding.Mesh``.  A sharded
container splits its rows along the block axis into one tensor per shard,
each on its shard's device; set algebra stays shard-local, reductions
bring per-shard partials to the host and combine them there in int64.

A device may repeat in a mesh (``Mesh(["cuda:0"] * 8)``): the shards are
then separate tensors on one device, which runs the shard logic where
there are fewer cards than shards.  ``make_mesh`` takes real cards only
and never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device
from ..constants import SET_BLOCK_SIZE

BLOCK_AXIS = "blocks"


class Mesh:
    """Ordered shard devices along one named axis."""

    def __init__(self, devices, axis_name: str = BLOCK_AXIS):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_name == other.axis_name)

    def __hash__(self):
        return hash((self.devices, self.axis_name))

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


def make_mesh(n_devices: int | None = None,
              axis_name: str = BLOCK_AXIS) -> Mesh:
    """A mesh over the first ``n_devices`` visible cards (all of them by
    default).  Raises when there are fewer."""
    n_visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_visible if n_devices is None else int(n_devices)
    if n < 1 or n > n_visible:
        raise RuntimeError(
            f"bitmagic_tpu_torch: make_mesh({n_devices}) needs {max(n, 1)} "
            f"card(s), {n_visible} visible; build a Mesh from an explicit "
            f"device list (e.g. Mesh(['cpu'] * 8)) to run elsewhere")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis_name)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array is laid out over a mesh: split into equal parts along
    ``axis`` (one per shard, in mesh order) or, with ``axis=None``,
    replicated on every shard's device."""
    mesh: Mesh
    axis: int | None

    def place(self, x) -> list[torch.Tensor]:
        """Per-shard int32 tensors of ``x`` (a host array of uint32 or
        int32 words, or a tensor), each on its shard's device."""
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x).view(np.int32)
                                 if x.dtype == np.uint32 else
                                 np.ascontiguousarray(x))
        else:
            t = x
        if self.axis is None:
            return [t.to(d).contiguous() for d in self.mesh.devices]
        n = self.mesh.size
        if t.shape[self.axis] % n:
            raise ValueError(f"axis {self.axis} of {tuple(t.shape)} does not "
                             f"split into {n} shards")
        return [p.to(d).contiguous()
                for p, d in zip(torch.chunk(t, n, dim=self.axis),
                                self.mesh.devices)]


def block_sharding(mesh: Mesh, axis: int = 0) -> Sharding:
    """Rows (= blocks) partitioned, words kept whole within a row; a plane
    stack ``[S, blocks, 2048]`` splits along ``axis=1``."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def pad_rows(n_rows: int, n_shards: int) -> int:
    return -(-n_rows // n_shards) * n_shards


def zero_rows(n: int, device) -> torch.Tensor:
    return torch.zeros((n, SET_BLOCK_SIZE), dtype=torch.int32, device=device)
