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

A mesh may span processes, the counterpart of a JAX mesh over
``jax.devices()`` of every process: ``ranks`` names the process (its rank
in the default ``torch.distributed`` group) that owns each shard, and each
process holds tensors for its own shards only (``Mesh.local``, in mesh
order).  ``process_mesh`` builds one from each process's local devices.
Without ``ranks`` every shard lies in the calling process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..constants import SET_BLOCK_SIZE

BLOCK_AXIS = "blocks"


def _group_rank() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh with ranks needs an initialised "
                           "torch.distributed process group")
    return dist.get_rank()


class Mesh:
    """Ordered shard devices along one named axis; ``ranks`` (one per
    device) names the owning process of each shard when the mesh spans
    processes."""

    def __init__(self, devices, axis_name: str = BLOCK_AXIS, ranks=None):
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name
        if ranks is None:
            self.ranks = None
            self.devices = tuple(resolve_device(d) for d in devices)
            self.local = tuple(range(len(self.devices)))
            return
        self.ranks = tuple(int(r) for r in ranks)
        if len(self.ranks) != len(devices):
            raise ValueError(f"{len(self.ranks)} ranks for {len(devices)} "
                             f"devices")
        me = _group_rank()
        # another process's device is only named here, never touched
        self.devices = tuple(resolve_device(d) if r == me
                             else torch.device(d)
                             for d, r in zip(devices, self.ranks))
        self.local = tuple(j for j, r in enumerate(self.ranks) if r == me)
        if not self.local:
            raise ValueError(f"no shard of the mesh lies in process {me}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_name == other.axis_name
                and self.ranks == other.ranks)

    def __hash__(self):
        return hash((self.devices, self.axis_name, self.ranks))

    def __repr__(self):
        ranks = "" if self.ranks is None else f", ranks={list(self.ranks)}"
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_name!r}{ranks})")


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


def process_mesh(local_devices, axis_name: str = BLOCK_AXIS) -> Mesh:
    """A mesh over the shards of every process of the default
    ``torch.distributed`` group, each process contributing its
    ``local_devices`` (one shard each): rank 0's shards first, then rank
    1's, and so on.  Every process of the group must call it.  Without a
    group (or in a group of one) it is ``Mesh(local_devices)``."""
    local = [str(resolve_device(d)) for d in local_devices]
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return Mesh(local, axis_name)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    return Mesh([d for devs in every for d in devs], axis_name,
                [r for r, devs in enumerate(every) for _ in devs])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array is laid out over a mesh: split into equal parts along
    ``axis`` (one per shard, in mesh order) or, with ``axis=None``,
    replicated on every shard's device.  Only the calling process's shards
    are placed."""
    mesh: Mesh
    axis: int | None

    def place(self, x) -> list[torch.Tensor]:
        """Per-shard int32 tensors of ``x`` (a host array of uint32 or
        int32 words, or a tensor, of the whole mesh), each on its shard's
        device: the shards of this process, in mesh order."""
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x).view(np.int32)
                                 if x.dtype == np.uint32 else
                                 np.ascontiguousarray(x))
        else:
            t = x
        devices = self.mesh.devices
        if self.axis is None:
            return [t.to(devices[j]).contiguous() for j in self.mesh.local]
        n = self.mesh.size
        if t.shape[self.axis] % n:
            raise ValueError(f"axis {self.axis} of {tuple(t.shape)} does not "
                             f"split into {n} shards")
        parts = torch.chunk(t, n, dim=self.axis)
        return [parts[j].to(devices[j]).contiguous() for j in self.mesh.local]


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
