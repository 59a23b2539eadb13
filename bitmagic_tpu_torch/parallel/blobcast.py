"""Serialized-BLOB broadcast between processes (port of
``bitmagic_tpu/parallel/blobcast.py``).

The reference's serialization layer is designed for network transfer and
sharded storage (per-plane layouts in src/bmsparsevec_serial.h:69).  Here
one process serializes, every process receives the compressed bytes
through ``torch.distributed`` (when a process group is initialised) and
deserializes: compressed bytes on the wire, never dense bitmaps.  A
broadcast sends the length first, then the payload padded to it, as host
uint8 tensors (a gloo group); the gather does the same for every
process's BLOB.

In a single process (no process group, or a group of one) broadcast is the
identity, so the same code runs everywhere.  Received vectors are decoded
onto ``device`` (``config.device`` by default).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _n_processes() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _is_root(root: int) -> bool:
    return _n_processes() == 1 or dist.get_rank() == root


def broadcast_bytes(data: bytes | None, root: int = 0) -> bytes:
    """Broadcast a byte string from ``root`` to all processes.  Non-root
    callers pass None (or anything: it is ignored).  Single process:
    identity."""
    if _n_processes() == 1:
        if data is None:
            raise ValueError("root payload required in single-process mode")
        return bytes(data)
    is_root = dist.get_rank() == root
    if is_root and data is None:
        raise ValueError("the root process must pass the payload")
    n = torch.tensor([len(data) if is_root else 0], dtype=torch.int64)
    dist.broadcast(n, src=root)
    n = int(n.item())
    buf = torch.zeros(max(n, 1), dtype=torch.uint8)
    if is_root and n:
        buf[:n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    dist.broadcast(buf, src=root)
    return bytes(buf[:n].numpy().tobytes())


def broadcast_bitvector(bv=None, root: int = 0, level: int = 6,
                        device=None):
    """Serialize on the root process, broadcast the compressed BLOB, and
    deserialize on every process onto ``device``.  Returns the BitVector
    on every process."""
    from ..serial.serializer import Deserializer, Serializer
    blob = Serializer(level).serialize(bv) \
        if _is_root(root) and bv is not None else None
    return Deserializer(device).deserialize(broadcast_bytes(blob, root))


def broadcast_sparse_vector(sv=None, root: int = 0, device=None):
    """Same for succinct vectors: the per-plane BLOB layout travels as one
    compressed byte string."""
    from ..serial.sv_serial import (sparse_vector_deserialize,
                                    sparse_vector_serialize)
    blob = sparse_vector_serialize(sv) \
        if _is_root(root) and sv is not None else None
    return sparse_vector_deserialize(broadcast_bytes(blob, root), device)


def all_gather_blobs(data: bytes) -> list[bytes]:
    """Every process contributes a BLOB; all receive the full list — the
    partition-then-merge build pattern (reference bvector::merge,
    src/bm.h:1000) across processes: workers serialize their partitions,
    all gather the compressed parts, each merges locally."""
    n_proc = _n_processes()
    if n_proc == 1:
        return [bytes(data)]
    size = torch.tensor([len(data)], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(n_proc)]
    dist.all_gather(sizes, size)
    sizes = [int(s.item()) for s in sizes]
    buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
    if data:
        buf[:len(data)] = torch.frombuffer(bytearray(data),
                                           dtype=torch.uint8)
    parts = [torch.zeros_like(buf) for _ in range(n_proc)]
    dist.all_gather(parts, buf)
    return [bytes(p[:s].numpy().tobytes()) for p, s in zip(parts, sizes)]


def merge_broadcast_parts(blobs: list[bytes], device=None):
    """Deserialize + OR-merge a list of BLOB partitions into one vector on
    ``device``."""
    from ..serial.serializer import Deserializer
    d = Deserializer(device)
    out = None
    for b in blobs:
        part = d.deserialize(b)
        out = part if out is None else out.bit_or(part)
    return out
