"""Debug / statistics printing and file save-load helpers.

Equivalent of `src/bmdbg.h`: print_bvector_stat (:391), print_stat per-block
dump (:414), print_svector_stat (:636), SaveBVector/LoadBVector (:197,167),
file_save_svector/file_load_svector (:1001,1035), and
compute_serialization_size (:525).  The printed text is the JAX package's,
character for character.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import constants as C


def print_bvector_stat(bv, out=None):
    out = out or sys.stdout
    st = bv.calc_stat()
    cnt = bv.count()
    print(f"size: {bv.size}  count: {cnt}", file=out)
    print(f"blocks: bit={st['bit_blocks']} full={st['full_blocks']} "
          f"zero={st['zero_blocks']} gap={st['gap_blocks']}", file=out)
    print(f"memory: {st['memory_used']} bytes "
          f"(max serialize {st['max_serialize_mem']})", file=out)


def print_stat(bv, blocks: int = 0, out=None):
    """Per-block class/count dump (reference print_stat, src/bmdbg.h:414).
    The dense rows' counts are one K3 launch on the card and one copy of
    the counts to the host."""
    out = out or sys.stdout
    bv._flush()
    from ..ops import cuda_kernels
    counts = (cuda_kernels.block_counts(bv._pool).cpu().numpy()
              if bv._pool.shape[0] else np.zeros(0, np.int64))
    slots = bv._struct.slots()
    gslots = bv._struct.gslots()
    gbc = bv._gap_bc()
    glen = (bv._gaps.gap_lens() if bv._gaps is not None
            else np.zeros(0, np.int64))
    n = len(bv._struct.nb) if blocks == 0 else min(blocks, len(bv._struct.nb))
    for k in range(n):
        nb = int(bv._struct.nb[k])
        if bv._struct.cls[k] == C.CLS_FULL:
            print(f"block {nb}: FULL", file=out)
        elif bv._struct.cls[k] == C.CLS_GAP:
            g = gslots[k]
            print(f"block {nb}: GAP bc={int(gbc[g])} len={int(glen[g])}",
                  file=out)
        else:
            print(f"block {nb}: BIT bc={int(counts[slots[k]])}", file=out)


def print_svector_stat(sv, out=None):
    """Per-plane statistics (reference print_svector_stat,
    src/bmdbg.h:636)."""
    out = out or sys.stdout
    sv._flush()
    print(f"size: {sv.size} dtype: {sv.dtype} planes: "
          f"{sum(p is not None for p in sv.planes)}/{sv.n_slices} "
          f"nullable: {sv.nullable}", file=out)
    for s, p in enumerate(sv.planes):
        if p is not None and p.any():
            print(f"  plane {s}: count={p.count()}", file=out)


def compute_serialization_size(obj, level: int = 6) -> int:
    """BLOB size without keeping it (reference compute_serialization_size,
    src/bmdbg.h:525)."""
    from ..serial.serializer import Serializer
    from ..serial.sv_serial import sparse_vector_serialize
    from ..core.bitvector import BitVector
    if isinstance(obj, BitVector):
        return len(Serializer(level).serialize(obj))
    return len(sparse_vector_serialize(obj, level))


def save_bvector(path, bv, level: int = 6):
    """SaveBVector equivalent (src/bmdbg.h:197)."""
    from ..serial.serializer import Serializer
    with open(path, "wb") as f:
        f.write(Serializer(level).serialize(bv))


def load_bvector(path, device=None):
    """LoadBVector equivalent (src/bmdbg.h:167), onto ``device``."""
    from ..serial.serializer import Deserializer
    with open(path, "rb") as f:
        return Deserializer(device=device).deserialize(f.read())


def file_save_svector(path, sv, level: int = 6):
    """file_save_svector equivalent (src/bmdbg.h:1001)."""
    from ..serial.sv_serial import sparse_vector_serialize
    with open(path, "wb") as f:
        f.write(sparse_vector_serialize(sv, level))


def file_load_svector(path, device=None):
    """file_load_svector equivalent (src/bmdbg.h:1035), onto ``device``."""
    from ..serial.sv_serial import sparse_vector_deserialize
    with open(path, "rb") as f:
        return sparse_vector_deserialize(f.read(), device=device)
