"""Containers' state as plain numpy arrays, in and out.

The parts of a BitVector are those of the JAX package's ``BitVector``:
``_struct.nb``, ``_struct.cls``, ``_struct.runs``, ``_pool_host()``
(uint32 rows) and ``_gaps.ends/offs/first`` (empty arrays when the vector
has no GAP blocks).  A SparseVector's parts are its dtype, nullability,
size and the BitVector parts of each plane and of the NULL plane; an
OperandArena's are the parts of its vectors.  With them the same
containers can be fed to both packages and their states compared
directly.  This module imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .core.bitvector import BitVector
from .core.blocks import Structure
from .core.gapstore import GapStore

SV_PARTS = ("dtype", "nullable", "size", "planes", "null_plane")

PARTS = ("size", "nb", "cls", "runs", "pool_u32", "gap_ends", "gap_offs",
         "gap_first")


def bitvector_from_parts(size, nb, cls, runs, pool_u32, gap_ends, gap_offs,
                         gap_first, device=None) -> BitVector:
    """A port BitVector holding exactly the given state."""
    gaps = None
    if np.asarray(gap_first).size:
        gaps = GapStore(np.asarray(gap_ends, np.int64).copy(),
                        np.asarray(gap_offs, np.int64).copy(),
                        np.asarray(gap_first, np.uint8).copy())
    struct = Structure(np.asarray(nb, np.int64).copy(),
                       np.asarray(cls, np.uint8).copy(),
                       np.asarray(runs, np.int64).reshape(-1, 2).copy())
    pool = np.asarray(pool_u32, np.uint32).reshape(-1, C.SET_BLOCK_SIZE)
    return BitVector._from_parts(struct, pool, int(size), gaps,
                                 device=device)


def bitvector_to_parts(bv: BitVector) -> dict:
    """The state of ``bv`` as numpy arrays, keyed by ``PARTS``:
    ``bitvector_from_parts(**bitvector_to_parts(bv))`` rebuilds it."""
    bv._flush()
    g = bv._gaps
    return {
        "size": bv.size,
        "nb": bv._struct.nb.copy(),
        "cls": bv._struct.cls.copy(),
        "runs": bv._struct.runs.copy(),
        "pool_u32": bv._pool_host().copy(),
        "gap_ends": (g.ends.copy() if g is not None
                     else np.zeros(0, np.int64)),
        "gap_offs": (g.offs.copy() if g is not None
                     else np.zeros(1, np.int64)),
        "gap_first": (g.first.copy() if g is not None
                      else np.zeros(0, np.uint8)),
    }


def sparse_vector_from_parts(dtype, nullable, size, planes, null_plane,
                             device=None):
    """A port SparseVector holding exactly the given state: ``planes`` has
    one entry per slice, None or the ``bitvector_*_parts`` dict of that
    plane; ``null_plane`` likewise (None when not nullable)."""
    from .sv.sparse_vector import SparseVector
    sv = SparseVector(np.dtype(dtype), nullable=bool(nullable),
                      device=device)
    if len(planes) != sv.n_slices:
        raise ValueError(f"{len(planes)} planes for {sv.n_slices} slices")
    sv.planes = [None if p is None else bitvector_from_parts(**p,
                                                             device=device)
                 for p in planes]
    if sv.nullable:
        sv.null_plane = bitvector_from_parts(**null_plane, device=device)
    sv._size = int(size)
    return sv


def sparse_vector_to_parts(sv) -> dict:
    """The state of ``sv`` keyed by ``SV_PARTS``:
    ``sparse_vector_from_parts(**sparse_vector_to_parts(sv))`` rebuilds
    it."""
    sv._flush()
    return {
        "dtype": sv.dtype.str,
        "nullable": bool(sv.nullable),
        "size": int(sv._size),
        "planes": [None if p is None else bitvector_to_parts(p)
                   for p in sv.planes],
        "null_plane": (bitvector_to_parts(sv.null_plane) if sv.nullable
                       else None),
    }


def operand_arena_from_parts(vector_parts, device=None):
    """A port OperandArena over BitVectors rebuilt from their parts (in the
    JAX package's order), whose ``pool`` and ``slots_matrix`` are then
    those of the JAX package's arena over the same vectors."""
    from .agg.arena import OperandArena
    return OperandArena([bitvector_from_parts(**p, device=device)
                         for p in vector_parts])


def operand_arena_to_parts(arena, indices, blocklist) -> dict:
    """The combined pool (uint32 rows) and the slot matrix of ``indices``
    on ``blocklist`` of an OperandArena, as numpy arrays."""
    from .ops.blockops import to_host_words
    return {"pool_u32": to_host_words(arena.pool),
            "slots": arena.slots_matrix(list(indices),
                                        np.asarray(blocklist, np.int64))}
