"""Containers' state as plain numpy arrays, in and out.

The parts of a BitVector are those of the JAX package's ``BitVector``:
``_struct.nb``, ``_struct.cls``, ``_struct.runs``, ``_pool_host()``
(uint32 rows) and ``_gaps.ends/offs/first`` (empty arrays when the vector
has no GAP blocks).  A SparseVector's parts are its dtype, nullability,
size and the BitVector parts of each plane and of the NULL plane; an
OperandArena's are the parts of its vectors.  A StrSparseVector's are the
SparseVector parts of its octet vectors, its remap matrices and its NULL
plane; a FloatSparseVector's its sign, exponent, mantissa and NULL plane;
an RSCSparseVector's its dense payload and NULL index.  A sharded
container's are its pool or plane stack as one host array (padding rows
included), its size and its metadata, placed over a port ``Mesh``.  With
them the same
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


STR_PARTS = ("max_str_size", "nullable", "size", "octets", "remap_matrices",
             "unmap_matrices", "null_plane")
FLOAT_PARTS = ("dtype", "nullable", "size", "sign", "exponent", "mantissa",
               "null_plane")
RSC_PARTS = ("dtype", "size", "dense", "null_bv")


def str_vector_from_parts(max_str_size, nullable, size, octets,
                          remap_matrices, unmap_matrices, null_plane,
                          device=None):
    """A port StrSparseVector holding exactly the given state: ``octets``
    holds the ``sparse_vector_*_parts`` dict of each octet position's uint8
    vector, the remap matrices are uint8[max_str_size, 256] (None when not
    remapped), ``null_plane`` a ``bitvector_*_parts`` dict or None."""
    from .sv.str_vector import StrSparseVector
    ssv = StrSparseVector(int(max_str_size), nullable=bool(nullable),
                          device=device)
    ssv.octets = [sparse_vector_from_parts(**o, device=device)
                  for o in octets]
    ssv.max_str_size = len(ssv.octets)
    for name, m in (("remap_matrices", remap_matrices),
                    ("unmap_matrices", unmap_matrices)):
        setattr(ssv, name, None if m is None
                else np.asarray(m, np.uint8).copy())
    if ssv.nullable:
        ssv.null_plane = bitvector_from_parts(**null_plane, device=device)
    ssv._size = int(size)
    return ssv


def str_vector_to_parts(ssv) -> dict:
    """The state of a StrSparseVector keyed by ``STR_PARTS``."""
    return {
        "max_str_size": int(ssv.max_str_size),
        "nullable": bool(ssv.nullable),
        "size": int(ssv._size),
        "octets": [sparse_vector_to_parts(o) for o in ssv.octets],
        "remap_matrices": (None if ssv.remap_matrices is None
                           else ssv.remap_matrices.copy()),
        "unmap_matrices": (None if ssv.unmap_matrices is None
                           else ssv.unmap_matrices.copy()),
        "null_plane": (bitvector_to_parts(ssv.null_plane) if ssv.nullable
                       else None),
    }


def float_vector_from_parts(dtype, nullable, size, sign, exponent, mantissa,
                            null_plane, device=None):
    """A port FloatSparseVector holding exactly the given state: ``sign``
    and ``null_plane`` are ``bitvector_*_parts`` dicts (the latter None
    when not nullable), ``exponent`` and ``mantissa`` are
    ``sparse_vector_*_parts`` dicts."""
    from .sv.float_vector import FloatSparseVector
    fv = FloatSparseVector(np.dtype(dtype), nullable=bool(nullable),
                           device=device)
    fv.sign = bitvector_from_parts(**sign, device=device)
    fv.exponent = sparse_vector_from_parts(**exponent, device=device)
    fv.mantissa = sparse_vector_from_parts(**mantissa, device=device)
    if fv.nullable:
        fv.null_plane = bitvector_from_parts(**null_plane, device=device)
    fv._size = int(size)
    return fv


def float_vector_to_parts(fv) -> dict:
    """The state of a FloatSparseVector keyed by ``FLOAT_PARTS``."""
    return {
        "dtype": fv.dtype.str,
        "nullable": bool(fv.nullable),
        "size": int(fv._size),
        "sign": bitvector_to_parts(fv.sign),
        "exponent": sparse_vector_to_parts(fv.exponent),
        "mantissa": sparse_vector_to_parts(fv.mantissa),
        "null_plane": (bitvector_to_parts(fv.null_plane) if fv.nullable
                       else None),
    }


def rsc_vector_from_parts(dtype, size, dense, null_bv, device=None):
    """A port RSCSparseVector holding exactly the given state: ``dense`` is
    the ``sparse_vector_*_parts`` dict of the compressed payload,
    ``null_bv`` the ``bitvector_*_parts`` dict of the NULL index."""
    from .sv.rsc_vector import RSCSparseVector
    rsc = RSCSparseVector(np.dtype(dtype), device=device)
    rsc.dense = sparse_vector_from_parts(**dense, device=device)
    rsc.null_bv = bitvector_from_parts(**null_bv, device=device)
    rsc._size = int(size)
    return rsc.sync()


def rsc_vector_to_parts(rsc) -> dict:
    """The state of an RSCSparseVector keyed by ``RSC_PARTS``."""
    rsc._flush()
    return {
        "dtype": rsc.dtype.str,
        "size": int(rsc._size),
        "dense": sparse_vector_to_parts(rsc.dense),
        "null_bv": bitvector_to_parts(rsc.null_bv),
    }


# ---------------------------------------------------------------------------
# sharded containers: the JAX package's pool or stack as one host array,
# its size and metadata, placed over a port Mesh
# ---------------------------------------------------------------------------
def sharded_bitvector_from_parts(pool_u32, size, mesh):
    """A port ShardedBitVector holding the rows ``pool_u32`` uint32[n,
    2048] (n divisible by the mesh size) over ``mesh``."""
    from .parallel.mesh import block_sharding
    from .parallel.sharded import ShardedBitVector
    pool = np.asarray(pool_u32, np.uint32).reshape(-1, C.SET_BLOCK_SIZE)
    return ShardedBitVector(block_sharding(mesh).place(pool), size, mesh)


def sharded_bitvector_to_parts(sbv) -> dict:
    """``pool_u32`` (every row, padding included) and ``size``."""
    return {"pool_u32": sbv.to_words(), "size": sbv.size}


def _stack_shards(stack_u32, mesh):
    from .parallel.mesh import block_sharding
    stack = np.asarray(stack_u32, np.uint32)
    return block_sharding(mesh, 1).place(stack)


SHARDED_SV_PARTS = ("stack_u32", "size", "dtype", "signed", "n_slices",
                    "n_eff", "nullable")
SHARDED_STR_PARTS = ("stack_u32", "size", "max_str_size", "nullable",
                     "slots", "remap_matrices", "unmap_matrices")
SHARDED_FLOAT_PARTS = ("stack_u32", "size", "dtype", "rows", "sign_row",
                       "nullable")


def sharded_sparse_vector_from_parts(stack_u32, size, dtype, signed,
                                     n_slices, n_eff, nullable, mesh):
    """A port ShardedSparseVector over ``mesh`` holding the plane stack
    uint32[K, n, 2048] and metadata keyed by ``SHARDED_SV_PARTS``."""
    from .parallel.sharded_sv import ShardedSparseVector
    return ShardedSparseVector(_stack_shards(stack_u32, mesh), size, mesh,
                               dtype, signed, n_slices, n_eff, nullable)


def sharded_sparse_vector_to_parts(ssv) -> dict:
    return {"stack_u32": ssv.to_words(), "size": ssv.size,
            "dtype": ssv.dtype.str, "signed": ssv.signed,
            "n_slices": ssv.n_slices, "n_eff": ssv.n_eff,
            "nullable": ssv.nullable}


def sharded_str_vector_from_parts(stack_u32, size, max_str_size, nullable,
                                  slots, remap_matrices, unmap_matrices,
                                  mesh):
    """A port ShardedStrSparseVector over ``mesh`` (parts keyed by
    ``SHARDED_STR_PARTS``)."""
    from .parallel.sharded_sv import ShardedStrSparseVector
    return ShardedStrSparseVector(
        _stack_shards(stack_u32, mesh), size, mesh, max_str_size, nullable,
        [tuple(s) for s in slots],
        None if remap_matrices is None else np.asarray(remap_matrices,
                                                       np.uint8).copy(),
        None if unmap_matrices is None else np.asarray(unmap_matrices,
                                                       np.uint8).copy())


def sharded_str_vector_to_parts(ssv) -> dict:
    return {"stack_u32": ssv.to_words(),
            "size": ssv.size, "max_str_size": ssv.max_str_size,
            "nullable": ssv.nullable, "slots": list(ssv.slots),
            "remap_matrices": ssv.remap_matrices,
            "unmap_matrices": ssv.unmap_matrices}


def sharded_float_vector_from_parts(stack_u32, size, dtype, rows, sign_row,
                                    nullable, mesh):
    """A port ShardedFloatVector over ``mesh`` (parts keyed by
    ``SHARDED_FLOAT_PARTS``)."""
    from .parallel.sharded_sv import ShardedFloatVector
    return ShardedFloatVector(_stack_shards(stack_u32, mesh), size, mesh,
                              dtype, rows, sign_row, nullable)


def sharded_float_vector_to_parts(fv) -> dict:
    return {"stack_u32": fv.to_words(),
            "size": fv.size, "dtype": fv.dtype.str, "rows": fv.rows,
            "sign_row": fv.SIGN, "nullable": fv.nullable}


def sharded_rsc_vector_from_parts(dense, null_pool_u32, size, mesh):
    """A port ShardedRSCVector over ``mesh``: ``dense`` keyed by
    ``SHARDED_SV_PARTS`` (without the mesh), the NULL index as its rows
    ``null_pool_u32`` over ``max(size, 1)`` bits; its rank/select index is
    built here."""
    from .parallel.sharded_sv import ShardedRSCVector
    d = sharded_sparse_vector_from_parts(**dense, mesh=mesh)
    null_sbv = sharded_bitvector_from_parts(null_pool_u32, max(size, 1),
                                            mesh)
    return ShardedRSCVector(d, null_sbv, null_sbv.build_rs_index(), size,
                            mesh)


def sharded_rsc_vector_to_parts(rsc) -> dict:
    return {"dense": sharded_sparse_vector_to_parts(rsc.dense),
            "null_pool_u32": rsc.null_sbv.to_words(), "size": rsc.size}
