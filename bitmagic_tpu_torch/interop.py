"""A BitVector's state as plain numpy arrays, in and out.

The parts are those of the JAX package's ``BitVector``: ``_struct.nb``,
``_struct.cls``, ``_struct.runs``, ``_pool_host()`` (uint32 rows) and
``_gaps.ends/offs/first`` (empty arrays when the vector has no GAP
blocks).  With them the same vector can be fed to both packages and their
states compared directly.  This module imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .core.bitvector import BitVector
from .core.blocks import Structure
from .core.gapstore import GapStore

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
