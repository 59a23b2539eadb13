"""Succinct-vector algorithms: first-mismatch and set-to-set transform
(port of ``bitmagic_tpu/sv/algo.py``).

Equivalents of `src/bmsparsevec_algo.h:172` (sparse_vector_find_first_mismatch,
the XOR-slice comparison) and `:1595` (set2set_11_transform, the image of a
set through an SV-encoded function).
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..agg.aggregator import Aggregator
from ..core.bitvector import BitVector
from .sparse_vector import SparseVector

_agg = Aggregator()


def find_first_mismatch(a: SparseVector, b: SparseVector) -> int:
    """First index where a and b hold different values (NULL-ness counts as
    a difference), or -1 (reference sparse_vector_find_first_mismatch,
    src/bmsparsevec_algo.h:172): XOR every slice pair (K1 each), OR the
    differences (B4 in OR mode), find the first bit."""
    a._flush()
    b._flush()
    diffs = []
    for s in range(max(a.n_slices, b.n_slices)):
        pa = a.planes[s] if s < a.n_slices else None
        pb = b.planes[s] if s < b.n_slices else None
        if pa is None and pb is None:
            continue
        if pa is None:
            diffs.append(pb)
        elif pb is None:
            diffs.append(pa)
        else:
            diffs.append(pa ^ pb)
    if a.nullable and b.nullable:
        diffs.append(a.null_plane ^ b.null_plane)
    elif a.nullable or b.nullable:
        nul = a if a.nullable else b
        other_size = b._size if a.nullable else a._size
        uni = BitVector(C.ID_MAX48, device=nul.device)
        if other_size:
            uni.set_range(0, other_size - 1)
        diffs.append(nul.null_plane ^ uni)
    m = _agg.combine_or(diffs).find() if diffs else -1
    size = max(a._size, b._size)
    if m >= size or m < 0:
        if a._size != b._size:
            return min(a._size, b._size)
        return -1
    return m


def set2set_transform(sv: SparseVector, bv_in: BitVector) -> BitVector:
    """Image of the set bv_in through the function encoded by sv:
    out = { sv[i] : i in bv_in, i assigned } (reference set2set_11_transform,
    src/bmsparsevec_algo.h:1595), on sv's device.  One batched gather."""
    sv._flush()
    ids = bv_in.indices()
    ids = ids[ids < sv._size]
    if sv.nullable:
        ids = ids[sv.null_plane.get_bits(ids)]
    if ids.size == 0:
        return BitVector(C.ID_MAX48, device=sv.device)
    vals = np.asarray(sv.gather(ids), np.int64)
    return BitVector.from_indices(np.unique(vals), C.ID_MAX48,
                                  device=sv.device)


class Set2SetTransform:
    """Stateful front of set2set_transform, mirroring the reference
    set2set_11_transform class (src/bmsparsevec_algo.h:1609): attach the
    translation sparse-vector once, run many remaps against it."""

    def __init__(self):
        self._sv = None

    def attach_sv(self, sv, compute_stats: bool = False):
        """Attach (or detach with None) the translation function
        (reference attach_sv, src/bmsparsevec_algo.h:1670)."""
        self._sv = sv
        return self

    def attached(self):
        return self._sv

    def run(self, bv_in: BitVector) -> BitVector:
        """one_pass_run / run (reference :1799)."""
        if self._sv is None:
            raise ValueError("attach_sv() first")
        return set2set_transform(self._sv, bv_in)

    one_pass_run = run
    remap = run
