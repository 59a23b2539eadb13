"""Bit traversal and partitioning (port of
``bitmagic_tpu/algo/traversal.py``).

Equivalents of `src/bmalgo.h:202-394`: for_each_bit / for_each_bit_range /
visit_each_bit functor walks, and rank_range_split — splitting a
bit-vector into equal-popcount ranges for partitioned processing.
"""

from __future__ import annotations

import numpy as np

from ..core.bitvector import BitVector


def for_each_bit(bv: BitVector, fn):
    """Call fn(position) for every set bit in ascending order (reference
    for_each_bit, src/bmalgo.h:202): all positions are decoded in one pass,
    then iterated on the host."""
    for i in bv.indices():
        fn(int(i))


def for_each_bit_range(bv: BitVector, lo, hi, fn):
    """for_each_bit restricted to the closed range [lo, hi]
    (src/bmalgo.h:266)."""
    idx = bv.indices()
    for i in idx[(idx >= int(lo)) & (idx <= int(hi))]:
        fn(int(i))


def visit_each_bit(bv: BitVector, fn):
    """Callback-style visit (src/bmalgo.h:336)."""
    for_each_bit(bv, fn)


def visit_each_bit_range(bv: BitVector, lo, hi, fn):
    """Callback-style visit of [lo, hi] (src/bmalgo.h:354)."""
    for_each_bit_range(bv, lo, hi, fn)


def rank_range_split(bv: BitVector, rank_per_part: int) -> list:
    """Split [0, size) into consecutive ranges each holding
    ``rank_per_part`` set bits, the last one fewer (reference
    rank_range_split, src/bmalgo.h:394).  Returns (lo, hi) inclusive pairs
    covering all set bits: the count on K3, the boundaries by one batched
    select over the RS index."""
    rank_per_part = int(rank_per_part)
    if rank_per_part <= 0:
        raise ValueError("rank_per_part must be positive")
    total = bv.count()
    if total == 0:
        return []
    rs = bv.build_rs_index()
    n_parts = -(-total // rank_per_part)
    start_ranks = 1 + rank_per_part * np.arange(n_parts, dtype=np.int64)
    end_ranks = np.minimum(start_ranks + rank_per_part - 1, total)
    starts = rs.select_batch(start_ranks)
    ends = rs.select_batch(end_ranks)
    return [(int(s), int(e)) for s, e in zip(starts, ends)]
