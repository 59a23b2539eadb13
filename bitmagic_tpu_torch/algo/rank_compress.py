"""Rank-Select space compression of one bit-vector by an index bit-vector
(port of ``bitmagic_tpu/algo/rank_compress.py``).

Equivalent of `bm::rank_compressor<BV>` (src/bmalgo.h:452-647):

  * compress(src, index): bit i of src (where index[i] is set) moves to
    position rank_index(i) - 1, dropping all positions the index lacks;
  * decompress: the inverse scatter.

Both directions are one batched rank or select over the index's RS index
(built with K3's per-block counts); results lie on the operands' device.
"""

from __future__ import annotations

from ..core.bitvector import BitVector


def compress(src: BitVector, index: BitVector) -> BitVector:
    """Rank-compress src by index (reference rank_compressor::compress,
    src/bmalgo.h:471)."""
    hits = (src & index).indices()          # positions present in both
    if hits.size == 0:
        return BitVector(index.count(), device=src.device)
    ranks = index.build_rs_index().rank_batch(hits)   # 1-based in index
    return BitVector.from_indices(ranks - 1, max(int(index.count()), 1),
                                  device=src.device)


def compress_by_source(src: BitVector, index: BitVector) -> BitVector:
    """Same result, the reference's other algorithm choice
    (src/bmalgo.h:540); provided for API parity."""
    return compress(src, index)


def decompress(src: BitVector, index: BitVector) -> BitVector:
    """Inverse: bit r of src moves to select(r+1) of index (reference
    rank_compressor::decompress, src/bmalgo.h:595)."""
    ranks = src.indices() + 1
    if ranks.size == 0:
        return BitVector(index.size, device=src.device)
    pos = index.build_rs_index().select_batch(ranks)
    return BitVector.from_indices(pos[pos >= 0], index.size,
                                  device=src.device)
