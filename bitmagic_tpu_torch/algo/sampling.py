"""Random sub-sampling of bit-vectors (port of
``bitmagic_tpu/algo/sampling.py``).

Equivalent of `bm::random_subset<BV>::sample` (src/bmrandom.h:56): a random
subset of N set bits, drawn in rank space — N distinct ranks from numpy's
``default_rng`` (the JAX package's generator, so both pick the same bits),
resolved by one batched select.
"""

from __future__ import annotations

import numpy as np

from ..core.bitvector import BitVector


def random_subset(bv: BitVector, n: int, seed=None) -> BitVector:
    """Random n-bit subset of the set bits of bv (reference
    random_subset::sample, src/bmrandom.h:112), on bv's device."""
    rng = np.random.default_rng(seed)
    total = bv.count()
    n = int(n)
    if n <= 0 or total == 0:
        return BitVector(bv.size, device=bv.device)
    if n >= total:
        return bv.copy()
    ranks = rng.choice(total, size=n, replace=False).astype(np.int64) + 1
    pos = bv.build_rs_index().select_batch(ranks)
    return BitVector.from_indices(pos, bv.size, device=bv.device)


class RandomSubset:
    """Stateful front of random_subset, mirroring bm::random_subset<BV>
    (src/bmrandom.h:58): construct once, sample() many times."""

    def __init__(self, seed=None):
        self._rng = np.random.default_rng(seed)

    def sample(self, bv_out: BitVector, bv_in: BitVector,
               sample_count: int) -> BitVector:
        """Pick ``sample_count`` random set bits of bv_in into bv_out
        (reference sample, src/bmrandom.h:71)."""
        bv_out.swap(random_subset(bv_in, sample_count, seed=self._rng))
        return bv_out
