"""Naive numpy golden model used by the property/fuzz test harness.

Equivalent in role to the reference's mini bit-vectors (`src/bmvmin.h:52-271`,
`tests/stress/rlebtv.h`): a deliberately simple, obviously-correct bitset that
every randomized test mirrors its operations into, then compares exhaustively
against the containers.

The model stores bits as a ``numpy`` bool array.  Word/bit order helpers follow
the framework convention (same as the reference): bit *n* lives in 32-bit word
``n >> 5`` at in-word position ``n & 31`` (LSB-first).
"""

from __future__ import annotations

import numpy as np

from ..constants import BITS_PER_BLOCK


class GoldenBitSet:
    """Obviously-correct dense bitset over numpy bool arrays."""

    def __init__(self, size: int = 0):
        self.bits = np.zeros(int(size), dtype=bool)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_indices(cls, indices, size=None):
        indices = np.asarray(indices, dtype=np.int64)
        if size is None:
            size = (int(indices.max()) + 1) if indices.size else 0
        g = cls(size)
        if indices.size:
            g.bits[indices] = True
        return g

    def copy(self):
        g = GoldenBitSet(0)
        g.bits = self.bits.copy()
        return g

    # -- size management ----------------------------------------------------
    @property
    def size(self):
        return self.bits.size

    def resize(self, new_size: int):
        n = int(new_size)
        if n < self.bits.size:
            self.bits = self.bits[:n].copy()
        elif n > self.bits.size:
            self.bits = np.concatenate([self.bits, np.zeros(n - self.bits.size, bool)])

    def _ensure(self, n: int):
        if n >= self.bits.size:
            self.resize(n + 1)

    # -- single-bit / range mutation ----------------------------------------
    def set(self, i, val=True):
        self._ensure(int(i))
        self.bits[int(i)] = bool(val)

    def flip(self, i):
        self._ensure(int(i))
        self.bits[int(i)] ^= True

    def set_range(self, lo, hi, val=True):
        self._ensure(int(hi))
        self.bits[int(lo):int(hi) + 1] = bool(val)

    def clear(self):
        self.bits[:] = False

    def invert(self):
        self.bits = ~self.bits

    def test(self, i):
        i = int(i)
        return bool(self.bits[i]) if i < self.bits.size else False

    # -- queries -------------------------------------------------------------
    def count(self):
        return int(self.bits.sum())

    def count_range(self, lo, hi):
        hi = min(int(hi), self.bits.size - 1)
        if hi < int(lo):
            return 0
        return int(self.bits[int(lo):hi + 1].sum())

    def count_to(self, i):
        """rank(i): number of set bits in [0, i] inclusive."""
        return self.count_range(0, i)

    def any(self):
        return bool(self.bits.any())

    def indices(self):
        return np.flatnonzero(self.bits).astype(np.int64)

    def find(self, frm=0):
        idx = np.flatnonzero(self.bits[int(frm):])
        return (int(idx[0]) + int(frm)) if idx.size else -1

    def find_reverse(self):
        idx = np.flatnonzero(self.bits)
        return int(idx[-1]) if idx.size else -1

    def select(self, rank):
        """Position of the rank-th set bit (rank is 1-based, like reference)."""
        idx = np.flatnonzero(self.bits)
        r = int(rank)
        if r < 1 or r > idx.size:
            return -1
        return int(idx[r - 1])

    # -- logical ops (sizes may differ; shorter operand is zero-extended) ----
    def _aligned(self, other: "GoldenBitSet"):
        n = max(self.bits.size, other.bits.size)
        a = np.zeros(n, bool); a[: self.bits.size] = self.bits
        b = np.zeros(n, bool); b[: other.bits.size] = other.bits
        return a, b

    def and_(self, other):
        a, b = self._aligned(other)
        self.bits = a & b

    def or_(self, other):
        a, b = self._aligned(other)
        self.bits = a | b

    def xor_(self, other):
        a, b = self._aligned(other)
        self.bits = a ^ b

    def sub_(self, other):
        a, b = self._aligned(other)
        self.bits = a & ~b

    def equal(self, other):
        a, b = self._aligned(other)
        return bool((a == b).all())

    # -- word-form conversion -------------------------------------------------
    def to_words(self, n_blocks=None):
        """Dense uint32 word image, LSB-first bit order, padded to blocks:
        bit n in word n >> 5 at position n & 31, the containers' layout
        (the JAX package's copy reverses the bytes of each word)."""
        nbits = self.bits.size
        if n_blocks is None:
            n_blocks = max(1, -(-nbits // BITS_PER_BLOCK))
        total = n_blocks * BITS_PER_BLOCK
        padded = np.zeros(total, dtype=np.uint8)
        padded[:nbits] = self.bits.astype(np.uint8)
        words = np.packbits(padded.reshape(-1, 8)[:, ::-1], axis=1)
        return words.reshape(-1).view(np.uint32).reshape(n_blocks, -1)

    @classmethod
    def from_words(cls, words, size=None):
        """Inverse of :meth:`to_words` (words: uint32 array, any shape)."""
        w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32).reshape(-1))
        by = w.view(np.uint8).reshape(-1, 4)[:, ::-1]
        bits = np.unpackbits(by, axis=1)[:, ::-1].reshape(-1).astype(bool)
        g = cls(0)
        g.bits = bits if size is None else bits[: int(size)].copy()
        return g


def random_indices(rng, size, density=0.01, style="uniform"):
    """Test-data generator in the spirit of the reference stress generators
    (`tests/stress/t.cpp:606-987` FillSets* / `tests/stress64/gena.h`):
    uniform scatter, dense intervals, and block-border values."""
    size = int(size)
    n = max(1, int(size * density))
    if style == "uniform":
        idx = rng.integers(0, size, n)
    elif style == "intervals":
        starts = rng.integers(0, size, max(1, n // 64))
        lens = rng.integers(1, 256, starts.size)
        idx = np.concatenate([np.arange(s, min(s + l, size)) for s, l in zip(starts, lens)])
    elif style == "borders":
        borders = np.arange(0, size, BITS_PER_BLOCK)
        cand = np.concatenate([borders, borders - 1, borders + 1, [0, size - 1]])
        cand = cand[(cand >= 0) & (cand < size)]
        idx = rng.choice(cand, min(n, cand.size), replace=False)
    else:
        raise ValueError(style)
    return np.unique(idx.astype(np.int64))
