"""Bit-matrix: an array of BitVector planes ("rows"/"slices") (port of
``bitmagic_tpu/sv/bmatrix.py``).

Equivalent of `bm::basic_bmatrix<BV>` (src/bmbmatrix.h:54): the storage base
of every succinct vector: value bit-planes are rows; octet views
(`get_octet`) give byte-wise access used by string vectors and sorted search.

Each row is an independent BitVector (its own block pool) on the matrix's
device; fused multi-plane work (scanner, transpose) goes through the
aggregator and the kernels that gather across the row pools.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..core.bitvector import BitVector


class BitMatrix:
    def __init__(self, n_rows: int = 0, size: int = 0, device=None):
        self._device = resolve_device(device)
        self._size = int(size)
        self.rows: list[BitVector | None] = [None] * int(n_rows)

    @property
    def device(self) -> torch.device:
        return self._device

    # -- row management (reference construct_row / destruct_row) ----------
    @property
    def n_rows(self) -> int:
        return len(self.rows)

    def allocate_rows(self, n: int):
        if n > len(self.rows):
            self.rows.extend([None] * (n - len(self.rows)))
        return self

    def row(self, i: int, construct: bool = False) -> BitVector | None:
        if construct and self.rows[i] is None:
            self.rows[i] = BitVector(self._size or 2**32,
                                     device=self._device)
        return self.rows[i]

    def set_row(self, i: int, bv: BitVector | None):
        if bv is not None and bv.device != self._device:
            raise ValueError(f"row on {bv.device}, matrix on {self._device}")
        if i >= len(self.rows):
            self.allocate_rows(i + 1)
        self.rows[i] = bv

    def swap_rows(self, i: int, j: int):
        self.rows[i], self.rows[j] = self.rows[j], self.rows[i]

    def clear_row(self, i: int):
        self.rows[i] = None

    # -- element views ------------------------------------------------------
    def get_column(self, idx: int) -> int:
        """Bits of column idx across rows, packed LSB-first into an int."""
        v = 0
        for j, r in enumerate(self.rows):
            if r is not None and r.test(idx):
                v |= 1 << j
        return v

    def get_octet(self, idx: int, octet: int) -> int:
        """Byte `octet` of column idx (reference get_octet,
        src/bmbmatrix.h:1013)."""
        v = 0
        for k in range(8):
            j = octet * 8 + k
            if j < len(self.rows):
                r = self.rows[j]
                if r is not None and r.test(idx):
                    v |= 1 << k
        return v

    def octets(self, ids, octet: int) -> np.ndarray:
        """Batched get_octet over many columns -> uint8[n]."""
        ids = np.asarray(ids, np.int64)
        out = np.zeros(ids.shape, np.uint8)
        for k in range(8):
            j = octet * 8 + k
            if j < len(self.rows) and self.rows[j] is not None:
                out |= self.rows[j].get_bits(ids).astype(np.uint8) << k
        return out

    def optimize(self):
        for r in self.rows:
            if r is not None:
                r.optimize()
        return self

    def calc_stat(self) -> dict:
        st = {"bit_blocks": 0, "full_blocks": 0, "memory_used": 0}
        for r in self.rows:
            if r is not None:
                s = r.calc_stat()
                for k in st:
                    st[k] += s[k]
        return st

    def freeze(self):
        for r in self.rows:
            if r is not None:
                r.freeze()
        return self

    def equal(self, other: "BitMatrix") -> bool:
        n = max(len(self.rows), len(other.rows))
        for j in range(n):
            a = self.rows[j] if j < len(self.rows) else None
            b = other.rows[j] if j < len(other.rows) else None
            a_empty = a is None or a.none()
            b_empty = b is None or b.none()
            if a_empty and b_empty:
                continue
            if a_empty != b_empty:
                return False
            if not a.equal(b):
                return False
        return True

    def set_octet(self, idx: int, octet: int, value: int):
        """Write byte ``octet`` of column idx across the 8 planes
        (reference set_octet, src/bmbmatrix.h:990).  Planes are grown on
        demand, like insert_column."""
        for k in range(8):
            j = octet * 8 + k
            if (value >> k) & 1:
                if j >= len(self.rows):
                    self.allocate_rows(j + 1)
                r = self.row(j, construct=True)
                r.set(idx)
            elif j < len(self.rows) and self.rows[j] is not None:
                self.rows[j].set(idx, False)
        return self

    def clear_column(self, idx: int):
        """Clear column idx in every row (reference clear_column,
        src/bmbmatrix.h:232)."""
        for r in self.rows:
            if r is not None:
                r.set(int(idx), False)
        return self

    def insert_column(self, idx: int, value: int = 0):
        """Insert column ``value`` at idx, shifting higher columns up
        (reference insert_column / insert_octet shape).  Rows needed by
        set bits of ``value`` are constructed on demand."""
        for j in range(int(value).bit_length()):
            if (value >> j) & 1:
                if j >= len(self.rows):
                    self.allocate_rows(j + 1)
                self.row(j, construct=True)
        for j, r in enumerate(self.rows):
            if r is not None:
                r.insert(int(idx), bool((value >> j) & 1))
        return self

    def erase_column(self, idx: int):
        """Erase column idx, shifting higher columns down (reference
        erase_column, src/bmbmatrix.h:239)."""
        for r in self.rows:
            if r is not None:
                r.erase(int(idx))
        return self

    def copy_from(self, other: "BitMatrix"):
        """Deep copy (reference copy_from, src/bmbmatrix.h:207): the rows
        stay on ``other``'s device, and so does the matrix."""
        self._device = other._device
        self._size = other._size
        self.rows = [None if r is None else r.copy() for r in other.rows]
        return self

    def is_same_structure(self, other: "BitMatrix") -> bool:
        """Same row allocation pattern (reference is_same_structure)."""
        return (len(self.rows) == len(other.rows)
                and all((a is None) == (b is None)
                        for a, b in zip(self.rows, other.rows)))

    def clear(self):
        """Drop all rows (reference clear/clear_all)."""
        self.rows = [None] * len(self.rows)
        return self

    clear_all = clear
