"""Succinct float vector (port of ``bitmagic_tpu/sv/float_vector.py``).

Equivalent of `bm::sparse_vector_float` (src/bmsparsevec_float.h:59): floats
stored decomposed for bit-slice compressibility.  The reference splits
sign (bit-vector) / exponent / mantissa (two sparse vectors,
src/bmsparsevec_float.h:44-50); this does the same split on the IEEE-754
image, so common-exponent data compresses in the exponent planes exactly
like the reference.  Every part lives on the vector's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..config import resolve_device
from ..core.bitvector import BitVector, check_writable
from .sparse_vector import SparseVector

_I64 = np.int64

_SPEC = {
    np.dtype(np.float32): dict(uint=np.uint32, exp_bits=8, man_bits=23),
    np.dtype(np.float64): dict(uint=np.uint64, exp_bits=11, man_bits=52),
}


class FloatSparseVector:
    """bm::sparse_vector_float equivalent (sign/exponent/mantissa split)."""

    def __init__(self, dtype=np.float32, nullable: bool = False,
                 device=None):
        self.dtype = np.dtype(dtype)
        if self.dtype not in _SPEC:
            raise ValueError("dtype must be float32 or float64")
        self._device = resolve_device(device)
        spec = _SPEC[self.dtype]
        self._uint = spec["uint"]
        self._eb, self._mb = spec["exp_bits"], spec["man_bits"]
        self.sign = self._new_bv()
        self.exponent = SparseVector(
            np.uint16 if self._eb <= 16 else np.uint32, device=self._device)
        self.mantissa = SparseVector(
            np.uint32 if self._mb <= 32 else np.uint64, device=self._device)
        self.nullable = nullable
        self.null_plane = self._new_bv() if nullable else None
        self._size = 0
        self._ro = False

    @property
    def device(self) -> torch.device:
        return self._device

    def _new_bv(self) -> BitVector:
        return BitVector(C.ID_MAX48, device=self._device)

    # ------------------------------------------------------------------
    @classmethod
    def from_array(cls, values, dtype=None, nullable=False, device=None):
        values = np.asarray(values)
        dtype = values.dtype if dtype is None else np.dtype(dtype)
        fv = cls(dtype, nullable=nullable, device=device)
        fv.import_values(values, 0)
        return fv

    def import_values(self, values, offset: int = 0):
        self._check_writable()
        values = np.asarray(values, self.dtype)
        n = values.size
        if n == 0:
            return self
        u = values.view(self._uint)
        sign_ids = np.flatnonzero(u >> (self._eb + self._mb)) + offset
        exp = ((u >> self._mb) & ((1 << self._eb) - 1)).astype(
            self.exponent.dtype)
        man = (u & ((1 << self._mb) - 1)).astype(self.mantissa.dtype)
        if sign_ids.size:
            self.sign.set_many(sign_ids)
        self.exponent.import_values(exp, offset)
        self.mantissa.import_values(man, offset)
        self._size = max(self._size, offset + n)
        if self.nullable:
            self.null_plane.set_range(offset, offset + n - 1, True)
        return self

    import_ = import_values      # reference name is `import` (a keyword)

    def push_back(self, v):
        return self.import_values(np.asarray([v], self.dtype), self._size)

    def push_back_null(self, count: int = 1):
        """Append ``count`` NULL elements (reference push_back_null,
        src/bmsparsevec.h:498 via the float container)."""
        if not self.is_nullable():
            raise ValueError("push_back_null requires a nullable vector")
        return self.resize(self._size + int(count))

    def end(self):
        """Invalid const_iterator sentinel (reference end())."""
        it = self.get_const_iterator(0)
        it.invalidate()
        return it

    def find_rank(self, rank: int) -> int:
        """Dense address space: the rank-th element is position rank-1
        (reference base find_rank)."""
        rank = int(rank)
        if rank < 1:
            raise ValueError("rank is 1-based")
        return rank - 1

    def sync_size(self):
        return self

    def is_remap(self) -> bool:
        return False

    def effective_slices(self) -> int:
        """Used bit planes across the sign/exponent/mantissa split
        (reference base effective_slices over the IEEE slice matrix)."""
        n = 1 if self.sign.any() else 0
        n += self.exponent.effective_slices()
        n += self.mantissa.effective_slices()
        return n

    def set(self, i, v):
        self._check_writable()
        i = int(i)
        u = np.asarray([v], self.dtype).view(self._uint)[0]
        self.sign.set(i, bool(u >> (self._eb + self._mb)))
        self.exponent.set(i, (int(u) >> self._mb) & ((1 << self._eb) - 1))
        self.mantissa.set(i, int(u) & ((1 << self._mb) - 1))
        if self.nullable:
            self.null_plane.set(i, True)
        if i >= self._size:
            self._size = i + 1
        return self

    __setitem__ = set

    # ------------------------------------------------------------------
    @property
    def size(self):
        return self._size

    def __len__(self):
        return self._size

    def gather(self, ids) -> np.ndarray:
        ids = np.asarray(ids, _I64)
        e = self.exponent.gather(ids).astype(self._uint)
        m = self.mantissa.gather(ids).astype(self._uint)
        s = self.sign.get_bits(ids).astype(self._uint)
        u = ((s << self._uint(self._eb + self._mb))
             | (e << self._uint(self._mb)) | m)
        vals = u.view(self.dtype)
        if self.nullable:
            vals = np.where(self.null_plane.get_bits(ids), vals,
                            self.dtype.type(0))
        return vals

    def get(self, i):
        return self.gather([i])[0]

    __getitem__ = get

    def decode(self, lo, n):
        return self.gather(np.arange(lo, lo + n, dtype=_I64))

    def to_numpy(self):
        return self.decode(0, self._size)

    def is_null(self, i):
        return self.nullable and not self.null_plane.test(i)

    def set_null(self, i):
        self._check_writable()
        if not self.nullable:
            raise ValueError("not nullable")
        self.null_plane.set(int(i), False)
        return self

    def at(self, i):
        if not (0 <= int(i) < self._size):
            raise IndexError(i)
        return self.get(i)

    def try_get(self, i):
        """(found, value); found is False at NULL positions."""
        if self.nullable and not self.null_plane.test(i):
            return False, self.dtype.type(0)
        return True, self.get(i)

    def empty(self) -> bool:
        """src/bmsparsevec_float.h:279."""
        return self._size == 0

    def clear(self):
        """Drop all content (reference clear, src/bmsparsevec_float.h:302)."""
        self._check_writable()
        self.sign = self._new_bv()
        self.exponent.clear()
        self.mantissa.clear()
        if self.nullable:
            self.null_plane = self._new_bv()
        self._size = 0
        return self

    clear_all = clear

    def resize(self, n: int):
        self._check_writable()
        n = int(n)
        if n < self._size:
            self.exponent.resize(n)
            self.mantissa.resize(n)
            if n > 0:
                self.sign.set_range(n, max(self._size - 1, n), False)
                if self.nullable:
                    self.null_plane.set_range(n, max(self._size - 1, n),
                                              False)
            else:
                self.sign.clear()
                if self.nullable:
                    self.null_plane.clear()
        self._size = n
        return self

    def swap(self, other: "FloatSparseVector"):
        """Container swap (reference swap, src/bmsparsevec_float.h:269)."""
        self.__dict__, other.__dict__ = other.__dict__, self.__dict__
        return self

    def copy_range(self, other: "FloatSparseVector", lo, hi):
        """Copy [lo, hi] from other, clearing everything else (reference
        copy_range, src/bmsparsevec_float.h:371)."""
        self._check_writable()
        if other.dtype != self.dtype:
            raise ValueError("dtype mismatch")
        lo, hi = int(lo), int(hi)
        self.clear()
        self.exponent.copy_range(other.exponent, lo, hi)
        self.mantissa.copy_range(other.mantissa, lo, hi)
        bv = BitVector(other.sign.size, device=self._device)
        bv.copy_range(other.sign, lo, hi)
        self.sign = bv
        if self.nullable:
            src_null = other.null_plane
            if src_null is None:
                src_null = self._new_bv()
                if other._size:
                    src_null.set_range(0, other._size - 1)
            nv = BitVector(src_null.size, device=self._device)
            nv.copy_range(src_null, lo, hi)
            self.null_plane = nv
        self._size = other._size
        return self

    def clear_range(self, lo, hi, set_null: bool = False):
        """Zero values in [lo, hi]; set_null also unassigns
        (reference clear_range, src/bmsparsevec_float.h:310)."""
        self._check_writable()
        lo, hi = int(lo), int(hi)
        self.sign.set_range(lo, hi, False)
        self.exponent.clear_range(lo, hi, set_null=False)
        self.mantissa.clear_range(lo, hi, set_null=False)
        if self.nullable and set_null:
            self.null_plane.set_range(lo, hi, False)
        return self

    def join(self, other: "FloatSparseVector"):
        """OR-merge another float vector in (reference join,
        src/bmsparsevec_float.h:345: plane-wise OR; overlapping non-zero
        values combine bitwise, as in the reference)."""
        self._check_writable()
        if other.dtype != self.dtype:
            raise ValueError("dtype mismatch")
        self.sign.bit_or(other.sign)
        self.exponent.join(other.exponent)
        self.mantissa.join(other.mantissa)
        if self.nullable:
            if other.nullable:
                self.null_plane.bit_or(other.null_plane)
            elif other._size:
                # non-nullable argument: all its positions are real
                # (reference join_null_slice, src/bmsparsevec.h:2244)
                self.null_plane.set_range(0, other._size - 1, True)
        elif other.nullable:
            self.nullable = True
            self.null_plane = other.null_plane.copy()
        self._size = max(self._size, other._size)
        return self

    def merge(self, other: "FloatSparseVector"):
        """Like join but borrows from (and empties) the source
        (reference merge, src/bmsparsevec_float.h:357)."""
        self.join(other)
        other.clear()
        return self

    def extract(self, n, offset=0):
        """src/bmsparsevec_float.h:426."""
        return self.decode(int(offset), int(n))

    def extract_range(self, lo, hi):
        """src/bmsparsevec_float.h:435."""
        return self.decode(int(lo), int(hi) - int(lo) + 1)

    def sync(self, force: bool = False, sync_size: bool = False):
        """Reference sync (src/bmsparsevec_float.h:407): size bookkeeping
        only; the planes are always consistent here."""
        self._size = max(self._size, self.exponent.size, self.mantissa.size)
        return self

    def _check_writable(self):
        check_writable(self)

    def freeze(self):
        """src/bmsparsevec_float.h:500."""
        self.sign.freeze()
        self.exponent.freeze()
        self.mantissa.freeze()
        if self.nullable:
            self.null_plane.freeze()
        self._ro = True
        return self

    def is_ro(self) -> bool:
        return self._ro

    def is_nullable(self) -> bool:
        return self.nullable

    def get_null_bvector(self) -> BitVector | None:
        return self.null_plane

    def is_compressed(self) -> bool:
        return False

    def is_str(self) -> bool:
        return False

    # -- iterators (reference const_iterator / back_insert_iterator) ----
    def get_const_iterator(self, pos: int = 0):
        """src/bmsparsevec_float.h:161."""
        from .iterators import ConstIterator
        return ConstIterator(self, pos)

    def begin(self):
        return self.get_const_iterator(0)

    def get_back_inserter(self):
        """src/bmsparsevec_float.h:225."""
        from .iterators import BackInsertIterator
        return BackInsertIterator(self)

    def _append_bulk(self, buf):
        has_null = any(v is None for v in buf)
        if has_null and not self.nullable:
            raise ValueError("add_null on a non-nullable vector")
        off = self._size
        vals = np.asarray([0.0 if v is None else v for v in buf],
                          self.dtype)
        self.import_values(vals, offset=off)
        if has_null:
            nulls = np.flatnonzero([v is None for v in buf]) + off
            self.null_plane.clear_many(nulls.astype(_I64))

    # ------------------------------------------------------------------
    def optimize(self):
        self.sign.optimize()
        self.exponent.optimize()
        self.mantissa.optimize()
        if self.nullable:
            self.null_plane.optimize()
        return self

    def calc_stat(self):
        return {
            "exp": self.exponent.calc_stat(),
            "man": self.mantissa.calc_stat(),
            "sign_memory": self.sign.calc_stat()["memory_used"],
        }

    def equal(self, other: "FloatSparseVector") -> bool:
        a, b = self.to_numpy(), other.to_numpy()
        return a.size == b.size and bool(
            np.array_equal(a.view(self._uint), b.view(self._uint)))

    def __iter__(self):
        return iter(self.to_numpy())

    def __repr__(self):
        return (f"FloatSparseVector(dtype={self.dtype}, size={self._size}, "
                f"device={self._device})")
