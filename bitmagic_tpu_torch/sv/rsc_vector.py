"""Rank-Select Compressed sparse vector: NULL columns physically dropped
(port of ``bitmagic_tpu/sv/rsc_vector.py``).

Equivalent of `bm::rsc_sparse_vector<Val, SV>` (src/bmsparsevec_compr.h:58):
logical position -> physical position via rank over the NULL bit-vector
(``sync()`` builds the rs_index, reference :806-823); values live densely in
an internal bit-sliced vector holding only assigned elements.  Both parts
live on the vector's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..config import resolve_device
from ..core.bitvector import BitVector, check_writable
from .sparse_vector import SparseVector

_I64 = np.int64


class RSCSparseVector:
    """bm::rsc_sparse_vector equivalent."""

    def __init__(self, dtype=np.uint32, device=None):
        self.dtype = np.dtype(dtype)
        self._device = resolve_device(device)
        self.dense = self._new_dense()            # values at compressed slots
        self.null_bv = self._new_bv()             # 1 = assigned
        self._size = 0
        self._rs = None
        self._staged: dict[int, object] = {}
        self._ro = False

    @property
    def device(self) -> torch.device:
        return self._device

    def _new_bv(self) -> BitVector:
        return BitVector(C.ID_MAX48, device=self._device)

    def _new_dense(self) -> SparseVector:
        return SparseVector(self.dtype, device=self._device)

    def _assign(self, ids, vals):
        """Dense payload ``vals`` at the sorted logical ``ids``."""
        self.dense = self._new_dense()
        if ids.size:
            self.dense.import_values(vals, 0)
            self.null_bv = BitVector.from_indices(ids, C.ID_MAX48,
                                                  device=self._device)
        else:
            self.null_bv = self._new_bv()

    # ------------------------------------------------------------------
    @classmethod
    def from_sparse_vector(cls, sv: SparseVector) -> "RSCSparseVector":
        """load_from a (nullable) plain sparse vector (reference load_from),
        on the source vector's device.  The assigned ids are the NULL
        plane's set bits below the size (the JAX package derives the same
        ids from ``setdiff1d`` over ``arange(size)``)."""
        out = cls(sv.dtype, device=sv.device)
        sv._flush()
        out._size = sv._size
        if sv.nullable:
            ids = sv.null_plane.indices()
            ids = ids[ids < sv._size]
        else:
            ids = np.arange(sv._size, dtype=_I64)
        if ids.size:
            out._assign(ids, sv.gather(ids))
        out.sync()
        return out

    def load_to(self, nullable: bool = True) -> SparseVector:
        """Decompress back to a plain sparse vector (reference load_to):
        the assigned values are written in one batch (the JAX package sets
        them one by one and flushes; the planes are the same)."""
        self._flush()
        out = SparseVector(self.dtype, nullable=nullable, device=self._device)
        ids = self.null_bv.indices()
        ids = ids[ids < self._size]
        if ids.size:
            out._write(ids, np.zeros(ids.size, bool),
                       self.dense.decode(0, ids.size))
        out._size = self._size
        return out

    # ------------------------------------------------------------------
    def sync(self):
        """Build/refresh the rank index (reference sync, :806)."""
        self._flush_no_sync()
        self._rs = self.null_bv.build_rs_index()
        return self

    def in_sync(self) -> bool:
        return self._rs is not None

    def unsync(self):
        """Drop the rank index (reference unsync,
        src/bmsparsevec_compr.h:832)."""
        self._rs = None
        return self

    def sync_size(self):
        return self.sync()

    def inc_not_null(self, i, v=1):
        """Add ``v`` to a known-not-NULL element (reference inc_not_null,
        src/bmsparsevec_compr.h:522)."""
        if self.is_null(i):
            raise ValueError("inc_not_null at a NULL position")
        self.set(i, self.get(i) + v)
        return self

    def is_remap(self) -> bool:
        return False

    def effective_slices(self) -> int:
        """Used value slices of the compressed-domain matrix (reference
        base effective_slices)."""
        return self.dense.effective_slices()

    def end(self):
        """Invalid const_iterator sentinel (reference end())."""
        it = self.get_const_iterator(0)
        it.invalidate()
        return it

    def _flush(self):
        if self._staged:
            self._flush_no_sync()
        if self._rs is None:
            self._rs = self.null_bv.build_rs_index()

    def _flush_no_sync(self):
        if not self._staged:
            return
        items = sorted(self._staged.items())
        self._staged = {}
        # rebuild the dense storage merging the staged values
        old_ids = self.null_bv.indices()
        old_vals = (self.dense.decode(0, old_ids.size) if old_ids.size
                    else np.zeros(0, self.dtype))
        m = dict(zip(old_ids.tolist(), old_vals.tolist()))
        for i, v in items:
            if v is None:
                m.pop(i, None)
            else:
                m[i] = v
        ids = np.asarray(sorted(m.keys()), _I64)
        self._assign(ids, np.asarray([m[i] for i in ids], self.dtype))
        self._rs = None

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self._size

    def __len__(self):
        return self._size

    def set(self, i, v):
        self._check_writable()
        i = int(i)
        self._staged[i] = v
        self._rs = None
        if i >= self._size:
            self._size = i + 1
        return self

    __setitem__ = set

    def set_null(self, i):
        self._check_writable()
        i = int(i)
        self._staged[i] = None
        self._rs = None
        if i >= self._size:
            self._size = i + 1
        return self

    def push_back(self, v):
        return self.set(self._size, v)

    def push_back_null(self, count: int = 1):
        """Append ``count`` NULL (unassigned) elements (reference
        push_back_null, src/bmsparsevec_compr.h:487)."""
        return self.resize(self._size + int(count))

    def inc(self, i):
        self._check_writable()
        self.set(i, self.get(i) + 1)
        return self

    def is_null(self, i) -> bool:
        self._flush()
        return not self.null_bv.test(i)

    def get(self, i):
        self._flush()
        i = int(i)
        if not self.null_bv.test(i):
            return self.dtype.type(0)
        r = int(self._rs.rank_batch(np.asarray([i]))[0])
        return self.dense.get(r - 1)

    def try_get(self, i):
        """(found, value) pair (reference try_get / try_get_sync)."""
        self._flush()
        if not self.null_bv.test(i):
            return False, self.dtype.type(0)
        return True, self.get(i)

    __getitem__ = get

    def gather(self, ids) -> np.ndarray:
        self._flush()
        ids = np.asarray(ids, _I64)
        has = self.null_bv.get_bits(ids)
        out = np.zeros(ids.shape, self.dtype)
        if has.any():
            ranks = self._rs.rank_batch(ids[has])
            out[has] = self.dense.gather(ranks - 1)
        return out

    def decode(self, lo: int, n: int) -> np.ndarray:
        return self.gather(np.arange(lo, lo + n, dtype=_I64))

    def to_numpy(self) -> np.ndarray:
        return self.decode(0, self._size)

    def find_rank(self, rank: int) -> int:
        """Logical position of the rank-th assigned element."""
        self._flush()
        return self._rs.select(rank)

    def get_null_bvector(self) -> BitVector:
        self._flush()
        return self.null_bv

    def count(self) -> int:
        """Number of assigned elements."""
        self._flush()
        return self.null_bv.count()

    def count_range_notnull(self, left, right) -> int:
        """Number of not-NULL elements in [left, right]
        (reference count_range_notnull, src/bmsparsevec_compr.h:406)."""
        left, right = int(left), int(right)
        if left > right:
            left, right = right, left
        self._flush()
        return self.null_bv.count_range(left, right)

    def optimize(self):
        self._flush()
        self.dense.optimize()
        self.null_bv.optimize()
        return self

    def calc_stat(self) -> dict:
        self._flush()
        st = self.dense.calc_stat()
        st["null_memory"] = self.null_bv.calc_stat()["memory_used"]
        return st

    def equal(self, other: "RSCSparseVector") -> bool:
        self._flush()
        other._flush()
        return (self._size == other._size and
                self.null_bv.equal(other.null_bv) and
                self.dense.equal(other.dense))

    def is_dense(self) -> bool:
        """All logical positions assigned?"""
        self._flush()
        return self.count() == self._size

    def at(self, i):
        """Bounds-checked access (reference at, src/bmsparsevec_compr.h:426)."""
        if not (0 <= int(i) < self._size):
            raise IndexError(i)
        return self.get(i)

    def try_get_sync(self, i):
        """try_get that requires a built rs_index (reference try_get_sync,
        src/bmsparsevec_compr.h:461).  Raises if not in sync."""
        if self._rs is None and not self._staged:
            raise RuntimeError("rsc vector is not in sync (call sync())")
        return self.try_get(i)

    def is_nullable(self) -> bool:
        return True         # reference: always (src/bmsparsevec_compr.h:653)

    def clear(self):
        """Drop all content (reference clear_all,
        src/bmsparsevec_compr.h:739)."""
        self._check_writable()
        self._staged = {}
        self.dense = self._new_dense()
        self.null_bv = self._new_bv()
        self._size = 0
        self._rs = None
        return self

    clear_all = clear

    def resize(self, n: int):
        """Truncate/extend the logical size (reference resize)."""
        self._check_writable()
        self._flush_no_sync()
        n = int(n)
        if n < self._size:
            keep_ids = self.null_bv.indices()
            keep_ids = keep_ids[keep_ids < n]
            vals = (self.dense.decode(0, keep_ids.size) if keep_ids.size
                    else np.zeros(0, self.dtype))
            self._assign(keep_ids, vals)
            self._rs = None
        self._size = n
        return self

    def copy_range(self, other: "RSCSparseVector", lo, hi):
        """Copy assigned values of other's [lo, hi], clearing the rest
        (reference copy_range, src/bmsparsevec_compr.h:789)."""
        self._check_writable()
        other._flush()
        lo, hi = int(lo), int(hi)
        self.clear()
        ids = other.null_bv.indices()
        ids = ids[(ids >= lo) & (ids <= hi) & (ids < other._size)]
        if ids.size:
            self._assign(ids, other.gather(ids))
        self._size = other._size
        self.sync()
        return self

    def merge_not_null(self, other: "RSCSparseVector"):
        """Merge other's assigned values into self; the reference requires
        the assigned sets be disjoint (merge_not_null,
        src/bmsparsevec_compr.h), enforced here."""
        self._check_writable()
        self._flush()
        other._flush()
        if (self.null_bv & other.null_bv).any():
            raise ValueError("merge_not_null: assigned sets overlap")
        ids = other.null_bv.indices()
        ids = ids[ids < other._size]
        if ids.size:
            for i, v in zip(ids, other.gather(ids)):
                self.set(int(i), v)
        self._size = max(self._size, other._size)
        other.clear()
        self.sync()
        return self

    def _check_writable(self):
        check_writable(self)

    def freeze(self):
        """Immutable residency (reference freeze)."""
        self._flush()
        self.dense.freeze()
        self.null_bv.freeze()
        self._ro = True
        return self

    def is_ro(self) -> bool:
        return self._ro

    # -- iterators (reference const_iterator / back_insert_iterator) ----
    def get_const_iterator(self, pos: int = 0):
        """src/bmsparsevec_compr.h:700."""
        from .iterators import ConstIterator
        self._flush()
        return ConstIterator(self, pos)

    def begin(self):
        return self.get_const_iterator(0)

    def get_back_inserter(self):
        """src/bmsparsevec_compr.h:717."""
        from .iterators import BackInsertIterator
        self._flush()
        return BackInsertIterator(self)

    def _append_bulk(self, buf):
        for v in buf:
            if v is None:
                self.set_null(self._size)
            else:
                self.push_back(v)

    def __iter__(self):
        return self.get_const_iterator(0)

    # -- reference-name conveniences (src/bmsparsevec_compr.h) ----------
    def load_from(self, sv: SparseVector):
        """Rebuild from a plain (nullable) sparse vector (reference
        load_from, src/bmsparsevec_compr.h)."""
        self._check_writable()
        other = RSCSparseVector.from_sparse_vector(sv)
        self.__dict__.update(other.__dict__)
        return self

    def construct_rs_index(self):
        return self.sync()

    def is_sync(self) -> bool:
        return self.in_sync()

    def empty(self) -> bool:
        return self._size == 0

    def effective_size(self) -> int:
        return self._size

    def is_compressed(self) -> bool:
        return True

    def is_str(self) -> bool:
        return False

    def __repr__(self):
        return (f"RSCSparseVector(dtype={self.dtype}, size={self._size}, "
                f"device={self._device})")
