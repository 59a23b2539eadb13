"""Succinct bit-sliced string vector with optional character remapping
(port of ``bitmagic_tpu/sv/str_vector.py``).

Equivalent of `bm::str_sparse_vector<CharType, BV, STR_SIZE>`
(src/bmstrsparsevec.h:71): strings of bounded length stored column-wise:
octet position k of every string lives in a bit-sliced uint8 plane-group,
searchable in compressed form per octet (scanner find_eq_str builds
per-octet slice masks, src/bmsparsevec_algo.h:2245).

Remap (reference remap_matrix / octet_freq_matrix, src/bmstrsparsevec.h:97):
frequency-based per-position character recoding: each position's alphabet is
renumbered densely, shrinking the number of active bit-planes.

Bulk import and decode convert between strings and the octet matrix with
numpy's fixed-width byte arrays (the JAX package walks the strings one by
one in Python; the octets are the same).  Every part lives on the
vector's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..config import resolve_device
from ..core.bitvector import BitVector, check_writable
from .sparse_vector import SparseVector

_I64 = np.int64


def _as_bytes(s) -> bytes:
    return s.encode() if isinstance(s, str) else bytes(s)


def _rows_to_str(cols: np.ndarray, nulls=None) -> list:
    """Octet rows (uint8[n, w]) -> strings, each cut at its first zero
    octet and decoded as latin-1; None where ``nulls``."""
    n, w = cols.shape
    if w == 0:
        out = [""] * n
    else:
        cut = np.cumsum(cols == 0, axis=1) > 0
        fixed = np.ascontiguousarray(np.where(cut, 0, cols), np.uint8)
        out = [b.decode("latin-1")
               for b in fixed.view(f"S{w}").reshape(n).tolist()]
    if nulls is not None:
        for r in np.flatnonzero(nulls):
            out[r] = None
    return out


class StrSparseVector:
    """bm::str_sparse_vector equivalent (fixed max octet capacity)."""

    def __init__(self, max_str_size: int = 16, nullable: bool = False,
                 device=None):
        self._device = resolve_device(device)
        self.max_str_size = int(max_str_size)
        self.nullable = nullable
        # one uint8 bit-sliced vector per octet position
        self.octets = [self._new_octet() for _ in range(self.max_str_size)]
        self.null_plane: BitVector | None = (self._new_bv() if nullable
                                             else None)
        self._size = 0
        self.remap_matrices = None      # [S][256] uint8 or None
        self.unmap_matrices = None
        self._ro = False

    @property
    def device(self) -> torch.device:
        return self._device

    def _new_bv(self) -> BitVector:
        return BitVector(C.ID_MAX48, device=self._device)

    def _new_octet(self) -> SparseVector:
        return SparseVector(np.uint8, device=self._device)

    # ------------------------------------------------------------------
    @classmethod
    def from_strings(cls, strings, max_str_size=None, nullable=False,
                     device=None):
        strings = list(strings)
        if max_str_size is None:
            max_str_size = max((len(s) for s in strings if s is not None),
                               default=0) or 1
        sv = cls(max_str_size,
                 nullable=nullable or any(s is None for s in strings),
                 device=device)
        sv.import_strings(strings)
        return sv

    def _octet_matrix(self, strings):
        """(uint8[n, max_str_size] octets, bool[n] NULL mask) of a batch:
        each string's UTF-8 bytes, zero-padded."""
        n, w = len(strings), self.max_str_size
        nulls = np.fromiter((s is None for s in strings), bool, n)
        bs = [b"" if s is None else _as_bytes(s) for s in strings]
        lens = np.fromiter(map(len, bs), _I64, n)
        over = np.flatnonzero(lens > w)
        if over.size:
            raise ValueError(f"string longer than max_str_size "
                             f"({int(lens[over[0]])} > {w})")
        mat = np.array(bs, dtype=f"S{w}").view(np.uint8).reshape(n, w)
        return mat, nulls

    def import_strings(self, strings, offset: int = 0):
        """Bulk import: one device transpose per octet position."""
        self._check_writable()
        n = len(strings)
        if n == 0:
            return self
        mat, nulls = self._octet_matrix(strings)
        if self.remap_matrices is not None:
            mat = self._remap_apply(mat)
        for k in range(self.max_str_size):
            self.octets[k].import_values(mat[:, k], offset)
        self._size = max(self._size, offset + n)
        if self.nullable:
            ids = np.flatnonzero(~nulls) + offset
            if ids.size:
                self.null_plane.set_many(ids)
        return self

    def push_back(self, s):
        return self.import_strings([s], offset=self._size)

    def push_back_null(self, count: int = 1):
        """Append ``count`` NULL elements (reference push_back_null,
        src/bmstrsparsevec.h:696)."""
        if not self.is_nullable():
            raise ValueError("push_back_null requires a nullable vector")
        return self.resize(self._size + int(count))

    def set(self, i, s):
        self._check_writable()
        i = int(i)
        b = _as_bytes(s)
        if len(b) > self.max_str_size:
            raise ValueError("string too long")
        arr = np.zeros(self.max_str_size, np.uint8)
        arr[:len(b)] = np.frombuffer(b, np.uint8)
        if self.remap_matrices is not None:
            arr = self._remap_apply(arr[None, :])[0]
        for k in range(self.max_str_size):
            self.octets[k].set(i, arr[k])
        if self.nullable:
            self.null_plane.set(i, True)
        if i >= self._size:
            self._size = i + 1
        return self

    __setitem__ = set

    def set_null(self, i):
        self._check_writable()
        if not self.nullable:
            raise ValueError("not nullable")
        for k in range(self.max_str_size):
            self.octets[k].set(i, 0)
        self.null_plane.set(int(i), False)
        return self

    def is_null(self, i) -> bool:
        return self.nullable and not self.null_plane.test(i)

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self._size

    def __len__(self):
        return self._size

    def get(self, i) -> str:
        return self.gather([i])[0]

    __getitem__ = get

    def _columns(self, ids, octets) -> np.ndarray:
        """uint8[n, len(octets)] of the given octet positions, unmapped."""
        cols = np.stack([self.octets[k].gather(ids) for k in octets], axis=1)
        if self.remap_matrices is not None:
            for j, k in enumerate(octets):
                cols[:, j] = self.unmap_matrices[k][cols[:, j]]
        return cols

    def gather(self, ids) -> list:
        ids = np.asarray(ids, _I64)
        cols = self._columns(ids, range(self.max_str_size))
        return _rows_to_str(cols, ~self.null_plane.get_bits(ids)
                            if self.nullable else None)

    def to_list(self) -> list:
        return self.gather(np.arange(self._size, dtype=_I64))

    def gather_substr(self, ids, frm: int, to: int) -> list:
        """Substring extraction [frm, to] per element without decoding the
        other octet columns (the reference const_iterator substring mode,
        src/bmstrsparsevec.h:382-390): only the selected octet slices are
        gathered."""
        if not (0 <= frm <= to < self.max_str_size):
            raise ValueError("substring range out of octet capacity")
        ids = np.asarray(ids, _I64)
        cols = self._columns(ids, range(frm, to + 1))
        return _rows_to_str(cols, ~self.null_plane.get_bits(ids)
                            if self.nullable else None)

    def substr(self, i: int, frm: int, to: int) -> str | None:
        return self.gather_substr([i], frm, to)[0]

    def compare(self, i: int, s) -> int:
        """Lexicographic compare of element i vs string s: -1/0/1
        (reference compare, src/bmstrsparsevec.h:775)."""
        mine = self.get(i) or ""
        s = s if isinstance(s, str) else bytes(s).decode("latin-1")
        return (mine > s) - (mine < s)

    # ------------------------------------------------------------------
    # remap (frequency-based per-position recoding)
    # ------------------------------------------------------------------
    def remap(self):
        """Recode characters per position by descending frequency
        (reference recalc_remap_matrix2 / remap_from_sv,
        src/bmstrsparsevec.h:97-108).  Code 0 is reserved for the string
        terminator; ties keep ascending character order."""
        self._check_writable()
        if self.remap_matrices is not None:
            return self
        ids = np.arange(self._size, dtype=_I64)
        cols = np.stack([self.octets[k].gather(ids)
                         for k in range(self.max_str_size)], axis=1)
        remaps, unmaps = [], []
        for k in range(self.max_str_size):
            freq = np.bincount(cols[:, k], minlength=256)
            vals = np.flatnonzero(freq[1:]) + 1
            order = vals[np.argsort(-freq[vals], kind="stable")]
            rm = np.zeros(256, np.uint8)
            um = np.zeros(256, np.uint8)
            codes = np.arange(1, order.size + 1)
            rm[order] = codes
            um[codes] = order
            remaps.append(rm)
            unmaps.append(um)
        self.remap_matrices = np.stack(remaps)
        self.unmap_matrices = np.stack(unmaps)
        new_cols = self._remap_apply(cols)
        for k in range(self.max_str_size):
            self.octets[k] = self._new_octet()
            self.octets[k].import_values(new_cols[:, k], 0)
        return self

    def is_remap(self) -> bool:
        return self.remap_matrices is not None

    def _remap_apply(self, mat: np.ndarray) -> np.ndarray:
        out = np.zeros_like(mat)
        for k in range(self.max_str_size):
            out[:, k] = self.remap_matrices[k][mat[:, k]]
        return out

    def remap_value(self, s) -> np.ndarray | None:
        """Remapped octet image of a query string, or None if some
        character cannot be remapped at its position (the value cannot
        exist)."""
        b = _as_bytes(s)
        if len(b) > self.max_str_size:
            return None          # longer than any stored string can be
        arr = np.zeros(self.max_str_size, np.uint8)
        arr[:len(b)] = np.frombuffer(b, np.uint8)
        if self.remap_matrices is None:
            return arr
        out = np.zeros_like(arr)
        for k in range(self.max_str_size):
            if arr[k] == 0:
                continue
            code = self.remap_matrices[k][arr[k]]
            if code == 0:
                return None
            out[k] = code
        return out

    # ------------------------------------------------------------------
    def _range_bv(self, lo, hi) -> BitVector:
        rng = self._new_bv()
        rng.set_range(int(lo), int(hi))
        return rng

    def keep_range(self, lo, hi):
        self._check_writable()
        rng = self._range_bv(lo, hi)
        for k in range(self.max_str_size):
            self.octets[k].filter(rng)
        if self.nullable:
            self.null_plane.bit_and(rng)
        return self

    def keep(self, bv_idx: BitVector):
        """AND every octet plane (and the NULL plane) with an index
        bit-vector (reference keep == bit_and_rows,
        src/bmstrsparsevec.h:589)."""
        self._check_writable()
        for k in range(self.max_str_size):
            self.octets[k].filter(bv_idx)
        if self.nullable:
            self.null_plane.bit_and(bv_idx)
        return self

    def clear_range(self, lo, hi, set_null: bool = False):
        """Zero octets in [lo, hi]; set_null also unassigns
        (reference clear_range, src/bmstrsparsevec.h:841)."""
        self._check_writable()
        for k in range(self.max_str_size):
            self.octets[k].clear_range(lo, hi, set_null=False)
        if self.nullable and set_null:
            self.null_plane.set_range(int(lo), int(hi), False)
        return self

    def import_back(self, strings):
        """Append a batch at the end: one bulk transpose import (reference
        import_back, src/bmstrsparsevec.h:1289)."""
        self._check_writable()
        return self.import_strings(list(strings), offset=self._size)

    def optimize(self):
        for o in self.octets:
            o.optimize()
        if self.nullable:
            self.null_plane.optimize()
        return self

    def calc_stat(self) -> dict:
        st = {"memory_used": 0, "bit_blocks": 0, "remap": self.is_remap()}
        for o in self.octets:
            s = o.calc_stat()
            st["memory_used"] += s["memory_used"]
            st["bit_blocks"] += s["bit_blocks"]
        return st

    def _check_writable(self):
        check_writable(self)

    def freeze(self):
        for o in self.octets:
            o.freeze()
        if self.nullable:
            self.null_plane.freeze()
        self._ro = True
        return self

    def is_ro(self) -> bool:
        return self._ro

    def equal(self, other: "StrSparseVector") -> bool:
        return self.to_list() == other.to_list()

    # -- reference-name conveniences (src/bmstrsparsevec.h) -------------
    def insert(self, i, s):
        """Insert a string at i, shifting elements right (reference
        insert, src/bmstrsparsevec.h): per-octet plane insert-shifts."""
        self._check_writable()
        i = int(i)
        for k in range(self.max_str_size):
            self.octets[k].insert(i, 0)
        if self.nullable:
            self.null_plane.insert(i, False)
        self._size += 1
        self.set(i, s)
        return self

    def erase(self, i):
        """Erase element i, shifting elements left (reference erase)."""
        self._check_writable()
        i = int(i)
        for k in range(self.max_str_size):
            self.octets[k].erase(i)
        if self.nullable:
            self.null_plane.erase(i)
        if self._size:
            self._size -= 1
        return self

    def common_prefix_length(self, i, j) -> int:
        """Length of the common prefix of elements i and j (reference
        common_prefix_length, src/bmstrsparsevec.h)."""
        a, b = self.get(int(i)) or "", self.get(int(j)) or ""
        n = 0
        for ca, cb in zip(a, b):
            if ca != cb:
                break
            n += 1
        return n

    def try_get(self, i):
        """(found, string); found is False at NULL positions (reference
        try_get, src/bmstrsparsevec.h:711)."""
        if self.nullable and not self.null_plane.test(i):
            return False, ""
        return True, self.get(i)

    def at(self, i):
        if not (0 <= int(i) < self._size):
            raise IndexError(i)
        return self.get(i)

    def is_nullable(self) -> bool:
        return self.nullable

    def swap(self, a, b=None):
        """Container swap (one arg, src/bmstrsparsevec.h:752) or element
        swap of positions a and b (two args, :604)."""
        if b is None:
            if not isinstance(a, StrSparseVector):
                raise TypeError("swap(other) needs a StrSparseVector")
            self.__dict__, a.__dict__ = a.__dict__, self.__dict__
            return self
        sa, sb = self.get(a), self.get(b)
        na = self.nullable and not self.null_plane.test(a)
        nb = self.nullable and not self.null_plane.test(b)
        self.set_null(a) if nb else self.set(a, sb)
        self.set_null(b) if na else self.set(b, sa)
        return self

    def join(self, other: "StrSparseVector"):
        """Plane-wise OR merge of the octet slices (reference str join,
        src/bmstrsparsevec.h: overlapping assigned strings combine
        bitwise, exactly as the reference's slice loop does).  Joining
        across different remap tables is undefined in the reference; here
        it raises instead."""
        self._check_writable()
        a, b = self.remap_matrices, other.remap_matrices
        if (a is None) != (b is None) or (
                a is not None and not all(
                    np.array_equal(x, y) for x, y in zip(a, b))):
            raise ValueError(
                "str join/merge across different remap tables is undefined "
                "in the reference; remap() after merging instead")
        while len(self.octets) < len(other.octets):
            self.octets.append(self._new_octet())
        self.max_str_size = max(self.max_str_size, other.max_str_size)
        for k, o in enumerate(other.octets):
            self.octets[k].join(o)
        if other._size > self._size:
            self._size = other._size
        if self.nullable:
            if other.nullable:
                self.null_plane.bit_or(other.null_plane)
            elif other._size:
                self.null_plane.set_range(0, other._size - 1, True)
        return self

    def merge(self, other: "StrSparseVector"):
        """join + clear other (reference str merge: the destructive join,
        src/bmstrsparsevec.h:1329)."""
        self.join(other)
        other.clear()
        return self

    def find_rank(self, rank: int) -> int:
        """Dense address space: the rank-th element is position rank-1
        (reference base find_rank)."""
        rank = int(rank)
        if rank < 1:
            raise ValueError("rank is 1-based")
        return rank - 1

    def sync(self, force: bool = False):
        return self

    def sync_size(self):
        return self.sync()

    def effective_slices(self) -> int:
        """Top used bit-plane of the octet matrix + 1 (reference base
        effective_slices over the 8*STR_SIZE-row bit-matrix)."""
        n = 0
        for k, o in enumerate(self.octets):
            s = o.effective_slices()
            if s:
                n = 8 * k + s
        return n

    def end(self):
        """Invalid const_iterator sentinel (reference end())."""
        it = self.get_const_iterator(0)
        it.invalidate()
        return it

    def clear(self):
        """Drop all content (reference clear_all,
        src/bmstrsparsevec.h:829; remap matrices kept unless remap=True)."""
        self._check_writable()
        for k in range(self.max_str_size):
            self.octets[k].clear()
        if self.nullable:
            self.null_plane = self._new_bv()
        self._size = 0
        return self

    def clear_all(self, free_mem: bool = True, remap: bool = False):
        self.clear()
        if remap:
            self.remap_matrices = None
            self.unmap_matrices = None
        return self

    def resize(self, n: int):
        """Truncate/extend (reference resize)."""
        self._check_writable()
        n = int(n)
        if n < self._size:
            for k in range(self.max_str_size):
                self.octets[k].resize(n)
            if self.nullable and n > 0:
                self.null_plane.set_range(n, max(self._size - 1, n), False)
            elif self.nullable:
                self.null_plane.clear()
        self._size = n
        return self

    def copy_range(self, other: "StrSparseVector", lo, hi):
        """Copy [lo, hi] from other, clearing everything else (reference
        copy_range, src/bmstrsparsevec.h:1315)."""
        self._check_writable()
        if other.max_str_size > self.max_str_size:
            raise ValueError("octet capacity too small")
        lo, hi = int(lo), int(hi)
        self.clear_all(remap=True)
        self.remap_matrices = (None if other.remap_matrices is None
                               else other.remap_matrices.copy())
        self.unmap_matrices = (None if other.unmap_matrices is None
                               else other.unmap_matrices.copy())
        for k in range(other.max_str_size):
            self.octets[k].copy_range(other.octets[k], lo, hi)
        if self.nullable:
            src_null = other.null_plane
            if src_null is None:
                src_null = self._new_bv()
                if other._size:
                    src_null.set_range(0, other._size - 1)
            bv = BitVector(src_null.size, device=self._device)
            bv.copy_range(src_null, lo, hi)
            self.null_plane = bv
        self._size = other._size
        return self

    @staticmethod
    def compare_str(s1, s2) -> int:
        """Three-way string compare (reference compare_str,
        src/bmstrsparsevec.h:778)."""
        a = s1 if isinstance(s1, str) else bytes(s1).decode("latin-1")
        b = s2 if isinstance(s2, str) else bytes(s2).decode("latin-1")
        return (a > b) - (a < b)

    def compare_elements(self, i, j) -> int:
        """Three-way compare of elements i and j (reference compare(idx1,
        idx2), src/bmstrsparsevec.h:792)."""
        return self.compare_str(self.get(int(i)) or "",
                                self.get(int(j)) or "")

    def remap_from(self, other: "StrSparseVector"):
        """Rebuild self as the remapped image of other (reference
        remap_from_sv, src/bmstrsparsevec.h)."""
        self.clear_all(remap=True)
        self.max_str_size = other.max_str_size
        self.octets = [self._new_octet() for _ in range(self.max_str_size)]
        self.nullable = other.nullable
        self.null_plane = self._new_bv() if self.nullable else None
        self.import_strings(other.to_list(), 0)
        self.remap()
        return self

    def effective_size(self) -> int:
        return self._size

    def get_null_bvector(self) -> BitVector | None:
        return self.null_plane

    # -- iterators (reference const_iterator / back_insert_iterator) ----
    def get_const_iterator(self, pos: int = 0):
        """src/bmstrsparsevec.h:944."""
        from .iterators import ConstIterator
        return ConstIterator(self, pos)

    def begin(self):
        return self.get_const_iterator(0)

    def get_back_inserter(self):
        """src/bmstrsparsevec.h:959."""
        from .iterators import BackInsertIterator
        return BackInsertIterator(self)

    def _append_bulk(self, buf):
        self.import_strings(list(buf), offset=self._size)

    def decode(self, lo: int, n: int) -> list:
        """n strings starting at lo (reference decode)."""
        return self.gather(np.arange(int(lo), int(lo) + int(n)))

    def decode_substr(self, lo: int, n: int, frm: int, to: int) -> list:
        return self.gather_substr(
            np.arange(int(lo), int(lo) + int(n)), frm, to)

    def empty(self) -> bool:
        return self._size == 0

    def effective_max_str(self) -> int:
        return self.max_str_size

    def is_str(self) -> bool:
        return True

    def is_compressed(self) -> bool:
        return False

    def __iter__(self):
        return iter(self.to_list())

    def __repr__(self):
        return (f"StrSparseVector(max_str_size={self.max_str_size}, "
                f"size={self._size}, device={self._device})")


StrSparseVector.assign = StrSparseVector.set    # reference alias
