"""Bit-sliced (bit-transposed) succinct integer vector, unsigned and signed
(port of ``bitmagic_tpu/sv/sparse_vector.py``).

Equivalent of `bm::sparse_vector<Val, BV>` (src/bmsparsevec.h:86): an integer
vector stored as up to 64 bit-planes (BitVectors) plus an optional NULL plane
(bit set = value assigned, reference null_support semantics).  Values are
searchable in compressed form via slice algebra (``sv/scanner.py``).

Signed values use the reference's s2u mapping (sign in bit 0, |v|-1
magnitudes shifted up, src/bmbmatrix.h:2294), so ordering by slices works
unchanged and the planes are bit-compatible with the reference BLOB format.

Bulk ``from_array`` bit-transposes the values on the vector's device in
plain PyTorch (the JAX package runs the same transpose as one XLA program,
``_transpose_kernel``); ``gather`` decodes every plane's word of each
queried element on the device (``_gather_decode_kernel`` there).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..config import resolve_device
from ..core.bitvector import BitVector, check_writable
from ..core.blocks import _B, _F, _G, Structure
from ..ops.bitops import u32_to_i32

_I64 = np.int64


def value_fits(value, dtype) -> bool:
    """True when ``value`` is representable in ``dtype``.  Search entry
    points use this to resolve out-of-range queries symbolically (the
    reference takes a typed ``value_type`` argument; here an
    unrepresentable value simply never matches)."""
    try:
        v = int(value)
    except (TypeError, ValueError, OverflowError):
        return False
    info = np.iinfo(dtype)
    return info.min <= v <= info.max


def _transpose(u: np.ndarray, n_slices: int, n_words: int, device):
    """Values (uint64, padded to n_words * 32) -> plane word image
    int32[n_slices, n_words] on ``device``: word w of plane s holds bit s
    of values 32w .. 32w + 31, LSB-first (the reference's import
    transpose, src/bmsparsevec.h:1185-1330)."""
    pad = np.zeros(n_words * 32, np.uint64)
    pad[:u.size] = u
    v = torch.from_numpy(pad.view(np.int64)).to(device).reshape(n_words, 32)
    weights = torch.ones(32, dtype=torch.int64, device=device) << \
        torch.arange(32, dtype=torch.int64, device=device)
    out = torch.empty((n_slices, n_words), dtype=torch.int32, device=device)
    for s in range(n_slices):
        out[s] = u32_to_i32((((v >> s) & 1) * weights).sum(dim=1))
    return out


def _bv_from_plane_words(words: torch.Tensor, word_offset: int
                         ) -> BitVector:
    """A BitVector from a plane word image (int32 on the device) starting
    at ``word_offset``, keeping only nonzero blocks."""
    dev = words.device
    total_words = word_offset + words.numel()
    first_blk = word_offset // C.SET_BLOCK_SIZE
    last_blk = (total_words - 1) // C.SET_BLOCK_SIZE
    n_blk = last_blk - first_blk + 1
    img = torch.zeros(n_blk * C.SET_BLOCK_SIZE, dtype=torch.int32,
                      device=dev)
    start = word_offset - first_blk * C.SET_BLOCK_SIZE
    img[start:start + words.numel()] = words
    img = img.reshape(n_blk, C.SET_BLOCK_SIZE)
    nz = torch.nonzero(img.any(dim=1)).reshape(-1)
    if nz.numel() == 0:
        return BitVector(C.ID_MAX48, device=dev)
    nz_np = nz.cpu().numpy().astype(_I64)
    struct = Structure(first_blk + nz_np,
                       np.full(nz_np.size, C.CLS_BIT, np.uint8))
    return BitVector._from_parts(struct, img[nz], C.ID_MAX48)


class SparseVector:
    """Succinct bit-sliced integer vector (bm::sparse_vector equivalent)."""

    def __init__(self, dtype=np.uint32, nullable: bool = False,
                 device=None):
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "iu":
            raise TypeError(f"SparseVector holds integers, not {self.dtype}")
        self._device = resolve_device(device)
        self.val_bits = self.dtype.itemsize * 8
        self.signed = self.dtype.kind == "i"
        # signed s2u packs sign into bit 0 and |v|-1 magnitudes above it,
        # so the encoding fits exactly val_bits slices for every dtype
        # (reference base_sparse_vector sv_value_slices, src/bmbmatrix.h:490)
        self.n_slices = self.val_bits
        self._size = 0
        self.planes: list[BitVector | None] = [None] * self.n_slices
        self.nullable = nullable
        self.null_plane: BitVector | None = (
            BitVector(C.ID_MAX48, device=self._device) if nullable else None)
        self._staged: dict[int, object] = {}
        self._ro = False

    @property
    def device(self) -> torch.device:
        return self._device

    def _new_plane(self) -> BitVector:
        return BitVector(C.ID_MAX48, device=self._device)

    # ------------------------------------------------------------------
    # value mapping (reference s2u/u2s)
    # ------------------------------------------------------------------
    def s2u(self, v):
        """Signed -> unsigned slice encoding: sign in bit 0, negatives store
        |v|-1 (the reference's -(v+1) trick, src/bmbmatrix.h:2294)."""
        if not self.signed:
            return np.asarray(v).astype(np.uint64)
        v = np.asarray(v, np.int64)
        # ~v == -(v+1) in two's complement: |v|-1 without overflowing at min
        return np.where(v < 0,
                        ((~v).astype(np.uint64) << np.uint64(1))
                        | np.uint64(1),
                        v.astype(np.uint64) << np.uint64(1))

    def u2s(self, u):
        """Inverse of s2u (reference u2s, src/bmbmatrix.h:2315)."""
        if not self.signed:
            return u.astype(self.dtype)
        u = np.asarray(u, np.uint64)
        mag = (u >> np.uint64(1)).astype(np.int64)
        return np.where(u & np.uint64(1), -mag - 1, mag).astype(self.dtype)

    # ------------------------------------------------------------------
    # construction / bulk import
    # ------------------------------------------------------------------
    @classmethod
    def from_array(cls, values, dtype=None, nullable=False, null_mask=None,
                   device=None):
        values = np.asarray(values)
        dtype = values.dtype if dtype is None else np.dtype(dtype)
        sv = cls(dtype, nullable=nullable or (null_mask is not None),
                 device=device)
        if null_mask is not None:
            # NULL slots hold zero value planes (reference set_null =
            # clear(idx, true), src/bmsparsevec.h:1162)
            nm = np.asarray(null_mask, bool)        # True = NULL
            values = np.where(nm, np.asarray(0, values.dtype), values)
        sv.import_values(values, offset=0)
        if sv.nullable and null_mask is not None:
            sv.null_plane = BitVector.from_indices(
                np.flatnonzero(~nm), C.ID_MAX48, device=sv._device)
        return sv

    def import_values(self, values, offset: int = 0):
        """Bulk import at offset (reference import, src/bmsparsevec.h:1185)."""
        self._check_writable()
        self._flush()
        values = np.asarray(values)
        n = values.size
        if n == 0:
            return self
        u = self.s2u(values)
        if offset % 32 == 0:
            self._import_aligned(u, offset)
        else:
            self._import_unaligned(u, offset)
        self._size = max(self._size, offset + n)
        if self.nullable:
            self.null_plane.set_range(offset, offset + n - 1, True)
        return self

    def _import_aligned(self, u: np.ndarray, offset: int):
        n = u.size
        n_words = -(-n // 32)
        words = _transpose(u, self._effective_slices(u), n_words,
                           self._device)
        n_sl = words.shape[0]
        nonzero = (words != 0).any(dim=1).cpu().numpy()
        word_off = offset // 32
        for s in range(n_sl):
            if not nonzero[s]:
                continue
            incoming = _bv_from_plane_words(words[s], word_off)
            if self.planes[s] is None:
                self.planes[s] = incoming
            else:
                # clear the imported range then OR the new bits
                self.planes[s].set_range(offset, offset + n - 1, False)
                self.planes[s].bit_or(incoming)
        # slices beyond the effective ones, and slices whose incoming bits
        # are all zero: clear the range
        for s in range(self.n_slices):
            if (s >= n_sl or not nonzero[s]) and self.planes[s] is not None:
                self.planes[s].set_range(offset, offset + n - 1, False)

    def _import_unaligned(self, u, offset):
        for s in range(self.n_slices):
            bit_ids = np.flatnonzero((u >> np.uint64(s)) & np.uint64(1))
            if self.planes[s] is None:
                if bit_ids.size == 0:
                    continue
                self.planes[s] = self._new_plane()
            self.planes[s].set_range(offset, offset + u.size - 1, False)
            if bit_ids.size:
                self.planes[s].set_many(bit_ids + offset)

    def _effective_slices(self, u) -> int:
        if u.size == 0:
            return 1
        m = int(np.asarray(u, np.uint64).max())
        return max(1, m.bit_length())

    def import_back(self, values):
        """Append at the end (reference import_back)."""
        self._check_writable()
        return self.import_values(values, offset=self._size)

    def extend(self, values):
        return self.import_back(values)

    # ------------------------------------------------------------------
    # element access
    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        self._flush()
        return self._size

    def __len__(self):
        return self.size

    def resize(self, n: int):
        self._check_writable()
        self._flush()
        n = int(n)
        if n < self._size:
            for p in self.planes:
                if p is not None and n > 0:
                    p.set_range(n, max(self._size - 1, n), False)
                elif p is not None:
                    p.clear()
            if self.nullable and n > 0:
                self.null_plane.set_range(n, max(self._size - 1, n), False)
            elif self.nullable:
                self.null_plane.clear()
        self._size = n
        return self

    def set(self, i, v):
        """Single set (staged; reference set, src/bmsparsevec.h)."""
        self._check_writable()
        self._staged[int(i)] = v
        if int(i) >= self._size:
            self._size = int(i) + 1
        return self

    __setitem__ = set

    def set_null(self, i):
        self._check_writable()
        if not self.nullable:
            raise ValueError("vector is not nullable")
        self._staged[int(i)] = None
        return self

    def push_back(self, v):
        return self.set(self._size, v)

    def push_back_null(self, count: int = 1):
        """Append ``count`` NULL (unassigned) elements (reference
        push_back_null, src/bmsparsevec.h:498)."""
        if not self.is_nullable():
            raise ValueError("push_back_null requires a nullable vector")
        return self.resize(self._size + int(count))

    def inc(self, i):
        """Increment element i (reference inc)."""
        self._check_writable()
        self.set(i, self.get(i) + 1)
        return self

    def add(self, i, d):
        self.set(i, self.get(i) + d)
        return self

    def is_null(self, i) -> bool:
        self._flush()
        if not self.nullable:
            return False
        return not self.null_plane.test(i)

    def get(self, i):
        self._flush()
        return self.gather(np.asarray([i]))[0]

    def __getitem__(self, i):
        return self.get(i)

    def _flush(self):
        if not self._staged:
            return
        items = sorted(self._staged.items())
        self._staged = {}
        ids = np.asarray([i for i, _ in items], _I64)
        nulls = np.asarray([v is None for _, v in items], bool)
        vals = np.asarray([0 if v is None else v for _, v in items],
                          self.dtype)
        self._write(ids, nulls, vals)

    def _write(self, ids, nulls, vals):
        """Write values (and NULLs where ``nulls``) at sorted unique ``ids``
        into the planes: the staged writes' flush."""
        u = self.s2u(vals)
        for s in range(self.n_slices):
            ones = ids[(((u >> np.uint64(s)) & np.uint64(1)) == 1) & ~nulls]
            zeros = ids[~np.isin(ids, ones, assume_unique=True)]
            if ones.size:
                if self.planes[s] is None:
                    self.planes[s] = self._new_plane()
                self.planes[s].set_many(ones)
            if zeros.size and self.planes[s] is not None:
                self.planes[s].clear_many(zeros)
        if self.nullable:
            nn = ids[~nulls]
            if nn.size:
                self.null_plane.set_many(nn)
            nz = ids[nulls]
            if nz.size:
                self.null_plane.clear_many(nz)

    # ------------------------------------------------------------------
    # bulk export (reference decode / gather, block-aligned extraction)
    # ------------------------------------------------------------------
    def gather(self, ids) -> np.ndarray:
        """Values at the given indices (reference gather): every plane's
        word of each element is read on the device and the value assembled
        there; FULL and GAP blocks are patched in on the host."""
        self._flush()
        ids = np.asarray(ids, _I64)
        dev = self._device
        word_idx = torch.from_numpy((ids & C.SET_BLOCK_MASK) >> 5).to(dev)
        bit_in = torch.from_numpy(ids & 31).to(dev)
        blocks = ids >> C.SET_BLOCK_SHIFT
        u_dev = torch.zeros(ids.shape, dtype=torch.int64, device=dev)
        for s, p in enumerate(self.planes):
            if p is None:
                continue
            p._flush()
            if p._pool.shape[0] == 0:
                continue
            st, slot = p._struct.lookup(blocks)
            sl = torch.from_numpy(np.where(st == _B, slot, -1)).to(dev)
            w = p._pool.reshape(-1)[(sl * C.SET_BLOCK_SIZE
                                     + word_idx).clamp(min=0)]
            bit = torch.where(sl < 0, 0, (w >> bit_in) & 1)
            u_dev |= bit << s
        u = u_dev.cpu().numpy().view(np.uint64)
        # host-side patch for FULL and GAP-resident blocks (rare)
        for s, p in enumerate(self.planes):
            if p is None:
                continue
            has_full = ((p._struct.cls == C.CLS_FULL).any()
                        or p._struct.has_runs)
            if not has_full and p._gaps is None:
                continue
            st, slot = p._struct.lookup(blocks)
            fm = st == _F
            if fm.any():
                u[fm] |= np.uint64(1) << np.uint64(s)
            gm = st == _G
            if gm.any():
                bits = p._gaps.test_bits(slot[gm], ids[gm] & C.SET_BLOCK_MASK)
                u[gm] |= bits.astype(np.uint64) << np.uint64(s)
        vals = self.u2s(u)
        if self.nullable:
            nm = ~self.null_plane.get_bits(ids)
            vals = np.where(nm, np.asarray(0, self.dtype), vals)
        return vals

    def decode(self, lo: int, n: int) -> np.ndarray:
        """Dense range export [lo, lo+n) (reference decode)."""
        return self.gather(np.arange(lo, lo + n, dtype=_I64))

    def to_numpy(self) -> np.ndarray:
        self._flush()
        return (self.decode(0, self._size) if self._size
                else np.zeros(0, self.dtype))

    def null_indices(self) -> np.ndarray:
        self._flush()
        if not self.nullable:
            return np.zeros(0, _I64)
        nn = self.null_plane.indices()
        return np.setdiff1d(np.arange(self._size, dtype=_I64), nn)

    def get_null_bvector(self) -> BitVector | None:
        self._flush()
        return self.null_plane

    # ------------------------------------------------------------------
    # vector algebra (reference join/merge/filter/clear_range)
    # ------------------------------------------------------------------
    def _check_device(self, other):
        if other.device != self._device:
            raise ValueError(f"vectors on different devices: {self._device} "
                             f"and {other.device}")

    def join(self, other: "SparseVector"):
        """Plane-wise OR merge (reference join, src/bmsparsevec.h:2186):
        every value slice (and the NULL slice) ORs in the argument's, so
        overlapping assigned values combine bitwise exactly as the
        reference's ``*bv |= *arg_bv`` loop does (K1 per plane)."""
        self._check_writable()
        if other.dtype != self.dtype:
            raise ValueError("dtype mismatch")
        self._check_device(other)
        self._flush()
        other._flush()
        if other._size > self._size:
            self._size = other._size
        for j, p in enumerate(other.planes):
            if p is not None:
                mine = self.planes[j]
                if mine is None:
                    self.planes[j] = p.copy()
                else:
                    mine.bit_or(p)
        if self.nullable:
            if other.nullable:
                self.null_plane.bit_or(other.null_plane)
            elif other._size:
                # argument assumed all-real (reference join_null_slice)
                self.null_plane.set_range(0, other._size - 1, True)
        elif other.nullable:
            # a non-nullable target adopts the argument's NULL slice
            # (reference join_null_slice, src/bmsparsevec.h:2238-2243)
            self.nullable = True
            self.null_plane = other.null_plane.copy()
        return self

    def merge(self, other: "SparseVector"):
        """join + clear other (reference merge, src/bmsparsevec.h:2217)."""
        self.join(other)
        other.clear()
        return self

    def end(self):
        """Invalid const_iterator sentinel (reference end(); compares
        equal to any exhausted iterator over this vector)."""
        it = self.get_const_iterator(0)
        it.invalidate()
        return it

    def find_rank(self, rank: int) -> int:
        """Dense address space: the rank-th element is position rank-1
        (reference sparse_vector::find_rank, src/bmsparsevec.h:2110)."""
        rank = int(rank)
        if rank < 1:
            raise ValueError("rank is 1-based")
        return rank - 1

    def sync(self, force: bool = False):
        """Structure sync (reference sync; the deferred state here is only
        the staged writes: flush them)."""
        self._flush()
        return self

    def sync_size(self):
        return self.sync()

    def is_remap(self) -> bool:
        """Only string vectors remap (reference base is_remap)."""
        return False

    def filter(self, keep: BitVector):
        """Zero out (and NULL) all positions not in keep (reference
        filter): one AND per plane."""
        self._check_writable()
        self._flush()
        for p in self.planes:
            if p is not None:
                p.bit_and(keep)
        if self.nullable:
            self.null_plane.bit_and(keep)
        return self

    keep = filter

    def insert(self, i, v):
        """Insert value at i, shifting elements right (reference
        sparse_vector insert, src/bmsparsevec.h): every plane
        insert-shifts; the NULL plane marks i assigned."""
        self._check_writable()
        self._flush()
        i = int(i)
        for p in self.planes:
            if p is not None:
                p.insert(i, False)
        if self.nullable:
            self.null_plane.insert(i, False)
        self._size += 1
        self.set(i, v)
        return self

    def erase(self, i):
        """Erase element i, shifting elements left (reference erase,
        src/bmsparsevec.h)."""
        self._check_writable()
        self._flush()
        i = int(i)
        for p in self.planes:
            if p is not None:
                p.erase(i)
        if self.nullable:
            self.null_plane.erase(i)
        if self._size:
            self._size -= 1
        return self

    def copy_range(self, other: "SparseVector", lo, hi):
        """Copy [lo, hi] from another vector of the same dtype, clearing
        everything else (reference copy_range, src/bmsparsevec.h)."""
        self._check_writable()
        other._flush()
        self._flush()
        if other.dtype != self.dtype:
            raise ValueError("dtype mismatch")
        self._check_device(other)
        lo, hi = int(lo), int(hi)
        self.planes = [None] * len(self.planes)
        for s, p in enumerate(other.planes[:len(self.planes)]):
            if p is not None:
                bv = BitVector(p.size, device=self._device)
                bv.copy_range(p, lo, hi)
                self.planes[s] = bv
        if self.nullable:
            src_null = other.null_plane
            if src_null is None:
                src_null = self._new_plane()
                if other._size:
                    src_null.set_range(0, other._size - 1)
            bv = BitVector(src_null.size, device=self._device)
            bv.copy_range(src_null, lo, hi)
            self.null_plane = bv
        self._size = other._size
        return self

    def at(self, i):
        """Bounds-checked access (reference at, src/bmsparsevec.h)."""
        if not (0 <= int(i) < self._size):
            raise IndexError(i)
        return self.get(i)

    def try_get(self, i):
        """(found, value) pair; found is False at NULL positions
        (reference try_get, src/bmsparsevec.h:473)."""
        self._flush()
        if self.nullable and not self.null_plane.test(i):
            return False, self.dtype.type(0)
        return True, self.get(i)

    def compare(self, i, val) -> int:
        """Three-way compare of element i against a value: -1/0/1
        (reference compare, src/bmsparsevec.h:778)."""
        mine = self.get(i)
        val = self.dtype.type(val)
        return int(mine > val) - int(mine < val)

    def is_nullable(self) -> bool:
        return self.nullable

    def swap(self, a, b=None):
        """Container swap (one arg, reference src/bmsparsevec.h:695) or
        element swap of positions a and b (two args, :525)."""
        if b is None:
            if not isinstance(a, SparseVector):
                raise TypeError("swap(other) needs a SparseVector")
            self._flush()
            a._flush()
            self.__dict__, a.__dict__ = a.__dict__, self.__dict__
            return self
        va, vb = self.get(a), self.get(b)
        na = self.nullable and not self.null_plane.test(a)
        nb = self.nullable and not self.null_plane.test(b)
        self.set_null(a) if nb else self.set(a, vb)
        self.set_null(b) if na else self.set(b, va)
        return self

    def keep_range(self, lo, hi):
        """Zero (and NULL) everything outside [lo, hi] (reference
        keep_range, src/bmsparsevec.h:883)."""
        self._check_writable()
        self._flush()
        rng = self._new_plane()
        rng.set_range(int(lo), int(hi))
        return self.filter(rng)

    def extract(self, n, offset=0):
        """Dense export of n values from offset (reference extract)."""
        return self.decode(int(offset), int(n))

    def extract_range(self, lo, hi):
        """Values of [lo, hi] inclusive (reference extract_range)."""
        return self.decode(int(lo), int(hi) - int(lo) + 1)

    def optimize_gap_size(self):
        """Per-plane GAP level tuning (reference optimize_gap_size)."""
        self._flush()
        for p in self.planes:
            if p is not None:
                p.optimize_gap_size()
        if self.nullable:
            self.null_plane.optimize_gap_size()
        return self

    # -- iterators (reference const_iterator / back_insert_iterator) ----
    def get_const_iterator(self, pos: int = 0):
        """Window-buffered iterator (reference get_const_iterator,
        src/bmsparsevec.h:571-580)."""
        from .iterators import ConstIterator
        self._flush()
        return ConstIterator(self, pos)

    def begin(self):
        return self.get_const_iterator(0)

    def get_back_inserter(self):
        """Buffered appender: add/add_null/flush land bulk imports
        (reference get_back_inserter, src/bmsparsevec.h:587)."""
        from .iterators import BackInsertIterator
        self._flush()
        return BackInsertIterator(self)

    def _append_bulk(self, buf):
        """Back-inserter flush sink: one bulk import per flush; None
        entries become NULL positions."""
        has_null = any(v is None for v in buf)
        if has_null and not self.nullable:
            raise ValueError("add_null on a non-nullable vector")
        off = self._size
        vals = np.asarray([0 if v is None else v for v in buf], self.dtype)
        self.import_values(vals, offset=off)
        if has_null:
            nulls = np.flatnonzero([v is None for v in buf]) + off
            self.null_plane.clear_many(nulls.astype(_I64))

    def empty(self) -> bool:
        return self._size == 0

    def effective_size(self) -> int:
        return self._size

    def is_compressed(self) -> bool:
        return False

    def is_str(self) -> bool:
        return False

    def clear_range(self, lo, hi, set_null: bool = False):
        """Zero values in [lo, hi]; set_null also unassigns them
        (reference default is false, src/bmsparsevec.h:715)."""
        self._check_writable()
        self._flush()
        for p in self.planes:
            if p is not None:
                p.set_range(lo, hi, False)
        if self.nullable and set_null:
            self.null_plane.set_range(lo, hi, False)
        return self

    def clear(self):
        self._check_writable()
        self._staged = {}
        self.planes = [None] * self.n_slices
        if self.nullable:
            self.null_plane = self._new_plane()
        self._size = 0
        return self

    clear_all = clear       # reference alias (src/bmsparsevec.h)

    # ------------------------------------------------------------------
    def optimize(self):
        self._flush()
        for p in self.planes:
            if p is not None:
                p.optimize()
        if self.nullable:
            self.null_plane.optimize()
        return self

    def calc_stat(self) -> dict:
        self._flush()
        st = {"bit_blocks": 0, "full_blocks": 0, "memory_used": 0,
              "planes": sum(p is not None for p in self.planes)}
        for p in self.planes:
            if p is not None:
                s = p.calc_stat()
                for k in ("bit_blocks", "full_blocks", "memory_used"):
                    st[k] += s[k]
        return st

    def equal(self, other: "SparseVector") -> bool:
        self._flush()
        other._flush()
        if self._size != other._size:
            return False
        if self._size == 0:
            return True
        return bool(np.array_equal(self.to_numpy(), other.to_numpy()) and
                    (not (self.nullable and other.nullable) or
                     self.null_plane.equal(other.null_plane)))

    def _check_writable(self):
        check_writable(self)

    def freeze(self):
        self._flush()
        for p in self.planes:
            if p is not None:
                p.freeze()
        if self.nullable:
            self.null_plane.freeze()
        self._ro = True
        return self

    def is_ro(self) -> bool:
        """src/bmbmatrix.h is_ro()."""
        return self._ro

    def effective_slices(self) -> int:
        self._flush()
        n = 0
        for s, p in enumerate(self.planes):
            if p is not None and p.any():
                n = s + 1
        return n

    def plane(self, s: int) -> BitVector | None:
        self._flush()
        return self.planes[s]

    def __iter__(self):
        return iter(self.to_numpy())

    def __repr__(self):
        return (f"SparseVector(dtype={self.dtype}, size={self._size}, "
                f"planes={sum(p is not None for p in self.planes)}, "
                f"device={self._device})")
