"""Succinct bit-vector container on PyTorch (port of
``bitmagic_tpu/core/bitvector.py``).

Functional equivalent of the reference ``bm::bvector<>`` (src/bm.h:114): a
block-structured compressed bitset with set algebra, counts and
rank/select:

  * host-side numpy metadata describes which 64K-bit blocks exist and their
    class (ZERO / FULL / BIT / GAP); ZERO and FULL occupy no storage — the
    analog of NULL pointers and the FULL_BLOCK_FAKE_ADDR sentinel
    (src/bmdef.h:165-170); wide FULL spans are interval runs;
  * all dense payload lives in ONE device tensor ``int32[n_rows, 2048]``
    on the vector's ``device``; GAP blocks live on the host (GapStore);
  * binary ops plan symbolically on host (FULL/ZERO algebra) and execute
    the dense part as ONE gather-fused kernel launch (K1, ``_binary``);
  * single-bit mutations are staged host-side and flushed as bulk scatters
    (the reference likewise steers users to bulk import, src/bm.h:1133).

Every entry point runs on the card unless ``device="cpu"`` is given (or
``config.device`` says so).  Addressing is 48-bit capable end-to-end
(int64 indices on the host; only in-block offsets reach the device).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import constants as C
from ..config import config, resolve_device
from ..ops import blockops
from ..ops import cuda_kernels as ck
from ..ops.bitops import popcount, u32_to_i32
from ..ops.blockops import full_block_np, to_device_words
from .blocks import (RUN_MIN, Structure, descent_codes, descriptor_pair,
                     operand_args, plan_binary, plane_table, points_in_runs,
                     runs_clip, runs_diff, runs_intersect, runs_normalize,
                     runs_overlap_bits, runs_subtract_points, runs_union,
                     split_runs)
from .gapstore import GapStore, compress_rows, from_positions

_I64 = np.int64


def _as_blocks(ids):
    return ids >> C.SET_BLOCK_SHIFT


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, _I64)).to(device)


def _unique_ids(ids) -> np.ndarray:
    """Sorted unique int64 ids, by one sort.  Newer numpy may answer
    ``np.unique`` with a hash table: in chip_smoke.py's main path on an H100
    machine, ``from_indices`` of 8.4M random ids took 9.7 s with
    ``np.unique`` and 0.6 s with this sort."""
    ids = np.sort(np.asarray(ids, _I64).ravel())
    if ids.size > 1:
        ids = ids[np.concatenate([[True], ids[1:] != ids[:-1]])]
    return ids


def _block_index(ids: np.ndarray):
    """(ub, inv) of ``np.unique(ids >> 16, return_inverse=True)`` for
    sorted ids, in one linear pass."""
    blocks = _as_blocks(ids)
    new = np.ones(blocks.size, bool)
    new[1:] = blocks[1:] != blocks[:-1]
    return blocks[new], np.cumsum(new) - 1


class ReadOnlyError(RuntimeError):
    pass


def check_writable(obj, what: str = "container"):
    """Shared eager read-only guard: every frozen container rejects writes
    at the call site (reference RO semantics)."""
    if getattr(obj, "_ro", False):
        raise ReadOnlyError(f"{what} is read-only (frozen)")


class BitVector:
    """Block-structured succinct bit-vector (bm::bvector equivalent)."""

    def __init__(self, size: int = C.ID_MAX32, strategy=None,
                 device=None):
        self._device = resolve_device(device)
        self._size = int(size)
        self._struct = Structure.empty()
        self._pool = blockops.zero_pool(0, self._device)
        self._host = None         # (weakref to _pool, its host copy)
        self._gaps = None         # GapStore for CLS_GAP entries (nb order)
        self._staged: dict[int, bool] = {}
        self._ro = False
        self._rs = None           # cached RSIndex
        self._glevel = tuple(config.gap_levels)
        self.strategy = config.strategy if strategy is None else strategy

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def _from_parts(cls, struct: Structure, pool, size: int, gaps=None,
                    device=None):
        """``pool``: a device tensor, or host uint32 rows uploaded to
        ``device``."""
        bv = cls.__new__(cls)
        if isinstance(pool, np.ndarray):
            bv._device = resolve_device(device)
            pool = to_device_words(pool, bv._device)
        else:
            bv._device = pool.device
        bv._size = int(size)
        bv._struct = struct
        bv._pool = pool
        bv._host = None
        bv._gaps = gaps
        bv._staged = {}
        bv._ro = False
        bv._rs = None
        bv._glevel = tuple(config.gap_levels)
        bv.strategy = C.BM_BIT
        return bv

    @classmethod
    def from_indices(cls, ids, size: int = C.ID_MAX32, strategy=None,
                     device=None):
        """Bulk build from sorted-or-not bit ids (reference bulk set,
        src/bm.h:1133).  With strategy=BM_GAP the blocks are built DIRECTLY
        as succinct D-GAP runs on the host (reference check_allocate_block
        under BM_GAP, src/bmblocks.h:1076; blocks whose run count overflows
        the top GAP level fall back to dense).  Without a strategy it
        takes ``config.strategy``."""
        dev = resolve_device(device)
        if strategy is None:
            strategy = config.strategy
        ids = _unique_ids(ids)
        if ids.size and (ids[0] < 0 or ids[-1] >= size):
            raise IndexError("bit id out of range")
        if strategy == C.BM_GAP and ids.size:
            return cls._from_indices_gap(ids, size, dev)
        struct, pool = _pool_from_ids(ids, dev)
        bv = cls._from_parts(struct, pool, size)
        bv.strategy = strategy
        return bv

    @classmethod
    def _from_indices_gap(cls, ids: np.ndarray, size: int, dev):
        ub, inv = _block_index(ids)
        store, bc = from_positions(inv.astype(_I64),
                                   (ids & C.SET_BLOCK_MASK).astype(_I64))
        glevel = tuple(config.gap_levels)
        full = bc == C.BITS_PER_BLOCK
        too_big = (store.gap_lens() > glevel[-1] - 4) & ~full
        gap_keep = ~full & ~too_big
        cls_arr = np.full(ub.size, C.CLS_GAP, np.uint8)
        cls_arr[full] = C.CLS_FULL
        cls_arr[too_big] = C.CLS_BIT
        pool = (store.to_dense(np.flatnonzero(too_big))
                if too_big.any()
                else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
        gaps_store = (store.subset(np.flatnonzero(gap_keep))
                      if gap_keep.any() else None)
        bv = cls._from_parts(Structure(ub.astype(_I64), cls_arr), pool,
                             size, gaps_store, device=dev)
        bv.strategy = C.BM_GAP
        return bv

    @classmethod
    def from_bools(cls, bools, size=None, device=None):
        bools = np.asarray(bools, bool)
        size = bools.size if size is None else size
        return cls.from_indices(np.flatnonzero(bools), size, device=device)

    @classmethod
    def from_words(cls, words, size=None, device=None):
        """Import from a raw dense uint32 word image, LSB-first
        (reference bm::bit_import_u32, src/bmbvimport.h)."""
        w = np.asarray(words, np.uint32).reshape(-1)
        if size is None:
            size = w.size * 32
        nblk = C.blocks_for_bits(w.size * 32)
        pad = np.zeros(nblk * C.SET_BLOCK_SIZE, np.uint32)
        pad[: w.size] = w
        struct = Structure(np.arange(nblk, dtype=_I64),
                           np.full(nblk, C.CLS_BIT, np.uint8))
        bv = cls._from_parts(struct, pad.reshape(nblk, C.SET_BLOCK_SIZE),
                             size, device=device)
        bv._drop_trailing(size)
        return bv

    def copy(self) -> "BitVector":
        """Independent copy (the pool tensor is shared: no operation of the
        port writes a pool in place)."""
        self._flush()
        return BitVector._from_parts(
            Structure(self._struct.nb.copy(), self._struct.cls.copy(),
                      self._struct.runs.copy()),
            self._pool, self._size, self._gaps)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def size(self) -> int:
        return self._size

    def resize(self, new_size: int):
        """Reference resize (src/bm.h:1306): bits at and above a smaller
        size are dropped."""
        self._check_writable()
        self._flush()
        new_size = int(new_size)
        if new_size < self._size:
            self._drop_trailing(new_size)
        self._size = new_size
        self._dirty()
        return self

    def _pool_host(self) -> np.ndarray:
        """Host uint32 view of the dense rows: one device-to-host copy per
        pool tensor, kept while the vector holds that tensor.  No operation
        of the port writes a pool in place; every change installs a new
        tensor, which misses the cache.  Callers must not write to it."""
        pool = self._pool
        if self._host is None or self._host[0]() is not pool:
            self._host = (weakref.ref(pool), blockops.to_host_words(pool))
        return self._host[1]

    def _drop_trailing(self, size):
        """Clear any bits at positions >= size."""
        if size <= 0:
            self._struct = Structure.empty()
            self._pool = blockops.zero_pool(0, self._device)
            return
        last_blk = (size - 1) >> C.SET_BLOCK_SHIFT
        if self._struct.has_runs:
            clipped = runs_clip(self._struct.runs, 0, last_blk + 1)
            if clipped.shape[0] != self._struct.runs.shape[0] or (
                    clipped.size and not np.array_equal(
                        clipped, self._struct.runs)):
                self._struct = Structure(self._struct.nb,
                                         self._struct.cls, clipped)
        keep = self._struct.nb <= last_blk
        if not keep.all():
            self._select_blocks(keep)
        tail_bits = size & C.SET_BLOCK_MASK
        if tail_bits == 0:
            return
        if self._struct.has_runs and points_in_runs(
                np.asarray([last_blk], _I64), self._struct.runs)[0]:
            # split the run: the tail block becomes one masked dense row
            # (runs are disjoint from nb, so it appends past all entries)
            new_runs = runs_subtract_points(self._struct.runs,
                                            np.asarray([last_blk], _I64))
            row = to_device_words(_tail_mask_np(tail_bits)[None, :],
                                  self._device)
            self._pool = torch.cat([self._pool, row], dim=0)
            self._struct = Structure(
                np.concatenate([self._struct.nb, [last_blk]]).astype(_I64),
                np.concatenate([self._struct.cls,
                                [C.CLS_BIT]]).astype(np.uint8),
                new_runs)
            return
        pos = np.searchsorted(self._struct.nb, last_blk)
        if pos < len(self._struct.nb) and self._struct.nb[pos] == last_blk:
            if self._struct.cls[pos] == C.CLS_FULL:
                self._materialize_block(pos)     # FULL tail -> masked BIT
            elif self._struct.cls[pos] == C.CLS_GAP:
                sel = np.zeros(len(self._struct.nb), bool)
                sel[pos] = True
                self._deoptimize_gaps(sel)
            slot = int(self._struct.slots()[pos])
            m = to_device_words(_tail_mask_np(tail_bits), self._device)
            pool = self._pool.clone()
            pool[slot] &= m
            self._pool = pool

    def _select_blocks(self, keep_mask: np.ndarray):
        """Keep only metadata entries where keep_mask; rebuild pool rows."""
        slots = self._struct.slots()
        rows = slots[keep_mask & (self._struct.cls == C.CLS_BIT)]
        self._pool = self._pool[_index(rows, self._device)]
        if self._gaps is not None:
            gkeep = self._struct.gslots()[
                keep_mask & (self._struct.cls == C.CLS_GAP)]
            self._gaps = self._gaps.subset(gkeep) if gkeep.size else None
        self._struct = Structure(self._struct.nb[keep_mask].copy(),
                                 self._struct.cls[keep_mask].copy(),
                                 self._struct.runs)

    def _materialize_block(self, pos: int):
        """Convert the FULL block at metadata position pos into a dense row
        (the deoptimize_block analog, src/bmblocks.h:1574)."""
        insert_row = int(np.sum(self._struct.cls[:pos] == C.CLS_BIT))
        full_row = torch.full((1, C.SET_BLOCK_SIZE), -1, dtype=torch.int32,
                              device=self._device)
        self._pool = torch.cat([self._pool[:insert_row], full_row,
                                self._pool[insert_row:]], dim=0)
        cls = self._struct.cls.copy()
        cls[pos] = C.CLS_BIT
        self._struct = Structure(self._struct.nb, cls, self._struct.runs)

    # ------------------------------------------------------------------
    # GAP residency helpers
    # ------------------------------------------------------------------
    def _gap_bc(self) -> np.ndarray:
        """Set-bit count per GAP block (store order)."""
        return (self._gaps.popcounts() if self._gaps is not None
                else np.zeros(0, _I64))

    def _deoptimize_gaps(self, sel=None):
        """Convert GAP blocks back to dense pool rows (content preserved;
        deoptimize_block analog, src/bmblocks.h:1574).  ``sel``: bool mask
        over metadata entries (None = all GAP blocks)."""
        if self._gaps is None:
            return
        is_gap = self._struct.cls == C.CLS_GAP
        conv = is_gap if sel is None else (is_gap & sel)
        if not conv.any():
            return
        gslots = self._struct.gslots()
        rows = to_device_words(self._gaps.to_dense(gslots[conv]),
                               self._device)
        # new pool order follows nb order of BIT + converted GAP entries
        is_bit = self._struct.cls == C.CLS_BIT
        new_bit = is_bit | conv
        src = np.empty(int(new_bit.sum()), _I64)
        n_pool = int(is_bit.sum())
        was_bit = is_bit[new_bit]
        src[was_bit] = self._struct.slots()[is_bit]
        src[~was_bit] = n_pool + np.argsort(np.argsort(gslots[conv]))
        combined = torch.cat([self._pool, rows], dim=0)
        self._pool = combined[_index(src, self._device)]
        keep_gap = is_gap & ~conv
        self._gaps = (self._gaps.subset(gslots[keep_gap])
                      if keep_gap.any() else None)
        new_cls = self._struct.cls.copy()
        new_cls[conv] = C.CLS_BIT
        self._struct = Structure(self._struct.nb, new_cls,
                                 self._struct.runs)
        self._rs = None

    def _block_words_host(self, k: int) -> np.ndarray:
        """Dense uint32[2048] content of metadata entry k (host copy)."""
        cls_k = self._struct.cls[k]
        if cls_k == C.CLS_FULL:
            return full_block_np()
        if cls_k == C.CLS_GAP:
            return self._gaps.to_dense(
                np.asarray([self._struct.gslots()[k]]))[0]
        return self._row_host(self._struct.slots()[k])

    def _snapshot_with_runs(self):
        """(nb, cls in {FULL, BIT}, words[n_bit_rows, 2048], runs): the
        point-entry dense view serializers read, FULL runs left as runs
        (serializing a succinct vector never expands its compact spans).
        GAP blocks expand on the host; the rows are one host copy of the
        pool, fetched on each call."""
        self._flush()
        struct = self._struct
        if self._gaps is None:
            words = (self._pool_host()
                     if (struct.cls == C.CLS_BIT).any()
                     else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
            return struct.nb, struct.cls, words, struct.runs
        cls2 = np.where(struct.cls == C.CLS_GAP, C.CLS_BIT,
                        struct.cls).astype(np.uint8)
        words = np.zeros((int((cls2 == C.CLS_BIT).sum()), C.SET_BLOCK_SIZE),
                         np.uint32)
        dst = np.cumsum(cls2 == C.CLS_BIT) - 1
        bitm = struct.cls == C.CLS_BIT
        if bitm.any():
            words[dst[bitm]] = self._pool_host()[struct.slots()[bitm]]
        words[dst[struct.cls == C.CLS_GAP]] = self._gaps.to_dense()
        return struct.nb, cls2, words, struct.runs

    def _dense_snapshot(self):
        """(nb, cls in {FULL, BIT}, words[n_bit_rows, 2048]) in nb order:
        the flat per-block dense view (FULL runs expand to per-block FULL
        entries, with no dense rows)."""
        nb, cls, words, runs = self._snapshot_with_runs()
        if runs.shape[0]:
            st = Structure(nb, cls, runs).materialized()
            return st.nb, st.cls, words
        return nb, cls, words

    # ------------------------------------------------------------------
    # single-bit mutation (staged; reference set_bit src/bm.h:1074)
    # ------------------------------------------------------------------
    def _check_writable(self):
        check_writable(self, "bit-vector")

    def _dirty(self):
        self._rs = None

    def set(self, i, val: bool = True):
        self._check_writable()
        i = int(i)
        if not (0 <= i < self._size):
            raise IndexError(f"bit {i} out of range [0, {self._size})")
        self._staged[i] = bool(val)
        self._dirty()
        return self

    set_bit = set

    def clear_bit(self, i):
        return self.set(i, False)

    def flip_bit(self, i):
        self.set(i, not self.test(i))
        return self

    def set_bit_conditional(self, i, val, condition):
        """Set bit i to val only if its current value equals ``condition``
        (reference src/bm.h:1082).  Returns True if changed."""
        cur = self.test(i)
        if cur == bool(condition) and cur != bool(val):
            self.set(i, val)
            return True
        return False

    def set_bit_and(self, i, val=True):
        """AND bit i with val; returns the resulting bit (reference
        :1104)."""
        cur = self.test(i)
        new = cur and bool(val)
        if new != cur:
            self.set(i, new)
        return new

    def inc(self, i) -> bool:
        """Increment bit i (flip); returns the carry, i.e. the OLD value
        (reference src/bm.h:1094)."""
        old = self.test(i)
        self.set(i, not old)
        return old

    def swap_bits(self, i, j):
        """Swap bits i and j (reference swap(idx1, idx2), src/bm.h:1170)."""
        bi, bj = self.test(i), self.test(j)
        if bi != bj:
            self.set(i, bj)
            self.set(j, bi)
        return self

    def __setitem__(self, i, val):
        self.set(i, val)

    def _flat_nb(self) -> np.ndarray:
        """Sorted per-block ids including run-covered blocks (the flat
        candidate list of aggregator arenas and SV planes); very wide runs
        raise MemoryError instead of expanding."""
        if not self._struct.has_runs:
            return self._struct.nb
        return self._struct.materialized().nb

    def _materialize_runs(self):
        """Replace runs with flat per-block FULL entries (bounded)."""
        if self._struct.has_runs:
            self._struct = self._struct.materialized()
            self._dirty()

    def _flush(self):
        if not self._staged:
            return
        items = self._staged
        self._staged = {}
        ids = np.fromiter(items.keys(), _I64, len(items))
        vals = np.fromiter(items.values(), bool, len(items))
        set_ids, clr_ids = ids[vals], ids[~vals]
        if set_ids.size:
            self._ior(BitVector.from_indices(set_ids, self._size,
                                             strategy=self.strategy,
                                             device=self._device))
        if clr_ids.size:
            self._isub(BitVector.from_indices(clr_ids, self._size,
                                              strategy=self.strategy,
                                              device=self._device))

    # ------------------------------------------------------------------
    # bulk mutation
    # ------------------------------------------------------------------
    def _bulk_operand(self, ids) -> "BitVector":
        return BitVector.from_indices(ids, self._size,
                                      strategy=self.strategy,
                                      device=self._device)

    def set_many(self, ids):
        """Bulk OR of bit ids (reference set(ids,n), src/bm.h:1133)."""
        self._check_writable()
        self._flush()
        self._ior(self._bulk_operand(ids))
        return self

    def clear_many(self, ids):
        """Bulk clear of bit ids (reference clear(ids,n), src/bm.h:1161)."""
        self._check_writable()
        self._flush()
        self._isub(self._bulk_operand(ids))
        return self

    def keep(self, ids):
        """Keep only listed bits (reference keep(ids,n), src/bm.h:1147)."""
        self._check_writable()
        self._flush()
        self._iand(self._bulk_operand(ids))
        return self

    def import_sorted(self, ids):
        """Bulk set of SORTED indices (reference import_sorted,
        src/bm.h:2080; duplicates are legal)."""
        ids = np.asarray(ids, _I64)
        if ids.size and (np.diff(ids) < 0).any():
            raise ValueError("import_sorted needs non-decreasing ids")
        return self.set_many(np.unique(ids) if ids.size else ids)

    def move_from(self, other: "BitVector"):
        """Adopt other's content, leaving it empty (reference move_from,
        src/bm.h:2342; self-move is a no-op)."""
        if other is self:
            return self
        self._check_writable()
        other._check_writable()
        other._flush()
        self._flush()
        self.__dict__, other.__dict__ = other.__dict__, self.__dict__
        other.clear()
        return self

    def swap(self, other: "BitVector"):
        """Exchange contents with other (reference swap, src/bm.h); the GAP
        level table and the block strategy stay with each object."""
        for attr in ("_size", "_struct", "_pool", "_device", "_gaps",
                     "_staged", "_ro", "_rs"):
            a, b = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, b)
            setattr(other, attr, a)
        return self

    def init(self):
        """Explicit init for deferred-construction parity (reference
        bvector::init; storage here is always initialized)."""
        return self

    # ------------------------------------------------------------------
    # range mutation
    # ------------------------------------------------------------------
    def set_range(self, lo, hi, val: bool = True):
        """Set/clear inclusive bit range (reference src/bm.h:1201)."""
        self._check_writable()
        self._flush()
        lo, hi = int(lo), int(hi)
        if hi < lo:
            return self
        if not (0 <= lo and hi < self._size):
            raise IndexError("range out of bounds")
        if val:
            self._ior(_range_vector(lo, hi, self._size, self._device))
        else:
            # clearing only touches blocks this vector already has
            self._isub(_range_vector(lo, hi, self._size, self._device,
                                     within=self._struct))
        return self

    def clear_range(self, lo, hi):
        """Clear inclusive bit range (reference clear_range,
        src/bm.h:1222)."""
        return self.set_range(lo, hi, False)

    def copy_range(self, other: "BitVector", lo, hi):
        """Copy bits [lo, hi] from other, zero everything else
        (reference src/bm.h:1238)."""
        self._check_writable()
        other._flush()
        lo, hi = int(lo), int(hi)
        if lo > hi:
            lo, hi = hi, lo
        rng = _range_vector(lo, hi, other._size, other._device,
                            within=other._struct)
        self._adopt(_binary(other, rng, "and"))
        return self

    def clear(self, free_mem: bool = True):
        self._check_writable()
        self._staged = {}
        self._struct = Structure.empty()
        self._pool = blockops.zero_pool(0, self._device)
        self._gaps = None
        self._dirty()
        return self

    def reset(self):
        return self.clear()

    def invert(self):
        """Flip all bits in [0, size) (reference src/bm.h:1837).
        O(own structure) for any address span: absent spans become FULL
        runs, FULL entries and runs drop, BIT rows complement on the
        device, GAP blocks complement their run lists on the host."""
        self._check_writable()
        self._flush()
        nblk = C.blocks_for_bits(self._size)
        st = self._struct
        pts_iv = (np.stack([st.nb, st.nb + 1], axis=1)
                  if st.nb.size else np.zeros((0, 2), _I64))
        present = runs_normalize(np.concatenate([pts_iv, st.runs]))
        absent = runs_diff(np.asarray([[0, nblk]], _I64), present)
        new_runs, full_pts = split_runs(absent, RUN_MIN)
        bitm = st.cls == C.CLS_BIT
        gapm = st.cls == C.CLS_GAP
        rows = st.slots()[bitm]
        pool = (~self._pool[_index(rows, self._device)] if rows.size
                else blockops.zero_pool(0, self._device))
        gaps = None
        if self._gaps is not None and gapm.any():
            gaps = self._gaps.complement()
        nb = np.concatenate([st.nb[bitm | gapm], full_pts])
        cls = np.concatenate([st.cls[bitm | gapm],
                              np.full(full_pts.size, C.CLS_FULL, np.uint8)])
        order = np.argsort(nb, kind="stable")
        self._struct = Structure(nb[order], cls[order], new_runs)
        self._pool = pool
        self._gaps = gaps
        self._drop_trailing(self._size)
        self._dirty()
        return self

    def __invert__(self):
        return self.copy().invert()

    def flip(self, i=None):
        """flip(i): invert one bit; flip(): invert the whole vector (the
        reference's two overloads, src/bm.h:1188, :1845)."""
        return self.invert() if i is None else self.flip_bit(i)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def test(self, i) -> bool:
        i = int(i)
        if i in self._staged:
            return self._staged[i]
        if not (0 <= i < self._size):
            return False
        return bool(self.get_bits(np.asarray([i]))[0])

    get_bit = test

    def __getitem__(self, i):
        return self.test(i)

    def get_bits(self, ids) -> np.ndarray:
        """Batch bit test -> bool[n]."""
        self._flush()
        ids = np.asarray(ids, _I64)
        st, slot = self._struct.lookup(_as_blocks(ids))
        out = st == 1          # FULL
        bitq = st == 2
        if bitq.any():
            flat = (slot[bitq] * C.SET_BLOCK_SIZE
                    + ((ids[bitq] & C.SET_BLOCK_MASK) >> 5))
            words = blockops.to_host_words(
                self._pool.reshape(-1)[_index(flat, self._device)])
            out[bitq] = (words >> (ids[bitq] & 31).astype(np.uint32)) & 1
        gapq = st == 3
        if gapq.any():
            out[gapq] = self._gaps.test_bits(slot[gapq],
                                             ids[gapq] & C.SET_BLOCK_MASK)
        return out

    def any(self) -> bool:
        self._flush()
        if self._struct.has_runs:
            return True
        if (self._struct.cls == C.CLS_FULL).any():
            return True
        if self._gaps is not None and (self._gap_bc() > 0).any():
            return True
        if not (self._struct.cls == C.CLS_BIT).any():
            return False
        return bool((self._pool != 0).any())

    def none(self) -> bool:
        return not self.any()

    def empty(self) -> bool:
        return self._size == 0

    def count(self) -> int:
        """Global popcount (reference src/bm.h:1320): per-block counts of
        the dense rows on the device (K3), the rest from metadata."""
        self._flush()
        full = int((self._struct.cls == C.CLS_FULL).sum()) * C.BITS_PER_BLOCK
        full += self._struct.run_block_count() * C.BITS_PER_BLOCK
        full += int(self._gap_bc().sum())     # GAP blocks answer on host
        if not (self._struct.cls == C.CLS_BIT).any():
            return full
        # K3 sums the int32 per-block counts into one int64 in its launch
        return full + int(ck.block_counts_total(self._pool)[0])

    def count_blocks(self) -> np.ndarray:
        """Running (cumulative) per-block popcounts up to the last present
        block (reference count_blocks, src/bm.h:1328/2637)."""
        self._flush()
        if self._struct.nb.size == 0 and not self._struct.has_runs:
            return np.zeros(0, np.int64)
        last = int(self._struct.nb[-1]) if self._struct.nb.size else -1
        if self._struct.has_runs:
            last = max(last, int(self._struct.runs[-1, 1]) - 1)
        if last + 1 > (1 << 26):
            raise MemoryError("count_blocks() on an address span this "
                              "large would materialize too much metadata; "
                              "use build_rs_index()/count_to instead")
        per = np.zeros(last + 1, np.int64)
        for s, e in self._struct.runs:
            per[s:min(e, last + 1)] = C.BITS_PER_BLOCK
        full = self._struct.cls == C.CLS_FULL
        per[self._struct.nb[full]] = C.BITS_PER_BLOCK
        gapm = self._struct.cls == C.CLS_GAP
        if gapm.any():
            per[self._struct.nb[gapm]] = self._gap_bc()
        bitm = self._struct.cls == C.CLS_BIT
        if bitm.any():
            cnt = ck.block_counts(self._pool).cpu().numpy().astype(np.int64)
            per[self._struct.nb[bitm]] = cnt[self._struct.slots()[bitm]]
        return np.cumsum(per)

    def count_range(self, lo, hi) -> int:
        """popcount of closed range [lo, hi] (reference src/bm.h:1341)."""
        self._flush()
        lo, hi = int(lo), int(hi)
        hi = min(hi, self._size - 1)
        if hi < lo:
            return 0
        b_lo, b_hi = lo >> C.SET_BLOCK_SHIFT, hi >> C.SET_BLOCK_SHIFT
        inside = (self._struct.nb >= b_lo) & (self._struct.nb <= b_hi)
        total = runs_overlap_bits(self._struct.runs, lo, hi,
                                  C.SET_BLOCK_SHIFT)
        # FULL blocks: overlap length with [lo, hi]
        for nb in self._struct.nb[inside & (self._struct.cls == C.CLS_FULL)]:
            base = int(nb) << C.SET_BLOCK_SHIFT
            total += min(hi, base + C.BITS_PER_BLOCK - 1) - max(lo, base) + 1
        # GAP blocks: host run arithmetic (gap_bit_count_range analog)
        gapm = inside & (self._struct.cls == C.CLS_GAP)
        if gapm.any():
            gsl = self._struct.gslots()[gapm]
            base = self._struct.nb[gapm].astype(_I64) * C.BITS_PER_BLOCK
            lo_rel = np.clip(lo - base, 0, C.BITS_PER_BLOCK - 1)
            hi_rel = np.clip(hi - base, -1, C.BITS_PER_BLOCK - 1)
            total += int(self._gaps.count_range(gsl, lo_rel, hi_rel).sum())
        # BIT blocks: masked popcount over the touched rows on the device
        bitm = inside & (self._struct.cls == C.CLS_BIT)
        if bitm.any():
            rows = self._pool[_index(self._struct.slots()[bitm],
                                     self._device)]
            total += _count_range_rows(rows, self._struct.nb[bitm], lo, hi)
        return total

    def any_range(self, lo, hi) -> bool:
        """True if any bit is set in [lo, hi] (reference src/bm.h
        any_range).  A touched FULL block answers without device work."""
        self._flush()
        lo, hi = int(lo), int(hi)
        hi = min(hi, self._size - 1)
        if hi < lo:
            return False
        b_lo, b_hi = lo >> C.SET_BLOCK_SHIFT, hi >> C.SET_BLOCK_SHIFT
        if runs_clip(self._struct.runs, b_lo, b_hi + 1).shape[0]:
            return True
        inside = (self._struct.nb >= b_lo) & (self._struct.nb <= b_hi)
        if (inside & (self._struct.cls == C.CLS_FULL)).any():
            return True
        if not (inside & ((self._struct.cls == C.CLS_BIT)
                          | (self._struct.cls == C.CLS_GAP))).any():
            return False
        return self.count_range(lo, hi) > 0

    def count_to(self, i) -> int:
        """rank: popcount of [0, i] (reference src/bm.h:1420)."""
        return self.count_range(0, i)

    def rank(self, i) -> int:
        return self.count_to(i)

    def rank_corrected(self, i) -> int:
        """rank(i) - test(i) (reference src/bm.h:1465)."""
        return self.count_to(i) - int(self.test(i))

    def count_to_test(self, i) -> int:
        """count_to(i) if bit i is set else 0 (reference src/bm.h:1443)."""
        return self.count_to(i) if self.test(i) else 0

    def is_all_one_range(self, lo, hi) -> bool:
        """True if every bit of [lo, hi] is set (reference src/bm.h
        is_all_one_range)."""
        lo, hi = int(lo), int(hi)
        if hi < lo or hi >= self._size:
            return False
        return self.count_range(lo, hi) == hi - lo + 1

    # -- find family (reference src/bm.h:1577-1705) ---------------------
    def get_first(self) -> int:
        """First set bit, or 0 when empty (reference get_first; pair with
        any() to tell bit 0 apart)."""
        return max(self.find(0), 0)

    def get_next(self, prev) -> int:
        """Next set bit strictly after ``prev``, or 0 if none (reference
        get_next)."""
        return max(self.find(int(prev) + 1), 0)

    def extract_next(self, prev) -> int:
        """get_next() that also CLEARS the found bit (reference
        extract_next)."""
        nxt = self.find(int(prev) + 1)
        if nxt >= 0:
            self.set(nxt, False)
            return nxt
        return 0

    def check_or_next(self, prev) -> int:
        """First set bit AT or after ``prev``, 0 if none (reference
        check_or_next, src/bm.h:2112)."""
        return max(self.find(int(prev)), 0)

    def check_or_next_extract(self, prev) -> int:
        """check_or_next() that also CLEARS the found bit (reference
        check_or_next_extract, src/bm.h:2126)."""
        self._check_writable()
        pos = self.find(int(prev))
        if pos >= 0:
            self.set(pos, False)
            return pos
        return 0

    def find_range(self):
        """(first, last) set bits, or None (reference src/bm.h:1651)."""
        f = self.find()
        if f < 0:
            return None
        return f, self.find_reverse()

    def find_first_mismatch(self, other: "BitVector") -> int:
        """First position where self and other differ, or -1 (reference
        src/bm.h:2035): the XOR on K1, then find."""
        return _binary(self, other, "xor").find()

    def find(self, frm: int = 0) -> int:
        """First set bit at position >= frm, or -1."""
        frm = max(0, int(frm))
        r_e = self._find_entries(frm)
        if not self._struct.has_runs:
            return r_e
        b0 = frm >> C.SET_BLOCK_SHIFT
        r = self._struct.runs
        i = int(np.searchsorted(r[:, 0], b0, side="right")) - 1
        if i >= 0 and b0 < r[i, 1]:
            r_r = frm
        elif i + 1 < r.shape[0]:
            r_r = int(r[i + 1, 0]) << C.SET_BLOCK_SHIFT
        else:
            r_r = -1
        cands = [x for x in (r_e, r_r) if x >= 0]
        return min(cands) if cands else -1

    def _row_host(self, slot: int) -> np.ndarray:
        return blockops.to_host_words(self._pool[int(slot)])

    def _find_entries(self, frm: int) -> int:
        self._flush()
        if frm >= self._size:
            return -1
        b0 = frm >> C.SET_BLOCK_SHIFT
        cand = self._struct.nb >= b0
        if not cand.any():
            return -1
        nbs = self._struct.nb[cand]
        clss = self._struct.cls[cand]
        slots = self._struct.slots()[cand]
        gslots = self._struct.gslots()[cand]
        firsts = np.full(nbs.size, -1, _I64)
        bit_rows = clss == C.CLS_BIT
        if bit_rows.any():
            rows = self._pool[_index(slots[bit_rows], self._device)]
            ff = blockops.find_first_in_blocks(rows).cpu().numpy()
            firsts[bit_rows] = np.where(
                ff < C.BITS_PER_BLOCK,
                (nbs[bit_rows] << C.SET_BLOCK_SHIFT) + ff, -1)
        gap_rows = clss == C.CLS_GAP
        if gap_rows.any():
            gf = self._gaps.find_in_block(gslots[gap_rows],
                                          np.zeros(int(gap_rows.sum()), _I64))
            firsts[gap_rows] = np.where(
                gf >= 0, (nbs[gap_rows] << C.SET_BLOCK_SHIFT) + gf, -1)
        firsts[clss == C.CLS_FULL] = nbs[clss == C.CLS_FULL] << C.SET_BLOCK_SHIFT
        # the partial first block: bits before frm don't count
        for k in range(nbs.size):
            f = firsts[k]
            if f < 0:
                continue
            if f >= frm:
                return int(f)
            if nbs[k] == b0:
                if clss[k] == C.CLS_FULL:
                    return frm
                if clss[k] == C.CLS_GAP:
                    r = int(self._gaps.find_in_block(
                        [gslots[k]], [frm & C.SET_BLOCK_MASK])[0])
                else:
                    r = _find_in_row_np(self._row_host(slots[k]),
                                        frm & C.SET_BLOCK_MASK)
                if r >= 0:
                    return (int(nbs[k]) << C.SET_BLOCK_SHIFT) + r
        return -1

    def find_reverse(self, frm: int | None = None) -> int:
        """Last set bit at position <= frm (or global last), or -1."""
        hi = self._size - 1 if frm is None else min(int(frm), self._size - 1)
        r_e = self._find_reverse_entries(hi)
        if not self._struct.has_runs:
            return r_e
        b1 = hi >> C.SET_BLOCK_SHIFT
        r = self._struct.runs
        i = int(np.searchsorted(r[:, 0], b1, side="right")) - 1
        if i >= 0 and b1 < r[i, 1]:
            r_r = hi
        elif i >= 0:
            r_r = (int(r[i, 1]) << C.SET_BLOCK_SHIFT) - 1
        else:
            r_r = -1
        return max(r_e, r_r)

    def _find_reverse_entries(self, hi: int) -> int:
        self._flush()
        b1 = hi >> C.SET_BLOCK_SHIFT
        cand = self._struct.nb <= b1
        if not cand.any():
            return -1
        nbs = self._struct.nb[cand]
        clss = self._struct.cls[cand]
        slots = self._struct.slots()[cand]
        gslots = self._struct.gslots()[cand]
        lasts = np.full(nbs.size, -1, _I64)
        bit_rows = clss == C.CLS_BIT
        if bit_rows.any():
            rows = self._pool[_index(slots[bit_rows], self._device)]
            fl = blockops.find_last_in_blocks(rows).cpu().numpy()
            lasts[bit_rows] = np.where(
                fl >= 0, (nbs[bit_rows] << C.SET_BLOCK_SHIFT) + fl, -1)
        gap_rows = clss == C.CLS_GAP
        if gap_rows.any():
            g = gslots[gap_rows]
            bc = self._gaps.popcounts()[g]
            gl = np.full(g.size, -1, _I64)
            nz = bc > 0
            if nz.any():
                gl[nz] = self._gaps.select_in_block(g[nz], bc[nz])
            lasts[gap_rows] = np.where(
                gl >= 0, (nbs[gap_rows] << C.SET_BLOCK_SHIFT) + gl, -1)
        fm = clss == C.CLS_FULL
        lasts[fm] = (nbs[fm] << C.SET_BLOCK_SHIFT) + C.BITS_PER_BLOCK - 1
        for k in range(nbs.size - 1, -1, -1):
            last = lasts[k]
            if last < 0:
                continue
            if last <= hi:
                return int(last)
            if nbs[k] == b1:
                if clss[k] == C.CLS_FULL:
                    return hi
                if clss[k] == C.CLS_GAP:
                    g = gslots[k]
                    rk = int(self._gaps.rank_in_block(
                        [g], [hi & C.SET_BLOCK_MASK])[0])
                    r = (int(self._gaps.select_in_block([g], [rk])[0])
                         if rk > 0 else -1)
                else:
                    r = _find_rev_in_row_np(self._row_host(slots[k]),
                                            hi & C.SET_BLOCK_MASK)
                if r >= 0:
                    return (int(nbs[k]) << C.SET_BLOCK_SHIFT) + r
        return -1

    # ------------------------------------------------------------------
    # logical operations
    # ------------------------------------------------------------------
    def _adopt(self, res: "BitVector"):
        self._struct = res._struct
        self._pool = res._pool
        self._device = res._device
        self._gaps = res._gaps
        self._dirty()

    def _ior(self, other):
        self._adopt(_binary(self, other, "or"))
        return self

    def _iand(self, other):
        self._adopt(_binary(self, other, "and"))
        return self

    def _ixor(self, other):
        self._adopt(_binary(self, other, "xor"))
        return self

    def _isub(self, other):
        self._adopt(_binary(self, other, "sub"))
        return self

    def _op3(self, op, a, b, opt_mode):
        """2-op (self OP= a) or 3-op (self = a OP b) form."""
        self._check_writable()
        self._flush()
        if b is None:
            self._adopt(_binary(self, a, op))
            return self
        self._adopt(_binary(a, b, op))
        self._size = max(a._size, b._size)
        if opt_mode:
            self.optimize(opt_mode)
        return self

    def bit_or(self, a, b=None, opt_mode=C.OPT_NONE):
        """2-op (self |= a) or 3-op (self = a | b) form (src/bm.h:1724+)."""
        return self._op3("or", a, b, opt_mode)

    def bit_and(self, a, b=None, opt_mode=C.OPT_NONE):
        return self._op3("and", a, b, opt_mode)

    def bit_xor(self, a, b=None, opt_mode=C.OPT_NONE):
        return self._op3("xor", a, b, opt_mode)

    def bit_sub(self, a, b=None, opt_mode=C.OPT_NONE):
        return self._op3("sub", a, b, opt_mode)

    def bit_or_and(self, a, b, opt_mode=C.OPT_NONE):
        """self |= (a & b) (reference bit_or_and, src/bm.h:1860)."""
        self._check_writable()
        self._flush()
        self._ior(_binary(a, b, "and"))
        if opt_mode:
            self.optimize(opt_mode)
        return self

    def merge(self, other: "BitVector"):
        """Destructive union: self |= other; other is cleared (reference
        src/bm.h:1000)."""
        self.bit_or(other)
        other.clear()
        return self

    def __iand__(self, o): return self.bit_and(o)
    def __ior__(self, o): return self.bit_or(o)
    def __ixor__(self, o): return self.bit_xor(o)
    def __isub__(self, o): return self.bit_sub(o)

    def _new_like(self, o) -> "BitVector":
        return BitVector(max(self._size, o._size), device=self._device)

    def __and__(self, o): return self._new_like(o).bit_and(self, o)
    def __or__(self, o): return self._new_like(o).bit_or(self, o)
    def __xor__(self, o): return self._new_like(o).bit_xor(self, o)
    def __sub__(self, o): return self._new_like(o).bit_sub(self, o)

    # ------------------------------------------------------------------
    # comparison (reference compare/equal src/bm.h:2011-2017)
    # ------------------------------------------------------------------
    def equal(self, other: "BitVector") -> bool:
        return _binary(self, other, "xor").none()

    def __eq__(self, other):
        return isinstance(other, BitVector) and self.equal(other)

    def __hash__(self):
        return id(self)

    def compare(self, other: "BitVector") -> int:
        """Lexicographic compare: 0 equal; 1 if self has the first
        mismatching bit set; -1 otherwise."""
        m = self.find_first_mismatch(other)
        if m < 0:
            return 0
        return 1 if self.test(m) else -1

    # ------------------------------------------------------------------
    # shifts / insert / erase / keep_range (reference src/bm.h:1514-1539)
    # ------------------------------------------------------------------
    def shift_right(self):
        """Shift the whole vector one position up (bit i -> i+1)."""
        self._check_writable()
        self._flush()
        self._adopt(_shifted_up(self))
        return self

    def shift_left(self):
        """Shift one position down (bit i -> i-1); bit 0 is lost."""
        self._check_writable()
        self._flush()
        self._adopt(_shifted_down(self))
        return self

    def _low_part(self, i: int) -> "BitVector":
        """A copy holding only the bits below i."""
        if i <= 0:
            return BitVector(self._size, device=self._device)
        return self.copy().keep_range(0, i - 1)

    def insert(self, i, value: bool):
        """Insert a bit at position i, shifting higher bits up (reference
        src/bm.h:1531): the part below i OR the part from i shifted up (K1
        for the dense rows of the split and of the OR)."""
        self._check_writable()
        self._flush()
        i = int(i)
        low = self._low_part(i)
        high = self.copy()
        if i > 0:
            high._isub(_range_vector(0, i - 1, self._size, self._device,
                                     within=high._struct))
        self._adopt(_binary(low, _shifted_up(high), "or"))
        if value:
            self.set(i, True)
        self._drop_trailing(self._size)
        return self

    def erase(self, i):
        """Erase the bit at position i, shifting higher bits down
        (reference src/bm.h:1539)."""
        self._check_writable()
        self._flush()
        i = int(i)
        low = self._low_part(i)
        high = self.copy()
        high._isub(_range_vector(0, i, self._size, self._device,
                                 within=high._struct))
        self._adopt(_binary(low, _shifted_down(high), "or"))
        return self

    def keep_range(self, lo, hi):
        """Clear every bit outside the closed range [lo, hi]."""
        self._check_writable()     # reference keep_range asserts !is_ro()
        self._flush()
        lo, hi = int(lo), int(hi)
        if lo > hi:                # reference xor_swap (bm.h keep_range)
            lo, hi = hi, lo
        self._iand(_range_vector(lo, hi, self._size, self._device,
                                 within=self._struct))
        return self

    keep_range_struct = keep_range

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def indices(self) -> np.ndarray:
        """All set-bit positions, sorted int64 (enumerator equivalent,
        reference src/bm.h:602)."""
        self._flush()
        out = []
        for s, e in self._struct.runs:      # inherently O(bits) to list
            out.append(np.arange(int(s) << C.SET_BLOCK_SHIFT,
                                 int(e) << C.SET_BLOCK_SHIFT, dtype=_I64))
        fm = self._struct.cls == C.CLS_FULL
        for nb in self._struct.nb[fm]:
            base = int(nb) << C.SET_BLOCK_SHIFT
            out.append(np.arange(base, base + C.BITS_PER_BLOCK, dtype=_I64))
        if self._gaps is not None:
            gm = self._struct.cls == C.CLS_GAP
            gpos = self._gaps.indices_concat(
                self._struct.nb[gm].astype(_I64) << C.SET_BLOCK_SHIFT)
            if gpos.size:
                out.append(gpos)
        if (self._struct.cls == C.CLS_BIT).any():
            # one host copy of the pool, decoded by the native library
            # (imported here: the serial package imports this module)
            from ..serial import native
            bases = (self._struct.nb[self._struct.cls == C.CLS_BIT]
                     << C.SET_BLOCK_SHIFT)
            out.append(native.pool_positions(self._pool_host(), bases))
        if not out:
            return np.zeros(0, _I64)
        if len(out) == 1:
            return out[0]          # BIT positions come out already sorted
        return np.sort(np.concatenate(out))

    def __iter__(self):
        return iter(self.indices())

    def to_numpy(self, size=None) -> np.ndarray:
        """Dense bool export of [0, size).  Content beyond ``size`` is
        clipped BEFORE position materialization (run-aware copy_range)."""
        size = self._size if size is None else size
        src = self
        st = self._struct
        lastw = (size - 1) >> C.SET_BLOCK_SHIFT
        beyond = ((st.nb.size and st.nb[-1] > lastw)
                  or (st.has_runs and st.runs[-1, 1] - 1 > lastw))
        if size < self._size and size > 0 and beyond:
            src = BitVector(self._size, device=self._device)
            src.copy_range(self, 0, size - 1)
        b = np.zeros(size, bool)
        idx = src.indices()
        b[idx[idx < size]] = True
        return b

    def to_words(self) -> np.ndarray:
        """Dense uint32 word image of [0, size)."""
        nblk = C.blocks_for_bits(self._size)
        words = np.zeros((nblk, C.SET_BLOCK_SIZE), np.uint32)
        self._flush()
        for s, e in self._struct.runs:
            words[int(s):min(int(e), nblk)] = 0xFFFFFFFF
        fm = self._struct.cls == C.CLS_FULL
        words[self._struct.nb[fm]] = 0xFFFFFFFF
        if (self._struct.cls == C.CLS_BIT).any():
            words[self._struct.nb[self._struct.cls == C.CLS_BIT]] = \
                self._pool_host()
        if self._gaps is not None:
            gnbs = self._struct.nb[self._struct.cls == C.CLS_GAP]
            words[gnbs] = self._gaps.to_dense()
        return words

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------
    def optimize(self, opt_mode: int = C.OPT_COMPRESS, _nb_range=None):
        """Reclassify blocks: free zero blocks, collapse full blocks, and
        (at opt_compress) move GAP-compressable dense blocks into the
        host-resident GAP store — classified exactly as the reference
        (optimize, src/bm.h:1942; optimize_bit_block src/bmblocks.h:1414).
        Per-block counts come from K3 on the device."""
        self._check_writable()
        self._flush()

        def _in_range_mask():
            if _nb_range is None:
                return np.ones(len(self._struct.nb), bool)
            return ((self._struct.nb >= _nb_range[0])
                    & (self._struct.nb <= _nb_range[1]))

        from . import gaps
        # GAP blocks that no longer fit the level table expand back first
        if self._gaps is not None:
            lvl = gaps.gap_calc_level_arr(self._gaps.gap_lens(), self._glevel)
            bad = lvl < 0
            if bad.any():
                gsl = self._struct.gslots()
                sel = (self._struct.cls == C.CLS_GAP) & _in_range_mask()
                sel[sel] &= bad[gsl[sel]]
                self._deoptimize_gaps(sel)
        if not (self._struct.cls == C.CLS_BIT).any():
            self._coalesce_full_runs(_nb_range)
            self._dirty()
            return self
        counts = ck.block_counts(self._pool).cpu().numpy().astype(np.int64)
        is_bit = self._struct.cls == C.CLS_BIT
        slots = self._struct.slots()
        cnt_all = np.zeros(len(self._struct.nb), np.int64)
        cnt_all[is_bit] = counts[slots[is_bit]]
        drop = is_bit & (cnt_all == 0)
        if opt_mode >= C.OPT_FREE_01:
            to_full = is_bit & (cnt_all == C.BITS_PER_BLOCK)
        else:
            to_full = np.zeros_like(drop)
        drop &= _in_range_mask()
        to_full &= _in_range_mask()
        if drop.any() or to_full.any():
            # rows are selected with the OLD slot mapping; reclassify to
            # FULL only after the rows of newly-FULL blocks are removed
            keep = ~drop
            row_keep = slots[keep & is_bit & ~to_full]
            self._pool = self._pool[_index(row_keep, self._device)]
            new_cls = self._struct.cls.copy()
            new_cls[to_full] = C.CLS_FULL
            gap_keep = keep & (self._struct.cls == C.CLS_GAP)
            if self._gaps is not None and not gap_keep[
                    self._struct.cls == C.CLS_GAP].all():
                self._gaps = self._gaps.subset(
                    self._struct.gslots()[gap_keep])
            self._struct = Structure(self._struct.nb[keep].copy(),
                                     new_cls[keep].copy(),
                                     self._struct.runs)
        self._dirty()
        if opt_mode >= C.OPT_COMPRESS and (self._struct.cls
                                           == C.CLS_BIT).any():
            bc = ck.block_counts(self._pool).cpu().numpy().astype(np.int64)
            gc = blockops.gap_counts(self._pool).cpu().numpy().astype(
                np.int64)
            gap_mask, _, _ = gaps.classify_blocks(bc, gc, self._glevel)
            is_bit = self._struct.cls == C.CLS_BIT
            conv = is_bit.copy()
            conv[is_bit] = gap_mask[self._struct.slots()[is_bit]]
            conv &= _in_range_mask()
            if conv.any():
                conv_rows = self._struct.slots()[conv]
                new_store = GapStore.from_dense(blockops.to_host_words(
                    self._pool[_index(conv_rows, self._device)]))
                keep_rows = self._struct.slots()[is_bit & ~conv]
                self._pool = self._pool[_index(keep_rows, self._device)]
                old_store = self._gaps
                n_old = old_store.n_blocks if old_store is not None else 0
                old_gslots = self._struct.gslots()
                new_cls = self._struct.cls.copy()
                new_cls[conv] = C.CLS_GAP
                # merge stores in final nb order: old blocks keep their
                # index, converted blocks follow at n_old + rank-in-conv
                src = np.full(len(new_cls), -1, _I64)
                was_gap = self._struct.cls == C.CLS_GAP
                src[was_gap] = old_gslots[was_gap]
                src[conv] = n_old + np.cumsum(conv)[conv] - 1
                merged = GapStore.concat(old_store, new_store)
                self._gaps = merged.subset(src[new_cls == C.CLS_GAP])
                self._struct = Structure(self._struct.nb, new_cls,
                                         self._struct.runs)
        self._coalesce_full_runs(_nb_range)
        return self

    def _coalesce_full_runs(self, nb_range=None):
        """Fold maximal spans of >= RUN_MIN consecutive FULL entries (or
        any FULL span abutting an existing run) into ``Structure.runs``
        (the reference's FULL sub-tree sentinels, src/bmblocks.h:644)."""
        st = self._struct
        full = st.cls == C.CLS_FULL
        if nb_range is not None:
            full &= (st.nb >= nb_range[0]) & (st.nb <= nb_range[1])
        if not full.any():
            return
        fnb = st.nb[full]
        brk = np.concatenate([[True], np.diff(fnb) != 1])
        starts = fnb[brk]
        ends = fnb[np.concatenate([brk[1:], [True]])] + 1
        keep = (ends - starts) >= RUN_MIN
        if st.has_runs:
            keep |= (np.isin(ends, st.runs[:, 0])
                     | np.isin(starts, st.runs[:, 1]))
        if not keep.any():
            return
        ivals = np.stack([starts[keep], ends[keep]], axis=1)
        new_runs = runs_union(st.runs, ivals)
        covered = points_in_runs(st.nb, new_runs)
        self._struct = Structure(st.nb[~covered].copy(),
                                 st.cls[~covered].copy(), new_runs)

    def optimize_range(self, lo, hi, opt_mode: int = C.OPT_COMPRESS):
        """optimize() restricted to blocks intersecting [lo, hi]
        (reference optimize_range, src/bm.h:1956)."""
        return self.optimize(opt_mode,
                             _nb_range=(int(lo) >> C.SET_BLOCK_SHIFT,
                                        int(hi) >> C.SET_BLOCK_SHIFT))

    def set_new_blocks_strat(self, strategy: int) -> int:
        """BM_BIT / BM_GAP preference for new blocks (reference
        set_new_blocks_strat, src/bm.h:1912); returns the old one."""
        old, self.strategy = self.strategy, int(strategy)
        return old

    def get_new_blocks_strat(self) -> int:
        return self.strategy

    def set_gap_levels(self, glevel_len) -> "BitVector":
        """Per-vector GAP level table (reference set_gap_levels,
        src/bm.h:1977; default table src/bmconst.h:396-403)."""
        tbl = tuple(int(x) for x in glevel_len)
        if len(tbl) != 4:
            raise ValueError("gap level table must have 4 entries")
        self._glevel = tbl
        return self

    def get_gap_levels(self) -> tuple:
        return self._glevel

    def optimize_gap_size(self):
        """Tune the GAP level table to this vector's GAP block lengths
        (reference optimize_gap_size -> improve_gap_levels,
        src/bmfunc.h:10170)."""
        self._check_writable()
        from . import gaps
        if self._gaps is None:
            self.optimize()
        if self._gaps is None or self._gaps.n_blocks == 0:
            return self
        improved, new_tbl = gaps.improve_gap_levels(self._gaps.gap_lens(),
                                                    self._glevel)
        if improved:
            self.set_gap_levels(new_tbl)
            self.optimize()
        return self

    def calc_stat(self) -> dict:
        """Block and memory statistics shaped like the reference
        bv_statistics (src/bmfunc.h:56; calc_stat src/bm.h:1904).  Memory
        counts uint32 words of the dense rows (the int32 pool holds the
        same bytes) and, for GAP blocks, the reference's capacity-by-level
        model (a gap buffer of glevel[level] words)."""
        self._flush()
        from . import gaps
        n_bit = int((self._struct.cls == C.CLS_BIT).sum())
        n_full = (int((self._struct.cls == C.CLS_FULL).sum())
                  + self._struct.run_block_count())
        gaps_by_level = [0, 0, 0, 0]
        gap_mem = gap_cap_overhead = gap_serial = 0
        n_gap = 0
        if self._gaps is not None and self._gaps.n_blocks:
            lens = self._gaps.gap_lens()
            levels = gaps.gap_calc_level_arr(lens, self._glevel)
            n_gap = int(lens.size)
            for lv, ln in zip(levels, lens):
                lv = max(int(lv), 0)
                gaps_by_level[lv] += 1
                cap = self._glevel[lv]
                gap_mem += cap * 2
                gap_cap_overhead += (cap - int(ln)) * 2
                gap_serial += int(ln) * 2 + 3
        mem = (n_bit * C.SET_BLOCK_SIZE * 4
               + self._struct.nb.nbytes + self._struct.cls.nbytes)
        return {
            "bit_blocks": n_bit,
            "gap_blocks": n_gap,
            "full_blocks": n_full,
            "zero_blocks": C.blocks_for_bits(self._size)
            - n_bit - n_gap - n_full,
            "gaps_by_level": gaps_by_level,
            "gap_levels": list(self._glevel),
            "gap_cap_overhead": gap_cap_overhead,
            "memory_used": mem + gap_mem,
            "device_memory_used": mem,
            "max_serialize_mem": (n_bit * (C.SET_BLOCK_SIZE * 4 + 16)
                                  + gap_serial + 64),
        }

    def freeze(self):
        """Make immutable (reference READONLY finalization src/bm.h:1057)."""
        self._flush()
        self._ro = True
        return self

    def is_ro(self) -> bool:
        return self._ro

    # rank/select via cached RS index ------------------------------------
    def _rs_index(self):
        if self._rs is None:
            from .rs_index import RSIndex
            self._flush()
            self._rs = RSIndex.build(self)
        return self._rs

    def select(self, rank: int) -> int:
        """Position of the rank-th set bit (1-based); -1 if out of range
        (reference src/bm.h:1705)."""
        return self._rs_index().select(rank)

    def find_rank(self, rank: int, frm: int = 0) -> int:
        """Position of the rank-th set bit counting from position frm
        (reference src/bm.h:1666)."""
        if frm <= 0:
            return self.select(rank)
        return self.select(self.count_to(frm - 1) + int(rank))

    def build_rs_index(self):
        return self._rs_index()

    # iterator factories (reference first()/get_enumerator, src/bm.h:602+)
    def get_enumerator(self, pos: int = 0):
        from .enumerator import Enumerator
        return Enumerator(self, pos)

    first = get_enumerator

    def end(self):
        """Invalid end-sentinel enumerator (reference bvector::end,
        src/bm.h:1877), made without decoding a block."""
        from .enumerator import Enumerator
        return Enumerator.end_sentinel(self)

    def get_counted_enumerator(self, pos: int = 0):
        from .enumerator import CountedEnumerator
        return CountedEnumerator(self, pos)

    def get_bulk_insert_iterator(self, buffer_size: int = 1 << 16):
        from .enumerator import BulkInsertIterator
        return BulkInsertIterator(self, buffer_size)

    inserter = get_bulk_insert_iterator

    def __repr__(self):
        return (f"BitVector(size={self._size}, blocks={len(self._struct.nb)}, "
                f"rows={int((self._struct.cls == C.CLS_BIT).sum())}, "
                f"device={self._device})")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _pool_from_ids(ids: np.ndarray, device):
    if ids.size == 0:
        return Structure.empty(), blockops.zero_pool(0, device)
    ub, inv = _block_index(ids)
    pool = blockops.scatter_set_bits(
        _index(inv, device),
        torch.from_numpy((ids & C.SET_BLOCK_MASK).astype(np.int32)).to(device),
        int(ub.size))
    return (Structure(ub.astype(_I64), np.full(ub.size, C.CLS_BIT, np.uint8)),
            pool)


def _tail_mask_np(tail_bits: int) -> np.ndarray:
    m = np.zeros(C.SET_BLOCK_SIZE, np.uint32)
    full_words = tail_bits >> 5
    m[:full_words] = 0xFFFFFFFF
    rem = tail_bits & 31
    if rem:
        m[full_words] = (1 << rem) - 1
    return m


def _range_vector(lo: int, hi: int, size: int, device,
                  within=None) -> BitVector:
    """BitVector with bits [lo, hi] set, built from at most two dense edge
    blocks (host-constructed, 8KB each) + a compact interior.

    ``within=None``: a wide interior (>= RUN_MIN blocks) is ONE FULL run
    entry (the reference's FULL sub-tree fast path, src/bm.h:6628-6650).
    ``within`` (a Structure): interior FULL coverage is narrowed to blocks
    that Structure has — enough whenever the range vector is consumed by
    AND or SUB against that same vector."""
    b_lo, b_hi = lo >> C.SET_BLOCK_SHIFT, hi >> C.SET_BLOCK_SHIFT
    lo_in = lo & C.SET_BLOCK_MASK
    hi_in = hi & C.SET_BLOCK_MASK
    rows = []
    runs = None
    if b_lo == b_hi:
        m = _edge_mask(lo_in, hi_in)
        nb = np.asarray([b_lo], _I64)
        if (m == 0xFFFFFFFF).all():
            cls = np.asarray([C.CLS_FULL], np.uint8)
        else:
            cls = np.asarray([C.CLS_BIT], np.uint8)
            rows = [m]
    else:
        if within is None:
            if b_hi - (b_lo + 1) >= RUN_MIN:
                interior = np.zeros(0, _I64)
                runs = np.asarray([[b_lo + 1, b_hi]], _I64)
            else:
                interior = np.arange(b_lo + 1, b_hi, dtype=_I64)
        else:
            w = within.nb
            interior = w[(w > b_lo) & (w < b_hi)]
            if within.has_runs:
                runs = runs_clip(within.runs, b_lo + 1, b_hi)
                if runs.shape[0] == 0:
                    runs = None
        nb_parts, cls_parts = [], []
        if lo_in == 0:
            nb_parts.append([b_lo]); cls_parts.append([C.CLS_FULL])
        else:
            nb_parts.append([b_lo]); cls_parts.append([C.CLS_BIT])
            rows.append(_edge_mask(lo_in, C.SET_BLOCK_MASK))
        nb_parts.append(interior)
        cls_parts.append(np.full(interior.size, C.CLS_FULL, np.uint8))
        if hi_in == C.SET_BLOCK_MASK:
            nb_parts.append([b_hi]); cls_parts.append([C.CLS_FULL])
        else:
            nb_parts.append([b_hi]); cls_parts.append([C.CLS_BIT])
            rows.append(_edge_mask(0, hi_in))
        nb = np.concatenate([np.asarray(p, _I64) for p in nb_parts])
        cls = np.concatenate([np.asarray(p, np.uint8) for p in cls_parts])
    pool = (np.stack(rows) if rows
            else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
    struct = (Structure(nb, cls) if runs is None
              else Structure(nb, cls, runs))
    return BitVector._from_parts(struct, pool, size, device=device)


def _edge_mask(lo_bit: int, hi_bit: int) -> np.ndarray:
    m = np.zeros(C.SET_BLOCK_SIZE, np.uint32)
    lw, hw = lo_bit >> 5, hi_bit >> 5
    m[lw:hw + 1] = 0xFFFFFFFF
    m[lw] &= np.uint32(0xFFFFFFFF) << np.uint32(lo_bit & 31)
    hb = hi_bit & 31
    if hb != 31:
        m[hw] &= np.uint32((1 << (hb + 1)) - 1)
    return m


# one operand's GAP content passes through (possibly complemented) when the
# other side is symbolically absorbing: {op: {(state_a, state_b): action}}
# with states z/f/g and actions copy_a/comp_a/copy_b/comp_b
_GAP_IDENT = {
    "and": {("g", "f"): "copy_a", ("f", "g"): "copy_b"},
    "or": {("g", "z"): "copy_a", ("z", "g"): "copy_b"},
    "xor": {("g", "z"): "copy_a", ("z", "g"): "copy_b",
            ("g", "f"): "comp_a", ("f", "g"): "comp_b"},
    "sub": {("g", "z"): "copy_a", ("f", "g"): "comp_b"},
}
# run-count bound above which a gap x gap pair's result stays a dense BIT
# row (a >4096-run result would cost more than the 8KB dense row)
_GAP_MERGE_MAX_RUNS = blockops.GAP_MERGE_MAX_RUNS


def _binary(a: BitVector, b: BitVector, op: str) -> BitVector:
    """Binary set-op.  Kernel blocks route two ways: GAP identity
    (metadata only) and ONE launch of the gather-fused K1 kernel for all
    the rest, GAP operands expanded on the device by gap_expand.  The rows
    of GAP x GAP pairs whose runs sum to at most _GAP_MERGE_MAX_RUNS come
    back to D-GAP through gap_compress (the result of the reference's
    gap_buff_op merge, src/bmfunc.h:3738: results stay succinct)."""
    if a._device != b._device:
        raise ValueError(f"operands on different devices: {a._device} "
                         f"and {b._device}")
    a._flush()
    b._flush()
    plan = plan_binary(op, a._struct, b._struct)
    nb_all = plan.nb.copy()
    cls_all = plan.cls.copy()
    kpos = np.flatnonzero(cls_all == C.CLS_BIT)
    k = kpos.size
    size = max(a._size, b._size)
    if k == 0:
        return BitVector._from_parts(Structure(nb_all, cls_all, plan.runs),
                                     blockops.zero_pool(0, a._device), size)

    def _state(slot, full, gap):
        st = np.full(k, "z", dtype="U1")
        st[slot >= 0] = "b"
        st[full] = "f"
        st[gap >= 0] = "g"
        return st

    st_a = _state(plan.a_slot, plan.a_full, plan.a_gap)
    st_b = _state(plan.b_slot, plan.b_full, plan.b_gap)
    ident = np.full(k, "", dtype="U6")
    for (sa, sb), act in _GAP_IDENT[op].items():
        ident[(st_a == sa) & (st_b == sb)] = act
    both_gap = (st_a == "g") & (st_b == "g") & (ident == "")
    cap = 0               # the small pairs' summed runs bound their result's
    if both_gap.any():
        lens = (a._gaps.n_runs()[plan.a_gap[both_gap]]
                + b._gaps.n_runs()[plan.b_gap[both_gap]])
        small = both_gap.copy()
        small[both_gap] = lens <= _GAP_MERGE_MAX_RUNS
        cap = int(lens[lens <= _GAP_MERGE_MAX_RUNS].sum())
    else:
        small = both_gap
    dense = (ident == "") & ~small

    # --- device part: one K1 launch, the BIT-result rows first ----------
    drop = np.zeros(len(nb_all), bool)
    parts = []            # stores in concat order
    part_keys = []
    pool = blockops.zero_pool(0, a._device)
    if (ident == "").any():
        rows = np.concatenate([np.flatnonzero(dense), np.flatnonzero(small)])
        a_desc, b_desc = descriptor_pair(
            (a._pool, plan.a_slot[rows], plan.a_full[rows], a._gaps,
             plan.a_gap[rows]),
            (b._pool, plan.b_slot[rows], plan.b_full[rows], b._gaps,
             plan.b_gap[rows]))
        # the digest is the reference's per-block wave digest of each
        # result row; as in the JAX package, an all-zero result row stays
        # a BIT row here (bitmagic_tpu/core/bitvector.py:1827), so the
        # digest is produced but not consulted
        out, _digest = ck.binary_op_digest(op, a_desc, b_desc)
        n_dense = int(dense.sum())
        pool = out if n_dense == rows.size else out[:n_dense].clone()
        if small.any():
            merged, zm, fm = compress_rows(out[n_dense:], cap)
            mpos = kpos[small]
            cls_all[mpos] = C.CLS_GAP
            cls_all[mpos[fm]] = C.CLS_FULL
            drop[mpos[zm]] = True
            keepm = ~(zm | fm)
            if keepm.any():
                parts.append(merged.subset(np.flatnonzero(keepm)))
                part_keys.append(mpos[keepm])
    if dense.all():
        return BitVector._from_parts(Structure(nb_all, cls_all, plan.runs),
                                     pool, size)
    # --- identity pass-through -----------------------------------------
    for act, store, gsl in (("copy_a", a._gaps, plan.a_gap),
                            ("comp_a", a._gaps, plan.a_gap),
                            ("copy_b", b._gaps, plan.b_gap),
                            ("comp_b", b._gaps, plan.b_gap)):
        m = ident == act
        if not m.any():
            continue
        sub = store.subset(gsl[m])
        if act.startswith("comp"):
            sub = sub.complement()
        parts.append(sub)
        part_keys.append(kpos[m])
        cls_all[kpos[m]] = C.CLS_GAP
    gaps = None
    if parts:
        combined = GapStore.concat_many(parts)
        order = np.argsort(np.concatenate(part_keys), kind="stable")
        gaps = combined.subset(order)
    keep = ~drop
    return BitVector._from_parts(
        Structure(nb_all[keep], cls_all[keep], plan.runs), pool, size, gaps)


# sv_descent's class codes (blockops.DESCENT_CLASSES) as block classes
_DESCENT_CLS = np.asarray([255, C.CLS_FULL, 255, C.CLS_BIT, C.CLS_GAP],
                          np.uint8)


def descent(table, uni: BitVector, steps, want_eq=True):
    """The MSB-first descent of an ordered search, as the chain
    ``eq &= p`` (a 1-bit) or ``gt |= eq & p; eq -= p`` (a 0-bit) of set
    operations from ``eq = uni``, ``gt = empty`` would leave both vectors,
    block layout and all, in one sv_descent launch and one download of
    the blocks' classes.  ``table``: the column's plane table; ``steps``:
    ``(table row, value bit, the plane's Structure)`` in descent order.
    The kernel walks every block that the planes or the universe hold an
    entry for; FULL runs follow by interval algebra on the host, as
    ``plan_binary`` runs them.  -> ``(gt, eq)`` (eq None without
    want_eq)."""
    uni._flush()
    dev = uni._device
    ust = uni._struct
    if not steps:
        return BitVector(C.ID_MAX48, device=dev), (uni.copy() if want_eq
                                                   else None)
    gt_runs, eq_runs = Structure.empty().runs, ust.runs
    for _, bit, pst in steps:
        t_runs = runs_intersect(eq_runs, pst.runs)
        if bit:
            eq_runs = t_runs
        else:
            gt_runs = runs_union(gt_runs, t_runs)
            eq_runs = runs_subtract_points(runs_diff(eq_runs, pst.runs),
                                           pst.nb)
    blocks = np.union1d(table.blocks, ust.nb)
    if blocks.size:
        gt_rows, _, eq_rows, _, cls = ck.sv_descent(
            table, *descent_args(table, uni, steps, blocks), want_eq)
        cls = cls.cpu().numpy().reshape(2, -1)
    else:                      # FULL runs only: nothing for the kernel
        gt_rows = eq_rows = blockops.zero_pool(0, dev)
        cls = np.zeros((2, 0), np.int32)
    gt = _descent_result(blocks, cls[0], gt_rows, gt_runs, C.ID_MAX48)
    if not want_eq:
        return gt, None
    return gt, _descent_result(blocks, cls[1], eq_rows, eq_runs, uni._size)


def descent_args(table, uni: BitVector, steps, blocks):
    """sv_descent's arguments after the column's plane table ``table``:
    the universe's one-plane table, the walked blocks' entry codes
    int32[K, len(steps) + 1] (``blocks.descent_codes`` of the sorted
    block ids ``blocks``, uploaded with the universe's table), the steps'
    table rows and the value's bits (bit i: step i's)."""
    rows = [r for r, _, _ in steps]
    codes = descent_codes(table, rows, uni._struct, blocks)
    words = np.concatenate([codes.ravel(), np.zeros(codes.size % 2,
                                                    np.int32)])
    utable = plane_table([(-1, uni._struct, uni._pool, uni._gaps)],
                         uni._device, words.view(np.int64))
    bits = sum(bit << i for i, (_, bit, _) in enumerate(steps))
    dev_codes = utable.extra.view(torch.int32)[:codes.size].view(
        codes.shape)
    return utable, dev_codes, rows, bits


def _descent_result(blocks, cls, rows, runs, size) -> BitVector:
    """A BitVector from sv_descent's rows and classes of ``blocks`` (each
    a class in bits 0-7 and a D-GAP result's run count above): its BIT
    rows taken as they are, its D-GAP rows re-encoded (canonical D-GAP,
    as the set operations' stores; the run counts sum to the exact total
    they hand ``compress_rows``), FULL runs from ``runs``."""
    c = _DESCENT_CLS[cls & 0xFF]
    keep = c != 255
    bit = np.flatnonzero(c == C.CLS_BIT)
    if bit.size == blocks.size:
        pool = rows
    else:
        pool = rows[torch.from_numpy(bit).to(rows.device)]
    gap = np.flatnonzero(c == C.CLS_GAP)
    gaps = None
    if gap.size:
        gaps = compress_rows(rows[torch.from_numpy(gap).to(rows.device)],
                             int((cls[gap] >> 8).sum()))[0]
    return BitVector._from_parts(Structure(blocks[keep], c[keep], runs),
                                 pool, size, gaps)


def _assemble_shifted(nbs, rows_dev, new_nb, new_rows, size) -> BitVector:
    if new_nb.size:
        all_nb = np.concatenate([nbs, new_nb])
        order = np.argsort(all_nb, kind="stable")
        rows_dev = torch.cat([rows_dev, to_device_words(
            new_rows, rows_dev.device)])[_index(order, rows_dev.device)]
        nbs = all_nb[order]
    return BitVector._from_parts(
        Structure(nbs.copy(), np.full(nbs.size, C.CLS_BIT, np.uint8)),
        rows_dev, size)


def _shifted_up(bv: BitVector) -> BitVector:
    """bv shifted one bit towards higher indices (whole vector).  The rows
    shift on the device (per-row shift); the host sees only the 8 B/block
    edge bits to stitch cross-block carries: a block's carry-out lands in
    the adjacent successor when present, else becomes a new 1-bit block.
    O(own blocks) for any address span."""
    bv._flush()
    bv._materialize_runs()       # flat per-block view (bounded) + _dirty
    nbs = bv._struct.nb
    if len(nbs) == 0:
        return bv
    rows = blockops.gather_rows(*operand_args(bv, nbs))  # present only
    _, top_dev = blockops.edge_bits(rows)
    top = top_dev.cpu().numpy().astype(np.uint32)        # tiny fetch
    succ_present = np.append(nbs[1:] == nbs[:-1] + 1, False)
    carry = np.zeros(nbs.size, np.int32)
    recv = np.flatnonzero(np.concatenate([[False], succ_present[:-1]]))
    carry[recv] = top[recv - 1]
    out = blockops.shift_rows_up1(rows, torch.from_numpy(carry).to(
        rows.device))
    make = (top == 1) & ~succ_present
    new_nb = nbs[make] + 1
    new_rows = np.zeros((new_nb.size, C.SET_BLOCK_SIZE), np.uint32)
    new_rows[:, 0] = 1
    res = _assemble_shifted(nbs, out, new_nb, new_rows, bv._size)
    res._drop_trailing(bv._size)
    return res


def _shifted_down(bv: BitVector) -> BitVector:
    """bv shifted one bit towards lower indices (rows on the device, edge
    bits stitched on the host, as in _shifted_up).  A block's bit 0 lands
    in the adjacent predecessor's top bit when present, else in a new
    block below; block 0's bit 0 drops off."""
    bv._flush()
    bv._materialize_runs()       # flat per-block view (bounded) + _dirty
    nbs = bv._struct.nb
    if len(nbs) == 0:
        return bv
    rows = blockops.gather_rows(*operand_args(bv, nbs))  # present only
    bottom_dev, _ = blockops.edge_bits(rows)
    bottom = bottom_dev.cpu().numpy().astype(np.uint32)  # tiny fetch
    succ_present = np.append(nbs[1:] == nbs[:-1] + 1, False)
    carry = np.zeros(nbs.size, np.int32)
    recv = np.flatnonzero(succ_present)
    carry[recv] = bottom[recv + 1]
    out = blockops.shift_rows_down1(rows, torch.from_numpy(carry).to(
        rows.device))
    prev_present = np.concatenate([[False], nbs[1:] == nbs[:-1] + 1])
    make = (bottom == 1) & ~prev_present & (nbs > 0)
    new_nb = nbs[make] - 1
    new_rows = np.zeros((new_nb.size, C.SET_BLOCK_SIZE), np.uint32)
    new_rows[:, -1] = np.uint32(0x80000000)
    return _assemble_shifted(nbs, out, new_nb, new_rows, bv._size)


def _count_range_rows_dev(rows, lo_rel, hi_rel):
    """popcount of bits within per-row in-block ranges [lo_rel, hi_rel)
    (clipped to [0, 65536] on the HOST — 48-bit global addresses never reach
    the device).  Returns per-row int32 counts."""
    bit0 = torch.arange(C.SET_BLOCK_SIZE, dtype=torch.int64,
                        device=rows.device)[None, :] * 32
    lo_w = (lo_rel.to(torch.int64)[:, None] - bit0).clamp(0, 32)
    hi_w = (hi_rel.to(torch.int64)[:, None] - bit0).clamp(0, 32)
    n_bits = (hi_w - lo_w).clamp(min=0)
    mask = (((torch.ones_like(n_bits) << n_bits) - 1) << lo_w) & 0xFFFFFFFF
    mask = torch.where(n_bits == 0, 0, mask)
    return popcount(rows & u32_to_i32(mask)).sum(dim=1, dtype=torch.int32)


def _count_range_rows(rows, nbs_np, lo, hi):
    """Split the global [lo, hi] into per-row relative ranges (int64 host
    math), count on the device, sum in int64."""
    base = np.asarray(nbs_np, np.int64) * C.BITS_PER_BLOCK
    lo_rel = np.clip(int(lo) - base, 0, C.BITS_PER_BLOCK).astype(np.int32)
    hi_rel = np.clip(int(hi) + 1 - base, 0, C.BITS_PER_BLOCK).astype(np.int32)
    dev = rows.device
    per_row = _count_range_rows_dev(rows, torch.from_numpy(lo_rel).to(dev),
                                    torch.from_numpy(hi_rel).to(dev))
    return int(per_row.sum(dtype=torch.int64))


def _find_in_row_np(row: np.ndarray, from_bit: int) -> int:
    bits = np.unpackbits(row.view(np.uint8), bitorder="little")
    nz = np.flatnonzero(bits[from_bit:])
    return int(nz[0]) + from_bit if nz.size else -1


def _find_rev_in_row_np(row: np.ndarray, to_bit: int) -> int:
    bits = np.unpackbits(row.view(np.uint8), bitorder="little")
    nz = np.flatnonzero(bits[: to_bit + 1])
    return int(nz[-1]) if nz.size else -1
