"""Enumerators and insert iterators over BitVectors (port of
``bitmagic_tpu/core/enumerator.py``).

Equivalents of the reference's nested iterator types (src/bm.h):
enumerator (:602 — decode-ahead set-bit iterator with go_to / skip /
skip_to_rank), counted_enumerator (:733), insert_iterator (:380) and
bulk_insert_iterator (:464 — buffered bulk loading).

The enumerator decodes one *block* of positions at a time on the host (the
native library's ``block_positions``), then iterates over them — the
analog of the reference's per-wave decode-ahead buffers.  Dense rows come
from the device ``ROW_CHUNK`` at a time, one copy per chunk instead of one
per block.  It walks the structure's *segment* view, so FULL runs stream
block by block without materializing per-block metadata.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..ops.blockops import to_host_words
from ..serial import native

_I64 = np.int64
ROW_CHUNK = 64       # dense rows per device-to-host copy (512 KiB)


class Enumerator:
    """Set-bit position iterator (bm::bvector::enumerator equivalent)."""

    def __init__(self, bv, pos: int = 0):
        self._bv = bv
        bv._flush()
        self._struct_ref = bv._struct
        self._segs = bv._struct.segments()
        self._rows = None         # (pool, first slot, host rows) fetched
        self._buf = np.zeros(0, _I64)
        self._buf_i = 0
        self._entry = -1          # index into the segment view
        self._seg_off = 0         # block offset within a multi-block segment
        self.go_to(pos)

    def _sync(self):
        """Re-read the segment view when a mutation replaced the vector's
        structure since this enumerator cached it (reference iterators are
        simply invalidated by mutation; go_to() re-anchors)."""
        self._bv._flush()
        if self._struct_ref is not self._bv._struct:
            self._struct_ref = self._bv._struct
            self._segs = self._bv._struct.segments()

    # -- internals ---------------------------------------------------------
    def _row(self, slot: int) -> np.ndarray:
        """Host copy of pool row ``slot``, from the chunk fetched last or a
        new chunk starting at it (a replaced pool tensor is re-fetched)."""
        pool = self._bv._pool
        got = self._rows
        if (got is None or got[0] is not pool
                or not got[1] <= slot < got[1] + got[2].shape[0]):
            got = self._rows = (pool, slot,
                                to_host_words(pool[slot:slot + ROW_CHUNK]))
        return got[2][slot - got[1]]

    def _load_entry(self, k: int, off: int = 0):
        """Decode all set positions of block ``off`` of segment k."""
        start, span, cls, slot, gslot = self._segs
        nb = int(start[k]) + off
        base = nb << C.SET_BLOCK_SHIFT
        if cls[k] == C.CLS_FULL:
            self._buf = np.arange(base, base + C.BITS_PER_BLOCK, dtype=_I64)
        elif cls[k] == C.CLS_GAP:
            g = self._bv._gaps.subset(np.asarray([gslot[k]]))
            self._buf = g.indices_concat(np.asarray([base], _I64))
        else:
            self._buf = native.block_positions(self._row(int(slot[k]))) + base
        self._buf_i = 0
        self._entry = k
        self._seg_off = off

    def _advance_entry(self):
        start, span, cls, slot, gslot = self._segs
        m = start.size
        while True:
            if (0 <= self._entry < m
                    and self._seg_off + 1 < span[self._entry]):
                self._load_entry(self._entry, self._seg_off + 1)
            else:
                k = self._entry + 1
                if k >= m:
                    self._buf = np.zeros(0, _I64)
                    self._buf_i = 0
                    self._entry = k
                    return False
                self._load_entry(k)
            if self._buf.size:
                return True

    # -- API (reference enumerator) ----------------------------------------
    def valid(self) -> bool:
        return self._buf_i < self._buf.size

    def invalidate(self):
        """Turn into the end sentinel (reference iterator_base::invalidate);
        _entry is pinned past any block count, so the sentinel stays
        invalid if the vector grows."""
        self._buf = np.zeros(0, _I64)
        self._buf_i = 0
        self._entry = 1 << 62
        self._seg_off = 0
        return self

    @classmethod
    def end_sentinel(cls, bv):
        """Invalid enumerator without the position-0 decode a normal
        construction performs (bvector.end() support)."""
        e = object.__new__(cls)
        e._bv = bv
        e._struct_ref = bv._struct
        e._segs = (np.zeros(0, _I64),) * 5
        e._rows = None
        return e.invalidate()

    def value(self) -> int:
        if not self.valid():
            raise StopIteration
        return int(self._buf[self._buf_i])

    def go_up(self) -> bool:
        """Advance to the next set bit (reference operator++)."""
        self._buf_i += 1
        if self._buf_i < self._buf.size:
            return True
        return self._advance_entry()

    advance = go_up

    def go_first(self) -> bool:
        """Rewind to the first set bit (reference go_first)."""
        return self.go_to(0)

    def go_to(self, pos: int) -> bool:
        """Position at the first set bit >= pos (reference go_to)."""
        self._sync()
        start, span, cls, slot, gslot = self._segs
        m = start.size
        blk = int(pos) >> C.SET_BLOCK_SHIFT
        i = int(np.searchsorted(start, blk, side="right")) - 1
        if i >= 0 and blk < start[i] + span[i]:
            self._load_entry(i, blk - int(start[i]))
            self._buf_i = int(np.searchsorted(self._buf, int(pos)))
            if self._buf_i >= self._buf.size:
                return self._advance_entry()
            return True
        k = i + 1
        if k >= m:
            self._buf = np.zeros(0, _I64)
            self._buf_i = 0
            self._entry = k
            return False
        self._load_entry(k)
        self._buf_i = 0
        return self._buf.size > 0 or self._advance_entry()

    def skip(self, n: int) -> bool:
        """Skip n set bits forward (reference skip)."""
        n = int(n)
        while n > 0:
            remaining = self._buf.size - self._buf_i - 1
            if remaining >= n:
                self._buf_i += n
                return True
            n -= remaining + 1
            if not self._advance_entry():
                return False
        return self.valid()

    def skip_to_rank(self, rank: int) -> bool:
        """Skip forward so that `rank` more set bits (1-based from the
        current one) have been consumed (reference skip_to_rank)."""
        return self.skip(int(rank) - 1)

    # -- comparisons (two invalid enumerators over the same vector compare
    # equal, so the canonical `while en != bv.end()` idiom terminates) -----
    def _cmp_key(self):
        if not self.valid():
            return None
        return self.value()

    def __eq__(self, other):
        if not isinstance(other, Enumerator):
            return NotImplemented
        if self._bv is not other._bv:
            return False
        return self._cmp_key() == other._cmp_key()

    def __ne__(self, other):
        r = self.__eq__(other)
        return r if r is NotImplemented else not r

    def __lt__(self, other):
        a, b = self._cmp_key(), other._cmp_key()
        if a is None:
            return False
        return b is None or a < b

    def __hash__(self):
        return hash((id(self._bv), self._cmp_key()))

    def __iter__(self):
        return self

    def __next__(self):
        if not self.valid():
            raise StopIteration
        v = self.value()
        self.go_up()
        return v


class CountedEnumerator(Enumerator):
    """Enumerator that tracks the running rank
    (bm::bvector::counted_enumerator, src/bm.h:733).  ``count()`` is the
    reference semantics: set bits up to AND including the current one — 1
    at the first set bit, unchanged by ++ past the end.  ``bit_count`` is
    count() minus the current unconsumed bit.  go_to()/go_first() are
    allowed (the reference closes them) and recompute the rank."""

    def go_up(self) -> bool:
        ok = super().go_up()
        self._ref_count += 1 if self.valid() else 0
        return ok

    advance = go_up       # Enumerator.advance aliases the BASE go_up

    def skip(self, n: int) -> bool:
        ok = super().skip(n)
        # the base skip moves the cursor directly: recompute the rank
        if self.valid():
            self._ref_count = self._bv.rank(self.value())
        else:
            self._ref_count = self._bv.count()
        return ok

    def go_to(self, pos: int) -> bool:
        ok = super().go_to(pos)
        if not self.valid():
            self._ref_count = self._bv.count()
        elif int(pos) == 0:
            self._ref_count = 1          # first set bit, no rank needed
        else:
            self._ref_count = self._bv.rank(self.value())
        return ok

    @property
    def bit_count(self) -> int:
        return self._ref_count - (1 if self.valid() else 0)

    def count(self) -> int:
        """reference counted_enumerator::count (src/bm.h:760)."""
        return self._ref_count


class BulkInsertIterator:
    """Buffered bulk set-bit inserter (bm::bvector::bulk_insert_iterator,
    src/bm.h:464): positions accumulate on the host and flush as one bulk
    set when the buffer fills."""

    def __init__(self, bv, buffer_size: int = 1 << 16):
        self._bv = bv
        self._buf = []
        self._cap = buffer_size

    def add(self, pos: int):
        self._buf.append(int(pos))
        if len(self._buf) >= self._cap:
            self.flush()
        return self

    __call__ = add

    def add_many(self, ids):
        self._buf.extend(int(i) for i in np.asarray(ids).ravel())
        if len(self._buf) >= self._cap:
            self.flush()
        return self

    def flush(self):
        if self._buf:
            self._bv.set_many(np.asarray(self._buf, _I64))
            self._buf.clear()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        return False


class InsertIterator(BulkInsertIterator):
    """Unbuffered-looking inserter (bm::bvector::insert_iterator,
    src/bm.h:380) — still batches under the hood."""
