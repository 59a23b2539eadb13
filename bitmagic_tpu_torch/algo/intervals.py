"""Interval (run) views over bit-vectors (port of
``bitmagic_tpu/algo/intervals.py``).

Equivalent of `src/bmintervals.h`: a bit-vector as a sequence of ranges of
1s — interval_enumerator (:52), is_interval (:248), find_interval_start /
end (:315, 438).
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..core.bitvector import BitVector
from ..serial import native


def _block_one_runs(base: int, ends, first: int) -> np.ndarray:
    """Inclusive (start, end) ones-runs of ONE block from its D-GAP run
    ends (ascending, last = block_max); O(runs)."""
    ends = np.asarray(ends, np.int64)
    starts = np.concatenate([[0], ends[:-1] + 1])
    k = np.arange(ends.size)
    ones = ((k & 1) == 0) if first else ((k & 1) == 1)
    return np.stack([base + starts[ones], base + ends[ones]], axis=1)


def intervals(bv: BitVector) -> np.ndarray:
    """All maximal runs of set bits as an [n, 2] int64 array of inclusive
    (start, end) pairs (interval_enumerator equivalent).

    Without FULL runs: from the positions of ``indices()``.  With them:
    from the segment view — a FULL run is ONE interval whatever its width,
    a GAP block gives its runs from the host store, a dense row its run
    boundaries from the native library (one host copy of the pool)."""
    bv._flush()
    st = bv._struct
    if not st.has_runs:
        idx = bv.indices()
        if idx.size == 0:
            return np.zeros((0, 2), np.int64)
        brk = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate([[idx[0]], idx[brk + 1]])
        ends = np.concatenate([idx[brk], [idx[-1]]])
        return np.stack([starts, ends], axis=1)
    B = C.BITS_PER_BLOCK
    start, span, cls, slot, gslot = st.segments()
    rows = bv._pool_host() if (cls == C.CLS_BIT).any() else None
    parts = []
    for i in range(start.size):
        base = int(start[i]) << C.SET_BLOCK_SHIFT
        if cls[i] == C.CLS_FULL:
            parts.append(np.asarray(
                [[base, base + int(span[i]) * B - 1]], np.int64))
        elif cls[i] == C.CLS_GAP:
            g = bv._gaps
            k = int(gslot[i])
            e = g.ends[g.offs[k]:g.offs[k + 1]]
            parts.append(_block_one_runs(base, e, int(g.first[k])))
        else:
            first_val, bounds = native.block_gap_boundaries(rows[int(slot[i])])
            parts.append(_block_one_runs(base, bounds, first_val))
    # a FULL run is always among the parts here
    iv = np.concatenate([p for p in parts if p.size])
    if iv.shape[0] <= 1:
        return iv
    # merge runs that touch across block/segment boundaries
    brk = np.concatenate([[True], iv[1:, 0] > iv[:-1, 1] + 1])
    last = np.concatenate([brk[1:], [True]])
    return np.stack([iv[brk, 0], iv[last, 1]], axis=1)


def interval_enumerator(bv: BitVector):
    """Generator over (start, end) runs (reference interval_enumerator,
    src/bmintervals.h:52); IntervalEnumerator has the reference's stateful
    shape."""
    for s, e in intervals(bv):
        yield int(s), int(e)


class IntervalEnumerator:
    """Stateful run iterator mirroring bm::interval_enumerator<BV>
    (src/bmintervals.h:52): valid()/start()/end()/advance()/go_to().
    go_to(pos, extend_start) lands on the interval containing pos —
    clipped to start at pos unless extend_start — or the next one."""

    def __init__(self, bv: BitVector, start_pos: int = 0,
                 extend_start: bool = True):
        self._iv = intervals(bv)
        self.go_to(start_pos, extend_start)

    def valid(self) -> bool:
        return 0 <= self._i < len(self._iv)

    def start(self) -> int:
        if not self.valid():
            raise StopIteration
        return self._cur[0]

    def end(self) -> int:
        if not self.valid():
            raise StopIteration
        return self._cur[1]

    def advance(self) -> bool:
        self._i += 1
        if self.valid():
            self._cur = (int(self._iv[self._i, 0]),
                         int(self._iv[self._i, 1]))
            return True
        return False

    go_up = advance

    def go_to(self, pos: int, extend_start: bool = True) -> bool:
        pos = int(pos)
        # first interval whose end >= pos
        i = int(np.searchsorted(self._iv[:, 1], pos)) \
            if self._iv.shape[0] else 0
        if i < self._iv.shape[0]:
            s, e = int(self._iv[i, 0]), int(self._iv[i, 1])
            self._i = i
            self._cur = (s if extend_start or s >= pos else pos, e)
            return True
        self._i = self._iv.shape[0]
        self._cur = None
        return False

    def __iter__(self):
        while self.valid():
            yield self._cur
            self.advance()


def is_interval(bv: BitVector, lo: int, hi: int) -> bool:
    """True if [lo, hi] is exactly one maximal run: all bits set, flanked by
    clear bits (reference is_interval, src/bmintervals.h:248)."""
    lo, hi = int(lo), int(hi)
    if hi < lo or lo < 0:
        return False
    if not bv.count_range(lo, hi) == hi - lo + 1:
        return False
    if lo > 0 and bv.test(lo - 1):
        return False
    if hi + 1 < bv.size and bv.test(hi + 1):
        return False
    return True


def find_interval_start(bv: BitVector, pos: int):
    """Start of the run containing pos, or None if bit pos is clear
    (reference find_interval_start, src/bmintervals.h:315): a binary
    search over count_range."""
    pos = int(pos)
    if not bv.test(pos):
        return None
    lo_s, hi_s = 0, pos
    while lo_s < hi_s:
        mid = (lo_s + hi_s) // 2
        if bv.count_range(mid, pos) == pos - mid + 1:
            hi_s = mid
        else:
            lo_s = mid + 1
    return lo_s


def find_interval_end(bv: BitVector, pos: int):
    """End of the run containing pos, or None (reference
    find_interval_end, src/bmintervals.h:438)."""
    pos = int(pos)
    if not bv.test(pos):
        return None
    lo_s, hi_s = pos, bv.size - 1
    while lo_s < hi_s:
        mid = (lo_s + hi_s + 1) // 2
        if bv.count_range(pos, mid) == mid - pos + 1:
            lo_s = mid
        else:
            hi_s = mid - 1
    return lo_s


def count_intervals(bv: BitVector) -> int:
    """Number of maximal runs of EITHER value over [0, size) (reference
    count_intervals, src/bmalgo_impl.h:1389: transitions + 1, corrected
    when the last bit is set).  An empty vector is one zero-interval."""
    runs = intervals(bv)
    r = runs.shape[0]
    if r == 0:
        return 1
    first0 = int(runs[0, 0] == 0)
    endmax = int(runs[-1, 1] == bv.size - 1)
    return 2 * r + 1 - first0 - endmax
