"""Host-resident D-GAP block store: the succinct in-memory representation
(own copy of ``bitmagic_tpu/core/gapstore.py``; numpy only).

The reference keeps sparse blocks as D-GAP buffers (uint16 run boundaries,
src/bmfunc.h gap_* family; storage src/bmblocks.h:1245 set_gap_block) so a
mostly-empty 2^32-bit vector costs KBs, not MBs.  The design keeps GAP
content OFF the device: device memory holds only dense BIT rows, while CLS_GAP blocks
live here as one concatenated run-boundary table on the host.  Device ops
expand touched GAP blocks to transient dense rows (the batched analog of
gap_convert_to_bitset, src/bmfunc.h:5223); queries (test/rank/select/count)
answer directly from the runs with segmented searchsorted — the vectorized
analog of gap_bfind / gap_test (src/bmfunc.h:1835,1943).

Layout (all blocks concatenated, in the owner's CLS_GAP nb order):

  ends : int64[total]  inclusive last bit index of each run; per block the
                       values are strictly increasing and end with 65535
  offs : int64[m+1]    run-range of block k is ends[offs[k]:offs[k+1]]
  first: uint8[m]      bit value of run 0 (runs alternate)

The run count of block k equals the reference GC stat (bit_block_calc_change)
and the GAP buffer word length is n_runs+1 (head word + boundaries), matching
core/gaps.py classification conventions.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C

_I64 = np.int64
_BPB = C.BITS_PER_BLOCK          # 65536


class GapStore:
    """Immutable batch of D-GAP blocks (rebuild on structural change)."""

    __slots__ = ("ends", "offs", "first", "_run_block", "_cum1", "_bc",
                 "_dense", "_ends32")

    def __init__(self, ends, offs, first):
        self.ends = np.asarray(ends, _I64)
        self.offs = np.asarray(offs, _I64)
        self.first = np.asarray(first, np.uint8)
        self._run_block = None
        self._cum1 = None
        self._bc = None
        self._dense = None        # cached full expansion (store is immutable)
        self._ends32 = None       # cached int32 ends (native stream-op view)

    def ends_i32(self) -> np.ndarray:
        """Block-local run ends as int32 (the native stream engine's
        run-coded target form); cached — the store is immutable."""
        if self._ends32 is None:
            self._ends32 = self.ends.astype(np.int32)
        return self._ends32

    # ------------------------------------------------------------------
    @classmethod
    def empty(cls) -> "GapStore":
        return cls(np.zeros(0, _I64), np.zeros(1, _I64), np.zeros(0, np.uint8))

    @property
    def n_blocks(self) -> int:
        return len(self.first)

    def memory_bytes(self) -> int:
        return self.ends.nbytes + self.offs.nbytes + self.first.nbytes

    # ------------------------------------------------------------------
    # derived tables (lazy)
    # ------------------------------------------------------------------
    def run_block(self) -> np.ndarray:
        """int64[total]: owning block index of each run."""
        if self._run_block is None:
            counts = np.diff(self.offs)
            self._run_block = np.repeat(
                np.arange(self.n_blocks, dtype=_I64), counts)
        return self._run_block

    def _ones_cum(self) -> np.ndarray:
        """int64[total]: within-block inclusive count of 1-bits through the
        end of each run."""
        if self._cum1 is None:
            rb = self.run_block()
            prev = np.empty_like(self.ends)
            if self.ends.size:
                prev[1:] = self.ends[:-1]
                prev[self.offs[:-1]] = -1
            run_len = self.ends - prev
            local = np.arange(self.ends.size, dtype=_I64) - self.offs[rb]
            val = (self.first[rb].astype(_I64) ^ (local & 1))
            cum = np.cumsum(run_len * val)
            base = np.zeros(self.n_blocks, _I64)
            if self.n_blocks:
                base[1:] = cum[self.offs[1:-1] - 1]
            self._cum1 = cum - base[rb]
        return self._cum1

    def popcounts(self) -> np.ndarray:
        """int64[m]: set-bit count per block."""
        if self._bc is None:
            if self.n_blocks == 0:
                self._bc = np.zeros(0, _I64)
            else:
                self._bc = self._ones_cum()[self.offs[1:] - 1]
        return self._bc

    def n_runs(self) -> np.ndarray:
        return np.diff(self.offs)

    def gap_lens(self) -> np.ndarray:
        """GAP buffer word count per block (GC+1 convention, core/gaps.py)."""
        return self.n_runs() + 1

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------
    @classmethod
    def from_dense(cls, words: np.ndarray) -> "GapStore":
        """Build from dense uint32[n, 2048] rows (bit_block_to_gap analog,
        src/bmfunc.h:5533), vectorized over the whole batch."""
        words = np.ascontiguousarray(words, np.uint32)
        n = words.shape[0]
        if n == 0:
            return cls.empty()
        bits = np.unpackbits(
            words.view(np.uint8), bitorder="little").reshape(n, _BPB)
        d = bits[:, 1:] != bits[:, :-1]
        rows, pos = np.nonzero(d)
        counts = np.bincount(rows, minlength=n)
        offs = np.zeros(n + 1, _I64)
        np.cumsum(counts + 1, out=offs[1:])
        ends = np.empty(int(offs[-1]), _I64)
        # boundary runs: each change position is the last index of a run
        idx = np.arange(rows.size, dtype=_I64) + offs[rows] - \
            np.cumsum(counts)[rows] + counts[rows]
        ends[idx] = pos
        ends[offs[1:] - 1] = _BPB - 1
        return cls(ends, offs, bits[:, 0].copy())

    def to_dense(self, sel=None) -> np.ndarray:
        """uint32[k, 2048] dense rows for the selected blocks (all when sel
        is None) — batched gap_convert_to_bitset (src/bmfunc.h:5223), by
        the native library's word-level span fills.  The full expansion of
        a store of at most 1024 blocks is cached (stores are immutable)."""
        if sel is not None and self._dense is not None:
            return self._dense[np.asarray(sel)]
        if (sel is not None and self.n_blocks <= 1024
                and len(np.asarray(sel)) * 8 >= self.n_blocks):
            # bulk slicing of a small store: build the (bounded, <= 8 MB)
            # full expansion once so repeated walks hit the cache; large
            # stores keep strict O(sel) expansion (succinct guarantee)
            self.to_dense(None)
            return self._dense[np.asarray(sel)]
        # imported here: the serial package imports this module
        from ..serial import native
        sub = self if sel is None else self.subset(sel)
        rows = native.gaps_to_dense(sub.ends, sub.offs, sub.first)
        if sel is None and sub.n_blocks <= 1024:
            # cache small expansions only: pinning a large dense image
            # would defeat the succinct residency this store provides
            self._dense = rows
        return rows

    @classmethod
    def concat(cls, a: "GapStore | None", b: "GapStore | None") -> "GapStore":
        """Store holding a's blocks (indices 0..) then b's."""
        if a is None or a.n_blocks == 0:
            return b if b is not None else cls.empty()
        if b is None or b.n_blocks == 0:
            return a
        return cls(np.concatenate([a.ends, b.ends]),
                   np.concatenate([a.offs, a.offs[-1] + b.offs[1:]]),
                   np.concatenate([a.first, b.first]))

    @classmethod
    def concat_many(cls, parts) -> "GapStore | None":
        """One multi-way concat of an ordered part list (linear, unlike a
        pairwise-concat fold which re-copies the growing arrays per part)."""
        parts = [p for p in parts if p is not None and p.n_blocks > 0]
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        bases = np.cumsum([0] + [int(p.offs[-1]) for p in parts[:-1]])
        return cls(np.concatenate([p.ends for p in parts]),
                   np.concatenate([parts[0].offs]
                                  + [b + p.offs[1:]
                                     for b, p in zip(bases[1:], parts[1:])]),
                   np.concatenate([p.first for p in parts]))

    def subset(self, sel) -> "GapStore":
        """New store holding blocks sel (index array or bool mask)."""
        sel = np.asarray(sel)
        if sel.dtype == bool:
            sel = np.flatnonzero(sel)
        sel = sel.astype(_I64)
        counts = np.diff(self.offs)[sel]
        offs = np.zeros(sel.size + 1, _I64)
        np.cumsum(counts, out=offs[1:])
        take = (np.arange(int(offs[-1]), dtype=_I64)
                - np.repeat(offs[:-1], counts)
                + np.repeat(self.offs[sel], counts))
        return GapStore(self.ends[take], offs, self.first[sel])

    # ------------------------------------------------------------------
    # queries (all batched; blk = store-local block indices)
    # ------------------------------------------------------------------
    def _find_runs(self, blk, nbit):
        """Global run index containing in-block bit nbit, per query."""
        key = self.run_block() * _BPB + self.ends
        q = np.asarray(blk, _I64) * _BPB + np.asarray(nbit, _I64)
        return np.searchsorted(key, q, side="left")

    def test_bits(self, blk, nbit) -> np.ndarray:
        """bool[n]: bit value (gap_test analog, src/bmfunc.h:1943)."""
        blk = np.asarray(blk, _I64)
        r = self._find_runs(blk, nbit)
        local = r - self.offs[blk]
        return ((self.first[blk].astype(_I64) ^ (local & 1)) == 1)

    def rank_in_block(self, blk, nbit) -> np.ndarray:
        """int64[n]: count of 1-bits in [0, nbit] within each block.
        nbit = -1 yields 0."""
        blk = np.asarray(blk, _I64)
        nbit = np.asarray(nbit, _I64)
        out = np.zeros(blk.shape, _I64)
        ok = nbit >= 0
        if not ok.any():
            return out
        b, nb_ = blk[ok], np.minimum(nbit[ok], _BPB - 1)
        r = self._find_runs(b, nb_)
        cum = self._ones_cum()
        local = r - self.offs[b]
        val = (self.first[b].astype(_I64) ^ (local & 1))
        prev_end = np.where(local > 0, self.ends[np.maximum(r - 1, 0)], -1)
        ones_before = np.where(local > 0, cum[np.maximum(r - 1, 0)], 0)
        out[ok] = ones_before + (nb_ - prev_end) * val
        return out

    def count_range(self, blk, lo, hi) -> np.ndarray:
        """int64[n]: ones in [lo, hi] per query (gap_bit_count_range)."""
        lo = np.asarray(lo, _I64)
        return self.rank_in_block(blk, hi) - self.rank_in_block(blk, lo - 1)

    def select_in_block(self, blk, rank) -> np.ndarray:
        """int64[n]: in-block position of the rank-th (1-based) set bit.
        Caller guarantees 1 <= rank <= popcount(blk)."""
        blk = np.asarray(blk, _I64)
        rank = np.asarray(rank, _I64)
        cum = self._ones_cum()
        # per-block keys: cum is non-decreasing within a block, <= 65536
        key = self.run_block() * (_BPB + 1) + cum
        q = blk * (_BPB + 1) + rank
        r = np.searchsorted(key, q, side="left")
        return self.ends[r] - (cum[r] - rank)

    def find_in_block(self, blk, from_bit) -> np.ndarray:
        """int64[n]: first set bit >= from_bit within each block, or -1."""
        blk = np.asarray(blk, _I64)
        before = self.rank_in_block(blk, np.asarray(from_bit, _I64) - 1)
        bc = self.popcounts()[blk]
        out = np.full(blk.shape, -1, _I64)
        ok = before < bc
        if ok.any():
            out[ok] = self.select_in_block(blk[ok], before[ok] + 1)
        return out

    def complement(self) -> "GapStore":
        """Bitwise NOT of every block: same boundaries, flipped start value
        (the D-GAP complement trick the reference uses for gapcmpr)."""
        return GapStore(self.ends, self.offs, self.first ^ 1)

    def indices_concat(self, bases) -> np.ndarray:
        """All set-bit positions across all blocks, offset by the per-block
        int64 ``bases``, in ascending order (bases must be ascending)."""
        if self.n_blocks == 0:
            return np.zeros(0, _I64)
        rb = self.run_block()
        prev = np.empty_like(self.ends)
        prev[1:] = self.ends[:-1]
        prev[self.offs[:-1]] = -1
        local = np.arange(self.ends.size, dtype=_I64) - self.offs[rb]
        is_one = (self.first[rb].astype(_I64) ^ (local & 1)) == 1
        starts = (prev + 1 + np.asarray(bases, _I64)[rb])[is_one]
        lens = (self.ends - prev)[is_one]
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, _I64)
        base_rep = np.repeat(starts, lens)
        cum_excl = np.concatenate([[0], np.cumsum(lens)[:-1]])
        return base_rep + np.arange(total, dtype=_I64) - \
            np.repeat(cum_excl, lens)


def gap_binary_op(op: str, store_a: GapStore, sel_a, store_b: GapStore,
                  sel_b):
    """Set-op over aligned GAP block pairs entirely in the run domain —
    the vectorized analog of the reference's gap_buff_op merge
    (src/bmfunc.h:3738): no dense expansion, results stay succinct.

    sel_a/sel_b: store-local block indices, aligned (pair k = A[sel_a[k]]
    op B[sel_b[k]]).  Returns (result GapStore over the K pairs,
    zero_mask bool[K], full_mask bool[K]): blocks whose result is
    all-zero/all-one carry no runs in the store (1-run entries) and are
    flagged for symbolic classification by the caller.
    """
    A = store_a.subset(sel_a)
    B = store_b.subset(sel_b)
    K = A.n_blocks
    if K == 0:
        return GapStore.empty(), np.zeros(0, bool), np.zeros(0, bool)
    # merged event set per pair: union of both boundary lists (sorted,
    # deduplicated) via the per-block key trick
    keyA = A.run_block() * _BPB + A.ends
    keyB = B.run_block() * _BPB + B.ends
    keys = np.sort(np.concatenate([keyA, keyB]), kind="stable")
    dup = np.zeros(keys.size, bool)
    dup[1:] = keys[1:] == keys[:-1]
    keys = keys[~dup]
    blk = keys // _BPB
    ends = keys % _BPB
    # run value of each operand over the segment ending at each event
    val_a = (A.first[blk].astype(_I64)
             ^ ((np.searchsorted(keyA, keys) - A.offs[blk]) & 1))
    val_b = (B.first[blk].astype(_I64)
             ^ ((np.searchsorted(keyB, keys) - B.offs[blk]) & 1))
    if op == "and":
        val = val_a & val_b
    elif op == "or":
        val = val_a | val_b
    elif op == "xor":
        val = val_a ^ val_b
    elif op == "sub":
        val = val_a & (1 - val_b)
    else:
        raise ValueError(op)
    # compress: keep an event iff it is the last of its block or its value
    # differs from the NEXT event's value (same block)
    last_of_blk = np.ones(keys.size, bool)
    last_of_blk[:-1] = blk[:-1] != blk[1:]
    keep = last_of_blk.copy()
    keep[:-1] |= val[:-1] != val[1:]
    ends_r = ends[keep]
    blk_r = blk[keep]
    counts = np.bincount(blk_r, minlength=K)
    offs_r = np.zeros(K + 1, _I64)
    np.cumsum(counts, out=offs_r[1:])
    # first value of each block = value of its first kept segment
    first_r = val[keep][offs_r[:-1]].astype(np.uint8)
    res = GapStore(ends_r, offs_r, first_r)
    one_run = counts == 1
    zero_mask = one_run & (first_r == 0)
    full_mask = one_run & (first_r == 1)
    return res, zero_mask, full_mask


def gap_metric_counts(store_a: GapStore, sel_a, store_b: GapStore, sel_b):
    """All pairwise popcount metrics over aligned GAP block pairs from ONE
    merged event sweep (the run-domain analog of the reference's
    combine_count_operation_with_block, src/bmalgo_impl.h:406).

    Returns a dict of int64[K] arrays: and_, or_, xor_, sub_ab, sub_ba,
    a_, b_ — per-block popcounts of the respective combinations."""
    A = store_a.subset(sel_a)
    B = store_b.subset(sel_b)
    K = A.n_blocks
    if K == 0:
        z = np.zeros(0, _I64)
        return {k: z for k in ("and_", "or_", "xor_", "sub_ab", "sub_ba",
                               "a_", "b_")}
    keyA = A.run_block() * _BPB + A.ends
    keyB = B.run_block() * _BPB + B.ends
    keys = np.sort(np.concatenate([keyA, keyB]), kind="stable")
    dup = np.zeros(keys.size, bool)
    dup[1:] = keys[1:] == keys[:-1]
    keys = keys[~dup]
    blk = keys // _BPB
    ends = keys % _BPB
    prev = np.empty_like(ends)
    prev[1:] = ends[:-1]
    first_of_blk = np.ones(keys.size, bool)
    first_of_blk[1:] = blk[1:] != blk[:-1]
    prev[first_of_blk] = -1
    seg = ends - prev
    val_a = (A.first[blk].astype(_I64)
             ^ ((np.searchsorted(keyA, keys) - A.offs[blk]) & 1))
    val_b = (B.first[blk].astype(_I64)
             ^ ((np.searchsorted(keyB, keys) - B.offs[blk]) & 1))

    def tot(cond):
        return np.bincount(blk, weights=seg * cond,
                           minlength=K).astype(_I64)

    return {
        "and_": tot(val_a & val_b),
        "or_": tot(val_a | val_b),
        "xor_": tot(val_a ^ val_b),
        "sub_ab": tot(val_a & (1 - val_b)),
        "sub_ba": tot(val_b & (1 - val_a)),
        "a_": tot(val_a),
        "b_": tot(val_b),
    }


def const_extended(store: "GapStore | None"):
    """(store', zero_idx, full_idx): the store with two synthetic 1-run
    blocks appended (all-zero, all-one) so symbolic FULL/ZERO operands can
    join run-domain sweeps as ordinary blocks."""
    consts = GapStore(np.asarray([_BPB - 1, _BPB - 1], _I64),
                      np.asarray([0, 1, 2], _I64),
                      np.asarray([0, 1], np.uint8))
    base = store.n_blocks if store is not None else 0
    return GapStore.concat(store, consts), base, base + 1


def from_positions(blk: np.ndarray, pos: np.ndarray):
    """Build a GapStore directly from sorted set-bit coordinates — the
    BM_GAP allocation strategy (reference check_allocate_block with
    BM_GAP, src/bmblocks.h:1076): no dense materialization anywhere.

    blk: int64[n] owning STORE-LOCAL block index per bit (ascending);
    pos: int64[n] in-block position (ascending within each block).
    Returns (store, bc) where bc[m] are per-block popcounts.
    """
    blk = np.asarray(blk, _I64)
    pos = np.asarray(pos, _I64)
    m = int(blk[-1]) + 1 if blk.size else 0
    if m == 0:
        return GapStore.empty(), np.zeros(0, _I64)
    # the +1 gap guarantees a break at every block boundary (a run of
    # consecutive bits never crosses blocks in the D-GAP representation)
    key = blk * (_BPB + 1) + pos
    brk = np.ones(key.size, bool)
    brk[1:] = np.diff(key) > 1
    seg_start = key[brk]                     # gapped coords of run starts
    end_mask = np.empty(key.size, bool)
    end_mask[:-1] = brk[1:]
    end_mask[-1] = True
    seg_end = key[end_mask]
    sblk = seg_start // (_BPB + 1)
    s_in = seg_start % (_BPB + 1)
    e_in = seg_end % (_BPB + 1)
    # events per segment: a 0-run end before it (when it does not start at
    # bit 0) and the 1-run end; plus a trailing 65535 zero-run end per
    # block whose last segment stops early
    ev_blk = [sblk[s_in > 0], sblk]
    ev_end = [s_in[s_in > 0] - 1, e_in]
    last_of_blk = np.empty(sblk.size, bool)
    last_of_blk[:-1] = sblk[:-1] != sblk[1:]
    last_of_blk[-1] = True
    tail = last_of_blk & (e_in < _BPB - 1)
    ev_blk.append(sblk[tail])
    ev_end.append(np.full(int(tail.sum()), _BPB - 1, _I64))
    ekey = np.sort(np.concatenate(
        [b * _BPB + e for b, e in zip(ev_blk, ev_end)]))
    eb = ekey // _BPB
    ends = ekey % _BPB
    counts = np.bincount(eb, minlength=m)
    offs = np.zeros(m + 1, _I64)
    np.cumsum(counts, out=offs[1:])
    first = np.zeros(m, np.uint8)
    first_seg = np.ones(sblk.size, bool)
    first_seg[1:] = sblk[1:] != sblk[:-1]
    starts0 = sblk[first_seg & (s_in == 0)]
    first[starts0] = 1
    bc = np.bincount(sblk, weights=(seg_end - seg_start + 1),
                     minlength=m).astype(_I64)
    return GapStore(ends, offs, first), bc
