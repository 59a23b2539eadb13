"""Rank-select acceleration index (port of ``bitmagic_tpu/core/rs_index.py``).

Equivalent of the reference ``bm::rs_index`` (src/bmrs.h:40): per-block
running counts for O(1) rank and log-descent select, laid out as

  * the inclusive popcount prefix ``cum[int64, n_seg]`` over allocated
    segments (ZERO blocks contribute nothing, like the reference's NULL
    super-block encoding; a FULL run is one multi-block segment), kept on
    the host and mirrored on the device with the other segment tables,
  * device: the global inclusive *wave* popcount prefix ``int32[r * 64]``
    over the pool rows (one entry per 1024 bits, finer than the
    reference's three sub-blocks per block),
  * device: the D-GAP blocks' query tables (run ends, inclusive ones
    counts and two search keys; 24 B per run), built from the host
    ``GapStore`` at the first query that needs them.

Select descends rank -> segment (searchsorted over ``cum``) -> GAP run
(searchsorted over the run keys) or wave (searchsorted over the wave
prefix) -> word -> in-word position; rank searches the segment starts.
All queries are batched and every step runs on the index's device: a
call uploads its queries once and downloads its answers once.  The
per-block counts of the build come from kernel K3.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import cuda_kernels as ck
from ..ops.select import global_wave_prefix, rank_in_rows, select_flat

_I64 = np.int64
_BPB = C.BITS_PER_BLOCK
# columns of the device segment table (RSIndex._segment_table)
(_END, _CB, _CA, _BASE, _CLS, _GKEY, _GKEYS, _GOFFS, _SLOT, _BEFORE,
 _BITOFF) = range(11)
_NCOLS = _BITOFF + 1


def _to_device(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


class RSIndex:
    """Rank/select index over one BitVector snapshot."""

    def __init__(self, nb, cls, cum, pool, size, gaps=None, span=None,
                 slots=None, gslots=None):
        self.nb = nb                   # int64[m] segment start block ids
        self.cls = cls                 # uint8[m]
        self.span = (span if span is not None
                     else np.ones(len(nb), _I64))  # blocks per segment
        self.cum = cum                 # int64[m] inclusive popcount prefix
        self.pool = pool               # device int32[r, 2048]
        self.gaps = gaps               # host GapStore (CLS_GAP blocks)
        self.gwc = (global_wave_prefix(pool) if pool.shape[0]
                    else torch.zeros(0, dtype=torch.int32,
                                     device=pool.device))
        self.size = size
        self.total = int(cum[-1]) if cum.size else 0
        if slots is None:
            is_bit = cls == C.CLS_BIT
            slots = np.where(is_bit, np.cumsum(is_bit) - 1, -1).astype(_I64)
        if gslots is None:
            is_gap = cls == C.CLS_GAP
            gslots = np.where(is_gap, np.cumsum(is_gap) - 1, -1).astype(_I64)
        self.slots = slots
        self.gslots = gslots
        self._seg = self._segment_table()
        dev = pool.device
        self._nb_dev = _to_device(nb, torch.int64, dev)
        self._cum0_dev = _to_device(np.concatenate([[0], cum]), torch.int64,
                                    dev)
        self._runs_dev = None          # GAP query tables, at first use

    def _segment_table(self) -> torch.Tensor:
        """The segment tables on the device, one int64 row per segment
        after a sentinel row 0 that no block hits (rank's "before the
        first segment"): columns ``_END`` .. ``_BITOFF``, so one gather
        gives a query all its segment's fields."""
        m, dev = len(self.nb), self.pool.device
        g = np.maximum(self.gslots, 0)
        offs = self.gaps.offs if self.gaps is not None else np.zeros(1, _I64)
        cols = np.zeros((m + 1, _NCOLS), _I64)
        cols[0, _END] = np.iinfo(_I64).min
        cols[0, _CLS] = C.CLS_ZERO
        seg = cols[1:]
        seg[:, _END] = self.nb + self.span
        seg[:, _CB] = self.cum - np.diff(self.cum, prepend=0)
        seg[:, _CA] = self.cum
        seg[:, _BASE] = self.nb << C.SET_BLOCK_SHIFT
        seg[:, _CLS] = self.cls
        seg[:, _GKEY] = g * _BPB
        seg[:, _GKEYS] = g * (_BPB + 1)
        seg[:, _GOFFS] = np.where(self.gslots >= 0, offs[g], 0)
        seg[:, _SLOT] = np.maximum(self.slots, 0)
        seg[:, _BITOFF] = seg[:, _BASE] - seg[:, _SLOT] * _BPB
        out = _to_device(cols, torch.int64, dev)
        if self.gwc.numel():
            # pool-global rank before the slot's row, for the select descent
            row0 = out[:, _SLOT] * C.BLOCK_WAVES
            out[:, _BEFORE] = torch.where(
                row0 > 0, self.gwc[(row0 - 1).clamp(min=0)].long(), 0)
        return out

    # ------------------------------------------------------------------
    @classmethod
    def build(cls_, bv) -> "RSIndex":
        """Build from a BitVector (reference build_rs_index,
        src/bm.h:2501), on the vector's device."""
        bv._flush()
        pool = bv._pool
        start, span, seg_cls, slots, gslots = bv._struct.segments()
        counts = span * C.BITS_PER_BLOCK          # FULL segments (and runs)
        counts[seg_cls != C.CLS_FULL] = 0
        is_bit = seg_cls == C.CLS_BIT
        if pool.shape[0]:
            bc = ck.block_counts(pool).cpu().numpy().astype(_I64)
            counts[is_bit] = bc[slots[is_bit]]
            # the select descent carries pool-global ranks as int32
            if int(bc.sum()) >= 2**31:
                raise ValueError(
                    "rs_index: device pool holds >= 2^31 set bits — beyond "
                    "the int32 select-descent bound; split the vector")
        is_gap = seg_cls == C.CLS_GAP
        if bv._gaps is not None and is_gap.any():
            counts[is_gap] = bv._gaps.popcounts()[gslots[is_gap]]
        return cls_(start, seg_cls, np.cumsum(counts), pool, bv.size,
                    bv._gaps, span=span, slots=slots, gslots=gslots)

    def _gap_runs(self):
        """The GAP blocks' per-run query tables on the index's device,
        built once from the host store: block-local run ends and inclusive
        ones counts as int32 pairs ``[runs, 2]``, and the search keys
        ``run_block * 65536 + ends`` (rank) and ``run_block * 65537 +
        cum1`` (select) as int64: 24 B per run."""
        if self._runs_dev is None:
            g, dev = self.gaps, self.pool.device
            rb, cum1 = g.run_block(), g._ones_cum()
            self._runs_dev = (
                _to_device(np.stack([g.ends, cum1], 1), torch.int32, dev),
                _to_device(rb * _BPB + g.ends, torch.int64, dev),
                _to_device(rb * (_BPB + 1) + cum1, torch.int64, dev))
        return self._runs_dev

    def _has_gaps(self) -> bool:
        return self.gaps is not None and self.gaps.n_blocks > 0

    # ------------------------------------------------------------------
    def count(self) -> int:
        return self.total

    def rank_batch(self, ids) -> np.ndarray:
        """rank(i) = popcount[0, i] for each id (reference count_to with
        rs_index, src/bm.h:1420); one upload of the ids, one download of
        the ranks, every step on the index's device."""
        ids = np.asarray(ids, _I64)
        if len(self.nb) == 0:
            return np.zeros(ids.shape, _I64)
        q = _to_device(ids.reshape(-1), torch.int64, self.pool.device)
        blocks = q >> C.SET_BLOCK_SHIFT
        nbit = q & C.SET_BLOCK_MASK
        # the segment at or before each block (row 0: none)
        s = self._seg[torch.searchsorted(self._nb_dev, blocks, right=True)]
        hit = blocks < s[:, _END]
        kind = torch.where(hit, s[:, _CLS], C.CLS_ZERO)
        # FULL segment containing i: in-segment offset + 1
        inblk = torch.where(kind == C.CLS_FULL, q - s[:, _BASE] + 1, 0)
        if self._has_gaps():
            # GAP block: the run holding the bit (gap_bfind analog); with
            # p the ones count minus the end of the run before it (1 for a
            # block's first run), rank = min(cum1[r], p + nbit) holds for
            # runs of ones and of zeros alike
            ec, key_end, _ = self._gap_runs()
            r = torch.searchsorted(key_end, s[:, _GKEY] + nbit)
            prev = ec[(r - 1).clamp(min=0)]
            p = torch.where(r > s[:, _GOFFS], prev[:, 1] - prev[:, 0], 1)
            inblk = torch.where(kind == C.CLS_GAP,
                                torch.minimum(ec[r, 1], p + nbit), inblk)
        # whole segments before the block, plus the in-block count
        out = torch.where(hit, s[:, _CB] + inblk, s[:, _CA])
        # BIT block containing i: in-row partial popcount
        bi = torch.nonzero(kind == C.CLS_BIT).squeeze(1)
        if bi.numel():
            out[bi] += rank_in_rows(self.pool, self.gwc, s[bi, _SLOT],
                                    nbit[bi]).long()
        return out.cpu().numpy().reshape(ids.shape)

    def rank(self, i) -> int:
        return int(self.rank_batch(np.asarray([i]))[0])

    def select_batch(self, ranks) -> np.ndarray:
        """Position of each (1-based) rank's set bit; -1 if out of range
        (reference select, src/bm.h:1705); one upload of the ranks, one
        download of the positions, every step on the index's device."""
        ranks = np.asarray(ranks, _I64)
        if self.total == 0:
            return np.full(ranks.shape, -1, _I64)
        q = _to_device(ranks.reshape(-1), torch.int64, self.pool.device)
        r = q.clamp(1, self.total)
        s = self._seg[torch.searchsorted(self._cum0_dev, r)]
        # 1-based rank within the segment (int64: FULL runs pass 2^31)
        rem = r - s[:, _CB]
        kind = s[:, _CLS]
        out = s[:, _BASE] + rem - 1    # FULL
        if self._has_gaps():
            # GAP block: the first run whose ones count reaches rem ends
            # cum1 - rem bits after the set bit
            ec, _, key_cum = self._gap_runs()
            rr = torch.searchsorted(key_cum, s[:, _GKEYS] + rem).clamp(
                max=key_cum.shape[0] - 1)
            run = ec[rr]
            out = torch.where(kind == C.CLS_GAP,
                              out + (run[:, 0] - run[:, 1] + 1), out)
        bi = torch.nonzero(kind == C.CLS_BIT).squeeze(1)
        if bi.numel():
            # the in-block rank in the pool's global rank space, resolved
            # by one flat search over the global wave prefix
            sb = s[bi]
            out[bi] = sb[:, _BITOFF] + select_flat(
                self.pool, self.gwc,
                (rem[bi] + sb[:, _BEFORE]).to(torch.int32))
        out = torch.where((q >= 1) & (q <= self.total), out, -1)
        return out.cpu().numpy().reshape(ranks.shape)

    def select(self, rank) -> int:
        return int(self.select_batch(np.asarray([rank]))[0])
