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
    ``GapStore`` at the first query (empty without D-GAP blocks).

Select descends rank -> segment (a search of ``cum``) -> GAP run (a search
of the block's runs' ones counts) or wave (the slot's row of the wave
prefix) -> word -> in-word position; rank searches the segment starts.
``rs_select`` also reads ``ops/select.select_tables`` of the index (the
segments' select records, samples of the wave prefix and of the runs'
ones counts, each wave's sector prefix), built at the first select, and
``rs_rank`` its ``rank_tables`` (the segments' rank records, samples of
the runs' ends, the same sector prefix), built at the first rank.  On the
card a batch is one launch of the hand kernel ``rs_select`` or ``rs_rank``
(``ops/csrc/rs_select.cu``) over these tables, with one upload of the
queries and one download of the answers (pageable copies, which beat a
pinned staging buffer for 1M-query batches on the card's host: PERF.md
§6); on the CPU the same call runs their plain versions
(``ops/select.py``).  The per-block counts of the build come from kernel
K3.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import cuda_kernels as ck
from ..ops.select import (BASE, BEFORE, BITOFF, CA, CB, CLS, END, GKEY,
                          GKEYS, GOFFS, SEG_COLS, SLOT, global_wave_prefix,
                          rank_tables, select_tables)

_I64 = np.int64
_BPB = C.BITS_PER_BLOCK


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
        self._runs_dev = None          # GAP query tables, at first query
        self._sel_dev = None           # rs_select's tables, at first select
        self._rank_dev = None          # rs_rank's tables, at first rank

    def _segment_table(self) -> torch.Tensor:
        """The segment tables on the device, one int64 row per segment
        after a sentinel row 0 that no block hits (rank's "before the
        first segment"): columns ``SEG_COLS`` (ops/select.py), so one gather
        gives a query all its segment's fields."""
        m, dev = len(self.nb), self.pool.device
        g = np.maximum(self.gslots, 0)
        offs = self.gaps.offs if self.gaps is not None else np.zeros(1, _I64)
        cols = np.zeros((m + 1, len(SEG_COLS)), _I64)
        cols[0, END] = np.iinfo(_I64).min
        cols[0, CLS] = C.CLS_ZERO
        seg = cols[1:]
        seg[:, END] = self.nb + self.span
        seg[:, CB] = self.cum - np.diff(self.cum, prepend=0)
        seg[:, CA] = self.cum
        seg[:, BASE] = self.nb << C.SET_BLOCK_SHIFT
        seg[:, CLS] = self.cls
        seg[:, GKEY] = g * _BPB
        seg[:, GKEYS] = g * (_BPB + 1)
        seg[:, GOFFS] = np.where(self.gslots >= 0, offs[g], 0)
        seg[:, SLOT] = np.maximum(self.slots, 0)
        seg[:, BITOFF] = seg[:, BASE] - seg[:, SLOT] * _BPB
        out = _to_device(cols, torch.int64, dev)
        if self.gwc.numel():
            # pool-global rank before the slot's row, for the select descent
            row0 = out[:, SLOT] * C.BLOCK_WAVES
            out[:, BEFORE] = torch.where(
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
        cum1`` (select) as int64: 24 B per run; empty tables when the
        vector has no D-GAP block."""
        if self._runs_dev is None:
            dev = self.pool.device
            if self.gaps is not None and self.gaps.n_blocks > 0:
                g = self.gaps
                rb, cum1 = g.run_block(), g._ones_cum()
                ends_ones = np.stack([g.ends, cum1], 1)
                keys = (rb * _BPB + g.ends, rb * (_BPB + 1) + cum1)
            else:
                ends_ones = np.zeros((0, 2), np.int32)
                keys = (np.zeros(0, _I64),) * 2
            self._runs_dev = (_to_device(ends_ones, torch.int32, dev),
                              *(_to_device(k, torch.int64, dev)
                                for k in keys))
        return self._runs_dev

    def _select_tables(self):
        """``ops/select.select_tables`` of the index (the segments'
        select records and the wave and run samples ``rs_select``
        searches), built once on the index's device at the first
        select."""
        if self._sel_dev is None:
            self._sel_dev = select_tables(self._seg, self._gap_runs(),
                                          self.pool, self.gwc)
        return self._sel_dev

    def _rank_tables(self):
        """``ops/select.rank_tables`` of the index (the segments' rank
        records, the run-end samples ``rs_rank`` searches and each wave's
        rank pair, from the select tables' sector prefix), built once on
        the index's device at the first rank."""
        if self._rank_dev is None:
            self._rank_dev = rank_tables(self._seg, self._gap_runs(),
                                         self.gwc, self._select_tables().wsp)
        return self._rank_dev

    def _batch(self, values, answer) -> np.ndarray:
        """``answer(queries)`` over int64 ``values`` on the index's device:
        one upload of the queries, one download of the answers."""
        values = np.asarray(values, _I64)
        q = _to_device(values.reshape(-1), torch.int64, self.pool.device)
        return answer(q).cpu().numpy().reshape(values.shape)

    # ------------------------------------------------------------------
    def count(self) -> int:
        return self.total

    def rank_batch(self, ids) -> np.ndarray:
        """rank(i) = popcount[0, i] for each id (reference count_to with
        rs_index, src/bm.h:1420): one ``rs_rank`` launch on the card."""
        ids = np.asarray(ids, _I64)
        if len(self.nb) == 0:
            return np.zeros(ids.shape, _I64)
        runs, tables = self._gap_runs(), self._rank_tables()
        return self._batch(ids, lambda q: ck.rs_rank(
            self._seg, self._nb_dev, runs, self.pool, self.gwc, q, tables))

    def rank(self, i) -> int:
        return int(self.rank_batch(np.asarray([i]))[0])

    def select_batch(self, ranks) -> np.ndarray:
        """Position of each (1-based) rank's set bit; -1 if out of range
        (reference select, src/bm.h:1705): one ``rs_select`` launch on the
        card."""
        ranks = np.asarray(ranks, _I64)
        if self.total == 0:
            return np.full(ranks.shape, -1, _I64)
        runs, tables = self._gap_runs(), self._select_tables()
        return self._batch(ranks, lambda q: ck.rs_select(
            self._seg, self._cum0_dev, runs, self.pool, self.gwc, q,
            self.total, tables))

    def select(self, rank) -> int:
        return int(self.select_batch(np.asarray([rank]))[0])
