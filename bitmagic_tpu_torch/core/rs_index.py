"""Rank-select acceleration index (port of ``bitmagic_tpu/core/rs_index.py``).

Equivalent of the reference ``bm::rs_index`` (src/bmrs.h:40): per-block
running counts for O(1) rank and log-descent select, laid out as

  * host: inclusive popcount prefix ``cum[int64, n_seg]`` over allocated
    segments (ZERO blocks contribute nothing, like the reference's NULL
    super-block encoding; a FULL run is one multi-block segment),
  * device: the global inclusive *wave* popcount prefix ``int32[r * 64]``
    over the pool rows (one entry per 1024 bits, finer than the
    reference's three sub-blocks per block).

Select descends rank -> segment (host searchsorted over ``cum``) -> wave
(device searchsorted over the wave prefix) -> word -> in-word position.
All queries are batched: a million ranks resolve in one pass of tensor ops.
The per-block counts of the build come from kernel K3.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import cuda_kernels as ck
from ..ops.select import global_wave_prefix, rank_in_rows, select_flat

_I64 = np.int64


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
        self._gwc_cache = None
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

    def _gwc_host(self):
        if self._gwc_cache is None:
            self._gwc_cache = self.gwc.cpu().numpy().astype(np.int64)
        return self._gwc_cache

    # ------------------------------------------------------------------
    def count(self) -> int:
        return self.total

    def rank_batch(self, ids) -> np.ndarray:
        """rank(i) = popcount[0, i] for each id (reference count_to with
        rs_index, src/bm.h:1420)."""
        ids = np.asarray(ids, _I64)
        out = np.zeros(ids.shape, _I64)
        if len(self.nb) == 0:
            return out
        blocks = ids >> C.SET_BLOCK_SHIFT
        # segment at or before each block (segments may span many blocks)
        pos = np.searchsorted(self.nb, blocks, side="right") - 1
        pos_c = np.maximum(pos, 0)
        hit = (pos >= 0) & (blocks < self.nb[pos_c] + self.span[pos_c])
        # whole segments strictly before the queried block
        out += np.where(hit,
                        np.where(pos_c > 0,
                                 self.cum[np.maximum(pos_c - 1, 0)], 0),
                        np.where(pos >= 0, self.cum[pos_c], 0))
        cls_at = self.cls[pos_c]
        # FULL segment containing i: in-segment offset + 1
        fullm = hit & (cls_at == C.CLS_FULL)
        out[fullm] += (ids[fullm]
                       - (self.nb[pos_c[fullm]] << C.SET_BLOCK_SHIFT)) + 1
        # GAP block containing i: host run arithmetic (gap_bfind analog)
        gapm = hit & (cls_at == C.CLS_GAP)
        if gapm.any():
            g = self.gslots[pos_c[gapm]]
            out[gapm] += self.gaps.rank_in_block(
                g, ids[gapm] & C.SET_BLOCK_MASK)
        # BIT block containing i: in-row partial popcount on the device
        bitm = hit & (cls_at == C.CLS_BIT)
        if bitm.any():
            dev = self.pool.device
            part = rank_in_rows(
                self.pool, self.gwc,
                _to_device(self.slots[pos_c[bitm]], torch.int64, dev),
                _to_device(ids[bitm] & C.SET_BLOCK_MASK, torch.int32, dev))
            out[bitm] += part.cpu().numpy().astype(_I64)
        return out

    def rank(self, i) -> int:
        return int(self.rank_batch(np.asarray([i]))[0])

    def select_batch(self, ranks) -> np.ndarray:
        """Position of each (1-based) rank's set bit; -1 if out of range
        (reference select, src/bm.h:1705)."""
        ranks = np.asarray(ranks, _I64)
        out = np.full(ranks.shape, -1, _I64)
        ok = (ranks >= 1) & (ranks <= self.total)
        if not ok.any():
            return out
        r = ranks[ok]
        entry = np.searchsorted(self.cum, r, side="left")
        base_rank = np.where(entry > 0, self.cum[np.maximum(entry - 1, 0)], 0)
        rem = r - base_rank                  # 1-based in segment (int64:
        blk_base = self.nb[entry] << C.SET_BLOCK_SHIFT   # runs pass 2^31)
        res = np.empty(r.shape, _I64)
        fullm = self.cls[entry] == C.CLS_FULL
        res[fullm] = blk_base[fullm] + rem[fullm] - 1
        gapm = self.cls[entry] == C.CLS_GAP
        if gapm.any():
            g = self.gslots[entry[gapm]]
            res[gapm] = blk_base[gapm] + self.gaps.select_in_block(
                g, rem[gapm])
        bitm = ~fullm & ~gapm
        if bitm.any():
            slots = self.slots[entry[bitm]].astype(np.int64)
            # the in-block rank in the pool's global rank space, resolved
            # by one flat search over the global wave prefix
            gwc_np = self._gwc_host()
            before = np.where(slots > 0,
                              gwc_np[np.maximum(slots * C.BLOCK_WAVES - 1, 0)],
                              0)
            granks = rem[bitm] + before
            pos_flat = select_flat(
                self.pool, self.gwc,
                _to_device(granks, torch.int32, self.pool.device))
            in_block = pos_flat.cpu().numpy() - slots * C.BITS_PER_BLOCK
            res[bitm] = blk_base[bitm] + in_block
        out[ok] = res
        return out

    def select(self, rank) -> int:
        return int(self.select_batch(np.asarray([rank]))[0])
