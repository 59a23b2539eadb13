"""Batched in-pool select and rank (port of ``bitmagic_tpu/ops/select.py``
and of the rank/select batches of ``bitmagic_tpu/core/rs_index.py``): the
plain PyTorch versions of the ``rs_select`` / ``rs_rank`` kernels
(``ops/csrc/rs_select.cu``).  ``ops/cuda_kernels`` runs them only for
tensors on the CPU; on the card the same signatures launch the kernels.

The wave-descent formulation: instead of gathering the whole 8 KiB block
row per query, search a per-wave popcount prefix table (256 B/row) and
gather only the query's 128 B wave; in-word select is the binary popcount
descent (bm::word_select32 analog, src/bmfunc.h:1075).  The JAX package's
sampled bucket search and f32 matmul cumsum were shaped for the TPU's
vector and matrix units; here the wave search is one
``torch.searchsorted`` over the prefix (the same count of prefix entries
below each rank) and the word prefix an int32 cumsum.

``rs_select`` and ``rs_rank`` answer a whole batch over an rs-index's
device tables: the segment table ``seg`` (columns ``SEG_COLS``, one row
per segment after a sentinel row 0), ``cum0`` (0, then the inclusive ones
prefix over segments), the segments' first blocks ``nb``, the D-GAP run
tables ``runs = (ends_ones int32[R, 2], key_end int64[R], key_cum
int64[R])`` (empty without D-GAP blocks), the pool and its global wave
prefix ``gwc``.  The kernels also read tables built from these once per
index (``select_tables``, ``rank_tables``, ``flat_tables``,
``flat_rank_tables``).
"""

from __future__ import annotations

import torch

from .. import constants as C
from .bitops import popcount, u32_to_i32, word_select32

_I32 = torch.int32
_I64 = torch.int64
# columns of an rs-index's segment table (core/rs_index.py; rs_select.cu)
SEG_COLS = ("end", "cb", "ca", "base", "cls", "gkey", "gkeys", "goffs",
            "slot", "before", "bitoff")
(END, CB, CA, BASE, CLS, GKEY, GKEYS, GOFFS, SLOT, BEFORE,
 BITOFF) = range(len(SEG_COLS))


# one sample per SAMPLE entries of the global wave prefix and of the D-GAP
# runs' ones counts (select_tables); the select kernels search the samples
# in shared memory and finish in one 32-byte sector of the table
SAMPLE = 8


class SelectTables:
    """The tables kernel ``rs_select`` reads besides ``cum0``
    (``select_tables``; ``flat_tables`` holds only ``gws`` and ``wsp``,
    what ``select_flat`` reads), built once by the index that owns the
    pool.  ``staging`` is ``ops/cuda_kernels``' checked launch plan for
    them, set at the first launch; the tensors are not replaced after."""

    __slots__ = ("sel", "gws", "gcs", "wsp", "staging")

    def __init__(self, sel, gws, gcs, wsp):
        self.sel, self.gws, self.gcs, self.wsp = sel, gws, gcs, wsp
        self.staging = None


def select_tables(seg, runs, pool, gwc) -> SelectTables:
    """The tables kernel ``rs_select`` reads besides ``cum0``, built once
    with an rs-index (``core/rs_index.py``) from its segment table, D-GAP
    run tables, pool and global wave prefix:

    ``sel`` int64[m + 1, 2]: per segment row the position its answers
        count from (``BASE``; ``BITOFF`` for a BIT block) and one packed
        word, low half ``a`` and high half ``b`` (int32 each): a BIT block
        has ``a`` = its pool slot and ``b`` = the pool-global rank before
        its row (``BEFORE``); a D-GAP block ``a`` = -2 - its first run
        and ``b`` = the run after its last; any other row ``a`` = -1.
    ``gws`` int32[waves / SAMPLE]: ``gwc[SAMPLE - 1 :: SAMPLE]``, the
        prefix at the end of every SAMPLE waves (8 per pool row).
    ``gcs`` int32[runs // SAMPLE]: the D-GAP runs' inclusive ones counts
        at every SAMPLE-th run, ``runs[0][SAMPLE - 1 :: SAMPLE, 1]``.
    ``wsp`` int32[waves]: ``wave_sectors(pool)``."""
    ec = runs[0]
    kind = seg[:, CLS]
    bit = (kind == C.CLS_BIT) & (gwc.shape[0] > 0)
    gap = (kind == C.CLS_GAP) & (ec.shape[0] > 0)
    p = torch.where(bit, seg[:, BITOFF], seg[:, BASE])
    # a D-GAP block's runs end where the next D-GAP block's begin
    gi = torch.nonzero(gap).squeeze(1)
    first = seg[gi, GOFFS]
    end = torch.cat([first[1:], torch.full((min(gi.numel(), 1),),
                                           ec.shape[0], dtype=_I64,
                                           device=seg.device)])
    a = torch.full_like(p, -1)
    b = torch.zeros_like(p)
    a[bit], b[bit] = seg[bit, SLOT], seg[bit, BEFORE]
    a[gi], b[gi] = -2 - first, end
    sel = torch.stack([p, (b << 32) | (a & 0xFFFFFFFF)], 1).contiguous()
    flat = flat_tables(pool, gwc)
    return SelectTables(sel, flat.gws, ec[SAMPLE - 1::SAMPLE, 1].contiguous(),
                        flat.wsp)


class RankTables:
    """The tables kernel ``rs_rank`` reads besides ``nb``, the D-GAP runs
    and the pool (``rank_tables``; ``flat_rank_tables`` holds only
    ``wrk``, what ``rank_flat`` reads), built once by the index that owns
    the pool; ``staging`` as ``SelectTables``'."""

    __slots__ = ("rec", "ges", "wrk", "staging")

    def __init__(self, rec, ges, wrk):
        self.rec, self.ges, self.wrk = rec, ges, wrk
        self.staging = None


# the routes of rank_tables' records (rs_select.cu kRoute*): what a hit in
# the segment adds to the ones before it
ROUTE_FULL, ROUTE_BIT, ROUTE_GAP = 1, 2, 3


def rank_tables(seg, runs, gwc, wsp) -> RankTables:
    """The tables kernel ``rs_rank`` reads besides ``nb``, the D-GAP runs
    and the pool, built once with an rs-index from its segment table,
    D-GAP run tables, global wave prefix and ``wave_sectors`` of its pool:

    ``rec`` int64[m + 2, 2]: per segment row the ones before it (``CB``)
    and one word, its route in bits 0-1 and a payload above them: FULL
    (``ROUTE_FULL``) its end block; BIT (``ROUTE_BIT``) its pool slot in
    30 bits, then the pool-global rank before its row (``BEFORE``); D-GAP
    (``ROUTE_GAP``) its first run in 31 bits, its run count in 17, then
    1 where its first run is of ones; 0 for the sentinel row 0 and any
    other row.  Row m + 1: the total (the ones before a segment past the
    last), route 0.
    ``ges`` int32[runs // SAMPLE]: the runs' block-local ends at every
    SAMPLE-th run, ``runs[0][SAMPLE - 1 :: SAMPLE, 0]``.
    ``wrk``: ``wave_ranks(gwc, wsp)``."""
    ec = runs[0]
    kind = seg[:, CLS]
    full = kind == C.CLS_FULL
    bit = (kind == C.CLS_BIT) & (gwc.shape[0] > 0)
    gi = torch.nonzero((kind == C.CLS_GAP) & (ec.shape[0] > 0)).squeeze(1)
    slot = seg[bit, SLOT]
    if slot.numel() and int(slot.max()) >= 1 << 30:
        raise ValueError("rank_tables: pool slots past 2^30")
    word = torch.zeros_like(kind)
    word[full] = ROUTE_FULL | (seg[full, END] << 2)
    word[bit] = ROUTE_BIT | ((slot | (seg[bit, BEFORE] << 30)) << 2)
    # a D-GAP block's runs end where the next D-GAP block's begin
    first = seg[gi, GOFFS]
    end = torch.cat([first[1:], torch.full((min(gi.numel(), 1),),
                                           ec.shape[0], dtype=_I64,
                                           device=seg.device)])
    ones = (ec[first, 1] > 0).to(_I64)
    word[gi] = ROUTE_GAP | ((first | ((end - first) << 31) | (ones << 48))
                            << 2)
    rec = torch.stack([torch.cat([seg[:, CB], seg[-1:, CA]]),
                       torch.cat([word, word.new_zeros(1)])], 1)
    return RankTables(rec.contiguous(), ec[SAMPLE - 1::SAMPLE, 0].contiguous(),
                      wave_ranks(gwc, wsp))


def flat_rank_tables(gwc, wsp) -> RankTables:
    """``rank_tables``' ``wrk`` of a pool's global wave prefix and wave
    sectors (``rec`` and ``ges`` None): what ``rank_flat`` reads."""
    return RankTables(None, None, wave_ranks(gwc, wsp))


def wave_ranks(gwc, wsp):
    """int32[waves, 2]: per wave the ones of the waves before it (``gwc``'s
    exclusive form) beside its ``wsp`` entry, so that a rank reads both
    in one 8-byte load."""
    before = torch.cat([gwc.new_zeros(min(gwc.shape[0], 1)), gwc[:-1]])
    return torch.stack([before, wsp], 1).contiguous()


def flat_tables(pool, gwc) -> SelectTables:
    """``select_tables``' ``gws`` and ``wsp`` of a pool and its global
    wave prefix (``sel`` and ``gcs`` None): what ``select_flat`` reads."""
    return SelectTables(None, gwc[SAMPLE - 1::SAMPLE].contiguous(), None,
                        wave_sectors(pool))


def wave_sectors(pool):
    """int32[rows * 64]: per 128 B wave the ones of its first 1, 2 and 3
    32-byte sectors, 10 bits each (bits 0-9, 10-19, 20-29), so a select
    reads only the sector holding its bit."""
    pc = popcount(pool.reshape(-1, 4, C.WAVE_WORDS // 4)).sum(
        dim=-1, dtype=_I32)
    e = torch.cumsum(pc[:, :3], dim=1, dtype=_I32)
    return (e[:, 0] | (e[:, 1] << 10) | (e[:, 2] << 20)).contiguous()


def wave_prefix(pool):
    """Inclusive per-wave popcount prefix -> int32[n_rows, 64]."""
    n = pool.shape[0]
    pc = popcount(pool.reshape(n, C.BLOCK_WAVES, C.WAVE_WORDS)).sum(
        dim=-1, dtype=_I32)
    return torch.cumsum(pc, dim=1, dtype=_I32)


def global_wave_prefix(pool):
    """Inclusive popcount prefix over ALL waves of the pool, flattened ->
    int32[n_rows * 64].  (Totals must fit int32: pools < 2^31 set bits.)"""
    pc = popcount(pool.reshape(-1, C.WAVE_WORDS)).sum(dim=-1, dtype=_I32)
    return torch.cumsum(pc, dim=0, dtype=_I32)


def _in_wave_descent(words, rem):
    """words int32[Q, 32], rem 1-based in-wave rank -> bit offset in the
    1024-bit wave (int64)."""
    pc = popcount(words)
    cum = torch.cumsum(pc, dim=1, dtype=_I32)
    w = (cum < rem[:, None]).sum(dim=1).clamp(max=C.WAVE_WORDS - 1)
    iota = torch.arange(C.WAVE_WORDS, device=words.device)
    prev_w = torch.where(iota[None, :] < w[:, None], pc, 0).sum(
        dim=1, dtype=_I32)
    word_val = words.gather(1, w[:, None])[:, 0]
    bit = word_select32(word_val, rem - prev_w)
    return w * C.WORD_BITS + bit


def select_flat(pool, gwc, ranks):
    """Batched select over the whole pool: ``ranks`` are 1-based global
    ranks (int32) within [1, total]; returns the global bit position
    pool_row * 65536 + in-block offset (int64)."""
    wave = torch.searchsorted(gwc, ranks.to(_I32)).clamp(
        max=gwc.shape[0] - 1)
    prev = torch.where(wave > 0, gwc[(wave - 1).clamp(min=0)], 0)
    rem = ranks.to(_I32) - prev
    words = pool.reshape(-1, C.WAVE_WORDS)[wave]
    return wave * C.WAVE_BITS + _in_wave_descent(words, rem)


def select_in_pool(pool, wave_cum, rows, rem):
    """For each query: pool row ``rows[q]`` and 1-based in-block rank
    ``rem[q]`` -> bit position in [0, 65536) (int64)."""
    rows = rows.to(_I64)
    rem = rem.to(_I32)
    wt = wave_cum[rows]                                     # [q, 64]
    wave = (wt < rem[:, None]).sum(dim=1).clamp(max=C.BLOCK_WAVES - 1)
    prev_w = torch.where(wave > 0,
                         wt.gather(1, (wave - 1).clamp(min=0)[:, None])[:, 0],
                         0)
    words = pool.reshape(-1, C.WAVE_WORDS)[rows * C.BLOCK_WAVES + wave]
    return wave * C.WAVE_BITS + _in_wave_descent(words, rem - prev_w)


def rank_in_rows(pool, gwc, slots, in_block_bits):
    """popcount of bits [0, in_block_bits] within pool rows ``slots``
    (the ``_rank_in_rows`` of bitmagic_tpu/core/rs_index.py:191-204).
    Whole waves come from the global wave prefix ``gwc``; only the query's
    128 B wave is gathered, so a batch of Q queries moves Q x 128 B, not
    Q x 8 KiB of rows."""
    slots = slots.to(_I64)
    bits = in_block_bits.to(_I64)
    row0 = slots * C.BLOCK_WAVES
    wave = row0 + (bits >> 10)
    zero = torch.zeros((), dtype=_I32, device=gwc.device)
    row_base = torch.where(slots > 0, gwc[(row0 - 1).clamp(min=0)], zero)
    before = torch.where((bits >> 10) > 0, gwc[(wave - 1).clamp(min=0)],
                         row_base) - row_base
    words = pool.reshape(-1, C.WAVE_WORDS)[wave]            # [Q, 32]
    wi = ((bits >> 5) & 31)[:, None]
    # low (bit + 1) bits of the query's word
    part = u32_to_i32((torch.full_like(bits, 2) << (bits & 31)) - 1)[:, None]
    j = torch.arange(C.WAVE_WORDS, device=pool.device)[None, :]
    mask = torch.where(j < wi, -1, torch.where(j == wi, part, 0))
    return before + popcount(words & mask).sum(dim=1, dtype=_I32)


def rank_flat(pool, gwc, rel):
    """popcount of bits [0, rel] of a whole pool for each ``rel`` (int64 on
    the pool's device, in [0, rows * 65536)) -> int64 (ShardedRSIndex's
    shard-local rank): the rows before rel's from the prefix, then
    ``rank_in_rows``."""
    slots = rel >> C.SET_BLOCK_SHIFT
    row_base = torch.where(slots > 0, gwc[(slots * C.BLOCK_WAVES - 1).clamp(
        min=0)], 0)
    return row_base.to(_I64) + rank_in_rows(
        pool, gwc, slots, rel & C.SET_BLOCK_MASK).to(_I64)


def rs_select(seg, cum0, runs, pool, gwc, ranks, total):
    """Position of each 1-based rank (int64[Q]) of an rs-index's vector,
    -1 outside [1, total] (reference select, src/bm.h:1705): the segment
    by a search of ``cum0``, then FULL offset arithmetic, the D-GAP run
    whose ones count reaches the rank, or for a BIT block the in-block
    rank in the pool's global rank space resolved by ``select_flat``."""
    if total <= 0:
        return torch.full_like(ranks, -1)
    r = ranks.clamp(1, total)
    s = seg[torch.searchsorted(cum0, r)]
    # 1-based rank within the segment (int64: FULL runs pass 2^31)
    rem = r - s[:, CB]
    kind = s[:, CLS]
    out = s[:, BASE] + rem - 1    # FULL
    ec, _, key_cum = runs
    if key_cum.numel():
        # GAP block: the first run whose ones count reaches rem ends
        # cum1 - rem bits after the set bit
        rr = torch.searchsorted(key_cum, s[:, GKEYS] + rem).clamp(
            max=key_cum.shape[0] - 1)
        run = ec[rr]
        out = torch.where(kind == C.CLS_GAP,
                          out + (run[:, 0] - run[:, 1] + 1), out)
    bi = torch.nonzero(kind == C.CLS_BIT).squeeze(1)
    if bi.numel():
        # the in-block rank in the pool's global rank space, resolved by
        # one flat search over the global wave prefix
        sb = s[bi]
        out[bi] = sb[:, BITOFF] + select_flat(
            pool, gwc, (rem[bi] + sb[:, BEFORE]).to(_I32))
    return torch.where((ranks >= 1) & (ranks <= total), out, -1)


def rs_rank(seg, nb, runs, pool, gwc, ids):
    """rank(i) = popcount[0, i] for each id (int64[Q]) of an rs-index's
    vector (reference count_to, src/bm.h:1420): the segment at or before
    the id's block by a search of ``nb``, then FULL offset arithmetic,
    the D-GAP run holding the bit, or ``rank_in_rows`` of a BIT block."""
    blocks = ids >> C.SET_BLOCK_SHIFT
    nbit = ids & C.SET_BLOCK_MASK
    # the segment at or before each block (row 0: none)
    s = seg[torch.searchsorted(nb, blocks, right=True)]
    hit = blocks < s[:, END]
    kind = torch.where(hit, s[:, CLS], C.CLS_ZERO)
    # FULL segment containing i: in-segment offset + 1
    inblk = torch.where(kind == C.CLS_FULL, ids - s[:, BASE] + 1, 0)
    ec, key_end, _ = runs
    if key_end.numel():
        # GAP block: the run holding the bit (gap_bfind analog); with p
        # the ones count minus the end of the run before it (1 for a
        # block's first run), rank = min(cum1[r], p + nbit) holds for runs
        # of ones and of zeros alike
        r = torch.searchsorted(key_end, s[:, GKEY] + nbit)
        prev = ec[(r - 1).clamp(min=0)]
        p = torch.where(r > s[:, GOFFS], prev[:, 1] - prev[:, 0], 1)
        inblk = torch.where(kind == C.CLS_GAP,
                            torch.minimum(ec[r, 1], p + nbit), inblk)
    # whole segments before the block, plus the in-block count
    out = torch.where(hit, s[:, CB] + inblk, s[:, CA])
    # BIT block containing i: in-row partial popcount
    bi = torch.nonzero(kind == C.CLS_BIT).squeeze(1)
    if bi.numel():
        out[bi] += rank_in_rows(pool, gwc, s[bi, SLOT], nbit[bi]).long()
    return out
