"""Block-level ops over dense pools ``int32[n_blocks, 2048]`` — plain
PyTorch versions (port of ``bitmagic_tpu/ops/blockops.py``).

These are the canonical semantics.  Six families also have a hand-written
Hopper kernel in ``cuda_kernels.py`` with the same signature:
``block_counts`` (and its total form), ``count_op`` / ``count_metrics``
(and its total form), ``logical_op_digest`` /
``binary_op_digest``, ``agg_and_sub`` (and its arena and batched forms),
``pipeline_counts`` and ``scan_eq``.  The wrappers there run the plain
version below only for tensors on the CPU; on the card they launch the
kernel.  The other functions here have no kernel in the JAX package either
and stay plain PyTorch on every device.

Conventions:
  * words are int32 tensors holding the reference's uint32 bits;
  * bit *n* of a block = word ``n >> 5``, in-word bit ``n & 31`` (LSB-first),
    identical to the reference so serialized images match;
  * a *digest* is an ``int32[n, 64]`` 0/1 wave-nonzero mask (the reference
    packs it into one ``bm::id64_t``, src/bmfunc.h:1230).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (BITS_PER_BLOCK, BLOCK_WAVES, SET_BLOCK_SIZE,
                         WAVE_WORDS)
from .bitops import clz32, ctz32, popcount, u32_to_i32

_I32 = torch.int32
_I64 = torch.int64

# distance metric codes (reference distance_metric enum,
# src/bmalgo_impl.h:60-76); a metric's code is its index here
METRICS = ("count_and", "count_xor", "count_or", "count_sub_ab",
           "count_sub_ba", "count_a", "count_b")
# the metric that counts ``a OP b`` for each logical op
OP_METRIC = {"and": "count_and", "or": "count_or", "xor": "count_xor",
             "sub": "count_sub_ab"}
OP_CODES = {"and": 0, "or": 1, "xor": 2, "sub": 3}


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def zero_pool(n, device="cpu"):
    return torch.zeros((n, SET_BLOCK_SIZE), dtype=_I32, device=device)


def to_device_words(words_u32: np.ndarray, device) -> torch.Tensor:
    """Upload a host uint32 word array as int32 words (same bits)."""
    w = np.ascontiguousarray(words_u32, np.uint32).view(np.int32)
    return torch.from_numpy(w.copy()).to(device)


def to_host_words(t: torch.Tensor) -> np.ndarray:
    """Fetch int32 words as a host uint32 array (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# counts & digests (reference bit_block_count src/bmfunc.h:5799,
# calc_block_digest0 src/bmfunc.h:1230)
# ---------------------------------------------------------------------------
def block_counts(pool):
    """Per-block popcount -> int32[n]  (plain version of kernel K3)."""
    return popcount(pool).sum(dim=-1, dtype=_I32)


def block_counts_total(pool, per_block=False):
    """Plain version of K3's total form: ``(int64`` 0-d sum of the
    per-block popcounts, ``int32[n]`` per-block popcounts or None)."""
    c = block_counts(pool)
    return c.sum(dtype=_I64), (c if per_block else None)


def wave_counts(pool):
    """Per-wave popcount -> int32[n, 64]."""
    n = pool.shape[0]
    w = pool.reshape(n, BLOCK_WAVES, WAVE_WORDS)
    return popcount(w).sum(dim=-1, dtype=_I32)


def calc_digest(pool):
    """Wave-nonzero digest -> int32[n, 64] of 0/1."""
    n = pool.shape[0]
    w = pool.reshape(n, BLOCK_WAVES, WAVE_WORDS)
    return (w != 0).any(dim=-1).to(_I32)


def is_zero_blocks(pool):
    return ~(pool != 0).any(dim=-1)


def is_full_blocks(pool):
    return (pool == -1).all(dim=-1)


def _shr_logical(x, k):
    """uint32 right shift of int32 words by k in [1, 31]."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def gap_counts(pool):
    """Per-block 'gap count' GC: 1 + number of 01/10 transitions in the
    block's bit string (reference bit_block_calc_change,
    src/bmfunc.h:5893)."""
    n = pool.shape[0]
    flat = pool.reshape(n, -1)
    shifted = _shr_logical(flat, 1) | (torch.roll(flat, -1, dims=1) << 31)
    cnt = popcount(flat ^ shifted).sum(dim=-1, dtype=_I32)
    # the last word's top bit paired with the rolled-in first word's bit 0
    # is not a pair of the block's bit string
    last_top = _shr_logical(flat[:, -1], 31)
    first_bot = flat[:, 0] & 1
    return cnt - (last_top ^ first_bot) + 1


def block_counts_np(words: np.ndarray) -> np.ndarray:
    """Host mirror of block_counts (for host-resident rows)."""
    return np.bitwise_count(words).sum(axis=1, dtype=np.int64)


def gap_counts_np(words: np.ndarray) -> np.ndarray:
    """Host mirror of gap_counts (bit_block_calc_change on numpy)."""
    flat = words.reshape(words.shape[0], -1)
    shifted = (flat >> np.uint32(1)) | (
        np.roll(flat, -1, axis=1) << np.uint32(31))
    x = flat ^ shifted
    cnt = np.bitwise_count(x).sum(axis=1, dtype=np.int64)
    last_top = (flat[:, -1] >> np.uint32(31)).astype(np.int64)
    first_bot = (flat[:, 0] & np.uint32(1)).astype(np.int64)
    return cnt - (last_top ^ first_bot) + 1


# ---------------------------------------------------------------------------
# logical families (reference src/bmfunc.h:7606-9291)
# ---------------------------------------------------------------------------
def and_blocks(a, b):
    return a & b


def or_blocks(a, b):
    return a | b


def xor_blocks(a, b):
    return a ^ b


def sub_blocks(a, b):
    return a & ~b


_OPS = {"and": and_blocks, "or": or_blocks, "xor": xor_blocks,
        "sub": sub_blocks}


def logical_op(op, a, b):
    return _OPS[op](a, b)


def logical_op_digest(op, a, b):
    """(a OP b, wave digest) over aligned rows — plain version of kernel K1
    (reference bit_block_and_2way returning digest, src/bmfunc.h:7824)."""
    out = _OPS[op](a, b)
    return out, calc_digest(out)


def count_op(op, a, b):
    """Per-block popcount of (a OP b) over aligned rows — plain version of
    kernel K2 (reference bit_operation_*_count, src/bmfunc.h:8022-9291)."""
    return block_counts(_OPS[op](a, b))


# ---------------------------------------------------------------------------
# gather-fused forms: each operand comes as the descriptor
# (pool, slot, full, aux, aux_slot) of core/blocks.operand_args
# ---------------------------------------------------------------------------
def gather_rows(pool, slot, full, aux=None, aux_slot=None):
    """Aligned operand rows: the pool row where slot >= 0, all ones where
    full, zero otherwise; the ``aux`` row where aux_slot >= 0 overrides
    (expanded GAP blocks).  Semantics of bitmagic_tpu gather_operand.
    ``slot=None`` is the aligned form (row i of the pool), ``full=None``
    means no FULL rows."""
    if slot is None:
        rows = pool
    elif pool.shape[0] == 0:
        rows = torch.zeros((slot.shape[0], SET_BLOCK_SIZE), dtype=_I32,
                           device=slot.device)
    else:
        rows = pool[slot.clamp(min=0).to(_I64)]
    if slot is not None:
        rows = torch.where((slot < 0)[:, None], 0, rows)
    if full is not None:
        rows = torch.where(full.to(torch.bool)[:, None], -1, rows)
    if aux is not None and aux.shape[0]:
        arows = aux[aux_slot.clamp(min=0).to(_I64)]
        rows = torch.where((aux_slot >= 0)[:, None], arows, rows)
    return rows


def binary_op_digest(op, a_desc, b_desc):
    """Gather-fused plain version of kernel K1: ``a OP b`` rows and their
    wave digest, operands given as gather descriptors."""
    return logical_op_digest(op, gather_rows(*a_desc), gather_rows(*b_desc))


def _metric_rows(m, a, b):
    if m == "count_and":
        return a & b
    if m == "count_xor":
        return a ^ b
    if m == "count_or":
        return a | b
    if m == "count_sub_ab":
        return a & ~b
    if m == "count_sub_ba":
        return b & ~a
    if m == "count_a":
        return a
    if m == "count_b":
        return b
    raise ValueError(m)


# each metric as a combination of the base counts |a & b|, |a|, |b| of a
# block (exact: per-block counts are at most 65536)
_BASES = ("count_and", "count_a", "count_b")
_AS_BASES = {"count_and": (1, 0, 0), "count_xor": (-2, 1, 1),
             "count_or": (-1, 1, 1), "count_sub_ab": (-1, 1, 0),
             "count_sub_ba": (-1, 0, 1), "count_a": (0, 1, 0),
             "count_b": (0, 0, 1)}


def count_plan(metrics):
    """How kernel K2 counts ``metrics``: ``(counted, coefs)``.  ``counted``
    (in METRICS order, at most three) are the metrics it popcounts: the
    requested ones, or the base counts they follow from when those are
    fewer; ``coefs[j][s]`` is requested metric j's coefficient on
    ``counted[s]``, so that metric j of a block is ``sum_s coefs[j][s] *
    popcount(counted[s])``."""
    for m in metrics:
        if m not in _AS_BASES:
            raise ValueError(f"unknown metric {m}")
    if not metrics:
        raise ValueError("no metrics requested")
    base = {x for m in metrics for x, c in zip(_BASES, _AS_BASES[m]) if c}
    if len(base) < len(set(metrics)):
        counted = tuple(m for m in METRICS if m in base)
        coefs = [[_AS_BASES[m][_BASES.index(x)] for x in counted]
                 for m in metrics]
    else:
        counted = tuple(m for m in METRICS if m in metrics)
        coefs = [[int(x == m) for x in counted] for m in metrics]
    return counted, coefs


def count_metrics(metrics, a_desc, b_desc):
    """Gather-fused plain version of kernel K2: per-block popcounts of every
    requested metric -> int32[len(metrics), k] (the device part of
    distance_operation, combine_count_operation_with_block analog,
    src/bmalgo_impl.h:406), counted as the kernel counts them
    (``count_plan``)."""
    counted, coefs = count_plan(metrics)
    a, b = gather_rows(*a_desc), gather_rows(*b_desc)
    counts = [block_counts(_metric_rows(m, a, b)) for m in counted]
    return torch.stack([sum(c * n for c, n in zip(row, counts) if c)
                        for row in coefs])


def count_metrics_total(metrics, a_desc, b_desc, per_block=False):
    """Plain version of K2's total form: ``(int64[len(metrics)]`` sums of
    the per-block counts, ``int32[len(metrics), k]`` per-block counts or
    None)."""
    c = count_metrics(metrics, a_desc, b_desc)
    return c.sum(dim=1, dtype=_I64), (c if per_block else None)


# ---------------------------------------------------------------------------
# K-way aggregator sweep, batched pipeline counts, bit-sliced equality scan
# (plain versions of kernels B4, B5 and B6)
# ---------------------------------------------------------------------------
def _desc_cols(desc) -> int:
    pool, slot = desc[0], desc[1]
    return pool.shape[0] if slot is None else slot.shape[0]


def agg_and_sub(n_and, descs, or_mode=False, rows=True, counts=False):
    """Plain version of kernel B4 over K gather descriptors aligned on the
    same k columns: AND of the first ``n_and`` operands' rows AND-NOT the
    rest's (``or_mode``: OR of every operand's rows, the ``n_and = 0``
    case of bitmagic_tpu's ``_agg_kernel``).  Returns ``(rows int32[k,
    2048] or None, per-column popcounts int32[k] or None)``; the result is
    the same whether or not a sweep stops early at an all-zero column."""
    if not descs:
        raise ValueError("agg_and_sub: no operands")
    k = _desc_cols(descs[0])
    dev = descs[0][0].device
    acc = torch.full((k, SET_BLOCK_SIZE), 0 if or_mode else -1, dtype=_I32,
                     device=dev)
    for j, d in enumerate(descs):
        r = gather_rows(*d)
        if or_mode:
            acc |= r
        elif j < n_and:
            acc &= r
        else:
            acc &= ~r
    return (acc if rows else None), (block_counts(acc) if counts else None)


def agg_and_sub_batch(descs, index, offs, n_and, rows=True, counts=False):
    """Plain version of the batched form of kernel B4: request r sweeps the
    operands ``descs[index[offs[r]:offs[r + 1]]]`` (gather descriptors
    aligned on k columns), ANDing the first ``n_and[r]`` and AND-NOTing the
    rest; ``n_and[r] = 0`` is the complement of the OR of its operands (the
    all-ones start of bitmagic_tpu ``_pipeline_results_kernel``) and a
    request with no operands is all ones.  Returns ``(rows int32[V, k,
    2048] or None, per-column popcounts int32[V, k] or None)``."""
    if not descs:
        raise ValueError("agg_and_sub_batch: no operands")
    index, offs, n_and = (np.asarray(x).astype(np.int64)
                          for x in (index, offs, n_and))
    k = _desc_cols(descs[0])
    dev = descs[0][0].device
    out_rows, out_cnt = [], []
    for r in range(offs.size - 1):
        ops = [descs[j] for j in index[offs[r]:offs[r + 1]].tolist()]
        if ops:
            acc = agg_and_sub(int(n_and[r]), ops)[0]
        else:
            acc = torch.full((k, SET_BLOCK_SIZE), -1, dtype=_I32, device=dev)
        out_rows.append(acc)
        out_cnt.append(block_counts(acc))
    shape = (0, k)
    rows_t = (torch.stack(out_rows) if out_rows else
              torch.zeros(shape + (SET_BLOCK_SIZE,), dtype=_I32, device=dev))
    cnt_t = (torch.stack(out_cnt) if out_cnt else
             torch.zeros(shape, dtype=_I32, device=dev))
    return (rows_t if rows else None), (cnt_t if counts else None)


def selector_requests(selectors):
    """Selector rows int[V, K] (1 AND, -1 AND-NOT, 0 skip) as the request
    table of the batched B4: ``(index int32[n], offs int32[V + 1], n_and
    int32[V])``, each request's AND operands first, then its AND-NOT ones,
    each in operand order."""
    sel = _checked_selectors(selectors)
    ra, ca = np.nonzero(sel == 1)
    rs, cs = np.nonzero(sel == -1)
    rows = np.concatenate([ra, rs])
    cols = np.concatenate([ca, cs])
    role = np.concatenate([np.zeros(ra.size, np.int8), np.ones(rs.size,
                                                               np.int8)])
    order = np.lexsort((cols, role, rows))
    offs = np.zeros(sel.shape[0] + 1, np.int32)
    np.cumsum(np.count_nonzero(sel, axis=1), out=offs[1:])
    return (cols[order].astype(np.int32), offs,
            np.count_nonzero(sel == 1, axis=1).astype(np.int32))


def arena_descriptors(n_and, slots, pool):
    """The arena form of B4 as gather descriptors: operand k reads
    ``pool[slots[k, i]]``; a slot of -1 is the identity, passed as FULL for
    an AND operand and left zero for a SUB operand (the rule of
    bitmagic_tpu agg_and_sub_pallas, pallas_kernels.py:221-228)."""
    full = slots < 0
    return [(pool, slots[k], full[k] if k < n_and else None, None, None)
            for k in range(slots.shape[0])]


def agg_and_sub_arena(n_and, n_sub, slots, pool):
    """Plain version of B4 in the signature of bitmagic_tpu
    ``agg_and_sub_pallas``: slots int32[n_and + n_sub, nb] into ``pool``
    -> int32[nb, 2048]."""
    if slots.shape[0] != n_and + n_sub:
        raise ValueError("agg_and_sub_arena: slots rows != n_and + n_sub")
    return agg_and_sub(n_and, arena_descriptors(n_and, slots, pool))[0]


def _checked_selectors(selectors) -> np.ndarray:
    sel = np.asarray(selectors)
    if sel.ndim != 2:
        raise ValueError("selectors must be [V, S]")
    bad = (sel != 0) & (sel != 1) & (sel != -1)
    if bad.any():
        raise ValueError("selectors hold only 1, -1 and 0")
    return sel


def pipeline_codes(selectors) -> tuple[np.ndarray, np.ndarray]:
    """Selector rows int[V, S] (1 AND, -1 AND-NOT, 0 skip) compacted to
    CSR: ``(offs int32[V + 1], codes int32[n])`` with code ``(s << 1) |
    (select == -1)`` for each non-zero select of row v in
    ``codes[offs[v]:offs[v + 1]]``."""
    sel = _checked_selectors(selectors)
    rows, cols = np.nonzero(sel)
    codes = (cols.astype(np.int32) << 1) | (sel[rows, cols] == -1)
    offs = np.zeros(sel.shape[0] + 1, np.int32)
    np.cumsum(np.count_nonzero(sel, axis=1), out=offs[1:])
    return offs, codes.astype(np.int32)


def pipeline_planes(selectors) -> tuple[np.ndarray, np.ndarray]:
    """The planes some row of ``selectors`` int[V, S] selects: ``(plane_idx
    int32[n], compact int32[V, n])``, ``compact[:, j]`` being the column of
    plane ``plane_idx[j]``.  Counting ``planes[plane_idx]`` under
    ``compact`` gives the counts of ``planes`` under ``selectors``."""
    sel = _checked_selectors(selectors)
    idx = np.flatnonzero((sel != 0).any(axis=0)).astype(np.int32)
    return idx, np.ascontiguousarray(sel[:, idx], dtype=np.int32)


def pipeline_masks(selectors) -> np.ndarray:
    """Selector rows int[V, S] as bit masks uint32[V, 2, ceil(S / 32)]:
    bit ``s % 32`` of word ``s // 32`` is set in row 0 where plane s is
    selected (1 or -1) and in row 1 where it is AND-NOTed (-1)."""
    sel = _checked_selectors(selectors)
    V, S = sel.shape
    nw = (S + 31) // 32
    bits = np.zeros((V, 2, nw * 32), bool)
    bits[:, 0, :S] = sel != 0
    bits[:, 1, :S] = sel == -1
    packed = np.packbits(bits, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


def pipeline_counts(planes, selectors):
    """Plain version of kernel B5: hit count per selector row over the plane
    stack ``planes`` int32[S, nb, 2048]; ``selectors`` int[V, S] with 1 =
    AND, -1 = AND-NOT, 0 = skip -> int64[V].  Unlike bitmagic_tpu
    ``pipeline_counts`` nothing is padded, so an all-zero row counts
    exactly the nb * 65536 bits of the stack."""
    sel = selectors.detach().cpu().numpy() if torch.is_tensor(selectors) \
        else np.asarray(selectors)
    offs, codes = pipeline_codes(sel)
    S, nb = planes.shape[0], planes.shape[1]
    if planes.shape[2:] != (SET_BLOCK_SIZE,):
        raise ValueError("planes must be [S, nb, 2048]")
    out = torch.zeros(sel.shape[0], dtype=_I64, device=planes.device)
    for v in range(sel.shape[0]):
        acc = torch.full((nb, SET_BLOCK_SIZE), -1, dtype=_I32,
                         device=planes.device)
        for c in codes[offs[v]:offs[v + 1]].tolist():
            p = planes[c >> 1]
            acc &= ~p if c & 1 else p
        out[v] = popcount(acc).sum(dtype=_I64)
    return out


def scan_eq(n_planes, planes, value):
    """Plain version of kernel B6 (bitmagic_tpu ``scan_eq_pallas``): the hit
    mask int32[nb, 2048] of ``value`` over the first ``n_planes`` planes of
    ``planes`` int32[S, nb, 2048] (value bits at s >= 32 read as 0)."""
    value = int(value) & 0xFFFFFFFF
    acc = torch.full(planes.shape[1:], -1, dtype=_I32, device=planes.device)
    for s in range(int(n_planes)):
        p = planes[s]
        acc &= p if (s < 32 and (value >> s) & 1) else ~p
    return acc


# ---------------------------------------------------------------------------
# range masks.  The range is pre-split on the HOST into word index +
# in-word bit offset (global 48-bit addresses never reach the device).
# ---------------------------------------------------------------------------
def range_mask(n_blocks, lo_w, lo_b, hi_w, hi_b, device="cpu"):
    """int32[n_blocks, 2048] with bits [lo, hi] set, where lo = lo_w*32+lo_b
    etc. (word index relative to the pool's first block)."""
    widx = torch.arange(n_blocks * SET_BLOCK_SIZE, dtype=_I64, device=device)
    lo_w, hi_w, lo_b, hi_b = int(lo_w), int(hi_w), int(lo_b), int(hi_b)
    lo_mask = (0xFFFFFFFF << lo_b) & 0xFFFFFFFF
    hi_mask = 0xFFFFFFFF if hi_b == 31 else (1 << (hi_b + 1)) - 1
    m = torch.where((widx > lo_w) & (widx < hi_w), 0xFFFFFFFF, 0)
    first = (lo_mask & hi_mask) if lo_w == hi_w else lo_mask
    m = torch.where(widx == lo_w, first, m)
    if hi_w != lo_w:
        m = torch.where(widx == hi_w, hi_mask, m)
    return u32_to_i32(m).reshape(n_blocks, SET_BLOCK_SIZE)


def _split_range(lo, hi):
    lo, hi = int(lo), int(hi)
    return lo >> 5, lo & 31, hi >> 5, hi & 31


def count_range_pool(pool, lo, hi):
    """popcount of bits [lo, hi] of the flattened pool (reference
    bit_block_calc_count_range, src/bmfunc.h:6138, generalized
    cross-block).  Returns a host int."""
    m = range_mask(pool.shape[0], *_split_range(lo, hi), device=pool.device)
    return int(popcount(pool & m).sum(dtype=_I64))


def any_range_pool(pool, lo, hi):
    m = range_mask(pool.shape[0], *_split_range(lo, hi), device=pool.device)
    return bool(((pool & m) != 0).any())


def is_all_one_range_pool(pool, lo, hi):
    """reference is_all_one_range (src/bmfunc.h:6049)."""
    m = range_mask(pool.shape[0], *_split_range(lo, hi), device=pool.device)
    return bool(((pool & m) == m).all())


# ---------------------------------------------------------------------------
# find first / last (reference bit_find_first src/bmfunc.h:9490,
# bit_find_last :9456)
# ---------------------------------------------------------------------------
def find_first_in_blocks(pool):
    """Per block: index of first set bit in [0, 65536), or BITS_PER_BLOCK if
    none -> int32[n]."""
    n = pool.shape[0]
    widx = torch.arange(SET_BLOCK_SIZE, dtype=_I32,
                        device=pool.device).expand(n, -1)
    first_w = torch.where(pool != 0, widx, SET_BLOCK_SIZE).amin(dim=-1)
    safe_w = first_w.clamp(max=SET_BLOCK_SIZE - 1)
    w = pool.gather(1, safe_w[:, None].to(_I64))[:, 0]
    return torch.where(first_w == SET_BLOCK_SIZE, BITS_PER_BLOCK,
                       first_w * 32 + ctz32(w)).to(_I32)


def find_last_in_blocks(pool):
    """Per block: index of last set bit, or -1 if none -> int32[n]."""
    n = pool.shape[0]
    widx = torch.arange(SET_BLOCK_SIZE, dtype=_I32,
                        device=pool.device).expand(n, -1)
    last_w = torch.where(pool != 0, widx, -1).amax(dim=-1)
    safe_w = last_w.clamp(min=0)
    w = pool.gather(1, safe_w[:, None].to(_I64))[:, 0]
    return torch.where(last_w < 0, -1,
                       last_w * 32 + 31 - clz32(w)).to(_I32)


# ---------------------------------------------------------------------------
# per-row 1-bit shifts with cross-word carry (reference
# bit_block_shift_r1_unr src/bmfunc.h:6459, _l1_unr :6559); cross-BLOCK
# carries come in/out through tiny edge-bit vectors.
# ---------------------------------------------------------------------------
def shift_rows_up1(pool, carry_bits):
    """PER-ROW shift towards higher bit indices by 1; carry_bits int32[n]
    (0/1) becomes each row's bit 0."""
    hi = _shr_logical(pool, 31)
    prev = torch.cat([(carry_bits & 1)[:, None].to(_I32), hi[:, :-1]], dim=1)
    return (pool << 1) | prev


def shift_rows_down1(pool, carry_bits):
    """PER-ROW shift towards lower bit indices by 1; carry_bits int32[n]
    (0/1) becomes each row's top bit."""
    lo = pool & 1
    nxt = torch.cat([lo[:, 1:], (carry_bits & 1)[:, None].to(_I32)], dim=1)
    return _shr_logical(pool, 1) | (nxt << 31)


def edge_bits(pool):
    """(bottom, top) int32[n]: each row's bit 0 and bit 65535."""
    return pool[:, 0] & 1, _shr_logical(pool[:, -1], 31)


# ---------------------------------------------------------------------------
# scatter bulk bit-set (reference bulk import: src/bm.h:2073-2161)
# ---------------------------------------------------------------------------
def scatter_set_bits(rows, bits_in_block, n_blocks):
    """Build a pool from (row, bit) pairs: ``rows`` int[k] = pool row per
    bit, ``bits_in_block`` int[k] in [0, 65536).

    Callers pass *deduplicated* (row, bit) pairs, so each pair adds a
    distinct power of two exactly once and the int32 scatter-add is exactly
    a scatter-OR (two's-complement addition of disjoint bits)."""
    rows = rows.to(_I64)
    bits = bits_in_block.to(_I64)
    word_idx = rows * SET_BLOCK_SIZE + (bits >> 5)
    bit_val = u32_to_i32(torch.ones_like(bits) << (bits & 31))
    flat = torch.zeros(n_blocks * SET_BLOCK_SIZE, dtype=_I32,
                       device=rows.device)
    flat.index_add_(0, word_idx, bit_val)
    return flat.reshape(n_blocks, SET_BLOCK_SIZE)
