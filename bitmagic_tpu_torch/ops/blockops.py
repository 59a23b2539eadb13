"""Block-level ops over dense pools ``int32[n_blocks, 2048]`` — plain
PyTorch versions (port of ``bitmagic_tpu/ops/blockops.py``).

These are the canonical semantics.  Twelve families also have a
hand-written Hopper kernel in ``cuda_kernels.py`` with the same signature:
``block_counts`` (and its total form), ``count_op`` / ``count_metrics``
(and its total form), ``logical_op_digest`` / ``binary_op_digest``,
``agg_and_sub`` (and its arena and batched forms), the Bitap chain
``shift_and_chain``, ``pipeline_counts``, ``scan_eq``, the D-GAP conversions
``gap_expand`` (and its pair form) / ``gap_compress``, the
SparseVector's multi-plane ``sv_gather`` and import ``sv_transpose``, and
the ordered searches' slice descent ``sv_descent`` / ``descent_rows``.
The wrappers there run the plain version below only for tensors on the
CPU; on the card they launch the kernel.  The other functions here have
no kernel in the JAX package either and stay plain PyTorch on every
device.

Conventions:
  * words are int32 tensors holding the reference's uint32 bits;
  * bit *n* of a block = word ``n >> 5``, in-word bit ``n & 31`` (LSB-first),
    identical to the reference so serialized images match;
  * a *digest* is an ``int32[n, 64]`` 0/1 wave-nonzero mask (the reference
    packs it into one ``bm::id64_t``, src/bmfunc.h:1230).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (BITS_PER_BLOCK, BLOCK_WAVES, SET_BLOCK_SIZE,
                         WAVE_WORDS)
from .bitops import as_u32_int64, clz32, ctz32, popcount, u32_to_i32

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


def full_block_np():
    """One FULL block as a host uint32 row (all ones)."""
    return np.full((SET_BLOCK_SIZE,), 0xFFFFFFFF, np.uint32)


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


def pack_digest(digest):
    """int32[n, 64] 0/1 -> int32[n, 2]: the packed (lo, hi) halves of the
    reference's 64-bit digest, as words with the uint32 bits."""
    n = digest.shape[0]
    d = digest.reshape(n, 2, 32).to(_I64)
    weights = torch.ones(32, dtype=_I64, device=d.device) << torch.arange(
        32, dtype=_I64, device=d.device)
    return u32_to_i32((d * weights).sum(dim=-1))


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


# B8's chain grouped by operand vector: a Bitap pattern's letters repeat,
# so its k operands are a few distinct vectors, each with a set of shifts.
# CHAIN_SPAN: the most word shifts q one segment of a vector covers (its
# 32-bit shift masks, one per q, fit one warp's lanes; shift_chain.cu)
CHAIN_SPAN = 32


def chain_groups(descs):
    """B8's ``k`` operands grouped by identity (a repeated letter is the
    same descriptor tuple): ``(vecs, offs int64[D + 1], shifts int64[k])``,
    the D distinct descriptors with the most shifts first (ties in order of
    first use), vector i's shifts ``s_j = k - 1 - j`` ascending in
    ``shifts[offs[i]:offs[i + 1]]``.  Each operand's shift appears once."""
    k = len(descs)
    first, vecs = {}, []
    g = np.empty(k, np.int64)
    for j, d in enumerate(descs):
        i = first.get(id(d))
        if i is None:
            i = first[id(d)] = len(vecs)
            vecs.append(d)
        g[j] = i
    counts = np.bincount(g, minlength=len(vecs))
    order = np.argsort(-counts, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    s = k - 1 - np.arange(k, dtype=np.int64)
    shifts = s[np.lexsort((s, rank[g]))]
    offs = np.zeros(len(vecs) + 1, np.int64)
    np.cumsum(counts[order], out=offs[1:])
    return [vecs[i] for i in order], offs, shifts


def chain_segments(offs, shifts):
    """Kernel shift_and_chain's plan of ``chain_groups``' CSR: each vector's
    shifts ``s = 32 q + r`` cut into segments of word shifts ``q`` that lie
    in one aligned span of CHAIN_SPAN -> ``(segs int32[m, 4], masks
    uint32[...], deep)``: a segment's vector, its lowest ``q`` (``qa``),
    its count of masks ``nq`` and the offset of its masks, mask ``i``
    holding bit ``r`` for each shift ``32 (qa + i) + r``; segments in
    vector order, ``qa`` ascending within a vector; ``deep`` the lowest
    list-block offset any segment's window reaches (its first word
    ``-ceil4(qa + nq)`` relative to the output row)."""
    vec = np.repeat(np.arange(offs.size - 1), np.diff(offs))
    q, r = shifts >> 5, shifts & 31
    key = vec * (1 << 40) + q // CHAIN_SPAN
    start = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    end = np.append(start[1:], key.size)
    qa, nq = q[start], q[end - 1] - q[start] + 1
    moff = np.zeros(start.size, np.int64)
    np.cumsum(nq[:-1], out=moff[1:])
    seg = np.repeat(np.arange(start.size), end - start)
    masks = np.zeros(int(nq.sum()), np.uint32)
    np.bitwise_or.at(masks, moff[seg] + q - qa[seg],
                     np.left_shift(np.uint32(1), r.astype(np.uint32)))
    segs = np.stack([vec[start], qa, nq, moff], 1).astype(np.int32)
    deep = int(-((int((qa + nq).max()) + 3) // 4 * 4) // SET_BLOCK_SIZE)
    return segs, masks, deep


def chain_and(first_mask, vecs, offs, shifts):
    """The Bitap chain's closed form over ``chain_groups``' grouping: the
    AND over the distinct vectors ``vecs`` of the AND over each one's
    shifts (in any order of the vectors) -> int32[n, 2048].  Per vector
    its rows are gathered once, and per word shift ``q`` the two source
    words ``w[x - q]`` and ``w[x - q - 1]`` once; each shift ``32 q + r``
    then takes ``(w[x - q] << r) | (w[x - q - 1] >> (32 - r))``, kernel
    shift_and_chain's funnel shift."""
    n = _desc_cols(vecs[0])
    dev = vecs[0][0].device
    words = n * SET_BLOCK_SIZE
    blk = torch.arange(n, dtype=_I64, device=dev)
    start = (first_mask.to(_I64) & 1) == 0
    if n:
        start[0] = True
    # first word of the run of adjacent blocks that holds each word
    lo = torch.cummax(torch.where(start, blk, 0), 0)[0] * SET_BLOCK_SIZE
    # each word's distance from that run's first word
    run = (torch.arange(words, dtype=_I64, device=dev)
           - lo.repeat_interleave(SET_BLOCK_SIZE))
    acc = torch.full((words,), 0xFFFFFFFF, dtype=_I64, device=dev)
    for v, d in enumerate(vecs):
        w = as_u32_int64(gather_rows(*d)).reshape(-1)

        def src(q):              # word x - q, 0 before x's run
            up = torch.zeros_like(w)
            up[q:] = w[:max(words - q, 0)]
            return torch.where(run >= q, up, 0)
        s = np.asarray(shifts[offs[v]:offs[v + 1]])
        for q in np.unique(s >> 5).tolist():
            pair = (src(q) << 32) | src(q + 1)
            for r in (s[(s >> 5) == q] & 31).tolist():
                acc &= (pair >> (32 - r)) & 0xFFFFFFFF
    return u32_to_i32(acc.reshape(n, SET_BLOCK_SIZE))


def shift_and_chain(first_mask, descs):
    """Plain version of the Bitap chain (bitmagic_tpu ``_shift_and_chain``,
    agg/aggregator.py:117: ``acc = rows_0``, then ``acc = shift_up1(acc) &
    rows_j``, over the block list's rows as one flat bit string, the carry
    into a block cleared where ``first_mask`` int32[n] has bit 0 clear) in
    its closed form, which kernel shift_and_chain computes: with k
    operands, flat bit p of the result is the AND over j of operand j's
    bit ``p - (k - 1 - j)``, and a source bit before the run of adjacent
    blocks that holds p (before the list, or across a block whose
    ``first_mask`` marks it not adjacent) reads 0.  The operands are
    grouped as the kernel groups them (``chain_groups``, ``chain_and``)
    -> int32[n, 2048]."""
    if not descs:
        raise ValueError("shift_and_chain: no operands")
    return chain_and(first_mask, *chain_groups(descs))


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
# D-GAP blocks to dense rows and back (plain versions of gap_expand and
# gap_compress, ops/csrc/gap_rows.cu); a store is the (ends, offs, first)
# arrays of core/gapstore.GapStore
# ---------------------------------------------------------------------------
def gap_expand(ends, offs, first, sel):
    """Dense rows int32[k, 2048] of the D-GAP blocks ``sel`` int[k] of the
    store (ends, offs, first), as ``GapStore.to_dense(sel)``.  A row's bit
    p is the parity of its toggles at or below p: bit 0 where the first run
    is ones, and the bit after each run end but the last; word by word, a
    prefix XOR inside the word and the parity of the words before it."""
    dev = sel.device
    sel = sel.to(_I64)
    k = sel.shape[0]
    lo = offs.to(_I64)[sel]
    n = offs.to(_I64)[sel + 1] - lo
    row = torch.repeat_interleave(torch.arange(k, device=dev), n)
    start = torch.cumsum(n, 0) - n
    run = (torch.arange(row.shape[0], device=dev)
           - start[row] + lo[row])
    e = ends.to(_I64)[run]
    inner = e < BITS_PER_BLOCK - 1          # every run end but the last
    ones = torch.nonzero(first.to(_I64)[sel] == 1).reshape(-1)
    pos = torch.cat([row[inner] * BITS_PER_BLOCK + e[inner] + 1,
                     ones * BITS_PER_BLOCK])
    # one word may hold several toggles, never the same bit twice
    tog = torch.zeros(k * SET_BLOCK_SIZE, dtype=_I64, device=dev)
    tog.index_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))
    x = tog
    for s in (1, 2, 4, 8, 16):
        x = x ^ ((x << s) & 0xFFFFFFFF)
    par = popcount(tog).reshape(k, SET_BLOCK_SIZE).to(_I64)
    before = (torch.cumsum(par, 1) - par) & 1
    return u32_to_i32(x.reshape(k, SET_BLOCK_SIZE) ^ (before * 0xFFFFFFFF))


def gap_expand_pair(mirror_a, mirror_b, sel, k_a):
    """Dense rows of two stores' D-GAP blocks: ``gap_expand`` of blocks
    ``sel[:k_a]`` of ``mirror_a``, then of ``sel[k_a:]`` of ``mirror_b``
    (a mirror None where its side selects no block)."""
    parts = [gap_expand(*m, s) for m, s in ((mirror_a, sel[:k_a]),
                                            (mirror_b, sel[k_a:]))
             if s.shape[0]]
    if not parts:
        return torch.zeros((0, SET_BLOCK_SIZE), dtype=torch.int32,
                           device=sel.device)
    return torch.cat(parts)


def gap_expand_many(mirrors, sel):
    """Dense rows of several stores' D-GAP blocks: ``gap_expand`` of
    blocks ``sel[i]`` (host int array) of ``mirrors[i]``, one store after
    another."""
    dev = mirrors[0][0].device
    parts = [gap_expand(*m, torch.from_numpy(np.asarray(s, np.int64)
                                             .ravel()).to(dev))
             for m, s in zip(mirrors, sel) if np.asarray(s).size]
    if not parts:
        return torch.zeros((0, SET_BLOCK_SIZE), dtype=torch.int32,
                           device=dev)
    return torch.cat(parts)


def gap_compress(rows, cap):
    """D-GAP encoding of rows int32[n, 2048], as ``GapStore.from_dense``,
    packed into one int32[2n + 1 + cap] buffer: ``offs`` (n + 1), ``first``
    (n, a word each), then the first ``min(total, cap)`` run ends (the
    rest of the buffer 0).  A run ends at each bit that differs from the
    bit after it, and at bit 65535.  ``offs[n]`` is the true total even
    above ``cap`` (clamped to 2^31 - 1); ``gap_unpack`` and
    ``GapStore.from_packed`` read the buffer."""
    n, dev = rows.shape[0], rows.device
    cap = int(cap)
    w = as_u32_int64(rows)
    after = torch.zeros_like(w)
    after[:, :-1] = w[:, 1:] & 1
    t = w ^ ((w >> 1) | (after << 31))
    t[:, -1] &= 0x7FFFFFFF
    counts = popcount(t).sum(dim=1, dtype=_I64)
    r, c = torch.nonzero(t, as_tuple=True)
    bit = torch.arange(32, device=dev)
    hit = ((t[r, c][:, None] >> bit) & 1) == 1
    at = ((r * BITS_PER_BLOCK + c * 32)[:, None] + bit)[hit]   # in order
    offs = torch.zeros(n + 1, dtype=_I64, device=dev)
    offs[1:] = torch.cumsum(counts + 1, 0)
    ends = torch.full((int(offs[-1]),), BITS_PER_BLOCK - 1, dtype=_I32,
                      device=dev)
    # each row before a run end adds its closing end before it
    ends[torch.arange(at.shape[0], device=dev) + (at >> 16)] = (
        at & (BITS_PER_BLOCK - 1)).to(_I32)
    buf = torch.zeros(2 * n + 1 + cap, dtype=_I32, device=dev)
    buf[:n + 1] = offs.clamp(max=2**31 - 1).to(_I32)
    buf[n + 1:2 * n + 1] = (w[:, 0] & 1).to(_I32)
    kept = min(ends.shape[0], cap)
    buf[2 * n + 1:2 * n + 1 + kept] = ends[:kept]
    return buf


def gap_unpack(buf, n):
    """``(ends, offs, first)`` views of a packed ``gap_compress`` buffer
    of ``n`` rows: ``ends`` the run ends written (at most ``cap``), the
    part of the buffer that is defined."""
    cap = buf.shape[0] - (2 * n + 1)
    total = int(buf[n])
    return (buf[2 * n + 1:2 * n + 1 + min(total, cap)], buf[:n + 1],
            buf[n + 1:2 * n + 1])


# ---------------------------------------------------------------------------
# SparseVector planes: the multi-plane gather and the import transpose
# ---------------------------------------------------------------------------
# columns of a plane-table row (sv_planes.cu struct Plane)
PLANE_COLS = ("nb_off", "nb_len", "run_off", "run_len", "pool", "ends",
              "offs", "first", "bit")


# the block directory's code of a plane with no bit in an interval (its
# other codes are ``ent``'s: pool row >= 0, -1 FULL, -2 - g D-GAP block g)
DIR_ZERO = -(1 << 31)
# the host directory's code of a block inside a FULL run, which the device
# directory writes as -1 like a FULL entry (the descent tells them apart)
DIR_RUN = DIR_ZERO + 1


@dataclasses.dataclass
class PlaneTable:
    """The planes of one column, as ``sv_gather`` reads them
    (``core/blocks.plane_table`` builds it).  Per plane ``p``, row ``p`` of
    ``meta`` (int64[P, 9], columns ``PLANE_COLS``) gives its slices of
    the concatenated ``nb`` (sorted block ids), ``ent`` (per block: pool
    row >= 0 of a BIT block, -1 FULL, -2 - g D-GAP block g) and ``runs``
    ([start, end) FULL block runs), the addresses of its pool and GAP
    store mirror, and the value bit it sets (-1: the NULL plane, whose 0
    bits zero the value).  ``table`` is ``meta`` on the device; ``pools``
    and ``gaps`` hold the tensors it points into, and keep them alive.
    ``blocks`` (host) are the sorted ids of the blocks any plane holds an
    entry for; ``extra`` is the device copy of the int64 array that
    ``plane_table`` was asked to upload with the table, or None.

    The block directory: ``bps`` (int64[B], sorted) are the block ids
    where any plane's state changes (each entry's block and the block
    after it, each FULL run's ends), and row ``r`` of ``dir``
    (int32[B + 1, P]) holds every plane's entry code for the blocks ``b``
    with ``r`` breakpoints at or below ``b`` (row 0: before the first;
    ``DIR_ZERO`` where the plane has no bit there, -1 inside a FULL run).
    ``bit_rows`` counts the rows with a BIT entry.  ``host_bps`` and
    ``host_dir`` are the directory on the host, with ``DIR_RUN`` where
    ``dir`` has -1 for a block inside a FULL run (a FULL entry stays -1):
    ``core/blocks.descent_codes`` reads them."""
    meta: np.ndarray
    table: torch.Tensor
    nb: torch.Tensor
    ent: torch.Tensor
    runs: torch.Tensor
    pools: list
    gaps: list
    blocks: np.ndarray
    bps: torch.Tensor
    dir: torch.Tensor
    bit_rows: int
    host_bps: np.ndarray
    host_dir: np.ndarray
    extra: torch.Tensor | None = None


def plane_entries(t: PlaneTable, p, blk):
    """int64[n]: plane ``p``'s entry code for blocks ``blk`` by searches
    of its block ids and FULL runs (the directory's codes)."""
    o, n, ro, rn = (int(x) for x in t.meta[p, :4])
    code = torch.full(blk.shape, DIR_ZERO, dtype=_I64, device=blk.device)
    if rn:                          # the last run starting at or before blk
        rs = t.runs[ro:ro + rn]
        k = torch.searchsorted(rs[:, 0].contiguous(), blk, right=True) - 1
        code[(k >= 0) & (blk < rs[k.clamp(min=0), 1])] = -1
    if n:
        nb = t.nb[o:o + n]
        pos = torch.searchsorted(nb, blk).clamp(max=n - 1)
        code = torch.where(nb[pos] == blk, t.ent[o:o + n][pos].to(_I64),
                           code)
    return code


def _plane_bits(t: PlaneTable, p, blk, nbit):
    """bool[n]: bit ``nbit`` of block ``blk`` in plane ``p``."""
    e = plane_entries(t, p, blk)
    val = e == -1
    pool = t.pools[p]
    if pool.shape[0]:
        w = pool.reshape(-1)[e.clamp(min=0) * SET_BLOCK_SIZE + (nbit >> 5)]
        val |= (e >= 0) & (((w >> (nbit & 31)) & 1) == 1)
    if t.gaps[p] is not None:       # the first run ending at or after nbit
        ends, offs, first = (a.to(_I64) for a in t.gaps[p])
        gap = (e <= -2) & (e != DIR_ZERO)
        g = torch.where(gap, -2 - e, 0)
        run_blk = torch.repeat_interleave(
            torch.arange(first.shape[0], device=blk.device), offs.diff())
        r = torch.searchsorted(run_blk * BITS_PER_BLOCK + ends,
                               g * BITS_PER_BLOCK + nbit)
        val |= gap & (((first[g] ^ (r - offs[g])) & 1) == 1)
    return val


def sv_gather(ids, table: PlaneTable):
    """The value image ``u`` int64[n] of ids int64[n] over a column's
    plane table: bit ``s`` of ``u`` is the id's bit in the plane of value
    bit ``s``, and ``u`` is 0 where the NULL plane's bit is 0 (the JAX
    package's ``_gather_decode_kernel`` with its FULL, D-GAP and NULL
    patches)."""
    blk = ids >> 16
    nbit = ids & (BITS_PER_BLOCK - 1)
    u = torch.zeros_like(ids)
    assigned = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    for p in range(table.meta.shape[0]):
        val = _plane_bits(table, p, blk, nbit)
        bit = int(table.meta[p, -1])
        if bit >= 0:
            u |= val.to(_I64) << bit
        else:
            assigned = val
    return torch.where(assigned, u, 0)


def sv_transpose(vals, n_slices):
    """Plane word image int32[n_slices, ceil(n / 32)] of values ``vals``
    (int32 holding uint32 values, or int64 holding uint64): word w of
    plane s holds bit s of values 32w .. 32w + 31, LSB first; values past
    n read as 0 (the JAX package's ``_transpose_kernel``)."""
    n = vals.shape[0]
    n_words = -(-n // 32)
    v = torch.zeros(n_words * 32, dtype=_I64, device=vals.device)
    v[:n] = as_u32_int64(vals) if vals.dtype == _I32 else vals
    v = v.reshape(n_words, 32)
    out = torch.empty((n_slices, n_words), dtype=_I32, device=vals.device)
    for s in range(n_slices):
        out[s] = pack_bits_to_words((v >> s) & 1)
    return out


# ---------------------------------------------------------------------------
# the MSB-first slice descent of the ordered searches (plain versions of
# sv_descent and descent_rows, ops/csrc/sv_descent.cu)
# ---------------------------------------------------------------------------
# a block's class in the descent: absent, FULL, inside a FULL run, BIT,
# D-GAP (sv_descent's class codes are the indices)
DESCENT_CLASSES = ("zero", "full", "run", "bit", "gap")
_DZ, _DF, _DR, _DB, _DG = range(len(DESCENT_CLASSES))
# run-count bound above which a GAP x GAP pair's result stays a dense BIT
# row (a >4096-run result would cost more than the 8 KB dense row)
GAP_MERGE_MAX_RUNS = 4096
_DESCENT_OPS = {"and": and_blocks, "or": or_blocks, "sub": sub_blocks}


def _descent_operand(t: PlaneTable, p, code):
    """Plane ``p`` of a plane table at the walked blocks whose entry
    codes in it are ``code`` int32[K] (``core/blocks.descent_codes``):
    ``(class int64[K], rows int32[K, 2048], runs int64[K])``, the run
    count of its D-GAP blocks."""
    code = code.to(_I64)
    k, dev = code.shape[0], code.device
    cls = torch.where(code >= 0, _DB, torch.where(
        code == -1, _DF, torch.where(code == DIR_RUN, _DR, torch.where(
            code == DIR_ZERO, _DZ, _DG))))
    idx = torch.where(code >= 0, code, -2 - code)
    rows = zero_pool(k, dev)
    rows[(cls == _DF) | (cls == _DR)] = -1
    bit = cls == _DB
    if bit.any():
        rows[bit] = t.pools[p][idx[bit]]
    runs = torch.zeros(k, dtype=_I64, device=dev)
    gap = cls == _DG
    if gap.any():
        ends, offs, first = t.gaps[p]
        rows[gap] = gap_expand(ends, offs, first, idx[gap])
        o64 = offs.to(_I64)
        runs[gap] = o64[idx[gap] + 1] - o64[idx[gap]]
    return cls, rows, runs


def _descent_pair(op, a, b):
    """``a OP b`` of two ``(class, rows, runs)`` block states, with the
    class the port's set operation gives the result (core/bitvector's
    ``_binary``): the FULL / absent algebra and the FULL-run interval
    algebra, the D-GAP pass-throughs, GAP x GAP pairs of at most
    GAP_MERGE_MAX_RUNS runs in all merged (absent when zero, FULL when all
    ones, else D-GAP), every other pair BIT."""
    sa, xa, na = a
    sb, xb, nb = b
    x = _DESCENT_OPS[op](xa, xb)
    ra, rb = sa == _DR, sb == _DR
    za, zb = sa == _DZ, sb == _DZ
    fa, fb = ra | (sa == _DF), rb | (sb == _DF)
    ga, gb = sa == _DG, sb == _DG
    cls = torch.full_like(sa, -1)
    runs = torch.zeros_like(na)

    def rule(cond, c, n=None):
        m = (cls < 0) & cond
        cls[m] = c
        if n is not None:
            runs[m] = n[m]

    if op == "and":
        rules = ((ra & rb, _DR), (za | zb, _DZ), (fa & fb, _DF),
                 (ga & fb, _DG, na), (fa & gb, _DG, nb))
    elif op == "or":
        rules = ((ra | rb, _DR), (za & zb, _DZ), (fa | fb, _DF),
                 (ga & zb, _DG, na), (za & gb, _DG, nb))
    else:
        rules = ((ra & zb, _DR), (za | fb, _DZ), (fa & zb, _DF),
                 (ga & zb, _DG, na), (fa & gb, _DG, nb))
    for r in rules:
        rule(*r)
    merge = (cls < 0) & ga & gb & (na + nb <= GAP_MERGE_MAX_RUNS)
    if merge.any():
        rule(merge & is_zero_blocks(x), _DZ)
        rule(merge & is_full_blocks(x), _DF)
        rule(merge, _DG, gap_counts(x).to(_I64))
    rule(torch.ones_like(ga), _DB)
    return cls, x, runs


def sv_descent(table: PlaneTable, utable: PlaneTable, codes, rows, bits,
               want_eq=True):
    """The MSB-first descent over K walked blocks given by their entry
    codes ``codes`` int32[K, len(rows) + 1] (``core/blocks.descent_codes``:
    column i step i's plane of ``table``, the last the universe's) (plain
    version of kernel sv_descent): eq starts as the universe (the one
    plane of ``utable``) and gt empty; step i takes plane ``rows[i]`` of
    ``table`` and bit i of ``bits``, a 1 making ``eq &= p``, a 0 ``gt |= eq
    & p; eq -= p``.  Each step keeps per block the class the port's set
    operation would give it (``_descent_pair``).  -> ``(gt int32[K,
    2048], its digest int32[K, 64], eq, its digest (both None without
    want_eq), classes int32[2K]: gt's, then eq's, each a class in bits
    0-7 and, for a D-GAP result, its run count above)``."""
    k, dev = codes.shape[0], codes.device
    eq = _descent_operand(utable, 0, codes[:, len(rows)])
    gt = (torch.zeros(k, dtype=_I64, device=dev), zero_pool(k, dev),
          torch.zeros(k, dtype=_I64, device=dev))
    for i, r in enumerate(rows):
        if bool((eq[0] == _DZ).all()):    # nothing changes any more
            break
        p = _descent_operand(table, r, codes[:, i])
        if (bits >> i) & 1:
            eq = _descent_pair("and", eq, p)
        else:
            gt = _descent_pair("or", gt, _descent_pair("and", eq, p))
            eq = _descent_pair("sub", eq, p)
    cls = torch.cat([gt[0] | (gt[2] << 8), eq[0] | (eq[2] << 8)]).to(_I32)
    if not want_eq:
        return gt[1], calc_digest(gt[1]), None, None, cls
    return gt[1], calc_digest(gt[1]), eq[1], calc_digest(eq[1]), cls


def descent_rows(stack, uni, rows, bits, sign=None, mode=0):
    """The MSB-first descent over one shard's stack int32[K, n, 2048]
    (plain version of kernel descent_rows, the JAX package's
    ``_descent_prog`` / ``_float_gt_prog`` loop): eq starts as ``uni``
    int32[n, 2048] (mode 1: ``uni & ~sign``, mode 2: ``uni & sign``), gt
    empty; step i takes stack row ``rows[i]`` (-1: a zero plane) and bit i
    of ``bits``.  -> ``(gt, eq)`` int32[n, 2048]."""
    eq = uni.clone() if mode == 0 else (sub_blocks(uni, sign) if mode == 1
                                        else and_blocks(uni, sign))
    gt = torch.zeros_like(uni)
    for i, r in enumerate(rows):
        p = stack[r] if r >= 0 else torch.zeros_like(uni)
        if (bits >> i) & 1:
            eq = eq & p
        else:
            gt = gt | (eq & p)
            eq = sub_blocks(eq, p)
    return gt, eq


def descent_steps(rows_by_bit, value):
    """The steps of a descent over all ``len(rows_by_bit)`` bits:
    ``(rows, bits)``, the row of each value bit from the top bit down, and
    the mask whose bit i is the value's bit at step i."""
    n = len(rows_by_bit)
    rows = [rows_by_bit[s] for s in range(n - 1, -1, -1)]
    bits = sum(((value >> s) & 1) << i
               for i, s in enumerate(range(n - 1, -1, -1)))
    return rows, bits


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
# bit unpack / pack (enumerator + import support)
# ---------------------------------------------------------------------------
def unpack_words_to_bits(words):
    """int32[...] words -> uint8[..., 32] little-endian bit expansion."""
    shifts = torch.arange(32, dtype=_I32, device=words.device)
    return ((words.to(_I32)[..., None] >> shifts) & 1).to(torch.uint8)


def pack_bits_to_words(bits):
    """{uint8,int32}[..., 32] 0/1 -> int32[...] words, little-endian."""
    shifts = torch.arange(32, dtype=_I64, device=bits.device)
    return u32_to_i32((bits.to(_I64) << shifts).sum(dim=-1))


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
