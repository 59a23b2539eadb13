"""Batched in-pool select: rank -> bit position (port of
``bitmagic_tpu/ops/select.py``), plain PyTorch on every device.

The wave-descent formulation: instead of gathering the whole 8 KiB block
row per query, search a per-wave popcount prefix table (256 B/row) and
gather only the query's 128 B wave; in-word select is the binary popcount
descent (bm::word_select32 analog, src/bmfunc.h:1075).  The JAX package's
sampled bucket search and f32 matmul cumsum were shaped for the TPU's
vector and matrix units; here the wave search is one
``torch.searchsorted`` over the prefix (the same count of prefix entries
below each rank) and the word prefix an int32 cumsum.
"""

from __future__ import annotations

import torch

from .. import constants as C
from .bitops import popcount, u32_to_i32, word_select32

_I32 = torch.int32
_I64 = torch.int64


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
