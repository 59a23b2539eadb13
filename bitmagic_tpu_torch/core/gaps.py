"""GAP (D-GAP run-length) classification parity (own copy of
``bitmagic_tpu/core/gaps.py``; numpy only).

The device representation is always dense (ZERO/FULL blocks cost nothing,
BIT blocks live in one device pool), but
the reference's *classification* semantics must match so that optimize(),
calc_stat() and the serialized formats agree with the reference:

  * gap_calc_level / GAP level tables   (src/bmfunc.h:5409,
    src/bmconst.h:396-431 — default {128,256,512,1280})
  * best_representation                 (src/bmfunc.h:9769)
  * improve_gap_levels / gap_overhead   (src/bmfunc.h:10170,10140)
  * the optimize() GAP-compressable threshold glen(max)-4
    (blocks_manager::optimize_bit_block, src/bmblocks.h:1414)

GAP length convention: a bit block with GC 0<->1 transitions (+1, i.e.
bit_block_calc_change) maps to a GAP buffer of GC+1 16-bit words
(head word + one boundary per run, final 65535 included).
"""

from __future__ import annotations

import numpy as np

from .. import constants as C

GAP_LEVELS = 4
GAP_MAX_BUFF_LEN = 1280

# set_representation (src/bmconst.h:217-223)
SET_BITSET = 0
SET_GAP = 1
SET_ARRAY1 = 2
SET_ARRAY0 = 3


def gap_calc_level(length, glevel_len) -> int:
    """Smallest level whose capacity-4 fits `length`; -1 if too big
    (src/bmfunc.h:5409)."""
    for lv in range(GAP_LEVELS):
        if length <= int(glevel_len[lv]) - 4:
            return lv
    return -1


def gap_calc_level_arr(lengths, glevel_len):
    """Vectorized gap_calc_level over an int64 array."""
    lengths = np.asarray(lengths, np.int64)
    lvl = np.full(lengths.shape, -1, np.int64)
    for lv in range(GAP_LEVELS - 1, -1, -1):
        lvl = np.where(lengths <= int(glevel_len[lv]) - 4, lv, lvl)
    return lvl


def gap_overhead(lengths, glevel_len) -> int:
    """Sum of capacity-length waste across GAP blocks (src/bmfunc.h:10140)."""
    total = 0
    for ln in lengths:
        lv = gap_calc_level(int(ln), glevel_len)
        if lv < 0:
            continue
        total += int(glevel_len[lv]) - int(ln)
    return total


def improve_gap_levels(lengths, glevel_len):
    """Optimize the per-vector GAP level table for the observed block
    lengths (src/bmfunc.h:10170).  Returns (improved, new_table)."""
    lengths = [int(x) for x in lengths]
    if not lengths:
        return False, tuple(glevel_len)
    glevel = list(glevel_len)
    max_len = max(lengths)
    if max_len < 5 or len(lengths) <= GAP_LEVELS:
        glevel[0] = max_len + 4
        for i in range(1, GAP_LEVELS):
            glevel[i] = GAP_MAX_BUFF_LEN
        return True, tuple(glevel)
    glevel[GAP_LEVELS - 1] = max_len + 5
    min_overhead = gap_overhead(lengths, glevel)
    improved = False
    for i in range(GAP_LEVELS - 2, -1, -1):
        saved = glevel[i]
        opt_len = 0
        imp = False
        for ln in lengths:
            glevel[i] = ln + 4
            ov = gap_overhead(lengths, glevel)
            if ov <= min_overhead:
                min_overhead = ov
                opt_len = ln + 4
                imp = True
        if imp:
            glevel[i] = opt_len
            improved = True
        else:
            glevel[i] = saved
    # deduplicate ascending (reference tail of improve_gap_levels)
    out = sorted(set(glevel))
    while len(out) < GAP_LEVELS:
        out.append(GAP_MAX_BUFF_LEN)
    return improved, tuple(out[:GAP_LEVELS])


def best_representation(bit_count, total_bits, gap_count, block_size_bytes):
    """Cheapest representation by byte cost (src/bmfunc.h:9769).
    gap_count here is the GAP buffer word count (GC+1)."""
    arr_size = 2 * bit_count + 2
    gap_size = 2 * gap_count + 2
    inv_arr_size = 2 * (total_bits - bit_count) + 2
    if gap_size < block_size_bytes and gap_size < arr_size and \
            gap_size < inv_arr_size:
        return SET_GAP
    if arr_size < inv_arr_size:
        if arr_size < block_size_bytes and arr_size < gap_size:
            return SET_ARRAY1
    else:
        if inv_arr_size < block_size_bytes and inv_arr_size < gap_size:
            return SET_ARRAY0
    return SET_BITSET


def classify_blocks(bc, gc, glevel_len):
    """Vectorized optimize()-style classification of BIT blocks.

    bc, gc: int64 arrays (popcount, bit_block_calc_change per block).
    Returns (gap_mask, gap_len, gap_level): blocks that the reference
    would convert to GAP at opt_compress (gap_len = GC+1 buffer words,
    threshold glen(max)-4, src/bmblocks.h:1433), with their level.
    """
    bc = np.asarray(bc, np.int64)
    gc = np.asarray(gc, np.int64)
    gap_len = gc + 1
    threshold = int(glevel_len[GAP_LEVELS - 1]) - 4
    gap_mask = (gc < threshold) & (bc > 0) & (bc < C.BITS_PER_BLOCK)
    level = gap_calc_level_arr(gap_len, glevel_len)
    gap_mask &= level >= 0
    return gap_mask, gap_len, level
