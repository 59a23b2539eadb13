"""Geometry constants of the PyTorch/CUDA succinct bit-vector port.

An own copy of ``bitmagic_tpu/constants.py`` (the port imports nothing of
the JAX package).  These mirror the reference geometry (BitMagic
`src/bmconst.h:55-124`) because bit-for-bit parity of logical / rank /
serialization results depends on the same block structure:

  * a *block* is 65536 bits = 2048 x 32-bit words,
  * a *wave* is 32 words = 1024 bits; 64 waves per block; the per-block
    *digest* has one bit per wave (reference `bm::id64_t` digest),
  * GAP (D-GAP run-length) buffers use 16-bit words with 4 length levels,
  * rank-select sub-block borders split a block in three at 21824 / 43648.

On the GPU the layout is dense pools ``int32[n_blocks, 2048]`` in device
memory (one row per allocated block, bit-identical to the reference's
``uint32`` words); an 8 KiB row is 512 16-byte vectors, two per thread of a
256-thread CTA.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Block geometry (reference: src/bmconst.h:55-68)
# ---------------------------------------------------------------------------
SET_BLOCK_SIZE = 2048            # words (uint32) per block
WORD_BITS = 32
BITS_PER_BLOCK = SET_BLOCK_SIZE * WORD_BITS      # 65536
SET_BLOCK_SHIFT = 16             # log2(BITS_PER_BLOCK)
SET_BLOCK_MASK = BITS_PER_BLOCK - 1
SET_WORD_SHIFT = 5               # log2(WORD_BITS)
SET_WORD_MASK = WORD_BITS - 1

# Digest geometry (reference: src/bmconst.h:66-68)
BLOCK_WAVES = 64                 # waves per block
WAVE_WORDS = SET_BLOCK_SIZE // BLOCK_WAVES       # 32 words = 1024 bits
WAVE_BITS = WAVE_WORDS * WORD_BITS               # 1024

# Two-level tree geometry of the reference (src/bmconst.h:95-113).  The port
# does not use a pointer tree, but the super-block unit (256 blocks)
# still matters for rank-select index layout and serialization grouping.
SET_ARRAY_SIZE = 256             # blocks per super-block
SUB_BLOCK_BITS = SET_ARRAY_SIZE * BITS_PER_BLOCK  # 16M bits per super-block

# 48-bit address space ceiling (reference bm64.h / src/bmconst.h:103-113).
ID_MAX48 = 1 << 48
ID_MAX32 = 1 << 32

# ---------------------------------------------------------------------------
# GAP (D-GAP run-length) parameters (reference: src/bmconst.h:76-87, 396-431)
# ---------------------------------------------------------------------------
GAP_MAX_BUFF_LEN = 1280
GAP_MAX_BITS = BITS_PER_BLOCK
GAP_EQUIV_LEN = BITS_PER_BLOCK // 16 // WORD_BITS   # gap words equivalent of a bit-block
GAP_LEVELS = 4
GAP_LEN_TABLE = (128, 256, 512, 1280)               # default glevel_len
GAP_LEN_TABLE_MIN = (32, 96, 128, 512)
GAP_WORD_MAX = 0xFFFF
GAP_MAX_SAFE_LEN = GAP_MAX_BUFF_LEN - 10

# ---------------------------------------------------------------------------
# Rank-select index (reference: src/bmconst.h:120-124, src/bmrs.h)
# ---------------------------------------------------------------------------
RS3_BORDER0 = 21824              # first sub-block border (bits)
RS3_BORDER1 = 43648              # second sub-block border (bits)

# ---------------------------------------------------------------------------
# Serialization (reference: src/bmconst.h:89, src/bmserial.h)
# ---------------------------------------------------------------------------
BIE_CUT_OFF = 16384              # BIC size cut-off (elements per block list)

# ---------------------------------------------------------------------------
# Block classes.  The reference tags block pointers (GAP bit in LSB, FULL
# sentinel address, NULL pointer for zero blocks, src/bmdef.h:165-199); the
# port replaces pointer tagging with an explicit class code per logical
# block.
# ---------------------------------------------------------------------------
CLS_ZERO = 0                     # no storage (all bits 0)
CLS_FULL = 1                     # no storage (all bits 1)
CLS_BIT = 2                      # dense row in the uint32[n, 2048] pool
CLS_GAP = 3                      # host-side D-GAP buffer (serialization form)

# strategy enum (reference src/bmconst.h:146-150)
BM_BIT = 0
BM_GAP = 1

# set_operation enum (reference src/bmconst.h:168-185)
SET_AND = 0
SET_OR = 1
SET_SUB = 2
SET_XOR = 3
SET_ASSIGN = 4
SET_COUNT = 5
SET_COUNT_AND = 6
SET_COUNT_XOR = 7
SET_COUNT_OR = 8
SET_COUNT_SUB_AB = 9
SET_COUNT_SUB_BA = 10
SET_COUNT_A = 11
SET_COUNT_B = 12

# set_representation enum (reference src/bmconst.h:217-223)
SET_BITSET = 0
SET_GAPS = 1
SET_ARRAY_ONE = 2
SET_ARRAY_ZERO = 3

# null_support enum (reference src/bmconst.h:229-233)
USE_NULL = 1
NO_NULL = 0

# optimization modes (reference src/bm.h:131-138)
OPT_NONE = 0
OPT_FREE_0 = 1
OPT_FREE_01 = 2
OPT_COMPRESS = 3

ALL_ONES_WORD = np.uint32(0xFFFFFFFF)


def blocks_for_bits(nbits: int) -> int:
    """Number of 64K-bit blocks needed to cover ``nbits`` bits."""
    return (int(nbits) + BITS_PER_BLOCK - 1) >> SET_BLOCK_SHIFT
