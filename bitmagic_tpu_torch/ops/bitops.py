"""Word-level bit utilities over int32 tensors that hold uint32 words
(the `src/bmutil.h` / low `src/bmfunc.h` equivalent; port of
``bitmagic_tpu/ops/bitops.py``).

PyTorch has no popcount or count-leading-zeros op, and on the CPU it
rejects ``~``, ``<<`` and ``>>`` on ``uint32``.  Words therefore stay int32
(bit-identical to the reference's uint32), and since ``>>`` on int32 is
arithmetic every right shift is masked.  The SWAR popcount works on the two
16-bit halves, so no intermediate ever leaves the non-negative int32 range.
clz comes from the float64 exponent (exact for every 32-bit value).
"""

from __future__ import annotations

import torch

_I32 = torch.int32
_I64 = torch.int64
_LOW32 = 0xFFFFFFFF


def _popcount16(v):
    """Popcount of values in [0, 65535] (any int dtype)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount(w):
    """Per-element population count of the low 32 bits -> int32."""
    return (_popcount16(w & 0xFFFF)
            + _popcount16((w >> 16) & 0xFFFF)).to(_I32)


def as_u32_int64(w):
    """uint32 value of each word as a non-negative int64."""
    return w.to(_I64) & _LOW32


def u32_to_i32(v):
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return ((v ^ 0x80000000) - 0x80000000).to(_I32)


def clz32(w):
    """Count leading zeros of each 32-bit word (32 for zero input)."""
    v = as_u32_int64(w)
    _, e = torch.frexp(v.to(torch.float64))      # v = m * 2^e, 0.5 <= m < 1
    return torch.where(v == 0, 32, 32 - e.to(_I32)).to(_I32)


def ctz32(w):
    """Count trailing zeros of each 32-bit word (32 for zero input);
    ctz(w) = 31 - clz(w & -w) (reference count_trailing_zeros,
    src/bmutil.h:190)."""
    v = as_u32_int64(w)
    iso = v & (-v)                        # isolate lowest set bit
    return torch.where(v == 0, 32, 31 - clz32(iso)).to(_I32)


def bit_scan_forward32(w):
    """Index of lowest set bit (32 for zero input)."""
    return ctz32(w)


def bit_scan_reverse32(w):
    """Index of highest set bit (reference bmutil.h:305)."""
    return 31 - clz32(w)


def word_select32(w, rank):
    """In-word select: position of the ``rank``-th (1-based) set bit of
    each 32-bit word (reference bm::word_select32, src/bmfunc.h:1075);
    binary popcount descent over 16/8/4/2/1-bit halves, elementwise."""
    cur = as_u32_int64(w)
    r = rank.to(_I32)
    pos = torch.zeros_like(r)
    for width in (16, 8, 4, 2, 1):
        lo = cur & ((1 << width) - 1)
        c = popcount(lo)
        go_hi = r > c
        r = torch.where(go_hi, r - c, r)
        pos = pos + torch.where(go_hi, width, 0).to(_I32)
        cur = torch.where(go_hi, cur >> width, lo)
    return pos


def parity(w):
    return popcount(w) & 1


def gap_mask(n_bits):
    """Low-bit mask of n_bits (n_bits in [0, 32]) as int32 words."""
    n = torch.as_tensor(n_bits).to(_I64)
    return u32_to_i32(torch.where(n >= 32, _LOW32, (1 << n.clamp(max=31)) - 1))
