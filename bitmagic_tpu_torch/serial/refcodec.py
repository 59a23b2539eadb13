"""Standalone clean-room codec for the REFERENCE serialization format.

Implements, from the format spec derived by structural analysis of the
reference (src/bmserial.h block codes :1173-1248, deserialize main loop
:5511, deseriaizer_base readers :4203-4750, src/encoding.h bitstreams),
a complete DECODER for reference-format BLOBs — all block-code families:

  * zero/one runs (1/8/16/32/64-scale + 7-bit packed + azero/aone)
  * raw bit blocks, bit intervals, 0-runs blocks, 1-bit blocks
  * set-bit arrays (direct/inverted), plain / gamma / BIC v1/v2/v3/v3s
  * D-GAP blocks plain / gamma / BIC v1/v2/v3/v3s / gamma_v3
  * digest0 (wave-compressed) blocks
  * super-block BIC arrays (v1 + v3)
  * bookmarks & sync marks (skipped on linear decode)
  * XOR reference filters (ref_eq, masked/unmasked 8/16/32-bit refs,
    GAP refs, XOR chains) given a reference vector collection
  * ID-list and 64-bit (BM64ADDR) headers

and an ENCODER producing reference-readable BLOBs from v1-generation
codes (raw / bit_1bit / arrbit(_inv) / gap / gap_egamma / arrgap_egamma /
arr_bienc(_inv, _8bh) / zero & one runs), with compression levels 0-6.

This is the port's own copy of ``bitmagic_tpu/serial/refcodec.py``: the
same stream grammar in Python + numpy, with the BIC and gamma hot loops in
the port's native library (``serial/native``, always built; no
pure-Python loop stands in for it).  Decoded vectors land on the device
given to ``RefDeserializer`` / ``ref_deserialize``.

Bit-exactness comes from matching the stream grammar the reference
defines; the array/GAP restore paths, XOR handling and fast-path
plumbing are original numpy formulations.  The centered-minimal BIC
inner step is ALGORITHMICALLY derived from the reference's coder
(bic_decode_u16_cm, src/encoding.h:2213): the interval arithmetic is
forced by bit-compatibility, so that piece necessarily mirrors the
published math (verified against fixtures in tests/fixtures/refblobs/).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import constants as C
from ..core.bitvector import BitVector
from ..core.blocks import (Structure, points_in_runs, runs_clip,
                           runs_normalize, runs_subtract_points)
from . import native


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))

# ---------------------------------------------------------------------------
# block-code constants (src/bmserial.h:1173-1248)
# ---------------------------------------------------------------------------
BLOCK_END = 0
BLOCK_1ZERO = 1
BLOCK_1ONE = 2
BLOCK_8ZERO = 3
BLOCK_8ONE = 4
BLOCK_16ZERO = 5
BLOCK_16ONE = 6
BLOCK_32ZERO = 7
BLOCK_32ONE = 8
BLOCK_AZERO = 9
BLOCK_AONE = 10
BLOCK_BIT = 11
BLOCK_SGAPBIT = 12
BLOCK_SGAPGAP = 13
BLOCK_GAP = 14
BLOCK_GAPBIT = 15
BLOCK_ARRBIT = 16
BLOCK_BIT_INTERVAL = 17
BLOCK_ARRGAP = 18
BLOCK_BIT_1BIT = 19
BLOCK_GAP_EGAMMA = 20
BLOCK_ARRGAP_EGAMMA = 21
BLOCK_BIT_0RUNS = 22
BLOCK_ARRGAP_EGAMMA_INV = 23
BLOCK_ARRGAP_INV = 24
BLOCK_64ZERO = 25
BLOCK_64ONE = 26
BLOCK_GAP_BIENC = 27
BLOCK_ARRGAP_BIENC = 28
BLOCK_ARRGAP_BIENC_INV = 29
BLOCK_ARRBIT_INV = 30
BLOCK_ARR_BIENC = 31
BLOCK_ARR_BIENC_INV = 32
BLOCK_BITGAP_BIENC = 33
BLOCK_BIT_DIGEST0 = 34
BLOCK_REF_EQ = 35
BLOCK_XOR_REF8 = 36
BLOCK_XOR_REF16 = 37
BLOCK_XOR_REF32 = 38
BLOCK_XOR_GAP_REF8 = 39
BLOCK_XOR_GAP_REF16 = 40
BLOCK_XOR_GAP_REF32 = 41
BLOCK_XOR_CHAIN = 42
BLOCK_GAP_BIENC_V2 = 43
BLOCK_ARRGAP_BIENC_V2 = 44
BLOCK_ARRGAP_BIENC_INV_V2 = 45
BLOCK_BITGAP_BIENC_V2 = 46
NB_BOOKMARK16 = 47
NB_BOOKMARK24 = 48
NB_BOOKMARK32 = 49
NB_SYNC_MARK8 = 50
NB_SYNC_MARK16 = 51
NB_SYNC_MARK24 = 52
NB_SYNC_MARK32 = 53
NB_SYNC_MARK48 = 54
NB_SYNC_MARK64 = 55
SBLOCK_BIENC = 56
BLOCK_ARR_BIENC_8BH = 57
BLOCK_XOR_REF8_UM = 58
BLOCK_XOR_REF16_UM = 59
BLOCK_XOR_REF32_UM = 60
BLOCK_GAP_BIENC_V3 = 61
BLOCK_GAP_BIENC_V3S = 62
BLOCK_ARR_BIENC_V3 = 63
BLOCK_ARR_BIENC_INV_V3 = 64
BLOCK_ARR_BIENC_V3S = 65
BLOCK_ARR_BIENC_INV_V3S = 66
BLOCK_GAP_EGAMMA_V3 = 67
SBLOCK_BIENC_V3 = 68
SBLOCK_BIENC_GAPS_V3 = 69

# header flags (src/bmserial.h:1157-1167)
HM_DEFAULT = 1
HM_RESIZE = 1 << 1
HM_ID_LIST = 1 << 2
HM_NO_BO = 1 << 3
HM_NO_GAPL = 1 << 4
HM_64_BIT = 1 << 5
HM_HXOR = 1 << 6
HM_SPARSE = 1 << 7

# v2 gap-head flags (src/bmserial.h:1258-1259)
H2F_MIN_V_8BIT = 1 << 1
H2F_MAX_V_8BIT = 1 << 2

# v3 head flags (src/bmserial.h:1263-1267)
H3F_MIN0_SKIP = 1 << 3
H3F_MIN0_8BIT = 1 << 4
H3F_MIN1_8BIT = 1 << 5
H3F_MIN1_SKIP = 1 << 6
H3F_EXCEPTIONS = 1 << 7
GAP_LEN_CUT_OFF_V3 = 4

# encode_array / decode_array flags (src/encoding.h:1821-1840)
H3F_EX_UPPER2 = 0b11
H3F_USE_GAMMA = 1 << 3
H3F_EX_ARR_1 = 1 << 4
H3F_EX_ARR_EX_EOC = 1 << 5
H3F_EX_ARR_MIN0_0 = 1 << 6
H3F_EX_MINMAX_V = 1 << 7
WCNT_CUTOFF = 15

# sblock flags (src/bmserial.h:2930-2942)
SB_FLAG_SB16 = 1
SB_FLAG_SB32 = 1 << 1
SB_FLAG_SBGAMMA = SB_FLAG_SB16 | SB_FLAG_SB32
SB_FLAG_MIN16 = 1 << 2
SB_FLAG_MIN24 = 1 << 3
SB_FLAG_LEN16 = 1 << 4
SB_FLAG_MAX16 = 1 << 5
SB_FLAG_MAX24 = 1 << 6
SB_FLAG_DR_MIN = 1 << 7

WORDS = 2048                 # words per block
BITS = 65536                 # bits per block
WAVE_WORDS = 32              # digest wave size in words
SUB_ARRAY = 256              # blocks per super-block
SUB_TOTAL_BITS = SUB_ARRAY * BITS
ID_MAX32 = 0xFFFFFFFF
TOTAL_BLOCKS32 = 65536
DEFAULT_GLEVELS = (128, 256, 512, 1280)

_FULL = "FULL"


# ---------------------------------------------------------------------------
# byte reader / writer (little-endian, matching bm::encoder/decoder)
# ---------------------------------------------------------------------------
class _ByteReader:
    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes):
        self.buf = np.frombuffer(bytes(data), np.uint8)
        self.pos = 0

    def get_8(self):
        v = int(self.buf[self.pos]); self.pos += 1; return v

    def _get(self, nbytes):
        p = self.pos
        v = 0
        for i in range(nbytes):
            v |= int(self.buf[p + i]) << (8 * i)
        self.pos = p + nbytes
        return v

    def get_16(self): return self._get(2)
    def get_24(self): return self._get(3)
    def get_32(self): return self._get(4)
    def get_48(self): return self._get(6)
    def get_64(self): return self._get(8)

    def get_h64(self):
        """h-compressed u64 (decoder_base::get_h64, src/encoding.h:897)."""
        h_mask = self.get_8()
        w = 0
        for i in range(8):
            if h_mask & (1 << i):
                w |= self.get_8() << (8 * i)
        return w

    def get_u16_array(self, n):
        if n < 0 or self.pos + 2 * n > len(self.buf):
            raise ValueError("malformed stream: bad u16 array length")
        p = self.pos
        out = self.buf[p:p + 2 * n].view("<u2").astype(np.int64)
        self.pos = p + 2 * n
        return out

    def get_u32_words(self, n):
        if n < 0 or self.pos + 4 * n > len(self.buf):
            raise ValueError("malformed stream: bad word-run length")
        p = self.pos
        out = self.buf[p:p + 4 * n].view("<u4").astype(np.uint32)
        self.pos = p + 4 * n
        return out


class _ByteWriter:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts = bytearray()

    def put_8(self, v): self.parts.append(v & 0xFF)

    def _put(self, v, nbytes):
        for i in range(nbytes):
            self.parts.append((v >> (8 * i)) & 0xFF)

    def put_16(self, v): self._put(v, 2)
    def put_24(self, v): self._put(v, 3)
    def put_32(self, v): self._put(v, 4)
    def put_48(self, v): self._put(v, 6)
    def put_64(self, v): self._put(v, 8)

    def put_u16_array(self, arr):
        self.parts += np.asarray(arr, "<u2").tobytes()

    def put_u32_words(self, words):
        self.parts += np.asarray(words, "<u4").tobytes()

    def get_bytes(self):
        return bytes(self.parts)


# ---------------------------------------------------------------------------
# bitstream reader / writer (32-bit LE words, LSB-first; bm::bit_in/bit_out)
# ---------------------------------------------------------------------------
class _BitIn:
    """Pulls whole 32-bit LE words from the shared byte reader on demand,
    consuming bits LSB-first — matches bm::bit_in (src/encoding.h:299)."""

    __slots__ = ("rdr", "acc", "n")

    def __init__(self, rdr: _ByteReader):
        self.rdr = rdr
        self.acc = 0
        self.n = 0

    def get_bits(self, count):
        while self.n < count:
            self.acc |= self.rdr.get_32() << self.n
            self.n += 32
        v = self.acc & ((1 << count) - 1)
        self.acc >>= count
        self.n -= count
        return v

    def get_bit(self):
        return self.get_bits(1)

    def gamma(self):
        zeros = 0
        while not self.get_bit():
            zeros += 1
        if zeros == 0:
            return 1
        return self.get_bits(zeros) | (1 << zeros)

    def gamma8(self):
        c = self.gamma()
        if c == 1:
            return self.gamma()
        if c == 2:
            return self.get_bits(8)
        if c == 3:
            return self.delta16()
        return 0  # c == 4

    def delta16(self):
        order = self.gamma()
        if order == 1:
            return 511 - self.get_bits(8)
        if order == 2:
            return 512 + 255 - self.get_bits(8)
        if order == 3:
            return 512 + 256 + 255 - self.get_bits(8)
        return self.get_16_no()

    def delta16s(self):
        if self.get_bit():
            return self.delta16()
        return self.get_bits(8)

    def get_16_no(self):
        return self.get_bits(8) | (self.get_bits(8) << 8)

    def get_24_no(self):
        return self.get_bits(8) | (self.get_bits(8) << 8) | \
            (self.get_bits(8) << 16)

    def get_32_no(self):
        return self.get_16_no() | (self.get_16_no() << 16)

    # -- Binary Interpolative Coding, centered-minimal (bic_*_cm) ----------
    def bic_decode_cm(self, sz, lo, hi):
        """Returns int64 array of sz values in (lo..hi); mirrors
        bit_in::bic_decode_u16_cm / u32_cm (src/encoding.h:2404/2358).
        The hot loop runs in C++ (codecs.cpp bmref_bic_decode_cm).
        Inverted ranges are rejected here — a crafted header with max < min
        would otherwise reach shift-by-64 UB in the C decoder and wrap
        negative positions via numpy indexing (round-5 hardening)."""
        if sz < 0 or hi < lo:
            raise ValueError("malformed stream: inverted BIC range")
        out = np.zeros(sz, np.int64)
        if not sz:
            return out
        pos = ctypes.c_int64(self.rdr.pos)
        acc = ctypes.c_uint64(self.acc)
        nb = ctypes.c_int32(self.n)
        rc = native.load().bmref_bic_decode_cm(
            _u8p(self.rdr.buf), self.rdr.buf.size, ctypes.byref(pos),
            ctypes.byref(acc), ctypes.byref(nb), sz, int(lo), int(hi),
            _i64p(out))
        if rc != 0:
            raise ValueError("BIC bitstream overrun")
        self.rdr.pos = pos.value
        self.acc = acc.value
        self.n = nb.value
        return out

    def gamma_array(self, n):
        """Decode n Elias-gamma values -> int64 array (codecs.cpp
        bmref_gamma_decode)."""
        out = np.zeros(n, np.uint32)
        if not n:
            return out.astype(np.int64)
        pos = ctypes.c_int64(self.rdr.pos)
        acc = ctypes.c_uint64(self.acc)
        nb = ctypes.c_int32(self.n)
        rc = native.load().bmref_gamma_decode(
            _u8p(self.rdr.buf), self.rdr.buf.size, ctypes.byref(pos),
            ctypes.byref(acc), ctypes.byref(nb), n, _u32p(out))
        if rc != 0:
            raise ValueError("gamma bitstream overrun")
        self.rdr.pos = pos.value
        self.acc = acc.value
        self.n = nb.value
        return out.astype(np.int64)

    # -- selective array decode (bit_in::decode_array, src/encoding.h:2697)
    def decode_array(self, default_sz=0):
        """Returns (h3_flag, np.int64 array)."""
        h3 = self.get_bits(8)
        if (h3 & H3F_EX_UPPER2) == H3F_EX_UPPER2 and (h3 & (1 << 7)):
            return h3, np.zeros(0, np.int64)          # no-op, 0 length
        if (h3 & H3F_EX_UPPER2) == H3F_EX_UPPER2:     # single value
            if h3 & H3F_EX_ARR_MIN0_0:
                v = 0
            elif h3 & H3F_USE_GAMMA:
                v = self.gamma()
            else:
                v = self.get_16_no()
            return h3, np.asarray([v], np.int64)
        # multi-value
        if default_sz:
            sz = default_sz
        elif h3 & H3F_USE_GAMMA:
            sz = self.gamma8() + 1
        else:
            sz = self.delta16()
        if sz > 65536:
            raise ValueError("malformed stream: array length over block")
        min0 = 0 if (h3 & H3F_EX_ARR_MIN0_0) else self.gamma()
        if (h3 & H3F_EX_UPPER2) == 0:                 # delta-gamma
            zero_correct = bool(h3 & (1 << 7))
            arr = np.zeros(sz, np.int64)
            arr[0] = 0 if zero_correct else self.gamma()
            for i in range(1, sz):
                arr[i] = arr[i - 1] + self.gamma() + min0
            return h3, arr
        if h3 & (1 << 1):                             # gamma
            zero_correct = bool(h3 & (1 << 7))
            arr = np.asarray(
                [self.gamma() - zero_correct + min0 for _ in range(sz)],
                np.int64)
            return h3, arr
        # BIC-DR
        arr = np.zeros(sz, np.int64)
        if h3 & H3F_EX_MINMAX_V:
            min_v = self.get_16_no()
            max_v = self.get_16_no()
            arr[0] = min_v
            arr[sz - 1] = max_v
            if sz == 2:
                return h3, arr
            if sz > 2:
                arr[1:sz - 1] = self.bic_decode_cm(sz - 2, min_v + 1,
                                                   max_v - 1)
        else:
            arr[:] = self.bic_decode_cm(sz, 0, 65535)
        use_wdr = self.get_bit()
        if use_wdr:
            win_size = self.gamma()
            wcnt = self.gamma() + WCNT_CUTOFF - 1
            win_size = (win_size + 9) * 2
            max_wd = (sz // win_size) + 1
            wflags = set(self.bic_decode_cm(wcnt, 1, max_wd))
            _arr_restore_min_w(arr, win_size, min0, wflags)
        elif min0:
            _arr_restore_min(arr, min0)
        return h3, arr


def _arr_restore_min(arr, min0, delta_acc=0):
    """bm::arr_restore_min (src/bmfunc.h:2648): arr[i] += i*min0 + acc."""
    arr += min0 * np.arange(len(arr), dtype=np.int64) + delta_acc


def _arr_restore_min_w(arr, wlen, min0, wflags):
    """bm::arr_restore_min_w (src/bmfunc.h:2517) — per-window DR restore."""
    arr_len = len(arr)
    delta_acc = 0
    min_w_prev = (1 << 63)
    for i in range(1, min(wlen, arr_len)):
        arr[i] += min0 + delta_acc
        delta_acc += min0
        delta = arr[i] - arr[i - 1]
        if delta < min_w_prev:
            min_w_prev = delta
    min_w_prev -= bool(min_w_prev)
    wave = 1
    i = wlen
    while i < arr_len:
        if i + wlen > arr_len:
            wlen = arr_len % wlen
        w_recalc = wave in wflags
        min_w = (1 << 63)
        for j in range(wlen):
            if w_recalc:
                arr[i + j] += min_w_prev + delta_acc
                delta_acc += min_w_prev
            else:
                arr[i + j] += min0 + delta_acc
                delta_acc += min0
            delta = arr[i + j] - arr[i + j - 1]
            if delta < min_w:
                min_w = delta
        min_w_prev = (min_w - 1) if min_w > min0 else min0
        wave += 1
        i += wlen


def _gamma_bits(v: int) -> int:
    return 2 * v.bit_length() - 1


def _delta16_bits(v: int) -> int:
    if 256 <= v <= 511:
        return 1 + 8
    if 512 <= v <= 1023:
        return 3 + 8
    return 5 + 16


def _delta16s_bits(v: int) -> int:
    return 9 if v < 256 else 1 + _delta16_bits(v)


def _gamma8_bits(v: int) -> int:
    if v == 0:
        return 5
    best = 1 + _gamma_bits(v)
    if v < 256:
        best = min(best, 3 + 8)
    return min(best, 3 + _delta16_bits(v))


class _BitOut:
    """LSB-first bit writer flushing 32-bit LE words (bm::bit_out)."""

    __slots__ = ("wtr", "acc", "n")

    def __init__(self, wtr: _ByteWriter):
        self.wtr = wtr
        self.acc = 0
        self.n = 0

    def put_bits(self, value, count):
        self.acc |= (value & ((1 << count) - 1)) << self.n
        self.n += count
        while self.n >= 32:
            self.wtr.put_32(self.acc & 0xFFFFFFFF)
            self.acc >>= 32
            self.n -= 32

    def put_bit(self, v):
        self.put_bits(v, 1)

    def gamma(self, value):
        logv = value.bit_length() - 1
        self.put_bits(1 << logv, logv + 1)       # logv zeros then a 1 bit
        if logv:
            self.put_bits(value & ((1 << logv) - 1), logv)

    def put_16_no(self, v):
        self.put_bits(v & 0xFF, 8)
        self.put_bits((v >> 8) & 0xFF, 8)

    # writer counterparts of _BitIn.delta16 / delta16s / gamma8 (formats
    # pinned by our own readers above; reference bit_out::delta16 family,
    # src/encoding.h)
    def delta16(self, v):
        if 256 <= v <= 511:
            self.gamma(1)
            self.put_bits(511 - v, 8)
        elif 512 <= v <= 767:
            self.gamma(2)
            self.put_bits(512 + 255 - v, 8)
        elif 768 <= v <= 1023:
            self.gamma(3)
            self.put_bits(768 + 255 - v, 8)
        else:
            self.gamma(4)
            self.put_16_no(v)

    def delta16s(self, v):
        if v < 256:
            self.put_bit(0)
            self.put_bits(v, 8)
        else:
            self.put_bit(1)
            self.delta16(v)

    def gamma8(self, v):
        """Cheapest of the reader's four gamma8 arms per value."""
        if v == 0:
            self.gamma(4)
            return
        costs = [(1 + _gamma_bits(v), 1)]
        if v < 256:
            costs.append((3 + 8, 2))
        costs.append((3 + _delta16_bits(v), 3))
        _, arm = min(costs)
        if arm == 1:
            self.gamma(1)
            self.gamma(v)
        elif arm == 2:
            self.gamma(2)
            self.put_bits(v, 8)
        else:
            self.gamma(3)
            self.delta16(v)

    def gamma_many(self, arr):
        """Bulk Elias-gamma writes (codecs.cpp bmref_gamma_encode)."""
        arr = np.ascontiguousarray(arr, np.uint32)
        if arr.size:
            self._native_put(native.load().bmref_gamma_encode,
                             (_u32p(arr), arr.size), arr.size * 5 + 16,
                             "gamma encode overflow")

    def bic_encode_cm(self, arr, lo, hi):
        """bit_out::bic_encode_u16_cm (src/encoding.h:1766); the hot loop
        runs in C++ (codecs.cpp bmref_bic_encode_cm)."""
        a = np.ascontiguousarray(arr, np.int64)
        if a.size:
            self._native_put(native.load().bmref_bic_encode_cm,
                             (_i64p(a), a.size, int(lo), int(hi)),
                             a.size * 8 + 64, "BIC encode overflow")

    def _native_put(self, fn, args, cap, what):
        """Run a native bit writer ``fn(*args, acc, nbits, out, cap,
        written)`` that continues this writer's state and append the whole
        32-bit words it wrote."""
        acc = ctypes.c_uint64(self.acc)
        nb = ctypes.c_int32(self.n)
        out = np.zeros(cap, np.uint8)
        written = ctypes.c_int64(0)
        if fn(*args, ctypes.byref(acc), ctypes.byref(nb), _u8p(out),
              out.size, ctypes.byref(written)) != 0:
            raise ValueError(what)
        self.wtr.parts += out[:written.value].tobytes()
        self.acc = acc.value
        self.n = nb.value

    def flush(self):
        if self.n:
            self.wtr.put_32(self.acc & 0xFFFFFFFF)
            self.acc = 0
            self.n = 0


# ---------------------------------------------------------------------------
# block-content helpers
# ---------------------------------------------------------------------------
def _cat(*parts):
    return np.concatenate([np.atleast_1d(np.asarray(x, np.int64))
                           for x in parts])


def _words_from_positions(pos, invert=False):
    bits = np.zeros(BITS, np.uint8)
    if len(pos):
        p = np.asarray(pos, np.int64)
        if p.min() < 0 or p.max() >= BITS:
            raise ValueError("malformed stream: bit position out of block")
        bits[p] = 1
    if invert:
        bits = 1 - bits
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _words_from_gap(start_bit, boundaries):
    """GAP semantics: run i covers (prev_boundary, boundaries[i]] with value
    start_bit ^ (i & 1); boundaries end with 65535."""
    b = np.asarray(boundaries, np.int64)
    if b.size and (b.min() < 0 or b.max() >= BITS
                   or (np.diff(b) <= 0).any()):
        raise ValueError("malformed stream: bad GAP boundaries")
    runs = np.diff(np.concatenate([[-1], b]))
    vals = ((np.arange(len(b)) + start_bit) % 2).astype(np.uint8)
    bits = np.repeat(vals, runs)
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _positions_from_words(words, invert=False):
    return native.block_positions(words, invert)


def _gap_boundaries_from_words(words):
    """Returns (start_bit, boundaries ending with 65535)."""
    return native.block_gap_boundaries(words)


def _gap_restore_mins(boundaries_head_arr, min0, min1):
    """bm::gap_restore_mins (src/bmfunc.h:3000).  Operates on the raw GAP
    buffer layout: buf[0]=head, buf[1..L]=boundaries (buf[L]==65535)."""
    buf = boundaries_head_arr
    dsize = int(buf[0]) >> 3
    i = 1
    buf[i] += min0
    delta_acc = min0
    i += 1
    while i <= dsize:
        if i == dsize:
            break
        buf[i] += min1 + delta_acc
        delta_acc += min1
        i += 1
        if i < dsize:
            buf[i] += min0 + delta_acc
            delta_acc += min0
            i += 1
        else:
            break


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _bv_block_map(bv):
    """{nb: uint32[2048] words | _FULL} for every stored block of ``bv``
    (the bv_ref_vector row view both XOR codecs share).  GAP-resident
    blocks expand transiently via the dense snapshot."""
    nb_arr, cls_arr, pool = bv._dense_snapshot()
    slots = np.where(cls_arr == C.CLS_BIT,
                     np.cumsum(cls_arr == C.CLS_BIT) - 1, -1)
    out = {}
    for k in range(len(nb_arr)):
        if cls_arr[k] == C.CLS_FULL:
            out[int(nb_arr[k])] = _FULL
        else:
            out[int(nb_arr[k])] = pool[slots[k]]
    return out


def _wave_popcounts(words):
    """Per-wave (64 x 1024-bit) popcounts of a dense block."""
    return np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8)).reshape(
            BITS // (WAVE_WORDS * 32), -1).sum(axis=1)



class _FullSet:
    """FULL-block tracker for the reference-format decoder: point set +
    wide half-open [s, e) spans, so a multi-block one-run record costs
    O(1) regardless of width (round-5 hardening: a ~15-byte blob could
    previously claim 2^64 FULL blocks and spin the decoder forever).
    Spans at or below _PT_MAX expand to points (every per-block consumer
    keeps working unchanged); wider spans stay interval-coded and become
    Structure.runs at assembly."""

    _PT_MAX = 4096
    __slots__ = ("pts", "iv")

    def __init__(self):
        self.pts: set = set()
        self.iv: list = []           # [s, e) spans, may overlap pts

    def add(self, nb):
        self.pts.add(nb)

    def add_run(self, s, e):
        if e <= s:
            return
        if e - s <= self._PT_MAX:
            self.pts.update(range(int(s), int(e)))
        else:
            self.iv.append((int(s), int(e)))

    def __contains__(self, nb):
        if nb in self.pts:
            return True
        return any(s <= nb < e for s, e in self.iv)

    def discard(self, nb):
        if nb in self.pts:
            self.pts.discard(nb)
            return
        for i, (s, e) in enumerate(self.iv):
            if s <= nb < e:
                del self.iv[i]
                self.add_run(s, nb)
                self.add_run(nb + 1, e)
                return

    def __len__(self):
        return len(self.pts) + sum(e - s for s, e in self.iv)


class RefDeserializer:
    """Standalone decoder for reference-format BLOBs.

    ref_vectors: optional list of (row_id, BitVector) pairs — the analog of
    bm::bv_ref_vector, required only for BLOBs serialized with the XOR
    filter (header flag HM_HXOR / codes 35-42, 58-60).  ``device``: where
    the decoded vector's dense rows go (``config.resolve_device``; the
    card unless the CPU is asked for).
    """

    def __init__(self, ref_vectors=None, device=None):
        self.device = device
        self.ref_vectors = list(ref_vectors or [])
        self._ref_rows = {int(r): bv for r, bv in self.ref_vectors}
        self._ref_cache = {}
        self.code_stat = {}   # per-block-code decode counters (parity debug)

    # -- reference-vector block access -------------------------------------
    def _ref_block_words(self, row_idx, nb):
        """Returns uint32[2048] words, _FULL, or None for a ref block."""
        bv = self._ref_rows.get(int(row_idx))
        if bv is None:
            raise ValueError(f"XOR ref row {row_idx} not in ref_vectors")
        key = id(bv)
        cached = self._ref_cache.get(key)
        if cached is None:
            cached = self._ref_cache[key] = _bv_block_map(bv)
        return cached.get(int(nb))

    # -----------------------------------------------------------------
    def deserialize(self, data: bytes, range_=None, sink=None):
        """Decode a reference BLOB; with ``range_=(lo, hi)`` only the bit
        range is materialized and bookmark sync marks (set_nb_bookmark*/
        set_nb_sync_mark*, src/bmserial.h:1224-1232) fast-skip whole
        regions of the stream (deserialize_range equivalent).

        With ``sink`` (callable ``sink(nb, words_or_None)``; None = FULL
        block) the decoder STREAMS: finalized blocks flush to the sink in
        ascending order as the cursor passes them and the method returns
        the decoded ``size`` — the serial_stream_iterator mode
        (src/bmserial.h:847) behind the reference-format
        operation_deserializer; memory stays O(pending blocks)."""
        nb_from, nb_to = 0, 1 << 62
        if range_ is not None:
            nb_from = int(range_[0]) >> 16
            nb_to = int(range_[1]) >> 16

        r = _ByteReader(data)
        header = r.get_8()
        if not (header & HM_NO_BO):
            r.get_8()                      # byte order mark (LE assumed)
        is64 = bool(header & HM_64_BIT)
        size = (1 << 48) if is64 else ID_MAX32

        blocks: dict[int, np.ndarray] = {}
        full = _FullSet()

        def or_words(nb, words):
            if nb in full:
                return
            cur = blocks.get(nb)
            if cur is None:
                blocks[nb] = words.astype(np.uint32, copy=True)
            else:
                cur |= words

        if header & HM_ID_LIST:
            if header & HM_RESIZE:
                size = r.get_64() if is64 else r.get_32()
            cnt = r.get_32()
            ids = np.asarray([r.get_32() for _ in range(cnt)], np.int64)
            self.bytes_consumed = r.pos
            if sink is not None:
                if ids.size and int(ids.max()) >= max(int(size), 1):
                    raise ValueError(
                        "malformed stream: id beyond declared size")
                for nb in np.unique(ids >> 16):
                    inb = ids[(ids >> 16) == nb] & 0xFFFF
                    w = np.zeros(WORDS, np.uint32)
                    np.bitwise_or.at(w, inb >> 5,
                                     np.uint32(1) << (inb & 31).astype(
                                         np.uint32))
                    sink(int(nb), w)
                return max(int(size), 1)
            return BitVector.from_indices(ids, max(size, 1),
                                          device=self.device)

        if not (header & HM_NO_GAPL):
            for _ in range(4):
                r.get_16()                 # GAP level table (informational)
        if header & HM_RESIZE:
            size = r.get_64() if is64 else r.get_32()

        total_blocks = (1 << 32) if is64 else TOTAL_BLOCKS32

        flush_mark = 0        # sink mode: blocks below this are delivered

        def _flush_to(limit):
            """Deliver finalized blocks (< limit) to the sink, ascending.
            A pending XOR block caps the limit: its decode completes only
            when the NEXT xor-family record (or stream end) triggers
            xor_decode, so flushing past it would deliver higher blocks
            first and break the sink's ascending-order contract (the
            trial_stream xor fuzz caught exactly that, seed 5104).
            Tail/range clamping happens at delivery time."""
            nonlocal flush_mark
            if x_nb >= 0:
                limit = min(limit, x_nb)
            if limit <= flush_mark:
                return
            last_nb_ = (max(int(size), 1) - 1) >> 16
            tail_bits_ = max(int(size), 1) - (last_nb_ << 16)
            if full.iv:
                # wide FULL spans cannot be streamed per-block through
                # the sink contract; the caller decodes-then-applies
                # (same fallback as BMT1 FULL_RUN records)
                raise native.RunCodedBlob()
            pend = [k for k in blocks if k < limit] + \
                   [k for k in full.pts if k < limit]
            for nb in sorted(pend):
                if nb in full:
                    full.discard(nb)
                    if nb > last_nb_ or not (nb_from <= nb <= nb_to):
                        continue
                    if nb == last_nb_ and tail_bits_ < BITS:
                        sink(nb, np.full(WORDS, 0xFFFFFFFF, np.uint32)
                             & _tail_mask(tail_bits_))
                    else:
                        sink(nb, None)
                    continue
                w = blocks.pop(nb)
                if nb > last_nb_ or not (nb_from <= nb <= nb_to):
                    continue
                if nb == last_nb_ and tail_bits_ < BITS:
                    w = w & _tail_mask(tail_bits_)
                if w.any():
                    sink(nb, w)
            flush_mark = limit

        # XOR FSM state
        x_row = x_d64 = 0
        x_nb = -1
        x_chain = []
        or_block = None

        def xor_decode():
            nonlocal x_row, x_d64, x_nb, x_chain, or_block
            ref = self._ref_block_words(x_row, x_nb)
            if ref is None:
                if or_block is not None:
                    or_words(x_nb, or_block)
                if x_chain:
                    blk = blocks.get(x_nb)
                    if blk is None and x_nb not in full:
                        blk = blocks[x_nb] = np.zeros(WORDS, np.uint32)
                    if x_nb not in full:
                        _apply_chain(blk, x_chain)
            else:
                if ref is _FULL:
                    ref = np.full(WORDS, 0xFFFFFFFF, np.uint32)
                if x_nb in full:
                    full.discard(x_nb)
                    blk = blocks[x_nb] = np.full(WORDS, 0xFFFFFFFF,
                                                 np.uint32)
                else:
                    blk = blocks.get(x_nb)
                    if blk is None:
                        blk = blocks[x_nb] = np.zeros(WORDS, np.uint32)
                _xor_digest(blk, ref, x_d64)
                if x_chain:
                    _apply_chain(blk, x_chain)
                if or_block is not None:
                    blk |= or_block
            x_row = x_d64 = 0
            x_nb = -1
            x_chain = []
            or_block = None

        def _apply_chain(blk, chain):
            for row, d64 in chain:
                refc = self._ref_block_words(row, x_nb if x_nb >= 0 else 0)
                if refc is None:
                    continue
                if refc is _FULL:
                    refc = np.full(WORDS, 0xFFFFFFFF, np.uint32)
                _xor_digest(blk, refc, d64)

        def start_xor(nb_i, row, d64):
            nonlocal x_row, x_d64, x_nb, or_block
            x_row, x_d64, x_nb = row, d64, nb_i
            if nb_i in full:
                or_block = np.full(WORDS, 0xFFFFFFFF, np.uint32)
                full.discard(nb_i)
            elif nb_i in blocks:
                or_block = blocks.pop(nb_i)

        nb_i = 0
        while nb_i < total_blocks:
            if nb_i > nb_to:
                break                      # past the requested range
            if sink is not None and nb_i > flush_mark and \
                    (len(blocks) + len(full)) > 4:
                _flush_to(nb_i)
            btype = r.get_8()
            if btype & 0x80:               # 7-bit packed zero run
                nb_i += btype & 0x7F
                continue
            self.code_stat[btype] = self.code_stat.get(btype, 0) + 1

            if btype in (BLOCK_AZERO, BLOCK_END):
                break
            if btype == BLOCK_1ZERO:
                pass
            elif btype == BLOCK_8ZERO:
                nb_i += r.get_8(); continue
            elif btype == BLOCK_16ZERO:
                nb_i += r.get_16(); continue
            elif btype == BLOCK_32ZERO:
                nb_i += r.get_32(); continue
            elif btype == BLOCK_64ZERO:
                nb_i += r.get_64(); continue
            elif btype == BLOCK_AONE:
                end = min(total_blocks, (size >> 16) + 1)
                for k in [k for k in blocks if nb_i <= k < end]:
                    blocks.pop(k)
                full.add_run(nb_i, end)
                break
            elif btype == BLOCK_1ONE:
                blocks.pop(nb_i, None)
                full.add(nb_i)
            elif btype in (BLOCK_8ONE, BLOCK_16ONE, BLOCK_32ONE,
                           BLOCK_64ONE):
                n = {BLOCK_8ONE: r.get_8, BLOCK_16ONE: r.get_16,
                     BLOCK_32ONE: r.get_32, BLOCK_64ONE: r.get_64}[btype]()
                if nb_i + n > total_blocks:
                    raise ValueError(
                        "malformed stream: one-run past the address space")
                for k in [k for k in blocks if nb_i <= k < nb_i + n]:
                    blocks.pop(k)
                full.add_run(nb_i, nb_i + n)
                nb_i += n - 1
            elif btype == BLOCK_BIT:
                or_words(nb_i, r.get_u32_words(WORDS))
            elif btype == BLOCK_BIT_1BIT:
                pos = r.get_16()
                w = np.zeros(WORDS, np.uint32)
                w[pos >> 5] = np.uint32(1 << (pos & 31))
                or_words(nb_i, w)
            elif btype == BLOCK_BIT_0RUNS:
                or_words(nb_i, self._read_0runs(r))
            elif btype == BLOCK_BIT_INTERVAL:
                head = r.get_16()
                tail = r.get_16()
                w = np.zeros(WORDS, np.uint32)
                w[head:tail + 1] = r.get_u32_words(tail - head + 1)
                or_words(nb_i, w)
            elif btype in (BLOCK_GAP, BLOCK_GAPBIT, BLOCK_ARRGAP,
                           BLOCK_GAP_EGAMMA, BLOCK_ARRGAP_EGAMMA,
                           BLOCK_ARRGAP_EGAMMA_INV, BLOCK_ARRGAP_INV,
                           BLOCK_GAP_BIENC, BLOCK_GAP_BIENC_V2,
                           BLOCK_ARRGAP_BIENC, BLOCK_ARRGAP_BIENC_INV,
                           BLOCK_ARRGAP_BIENC_V2, BLOCK_ARRGAP_BIENC_INV_V2,
                           BLOCK_GAP_BIENC_V3, BLOCK_GAP_BIENC_V3S,
                           BLOCK_GAP_EGAMMA_V3):
                or_words(nb_i, self._read_gap_family(r, btype))
            elif btype == BLOCK_ARRBIT:
                ln = r.get_16()
                pos = r.get_u16_array(ln)
                or_words(nb_i, _words_from_positions(pos))
            elif btype == BLOCK_ARRBIT_INV:
                ln = r.get_16()
                pos = r.get_u16_array(ln)
                or_words(nb_i, _words_from_positions(pos, invert=True))
            elif btype in (BLOCK_ARR_BIENC, BLOCK_ARR_BIENC_INV,
                           BLOCK_ARR_BIENC_8BH, BLOCK_ARR_BIENC_V3,
                           BLOCK_ARR_BIENC_INV_V3, BLOCK_ARR_BIENC_V3S,
                           BLOCK_ARR_BIENC_INV_V3S):
                or_words(nb_i, self._read_bic_arr(r, btype))
            elif btype == BLOCK_BITGAP_BIENC:
                or_words(nb_i, self._read_bic_gap(r))
            elif btype == BLOCK_BIT_DIGEST0:
                or_words(nb_i, self._read_digest0(r))
            elif btype in (SBLOCK_BIENC, SBLOCK_BIENC_V3):
                sb, arr = self._read_sblock(r, btype)
                if (sb + 1) * SUB_TOTAL_BITS > (total_blocks << 16):
                    raise ValueError(
                        "malformed stream: super-block index out of space")
                base = sb * SUB_TOTAL_BITS
                for off in arr:
                    idx = base + int(off)
                    nb = idx >> 16
                    if nb >= total_blocks:
                        raise ValueError(
                            "malformed stream: sblock offset out of space")
                    w = blocks.get(nb)
                    if nb in full:
                        continue
                    if w is None:
                        w = blocks[nb] = np.zeros(WORDS, np.uint32)
                    bit = idx & 0xFFFF
                    w[bit >> 5] |= np.uint32(1 << (bit & 31))
                nb_i += SUB_ARRAY - (nb_i & (SUB_ARRAY - 1))
                continue
            elif btype == SBLOCK_BIENC_GAPS_V3:
                # dead code point in the format: the reference's OWN
                # emitter for code 69 is compiled out (`#if (0)` around
                # bienc_gaps_sblock, src/bmserial.h:3117), so no producer
                # exists; raise rather than guess at an unexercised layout
                raise ValueError(
                    "sblock_bienc_gaps_v3: no serializer emits this code "
                    "(reference emitter disabled at src/bmserial.h:3117)")
            elif btype in (NB_BOOKMARK16, NB_BOOKMARK24, NB_BOOKMARK32):
                skip_off = {NB_BOOKMARK16: r.get_16, NB_BOOKMARK24: r.get_24,
                            NB_BOOKMARK32: r.get_32}[btype]()
                if range_ is not None and skip_off and nb_i < nb_from:
                    # try_skip (src/bmserial.h:5040): peek the sync mark at
                    # the bookmark target; jump when still before the range
                    save = r.pos
                    skip_pos = r.pos + skip_off
                    if skip_pos + 1 < r.buf.size:
                        r.pos = skip_pos
                        sync = r.get_8()
                        getter = {NB_SYNC_MARK8: r.get_8,
                                  NB_SYNC_MARK16: r.get_16,
                                  NB_SYNC_MARK24: r.get_24,
                                  NB_SYNC_MARK32: r.get_32,
                                  NB_SYNC_MARK48: r.get_48,
                                  NB_SYNC_MARK64: r.get_64}.get(sync)
                        if getter is not None:
                            target = nb_i + getter()
                            if target <= nb_from:
                                nb_i = target
                                continue
                        r.pos = save
                continue
            elif btype in (NB_SYNC_MARK8, NB_SYNC_MARK16, NB_SYNC_MARK24,
                           NB_SYNC_MARK32, NB_SYNC_MARK48, NB_SYNC_MARK64):
                {NB_SYNC_MARK8: r.get_8, NB_SYNC_MARK16: r.get_16,
                 NB_SYNC_MARK24: r.get_24, NB_SYNC_MARK32: r.get_32,
                 NB_SYNC_MARK48: r.get_48, NB_SYNC_MARK64: r.get_64}[btype]()
                continue
            elif btype == BLOCK_REF_EQ:
                if x_nb >= 0:
                    xor_decode()
                row = r.get_32()
                ref = self._ref_block_words(row, nb_i)
                if ref is _FULL:
                    blocks.pop(nb_i, None)
                    full.add(nb_i)
                elif ref is not None:
                    or_words(nb_i, ref)
            elif btype in (BLOCK_XOR_REF8, BLOCK_XOR_REF16, BLOCK_XOR_REF32,
                           BLOCK_XOR_REF8_UM, BLOCK_XOR_REF16_UM,
                           BLOCK_XOR_REF32_UM):
                if x_nb >= 0:
                    xor_decode()
                row = {BLOCK_XOR_REF8: r.get_8, BLOCK_XOR_REF16: r.get_16,
                       BLOCK_XOR_REF32: r.get_32,
                       BLOCK_XOR_REF8_UM: r.get_8,
                       BLOCK_XOR_REF16_UM: r.get_16,
                       BLOCK_XOR_REF32_UM: r.get_32}[btype]()
                d64 = r.get_64() if btype <= BLOCK_XOR_REF32 \
                    else 0xFFFFFFFFFFFFFFFF
                start_xor(nb_i, row, d64)
                continue
            elif btype in (BLOCK_XOR_GAP_REF8, BLOCK_XOR_GAP_REF16,
                           BLOCK_XOR_GAP_REF32):
                if x_nb >= 0:
                    xor_decode()
                row = {BLOCK_XOR_GAP_REF8: r.get_8,
                       BLOCK_XOR_GAP_REF16: r.get_16,
                       BLOCK_XOR_GAP_REF32: r.get_32}[btype]()
                start_xor(nb_i, row, 0xFFFFFFFFFFFFFFFF)
                continue
            elif btype == BLOCK_XOR_CHAIN:
                if x_nb >= 0:
                    xor_decode()
                vbr = r.get_8()
                if vbr not in (0, 1, 2):
                    raise ValueError(f"malformed xor-chain vbr {vbr}")
                row = {1: r.get_8, 2: r.get_16, 0: r.get_32}[vbr]()
                d64 = r.get_h64()
                chain_n = r.get_8()
                chain = []
                for _ in range(chain_n):
                    ref_idx = {1: r.get_8, 2: r.get_16, 0: r.get_32}[vbr]()
                    chain.append((ref_idx, r.get_h64()))
                start_xor(nb_i, row, d64)
                x_chain = chain
                continue
            elif btype in (BLOCK_SGAPBIT, BLOCK_SGAPGAP):
                raise ValueError(f"legacy sgap code {btype} unsupported")
            else:
                raise ValueError(f"unknown block code {btype}")
            nb_i += 1

        if x_nb >= 0:
            xor_decode()

        self.bytes_consumed = r.pos   # for embedded BLOBs (SV plane streams)

        if sink is not None:
            _flush_to(1 << 62)
            return max(int(size), 1)

        # assemble BitVector: clamp to size (and to range_, host-side)
        size = max(int(size), 1)
        last_nb = (size - 1) >> 16
        tail_bits = size - (last_nb << 16)
        lo_edge = hi_edge = None
        if range_ is not None:
            lo_bit, hi_bit = int(range_[0]), int(range_[1])
            lo_edge = (nb_from, _edge_mask_ge(lo_bit & 0xFFFF))
            hi_edge = (nb_to, _edge_mask_le(hi_bit & 0xFFFF))
        # wide FULL spans become Structure runs (the ref-format analog of
        # BMT1 FULL_RUN assembly); edge blocks that need masks leave the
        # runs and take the per-block path
        iv =(runs_normalize(np.asarray(full.iv, np.int64).reshape(-1, 2))
              if full.iv else np.zeros((0, 2), np.int64))
        iv = runs_clip(iv, nb_from, min(nb_to, last_nb) + 1)
        edge = set()
        if tail_bits < BITS:
            edge.add(last_nb)
        if lo_edge is not None:
            edge.add(lo_edge[0])
        if hi_edge is not None:
            edge.add(hi_edge[0])
        if iv.shape[0] and edge:
            pts = np.asarray(sorted(edge), np.int64)
            inside = points_in_runs(pts, iv)
            if inside.any():
                iv = runs_subtract_points(iv, pts[inside])
                full.pts.update(int(x) for x in pts[inside])

        def _covered(nb):
            return iv.shape[0] and bool(points_in_runs(
                np.asarray([nb], np.int64), iv)[0])

        nbs, clss, rows = [], [], []
        for nb in sorted(set(blocks) | full.pts):
            if nb > last_nb or not (nb_from <= nb <= nb_to):
                continue
            if _covered(nb):
                continue
            w = None
            if nb in full:
                if (nb == last_nb and tail_bits < BITS) or \
                        (lo_edge and nb == lo_edge[0]) or \
                        (hi_edge and nb == hi_edge[0]):
                    w = np.full(WORDS, 0xFFFFFFFF, np.uint32)
                else:
                    nbs.append(nb); clss.append(C.CLS_FULL)
                    continue
            else:
                w = blocks[nb]
            if nb == last_nb and tail_bits < BITS:
                w = w & _tail_mask(tail_bits)
            if lo_edge and nb == lo_edge[0]:
                w = w & lo_edge[1]
            if hi_edge and nb == hi_edge[0]:
                w = w & hi_edge[1]
            if not w.any():
                continue
            nbs.append(nb); clss.append(C.CLS_BIT); rows.append(w)
        pool = (np.stack(rows) if rows
                else np.zeros((0, WORDS), np.uint32))
        struct = Structure(np.asarray(nbs, np.int64),
                           np.asarray(clss, np.uint8), iv)
        return BitVector._from_parts(struct, pool, size, device=self.device)

    def deserialize_range(self, data: bytes, lo: int, hi: int):
        return self.deserialize(data, range_=(lo, hi))

    # -- per-family readers -------------------------------------------------
    @staticmethod
    def _read_0runs(r):
        """set_block_bit_0runs (read_0runs_block, src/bmserial.h:4674)."""
        w = np.zeros(WORDS, np.uint32)
        run_type = r.get_8()
        j = 0
        while j < WORDS:
            run_len = r.get_16()
            if run_type:
                w[j:j + run_len] = r.get_u32_words(run_len)
            j += run_len
            run_type = not run_type
        return w

    @staticmethod
    def _read_digest0(r):
        """set_block_bit_digest0 (read_digest0_block, src/bmserial.h:4634)."""
        w = np.zeros(WORDS, np.uint32)
        d0 = r.get_64()
        wave = 0
        while d0:
            if d0 & 1:
                off = wave * WAVE_WORDS
                w[off:off + WAVE_WORDS] = r.get_u32_words(WAVE_WORDS)
            d0 >>= 1
            wave += 1
        return w

    def _read_bic_arr(self, r, btype):
        """read_bic_arr families (src/bmserial.h:4284)."""
        if btype in (BLOCK_ARR_BIENC, BLOCK_ARR_BIENC_INV):
            min_v = r.get_16()
            max_v = r.get_16()
            arr_len = r.get_16()
            bi = _BitIn(r)
            mids = bi.bic_decode_cm(arr_len - 2, min_v, max_v) \
                if arr_len > 2 else []
            return _words_from_positions(
                _cat(min_v, mids, max_v),
                invert=(btype == BLOCK_ARR_BIENC_INV))
        if btype == BLOCK_ARR_BIENC_8BH:
            min_v = r.get_8()
            max_delta = r.get_8()
            max_v = (65536 - max_delta) & 0xFFFF
            arr_len = r.get_16()
            bi = _BitIn(r)
            mids = bi.bic_decode_cm(arr_len - 2, min_v, max_v) \
                if arr_len > 2 else []
            return _words_from_positions(_cat(min_v, mids, max_v))
        if btype in (BLOCK_ARR_BIENC_V3, BLOCK_ARR_BIENC_INV_V3):
            bi = _BitIn(r)
            w = np.zeros(WORDS, np.uint32)
            h3, arr_s = bi.decode_array()
            for p in arr_s:
                w[int(p) >> 5] |= np.uint32(1 << (int(p) & 31))
            if not (h3 & H3F_EX_ARR_EX_EOC):
                _h3r, arr_r = bi.decode_array()
                h3rl, arr_rl = bi.decode_array(default_sz=len(arr_r))
                if (h3rl & H3F_EX_UPPER2) == 1:      # BIC coder: ends stored
                    arr_rl = arr_rl - arr_r
                bits = np.unpackbits(w.view(np.uint8), bitorder="little")
                for s, ln in zip(arr_r, arr_rl):
                    bits[int(s):int(s) + int(ln) + 1] = 1
                w = np.packbits(bits, bitorder="little").view(np.uint32)
            if btype == BLOCK_ARR_BIENC_INV_V3:
                w = ~w
            return w
        # v3s
        bi = _BitIn(r)
        arr_len = bi.delta16s()
        need_min_max = bi.get_bits(1)
        parts = []
        if need_min_max:
            min_v = bi.delta16s()
            arr_len -= 2
            max_delta = bi.delta16s()
            max_v = (65536 - max_delta) & 0xFFFF
            parts.append(np.asarray([min_v, max_v], np.int64))
            min_v += 1
            max_v -= 1
        else:
            min_v, max_v = 0, 65535
        if arr_len:
            parts.append(bi.bic_decode_cm(arr_len, min_v, max_v))
        pos = _cat(*parts) if parts else np.zeros(0, np.int64)
        return _words_from_positions(
            pos, invert=(btype == BLOCK_ARR_BIENC_INV_V3S))

    @staticmethod
    def _read_bic_gap(r):
        """set_block_bitgap_bienc (read_bic_gap, src/bmserial.h:4611)."""
        head = r.get_8()
        arr_len = r.get_16()
        min_v = r.get_16()
        bi = _BitIn(r)
        mids = bi.bic_decode_cm(arr_len - 2, min_v, 65535) \
            if arr_len > 2 else []
        # gap buffer [head, b1..] — head bit0 is the start value
        return _words_from_gap(head & 1, _cat(min_v, mids, 65535))

    def _read_gap_family(self, r, btype):
        """All GAP-family codes -> dense words (read_gap_block,
        src/bmserial.h:4748 + deserialize_gap :5245)."""
        if btype in (BLOCK_GAP, BLOCK_GAPBIT):
            head = r.get_16()
            L = head >> 3
            vals = r.get_u16_array(L - 1)
            boundaries = np.concatenate([vals, [BITS - 1]])
            return _words_from_gap(head & 1, boundaries)

        if btype in (BLOCK_ARRGAP, BLOCK_ARRGAP_INV):
            ln = r.get_16()
            pos = r.get_u16_array(ln)
            return _words_from_positions(pos,
                                         invert=(btype == BLOCK_ARRGAP_INV))

        if btype in (BLOCK_ARRGAP_EGAMMA, BLOCK_ARRGAP_EGAMMA_INV):
            bi = _BitIn(r)
            ln = bi.gamma()
            vals = bi.gamma_array(ln)
            if ln:
                vals[0] -= 1
            pos = np.cumsum(vals)
            return _words_from_positions(
                pos, invert=(btype == BLOCK_ARRGAP_EGAMMA_INV))

        if btype in (BLOCK_ARRGAP_BIENC, BLOCK_ARRGAP_BIENC_INV):
            min_v = r.get_16()
            max_v = r.get_16()
            bi = _BitIn(r)
            ln = bi.gamma() + 4
            if ln > 65536:
                raise ValueError("malformed stream: gap array over block")
            mids = bi.bic_decode_cm(ln - 2, min_v, max_v)
            return _words_from_positions(
                _cat(min_v, mids, max_v),
                invert=(btype == BLOCK_ARRGAP_BIENC_INV))

        if btype in (BLOCK_ARRGAP_BIENC_V2, BLOCK_ARRGAP_BIENC_INV_V2):
            ln = r.get_16()
            min_v = r.get_8() if (ln & 1) else r.get_16()
            max_d = r.get_8() if (ln & 2) else r.get_16()
            max_v = (min_v + max_d) & 0xFFFF
            ln >>= 2
            bi = _BitIn(r)
            mids = bi.bic_decode_cm(ln - 2, min_v, max_v) if ln > 2 else []
            return _words_from_positions(
                _cat(min_v, mids, max_v),
                invert=(btype == BLOCK_ARRGAP_BIENC_INV_V2))

        if btype == BLOCK_GAP_EGAMMA:
            head = r.get_16()
            L = (head >> 3) - 1
            bi = _BitIn(r)
            vals = bi.gamma_array(L)
            if L:
                vals[0] -= 1
            return _words_from_gap(head & 1,
                                   _cat(np.cumsum(vals), BITS - 1))

        if btype == BLOCK_GAP_EGAMMA_V3:
            bi = _BitIn(r)
            L = bi.gamma() + 1
            start = bi.get_bit()
            use_gamma = bi.get_bit()
            vals = []
            if use_gamma:
                prev = bi.gamma8()
                vals.append(prev)
                for _ in range(2, L):
                    prev += bi.gamma8()
                    vals.append(prev)
            else:
                for _ in range(1, L):
                    vals.append(bi.get_16_no())
            boundaries = np.asarray(vals + [BITS - 1], np.int64)
            return _words_from_gap(start, boundaries)

        if btype == BLOCK_GAP_BIENC:
            head = r.get_16()
            L = head >> 3
            min_v = r.get_16()
            bi = _BitIn(r)
            mids = bi.bic_decode_cm(L - 2, min_v, 65535) if L > 2 else []
            return _words_from_gap(head & 1, _cat(min_v, mids, BITS - 1))

        if btype == BLOCK_GAP_BIENC_V2:
            head = r.get_16()
            L = head >> 3
            min_v = r.get_8() if (head & H2F_MIN_V_8BIT) else r.get_16()
            max_v = r.get_8() if (head & H2F_MAX_V_8BIT) else r.get_16()
            max_v = (65535 - max_v) & 0xFFFF
            bi = _BitIn(r)
            mids = bi.bic_decode_cm(L - 3, min_v, max_v) if L > 3 else []
            return _words_from_gap(
                head & 1, _cat(min_v, mids, max_v, BITS - 1))

        if btype == BLOCK_GAP_BIENC_V3S:
            bi = _BitIn(r)
            head = bi.delta16s()
            L = head >> 3
            min8 = head & H2F_MIN_V_8BIT
            tail8 = head & H2F_MAX_V_8BIT
            min_v = bi.gamma8() if min8 else bi.get_16_no()
            max_v = bi.gamma8() if tail8 else bi.get_16_no()
            max_v = (65535 - max_v) & 0xFFFF
            mids = bi.bic_decode_cm(L - 3, min_v, max_v) if L > 3 else []
            return _words_from_gap(
                head & 1, _cat(min_v, mids, max_v, BITS - 1))

        if btype == BLOCK_GAP_BIENC_V3:
            return self._read_gap_bienc_v3(r)

        raise ValueError(f"unhandled GAP code {btype}")

    @staticmethod
    def _read_gap_bienc_v3(r):
        """set_block_gap_bienc_v3 (src/bmserial.h:4884)."""
        bi = _BitIn(r)
        head_v3 = bi.get_bits(8)
        gap_head = bi.delta16s()
        L = gap_head >> 3
        start = gap_head & 1

        def decode_min_max():
            min_v = bi.get_bits(8) if (gap_head & H2F_MIN_V_8BIT) \
                else bi.get_16_no()
            if gap_head & H2F_MAX_V_8BIT:
                mv = bi.get_bits(8)
                mv = (mv << 3) | (head_v3 & 0b111)
            else:
                mv = bi.get_16_no()
            return min_v, (65535 - mv) & 0xFFFF

        def decode_mins():
            min0 = min1 = 0
            if not (head_v3 & H3F_MIN0_SKIP):
                min0 = bi.gamma8() if (head_v3 & H3F_MIN0_8BIT) \
                    else bi.delta16()
            if not (head_v3 & H3F_MIN1_SKIP):
                min1 = bi.gamma8() if (head_v3 & H3F_MIN1_8BIT) \
                    else bi.delta16()
            return min0, min1

        def bic_body():
            min_v, max_v = decode_min_max()
            min0, min1 = decode_mins()
            mids = bi.bic_decode_cm(L - 3, min_v + 1, max_v) if L > 3 else []
            buf = np.zeros(L + 1, np.int64)
            buf[0] = gap_head & ~6         # head with v2 flags cleared
            buf[1] = min_v
            if L > 3:
                buf[2:L - 1] = mids
            buf[L - 1] = max_v + 1
            buf[L] = BITS - 1
            return buf, min0, min1

        if head_v3 & H3F_EXCEPTIONS:
            if L < GAP_LEN_CUT_OFF_V3:
                vals = []
                if L > 1:
                    prev = bi.delta16s()
                    vals.append(prev)
                    for _ in range(2, L):
                        prev += bi.delta16s()
                        vals.append(prev)
                boundaries = np.asarray(vals + [BITS - 1], np.int64)
            else:
                buf, min0, min1 = bic_body()
                _gap_restore_mins(buf, min0, min1)
                boundaries = buf[1:]
            words = _words_from_gap(start, boundaries)
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            h3, ex = bi.decode_array()
            bits[ex.astype(np.int64)] = 1 if (h3 & H3F_EX_ARR_1) else 0
            if not (h3 & H3F_EX_ARR_EX_EOC):
                h3b, ex2 = bi.decode_array()
                bits[ex2.astype(np.int64)] = 1 if (h3b & H3F_EX_ARR_1) else 0
            return np.packbits(bits, bitorder="little").view(np.uint32)
        buf, min0, min1 = bic_body()
        if min0 or min1:
            _gap_restore_mins(buf, min0, min1)
        return _words_from_gap(start, buf[1:])

    @staticmethod
    def _read_sblock(r, btype):
        """set_sblock_bienc (v1+v3) -> (sb_index, offsets array)
        (read_bic_sb_arr, src/bmserial.h:4423)."""
        bi = _BitIn(r)
        if btype == SBLOCK_BIENC:
            sb_flag = r.get_8()
            if sb_flag & SB_FLAG_SB32:
                sb = r.get_32()
            elif sb_flag & SB_FLAG_SB16:
                sb = r.get_16()
            else:
                sb = r.get_8()
            ln = r.get_16() if (sb_flag & SB_FLAG_LEN16) else r.get_8()
            if not ln:
                raise ValueError("zero-length sblock")
            if sb_flag & SB_FLAG_MIN24:
                min_v = r.get_32() if (sb_flag & SB_FLAG_MIN16) else \
                    r.get_24()
            elif sb_flag & SB_FLAG_MIN16:
                min_v = r.get_16()
            else:
                min_v = r.get_8()
            if sb_flag & SB_FLAG_MAX24:
                max_v = r.get_32() if (sb_flag & SB_FLAG_MAX16) else \
                    r.get_24()
            elif sb_flag & SB_FLAG_MAX16:
                max_v = r.get_16()
            else:
                max_v = r.get_8()
            max_v = SUB_TOTAL_BITS - max_v
            min0 = 0
            if sb_flag & SB_FLAG_DR_MIN:
                min0 = bi.gamma() if bi.get_bit() else bi.get_16_no()
            arr = np.zeros(ln, np.int64)
            arr[0] = min_v
            arr[ln - 1] = max_v
            if ln > 2:
                arr[1:ln - 1] = bi.bic_decode_cm(ln - 2, min_v, max_v)
            if min0:
                _arr_restore_min(arr, min0)
            return sb, arr
        # v3
        sb_flag = bi.get_bits(8)
        ln = bi.delta16() if (sb_flag & SB_FLAG_LEN16) else bi.get_bits(8)
        if sb_flag & SB_FLAG_MIN24:
            j = bi.gamma()
            nbit = bi.get_16_no()
            min_v = j * 65536 + nbit
        elif sb_flag & SB_FLAG_MIN16:
            min_v = bi.get_16_no()
        else:
            min_v = bi.get_bits(8)
        if sb_flag & SB_FLAG_MAX24:
            max_v = bi.get_24_no()
        elif sb_flag & SB_FLAG_MAX16:
            max_v = bi.get_16_no()
        else:
            max_v = bi.get_bits(8)
        max_v = SUB_TOTAL_BITS - max_v
        min0 = 0
        if sb_flag & SB_FLAG_DR_MIN:
            code = bi.gamma()
            if code == 1:
                min0 = bi.gamma()
            elif code == 2:
                min0 = bi.get_bits(8)
            elif code == 3:
                min0 = bi.get_16_no()
        if (sb_flag & SB_FLAG_SBGAMMA) == SB_FLAG_SBGAMMA:
            sb = bi.gamma() - 1
        elif sb_flag & SB_FLAG_SB32:
            sb = bi.get_32_no()
        elif sb_flag & SB_FLAG_SB16:
            sb = bi.get_16_no()
        else:
            sb = bi.get_bits(8)
        arr = np.zeros(ln, np.int64)
        arr[0] = min_v
        arr[ln - 1] = max_v
        if ln > 2:
            arr[1:ln - 1] = bi.bic_decode_cm(ln - 2, min_v + 1, max_v - 1)
        if min0:
            _arr_restore_min(arr, min0)
        return sb, arr


def _xor_digest(blk, ref, d64):
    """bm::bit_block_xor w/ digest (src/bmxor.h:569): XOR ref into blk for
    every wave whose digest bit is set."""
    if d64 == 0xFFFFFFFFFFFFFFFF:
        blk ^= ref
        return
    wave = 0
    while d64:
        if d64 & 1:
            off = wave * WAVE_WORDS
            blk[off:off + WAVE_WORDS] ^= ref[off:off + WAVE_WORDS]
        d64 >>= 1
        wave += 1


def _tail_mask(tail_bits):
    bits = np.zeros(BITS, np.uint8)
    bits[:tail_bits] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _edge_mask_ge(bit):
    """Mask keeping in-block bits >= bit."""
    bits = np.zeros(BITS, np.uint8)
    bits[bit:] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _edge_mask_le(bit):
    """Mask keeping in-block bits <= bit."""
    bits = np.zeros(BITS, np.uint8)
    bits[:bit + 1] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


# ---------------------------------------------------------------------------
# Encoder (reference-readable subset, v1-generation codes)
# ---------------------------------------------------------------------------

class _BookmarkState:
    """Mirror of the reference bookmark_state (src/bmserial.h:441)."""

    __slots__ = ("range", "min_bytes", "bm_type", "ptr", "nb")

    def __init__(self, nb_range):
        self.range = nb_range
        self.min_bytes = max(nb_range * 8, 512)
        self.bm_type = 2 if nb_range < 15 else (1 if nb_range < 255 else 0)
        self.ptr = None       # byte offset of the skip placeholder
        self.nb = 0


class RefSerializer:
    """Standalone serializer producing reference-format BLOBs.

    Emits v1/v2-generation block codes readable by ANY reference version:
    zero/one runs, raw bit blocks, bit_1bit, bit_0runs, digest0,
    arrbit(_inv), plain GAP, gamma GAP/arrays, BIC arrays and GAP
    (arr_bienc/_inv/_8bh, gap_bienc/_v2), super-block BIC lists, XOR
    reference records, and bookmark/sync marks for range-skip
    deserialization (set_bookmarks, src/bmserial.h:246).  The per-block
    chooser mirrors find_bit_best_encoding(_l5) cost models
    (src/bmserial.h:2220,2373) and then competes the near-best candidates
    by ACTUAL payload size.  Compression levels follow the reference
    ladder (src/bmserial.h:115-127): 0 raw, 1-3 +arrays/GAP, 4 +gamma,
    5-6 +BIC.
    """

    def __init__(self, level: int = 6, ref_vectors=None):
        if not (0 <= level <= 6):
            raise ValueError("level must be 0..6")
        self.level = level
        self.compression_stat = {}
        self.sb_bookmarks = False
        self.bm_interval = 256
        # XOR similarity filter (bm::serializer::set_ref_vectors,
        # src/bmserial.h + src/bmxor.h): (row_id, BitVector) pairs; row ids
        # must match the ids the decode side registers in ITS collection.
        self.ref_vectors = list(ref_vectors or [])
        self._ref_maps = None
        self._ref_maps_injected = False   # set by callers pre-seeding maps

    def set_bookmarks(self, enable: bool, bm_interval: int = 256):
        """Enable periodic bookmark/sync marks so deserialize_range can
        skip ahead (reference set_bookmarks, src/bmserial.h:246,1423)."""
        self.sb_bookmarks = bool(enable)
        self.bm_interval = max(4, min(512, int(bm_interval)))
        return self

    def set_ref_vectors(self, ref_vectors):
        """(Re)attach the XOR similarity reference collection (reference
        set_ref_vectors, src/bmserial.h:270): (row_id, BitVector) pairs;
        drops any cached similarity model."""
        self.ref_vectors = list(ref_vectors or [])
        self._ref_maps = None
        self._ref_maps_injected = False
        return self

    def set_curr_ref_idx(self, idx: int):
        """Current vector's row in the reference collection (reference
        set_curr_ref_idx, src/bmserial.h:277).  The emitter here matches
        candidate refs by content automatically; the index is stored so a
        frame writer can exclude self-references."""
        self._curr_ref_idx = int(idx)
        return self

    def compute_sim_model(self, ref_vectors=None, params=None):
        """Precompute the block-map similarity model for a frame
        (reference compute_sim_model, src/bmserial.h:281 — one
        xor_sim_model shared across the frame's serializations).  Returns
        an opaque model for set_sim_model(); ``params`` accepted for
        signature parity."""
        refs = (list(ref_vectors) if ref_vectors is not None
                else self.ref_vectors)
        return {int(r): _bv_block_map(bv) for r, bv in refs}

    def set_sim_model(self, model):
        """Inject a model from compute_sim_model() so serialize() skips
        re-snapshotting the reference collection (reference set_sim_model,
        src/bmserial.h:289)."""
        self._ref_maps = dict(model) if model is not None else None
        self._ref_maps_injected = model is not None
        return self

    def get_compression_level(self) -> int:
        return self.level

    def set_compression_level(self, level: int):
        if not (0 <= int(level) <= 6):
            raise ValueError("level must be 0..6")
        self.level = int(level)
        return self

    def get_compression_stat(self) -> dict:
        return dict(self.compression_stat)

    def reset_compression_stats(self):
        self.compression_stat = {}
        return self

    def serialize(self, bv) -> bytes:
        bv._flush()
        if not self._ref_maps_injected:
            # re-snapshot the reference collection: a cached map would emit
            # XOR records against stale blocks if a ref vector was mutated
            # between serialize() calls
            self._ref_maps = None
        w = _ByteWriter()
        size = int(bv.size)
        struct = bv._struct
        is64 = size > ID_MAX32 or (
            len(struct.nb) and int(struct.nb[-1]) >= TOTAL_BLOCKS32)

        # NO_GAPL: we always serialize with the default GAP level table, so
        # the 8 glevel bytes are omitted (the reference's serializer does
        # the same when levels are default — src/bmserial.h:2575)
        header = HM_RESIZE | HM_NO_GAPL
        if is64:
            header |= HM_64_BIT
        if self.ref_vectors:
            header |= HM_HXOR
        w.put_8(header)
        w.put_8(1)                                # ByteOrder::LittleEndian
        (w.put_64 if is64 else w.put_32)(min(size, (1 << 48) if is64
                                             else ID_MAX32))

        self.compression_stat = {}
        # dense snapshot expands GAP-resident blocks transiently; the
        # emitted bytes do not depend on the in-memory representation
        nb_s, cls_s, pool = bv._dense_snapshot()
        struct = Structure(nb_s, cls_s)
        bc_all = (np.bitwise_count(pool).sum(axis=1, dtype=np.int64)
                  if pool.shape[0] else np.zeros(0, np.int64))
        slots = struct.slots()

        # super-block grouping: a 16M-bit sub-tree whose total popcount is
        # tiny serializes as ONE BIC offset list (set_sblock_bienc, the
        # reference's is_sparse_sblock path, src/bmserial.h:3655)
        sblocks = {}
        if self.level >= 5 and len(struct.nb):
            sb_ids = struct.nb >> 8
            for sb in np.unique(sb_ids):
                sel = np.flatnonzero(sb_ids == sb)
                if len(sel) < 2 or (struct.cls[sel] != C.CLS_BIT).any():
                    continue
                rows = slots[sel]
                total = int(bc_all[rows].sum())
                # len >= 3: the reference's u32 BIC decode loop is do-while
                # and would misparse a zero-length middle section
                if not (3 <= total < 65536) or total > 256 * len(sel):
                    continue
                offs = np.concatenate([
                    (int(struct.nb[i]) & 0xFF) * 65536
                    + _positions_from_words(pool[slots[i]])
                    for i in sel])
                sblocks[int(sb)] = offs

        bookm = _BookmarkState(self.bm_interval) if self.sb_bookmarks \
            else None
        cur = 0
        k = 0
        n = len(struct.nb)
        while k < n:
            nb = int(struct.nb[k])
            if bookm is not None:
                self._process_bookmark(nb, bookm, w)
            sb = nb >> 8
            if sb in sblocks:
                gap = nb - cur
                if gap:
                    self._put_zero_run(w, gap)
                self._put_sblock(w, sb, sblocks.pop(sb))
                cur = (sb + 1) << 8
                while k < n and (int(struct.nb[k]) >> 8) == sb:
                    k += 1
                continue
            gap = nb - cur
            if gap:
                self._put_zero_run(w, gap)
            if struct.cls[k] == C.CLS_FULL:
                run = 1
                while (k + run < n and struct.cls[k + run] == C.CLS_FULL
                       and int(struct.nb[k + run]) == nb + run):
                    run += 1
                self._put_one_run(w, run)
                cur = nb + run
                k += run
                continue
            s = slots[k]
            bc = int(bc_all[s])
            if bc == 0:
                cur = nb  # nothing emitted; zero run continues
                k += 1
                continue
            if bc == BITS:
                self._put_one_run(w, 1)
            else:
                est = self._block_estimate(pool[s], bc)
                if not self._try_xor(w, nb, pool[s], bc, est):
                    self._encode_block(w, pool[s], bc, est)
            cur = nb + 1
            k += 1
        w.put_8(BLOCK_END)
        if any(s.startswith("sblock") for s in self.compression_stat):
            # the reference flags blobs that use super-block codes
            # (BM_HM_SPARSE, src/bmserial.h:3666) — its
            # operation_deserializer keys a strategy choice off it
            w.parts[0] |= HM_SPARSE
        return w.get_bytes()

    # ------------------------------------------------------------------

    def _process_bookmark(self, nb, bookm, w):
        """Emit/back-patch bookmark + sync marks (process_bookmark,
        src/bmserial.h:3504): the placeholder offset is patched once the
        next mark point is reached, then a sync mark records the block
        delta so deserialize_range can jump."""
        nb_delta = nb - bookm.nb
        width = {0: 4, 1: 3, 2: 2}[bookm.bm_type]
        if bookm.ptr is not None and nb_delta >= bookm.range:
            bytes_delta = len(w.parts) - bookm.ptr
            if bytes_delta > bookm.min_bytes:
                d = bytes_delta - width
                if d < (1 << (8 * width)) - 1:
                    w.parts[bookm.ptr:bookm.ptr + width] = \
                        int(d).to_bytes(width, "little")
                if nb_delta < 0xFF:
                    w.put_8(NB_SYNC_MARK8); w.put_8(nb_delta)
                elif nb_delta < 0xFFFF:
                    w.put_8(NB_SYNC_MARK16); w.put_16(nb_delta)
                elif nb_delta < 0xFFFFFF:
                    w.put_8(NB_SYNC_MARK24); w.put_24(nb_delta)
                elif nb_delta < 0xFFFFFFFF:
                    w.put_8(NB_SYNC_MARK32); w.put_32(nb_delta)
                elif nb_delta < (1 << 48) - 1:
                    w.put_8(NB_SYNC_MARK48); w.put_48(nb_delta)
                else:
                    w.put_8(NB_SYNC_MARK64); w.put_64(nb_delta)
                bookm.ptr = None
        if bookm.ptr is None:
            bookm.nb = nb
            w.put_8({0: NB_BOOKMARK32, 1: NB_BOOKMARK24,
                     2: NB_BOOKMARK16}[bookm.bm_type])
            bookm.ptr = len(w.parts)
            w.parts += b"\x00" * width

    def _stat(self, name):
        self.compression_stat[name] = self.compression_stat.get(name, 0) + 1

    def _put_zero_run(self, w, n):
        while n:
            if 1 < n < 128:
                w.put_8(0x80 | n)
                return
            if n == 1:
                w.put_8(BLOCK_1ZERO)
                return
            if n < 256:
                w.put_8(BLOCK_8ZERO); w.put_8(n); return
            if n < 65536:
                w.put_8(BLOCK_16ZERO); w.put_16(n); return
            if n < ID_MAX32:
                w.put_8(BLOCK_32ZERO); w.put_32(n); return
            w.put_8(BLOCK_64ZERO); w.put_64(n); return

    def _put_sblock(self, w, sb, offs):
        """Super-block offset list: v1 (code 56) vs v3 (code 68, fully
        bit-packed header) built side by side, smaller record kept."""
        v1 = _ByteWriter()
        self._put_sblock_v1(v1, sb, offs)
        v3 = _ByteWriter()
        self._put_sblock_v3(v3, sb, offs)
        b1, b3 = v1.get_bytes(), v3.get_bytes()
        if len(b3) < len(b1):
            w.parts += b3
            self._stat("sblock_bienc_v3")
        else:
            w.parts += b1
            self._stat("sblock_bienc")

    @staticmethod
    def _put_sblock_v1(w, sb, offs):
        """set_sblock_bienc (v1, code 56): whole 16M-bit super-block as one
        BIC offset list (flags: 32-bit sb id, 16-bit len, 24-bit min/max,
        no DR-min)."""
        w.put_8(SBLOCK_BIENC)
        w.put_8(SB_FLAG_SB32 | SB_FLAG_LEN16 | SB_FLAG_MIN24 |
                SB_FLAG_MAX24)
        w.put_32(int(sb))
        w.put_16(len(offs))
        min_v = int(offs[0])
        max_v = int(offs[-1])
        w.put_24(min_v)
        w.put_24(SUB_TOTAL_BITS - max_v)
        bo = _BitOut(w)
        bo.bic_encode_cm(np.asarray(offs[1:-1], np.int64), min_v, max_v)
        bo.flush()

    @staticmethod
    def _put_sblock_v3(w, sb, offs):
        """set_sblock_bienc v3 (code 68): flags + length + min/max + sb id
        all bit-packed, BIC over the narrowed interior (min+1, max-1) —
        layout pinned by our reader `_read_sblock` v3 arm
        (src/bmserial.h:4423)."""
        n = len(offs)
        mn, mx = int(offs[0]), int(offs[-1])
        maxd = SUB_TOTAL_BITS - mx
        sb = int(sb)
        flags = 0
        if n >= 256:
            flags |= SB_FLAG_LEN16
        if mn >= 65536:
            flags |= SB_FLAG_MIN24
        elif mn >= 256:
            flags |= SB_FLAG_MIN16
        if maxd >= 65536:
            flags |= SB_FLAG_MAX24
        elif maxd >= 256:
            flags |= SB_FLAG_MAX16
        sb_cost = 8 if sb < 256 else (16 if sb < 65536 else 32)
        if _gamma_bits(sb + 1) < sb_cost:
            flags |= SB_FLAG_SBGAMMA
        elif sb >= 65536:
            flags |= SB_FLAG_SB32
        elif sb >= 256:
            flags |= SB_FLAG_SB16
        w.put_8(SBLOCK_BIENC_V3)
        bo = _BitOut(w)
        bo.put_bits(flags, 8)
        if flags & SB_FLAG_LEN16:
            bo.delta16(n)
        else:
            bo.put_bits(n, 8)
        if flags & SB_FLAG_MIN24:
            bo.gamma(mn >> 16)
            bo.put_16_no(mn & 0xFFFF)
        elif flags & SB_FLAG_MIN16:
            bo.put_16_no(mn)
        else:
            bo.put_bits(mn, 8)
        if flags & SB_FLAG_MAX24:
            bo.put_bits(maxd & 0xFF, 8)
            bo.put_bits((maxd >> 8) & 0xFF, 8)
            bo.put_bits((maxd >> 16) & 0xFF, 8)
        elif flags & SB_FLAG_MAX16:
            bo.put_16_no(maxd)
        else:
            bo.put_bits(maxd, 8)
        if (flags & SB_FLAG_SBGAMMA) == SB_FLAG_SBGAMMA:
            bo.gamma(sb + 1)
        elif flags & SB_FLAG_SB32:
            bo.put_16_no(sb & 0xFFFF)
            bo.put_16_no(sb >> 16)
        elif flags & SB_FLAG_SB16:
            bo.put_16_no(sb)
        else:
            bo.put_bits(sb, 8)
        bo.bic_encode_cm(np.asarray(offs[1:-1], np.int64), mn + 1, mx - 1)
        bo.flush()

    def _put_one_run(self, w, n):
        if n == 1:
            w.put_8(BLOCK_1ONE)
        elif n < 256:
            w.put_8(BLOCK_8ONE); w.put_8(n)
        elif n < 65536:
            w.put_8(BLOCK_16ONE); w.put_16(n)
        elif n < ID_MAX32:
            w.put_8(BLOCK_32ONE); w.put_32(n)
        else:
            w.put_8(BLOCK_64ONE); w.put_64(n)

    def _encode_block(self, w, words, bc, est=None):
        if est is None:
            est = self._block_estimate(words, bc)
        _, tag, start, boundaries, cands = est
        best_tag, best_payload = tag, None
        for t in cands:
            payload = self._block_payload(t, words, bc, start, boundaries)
            if best_payload is None or len(payload) < len(best_payload):
                best_tag, best_payload = t, payload
        w.parts += best_payload
        self._stat(best_tag)

    # -- XOR similarity filter ---------------------------------------------
    def _ref_block(self, row_id, nb):
        if self._ref_maps is None:
            self._ref_maps = {int(r): _bv_block_map(bv)
                              for r, bv in self.ref_vectors}
        return self._ref_maps[int(row_id)].get(int(nb))

    def _try_xor(self, w, nb, words, bc, est=None):
        """Emit a ref_eq / xor_ref record when a reference-collection block
        makes the target cheaper (bm::xor_scanner::search_best_xor_mask,
        src/bmxor.h:819: per-wave gain selection -> digest mask).  Returns
        True when an XOR record replaced the plain encoding."""
        if not self.ref_vectors or self.level < 5:
            return False
        if est is None:
            est = self._block_estimate(words, bc)
        plain_cost = est[0]
        pt = None                        # target wave popcounts, computed once
        best = None                      # (cost, row_id, d64 or None=eq, res)
        for row_id, _bv in self.ref_vectors:
            ref = self._ref_block(row_id, nb)
            if ref is None:
                continue
            refw = np.full(WORDS, 0xFFFFFFFF, np.uint32) \
                if ref is _FULL else ref
            if np.array_equal(refw, words):
                if best is None or 5 < best[0]:
                    best = (5, int(row_id), None, None)
                continue
            xw = words ^ refw
            if pt is None:
                pt = _wave_popcounts(words)
            px = _wave_popcounts(xw)
            gain = px < pt
            if not gain.any():
                continue
            t2 = words.reshape(-1, WAVE_WORDS)
            x2 = xw.reshape(-1, WAVE_WORDS)
            res = np.where(gain[:, None], x2, t2).reshape(-1)
            bc_res = int(px[gain].sum() + pt[~gain].sum())
            if bc_res == 0:
                # keep the stream's residual record non-empty: leave the
                # heaviest matched wave unmasked so it carries target bits
                iw = int(np.argmax(np.where(gain, pt, -1)))
                gain = gain.copy()
                gain[iw] = False
                res = np.where(gain[:, None], x2, t2).reshape(-1)
                bc_res = int(pt[iw])
            d64 = 0
            for i in np.flatnonzero(gain):
                d64 |= 1 << int(i)
            row_bytes = 1 if row_id < 256 else (2 if row_id < 65536 else 4)
            um = d64 == 0xFFFFFFFFFFFFFFFF
            hdr = 1 + row_bytes + (0 if um else 8)
            cost = hdr + self._block_estimate(res, bc_res)[0]
            if best is None or cost < best[0]:
                best = (cost, int(row_id), d64, (res, bc_res))
        if best is None or best[0] >= plain_cost:
            return False
        cost, row_id, d64, res = best
        if d64 is None:                              # set_block_ref_eq
            w.put_8(BLOCK_REF_EQ)
            w.put_32(row_id)
            self._stat("ref_eq")
            return True
        um = d64 == 0xFFFFFFFFFFFFFFFF
        if row_id < 256:
            w.put_8(BLOCK_XOR_REF8_UM if um else BLOCK_XOR_REF8)
            w.put_8(row_id)
        elif row_id < 65536:
            w.put_8(BLOCK_XOR_REF16_UM if um else BLOCK_XOR_REF16)
            w.put_16(row_id)
        else:
            w.put_8(BLOCK_XOR_REF32_UM if um else BLOCK_XOR_REF32)
            w.put_32(row_id)
        if not um:
            w.put_64(d64)
        self._stat("xor_ref")
        res_words, bc_res = res
        self._encode_block(w, res_words, bc_res)
        return True

    def _block_estimate(self, words, bc):
        """(estimated bytes, tag) of the best block record — the analog of
        the reference's find_bit_best_encoding cost model
        (src/bmserial.h:2373; BIC cost uses the same bie_bits_per_int
        ~3.75 heuristic as src/bmserial.h:139-152)."""
        level = self.level
        if bc == 1:
            return 3, "bit_1bit", 0, None, ("bit_1bit",)
        ibc = BITS - bc
        start, boundaries = _gap_boundaries_from_words(words)
        L = len(boundaries)
        # BIC cost knob: 3.75 bits/int below L6; the reference's L6 default
        # is bie_bits_per_int = 2.2 (src/bmserial.h:546, :2225) which admits
        # much denser arrays into the interpolative codes
        bie = 3.75 if level < 6 else 2.2
        # admission limit: the emitter competes candidates by ACTUAL payload
        # size, so admitting denser arrays than the reference's own L5
        # heuristic can only shrink blobs (reference admits them at L6 via
        # bie_bits_per_int = 2.2, src/bmserial.h:546)
        bie_limit = int(BITS / 2.2)
        est = [(1 + 4 * WORDS, "bit")]
        if level >= 1:
            if bc < 65536:
                est.append((3 + 2 * bc, "arrbit"))
            if ibc < 65536:
                est.append((3 + 2 * ibc, "arrbit_inv"))
            if L < 8192:
                est.append((3 + 2 * (L - 1), "gap"))
        if level >= 3:
            # exact costs for the clustered-dense codes (the reference's
            # find_bit_best_encoding also weighs these via block stats,
            # src/bmserial.h:2373)
            nzw = words != 0
            nz_words = int(np.count_nonzero(nzw))
            n_runs = 1 + int(np.count_nonzero(np.diff(nzw)))
            est.append((2 + 2 * n_runs + 4 * nz_words, "bit_0runs"))
            waves_nz = int(np.count_nonzero(
                words.reshape(-1, WAVE_WORDS).any(axis=1)))
            est.append((9 + 4 * WAVE_WORDS * waves_nz, "digest0"))
        if level >= 4 and L < 8192:
            vals = np.asarray(boundaries[:-1], np.int64)
            deltas = np.diff(vals, prepend=-1)
            gamma_bits = int(np.sum(
                2 * np.floor(np.log2(np.maximum(deltas, 1))) + 1))
            est.append((3 + (gamma_bits + 31) // 32 * 4, "gap_egamma"))
        if level >= 5:
            if 2 < bc <= bie_limit:
                est.append((7 + int(bc * bie) // 8, "arr_bienc"))
                # v3s: same interior BIC, bit-packed header (codes 65/66)
                est.append((4 + int(bc * bie) // 8, "arr_bienc_v3s"))
            if 2 < ibc <= bie_limit:
                est.append((7 + int(ibc * bie) // 8, "arr_bienc_inv"))
                est.append((4 + int(ibc * bie) // 8, "arr_bienc_inv_v3s"))
            if 2 <= L < 8192:
                est.append((6 + int(L * bie) // 8, "gap_bienc"))
            if 3 <= L < 8192:
                # v2 stores min AND max (8- or 16-bit each) and BIC-codes one
                # fewer boundary over a narrower range (src/bmserial.h:1762)
                min_v = int(boundaries[0])
                tail = BITS - 1 - int(boundaries[L - 2])
                hdr = 3 + (1 if min_v < 256 else 2) + (1 if tail < 256 else 2)
                est.append((hdr + int((L - 3) * bie) // 8, "gap_bienc_v2"))
                # v3s: v2 with head/min/max bit-packed (code 62)
                est.append((2 + int((L - 3) * bie) // 8, "gap_bienc_v3s"))
        est.sort()
        # keep the near-best candidates: BIC costs are estimates (bits/int
        # heuristics, src/bmserial.h:2225); the emitter builds the top few
        # payloads and keeps the actually-smallest record
        best = est[0][0]
        cands = tuple(t for sz, t in est[:6] if sz <= best * 1.35 + 16)
        return est[0] + (start, boundaries, cands)

    def _block_payload(self, tag, words, bc, start=None, boundaries=None):
        if tag == "bit_1bit":
            pos = int(_positions_from_words(words)[0])
            w = _ByteWriter()
            w.put_8(BLOCK_BIT_1BIT)
            w.put_16(pos)
            return w.get_bytes()
        if boundaries is None and tag.startswith("gap"):
            start, boundaries = _gap_boundaries_from_words(words)
        if tag == "bit":
            return self._enc_raw(words)
        if tag == "arrbit":
            return self._enc_arrbit(_positions_from_words(words), False)
        if tag == "arrbit_inv":
            return self._enc_arrbit(
                _positions_from_words(words, invert=True), True)
        if tag == "gap":
            return self._enc_gap(start, boundaries)
        if tag == "gap_egamma":
            return self._enc_gap_egamma(start, boundaries)
        if tag == "gap_bienc":
            return self._enc_gap_bienc(start, boundaries)
        if tag == "gap_bienc_v2":
            return self._enc_gap_bienc_v2(start, boundaries)
        if tag == "gap_bienc_v3s":
            return self._enc_gap_bienc_v3s(start, boundaries)
        if tag == "bit_0runs":
            return self._enc_bit_0runs(words)
        if tag == "digest0":
            return self._enc_digest0(words)
        if tag == "arr_bienc":
            return self._enc_arr_bienc(_positions_from_words(words), False)
        if tag == "arr_bienc_v3s":
            return self._enc_arr_bienc_v3s(_positions_from_words(words),
                                           False)
        if tag == "arr_bienc_inv_v3s":
            return self._enc_arr_bienc_v3s(
                _positions_from_words(words, invert=True), True)
        return self._enc_arr_bienc(
            _positions_from_words(words, invert=True), True)

    @staticmethod
    def _enc_raw(words):
        w = _ByteWriter()
        w.put_8(BLOCK_BIT)
        w.put_u32_words(words)
        return w.get_bytes()

    @staticmethod
    def _enc_bit_0runs(words):
        """set_block_bit_0runs: alternating zero/nonzero word runs; nonzero
        runs carry raw words (read side: read_0runs_block,
        src/bmserial.h:4674)."""
        nzw = np.asarray(words) != 0
        change = np.flatnonzero(np.diff(nzw.astype(np.int8))) + 1
        bounds = np.concatenate([[0], change, [len(nzw)]])
        w = _ByteWriter()
        w.put_8(BLOCK_BIT_0RUNS)
        w.put_8(int(nzw[0]))
        for s, e in zip(bounds[:-1], bounds[1:]):
            w.put_16(int(e - s))
            if nzw[s]:
                w.put_u32_words(words[s:e])
        return w.get_bytes()

    @staticmethod
    def _enc_digest0(words):
        """set_block_bit_digest0: u64 wave mask + raw words of the nonzero
        waves only (read side: read_digest0_block, src/bmserial.h:4634)."""
        tiles = words.reshape(-1, WAVE_WORDS)
        nz_waves = np.flatnonzero(tiles.any(axis=1))
        d0 = 0
        for i in nz_waves:
            d0 |= 1 << int(i)
        w = _ByteWriter()
        w.put_8(BLOCK_BIT_DIGEST0)
        w.put_64(d0)
        for i in nz_waves:
            w.put_u32_words(tiles[i])
        return w.get_bytes()

    @staticmethod
    def _enc_arrbit(pos, inverted):
        w = _ByteWriter()
        w.put_8(BLOCK_ARRBIT_INV if inverted else BLOCK_ARRBIT)
        w.put_16(len(pos))
        w.put_u16_array(pos)
        return w.get_bytes()

    @staticmethod
    def _enc_gap(start, boundaries):
        """set_block_gap: head u16 + boundaries[0..L-2] u16 (last implied)."""
        L = len(boundaries)
        w = _ByteWriter()
        w.put_8(BLOCK_GAP)
        head = (L << 3) | (3 << 1) | start       # level bits informational
        w.put_16(head)
        w.put_u16_array(boundaries[:-1])
        return w.get_bytes()

    @staticmethod
    def _enc_gap_egamma(start, boundaries):
        """set_block_gap_egamma: head u16, then gammas of first+1, deltas."""
        L = len(boundaries)                      # includes final 65535
        w = _ByteWriter()
        w.put_8(BLOCK_GAP_EGAMMA)
        head = (L << 3) | (3 << 1) | start
        w.put_16(head)
        bo = _BitOut(w)
        vals = np.asarray(boundaries[:-1], np.int64)  # final 65535 implied
        bo.gamma_many(np.diff(vals, prepend=-1))      # first stored as v+1
        bo.flush()
        return w.get_bytes()

    @staticmethod
    def _enc_gap_bienc(start, boundaries):
        """set_block_gap_bienc (v1): head u16, min boundary u16, BIC-cm of
        the middle boundaries in (min, 65535); final 65535 implied."""
        L = len(boundaries)                      # incl. final 65535
        w = _ByteWriter()
        w.put_8(BLOCK_GAP_BIENC)
        w.put_16((L << 3) | (3 << 1) | start)
        b0 = int(boundaries[0])
        w.put_16(b0)
        bo = _BitOut(w)
        bo.bic_encode_cm(np.asarray(boundaries[1:-1], np.int64), b0, 65535)
        bo.flush()
        return w.get_bytes()

    @staticmethod
    def _enc_gap_bienc_v2(start, boundaries):
        """set_block_gap_bienc_v2: head carries 8-bit min/max flags; min and
        (65535-max) stored 8- or 16-bit; BIC-cm of the middle boundaries in
        (min, max); max then final 65535 implied (src/bmserial.h:1762)."""
        L = len(boundaries)                      # incl. final 65535
        min_v = int(boundaries[0])
        max_v = int(boundaries[L - 2])
        tail = BITS - 1 - max_v
        head = (L << 3) | start
        if min_v < 256:
            head |= H2F_MIN_V_8BIT
        if tail < 256:
            head |= H2F_MAX_V_8BIT
        w = _ByteWriter()
        w.put_8(BLOCK_GAP_BIENC_V2)
        w.put_16(head)
        (w.put_8 if min_v < 256 else w.put_16)(min_v)
        (w.put_8 if tail < 256 else w.put_16)(tail)
        bo = _BitOut(w)
        bo.bic_encode_cm(np.asarray(boundaries[1:L - 2], np.int64),
                         min_v, max_v)
        bo.flush()
        return w.get_bytes()

    @staticmethod
    def _enc_arrgap_egamma(pos, inverted):
        w = _ByteWriter()
        w.put_8(BLOCK_ARRGAP_EGAMMA_INV if inverted
                else BLOCK_ARRGAP_EGAMMA)
        bo = _BitOut(w)
        bo.gamma(len(pos))
        bo.gamma_many(np.diff(np.asarray(pos, np.int64), prepend=-1))
        bo.flush()
        return w.get_bytes()

    @staticmethod
    def _enc_arr_bienc(pos, inverted):
        """set_block_arr_bienc / _inv / _8bh (v1 layout,
        src/bmserial.h:3419-3452)."""
        min_v = int(pos[0])
        max_v = int(pos[-1])
        max_delta = 65536 - max_v
        w = _ByteWriter()
        if not inverted and min_v <= 0xFF and max_delta <= 0xFF:
            w.put_8(BLOCK_ARR_BIENC_8BH)
            w.put_8(min_v)
            w.put_8(max_delta)
        else:
            w.put_8(BLOCK_ARR_BIENC_INV if inverted else BLOCK_ARR_BIENC)
            w.put_16(min_v)
            w.put_16(max_v)
        w.put_16(len(pos))
        bo = _BitOut(w)
        bo.bic_encode_cm([int(v) for v in pos[1:-1]], min_v, max_v)
        bo.flush()
        return w.get_bytes()

    @staticmethod
    def _enc_arr_bienc_v3s(pos, inverted):
        """set_block_arr_bienc_v3s: fully bit-packed header (delta16s
        length + min + 65536-max) and BIC over the narrowed interior
        (min+1, max-1) — layout pinned by our reader `_read_bic_arr` v3s
        arm (reference src/bmserial.h:1253, codes 65/66)."""
        n = len(pos)
        w = _ByteWriter()
        w.put_8(BLOCK_ARR_BIENC_INV_V3S if inverted
                else BLOCK_ARR_BIENC_V3S)
        bo = _BitOut(w)
        bo.delta16s(n)
        if n >= 2:
            bo.put_bit(1)
            mn, mx = int(pos[0]), int(pos[-1])
            bo.delta16s(mn)
            bo.delta16s((65536 - mx) & 0xFFFF)
            bo.bic_encode_cm(np.asarray(pos[1:-1], np.int64),
                             mn + 1, mx - 1)
        else:
            bo.put_bit(0)
            bo.bic_encode_cm(np.asarray(pos, np.int64), 0, 65535)
        bo.flush()
        return w.get_bytes()

    @staticmethod
    def _enc_gap_bienc_v3s(start, boundaries):
        """set_block_gap_bienc_v3s: the v2 layout with the head and min/max
        fields bit-packed (delta16s head, gamma8-or-raw16 min and tail) —
        layout pinned by our reader (BLOCK_GAP_BIENC_V3S, code 62)."""
        L = len(boundaries)
        min_v = int(boundaries[0])
        max_v = int(boundaries[L - 2])
        tail = (65535 - max_v) & 0xFFFF
        head = (L << 3) | start
        min8 = _gamma8_bits(min_v) < 16
        tail8 = _gamma8_bits(tail) < 16
        if min8:
            head |= H2F_MIN_V_8BIT
        if tail8:
            head |= H2F_MAX_V_8BIT
        w = _ByteWriter()
        w.put_8(BLOCK_GAP_BIENC_V3S)
        bo = _BitOut(w)
        bo.delta16s(head)
        if min8:
            bo.gamma8(min_v)
        else:
            bo.put_16_no(min_v)
        if tail8:
            bo.gamma8(tail)
        else:
            bo.put_16_no(tail)
        bo.bic_encode_cm(np.asarray(boundaries[1:L - 2], np.int64),
                         min_v, max_v)
        bo.flush()
        return w.get_bytes()


# ---------------------------------------------------------------------------
# one-shot helpers
# ---------------------------------------------------------------------------
def ref_serialize(bv, level: int = 6) -> bytes:
    """BitVector -> reference-format BLOB (standalone)."""
    return RefSerializer(level).serialize(bv)


def ref_deserialize(data: bytes, ref_vectors=None, device=None):
    """Reference-format BLOB -> BitVector (standalone, all block codes) on
    ``device``."""
    return RefDeserializer(ref_vectors, device).deserialize(data)
