"""Bit/byte stream codecs: Elias gamma and Binary Interpolative Coding
(own copy of ``bitmagic_tpu/serial/encoding.py``; numpy only).

Equivalent of `src/encoding.h` (encoder/decoder byte streams :49-162,
bit_out/bit_in bit streams :185-299 with gamma :207 and BIC
bic_encode_u16_cm/bic_encode_u32_cm + decoders :231-390) and the legacy gamma
decoder (`src/bmgamma.h`).

Pure-Python/numpy implementation with vectorized bulk paths (array gamma
encode is a <=64-pass scatter over precomputed bit offsets); the serializers
take the sequential BIC and gamma hot loops from the native library
(serial/native) — the reference also treats codecs as scalar code (no SIMD
BIC in bmsse4/avx2).

Bit order: MSB-first within the stream (matches the reference's bit_out shift
discipline).  Each block payload is byte-aligned by the serializer.
"""

from __future__ import annotations

import numpy as np


class ByteEncoder:
    """Byte-stream encoder (reference bm::encoder, src/encoding.h:49)."""

    def __init__(self):
        self.buf = bytearray()

    def put_8(self, v):
        self.buf.append(int(v) & 0xFF)

    def put_16(self, v):
        self.buf += int(v).to_bytes(2, "little")

    def put_32(self, v):
        self.buf += int(v).to_bytes(4, "little")

    def put_48(self, v):
        self.buf += int(v).to_bytes(6, "little")

    def put_64(self, v):
        self.buf += int(v).to_bytes(8, "little")

    def put_bytes(self, b):
        self.buf += bytes(b)

    def put_varint(self, v):
        """LEB128 (7 bits/byte, little-endian groups)."""
        v = int(v)
        while v >= 0x80:
            self.buf.append((v & 0x7F) | 0x80)
            v >>= 7
        self.buf.append(v)

    def put_array_u16(self, arr):
        self.buf += np.asarray(arr, "<u2").tobytes()

    def put_array_u32(self, arr):
        self.buf += np.asarray(arr, "<u4").tobytes()

    def size(self):
        return len(self.buf)

    def get_bytes(self):
        return bytes(self.buf)


class ByteDecoder:
    """Byte-stream decoder (reference bm::decoder, src/encoding.h:128).

    Accepts bytes-like input OR a uint8 ndarray (e.g. np.fromfile of a
    saved blob): arrays are viewed through a zero-copy memoryview so
    slices compare content-wise against bytes literals."""

    def __init__(self, data, pos: int = 0):
        if isinstance(data, np.ndarray):
            data = memoryview(np.ascontiguousarray(data, np.uint8))
        self.data = data
        self.pos = pos

    def get_8(self):
        v = self.data[self.pos]
        self.pos += 1
        return v

    def get_16(self):
        v = int.from_bytes(self.data[self.pos:self.pos + 2], "little")
        self.pos += 2
        return v

    def get_32(self):
        v = int.from_bytes(self.data[self.pos:self.pos + 4], "little")
        self.pos += 4
        return v

    def get_48(self):
        v = int.from_bytes(self.data[self.pos:self.pos + 6], "little")
        self.pos += 6
        return v

    def get_64(self):
        v = int.from_bytes(self.data[self.pos:self.pos + 8], "little")
        self.pos += 8
        return v

    def get_varint(self):
        v = sh = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << sh
            if not b & 0x80:
                return v
            sh += 7

    def get_bytes(self, n):
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def get_array_u16(self, n):
        a = np.frombuffer(self.data, "<u2", count=n, offset=self.pos)
        self.pos += 2 * n
        return a.copy()

    def get_array_u32(self, n):
        a = np.frombuffer(self.data, "<u4", count=n, offset=self.pos)
        self.pos += 4 * n
        return a.copy()


class BitWriter:
    """MSB-first bit stream (reference bm::bit_out, src/encoding.h:185).

    Keeps a small int accumulator; completed bytes are flushed to a bytearray
    incrementally so writes stay O(1) amortized."""

    _FLUSH_BITS = 1 << 12

    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._nbits = 0            # bits currently in _acc
        self._total = 0            # total bits ever written

    def put_bits(self, value: int, n: int):
        if n == 0:
            return
        self._acc = (self._acc << n) | (int(value) & ((1 << n) - 1))
        self._nbits += n
        self._total += n
        if self._nbits >= self._FLUSH_BITS:
            self._flush_whole_bytes()

    def _flush_whole_bytes(self):
        rem = self._nbits % 8
        nbytes = self._nbits // 8
        if nbytes:
            top = self._acc >> rem
            self.buf += top.to_bytes(nbytes, "big")
            self._acc &= (1 << rem) - 1
            self._nbits = rem

    def put_bit(self, b: int):
        self.put_bits(b, 1)

    def put_gamma(self, v: int):
        """Elias gamma for v >= 1 (reference gamma, src/encoding.h:207)."""
        nb = int(v).bit_length()
        self.put_bits(int(v), 2 * nb - 1)   # nb-1 zeros then v (leads with 1)

    def put_gamma_array(self, arr):
        arr = np.asarray(arr, np.uint64)
        for v in arr.tolist():
            nb = int(v).bit_length()
            self.put_bits(v, 2 * nb - 1)

    def align8(self):
        pad = (-self._total) % 8
        if pad:
            self.put_bits(0, pad)

    def getvalue(self) -> bytes:
        pad = (-self._nbits) % 8
        acc = self._acc << pad
        n = (self._nbits + pad) // 8
        tail = acc.to_bytes(n, "big") if n else b""
        return bytes(self.buf) + tail

    def bit_length(self):
        return self._total


class BitReader:
    """MSB-first bit reader (reference bm::bit_in, src/encoding.h:299)."""

    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.bitpos = bitpos

    def get_bits(self, n: int) -> int:
        if n == 0:
            return 0
        b0 = self.bitpos >> 3
        b1 = (self.bitpos + n + 7) >> 3
        chunk = int.from_bytes(self.data[b0:b1], "big")
        shift = (b1 - b0) * 8 - (self.bitpos - b0 * 8) - n
        self.bitpos += n
        return (chunk >> shift) & ((1 << n) - 1)

    def get_bit(self) -> int:
        b = self.data[self.bitpos >> 3]
        v = (b >> (7 - (self.bitpos & 7))) & 1
        self.bitpos += 1
        return v

    def get_gamma(self) -> int:
        nz = 0
        while self.get_bit() == 0:
            nz += 1
        if nz == 0:
            return 1
        rest = self.get_bits(nz)
        return (1 << nz) | rest

    def get_gamma_array(self, n: int) -> np.ndarray:
        out = np.empty(n, np.uint64)
        for i in range(n):
            out[i] = self.get_gamma()
        return out

    def align8(self):
        self.bitpos += (-self.bitpos) % 8

    def byte_pos(self):
        return self.bitpos // 8


# ---------------------------------------------------------------------------
# Binary Interpolative Coding (centered minimal binary codes)
# Reference: bic_encode_u16_cm / bic_decode_u16_cm etc., src/encoding.h:231-390
# ---------------------------------------------------------------------------
def _cm_bits(r: int) -> int:
    """Code length classes for a range of r distinct values."""
    return (r - 1).bit_length() if r > 1 else 0


def _mb_encode(w: BitWriter, x: int, lo: int, hi: int):
    """Minimal binary code of x in [lo, hi] (short codes first)."""
    r = hi - lo + 1
    if r <= 1:
        return
    b = _cm_bits(r)
    extra = (1 << b) - r
    c = x - lo
    if c < extra:
        w.put_bits(c, b - 1)
    else:
        w.put_bits(c + extra, b)


def _mb_decode(rd: BitReader, lo: int, hi: int) -> int:
    r = hi - lo + 1
    if r <= 1:
        return lo
    b = _cm_bits(r)
    extra = (1 << b) - r
    if b > 1:
        v = rd.get_bits(b - 1)
    else:
        v = 0
    if v < extra:
        return lo + v
    v = (v << 1) | rd.get_bit()
    return lo + v - extra


def bic_encode(w: BitWriter, arr, lo: int, hi: int):
    """Binary interpolative coding of a strictly increasing array with
    values in [lo, hi] (reference bic_encode_u16_cm, src/encoding.h:244).
    Iterative midpoint recursion with an explicit stack."""
    arr = np.asarray(arr, np.int64)
    stack = [(0, arr.size, lo, hi)]
    while stack:
        i0, i1, l, h = stack.pop()
        n = i1 - i0
        if n == 0:
            continue
        mid = (i0 + i1) >> 1
        x = int(arr[mid])
        nleft = mid - i0
        nright = i1 - mid - 1
        # x is constrained to [l + nleft, h - nright]
        _mb_encode(w, x, l + nleft, h - nright)
        # push right first so left pops first (order only matters for
        # symmetry with the decoder)
        stack.append((mid + 1, i1, x + 1, h))
        stack.append((i0, mid, l, x - 1))


def bic_decode(rd: BitReader, n: int, lo: int, hi: int) -> np.ndarray:
    """Inverse of bic_encode."""
    out = np.empty(n, np.int64)
    stack = [(0, n, lo, hi)]
    while stack:
        i0, i1, l, h = stack.pop()
        cnt = i1 - i0
        if cnt == 0:
            continue
        mid = (i0 + i1) >> 1
        nleft = mid - i0
        nright = i1 - mid - 1
        x = _mb_decode(rd, l + nleft, h - nright)
        out[mid] = x
        stack.append((mid + 1, i1, x + 1, h))
        stack.append((i0, mid, l, x - 1))
    return out
