"""Loader of the port's native codec library (``codecs.cpp``).

The port keeps its own copy of the C++ source, byte for byte that of the
JAX package, and builds it with ``g++`` at first use into
``bitmagic_tpu_torch/_build/``.  The library's file name carries a hash of
the source, the flags and the host's machine and C library, so an edited
source never loads a stale build and a library built on another kind of
host is never loaded.  A failed build raises: nothing falls back to a
pure-Python codec.

Two kinds of failure stay apart.  ``load()`` raises when the library
cannot be built or loaded.  A C function that rejects its input (a
malformed BLOB, a nonzero return code) makes its wrapper return None, and
the serializers then walk the BLOB's records in Python, which raise the
decode error of the malformed record.

Exposed through ``ctypes`` (a plain C interface): the positions of every
set bit of a pool (``pool_positions``), of one block (``block_positions``),
the run boundaries of one block (``block_gap_boundaries``), the whole-BLOB
BMT1 decoders and encoder (``bmt1_decode``, ``bmt1_decode_gap``,
``bmt1_encode``), the D-GAP expansion (``gaps_to_dense``), the record index
and the streamed set-op engine (``bmt1_record_index``, ``bmt1_stream_op``),
and the BIC and gamma byte helpers.  The reference-format bit I/O
(``serial/refcodec.py``) calls the ``bmref_*`` functions through
``load()`` directly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from ... import constants as C

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "codecs.cpp")
BUILD_DIR = os.path.normpath(os.path.join(_DIR, os.pardir, os.pardir,
                                          "_build"))
# -mpopcnt: the decoders' inner loops are __builtin_popcountll
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17") + (
    ("-mpopcnt",) if platform.machine() in ("x86_64", "AMD64") else ())

_lock = threading.Lock()
_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "bm_pool_positions": (_I64, [_U32P, _I64, _I64P, _I64P]),
    "bm_block_positions": (_I64, [_U32P, _INT, _U16P]),
    "bm_block_gap_boundaries": (_I64, [_U32P, _U16P, _I32P]),
    "bm_bic_encode": (ctypes.c_uint64, [_I64P, _I64, _I64, _I64, _U8P]),
    "bm_bic_decode": (ctypes.c_uint64, [_U8P, ctypes.c_uint64, _I64, _I64,
                                        _I64, _I64P]),
    "bm_gamma_encode": (ctypes.c_uint64, [_U64P, _I64, _U8P]),
    "bm_gamma_decode": (_I64, [_U8P, ctypes.c_uint64, ctypes.c_uint64, _I64,
                               _U64P]),
    "bm_bmt1_scan": (_INT, [_U8P, _I64, _I64, _I64P, _I64P]),
    "bm_bmt1_decode": (_INT, [_U8P, _I64, _I64, _I64P, _U8P, _I64P, _U32P]),
    "bm_bmt1_scan_gap": (_INT, [_U8P, _I64, _I64, _I64P, _I64P, _I64P,
                                _I64P]),
    "bm_bmt1_decode_gap": (_INT, [_U8P, _I64, _I64, _I64P, _U8P, _I64P,
                                  _U32P, _I32P, _I64P, _U8P]),
    "bm_bmt1_encode": (_I64, [_U32P, _I64P, _U8P, _I64P, _I32P, _I64P, _U8P,
                              _I64, _INT, _I64, _INT, _U8P, _I64, _I64P]),
    "bmref_bic_decode_cm": (_INT, [_U8P, _I64, _I64P, _U64P, _I32P, _I64,
                                   _I64, _I64, _I64P]),
    "bmref_bic_encode_cm": (_INT, [_I64P, _I64, _I64, _I64, _U64P, _I32P,
                                   _U8P, _I64, _I64P]),
    "bmref_gamma_decode": (_INT, [_U8P, _I64, _I64P, _U64P, _I32P, _I64,
                                  _U32P]),
    "bmref_gamma_encode": (_INT, [_U32P, _I64, _U64P, _I32P, _U8P, _I64,
                                  _I64P]),
    "bm_gaps_to_dense": (_INT, [_I64P, _I64P, _U8P, _I64, _U32P]),
    "bm_bmt1_record_index": (_I64, [_U8P, _I64, _I64, _I64P, _I64P]),
    "bm_bmt1_stream_op": (_INT, [_U8P, _I64, _I64, _I64, _I64, _INT, _INT,
                                 _I64P, _U8P, _I64P, _U32P, _I32P, _I64P,
                                 _U8P, _I64, _I64P, _U8P, _U32P, _I64P,
                                 _I64P, _I64P]),
}


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(" ".join((platform.machine(), *platform.libc_ver())).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbmcodecs_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"bitmagic_tpu_torch: build of {SOURCE} failed "
                           f"(g++ exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The codec library, built first if needed; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _p(a: np.ndarray, ptr):
    return a.ctypes.data_as(ptr)


def _words(words: np.ndarray, rows: int | None = None) -> np.ndarray:
    """A contiguous uint32 view of ``words`` (int32 rows are viewed, not
    converted), checked to hold whole 2048-word blocks."""
    w = np.ascontiguousarray(words)
    if w.dtype == np.int32:
        w = w.view(np.uint32)
    if w.dtype != np.uint32:
        raise TypeError(f"expected uint32 or int32 words, got {w.dtype}")
    if w.size % C.SET_BLOCK_SIZE or (rows is not None
                                     and w.size != rows * C.SET_BLOCK_SIZE):
        raise ValueError(f"expected whole {C.SET_BLOCK_SIZE}-word blocks, "
                         f"got shape {w.shape}")
    return w


def pool_positions(words: np.ndarray, bases: np.ndarray) -> np.ndarray:
    """Global positions (int64, ascending within each row) of every set bit
    of the rows ``words[n, 2048]``: row r's bit p is ``bases[r] + p``."""
    w = _words(words)
    n = w.size // C.SET_BLOCK_SIZE
    bases = np.ascontiguousarray(bases, np.int64)
    if bases.size != n:
        raise ValueError(f"{bases.size} bases for {n} rows")
    out = np.empty(max(int(np.bitwise_count(w).sum(dtype=np.int64)), 1),
                   np.int64)
    got = load().bm_pool_positions(_p(w, _U32P), n, _p(bases, _I64P),
                                   _p(out, _I64P))
    return out[:got]


def block_positions(words: np.ndarray, inverted: bool = False) -> np.ndarray:
    """Positions (int64) of the set bits of one 2048-word block, or of its
    clear bits when ``inverted``."""
    w = _words(words, 1)
    out = np.empty(C.BITS_PER_BLOCK, np.uint16)
    n = load().bm_block_positions(_p(w, _U32P), int(inverted),
                                  _p(out, _U16P))
    return out[:n].astype(np.int64)


def block_gap_boundaries(words: np.ndarray):
    """(value of bit 0, int64 run ends ascending, the last one 65535) of one
    2048-word block: its D-GAP form."""
    w = _words(words, 1)
    out = np.empty(C.BITS_PER_BLOCK + 1, np.uint16)
    start = ctypes.c_int32(0)
    n = load().bm_block_gap_boundaries(_p(w, _U32P), _p(out, _U16P),
                                       ctypes.byref(start))
    return int(start.value), out[:n].astype(np.int64)


# ---------------------------------------------------------------------------
# BMT1 BLOBs
# ---------------------------------------------------------------------------
class RunCodedBlob(Exception):
    """The BLOB holds FULL_RUN span records: the per-record stream engines
    leave it to decode-then-apply (runs decode to interval metadata, so
    that path stays cheap)."""


class PaddedBlob(np.ndarray):
    """uint8 view marking a BLOB whose 8 trailing zero bytes were added by
    ``padded_blob`` itself.  Only this marker skips re-padding: a plain
    uint8 array from the caller is not trusted to be padded."""


def padded_blob(blob) -> np.ndarray:
    """The BLOB with 8 zero bytes appended (the C bit reader's fast path
    reads one 64-bit word past its cursor).  Returns a PaddedBlob; passing
    one back in is a no-op, so callers that run the engine once per
    record window pad once."""
    if isinstance(blob, PaddedBlob):
        return blob
    if isinstance(blob, np.ndarray):
        raw = np.ascontiguousarray(blob).view(np.uint8).tobytes()
    else:
        raw = bytes(blob)
    return np.frombuffer(raw + b"\0" * 8, np.uint8).view(PaddedBlob)


def _scan(lib, buf, rec_offset):
    """(record count, dense row count) of a padded BLOB, or None when the
    record headers are malformed."""
    n_rec = ctypes.c_int64(0)
    n_rows = ctypes.c_int64(0)
    if lib.bm_bmt1_scan(_p(buf, _U8P), buf.size - 8, rec_offset,
                        ctypes.byref(n_rec), ctypes.byref(n_rows)) != 0:
        return None
    return int(n_rec.value), int(n_rows.value)


def bmt1_decode(blob, rec_offset: int):
    """Whole-BLOB BMT1 decode: (nbs int64, cls uint8, spans int64, words
    uint32[n_rows, 2048]), or None when the BLOB is malformed.  spans[k]
    > 1 marks a FULL_RUN record covering that many blocks from nbs[k]."""
    lib = load()
    buf = padded_blob(blob)
    sc = _scan(lib, buf, rec_offset)
    if sc is None:
        return None
    n_rec, n_rows = sc
    nbs = np.empty(max(n_rec, 1), np.int64)
    cls = np.empty(max(n_rec, 1), np.uint8)
    spans = np.empty(max(n_rec, 1), np.int64)
    words = np.empty((max(n_rows, 1), C.SET_BLOCK_SIZE), np.uint32)
    if lib.bm_bmt1_decode(_p(buf, _U8P), buf.size - 8, rec_offset,
                          _p(nbs, _I64P), _p(cls, _U8P), _p(spans, _I64P),
                          _p(words, _U32P)) != 0:
        return None
    return nbs[:n_rec], cls[:n_rec], spans[:n_rec], words[:n_rows]


def bmt1_decode_gap(blob, rec_offset: int):
    """Whole-BLOB BMT1 decode in which D-GAP records keep their run form:
    (nbs, cls, spans, words, (g_ends int32, g_offs int64, g_first uint8)),
    or None when the BLOB is malformed.  cls is 1 FULL, 2 BIT, 3 GAP;
    ``words`` rows follow the cls 2 records in order, the run arrays the
    cls 3 records."""
    lib = load()
    buf = padded_blob(blob)
    bp = _p(buf, _U8P)
    n_rec = ctypes.c_int64(0)
    n_rows = ctypes.c_int64(0)
    n_gr = ctypes.c_int64(0)
    n_ge = ctypes.c_int64(0)
    if lib.bm_bmt1_scan_gap(bp, buf.size - 8, rec_offset,
                            ctypes.byref(n_rec), ctypes.byref(n_rows),
                            ctypes.byref(n_gr), ctypes.byref(n_ge)) != 0:
        return None
    nr, nw, ngr, nge = (int(n_rec.value), int(n_rows.value),
                        int(n_gr.value), int(n_ge.value))
    nbs = np.empty(max(nr, 1), np.int64)
    cls = np.empty(max(nr, 1), np.uint8)
    spans = np.empty(max(nr, 1), np.int64)
    words = np.empty((max(nw, 1), C.SET_BLOCK_SIZE), np.uint32)
    g_ends = np.empty(max(nge, 1), np.int32)
    g_offs = np.empty(ngr + 1, np.int64)
    g_first = np.empty(max(ngr, 1), np.uint8)
    if lib.bm_bmt1_decode_gap(bp, buf.size - 8, rec_offset, _p(nbs, _I64P),
                              _p(cls, _U8P), _p(spans, _I64P),
                              _p(words, _U32P), _p(g_ends, _I32P),
                              _p(g_offs, _I64P), _p(g_first, _U8P)) != 0:
        return None
    return (nbs[:nr], cls[:nr], spans[:nr], words[:nw],
            (g_ends[:nge], g_offs[:ngr + 1], g_first[:ngr]))


# the largest payload one BMT1 record can take: an ARR_BIC(_INV) list of
# 29789 positions at 16 bits each plus its count and a flushed word
_MAX_RECORD_PAYLOAD = 2 * 29789 + 16
# the room bm_bmt1_encode checks for before each record
_RECORD_MARGIN = 16 + 8192 + 64


def bmt1_encode(words: np.ndarray, nbs: np.ndarray, cls: np.ndarray,
                level: int, spans: np.ndarray = None,
                prev_nb: int = -1, emit_end: bool = True,
                gap_ends=None, gap_offs=None, gap_first=None):
    """Whole-BLOB BMT1 record encoding: (record bytes, code counts
    int64[11]), or None when the encoder rejects its input.  spans[k] > 1
    on a FULL entry emits one FULL_RUN record covering that many blocks;
    cls 3 entries encode straight from the D-GAP store layout
    (gap_ends / gap_offs / gap_first) with no dense expansion."""
    lib = load()
    words = _words(words)
    nbs = np.ascontiguousarray(nbs, np.int64)
    cls = np.ascontiguousarray(cls, np.uint8)
    spans = (np.ones(nbs.size, np.int64) if spans is None
             else np.ascontiguousarray(spans, np.int64))
    if gap_ends is None:
        gap_ends = np.zeros(0, np.int32)
        gap_offs = np.zeros(1, np.int64)
        gap_first = np.zeros(0, np.uint8)
    gap_ends = np.ascontiguousarray(gap_ends, np.int32)
    gap_offs = np.ascontiguousarray(gap_offs, np.int64)
    gap_first = np.ascontiguousarray(gap_first, np.uint8)
    n_rec = nbs.size
    n_payload_rows = words.size // C.SET_BLOCK_SIZE + int(gap_first.size)
    # a BIC record may outgrow RAW's 8 KiB: the chooser takes it on its
    # size estimate, and one holds at most 29789 values of <= 16 bits.
    # The encoder asks for 8272 free bytes before every record, FULL ones
    # included, so one such margin more keeps it from turning down a
    # vector of FULL blocks only
    cap = (n_rec * 22 + n_payload_rows * _MAX_RECORD_PAYLOAD
           + _RECORD_MARGIN + 64)
    out = np.empty(cap, np.uint8)
    counts = np.zeros(11, np.int64)
    n = lib.bm_bmt1_encode(
        _p(words, _U32P), _p(nbs, _I64P), _p(cls, _U8P), _p(spans, _I64P),
        _p(gap_ends, _I32P), _p(gap_offs, _I64P), _p(gap_first, _U8P),
        n_rec, int(level), int(prev_nb), int(bool(emit_end)),
        _p(out, _U8P), cap, _p(counts, _I64P))
    if n < 0:
        return None
    return out[:n].tobytes(), counts


def gaps_to_dense(ends: np.ndarray, offs: np.ndarray,
                  first: np.ndarray) -> np.ndarray:
    """Dense uint32[m, 2048] rows of m D-GAP blocks in the concatenated
    store layout (``core/gapstore.py``), by word-level span fills."""
    lib = load()
    ends = np.ascontiguousarray(ends, np.int64)
    offs = np.ascontiguousarray(offs, np.int64)
    first = np.ascontiguousarray(first, np.uint8)
    m = first.size
    if offs.size != m + 1:
        raise ValueError(f"{offs.size} offsets for {m} blocks")
    out = np.zeros((m, C.SET_BLOCK_SIZE), np.uint32)
    if m:
        lib.bm_gaps_to_dense(_p(ends, _I64P), _p(offs, _I64P),
                             _p(first, _U8P), m, _p(out, _U32P))
    return out


# op codes of bmt1_stream_op (codecs.cpp)
OP_AND, OP_OR, OP_XOR, OP_SUB_AB, OP_SUB_BA = 0, 1, 2, 3, 4


def bmt1_record_index(blob, rec_offset: int):
    """(nbs int64[R], offs int64[R]): block id and byte offset of every
    record (a header scan, no payload decode), or None when the BLOB is
    malformed."""
    lib = load()
    buf = padded_blob(blob)
    sc = _scan(lib, buf, rec_offset)
    if sc is None:
        return None
    cap = max(sc[0], 1)
    nbs = np.zeros(cap, np.int64)
    offs = np.zeros(cap, np.int64)
    r = lib.bm_bmt1_record_index(_p(buf, _U8P), buf.size - 8, rec_offset,
                                 _p(nbs, _I64P), _p(offs, _I64P))
    if r < 0:
        return None
    return nbs[:r], offs[:r]


def bmt1_stream_op(blob, rec_offset: int, op: int, count_mode: bool,
                   t_nbs: np.ndarray, t_cls: np.ndarray,
                   t_words: np.ndarray, n_rec: int | None = None,
                   nb_prev: int = -1, t_gap_ends=None, t_gap_offs=None,
                   t_gap_first=None):
    """Streamed set-op of a BMT1 BLOB against a target view (O(1 block)
    scratch in C).  Returns the count (count_mode) or (nbs, cls, words) of
    the per-record results; None when the BLOB is malformed.  Raises
    RunCodedBlob when the BLOB holds FULL_RUN records.

    n_rec: process that many records from rec_offset (a window of the
    chunked walk: rec_offset then points at the window's first record);
    None streams to the END record.  nb_prev: block id of the record before
    the window (-1 at the stream start); compact BLOBs delta-code ids.
    t_gap_*: run-coded target blocks (t_cls 3): block k of the cls 3
    subsequence has the block-local int32 run ends
    t_gap_ends[t_gap_offs[k]:t_gap_offs[k+1]] and first-run value
    t_gap_first[k]."""
    lib = load()
    buf = padded_blob(blob)
    if n_rec is None:
        sc = _scan(lib, buf, rec_offset)
        if sc is None:
            return None
        n_rec_eff, max_rec = sc[0], 0
    else:
        n_rec_eff, max_rec = int(n_rec), int(n_rec)
    t_nbs = np.ascontiguousarray(t_nbs, np.int64)
    t_cls = np.ascontiguousarray(t_cls, np.uint8)
    t_words = _words(t_words)
    # per-class slot numbering: cls 2 rows index t_words, cls 3 blocks
    # index the run arrays
    t_slot = np.where(t_cls == 2, np.cumsum(t_cls == 2) - 1, -1).astype(
        np.int64)
    gapm = t_cls == 3
    if gapm.any():
        t_slot[gapm] = np.cumsum(gapm)[gapm] - 1
    if t_gap_ends is None:
        t_gap_ends = np.zeros(0, np.int32)
        t_gap_offs = np.zeros(1, np.int64)
        t_gap_first = np.zeros(0, np.uint8)
    t_gap_ends = np.ascontiguousarray(t_gap_ends, np.int32)
    t_gap_offs = np.ascontiguousarray(t_gap_offs, np.int64)
    t_gap_first = np.ascontiguousarray(t_gap_first, np.uint8)
    if (t_cls.size != t_nbs.size
            or int((t_cls == 2).sum()) * C.SET_BLOCK_SIZE != t_words.size
            or int(gapm.sum()) != t_gap_first.size
            or t_gap_offs.size != t_gap_first.size + 1
            or int(t_gap_offs[-1]) > t_gap_ends.size):
        raise ValueError("target view: classes, rows and run arrays "
                         "disagree")
    cap = max(n_rec_eff, 1)
    out_nbs = np.full(cap, -1, np.int64)
    out_cls = np.zeros(cap, np.uint8)
    out_words = np.zeros((1 if count_mode else cap, C.SET_BLOCK_SIZE),
                         np.uint32)
    o_nrec = ctypes.c_int64(0)
    o_nrows = ctypes.c_int64(0)
    cnt = ctypes.c_int64(0)
    rc = lib.bm_bmt1_stream_op(
        _p(buf, _U8P), buf.size - 8, rec_offset, max_rec, int(nb_prev),
        int(op), int(bool(count_mode)), _p(t_nbs, _I64P), _p(t_cls, _U8P),
        _p(t_slot, _I64P), _p(t_words, _U32P), _p(t_gap_ends, _I32P),
        _p(t_gap_offs, _I64P), _p(t_gap_first, _U8P), t_nbs.size,
        _p(out_nbs, _I64P), _p(out_cls, _U8P), _p(out_words, _U32P),
        ctypes.byref(o_nrec), ctypes.byref(o_nrows), ctypes.byref(cnt))
    if rc == -2:
        raise RunCodedBlob("BMT1 blob contains FULL_RUN records; "
                           "use decode-then-apply")
    if rc != 0:
        return None
    if count_mode:
        return int(cnt.value)
    m = out_nbs[:o_nrec.value] >= 0
    return (out_nbs[:o_nrec.value][m], out_cls[:o_nrec.value][m],
            out_words[:o_nrows.value])


# ---------------------------------------------------------------------------
# BIC and gamma byte helpers
# ---------------------------------------------------------------------------
def bic_encode_bytes(arr: np.ndarray, lo: int, hi: int) -> bytes:
    """BIC-encode a strictly increasing int64 array with values in
    [lo, hi] into a byte-aligned payload."""
    arr = np.ascontiguousarray(arr, np.int64)
    out = np.zeros(arr.size * 8 + 16, np.uint8)
    nbits = load().bm_bic_encode(_p(arr, _I64P), arr.size, int(lo), int(hi),
                                 _p(out, _U8P))
    return out[: (nbits + 7) // 8].tobytes()


def bic_decode_bytes(data, n: int, lo: int, hi: int) -> np.ndarray:
    """The n int64 values of a ``bic_encode_bytes`` payload."""
    buf = padded_blob(data)
    out = np.zeros(n, np.int64)
    load().bm_bic_decode(_p(buf, _U8P), 0, int(n), int(lo), int(hi),
                         _p(out, _I64P))
    return out


def gamma_encode_bytes(arr: np.ndarray) -> bytes:
    """Elias-gamma code of positive uint64 values, byte-aligned."""
    arr = np.ascontiguousarray(arr, np.uint64)
    # worst case: 2*64-1 bits per value
    out = np.zeros(arr.size * 16 + 16, np.uint8)
    nbits = load().bm_gamma_encode(_p(arr, _U64P), arr.size, _p(out, _U8P))
    return out[: (nbits + 7) // 8].tobytes()


def gamma_decode_bytes(data, n: int) -> np.ndarray:
    """The first n uint64 values of a gamma-coded payload; raises
    ValueError when the payload is shorter."""
    buf = padded_blob(data)
    out = np.zeros(n, np.uint64)
    if load().bm_gamma_decode(_p(buf, _U8P), 0, (buf.size - 8) * 8, int(n),
                              _p(out, _U64P)) < 0:
        raise ValueError("malformed stream: truncated gamma payload")
    return out
