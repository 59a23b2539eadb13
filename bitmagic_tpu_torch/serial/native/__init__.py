"""Loader of the port's native codec library (``codecs.cpp``).

The port keeps its own copy of the C++ source, byte for byte that of the
JAX package, and builds it with ``g++`` at first use into
``bitmagic_tpu_torch/_build/``.  The library's file name carries a hash of
the source, the flags and the host's machine and C library, so an edited
source never loads a stale build and a library built on another kind of
host is never loaded.  A failed build raises: nothing falls back to a
pure-Python codec.

Exposed so far (a plain C interface through ``ctypes``): the positions of
every set bit of a pool (``pool_positions``), of one block
(``block_positions``) and the run boundaries of one block
(``block_gap_boundaries``).
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

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "bm_pool_positions": (ctypes.c_int64, [_U32P, ctypes.c_int64, _I64P,
                                           _I64P]),
    "bm_block_positions": (ctypes.c_int64, [_U32P, ctypes.c_int, _U16P]),
    "bm_block_gap_boundaries": (ctypes.c_int64, [_U32P, _U16P, _I32P]),
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
    got = load().bm_pool_positions(w.ctypes.data_as(_U32P), n,
                                   bases.ctypes.data_as(_I64P),
                                   out.ctypes.data_as(_I64P))
    return out[:got]


def block_positions(words: np.ndarray, inverted: bool = False) -> np.ndarray:
    """Positions (int64) of the set bits of one 2048-word block, or of its
    clear bits when ``inverted``."""
    w = _words(words, 1)
    out = np.empty(C.BITS_PER_BLOCK, np.uint16)
    n = load().bm_block_positions(w.ctypes.data_as(_U32P), int(inverted),
                                  out.ctypes.data_as(_U16P))
    return out[:n].astype(np.int64)


def block_gap_boundaries(words: np.ndarray):
    """(value of bit 0, int64 run ends ascending, the last one 65535) of one
    2048-word block: its D-GAP form."""
    w = _words(words, 1)
    out = np.empty(C.BITS_PER_BLOCK + 1, np.uint16)
    start = ctypes.c_int32(0)
    n = load().bm_block_gap_boundaries(w.ctypes.data_as(_U32P),
                                       out.ctypes.data_as(_U16P),
                                       ctypes.byref(start))
    return int(start.value), out[:n].astype(np.int64)
