"""Flat C-API-shaped facade.

Equivalent surface of the reference C binding (`lang-maps/libbm`,
include/libbm.h — 94 ``BM_*`` functions over opaque handles with error
codes).  Useful for FFI-style embedding and for porting code written against
libbm: every function returns an error code (BM_OK / BM_ERR_*) and writes
results through out-params (here: returned tuples), never raising across the
boundary.  The handles are the port's containers: ``BM_bvector_construct``
builds on ``config.device`` (the card unless the caller chose the CPU), and
every other call runs where its operands live.
"""

from __future__ import annotations

import traceback

import numpy as np

from . import constants as C
from .core.bitvector import BitVector
from .serial.serializer import Deserializer, Serializer

# error codes and numbering follow include/libbm.h:28-40 exactly
BM_OK = 0
BM_ERR_BADALLOC = 1
BM_ERR_BADARG = 2
BM_ERR_RANGE = 3
BM_ERR_CPU = 4
BM_ERR_SERIALFORMAT = 5
BM_ERR_BAD_VALUE = 6
BM_ERR_RANK_SELECT_IDX_MISSING = 7
BM_ERR_DETACHED = 101
BM_ERR_JVM_NOT_SUPPORTED = 102
BM_ERR_JVM_OUT_OF_MEMORY = 103


def BM_version():
    """(err, (major, minor, patch), version_string)."""
    from . import __version__
    parts = tuple(int(x) for x in __version__.split("."))
    return BM_OK, parts, __version__


def BM_init(_ptr=None):
    return BM_OK


def _guard(fn):
    try:
        return BM_OK, fn()
    except IndexError:
        return BM_ERR_RANGE, None
    except ValueError:
        return BM_ERR_BADARG, None
    except MemoryError:
        return BM_ERR_BADALLOC, None
    except Exception:
        traceback.print_exc()
        return BM_ERR_BADARG, None


# -- construction / destruction ------------------------------------------
def BM_bvector_construct(size: int = C.ID_MAX32):
    return _guard(lambda: BitVector(size))


def BM_bvector_construct_copy(bv):
    return _guard(bv.copy)


def BM_bvector_free(bv):
    return BM_OK


def BM_bvector_swap(a, b):
    return _guard(lambda: a.swap(b))[0]


# -- size ------------------------------------------------------------------
def BM_bvector_get_size(bv):
    return BM_OK, bv.size


def BM_bvector_set_size(bv, new_size):
    return _guard(lambda: bv.resize(new_size))[0]


# -- bit set/get -----------------------------------------------------------
def BM_bvector_set_bit(bv, i, val=True):
    return _guard(lambda: bv.set(i, bool(val)))[0]


def BM_bvector_set_bit_no_check(bv, i):
    return BM_bvector_set_bit(bv, i, True)


def BM_bvector_clear_bit(bv, i):
    return _guard(lambda: bv.set(i, False))[0]


def BM_bvector_flip_bit(bv, i):
    return _guard(lambda: bv.flip_bit(i))[0]


def BM_bvector_set_bit_conditional(bv, i, val, condition):
    err, changed = _guard(lambda: bv.set_bit_conditional(i, val, condition))
    return err, changed


def BM_bvector_inc_bit(bv, i):
    err, carry = _guard(lambda: bv.inc(i))
    return err, carry


def BM_bvector_get_bit(bv, i):
    return BM_OK, bv.test(i)


def BM_bvector_set_bits(bv, ids):
    return _guard(lambda: bv.set_many(np.asarray(ids)))[0]


def BM_bvector_set(bv):
    """Set all bits (reference BM_bvector_set)."""
    def run():
        bv.set_range(0, bv.size - 1)
        return bv
    return _guard(run)[0]


def BM_bvector_set_range(bv, lo, hi, val=True):
    return _guard(lambda: bv.set_range(lo, hi, val))[0]


def BM_bvector_invert(bv):
    return _guard(bv.invert)[0]


def BM_bvector_clear(bv, free_mem=True):
    return _guard(lambda: bv.clear(free_mem))[0]


def BM_bvector_extract_next(bv, prev):
    """(err, next_set_bit_after_prev_cleared) reference semantics: find the
    next set bit > prev and clear it."""
    def run():
        i = bv.find(int(prev) + 1)
        if i >= 0:
            bv.set(i, False)
        return i
    return _guard(run)


# -- counts / queries -------------------------------------------------------
def BM_bvector_count(bv):
    return BM_OK, bv.count()


def BM_bvector_count_range(bv, lo, hi):
    return _guard(lambda: bv.count_range(lo, hi))


def BM_bvector_any(bv):
    return BM_OK, bv.any()


def BM_bvector_find(bv, start):
    i = bv.find(start)
    return BM_OK, (i >= 0), i


def BM_bvector_find_reverse(bv):
    i = bv.find_reverse()
    return BM_OK, (i >= 0), i


def BM_bvector_find_first_mismatch(a, b):
    i = a.find_first_mismatch(b)
    return BM_OK, (i >= 0), i


def BM_bvector_find_rank(bv, rank, frm=0):
    i = bv.find_rank(rank, frm)
    return BM_OK, (i >= 0), i


def BM_bvector_rank(bv, i):
    return _guard(lambda: bv.count_to(i))


def BM_bvector_rank_corrected(bv, i):
    return _guard(lambda: bv.rank_corrected(i))


def BM_bvector_select(bv, rank):
    i = bv.select(rank)
    return BM_OK, (i >= 0), i


# -- comparisons -------------------------------------------------------------
def BM_bvector_compare(a, b):
    return BM_OK, a.compare(b)


def BM_bvector_equal(a, b):
    return BM_OK, a.equal(b)


# -- logical ops --------------------------------------------------------------
def BM_bvector_combine_AND(dst, src):
    return _guard(lambda: dst.bit_and(src))[0]


def BM_bvector_combine_OR(dst, src):
    return _guard(lambda: dst.bit_or(src))[0]


def BM_bvector_combine_SUB(dst, src):
    return _guard(lambda: dst.bit_sub(src))[0]


def BM_bvector_combine_XOR(dst, src):
    return _guard(lambda: dst.bit_xor(src))[0]


def BM_bvector_combine_AND_2sc(dst, a, b, compress=False):
    return _guard(lambda: dst.bit_and(a, b, C.OPT_COMPRESS if compress else 0))[0]


def BM_bvector_combine_OR_2sc(dst, a, b, compress=False):
    return _guard(lambda: dst.bit_or(a, b, C.OPT_COMPRESS if compress else 0))[0]


def BM_bvector_combine_XOR_2sc(dst, a, b, compress=False):
    return _guard(lambda: dst.bit_xor(a, b, C.OPT_COMPRESS if compress else 0))[0]


def BM_bvector_combine_SUB_2sc(dst, a, b, compress=False):
    return _guard(lambda: dst.bit_sub(a, b, C.OPT_COMPRESS if compress else 0))[0]


def BM_bvector_merge(dst, src):
    return _guard(lambda: dst.merge(src))[0]


def BM_bvector_rshift1(bv):
    return _guard(bv.shift_right)[0]


# -- optimization / stats ------------------------------------------------------
def BM_bvector_optimize(bv, opt_mode=C.OPT_COMPRESS):
    err, _ = _guard(lambda: bv.optimize(opt_mode))
    return err, bv.calc_stat() if err == BM_OK else None


def BM_bvector_calc_stat(bv):
    return _guard(bv.calc_stat)


def BM_bvector_freeze(bv):
    return _guard(bv.freeze)[0]


def BM_bvector_is_ro(bv):
    return BM_OK, bv.is_ro()


# -- serialization --------------------------------------------------------------
def BM_bvector_serialize(bv, level=6):
    """(err, blob)."""
    return _guard(lambda: Serializer(level).serialize(bv))


def BM_bvector_deserialize(blob):
    """(err, bvector)."""
    try:
        return BM_OK, Deserializer().deserialize(bytes(blob))
    except ValueError:
        return BM_ERR_SERIALFORMAT, None


def BM_bvector_operation_deserialize(bv, blob, op):
    from .serial.opdeser import OperationDeserializer
    return _guard(lambda: OperationDeserializer().deserialize(bv, bytes(blob), op))


# -- enumerator -------------------------------------------------------------------
def BM_bvector_enumerator_construct(bv, pos=0):
    """(err, iterator over set bits >= pos)."""
    idx = bv.indices()
    return BM_OK, iter(idx[idx >= pos].tolist())


def BM_bvector_enumerator_next(en):
    try:
        return BM_OK, True, next(en)
    except StopIteration:
        return BM_OK, False, -1


# -- full libbm parity surface (lang-maps/libbm/include/libbm.h) ----------
def BM_simd_version():
    from .config import simd_version
    return BM_OK, simd_version()


def BM_error_msg(err):
    # messages mirror include/libbm.h:46-60
    return {BM_OK: "BM-00: All correct",
            BM_ERR_BADALLOC: "BM-01: Allocation error",
            BM_ERR_BADARG: "BM-02: Invalid or missing function argument",
            BM_ERR_RANGE: "BM-03: Incorrect range or index",
            BM_ERR_CPU:
                "BM-04: Incorrect CPU vectorization (SIMD) version",
            BM_ERR_SERIALFORMAT: "BM-05: Serialization format error",
            BM_ERR_BAD_VALUE: "BM-06: Bad value",
            BM_ERR_RANK_SELECT_IDX_MISSING:
                "BM-07: Rank-Select index not constructed, call sync() first",
            BM_ERR_DETACHED: "BM-101: Current thread no attached to JVM",
            BM_ERR_JVM_NOT_SUPPORTED: "BM-102: JVM version not supported",
            BM_ERR_JVM_OUT_OF_MEMORY: "BM-103: Out of memory error",
            }.get(err, "BM-XX: unknown error")


def BM_bvector_init(bv):
    return BM_OK


def BM_bvector_construct_copy_ro(bv):
    def run():
        out = bv.copy()
        out.freeze()
        return out
    return _guard(run)


def BM_bvector_construct_copy_rw(bv):
    return _guard(lambda: bv.copy())


def BM_bvector_get_capacity(bv):
    return BM_OK, bv.size


def BM_bvector_swap_bits(bv, i, j):
    return _guard(lambda: bv.swap_bits(i, j))


def BM_bvector_get_first(bv):
    """(err, found, pos) — first set bit."""
    pos = bv.find(0)
    return BM_OK, pos >= 0, max(pos, 0)


def BM_bvector_get_next(bv, pos):
    """(err, found, pos) — next set bit strictly after pos."""
    nxt = bv.find(int(pos) + 1)
    return BM_OK, nxt >= 0, max(nxt, 0)


def BM_bvector_count_AND(a, b):
    from .algo import setops
    return _guard(lambda: setops.count_and(a, b))


def BM_bvector_count_OR(a, b):
    from .algo import setops
    return _guard(lambda: setops.count_or(a, b))


def BM_bvector_count_XOR(a, b):
    from .algo import setops
    return _guard(lambda: setops.count_xor(a, b))


def BM_bvector_count_SUB(a, b):
    from .algo import setops
    return _guard(lambda: setops.count_sub(a, b))


def BM_bvector_any_AND(a, b):
    from .algo import setops
    return _guard(lambda: setops.any_and(a, b))


def BM_bvector_any_OR(a, b):
    from .algo import setops
    return _guard(lambda: setops.any_or(a, b))


def BM_bvector_any_XOR(a, b):
    from .algo import setops
    return _guard(lambda: setops.any_xor(a, b))


def BM_bvector_any_SUB(a, b):
    from .algo import setops
    return _guard(lambda: setops.any_sub(a, b))


def BM_bvector_combine_operation(dst, src, opcode):
    """Generic op dispatch (libbm BM_bvector_combine_operation;
    opcodes: 0 AND, 1 OR, 2 SUB, 3 XOR as in the reference binding)."""
    def run():
        if opcode == 0:
            dst.bit_and(src)
        elif opcode == 1:
            dst.bit_or(src)
        elif opcode == 2:
            dst.bit_sub(src)
        elif opcode == 3:
            dst.bit_xor(src)
        else:
            raise ValueError(f"bad opcode {opcode}")
        return dst
    return _guard(run)


def _combine_arr(dst, arr, op):
    def run():
        other = BitVector.from_indices(
            np.unique(np.asarray(arr, np.int64)), dst.size,
            device=dst.device)
        getattr(dst, op)(other)
        return dst
    return _guard(run)


def BM_bvector_combine_OR_arr(dst, arr):
    return _combine_arr(dst, arr, "bit_or")


def BM_bvector_combine_AND_arr(dst, arr):
    return _combine_arr(dst, arr, "bit_and")


def BM_bvector_combine_AND_arr_sorted(dst, arr):
    return _combine_arr(dst, arr, "bit_and")


def BM_bvector_combine_XOR_arr(dst, arr):
    return _combine_arr(dst, arr, "bit_xor")


def BM_bvector_combine_SUB_arr(dst, arr):
    return _combine_arr(dst, arr, "bit_sub")


def BM_bvector_statistics(bv):
    """(err, dict) — reference BM_bvector_statistics (bv_statistics)."""
    return _guard(bv.calc_stat)


# stateful enumerator handles (libbm enumerator object surface)
class _Enumerator:
    __slots__ = ("idx", "k")

    def __init__(self, idx, pos):
        self.idx = idx
        self.k = int(np.searchsorted(idx, pos))


def BM_bvector_enumerator_construct_from(bv, pos):
    return BM_OK, _Enumerator(bv.indices(), pos)


def BM_bvector_enumerator_free(en):
    return BM_OK


def BM_bvector_enumerator_is_valid(en):
    return BM_OK, en.k < len(en.idx)


def BM_bvector_enumerator_get_value(en):
    if en.k >= len(en.idx):
        return BM_ERR_RANGE, 0
    return BM_OK, int(en.idx[en.k])


def BM_bvector_enumerator_next_value(en):
    """(err, valid, value) — advance then read."""
    en.k += 1
    if en.k >= len(en.idx):
        return BM_OK, False, 0
    return BM_OK, True, int(en.idx[en.k])


def BM_bvector_enumerator_goto(en, pos):
    en.k = int(np.searchsorted(en.idx, pos))
    return BM_OK, en.k < len(en.idx)
