"""The rest of the port's BitVector against the JAX package, on the CPU.

Host-only methods (single-bit updates, keep, import_sorted, swap,
move_from, the range queries, the GAP-level controls, calc_stat and the
serializer snapshots), the methods on the K1 route of ``_binary`` (flip,
compare and find_first_mismatch, bit_or_and, merge, shift_left, insert
and erase) and the iteration methods (get_first / get_next / extract_next
/ check_or_next, the native positions of ``indices()``).  The same calls
on the same numpy-seeded inputs go to both packages; states (through
``interop``) and answers must be identical, on the mixed 80-block pair of
``test_torch_bitvector.py``, on vectors built for shift_left's edge cases
and on ids near ``ID_MAX48``.
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.serial import native
from test_torch_bitvector import SIZE, assert_same_state, build_pair

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
TOP = C.ID_MAX48
B32 = 1 << 32
# a BIT row's first bit and middle, a GAP block, the start and middle of
# A's FULL run, the partial row, the last bit
POS = [0, 3 * BPB, 3 * BPB + 777, 12 * BPB + 5, 20 * BPB, 40 * BPB + 9,
       61 * BPB + 5, SIZE - 1]
BORDER_IDS = np.asarray(sorted({
    0, 1, 65535, 65536, B32 - 65537, B32 - 65536, B32 - 1, B32, B32 + 1,
    B32 + 65536, (1 << 40) + 21824, TOP - 65537, TOP - 65536, TOP - 2,
    TOP - 1}), np.int64)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


@pytest.fixture(scope="module")
def pairs():
    old = tbm.config.device
    tbm.config.device = "cpu"
    try:
        return build_pair(jbm), build_pair(tbm)
    finally:
        tbm.config.device = old


def shift_vectors(pkg):
    """Vectors for shift_left / erase edges: bit 0 set; a block whose bit 0
    carries into a present predecessor, one whose predecessor is absent; a
    FULL run; a GAP block next to a dense one; a partial last block."""
    size = 60 * BPB + 12345
    ids = np.asarray([0, 1, 777, BPB, BPB + 5, 5 * BPB, 5 * BPB + 64,
                      9 * BPB - 1, 58 * BPB, 60 * BPB, 60 * BPB + 12344],
                     np.int64)
    v = pkg.BitVector.from_indices(ids, size)
    v.set_range(10 * BPB, 45 * BPB - 1)                   # a FULL run
    gap = 46 * BPB + np.arange(100, 400)
    v |= pkg.BitVector.from_indices(gap, size, strategy=C.BM_GAP)
    v.set(47 * BPB)                                        # dense neighbour
    v.optimize()
    return v


def border_vector(pkg):
    return pkg.BitVector.from_indices(BORDER_IDS, TOP)


def _answers_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _answers_equal(g, w)
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        assert got == want


def run_both(make, fn):
    """fn(pkg, vectors...) on fresh vectors of each package: the answers
    and every vector's final state must match."""
    jv, tv = make(jbm), make(tbm)
    jv = jv if isinstance(jv, tuple) else (jv,)
    tv = tv if isinstance(tv, tuple) else (tv,)
    want, got = fn(jbm, *jv), fn(tbm, *tv)
    _answers_equal(got, want)
    for j, t in zip(jv, tv):
        assert_same_state(j, t)
    return got


def _pair_copies(pairs):
    (ja, jb), (ta, tb) = pairs
    return lambda pkg: ((ja.copy(), jb.copy()) if pkg is jbm
                        else (ta.copy(), tb.copy()))


# --- host-only methods -------------------------------------------------
def _single_bits(pkg, v, w):
    out = []
    for i in POS:
        v.flip_bit(i)
        out.append(v.set_bit_conditional(min(i + 1, SIZE - 2), True, False))
        out.append(v.set_bit_conditional(i, True, True))
        out.append(v.set_bit_and(i, False))
        out.append(w.inc(i))
    w.swap_bits(POS[1], POS[3])
    w.swap_bits(POS[4], SIZE - 2)
    return out


def _keep_import(pkg, v, w):
    rng = np.random.default_rng(3)
    v.keep(np.concatenate([rng.integers(0, SIZE, 3000), POS]))
    ids = np.sort(rng.integers(0, SIZE, 2000))
    w.import_sorted(np.repeat(ids, 2))          # duplicates are legal
    with pytest.raises(ValueError):
        w.import_sorted([5, 3])
    return v.count(), w.count()


def _swap_move(pkg, v, w):
    v.set(9)                                      # staged bits travel too
    v.swap(w)
    x = pkg.BitVector(SIZE)
    x.move_from(v)
    v.move_from(x)
    v.move_from(v)
    return v.count(), w.count(), x.count(), x.init().any()


def _range_queries(pkg, v, w):
    out = []
    for lo, hi in ((20 * BPB, 60 * BPB - 1), (20 * BPB - 1, 30 * BPB),
                   (61 * BPB + 5, 61 * BPB + 1000), (0, 0), (5, 3),
                   (SIZE - 10, SIZE)):
        out.append(v.is_all_one_range(lo, hi))
    for i in POS:
        out += [v.rank_corrected(i), v.count_to_test(i), w.count_to_test(i)]
    out += [v.find_range(), pkg.BitVector(SIZE).find_range()]
    return out


def _gap_levels(pkg, v, w):
    old = v.set_new_blocks_strat(C.BM_GAP)
    out = [old, v.get_new_blocks_strat()]
    v.set_gap_levels((32, 64, 128, 256)).optimize()
    out.append(v.get_gap_levels())
    with pytest.raises(ValueError):
        v.set_gap_levels((1, 2, 3))
    w.optimize_range(5 * BPB, 16 * BPB - 1)
    w.optimize_gap_size()
    out.append(w.get_gap_levels())
    return out


def _stats(pkg, v, w):
    out = [v.calc_stat(), w.calc_stat()]
    w.set_gap_levels((64, 128, 256, 512))
    out.append(w.calc_stat())
    return out


@pytest.mark.parametrize("fn", [_single_bits, _keep_import, _swap_move,
                                _range_queries, _gap_levels, _stats],
                         ids=lambda f: f.__name__.strip("_"))
def test_host_methods(pairs, fn):
    run_both(_pair_copies(pairs), fn)


def test_snapshots(pairs):
    (ja, jb), (ta, tb) = pairs
    for j, t in ((ja, ta), (jb, tb)):
        want, got = j._snapshot_with_runs(), t._snapshot_with_runs()
        for w_, g_ in zip(want, got):
            np.testing.assert_array_equal(g_, w_)
        for w_, g_ in zip(j._dense_snapshot(), t._dense_snapshot()):
            np.testing.assert_array_equal(g_, w_)
        for k in range(len(t._struct.nb)):
            np.testing.assert_array_equal(t._block_words_host(k),
                                          j._block_words_host(k))


def test_read_only_guards():
    v = tbm.BitVector.from_indices([1, 5], 100).freeze()
    for call in (lambda: v.keep([1]), lambda: v.insert(2, True),
                 lambda: v.erase(1), lambda: v.shift_left(),
                 lambda: v.flip(), lambda: v.merge(
                     tbm.BitVector.from_indices([3], 100)),
                 lambda: v.check_or_next_extract(0),
                 lambda: v.optimize_gap_size()):
        with pytest.raises(tbm.core.bitvector.ReadOnlyError):
            call()


# --- methods on the K1 route -------------------------------------------
def _flip(pkg, v, w):
    v.flip()
    for i in POS:
        w.flip(i)
    return v.count()


def _compare(pkg, v, w):
    x = v.copy()
    out = [v.compare(w), w.compare(v), v.find_first_mismatch(w),
           v.compare(x), v.find_first_mismatch(x)]
    for i in POS:
        y = v.copy().flip(i)
        out += [v.compare(y), y.compare(v), v.find_first_mismatch(y)]
    return out


def _or_and_merge(pkg, v, w):
    z = pkg.BitVector.from_indices(np.arange(0, SIZE, 977), SIZE)
    z.bit_or_and(v, w)
    v.bit_or_and(w, z, opt_mode=C.OPT_COMPRESS)
    y = w.copy()
    w.merge(y)
    return z.count(), y.count(), y.any()


@pytest.mark.parametrize("fn", [_flip, _compare, _or_and_merge],
                         ids=lambda f: f.__name__.strip("_"))
def test_k1_route_methods(pairs, fn):
    run_both(_pair_copies(pairs), fn)


@pytest.mark.parametrize("i", POS)
def test_insert_erase(pairs, i):
    def fn(pkg, v, w):
        v.insert(i, True)
        w.insert(i, False)
        return v.count(), w.count()

    run_both(_pair_copies(pairs), fn)

    def fn2(pkg, v, w):
        v.erase(i)
        w.erase(i)
        return v.indices()[:50], w.count()

    run_both(_pair_copies(pairs), fn2)


def _lone_block_vector(pkg):
    """Block 1 and block 3 hold bit 0 and have no block before them."""
    return pkg.BitVector.from_indices([BPB, 3 * BPB, 3 * BPB + 1, 4 * BPB - 1],
                                      5 * BPB)


@pytest.mark.parametrize("make", [shift_vectors, _lone_block_vector],
                         ids=["mixed", "lone_blocks"])
def test_shift_left_edges(make):
    def fn(pkg, v):
        out = []
        for _ in range(3):
            v.shift_left()
            out.append(v.indices()[:20])
        v.erase(0)
        v.erase(9 * BPB - 4)
        v.insert(v.size - 1, True)
        out.append(v.count())
        return out

    got = run_both(make, fn)
    assert got[0].size


def test_shift_left_pairs(pairs):
    def fn(pkg, v, w):
        v.shift_left()
        w.shift_left()
        w.shift_left()
        return v.count() + w.count()

    run_both(_pair_copies(pairs), fn)


def test_boundary48():
    def fn(pkg, v):
        w = v.copy()
        out = [v.get_first(), v.get_next(B32 - 1), v.get_next(TOP - 2),
               v.get_next(TOP - 1), v.check_or_next(B32 + 2),
               v.find_range(), v.calc_stat()]
        w.insert(B32, True)
        w.insert(TOP - 2, False)           # bit TOP-1 moves past the end
        out += [w.compare(v), w.find_first_mismatch(v), w.count()]
        w.erase(1)
        w.erase(TOP - 65536)
        w.shift_left()
        out += [w.extract_next(B32 - 2), w.check_or_next_extract(TOP - 4),
                v.is_all_one_range(TOP - 2, TOP - 1), v.rank_corrected(B32)]
        out.append(w.indices().tolist())
        v.flip(TOP - 3)
        v.keep([TOP - 3, TOP - 1, B32])
        out.append(v.indices().tolist())
        return out

    run_both(border_vector, fn)


# --- iteration -----------------------------------------------------------
def test_find_walks(pairs):
    def fn(pkg, v, w):
        out = [v.get_first(), pkg.BitVector(SIZE).get_first()]
        for i in POS + [SIZE]:
            out += [v.get_next(i), w.check_or_next(i)]
        for i in POS[:4]:
            out += [v.extract_next(i), w.check_or_next_extract(i)]
        return out

    run_both(_pair_copies(pairs), fn)


def test_indices_native(pairs, monkeypatch):
    """indices() decodes the dense rows with the native library, once per
    call, and gives the JAX package's positions."""
    calls = []
    real = native.pool_positions
    monkeypatch.setattr(native, "pool_positions",
                        lambda *a: calls.append(1) or real(*a))
    (ja, jb), (ta, tb) = pairs
    for j, t in ((ja, ta), (jb, tb), (ja & jb, ta & tb),
                 (border_vector(jbm), border_vector(tbm))):
        np.testing.assert_array_equal(t.indices(), j.indices())
    assert len(calls) == 4
    assert tbm.BitVector(SIZE).indices().size == 0
