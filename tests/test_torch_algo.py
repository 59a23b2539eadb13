"""The port's enumerators and free-function algorithms against the JAX
package, on the CPU.

Enumerator, CountedEnumerator, the insert iterators, traversal,
intervals, rank_compress, sampling, Kleene logic and the rest of setops
(similarity batches, distance_operation_any, the combine family, the raw
imports, the Jaccard batch over a SparseVector's planes).  The same calls
on the same numpy-seeded inputs go to both packages; positions, counts,
matrices, Jaccard floats (with no tolerance) and vector states must be
identical.
"""
import itertools

import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.core import enumerator as tenum
from test_torch_bitvector import SIZE, assert_same_state, build_pair
from test_torch_bitvector_rest import POS, _answers_equal, border_vector

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


@pytest.fixture(scope="module")
def vecs():
    """{package: [A, B, A & B (no FULL run), the 48-bit border vector, A's
    BIT and GAP blocks alone (~50k bits, for full Python walks)]}."""
    old = tbm.config.device
    tbm.config.device = "cpu"
    try:
        out = {}
        for pkg in (jbm, tbm):
            a, b = build_pair(pkg)
            out[pkg] = [a, b, a & b, border_vector(pkg),
                        a.copy().keep_range(0, 20 * BPB - 1)]
        return out
    finally:
        tbm.config.device = old


def both(vecs, fn, *idx):
    """fn(pkg, *vectors) for each package on copies of vecs[idx]; the
    answers and final states must match."""
    j = [vecs[jbm][i].copy() for i in idx]
    t = [vecs[tbm][i].copy() for i in idx]
    want, got = fn(jbm, *j), fn(tbm, *t)
    _answers_equal(got, want)
    for x, y in zip(j, t):
        assert_same_state(x, y)
    return got


# --- enumerators ---------------------------------------------------------
@pytest.mark.parametrize("k", [3, 4])
def test_enumerator_walk(vecs, k, monkeypatch):
    """A full walk (rows fetched two at a time, so chunks turn over) equals
    the JAX walk and indices()."""
    monkeypatch.setattr(tenum, "ROW_CHUNK", 2)

    def fn(pkg, v):
        walk = np.fromiter(v.get_enumerator(), np.int64)
        np.testing.assert_array_equal(walk, v.indices())
        n = 0
        en = v.first()
        while en != v.end():
            n += 1
            en.advance()
        return walk, n

    both(vecs, fn, k)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_enumerator_partial_walks(vecs, k, monkeypatch):
    """Walks of 20000 positions from points in BIT, GAP, FULL-run and
    absent blocks (the vectors hold millions of bits) against indices()."""
    monkeypatch.setattr(tenum, "ROW_CHUNK", 2)

    def fn(pkg, v):
        idx = v.indices()
        out = []
        for p in (0, 9 * BPB + 5, 19 * BPB, 59 * BPB + 60000, 61 * BPB,
                  74 * BPB):
            walk = np.fromiter(itertools.islice(v.get_enumerator(p), 20000),
                               np.int64)
            lo = np.searchsorted(idx, p)
            np.testing.assert_array_equal(walk, idx[lo:lo + 20000])
            out.append(walk)
        return out

    both(vecs, fn, k)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_enumerator_jumps(vecs, k):
    def fn(pkg, v):
        size = v.size
        out = []
        en = v.get_enumerator()
        for p in [0, 3, size // 3, size // 2 + 5, size - 1, size]:
            out.append((en.go_to(p), en.valid() and en.value()))
        en.go_first()
        for n in (1, 2, 500, 70000, 10 ** 6, 10 ** 9):
            out.append((en.skip(n), en.valid() and en.value()))
        en = v.get_enumerator(size // 4)
        for r in (1, 3, 40000):
            out.append((en.skip_to_rank(r), en.valid() and en.value()))
        end = v.end()
        out += [end.valid(), end == v.end(), en < end, end < en]
        return out

    both(vecs, fn, k)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_counted_enumerator(vecs, k):
    def fn(pkg, v):
        en = v.get_counted_enumerator()
        out = [en.count(), en.bit_count]
        for _ in range(5):
            en.go_up()
            out += [en.count(), en.value()]
        en.skip(1000)
        out += [en.count(), en.bit_count]
        en.go_to(v.size // 2)
        out += [en.count(), en.valid()]
        en.go_to(v.size)
        out += [en.count(), en.bit_count]
        return out

    both(vecs, fn, k)


def test_enumerator_resyncs_after_mutation(vecs):
    def fn(pkg, v):
        en = v.get_enumerator(POS[2])
        first = en.value()
        v.set(POS[2])
        v.clear_range(POS[1], POS[3])
        v.optimize()
        en.go_to(POS[1])
        return first, en.value(), list(en)[:30]

    both(vecs, fn, 0)


def test_insert_iterators(vecs):
    def fn(pkg, v):
        rng = np.random.default_rng(11)
        ids = rng.integers(0, v.size, 300)
        it = v.get_bulk_insert_iterator(buffer_size=64)
        for i in ids[:100]:
            it.add(int(i))
        it(int(ids[100]))
        it.add_many(ids[101:200])
        it.flush()
        with v.inserter() as it2:
            it2.add_many(ids[200:])
        from importlib import import_module
        ins = import_module(pkg.__name__ + ".core.enumerator").InsertIterator
        with ins(v) as it3:
            it3.add(5)
        return v.count()

    both(vecs, fn, 1)


# --- traversal -------------------------------------------------------------
@pytest.mark.parametrize("k", [3, 4])
def test_traversal(vecs, k):
    def fn(pkg, v, a):
        seen, seen_r, vis = [], [], []
        pkg.for_each_bit(v, seen.append)
        pkg.for_each_bit_range(v, POS[1], POS[5], seen_r.append)
        pkg.visit_each_bit_range(v, 0, POS[3], vis.append)
        n = [0]
        pkg.visit_each_bit(v, lambda i: n.__setitem__(0, n[0] + 1))
        splits = [pkg.rank_range_split(v, r) for r in (1, 7, 5000, 10 ** 9)]
        splits.append(pkg.rank_range_split(a, 100_000))
        with pytest.raises(ValueError):
            pkg.rank_range_split(v, 0)
        return seen, seen_r, vis, n[0], splits, pkg.rank_range_split(
            pkg.BitVector(v.size), 5)

    both(vecs, fn, k, 0)


# --- intervals -------------------------------------------------------------
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_intervals(vecs, k):
    def fn(pkg, v):
        iv = pkg.algo.intervals(v)
        out = [iv, list(pkg.interval_enumerator(v))[:50],
               pkg.count_intervals(v), pkg.count_intervals(
                   pkg.BitVector(v.size))]
        ie = pkg.IntervalEnumerator(v, POS[2], extend_start=False)
        out.append([(ie.start(), ie.end())] if ie.valid() else [])
        for p in POS + [v.size]:
            for ext in (True, False):
                ok = ie.go_to(p, ext)
                out.append((ok, ok and (ie.start(), ie.end())))
        ie = pkg.IntervalEnumerator(v)
        out.append(list(ie)[:40])
        for s, e in iv[:: max(1, len(iv) // 8)]:
            mid = (int(s) + int(e)) // 2
            out += [pkg.is_interval(v, s, e), pkg.is_interval(v, s, e - 1),
                    pkg.is_interval(v, s - 1, e),
                    pkg.find_interval_start(v, mid),
                    pkg.find_interval_end(v, mid)]
        out += [pkg.find_interval_start(v, int(iv[0, 0]) - 1)
                if iv[0, 0] > 0 else None, pkg.is_interval(v, 5, 3)]
        return out

    both(vecs, fn, k)


# --- rank_compress, sampling ---------------------------------------------
def test_rank_compress(vecs):
    def fn(pkg, a, b, ab):
        rc = pkg.rank_compress
        c = rc.compress(a, b)
        d = rc.decompress(c, b)
        e = rc.compress_by_source(ab, a)
        empty = rc.compress(pkg.BitVector(a.size), b)
        back = rc.decompress(pkg.BitVector(10), b)
        return [x.indices() for x in (c, d, e)] + [
            (x.size, x.count()) for x in (c, d, e, empty, back)]

    both(vecs, fn, 0, 1, 2)


def test_sampling(vecs):
    def fn(pkg, a, border):
        out = []
        for n, seed in ((0, 1), (1, 2), (1000, 3), (a.count(), 4),
                        (a.count() + 5, 5)):
            out.append(pkg.random_subset(a, n, seed).indices())
        out.append(pkg.random_subset(border, 5, 6).indices())
        rs = pkg.RandomSubset(7)
        dst = pkg.BitVector(a.size)
        for n in (10, 300):
            out.append(rs.sample(dst, a, n).indices())
        return out

    both(vecs, fn, 0, 3)


# --- Kleene ----------------------------------------------------------------
def test_kleene(vecs):
    def fn(pkg, a, b, ab):
        v1, k1 = pkg.init_kleene(ab.copy(), a.copy())
        v2, k2 = pkg.init_kleene(b.copy() - a, b.copy())
        out = []
        for op in (pkg.and_kleene, pkg.or_kleene):
            v, k = op(v1, k1, v2, k2)
            out += [v.indices(), k.indices()]
        for i in POS:
            out.append(pkg.get_value_kleene(v1, k1, i))
        pkg.set_value_kleene(v1, k1, POS[1], 1)
        pkg.set_value_kleene(v1, k1, POS[2], -1)
        pkg.set_value_kleene(v1, k1, POS[4], 0)
        pkg.invert_kleene(v1, k1)
        kl = pkg.algo.kleene
        kl.and_kleene_inplace(v1, k1, v2, k2)
        kl.or_kleene_inplace(v2, k2, v1, k1)
        out += [v1.indices(), k1.indices(), v2.indices(), k2.indices()]
        out += [kl.and_values_kleene(x, y) for x in (-1, 0, 1)
                for y in (-1, 0, 1)]
        out += [kl.or_values_kleene(x, y) for x in (-1, 0, 1)
                for y in (-1, 0, 1)]
        return out

    both(vecs, fn, 0, 1, 2)


# --- setops ------------------------------------------------------------------
METRICS = ("count_and", "count_xor", "count_or", "count_sub_ab",
           "count_sub_ba", "count_a", "count_b")


def test_similarity_and_any(vecs):
    def fn(pkg, a, b, ab):
        group = [a, b, ab, pkg.BitVector(a.size)]
        out = [pkg.similarity_batch(group),
               pkg.build_similarity_batch(group, "count_xor"),
               pkg.distance_and_operation(a, b)]
        for x, y in ((a, b), (ab, pkg.BitVector(a.size)), (a, a)):
            out.append(pkg.distance_operation_any(x, y, METRICS))
        with pytest.raises(ValueError):
            pkg.distance_operation_any(a, b, ["count_nope"])
        return out

    both(vecs, fn, 0, 1, 2)


def test_combine_family(vecs):
    def fn(pkg, a, b, border):
        rng = np.random.default_rng(5)
        ids = rng.integers(0, SIZE, 4000)
        pkg.combine_or(a, ids[:1000])
        pkg.combine_xor(a, ids[500:2000])
        pkg.combine_sub(b, ids[1000:3000])
        pkg.combine_and(b, np.concatenate([ids, np.arange(50 * BPB,
                                                          55 * BPB)]))
        pkg.combine_and_sorted(border, np.sort(border.indices()[::2]))
        with pytest.raises(ValueError):
            pkg.combine_and_sorted(a, [9, 2])
        for f in (pkg.combine_or, pkg.combine_xor, pkg.combine_sub):
            f(a, [])
        e = pkg.BitVector(0)
        pkg.combine_and(e, [])
        return a.count(), b.count(), border.count(), e.size

    both(vecs, fn, 0, 1, 3)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint32, np.int64])
def test_raw_imports(dtype):
    rng = np.random.default_rng(9)
    arr = rng.integers(0, np.iinfo(dtype).max, 70001).astype(dtype)
    words = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(
        np.uint32)

    def make(pkg):
        return (pkg.BitVector(100), pkg.BitVector(3 * BPB),
                pkg.BitVector(10), pkg.BitVector(10))

    def fn(pkg, v, w, x, y):
        pkg.export_array(v, arr)
        pkg.export_array(w, arr[:3])
        pkg.bit_import(x, words)
        pkg.bit_import_u32(y, words, size=1000 * 32 + 7, optimize=True)
        with pytest.raises(ValueError):
            pkg.bit_import_u32(pkg.BitVector(10), words[:2], size=100)
        with pytest.raises(ValueError):
            pkg.export_array(pkg.BitVector(10), np.zeros(3, np.float32))
        return [z.size for z in (v, w, x, y)]

    jv, tv = make(jbm), make(tbm)
    _answers_equal(fn(tbm, *tv), fn(jbm, *jv))
    for j, t in zip(jv, tv):
        assert_same_state(j, t)


def test_jaccard_batch():
    """Over the value planes of a SparseVector (BitVectors in both
    packages); the Jaccard floats equal with no tolerance, ties sorted
    alike."""
    rng = np.random.default_rng(21)
    vals = rng.integers(0, 1 << 12, 200_000).astype(np.uint32)
    vals[::7] = 0x0F0                          # ties between planes 4..7
    want = jbm.algo.setops.build_jaccard_similarity_batch(
        jbm.SparseVector.from_array(vals))
    got = tbm.build_jaccard_similarity_batch(tbm.SparseVector.from_array(
        vals))
    assert len(got) == 12 * 11 // 2
    assert got == want
    assert all(type(t[4]) is float for t in got)


def test_slice_names_exported():
    """The names of this slice that the JAX package exports at its top
    level are exported by the port under the same names."""
    names = ["algo", "rank_compress", "IntervalEnumerator", "RandomSubset",
             "bit_import", "bit_import_u32", "build_jaccard_similarity_batch",
             "build_similarity_batch", "combine_and", "combine_and_sorted",
             "combine_or", "combine_sub", "combine_xor",
             "distance_and_operation", "distance_operation_any",
             "export_array", "similarity_batch", "for_each_bit",
             "for_each_bit_range", "rank_range_split", "visit_each_bit",
             "visit_each_bit_range", "count_intervals", "find_interval_end",
             "find_interval_start", "interval_enumerator", "is_interval",
             "and_kleene", "get_value_kleene", "init_kleene",
             "invert_kleene", "or_kleene", "set_value_kleene",
             "random_subset"]
    for n in names:
        assert n in jbm.__all__ and n in tbm.__all__, n
        assert hasattr(tbm, n), n
    assert sorted(tbm.algo.__all__) == sorted(jbm.algo.__all__)
