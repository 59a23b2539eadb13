"""One-to-one walk of the reference's bvsample01-26 programs.

Each function mirrors the API surface its reference sample demonstrates
(samples/readme in the reference tree), using this package's public
exports — the use-case samples 01-22 cover the same ground thematically;
this file is the literal program-by-program map so a reference user can
find every bvsampleNN flow by name.

Run: python samples_torch/23_bvsample_walk.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm  # noqa: E402


def bvsample01():
    """Basic set/get bits + cardinality (reference samples/bvsample01)."""
    bv = bm.BitVector(10000)
    bv.set(10)
    bv.set(100)
    bv.set(10000 - 1)
    assert bv.test(10) and not bv.test(11)
    assert bv.count() == 3
    bv.clear_bit(100)
    assert bv.count() == 2
    bv.inc(10)                                # toggles: set -> clear
    assert not bv.test(10)


def bvsample02():
    """Set algebra, equivalence, lexicographical compare,
    find_first_mismatch (bvsample02)."""
    a = bm.BitVector.from_indices([1, 2, 3], size=1000)
    b = bm.BitVector.from_indices([2, 3, 4], size=1000)
    assert sorted((a & b).indices().tolist()) == [2, 3]
    assert sorted((a | b).indices().tolist()) == [1, 2, 3, 4]
    assert sorted((a - b).indices().tolist()) == [1]
    assert sorted((a ^ b).indices().tolist()) == [1, 4]
    assert not a.equal(b) and a.equal(a.copy())
    assert a.compare(b) != 0                  # lexicographical order
    assert a.find_first_mismatch(b) == 1


def bvsample03():
    """In-memory compression options + memory footprint (bvsample03)."""
    bv = bm.BitVector(1 << 24)
    bv.set_range(0, 65535)                    # a FULL block
    for i in range(0, 1 << 20, 2048):         # a sparse (GAP-able) spread
        bv.set(i)
    st0 = bv.calc_stat()
    bv.optimize()                             # OPT_COMPRESS default
    st1 = bv.calc_stat()
    assert st1["memory_used"] <= st0["memory_used"]
    assert st1["gap_blocks"] > 0              # sparse blocks went succinct


def bvsample04():
    """Serialize to a BLOB and save to a file (bvsample04)."""
    import tempfile
    bv = bm.BitVector.from_indices([5, 70000, 1 << 22], size=1 << 23)
    blob = bm.serialize(bv)
    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(bytes(blob))
        path = f.name
    back = bm.deserialize(np.fromfile(path, np.uint8))
    os.unlink(path)
    assert back.equal(bv)


def bvsample05():
    """Enumerator: decode the vector into indexes of 1-bits (bvsample05)."""
    bv = bm.BitVector.from_indices([10, 20, 30, 65536], size=1 << 18)
    en = bv.get_enumerator(0)
    seen = []
    while en != bv.end():
        seen.append(int(en.value()))
        en.go_up()
    assert seen == [10, 20, 30, 65536]


def bvsample06():
    """Allocator/residency example (bvsample06): where the memory lives.
    Device HBM holds one dense pool; optimize() moves GAP-able blocks to
    the host-side succinct store so sparse vectors cost ~nothing in HBM."""
    bv = bm.BitVector(100_000_000)
    for i in range(0, 100_000_000, 1_000_000):
        bv.set(i)
    bv.optimize()
    st = bv.calc_stat()
    assert st["bit_blocks"] == 0              # nothing dense left
    assert st["gap_blocks"] > 0


def bvsample07():
    """Logical operations between plain arrays and bit-vectors
    (bvsample07 combine_and/combine_or)."""
    bv = bm.BitVector.from_indices([1, 5, 9], size=1000)
    bm.combine_or(bv, np.asarray([2, 5, 800]))
    assert sorted(bv.indices().tolist()) == [1, 2, 5, 9, 800]
    bm.combine_and(bv, np.asarray([5, 800]))
    assert sorted(bv.indices().tolist()) == [5, 800]


def bvsample08():
    """Python-native (STL-style) interoperability (bvsample08)."""
    ids = {3, 700, 65537}
    bv = bm.BitVector.from_indices(sorted(ids), size=1 << 18)
    assert set(bv.indices().tolist()) == ids          # container -> set
    assert set(iter(bv.get_enumerator(0))) == ids      # iterator protocol


def bvsample09():
    """Binary distance metrics in one batch pass (bvsample09)."""
    a = bm.BitVector.from_indices([1, 2, 3, 10], size=1000)
    b = bm.BitVector.from_indices([2, 3, 4], size=1000)
    res = bm.distance_operation(a, b, ["count_and", "count_or", "count_xor"])
    assert res == {"count_and": 2, "count_or": 5, "count_xor": 3}


def bvsample10():
    """Random subset extraction for Monte Carlo (bvsample10)."""
    bv = bm.BitVector.from_indices(list(range(0, 20000, 7)), size=1 << 16)
    sub = bm.random_subset(bv, 100, seed=7)
    assert sub.count() == 100
    assert (sub & bv).equal(sub)              # strictly a subset


def bvsample11():
    """Range population counts: count_range/count_to/count_and
    (bvsample11)."""
    bv = bm.BitVector.from_indices([0, 10, 20, 65536, 65600], size=1 << 18)
    bv.build_rs_index()
    assert bv.count_range(10, 20) == 2
    assert bv.count_to(65536) == 4
    other = bm.BitVector.from_indices([20, 65600], size=1 << 18)
    assert bm.count_and(bv, other) == 2


def bvsample12():
    """The ways to set and clear bits, compared (bvsample12)."""
    n = 1 << 18
    a = bm.BitVector(n)
    for i in range(0, 1000, 3):
        a.set(i)                              # single-bit staged writes
    b = bm.BitVector.from_indices(list(range(0, 1000, 3)), size=n)
    c = bm.BitVector(n)
    c.set_range(0, 999)                       # range fill + mask down
    c &= b
    d = bm.BitVector(n)
    d.set_many(np.arange(0, 1000, 3))         # bulk numpy import
    assert a.equal(b) and b.equal(c) and c.equal(d)


def bvsample14():
    """Logical operations directly on compressed BLOBs (bvsample14)."""
    a = bm.BitVector.from_indices([1, 100, 65636], size=1 << 18)
    b = bm.BitVector.from_indices([100, 5000], size=1 << 18)
    from bitmagic_tpu_torch import constants as C
    blob = bm.serialize(b)
    od = bm.OperationDeserializer()
    cnt = od.deserialize(a.copy(), blob, op=C.SET_COUNT_AND)
    assert cnt == 1
    t = a.copy()
    od.deserialize(t, blob, op=C.SET_OR)
    assert t.equal(a | b)


def bvsample15():
    """find / find_reverse / dynamic range detection (bvsample15)."""
    bv = bm.BitVector.from_indices([30, 700, 65538], size=1 << 18)
    assert bv.find(0) == 30                   # -1 when not found
    assert bv.find_reverse() == 65538
    assert bv.find_range() == (30, 65538)
    assert bm.BitVector(100).find() == -1


def bvsample16():
    """Aggregator: fused group logic (bvsample16)."""
    vs = [bm.BitVector.from_indices([1, 2, 3, k], size=1000)
          for k in (10, 11, 12)]
    agg = bm.Aggregator()
    res = agg.combine_and(vs)
    assert sorted(res.indices().tolist()) == [1, 2, 3]
    sub = bm.BitVector.from_indices([3, 12], size=1000)
    res2 = agg.combine_and_sub(vs[:2], [sub])
    assert sorted(res2.indices().tolist()) == [1, 2]


def bvsample17():
    """Rank-select with rs_index (bvsample17)."""
    bv = bm.BitVector.from_indices([5, 15, 25, 65535, 70000], size=1 << 18)
    bv.build_rs_index()
    assert bv.rank(25) == 3
    assert bv.select(4) == 65535              # 1-based, like the reference
    assert bv.find_rank(2, 6) == 25           # 2nd set bit at/after 6


def bvsample18():
    """Bulk construction (reference bulk_insert_iterator) (bvsample18)."""
    ids = np.asarray(sorted({int(x) for x in
                             np.random.default_rng(0).integers(0, 1 << 20,
                                                               5000)}))
    bv = bm.BitVector(1 << 21)
    it = bv.get_bulk_insert_iterator()
    for i in ids:
        it.add(int(i))                        # staged, flushed in bulk
    it.flush()
    assert bv.count() == ids.size


def bvsample18a():
    """Import from an external bit-stream (bmbvimport.h) (bvsample18a)."""
    words = np.zeros(64, np.uint32)
    words[0] = 0b1011
    words[63] = 1 << 31
    bv = bm.BitVector.from_words(words, size=64 * 32)
    assert sorted(bv.indices().tolist()) == [0, 1, 3, 64 * 32 - 1]


def bvsample19():
    """merge() — absorbing union for partitioned processing
    (bvsample19)."""
    a = bm.BitVector.from_indices([1, 2], size=1000)
    b = bm.BitVector.from_indices([2, 900], size=1000)
    a.merge(b)                                # may consume b's blocks
    assert sorted(a.indices().tolist()) == [1, 2, 900]


def bvsample20():
    """shift_right / insert (bvsample20)."""
    bv = bm.BitVector.from_indices([0, 10], size=1000)
    bv.shift_right()
    assert sorted(bv.indices().tolist()) == [1, 11]
    bv.insert(0, True)
    assert sorted(bv.indices().tolist()) == [0, 2, 12]


def bvsample21():
    """shift_left / erase (bvsample21)."""
    bv = bm.BitVector.from_indices([0, 10], size=1000)
    bv.shift_left()
    assert sorted(bv.indices().tolist()) == [9]
    bv.erase(4)
    assert sorted(bv.indices().tolist()) == [8]


def bvsample22():
    """Interval algorithms (bmintervals.h) (bvsample22)."""
    from bitmagic_tpu_torch.algo.intervals import (find_interval_start,
                                             find_interval_end)
    bv = bm.BitVector(1000)
    bv.set_range(10, 20)
    bv.set_range(100, 110)
    assert bm.is_interval(bv, 10, 20)
    assert find_interval_start(bv, 15) == 10
    assert find_interval_end(bv, 15) == 20
    # runs of EITHER value: 0s,1s,0s,1s,0s (reference count_intervals)
    assert bm.count_intervals(bv) == 5


def bvsample23():
    """interval_enumerator: traverse the vector as [lo, hi] runs
    (bvsample23)."""
    bv = bm.BitVector(1000)
    bv.set_range(10, 20)
    bv.set_range(100, 110)
    runs = [(lo, hi) for lo, hi in bm.interval_enumerator(bv)]
    assert runs == [(10, 20), (100, 110)]


def bvsample24():
    """rank_range_split: equal-weight partitioning (bvsample24)."""
    bv = bm.BitVector.from_indices(list(range(0, 4000, 4)), size=1 << 13)
    bv.build_rs_index()
    pairs = bm.rank_range_split(bv, 250)
    assert len(pairs) == 4
    total = sum(bv.count_range(lo, hi) for lo, hi in pairs)
    assert total == bv.count()


def bvsample25():
    """visit_each_bit / for_each_bit traversal callbacks (bvsample25)."""
    bv = bm.BitVector.from_indices([2, 300, 70000], size=1 << 18)
    seen = []
    bm.visit_each_bit(bv, seen.append)
    assert seen == [2, 300, 70000]
    seen_r = []
    bm.visit_each_bit_range(bv, 100, 1000, seen_r.append)
    assert seen_r == [300]


def bvsample26():
    """Immutable (read-only) vectors: freeze() (bvsample26)."""
    bv = bm.BitVector.from_indices([1, 2, 3], size=1000)
    bv.optimize()
    bv.freeze()
    assert bv.is_ro()
    try:
        bv.set(9)
        raise AssertionError("write to frozen vector must raise")
    except bm.ReadOnlyError:
        pass
    assert bv.count() == 3                    # reads unaffected


def bvsample01_64():
    """48-bit address space basics (bvsample01_64)."""
    bv = bm.BitVector(1 << 48)
    bv.set((1 << 47) + 12345)
    bv.set_range(1 << 40, (1 << 40) + (1 << 24) - 1)
    assert bv.count() == (1 << 24) + 1
    assert bv.find_reverse() == (1 << 47) + 12345


def main():
    fns = [v for k, v in sorted(globals().items())
           if k.startswith("bvsample") and callable(v)]
    for fn in fns:
        fn()
        print(f"{fn.__name__}: ok")
    print(f"bvsample walk: {len(fns)} programs ok")


if __name__ == "__main__":
    main()
