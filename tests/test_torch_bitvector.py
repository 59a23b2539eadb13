"""BitVector of the PyTorch port against the JAX package, on the CPU.

The same API calls on the same numpy-seeded inputs go to both packages;
the resulting states (``nb``, ``cls``, FULL runs, dense rows, GAP arrays,
read through ``interop``) and every answer must be identical.  Covers both
``from_indices`` strategies, FULL runs from ``set_range``, ``optimize``,
the four ops through all three ``_binary`` routes (GAP identity, GAP x GAP
host merge, device kernel), counts, ranges, finds and 48-bit addresses.
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
SIZE = 80 * BPB
OPS = {"and": "__and__", "or": "__or__", "xor": "__xor__", "sub": "__sub__"}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def jax_parts(bv):
    bv._flush()
    g = bv._gaps
    return {
        "size": bv.size, "nb": bv._struct.nb, "cls": bv._struct.cls,
        "runs": bv._struct.runs, "pool_u32": np.asarray(bv._pool_host()),
        "gap_ends": g.ends if g is not None else np.zeros(0, np.int64),
        "gap_offs": g.offs if g is not None else np.zeros(1, np.int64),
        "gap_first": g.first if g is not None else np.zeros(0, np.uint8),
    }


def assert_same_state(jv, tv):
    want, got = jax_parts(jv), interop.bitvector_to_parts(tv)
    assert set(got) == set(interop.PARTS)
    for key in interop.PARTS:
        np.testing.assert_array_equal(
            np.asarray(got[key]), np.asarray(want[key]).reshape(
                np.shape(got[key])), err_msg=key)
    assert tv.count() == jv.count()


def _clustered(rng, blk0, blk1, runs_per_block=6):
    out = []
    for blk in range(blk0, blk1):
        starts = np.sort(rng.choice(BPB - 300, runs_per_block,
                                    replace=False))
        for s in starts:
            out.append(blk * BPB + s + np.arange(rng.integers(1, 200)))
    return np.concatenate(out)


def build_pair(pkg, seed=7):
    """Two vectors mixing BIT, GAP, FULL-run and FULL blocks so that every
    op takes all three _binary routes (same calls for either package)."""
    rng = np.random.default_rng(seed)
    BV = pkg.BitVector
    a = BV.from_indices(rng.integers(0, 10 * BPB, 40000), SIZE)
    a |= BV.from_indices(_clustered(rng, 10, 20), SIZE,
                         strategy=C.BM_GAP)
    a.set_range(20 * BPB, 60 * BPB - 1)                  # FULL run
    a.set_range(61 * BPB + 5, 61 * BPB + 1000)           # partial BIT row
    a.optimize()
    b = BV.from_indices(rng.integers(5 * BPB, 15 * BPB, 40000), SIZE)
    b |= BV.from_indices(_clustered(rng, 15, 25), SIZE, strategy=C.BM_GAP)
    b.set_range(50 * BPB, 70 * BPB - 1)                  # FULL points
    b.set(75 * BPB + 3)
    b.clear_bit(6 * BPB + 1)
    return a, b


@pytest.fixture(scope="module")
def pairs():
    import bitmagic_tpu_torch
    old = bitmagic_tpu_torch.config.device
    bitmagic_tpu_torch.config.device = "cpu"
    try:
        return build_pair(jbm), build_pair(tbm)
    finally:
        bitmagic_tpu_torch.config.device = old


def test_built_states_match(pairs):
    (ja, jb), (ta, tb) = pairs
    assert_same_state(ja, ta)
    assert_same_state(jb, tb)
    # the mix is what the op tests rely on
    for v in (ta, tb):
        assert set(np.unique(v._struct.cls)) >= {C.CLS_BIT, C.CLS_GAP}
    assert ta._struct.has_runs


@pytest.mark.parametrize("op", list(OPS))
def test_binary_ops_all_routes(pairs, op):
    (ja, jb), (ta, tb) = pairs
    jr = getattr(ja, OPS[op])(jb)
    tr = getattr(ta, OPS[op])(tb)
    assert_same_state(jr, tr)
    np.testing.assert_array_equal(tr.indices(), jr.indices())
    jr2 = getattr(jb, OPS[op])(ja)
    tr2 = getattr(tb, OPS[op])(ta)
    assert_same_state(jr2, tr2)


def test_binary_routes_taken(pairs, monkeypatch):
    """All three routes run: GAP pass-through, host GAP x GAP merge and the
    device kernel."""
    from bitmagic_tpu_torch.core import bitvector as tbv
    (_, _), (ta, tb) = pairs
    seen = {"merge": 0, "kernel": 0}
    merge, kern = tbv.gap_binary_op, tbv.ck.binary_op_digest

    def _merge(*a, **k):
        seen["merge"] += 1
        return merge(*a, **k)

    def _kern(*a, **k):
        seen["kernel"] += 1
        return kern(*a, **k)

    monkeypatch.setattr(tbv, "gap_binary_op", _merge)
    monkeypatch.setattr(tbv.ck, "binary_op_digest", _kern)
    r = ta ^ tb
    assert seen == {"merge": 1, "kernel": 1}
    # pass-through: b's GAP blocks under a's FULL run come out complemented
    gap_nb = r._struct.nb[r._struct.cls == C.CLS_GAP]
    assert ((gap_nb >= 20) & (gap_nb < 25)).any()


def test_inplace_and_three_operand_forms(pairs):
    (ja, jb), (ta, tb) = pairs
    for op in ("and", "or", "xor", "sub"):
        jc, tc = ja.copy(), ta.copy()
        getattr(jc, f"bit_{op}")(jb)
        getattr(tc, f"bit_{op}")(tb)
        assert_same_state(jc, tc)
        jd = getattr(jbm.BitVector(SIZE), f"bit_{op}")(ja, jb,
                                                      C.OPT_COMPRESS)
        td = getattr(tbm.BitVector(SIZE), f"bit_{op}")(ta, tb,
                                                      C.OPT_COMPRESS)
        assert_same_state(jd, td)
    assert ta.equal(ta.copy()) and not ta.equal(tb)
    assert (ta == ta.copy()) and not (ta == tb)


@pytest.mark.parametrize("strategy", [None, C.BM_BIT, C.BM_GAP])
def test_from_indices_strategies(rng, strategy):
    ids = np.concatenate([rng.integers(0, 3 * BPB, 500),
                          np.arange(4 * BPB, 5 * BPB),           # FULL
                          np.arange(6 * BPB + 7, 6 * BPB + 9000),
                          rng.integers(7 * BPB, 8 * BPB, 6000)])  # dense
    jv = jbm.BitVector.from_indices(ids, 9 * BPB, strategy=strategy)
    tv = tbm.BitVector.from_indices(ids, 9 * BPB, strategy=strategy)
    assert_same_state(jv, tv)
    assert tv.strategy == jv.strategy
    np.testing.assert_array_equal(tv.indices(), np.unique(ids))
    with pytest.raises(IndexError):
        tbm.BitVector.from_indices([9 * BPB], 9 * BPB)


def test_from_words_bools_and_export(rng):
    words = rng.integers(0, 2**32, 3 * 2048 + 100,
                         dtype=np.uint64).astype(np.uint32)
    words[2048:4096] = 0xFFFFFFFF
    size = words.size * 32 - 5
    jv = jbm.BitVector.from_words(words, size)
    tv = tbm.BitVector.from_words(words, size)
    assert_same_state(jv, tv)
    np.testing.assert_array_equal(tv.to_words(), jv.to_words())
    np.testing.assert_array_equal(tv.to_numpy(), jv.to_numpy())
    np.testing.assert_array_equal(tv.to_numpy(70000), jv.to_numpy(70000))
    jv.optimize()
    tv.optimize()
    assert_same_state(jv, tv)
    np.testing.assert_array_equal(tv.to_words(), jv.to_words())
    np.testing.assert_array_equal(tv.count_blocks(), jv.count_blocks())
    bools = rng.random(3 * BPB) < 0.01
    assert_same_state(jbm.BitVector.from_bools(bools),
                      tbm.BitVector.from_bools(bools))


def test_set_range_optimize_and_clear(rng):
    def run(pkg):
        v = pkg.BitVector(SIZE)
        v.set_range(3, 45 * BPB + 17)                 # edges + FULL run
        v.set_range(50 * BPB, 51 * BPB - 1)           # one FULL block
        for i in (60 * BPB + 1, 60 * BPB + 2, 61 * BPB):
            v.set(i)
        v.clear_range(10 * BPB + 5, 12 * BPB + 6)     # splits the run
        v.clear_bit(3)
        v.optimize()
        w = v.copy()
        w.set_range(0, 70 * BPB - 1)
        w.optimize(C.OPT_FREE_01)
        return v, w

    (jv, jw), (tv, tw) = run(jbm), run(tbm)
    assert_same_state(jv, tv)
    assert_same_state(jw, tw)
    assert tv._struct.has_runs


def test_queries_match(pairs, rng):
    (ja, jb), (ta, tb) = pairs
    for jv, tv in ((ja, ta), (jb, tb)):
        lo = rng.integers(0, SIZE, 40)
        hi = lo + rng.integers(0, 30 * BPB, 40)
        for a, b in zip(lo, hi):
            assert tv.count_range(a, b) == jv.count_range(a, b)
            assert tv.any_range(a, b) == jv.any_range(a, b)
        probe = rng.integers(0, SIZE, 300)
        np.testing.assert_array_equal(tv.get_bits(probe), jv.get_bits(probe))
        for i in probe[:40]:
            assert tv.test(i) == jv.test(i)
            assert tv.count_to(i) == jv.count_to(i)
            assert tv.rank(i) == jv.rank(i)
            assert tv.find(i) == jv.find(i)
            assert tv.find_reverse(i) == jv.find_reverse(i)
        assert tv.find() == jv.find()
        assert tv.find_reverse() == jv.find_reverse()
        assert tv.any() == jv.any() and tv.none() == jv.none()
        np.testing.assert_array_equal(tv.count_blocks(), jv.count_blocks())
        np.testing.assert_array_equal(tv.to_words(), jv.to_words())


def test_staged_mutations_flush(rng):
    def run(pkg):
        v = pkg.BitVector.from_indices(rng_ids, SIZE)
        for i in set_ids:
            v[int(i)] = True
        for i in clr_ids:
            v.clear_bit(int(i))
        got = [v.test(int(i)) for i in set_ids[:5]]   # answered from staging
        return v, got

    rng_ids = rng.integers(0, 6 * BPB, 2000)
    set_ids = rng.integers(0, SIZE, 50)
    clr_ids = rng_ids[:30]
    (jv, jg), (tv, tg) = run(jbm), run(tbm)
    assert tg == jg
    assert_same_state(jv, tv)
    with pytest.raises(IndexError):
        tv.set(SIZE)


TOP = C.ID_MAX48
B32 = 1 << 32
BORDER_IDS = np.asarray(sorted({
    0, 1, 65535, 65536,
    B32 - 65537, B32 - 65536, B32 - 1, B32, B32 + 1, B32 + 65536,
    (1 << 40) + 21824, (1 << 40) + 43648,
    TOP - 65537, TOP - 65536, TOP - 2, TOP - 1,
}), np.int64)


def test_48bit_borders():
    jv = jbm.BitVector.from_indices(BORDER_IDS, TOP)
    tv = tbm.BitVector.from_indices(BORDER_IDS, TOP)
    assert_same_state(jv, tv)
    np.testing.assert_array_equal(tv.indices(), BORDER_IDS)
    for i in BORDER_IDS:
        assert tv.test(int(i))
        assert tv.count_to(int(i)) == jv.count_to(int(i))
        assert tv.find(int(i) + 1) == jv.find(int(i) + 1)
        assert tv.find_reverse(int(i) - 1) == jv.find_reverse(int(i) - 1)
    assert tv.count_range(B32 - 65536, TOP - 2) == jv.count_range(
        B32 - 65536, TOP - 2)
    # a FULL run high in the 48-bit space, combined with the borders
    jw, tw = jbm.BitVector(TOP), tbm.BitVector(TOP)
    jw.set_range(B32 - 100, B32 + 40 * BPB)
    tw.set_range(B32 - 100, B32 + 40 * BPB)
    assert_same_state(jw, tw)
    for op in OPS.values():
        assert_same_state(getattr(jv, op)(jw), getattr(tv, op)(tw))
    ranks = np.arange(1, len(BORDER_IDS) + 1)
    np.testing.assert_array_equal(tv.build_rs_index().select_batch(ranks),
                                  BORDER_IDS)


def test_interop_round_trip(pairs):
    """The JAX vector's state fed into the port gives the same ops."""
    (ja, jb), _ = pairs
    ta = interop.bitvector_from_parts(**jax_parts(ja))
    tb = interop.bitvector_from_parts(**jax_parts(jb), device="cpu")
    assert_same_state(ja, ta)
    for op in OPS.values():
        assert_same_state(getattr(ja, op)(jb), getattr(ta, op)(tb))
    back = interop.bitvector_from_parts(**interop.bitvector_to_parts(ta))
    assert_same_state(ja, back)


def test_slice_main_path(pairs, rng):
    """The slice end to end at a small size: ops, counts, distance metrics,
    range counts, rank and select, against the JAX package."""
    (ja, jb), (ta, tb) = pairs
    for op in OPS.values():
        assert getattr(ta, op)(tb).count() == getattr(ja, op)(jb).count()
    metrics = ["count_and", "count_xor", "count_or", "count_sub_ab",
               "count_sub_ba", "count_a", "count_b"]
    assert tbm.distance_operation(ta, tb, metrics) == \
        jbm.distance_operation(ja, jb, metrics)
    for name in ("count_and", "count_or", "count_xor", "count_sub",
                 "any_and", "any_or", "any_xor", "any_sub"):
        assert getattr(tbm, name)(ta, tb) == getattr(jbm, name)(ja, jb)
    jr, tr = ja.build_rs_index(), ta.build_rs_index()
    ranks = rng.integers(0, tr.count() + 3, 500)
    np.testing.assert_array_equal(tr.select_batch(ranks),
                                  jr.select_batch(ranks))
    ids = rng.integers(0, SIZE, 500)
    np.testing.assert_array_equal(tr.rank_batch(ids), jr.rank_batch(ids))


@pytest.mark.parametrize("ids", [[], [7], [5, 5, 5], [3, 70000, 3, 1 << 40,
                                                      65535, 65536, 70000]])
def test_id_helpers_match_numpy_unique(ids):
    from bitmagic_tpu_torch.core import bitvector as tbv
    got = tbv._unique_ids(ids)
    want = np.unique(np.asarray(ids, np.int64))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    ub, inv = tbv._block_index(got)
    want_ub, want_inv = np.unique(want >> 16, return_inverse=True)
    np.testing.assert_array_equal(ub, want_ub)
    np.testing.assert_array_equal(inv, want_inv)


# ---------------------------------------------------------------------------
# the BitVector methods the search path calls (resize, clear, invert,
# keep_range, shift_right, set_many/clear_many, freeze/is_ro, _flat_nb)
# ---------------------------------------------------------------------------
def _mutate(v, how):
    if how == "invert":
        v.invert()
    elif how == "keep_range":
        v.keep_range(70 * BPB + 9, 12 * BPB - 5)          # swapped bounds
    elif how == "shift_right":
        v.shift_right()
        v.shift_right()
    elif how == "resize":
        v.resize(30 * BPB + 77)
        v.resize(SIZE)
    elif how == "set_clear_many":
        v.set_many(np.arange(3, 40 * BPB, 997))
        v.clear_many(np.arange(5, 30 * BPB, 13))
    elif how == "clear":
        v.clear()
    return v


@pytest.mark.parametrize("how", ["invert", "keep_range", "shift_right",
                                 "resize", "set_clear_many", "clear"])
def test_search_path_methods(pairs, how):
    for j, t in zip(*pairs):
        jr, tr = _mutate(j.copy(), how), _mutate(t.copy(), how)
        assert_same_state(jr, tr)
        np.testing.assert_array_equal(tr._flat_nb(), jr._flat_nb())
    inv = ~pairs[1][0]
    assert inv.count() == SIZE - pairs[1][0].count()


def test_freeze_guards_writes():
    v = tbm.BitVector.from_indices([1, 70000], 1 << 20, device="cpu")
    assert not v.is_ro()
    v.freeze()
    assert v.is_ro()
    from bitmagic_tpu_torch.core.bitvector import ReadOnlyError
    for call in (lambda: v.set(3), lambda: v.set_range(0, 9),
                 lambda: v.resize(10), lambda: v.invert(),
                 lambda: v.shift_right(), lambda: v.keep_range(0, 5),
                 lambda: v.clear(), lambda: v.set_many([4]),
                 lambda: v.bit_or(v), lambda: v.optimize()):
        with pytest.raises(ReadOnlyError):
            call()
    assert v.count() == 2 and not v.copy().is_ro()
