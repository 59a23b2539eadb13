"""The scanner's ordered and sorted searches in the PyTorch port against the
JAX package, on the CPU: find_gt/ge/lt/le/range/nonnegative (the slice
descent, K1's plain version for every step), the signed split at the
``iinfo`` edges of int8 to int64, uint64's top planes, the AND mask and
search range composed with the ordered searches, and bind + lower_bound /
bfind_eq.  Results keep the JAX package's plane state (``interop``) and
equal numpy.  Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.sv.scanner import SparseVectorScanner as JScanner
from bitmagic_tpu.sv.scanner import scanner as jsc
from bitmagic_tpu_torch import constants as C
from test_torch_scanner import assert_same_bits, assert_same_bv, pair

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
N = 70_000
tsc = tbm.scanner
ORDERED = ("find_gt", "find_ge", "find_lt", "find_le")
NP_OPS = {"find_gt": np.greater, "find_ge": np.greater_equal,
          "find_lt": np.less, "find_le": np.less_equal}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


@pytest.fixture(scope="module")
def svs():
    rng = np.random.default_rng(21)
    vals = rng.integers(0, 1 << 12, N).astype(np.uint32)
    nulls = rng.random(N) < 0.2
    signed = rng.integers(-3000, 3000, N).astype(np.int32)
    return {
        "u32": (vals, None) + pair(vals),
        "null": (vals, nulls) + pair(vals, nullable=True, null_mask=nulls),
        "i32": (signed, None) + pair(signed),
        "i32null": (signed, nulls) + pair(signed, nullable=True,
                                          null_mask=nulls),
    }


def _want(vals, nulls, name, q):
    ok = np.ones(vals.size, bool) if nulls is None else ~nulls
    return np.flatnonzero(NP_OPS[name](vals.astype(object), q) & ok)


@pytest.mark.parametrize("kind,probes", [
    ("u32", [0, 1, 2048, 4095, 4096, 1234, -1, 1 << 33]),
    ("null", [0, 17, 4095, 2**32 - 1]),
    ("i32", [-3001, -3000, -1, 0, 1, 2999, 77, -2**31]),
    ("i32null", [-1, 0, 100, 2**31 - 1])])
def test_ordered_family(svs, kind, probes):
    vals, nulls, j, t = svs[kind]
    for q in probes:
        for name in ORDERED:
            want = getattr(jsc, name)(j, q)
            got = getattr(tsc, name)(t, q)
            assert_same_bv(want, got)
            ids = got.indices()
            np.testing.assert_array_equal(ids[ids < N],
                                          _want(vals, nulls, name, q))


@pytest.mark.parametrize("kind,lo,hi", [("u32", 100, 3000),
                                        ("u32", 3000, 100),
                                        ("null", 0, 0),
                                        ("i32", -2500, 12),
                                        ("i32null", -1, 1)])
def test_find_range(svs, kind, lo, hi):
    vals, nulls, j, t = svs[kind]
    want = jsc.find_range(j, lo, hi)
    got = tsc.find_range(t, lo, hi)
    assert_same_bv(want, got)
    ok = np.ones(N, bool) if nulls is None else ~nulls
    np.testing.assert_array_equal(
        got.indices(), np.flatnonzero((vals >= lo) & (vals <= hi) & ok))


@pytest.mark.parametrize("kind", ["u32", "null", "i32", "i32null"])
def test_find_nonnegative(svs, kind):
    vals, nulls, j, t = svs[kind]
    got = tsc.find_nonnegative(t)
    assert_same_bv(jsc.find_nonnegative(j), got)
    # NULLs read 0 and count as non-negative (reference
    # find_nonnegative_no_mask does not null-correct)
    live = vals if nulls is None else np.where(nulls, 0, vals)
    np.testing.assert_array_equal(got.indices(), np.flatnonzero(live >= 0))


def _edge_values(dt):
    info = np.iinfo(dt)
    return np.array([info.min, info.min + 1, info.min // 2, 7, 0, 1,
                     info.max - 1, info.max, info.min, 3, info.max // 3],
                    dtype=dt)


@pytest.mark.parametrize("dt", [np.int8, np.int16, np.int32, np.int64,
                                np.uint8, np.uint16, np.uint64])
def test_edges(dt):
    """Every ordered search at the dtype's edges (the s2u split for signed
    types, all 64 planes for uint64), out-of-dtype queries included."""
    info = np.iinfo(dt)
    vals = np.concatenate([_edge_values(dt),
                           np.random.default_rng(5).integers(
                               info.min, info.max, 3000, dtype=dt,
                               endpoint=True)])
    j, t = pair(vals)
    v64 = vals.astype(object)
    queries = [info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max,
               int(info.min) - 1, int(info.max) + 1, -(1 << 70), 1 << 70,
               int(vals[20])]
    for q in queries:
        for name in ORDERED:
            want = getattr(jsc, name)(j, q)
            got = getattr(tsc, name)(t, q)
            assert_same_bits(want, got)
            np.testing.assert_array_equal(
                got.indices(), np.flatnonzero(NP_OPS[name](v64, q)),
                err_msg=f"{dt.__name__} {name} {q}")
    for lo, hi in [(info.min, info.min), (info.min, -1), (-1, 1),
                   (info.min, info.max), (0, info.max)]:
        got = tsc.find_range(t, lo, hi)
        assert_same_bits(jsc.find_range(j, lo, hi), got)
        np.testing.assert_array_equal(
            got.indices(), np.flatnonzero((v64 >= lo) & (v64 <= hi)))


def test_mask_and_range_compose(svs):
    vals, nulls, j, t = svs["i32null"]
    ids = np.arange(0, N, 3)
    jm = jbm.BitVector.from_indices(ids, C.ID_MAX48)
    tm = tbm.BitVector.from_indices(ids, C.ID_MAX48)
    js, ts = JScanner(), tbm.SparseVectorScanner()
    js.set_and_mask(jm)
    ts.set_and_mask(tm)
    js.set_search_range(BPB - 100, N - 7)
    ts.set_search_range(N - 7, BPB - 100)
    sel = np.zeros(N, bool)
    sel[ids] = True
    sel[:BPB - 100] = sel[N - 6:] = False
    for q in (-100, 0, 55):
        for name in ORDERED:
            got = getattr(ts, name)(t, q)
            assert_same_bits(getattr(js, name)(j, q), got)
            np.testing.assert_array_equal(
                got.indices(),
                np.flatnonzero(NP_OPS[name](vals, q) & ~nulls & sel))
    got = ts.find_range(t, -100, 100)
    assert_same_bits(js.find_range(j, -100, 100), got)
    assert_same_bits(js.find_nonnegative(j), ts.find_nonnegative(t))
    ts.reset_and_mask()
    ts.reset_search_range()
    assert_same_bits(jsc.find_gt(j, 5), ts.find_gt(t, 5))


@pytest.mark.parametrize("dtype", [np.uint32, np.int64])
def test_bind_lower_bound_bfind(dtype):
    rng = np.random.default_rng(31)
    vals = np.sort(rng.integers(-5000 if dtype == np.int64 else 0, 60_000,
                                5000)).astype(dtype)
    j, t = pair(vals)
    probes = [int(vals[0]) - 1, int(vals[0]), int(vals[-1]),
              int(vals[-1]) + 1, int(vals[2500]), int(vals[255]),
              int(vals[256])] + [int(x) for x in rng.integers(-6000, 61_000,
                                                                30)]
    unbound = [tsc.lower_bound(t, q) for q in probes]
    ts, js = tbm.SparseVectorScanner(), JScanner()
    ts.bind(t)
    js.bind(j)
    assert ts._bound[2].tolist() == js._bound[2].tolist()
    for q, u in zip(probes, unbound):
        want = int(np.searchsorted(vals, q, side="left"))
        assert ts.lower_bound(t, q) == js.lower_bound(j, q) == u == want
        hit = want if want < vals.size and vals[want] == q else -1
        assert ts.bfind_eq(t, q) == js.bfind_eq(j, q) == hit
        assert ts.bfind(t, q) == hit
    ts.reset_binding()
    assert ts._bound is None
    ts.bind(t, sorted=False)
    assert ts._bound is None and ts.lower_bound(t, probes[4]) == unbound[4]


def test_bind_sorted_str():
    rng = np.random.default_rng(33)
    words = sorted({f"k{int(x):06d}" for x in rng.integers(0, 10**6, 900)})
    words = [""] + words
    jssv = jbm.StrSparseVector.from_strings(words)
    tssv = tbm.StrSparseVector.from_strings(words)
    probes = ["", "a", words[1], words[300], words[300] + "0", words[-1],
              "z", words[256], words[257][:4]]
    unbound = [tsc.lower_bound_str(tssv, p) for p in probes]
    ts, js = tbm.SparseVectorScanner(), JScanner()
    ts.bind(tssv)
    js.bind(jssv)
    import bisect
    for p, u in zip(probes, unbound):
        want = bisect.bisect_left(words, p)
        assert ts.lower_bound_str(tssv, p) == js.lower_bound_str(jssv, p) \
            == u == want
        hit = want if want < len(words) and words[want] == p else -1
        assert ts.bfind_eq_str(tssv, p) == js.bfind_eq_str(jssv, p) == hit
        assert ts.bfind_eq_str(tssv, p.encode()) == hit
