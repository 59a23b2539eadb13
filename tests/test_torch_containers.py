"""The string, float and RSC vectors of the PyTorch port, their searches
and the string pipeline, against the JAX package on the CPU (the shapes of
``tests/test_containers.py`` and ``tests/test_scanner_extras.py``, without
the sharded cases).

Both packages build each container from the same numpy values; the port's
state (octet planes, remap matrices, sign / exponent / mantissa planes, the
RSC payload and NULL index, read through ``interop``), every position set,
count and decoded value must equal the JAX package's.  Containers built in
the JAX package are also carried across through ``interop``'s
``*_from_parts`` and searched in the port.  The JAX string pipeline runs
with ``use_pallas`` on (interpret mode) and through its plain route.
Tolerance: exact equality (float values compared bit for bit).
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.config import config as jconfig
from bitmagic_tpu.sv.scanner import SparseVectorScanner as JScanner
from bitmagic_tpu.sv.scanner import scanner as jsc
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from test_torch_scanner import (assert_same_bits, assert_same_bv,
                                assert_same_sv, jax_parts, jax_sv_parts)

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
tsc = tbm.scanner


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def jax_str_parts(ssv):
    return {"max_str_size": ssv.max_str_size, "nullable": ssv.nullable,
            "size": ssv._size,
            "octets": [jax_sv_parts(o) for o in ssv.octets],
            "remap_matrices": ssv.remap_matrices,
            "unmap_matrices": ssv.unmap_matrices,
            "null_plane": jax_parts(ssv.null_plane) if ssv.nullable else None}


def jax_float_parts(fv):
    return {"dtype": fv.dtype.str, "nullable": fv.nullable, "size": fv._size,
            "sign": jax_parts(fv.sign), "exponent": jax_sv_parts(fv.exponent),
            "mantissa": jax_sv_parts(fv.mantissa),
            "null_plane": jax_parts(fv.null_plane) if fv.nullable else None}


def jax_rsc_parts(rsc):
    rsc._flush()
    return {"dtype": rsc.dtype.str, "size": rsc._size,
            "dense": jax_sv_parts(rsc.dense), "null_bv": jax_parts(rsc.null_bv)}


def assert_same_str(j, t):
    assert (t.max_str_size, t.nullable, t._size) == \
        (j.max_str_size, j.nullable, j._size)
    for jo, to in zip(j.octets, t.octets, strict=True):
        assert_same_sv(jo, to)
    for name in ("remap_matrices", "unmap_matrices"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
    if j.nullable:
        assert_same_bv(j.null_plane, t.null_plane)


def assert_same_float(j, t):
    assert (t.dtype, t.nullable, t._size) == (j.dtype, j.nullable, j._size)
    assert_same_bv(j.sign, t.sign)
    assert_same_sv(j.exponent, t.exponent)
    assert_same_sv(j.mantissa, t.mantissa)
    if j.nullable:
        assert_same_bv(j.null_plane, t.null_plane)


def assert_same_rsc(j, t):
    j._flush()
    t._flush()
    assert (t.dtype, t._size) == (j.dtype, j._size)
    assert_same_sv(j.dense, t.dense)
    assert_same_bv(j.null_bv, t.null_bv)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------
WORDS = ["alpha", "alp", "alpine", "beta", "al", "gamma", "alphas",
         "", "alpaca", "b", "alpha", "\xe9t\xe9"]


def _catalog(n, seed=16):
    rng = np.random.default_rng(seed)
    return sorted({f"NGC {int(x):07d}" for x in rng.integers(0, 10**7, n)})


def str_pair(words, **kw):
    return (jbm.StrSparseVector.from_strings(words, **kw),
            tbm.StrSparseVector.from_strings(words, **kw))


@pytest.mark.parametrize("remap", [False, True])
def test_str_build_decode(remap):
    words = WORDS * 3 + [None, "x" * 8]
    j, t = str_pair(words, max_str_size=9)
    if remap:
        j.remap()
        t.remap()
    assert_same_str(j, t)
    # strings are stored as UTF-8 and read back as latin-1 in both packages
    assert t.to_list() == j.to_list()
    assert [w for w in t.to_list() if w is None or w.isascii()] == \
        [w for w in words if w is None or w.isascii()]
    ids = [3, 0, 37, 36, 11]
    assert t.gather(ids) == j.gather(ids)
    assert t.gather_substr(ids, 1, 3) == j.gather_substr(ids, 1, 3)
    assert t.decode_substr(30, 6, 0, 2) == j.decode_substr(30, 6, 0, 2)
    assert t.substr(2, 3, 5) == "ine"
    assert [t.compare(i, "alpha") for i in range(12)] == \
        [j.compare(i, "alpha") for i in range(12)]
    assert t.common_prefix_length(0, 2) == 3
    assert t.calc_stat() == j.calc_stat()
    assert t.effective_slices() == j.effective_slices()
    it = t.get_const_iterator(1).set_substr(1, 2)
    assert it.get_string_view() == "lp" and it.advance() and it.value() == "lp"
    assert list(t.begin()) == j.to_list() and t.end() == t.end()
    with pytest.raises(ValueError):
        t.push_back("y" * 10)
    back = interop.str_vector_from_parts(**jax_str_parts(j))
    assert_same_str(j, back)
    assert back.to_list() == j.to_list()


def test_str_mutators():
    words = [f"w{i % 97:04d}" for i in range(BPB + 300)]
    j, t = str_pair(words, nullable=True)
    for v in (j, t):
        v.set(3, "abc")
        v.assign(4, b"abd")
        v.set_null(5)
        v.push_back("tail")
        v.push_back_null(2)
        v.insert(BPB - 1, "edge")
        v.erase(0)
        v.swap(1, 6)
        v.clear_range(10, 12)
        v.clear_range(13, 14, set_null=True)
        v.import_back(["p", None, "q"])
        v.optimize()
    assert_same_str(j, t)
    assert t.to_list() == j.to_list()
    assert t.try_get(4) == j.try_get(4) and t.try_get(12) == j.try_get(12)
    jr, tr = jbm.StrSparseVector(8, nullable=True), \
        tbm.StrSparseVector(8, nullable=True)
    jr.remap_from(j)
    tr.remap_from(t)
    assert_same_str(jr, tr)
    for v, w in ((j, jr), (t, tr)):
        w.keep_range(2, BPB + 5)
        v.copy_range(w, 100, 200)
    assert_same_str(j, t)
    jk = jbm.BitVector.from_indices(np.arange(0, BPB, 2), C.ID_MAX48)
    tk = tbm.BitVector.from_indices(np.arange(0, BPB, 2), C.ID_MAX48)
    jr.keep(jk)
    tr.keep(tk)
    assert_same_str(jr, tr)
    ja, ta = str_pair(["m1", "m2", None], nullable=True)
    jb, tb = str_pair(["zz", "", "m3", "m4"])
    ja.merge(jb)
    ta.merge(tb)
    assert_same_str(ja, ta)
    assert len(tb) == 0 and ta.to_list() == ja.to_list()
    tr.remap()
    with pytest.raises(ValueError):
        tr.join(ta)
    with pytest.raises(ValueError):
        tbm.StrSparseVector(1).copy_range(ta, 0, 1)
    ja.swap(jr)
    ta.swap(tr)
    assert_same_str(ja, ta)
    ta.resize(3)
    ja.resize(3)
    assert_same_str(ja, ta)
    ta.clear_all(remap=True)
    assert ta.empty() and not ta.is_remap()


@pytest.mark.parametrize("remap", [False, True])
def test_find_eq_str_family(remap):
    words = WORDS * 40 + [None, "alpha"]
    j, t = str_pair(words, max_str_size=8)
    if remap:
        j.remap()
        t.remap()
    probes = ["alpha", "alp", "b", "", "zeta", "alphasX", "alpacaXYZ",
              "qqq", "\xe9t\xe9", b"beta"]
    for k, p in enumerate(probes):
        got = tsc.find_eq_str(t, p)
        ps = p if isinstance(p, str) else p.decode()
        ids = got.indices()
        hits = [i for i, w in enumerate(words) if w == ps]
        np.testing.assert_array_equal(ids[ids < len(words)], hits)
        assert tsc.find_eq_str_count(t, p) == len(hits)
        assert tsc.find_first_eq_str(t, p) == (hits[0] if hits else -1)
        pre = tsc.find_eq_str_prefix(t, p)
        if k % 2 == remap:          # half the probes against JAX each
            assert_same_bv(jsc.find_eq_str(j, p), got)
            assert tsc.find_first_eq_str(t, p) == jsc.find_first_eq_str(j, p)
            assert_same_bv(jsc.find_eq_str_prefix(j, p), pre)
        got = pre
        want_pre = ([i for i, w in enumerate(words) if w == ""] if not ps
                    else [i for i, w in enumerate(words)
                          if w is not None and w.startswith(ps)])
        np.testing.assert_array_equal(got.indices(), want_pre)
    js, ts = JScanner(), tbm.SparseVectorScanner()
    m = np.arange(5, len(words), 4)
    js.set_and_mask(jbm.BitVector.from_indices(m, C.ID_MAX48))
    ts.set_and_mask(tbm.BitVector.from_indices(m, C.ID_MAX48))
    js.set_search_range(100, 400)
    ts.set_search_range(100, 400)
    for p in ("alpha", "al", "", "gamma"):
        assert_same_bits(js.find_eq_str(j, p), ts.find_eq_str(t, p))
        assert_same_bits(js.find_eq_str_prefix(j, p),
                         ts.find_eq_str_prefix(t, p))
        assert ts.find_first_eq_str(t, p) == js.find_first_eq_str(j, p)
        assert ts.find_eq_str_count(t, p) == js.find_eq_str_count(j, p)


def test_find_eq_str_nullable_and_long():
    j, t = str_pair(["foo", "foobar", None, ""], max_str_size=8,
                    nullable=True)
    for v in (j, t):
        v.push_back("fool")
        v.set_null(0)
    for p in ("foo", "", "foobarXYZ", "fool"):
        assert_same_bits(jsc.find_eq_str_prefix(j, p),
                         tsc.find_eq_str_prefix(t, p))
        assert_same_bits(jsc.find_eq_str(j, p), tsc.find_eq_str(t, p))
    assert tsc.find_eq_str_prefix(t, "foo").indices().tolist() == [1, 4]
    assert tsc.find_eq_str(t, "").indices().tolist() == [3]


@pytest.mark.parametrize("use_pallas", [None, True])
def test_str_pipeline(monkeypatch, use_pallas):
    """Counts of the string pipeline on raw and remapped codes: one B5
    launch (plain version here) over every octet plane, equal to both JAX
    routes and to Python."""
    names = _catalog(1200)
    j, t = str_pair(names, nullable=True)
    for v in (j, t):
        v.set_null(7)
    rng = np.random.default_rng(2)
    queries = [names[int(i)] for i in rng.integers(0, len(names), 12)] + \
        [names[7], "NGC 9999999", "XYZ 1", "", "NGC 00", "NGC 0000000X"]
    live = set(names) - {names[7]}
    want = [int(q in live) for q in queries]
    monkeypatch.setattr(jconfig, "use_pallas", use_pallas)
    for remapped in (False, True):
        if remapped:
            j.remap()
            t.remap()
            assert_same_str(j, t)
        got = tsc.pipeline_find_eq_str(t, queries)
        assert got == jsc.pipeline_find_eq_str(j, queries) == want
        prep = tsc.prepare_pipeline_str(t)
        assert prep.ok and prep.K == jsc.prepare_pipeline_str(j).K
        assert prep.counts(queries) == want
        res = tsc.pipeline_find_eq_str(t, queries[:4], counts_only=False)
        for q, r in zip(queries[:4], res):
            assert_same_bv(jsc.find_eq_str(j, q), r)


def test_str_pipeline_plane_counts():
    """A remapped 11-character catalog id holds about 32 planes, raw ASCII
    about 54: both under B5's 72-plane register path."""
    names = _catalog(3000)
    t = tbm.StrSparseVector.from_strings(names)
    raw = tsc.prepare_pipeline_str(t).K
    t.remap()
    remapped = tsc.prepare_pipeline_str(t).K
    assert remapped < raw <= 72 and remapped <= 40


# ---------------------------------------------------------------------------
# floats
# ---------------------------------------------------------------------------
def _fvals(dtype, n=4000, seed=3):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 1000).astype(dtype)
    v[::7] = 2.5
    v[1::11] = -2.5
    v[:6] = [0.0, -0.0, np.inf, -np.inf, np.finfo(dtype).tiny,
             -np.finfo(dtype).max]
    v[10:14] = [0.0, -0.0, 0.0, -0.0]
    return v


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_build_and_mutate(dtype):
    vals = _fvals(dtype)
    j = jbm.FloatSparseVector.from_array(vals, nullable=True)
    t = tbm.FloatSparseVector.from_array(vals, nullable=True)
    assert_same_float(j, t)
    np.testing.assert_array_equal(t.to_numpy().view(t._uint),
                                  vals.view(t._uint))
    for v in (j, t):
        v.set(5, dtype(3.25))
        v.set_null(6)
        v.push_back(dtype(-1.5))
        v.push_back_null(2)
        v.clear_range(20, 25)
        v.clear_range(26, 27, set_null=True)
        ins = v.get_back_inserter()
        ins.add(dtype(8.0))
        ins.add_null()
        ins.flush()
        v.optimize()
    assert_same_float(j, t)
    assert t.effective_slices() == j.effective_slices()
    assert t.calc_stat() == j.calc_stat()
    assert list(t.begin())[:8] == list(j.begin())[:8]
    assert t.try_get(6) == (False, 0) and t.at(5) == dtype(3.25)
    jc = jbm.FloatSparseVector(dtype, nullable=True)
    tc = tbm.FloatSparseVector(dtype, nullable=True)
    jc.copy_range(j, 100, BPB)
    tc.copy_range(t, 100, BPB)
    assert_same_float(jc, tc)
    ja = jbm.FloatSparseVector.from_array(vals[:300])
    ta = tbm.FloatSparseVector.from_array(vals[:300])
    jc.join(ja)
    tc.join(ta)
    assert_same_float(jc, tc)
    ja.merge(jc)
    ta.merge(tc)
    assert_same_float(ja, ta)
    assert ta.equal(interop.float_vector_from_parts(**jax_float_parts(ja)))
    for v in (ja, ta):
        v.resize(200)
        v.sync()
    assert_same_float(ja, ta)


@pytest.mark.parametrize("dtype,nullable", [(np.float32, False),
                                            (np.float32, True),
                                            (np.float64, True)])
def test_float_searches(dtype, nullable):
    vals = _fvals(dtype)
    j = jbm.FloatSparseVector.from_array(vals, nullable=nullable)
    t = tbm.FloatSparseVector.from_array(vals, nullable=nullable)
    ok = np.ones(vals.size, bool)
    if nullable:
        for v in (j, t):
            v.set_null(3)
            v.set_null(8)
        ok[[3, 8]] = False
    ops = {"find_eq_float": np.equal, "find_gt_float": np.greater,
           "find_ge_float": np.greater_equal, "find_lt_float": np.less,
           "find_le_float": np.less_equal}
    # against the JAX package at the zeros and a value each side; against
    # numpy everywhere (a JAX float search costs ~0.3 s on the CPU)
    with_jax = (0.0, 2.5, -2.5) if nullable and dtype == np.float32 else ()
    for q in with_jax + (-2.5,) * (not with_jax) + (-0.0, float(vals[100]),
                                                     -np.inf):
        for name, op in ops.items():
            got = getattr(tsc, name)(t, q)
            if q in with_jax or (not with_jax and q == -2.5):
                assert_same_bv(getattr(jsc, name)(j, q), got)
            np.testing.assert_array_equal(
                got.indices(), np.flatnonzero(op(vals, dtype(q)) & ok),
                err_msg=f"{name} {q}")
    for lo, hi in ((-2.5, 2.5), (0.0, -0.0)):
        a, b = min(lo, hi), max(lo, hi)
        got = tsc.find_range_float(t, lo, hi)
        np.testing.assert_array_equal(
            got.indices(), np.flatnonzero((vals >= a) & (vals <= b) & ok))
        got_open = tsc.find_range_float_unbounded(t, lo, hi)
        np.testing.assert_array_equal(
            got_open.indices(), np.flatnonzero((vals > a) & (vals < b) & ok))
        if lo == -2.5:
            assert_same_bv(jsc.find_range_float(j, lo, hi), got)
            assert_same_bv(jsc.find_range_float_unbounded(j, lo, hi),
                           got_open)
    js, ts = JScanner(), tbm.SparseVectorScanner()
    js.set_and_mask(jbm.BitVector.from_indices(np.arange(0, 3000),
                                               C.ID_MAX48))
    ts.set_and_mask(tbm.BitVector.from_indices(np.arange(0, 3000),
                                               C.ID_MAX48))
    assert_same_bits(js.find_range_float(j, -3.0, 3.0),
                     ts.find_range_float(t, -3.0, 3.0))
    carried = interop.float_vector_from_parts(**jax_float_parts(j))
    assert_same_bv(jsc.find_gt_float(j, -2.5), tsc.find_gt_float(carried,
                                                                -2.5))


# ---------------------------------------------------------------------------
# RSC
# ---------------------------------------------------------------------------
def _rsc_source(n=3 * BPB, density=0.3, seed=11):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 10, n).astype(np.uint32)
    nulls = rng.random(n) >= density
    return vals, nulls


def test_rsc_from_sv_load_to():
    vals, nulls = _rsc_source()
    js = jbm.SparseVector.from_array(vals, null_mask=nulls)
    ts = tbm.SparseVector.from_array(vals, null_mask=nulls)
    j = jbm.RSCSparseVector.from_sparse_vector(js)
    t = tbm.RSCSparseVector.from_sparse_vector(ts)
    assert_same_rsc(j, t)
    live = np.where(nulls, 0, vals)
    np.testing.assert_array_equal(t.to_numpy(), live)
    # load_to writes in one batch where the JAX package sets one by one:
    # the planes must come out the same
    jl, tl = j.load_to(), t.load_to()
    assert_same_sv(jl, tl)
    np.testing.assert_array_equal(tl.to_numpy(), live)
    assert_same_sv(j.load_to(nullable=False), t.load_to(nullable=False))
    assert t.count() == int((~nulls).sum())
    for lo, hi in ((0, 100), (BPB + 5, 2 * BPB + 9), (900, 30)):
        assert t.count_range_notnull(lo, hi) == j.count_range_notnull(lo, hi)
    for r in (1, 2, 500, t.count()):
        assert t.find_rank(r) == j.find_rank(r)
    ids = np.r_[np.arange(0, 50), [BPB, 3 * BPB - 1]]
    np.testing.assert_array_equal(t.gather(ids), j.gather(ids))
    assert t.is_dense() is False and t.is_compressed()
    dense = tbm.RSCSparseVector.from_sparse_vector(
        tbm.SparseVector.from_array(vals[:100]))
    assert dense.is_dense() and dense.count() == 100
    back = interop.rsc_vector_from_parts(**jax_rsc_parts(j))
    assert_same_rsc(j, back)
    assert back.equal(t)


def test_rsc_mutators():
    vals, nulls = _rsc_source(n=5000)
    js = jbm.SparseVector.from_array(vals, null_mask=nulls)
    ts = tbm.SparseVector.from_array(vals, null_mask=nulls)
    j, t = jbm.RSCSparseVector(), tbm.RSCSparseVector()
    j.load_from(js)
    t.load_from(ts)
    i = int(np.flatnonzero(~nulls[20:])[0]) + 20
    for v in (j, t):
        v.set(10, 100)
        v.set(3, 7)
        v.set_null(i)
        v.push_back(9)
        v.push_back_null(3)
        v.inc(3)
        v.inc_not_null(10, 5)
        with v.get_back_inserter() as ins:
            ins.add(4)
            ins.add_null()
            ins.add(6)
    assert_same_rsc(j, t)
    assert t[10] == 105 and t.try_get(i) == (False, 0)
    assert t.try_get_sync(10) == j.try_get_sync(10)
    assert list(t)[:20] == list(j)[:20]
    assert t.calc_stat() == j.calc_stat()
    for v in (j, t):
        v.resize(4000)
        v.optimize()
    assert_same_rsc(j, t)
    jc, tc = jbm.RSCSparseVector(), tbm.RSCSparseVector()
    jc.copy_range(j, 100, 2000)
    tc.copy_range(t, 100, 2000)
    assert_same_rsc(jc, tc)
    ja, ta = jbm.RSCSparseVector(), tbm.RSCSparseVector()
    for v in (ja, ta):
        v.set(4500, 1)
        v.set(4600, 2)
    ja.merge_not_null(jc)
    ta.merge_not_null(tc)
    assert_same_rsc(ja, ta)
    with pytest.raises(ValueError):
        ta.merge_not_null(ta)
    with pytest.raises(ValueError):
        ta.inc_not_null(5)
    assert ta.unsync().in_sync() is False
    with pytest.raises(RuntimeError):
        ta.try_get_sync(5)


@pytest.mark.parametrize("q", [0, 7, 1023, 600])
def test_rsc_searches(q):
    vals, nulls = _rsc_source(n=50_000, density=0.4)
    js = jbm.SparseVector.from_array(vals, null_mask=nulls)
    ts = tbm.SparseVector.from_array(vals, null_mask=nulls)
    j = jbm.RSCSparseVector.from_sparse_vector(js)
    t = tbm.RSCSparseVector.from_sparse_vector(ts)
    for name, op in (("find_eq_rsc", np.equal), ("find_gt_rsc", np.greater),
                     ("find_lt_rsc", np.less)):
        got = getattr(tsc, name)(t, q)
        assert_same_bv(getattr(jsc, name)(j, q), got)
        np.testing.assert_array_equal(got.indices(),
                                      np.flatnonzero(op(vals, q) & ~nulls))
    carried = interop.rsc_vector_from_parts(**jax_rsc_parts(j))
    assert_same_bits(jsc.find_gt_rsc(j, q), tsc.find_gt_rsc(carried, q))


# ---------------------------------------------------------------------------
# every part on the container's device
# ---------------------------------------------------------------------------
def test_parts_on_the_containers_device(monkeypatch):
    """With the default device the card (absent here, so any part built on
    it raises), containers asked for the CPU build every part there and
    every search and algorithm runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbm.config, "device", "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.StrSparseVector()
    cpu = dict(device="cpu")
    vals = np.arange(3000, dtype=np.int32) % 50 - 25
    nm = np.zeros(3000, bool)
    nm[::9] = True
    sv = tbm.SparseVector.from_array(vals, null_mask=nm, **cpu)
    sc = tbm.SparseVectorScanner()
    for name in ("find_gt", "find_ge", "find_lt", "find_le"):
        assert getattr(sc, name)(sv, -3).device.type == "cpu"
    assert sc.find_range(sv, -3, 3).any() and sc.find_nonnegative(sv).any()
    sc.bind(sv)
    assert sc.lower_bound(sv, 0) >= 0 and sc.bfind_eq(sv, 10**6) == -1
    other = tbm.SparseVector.from_array(vals[:100], **cpu)
    assert tbm.find_first_mismatch(sv, other) == 0
    assert tbm.find_first_mismatch(other, tbm.SparseVector.from_array(
        vals[:100], null_mask=nm[:100], **cpu)) == 0
    keep = tbm.BitVector.from_indices(np.arange(10), C.ID_MAX48, **cpu)
    assert tbm.set2set_transform(
        tbm.SparseVector.from_array(vals[:50] + 25, null_mask=nm[:50],
                                    **cpu), keep).any()
    assert tbm.Set2SetTransform().attach_sv(sv).run(
        tbm.BitVector(C.ID_MAX48, **cpu)).none()
    for v in (sv.copy_range(other, 5, 50), other.keep_range(3, 9)):
        assert v.device.type == "cpu"
    sv.join(other)
    sv.insert(3, 4)
    sv.erase(0)
    sv.clear_range(0, 3, set_null=True)
    with sv.get_back_inserter() as ins:
        ins.add(5)
        ins.add_null()
    ssv = tbm.StrSparseVector.from_strings(WORDS[:-1] + [None], **cpu)
    ssv.remap()
    ssv.keep_range(0, 11)
    ssv2 = tbm.StrSparseVector(8, nullable=True, **cpu).remap_from(ssv)
    ssv2.copy_range(ssv, 0, 3)
    ssv2.clear()
    for p in ("alpha", "", "zz"):
        assert sc.find_eq_str(ssv, p).device.type == "cpu"
        sc.find_eq_str_prefix(ssv, p)
        sc.find_first_eq_str(ssv, p)
    assert sc.pipeline_find_eq_str(ssv, ["alpha", "", "zz"]) == [2, 1, 0]
    fv = tbm.FloatSparseVector.from_array(_fvals(np.float32, 500),
                                          nullable=True, **cpu)
    for name in ("find_eq_float", "find_gt_float", "find_lt_float",
                 "find_ge_float", "find_le_float"):
        getattr(sc, name)(fv, -2.5)
    sc.find_range_float_unbounded(fv, -1.0, 1.0)
    tbm.FloatSparseVector(nullable=True, **cpu).copy_range(fv, 0, 9)
    fv.clear()
    rsc = tbm.RSCSparseVector.from_sparse_vector(sv)
    for name in ("find_eq_rsc", "find_gt_rsc", "find_lt_rsc"):
        assert getattr(sc, name)(rsc, 3).device.type == "cpu"
    assert sc.find_eq_rsc(rsc, 10**5).none()
    rsc.load_to()
    rsc.resize(10)
    tbm.RSCSparseVector(np.int32, **cpu).copy_range(rsc, 0, 5)
    rsc.clear()
    m = tbm.BitMatrix(2, **cpu)
    m.set_octet(5, 0, 3)
    m.insert_column(1, 1)
    assert m.rows[0].device.type == "cpu"
    for util in (tbm.sv.AddressResolver(**cpu),
                 tbm.sv.CompressedCollection(**cpu),
                 tbm.sv.SVAddressResolver(**cpu)):
        (util.set(3) if hasattr(util, "set") else util.push_back(3, "x"))
        util.sync() if hasattr(util, "sync") else util.optimize()
    for name in interop.SV_PARTS:
        assert name in interop.sparse_vector_to_parts(sv)
    assert interop.str_vector_from_parts(
        **interop.str_vector_to_parts(ssv), **cpu).to_list() == \
        ssv.to_list()
