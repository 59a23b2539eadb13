"""The sharded sparse vectors of the PyTorch port (integer, RSC, string and
float) against the JAX package on the CPU (the cases of
``tests/test_sharded_sv.py``).

Both packages build each container from the same seeded numpy values, the
JAX package on its virtual 8-device CPU mesh and the port on
``Mesh(["cpu"] * 8)``.  The plane stacks (padding rows included), every
search's hit pool, ``last_narrowing``, counts, pipelines, gathered values
(floats bit for bit) and checkpoint BLOBs must be equal; containers built
by the JAX package are also carried across through ``interop`` and
searched in the port.  Tolerance: exact equality.
"""
import bisect

import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.parallel import mesh as jmesh_mod
from bitmagic_tpu.parallel import sharded_sv as jss
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.parallel import Mesh
from bitmagic_tpu_torch.parallel import sharded_sv as tss

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
N = 5 * BPB + 12345      # several blocks + a ragged tail, 1 block / shard


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_mod.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * 8)


def jwords(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def assert_same_hits(jr, tr, what=""):
    np.testing.assert_array_equal(tr.to_words(), jwords(jr.pool),
                                  err_msg=what)
    assert tr.last_narrowing == jr.last_narrowing, what


def assert_same_stack(j, t):
    np.testing.assert_array_equal(
        np.concatenate([s.numpy().view(np.uint32) for s in t.stack], axis=1),
        jwords(j.stack))


def int_pair(jmesh, tmesh, vals, **kw):
    jsv = jbm.SparseVector.from_array(vals, **kw)
    tsv = tbm.SparseVector.from_array(vals, **kw)
    return (jss.ShardedSparseVector.from_sparse_vector(jsv, jmesh),
            tss.ShardedSparseVector.from_sparse_vector(tsv, tmesh))


def _mk(rng, signed=False, nullable=False, dtype=None):
    dtype = dtype or (np.int32 if signed else np.uint32)
    vals = rng.integers(-5000 if signed else 0, 5000, N).astype(dtype)
    null_mask = rng.random(N) < 0.3 if nullable else None
    return vals, null_mask


# ---------------------------------------------------------------------------
# integer vectors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("signed,nullable", [(False, False), (True, True),
                                             (False, True)])
def test_find_eq_ne_count(jmesh, tmesh, signed, nullable):
    rng = np.random.default_rng(signed * 2 + nullable)
    vals, nm = _mk(rng, signed, nullable)
    j, t = int_pair(jmesh, tmesh, vals, nullable=nullable, null_mask=nm)
    assert_same_stack(j, t)
    assert (t.n_eff, t.n_slices, t.UNI, t.K) == (j.n_eff, j.n_slices,
                                                  j.UNI, j.K)
    for v in (0, 1, 17, 4999, -1, -4999, 12345, 1 << 30):
        assert_same_hits(j.find_eq(v), t.find_eq(v), f"eq {v}")
        assert t.find_eq_count(v) == j.find_eq_count(v)
        assert_same_hits(j.find_ne(v), t.find_ne(v), f"ne {v}")
    assert_same_hits(j.find_zero(), t.find_zero())
    assert_same_hits(j.find_nonzero(), t.find_nonzero())


def test_find_eq_digest_narrowing_sparse(jmesh, tmesh):
    vals = np.zeros(N, np.uint32)
    vals[3] = 0xABCDE
    vals[BPB * 4 + 7] = 0xABCDE
    j, t = int_pair(jmesh, tmesh, vals)
    res = t.find_eq(0xABCDE)
    np.testing.assert_array_equal(res.to_bitvector().indices(),
                                  [3, BPB * 4 + 7])
    assert_same_hits(j.find_eq(0xABCDE), res)
    assert res.last_narrowing == (2, 8)


@pytest.mark.parametrize("signed", [False, True])
def test_ordered_searches(jmesh, tmesh, signed):
    rng = np.random.default_rng(2 + signed)
    vals, _ = _mk(rng, signed=signed)
    j, t = int_pair(jmesh, tmesh, vals)
    for v in ([-3000, -1, 0, 1, 2500, 6000, -(1 << 20), 1 << 20]
              if signed else [0, 1, 777, 2500, 6000, -1, 1 << 20]):
        for name in ("find_gt", "find_ge", "find_lt", "find_le"):
            assert_same_hits(getattr(j, name)(v), getattr(t, name)(v),
                             f"{name} {v}")
    for lo, hi in ((-100, 300), (0, 0), (500, 100)) if signed else \
            ((100, 500), (0, 4999), (7, 7)):
        assert_same_hits(j.find_range(lo, hi), t.find_range(lo, hi))


@pytest.mark.parametrize("signed", [False, True])
def test_ordered_searches_out_of_range(jmesh, tmesh, signed):
    vals = (np.asarray([-3, -1, 0, 2], np.int32) if signed
            else np.asarray([1, 2, 3, 0, 3], np.uint32))
    j, t = int_pair(jmesh, tmesh, vals)
    for v in ([5, -10, 100, -100, 3, -4] if signed
              else [4, 5, 100, (1 << 31) - 1, 3]):
        for name in ("find_gt", "find_ge", "find_lt", "find_le"):
            assert_same_hits(getattr(j, name)(v), getattr(t, name)(v),
                             f"{name} {v}")


def test_out_of_dtype_queries_and_pipeline(jmesh, tmesh):
    rng = np.random.default_rng(55)
    vals = rng.integers(-100, 100, 30_000).astype(np.int16)
    j, t = int_pair(jmesh, tmesh, vals)
    for q in (1 << 15, (1 << 15) + 7, -(1 << 15) - 1, 1 << 40):
        assert t.find_eq_count(q) == j.find_eq_count(q) == 0
        assert_same_hits(j.find_eq(q), t.find_eq(q))
        assert_same_hits(j.find_ne(q), t.find_ne(q))
    qs = [0, 1 << 15, 17, -(1 << 20), -5]
    assert t.pipeline_find_eq(qs) == j.pipeline_find_eq(qs) == \
        [int((vals == q).sum()) if -(1 << 15) <= q < 1 << 15 else 0
         for q in qs]


def test_gather_decode_checkpoint(jmesh, tmesh):
    rng = np.random.default_rng(5)
    vals, nm = _mk(rng, signed=True, nullable=True)
    j, t = int_pair(jmesh, tmesh, vals, nullable=True, null_mask=nm)
    ids = rng.integers(0, N, 300).astype(np.int64)
    np.testing.assert_array_equal(t.gather(ids), j.gather(ids))
    np.testing.assert_array_equal(t.decode(100, 50), j.decode(100, 50))
    assert t.get(3) == j.get(3) and t[5] == j[5] and len(t) == len(j)
    with pytest.raises(IndexError):
        t.gather([N + BPB * 8])
    back = t.to_sparse_vector()
    assert back.equal(tbm.SparseVector.from_array(vals, null_mask=nm))
    blob = t.checkpoint_bytes()
    assert blob == j.checkpoint_bytes()
    again = tss.ShardedSparseVector.from_checkpoint(blob, tmesh)
    assert_same_stack(j, again)


def test_uint64_gather(jmesh, tmesh):
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 1 << 63, 3000, dtype=np.uint64) * np.uint64(2) \
        + np.uint64(1)
    j, t = int_pair(jmesh, tmesh, vals)
    ids = np.arange(0, 3000, 7)
    np.testing.assert_array_equal(t.gather(ids), vals[ids])
    np.testing.assert_array_equal(t.gather(ids), j.gather(ids))
    assert_same_hits(j.find_gt(int(vals[9])), t.find_gt(int(vals[9])))


def test_carried_across_through_interop(jmesh, tmesh):
    rng = np.random.default_rng(6)
    vals, nm = _mk(rng, nullable=True)
    j, _ = int_pair(jmesh, tmesh, vals, nullable=True, null_mask=nm)
    t = interop.sharded_sparse_vector_from_parts(
        jwords(j.stack), j.size, j.dtype, j.signed, j.n_slices, j.n_eff,
        j.nullable, tmesh)
    assert_same_hits(j.find_eq(42), t.find_eq(42))
    assert_same_hits(j.find_gt(42), t.find_gt(42))
    parts = interop.sharded_sparse_vector_to_parts(t)
    np.testing.assert_array_equal(parts["stack_u32"], jwords(j.stack))


def test_sorted_search_on_sharded(tmesh):
    """scanner.bind() sorted search runs on the mesh containers through
    their gather / len."""
    rng = np.random.default_rng(41)
    vals = np.sort(rng.integers(0, 100_000, 50_000).astype(np.uint32))
    t = tss.ShardedSparseVector.from_array(vals, tmesh)
    sc = tbm.SparseVectorScanner()
    sc.bind(t)
    for q in (0, int(vals[7]), int(vals[-1]), 100_001, 55_555):
        assert sc.lower_bound(t, q) == bisect.bisect_left(vals, q), q
    assert vals[sc.bfind_eq(t, int(vals[123]))] == vals[123]
    assert sc.bfind_eq(t, 100_001) == -1
    words = sorted("w%05d" % v for v in rng.integers(0, 999, 5_000))
    st = tss.ShardedStrSparseVector.from_strings(words, tmesh)
    sc.bind(st)
    for q in ("w00000", words[17], words[-1], "zzzzz"):
        assert sc.lower_bound_str(st, q) == bisect.bisect_left(words, q), q
    assert sc.bfind_eq_str(st, "zzzzz") == -1


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def str_data():
    rng = np.random.default_rng(11)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
             "longer-string-here", "x", "\xe9t\xe9"]
    strs = [words[i] for i in rng.integers(0, len(words), 50_000)]
    strs[12345] = "needle"
    return strs


def str_pair(jmesh, tmesh, strs, remap=False, **kw):
    jv = jbm.StrSparseVector.from_strings(strs, **kw)
    tv = tbm.StrSparseVector.from_strings(strs, **kw)
    if remap:
        jv.remap()
        tv.remap()
    return (jss.ShardedStrSparseVector.from_str_vector(jv, jmesh),
            tss.ShardedStrSparseVector.from_str_vector(tv, tmesh))


@pytest.mark.parametrize("remap", [False, True])
def test_str_find_and_pipeline(jmesh, tmesh, str_data, remap):
    j, t = str_pair(jmesh, tmesh, str_data, remap)
    assert_same_stack(j, t)
    assert t.slots == list(j.slots)
    queries = ["beta", "needle", "absent", "x", "", "a" * 40, "\xe9t\xe9"]
    for q in queries:
        assert_same_hits(j.find_eq_str(q), t.find_eq_str(q), q)
        assert t.find_eq_str_count(q) == j.find_eq_str_count(q)
    for p in ("al", "", "zz", "longer", "x"):
        assert_same_hits(j.find_eq_str_prefix(p), t.find_eq_str_prefix(p), p)
    assert t.pipeline_find_eq_str(queries) == j.pipeline_find_eq_str(queries)
    ids = [0, 7, 100, 12345, 49_999]
    assert t.gather(ids) == j.gather(ids)
    assert t.decode(10, 20) == j.decode(10, 20)
    assert t.compare(12345, "needle") == j.compare(12345, "needle") == 0
    assert t.compare(0, "zzz") == j.compare(0, "zzz")


def test_str_nullable_checkpoint_and_interop(jmesh, tmesh, str_data):
    strs = list(str_data[:2000])
    strs[7] = None
    j, t = str_pair(jmesh, tmesh, strs, remap=True, nullable=True)
    ids = [0, 7, 100, 1999]
    assert t.gather(ids) == j.gather(ids) == [strs[i] for i in ids]
    assert t[7] is None
    # strings go in as UTF-8 and come out as latin-1 in both packages
    assert t.to_str_vector().gather(np.arange(50)) == \
        j.to_str_vector().gather(np.arange(50))
    blob = t.checkpoint_bytes()
    assert blob == j.checkpoint_bytes()
    again = tss.ShardedStrSparseVector.from_checkpoint(blob, tmesh)
    assert again.gather(ids) == [strs[i] for i in ids]
    c = interop.sharded_str_vector_from_parts(
        jwords(j.stack), j.size, j.max_str_size, j.nullable, j.slots,
        j.remap_matrices, j.unmap_matrices, tmesh)
    assert_same_hits(j.find_eq_str(strs[100]), c.find_eq_str(strs[100]))
    parts = interop.sharded_str_vector_to_parts(c)
    np.testing.assert_array_equal(parts["stack_u32"], jwords(j.stack))


# ---------------------------------------------------------------------------
# floats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,nullable", [(np.float32, False),
                                            (np.float64, False),
                                            (np.float32, True)])
def test_float_searches(jmesh, tmesh, dtype, nullable):
    rng = np.random.default_rng(31)
    n = 2 * BPB + 999
    vals = (rng.normal(0, 100, n) * rng.choice([1, 0, 0.5], n)).astype(dtype)
    vals[5] = -0.0
    vals[7] = 3.25
    jf = jbm.FloatSparseVector.from_array(vals, nullable=nullable)
    tf = tbm.FloatSparseVector.from_array(vals, nullable=nullable)
    if nullable:
        for i in (3, 100, n - 1):
            jf.set_null(i)
            tf.set_null(i)
    j = jss.ShardedFloatVector.from_float_vector(jf, jmesh)
    t = tss.ShardedFloatVector.from_float_vector(tf, tmesh)
    assert_same_stack(j, t)
    assert (t.rows, t.SIGN) == (j.rows, j.SIGN)
    for q in (3.25, 0.0, -0.0, -50.0, 1e30):
        q = dtype(q)
        assert_same_hits(j.find_eq(q), t.find_eq(q), f"eq {q}")
        assert t.find_eq_count(q) == j.find_eq_count(q)
    for name, q in (("find_ne", 3.25), ("find_gt", -0.0), ("find_gt", 12.75),
                    ("find_ge", -50.0), ("find_lt", float(vals[123])),
                    ("find_le", 0.0), ("find_lt", -1e30)):
        q = dtype(q)
        assert_same_hits(getattr(j, name)(q), getattr(t, name)(q),
                         f"{name} {q}")
    assert_same_hits(j.find_range(dtype(-10), dtype(10)),
                     t.find_range(dtype(-10), dtype(10)))
    qs = [dtype(3.25), dtype(0.0), dtype(999999.0)]
    assert t.pipeline_find_eq(qs) == j.pipeline_find_eq(qs)
    ids = rng.integers(0, n, 200)
    np.testing.assert_array_equal(t.gather(ids).view(np.uint8),
                                  j.gather(ids).view(np.uint8))
    blob = t.checkpoint_bytes()
    assert blob == j.checkpoint_bytes()
    again = tss.ShardedFloatVector.from_checkpoint(blob, tmesh)
    np.testing.assert_array_equal(again.decode(0, 64).view(np.uint8),
                                  j.decode(0, 64).view(np.uint8))
    c = interop.sharded_float_vector_from_parts(
        jwords(j.stack), j.size, j.dtype, j.rows, j.SIGN, j.nullable, tmesh)
    assert_same_hits(j.find_gt(dtype(1.5)), c.find_gt(dtype(1.5)))
    assert interop.sharded_float_vector_to_parts(c)["rows"] == j.rows


# ---------------------------------------------------------------------------
# RSC
# ---------------------------------------------------------------------------
def test_rsc_find_gather_checkpoint(jmesh, tmesh):
    rng = np.random.default_rng(21)
    n = 2 * BPB + 777
    nm = rng.random(n) < 0.7
    vals = rng.integers(1, 3000, n).astype(np.uint32)
    jr = jss.ShardedRSCVector.from_sparse_vector(
        jbm.SparseVector.from_array(vals, nullable=True, null_mask=nm), jmesh)
    tr = tss.ShardedRSCVector.from_sparse_vector(
        tbm.SparseVector.from_array(vals, nullable=True, null_mask=nm), tmesh)
    assert tr.count() == jr.count() == int((~nm).sum())
    assert_same_stack(jr.dense, tr.dense)
    np.testing.assert_array_equal(tr.null_sbv.to_words(),
                                  jwords(jr.null_sbv.pool))
    q0 = int(vals[np.flatnonzero(~nm)[0]])
    for name, q in (("find_eq", q0), ("find_eq", 12345), ("find_gt", 1500),
                    ("find_ge", q0), ("find_lt", 1500), ("find_le", q0),
                    ("find_ne", 1500)):
        assert_same_hits(getattr(jr, name)(q), getattr(tr, name)(q),
                         f"{name} {q}")
    assert_same_hits(jr.find_range(100, 2000), tr.find_range(100, 2000))
    assert tr.find_eq_count(q0) == jr.find_eq_count(q0)
    assert tr.pipeline_find_eq([q0, 7, 100000]) == \
        jr.pipeline_find_eq([q0, 7, 100000])
    ids = np.asarray([0, 5, n - 1] + list(rng.integers(0, n, 100)))
    tv, tok = tr.gather(ids)
    jv, jok = jr.gather(ids)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tok, jok)
    i_null = int(np.flatnonzero(nm)[0])
    assert tr.try_get(i_null) is None
    assert tr.try_get(5) == jr.try_get(5) and tr[5] == jr[5]
    blob = tr.checkpoint_bytes()
    assert blob == jr.checkpoint_bytes()
    again = tss.ShardedRSCVector.from_checkpoint(blob, tmesh)
    np.testing.assert_array_equal(again.gather(ids)[0], jv)
    c = interop.sharded_rsc_vector_from_parts(
        {"stack_u32": jwords(jr.dense.stack), "size": jr.dense.size,
         "dtype": jr.dense.dtype, "signed": jr.dense.signed,
         "n_slices": jr.dense.n_slices, "n_eff": jr.dense.n_eff,
         "nullable": jr.dense.nullable}, jwords(jr.null_sbv.pool), jr.size,
        tmesh)
    assert_same_hits(jr.find_eq(q0), c.find_eq(q0))
    parts = interop.sharded_rsc_vector_to_parts(c)
    np.testing.assert_array_equal(parts["null_pool_u32"],
                                  jwords(jr.null_sbv.pool))
