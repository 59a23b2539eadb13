"""SparseVector (integer part), scanner equality search and kernel B6 of the
PyTorch port against the JAX package, on the CPU.

Both packages build their vectors from the same numpy values; the port's
plane states (``nb``, ``cls``, rows, GAP arrays of every plane and of the
NULL plane, read through ``interop``) and every answer must be identical,
and search results keep the JAX package's state wherever both take the
same route.  The JAX package takes its fused pipeline routes only with
Pallas on (``use_pallas``, interpret mode here); the port always takes
them, so its pipelines are held against both JAX routes.  The plain
version of kernel B6 is held against ``scan_eq_pallas`` in interpret mode.
Tolerance: exact equality (integer results).
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.config import config as jconfig
from bitmagic_tpu.ops import pallas_kernels as pk
from bitmagic_tpu.sv.scanner import scanner as jsc
from bitmagic_tpu.sv.sparse_vector import SparseVector as JSV
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.core.bitvector import ReadOnlyError
from bitmagic_tpu_torch.ops import blockops

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
N = 70_000
tsc = tbm.scanner
TSV = tbm.SparseVector


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


def jax_sv_parts(sv):
    sv._flush()
    return {"dtype": sv.dtype.str, "nullable": bool(sv.nullable),
            "size": int(sv._size),
            "planes": [None if p is None else jax_parts(p)
                       for p in sv.planes],
            "null_plane": jax_parts(sv.null_plane) if sv.nullable else None}


def assert_same_bv(jv, tv):
    want, got = jax_parts(jv), interop.bitvector_to_parts(tv)
    for key in interop.PARTS:
        np.testing.assert_array_equal(
            np.asarray(got[key]), np.asarray(want[key]).reshape(
                np.shape(got[key])), err_msg=key)


def assert_same_bits(jv, tv):
    np.testing.assert_array_equal(tv.indices(), np.asarray(jv.indices()))


def assert_same_sv(jsv, tsv):
    want, got = jax_sv_parts(jsv), interop.sparse_vector_to_parts(tsv)
    for key in ("dtype", "nullable", "size"):
        assert got[key] == want[key], key
    assert [p is None for p in got["planes"]] == \
        [p is None for p in want["planes"]]
    for g, w in zip(got["planes"] + [got["null_plane"]],
                    want["planes"] + [want["null_plane"]]):
        if w is None:
            assert g is None
            continue
        for key in interop.PARTS:
            np.testing.assert_array_equal(
                np.asarray(g[key]), np.asarray(w[key]).reshape(
                    np.shape(g[key])), err_msg=key)


def pair(values, **kw):
    return (JSV.from_array(values, **kw),
            TSV.from_array(values, device="cpu", **kw))


# ---------------------------------------------------------------------------
# kernel B6 (plain version) against scan_eq_pallas, interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_planes,nb", [(8, 3), (32, 1)])
def test_scan_eq_plain_vs_pallas(n_planes, nb):
    rng = np.random.default_rng(n_planes)
    vals = rng.integers(0, 2**n_planes, nb * BPB, dtype=np.uint64)
    vals[::7] = 42
    planes = np.zeros((n_planes, nb, 2048), np.uint32)
    for s in range(n_planes):
        bits = ((vals >> np.uint64(s)) & np.uint64(1)).astype(np.uint8)
        planes[s] = np.packbits(bits, bitorder="little").view(
            np.uint32).reshape(nb, 2048)
    tp = blockops.to_device_words(planes, "cpu")
    for target in (42, int(vals[3]), 2**n_planes - 1):
        want = np.asarray(pk.scan_eq_pallas(n_planes, planes,
                                            np.uint32(target)))
        got = blockops.to_host_words(blockops.scan_eq(n_planes, tp, target))
        np.testing.assert_array_equal(got, want)
        hits = np.unpackbits(got.view(np.uint8), bitorder="little")
        np.testing.assert_array_equal(np.flatnonzero(hits),
                                      np.flatnonzero(vals == target))


# ---------------------------------------------------------------------------
# SparseVector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,lo,hi", [(np.uint32, 0, 2**31),
                                         (np.uint8, 0, 255),
                                         (np.uint64, 0, 2**40),
                                         (np.int32, -2**30, 2**30),
                                         (np.int64, -2**40, 2**40)])
def test_from_array_state_and_decode(dtype, lo, hi):
    rng = np.random.default_rng(3)
    vals = rng.integers(lo, hi, N).astype(dtype)
    j, t = pair(vals)
    assert_same_sv(j, t)
    assert len(t) == N and t.device.type == "cpu"
    np.testing.assert_array_equal(t.to_numpy(), vals)
    ids = rng.integers(0, N, 300)
    np.testing.assert_array_equal(t.gather(ids), vals[ids])
    np.testing.assert_array_equal(t.decode(N // 3, 500),
                                  vals[N // 3:N // 3 + 500])
    assert t[5] == vals[5]
    assert t.effective_slices() == j.effective_slices()
    back = interop.sparse_vector_from_parts(**jax_sv_parts(j), device="cpu")
    assert back.equal(t)
    np.testing.assert_array_equal(back.to_numpy(), vals)


def test_nullable_import_offset_and_flush():
    rng = np.random.default_rng(5)
    vals = rng.integers(1, 1000, 2000).astype(np.uint32)
    nulls = rng.random(2000) < 0.3
    j, t = pair(vals, nullable=True, null_mask=nulls)
    assert_same_sv(j, t)
    assert [t.is_null(i) for i in range(50)] == list(nulls[:50])
    np.testing.assert_array_equal(t.to_numpy(), np.where(nulls, 0, vals))
    np.testing.assert_array_equal(t.null_indices(), np.flatnonzero(nulls))
    assert_same_bv(j.get_null_bvector(), t.get_null_bvector())
    for sv in (j, t):
        patch = np.arange(128, dtype=np.uint32) * 3
        sv.import_values(patch, offset=256)            # 32-aligned
        sv.import_values(patch[:50] + 1, offset=101)   # unaligned
        sv.import_back(patch[:77])
        sv.set(3, 77777)
        sv.set_null(4)
        sv.push_back(9)
        sv.optimize()
    assert_same_sv(j, t)
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    assert t.is_null(4) and t[3] == 77777 and len(t) == len(j)
    for sv in (j, t):
        sv.resize(1500)
    assert_same_sv(j, t)
    assert t.equal(interop.sparse_vector_from_parts(**jax_sv_parts(j)))
    t2 = interop.sparse_vector_from_parts(**jax_sv_parts(j))
    t2.set(5, int(t2[5]) + 1)
    assert not t.equal(t2)
    t.freeze()
    assert t.is_ro() and t.plane(0).is_ro()
    with pytest.raises(ReadOnlyError):
        t.set(1, 2)
    with pytest.raises(ReadOnlyError):
        t.plane(0).set_range(0, 10)
    t2.clear()
    assert len(t2) == 0 and t2.empty()


def test_single_set_get_and_nulls():
    """Staged single sets and NULLs flush into the same planes in both
    packages."""
    j, t = JSV(np.uint32, nullable=True), TSV(np.uint32, nullable=True,
                                             device="cpu")
    for sv in (j, t):
        sv.set(5, 42)
        sv.set(100_000, 7)
        sv[3] = 9
        sv.set_null(3)
        sv.set(0, 5)
    assert_same_sv(j, t)
    assert (t[5], t[100_000], t[4], len(t)) == (42, 7, 0, 100_001)
    assert t.is_null(3) and not t.is_null(0) and t[0] == 5
    np.testing.assert_array_equal(t.null_indices(), j.null_indices())


# ---------------------------------------------------------------------------
# scanner: equality searches
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def svs():
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 50, N).astype(np.uint32)
    nulls = rng.random(N) < 0.2
    signed = rng.integers(-20, 20, 5000).astype(np.int32)
    return {
        "u32": (vals, None) + pair(vals),
        "null": (vals, nulls) + pair(vals, nullable=True, null_mask=nulls),
        "i32": (signed, None) + pair(signed),
    }


@pytest.mark.parametrize("kind,probes", [("u32", [0, 1, 7, 49, 200]),
                                         ("null", [0, 3, 49]),
                                         ("i32", [-20, -1, 0, 5, 19])])
def test_find_eq_family(svs, kind, probes):
    vals, nulls, j, t = svs[kind]
    ok = np.ones(vals.size, bool) if nulls is None else ~nulls
    for v in probes:
        want = jsc.find_eq(j, v)
        got = tsc.find_eq(t, v)
        assert_same_bv(want, got)
        got_ids = got.indices()
        np.testing.assert_array_equal(got_ids[got_ids < vals.size],
                                      np.flatnonzero((vals == v) & ok))
        assert tsc.find_eq_count(t, v) == int(((vals == v) & ok).sum())
        assert tsc.find_first_eq(t, v) == jsc.find_first_eq(j, v)
        assert_same_bits(jsc.find_ne(j, v), tsc.find_ne(t, v))
        assert_same_bits(jsc.invert(j, want), tsc.invert(t, got))
    assert_same_bv(jsc.find_zero(j), tsc.find_zero(t))
    assert_same_bv(jsc.find_nonzero(j), tsc.find_nonzero(t))
    assert_same_bits(jsc.find_eq_set(j, probes), tsc.find_eq_set(t, probes))


def test_and_mask_and_search_range(svs):
    vals, nulls, j, t = svs["null"]
    ids = np.arange(0, N, 3)
    jm = jbm.BitVector.from_indices(ids, C.ID_MAX48)
    tm = tbm.BitVector.from_indices(ids, C.ID_MAX48)
    jsc2, tsc2 = type(jsc)(), tbm.SparseVectorScanner()
    jsc2.set_and_mask(jm)
    tsc2.set_and_mask(tm)
    jsc2.set_search_range(BPB - 100, N - 7)
    tsc2.set_search_range(N - 7, BPB - 100)             # swapped bounds
    for v in (0, 3, 17):
        assert_same_bits(jsc2.find_eq(j, v), tsc2.find_eq(t, v))
        assert_same_bits(jsc2.find_ne(j, v), tsc2.find_ne(t, v))
        assert jsc2.find_first_eq(j, v) == tsc2.find_first_eq(t, v)
    assert_same_bits(jsc2.find_nonzero(j), tsc2.find_nonzero(t))
    tsc2.reset_and_mask()
    tsc2.reset_search_range()
    assert_same_bits(jsc.find_eq(j, 3), tsc2.find_eq(t, 3))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int64])
def test_out_of_dtype_range_queries(dtype):
    rng = np.random.default_rng(11)
    info = np.iinfo(dtype)
    vals = rng.integers(max(info.min, -100), min(info.max, 100),
                        5000).astype(dtype)
    nm = rng.random(5000) < 0.2
    j, t = pair(vals, nullable=True, null_mask=nm)
    over = [int(info.max) + 1, int(info.min) - 1]
    for q in over:
        assert tsc.find_eq(t, q).count() == 0
        assert tsc.find_ne(t, q).count() == int((~nm).sum())
        assert tsc.find_first_eq(t, q) == -1
    batch = [0, over[0], 5, over[1]]
    want = [int((vals[~nm] == q).sum()) if info.min <= q <= info.max else 0
            for q in batch]
    assert tsc.pipeline_find_eq(t, batch, counts_only=True) == want
    assert [b.count() for b in tsc.pipeline_find_eq(t, batch)] == want
    assert jsc.pipeline_find_eq(j, batch, counts_only=True) == want


# ---------------------------------------------------------------------------
# pipelines (B5 counts, B4 arena results)
# ---------------------------------------------------------------------------
def test_pipeline_find_eq(monkeypatch):
    rng = np.random.default_rng(13)
    vals = rng.integers(0, 1 << 12, 50_000).astype(np.uint32)
    vals[::9] = 0
    j, t = pair(vals, nullable=True)
    queries = list(rng.integers(0, 1 << 12, 12)) + [0, 1 << 20]
    loop = [int(jsc.find_eq(j, q).count()) for q in queries]
    assert tsc.pipeline_find_eq(t, queries, counts_only=True) == loop
    per_value = [jsc.find_eq(j, q) for q in queries]
    monkeypatch.setattr(jconfig, "use_pallas", True)
    fused_j = jsc.pipeline_find_eq(j, queries)
    fused_j_counts = jsc.pipeline_find_eq(j, queries, counts_only=True)
    got = tsc.pipeline_find_eq(t, queries)
    assert fused_j_counts == loop
    for q, w, fw, g in zip(queries, per_value, fused_j, got):
        assert_same_bits(w, g)
        if q:                       # arena route on both sides: same state
            assert_same_bv(fw, g)


@pytest.mark.parametrize("use_pallas", [None, True])
def test_pipeline_counts_with_full_blocks(monkeypatch, use_pallas):
    """FULL plane and NULL-plane blocks map to all-ones rows of the stack:
    the port's fused counts equal both JAX routes and numpy."""
    rng = np.random.default_rng(19)
    n = 150_000
    vals = rng.integers(0, 16, n).astype(np.uint32)
    j, t = pair(vals, nullable=True)
    for sv in (j, t):
        for p in sv.planes + [sv.null_plane]:
            if p is not None:
                p.optimize()
    assert (t.null_plane._struct.cls == C.CLS_FULL).any() \
        or t.null_plane._struct.has_runs
    queries = list(range(17))
    want = [int((vals == q).sum()) for q in queries]
    assert tsc.pipeline_find_eq(t, queries, counts_only=True) == want
    monkeypatch.setattr(jconfig, "use_pallas", use_pallas)
    assert jsc.pipeline_find_eq(j, queries, counts_only=True) == want


def test_prepared_pipeline(monkeypatch):
    rng = np.random.default_rng(17)
    n = 150_000                     # > two blocks: FULL null-plane blocks
    vals = rng.integers(0, 1 << 10, n).astype(np.uint32)
    vals[:BPB] = rng.integers(0, 4, BPB)
    j, t = pair(vals, nullable=True)
    for sv in (j, t):
        for p in sv.planes:
            if p is not None:
                p.optimize()
        sv.null_plane.optimize()
    assert_same_sv(j, t)
    prep = tsc.prepare_pipeline(t)
    assert prep.ok and not prep.succinct
    for _ in range(2):
        qs = [int(q) for q in rng.integers(0, 1 << 10, 16)] + [0, 1, 2]
        want = [int((vals == q).sum()) for q in qs]
        assert prep.counts(qs) == want
    mask_ids = np.arange(0, n, 5)
    mask = tbm.BitVector.from_indices(mask_ids, C.ID_MAX48)
    in_mask = np.zeros(n, bool)
    in_mask[mask_ids] = True
    prep.set_search_mask(mask).set_search_count_limit(40)
    qs = [1, 2, 3, 5]
    assert prep.counts(qs) == [min(int(((vals == q) & in_mask).sum()), 40)
                               for q in qs]
    target = tbm.BitVector(C.ID_MAX48)
    prep.set_or_target(target).set_search_count_limit(None)
    prep.counts([1, 2])
    np.testing.assert_array_equal(
        target.indices(), np.flatnonzero(np.isin(vals, [1, 2]) & in_mask))
    monkeypatch.setattr(jconfig, "use_pallas", True)
    jprep = jsc.prepare_pipeline(j)
    assert jprep.counts(qs) == tsc.prepare_pipeline(t).counts(qs)


def test_prepared_pipeline_succinct(monkeypatch):
    rng = np.random.default_rng(5)
    n = 3_000_000
    vals = np.zeros(n, np.uint32)
    idx = np.sort(rng.choice(n, 8000, replace=False))
    vals[idx] = rng.integers(1, 4096, idx.size)
    vals[70_000:70_016] = 77777
    j, t = pair(vals)
    for sv in (j, t):
        sv.optimize()               # planes go GAP-resident
    assert_same_sv(j, t)
    from bitmagic_tpu_torch.agg import arena as tarena

    def no_dense(self):
        raise AssertionError("succinct pipeline built the full arena")
    monkeypatch.setattr(tarena.OperandArena, "pool", property(no_dense))
    prep = tsc.prepare_pipeline(t)
    assert prep.succinct and prep.ok
    qs = [77777, 5, 7, 99999]
    assert prep.counts(qs) == [int((vals == q).sum()) for q in qs]
    assert prep.counts([77777]) == [16]
    surv, total = prep.last_narrowing
    assert surv < total and surv <= 4
