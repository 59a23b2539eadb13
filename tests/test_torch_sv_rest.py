"""The rest of SparseVector, the sv iterators, BitMatrix, ``sv/util.py`` and
``sv/algo.py`` of the PyTorch port against the JAX package, on the CPU.

Both packages run the same calls on vectors built from the same numpy
values; the port's plane states (read through ``interop``), positions,
counts and decoded values must equal the JAX package's.  Tolerance: exact
equality (integer results).
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.sv import algo as jalgo
from bitmagic_tpu.sv import util as jutil
from bitmagic_tpu.sv.bmatrix import BitMatrix as JBM
from bitmagic_tpu.sv.sparse_vector import SparseVector as JSV
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.sv import util as tutil
from test_torch_scanner import (assert_same_bits, assert_same_bv,
                                assert_same_sv, pair)

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
TSV = tbm.SparseVector


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _vals(seed, n, hi=1 << 12, dtype=np.uint32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, n).astype(dtype), rng.random(n) < 0.2


# ---------------------------------------------------------------------------
# SparseVector: the methods of bitmagic_tpu/sv/sparse_vector.py:296-696
# ---------------------------------------------------------------------------
def test_push_back_null_inc_add():
    j, t = JSV(np.uint32, nullable=True), TSV(np.uint32, nullable=True)
    for sv in (j, t):
        sv.push_back(7)
        sv.push_back_null(2)
        sv.push_back(9)
        sv.inc(0)
        sv.add(3, 5)
        sv.inc(1)                 # a NULL reads 0: inc assigns 1
    assert_same_sv(j, t)
    assert (len(t), t[0], t[1], t[3]) == (4, 8, 1, 14)
    assert t.is_null(2) and not t.is_null(1)
    with pytest.raises(ValueError):
        TSV(np.uint32).push_back_null()


@pytest.mark.parametrize("na,nb", [(True, True), (True, False),
                                   (False, True), (False, False)])
def test_join_merge(na, nb):
    va, ma = _vals(1, 3 * BPB // 2)
    vb, mb = _vals(2, BPB + 77, hi=1 << 14)
    ja, ta = pair(va, null_mask=ma if na else None)
    jb, tb = pair(vb, null_mask=mb if nb else None)
    ja.join(jb)
    ta.join(tb)
    assert_same_sv(ja, ta)
    np.testing.assert_array_equal(ta.to_numpy(), ja.to_numpy())
    jc, tc = pair(vb[:500])
    jc.merge(jb)
    tc.merge(tb)
    assert_same_sv(jc, tc)
    assert_same_sv(jb, tb)
    assert len(tb) == 0
    with pytest.raises(ValueError):
        ta.join(TSV(np.uint16))


def test_filter_keep_range_clear_range():
    vals, nm = _vals(3, 2 * BPB + 300)
    ids = np.arange(0, vals.size, 3)
    for nullable in (True, False):
        j, t = pair(vals, null_mask=nm if nullable else None)
        j.filter(jbm.BitVector.from_indices(ids, C.ID_MAX48))
        t.keep(tbm.BitVector.from_indices(ids, C.ID_MAX48))
        assert_same_sv(j, t)
        for sv in (j, t):
            sv.keep_range(500, BPB + 900)
            sv.clear_range(600, 700)
            sv.clear_range(800, 850, set_null=True)
        assert_same_sv(j, t)
        np.testing.assert_array_equal(t.extract(400, 450), j.extract(400, 450))
        np.testing.assert_array_equal(t.extract_range(590, BPB + 1000),
                                      j.extract_range(590, BPB + 1000))


@pytest.mark.parametrize("nullable", [True, False])
def test_insert_erase_copy_range(nullable):
    vals, nm = _vals(4, BPB + 2000, hi=1 << 16)
    j, t = pair(vals, null_mask=nm if nullable else None)
    for sv in (j, t):
        sv.insert(0, 11)
        sv.insert(BPB - 1, 77777)            # a block edge
        sv.insert(500, 3)
        sv.erase(BPB + 10)
        sv.erase(0)
    assert_same_sv(j, t)
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    for dst_nullable in (True, False):
        jd = JSV(np.uint32, nullable=dst_nullable)
        td = TSV(np.uint32, nullable=dst_nullable)
        jd.copy_range(j, 100, BPB + 50)
        td.copy_range(t, BPB + 50, 100)      # swapped bounds
        assert_same_sv(jd, td)
    with pytest.raises(ValueError):
        TSV(np.int32).copy_range(t, 0, 5)


def test_access_compare_swap_stat():
    vals, nm = _vals(5, 3000)
    j, t = pair(vals, null_mask=nm)
    i_null, i_val = int(np.flatnonzero(nm)[0]), int(np.flatnonzero(~nm)[0])
    assert t.try_get(i_null) == j.try_get(i_null) == (False, 0)
    assert t.try_get(i_val) == j.try_get(i_val)
    assert t.at(i_val) == vals[i_val]
    with pytest.raises(IndexError):
        t.at(3000)
    for q in (0, int(vals[i_val]), 1 << 13):
        assert t.compare(i_val, q) == j.compare(i_val, q)
    assert t.find_rank(5) == 4
    with pytest.raises(ValueError):
        t.find_rank(0)
    assert t.sync() is t and t.sync_size() is t and not t.is_remap()
    assert (t.effective_size(), t.is_compressed(), t.is_str()) == \
        (3000, False, False)
    for sv in (j, t):
        sv.swap(i_null, i_val)
        sv.swap(1, 2)
    assert_same_sv(j, t)
    j2, t2 = pair(vals[:700])
    j.swap(j2)
    t.swap(t2)
    assert_same_sv(j, t)
    assert_same_sv(j2, t2)
    with pytest.raises(TypeError):
        t.swap(5)
    for sv in (j2, t2):
        sv.optimize()
        sv.optimize_gap_size()
    assert_same_sv(j2, t2)
    assert t2.calc_stat() == j2.calc_stat()
    t2.clear_all()
    assert t2.empty() and t2.null_plane.none()


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------
def test_const_iterator():
    vals, nm = _vals(6, 20_000)                 # three 8192-element windows
    j, t = pair(vals, null_mask=nm)
    assert list(t.begin()) == list(j.begin())
    it = t.get_const_iterator(8190)
    got = []
    while it != t.end():
        got.append((it.pos(), it.is_null(), it.value()))
        if not it.advance():
            break
        if it.pos() == 8200:
            it.go_to(19_995)
    want = [(p, bool(nm[p]), 0 if nm[p] else vals[p])
            for p in list(range(8190, 8200)) + list(range(19_995, 20_000))]
    assert got == want
    assert not it.valid() and it.is_null()
    with pytest.raises(IndexError):
        it.value()
    assert t.end() == t.end() and t.end() != j.end()
    assert len({t.end(), t.end()}) == 1


@pytest.mark.parametrize("buffer_size", [7, 65536])
def test_back_inserter(buffer_size):
    j, t = JSV(np.uint32, nullable=True), TSV(np.uint32, nullable=True)
    for sv in (j, t):
        sv.push_back(5)
        ins = sv.get_back_inserter()
        if buffer_size != 65536:
            ins = type(ins)(sv, buffer_size)
        with ins:
            for v in range(40):
                ins.add(v * 3)
                if v % 9 == 0:
                    ins.add_null(2)
            ins(1000)
    assert_same_sv(j, t)
    assert len(t) == 1 + 40 + 10 + 1
    plain = TSV(np.uint32)
    with pytest.raises(ValueError):
        plain.get_back_inserter().add_null().flush()


# ---------------------------------------------------------------------------
# BitMatrix
# ---------------------------------------------------------------------------
def test_bitmatrix():
    rng = np.random.default_rng(8)
    cols = rng.integers(0, BPB + 500, 60)
    octs = rng.integers(0, 256, cols.size)
    jm, tm = JBM(4, 0), tbm.BitMatrix(4, 0)
    for m in (jm, tm):
        for i, c in enumerate(cols):
            m.set_octet(int(c), i % 3, int(octs[i]))
        m.insert_column(7, 0x1F3)
        m.erase_column(int(cols[0]))
        m.clear_column(int(cols[1]))
        m.swap_rows(0, 1)
    assert tm.n_rows == jm.n_rows
    for a, b in zip(jm.rows, tm.rows):
        assert (a is None) == (b is None)
        if a is not None:
            assert_same_bv(a, b)
    probe = np.concatenate([cols, [7, 8]])
    for o in range(3):
        np.testing.assert_array_equal(tm.octets(probe, o), jm.octets(probe, o))
        assert [tm.get_octet(int(c), o) for c in probe[:10]] == \
            [jm.get_octet(int(c), o) for c in probe[:10]]
    assert [tm.get_column(int(c)) for c in probe] == \
        [jm.get_column(int(c)) for c in probe]
    tc = tbm.BitMatrix().copy_from(tm)
    assert tc.equal(tm) and tc.is_same_structure(tm)
    tc.row(0, construct=True).set(3)
    assert not tc.equal(tm)
    tm.optimize()
    jm.optimize()
    assert tm.calc_stat() == jm.calc_stat()
    assert tm.n_rows == 24
    tm.set_row(30, tbm.BitVector.from_indices([4], C.ID_MAX48))
    assert tm.n_rows == 31 and tm.get_column(4) >> 30 == 1
    tm.clear_row(30)
    tm.freeze()
    assert tm.rows[2].is_ro()
    assert tm.clear().n_rows == 31 and all(r is None for r in tm.rows)


# ---------------------------------------------------------------------------
# sv/util.py
# ---------------------------------------------------------------------------
def test_address_resolver_and_collections():
    ids = np.asarray([10, 100, 70_000, 3 * BPB + 5, 1 << 40], np.int64)
    ja, ta = jutil.AddressResolver(), tutil.AddressResolver()
    for r in (ja, ta):
        r.set_many(ids[:3])
        r.set(int(ids[3]))
        r.set(int(ids[4]))
    probe = np.concatenate([ids, [0, 11, 70_001, (1 << 40) + 1]])
    np.testing.assert_array_equal(ta.resolve_batch(probe),
                                  ja.resolve_batch(probe))
    assert [ta.resolve(int(i)) for i in probe] == \
        [ja.resolve(int(i)) for i in probe]
    assert ta.count() == 5
    assert_same_bv(ja.addr_bv, ta.addr_bv)
    for cls in ("CompressedCollection", "CompressedBufferCollection"):
        jc, tc = getattr(jutil, cls)(), getattr(tutil, cls)()
        for c in (jc, tc):
            c.push_back(5, b"five")
            c.push_back(100, b"hundred")
            c.push_back(BPB * 2, b"far")
            with pytest.raises(ValueError):
                c.push_back(50, b"out of order")
        assert tc[100] == jc[100] and tc.get(BPB * 2) == b"far"
        assert (5 in tc, 6 in tc, len(tc)) == (True, False, 3)
        np.testing.assert_array_equal(tc.keys(), jc.keys())
        with pytest.raises(KeyError):
            tc.get(6)


def test_sv_address_resolver():
    ids = [70_000, 5, 123_456, 5, 1 << 33, 9]
    ja, ta = jutil.SVAddressResolver(), tutil.SVAddressResolver()
    for r in (ja, ta):
        for i in ids:
            r.set(i)
        r.optimize()
    probe = ids + [6, 70_001]
    assert [ta.resolve(i) for i in probe] == [ja.resolve(i) for i in probe]
    np.testing.assert_array_equal(ta.resolve_batch(probe),
                                  ja.resolve_batch(probe))
    assert ta.count() == ja.count() == 5 and ta.get(5) == 2
    assert_same_bv(ja.get_bvector(), ta.get_bvector())
    assert_same_sv(ja.addr_sv, ta.addr_sv)


# ---------------------------------------------------------------------------
# sv/algo.py
# ---------------------------------------------------------------------------
def _mismatch_cases():
    vals, nm = _vals(9, 2 * BPB + 100)
    late = vals.copy()
    late[2 * BPB + 50] ^= 1
    return {
        "equal": (dict(values=vals), dict(values=vals.copy())),
        "late": (dict(values=vals), dict(values=late)),
        "first": (dict(values=vals), dict(values=np.r_[vals[0] + 1,
                                                       vals[1:]])),
        "nulls": (dict(values=vals, null_mask=nm),
                  dict(values=vals, null_mask=np.r_[nm[:-1], ~nm[-1]])),
        "one_nullable": (dict(values=vals, null_mask=np.zeros(vals.size,
                                                              bool)),
                         dict(values=vals)),
        "shorter": (dict(values=vals), dict(values=vals[:BPB + 3])),
        "empty": (dict(values=vals[:0]), dict(values=vals[:0])),
    }


@pytest.mark.parametrize("case", list(_mismatch_cases()))
def test_find_first_mismatch(case):
    a, b = _mismatch_cases()[case]
    ja, ta = pair(a.pop("values"), **a)
    jb, tb = pair(b.pop("values"), **b)
    want = jalgo.find_first_mismatch(ja, jb)
    assert tbm.find_first_mismatch(ta, tb) == want
    assert tbm.find_first_mismatch(tb, ta) == jalgo.find_first_mismatch(jb,
                                                                        ja)
    if case == "late":
        assert want == 2 * BPB + 50


def test_set2set_transform():
    vals, nm = _vals(10, 3000, hi=BPB * 3)
    j, t = pair(vals, null_mask=nm)
    ids = np.arange(0, 5000, 7)                 # some past the end
    jin = jbm.BitVector.from_indices(ids, C.ID_MAX48)
    tin = tbm.BitVector.from_indices(ids, C.ID_MAX48)
    want = jalgo.set2set_transform(j, jin)
    got = tbm.set2set_transform(t, tin)
    assert_same_bv(want, got)
    ok = ids[(ids < 3000)]
    ok = ok[~nm[ok]]
    np.testing.assert_array_equal(got.indices(), np.unique(vals[ok]))
    tr = tbm.Set2SetTransform()
    with pytest.raises(ValueError):
        tr.run(tin)
    assert tr.attach_sv(t).attached() is t
    assert_same_bits(want, tr.remap(tin))
    assert tbm.set2set_transform(
        t, tbm.BitVector.from_indices([4000], C.ID_MAX48)).none()


def test_exports_match_the_jax_package():
    import bitmagic_tpu.sv as jsv
    assert sorted(tbm.sv.__all__) == sorted(jsv.__all__)
    for name in jsv.__all__:
        assert hasattr(tbm.sv, name), name
    for name in ("BitMatrix", "RSCSparseVector", "StrSparseVector",
                 "FloatSparseVector", "find_first_mismatch",
                 "set2set_transform", "Set2SetTransform", "sv"):
        assert name in tbm.__all__ and hasattr(tbm, name), name
        assert hasattr(jbm, name), name
