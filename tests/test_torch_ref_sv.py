"""The reference's own sparse-vector BLOB format (``serial/ref_sv.py``) in
the PyTorch port, against the JAX package and the reference's fixtures on
the CPU (the cases of ``tests/test_ref_sv.py`` that need no reference
build).

The five sparse-vector fixtures written by the reference's
sparse_vector_serializer (``tests/fixtures/refblobs``) decode in the port
to the fixture inputs and to the JAX package's state; the port's 'BM' /
'BC' / string / 'bf0' BLOBs of containers built from the same seeded
numpy values are byte-identical to the JAX package's, with and without the
cross-plane XOR references.  Tolerance: exact equality (floats bit for
bit).
"""
import os
import struct

import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.serial import ref_sv as jref
from bitmagic_tpu_torch.serial import ref_sv as tref
from test_torch_containers import assert_same_float, assert_same_str
from test_torch_scanner import assert_same_sv

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refblobs")
_IN = np.load(os.path.join(FIX, "sv_inputs.npz"))
VALS, NOTNULL = _IN["vals"], _IN["notnull"].astype(bool)
IDX = np.flatnonzero(NOTNULL).astype(np.int64)
_SIN = np.load(os.path.join(FIX, "str_inputs.npz"), allow_pickle=True)
STRINGS = [s or None for s in _SIN["strings"].tolist()]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _blob(name):
    with open(os.path.join(FIX, name), "rb") as f:
        return f.read()


def _nullable_pair(n, hi, p_null, seed, dtype=np.uint32):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, hi, n).astype(dtype)
    nm = rng.random(n) < p_null
    nm[-1] = False
    arr = np.where(nm, 0, vals).astype(dtype)
    return (jbm.SparseVector.from_array(arr, nullable=True, null_mask=nm),
            tbm.SparseVector.from_array(arr, nullable=True, null_mask=nm),
            vals, nm)


# ---------------------------------------------------------------------------
# the reference's fixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sv_plain.bin", "sv_xor.bin"])
def test_reference_sv_fixture_decodes(name):
    sv = tref.deserialize_sv_blob(_blob(name), np.uint32, device="cpu")
    assert sv.size == len(VALS) and sv.device.type == "cpu"
    np.testing.assert_array_equal(sv.gather(IDX), VALS[IDX])
    nz = sv.null_plane.indices()
    nn = np.zeros(len(VALS), bool)
    nn[nz[nz < len(VALS)]] = True
    np.testing.assert_array_equal(nn, NOTNULL)
    assert_same_sv(jref.deserialize_sv_blob(_blob(name), np.uint32), sv)


def test_reference_rsc_fixture_decodes():
    rsc = tref.deserialize_rsc_blob(_blob("rsc.bin"), np.uint32)
    np.testing.assert_array_equal(rsc.gather(IDX), VALS[IDX])
    j = jref.deserialize_rsc_blob(_blob("rsc.bin"), np.uint32)
    assert_same_sv(j.dense, rsc.dense)
    np.testing.assert_array_equal(rsc.null_bv.indices(),
                                  np.asarray(j.null_bv.indices()))


@pytest.mark.parametrize("name", ["strsv_plain.bin", "strsv_remap.bin"])
def test_reference_str_fixture_decodes(name):
    ssv = tref.deserialize_str_blob(_blob(name))
    assert [g or None for g in ssv.to_list()] == STRINGS
    assert_same_str(jref.deserialize_str_blob(_blob(name)), ssv)


# ---------------------------------------------------------------------------
# our writer: bytes identical to the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("xor_refs", [True, False])
def test_sv_blob_bytes_identical(xor_refs):
    j, t, vals, nm = _nullable_pair(60_000, 1 << 16, 0.5, 4)
    blob = tref.serialize_sv_blob(t, xor_refs=xor_refs)
    assert blob == jref.serialize_sv_blob(j, xor_refs=xor_refs)
    back = tref.deserialize_sv_blob(blob, np.uint32)
    assert_same_sv(jref.deserialize_sv_blob(blob, np.uint32), back)
    ok = np.flatnonzero(~nm)
    np.testing.assert_array_equal(back.gather(ok), vals[ok])


@pytest.mark.parametrize("dtype", [np.int16, np.uint64])
def test_sv_blob_non_nullable_and_signed(dtype):
    rng = np.random.default_rng(12)
    info = np.iinfo(dtype)
    vals = rng.integers(max(int(info.min), -3000), 3000, 20_000).astype(dtype)
    j = jbm.SparseVector.from_array(vals)
    t = tbm.SparseVector.from_array(vals)
    blob = tref.serialize_sv_blob(t)
    assert blob == jref.serialize_sv_blob(j)
    back = tref.deserialize_sv_blob(blob, dtype)
    np.testing.assert_array_equal(back.to_numpy()[:vals.size], vals)
    assert_same_sv(jref.deserialize_sv_blob(blob, dtype), back)


def test_sv_xor_planes_shrink():
    rng = np.random.default_rng(14)
    vals = (rng.integers(0, 4, 200_000).astype(np.uint32) * 0x0F0F0F0) | 1
    t = tbm.SparseVector.from_array(vals, nullable=True)
    plain = tref.serialize_sv_blob(t, xor_refs=False)
    xored = tref.serialize_sv_blob(t, xor_refs=True)
    assert len(xored) < len(plain) // 2
    assert xored == jref.serialize_sv_blob(
        jbm.SparseVector.from_array(vals, nullable=True), xor_refs=True)
    back = tref.deserialize_sv_blob(xored)
    np.testing.assert_array_equal(back.to_numpy()[:len(vals)], vals)


def test_rsc_blob_bytes_identical():
    j, t, vals, nm = _nullable_pair(50_000, 1 << 16, 0.7, 6)
    jr = jbm.RSCSparseVector.from_sparse_vector(j)
    tr = tbm.RSCSparseVector.from_sparse_vector(t)
    blob = tref.serialize_rsc_blob(tr)
    assert blob == jref.serialize_rsc_blob(jr)
    back = tref.deserialize_rsc_blob(blob, np.uint32)
    ok = np.flatnonzero(~nm)
    np.testing.assert_array_equal(back.gather(ok), vals[ok])
    jb = jref.deserialize_rsc_blob(blob, np.uint32)
    assert_same_sv(jb.dense, back.dense)


@pytest.mark.parametrize("remap", [False, True])
def test_str_blob_bytes_identical(remap):
    sub = STRINGS[:5000]
    pair = []
    for pkg in (jbm, tbm):
        ssv = pkg.StrSparseVector.from_strings([s or "" for s in sub],
                                               nullable=True)
        for i, s in enumerate(sub):
            if not s:
                ssv.set_null(i)
        if remap:
            ssv.remap()
        pair.append(ssv)
    blob = tref.serialize_str_blob(pair[1])
    assert blob == jref.serialize_str_blob(pair[0])
    back = tref.deserialize_str_blob(blob)
    assert [g or None for g in back.to_list()] == sub
    assert_same_str(jref.deserialize_str_blob(blob), back)


def test_float_blob_bytes_identical():
    rng = np.random.default_rng(3)
    vals = (rng.standard_normal(20_000) * 100).astype(np.float32)
    vals[::11] = 0.0
    vals[1::17] = -0.0
    jf = jbm.FloatSparseVector.from_array(vals)
    tf = tbm.FloatSparseVector.from_array(vals)
    blob = tref.serialize_float_blob(tf)
    assert blob == jref.serialize_float_blob(jf)
    back = tref.deserialize_float_blob(blob)
    np.testing.assert_array_equal(back.to_numpy()[:len(vals)].view(np.uint32),
                                  vals.view(np.uint32))
    assert_same_float(jref.deserialize_float_blob(blob), back)
    with pytest.raises(ValueError):
        tref.serialize_float_blob(tbm.FloatSparseVector.from_array(
            vals.astype(np.float64)))
    with pytest.raises(ValueError):
        tref.deserialize_float_blob(b"bf1" + blob[3:])


def test_range_decode():
    j, t, vals, nm = _nullable_pair(250_000, 1 << 20, 0.4, 31)
    arr = np.where(nm, 0, vals)
    lo, hi = 100_000, 140_000
    blob = tref.serialize_sv_blob(t)
    part = tref.deserialize_sv_blob(blob, range_=(lo, hi))
    a = part.to_numpy()
    np.testing.assert_array_equal(a[lo:hi + 1], arr[lo:hi + 1])
    assert not a[:lo].any() and not a[hi + 1:250_000].any()
    assert_same_sv(jref.deserialize_sv_blob(blob, range_=(lo, hi)), part)
    rblob = tref.serialize_rsc_blob(tbm.RSCSparseVector.from_sparse_vector(t))
    rpart = tref.deserialize_rsc_blob(rblob, range_=(lo, hi))
    np.testing.assert_array_equal(rpart.gather(np.arange(lo, hi + 1)),
                                  arr[lo:hi + 1])
    jpart = jref.deserialize_rsc_blob(rblob, range_=(lo, hi))
    assert_same_sv(jpart.dense, rpart.dense)


def test_empty_and_all_null():
    sv = tbm.SparseVector(np.uint32, nullable=True)
    assert tref.serialize_sv_blob(sv) == b"BZ"
    assert tref.deserialize_sv_blob(b"BZ").size == 0
    assert tref.deserialize_rsc_blob(b"BZ").size == 0
    assert tref.deserialize_str_blob(b"BZ").size == 0
    sv.resize(100)
    blob = tref.serialize_sv_blob(sv)
    jsv = jbm.SparseVector(np.uint32, nullable=True)
    jsv.resize(100)
    assert blob == jref.serialize_sv_blob(jsv)
    back = tref.deserialize_sv_blob(blob)
    assert back.is_null(0) and back.is_null(99) and back.size == 100
    sv2 = tbm.SparseVector.from_array(np.arange(50, dtype=np.uint32))
    back2 = tref.deserialize_sv_blob(tref.serialize_sv_blob(sv2))
    assert not back2.is_null(3) and back2.get(3) == 3
    with pytest.raises(ValueError):
        tref.deserialize_sv_blob(b"XY")
    with pytest.raises(ValueError):
        tref.deserialize_rsc_blob(blob)          # a 'BM' BLOB


def test_sv_blob_adversarial_hardening():
    """Implausible plane counts, string widths and dense decode sizes fail
    fast with ValueError, as in the JAX package."""
    w = bytearray(b"BM")
    w += bytes([1, 0, 1])
    w += struct.pack("<Q", (1 << 60) | (1 << 63))
    w += struct.pack("<Q", 100)
    w += struct.pack("<Q", 40)
    w += b"\x00" * 4
    bad = bytes(w) + b"\x00" * 64
    with pytest.raises(ValueError):
        tref.deserialize_str_blob(bad)
    with pytest.raises((ValueError, IndexError)):
        tref.deserialize_sv_blob(bad)
    assert tref._DENSE_DECODE_CAP == jref._DENSE_DECODE_CAP == 1 << 31
    with pytest.raises(ValueError, match="memory-safe"):
        tref._cap_dense((1 << 31) + 1)
    assert tref._cap_dense(1 << 31) == 1 << 31


def test_gap_planes_round_trip():
    """Planes holding GAP blocks (an optimized vector) serialize from their
    runs; the decode gives the values back."""
    rng = np.random.default_rng(1)
    vals = np.zeros(300_000, np.uint32)
    vals[rng.integers(0, 300_000, 200)] = rng.integers(1, 1000, 200)
    sv = tbm.SparseVector.from_array(vals, nullable=True)
    sv.optimize()
    assert any(p is not None and p._gaps is not None for p in sv.planes)
    back = tref.deserialize_sv_blob(tref.serialize_sv_blob(sv))
    np.testing.assert_array_equal(back.to_numpy()[:300_000], vals)


def test_decoders_take_the_device(monkeypatch):
    blob = _blob("sv_plain.bin")
    monkeypatch.setattr(tbm.config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tref.deserialize_sv_blob(blob)
    sv = tref.deserialize_sv_blob(blob, device="cpu")
    assert sv.null_plane.device.type == "cpu"
    assert all(p is None or p.device.type == "cpu" for p in sv.planes)
    rsc = tref.deserialize_rsc_blob(_blob("rsc.bin"), device="cpu")
    assert rsc.device.type == "cpu"
    assert tref.deserialize_str_blob(_blob("strsv_remap.bin"),
                                     device="cpu").device.type == "cpu"
