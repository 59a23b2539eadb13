"""The sparse vectors' BMSV containers (``serial/sv_serial.py``) of the
PyTorch port against the JAX package on the CPU (the cases of
``tests/test_sv_serial.py``).

Both packages build each container from the same seeded numpy values and
serialize it with and without the cross-plane XOR groups: the BLOBs must
be byte-identical, and each package's decode of them (full, range and
gather) must give the same state (planes, NULL plane, remap matrices) and
values.  Decoders take ``device=``.  Tolerance: exact equality (floats
compared bit for bit).
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.serial import sv_serial as jsvs
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.serial import sv_serial as tsvs
from test_torch_containers import (assert_same_float, assert_same_rsc,
                                   assert_same_str)
from test_torch_scanner import assert_same_sv

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
N = 3 * BPB + 1234


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _int(pkg, rng, dtype, nullable):
    info = np.iinfo(dtype)
    lo, hi = max(int(info.min), -5000), min(int(info.max), 1 << 20)
    vals = rng.integers(lo, hi, N).astype(dtype)
    nm = rng.random(N) < 0.3 if nullable else None
    return pkg.SparseVector.from_array(vals, nullable=nullable, null_mask=nm)


def _rsc(pkg, rng):
    vals = rng.integers(1, 1 << 20, N).astype(np.uint32)
    nm = rng.random(N) < 0.6
    return pkg.RSCSparseVector.from_sparse_vector(
        pkg.SparseVector.from_array(vals, nullable=True, null_mask=nm))


def _str(pkg, rng, remap, nullable=False):
    words = [f"k{int(x):05d}" for x in rng.integers(0, 99999, 6000)]
    words[3] = "\xe9t\xe9"
    words[5] = ""
    ssv = pkg.StrSparseVector.from_strings(words, nullable=nullable)
    if nullable:
        ssv.set_null(7)
    if remap:
        ssv.remap()
    return ssv


def _float(pkg, rng, dtype, nullable):
    vals = (rng.standard_normal(20_000) * 100).astype(dtype)
    vals[::11] = 0.0
    vals[1::13] = -0.0
    fv = pkg.FloatSparseVector.from_array(vals, nullable=nullable)
    if nullable:
        fv.set_null(3)
    return fv


CONTAINERS = {
    "u32": lambda p, r: _int(p, r, np.uint32, False),
    "i32_nullable": lambda p, r: _int(p, r, np.int32, True),
    "u8": lambda p, r: _int(p, r, np.uint8, False),
    "i64_nullable": lambda p, r: _int(p, r, np.int64, True),
    "rsc": _rsc,
    "str": lambda p, r: _str(p, r, False),
    "str_remap_nullable": lambda p, r: _str(p, r, True, True),
    "f32": lambda p, r: _float(p, r, np.float32, False),
    "f64_nullable": lambda p, r: _float(p, r, np.float64, True),
}


def pair(kind, seed=0):
    return (CONTAINERS[kind](jbm, np.random.default_rng(seed)),
            CONTAINERS[kind](tbm, np.random.default_rng(seed)))


def assert_same(kind, j, t):
    if kind == "rsc":
        assert_same_rsc(j, t)
    elif kind.startswith("str"):
        assert_same_str(j, t)
    elif kind.startswith("f"):
        assert_same_float(j, t)
    else:
        assert_same_sv(j, t)


@pytest.fixture(scope="module")
def blobs():
    """kind -> (jax container, port container, {xor: (jax blob, port
    blob)})."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbm.config, "device", "cpu")
        for kind in CONTAINERS:
            j, t = pair(kind)
            out[kind] = (j, t, {
                xor: (_ser(jsvs, j, xor), _ser(tsvs, t, xor))
                for xor in (True, False)})
    return out


def _ser(mod, c, xor):
    s = mod.SparseVectorSerializer(6, xor_filter=xor)
    name = type(c).__name__
    return {"SparseVector": s.serialize,
            "RSCSparseVector": s.serialize_rsc,
            "StrSparseVector": s.serialize_str,
            "FloatSparseVector": s.serialize_float}[name](c)


@pytest.mark.parametrize("xor", [True, False])
@pytest.mark.parametrize("kind", sorted(CONTAINERS))
def test_bmsv_bytes_identical_and_decode(blobs, kind, xor):
    j, t, by_xor = blobs[kind]
    jb, tb = by_xor[xor]
    assert tb == jb
    assert tsvs.sparse_vector_serialize(t) == by_xor[True][1]
    jd = jsvs.sparse_vector_deserialize(jb)
    td = tsvs.sparse_vector_deserialize(tb, device="cpu")
    assert_same(kind, jd, td)
    assert td.size == t.size


@pytest.mark.parametrize("kind", sorted(CONTAINERS))
def test_range_and_gather_decode(blobs, kind):
    j, t, by_xor = blobs[kind]
    n = t.size
    lo, hi = n // 3, n // 3 + 5000
    rng = np.random.default_rng(9)
    ids = np.sort(rng.choice(n, 40, replace=False))
    jde, tde = jsvs.SparseVectorDeserializer(), \
        tsvs.SparseVectorDeserializer("cpu")
    for xor in (True, False):
        jb, tb = by_xor[xor]
        assert_same(kind, jde.deserialize_range(jb, lo, hi),
                    tde.deserialize_range(tb, lo, hi))
        assert_same(kind, jde.deserialize_gather(jb, ids),
                    tde.deserialize_gather(tb, ids))
    part = tde.deserialize_gather(by_xor[True][1], ids)
    want = t.gather(ids)
    got = part.gather(ids)
    if kind.startswith("f"):
        np.testing.assert_array_equal(np.asarray(got).view(np.uint8),
                                      np.asarray(want).view(np.uint8))
    else:
        assert list(got) == list(want)
    with pytest.raises(ValueError):
        tde.deserialize_range(by_xor[True][1], 10, 5)
    with pytest.raises(ValueError):
        tde.deserialize_gather(by_xor[True][1], [])


def test_xor_filter_helps_correlated(rng):
    base = rng.integers(0, 2, 60000).astype(np.uint32)
    vals = base * 0b1111111          # planes 0..6 identical
    sv = tbm.SparseVector.from_array(vals)
    on = tsvs.SparseVectorSerializer(6, xor_filter=True).serialize(sv)
    off = tsvs.SparseVectorSerializer(6).disable_xor_compression() \
        .serialize(sv)
    assert len(on) < len(off) // 2
    assert on == jsvs.SparseVectorSerializer(6).serialize(
        jbm.SparseVector.from_array(vals))
    np.testing.assert_array_equal(
        tsvs.sparse_vector_deserialize(on).to_numpy(), vals)


def test_serializer_knobs():
    s = tsvs.SparseVectorSerializer()
    assert s.is_xor_ref()
    assert not s.disable_xor_compression().is_xor_ref()
    assert s.enable_xor_compression().is_xor_ref()
    assert not s.set_xor_ref(None).is_xor_ref()
    assert s.set_xor_ref([1, 2]).is_xor_ref()
    assert s.compute_sim_model() is None
    assert s.set_sim_model({}) is s and s.set_bookmarks(True, 64) is s


def test_finalization_and_device(monkeypatch, blobs):
    """Decoders build on the device they are given: with the default
    device the absent card, ``device="cpu"`` must put every part on the
    CPU; READONLY finalization freezes the container."""
    _, t, by_xor = blobs["i32_nullable"]
    monkeypatch.setattr(tbm.config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsvs.sparse_vector_deserialize(by_xor[True][1])
    de = tsvs.SparseVectorDeserializer("cpu").set_finalization("READONLY")
    for kind in ("i32_nullable", "rsc", "str_remap_nullable",
                 "f64_nullable"):
        d = de.deserialize(blobs[kind][2][True][1])
        assert d.device.type == "cpu" and d.is_ro()
    sv = tsvs.SparseVectorDeserializer("cpu").deserialize(by_xor[True][1])
    assert not sv.is_ro()
    assert all(p is None or p.device.type == "cpu" for p in sv.planes)


def test_malformed_streams_raise():
    sv = tbm.SparseVector.from_array(np.arange(100, dtype=np.uint32))
    blob = tsvs.SparseVectorSerializer(xor_filter=False).serialize(sv)
    with pytest.raises(ValueError):
        tsvs.sparse_vector_deserialize(b"XXXX" + blob[4:])
    bad = bytearray(blob)
    bad[4] = 7                      # unknown container type
    with pytest.raises(ValueError):
        tsvs.sparse_vector_deserialize(bytes(bad))
    # the first plane record's slice id out of range, and one duplicated
    at = 4 + 1 + 1 + 1 + 8 + 2 + 8
    for sid in (200, 1):
        bad = bytearray(blob)
        bad[at] = sid
        with pytest.raises(ValueError):
            tsvs.sparse_vector_deserialize(bytes(bad))
        with pytest.raises(ValueError):
            jsvs.sparse_vector_deserialize(bytes(bad))


def test_compressed_collection_roundtrip():
    from bitmagic_tpu.sv.util import CompressedBufferCollection as JColl
    from bitmagic_tpu_torch.sv.util import CompressedBufferCollection
    items = [(10, b"alpha"), (42, b"beta" * 50), (9_000_000, b""),
             (10_000_000, b"far")]
    coll, jcoll = CompressedBufferCollection(), JColl()
    for k, v in items:
        coll.push_back(k, v)
        jcoll.push_back(k, v)
    blob = tsvs.serialize_compressed_collection(coll)
    assert blob == jsvs.serialize_compressed_collection(jcoll)
    back = tsvs.deserialize_compressed_collection(blob, device="cpu")
    assert list(back.keys()) == [10, 42, 9_000_000, 10_000_000]
    assert back[42] == b"beta" * 50 and back[9_000_000] == b""
    assert 10 in back and 11 not in back
    with pytest.raises(ValueError):
        tsvs.deserialize_compressed_collection(b"XXXX" + blob[4:])


def test_sv_serial_names_exported():
    import bitmagic_tpu.serial as jser
    names = set(jser.__all__) - {"refformat"}
    assert names <= set(tbm.serial.__all__)
    for name in names:
        assert getattr(tbm.serial, name) is not None
    for name in ("SparseVectorSerializer", "SparseVectorDeserializer",
                 "sparse_vector_serialize", "sparse_vector_deserialize"):
        assert getattr(tbm, name) is getattr(tbm.serial, name)
