"""The reference-format codec of the PyTorch port (``serial/refcodec.py``)
against the JAX package, on the CPU.

The 94 bit-vector BLOBs that the reference's own serializer wrote into
``tests/fixtures/refblobs/`` decode to ``inputs.npz`` and to the JAX
package's decode; the port's reference-format BLOBs are byte-identical to
the JAX package's at levels 0-6, with bookmarks and with XOR-reference
filters; each package decodes the other's BLOBs to the same state;
malformed BLOBs raise the same exception types.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.serial import refcodec as jrc
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.serial import refcodec as trc
from test_torch_bitvector import assert_same_state
from test_torch_serial import (KINDS, _corruptions, assert_same_outcome,
                               make_vectors, outcome)

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refblobs")
with open(os.path.join(FIX, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
# the bit-vector BLOBs: all but the five sparse-vector ones
BV_BLOBS = [b for b in MANIFEST["blobs"]
            if b["dist"] not in ("sv", "rsc", "strsv")]
XOR_REFS = {"xor_target.bin": ("xor_inputs.npz", ((0, "ref"),)),
            "xor_chain.bin": ("xor_chain_inputs.npz",
                              ((0, "ref"), (2, "ref2")))}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


@pytest.fixture(scope="module")
def inputs():
    return np.load(os.path.join(FIX, "inputs.npz"))


@pytest.fixture(scope="module")
def vecs():
    return make_vectors()


def _refs(pkg, entry):
    """(expected ids, the (row, vector) collection) of a fixture."""
    data = np.load(os.path.join(FIX, XOR_REFS[entry["file"]][0]))
    refs = [(row, pkg.BitVector.from_indices(data[key], MANIFEST["size"]))
            for row, key in XOR_REFS[entry["file"]][1]]
    return data["target"], refs


def test_fixture_count():
    assert len(BV_BLOBS) == 94
    assert sum(b["options"] == "xor" for b in BV_BLOBS) == 2


@pytest.mark.parametrize("entry", BV_BLOBS, ids=[b["file"] for b in BV_BLOBS])
def test_fixture_decodes(entry, inputs):
    """Every bit-vector BLOB of the reference decodes to its input ids and
    to the JAX package's decoded state."""
    with open(os.path.join(FIX, entry["file"]), "rb") as f:
        blob = f.read()
    if entry["options"] == "xor":
        expected, jrefs = _refs(jbm, entry)
        _, trefs = _refs(tbm, entry)
    else:
        expected, jrefs, trefs = inputs[entry["dist"]], [], []
    td = trc.RefDeserializer(trefs, device="cpu")
    got = td.deserialize(blob)
    np.testing.assert_array_equal(got.indices(), expected)
    assert got.size == MANIFEST["size"] and got.device.type == "cpu"
    jd = jrc.RefDeserializer(jrefs)
    assert_same_state(jd.deserialize(blob), got)
    assert td.code_stat == jd.code_stat
    # the Deserializer front end sniffs the format
    d = tbm.Deserializer().set_ref_vectors(trefs)
    np.testing.assert_array_equal(d.deserialize(blob).indices(), expected)


@pytest.mark.parametrize("level", range(7))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_blob_bytes_identical(vecs, kind, level):
    jv, tv = vecs[kind]
    js, ts = jrc.RefSerializer(level), trc.RefSerializer(level)
    blob = ts.serialize(tv)
    assert blob == js.serialize(jv)
    assert ts.get_compression_stat() == js.get_compression_stat()
    bm_blob = trc.RefSerializer(level).set_bookmarks(True, 8).serialize(tv)
    assert bm_blob == jrc.RefSerializer(level).set_bookmarks(
        True, 8).serialize(jv)
    for b in (blob, bm_blob):
        assert_same_state(jrc.ref_deserialize(b), trc.ref_deserialize(b))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cross_decode(vecs, kind):
    jv, tv = vecs[kind]
    jblob, tblob = jrc.ref_serialize(jv), trc.ref_serialize(tv)
    assert_same_state(jrc.ref_deserialize(tblob), trc.ref_deserialize(jblob))
    np.testing.assert_array_equal(trc.ref_deserialize(jblob).indices(),
                                  tv.indices())


def _xor_pair(rng, size):
    """(target ids, reference ids): the reference with per-block changes
    and one dense wave the target lacks."""
    ref_ids = np.unique(rng.integers(0, size, 60_000))
    tgt = set(int(i) for i in ref_ids)
    for b in range(8, 14):
        for i in rng.integers(b * BPB, (b + 1) * BPB, 25):
            tgt.symmetric_difference_update([int(i)])
    base = 20 * BPB
    extra = np.arange(base + 40 * 1024, base + 41 * 1024)
    ref_ids = np.union1d(ref_ids, extra)
    tgt.difference_update(int(i) for i in extra)
    return np.asarray(sorted(tgt), np.int64), ref_ids.astype(np.int64)


def xor_vectors(pkg, seed=21, size=1_600_000):
    rng = np.random.default_rng(seed)
    tgt_ids, ref_ids = _xor_pair(rng, size)
    ref2 = np.unique(rng.integers(0, size, 30_000))
    return (pkg.BitVector.from_indices(tgt_ids, size),
            [(0, pkg.BitVector.from_indices(ref_ids, size)),
             (2, pkg.BitVector.from_indices(ref2, size))])


@pytest.mark.parametrize("level", [4, 5, 6])
def test_xor_reference_filters(level):
    """BLOBs written with XOR-reference filters: the same bytes, the same
    compression statistics, and the same decode in both packages."""
    jt, jrefs = xor_vectors(jbm)
    tt, trefs = xor_vectors(tbm)
    js = jrc.RefSerializer(level, ref_vectors=jrefs)
    ts = trc.RefSerializer(level, ref_vectors=trefs)
    blob = ts.serialize(tt)
    assert blob == js.serialize(jt)
    assert ts.compression_stat == js.compression_stat
    got = trc.RefDeserializer(trefs).deserialize(blob)
    assert got.equal(tt)
    assert_same_state(jrc.RefDeserializer(jrefs).deserialize(blob), got)
    # a precomputed similarity model gives the same bytes
    model = trc.RefSerializer(level).compute_sim_model(trefs)
    ts2 = trc.RefSerializer(level, ref_vectors=trefs).set_sim_model(model)
    assert ts2.serialize(tt) == blob
    if level >= 5:                  # the XOR filter is on from level 5
        assert ts.compression_stat.get("xor_ref")
        assert ts.compression_stat.get("ref_eq")
        with pytest.raises(ValueError):
            trc.ref_deserialize(blob)


def test_range_decode_with_and_without_bookmarks(inputs):
    for file in ("midsparse_L6_bm.bin", "clustered_L6.bin",
                 "runs_L3_gap.bin"):
        with open(os.path.join(FIX, file), "rb") as f:
            blob = f.read()
        ids = inputs[file.split("_")[0]]
        for lo, hi in [(int(ids[len(ids) // 3]), int(ids[2 * len(ids) // 3])),
                       (int(ids[10]) + 3, int(ids[-10]))]:
            got = trc.RefDeserializer().deserialize_range(blob, lo, hi)
            np.testing.assert_array_equal(
                got.indices(), ids[(ids >= lo) & (ids <= hi)])
            assert_same_state(
                jrc.RefDeserializer().deserialize_range(blob, lo, hi), got)


def _hdr(mod, size=2_000_000):
    w = mod._ByteWriter()
    w.put_8(mod.HM_RESIZE)
    w.put_8(1)
    for g in mod.DEFAULT_GLEVELS:
        w.put_16(g)
    w.put_32(size)
    return w


def _crafted(mod):
    """Hand-made streams of codes the reference serializer no longer
    writes, built with ``mod``'s own writers."""
    out = {}
    w = _hdr(mod)
    w.put_8(mod.BLOCK_BIT_INTERVAL)
    w.put_16(3)
    w.put_16(4)
    w.put_u32_words(np.asarray([0x1, 0x80000000], np.uint32))
    out["bit_interval"] = w
    w = _hdr(mod)
    w.put_8(mod.BLOCK_BIT_DIGEST0)
    w.put_64((1 << 0) | (1 << 63))
    wave = np.zeros(32, np.uint32)
    wave[0] = 0b101
    w.put_u32_words(wave)
    w.put_u32_words(wave[::-1])
    out["digest0"] = w
    w = _hdr(mod)
    w.put_8(mod.BLOCK_ARRGAP_INV)
    w.put_16(3)
    w.put_u16_array([10, 500, 60_000])
    out["arrgap_inv"] = w
    w = _hdr(mod)
    w.put_8(mod.BLOCK_GAP_BIENC)
    w.put_16((3 << 3) | 0)
    w.put_16(100)
    bo = mod._BitOut(w)
    bo.bic_encode_cm([200], 100, 65535)
    bo.flush()
    out["gap_bienc_v1"] = w
    w = _hdr(mod)
    w.put_8(mod.BLOCK_ARRGAP_EGAMMA_INV)
    bo = mod._BitOut(w)
    bo.gamma(3)
    for v in (4, 74, 947):
        bo.gamma(v)
    bo.flush()
    out["arrgap_egamma_inv"] = w
    w = _hdr(mod)
    w.put_8(mod.BLOCK_8ONE)
    w.put_8(2)
    w.put_8(0x80 | 3)
    w.put_8(mod.BLOCK_16ZERO)
    w.put_16(4)
    w.put_8(mod.BLOCK_BIT_1BIT)
    w.put_16(7)
    out["runs_1bit"] = w
    w = _hdr(mod)
    w.put_8(mod.SBLOCK_BIENC)
    w.put_8(mod.SB_FLAG_MAX24)
    w.put_8(0)
    w.put_8(3)
    w.put_8(100)
    w.put_24(mod.SUB_TOTAL_BITS - 300_000)
    bo = mod._BitOut(w)
    bo.bic_encode_cm([5000], 100, 300_000)
    bo.flush()
    out["sblock_v1"] = w
    for w in out.values():
        w.put_8(mod.BLOCK_END)
    return {k: w.get_bytes() for k, w in out.items()}


def test_crafted_legacy_streams():
    """The port's writers build the same legacy streams, and both
    decoders read them to the same state."""
    tblobs, jblobs = _crafted(trc), _crafted(jrc)
    assert tblobs == jblobs
    for name, blob in tblobs.items():
        assert_same_state(jrc.ref_deserialize(blob),
                          trc.ref_deserialize(blob))
    ids = trc.ref_deserialize(tblobs["runs_1bit"]).indices()
    np.testing.assert_array_equal(
        ids, np.concatenate([np.arange(2 * BPB), [9 * BPB + 7]]))


def test_id_list_header():
    w = trc._ByteWriter()
    w.put_8(trc.HM_ID_LIST | trc.HM_RESIZE | trc.HM_NO_BO | trc.HM_NO_GAPL)
    w.put_32(2_000_000)
    w.put_32(3)
    for i in (3, 99, 1_500_000):
        w.put_32(i)
    blob = w.get_bytes()
    got = trc.ref_deserialize(blob)
    assert got.indices().tolist() == [3, 99, 1_500_000]
    assert_same_state(jrc.ref_deserialize(blob), got)


def test_wide_one_run_decodes_to_runs():
    size = 1 << 32
    jv, tv = jbm.BitVector(size), tbm.BitVector(size)
    for v in (jv, tv):
        v.set_range(0, (1 << 31) - 1)
    blob = trc.ref_serialize(tv)
    assert blob == jrc.ref_serialize(jv) and len(blob) < 200
    got = trc.ref_deserialize(blob)
    assert got._struct.has_runs and got.count() == 1 << 31
    assert_same_state(jrc.ref_deserialize(blob), got)


@pytest.mark.parametrize("kind", ["mixed_a", "gappy"])
def test_malformed_blobs_raise_alike(vecs, kind):
    _, tv = vecs[kind]
    blob = trc.ref_serialize(tv)
    rng = np.random.default_rng(7)
    for bad in _corruptions(blob, rng):
        if len(bad) < 2:
            continue
        assert_same_outcome(outcome(lambda: jrc.ref_deserialize(bad)),
                            outcome(lambda: trc.ref_deserialize(bad)))


def test_adversarial_blobs():
    """The round-5 hardening comes across: a one-run claiming 2^48
    blocks, an inverted word interval, an inverted BIC range."""
    head = bytes([trc.HM_NO_BO | trc.HM_NO_GAPL])
    blobs = [head + bytes([trc.BLOCK_64ONE]) + struct.pack("<Q", 1 << 48),
             head + bytes([trc.BLOCK_BIT_INTERVAL])
             + struct.pack("<HH", 5, 0),
             head + bytes([trc.BLOCK_GAP_BIENC])
             + struct.pack("<HH", (3 << 3), 900) + b"\0" * 8]
    for blob in blobs:
        want = outcome(lambda: jrc.ref_deserialize(blob))
        got = outcome(lambda: trc.ref_deserialize(blob))
        assert_same_outcome(want, got)
    with pytest.raises(ValueError):
        trc.ref_deserialize(blobs[0])
    with pytest.raises(ValueError):
        trc._BitIn(trc._ByteReader(b"\0" * 16)).bic_decode_cm(3, 10, 5)
