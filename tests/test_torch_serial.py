"""BMT1 serialization of the PyTorch port against the JAX package, on the
CPU: BLOB bytes, cross decoding, range decoding, the Python record path,
malformed BLOBs, the stream iterator, XOR groups, ``GapStore.to_dense`` on
the native expansion, and no silent fallback when the native library is
missing.  The same numpy-seeded vectors go through both packages; BLOBs
must be byte-identical and decoded states (structure, dense rows, GAP
runs) identical.
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.core.gapstore import GapStore as JGapStore
from bitmagic_tpu.serial import native as jnative
from bitmagic_tpu.serial import serializer as jser
from bitmagic_tpu.serial import stream_iter as jsi
from bitmagic_tpu.serial import xor_group as jxg
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.core.gapstore import GapStore
from bitmagic_tpu_torch.serial import native
from bitmagic_tpu_torch.serial import serializer as tser
from bitmagic_tpu_torch.serial import stream_iter as tsi
from bitmagic_tpu_torch.serial import xor_group as txg
from test_torch_bitvector import assert_same_state, build_pair

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
B32 = 1 << 32


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _partial_last(pkg):
    size = 7 * BPB + 12345
    rng = np.random.default_rng(3)
    v = pkg.BitVector.from_indices(rng.integers(0, size, 30000), size)
    v.set_range(6 * BPB + 100, size - 1)        # into the partial block
    v.set_range(2 * BPB, 4 * BPB - 1)           # FULL blocks
    v.optimize()
    return v


def _high(pkg):
    size = 1 << 40
    rng = np.random.default_rng(5)
    ids = np.concatenate([rng.integers(0, 3 * BPB, 2000),
                          B32 + rng.integers(0, 2 * BPB, 3000),
                          [size - 2, (1 << 36) + 7]])
    v = pkg.BitVector.from_indices(ids, size)
    v.set_range((1 << 36) + BPB, (1 << 36) + 40 * BPB - 1)   # a FULL run
    return v


def _full(pkg):
    size = 5 * BPB + 77
    v = pkg.BitVector(size)
    v.set_range(0, size - 1)
    v.optimize()
    return v


def _gappy(pkg):
    """A GAP-heavy vector: clustered runs, most blocks GAP-resident."""
    rng = np.random.default_rng(11)
    size = 48 * BPB
    starts = rng.integers(0, size - 400, 400)
    ids = np.unique(np.concatenate(
        [np.arange(s, s + n)
         for s, n in zip(starts, rng.integers(30, 300, 400))]))
    v = pkg.BitVector.from_indices(ids, size)
    v.optimize()
    return v


KINDS = {
    "mixed_a": lambda pkg: build_pair(pkg)[0],
    "mixed_b": lambda pkg: build_pair(pkg)[1],
    "partial_last": _partial_last,
    "above_2_32": _high,
    "empty": lambda pkg: pkg.BitVector(9 * BPB),
    "full": _full,
    "gappy": _gappy,
}


def make_vectors():
    """{kind: (JAX vector, port vector)} built by the same calls."""
    old = tbm.config.device
    tbm.config.device = "cpu"
    try:
        return {k: (f(jbm), f(tbm)) for k, f in KINDS.items()}
    finally:
        tbm.config.device = old


@pytest.fixture(scope="module")
def vecs():
    return make_vectors()


# ---------------------------------------------------------------------------
# BLOB bytes and decoding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("level", range(7))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_blob_bytes_identical(vecs, kind, level):
    jv, tv = vecs[kind]
    js, ts = jbm.Serializer(level), tbm.Serializer(level)
    want = js.serialize(jv)
    assert ts.serialize(tv) == want
    assert ts.get_compression_stat() == js.get_compression_stat()
    # BMT1 bookmarks are recorded only: the bytes do not change
    ts.set_bookmarks(True, 16)
    assert ts.serialize(tv) == want


@pytest.mark.parametrize("density", [0.44, 0.56])
def test_bic_record_larger_than_raw(density):
    """At level 6 a block of ~29000 set (or clear) bits is written as an
    ARR_BIC(_INV) record chosen on its size estimate; its payload outgrows
    the 8 KiB of a RAW record.  The native encoder must make room for it
    and write the JAX package's bytes."""
    rng = np.random.default_rng(0)
    ids = np.flatnonzero(rng.random(3 * BPB) < density)
    jv = jbm.BitVector.from_indices(ids, 3 * BPB)
    tv = tbm.BitVector.from_indices(ids, 3 * BPB, device="cpu")
    want = jbm.Serializer(6).serialize(jv)
    assert len(want) > 3 * 8192
    assert tbm.Serializer(6).serialize(tv) == want


@pytest.mark.parametrize("n_full", [1, 4, 40])
def test_full_blocks_only(n_full):
    """A vector of FULL blocks only (an optimized plane) has no payload
    row; the native encoder must still take it and write the JAX
    package's bytes."""
    ids = np.arange(n_full * BPB, dtype=np.int64)
    jv = jbm.BitVector.from_indices(ids, C.ID_MAX48)
    tv = tbm.BitVector.from_indices(ids, C.ID_MAX48, device="cpu")
    jv.optimize()
    tv.optimize()
    for level in (1, 6):
        want = jbm.Serializer(level).serialize(jv)
        assert tbm.Serializer(level).serialize(tv) == want


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cross_decode(vecs, kind):
    """Each package decodes the other's BLOB to the same state, GAP
    records kept run-coded in a GapStore by both."""
    jv, tv = vecs[kind]
    for level in (1, 4, 6):
        blob = tbm.serialize(tv, level)
        got, want = tbm.deserialize(blob), jbm.deserialize(blob)
        assert_same_state(want, got)
        assert_same_state(jbm.deserialize(jbm.serialize(jv, level)),
                          tbm.deserialize(blob))
        np.testing.assert_array_equal(got.indices(), tv.indices())
        assert got.size == tv.size and got.device.type == "cpu"


@pytest.mark.parametrize("kind", ["mixed_a", "partial_last", "gappy",
                                  "above_2_32"])
def test_range_decode(vecs, kind):
    jv, tv = vecs[kind]
    blob = tbm.serialize(tv)
    size = tv.size
    for lo, hi in [(0, size - 1), (BPB + 5, 3 * BPB), (17, 17),
                   (2 * BPB + 1000, size - 3)]:
        got = tbm.Deserializer().deserialize_range(blob, lo, hi)
        want = jbm.Deserializer().deserialize_range(blob, lo, hi)
        assert_same_state(want, got)
        # set_range applies the same window to a plain deserialize()
        d = tbm.Deserializer().set_range(lo, hi)
        assert_same_state(want, d.deserialize(blob))
        assert_same_state(jbm.deserialize(blob).keep_range(lo, hi),
                          d.unset_range().deserialize(blob).keep_range(lo,
                                                                       hi))
        np.testing.assert_array_equal(
            got.indices(), tv.copy().keep_range(lo, hi).indices())


def test_python_record_path(vecs, monkeypatch):
    """BLOBs the native decoders turn down are walked record by record in
    Python, to the same state (and GAP records stay run-coded)."""
    monkeypatch.setattr(native, "bmt1_decode_gap", lambda *a, **k: None)
    monkeypatch.setattr(native, "bmt1_decode", lambda *a, **k: None)
    for kind in sorted(KINDS):
        jv, tv = vecs[kind]
        blob = tbm.serialize(tv)
        assert_same_state(jbm.deserialize(blob), tbm.deserialize(blob))


def test_interchange_with_the_python_encoder(vecs, monkeypatch):
    """The JAX package's pure-Python record encoder writes the same bytes
    as the port's native whole-BLOB encoder, and the port decodes them."""
    for kind in ("mixed_a", "partial_last", "gappy"):
        jv, tv = vecs[kind]
        native_blobs = {lv: tbm.serialize(tv, lv) for lv in range(7)}
        with monkeypatch.context() as m:
            m.setattr(jnative, "bmt1_encode", lambda *a, **k: None)
            py_blobs = {lv: jbm.serialize(jv, lv) for lv in range(7)}
        for lv in range(7):
            assert py_blobs[lv] == native_blobs[lv], (kind, lv)


def test_uint8_array_and_compact_header(vecs):
    jv, tv = vecs["mixed_a"]
    blob = tbm.serialize(tv)
    arr = np.frombuffer(blob, np.uint8).copy()
    assert_same_state(jv, tbm.deserialize(arr))
    lo, hi = 100000, 200000
    assert_same_state(jbm.Deserializer().deserialize_range(arr, lo, hi),
                      tbm.Deserializer().deserialize_range(arr, lo, hi))


def test_serializer_knobs(vecs):
    jv, tv = vecs["mixed_a"]
    s = tbm.Serializer(6).allow_stat_reset(False)
    s.serialize(tv)
    s.serialize(tv)
    j = jbm.Serializer(6).allow_stat_reset(False)
    j.serialize(jv)
    j.serialize(jv)
    assert s.get_compression_stat() == j.get_compression_stat()
    assert s.reset_compression_stats().get_compression_stat() == {}
    with pytest.raises(ValueError):
        tbm.Serializer(7)
    v = tv.copy()
    blob = tbm.Serializer(6).optimize_serialize_destroy(v)
    assert v.none() and blob == jbm.Serializer(6).optimize_serialize_destroy(
        jv.copy())


def _corruptions(blob, rng):
    yield blob[:13]
    for cut in rng.integers(14, len(blob), 6):
        yield blob[:int(cut)]
    for pos in rng.integers(13, len(blob), 10):
        b = bytearray(blob)
        b[int(pos)] ^= 0xFF
        yield bytes(b)
    for pos in rng.integers(13, max(14, len(blob) - 8), 4):
        b = bytearray(blob)
        b[int(pos):int(pos) + 8] = rng.integers(0, 256, 8,
                                                dtype=np.uint8).tobytes()
        yield bytes(b)
    yield blob[:20] + b"\x80"                # lone varint continuation


def outcome(fn):
    """("ok", parts) of a decode, or ("err", exception type)."""
    try:
        v = fn()
    except Exception as e:              # the type is what is compared
        return "err", type(e)
    return "ok", v


def assert_same_outcome(want, got):
    assert want[0] == got[0], (want, got)
    if want[0] == "err":
        assert want[1] is got[1], (want[1], got[1])
    else:
        assert_same_state(want[1], got[1])


@pytest.mark.parametrize("kind", ["mixed_a", "gappy"])
def test_malformed_blobs_raise_alike(vecs, kind):
    """Truncated and corrupted BLOBs raise the same exception type in both
    packages, or decode to the same state."""
    _, tv = vecs[kind]
    blob = tbm.serialize(tv)
    rng = np.random.default_rng(99)
    for bad in _corruptions(blob, rng):
        assert_same_outcome(outcome(lambda: jbm.deserialize(bad)),
                            outcome(lambda: tbm.deserialize(bad)))
        assert_same_outcome(
            outcome(lambda: jbm.Deserializer().deserialize_range(
                bad, BPB, 5 * BPB)),
            outcome(lambda: tbm.Deserializer().deserialize_range(
                bad, BPB, 5 * BPB)))


def test_no_silent_fallback(vecs, monkeypatch):
    """Without the native library serialization raises: nothing encodes
    or decodes in Python instead."""
    _, tv = vecs["mixed_a"]
    blob = tbm.serialize(tv)
    gaps = vecs["gappy"][1]._gaps

    def missing():
        raise RuntimeError("codec library unavailable")

    monkeypatch.setattr(native, "load", missing)
    with pytest.raises(RuntimeError, match="unavailable"):
        tbm.serialize(tv)
    with pytest.raises(RuntimeError, match="unavailable"):
        tbm.deserialize(blob)
    with pytest.raises(RuntimeError, match="unavailable"):
        tbm.serial.ref_serialize(tv)
    with pytest.raises(RuntimeError, match="unavailable"):
        GapStore(gaps.ends, gaps.offs, gaps.first).to_dense()


# ---------------------------------------------------------------------------
# GapStore.to_dense on the native expansion
# ---------------------------------------------------------------------------
def _to_dense_np(store, sel=None):
    """The numpy expansion the port used before the native one."""
    sub = store if sel is None else store.subset(sel)
    k = sub.n_blocks
    if k == 0:
        return np.zeros((0, C.SET_BLOCK_SIZE), np.uint32)
    toggles = np.zeros((k, BPB), np.uint8)
    rb = sub.run_block()
    starts = sub.ends + 1
    inside = starts < BPB
    np.bitwise_xor.at(toggles, (rb[inside], starts[inside]), 1)
    toggles[:, 0] ^= sub.first
    bits = np.bitwise_xor.accumulate(toggles, axis=1)
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _store(n_blocks, seed):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n_blocks, C.SET_BLOCK_SIZE), np.uint32)
    for k in range(n_blocks):
        for s in rng.integers(0, BPB - 600, int(rng.integers(0, 6))):
            a = int(s)
            b = a + int(rng.integers(1, 500))
            bits = np.zeros(BPB, np.uint8)
            bits[a:b] = 1
            rows[k] |= np.packbits(bits, bitorder="little").view(np.uint32)
    rows[0] = 0xFFFFFFFF                    # one run, first = 1
    rows[-1, -1] = 0x80000000               # the last bit alone
    parts = GapStore.from_dense(rows)
    return (GapStore(parts.ends, parts.offs, parts.first),
            JGapStore(parts.ends, parts.offs, parts.first), rows)


@pytest.mark.parametrize("sel_kind", ["none", "index", "mask", "list",
                                      "empty", "one"])
def test_gapstore_to_dense(sel_kind):
    t, j, rows = _store(40, 3)
    sel = {"none": None, "index": np.asarray([5, 0, 39, 5, 12]),
           "mask": np.arange(40) % 3 == 0, "list": [1, 2, 3],
           "empty": np.zeros(0, np.int64), "one": np.asarray([7])}[sel_kind]
    got = t.to_dense(sel)
    np.testing.assert_array_equal(got, _to_dense_np(t, sel))
    np.testing.assert_array_equal(got, j.to_dense(sel))
    if sel is None:
        np.testing.assert_array_equal(got, rows)
    assert got.dtype == np.uint32 and got.shape[1] == C.SET_BLOCK_SIZE


def test_gapstore_cache_rule():
    """A full expansion of at most 1024 blocks is cached, and a bulk slice
    of such a store builds it once; a larger store is never cached."""
    t, _, rows = _store(64, 4)
    assert t._dense is None
    few = t.to_dense(np.asarray([3]))          # < 1/8 of the store
    assert t._dense is None
    np.testing.assert_array_equal(few, rows[[3]])
    bulk = t.to_dense(np.arange(0, 64, 2))     # bulk slice: builds it once
    assert t._dense is not None
    np.testing.assert_array_equal(bulk, rows[::2])
    cached = t._dense
    t.to_dense(np.arange(10))
    assert t._dense is cached

    big, jbig, _ = _store(1100, 5)
    full = big.to_dense()
    assert big._dense is None
    np.testing.assert_array_equal(full, jbig.to_dense())
    np.testing.assert_array_equal(big.to_dense(np.arange(0, 1100, 2)),
                                  full[::2])
    assert big._dense is None


# ---------------------------------------------------------------------------
# stream iterator and XOR groups
# ---------------------------------------------------------------------------
def _walk(mod, blob, skip_every=0):
    it = mod.SerialStreamIterator(blob)
    out = []
    k = 0
    while it.next():
        k += 1
        if skip_every and k % skip_every == 0:
            it.skip()
            out.append((it.block_idx, it.state, None))
        else:
            out.append((it.block_idx, it.state,
                        it.get_block_words().tobytes()))
    assert it.state == mod.E_END and not it.next()
    return it.size, out


@pytest.mark.parametrize("kind", ["mixed_a", "mixed_b", "above_2_32"])
def test_stream_iterator_walk(vecs, kind):
    _, tv = vecs[kind]
    blob = tbm.serialize(tv)
    for skip_every in (0, 3):
        assert _walk(tsi, blob, skip_every) == _walk(jsi, blob, skip_every)


@pytest.mark.parametrize("op", [C.SET_AND, C.SET_OR, C.SET_XOR, C.SET_SUB,
                                C.SET_COUNT_AND, C.SET_COUNT_OR,
                                C.SET_COUNT_XOR, C.SET_COUNT_SUB_AB,
                                C.SET_COUNT_SUB_BA])
def test_iterator_deserializer(vecs, op):
    ja, ta = vecs["gappy"]
    blob = tbm.serialize(vecs["mixed_a"][1])
    jt, tt = ja.copy(), ta.copy()
    want = jbm.IteratorDeserializer().deserialize_streamed(
        jt, jbm.SerialStreamIterator(blob), op)
    got = tbm.IteratorDeserializer().deserialize_streamed(
        tt, tbm.SerialStreamIterator(blob), op)
    if op >= C.SET_COUNT:
        assert got == want
    else:
        assert_same_state(jt, tt)
        jt2, tt2 = ja.copy(), ta.copy()
        jbm.IteratorDeserializer().deserialize(
            jt2, jbm.SerialStreamIterator(blob), op)
        tbm.IteratorDeserializer().deserialize(
            tt2, tbm.SerialStreamIterator(blob), op)
        assert_same_state(jt2, tt2)


def _group(pkg):
    rng = np.random.default_rng(8)
    size = 24 * BPB
    base = np.unique(rng.integers(0, size, 60_000))
    out = [pkg.BitVector.from_indices(base, size)]
    for _ in range(3):
        flip = rng.choice(base, 200, replace=False)
        extra = np.unique(rng.integers(0, size, 200))
        out.append(pkg.BitVector.from_indices(
            np.union1d(np.setdiff1d(base, flip), extra), size))
    full = pkg.BitVector(size)
    full.set_range(0, 3 * BPB - 1)
    full.clear_many(rng.integers(0, 3 * BPB, 300))
    out.append(full)
    return out


def test_xor_group_round_trip():
    jv, tv = _group(jbm), _group(tbm)
    blob = txg.serialize_group(tv)
    assert blob == jxg.serialize_group(jv)
    assert len(blob) < 0.5 * sum(len(tbm.serialize(v)) for v in tv)
    for sel in (None, ("range", (BPB + 7, 9 * BPB)),
                ("blocks", {0, 2, 5, 23})):
        got = txg.deserialize_group(blob, sel)
        want = jxg.deserialize_group(blob, sel)
        assert len(got) == len(want) == len(tv)
        for g, w in zip(got, want):
            assert_same_state(w, g)
    for g, v in zip(txg.deserialize_group(blob), tv):
        assert g.equal(v)


def test_deserializer_device_argument(vecs):
    """Decoded vectors land on the device asked for; the default is
    config.device."""
    blob = tbm.serialize(vecs["mixed_a"][1])
    assert tbm.deserialize(blob, device="cpu").device.type == "cpu"
    assert tbm.Deserializer(device="cpu").deserialize(blob).device.type \
        == "cpu"
    assert tser.Deserializer().deserialize(blob).device.type == "cpu"


def test_serial_names_exported():
    """The serialization names the JAX package exports at its top level
    are the port's too, with ReadOnlyError."""
    names = ["serialize", "deserialize", "Serializer", "Deserializer",
             "OperationDeserializer", "SerialStreamIterator",
             "IteratorDeserializer", "serial", "ReadOnlyError"]
    for n in names:
        assert n in jbm.__all__ and n in tbm.__all__, n
        assert hasattr(tbm, n), n
    for n in ("Serializer", "Deserializer", "serialize", "deserialize",
              "OperationDeserializer", "RefSerializer", "RefDeserializer",
              "ref_serialize", "ref_deserialize", "serialize_group",
              "deserialize_group", "encoding", "refcodec"):
        assert n in jbm.serial.__all__ and n in tbm.serial.__all__, n
    assert tbm.serialize is tbm.serial.serialize
    assert issubclass(tbm.ReadOnlyError, RuntimeError)
    v = tbm.BitVector.from_indices([1, 2], 1 << 20)
    v.freeze()
    with pytest.raises(tbm.ReadOnlyError):
        tbm.OperationDeserializer().deserialize(
            v, tbm.serialize(v), C.SET_OR)
    with pytest.raises(tbm.ReadOnlyError):
        v.set(5)
