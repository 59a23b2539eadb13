"""The port's native codec library: built from the port's own copy of
``codecs.cpp`` into ``bitmagic_tpu_torch/_build/``, a failed build raises,
and its block decoders give the JAX package's native answers and numpy's
on the same rows."""
import os

import numpy as np
import pytest

from bitmagic_tpu.core.bitvector import _pool_positions_native
from bitmagic_tpu.serial import native as jnative
import bitmagic_tpu_torch
from bitmagic_tpu_torch.serial import native

PKG = os.path.dirname(os.path.abspath(bitmagic_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)
B48 = 1 << 48


def _rows(rng):
    """Rows of every shape the decoders meet: random, empty, full,
    sparse, word runs, alternating bits, single first / last bits."""
    r = {"random": rng.integers(0, 2 ** 32, 2048, dtype=np.uint64),
         "zeros": np.zeros(2048), "ones": np.full(2048, 0xFFFFFFFF),
         "alternating": np.full(2048, 0x55555555)}
    sparse = np.zeros(2048, np.uint64)
    sparse[rng.integers(0, 2048, 40)] = 1 << rng.integers(0, 32, 40)
    r["sparse"] = sparse
    runs = np.zeros(2048, np.uint64)
    for s in rng.integers(0, 2000, 12):
        runs[s:s + rng.integers(1, 40)] = 0xFFFFFFFF
    runs[700] = 0x00FFFF00
    r["runs"] = runs
    first = np.zeros(2048, np.uint64)
    first[0] = 1
    r["first_bit"] = first
    last = np.zeros(2048, np.uint64)
    last[-1] = 0x80000000
    r["last_bit"] = last
    return {k: np.asarray(v).astype(np.uint32) for k, v in r.items()}


ROWS = _rows(np.random.default_rng(17))


def _positions_np(row, inverted=False):
    bits = np.unpackbits(row.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits == (0 if inverted else 1)).astype(np.int64)


def test_builds_from_own_copy():
    lib = native.load()
    assert os.path.commonpath([native.SOURCE, PKG]) == PKG
    assert os.path.commonpath([native.library_path(), PKG]) == PKG
    assert os.path.dirname(native.library_path()) == os.path.join(PKG,
                                                                  "_build")
    assert os.path.realpath(lib._name) == os.path.realpath(
        native.library_path())
    with open(native.SOURCE, "rb") as f, open(os.path.join(
            ROOT, "bitmagic_tpu", "serial", "native", "codecs.cpp"),
            "rb") as g:
        assert f.read() == g.read()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "codecs.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        native.load()
    assert not os.listdir(tmp_path / "_build")


@pytest.mark.parametrize("kind", sorted(ROWS))
def test_block_decoders(kind):
    row = ROWS[kind]
    for inverted in (False, True):
        got = native.block_positions(row, inverted)
        np.testing.assert_array_equal(got, _positions_np(row, inverted))
        np.testing.assert_array_equal(
            got, jnative.block_positions(row, inverted))
    first, bounds = native.block_gap_boundaries(row)
    jfirst, jbounds = jnative.block_gap_boundaries(row)
    assert first == jfirst == int(row[0] & 1)
    np.testing.assert_array_equal(bounds, jbounds)
    bits = np.unpackbits(row.view(np.uint8), bitorder="little")
    want = np.append(np.flatnonzero(bits[1:] != bits[:-1]), 65535)
    np.testing.assert_array_equal(bounds, want)
    # int32 rows (the port's pool dtype) are read as the same bits
    np.testing.assert_array_equal(
        native.block_positions(row.view(np.int32)), _positions_np(row))


def test_pool_positions():
    words = np.stack([ROWS[k] for k in sorted(ROWS)])
    bases = np.asarray([0, 65536, 1 << 32, B48 - 5 * 65536, 7 * 65536,
                        B48 - 3 * 65536, 3 * 65536, B48 - 65536], np.int64)
    got = native.pool_positions(words, bases)
    want = np.concatenate([_positions_np(r) + b
                           for r, b in zip(words, bases)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _pool_positions_native(words, bases))
    np.testing.assert_array_equal(
        native.pool_positions(words.view(np.int32), bases), want)
    assert native.pool_positions(np.zeros((0, 2048), np.uint32),
                                 np.zeros(0, np.int64)).size == 0


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        native.block_positions(np.zeros(100, np.uint32))
    with pytest.raises(ValueError):
        native.pool_positions(np.zeros((2, 2048), np.uint32),
                              np.zeros(3, np.int64))
    with pytest.raises(TypeError):
        native.block_gap_boundaries(np.zeros(2048, np.float32))


# ---------------------------------------------------------------------------
# the serializer's wrappers
# ---------------------------------------------------------------------------
def _blob_and_target():
    import bitmagic_tpu as jbm
    rng = np.random.default_rng(5)
    size = 40 * 65536
    src = jbm.BitVector.from_indices(rng.integers(0, size, 30_000), size)
    src.set_range(3 * 65536, 5 * 65536 - 1)
    src.optimize()
    tgt = jbm.BitVector.from_indices(rng.integers(0, size, 20_000), size)
    tgt.set_range(4 * 65536, 6 * 65536 + 9)
    tgt.optimize()
    return jbm.serialize(src), tgt


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want


def test_blob_wrappers_match_jax():
    blob, tgt = _blob_and_target()
    for fn in ("bmt1_decode", "bmt1_decode_gap", "bmt1_record_index"):
        _same(getattr(native, fn)(blob, 13), getattr(jnative, fn)(blob, 13))
        # a truncated BLOB is turned down with None by both
        assert getattr(native, fn)(blob[:-3], 13) is None
        assert getattr(jnative, fn)(blob[:-3], 13) is None
    st, g = tgt._struct, tgt._gaps
    words = tgt._pool_host()
    cls = st.cls.copy()
    for op in range(5):
        for count in (True, False):
            args = (blob, 13, op, count, st.nb, cls, words)
            kw = dict(t_gap_ends=g.ends_i32(), t_gap_offs=g.offs,
                      t_gap_first=g.first)
            _same(native.bmt1_stream_op(*args, **kw),
                  jnative.bmt1_stream_op(*args, **kw))
    nbs, offs = native.bmt1_record_index(blob, 13)
    _same(native.bmt1_stream_op(blob, int(offs[4]), 1, False, st.nb, cls,
                                words, n_rec=6, nb_prev=int(nbs[3]), **kw),
          jnative.bmt1_stream_op(blob, int(offs[4]), 1, False, st.nb, cls,
                                 words, n_rec=6, nb_prev=int(nbs[3]), **kw))
    _same(native.padded_blob(blob), jnative.padded_blob(blob))
    assert native.padded_blob(native.padded_blob(blob)).size == len(blob) + 8


def test_encode_wrappers_match_jax():
    _, tgt = _blob_and_target()
    st, g = tgt._struct, tgt._gaps
    words = tgt._pool_host()
    for level in range(7):
        kw = dict(gap_ends=g.ends_i32(), gap_offs=g.offs, gap_first=g.first)
        _same(native.bmt1_encode(words, st.nb, st.cls, level, **kw),
              jnative.bmt1_encode(words, st.nb, st.cls, level, **kw))
    _same(native.gaps_to_dense(g.ends, g.offs, g.first),
          jnative.gaps_to_dense(g.ends, g.offs, g.first))
    assert native.gaps_to_dense(np.zeros(0), np.zeros(1),
                                np.zeros(0)).shape == (0, 2048)
    rng = np.random.default_rng(2)
    arr = np.unique(rng.integers(0, 65536, 3000)).astype(np.int64)
    b = native.bic_encode_bytes(arr, 0, 65535)
    assert b == jnative.bic_encode_bytes(arr, 0, 65535)
    _same(native.bic_decode_bytes(b, arr.size, 0, 65535), arr)
    vals = rng.integers(1, 1 << 40, 500).astype(np.uint64)
    b = native.gamma_encode_bytes(vals)
    assert b == jnative.gamma_encode_bytes(vals)
    _same(native.gamma_decode_bytes(b, vals.size), vals)
    with pytest.raises(ValueError, match="truncated"):
        native.gamma_decode_bytes(b"\x00\x00", 50)
