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
