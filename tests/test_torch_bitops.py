"""Word-level bit utilities of the PyTorch port against the JAX package
(``bitmagic_tpu.ops.bitops``), on the CPU.  Tolerance: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitmagic_tpu.ops import bitops as jb
from bitmagic_tpu_torch.ops import bitops as tb

torch.set_num_threads(1)

EDGE = np.asarray([0, 1, 2, 3, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF,
                   0x80000001, 0x00010000, 0xFFFF0000, 0x0000FFFF,
                   0xAAAAAAAA, 0x55555555], np.uint32)


@pytest.fixture
def words(rng):
    rand = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    # sparse words too: single bits and pairs at every position
    single = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return np.concatenate([EDGE, rand, single, single | np.uint32(1)])


def _t(w):
    return torch.from_numpy(w.view(np.int32).copy())


@pytest.mark.parametrize("name", ["popcount", "clz32", "ctz32",
                                  "bit_scan_reverse32", "parity"])
def test_word_functions_match(words, name):
    got = getattr(tb, name)(_t(words)).numpy()
    want = np.asarray(getattr(jb, name)(jnp.asarray(words)))
    if name == "bit_scan_reverse32":            # undefined for 0 in both
        nz = words != 0
        got, want = got[nz], want[nz]
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


def test_word_select32_matches(words, rng):
    w = words[words != 0]
    pc = np.bitwise_count(w).astype(np.int64)
    ranks = (rng.integers(0, 2**31, w.size) % pc + 1).astype(np.int32)
    ranks[:1] = pc[:1]                           # last set bit
    got = tb.word_select32(_t(w), torch.from_numpy(ranks)).numpy()
    want = np.asarray(jb.word_select32(jnp.asarray(w), jnp.asarray(ranks)))
    np.testing.assert_array_equal(got, want)
    # and against the definition
    for word, r, pos in zip(w[:64], ranks[:64], got[:64]):
        bits = np.flatnonzero([(int(word) >> i) & 1 for i in range(32)])
        assert bits[r - 1] == pos


def test_gap_mask_matches():
    n = np.arange(33, dtype=np.int64)
    got = tb.gap_mask(torch.from_numpy(n)).numpy().view(np.uint32)
    want = np.asarray(jb.gap_mask(jnp.asarray(n)))
    np.testing.assert_array_equal(got, want)


def test_u32_round_trip(words):
    v = torch.from_numpy(words.astype(np.int64))
    np.testing.assert_array_equal(tb.u32_to_i32(v).numpy().view(np.uint32),
                                  words)
    np.testing.assert_array_equal(tb.as_u32_int64(_t(words)).numpy(),
                                  words.astype(np.int64))
