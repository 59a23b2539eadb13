"""The PyTorch port against fixtures produced by the REFERENCE
implementation (``tools/make_fixtures.cpp``), on the CPU: the checks of
``test_reference_parity.py``, through the port.  Tolerance: exact."""
import os
import struct

import numpy as np
import pytest
import torch

import bitmagic_tpu_torch as tbm

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SIZE = 100_000_000

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(FIX, "expected.bin")),
    reason="fixtures not generated (tools/make_fixtures.cpp)")


def _read_u64s(f, n):
    return np.frombuffer(f.read(8 * n), "<u8").astype(np.int64)


@pytest.fixture(scope="module")
def vectors():
    with open(os.path.join(FIX, "inputs.bin"), "rb") as f:
        na = struct.unpack("<Q", f.read(8))[0]
        ia = _read_u64s(f, na)
        nb = struct.unpack("<Q", f.read(8))[0]
        ib = _read_u64s(f, nb)
    a = tbm.BitVector.from_indices(ia, SIZE, device="cpu")
    b = tbm.BitVector.from_indices(ib, SIZE, device="cpu")
    return a, b


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIX, "expected.bin"), "rb") as f:
        counts = _read_u64s(f, 6)
        nr = struct.unpack("<Q", f.read(8))[0]
        ranks = _read_u64s(f, 2 * nr).reshape(nr, 2)
        ns = struct.unpack("<Q", f.read(8))[0]
        sels = _read_u64s(f, 2 * ns).reshape(ns, 2)
        n_and = struct.unpack("<Q", f.read(8))[0]
        and_idx = _read_u64s(f, n_and)
    return dict(counts=counts, ranks=ranks, sels=sels, and_idx=and_idx)


def test_counts_match_reference(vectors, expected):
    a, b = vectors
    c = expected["counts"]
    assert a.count() == c[0]
    assert b.count() == c[1]
    assert tbm.count_and(a, b) == c[2]
    assert tbm.count_or(a, b) == c[3]
    assert tbm.count_xor(a, b) == c[4]
    assert tbm.count_sub(a, b) == c[5]


def test_and_result_bit_for_bit(vectors, expected):
    a, b = vectors
    np.testing.assert_array_equal((a & b).indices(), expected["and_idx"])


def test_rank_matches_reference(vectors, expected):
    a, _ = vectors
    rs = a.build_rs_index()
    np.testing.assert_array_equal(rs.rank_batch(expected["ranks"][:, 0]),
                                  expected["ranks"][:, 1])


def test_select_matches_reference(vectors, expected):
    a, _ = vectors
    rs = a.build_rs_index()
    np.testing.assert_array_equal(rs.select_batch(expected["sels"][:, 0]),
                                  expected["sels"][:, 1])
