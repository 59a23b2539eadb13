"""Block ops of the PyTorch port against the JAX package, on the CPU.

Every plain block op is held against ``bitmagic_tpu.ops.blockops`` on the
13-row pool of ``test_pallas_kernels.py`` (not a tile multiple, one zero
row, one full row).  The plain versions of the three hand-written kernels
are held against the Pallas kernels in interpret mode
(``logical_op_digest_pallas``, ``count_op_pallas``,
``block_counts_pallas``) and their gather-fused forms against the XLA
fusions the JAX package runs (``bitvector._binary_kernel``,
``setops._metric_kernel``).  Through ``cuda_kernels`` the CPU tensors take
the plain versions and launch nothing.  Tolerance: exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitmagic_tpu.algo import setops as jsetops
from bitmagic_tpu.core import bitvector as jbv
from bitmagic_tpu.ops import blockops as jops
from bitmagic_tpu.ops import pallas_kernels as pk
from bitmagic_tpu_torch.ops import blockops as tops
from bitmagic_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

OPS = ["and", "or", "xor", "sub"]
METRICS = list(tops.METRICS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)
                            .copy())


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.fixture
def pools(rng):
    n = 13   # non-multiple of any tile on purpose
    a = rng.integers(0, 2**32, (n, 2048), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (n, 2048), dtype=np.uint64).astype(np.uint32)
    a[3] = 0
    b[7] = 0xFFFFFFFF
    # sparse rows: some waves zero, so digests are not all ones
    a[5] &= np.where(np.arange(2048) % 96 < 32, 0xFFFFFFFF, 0).astype(
        np.uint32)
    b[5] = 0
    b[5, 1000] = 0x80000000
    return a, b


@pytest.fixture(autouse=True)
def _no_launches():
    ck.reset_launches()
    yield
    assert not any(ck.launches.values()), ck.launches


# ---------------------------------------------------------------------------
# plain versions of the three kernels vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", OPS)
def test_logical_op_digest_vs_pallas(pools, op):
    a, b = pools
    out, dig = tops.logical_op_digest(op, _t(a), _t(b))
    want, want_dig = pk.logical_op_digest_pallas(op, jnp.asarray(a),
                                                 jnp.asarray(b))
    np.testing.assert_array_equal(_u(out), np.asarray(want))
    np.testing.assert_array_equal(dig.numpy(), np.asarray(want_dig))
    # through the wrapper (CPU tensors -> plain version)
    out2, dig2 = ck.logical_op_digest(op, _t(a), _t(b))
    np.testing.assert_array_equal(_u(out2), np.asarray(want))
    np.testing.assert_array_equal(dig2.numpy(), np.asarray(want_dig))


@pytest.mark.parametrize("op", OPS)
def test_count_op_vs_pallas(pools, op):
    a, b = pools
    want = np.asarray(pk.count_op_pallas(op, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tops.count_op(op, _t(a), _t(b)).numpy(),
                                  want)
    np.testing.assert_array_equal(ck.count_op(op, _t(a), _t(b)).numpy(),
                                  want)


def test_block_counts_vs_pallas(pools):
    a, b = pools
    for p in (a, b):
        want = np.asarray(pk.block_counts_pallas(jnp.asarray(p)))
        np.testing.assert_array_equal(tops.block_counts(_t(p)).numpy(), want)
        np.testing.assert_array_equal(ck.block_counts(_t(p)).numpy(), want)


def test_empty_pools():
    z = torch.zeros((0, 2048), dtype=torch.int32)
    assert ck.block_counts(z).shape == (0,)
    assert ck.count_op("and", z, z).shape == (0,)
    out, dig = ck.logical_op_digest("xor", z, z)
    assert out.shape == (0, 2048) and dig.shape == (0, 64)


# ---------------------------------------------------------------------------
# gather-fused forms vs the XLA fusions of the JAX package
# ---------------------------------------------------------------------------
def _descriptors(rng, a, b, k=11):
    """Descriptors with -1 slots, FULL rows and aux rows (and one 0-row
    pool) for both packages."""
    aux = rng.integers(0, 2**32, (3, 2048), dtype=np.uint64).astype(np.uint32)
    a_slot = rng.integers(-1, a.shape[0], k)
    a_slot[:3] = [-1, 3, 12]
    a_full = np.zeros(k, bool)
    a_full[[0, 4]] = True
    a_aux_slot = np.full(k, -1)
    a_aux_slot[[5, 9]] = [2, 0]
    b_slot = rng.integers(-1, b.shape[0], k)
    b_slot[[1, 6]] = [-1, 7]
    b_full = np.zeros(k, bool)
    b_full[[2, 6]] = True
    b_aux_slot = np.full(k, -1)          # b has no aux rows: empty aux
    empty_aux = np.zeros((0, 2048), np.uint32)
    cases = {
        "mixed": ((a, a_slot, a_full, aux, a_aux_slot),
                  (b, b_slot, b_full, empty_aux, b_aux_slot)),
        "empty_pool": ((np.zeros((0, 2048), np.uint32), np.full(k, -1),
                        a_full, aux, a_aux_slot),
                       (b, b_slot, b_full, empty_aux, b_aux_slot)),
    }
    return cases


def _jdesc(d):
    pool, slot, full, aux, aux_slot = d
    return (jnp.asarray(pool), jnp.asarray(slot), jnp.asarray(full),
            jnp.asarray(aux), jnp.asarray(aux_slot))


def _tdesc(d):
    pool, slot, full, aux, aux_slot = d
    return (_t(pool), torch.from_numpy(np.asarray(slot, np.int32)),
            torch.from_numpy(np.asarray(full, bool)), _t(aux),
            torch.from_numpy(np.asarray(aux_slot, np.int32)))


@pytest.mark.parametrize("case", ["mixed", "empty_pool"])
@pytest.mark.parametrize("op", OPS)
def test_binary_op_digest_vs_binary_kernel(pools, rng, op, case):
    da, db = _descriptors(rng, *pools)[case]
    want = np.asarray(jbv._binary_kernel(op, *_jdesc(da), *_jdesc(db)))
    out, dig = ck.binary_op_digest(op, _tdesc(da), _tdesc(db))
    np.testing.assert_array_equal(_u(out), want)
    np.testing.assert_array_equal(
        dig.numpy(), np.asarray(jops.calc_digest(jnp.asarray(want))))


@pytest.mark.parametrize("case", ["mixed", "empty_pool"])
def test_count_metrics_vs_metric_kernel(pools, rng, case):
    da, db = _descriptors(rng, *pools)[case]
    want = np.asarray(jsetops._metric_kernel(tuple(METRICS), *_jdesc(da),
                                             *_jdesc(db)))
    got = ck.count_metrics(tuple(METRICS), _tdesc(da), _tdesc(db))
    np.testing.assert_array_equal(got.numpy(), want)
    # a subset in another order
    sub = ("count_b", "count_sub_ba", "count_and")
    want = np.asarray(jsetops._metric_kernel(sub, *_jdesc(da), *_jdesc(db)))
    np.testing.assert_array_equal(
        ck.count_metrics(sub, _tdesc(da), _tdesc(db)).numpy(), want)


def test_gather_rows_vs_gather_operand(pools, rng):
    from bitmagic_tpu.core import blocks as jblocks
    for da, _ in _descriptors(rng, *pools).values():
        want = np.asarray(jblocks.gather_operand(*_jdesc(da)))
        np.testing.assert_array_equal(_u(tops.gather_rows(*_tdesc(da))),
                                      want)


# ---------------------------------------------------------------------------
# K1's edges: one, two and 133 rows, results whose first and last waves
# are zero, all-zero and all-one rows, every source kind mixed
# ---------------------------------------------------------------------------
EDGE_ROWS = [1, 2, 133]


def _edge_pair(rng, k):
    """Operands of ``k`` rows: random words, row 0's first and last waves
    zero on both sides (so in every result), then (where k allows) a row
    zero on both sides, one all ones on both, one all ones against zero
    and one holding a lone bit in its last wave."""
    a, b = (rng.integers(0, 2**32, (k, 2048), dtype=np.uint64)
            .astype(np.uint32) for _ in range(2))
    for p in (a, b):
        p[0, :32] = 0
        p[0, -32:] = 0
    for i, (x, y) in enumerate(((0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                (0xFFFFFFFF, 0)), start=1):
        if i < k:
            a[i], b[i] = x, y
    if k > 4:
        a[4] = 0
        a[4, 2047] = 0x80000000
    return a, b


def _edge_descriptors(rng, k, one_pool):
    """Descriptors of ``k`` rows over the edge rows: pool rows, aux rows,
    FULL rows and absent rows (slot -1) on both sides, each kind forced
    into the first rows; ``one_pool``: both operands on one pool."""
    pa, pb = _edge_pair(rng, 7)
    if one_pool:
        pb = pa
    aux = _edge_pair(rng, 3)[0]
    descs = []
    for side, pool in enumerate((pa, pb)):
        slot = rng.integers(-1, pool.shape[0], k)
        full = rng.random(k) < 0.15
        aux_slot = np.where(rng.random(k) < 0.25, rng.integers(0, 3, k), -1)
        # row 0: pool row 0 on both sides; row 1: FULL / aux; row 2:
        # absent / pool row 1
        forced = [(0, False, -1), (-1, True, -1) if side else (5, False, 2),
                  (1, False, -1) if side else (-1, False, -1)]
        for i, (s, f, x) in enumerate(forced[:k]):
            slot[i], full[i], aux_slot[i] = s, f, x
        descs.append((pool, slot, full, aux, aux_slot))
    return descs


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("k", EDGE_ROWS)
def test_logical_op_digest_edges_vs_pallas(rng, k, op):
    a, b = _edge_pair(rng, k)
    want, want_dig = pk.logical_op_digest_pallas(op, jnp.asarray(a),
                                                 jnp.asarray(b))
    out, dig = ck.logical_op_digest(op, _t(a), _t(b))
    np.testing.assert_array_equal(_u(out), np.asarray(want))
    np.testing.assert_array_equal(dig.numpy(), np.asarray(want_dig))
    assert not dig[0, 0] and not dig[0, -1]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", ["mixed", "one_pool"])
@pytest.mark.parametrize("k", EDGE_ROWS)
def test_binary_op_digest_edges_vs_binary_kernel(rng, k, case, op):
    da, db = _edge_descriptors(rng, k, case == "one_pool")
    want = np.asarray(jbv._binary_kernel(op, *_jdesc(da), *_jdesc(db)))
    out, dig = ck.binary_op_digest(op, _tdesc(da), _tdesc(db))
    np.testing.assert_array_equal(_u(out), want)
    np.testing.assert_array_equal(
        dig.numpy(), np.asarray(jops.calc_digest(jnp.asarray(want))))


# ---------------------------------------------------------------------------
# the other plain block ops vs blockops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["block_counts", "wave_counts",
                                  "calc_digest", "is_zero_blocks",
                                  "is_full_blocks", "gap_counts",
                                  "find_first_in_blocks",
                                  "find_last_in_blocks"])
def test_pool_functions_match(pools, name):
    a, b = pools
    p = np.concatenate([a, b, np.zeros((1, 2048), np.uint32)])
    p[-1, 2047] = 0x80000000            # last bit only
    got = getattr(tops, name)(_t(p)).numpy()
    want = np.asarray(getattr(jops, name)(jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)


def test_host_mirrors_match(pools):
    a, _ = pools
    np.testing.assert_array_equal(tops.block_counts_np(a),
                                  jops.block_counts_np(a))
    np.testing.assert_array_equal(tops.gap_counts_np(a),
                                  jops.gap_counts_np(a))
    np.testing.assert_array_equal(tops.gap_counts(_t(a)).numpy(),
                                  jops.gap_counts_np(a))


@pytest.mark.parametrize("lo,hi", [(0, 0), (5, 37), (31, 32), (100, 65535),
                                   (65535, 65536), (70000, 3 * 65536 + 17),
                                   (0, 13 * 65536 - 1)])
def test_range_ops_match(pools, lo, hi):
    a, _ = pools
    ja, ta = jnp.asarray(a), _t(a)
    sp = jops._split_range(lo, hi)
    np.testing.assert_array_equal(
        _u(tops.range_mask(13, *tops._split_range(lo, hi))),
        np.asarray(jops.range_mask(13, *sp)))
    assert tops.count_range_pool(ta, lo, hi) == jops.count_range_pool(
        ja, lo, hi)
    assert tops.any_range_pool(ta, lo, hi) == bool(
        jops.any_range_pool(ja, lo, hi))
    full = _t(np.full((13, 2048), 0xFFFFFFFF, np.uint32))
    assert tops.is_all_one_range_pool(full, lo, hi)
    assert tops.is_all_one_range_pool(ta, lo, hi) == bool(
        jops.is_all_one_range_pool(ja, lo, hi))


def test_shifts_and_edges_match(pools, rng):
    a, _ = pools
    carry = rng.integers(0, 2, 13).astype(np.uint32)
    ja, ta = jnp.asarray(a), _t(a)
    tc = torch.from_numpy(carry.astype(np.int32))
    np.testing.assert_array_equal(
        _u(tops.shift_rows_up1(ta, tc)),
        np.asarray(jops.shift_rows_up1(ja, jnp.asarray(carry))))
    np.testing.assert_array_equal(
        _u(tops.shift_rows_down1(ta, tc)),
        np.asarray(jops.shift_rows_down1(ja, jnp.asarray(carry))))
    for got, want in zip(tops.edge_bits(ta), jops.edge_bits(ja)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_set_bits_matches(rng):
    n = 5
    ids = np.unique(rng.integers(0, n * 65536, 4000))
    ids = np.concatenate([ids, [31, 63, n * 65536 - 1]])
    ids = np.unique(ids)
    rows, bits = ids >> 16, (ids & 0xFFFF).astype(np.int32)
    got = tops.scatter_set_bits(torch.from_numpy(rows),
                                torch.from_numpy(bits), n)
    want = jops.scatter_set_bits(jnp.asarray(rows), jnp.asarray(bits), n)
    np.testing.assert_array_equal(_u(got), np.asarray(want))


def test_logical_ops_match(pools):
    a, b = pools
    for op in OPS:
        np.testing.assert_array_equal(
            _u(tops.logical_op(op, _t(a), _t(b))),
            np.asarray(jops.logical_op(op, jnp.asarray(a), jnp.asarray(b))))


def test_full_block_np_matches():
    got, want = tops.full_block_np(), jops.full_block_np()
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_pack_digest_matches(pools):
    a, b = pools
    p = np.concatenate([a, b])
    d = np.array(jops.calc_digest(jnp.asarray(p)))
    d[0] = 1                                   # both top bits set
    got = tops.pack_digest(torch.from_numpy(d.astype(np.int32)))
    want = np.asarray(jops.pack_digest(jnp.asarray(d)))
    assert got.dtype == torch.int32 and got.shape == (p.shape[0], 2)
    np.testing.assert_array_equal(_u(got), want)


def test_unpack_and_pack_bits_match(pools):
    a, _ = pools
    w = a[:4, :64]
    got = tops.unpack_words_to_bits(_t(w))
    want = np.asarray(jops.unpack_words_to_bits(jnp.asarray(w)))
    assert got.dtype == torch.uint8 and got.shape == (4, 64, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tops.pack_bits_to_words(got)
    np.testing.assert_array_equal(
        _u(back), np.asarray(jops.pack_bits_to_words(jnp.asarray(want))))
    np.testing.assert_array_equal(_u(back), w)
    # int32 0/1 input packs the same
    np.testing.assert_array_equal(
        _u(tops.pack_bits_to_words(got.to(torch.int32))), w)
