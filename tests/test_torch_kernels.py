"""The hand-written Hopper kernels against their plain PyTorch
versions (or hand-worked counts), on the card.  Every test here needs
CUDA (marker ``cuda``) and skips without it.  On a machine with an H100
and no JAX, run them without the suite's conftest (which imports JAX):

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: exact equality (integer results)."""
import numpy as np
import pytest
import torch

import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.core.gapstore import GapStore
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
OPS = ["and", "or", "xor", "sub"]


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    ck.reset_launches()
    return torch.device("cuda")


def _pool(rng, n, dev):
    p = rng.integers(0, 2**32, (n, 2048), dtype=np.uint64).astype(np.uint32)
    if n > 3:
        p[1] = 0
        p[2] = 0xFFFFFFFF
        p[3, ::64] = 0                       # some zero waves
        p[3, :1024] = 0
    return torch.from_numpy(p.view(np.int32).copy()).to(dev)


def _desc(rng, pool, k, dev, with_aux):
    r = pool.shape[0]
    slot = rng.integers(-1, max(r, 1), k).astype(np.int32)
    if r == 0:
        slot[:] = -1
    full = rng.random(k) < 0.2
    aux = _pool(rng, 3 if with_aux else 0, dev)
    aux_slot = np.where(rng.random(k) < 0.3, rng.integers(0, 3, k), -1)
    if not with_aux:
        aux_slot[:] = -1
    return (pool, torch.from_numpy(slot).to(dev),
            torch.from_numpy(full).to(dev), aux,
            torch.from_numpy(aux_slot.astype(np.int32)).to(dev))


def _cpu(desc):
    return tuple(t.cpu() for t in desc)


@pytest.mark.parametrize("n", [0, 1, 13, 1536])
def test_block_counts_kernel(dev, rng, n):
    p = _pool(rng, n, dev)
    got = ck.block_counts(p)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), blockops.block_counts(p.cpu()))
    assert ck.launches["block_counts"] == (1 if n else 0)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", [0, 13, 1536])
def test_aligned_kernels(dev, rng, op, n):
    a, b = _pool(rng, n, dev), _pool(rng, n, dev)
    out, dig = ck.logical_op_digest(op, a, b)
    cnt = ck.count_op(op, a, b)
    torch.cuda.synchronize()
    want, want_dig = blockops.logical_op_digest(op, a.cpu(), b.cpu())
    assert torch.equal(out.cpu(), want)
    assert torch.equal(dig.cpu(), want_dig)
    assert torch.equal(cnt.cpu(), blockops.count_op(op, a.cpu(), b.cpu()))


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("pool_rows", [0, 13])
def test_gather_fused_kernels(dev, rng, with_aux, pool_rows):
    k = 29
    da = _desc(rng, _pool(rng, pool_rows, dev), k, dev, with_aux)
    db = _desc(rng, _pool(rng, 7, dev), k, dev, not with_aux)
    for op in OPS:
        out, dig = ck.binary_op_digest(op, da, db)
        want, want_dig = blockops.binary_op_digest(op, _cpu(da), _cpu(db))
        assert torch.equal(out.cpu(), want)
        assert torch.equal(dig.cpu(), want_dig)
    metrics = blockops.METRICS
    got = ck.count_metrics(metrics, da, db)
    assert torch.equal(got.cpu(),
                       blockops.count_metrics(metrics, _cpu(da), _cpu(db)))
    sub = ("count_b", "count_sub_ba")
    assert torch.equal(ck.count_metrics(sub, da, db).cpu(),
                       blockops.count_metrics(sub, _cpu(da), _cpu(db)))
    assert {k: ck.launches[k] for k in ("block_counts", "count_op",
                                        "logical_op_digest")} == {
        "block_counts": 0, "count_op": 2, "logical_op_digest": 4}


# ---------------------------------------------------------------------------
# K1 at its edges: row counts on both sides of its warp split (4096 rows),
# every source kind mixed, both operands on one pool, results whose first
# and last waves are zero, all-zero and all-one rows; each op against the
# plain version on the same card tensors, one launch a call
# ---------------------------------------------------------------------------
K1_EDGE_ROWS = [1, 2, 133, 16385]


def _k1_pool(rng, n, dev):
    """``_pool``'s rows (1 zero, 2 all ones, 3 with zero waves) with row
    0's first and last waves zero."""
    p = _pool(rng, n, dev)
    p[0, :32] = 0
    p[0, -32:] = 0
    return p


def _k1_check(call, plain):
    for op in OPS:
        out, dig = call(op)
        want, want_dig = plain(op)
        torch.cuda.synchronize()
        assert torch.equal(out, want), op
        assert torch.equal(dig, want_dig), op
    assert ck.launches["logical_op_digest"] == len(OPS)


@pytest.mark.parametrize("k", K1_EDGE_ROWS)
def test_k1_aligned_edges(dev, rng, k):
    a, b = _k1_pool(rng, k, dev), _k1_pool(rng, k, dev)
    if k > 4:
        b[4] = a[4]                     # xor and sub give a zero row
    _k1_check(lambda op: ck.logical_op_digest(op, a, b),
              lambda op: blockops.logical_op_digest(op, a, b))
    dig = ck.logical_op_digest("or", a, b)[1]
    assert not dig[0, 0] and not dig[0, -1]


@pytest.mark.parametrize("one_pool", [False, True])
@pytest.mark.parametrize("k", K1_EDGE_ROWS)
def test_k1_gather_edges(dev, rng, k, one_pool):
    pa = _k1_pool(rng, 7, dev)
    pb = pa if one_pool else _k1_pool(rng, 5, dev)
    da = _desc(rng, pa, k, dev, True)
    db = _desc(rng, pb, k, dev, True)
    # the first rows take each kind: a pool row 0 / pool row 0, an aux row
    # / FULL, absent / pool row 1 (all zero), FULL / aux row
    kinds = (((0, False, -1), (0, False, -1)), ((5, False, 2), (-1, True, -1)),
             ((-1, False, -1), (1, False, -1)), ((3, True, -1), (2, False, 0)))
    for i, pair in enumerate(kinds[:k]):
        for (slot, full, aux_slot), d in zip(pair, (da, db)):
            d[1][i], d[2][i], d[4][i] = slot, full, aux_slot
    _k1_check(lambda op: ck.binary_op_digest(op, da, db),
              lambda op: blockops.binary_op_digest(op, da, db))


def test_bitvector_on_card_matches_cpu(dev, rng):
    ids_a = rng.integers(0, 40 * 65536, 200000)
    ids_b = np.concatenate([rng.integers(0, 40 * 65536, 200000),
                            np.arange(65536 * 3, 65536 * 9)])
    out = {}
    for d in ("cpu", "cuda"):
        a = tbm.BitVector.from_indices(ids_a, 40 * 65536, device=d)
        b = tbm.BitVector.from_indices(ids_b, 40 * 65536, device=d,
                                       strategy=1)
        b.optimize()
        out[d] = [interop.bitvector_to_parts(getattr(a, m)(b))
                  for m in ("__and__", "__or__", "__xor__", "__sub__")]
        out[d].append(tbm.distance_operation(a, b, list(blockops.METRICS)))
        out[d].append(a.build_rs_index().select_batch(
            np.arange(1, 5000, 7)))
    for g, w in zip(out["cuda"][:4], out["cpu"][:4]):
        for key in interop.PARTS:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert out["cuda"][4] == out["cpu"][4]
    np.testing.assert_array_equal(out["cuda"][5], out["cpu"][5])
    assert all(ck.launches[k] for k in ("block_counts", "count_op",
                                        "logical_op_digest")), ck.launches


# ---------------------------------------------------------------------------
# K3 and K2 at 1 to 16384 rows, the total forms (one atomic per CTA into
# a counter the launcher zeroes), every subset of the metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1536, 4097, 16384])
def test_block_counts_total_kernel(dev, rng, n, per_block):
    p = _pool(rng, n, dev)
    tot, per = ck.block_counts_total(p, per_block)
    torch.cuda.synchronize()
    want_tot, want_per = blockops.block_counts_total(p, per_block)
    assert tot.dtype == torch.int64 and tot.shape == ()
    assert int(tot) == int(want_tot)
    assert (per is None) == (not per_block)
    if per_block:
        assert torch.equal(per, want_per)
    assert torch.equal(ck.block_counts(p), blockops.block_counts(p))
    assert ck.launches["block_counts"] == (2 if n else 0)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", [31, 33, 4097, 16384])
def test_count_op_kernel_regimes(dev, rng, op, n):
    a, b = _pool(rng, n, dev), _pool(rng, n, dev)
    got = ck.count_op(op, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, blockops.count_op(op, a, b))


def test_count_metrics_every_subset(dev, rng):
    """Every subset of the seven metrics in a random order: counted
    directly or combined from |a&b|, |a| and |b| (blockops.count_plan)."""
    da = _desc(rng, _pool(rng, 13, dev), 301, dev, True)
    db = _desc(rng, _pool(rng, 7, dev), 301, dev, False)
    n = 0
    for mask in range(1, 1 << 7):
        ms = tuple(rng.permutation([m for j, m in enumerate(blockops.METRICS)
                                    if mask >> j & 1]).tolist())
        got = ck.count_metrics(ms, da, db)
        tot, per = ck.count_metrics_total(ms, da, db, per_block=True)
        n += 2
        torch.cuda.synchronize()
        want = blockops.count_metrics(ms, da, db)
        assert torch.equal(got, want), ms
        assert torch.equal(per, want), ms
        assert torch.equal(tot, want.sum(dim=1, dtype=torch.int64)), ms
    assert ck.launches["count_op"] == n


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("k", [1, 33, 1536, 16384])
def test_count_metrics_total_kernel(dev, rng, k, per_block):
    da = _desc(rng, _pool(rng, 2048, dev), k, dev, True)
    db = _desc(rng, _pool(rng, 900, dev), k, dev, False)
    for ms in (tuple(blockops.METRICS), ("count_and",),
               ("count_sub_ba", "count_or", "count_a")):
        tot, per = ck.count_metrics_total(ms, da, db, per_block)
        torch.cuda.synchronize()
        want_tot, want_per = blockops.count_metrics_total(ms, da, db, True)
        assert tot.dtype == torch.int64 and torch.equal(tot, want_tot)
        assert (per is None) == (not per_block)
        if per_block:
            assert torch.equal(per, want_per)
    assert ck.launches["count_op"] == 3


def test_count_metrics_ones_and_zeros(dev):
    """Derived metrics on rows of all ones against zeros and themselves,
    against counts worked out by hand."""
    k = 5
    ones = torch.full((k, 2048), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(ones)
    B = 65536
    want = {(1, 0): [0, B, B, B, 0, B, 0], (0, 1): [0, B, B, 0, B, 0, B],
            (1, 1): [B, 0, B, 0, 0, B, B]}
    for (x, y), w in want.items():
        d = [(p, torch.arange(k, dtype=torch.int32, device=dev),
              torch.zeros(k, dtype=torch.bool, device=dev), p[:0],
              torch.full((k,), -1, dtype=torch.int32, device=dev))
             for p in ((ones if x else zeros), (ones if y else zeros))]
        tot, per = ck.count_metrics_total(blockops.METRICS, *d,
                                          per_block=True)
        torch.cuda.synchronize()
        assert per.cpu().tolist() == [[v] * k for v in w]
        assert tot.cpu().tolist() == [v * k for v in w]


def test_count_and_distance_one_launch_each(dev, rng):
    ids_a = rng.integers(0, 40 * 65536, 300000)
    ids_b = np.concatenate([rng.integers(0, 40 * 65536, 200000),
                            np.arange(65536 * 3, 65536 * 9)])
    a = tbm.BitVector.from_indices(ids_a, 40 * 65536, device="cuda")
    b = tbm.BitVector.from_indices(ids_b, 40 * 65536, device="cuda",
                                   strategy=1)
    b.optimize()
    ck.reset_launches()
    assert a.count() == np.unique(ids_a).size
    assert ck.launches["block_counts"] == 1
    dist = tbm.distance_operation(a, b, list(blockops.METRICS))
    assert ck.launches["count_op"] == 1
    ua, ub = set(np.unique(ids_a).tolist()), set(np.unique(ids_b).tolist())
    assert dist["count_and"] == len(ua & ub)
    assert dist["count_or"] == len(ua | ub)
    assert dist["count_xor"] == len(ua ^ ub)
    assert dist["count_sub_ab"] == len(ua - ub)
    assert dist["count_sub_ba"] == len(ub - ua)


# ---------------------------------------------------------------------------
# B4: K-way AND-SUB sweep
# ---------------------------------------------------------------------------
def _dense_pool(rng, n, dev, density=0.5):
    """Rows whose AND over ~-log2(density^-1) operands goes to zero, so the
    sweep's early exit triggers on some columns and not on others."""
    bits = rng.random((n, 2048, 32)) < density
    w = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    return torch.from_numpy(w.view(np.int32).copy()).to(dev)


@pytest.mark.parametrize("or_mode", [False, True])
@pytest.mark.parametrize("k_ops,n_and", [(1, 1), (5, 3), (5, 0), (40, 40),
                                         (300, 150)])
@pytest.mark.parametrize("cols", [1, 13])
def test_agg_and_sub_kernel(dev, rng, or_mode, k_ops, n_and, cols):
    pool = _dense_pool(rng, 37, dev, density=0.85)
    descs = [_desc(rng, pool, cols, dev, with_aux=(j % 3 == 0))
             for j in range(k_ops)]
    rows, cnt = ck.agg_and_sub(n_and, descs, or_mode=or_mode, counts=True)
    cdescs = [_cpu(d) for d in descs]
    w_rows, w_cnt = blockops.agg_and_sub(n_and, cdescs, or_mode=or_mode,
                                         counts=True)
    only, none_rows = ck.agg_and_sub(n_and, descs, or_mode=or_mode,
                                     rows=False, counts=True)[::-1]
    torch.cuda.synchronize()
    assert torch.equal(rows.cpu(), w_rows)
    assert torch.equal(cnt.cpu(), w_cnt)
    assert none_rows is None and torch.equal(only.cpu(), w_cnt)
    assert ck.launches["agg_and_sub"] == 2


def test_agg_and_sub_kernel_early_exit_oracle(dev, rng):
    """Columns that die early and columns that never do, held against a
    numpy fold (not only against the plain version)."""
    n_and, n_sub, nb = 100, 100, 9
    pool_np = rng.integers(0, 2**32, (n_and + n_sub, 2048),
                           dtype=np.uint64).astype(np.uint32)
    pool_np[-1] = 0                                   # a zero SUB row
    slots = rng.integers(0, n_and + n_sub - 1, (n_and + n_sub, nb)
                         ).astype(np.int32)
    slots[:, 0] = -1                                  # never dies: all -1
    slots[0, 1] = n_and + n_sub - 1                   # dies at operand 0
    slots[:n_and, 2] = -1
    slots[n_and:, 2] = n_and + n_sub - 1              # SUB of zero rows
    want = np.full((nb, 2048), 0xFFFFFFFF, np.uint32)
    for k in range(n_and + n_sub):
        for i in range(nb):
            if slots[k, i] >= 0:
                r = pool_np[slots[k, i]]
                want[i] &= r if k < n_and else ~r
    pool = torch.from_numpy(pool_np.view(np.int32)).to(dev)
    got = ck.agg_and_sub_arena(n_and, n_sub,
                               torch.from_numpy(slots).to(dev), pool)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(blockops.to_host_words(got), want)
    assert (want[0] == 0xFFFFFFFF).all() and (want[1] == 0).all()
    assert (want[3:] == 0).all()


@pytest.mark.parametrize("nb", [0, 1, 13])
def test_agg_and_sub_arena_kernel(dev, rng, nb):
    pool = _dense_pool(rng, 20, dev, density=0.9)
    slots = rng.integers(-1, 20, (7, nb)).astype(np.int32)
    sl = torch.from_numpy(slots).to(dev)
    got = ck.agg_and_sub_arena(4, 3, sl, pool)
    empty = ck.agg_and_sub_arena(2, 1, torch.full((3, nb), -1,
                                                  dtype=torch.int32,
                                                  device=dev),
                                 pool[:0])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(),
                       blockops.agg_and_sub_arena(4, 3, sl.cpu(), pool.cpu()))
    # an empty pool: AND identity all ones, SUB identity zero
    assert empty.shape == (nb, 2048) and bool((empty == -1).all())


def test_agg_and_sub_kernel_slices(dev):
    """The four 2 KiB slices of one column die at different operands (0, 5,
    never, 9): rows and rows-off counts (summed over the slices) against a
    numpy fold."""
    rng = np.random.default_rng(7)
    K, n_and = 16, 12
    rows = np.full((K, 2048), 0xFFFFFFFF, np.uint32)
    rows[:, 512:1536] = rng.integers(0, 2**32, (K, 1024), dtype=np.uint64
                                     ).astype(np.uint32) | np.uint32(1)
    rows[0, :512] = 0                                  # slice 0 dies at 0
    rows[5, 512:1024] = 0                              # slice 1 dies at 5
    rows[1:, 1024:1536] = 0xFFFFFFFF                   # slice 2 never dies
    rows[9, 1536:] = 0                                 # slice 3 dies at 9
    rows[n_and:, 1024:1536] = 0
    want = np.full(2048, 0xFFFFFFFF, np.uint32)
    for k in range(K):
        want &= rows[k] if k < n_and else ~rows[k]
    assert (want[:512] == 0).all() and want[1024:1536].any()
    pool = torch.from_numpy(rows.view(np.int32).copy()).to(dev)
    descs = [(pool[k:k + 1], None, None, None, None) for k in range(K)]
    r, c = ck.agg_and_sub(n_and, descs, counts=True)
    only = ck.agg_and_sub(n_and, descs, rows=False, counts=True)[1]
    torch.cuda.synchronize()
    np.testing.assert_array_equal(blockops.to_host_words(r)[0], want)
    assert int(c[0]) == int(only[0]) == int(np.bitwise_count(want).sum())
    w_r, w_c = blockops.agg_and_sub(n_and, descs, counts=True)
    assert torch.equal(r, w_r) and torch.equal(c, w_c)


@pytest.mark.parametrize("V", [1, 64])
def test_agg_and_sub_batch_kernel(dev, rng, V):
    """The batched form, one launch, against the plain version: requests
    with n_and = 0, without SUB operands, without operands, and columns
    that die early and never."""
    K, nb = 12, 13
    stack = _dense_pool(rng, K * nb, dev, density=0.85).reshape(K, nb, 2048)
    sel = rng.integers(-1, 2, (V, K)).astype(np.int32)
    if V > 3:
        sel[1] = 0                                     # no operands
        sel[2] = -np.abs(sel[2])                       # n_and = 0
        sel[3] = np.abs(sel[3])                        # no SUB
    index, offs, n_and = blockops.selector_requests(sel)
    descs = [(stack[k], None, None, None, None) for k in range(K)]
    rows, cnt = ck.agg_and_sub_batch(descs, index, offs, n_and, counts=True)
    torch.cuda.synchronize()
    assert ck.launches["agg_and_sub"] == 1
    w_rows, w_cnt = blockops.agg_and_sub_batch(descs, index, offs, n_and,
                                               counts=True)
    assert torch.equal(rows, w_rows) and torch.equal(cnt, w_cnt)
    assert torch.equal(cnt, blockops.block_counts(
        rows.reshape(-1, 2048)).reshape(V, nb))


# ---------------------------------------------------------------------------
# B5: batched pipeline counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 21, 33, 65, 200])
@pytest.mark.parametrize("V", [1, 7, 256])
def test_pipeline_counts_kernel(dev, rng, S, V):
    nb = 3
    planes = _dense_pool(rng, S * nb, dev, density=0.6).reshape(S, nb, 2048)
    sel = rng.integers(-1, 2, (V, S)).astype(np.int32)
    sel[0] = 0                                         # all skip
    if V > 1:
        sel[1] = np.where(sel[1] == 0, 1, sel[1])      # no skip
    st = torch.from_numpy(sel).to(dev)
    got = ck.pipeline_counts(planes, st)
    torch.cuda.synchronize()
    want = blockops.pipeline_counts(planes.cpu(), sel)
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), want)
    assert int(want[0]) == nb * 65536
    assert ck.launches["pipeline_counts"] == 1


# every ceiling of the register path (8 .. 72 staged planes) and the
# shared path at its edges (73, 144 | 145, 200, 400); 130 values cross a
# 128-value chunk
@pytest.mark.parametrize("S", [0, 1, 8, 9, 16, 24, 32, 33, 40, 48, 56, 64,
                               65, 72, 73, 144, 145, 200, 400])
@pytest.mark.parametrize("skip", [False, True])
def test_pipeline_counts_kernel_paths(dev, rng, S, skip):
    nb = 2
    V = 130 if S <= ck.PIPELINE_REG_PLANES else 9
    planes = _dense_pool(rng, S * nb, dev, density=0.9).reshape(S, nb, 2048)
    sel = rng.choice(np.asarray([-1, 1], np.int32), (V, S))
    if skip:
        sel[rng.random((V, S)) < 0.5] = 0
    if V > 2 and S:
        sel[2] = 0
        sel[2, S - 1] = 1                              # one plane only
    if V > 1:
        sel[1] = 0                                     # all skip
    got = ck.pipeline_counts(planes, sel)
    torch.cuda.synchronize()
    want = blockops.pipeline_counts(planes, sel)       # plain, on the card
    assert torch.equal(got.cpu(), want.cpu())
    if V > 1:
        assert int(got[1]) == nb * 65536
    assert ck.launches["pipeline_counts"] == 1


# ---------------------------------------------------------------------------
# B6: bit-sliced equality scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_planes,nb", [(0, 2), (8, 3), (32, 13), (33, 2)])
def test_scan_eq_kernel(dev, rng, n_planes, nb):
    planes = _dense_pool(rng, max(n_planes, 1) * nb, dev).reshape(
        max(n_planes, 1), nb, 2048)
    for value in (0, 42, 0xFFFFFFFF, int(rng.integers(0, 2**32))):
        got = ck.scan_eq(n_planes, planes, value)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           blockops.scan_eq(n_planes, planes.cpu(), value))


def test_sharded_steps_launch_per_shard(dev, rng):
    """The sharded containers' per-shard steps launch one kernel per shard
    and give the answers of the same containers on a CPU mesh."""
    from bitmagic_tpu_torch.parallel import (Mesh, ShardedBitVector,
                                             ShardedSparseVector,
                                             sharded_and_many)
    size = 8 * 65536
    wa = rng.integers(0, 2**32, (8, 2048), dtype=np.uint64).astype(np.uint32)
    wb = rng.integers(0, 2**32, (8, 2048), dtype=np.uint64).astype(np.uint32)
    card, host = Mesh([dev] * 4), Mesh(["cpu"] * 4)
    a, b = (ShardedBitVector.from_words(w, size, card) for w in (wa, wb))
    ha, hb = (ShardedBitVector.from_words(w, size, host) for w in (wa, wb))
    for op in ("__and__", "__or__", "__xor__", "__sub__"):
        ck.reset_launches()
        r = getattr(a, op)(b)
        assert ck.launches["logical_op_digest"] == 4
        np.testing.assert_array_equal(r.to_words(),
                                      getattr(ha, op)(hb).to_words())
        ck.reset_launches()
        assert r.count() == getattr(ha, op)(hb).count()
        assert ck.launches["block_counts"] == 4
    ck.reset_launches()
    r = sharded_and_many([a, b], digest_narrowing=False)
    assert ck.launches["agg_and_sub"] == 4
    np.testing.assert_array_equal(
        r.to_words(), sharded_and_many([ha, hb],
                                       digest_narrowing=False).to_words())
    vals = rng.integers(0, 1000, 200_000).astype(np.uint32)
    sv = tbm.SparseVector.from_array(vals, device="cpu")
    s, h = (ShardedSparseVector.from_sparse_vector(sv, m)
            for m in (card, host))
    ck.reset_launches()
    assert s.pipeline_find_eq([7, 8]) == h.pipeline_find_eq([7, 8])
    assert ck.launches["pipeline_counts"] == 4
    np.testing.assert_array_equal(s.find_gt(500).to_words(),
                                  h.find_gt(500).to_words())
    np.testing.assert_array_equal(s.find_eq(7).to_words(),
                                  h.find_eq(7).to_words())


# ---------------------------------------------------------------------------
def _run_rows(rng, n):
    """n rows of 1 to 3000 runs each at random bounds, plus edge rows: all
    zero, all one, lone bits at 0 and 65535, 65536 one-bit runs."""
    out = []
    for k in rng.integers(1, 3000, n):
        cuts = np.sort(rng.choice(np.arange(1, 65536), k - 1, replace=False))
        val = (np.arange(k) + rng.integers(0, 2)) & 1
        bits = np.repeat(val, np.diff(np.concatenate([[0], cuts, [65536]])))
        out.append(np.packbits(bits.astype(np.uint8),
                               bitorder="little").view(np.uint32))
    edge = np.zeros((5, 2048), np.uint32)
    edge[1] = 0xFFFFFFFF
    edge[2, 0] = 1
    edge[3, -1] = 0x80000000
    edge[4] = 0x55555555
    return np.concatenate([np.stack(out), edge])


@pytest.mark.parametrize("n", [1, 40, 768])
def test_gap_rows_kernels(dev, rng, n):
    words = _run_rows(rng, n)
    store = GapStore.from_dense(words)
    sel = rng.permutation(words.shape[0]).astype(np.int32)
    sel_d = torch.from_numpy(sel).to(dev)
    got = ck.gap_expand(*store.device_arrays(dev), sel_d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), blockops.gap_expand(
        *store.device_arrays("cpu"), torch.from_numpy(sel)))
    assert np.array_equal(blockops.to_host_words(got), words[sel])
    total = int(store.offs[-1])
    for cap in (total, total + 100, total - 3):
        buf = ck.gap_compress(got, cap)
        torch.cuda.synchronize()
        want = blockops.gap_compress(got.cpu(), cap)
        for g, w in zip(blockops.gap_unpack(buf.cpu(), got.shape[0]),
                        blockops.gap_unpack(want, got.shape[0])):
            assert torch.equal(g, w)
    back = GapStore.from_packed(ck.gap_compress(got, total), got.shape[0])
    want = store.subset(sel)
    for key in ("ends", "offs", "first"):
        assert np.array_equal(getattr(back, key), getattr(want, key))
    assert ck.launches["gap_expand"] == 1
    # one launch a call
    assert ck.launches["gap_compress"] == 4


def test_gap_compress_cases(dev):
    """gap_compress over ``chip_smoke.compress_cases`` (20,000 rows, more
    CTAs than the card holds at once, for the look-back; rows of 65536
    runs; cap equal to the total, above it and below it) against its
    plain version and ``GapStore.from_dense``: one launch each."""
    import chip_smoke as cs
    for name, rows, cap, store in cs.compress_cases(
            np.random.default_rng(15), dev):
        n0 = ck.launches["gap_compress"]
        buf = ck.gap_compress(rows, cap)
        torch.cuda.synchronize()
        assert ck.launches["gap_compress"] == n0 + 1
        n = rows.shape[0]
        want = blockops.gap_compress(rows, cap)
        for g, w in zip(blockops.gap_unpack(buf, n),
                        blockops.gap_unpack(want, n)):
            assert torch.equal(g, w), name
        if cap >= int(store.offs[-1]):
            back = GapStore.from_packed(buf, n)
            for key in ("ends", "offs", "first"):
                assert np.array_equal(getattr(back, key),
                                      getattr(store, key)), name
        else:
            with pytest.raises(RuntimeError):
                GapStore.from_packed(buf, n)


@pytest.fixture(scope="module")
def b8_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    import chip_smoke as cs
    return dict(cs.bitap_kernel_cases(tbm, torch.device("cuda")))


@pytest.mark.parametrize("case", ["sample06_ACGG", "k33_gaps", "k34_gaps",
                                  "k65_gaps", "k65538_contiguous",
                                  "k131075_contiguous", "k40_first_zero"])
def test_shift_and_chain_kernel(dev, b8_cases, case):
    """B8 (``shift_and_chain``) over ``chip_smoke.bitap_kernel_cases``
    (samples/06's chain, chains of 33, 34 and 65 operands over a block
    list with gaps, 65538 and 131075 over a contiguous one, the last
    reading three blocks back, and 40 whose first vector zeroes every row,
    so that every CTA stops after its first copy) against its plain
    version, bit for bit: one launch a call."""
    first_mask, descs = b8_cases[case]
    ck.reset_launches()
    got = ck.shift_and_chain(first_mask, descs)
    torch.cuda.synchronize()
    assert ck.launches["shift_and_chain"] == 1
    assert torch.equal(got, blockops.shift_and_chain(first_mask, descs))


GAP_CASES = ["edges", "one_row", "top_level", "above_top_level", "pair",
             "pair_a_empty", "pair_b_empty"]


@pytest.mark.parametrize("name", GAP_CASES)
def test_gap_expand_cases(dev, name):
    """gap_expand's pair launch over chip_smoke.gap_cases (1-run blocks,
    runs ending on bits 31 / 32 of a word and on 65534, 1280 runs (the
    default top GAP level) and above it, two stores, either side empty)
    against its plain version: one launch each."""
    import chip_smoke as cs
    cases = cs.gap_cases(np.random.default_rng(14), dev)
    assert [c[0] for c in cases] == GAP_CASES
    args = dict((c[0], c[1:]) for c in cases)[name]
    got = ck.gap_expand_pair(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, blockops.gap_expand_pair(*args))
    assert ck.launches["gap_expand"] == 1


@pytest.mark.parametrize("name", GAP_CASES)
def test_gap_expand_many_cases(dev, name):
    """gap_expand's many-store launch over the stores and blocks of
    chip_smoke.gap_cases: one launch, bit for bit the pair launch's rows
    and its plain version."""
    import chip_smoke as cs
    cases = dict((c[0], c[1:]) for c in cs.gap_cases(
        np.random.default_rng(cs.SEED + 1), dev))
    m_a, m_b, sel, k_a = cases[name]
    sel = sel.cpu().numpy()
    parts = [(m, x) for m, x in ((m_a, sel[:k_a]), (m_b, sel[k_a:]))
             if x.size]
    mirrors, sels = [m for m, _ in parts], [x for _, x in parts]
    ck.reset_launches()
    got = ck.gap_expand_many(mirrors, sels)
    torch.cuda.synchronize()
    assert ck.launches["gap_expand"] == 1
    assert torch.equal(got, blockops.gap_expand_many(mirrors, sels))
    assert torch.equal(got, ck.gap_expand_pair(*cases[name]))


def test_cell1_step_launches_seven_gap_expands(dev):
    """One step of bvsetalgebra_rank_select (bench_torch.py, cut to 24
    blocks) on the card: seven gap_expand launches (a pair each in
    count_and, the four operations and distance_operation, A's alone in
    shift_right), its answers against the cell's oracle."""
    import bench_torch as bt
    w, cfg = bt.load_workload("bvsetalgebra_rank_select")
    sizes = dict(cfg["sizes"], blocks_per_vector=24,
                 bits_per_vector=24 * bt.BLOCK_BITS,
                 row_bytes_per_vector=24 * bt.ROW, select_queries=1000,
                 rank_queries=1000)
    cell = bt.TRAFFIC[w["traffic"]](7, sizes)
    cell.build(dev)
    n0 = ck.launches["gap_expand"]
    answers = cell.step(bt.Step(dev))
    torch.cuda.synchronize()
    assert ck.launches["gap_expand"] - n0 == 7
    bt.check_answers("cut cell 1", answers, cell.oracle())


def test_gap_routes_on_card_match_cpu(dev, rng, monkeypatch):
    """GAP x GAP, GAP x FULL and GAP x ZERO pairs through the four ops and
    distance_operation on the card give the CPU's state and answers, and
    neither host run merge runs."""
    from bitmagic_tpu_torch.core import gapstore
    size = 40 * 65536
    runs = rng.integers(0, size - 300, 4000)
    ids_a = (runs[:, None] + np.arange(100)).ravel()
    ids_b = np.concatenate([(runs[:2000, None] + 150
                             + np.arange(100)).ravel(),
                            np.arange(65536 * 30, 65536 * 33)])
    dense = rng.integers(0, 10 * 65536, 100000)      # BIT blocks 0-9

    def refuse(*a, **k):
        raise AssertionError("host run-domain merge called")

    out = {}
    for d in ("cpu", dev):
        a = tbm.BitVector.from_indices(ids_a, size, device=d, strategy=1)
        a |= tbm.BitVector.from_indices(dense, size, device=d)
        b = tbm.BitVector.from_indices(ids_b, size, device=d, strategy=1)
        a.optimize()
        b.optimize()
        assert (a._struct.cls == C.CLS_GAP).sum() > 20
        assert (b._struct.cls == C.CLS_GAP).sum() > 20
        with monkeypatch.context() as m:
            m.setattr(gapstore, "gap_binary_op", refuse)
            m.setattr(gapstore, "gap_metric_counts", refuse)
            out[str(d)] = [interop.bitvector_to_parts(getattr(a, op)(b))
                           for op in ("__and__", "__or__", "__xor__",
                                      "__sub__")]
            out[str(d)].append(tbm.distance_operation(
                a, b, list(blockops.METRICS)))
    got, want = out[str(dev)], out["cpu"]
    for g, w in zip(got[:4], want[:4]):
        for key in interop.PARTS:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got[4] == want[4]
    assert ck.launches["gap_expand"] and ck.launches["gap_compress"]


def _sv_columns(rng, dev):
    """Columns on the card and the same columns on the CPU, with BIT,
    D-GAP, FULL and FULL-run blocks, absent planes and a NULL plane that is
    BIT, then one that is FULL: (card column, CPU column, size) each."""
    n = 34 * 65536 + 777
    v = rng.integers(0, 1 << 20, n).astype(np.uint32) | np.uint32(1 << 21)
    v[65536:3 * 65536] &= np.uint32(0xF)              # planes 4-19 zero
    v[::7] = 0
    nm = rng.random(n) < 0.01
    nm[:65536] = False
    s = rng.integers(-(1 << 62), 1 << 62, 200000)
    s[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1]
    out = []
    for vals, kw in ((v, {"null_mask": nm}), (v, {"nullable": True}),
                     (s, {"nullable": True}), (s.astype(np.int32), {})):
        pair = [tbm.SparseVector.from_array(vals, device=d, **kw)
                for d in (dev, "cpu")]
        for c in pair:
            c.optimize()
        out.append((*pair, vals.size))
    return out


def test_sv_planes_kernels(dev, rng):
    """sv_gather and sv_transpose against their plain versions on the
    card; three sv_gather launches per grouped gather, one per direct one
    (100 ids), none for an empty one; from_array launches sv_transpose; a
    bad input raises."""
    cols = _sv_columns(rng, dev)
    assert ck.launches["sv_transpose"] == len(cols)
    kinds = set()
    for card, cpu, n in cols:
        for p in card.planes + [card.null_plane]:
            if p is not None:
                kinds.update(np.unique(p._struct.cls).tolist())
                if p._struct.has_runs:
                    kinds.add("runs")
        ids = rng.integers(0, n + 3 * 65536, 100000)
        table = card._plane_table()
        d_ids = torch.from_numpy(ids).to(dev)
        got = ck.sv_gather(d_ids, table)
        torch.cuda.synchronize()
        assert torch.equal(got, blockops.sv_gather(d_ids, table))
        before = ck.launches["sv_gather"]
        np.testing.assert_array_equal(card.gather(ids), cpu.gather(ids))
        grouped = ck._gather_grouped(ids.size, table)
        assert ck.launches["sv_gather"] == before + (3 if grouped else 1)
        np.testing.assert_array_equal(card.gather(ids[:100]),
                                      cpu.gather(ids[:100]))
        card.gather(np.zeros(0, np.int64))
        assert ck.launches["sv_gather"] == before + (4 if grouped else 2)
    assert kinds >= {1, 2, 3, "runs"}
    for n_slices, dt in ((1, torch.int32), (20, torch.int32),
                         (32, torch.int32), (33, torch.int64),
                         (64, torch.int64)):
        vals = torch.from_numpy(rng.integers(
            -2**31 if dt == torch.int32 else -2**63, 2**31 - 1
            if dt == torch.int32 else 2**63 - 1, 32 * 999 + 5)).to(dt)
        vals = vals.to(dev)
        got = ck.sv_transpose(vals, n_slices)
        torch.cuda.synchronize()
        assert torch.equal(got, blockops.sv_transpose(vals, n_slices))
    with pytest.raises(TypeError):
        ck.sv_gather(d_ids.to(torch.int32), table)
    with pytest.raises(ValueError):
        ck.sv_transpose(vals.to(torch.int32), 33)


GATHER_CASES = ["one_block", "sorted", "duplicates", "past_end_absent",
                "sparse_direct", "wide_directory", "planes65", "uniform"]


@pytest.fixture(scope="module")
def gather_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from chip_smoke import gather_cases as cases
    got = {name: (c, ids, grouped) for name, c, ids, grouped in cases(
        tbm, np.random.default_rng(7), torch.device("cuda"))}
    assert sorted(got) == sorted(GATHER_CASES)
    return got


@pytest.mark.parametrize("name", GATHER_CASES)
def test_sv_gather_cases(dev, gather_cases, name):
    """The grouped gather's risky cases (chip_smoke.gather_cases) against
    the plain version, bit for bit, each on the route its size gives it;
    a grouped gather is three launches."""
    c, ids, grouped = gather_cases[name]
    table = c._plane_table()
    assert ck._gather_grouped(ids.shape[0], table) == grouped
    got = ck.sv_gather(ids, table)
    torch.cuda.synchronize()
    assert torch.equal(got, blockops.sv_gather(ids, table))
    assert ck.launches["sv_gather"] == (3 if grouped else 1)


SELECT_VECTORS = ["cell", "edge", "full_only", "gap_only", "bit_only",
                  "wide"]


@pytest.fixture(scope="module")
def select_indices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    import chip_smoke as cs
    rng = np.random.default_rng(8)
    dev = torch.device("cuda")
    vecs = {"cell": cs.rs_cell_vector(tbm, rng, dev)[0],
            "edge": cs.rs_edge_vector(tbm, dev),
            "wide": cs.wide_index_vector(tbm, rng, dev),
            **cs.class_vectors(tbm, rng, dev)}
    return {k: v.build_rs_index() for k, v in vecs.items()}


@pytest.mark.parametrize("vec", SELECT_VECTORS)
def test_rs_select_cases(dev, select_indices, vec):
    """rs_select over chip_smoke.select_cases of each index (one launch
    per case; the wide index stages only a sample of cum0), and
    select_flat over its pool (the wide one's gws staged as a sample),
    against the plain versions."""
    from bitmagic_tpu_torch.ops import select as plain
    import chip_smoke as cs
    rs = select_indices[vec]
    rng = np.random.default_rng(9)
    runs = rs._gap_runs()
    sargs = (rs._seg, rs._cum0_dev, runs, rs.pool, rs.gwc)
    cases = cs.select_cases(rs, rng)
    for name, ranks in cases:
        q = torch.from_numpy(ranks).to(dev)
        got = ck.rs_select(*sargs, q, rs.total, rs._select_tables())
        torch.cuda.synchronize()
        assert torch.equal(got, plain.rs_select(*sargs, q, rs.total)), name
    assert ck.launches["rs_select"] == len(cases)
    if rs.gwc.numel() and int(rs.gwc[-1]):
        g = torch.from_numpy(rng.integers(
            -3, int(rs.gwc[-1]) + 3, 20000).astype(np.int32)).to(dev)
        got = ck.select_flat(rs.pool, rs.gwc, g,
                             plain.flat_tables(rs.pool, rs.gwc))
        torch.cuda.synchronize()
        assert torch.equal(got, plain.select_flat(rs.pool, rs.gwc, g))


@pytest.mark.parametrize("vec", SELECT_VECTORS)
def test_rs_rank_cases(dev, select_indices, vec):
    """rs_rank over chip_smoke.rank_cases of each index (one launch per
    case, one id among them; the wide index stages only a sample of nb)
    and rank_flat over its pool (one offset among them) against the plain
    versions."""
    import chip_smoke as cs
    rs = select_indices[vec]
    rng = np.random.default_rng(15)
    errs = []

    def cmp(name, got, want):
        torch.cuda.synchronize()
        errs.append(bool(torch.equal(got, want)))

    cs.rank_cases_vs_plain(rs, rng, cmp)
    assert errs and all(errs)
    n_cases = len(cs.rank_cases(rs, rng))
    assert ck.launches["rs_rank"] == n_cases + (2 if rs.pool.shape[0]
                                                else 0)


def test_sharded_select_flat(dev, select_indices):
    """select_flat and rank_flat per shard of an 8-shard ShardedRSIndex
    on one card against their plain versions; the index's batches against
    numpy."""
    import chip_smoke as cs
    rng = np.random.default_rng(10)
    bv, words = cs.rs_cell_vector(tbm, rng, dev)
    errs = []

    def cmp(name, got, want):
        torch.cuda.synchronize()
        errs.append(bool(torch.equal(got, want)))

    cs.sharded_select_vs_plain(bv, words, dev, rng, cmp)
    assert errs and all(errs)


def test_rs_select_kernels(dev, rng):
    """rs_select and rs_rank, and their flat forms, against their plain
    versions on the card; the index's batches against numpy with one
    launch each, none for an empty batch; a wrong dtype raises."""
    from bitmagic_tpu_torch.ops import select as plain
    from chip_smoke import rs_edge_vector
    bv = rs_edge_vector(tbm, dev)
    rs = bv.build_rs_index()
    runs = rs._gap_runs()
    total, size = rs.total, bv.size
    ranks = np.concatenate([[-1, 0, 1, total, total + 1], rs.cum,
                            rs.cum + 1, rng.integers(1, total + 1, 50000)])
    borders = np.arange(50) * C.BITS_PER_BLOCK
    ids = np.concatenate([[-1, 0, size - 1, size], borders - 1, borders,
                          rng.integers(0, size, 50000)])
    q, i = torch.from_numpy(ranks).to(dev), torch.from_numpy(ids).to(dev)
    sargs = (rs._seg, rs._cum0_dev, runs, rs.pool, rs.gwc)
    rargs = (rs._seg, rs._nb_dev, runs, rs.pool, rs.gwc)
    got = ck.rs_select(*sargs, q, total, rs._select_tables())
    torch.cuda.synchronize()
    assert torch.equal(got, plain.rs_select(*sargs, q, total))
    got = ck.rs_rank(*rargs, i, rs._rank_tables())
    torch.cuda.synchronize()
    assert torch.equal(got, plain.rs_rank(*rargs, i))
    g = torch.from_numpy(rng.integers(1, int(rs.gwc[-1]) + 1, 50000).astype(
        np.int32)).to(dev)
    flat = plain.flat_tables(rs.pool, rs.gwc)
    got = ck.select_flat(rs.pool, rs.gwc, g, flat)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.select_flat(rs.pool, rs.gwc, g))
    rel = torch.from_numpy(rng.integers(0, rs.pool.shape[0] * 65536,
                                        50000)).to(dev)
    got = ck.rank_flat(rs.pool, rs.gwc, rel,
                       plain.flat_rank_tables(rs.gwc, flat.wsp))
    torch.cuda.synchronize()
    assert torch.equal(got, plain.rank_flat(rs.pool, rs.gwc, rel))
    assert ck.launches["rs_select"] == ck.launches["rs_rank"] == 2
    ones = np.flatnonzero(np.unpackbits(bv.to_words().ravel().view(np.uint8),
                                        bitorder="little"))
    ok = (ranks >= 1) & (ranks <= total)
    want = np.where(ok, ones[np.clip(ranks, 1, total) - 1], -1)
    np.testing.assert_array_equal(rs.select_batch(ranks), want)
    np.testing.assert_array_equal(rs.rank_batch(ids),
                                  np.searchsorted(ones, ids, side="right"))
    rs.select_batch(np.zeros(0, np.int64))
    assert ck.launches["rs_select"] == ck.launches["rs_rank"] == 3
    with pytest.raises(TypeError):
        ck.rs_select(*sargs, q.to(torch.int32), total, rs._select_tables())
    with pytest.raises(TypeError):
        ck.select_flat(rs.pool, rs.gwc, g.long(), flat)


def _same_parts(a, b):
    pa, pb = interop.bitvector_to_parts(a), interop.bitvector_to_parts(b)
    for key in interop.PARTS:
        np.testing.assert_array_equal(np.asarray(pa[key]),
                                      np.asarray(pb[key]), err_msg=key)


def test_sv_descent_kernels(dev, rng):
    """sv_descent and descent_rows against their plain versions on the
    card over columns with every block class (chip_smoke.descent_column);
    the fused descent equals the chain of set operations on the card in
    every part; an unsigned find_gt is one sv_descent launch and no K1;
    a bad step raises."""
    from chip_smoke import descent_chain, descent_column, descent_queries
    from bitmagic_tpu_torch.core.bitvector import descent_args
    from bitmagic_tpu_torch.sv.scanner import _universe
    sc = tbm.SparseVectorScanner()
    for dtype, nullable in ((np.uint32, False), (np.uint32, True),
                            (np.int16, True)):
        c = descent_column(tbm, dtype, nullable, device=dev)
        bits = np.iinfo(dtype).bits
        uni = _universe(c)
        for q in descent_queries(bits):
            table, steps, _ = sc._descent_steps(c, q, bits)
            args = descent_args(table, uni, steps, np.union1d(table.blocks,
                                                       uni._struct.nb))
            got = ck.sv_descent(table, *args)
            torch.cuda.synchronize()
            for g, w in zip(got, blockops.sv_descent(table, *args)):
                assert torch.equal(g, w)
            fused = sc._cmp_unsigned(c, uni, q, bits)
            for f, w in zip(fused, descent_chain(tbm, c.planes, uni, q,
                                                 bits)):
                _same_parts(f, w)
    c = descent_column(tbm, np.uint32, True, device=dev)
    ck.reset_launches()
    sc.find_gt(c, 12345)
    assert ck.launches["sv_descent"] == 1
    assert ck.launches["logical_op_digest"] == 0
    stack = _pool(rng, 8 * 13, dev).reshape(8, 13, 2048)
    rows = [5, -1, 0, 3, 7, 2]
    for mode in (0, 1, 2):
        got = ck.descent_rows(stack, stack[6], rows, 0b100101, stack[1],
                              mode)
        torch.cuda.synchronize()
        want = blockops.descent_rows(stack, stack[6], rows, 0b100101,
                                     stack[1], mode)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError):
        ck.sv_descent(table, *args[:2], [0] * 65, 0)
    with pytest.raises(ValueError):
        ck.descent_rows(stack, stack[6], [8], 0)


@pytest.mark.parametrize("n", [1, 31, 33, 1023, 1025, 32 * 999 + 5])
@pytest.mark.parametrize("n_slices,width", [(1, 4), (20, 4), (32, 4), (1, 8),
                                            (20, 8), (33, 8), (64, 8)])
def test_sv_transpose_tails(dev, rng, n, n_slices, width):
    """sv_transpose against its plain version where its warp tiles break:
    n short of a word and of a warp's 1024 values, 4- and 8-byte values
    (slices 32-63 from the high words), values 16-byte aligned and not."""
    dt = torch.int32 if width == 4 else torch.int64
    info = torch.iinfo(dt)
    vals = torch.from_numpy(rng.integers(info.min, info.max, n + 1,
                                         endpoint=True)).to(dt).to(dev)
    for v in (vals[:n], vals[1:]):
        got = ck.sv_transpose(v, n_slices)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), blockops.sv_transpose(v.cpu(),
                                                            n_slices))
    assert ck.launches["sv_transpose"] == 2


RING_CASES = ["one step", "one step, 0-bit", "64 steps", "early stop",
              "early stop, 0-bits"]


@pytest.fixture(scope="module")
def ring_columns():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    import chip_smoke as cs
    cols = cs.descent_ring_columns(tbm, np.random.default_rng(23),
                                   torch.device("cuda"))
    return {name: rest for name, *rest in cols}


@pytest.mark.parametrize("case", RING_CASES)
def test_sv_descent_ring(dev, ring_columns, case):
    """sv_descent against its plain version where its ring of staged rows
    breaks: one step, 64 BIT steps (the ring wraps), blocks that stop
    early with copies in flight; gt and eq with and without eq, and the
    fused search against the chain of set operations in every part."""
    from chip_smoke import descent_chain
    from bitmagic_tpu_torch.core.bitvector import descent_args
    from bitmagic_tpu_torch.sv.scanner import _universe
    c, n_bits, q = ring_columns[case]
    sc = tbm.SparseVectorScanner()
    uni = _universe(c)
    table, steps, _ = sc._descent_steps(c, q, n_bits)
    args = descent_args(table, uni, steps,
                        np.union1d(table.blocks, uni._struct.nb))
    for want_eq in (True, False):
        got = ck.sv_descent(table, *args, want_eq)
        torch.cuda.synchronize()
        for g, w in zip(got, blockops.sv_descent(table, *args, want_eq)):
            assert (g is None and w is None) or torch.equal(g, w)
    assert ck.launches["sv_descent"] == 2
    fused = sc._cmp_unsigned(c, uni, q, n_bits)
    for f, w in zip(fused, descent_chain(tbm, c.planes, uni, q, n_bits)):
        _same_parts(f, w)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 31, 33, 245])
def test_descent_rows_shapes(dev, rng, n, mode):
    """descent_rows against its plain version at 1, 31 (a shard of 8 of
    config 4b's column), 33 and 245 rows in each mode, over 6 and 64
    steps (two batches of a thread's loads) with -1 rows and a zero
    plane."""
    stack = _pool(rng, 8 * n, dev).reshape(8, n, 2048)
    stack[2] = 0
    for rows, bits in (([5, -1, 2, 0, 3, 7], 0b100101),
                       ([int(r) for r in rng.integers(-1, 8, 64)],
                        int(rng.integers(0, 2**63)) | 1 << 63)):
        got = ck.descent_rows(stack, stack[6], rows, bits, stack[1], mode)
        torch.cuda.synchronize()
        want = blockops.descent_rows(stack, stack[6], rows, bits, stack[1],
                                     mode)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ck.launches["sv_descent"] == 2
