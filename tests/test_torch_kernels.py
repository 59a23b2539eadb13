"""The six hand-written Hopper kernels against their plain PyTorch
versions (or hand-worked counts), on the card.  Every test here needs
CUDA (marker ``cuda``) and skips without it.  On a machine with an H100
and no JAX, run them without the suite's conftest (which imports JAX):

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: exact equality (integer results)."""
import numpy as np
import pytest
import torch

import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch import interop
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
