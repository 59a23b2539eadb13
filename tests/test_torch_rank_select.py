"""Rank/select of the PyTorch port against the JAX ``RSIndex``, on the CPU.
Select is 1-based; out-of-range ranks give -1.  Tolerance: exact."""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.utils.golden import GoldenBitSet, random_indices
from bitmagic_tpu_torch.constants import BITS_PER_BLOCK
from bitmagic_tpu_torch.core import rs_index as trs
from bitmagic_tpu_torch.ops import select as tsel

torch.set_num_threads(1)

SIZE = 5 * BITS_PER_BLOCK + 321


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _both(idx, size=SIZE, strategy=None):
    return (jbm.BitVector.from_indices(idx, size, strategy=strategy),
            tbm.BitVector.from_indices(idx, size, strategy=strategy))


@pytest.mark.parametrize("style", ["uniform", "intervals", "borders"])
@pytest.mark.parametrize("strategy", [None, 1])
def test_rank_select_batches(rng, style, strategy):
    idx = random_indices(rng, SIZE, 0.02, style)
    jv, tv = _both(idx, strategy=strategy)
    jr, tr = jv.build_rs_index(), tv.build_rs_index()
    assert tr.count() == jr.count() == GoldenBitSet.from_indices(
        idx, SIZE).count()
    np.testing.assert_array_equal(tr.cum, jr.cum)
    np.testing.assert_array_equal(tr.gwc.numpy(), np.asarray(jr.gwc))
    probes = np.concatenate([rng.integers(0, SIZE, 300), [0, SIZE - 1]])
    np.testing.assert_array_equal(tr.rank_batch(probes),
                                  jr.rank_batch(probes))
    ranks = np.concatenate([rng.integers(-2, tr.count() + 3, 300),
                            [0, 1, tr.count(), tr.count() + 1]])
    np.testing.assert_array_equal(tr.select_batch(ranks),
                                  jr.select_batch(ranks))
    assert tr.select(0) == -1 and tr.select(tr.count() + 1) == -1


def test_select_with_full_segments(rng):
    def run(pkg):
        bv = pkg.BitVector(40 * BITS_PER_BLOCK)
        bv.set_range(BITS_PER_BLOCK, 3 * BITS_PER_BLOCK - 1)   # FULL blocks
        bv.set_range(5 * BITS_PER_BLOCK, 38 * BITS_PER_BLOCK - 1)  # run
        bv.set(7)
        bv.set(4 * BITS_PER_BLOCK + 11)
        bv.set(39 * BITS_PER_BLOCK + 5)
        bv.optimize()
        return bv

    jv, tv = run(jbm), run(tbm)
    assert tv._struct.has_runs
    jr, tr = jv.build_rs_index(), tv.build_rs_index()
    total = tr.count()
    ranks = np.asarray([1, 2, 100, 65537, 3 * 65536, total - 1, total,
                        total + 1])
    np.testing.assert_array_equal(tr.select_batch(ranks),
                                  jr.select_batch(ranks))
    probes = np.asarray([0, 7, BITS_PER_BLOCK, 2 * BITS_PER_BLOCK + 5,
                         20 * BITS_PER_BLOCK, 39 * BITS_PER_BLOCK + 5,
                         40 * BITS_PER_BLOCK - 1])
    np.testing.assert_array_equal(tr.rank_batch(probes),
                                  jr.rank_batch(probes))


def test_bv_select_find_rank_and_invalidation(rng):
    idx = random_indices(rng, SIZE, 0.01)
    jv, tv = _both(idx)
    gi = np.unique(idx)
    for r in (1, len(gi), len(gi) + 5):
        assert tv.select(r) == jv.select(r)
    frm = int(gi[len(gi) // 2])
    for r in (1, 3):
        assert tv.find_rank(r, frm) == jv.find_rank(r, frm)
    bv = tbm.BitVector.from_indices([10, 20, 30], SIZE)
    assert bv.select(2) == 20
    bv.set(15)
    assert bv.select(2) == 15       # the index rebuilds after a mutation
    bv.clear_bit(10)
    assert bv.select(1) == 15


def test_select_helpers_match(rng):
    import jax.numpy as jnp
    from bitmagic_tpu.ops import select as jsel
    pool = rng.integers(0, 2**32, (3, 2048), dtype=np.uint64).astype(
        np.uint32)
    pool[1, 100:900] = 0
    tp = torch.from_numpy(pool.view(np.int32).copy())
    np.testing.assert_array_equal(tsel.wave_prefix(tp).numpy(),
                                  np.asarray(jsel.wave_prefix(
                                      jnp.asarray(pool))))
    wc = tsel.wave_prefix(tp)
    rows = rng.integers(0, 3, 200).astype(np.int32)
    rem = (rng.integers(0, 2**31, 200)
           % np.bitwise_count(pool).sum(1)[rows] + 1).astype(np.int32)
    got = tsel.select_in_pool(tp, wc, torch.from_numpy(rows),
                              torch.from_numpy(rem)).numpy()
    want = np.asarray(jsel.select_in_pool(jnp.asarray(pool),
                                          jnp.asarray(wc.numpy()),
                                          jnp.asarray(rows),
                                          jnp.asarray(rem)))
    np.testing.assert_array_equal(got, want)


def test_rs_index_int32_bound_enforced(rng, monkeypatch):
    """A pool holding >= 2^31 set bits refuses to build an rs_index (the
    select descent carries pool-global ranks as int32) — loudly, not by
    wrapping.  Simulated via patched block counts."""
    idx = random_indices(rng, 4 * BITS_PER_BLOCK, 0.01)
    bv = tbm.BitVector.from_indices(idx, 4 * BITS_PER_BLOCK)
    n_rows = bv._pool.shape[0]
    monkeypatch.setattr(
        trs.ck, "block_counts",
        lambda pool: torch.full((pool.shape[0],),
                                2**31 // max(n_rows, 1) + 1,
                                dtype=torch.int64))
    with pytest.raises(ValueError, match="2\\^31"):
        trs.RSIndex.build(bv)
