"""Rank/select of the PyTorch port against the JAX ``RSIndex``, on the CPU.
Select is 1-based; out-of-range ranks give -1.  Tolerance: exact."""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bench_torch import run_block
from bitmagic_tpu.utils.golden import GoldenBitSet, random_indices
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.constants import BITS_PER_BLOCK
from bitmagic_tpu_torch.core import rs_index as trs
from bitmagic_tpu_torch.core.gapstore import GapStore
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


def _gap_heavy_words(seed, n_blocks, full_run):
    """A word image of ``n_blocks`` blocks, half of them drawn as 1-256
    runs (bench_torch.run_block, D-GAP after optimize()), the rest dense
    random words, single FULL blocks and ZERO gaps; ``full_run`` puts a
    33-block FULL run (one multi-block segment) in the middle."""
    rng = np.random.default_rng(seed)
    kinds = np.array(["gap"] * (n_blocks // 2) + ["bit", "full", "zero"]
                     * n_blocks)[:n_blocks]
    rng.shuffle(kinds)
    if full_run:
        kinds = np.concatenate([kinds[:n_blocks // 2], ["full"] * 33,
                                kinds[n_blocks // 2:]])
    words = np.zeros((len(kinds), C.SET_BLOCK_SIZE), np.uint32)
    for i, k in enumerate(kinds):
        if k == "gap":
            words[i] = run_block(rng, int(rng.integers(1, 257)))
        elif k == "bit":
            words[i] = rng.integers(0, 2**32, C.SET_BLOCK_SIZE,
                                    dtype=np.uint64).astype(np.uint32)
        elif k == "full":
            words[i] = 0xFFFFFFFF
    return words.ravel()


@pytest.mark.parametrize("seed,n_blocks,full_run",
                         [(1, 16, False), (2, 20, True), (3, 24, True)])
def test_rank_select_gap_heavy(seed, n_blocks, full_run):
    """D-GAP-heavy vectors: ranks at every block border, at bit 0 and bit
    65535 of each GAP block, past the end and negative; selects at every
    segment's first and last rank, 0, 1, total, total + 1 and negatives."""
    words = _gap_heavy_words(seed, n_blocks, full_run)
    jv, tv = jbm.BitVector.from_words(words), tbm.BitVector.from_words(words)
    for v in (jv, tv):
        v.optimize()
    st = tv._struct
    assert {C.CLS_BIT, C.CLS_GAP, C.CLS_FULL} <= set(st.cls.tolist())
    assert st.has_runs == full_run
    jr, tr = jv.build_rs_index(), tv.build_rs_index()
    np.testing.assert_array_equal(tr.cum, jr.cum)
    size = words.size * 32
    gap_nb = st.nb[st.cls == C.CLS_GAP]
    borders = np.arange(len(words) // C.SET_BLOCK_SIZE + 1) * BITS_PER_BLOCK
    rng = np.random.default_rng(seed)
    ids = np.concatenate([borders - 1, borders, borders + 1,
                          gap_nb * BITS_PER_BLOCK,
                          gap_nb * BITS_PER_BLOCK + BITS_PER_BLOCK - 1,
                          rng.integers(0, size, 500), [size, -1, -7]])
    np.testing.assert_array_equal(tr.rank_batch(ids), jr.rank_batch(ids))
    total = tr.count()
    assert total == int(np.bitwise_count(words).sum())
    cum = tr.cum
    ranks = np.concatenate([cum, cum + 1, np.concatenate([[0], cum[:-1]]) + 1,
                            rng.integers(1, total + 1, 500),
                            [0, 1, total, total + 1, -1, -3]])
    want = jr.select_batch(ranks)
    np.testing.assert_array_equal(tr.select_batch(ranks), want)
    ones = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little"))
    ok = (ranks >= 1) & (ranks <= total)
    np.testing.assert_array_equal(want[ok], ones[ranks[ok] - 1])
    assert (want[~ok] == -1).all()


def test_rank_select_batches_skip_host_gap_queries(monkeypatch):
    """select_batch and rank_batch answer GAP blocks from the index's own
    device tables, never through the host GapStore's queries."""
    words = _gap_heavy_words(4, 20, True)
    jv, tv = jbm.BitVector.from_words(words), tbm.BitVector.from_words(words)
    for v in (jv, tv):
        v.optimize()
    jr, tr = jv.build_rs_index(), tv.build_rs_index()

    def refuse(*args, **kwargs):
        raise AssertionError("host GapStore query on the rs-index path")

    monkeypatch.setattr(GapStore, "select_in_block", refuse)
    monkeypatch.setattr(GapStore, "rank_in_block", refuse)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, words.size * 32, 2000)
    ranks = rng.integers(1, tr.count() + 1, 2000)
    np.testing.assert_array_equal(tr.rank_batch(ids), jr.rank_batch(ids))
    np.testing.assert_array_equal(tr.select_batch(ranks),
                                  jr.select_batch(ranks))
    assert tv.select(int(ranks[0])) == jv.select(int(ranks[0]))
