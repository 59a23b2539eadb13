"""K2's metric plan and the total forms of K2 and K3 against the JAX
package, on the CPU.

Kernel K2 popcounts either the requested metrics or the base counts
|a & b|, |a| and |b| they follow from, whichever are fewer, and combines
them per block with small integer coefficients (``blockops.count_plan``);
its plain version counts the same way.  The
total forms (``block_counts_total``, ``count_metrics_total``) sum the
per-block counts in int64 in the same launch, and ``BitVector.count()`` and
``distance_operation`` take them.  Everything here is held against
``bitmagic_tpu`` (``_metric_kernel``, ``blockops.block_counts``,
``BitVector.count``, ``distance_operation`` and ``count_*``) on seeded
numpy inputs with FULL rows, GAP (aux) rows, -1 slots, FULL runs and empty
vectors.  On the CPU the wrappers take the plain versions and launch
nothing.  Tolerance: exact equality.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.algo import setops as jsetops
from bitmagic_tpu.ops import blockops as jops
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.ops import blockops as tops
from bitmagic_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

METRICS = tops.METRICS
BPB = C.BITS_PER_BLOCK
SIZE = 40 * BPB


@pytest.fixture(autouse=True)
def _cpu_no_launches(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")
    ck.reset_launches()
    yield
    assert not any(ck.launches.values()), ck.launches


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)
                            .copy())


def _pool(rng, n):
    p = rng.integers(0, 2**32, (n, 2048), dtype=np.uint64).astype(np.uint32)
    if n > 3:
        p[1] = 0
        p[2] = 0xFFFFFFFF
        p[3, ::3] = 0
    return p


def _descriptor_pair(rng, k=17, a_rows=9, b_rows=6):
    """Numpy descriptors (pool, slot, full, aux, aux_slot) of two operands
    aligned on k blocks: -1 slots, FULL rows, aux rows on a only, rows of
    all ones and zeros in the pools."""
    aux = _pool(rng, 3)
    descs = []
    for rows, with_aux in ((a_rows, True), (b_rows, False)):
        slot = rng.integers(-1, max(rows, 1), k) if rows else np.full(k, -1)
        full = rng.random(k) < 0.2
        aux_slot = np.where(rng.random(k) < 0.3, rng.integers(0, 3, k), -1)
        if not with_aux:
            aux_slot[:] = -1
        descs.append((_pool(rng, rows), slot, full,
                      aux if with_aux else np.zeros((0, 2048), np.uint32),
                      aux_slot))
    return descs


def _jdesc(d):
    return tuple(jnp.asarray(x) for x in d)


def _tdesc(d):
    pool, slot, full, aux, aux_slot = d
    return (_t(pool), torch.from_numpy(np.asarray(slot, np.int32)),
            torch.from_numpy(np.asarray(full, bool)), _t(aux),
            torch.from_numpy(np.asarray(aux_slot, np.int32)))


# ---------------------------------------------------------------------------
# the metric plan and its derivation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metrics,counted,coefs", [
    (("count_and",), ("count_and",), [[1]]),
    (("count_or",), ("count_or",), [[1]]),
    (METRICS, ("count_and", "count_a", "count_b"),
     [[1, 0, 0], [-2, 1, 1], [-1, 1, 1], [-1, 1, 0], [-1, 0, 1], [0, 1, 0],
      [0, 0, 1]]),
    (("count_sub_ab", "count_sub_ba"), ("count_sub_ab", "count_sub_ba"),
     [[1, 0], [0, 1]]),
    (("count_xor", "count_or", "count_and", "count_sub_ab"),
     ("count_and", "count_a", "count_b"),
     [[-2, 1, 1], [-1, 1, 1], [1, 0, 0], [-1, 1, 0]]),
    (("count_sub_ab", "count_a", "count_and"), ("count_and", "count_a"),
     [[-1, 1], [0, 1], [1, 0]]),
    (("count_b", "count_and", "count_or"),
     ("count_and", "count_or", "count_b"), [[0, 0, 1], [1, 0, 0], [0, 1, 0]]),
])
def test_count_plan(metrics, counted, coefs):
    assert tops.count_plan(metrics) == (counted, coefs)


def test_count_plan_rejects():
    with pytest.raises(ValueError):
        tops.count_plan(())
    with pytest.raises(ValueError):
        tops.count_plan(("count_and", "count_nand"))


@pytest.mark.parametrize("size", range(1, len(METRICS) + 1))
def test_every_subset_vs_metric_kernel(rng, size):
    """Every subset of ``size`` metrics, each in a random order, counted as
    K2 counts them, per block and in total, against the JAX package's
    fused metric kernel; at most three popcounts for two metrics or more."""
    for case in range(2):
        da, db = _descriptor_pair(rng, a_rows=9 if case else 0)
        want = np.asarray(jsetops._metric_kernel(METRICS, *_jdesc(da),
                                                 *_jdesc(db)))
        ta, tb = _tdesc(da), _tdesc(db)
        for combo in itertools.combinations(range(len(METRICS)), size):
            order = rng.permutation(np.asarray(combo))
            ms = tuple(METRICS[j] for j in order)
            counted, _ = tops.count_plan(ms)
            assert len(counted) <= min(size, 3)
            np.testing.assert_array_equal(
                ck.count_metrics(ms, ta, tb).numpy(), want[order])
            for per_block in (False, True):
                tot, per = ck.count_metrics_total(ms, ta, tb, per_block)
                assert tot.dtype == torch.int64
                np.testing.assert_array_equal(
                    tot.numpy(), want[order].sum(axis=1, dtype=np.int64))
                if per_block:
                    np.testing.assert_array_equal(per.numpy(), want[order])
                else:
                    assert per is None


def test_count_plan_coefficients_vs_direct_popcounts(rng):
    """Each metric from its coefficients over the base counts equals its
    direct popcount, on rows of all ones, zeros and random words."""
    a, b = _t(_pool(rng, 7)), _t(_pool(rng, 7)[::-1].copy())
    counted, coefs = tops.count_plan(METRICS)
    base = [tops.block_counts(tops._metric_rows(m, a, b)) for m in counted]
    for m, row in zip(METRICS, coefs):
        got = sum(c * n for c, n in zip(row, base))
        assert torch.equal(got, tops.block_counts(tops._metric_rows(m, a,
                                                                    b))), m


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("n", [0, 1, 13])
def test_block_counts_total_vs_jax(rng, n, per_block):
    p = _pool(rng, n)
    want = np.asarray(jops.block_counts(jnp.asarray(p)))
    tot, per = ck.block_counts_total(_t(p), per_block)
    assert tot.dtype == torch.int64 and tot.shape == ()
    assert int(tot) == int(want.sum(dtype=np.int64))
    if per_block:
        np.testing.assert_array_equal(per.numpy(), want)
    else:
        assert per is None
    np.testing.assert_array_equal(ck.block_counts(_t(p)).numpy(), want)


# ---------------------------------------------------------------------------
# count() and distance_operation on the total forms, against the JAX package
# ---------------------------------------------------------------------------
def _clustered(rng, blk0, blk1):
    out = [blk * BPB + s + np.arange(rng.integers(1, 200))
           for blk in range(blk0, blk1)
           for s in rng.choice(BPB - 300, 5, replace=False)]
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _vector(pkg, rng, kind):
    """One vector of ``kind`` built by the same calls in either package."""
    BV = pkg.BitVector
    if kind == "empty":
        return BV(SIZE)
    if kind == "gap_runs":
        v = BV.from_indices(_clustered(rng, 2, 9), SIZE, strategy=C.BM_GAP)
        v.set_range(12 * BPB, 30 * BPB - 1)              # a FULL run
        return v
    v = BV.from_indices(rng.integers(0, 10 * BPB, 30000), SIZE)
    v |= BV.from_indices(_clustered(rng, 8, 14), SIZE, strategy=C.BM_GAP)
    v.set_range(16 * BPB, 24 * BPB - 1)                  # FULL run
    v.set_range(25 * BPB + 7, 25 * BPB + 900)            # partial BIT row
    v.set(33 * BPB + 5)
    v.optimize()
    return v


@pytest.mark.parametrize("kinds", [("mixed", "mixed"), ("mixed", "empty"),
                                   ("empty", "empty"),
                                   ("mixed", "gap_runs")])
def test_count_and_distance_vs_jax(kinds, monkeypatch):
    """count(), distance_operation for one subset of each size in a random
    order, and count_and/or/xor/sub: equal to the JAX package's, through
    the total forms (the per-block forms are not called)."""
    vecs = {}
    for name, pkg in (("jax", jbm), ("torch", tbm)):
        rng = np.random.default_rng(11)
        vecs[name] = [_vector(pkg, rng, k) for k in kinds]
    (ja, jb), (ta, tb) = vecs["jax"], vecs["torch"]

    def per_block_form(*_):
        raise AssertionError("a per-block form on the count path")

    monkeypatch.setattr(ck, "block_counts", per_block_form)
    monkeypatch.setattr(ck, "count_metrics", per_block_form)
    assert ta.count() == ja.count() and tb.count() == jb.count()
    rng = np.random.default_rng(5)
    for size in range(1, len(METRICS) + 1):
        ms = [METRICS[j] for j in rng.permutation(len(METRICS))[:size]]
        assert tbm.distance_operation(ta, tb, ms) == \
            jbm.distance_operation(ja, jb, ms), ms
    for f in ("count_and", "count_or", "count_xor", "count_sub"):
        assert getattr(tbm, f)(ta, tb) == getattr(jbm, f)(ja, jb), f
