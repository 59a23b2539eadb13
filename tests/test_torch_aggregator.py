"""Aggregator, operand arena and kernels B4/B5 of the PyTorch port against
the JAX package, on the CPU.

The same containers go to both packages (built in the JAX package, handed
to the port through ``interop``); every answer must be identical, and so
must the result's state (``nb``, ``cls``, rows) wherever both packages take
the same route.  The plain versions of kernels B4 and B5 are held against
the Pallas kernels run in interpret mode (B5 with ``use_pallas`` on) and,
for the early exit, against a numpy fold.  Tolerance: exact equality
(integer results).
"""
import importlib

import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.agg import arena as jarena
from bitmagic_tpu.config import config as jconfig
from bitmagic_tpu.ops import pallas_kernels as pk
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.agg import arena as tarena
from bitmagic_tpu_torch.ops import blockops

torch.set_num_threads(1)

# the packages' ``agg.aggregator`` attribute is the module-level instance
jagg_mod = importlib.import_module("bitmagic_tpu.agg.aggregator")
tagg_mod = importlib.import_module("bitmagic_tpu_torch.agg.aggregator")

BPB = C.BITS_PER_BLOCK
SIZE = 6 * BPB + 500


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def jax_parts(bv):
    bv._flush()
    g = bv._gaps
    return {
        "size": bv.size, "nb": bv._struct.nb, "cls": bv._struct.cls,
        "runs": bv._struct.runs, "pool_u32": np.asarray(bv._pool_host()),
        "gap_ends": g.ends if g is not None else np.zeros(0, np.int64),
        "gap_offs": g.offs if g is not None else np.zeros(1, np.int64),
        "gap_first": g.first if g is not None else np.zeros(0, np.uint8),
    }


def port(jv):
    return interop.bitvector_from_parts(**jax_parts(jv), device="cpu")


def assert_same_state(jv, tv):
    want, got = jax_parts(jv), interop.bitvector_to_parts(tv)
    for key in interop.PARTS:
        np.testing.assert_array_equal(
            np.asarray(got[key]), np.asarray(want[key]).reshape(
                np.shape(got[key])), err_msg=key)


def assert_same_bits(jv, tv):
    np.testing.assert_array_equal(tv.indices(), np.asarray(jv.indices()))
    assert tv.count() == jv.count()


def mixed_group(seed, n, density=0.5, size=SIZE):
    """n JAX vectors mixing dense BIT blocks, GAP blocks, FULL blocks and a
    missing block, and their port twins."""
    rng = np.random.default_rng(seed)
    js = []
    for j in range(n):
        ids = np.flatnonzero(rng.random(size) < density)
        v = jbm.BitVector.from_indices(ids, size)
        if j % 3 == 1 and size > 5 * BPB:
            v.set_range(2 * BPB, 3 * BPB - 1)            # FULL block
        if j % 4 == 2 and size > 5 * BPB:
            v.set_range(4 * BPB, 5 * BPB - 1, False)     # missing block
            v.set_range(4 * BPB + 100, 4 * BPB + 900)    # ... now GAP
        v.optimize()
        js.append(v)
    return js, [port(v) for v in js]


# ---------------------------------------------------------------------------
# kernel B4 (plain version) against agg_and_sub_pallas, interpret mode
# ---------------------------------------------------------------------------
def _slots_case(rng, n_rows, K, nb):
    pool = rng.integers(0, 2**32, (n_rows, 2048),
                        dtype=np.uint64).astype(np.uint32)
    pool |= 0xF000000F                 # keep rows non-zero
    slots = rng.integers(0, n_rows, (K, nb)).astype(np.int32)
    slots[rng.random((K, nb)) < 0.2] = -1
    return pool, slots


@pytest.mark.parametrize("n_and,n_sub,nb", [(3, 2, 5), (1, 0, 9), (2, 4, 3)])
def test_agg_and_sub_plain_vs_pallas(n_and, n_sub, nb):
    rng = np.random.default_rng(n_and * 10 + n_sub)
    pool, slots = _slots_case(rng, 24, n_and + n_sub, nb)
    want = np.asarray(pk.agg_and_sub_pallas(n_and, n_sub, slots, pool))
    got = blockops.agg_and_sub_arena(
        n_and, n_sub, torch.from_numpy(slots),
        blockops.to_device_words(pool, "cpu"))
    np.testing.assert_array_equal(blockops.to_host_words(got), want)


def test_agg_and_sub_early_exit_vs_oracle():
    """A column whose AND dies at operand 1 stays zero whatever follows;
    other columns run through all operands: both kernels against numpy."""
    rng = np.random.default_rng(3)
    pool = rng.integers(0, 2**32, (6, 2048), dtype=np.uint64
                        ).astype(np.uint32)
    pool[1] = 0
    slots = np.asarray([[0, 0, -1], [1, 2, -1], [3, 4, 5], [2, -1, 3]],
                       np.int32)                       # and: 2, sub: 2
    want = np.full((3, 2048), 0xFFFFFFFF, np.uint32)
    for k in range(4):
        for i in range(3):
            if slots[k, i] >= 0:
                r = pool[slots[k, i]]
                want[i] &= r if k < 2 else ~r
    assert (want[0] == 0).all() and want[1].any()
    got_j = np.asarray(pk.agg_and_sub_pallas(2, 2, slots, pool))
    got_t = blockops.to_host_words(blockops.agg_and_sub_arena(
        2, 2, torch.from_numpy(slots), blockops.to_device_words(pool, "cpu")))
    np.testing.assert_array_equal(got_j, want)
    np.testing.assert_array_equal(got_t, want)


def test_agg_and_sub_empty_pool_and_or_mode():
    """A 0-row pool (all slots -1: AND identity ones, SUB identity zero),
    OR mode and rows-off counts, against numpy (the Pallas kernel needs a
    non-empty pool and has no OR mode)."""
    pool = torch.zeros((0, 2048), dtype=torch.int32)
    out = blockops.agg_and_sub_arena(2, 1, torch.full((3, 4), -1,
                                                      dtype=torch.int32),
                                     pool)
    assert out.shape == (4, 2048) and bool((out == -1).all())
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 2**32, (3, 5, 2048), dtype=np.uint64
                        ).astype(np.uint32)
    descs = [(blockops.to_device_words(r, "cpu"), None, None, None, None)
             for r in rows]
    o, c = blockops.agg_and_sub(0, descs, or_mode=True, counts=True)
    want = rows[0] | rows[1] | rows[2]
    np.testing.assert_array_equal(blockops.to_host_words(o), want)
    np.testing.assert_array_equal(c.numpy(),
                                  np.bitwise_count(want).sum(axis=1))
    none, c2 = blockops.agg_and_sub(2, descs, rows=False, counts=True)
    assert none is None
    np.testing.assert_array_equal(
        c2.numpy(), np.bitwise_count(rows[0] & rows[1] & ~rows[2]).sum(1))


def test_agg_kernel_descriptor_form_vs_jax():
    """B4 on per-vector gather descriptors against bitmagic_tpu's
    _agg_kernel and _agg_any_kernel (XLA) on the same block list."""
    js, ts = mixed_group(11, 5, density=0.7)
    nb = np.arange(7, dtype=np.int64)
    jargs = []
    for v in js:
        jargs.extend(jbm.core.blocks.operand_args(v, nb))
    descs = tagg_mod._operand_descs(ts, nb)
    for n_and, n_sub in ((3, 2), (5, 0), (0, 5), (1, 4)):
        want = np.asarray(jagg_mod._agg_kernel(n_and, n_sub, *jargs))
        got = blockops.to_host_words(tagg_mod._agg_kernel(n_and, n_sub,
                                                          descs))
        np.testing.assert_array_equal(got, want)
        if n_and:
            np.testing.assert_array_equal(
                tagg_mod._agg_any_kernel(n_and, n_sub, descs).numpy(),
                np.asarray(jagg_mod._agg_any_kernel(n_and, n_sub, *jargs)))


# ---------------------------------------------------------------------------
# kernel B5 (plain version) against pipeline_counts with Pallas on
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,V,nb", [(5, 7, 3), (21, 9, 1)])
def test_pipeline_counts_plain_vs_pallas(monkeypatch, S, V, nb):
    monkeypatch.setattr(jconfig, "use_pallas", True)
    rng = np.random.default_rng(S * V)
    bits = rng.random((S, nb, 2048, 32)) < 0.7
    planes = np.packbits(bits, axis=-1, bitorder="little").view(
        np.uint32)[..., 0]
    sels = rng.integers(-1, 2, (V, S)).astype(np.int32)
    sels[:, 0] = 1              # every row has an AND plane (the JAX
    sels[1, 1:] = 0             # precondition, pallas_kernels.py:444)
    want = np.asarray(pk.pipeline_counts(planes, sels))
    got = blockops.pipeline_counts(blockops.to_device_words(planes, "cpu"),
                                   torch.from_numpy(sels))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # an all-zero row counts every bit of the stack (plain version only:
    # the Pallas kernel pads blocks and would count the padding too)
    zero = blockops.pipeline_counts(blockops.to_device_words(planes, "cpu"),
                                    np.zeros((1, S), np.int32))
    assert int(zero[0]) == nb * BPB


def test_pipeline_codes_csr():
    sel = np.asarray([[1, 0, -1], [0, 0, 0], [-1, 1, 1]], np.int32)
    offs, codes = blockops.pipeline_codes(sel)
    assert offs.tolist() == [0, 2, 2, 5]
    assert codes.tolist() == [0, 5, 1, 2, 4]
    with pytest.raises(ValueError):
        blockops.pipeline_codes(np.asarray([[2]]))


# ---------------------------------------------------------------------------
# operand arena
# ---------------------------------------------------------------------------
def test_operand_arena_parity():
    js, ts = mixed_group(21, 4)
    ja = jarena.OperandArena(js)
    ta = interop.operand_arena_from_parts([jax_parts(v) for v in js])
    blocklist = np.arange(8, dtype=np.int64)
    got = interop.operand_arena_to_parts(ta, [0, 2, 3], blocklist)
    np.testing.assert_array_equal(got["pool_u32"], np.asarray(ja.pool))
    np.testing.assert_array_equal(got["slots"],
                                  ja.slots_matrix([0, 2, 3], blocklist))
    np.testing.assert_array_equal(
        blockops.to_host_words(tarena.build_dense_stack(ta)),
        np.asarray(jarena.build_dense_stack(ja)))
    assert tarena.operands_succinct(ts) == jarena.operands_succinct(js)
    for a, b in zip(tarena.presence_table(ts), jarena.presence_table(js)):
        np.testing.assert_array_equal(a, b)
    sels = np.asarray([[1, -1, 0, 1], [0, 1, 1, 0]], np.int32)
    for a, b in zip(tarena.narrowed_union(ts, sels),
                    jarena.narrowed_union(js, sels)):
        np.testing.assert_array_equal(a, b)
    nb_sel = np.asarray([0, 2, 4, 6], np.int64)
    np.testing.assert_array_equal(tarena.build_dense_stack_host(ts, nb_sel),
                                  jarena.build_dense_stack_host(js, nb_sel))
    assert tarena.build_dense_stack(
        tarena.OperandArena([tbm.BitVector(SIZE)])) is None


# ---------------------------------------------------------------------------
# entry points: combine_*, find_first_and_sub, shift-right-and, arena
# ---------------------------------------------------------------------------
def test_combine_or_and_and_sub():
    js, ts = mixed_group(31, 6, density=0.6)
    ja, ta = jbm.agg.Aggregator(), tbm.Aggregator()
    assert_same_state(ja.combine_or(js), ta.combine_or(ts))
    assert_same_state(ja.combine_and(js[:4]), ta.combine_and(ts[:4]))
    assert_same_state(ja.combine_and_sub(js[:3], js[3:]),
                      ta.combine_and_sub(ts[:3], ts[3:]))
    assert ja.find_first_and_sub(js[:3], js[3:]) == \
        ta.find_first_and_sub(ts[:3], ts[3:])
    # many operands (config 3's shape, small): AND of 40 dense vectors
    js, ts = mixed_group(32, 40, density=0.92, size=BPB)
    assert_same_state(ja.combine_and(js), ta.combine_and(ts))
    assert_same_state(ja.combine_and_sub(js[:20], js[20:]),
                      ta.combine_and_sub(ts[:20], ts[20:]))


def test_and_sub_full_and_missing_blocks():
    rng = np.random.default_rng(41)
    ja, ta = jbm.agg.Aggregator(), tbm.Aggregator()
    a = jbm.BitVector(SIZE)
    a.set_range(0, 2 * BPB - 1)
    a.optimize()
    b = jbm.BitVector.from_indices(
        np.flatnonzero(rng.random(2 * BPB) < 0.3), SIZE)
    s = jbm.BitVector(SIZE)
    s.set_range(BPB, 2 * BPB - 1)
    s.optimize()
    e = jbm.BitVector(SIZE)
    ta_, tb, ts_, te = port(a), port(b), port(s), port(e)
    assert_same_state(ja.combine_and_sub([a, b], [s]),
                      ta.combine_and_sub([ta_, tb], [ts_]))
    assert ta.combine_and_sub([ta_, tb, te], [ts_]).none()
    assert ta.find_first_and_sub([ta_, tb, te]) == -1
    # all-FULL AND group with no SUB bits: pure FULL result, no kernel
    assert_same_state(ja.combine_and([a, a]), ta.combine_and([ta_, ta_]))
    assert_same_state(ja.combine_or([a, s]), ta.combine_or([ta_, ts_]))


def test_stateful_api_and_range_hint():
    js, ts = mixed_group(51, 4, density=0.7)
    ja, ta = jbm.agg.Aggregator(), tbm.Aggregator()
    for j, t in zip(js[:3], ts[:3]):
        ja.add(j)
        ta.add(t)
    ja.add(js[3], 1)
    ta.add(ts[3], 1)
    assert_same_state(ja.combine_and_sub(), ta.combine_and_sub())
    assert_same_state(ja.combine_and(), ta.combine_and())
    for lo, hi in ((BPB + 7, BPB + 30000), (10, 3 * BPB + 5)):
        ja.set_range_hint(lo, hi)
        ta.set_range_hint(lo, hi)
        assert_same_bits(ja.combine_and_sub(), ta.combine_and_sub())
        assert ja.find_first_and_sub() == ta.find_first_and_sub()
    ja.reset_range_hint()
    ta.reset_range_hint()
    ja.set_optimization()
    ta.set_optimization()
    assert_same_state(ja.combine_or(), ta.combine_or())
    assert_same_state(ja.combine_and_horizontal(),
                      ta.combine_and_horizontal())
    ta.reset()
    assert ta.combine_or().size == 0


def test_find_first_and_sub(monkeypatch):
    size = 8_000_000
    ids_a, ids_b = np.arange(3_000_000, 3_000_100), \
        np.arange(3_000_050, 3_000_300)
    a = tbm.BitVector.from_indices(ids_a, size)
    b = tbm.BitVector.from_indices(ids_b, size)
    s = tbm.BitVector.from_indices([3_000_050, 3_000_051], size)
    agg = tbm.aggregator
    assert agg.find_first_and_sub([a, b], [s]) == 3_000_052
    assert agg.find_first_and_sub([a], [a]) == -1
    assert agg.find_first_and_sub([a, tbm.BitVector(size)]) == -1
    ja = jbm.BitVector.from_indices(ids_a, size)
    jb = jbm.BitVector.from_indices(ids_b, size)
    assert jbm.agg.aggregator.find_first_and_sub([ja, jb]) == \
        agg.find_first_and_sub([a, b])
    # the probe computes per-block counts only: no full combine runs
    called = []
    orig = tbm.Aggregator.combine_and_sub
    monkeypatch.setattr(tbm.Aggregator, "combine_and_sub",
                        lambda *a_, **k_: called.append(1) or orig(*a_, **k_))
    assert agg.find_first_and_sub([a, b], [s]) == 3_000_052
    assert not called


def test_shift_right_and():
    text, pattern = "abracadabra", "abra"
    jocc, tocc = {}, {}
    for ch in set(text):
        pos = [i for i, c in enumerate(text) if c == ch]
        jocc[ch] = jbm.BitVector.from_indices(pos, len(text) + 1)
        tocc[ch] = tbm.BitVector.from_indices(pos, len(text) + 1)
    agg = tbm.Aggregator()
    got = agg.combine_shift_right_and([tocc[c] for c in pattern])
    assert_same_state(jbm.agg.aggregator.combine_shift_right_and(
        [jocc[c] for c in pattern]), got)
    np.testing.assert_array_equal(got.indices(), [3, 10])
    # fused chain == per-step shift_right + bit_and, across blocks and GAP
    rng = np.random.default_rng(61)
    size = 2_000_000
    js = [jbm.BitVector.from_indices(
        np.unique(rng.integers(0, size, 20_000)), size) for _ in range(4)]
    js[1].optimize()
    ts = [port(v) for v in js]
    got = agg.combine_shift_right_and(ts)
    assert_same_state(jbm.agg.aggregator.combine_shift_right_and(js), got)
    agg.set_operation(tagg_mod.BM_SHIFT_R_AND)
    for v in ts:
        agg.add(v)
    agg.stage()
    while agg.run_step() != agg.get_operation_status().op_done:
        pass
    assert agg.get_target().equal(got)
    # a carry crosses a block boundary but not a gap in the block list
    x = tbm.BitVector.from_indices([65535, 9_000_000], 1 << 30)
    y = tbm.BitVector.from_indices([65536, 50 << 16, 9_000_001], 1 << 30)
    np.testing.assert_array_equal(
        agg.combine_shift_right_and([x, y]).indices(), [65536, 9_000_001])


def test_shift_right_and_far_apart_operands():
    """Operands spread over a 2^33-bit span keep the narrowed block list
    small and equal the JAX package's result and the per-step shift."""
    size = 1 << 33
    far = [10, 100_000_000, 7_000_000_000]
    ia = far + [65535 + (200 << 16)]
    ib = [p + 1 for p in far] + [65536 + (200 << 16)]
    js = [jbm.BitVector.from_indices(ia, size),
          jbm.BitVector.from_indices(ib, size)]
    ts = [port(v) for v in js]
    got = tbm.aggregator.combine_shift_right_and(ts)
    assert_same_state(jbm.agg.aggregator.combine_shift_right_and(js), got)
    step = ts[0].copy()
    step.shift_right()
    step.bit_and(ts[1])
    np.testing.assert_array_equal(step.indices(), sorted(ib))
    assert got.equal(step) and len(got._struct.nb) <= 16


def test_aggregator_pipeline_execute():
    """Interleaved staged aggregators (round-robin run_step) against the
    JAX package's and the fused combine_shift_right_and."""
    rng = np.random.default_rng(65)
    size = 300_000
    js = [jbm.BitVector.from_indices(np.unique(rng.integers(0, size, 40_000)),
                                     size) for _ in range(5)]
    ts = [port(v) for v in js]
    groups = ([0, 1, 2], [3, 4], [1, 2, 3, 4])
    jaggs, taggs = [], []
    for g in groups:
        for mod, vecs, out in ((jagg_mod, js, jaggs), (tagg_mod, ts, taggs)):
            a = mod.Aggregator()
            a.set_operation(mod.BM_SHIFT_R_AND)
            for i in g:
                a.add(vecs[i])
            out.append(a)
    jagg_mod.aggregator_pipeline_execute(jaggs)
    assert tagg_mod.aggregator_pipeline_execute(taggs) == taggs
    for g, ja, ta in zip(groups, jaggs, taggs):
        assert ta.get_operation_status() == tagg_mod.OperationStatus.op_done
        assert_same_bits(ja.get_target(), ta.get_target())
        assert ta.get_target().equal(
            tbm.aggregator.combine_shift_right_and([ts[i] for i in g]))


def test_combine_and_sub_arena():
    js, ts = mixed_group(71, 6, density=0.8)
    ja = jarena.OperandArena(js)
    ta = tarena.OperandArena(ts)
    jag, tag = jbm.agg.Aggregator(), tbm.Aggregator()
    for and_idx, sub_idx in (([0, 1, 2], [3, 4]), ([5], []), ([1, 4], [2])):
        want = jag.combine_and_sub_arena(ja, and_idx, sub_idx)
        got = tag.combine_and_sub_arena(ta, and_idx, sub_idx)
        assert_same_state(want, got)
        assert_same_bits(jag.combine_and_sub([js[i] for i in and_idx],
                                             [js[i] for i in sub_idx]), got)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------
def _requests(seed, vecs):
    rng = np.random.default_rng(seed)
    n = len(vecs)
    reqs = []
    for _ in range(7):
        a = list(rng.choice(n, rng.integers(1, 4), replace=False))
        s = list(rng.choice(n, rng.integers(0, 3), replace=False))
        reqs.append((a, s))
    reqs.append(([0, 1], [0]))                 # forced zero
    return reqs


def _take(vecs, reqs):
    return [([vecs[i] for i in a], [vecs[i] for i in s]) for a, s in reqs]


def test_pipeline_counts_fused(monkeypatch):
    size = 3_000_000
    rng = np.random.default_rng(81)
    js = [jbm.BitVector.from_indices(np.unique(rng.integers(0, size, 5000)),
                                     size) for _ in range(10)]
    ts = [port(v) for v in js]
    reqs = _requests(82, js)
    opts = dict(compute_counts=True, make_results=False)
    got = tbm.aggregator.pipeline(_take(ts, reqs), tbm.AggOptions(**opts))
    loop = [jbm.agg.aggregator.combine_and_sub(a, s).count()
            for a, s in _take(js, reqs)]
    monkeypatch.setattr(jconfig, "use_pallas", True)
    fused = jbm.agg.Aggregator().pipeline(_take(js, reqs),
                                          jbm.agg.AggOptions(**opts))
    assert [e["count"] for e in got] == loop == [e["count"] for e in fused]
    assert got[-1]["count"] == 0
    lim = tbm.AggOptions(**opts).set_search_count_limit(3)
    assert [e["count"] for e in tbm.aggregator.pipeline(
        _take(ts, reqs), lim)] == [min(c, 3) for c in loop]


def test_pipeline_results_fused():
    size = 3_000_000
    rng = np.random.default_rng(91)
    js = [jbm.BitVector.from_indices(np.unique(rng.integers(0, size, 8000)),
                                     size) for _ in range(6)]
    js[2].optimize()
    ts = [port(v) for v in js]
    reqs = [([0, 1], [2]), ([2, 3], []), ([4], [5, 0]), ([1], [1])]
    opts = dict(make_results=True, compute_counts=True)
    want = jbm.agg.aggregator.pipeline(_take(js, reqs),
                                       jbm.agg.AggOptions(**opts))
    got = tbm.aggregator.pipeline(_take(ts, reqs), tbm.AggOptions(**opts))
    for w, g in zip(want, got):
        assert_same_state(w["bv"], g["bv"])         # both fused: same state
        assert w["count"] == g["count"]
    # the per-request route (an or-target) gives the same bits
    target = tbm.BitVector(size)
    per = tbm.aggregator.pipeline(
        _take(ts, reqs), tbm.AggOptions(**opts).set_or_target(target))
    for w, g in zip(want, per):
        assert_same_bits(w["bv"], g["bv"])
    union = np.unique(np.concatenate([w["bv"].indices() for w in want]))
    np.testing.assert_array_equal(target.indices(), union)


def test_pipelines_succinct(monkeypatch):
    n = 3_000_000
    rng = np.random.default_rng(9)
    js = [jbm.BitVector.from_indices(np.unique(rng.integers(0, n, 4000)), n,
                                     strategy=C.BM_GAP) for _ in range(4)]
    ts = [port(v) for v in js]
    reqs = [([0, 1], [2]), ([1, 3], []), ([0], [1, 3])]
    want = [jbm.agg.aggregator.combine_and_sub(a, s)
            for a, s in _take(js, reqs)]

    def no_dense(self):
        raise AssertionError("succinct pipeline built the full arena")
    monkeypatch.setattr(tarena.OperandArena, "pool", property(no_dense))
    counts = tbm.aggregator.pipeline(_take(ts, reqs), tbm.AggOptions(
        compute_counts=True, make_results=False))
    assert [c["count"] for c in counts] == [w.count() for w in want]
    res = tbm.aggregator.pipeline(_take(ts, reqs), tbm.AggOptions(
        compute_counts=True, make_results=True))
    for r, w in zip(res, want):
        assert_same_bits(w, r["bv"])
        assert r["count"] == w.count()
