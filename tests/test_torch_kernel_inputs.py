"""The host-side inputs of kernels B4 and B5 against the JAX package, on the
CPU.

B5 stages only the planes some value selects and takes its selectors as
bit masks (register path) or CSR codes (shared-memory path); B4's batched
form takes a request table over one operand table.  Each piece is fed back
through the plain version of its kernel and held against the JAX package:
``pipeline_counts`` with Pallas on (interpret mode on the CPU),
``_pipeline_results_kernel`` (XLA) and ``agg_and_sub_pallas`` per request
(interpret mode).  Inputs are made by numpy from a seed.  Tolerance: exact
equality (bit-identical words, equal integer counts).
"""
import importlib

import numpy as np
import pytest
import torch

import bitmagic_tpu_torch as tbm
from bitmagic_tpu.config import config as jconfig
from bitmagic_tpu.ops import pallas_kernels as pk
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

jagg_mod = importlib.import_module("bitmagic_tpu.agg.aggregator")
tagg_mod = importlib.import_module("bitmagic_tpu_torch.agg.aggregator")

BPB = 65536


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def masks_selectors(masks, n_planes):
    """Inverse of ``blockops.pipeline_masks``: int32[V, n_planes] rows."""
    m = np.ascontiguousarray(masks, dtype="<u4")
    bits = np.unpackbits(m.view(np.uint8), axis=-1, bitorder="little")
    bits = bits[:, :, :n_planes].astype(np.int32)
    return bits[:, 0] * (1 - 2 * bits[:, 1])


def _planes(rng, S, nb, density=0.7):
    bits = rng.random((S, nb, 2048, 32)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(
        np.uint32)[..., 0]


def _selectors(rng, V, S, skip):
    """V selector rows over S planes: row 0 skips every plane; with
    ``skip`` the others skip about half their planes (so some planes are
    selected by no row), else none."""
    sel = rng.choice(np.asarray([-1, 1], np.int32), (V, S))
    if skip:
        sel[rng.random((V, S)) < 0.5] = 0
        if S > 2:
            sel[:, S // 2] = 0                # a plane no row selects
    sel[0] = 0
    return sel


# ---------------------------------------------------------------------------
# B5: plane list, masks and codes, through the plain version, against the
# Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("S,V", [(1, 5), (21, 9), (32, 300), (33, 7),
                                 (64, 5), (65, 5), (200, 9)])
def test_pipeline_inputs_plain_vs_pallas(monkeypatch, S, V, skip):
    monkeypatch.setattr(jconfig, "use_pallas", True)
    rng = np.random.default_rng(S * 1000 + V + skip)
    nb = 2                      # even: the Pallas kernel pads no block
    planes = _planes(rng, S, nb)
    sel = _selectors(rng, V, S, skip)
    want = np.asarray(pk.pipeline_counts(planes, sel)).astype(np.int64)
    assert want[0] == nb * BPB                  # an all-skip row
    idx, masks, offs, codes = ck.pipeline_inputs(sel)
    n = idx.size
    assert (masks is not None) == (n <= ck.PIPELINE_REG_PLANES)
    assert (offs is not None) == (masks is None)
    if skip and S > 2:
        assert S // 2 not in idx.tolist()
    staged = blockops.to_device_words(planes[idx], "cpu")
    if masks is not None:
        assert masks.dtype == np.uint32
        assert masks.shape == (V, 2, (n + 31) // 32)
        back = masks_selectors(masks, n)
    else:
        back = np.zeros((V, n), np.int32)
        for v in range(V):
            c = codes[offs[v]:offs[v + 1]]
            back[v, c >> 1] = np.where(c & 1, -1, 1)
    np.testing.assert_array_equal(back, sel[:, idx])
    got = blockops.pipeline_counts(staged, torch.from_numpy(back))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper's CPU route gives the same counts on the full stack
    np.testing.assert_array_equal(
        ck.pipeline_counts(blockops.to_device_words(planes, "cpu"),
                           sel).numpy(), want)


@pytest.mark.parametrize("S", [0, 1, 31, 32, 33, 64, 65, 96])
def test_pipeline_masks_round_trip(S):
    rng = np.random.default_rng(S + 7)
    sel = rng.integers(-1, 2, (11, S)).astype(np.int32)
    m = blockops.pipeline_masks(sel)
    assert m.shape == (11, 2, (S + 31) // 32) and m.dtype == np.uint32
    np.testing.assert_array_equal(masks_selectors(m, S), sel)
    for v in range(11):
        for s in range(S):
            word, bit = s // 32, np.uint32(1 << (s % 32))
            assert bool(m[v, 0, word] & bit) == (sel[v, s] != 0)
            assert bool(m[v, 1, word] & bit) == (sel[v, s] == -1)


def test_pipeline_planes_all_skip():
    sel = np.zeros((4, 9), np.int32)
    idx, compact = blockops.pipeline_planes(sel)
    assert idx.size == 0 and compact.shape == (4, 0)
    planes = blockops.to_device_words(_planes(np.random.default_rng(1), 9, 3),
                                      "cpu")
    got = blockops.pipeline_counts(planes[idx], compact)
    assert got.tolist() == [3 * BPB] * 4
    with pytest.raises(ValueError):
        blockops.pipeline_masks(np.asarray([[2]]))


# ---------------------------------------------------------------------------
# B4 batched: request table, against _pipeline_results_kernel and per-request
# agg_and_sub_pallas
# ---------------------------------------------------------------------------
def _request_selectors(rng, V, K):
    sel = rng.integers(-1, 2, (V, K)).astype(np.int32)
    sel[0] = 0                                  # no operands: all ones
    sel[1] = np.where(sel[1] == 0, -1, -sel[1] * sel[1])   # n_and = 0
    sel[2] = np.abs(sel[2])                     # an empty SUB list
    sel[2, 0] = 1
    return sel


@pytest.mark.parametrize("V,K,nb", [(5, 3, 1), (9, 6, 3), (20, 12, 2)])
def test_agg_batch_plain_vs_pipeline_results_kernel(V, K, nb):
    rng = np.random.default_rng(V * 100 + K)
    planes = _planes(rng, K, nb, density=0.8)
    sel = _request_selectors(rng, V, K)
    want_rows, want_cnt = jagg_mod._pipeline_results_kernel(planes, sel)
    index, offs, n_and = blockops.selector_requests(sel)
    assert n_and[1] == 0 and offs[1] == offs[0] == 0
    stack = blockops.to_device_words(planes, "cpu")
    descs = [(stack[k], None, None, None, None) for k in range(K)]
    for fn in (blockops.agg_and_sub_batch, ck.agg_and_sub_batch):
        rows, cnt = fn(descs, index, offs, n_and, counts=True)
        assert rows.shape == (V, nb, 2048) and cnt.shape == (V, nb)
        np.testing.assert_array_equal(blockops.to_host_words(rows),
                                      np.asarray(want_rows))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    # rows-off: counts alone
    none, cnt = ck.agg_and_sub_batch(descs, index, offs, n_and, rows=False,
                                     counts=True)
    assert none is None
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_selector_requests_order():
    sel = np.asarray([[1, -1, 0, 1], [0, -1, -1, 0], [0, 0, 0, 0],
                      [-1, 1, 1, -1]], np.int32)
    index, offs, n_and = blockops.selector_requests(sel)
    assert offs.tolist() == [0, 3, 5, 5, 9]
    assert n_and.tolist() == [2, 0, 0, 2]
    assert index.tolist() == [0, 3, 1, 1, 2, 1, 2, 0, 3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agg_batch_plain_vs_pallas_per_request(seed):
    """Requests in arena form with -1 slots on both sides, n_and = 0 and an
    empty SUB list: one batch against agg_and_sub_pallas per request."""
    rng = np.random.default_rng(40 + seed)
    nb, n_rows = 5, 24
    pool = rng.integers(0, 2**32, (n_rows, 2048), dtype=np.uint64
                        ).astype(np.uint32)
    pool |= np.uint32(0x80000001)
    pool_t = blockops.to_device_words(pool, "cpu")
    shapes = [(3, 2), (1, 0), (0, 3), (4, 1), (2, 2)]
    descs, offs, n_and, wants = [], [0], [], []
    for na, ns in shapes:
        slots = rng.integers(0, n_rows, (na + ns, nb)).astype(np.int32)
        slots[rng.random((na + ns, nb)) < 0.25] = -1
        wants.append(np.asarray(pk.agg_and_sub_pallas(na, ns, slots, pool)))
        descs += blockops.arena_descriptors(na, torch.from_numpy(slots),
                                            pool_t)
        offs.append(len(descs))
        n_and.append(na)
    index = np.arange(len(descs))
    rows, cnt = ck.agg_and_sub_batch(descs, index, offs, n_and, counts=True)
    for r, want in enumerate(wants):
        np.testing.assert_array_equal(blockops.to_host_words(rows[r]), want)
        np.testing.assert_array_equal(cnt[r].numpy(),
                                      np.bitwise_count(want).sum(axis=1))


def test_agg_batch_rejects_malformed_tables():
    stack = torch.zeros((2, 3, 2048), dtype=torch.int32)
    descs = [(stack[k], None, None, None, None) for k in range(2)]
    for index, offs, n_and in (([0, 1], [0, 1], [0]),      # offs short
                               ([0, 2], [0, 2], [1]),      # index range
                               ([0, 1], [0, 2], [3]),      # n_and > n
                               ([0, 1], [1, 2], [0])):     # offs[0] != 0
        with pytest.raises(ValueError):
            ck.agg_and_sub_batch(descs, index, offs, n_and)
    with pytest.raises(ValueError):
        ck.agg_and_sub_batch([], [], [0], [])


def test_pipeline_results_one_batch_call(monkeypatch):
    """The result pipeline makes one batched B4 call per batch and no
    single-request call, and agrees with the JAX package's fused route."""
    rng = np.random.default_rng(77)
    size = 4 * BPB
    words = rng.integers(0, 2**32, (6, size // 32), dtype=np.uint64
                         ).astype(np.uint32)
    vecs = [tbm.BitVector.from_words(w) for w in words]
    reqs = [([0, 1], [2]), ([3], []), ([4, 5], [0, 1]), ([2], [2])]
    groups = [([vecs[i] for i in a], [vecs[i] for i in s]) for a, s in reqs]
    calls = {"batch": 0, "single": 0}
    batch, single = ck.agg_and_sub_batch, ck.agg_and_sub
    monkeypatch.setattr(ck, "agg_and_sub_batch", lambda *a, **k: (
        calls.__setitem__("batch", calls["batch"] + 1) or batch(*a, **k)))
    monkeypatch.setattr(ck, "agg_and_sub", lambda *a, **k: (
        calls.__setitem__("single", calls["single"] + 1) or single(*a, **k)))
    out = tbm.aggregator.pipeline(groups, tbm.AggOptions(compute_counts=True))
    assert calls == {"batch": 1, "single": 0}
    for (a, s), o in zip(reqs, out):
        want = np.bitwise_and.reduce(words[a], axis=0)
        for j in s:
            want &= ~words[j]
        if set(a) & set(s):
            want[:] = 0
        np.testing.assert_array_equal(o["bv"].to_words().ravel(), want)
        assert o["count"] == int(np.bitwise_count(want).sum())
