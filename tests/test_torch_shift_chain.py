"""B8, the Bitap chain of ``combine_shift_right_and``, against the JAX
package on the CPU.

The port computes the chain in its closed form (flat bit p of the result
is the AND over operand j of its bit p - (k - 1 - j), a source before the
run of adjacent blocks that holds p reading 0): kernel ``shift_and_chain``
on the card, its plain version ``blockops.shift_and_chain`` here.  The
JAX package runs the chain step by step (a jitted ``lax.scan`` of shift
and AND).  The same operands go to both: k in {1, 2, 17, 32, 33, 34, 64,
65} (k >= 33 shifts across whole words), each operand's blocks a mix of
BIT, FULL (an entry or a FULL run), D-GAP and absent blocks over a block
list with gaps, rows mostly ones with holes drawn with numpy from a fixed
seed so that the chains keep bits; the result's state and ids must be
identical.  Both the kernel and the plain version group the operands by
vector (``blockops.chain_groups`` / ``chain_segments``): the tests also
take 17-65 operands interleaved over 3-4 vectors, check that the
grouping holds each operand's shift exactly once, that the vectors may
come in any order, and that ``_operand_descs`` expands D-GAP blocks on
the vectors' device equal to the host expansion.  The kernel itself is
held against the plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).

Tolerance: exact equality (bits).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.core.blocks import Structure as JaxStructure
from bitmagic_tpu.core.gapstore import GapStore as JaxGapStore
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.core.gapstore import GapStore
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from test_torch_aggregator import assert_same_state

torch.set_num_threads(1)

jagg_mod = importlib.import_module("bitmagic_tpu.agg.aggregator")
tagg_mod = importlib.import_module("bitmagic_tpu_torch.agg.aggregator")

BPB = C.BITS_PER_BLOCK
# the blocks the operands hold: gaps after 2, 5 and 10; 8-10 may be a FULL
# run
BLOCKS = (0, 1, 2, 4, 5, 8, 9, 10, 13)
SIZE = 15 * BPB
KS = (1, 2, 17, 32, 33, 34, 64, 65)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def holes(rng, n):
    """A block's words: ones with ``n`` holes of 1 to 40 bits."""
    bits = np.ones(BPB, np.uint8)
    for p, w in zip(rng.integers(0, BPB, n), rng.integers(1, 41, n)):
        bits[p:p + w] = 0
    return np.packbits(bits, bitorder="little").view(np.uint32)


def operand_parts(rng, base):
    """One operand: each block of ``BLOCKS`` is the block's ``base`` row
    less a few holes of its own, kept BIT (60 %), D-GAP (25 %) or FULL
    (15 %); blocks 5 and 13 absent in one operand in ten, blocks 8-10 a
    FULL run in one in four."""
    nb, cls, bit_rows, gap_rows = [], [], [], []
    run = rng.random() < 0.25
    for blk in BLOCKS:
        if run and blk in (8, 9, 10):
            continue
        if blk in (5, 13) and rng.random() < 0.1:
            continue
        u = rng.random()
        words = base[blk] & holes(rng, 3)
        nb.append(blk)
        if u < 0.15:
            cls.append(C.CLS_FULL)
        elif u < 0.40:
            cls.append(C.CLS_GAP)
            gap_rows.append(words)
        else:
            cls.append(C.CLS_BIT)
            bit_rows.append(words)
    gaps = GapStore.from_dense(np.stack(gap_rows)) if gap_rows else \
        GapStore.empty()
    return {"size": SIZE, "nb": np.asarray(nb, np.int64),
            "cls": np.asarray(cls, np.uint8),
            "runs": np.asarray([[8, 11]] if run else [], np.int64).reshape(
                -1, 2),
            "pool_u32": (np.stack(bit_rows) if bit_rows
                         else np.zeros((0, 2048), np.uint32)),
            "gap_ends": gaps.ends, "gap_offs": gaps.offs,
            "gap_first": gaps.first}


def jax_vector(parts):
    return jbm.BitVector._from_parts(
        JaxStructure(parts["nb"].copy(), parts["cls"].copy(),
                     parts["runs"].copy()),
        jnp.asarray(parts["pool_u32"]), parts["size"],
        JaxGapStore(parts["gap_ends"].copy(), parts["gap_offs"].copy(),
                    parts["gap_first"].copy()))


def operands(k, seed):
    rng = np.random.default_rng(seed)
    base = {blk: holes(rng, 40) for blk in BLOCKS}
    parts = [operand_parts(rng, base) for _ in range(k)]
    return ([jax_vector(p) for p in parts],
            [interop.bitvector_from_parts(**p, device="cpu") for p in parts])


@pytest.mark.parametrize("k", KS)
def test_combine_shift_right_and_against_jax(k, monkeypatch):
    """The port's chain (one ``shift_and_chain`` call, its closed-form
    plain version here) leaves the JAX package's state and ids."""
    js, ts = operands(k, 100 + k)
    want = jagg_mod.aggregator.combine_shift_right_and(js)
    calls = []
    real = ck.shift_and_chain

    def spy(first_mask, descs):
        calls.append(len(descs))
        return real(first_mask, descs)
    monkeypatch.setattr(ck, "shift_and_chain", spy)
    got = tagg_mod.aggregator.combine_shift_right_and(ts)
    assert calls == [k]
    assert_same_state(want, got)
    ids = got.indices()
    np.testing.assert_array_equal(ids, want.indices())
    # the chains keep bits, across the list's gaps too
    assert ids.size > 0 and (k == 1 or (ids >> 16).min() < 4)


@pytest.mark.parametrize("k", (33, 65))
def test_plain_chain_against_jax_rows(k):
    """The closed form row for row against the JAX scan on the same
    descriptors, with a first block whose predecessor in the list is no
    neighbour (bit 0 of every block cleared where marked)."""
    js, ts = operands(k, 7 + k)
    blocklist = np.asarray(BLOCKS, np.int64)
    adj = np.concatenate([[False], blocklist[1:] == blocklist[:-1] + 1])
    first_mask = np.where(adj | (np.arange(blocklist.size) == 0),
                          np.uint32(0xFFFFFFFF), np.uint32(0xFFFFFFFE))
    want = np.asarray(jagg_mod._shift_and_chain(
        k, jnp.asarray(first_mask),
        *jagg_mod._operand_args(js, blocklist)))
    got = blockops.shift_and_chain(
        torch.from_numpy(first_mask.view(np.int32)),
        tagg_mod._operand_descs(ts, blocklist))
    np.testing.assert_array_equal(blockops.to_host_words(got),
                                  want.reshape(-1, 2048))
    assert np.bitwise_count(want).sum() > 0


@pytest.mark.parametrize("k", (16, 33))
def test_repeated_operands_against_jax(k):
    """A pattern's letters repeat: ``k`` operands drawn from three vectors
    (each looked up and expanded once) leave the JAX package's state."""
    js, ts = operands(3, 300 + k)
    pick = np.random.default_rng(k).integers(0, 3, k)
    want = jagg_mod.aggregator.combine_shift_right_and([js[i] for i in pick])
    got = tagg_mod.aggregator.combine_shift_right_and([ts[i] for i in pick])
    assert_same_state(want, got)
    np.testing.assert_array_equal(got.indices(), want.indices())
    assert got.count() > 0


@pytest.mark.parametrize("k,n_vec", [(17, 3), (33, 4), (65, 3), (65, 4)])
def test_interleaved_vectors_against_jax(k, n_vec):
    """``k`` operands interleaved over ``n_vec`` vectors (each a mix of
    BIT, D-GAP, FULL entries or a FULL run and absent blocks over a list
    with gaps), in a seeded order where no vector's operands are
    contiguous: the kernel's grouping by vector leaves the JAX package's
    state and ids."""
    js, ts = operands(n_vec, 500 + k + n_vec)
    pick = (np.arange(k) + np.random.default_rng(k).integers(0, 2, k)) \
        % n_vec
    want = jagg_mod.aggregator.combine_shift_right_and([js[i] for i in pick])
    got = tagg_mod.aggregator.combine_shift_right_and([ts[i] for i in pick])
    assert_same_state(want, got)
    np.testing.assert_array_equal(got.indices(), want.indices())
    assert got.count() > 0


def _decode(segs, masks):
    """{vector: sorted shifts} that kernel shift_and_chain's segments and
    masks hold."""
    out = {}
    for v, qa, nq, moff in segs.tolist():
        for i in range(nq):
            m = int(masks[moff + i])
            out.setdefault(v, []).extend(32 * (qa + i) + r for r in range(32)
                                         if m >> r & 1)
    return {v: sorted(s) for v, s in out.items()}


@pytest.mark.parametrize("k,n_vec", [(1, 1), (33, 4), (65, 3), (2100, 5)])
def test_chain_grouping_holds_each_shift_once(k, n_vec):
    """``chain_groups`` puts each operand's shift ``k - 1 - j`` exactly
    once under its vector (the vector with the most shifts first), and
    ``chain_segments`` covers the same shifts, each segment within one
    aligned span of CHAIN_SPAN word shifts, ``deep`` the deepest window's
    block offset."""
    rng = np.random.default_rng(k)
    base = [(torch.zeros((0, 2048), dtype=torch.int32),
             torch.full((3,), -1, dtype=torch.int32), None, None, None)
            for _ in range(n_vec)]
    pick = rng.integers(0, n_vec, k)
    descs = [base[i] for i in pick]
    vecs, offs, shifts = blockops.chain_groups(descs)
    assert sorted(shifts.tolist()) == list(range(k))
    counts = np.diff(offs)
    assert (np.diff(counts) <= 0).all()
    for i, d in enumerate(vecs):
        mine = [k - 1 - j for j in range(k) if descs[j] is d]
        assert shifts[offs[i]:offs[i + 1]].tolist() == sorted(mine)
    segs, masks, deep = blockops.chain_segments(offs, shifts)
    assert _decode(segs, masks) == {
        i: shifts[offs[i]:offs[i + 1]].tolist() for i in range(len(vecs))}
    qa, nq = segs[:, 1], segs[:, 2]
    assert ((qa // blockops.CHAIN_SPAN)
            == ((qa + nq - 1) // blockops.CHAIN_SPAN)).all()
    assert (masks[segs[:, 3]] != 0).all()
    deepest = (k - 1) // 32 + 1           # the deepest window's words
    assert deep == -((deepest + 3) // 4 * 4) // C.SET_BLOCK_SIZE


@pytest.mark.parametrize("k", (17, 65))
def test_shuffled_vector_order_same_rows(k):
    """The AND over the distinct vectors takes them in any order: the
    grouped closed form with its vectors permuted gives the same rows,
    and those rows are the JAX scan's."""
    js, ts = operands(4, 900 + k)
    pick = np.random.default_rng(k).integers(0, 4, k)
    blocklist = np.asarray(BLOCKS, np.int64)
    adj = np.concatenate([[False], blocklist[1:] == blocklist[:-1] + 1])
    first_mask = np.where(adj | (np.arange(blocklist.size) == 0),
                          np.uint32(0xFFFFFFFF), np.uint32(0xFFFFFFFE))
    fm = torch.from_numpy(first_mask.view(np.int32))
    vecs, offs, shifts = blockops.chain_groups(
        tagg_mod._operand_descs([ts[i] for i in pick], blocklist))
    rows = blockops.chain_and(fm, vecs, offs, shifts)
    perm = np.random.default_rng(k + 1).permutation(len(vecs))
    parts = [shifts[offs[i]:offs[i + 1]] for i in perm]
    p_offs = np.concatenate([[0], np.cumsum([p.size for p in parts])])
    shuffled = blockops.chain_and(fm, [vecs[i] for i in perm], p_offs,
                                  np.concatenate(parts))
    assert torch.equal(shuffled, rows)
    jpick = [js[i] for i in pick]
    want = np.asarray(jagg_mod._shift_and_chain(
        k, jnp.asarray(first_mask),
        *jagg_mod._operand_args(jpick, blocklist)))
    np.testing.assert_array_equal(blockops.to_host_words(rows),
                                  want.reshape(-1, 2048))


def test_operand_descs_expand_gap_rows_on_the_device(monkeypatch):
    """``_operand_descs`` expands the D-GAP blocks of all distinct vectors
    by one ``gap_expand_many`` call on the vectors' device, a store per
    vector that has them (no aux for a vector without), and every
    descriptor's aux rows equal the host expansion ``GapStore.to_dense``
    of its D-GAP blocks; a repeated vector shares its descriptor."""
    _, ts = operands(4, 77)
    vectors = [ts[0], ts[1], ts[0], ts[2], ts[3], ts[1]]
    blocklist = np.asarray(BLOCKS, np.int64)
    calls = []
    real = ck.gap_expand_many

    def spy(mirrors, sel):
        calls.append(len(mirrors))
        return real(mirrors, sel)
    monkeypatch.setattr(ck, "gap_expand_many", spy)
    descs = tagg_mod._operand_descs(vectors, blocklist)
    assert descs[0] is descs[2] and descs[1] is descs[5]
    with_gap = 0
    for v, d in zip(vectors[:2] + vectors[3:5], descs[:2] + descs[3:5]):
        st, sl = v._struct.lookup(blocklist)
        gap = st == tagg_mod._G
        with_gap += bool(gap.any())
        pool, slot, full, aux, aux_slot = d
        assert (aux is None) == (aux_slot is None) == (not gap.any())
        if gap.any():
            assert aux.device == v._pool.device
            a_sl = aux_slot.numpy()
            assert ((a_sl >= 0) == gap).all()
            np.testing.assert_array_equal(
                blockops.to_host_words(aux[torch.from_numpy(
                    a_sl[gap].astype(np.int64))]),
                v._gaps.to_dense(sl[gap]))
    assert with_gap >= 2 and calls == [with_gap]
