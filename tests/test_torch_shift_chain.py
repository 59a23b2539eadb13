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
identical.  The kernel itself is held against the plain version on the
card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).

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
