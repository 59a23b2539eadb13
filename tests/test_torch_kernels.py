"""The three hand-written Hopper kernels against their plain PyTorch
versions, on the card.  Every test here needs CUDA (marker ``cuda``) and
skips without it.  On a machine with an H100 and no JAX, run them without
the suite's conftest (which imports JAX):

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
    assert ck.launches == {"block_counts": 0, "count_op": 2,
                           "logical_op_digest": 4}


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
    assert all(ck.launches.values()), ck.launches
