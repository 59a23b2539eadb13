"""Meshes, host task plans and the sharded bit-vector of the PyTorch port
against the JAX package on the CPU (the cases of ``tests/test_parallel.py``
and ``tests/test_sharded_digest.py``).

The JAX side runs on its virtual 8-device CPU mesh (``tests/conftest.py``),
the port on ``Mesh(["cpu"] * 8)``; both get the same seeded numpy inputs,
and vectors built by the JAX package are carried across through
``interop``.  Every pool (padding rows included), count, position, rank,
``last_narrowing`` and ``group_and_exchange``'s traffic must be equal.
Tolerance: exact equality (integer results).
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.parallel import mesh as jmesh_mod
from bitmagic_tpu.parallel import sharded as jsh
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from bitmagic_tpu_torch.parallel import Mesh
from bitmagic_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
SIZE_BLOCKS = 16            # 2 blocks / shard on the 8-shard mesh
SIZE = SIZE_BLOCKS * BPB


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_mod.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * 8)


def jpool(sbv) -> np.ndarray:
    return np.asarray(sbv.pool).astype(np.uint32)


def assert_same_pool(jv, tv):
    np.testing.assert_array_equal(tv.to_words(), jpool(jv))
    assert tv.size == jv.size


def pair_ids(ids, size, jmesh, tmesh):
    return (jsh.ShardedBitVector.from_indices(ids, size, jmesh),
            tsh.ShardedBitVector.from_indices(ids, size, tmesh))


def sparse_pair(rng, jmesh, tmesh, blocks, size=SIZE):
    """Vectors whose content lives only in the given block ids."""
    ids = np.unique(np.concatenate([
        rng.integers(b * BPB, (b + 1) * BPB, 500) for b in blocks])
    ).astype(np.int64)
    j, t = pair_ids(ids, size, jmesh, tmesh)
    return j, t, ids


def random_ids(rng, size, density):
    return np.flatnonzero(rng.random(size) < density).astype(np.int64)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------
def test_mesh_and_placement(tmesh):
    assert tmesh.size == 8
    assert tmesh == Mesh(["cpu"] * 8) and tmesh != Mesh(["cpu"] * 4)
    from bitmagic_tpu_torch.parallel import (block_sharding, pad_rows,
                                             replicated)
    assert pad_rows(17, 8) == 24 and pad_rows(16, 8) == 16
    x = np.arange(4 * 16 * 2048, dtype=np.uint32).reshape(4, 16, 2048)
    parts = block_sharding(tmesh, 1).place(x)
    assert [tuple(p.shape) for p in parts] == [(4, 2, 2048)] * 8
    np.testing.assert_array_equal(
        np.concatenate([p.numpy().view(np.uint32) for p in parts], axis=1),
        x)
    assert all(torch.equal(p, parts[0])
               for p in replicated(tmesh).place(parts[0]))
    with pytest.raises(ValueError):
        block_sharding(tmesh).place(np.zeros((9, 2048), np.uint32))


def test_make_mesh_needs_cards(monkeypatch):
    from bitmagic_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="card"):
        make_mesh(8)
    with pytest.raises(RuntimeError, match="card"):
        tsh.ShardedBitVector.from_indices([1], SIZE)


# ---------------------------------------------------------------------------
# sharded bit-vector
# ---------------------------------------------------------------------------
def test_roundtrip_and_count(rng, jmesh, tmesh):
    idx = random_ids(rng, SIZE, 0.01)
    jv, tv = pair_ids(idx, SIZE, jmesh, tmesh)
    assert_same_pool(jv, tv)
    assert tv.count() == jv.count() == tv.count_shardmap() == idx.size
    np.testing.assert_array_equal(tv.to_bitvector().indices(), idx)
    np.testing.assert_array_equal(tv.block_counts(),
                                  np.asarray(jv.block_counts()))
    np.testing.assert_array_equal(tv.digests(), np.asarray(jv.digests()))
    # carried across through interop
    back = interop.sharded_bitvector_from_parts(jpool(jv), jv.size, tmesh)
    assert_same_pool(jv, back)
    parts = interop.sharded_bitvector_to_parts(tv)
    np.testing.assert_array_equal(parts["pool_u32"], jpool(jv))


@pytest.mark.parametrize("op", ["__and__", "__or__", "__xor__", "__sub__"])
def test_sharded_ops(rng, jmesh, tmesh, op):
    ia, ib = random_ids(rng, SIZE, 0.02), random_ids(rng, SIZE, 0.02)
    ja, ta = pair_ids(ia, SIZE, jmesh, tmesh)
    jb, tb = pair_ids(ib, SIZE, jmesh, tmesh)
    jr, tr = getattr(ja, op)(jb), getattr(ta, op)(tb)
    assert_same_pool(jr, tr)
    assert tr.count() == jr.count()
    assert tr.last_narrowing is None
    assert_same_pool(ja.invert(), ta.invert())


def counting_wrappers(monkeypatch):
    """Count the calls of each kernel wrapper (on the CPU each runs its
    plain version; on the card each call is one launch)."""
    calls = {}
    for name in ("logical_op_digest", "block_counts_total", "agg_and_sub",
                 "pipeline_counts", "scan_eq"):
        fn = getattr(ck, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ck, name, wrapped)
    return calls


def test_one_kernel_call_per_shard_and_step(rng, monkeypatch, tmesh):
    a = tsh.ShardedBitVector.from_indices(random_ids(rng, SIZE, 0.02), SIZE,
                                          tmesh)
    calls = counting_wrappers(monkeypatch)
    a & a
    a.count()
    tsh.sharded_and_many([a, a], digest_narrowing=False)
    tsh.sharded_and_sub_count([a], [a], digest_narrowing=False)
    assert calls == {"logical_op_digest": 8, "block_counts_total": 8,
                     "agg_and_sub": 16}
    planes = rng.integers(0, 1 << 32, (3, 16, 2048),
                          dtype=np.uint64).astype(np.uint32)
    tsh.pipeline_counts_host(tmesh, planes, np.ones((4, 3), np.int32))
    tsh.scan_throughput_program(tmesh, 3, 2)[0](planes, 5)
    assert calls["pipeline_counts"] == calls["scan_eq"] == 8
    assert calls["block_counts_total"] == 16


def test_rank_range_select(rng, jmesh, tmesh):
    idx = random_ids(rng, SIZE, 0.01)
    jv, tv = pair_ids(idx, SIZE, jmesh, tmesh)
    qs = rng.integers(0, SIZE, 10)
    assert [tv.rank(int(i)) for i in qs] == [jv.rank(int(i)) for i in qs]
    for lo, hi in ((SIZE // 3, 2 * SIZE // 3), (0, SIZE - 1), (5, 5),
                   (BPB * 2 - 1, BPB * 2)):
        assert tv.count_range(lo, hi) == jv.count_range(lo, hi)
    ranks = np.concatenate([[0, -5, 1, idx.size, idx.size + 1, 2**40],
                            rng.integers(1, idx.size + 1, 200)])
    np.testing.assert_array_equal(tv.select_batch(ranks),
                                  jv.select_batch(ranks))
    ids = np.concatenate([rng.integers(-3, SIZE + 3, 300), [SIZE * 9]])
    np.testing.assert_array_equal(tv.get_bits(ids), jv.get_bits(ids))


def test_select_on_both_sides_of_the_cap(monkeypatch, tmesh):
    """The pool-size cap routes select through the rs index (the JAX
    package's int32 bound); both routes give the same answers."""
    rng = np.random.default_rng(31)
    size = 8 * BPB * 2
    ids = np.unique(rng.integers(0, size, 9_000)).astype(np.int64)
    n = len(ids)
    ranks = np.asarray([0, -5, 1, n, n + 1, 2**40], np.int64)
    want = np.asarray([-1, -1, ids[0], ids[-1], -1, -1], np.int64)
    fused = tsh.ShardedBitVector.from_indices(ids, size, tmesh)
    np.testing.assert_array_equal(fused.select_batch(ranks), want)
    assert fused._rs is None
    monkeypatch.setattr(tsh, "_FUSED_SELECT_CAP", 1)
    big = tsh.ShardedBitVector.from_indices(ids, size, tmesh)
    np.testing.assert_array_equal(big.select_batch(ranks), want)
    assert big._rs is not None
    rk = rng.integers(1, n + 1, 300)
    np.testing.assert_array_equal(big.select_batch(rk), ids[rk - 1])


def test_rs_index(rng, jmesh, tmesh):
    ids = np.unique(rng.integers(0, SIZE, 30_000)).astype(np.int64)
    jv, tv = pair_ids(ids, SIZE, jmesh, tmesh)
    ti, ji = tv.build_rs_index(), jv.build_rs_index()
    assert ti is tv.build_rs_index()
    assert ti.count() == ji.count() == ids.size
    np.testing.assert_array_equal(ti.shard_totals, ji.shard_totals)
    ranks = np.concatenate([[1, ids.size], rng.integers(1, ids.size, 500)])
    np.testing.assert_array_equal(ti.select_batch(ranks),
                                  ji.select_batch(ranks))
    assert ti.select(0) == ti.select(ids.size + 1) == -1
    qs = np.concatenate([ids[:200], ids[:200] + 1, [0, SIZE - 1, -1,
                                                    SIZE + 5]])
    np.testing.assert_array_equal(ti.rank_batch(qs), ji.rank_batch(qs))
    for q in qs[:5]:
        assert ti.rank(int(q)) == tv.rank_scan(int(q))


def test_rs_index_not_rebuilt_per_query(monkeypatch, tmesh):
    rng = np.random.default_rng(4)
    ids = np.unique(rng.integers(0, SIZE, 5_000)).astype(np.int64)
    sbv = tsh.ShardedBitVector.from_indices(ids, SIZE, tmesh)
    sbv.build_rs_index()

    def boom(*a):
        raise AssertionError("index rebuilt per query")
    monkeypatch.setattr(tsh, "_gwc", boom)
    for _ in range(3):
        r = int(rng.integers(1, ids.size))
        assert sbv.select_batch([r])[0] == ids[r - 1]


def test_reshard_and_checkpoint(rng, jmesh, tmesh):
    ids = np.unique(rng.integers(0, SIZE, 8_000)).astype(np.int64)
    jv, tv = pair_ids(ids, SIZE, jmesh, tmesh)
    for n in (4, 1, 3):
        r = tv.reshard(Mesh(["cpu"] * n))
        assert r.count() == ids.size and r.mesh.size == n
        assert_same_pool(jv.reshard(jmesh_mod.make_mesh(n)), r)
        np.testing.assert_array_equal(r.reshard(tmesh).to_words(),
                                      tv.to_words())
    blob = tv.checkpoint_bytes()
    assert blob == jv.checkpoint_bytes()
    back = tsh.ShardedBitVector.from_checkpoint(blob, tmesh)
    assert_same_pool(jv, back)


# ---------------------------------------------------------------------------
# digest narrowing, AND-SUB, the vector-axis exchange
# ---------------------------------------------------------------------------
def test_and_many_digest_narrowing(jmesh, tmesh):
    rng = np.random.default_rng(0)
    ja, ta, _ = sparse_pair(rng, jmesh, tmesh, [1, 3, 5, 11, 12])
    jb, tb, _ = sparse_pair(rng, jmesh, tmesh, [0, 3, 7, 11])
    jc, tc, _ = sparse_pair(rng, jmesh, tmesh, [3, 9, 11, 14])
    for narrow in (True, False):
        jr = jsh.sharded_and_many([ja, jb, jc], digest_narrowing=narrow)
        tr = tsh.sharded_and_many([ta, tb, tc], digest_narrowing=narrow)
        assert_same_pool(jr, tr)
        assert tr.last_narrowing == jr.last_narrowing
    assert tsh.sharded_and_many([ta]).last_narrowing == \
        jsh.sharded_and_many([ja]).last_narrowing == (16, 16)
    assert_same_pool(jsh.sharded_and_many([ja]), tsh.sharded_and_many([ta]))


def test_and_many_survivor_at_row0(jmesh, tmesh):
    """A survivor at a shard's local row 0 with ragged survivor counts:
    the JAX package pads the shorter shards' lists with slots that alias
    row 0; the port writes only valid rows."""
    ids = np.array([5, 131079, 196617], np.int64)          # blocks 0, 2, 3
    ja, ta = pair_ids(np.union1d(ids, [7 * BPB + 11]), SIZE, jmesh, tmesh)
    jb, tb = pair_ids(np.union1d(ids, [9 * BPB + 3]), SIZE, jmesh, tmesh)
    jr, tr = jsh.sharded_and_many([ja, jb]), tsh.sharded_and_many([ta, tb])
    np.testing.assert_array_equal(tr.to_bitvector().indices(), ids)
    assert_same_pool(jr, tr)
    assert tr.last_narrowing == jr.last_narrowing == (3, 16)
    rng = np.random.default_rng(42)
    for _ in range(5):
        blocks_a = rng.choice(SIZE_BLOCKS, 6, replace=False)
        blocks_b = np.union1d(rng.choice(blocks_a, 3, replace=False),
                              rng.choice(SIZE_BLOCKS, 3, replace=False))
        ja, ta, _ = sparse_pair(rng, jmesh, tmesh, blocks_a)
        jb, tb, _ = sparse_pair(rng, jmesh, tmesh, blocks_b)
        r1 = tsh.sharded_and_many([ta, tb])
        assert_same_pool(jsh.sharded_and_many([ja, jb]), r1)
        np.testing.assert_array_equal(
            r1.to_words(),
            tsh.sharded_and_many([ta, tb], digest_narrowing=False)
            .to_words())


def test_and_sub_and_count(jmesh, tmesh):
    rng = np.random.default_rng(1)
    ja, ta, ia = sparse_pair(rng, jmesh, tmesh, [2, 6, 10])
    jb, tb, ib = sparse_pair(rng, jmesh, tmesh, [2, 6, 13])
    js, ts, is_ = sparse_pair(rng, jmesh, tmesh, [6])
    want = np.setdiff1d(np.intersect1d(ia, ib), is_).size
    for narrow in (True, False):
        assert tsh.sharded_and_sub_count([ta, tb], [ts], narrow) == \
            jsh.sharded_and_sub_count([ja, jb], [js], narrow) == want
    assert tsh.sharded_and_sub_count([ta, tb]) == \
        jsh.sharded_and_sub_count([ja, jb])
    assert_same_pool(jsh.sharded_and_sub([ja, jb], [js]),
                     tsh.sharded_and_sub([ta, tb], [ts]))
    idxs = [random_ids(rng, SIZE, 0.6) for _ in range(5)]
    pairs = [pair_ids(i, SIZE, jmesh, tmesh) for i in idxs]
    jv, tv = [p[0] for p in pairs], [p[1] for p in pairs]
    assert_same_pool(jsh.sharded_and_many(jv), tsh.sharded_and_many(tv))
    jsub, tsub = pair_ids(idxs[0][:100], SIZE, jmesh, tmesh)
    assert_same_pool(jsh.sharded_and_sub(jv, [jsub]),
                     tsh.sharded_and_sub(tv, [tsub]))


@pytest.mark.parametrize("shared", [[4, 9], []])
def test_group_and_exchange(shared):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    rng = np.random.default_rng(2)
    K = 8
    stacks = []
    for k in range(K):
        blocks = shared + [(k % 6) + 10 if k % 2 else k]
        ids = np.unique(np.concatenate([
            rng.integers(b * BPB, (b + 1) * BPB, 800) for b in blocks])
        ).astype(np.int64)
        stacks.append(jbm.BitVector.from_indices(ids, SIZE).to_words())
    stack = np.stack(stacks)
    jv = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("v",))
    tv = Mesh(["cpu"] * 8, "v")
    jstack = jax.device_put(stack, NamedSharding(jv, P("v", None, None)))
    jrows, jsurv, jtraffic = jsh.group_and_exchange(jstack, jv, "v")
    trows, tsurv, ttraffic = tsh.group_and_exchange(stack, tv, "v")
    np.testing.assert_array_equal(tsurv, jsurv)
    assert ttraffic == jtraffic
    np.testing.assert_array_equal(
        trows.numpy().view(np.uint32), np.asarray(jrows).astype(np.uint32))
    jc, _, jt2 = jsh.group_and_exchange(jstack, jv, "v", count_only=True)
    tc, _, tt2 = tsh.group_and_exchange(stack, tv, "v", count_only=True)
    assert tc == jc and tt2 == jt2
    with pytest.raises(ValueError):
        tsh.group_and_exchange(stack, Mesh(["cpu"] * 8), "v")


# ---------------------------------------------------------------------------
# pipeline counts, scan throughput, task plans
# ---------------------------------------------------------------------------
def test_pipeline_counts(jmesh, tmesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    rng = np.random.default_rng(3)
    S, nblk = 6, 16
    planes = rng.integers(0, 1 << 32, (S, nblk, 2048),
                          dtype=np.uint64).astype(np.uint32)
    sels = rng.integers(-1, 2, (24, S)).astype(np.int32)
    sels[:, 0] = 1                 # the JAX kernel needs an AND operand
    jplanes = jax.device_put(planes, NamedSharding(
        jmesh, P(None, jmesh_mod.BLOCK_AXIS, None)))
    jparts = np.asarray(jsh.pipeline_counts_program(jmesh)(
        jplanes, jnp.asarray(sels)))
    tparts = tsh.pipeline_counts_program(tmesh)(planes, sels)
    assert tparts.shape == (8, 24) and tparts.dtype == np.int64
    np.testing.assert_array_equal(tparts, jparts.astype(np.int64))
    np.testing.assert_array_equal(
        tsh.pipeline_counts_host(tmesh, planes, torch.from_numpy(sels)),
        jsh.pipeline_counts_host(jmesh, jplanes, jnp.asarray(sels)))


@pytest.mark.parametrize("n_planes,target", [(8, 42), (5, 0), (8, 300)])
def test_scan_throughput_program(jmesh, tmesh, n_planes, target):
    rng = np.random.default_rng(7)
    nb_per_shard = 2
    nblk = nb_per_shard * 8
    vals = rng.integers(0, 2**n_planes, nblk * BPB).astype(np.uint32)
    planes = np.zeros((n_planes, nblk, 2048), np.uint32)
    for s in range(n_planes):
        bits = ((vals >> s) & 1).astype(np.uint8)
        planes[s] = np.packbits(bits, bitorder="little").view(
            np.uint32).reshape(nblk, 2048)
    jscan, _ = jsh.scan_throughput_program(jmesh, n_planes, nb_per_shard)
    tscan, sharding = tsh.scan_throughput_program(tmesh, n_planes,
                                                  nb_per_shard)
    got = tscan(planes, np.uint32(target))
    assert isinstance(got, np.uint32)
    # value bits above the scanned planes are not looked at
    assert int(got) == int(jscan(planes, np.uint32(target))) == \
        int((vals == target % 2**n_planes).sum())
    assert int(tscan(sharding.place(planes), target)) == int(got)


def test_task_batch_plans(rng):
    from bitmagic_tpu.parallel import plan as jplan
    from bitmagic_tpu_torch.parallel import plan as tplan
    vals = rng.integers(0, 1000, 5000).astype(np.uint32)
    jsv = jbm.SparseVector.from_array(vals)
    tsv = tbm.SparseVector.from_array(vals)
    tplan.run_task_batch(tplan.build_optimize_plan(tsv), n_threads=4)
    jplan.run_task_batch(jplan.build_optimize_plan(jsv), n_threads=4)
    np.testing.assert_array_equal(tsv.to_numpy(), vals)
    tb = tplan.run_task_batch(tplan.build_sv_serialization_plan(tsv),
                              n_threads=4)
    jb = jplan.run_task_batch(jplan.build_sv_serialization_plan(jsv))
    assert tb == jb
    vs = [tbm.BitVector.from_indices(random_ids(rng, 3 * BPB, d), 3 * BPB)
          for d in (0.1, 0.3, 0.5)]
    jvs = [jbm.BitVector.from_indices(v.indices(), 3 * BPB) for v in vs]
    assert tplan.run_task_batch(tplan.build_sim_matrix_plan(vs)) == \
        jplan.run_task_batch(jplan.build_sim_matrix_plan(jvs))
    assert tplan.run_task_batch(
        tplan.TaskBatch().add(lambda: 1).add(lambda: 2)) == [1, 2]


def test_parallel_names_exported():
    import bitmagic_tpu.parallel as jpar
    import bitmagic_tpu_torch.parallel as tpar
    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in jpar.__all__:
        assert getattr(tpar, name) is not None
    assert tbm.parallel is tpar
