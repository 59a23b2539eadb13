"""The ordered searches' MSB-first slice descent in one launch (the port's
kernel sv_descent and its dense form descent_rows, here their plain
versions) against the JAX package, on the CPU.

Every ordered search (find_gt/ge/lt/le/range) runs on unsigned columns,
nullable and not, on signed columns of int8 to int64 at the ``iinfo``
edges, on uint64's top planes, on a float column (the float searches) and
on an RSC column, each built with every block class in its planes: BIT
rows, FULL runs (``set_range``), absent planes and blocks, and D-GAP
blocks of 1 to 3000 runs.  In the unsigned columns the two top planes
hold D-GAP blocks whose runs sum to 4096 in one block (merged in the run
domain) and 4097 in the next (a BIT row), and a query's 1-bit meets an
absent plane.  Each result must equal the JAX scanner's, which runs the
chain of set operations, in every ``interop.PARTS`` field.  The sharded
containers' descents equal the JAX package's fused ``_descent_prog`` and
``_float_gt_prog`` on its 8-device CPU mesh.  The fused descent also
equals the port's own chain of set operations on hand-made universes
(FULL runs only, D-GAP only, empty).  Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.parallel import mesh as jmesh_mod
from bitmagic_tpu.parallel import sharded_sv as jss
from bitmagic_tpu.sv.scanner import scanner as jsc
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.core.bitvector import BitVector, descent
from bitmagic_tpu_torch.core.blocks import Structure
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from bitmagic_tpu_torch.parallel import Mesh
from bitmagic_tpu_torch.parallel import sharded_sv as tss
from chip_smoke import _run_bits, descent_chain, descent_column
from test_torch_containers import jax_float_parts, jax_rsc_parts
from test_torch_scanner import assert_same_bv, jax_sv_parts

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
DATA_BLOCKS = 6              # blocks 0-3 random, 4-5 D-GAP patterns
SIZE = 37 * BPB + 99         # descent_column's: a 32-block FULL run fits
GAP_LEVELS = (128, 256, 512, 4096)
DESCENT_GAP = blockops.DESCENT_CLASSES.index("gap")
tsc = tbm.scanner


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _int_column(dtype, nullable, seed):
    """(JAX column, the port's copy of it through interop)."""
    jsv = descent_column(jbm, dtype, nullable, seed)
    return jsv, interop.sparse_vector_from_parts(**jax_sv_parts(jsv),
                                                 device="cpu")


def _kinds(sv):
    """Block classes and D-GAP run counts over a port column's planes."""
    kinds, runs = set(), []
    for p in sv.planes + ([sv.null_plane] if sv.nullable else []):
        if p is None:
            kinds.add("absent")
            continue
        kinds.update(int(c) for c in np.unique(p._struct.cls))
        if p._struct.has_runs:
            kinds.add("runs")
        if p._gaps is not None:
            runs.extend(p._gaps.n_runs().tolist())
    return kinds, runs


def _queries(jsv, dtype):
    info = np.iinfo(dtype)
    bits = info.bits
    hole = 1 << (bits // 2)        # a 1-bit on the absent plane
    qs = {0, 1, 2, info.max, info.max - 1, info.min, info.min + 1,
          hole | 5, info.max >> 1, int(jsv.get(12345)), int(jsv.get(7))}
    if info.min:
        qs |= {-1, -2, -(hole | 5)}
    return sorted(q for q in qs if info.min <= q <= info.max)


def _check_ordered(jsv, tsv, queries, jscan=jsc, tscan=tsc):
    for q in queries:
        for name in ("find_gt", "find_ge", "find_lt", "find_le"):
            assert_same_bv(getattr(jscan, name)(jsv, q),
                           getattr(tscan, name)(tsv, q))
    for lo, hi in zip(queries, queries[::-1]):
        assert_same_bv(jscan.find_range(jsv, lo, hi),
                       tscan.find_range(tsv, lo, hi))


@pytest.mark.parametrize("nullable", [False, True])
def test_unsigned_column(nullable):
    jsv, tsv = _int_column(np.uint32, nullable, 7)
    kinds, runs = _kinds(tsv)
    assert kinds >= {"absent", "runs", C.CLS_BIT, C.CLS_GAP, C.CLS_FULL}
    assert min(runs) <= 10 and max(runs) > 2900
    top = [tsv.planes[s]._gaps.n_runs()[:2].tolist() for s in (31, 30)]
    assert top == [[2000, 2000], [2096, 2097]]
    _check_ordered(jsv, tsv, _queries(jsv, np.uint32))


def test_the_merge_bound_decides_the_block_class():
    """eq = universe & p31 & p30 over the unsigned column: in block 4 the
    two D-GAP blocks' runs sum to 4096 (merged in the run domain: D-GAP),
    in block 5 to 4097 (a BIT row); both packages and the port's chain
    agree."""
    from bitmagic_tpu.sv.scanner import _universe as j_universe
    from bitmagic_tpu_torch.sv.scanner import _universe as t_universe
    jsv, tsv = _int_column(np.uint32, False, 7)
    juni, uni = j_universe(jsv), t_universe(tsv)
    table = tsv._plane_table()
    row = {int(b): i for i, b in enumerate(table.meta[:, -1])}
    steps = [(row[s], 1, tsv.planes[s]._struct) for s in (31, 30)]
    _, eq = descent(table, uni, steps)
    assert_same_bv((juni & jsv.planes[31]) & jsv.planes[30], eq)
    _same((uni & tsv.planes[31]) & tsv.planes[30], eq)
    cls = dict(zip(eq._struct.nb.tolist(), eq._struct.cls.tolist()))
    assert (cls[4], cls[5]) == (C.CLS_GAP, C.CLS_BIT)


@pytest.mark.parametrize("nullable", [False, True])
def test_classes_carry_the_d_gap_run_counts(nullable):
    """sv_descent's class words (plain version): a D-GAP result's word
    holds its exact run count above the class, which ``descent`` sums
    into gap_compress's bound; every other class holds 0 there."""
    from bitmagic_tpu_torch.core.bitvector import descent_args
    from bitmagic_tpu_torch.core.gapstore import GapStore
    from bitmagic_tpu_torch.sv.scanner import _universe as t_universe
    jsv, tsv = _int_column(np.uint32, nullable, 7)
    uni = t_universe(tsv)
    seen = 0
    for value in _queries(jsv, np.uint32):
        table, steps, _ = tsc._descent_steps(tsv, value, 32)
        if not steps:
            continue
        blocks = np.union1d(table.blocks, uni._struct.nb)
        gt, _, eq, _, cls = blockops.sv_descent(
            table, *descent_args(table, uni, steps, blocks))
        assert cls.dtype == torch.int32 and cls.shape == (2 * blocks.size,)
        rows = blockops.to_host_words(torch.cat([gt, eq]))
        kind, runs = cls.numpy() & 0xFF, cls.numpy() >> 8
        gap = np.flatnonzero(kind == DESCENT_GAP)
        assert not runs[kind != DESCENT_GAP].any()
        want = GapStore.from_dense(rows[gap]).n_runs() if gap.size else []
        assert np.array_equal(runs[gap], want)
        seen += gap.size
    assert seen


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.uint64])
def test_signed_and_64_bit_columns(dtype):
    jsv, tsv = _int_column(dtype, dtype == np.int32, 11)
    kinds, _ = _kinds(tsv)
    assert kinds >= {"absent", "runs", C.CLS_BIT, C.CLS_GAP}
    _check_ordered(jsv, tsv, _queries(jsv, dtype))
    if dtype == np.uint64:             # the top planes
        assert tsv.planes[63] is not None
        for q in (2**63, 2**63 - 1, 2**64 - 2, 3 << 62):
            assert_same_bv(jsc.find_gt(jsv, q), tsc.find_gt(tsv, q))


def test_float_column():
    rng = np.random.default_rng(5)
    n = DATA_BLOCKS * BPB + 777
    vals = (rng.standard_normal(n) * 1000).astype(np.float32)
    # D-GAP blocks: long runs of a few values; block 5 zeros
    steps = np.repeat(rng.choice([2.5, -2.5, 0.0, 1e6, -0.0], 600),
                      2 * BPB // 600 + 1)[:2 * BPB]
    vals[2 * BPB:4 * BPB] = steps.astype(np.float32)
    vals[5 * BPB:6 * BPB] = 0.0
    vals[:4] = [0.0, -0.0, np.inf, -np.inf]
    levels = jbm.config.gap_levels
    try:
        jbm.config.gap_levels = GAP_LEVELS
        jf = jbm.FloatSparseVector.from_array(vals, nullable=True)
        for i in (3, 100, n - 1):
            jf.set_null(i)
        jf.optimize()
    finally:
        jbm.config.gap_levels = levels
    jf.resize(SIZE)
    for part, s in ((jf.exponent, 2), (jf.mantissa, 20)):
        part.planes[s].set_range(3 * BPB + 17, 37 * BPB - 1)
    jf.null_plane.set_range(6 * BPB, SIZE - 1)
    tf = interop.float_vector_from_parts(**jax_float_parts(jf),
                                         device="cpu")
    kinds, _ = _kinds(tf.mantissa)
    assert kinds >= {"absent", "runs", C.CLS_BIT, C.CLS_GAP}
    qs = [2.5, -2.5, 0.0, -0.0, 1e6, -1e30, 12.75, float(vals[77])]
    for q in qs:
        q = np.float32(q)
        for name in ("find_gt_float", "find_ge_float", "find_lt_float",
                     "find_le_float"):
            assert_same_bv(getattr(jsc, name)(jf, q),
                           getattr(tsc, name)(tf, q))
    for lo, hi in ((-2.5, 2.5), (1e6, -1e6), (0.0, 0.0)):
        assert_same_bv(jsc.find_range_float(jf, lo, hi),
                       tsc.find_range_float(tf, lo, hi))


def test_rsc_column():
    rng = np.random.default_rng(9)
    n = DATA_BLOCKS * BPB
    vals = rng.integers(0, 1 << 12, n).astype(np.uint32)
    vals[2 * BPB:4 * BPB] = np.repeat(rng.integers(0, 1 << 12, 400),
                                      2 * BPB // 400 + 1)[:2 * BPB]
    nulls = rng.random(n) < 0.3
    nulls[2 * BPB:3 * BPB] = False
    levels = jbm.config.gap_levels
    try:
        jbm.config.gap_levels = GAP_LEVELS
        js = jbm.SparseVector.from_array(vals, null_mask=nulls)
        j = jbm.RSCSparseVector.from_sparse_vector(js)
        j.optimize()
    finally:
        jbm.config.gap_levels = levels
    t = interop.rsc_vector_from_parts(**jax_rsc_parts(j), device="cpu")
    kinds, _ = _kinds(t.dense)
    assert kinds >= {C.CLS_BIT, C.CLS_GAP}
    for q in (0, 7, 1023, 4095, int(vals[1])):
        for name in ("find_gt_rsc", "find_lt_rsc"):
            assert_same_bv(getattr(jsc, name)(j, q),
                           getattr(tsc, name)(t, q))
    _check_ordered(j.dense, t.dense, [0, 100, 4095, int(vals[1])])


def _entries_beside_runs(pkg, size):
    """A vector of ``pkg`` with a FULL entry (block 1) two blocks from a
    FULL run (blocks 3-35) and BIT blocks between and after them: the
    complement of every 7th bit of blocks 0, 2 and 36."""
    idx = np.concatenate([b * BPB + np.arange(0, BPB, 7) for b in (0, 2, 36)])
    kw = {} if pkg is jbm else {"device": "cpu"}
    v = pkg.BitVector.from_indices(idx, size, **kw)
    v.invert()
    return v


@pytest.mark.parametrize("where", ["plane", "universe"])
def test_full_entries_beside_runs(where):
    """The descent's entry codes tell a FULL entry (-1) from a block inside
    a FULL run (DIR_RUN), which the block directory writes alike: with
    both in the top plane, and in the universe (the NULL plane) too, every
    ordered search equals the JAX package's.  A 0-bit on the top plane
    ANDs a FULL run of it with one of the universe at walked blocks 4-6,
    which stays a run (an entry there would be a FULL block)."""
    jsv, tsv = _int_column(np.uint32, where == "universe", 5)
    for c, pkg in ((jsv, jbm), (tsv, tbm)):
        c.planes[31] = _entries_beside_runs(pkg, c.size)
        if where == "universe":
            c.null_plane = _entries_beside_runs(pkg, c.size)
    for p in (tsv.planes[31], tsv.null_plane if tsv.nullable else None):
        st = (p or tsv.planes[31])._struct
        assert C.CLS_FULL in st.cls and st.has_runs
    _check_ordered(jsv, tsv, [0, 1 << 7, 0x7FFF_FF7F, 0x8000_0080,
                              int(jsv.get(3 * BPB + 11)), 0xFFFF_FFFF])


# ---------------------------------------------------------------------------
# the fused descent against the port's own chain of set operations
# ---------------------------------------------------------------------------
def _same(a, b):
    pa, pb = interop.bitvector_to_parts(a), interop.bitvector_to_parts(b)
    for key in interop.PARTS:
        np.testing.assert_array_equal(np.asarray(pa[key]),
                                      np.asarray(pb[key]), err_msg=key)


def _universes(rng):
    runs = BitVector._from_parts(
        Structure(np.zeros(0, np.int64), np.zeros(0, np.uint8),
                  np.asarray([[0, 3], [4, 40]], np.int64)),
        blockops.zero_pool(0), SIZE, device="cpu")
    levels = tbm.config.gap_levels
    try:
        tbm.config.gap_levels = GAP_LEVELS
        gap = BitVector.from_indices(np.concatenate([
            b * BPB + np.flatnonzero(_run_bits(rng, r)) for b, r in
            ((0, 3), (2, 1500), (4, 2600), (5, 40))]), SIZE,
            strategy=C.BM_GAP, device="cpu")
    finally:
        tbm.config.gap_levels = levels
    assert (gap._struct.cls == C.CLS_GAP).all()
    return {"runs only": runs, "D-GAP": gap,
            "empty": BitVector(SIZE, device="cpu"),
            "column": BitVector.from_indices(np.arange(0, SIZE, 3), SIZE,
                                             device="cpu")}


@pytest.mark.parametrize("which", ["runs only", "D-GAP", "empty", "column"])
def test_fused_equals_the_chain(which):
    _, tsv = _int_column(np.uint32, False, 3)
    uni = _universes(np.random.default_rng(4))[which]
    for q in (0, 5, 1 << 16, (1 << 31) | 77, 0xFFFFFFFE, 1 << 16 | 1):
        want = descent_chain(tbm, tsv.planes, uni, q, 32)
        got = tsc._cmp_unsigned(tsv, uni, q, 32)
        _same(want[0], got[0])
        _same(want[1], got[1])
        assert tsc._cmp_unsigned(tsv, uni, q, 32, want_eq=False)[1] is None


def test_no_step_and_no_block(monkeypatch):
    """A descent with no step returns gt empty and eq the universe; one
    over planes and a universe of FULL runs only launches nothing."""
    calls = []
    real = ck.sv_descent
    monkeypatch.setattr(ck, "sv_descent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    uni = _universes(np.random.default_rng(4))["runs only"]
    sv = tbm.SparseVector(np.uint32, device="cpu")
    sv.resize(SIZE)
    gt, eq = tsc._cmp_unsigned(sv, uni, 0, 32)
    _same(gt, BitVector(C.ID_MAX48, device="cpu"))
    _same(eq, uni)
    gt, eq = tsc._cmp_unsigned(sv, uni, 5, 32)      # a 1-bit, no plane
    _same(eq, BitVector(C.ID_MAX48, device="cpu"))
    sv.planes[3] = BitVector._from_parts(
        Structure(np.zeros(0, np.int64), np.zeros(0, np.uint8),
                  np.asarray([[1, 38]], np.int64)),
        blockops.zero_pool(0), C.ID_MAX48, device="cpu")
    for q in (8, 0, 1):
        want = descent_chain(tbm, sv.planes, uni, q, 32)
        got = tsc._cmp_unsigned(sv, uni, q, 32)
        _same(want[0], got[0])
        _same(want[1], got[1])
    assert not calls


def test_steps_and_the_card():
    rows, bits = blockops.descent_steps([4, -1, 6], 0b101)
    assert rows == [6, -1, 4] and bits == 0b101
    rows, bits = blockops.descent_steps([4, -1, 6], 0b110)
    assert bits == 0b011
    vals = np.arange(100, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.SparseVector.from_array(vals, device="cuda")
    stack = torch.zeros((3, 2, 2048), dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.descent_rows(stack, stack[0], [0], 0, mode=1)


# ---------------------------------------------------------------------------
# the dense form: the sharded containers against the fused JAX programs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def meshes():
    return jmesh_mod.make_mesh(8), Mesh(["cpu"] * 8)


def _joined(pools):
    return np.concatenate([p.numpy().view(np.uint32) for p in pools])


@pytest.mark.parametrize("dtype", [np.uint32, np.int16])
def test_descent_rows_equals_descent_prog(meshes, dtype):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(13)
    n = 3 * BPB + 999
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    vals[BPB:2 * BPB] = np.repeat(vals[:200], BPB // 200 + 1)[:BPB]
    nm = rng.random(n) < 0.1
    j = jss.ShardedSparseVector.from_sparse_vector(
        jbm.SparseVector.from_array(vals, null_mask=nm), jmesh)
    t = tss.ShardedSparseVector.from_sparse_vector(
        tbm.SparseVector.from_array(vals, null_mask=nm, device="cpu"), tmesh)
    n_mag = j.n_eff - 1
    cases = [(0, 0, j.n_eff, 12345), (0, 0, j.n_eff, 0)]
    if j.signed:
        cases += [(1, 1, n_mag, 77), (2, 1, n_mag, 3000), (2, 1, n_mag, 0)]
    for mode, lo, nbits, u in cases:
        jg, je = j._descent(mode, j._vbits(u, 0, nbits), lo, nbits)
        tg, te = t._descent(mode, u, lo, nbits)
        np.testing.assert_array_equal(_joined(tg), np.asarray(jg))
        np.testing.assert_array_equal(_joined(te), np.asarray(je))
    calls = []
    real = ck.descent_rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "descent_rows",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        got = t.find_gt(12345)
    assert len(calls) == 8                  # one per shard
    np.testing.assert_array_equal(got.to_words(),
                                  np.asarray(j.find_gt(12345).pool))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_gt_eq_equals_float_gt_prog(meshes, dtype):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(17)
    n = 2 * BPB + 321
    # |x| < 2: the exponent's top plane is absent (a -1 row)
    vals = np.clip(rng.normal(0, 0.5, n), -1.9, 1.9).astype(dtype)
    vals[5] = -0.0
    j = jss.ShardedFloatVector.from_float_vector(
        jbm.FloatSparseVector.from_array(vals), jmesh)
    t = tss.ShardedFloatVector.from_float_vector(
        tbm.FloatSparseVector.from_array(vals, device="cpu"), tmesh)
    assert -1 in t.rows and t.rows == j.rows
    for q in (0.25, 0.0, -0.0, -1.5, 1e30, -3.0, float(vals[9])):
        jg, je = j._gt_eq(dtype(q))
        tg, te = t._gt_eq(dtype(q))
        np.testing.assert_array_equal(_joined(tg), np.asarray(jg))
        np.testing.assert_array_equal(_joined(te), np.asarray(je))
