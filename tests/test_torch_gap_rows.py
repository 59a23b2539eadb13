"""D-GAP blocks on the device: ``gap_expand`` / ``gap_compress`` and the
set-op and metric routes built on them, against the JAX package.

On the CPU the wrappers run their plain versions (``ops/blockops.py``):
they must equal ``GapStore.to_dense`` / ``GapStore.from_dense`` exactly.
``_binary`` sends GAP x GAP pairs through K1 and re-encodes the small ones
with ``gap_compress``; ``distance_operation`` sends every pair with a BIT
or GAP side through K2.  Both must leave exactly the JAX package's state
(block classes, dense rows, GAP ``ends`` / ``offs`` / ``first``) and
answers, which that package computes with its host run merges; and the
port's result store must equal its own ``gap_binary_op``'s.  Inputs are
made with numpy from fixed seeds.  The kernels themselves are held against
the plain versions on the card in ``tests/test_torch_kernels.py``.

Tolerance: exact equality everywhere (bits and integer counts).
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import interop
from bitmagic_tpu_torch.core import bitvector as tbv
from bitmagic_tpu_torch.core import gapstore as tgs
from bitmagic_tpu_torch.core.gapstore import GapStore, compress_rows
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from test_torch_bitvector import assert_same_state

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
OPS = {"and": "__and__", "or": "__or__", "xor": "__xor__", "sub": "__sub__"}
METRICS = list(blockops.METRICS)
N_BLOCKS = 64


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def run_row(rng, n_runs, first=None):
    """One block's words with ``n_runs`` runs (bounds drawn at random),
    starting with ``first`` (random when None)."""
    cuts = np.sort(rng.choice(np.arange(1, BPB), n_runs - 1, replace=False))
    first = int(rng.integers(0, 2)) if first is None else first
    val = (np.arange(n_runs) + first) & 1
    bits = np.repeat(val, np.diff(np.concatenate([[0], cuts, [BPB]])))
    return np.packbits(bits.astype(np.uint8), bitorder="little").view(
        np.uint32)


def edge_rows(rng):
    """Rows covering the encoder's edges: 1-run zero and full blocks, first
    = 1, a lone bit at 0 and at 65535, ends in the last word, runs of one
    bit, and a block of exactly ``_GAP_MERGE_MAX_RUNS`` runs."""
    rows = [np.zeros(2048, np.uint32), np.full(2048, 0xFFFFFFFF, np.uint32)]
    for word, val in ((0, 1), (-1, 0x80000000), (-1, 0x7FFFFFFF),
                      (0, 0xFFFFFFFE)):
        r = np.zeros(2048, np.uint32)
        r[word] = val
        rows.append(r)
    rows.append(np.full(2048, 0x55555555, np.uint32))     # 65536 runs
    rows.append(run_row(rng, tbv._GAP_MERGE_MAX_RUNS))
    rows += [run_row(rng, n, f) for n, f in ((2, 1), (3, 1), (2, 0),
                                             (200, 1), (1000, 0))]
    return np.stack(rows)


def as_torch(words):
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                            .view(np.int32).copy())


@pytest.fixture(scope="module")
def rows():
    return edge_rows(np.random.default_rng(2026))


def test_gap_expand_plain_equals_to_dense(rows):
    store = GapStore.from_dense(rows)
    for sel in (np.arange(len(rows)), np.asarray([8, 0, 3, 3, 1, 7]),
                np.zeros(0, np.int64)):
        got = ck.gap_expand(*store.device_arrays("cpu"),
                            torch.from_numpy(sel.astype(np.int32)))
        assert got.shape == (sel.size, 2048)
        np.testing.assert_array_equal(blockops.to_host_words(got),
                                      store.to_dense(sel))


def _compress_case(case, rows):
    """Rows of one ``gap_compress`` case: the edge rows, no row, one row,
    400 rows drawn as bvsetalgebra_rank_select's (1 to 256 runs), rows of
    one run (zero, full) and rows of 65536 runs."""
    rng = np.random.default_rng(17)
    if case == "edges":
        return rows
    if case == "empty":
        return np.zeros((0, 2048), np.uint32)
    if case == "one_row":
        return run_row(rng, 200)[None]
    if case == "rows_400":
        return np.stack([run_row(rng, int(n))
                         for n in rng.integers(1, 257, 400)])
    if case == "one_run":
        return np.stack([np.zeros(2048, np.uint32),
                         np.full(2048, 0xFFFFFFFF, np.uint32)])
    return np.stack([np.full(2048, w, np.uint32)
                     for w in (0x55555555, 0xAAAAAAAA)])


@pytest.mark.parametrize("above", [0, 1000], ids=["cap_total",
                                                  "cap_above"])
@pytest.mark.parametrize("case", ["edges", "empty", "one_row", "rows_400",
                                  "one_run", "runs_65536"])
def test_gap_compress_plain_equals_from_dense(rows, case, above):
    """The plain packed buffer (offs, first a word each, then the run
    ends) of every case, with ``cap`` the total or above it, read back by
    ``GapStore.from_packed``, equals ``GapStore.from_dense``."""
    words = _compress_case(case, rows)
    n = words.shape[0]
    want = GapStore.from_dense(words)
    total = int(want.offs[-1])
    if case == "runs_65536":
        assert list(want.n_runs()) == [BPB, BPB]
    buf = ck.gap_compress(as_torch(words), total + above)
    assert buf.dtype == torch.int32 and buf.shape == (2 * n + 1 + total
                                                      + above,)
    ends, offs, first = blockops.gap_unpack(buf, n)
    np.testing.assert_array_equal(ends.numpy(), want.ends)
    np.testing.assert_array_equal(offs.numpy(), want.offs)
    np.testing.assert_array_equal(first.numpy(), want.first)
    got = GapStore.from_packed(buf, n)
    for key in ("ends", "offs", "first"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    store, zm, fm = compress_rows(as_torch(words), total + above)
    for key in ("ends", "offs", "first"):
        np.testing.assert_array_equal(getattr(store, key),
                                      getattr(want, key))
    if case == "edges":
        np.testing.assert_array_equal(np.flatnonzero(zm), [0])
        np.testing.assert_array_equal(np.flatnonzero(fm), [1])


def test_gap_compress_cap_below_total_raises(rows):
    """A ``cap`` below the total: the buffer holds the first ``cap`` run
    ends and the true total in ``offs[n]``, and reading it raises."""
    want = GapStore.from_dense(rows)
    n, total = rows.shape[0], int(want.offs[-1])
    buf = ck.gap_compress(as_torch(rows), total - 5)
    ends, offs, _ = blockops.gap_unpack(buf, n)
    assert int(offs[n]) == total
    np.testing.assert_array_equal(ends.numpy(), want.ends[:total - 5])
    with pytest.raises(RuntimeError, match="exceed"):
        GapStore.from_packed(buf, n)
    with pytest.raises(RuntimeError, match="exceed"):
        compress_rows(as_torch(rows), total - 1)
    with pytest.raises(ValueError):
        ck.gap_compress(as_torch(rows), -1)


@pytest.mark.parametrize("seed", [3, 4])
def test_gap_round_trip_random_stores(seed):
    rng = np.random.default_rng(seed)
    words = np.stack([run_row(rng, int(n))
                      for n in rng.integers(1, 3000, 24)])
    store = GapStore.from_dense(words)
    sel = rng.permutation(24)[:17]
    got = ck.gap_expand(*store.device_arrays("cpu"),
                        torch.from_numpy(sel.astype(np.int32)))
    np.testing.assert_array_equal(blockops.to_host_words(got), words[sel])
    sub = store.subset(sel)
    back = GapStore.from_packed(ck.gap_compress(got, int(sub.offs[-1])),
                                sel.size)
    for key in ("ends", "offs", "first"):
        np.testing.assert_array_equal(getattr(back, key), getattr(sub, key))


def test_device_mirror_is_kept():
    store = GapStore.from_dense(edge_rows(np.random.default_rng(5))[:4])
    m = store.device_arrays("cpu")
    assert store.device_arrays(torch.device("cpu")) is m
    assert [t.dtype for t in m] == [torch.int32, torch.int32, torch.uint8]
    np.testing.assert_array_equal(m[0].numpy(), store.ends)
    np.testing.assert_array_equal(m[1].numpy(), store.offs)


# ---------------------------------------------------------------------------
# the set-op and metric routes against the JAX package
# ---------------------------------------------------------------------------
def pair_parts(seed):
    """The parts of two 64-block vectors whose aligned blocks meet every
    route: BIT x BIT / GAP, GAP x GAP (random, complementary, equal,
    starting with ones, past and at the run bound), GAP x FULL / ZERO /
    FULL run, and FULL / ZERO x GAP."""
    rng = np.random.default_rng(seed)
    dense = lambda: rng.integers(0, 2**32, 2048,  # noqa: E731
                                 dtype=np.uint64).astype(np.uint32)
    gap = lambda n=None, f=None: run_row(  # noqa: E731
        rng, int(rng.integers(2, 300)) if n is None else n, f)
    full = np.full(2048, 0xFFFFFFFF, np.uint32)
    a, b = {}, {}
    a[0], b[0] = ("B", dense()), ("B", dense())
    a[1], b[1] = ("B", dense()), ("G", gap())
    a[2], b[2] = ("G", gap()), ("B", dense())
    for blk in (3, 13, 14):
        a[blk], b[blk] = ("G", gap()), ("G", gap())
    g = gap()
    a[4], b[4] = ("G", g), ("G", ~g)                 # and ZERO, or/xor FULL
    g = gap()
    a[5], b[5] = ("G", g), ("G", g.copy())           # xor / sub ZERO
    a[6], b[6] = ("G", gap(2100)), ("G", gap(2100))  # past the run bound
    a[7], b[7] = ("G", gap(2048)), ("G", gap(2048))  # at the run bound
    a[8], b[8] = ("G", gap()), ("F", full)
    a[9] = ("G", gap())                              # b ZERO
    a[10], b[10] = ("F", full), ("G", gap())
    b[11] = ("G", gap())                             # a ZERO
    a[12], b[12] = ("G", gap(f=1)), ("G", gap(f=1))
    b[15] = ("B", dense())
    a[16] = ("F", full)
    for blk in (30, 31):                             # under a's FULL run
        b[blk] = ("G", gap())
    b[40] = ("B", dense())
    return [to_parts(v, runs) for v, runs in ((a, [[20, 56]]), (b, []))]


def to_parts(blocks, runs):
    nb = np.asarray(sorted(blocks), np.int64)
    kind = [blocks[i][0] for i in nb]
    cls = np.asarray([{"B": C.CLS_BIT, "G": C.CLS_GAP, "F": C.CLS_FULL}[k]
                      for k in kind], np.uint8)
    words = [blocks[i][1] for i in nb]
    bit_rows = [w for w, k in zip(words, kind) if k == "B"]
    gaps = GapStore.from_dense(np.stack([w for w, k in zip(words, kind)
                                         if k == "G"]))
    return {"size": N_BLOCKS * BPB, "nb": nb, "cls": cls,
            "runs": np.asarray(runs, np.int64).reshape(-1, 2),
            "pool_u32": np.stack(bit_rows), "gap_ends": gaps.ends,
            "gap_offs": gaps.offs, "gap_first": gaps.first}


def jax_vector(parts):
    import jax.numpy as jnp
    from bitmagic_tpu.core.blocks import Structure
    from bitmagic_tpu.core.gapstore import GapStore as JaxGapStore
    return jbm.BitVector._from_parts(
        Structure(parts["nb"].copy(), parts["cls"].copy(),
                  parts["runs"].copy()),
        jnp.asarray(parts["pool_u32"]), parts["size"],
        JaxGapStore(parts["gap_ends"].copy(), parts["gap_offs"].copy(),
                    parts["gap_first"].copy()))


def port_vector(parts):
    return interop.bitvector_from_parts(**parts, device="cpu")


@pytest.fixture(scope="module")
def vectors():
    pa, pb = pair_parts(11)
    return (jax_vector(pa), jax_vector(pb)), (port_vector(pa),
                                              port_vector(pb))


def no_host_merges(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host run-domain merge called")
    for name in ("gap_binary_op", "gap_metric_counts"):
        monkeypatch.setattr(tgs, name, refuse)


@pytest.mark.parametrize("op", list(OPS))
def test_binary_ops_against_jax(vectors, op, monkeypatch):
    (ja, jb), (ta, tb) = vectors
    no_host_merges(monkeypatch)
    for (jx, jy), (tx, ty) in (((ja, jb), (ta, tb)), ((jb, ja), (tb, ta))):
        jr = getattr(jx, OPS[op])(jy)
        tr = getattr(tx, OPS[op])(ty)
        assert_same_state(jr, tr)
        np.testing.assert_array_equal(tr.indices(), jr.indices())
    # the classes the pairs were drawn for
    tr = getattr(ta, OPS[op])(tb)
    cls = dict(zip(tr._struct.nb.tolist(), tr._struct.cls.tolist()))
    assert cls[6] == C.CLS_BIT and cls[7] == C.CLS_GAP
    want4 = {"and": None, "or": C.CLS_FULL, "xor": C.CLS_FULL,
             "sub": C.CLS_GAP}[op]
    want5 = {"and": C.CLS_GAP, "or": C.CLS_GAP, "xor": None,
             "sub": None}[op]
    assert cls.get(4) == want4 and cls.get(5) == want5


@pytest.mark.parametrize("op", list(OPS))
def test_result_store_equals_gap_binary_op(vectors, op):
    """The rows K1 writes for the small GAP x GAP pairs, re-encoded, give
    exactly the run-domain merge's store and masks."""
    _, (ta, tb) = vectors
    both = np.intersect1d(ta._struct.nb[ta._struct.cls == C.CLS_GAP],
                          tb._struct.nb[tb._struct.cls == C.CLS_GAP])
    _, sa = ta._struct.lookup(both)
    _, sb = tb._struct.lookup(both)
    small = (ta._gaps.n_runs()[sa] + tb._gaps.n_runs()[sb]
             <= tbv._GAP_MERGE_MAX_RUNS)
    assert small.sum() == 7 and (~small).sum() == 1
    none, no = np.full(small.sum(), -1), np.zeros(small.sum(), bool)
    a_desc, b_desc = tbv.descriptor_pair(
        (ta._pool, none, no, ta._gaps, sa[small]),
        (tb._pool, none, no, tb._gaps, sb[small]))
    out, _ = ck.binary_op_digest(op, a_desc, b_desc)
    cap = int((ta._gaps.n_runs()[sa] + tb._gaps.n_runs()[sb])[small].sum())
    got = compress_rows(out, cap)
    want = tgs.gap_binary_op(op, ta._gaps, sa[small], tb._gaps, sb[small])
    for key in ("ends", "offs", "first"):
        np.testing.assert_array_equal(getattr(got[0], key),
                                      getattr(want[0], key))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_distance_operation_against_jax(vectors, monkeypatch):
    (ja, jb), (ta, tb) = vectors
    no_host_merges(monkeypatch)
    wa, wb = ta.to_words().ravel(), tb.to_words().ravel()
    oracle = {"count_and": wa & wb, "count_xor": wa ^ wb,
              "count_or": wa | wb, "count_sub_ab": wa & ~wb,
              "count_sub_ba": wb & ~wa, "count_a": wa, "count_b": wb}
    for x, y, jx, jy, flip in ((ta, tb, ja, jb, False),
                               (tb, ta, jb, ja, True)):
        got = tbm.distance_operation(x, y, METRICS)
        assert got == jbm.distance_operation(jx, jy, METRICS)
        for m in METRICS:
            mm = {"count_sub_ab": "count_sub_ba", "count_sub_ba":
                  "count_sub_ab", "count_a": "count_b",
                  "count_b": "count_a"}.get(m, m) if flip else m
            assert got[m] == int(np.bitwise_count(oracle[mm]).sum()), m
    assert tbm.count_and(ta, tb) == jbm.count_and(ja, jb)


def test_gap_only_pairs_reach_k2(vectors, monkeypatch):
    """A pair of GAP x GAP / FULL / ZERO blocks is counted by K2 (one call)
    with its GAP sides as aux rows."""
    _, (ta, tb) = vectors
    seen = []
    real = ck.count_metrics_total

    def spy(metrics, a_desc, b_desc, per_block=False):
        seen.append((a_desc[3].shape[0], b_desc[3].shape[0]))
        return real(metrics, a_desc, b_desc, per_block)

    monkeypatch.setattr(ck, "count_metrics_total", spy)
    tbm.distance_operation(ta, tb, METRICS)
    assert seen == [(int((ta._struct.cls == C.CLS_GAP).sum()),
                     int((tb._struct.cls == C.CLS_GAP).sum()))]


# ---------------------------------------------------------------------------
# one gap_expand launch per operand pair
# ---------------------------------------------------------------------------
def _pair_stores(case):
    """Two stores and the blocks a pair expansion selects from each:
    ``both`` (repeats, every edge row), ``a_empty`` / ``b_empty`` (one
    side selects nothing), ``above_top_level`` (blocks of more runs than
    the default top GAP level's 1280: 1281, 3000 and 65536)."""
    rng = np.random.default_rng(31)
    a = edge_rows(rng)
    b = np.stack([run_row(rng, int(n)) for n in rng.integers(1, 1280, 9)]
                 + [run_row(rng, 1280), run_row(rng, 1, 1)])
    if case == "above_top_level":
        b = np.stack([run_row(rng, 1281), run_row(rng, 3000),
                      np.full(2048, 0x55555555, np.uint32), b[0]])
    sa, sb = GapStore.from_dense(a), GapStore.from_dense(b)
    ia = np.asarray([8, 0, 3, 3, 1, 7, len(a) - 1])
    ib = np.arange(len(b))[::-1]
    if case == "a_empty":
        ia = ia[:0]
    if case == "b_empty":
        ib = ib[:0]
    return (a, sa, ia), (b, sb, ib)


@pytest.mark.parametrize("case", ["both", "a_empty", "b_empty",
                                  "above_top_level"])
def test_gap_expand_pair_equals_two_expansions(case):
    """The pair form's plain route: a's rows, then b's, equal to two
    single expansions, to ``GapStore.to_dense`` of the port and of the
    JAX package, and to the words the stores were built from."""
    from bitmagic_tpu.core.gapstore import GapStore as JaxGapStore
    (wa, sa, ia), (wb, sb, ib) = _pair_stores(case)
    if case == "above_top_level":
        assert np.diff(sb.offs)[:3].min() > 1280
    sel = torch.from_numpy(np.concatenate([ia, ib]).astype(np.int32))
    got = ck.gap_expand_pair(sa.device_arrays("cpu") if ia.size else None,
                             sb.device_arrays("cpu") if ib.size else None,
                             sel, ia.size)
    assert got.shape == (ia.size + ib.size, 2048) and got.dtype == torch.int32
    singles = [ck.gap_expand(*s.device_arrays("cpu"),
                             torch.from_numpy(i.astype(np.int32)))
               for s, i in ((sa, ia), (sb, ib))]
    assert torch.equal(got, torch.cat(singles))
    host = blockops.to_host_words(got)
    want = np.concatenate([wa[ia], wb[ib]])
    np.testing.assert_array_equal(host, want)
    jax_rows = [np.asarray(JaxGapStore(s.ends.copy(), s.offs.copy(),
                                       s.first.copy()).to_dense(i))
                .reshape(-1, 2048) for s, i in ((sa, ia), (sb, ib))]
    np.testing.assert_array_equal(host, np.concatenate(jax_rows))


@pytest.mark.parametrize("case", ["both", "a_empty", "b_empty",
                                  "above_top_level"])
def test_gap_expand_many_equals_single_expansions(case):
    """The many-store form's plain route (the aggregator's operands): the
    pair case's two stores and a's again, one after another, equal to
    single expansions, to the words the stores were built from and to the
    JAX package's ``GapStore.to_dense``."""
    from bitmagic_tpu.core.gapstore import GapStore as JaxGapStore
    (wa, sa, ia), (wb, sb, ib) = _pair_stores(case)
    stores = [(wa, sa, ia), (wb, sb, ib), (wa, sa, ia[::-1][:3])]
    got = ck.gap_expand_many([s.device_arrays("cpu") for _, s, _ in stores],
                             [i for _, _, i in stores])
    k = sum(i.size for _, _, i in stores)
    assert got.shape == (k, 2048) and got.dtype == torch.int32
    singles = [ck.gap_expand(*s.device_arrays("cpu"),
                             torch.from_numpy(i.astype(np.int32)))
               for _, s, i in stores]
    assert torch.equal(got, torch.cat(singles))
    host = blockops.to_host_words(got)
    np.testing.assert_array_equal(
        host, np.concatenate([w[i] for w, _, i in stores]))
    jax_rows = [np.asarray(JaxGapStore(s.ends.copy(), s.offs.copy(),
                                       s.first.copy()).to_dense(i))
                .reshape(-1, 2048) for _, s, i in stores if i.size]
    np.testing.assert_array_equal(host, np.concatenate(jax_rows))


def _counting_expansions(monkeypatch):
    calls = {"gap_expand": 0, "gap_expand_pair": 0}
    for name in calls:
        real = getattr(ck, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(ck, name, spy)
    return calls


@pytest.mark.parametrize("sides", ["both", "a_only", "b_only", "neither"])
def test_descriptor_pair_expands_in_one_call(vectors, sides, monkeypatch):
    """``operand_args_pair`` gives each operand the rows of its own
    ``operand_args`` with one pair expansion, whichever side holds D-GAP
    blocks; its aux halves are one tensor's."""
    from bitmagic_tpu_torch.core import blocks as tblocks
    _, (ta, tb) = vectors
    nb = np.union1d(ta._struct.nb, tb._struct.nb)
    pick = {"both": nb, "a_only": np.asarray([9, 16]),
            "b_only": np.asarray([11, 15]), "neither": np.asarray([0, 40])}
    blocks = pick[sides]
    want = [blockops.gather_rows(*tblocks.operand_args(v, blocks))
            for v in (ta, tb)]
    calls = _counting_expansions(monkeypatch)
    da, db = tblocks.operand_args_pair(ta, tb, blocks)
    assert calls == {"gap_expand": 0, "gap_expand_pair": 1}
    for d, w in zip((da, db), want):
        assert torch.equal(blockops.gather_rows(*d), w)
    ka, kb = da[3].shape[0], db[3].shape[0]
    assert (ka > 0) == (sides in ("both", "a_only"))
    assert (kb > 0) == (sides in ("both", "b_only"))
    if ka and kb:
        assert db[3].data_ptr() == da[3].data_ptr() + ka * 8192


def test_cell1_step_expands_in_seven_calls(monkeypatch):
    """One step of bvsetalgebra_rank_select (bench_torch.py, cut to 24
    blocks) makes seven expansions: a pair each in count_and, the four
    operations and distance_operation, and A's alone in shift_right."""
    import bench_torch as bt
    name = "bvsetalgebra_rank_select"
    w, cfg = bt.load_workload(name)
    sizes = dict(cfg["sizes"], blocks_per_vector=24,
                 bits_per_vector=24 * bt.BLOCK_BITS,
                 row_bytes_per_vector=24 * bt.ROW, select_queries=1000,
                 rank_queries=1000)
    cell = bt.TRAFFIC[w["traffic"]](7, sizes)
    cell.build(torch.device("cpu"))
    assert all((v._struct.cls == C.CLS_GAP).any() for v in (cell.a, cell.b))
    calls = _counting_expansions(monkeypatch)
    answers = cell.step(bt.Step(torch.device("cpu")))
    assert calls == {"gap_expand_pair": 6, "gap_expand": 1}
    bt.check_answers("cut cell 1", answers, cell.oracle())
