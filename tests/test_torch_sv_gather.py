"""SparseVector.gather and bulk import of the PyTorch port against the JAX
package, on the CPU: the plain versions of kernels sv_gather and
sv_transpose (``ops/blockops.py``) and the routes through them.

Both packages build each column from the same numpy values (seeded); the
columns hold every block kind in their planes: BIT rows, D-GAP blocks
after ``optimize()``, FULL blocks, FULL runs (32 blocks or more), absent
planes, and NULL planes that are BIT (some rows NULL) or FULL (none).
The gather, its dense forms and the float / string containers' gathers
must equal the JAX package's, as must the plain transpose against the JAX
package's ``_transpose_kernel`` and ``from_array``'s planes, also after
each kind of mutation between gathers.  Tolerance: exact equality
(integer and bit-pattern results).
"""
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.sv.sparse_vector import SparseVector as JSV
from bitmagic_tpu.sv.sparse_vector import _transpose_kernel
from bitmagic_tpu_torch.core.bitvector import BitVector
from bitmagic_tpu_torch.core.blocks import Structure
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from bitmagic_tpu_torch.sv import sparse_vector as tsv_mod
from test_torch_scanner import assert_same_sv

torch.set_num_threads(1)

BPB = 65536
N = 2 * BPB + 4321                 # three blocks, the last one partial
TSV = tbm.SparseVector
DTYPES = [np.uint32, np.int32, np.uint64, np.int64]
KINDS = ["bit", "gap", "full", "absent"]
NULLS = ["none", "some", "all_assigned"]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def column_values(kind, dtype, n=N, seed=0):
    """Values of one column kind: ``bit`` random over the dtype's range
    (its edges included), ``gap`` mostly 0 (D-GAP planes after optimize)
    beside one dense block, ``full`` a bit set on every row of the first
    two blocks (FULL blocks after optimize), ``absent`` only bits 0, 7 and
    30 (the other planes absent)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if kind == "bit":
        v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        v[:4] = [info.min, info.max, 0, -1 if info.min else 1]
    elif kind == "gap":
        v = np.zeros(n, dtype)
        hit = rng.random(n) < 0.002
        v[hit] = rng.integers(1, 1 << 20, int(hit.sum()))
        v[BPB:2 * BPB] = rng.integers(0, 1 << 20, BPB)
    elif kind == "full":
        v = rng.integers(0, 1 << 12, n).astype(dtype) | dtype(1 << 3)
        v[2 * BPB:] = rng.integers(0, 1 << 12, n - 2 * BPB)
    else:
        bits = np.asarray([1, 1 << 7, 1 << 30], np.int64)
        v = (bits * rng.integers(0, 2, (n, 3))).sum(axis=1).astype(dtype)
    return v


def build(values, nulls="none", optimize=True, seed=1):
    """The same column in both packages: (JAX column, port column);
    ``nulls``: not nullable, 5 % of the rows past the first block NULL,
    or nullable with every row assigned."""
    kw = {}
    if nulls == "some":             # none in the first block
        kw["null_mask"] = np.random.default_rng(seed).random(
            values.size) < 0.05
        kw["null_mask"][:BPB] = False
    elif nulls == "all_assigned":
        kw["nullable"] = True
    j = JSV.from_array(values, **kw)
    t = TSV.from_array(values, device="cpu", **kw)
    if optimize:
        j.optimize()
        t.optimize()
    return j, t


def query_ids(n, seed=2, k=3000):
    """Unsorted ids with repeats, a block past the end, and the edges."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n + BPB, k)
    return np.concatenate([ids, ids[:50], [0, n - 1, n, n + 1, 1 << 40]])


def same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def kinds_of(t):
    """The block kinds of the port column's value planes and NULL plane."""
    out = set()
    for p in t.planes + [t.null_plane]:
        if p is None:
            out.add("absent")
            continue
        out.update({1: "full", 2: "bit", 3: "gap"}[c]
                   for c in np.unique(p._struct.cls))
        if p._struct.has_runs:
            out.add("runs")
    return out


# ---------------------------------------------------------------------------
# gather, decode, to_numpy, get against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_gather_vs_jax(kind, dtype):
    nulls = NULLS[(KINDS.index(kind) + DTYPES.index(dtype)) % 3]
    j, t = build(column_values(kind, dtype), nulls)
    assert kind in kinds_of(t)
    ids = query_ids(N)
    same(t.gather(ids), j.gather(ids))


@pytest.mark.parametrize("nulls", NULLS)
def test_gather_null_planes(nulls):
    j, t = build(column_values("bit", np.uint32), nulls)
    if nulls == "some":
        assert (t.null_plane._struct.cls == 2).any()
    elif nulls == "all_assigned":
        assert (t.null_plane._struct.cls == 1).any()
    ids = query_ids(N, seed=3)
    same(t.gather(ids), j.gather(ids))


@pytest.fixture(scope="module")
def run_pair():
    """A 34-block nullable column, every row assigned: bit 5 of every
    value set, so after optimize plane 5 and the NULL plane hold FULL
    runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbm.config, "device", "cpu")
        n = 34 * BPB + 1000
        rng = np.random.default_rng(4)
        v = (rng.integers(0, 4, n) | 32).astype(np.uint32)
        return build(v, "all_assigned") + (n,)


def test_gather_full_runs(run_pair):
    j, t, n = run_pair
    assert t.planes[5]._struct.has_runs and t.null_plane._struct.has_runs
    ids = query_ids(n, seed=5)
    same(t.gather(ids), j.gather(ids))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_decode_to_numpy_get(dtype):
    j, t = build(column_values("gap", dtype, seed=6), "some")
    same(t.to_numpy(), j.to_numpy())
    same(t.decode(BPB - 100, 300), j.decode(BPB - 100, 300))
    for i in (0, 5, BPB - 1, BPB, N - 1, N + 10):
        got, want = t.get(i), j.get(i)
        assert type(got) is type(want) and got == want, i
    assert t.at(N - 1) == j.at(N - 1)


@pytest.mark.parametrize("ids", [[], [7], [3, 3, 3], [N + 5, 2, N - 1, 2],
                                 [1 << 40]], ids=lambda x: str(len(x)))
def test_gather_small_id_sets(ids):
    j, t = build(column_values("bit", np.int32, seed=7), "some")
    ids = np.asarray(ids, np.int64)
    same(t.gather(ids), j.gather(ids))


def test_gather_empty_column():
    for kw in ({}, {"nullable": True}):
        j, t = JSV(np.int64, **kw), TSV(np.int64, device="cpu", **kw)
        same(t.gather([0, 5, 1 << 20]), j.gather([0, 5, 1 << 20]))


# ---------------------------------------------------------------------------
# the other containers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_gather(dtype):
    rng = np.random.default_rng(8)
    v = (rng.standard_normal(N) * 1e3).astype(dtype)
    v[:6] = [0.0, -0.0, np.inf, -np.inf, 1.5, -1.5]
    j = jbm.FloatSparseVector.from_array(v, nullable=True)
    t = tbm.FloatSparseVector.from_array(v, nullable=True, device="cpu")
    for c in (j, t):
        c.set_null(9)
        c.optimize()
    ids = query_ids(N, seed=9)
    got, want = t.gather(ids), np.asarray(j.gather(ids))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_str_gather():
    rng = np.random.default_rng(10)
    words = ["", "a", "NGC %07d" % 12, "abcdefghijklmnop", "zz"]
    strs = [words[k] if k < 5 else "id%06d" % k
            for k in rng.integers(0, 5000, 3000)]
    j = jbm.StrSparseVector.from_strings(strs, nullable=True)
    t = tbm.StrSparseVector.from_strings(strs, nullable=True, device="cpu")
    for c in (j, t):
        c.set_null(4)
    ids = query_ids(len(strs), seed=11, k=500)
    assert t.gather(ids) == j.gather(ids)


# ---------------------------------------------------------------------------
# the transpose: plain version against the JAX program, from_array's planes
# ---------------------------------------------------------------------------
def _transpose_vs_jax(n, n_slices, width, seed):
    """The plain transpose of n values of ``width`` bytes (below 2 **
    n_slices) against the JAX package's ``_transpose_kernel``."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**64, n, dtype=np.uint64)
    if n_slices < 64:
        u &= np.uint64((1 << n_slices) - 1)
    n_words = -(-n // 32)
    pad = np.zeros(n_words * 32, np.uint64)
    pad[:n] = u
    want = np.asarray(_transpose_kernel(
        (pad & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (pad >> np.uint64(32)).astype(np.uint32), n_slices, n_words))
    vals = (u.astype(np.uint32).view(np.int32) if width == 4
            else u.view(np.int64))
    got = ck.sv_transpose(torch.from_numpy(vals), n_slices)
    np.testing.assert_array_equal(blockops.to_host_words(got), want)


@pytest.mark.parametrize("n_slices", [1, 7, 20, 31, 32, 33, 50, 64])
def test_transpose_plain_vs_jax(n_slices):
    # no multiple of 32
    _transpose_vs_jax(32 * 37 + 13, n_slices, 4 if n_slices <= 32 else 8,
                      n_slices)


@pytest.mark.parametrize("n", [1, 31, 33, 1023, 1025])
@pytest.mark.parametrize("n_slices,width", [(1, 4), (20, 4), (32, 4), (1, 8),
                                            (20, 8), (32, 8), (33, 8),
                                            (64, 8)])
def test_transpose_plain_vs_jax_tails(n, n_slices, width):
    """The kernel's ragged tails (n short of a word and of a warp's 1024
    values) and both value widths: 8-byte values at every slice count,
    their slices 32-63 from the high words."""
    _transpose_vs_jax(n, n_slices, width, 1000 * n + n_slices)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_from_array_planes_vs_jax(dtype):
    v = column_values("bit", dtype, n=BPB + 777, seed=12)
    j, t = build(v, "some", optimize=False)
    assert_same_sv(j, t)
    for c in (j, t):                # an aligned import over existing planes
        c.import_values(v[::-1][:4000], offset=32 * 100)
    assert_same_sv(j, t)


# ---------------------------------------------------------------------------
# the route: no host lookup, and a plane table rebuilt after each mutation
# ---------------------------------------------------------------------------
def test_gather_makes_no_lookup(monkeypatch, run_pair):
    cols = [build(column_values(k, np.int64, seed=13), "some")
            for k in ("gap", "full")] + [run_pair[:2]]
    ids = query_ids(N, seed=14)
    want = [j.gather(ids) for j, _ in cols]

    def refuse(*a, **k):
        raise AssertionError("a host block lookup on the gather route")

    monkeypatch.setattr(Structure, "lookup", refuse)
    monkeypatch.setattr(BitVector, "get_bits", refuse)
    for (_, t), w in zip(cols, want):
        same(t.gather(ids), w)


def test_gather_cache_invalidation(monkeypatch):
    built = []
    real = tsv_mod.plane_table

    def counting(*a, **k):
        built.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsv_mod, "plane_table", counting)
    j, t = build(column_values("bit", np.int32, seed=15), "some",
                 optimize=False)
    ids = query_ids(N, seed=16)
    rng = np.random.default_rng(17)
    same(t.gather(ids), j.gather(ids))
    steps = [
        ("none", lambda c, v: None),
        ("set", lambda c, v: [c.set(int(i), -77) for i in ids[:20]]),
        ("set_null", lambda c, v: [c.set_null(int(i)) for i in ids[20:40]]),
        ("import_back", lambda c, v: c.import_back(v)),
        ("optimize", lambda c, v: c.optimize()),
        ("clear_range", lambda c, v: c.clear_range(100, BPB + 50)),
        ("clear_range_null", lambda c, v: c.clear_range(5, 900, True)),
        ("resize", lambda c, v: c.resize(N - 300)),
        ("import_values", lambda c, v: c.import_values(v, offset=32 * 7)),
        ("clear", lambda c, v: c.clear()),
    ]
    for name, step in steps:
        before = len(built)
        vals = rng.integers(-9, 9, 5000).astype(np.int32)
        old = t._plane_table()
        for c in (j, t):
            step(c, vals)
        same(t.gather(ids), j.gather(ids))
        rebuilt = len(built) - before
        assert rebuilt == (0 if name == "none" else 1), name
        # the block directory is rebuilt with the table, and is current
        table = t._plane_table()
        assert (table.dir is old.dir) == (name == "none"), name
        planes = [(s, p) for s, p in enumerate(t.planes) if p is not None]
        planes.append((-1, t.null_plane))
        fresh = real([(s, p._struct, p._pool, p._gaps) for s, p in planes],
                     "cpu")
        assert torch.equal(table.bps, fresh.bps), name
        assert torch.equal(table.dir, fresh.dir), name
        same(t.gather(ids), j.gather(ids))
        assert len(built) - before == rebuilt, f"{name}: table not kept"


# ---------------------------------------------------------------------------
# the plane table's block directory (core/blocks.plane_directory): entry
# for entry what the per-plane searches of the plain version give
# ---------------------------------------------------------------------------
def directory_columns(name):
    """The port column of one directory case."""
    if name == "empty":
        return TSV(np.int64, device="cpu")
    if name == "empty_nullable":
        return TSV(np.int64, nullable=True, device="cpu")
    if name == "runs":              # FULL runs beside absent planes
        n = 34 * BPB + 1000
        v = (np.random.default_rng(4).integers(0, 4, n) | 32).astype(
            np.uint32)
        return build(v, "all_assigned")[1]
    if name == "planes65":
        t = build(column_values("bit", np.int64, seed=30), "some")[1]
        assert len([p for p in t.planes if p is not None]) == 64
        return t
    kind, dtype = name.split("-")
    nulls = "some" if kind in ("bit", "gap") else "all_assigned"
    return build(column_values(kind, np.dtype(dtype).type, seed=31),
                 nulls)[1]


@pytest.mark.parametrize("name", ["bit-uint32", "bit-int64", "gap-uint32",
                                  "gap-int64", "full-uint32", "full-int64",
                                  "absent-uint32", "absent-int64", "runs",
                                  "planes65", "empty", "empty_nullable"])
def test_block_directory_matches_plane_searches(name):
    t = directory_columns(name)
    table = t._plane_table()
    P = table.meta.shape[0]
    bps, d = table.bps.numpy(), table.dir.numpy()
    assert d.shape == (bps.size + 1, P)
    assert (np.diff(bps) > 0).all()
    # each row's first block (row 0: one before the first breakpoint),
    # every breakpoint's neighbours and blocks past the column
    rng = np.random.default_rng(32)
    top = int(bps[-1]) + 3 if bps.size else 4
    first = np.concatenate([[bps[0] - 1 if bps.size else -1], bps])
    probe = np.concatenate([first, bps - 1, bps + 1, [top, 1 << 31],
                            rng.integers(-2, top, 300)])
    rows = np.searchsorted(bps, probe, side="right")
    blk = torch.from_numpy(probe.astype(np.int64))
    for p in range(P):
        np.testing.assert_array_equal(
            d[rows, p], blockops.plane_entries(table, p, blk).numpy(),
            err_msg=f"plane {p}")
    # a BIT or D-GAP entry's interval is one block
    single = np.diff(np.append(bps, bps[-1] + 1 if bps.size else 0))
    held = (d[1:] >= 0) | ((d[1:] <= -2) & (d[1:] != blockops.DIR_ZERO))
    if bps.size:
        assert (single[held.any(axis=1)] == 1).all()
    assert table.bit_rows == int((d >= 0).any(axis=1).sum())
    kinds = {int(c) for c in np.unique(d)}
    if name == "runs":
        assert -1 in kinds and blockops.DIR_ZERO in kinds
    if name.startswith("gap"):
        assert any(k <= -2 and k != blockops.DIR_ZERO for k in kinds)


def _lookup(nb, ent, runs, blocks):
    """The per-plane search the descent's codes replace (the first
    sv_descent kernel's lookup): an entry's code, else DIR_RUN inside a
    FULL run, else DIR_ZERO."""
    out = []
    for b in blocks:
        i = np.searchsorted(nb, b)
        if i < nb.size and nb[i] == b:
            out.append(int(ent[i]))
            continue
        j = np.searchsorted(runs[:, 0], b, side="right") - 1
        out.append(blockops.DIR_RUN if j >= 0 and b < runs[j, 1]
                   else blockops.DIR_ZERO)
    return np.asarray(out, np.int64)


def _with_entries_beside_runs(name):
    """directory_columns' column, or for ``entries_beside_runs`` config
    4b-like values whose plane 7 and NULL plane hold a FULL entry (block
    1) beside a FULL run (blocks 3-35) and BIT blocks."""
    if name != "entries_beside_runs":
        return directory_columns(name)
    t = build(column_values("bit", np.uint32, n=37 * BPB + 99, seed=40),
              "some")[1]
    idx = np.concatenate([b * BPB + np.arange(0, BPB, 7) for b in (0, 2, 36)])
    for s in ("plane", "null"):
        v = BitVector.from_indices(idx, t.size, device="cpu")
        v.invert()
        if s == "plane":
            t.planes[7] = v
        else:
            t.null_plane = v
    return t


@pytest.mark.parametrize("name", ["bit-uint32", "gap-int64", "full-uint32",
                                  "absent-int64", "runs", "planes65",
                                  "empty_nullable", "entries_beside_runs"])
def test_descent_codes_match_plane_searches(name):
    """``blocks.descent_codes`` (the host directory, one search for every
    plane) gives each walked block the code the per-plane searches give:
    ``plane_entries``' directory code, with DIR_RUN where a block lies
    inside a FULL run and is no entry (a FULL entry stays -1), and the
    first kernel's lookup of the plane's ids, entries and runs; the
    universe's column (its own FULL entries, runs, BIT and D-GAP blocks)
    likewise.  The steps' rows may come in any order."""
    from bitmagic_tpu_torch.core.blocks import descent_codes, entry_codes
    from bitmagic_tpu_torch.sv.scanner import _universe
    t = _with_entries_beside_runs(name)
    table = t._plane_table()
    P = table.meta.shape[0]
    unis = [_universe(t)] + [p for p in t.planes if p is not None][:2]
    edges = [table.host_bps] + [
        np.concatenate([u._struct.nb, u._struct.runs.ravel()]) for u in unis]
    pts = np.concatenate(edges + [np.arange(0, 40)])
    blocks = np.unique(np.concatenate([pts - 1, pts, pts + 1]))
    blocks = blocks[blocks >= 0]
    rows = list(range(P))[::-1]
    seen = set()
    for uni in unis:
        codes = descent_codes(table, rows, uni._struct, blocks)
        assert codes.shape == (blocks.size, P + 1)
        blk = torch.from_numpy(blocks)
        for i, p in enumerate(rows):
            o, n, ro, rn = (int(x) for x in table.meta[p, :4])
            nb = table.nb[o:o + n].numpy()
            want = blockops.plane_entries(table, p, blk).numpy()
            want = np.where((want == -1) & ~np.isin(blocks, nb),
                            blockops.DIR_RUN, want)
            np.testing.assert_array_equal(codes[:, i], want,
                                          err_msg=f"plane {p}")
            np.testing.assert_array_equal(
                codes[:, i], _lookup(nb, table.ent[o:o + n].numpy(),
                                     table.runs[ro:ro + rn].numpy(),
                                     blocks), err_msg=f"plane {p}")
        ust = uni._struct
        np.testing.assert_array_equal(
            codes[:, -1], _lookup(ust.nb, entry_codes(ust),
                                  ust.runs.reshape(-1, 2), blocks))
        seen.update(int(c) for c in np.unique(codes))
    if name in ("runs", "entries_beside_runs"):
        assert {blockops.DIR_RUN, blockops.DIR_ZERO} <= seen
    if name == "entries_beside_runs":
        assert -1 in seen
    if name.startswith("gap"):
        assert any(c <= -2 and c not in (blockops.DIR_ZERO,
                                         blockops.DIR_RUN) for c in seen)
    # the device directory the gathers read keeps -1 for both
    assert blockops.DIR_RUN not in np.unique(table.dir.numpy())


@pytest.mark.parametrize("name", ["bit-int64", "runs", "empty_nullable"])
def test_gather_routes_agree_on_cpu(name):
    """On CPU tensors the wrapper is the plain version and launches
    nothing; the route a card would take is direct up to
    GATHER_DIRECT_MAX ids and below GATHER_ROW_IDS ids per BIT directory
    row, else grouped."""
    t = directory_columns(name)
    table = t._plane_table()
    ids = torch.from_numpy(query_ids(max(t.size, 1), seed=33))
    ck.reset_launches()
    assert torch.equal(ck.sv_gather(ids, table),
                       blockops.sv_gather(ids, table))
    assert not any(ck.launches.values())
    rows = max(table.bit_rows, 1)
    many = max(ck.GATHER_DIRECT_MAX + 1, ck.GATHER_ROW_IDS * rows)
    assert not ck._gather_grouped(ck.GATHER_DIRECT_MAX, table)
    assert ck._gather_grouped(many, table)
    if many > ck.GATHER_DIRECT_MAX + 1:     # too few ids per BIT row
        assert not ck._gather_grouped(many - 1, table)
