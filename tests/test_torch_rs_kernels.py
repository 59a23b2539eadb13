"""The plain versions of the rank/select kernels (``ops/select.py``:
``select_flat``, ``rank_in_rows``, ``rank_flat``, ``rs_select``,
``rs_rank``; ``ops/csrc/rs_select.cu`` on the card) against the JAX
package on the CPU: ``select_flat`` and ``_rank_in_rows`` directly, the
batches through ``RSIndex`` against the JAX ``RSIndex`` on vectors that
mix every block kind, and the sharded flat forms against the JAX
``ShardedRSIndex`` on an 8-shard mesh.  Inputs come from a numpy seed.
Tolerance: exact (bit-equal int64).  The kernels themselves are held
against these on the card in tests/test_torch_kernels.py (marker
``cuda``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.core import rs_index as jrs
from bitmagic_tpu.ops import select as jsel
from bitmagic_tpu.parallel import mesh as jmesh_mod
from bitmagic_tpu.parallel import sharded as jsh
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.ops import cuda_kernels as ck
from bitmagic_tpu_torch.ops import select as tsel
from bitmagic_tpu_torch.parallel import Mesh
from bitmagic_tpu_torch.parallel import sharded as tsh
from chip_smoke import rs_edge_vector

torch.set_num_threads(1)

BPB = C.BITS_PER_BLOCK
N_QUERIES = 4096                  # one query shape: one JAX compile each


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def _pool_words(kind, rng):
    """uint32 pool rows: random words with a zero row, a full row and zero
    waves; a sparse pool (most waves empty, so the wave prefix repeats);
    one row of a few bits."""
    if kind == "random":
        p = rng.integers(0, 2**32, (6, 2048), dtype=np.uint64).astype(
            np.uint32)
        p[1] = 0
        p[2] = 0xFFFFFFFF
        p[3, :1024] = 0
        p[3, ::64] = 0
        return p
    n = 5 if kind == "sparse" else 1
    bits = np.zeros(n * BPB, np.uint8)
    bits[rng.integers(0, n * BPB, 40 if kind == "sparse" else 7)] = 1
    bits[[0, n * BPB - 1]] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32).reshape(
        n, 2048)


def _fill(edges, rng, lo, hi):
    """``edges`` then random draws in [lo, hi) up to N_QUERIES."""
    edges = np.asarray(edges, np.int64)[:N_QUERIES]
    return np.concatenate([edges, rng.integers(lo, hi,
                                               N_QUERIES - edges.size)])


def _torch_pool(words):
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("kind", ["random", "sparse", "one_row"])
def test_select_flat_matches_jax(kind):
    rng = np.random.default_rng(7)
    words = _pool_words(kind, rng)
    tp = _torch_pool(words)
    gwc = tsel.global_wave_prefix(tp)
    jgwc = jsel.global_wave_prefix(jnp.asarray(words))
    np.testing.assert_array_equal(gwc.numpy(), np.asarray(jgwc))
    total = int(gwc[-1])
    # every wave's first and last rank: ties where waves are empty
    g = gwc.numpy().astype(np.int64)
    ranks = _fill(np.clip(np.concatenate([[1, total], g, g + 1]), 1, total),
                  rng, 1, total + 1).astype(np.int32)
    want = np.asarray(jsel.select_flat(jnp.asarray(words), jgwc,
                                       jnp.asarray(ranks))).astype(np.int64)
    got = tsel.select_flat(tp, gwc, torch.from_numpy(ranks))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ck.select_flat(tp, gwc, torch.from_numpy(ranks),
                       tsel.flat_tables(tp, gwc)).numpy(), want)
    ones = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little"))
    np.testing.assert_array_equal(want, ones[ranks - 1])


@pytest.mark.parametrize("kind", ["random", "sparse", "one_row"])
def test_rank_in_rows_and_rank_flat_match_jax(kind):
    rng = np.random.default_rng(8)
    words = _pool_words(kind, rng)
    tp = _torch_pool(words)
    gwc = tsel.global_wave_prefix(tp)
    n = words.shape[0]
    edge_bits = [0, 31, 32, 1023, 1024, 1025, 65535]
    bits = _fill(edge_bits * n, rng, 0, BPB).astype(np.int32)
    slots = _fill(np.repeat(np.arange(n), len(edge_bits)), rng, 0,
                  n).astype(np.int32)
    want = np.asarray(jrs._rank_in_rows(jnp.asarray(words),
                                        jnp.asarray(slots),
                                        jnp.asarray(bits)))
    got = tsel.rank_in_rows(tp, gwc, torch.from_numpy(slots),
                            torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), want)
    # the flat form counts every row before the slot too
    rel = slots.astype(np.int64) * BPB + bits
    before = np.concatenate([[0], np.cumsum(np.bitwise_count(words).sum(
        1, dtype=np.int64))])[slots]
    flat = tsel.flat_rank_tables(gwc, tsel.wave_sectors(tp))
    for fn in (tsel.rank_flat,
               lambda *a: ck.rank_flat(*a, flat)):
        got = fn(tp, gwc, torch.from_numpy(rel))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), before + want)


def _counting(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(ck, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ck, name, wrapped)
    return calls


@pytest.mark.parametrize("variant", ["all", "no_gap", "no_bit"])
def test_rs_batches_match_jax(variant, monkeypatch):
    """The port's RSIndex batches (rs_select / rs_rank, one call each)
    against the JAX RSIndex and the word image on ``rs_edge_vector``
    (chip_smoke.py) with and without its D-GAP or BIT blocks."""
    parts = {"gap": variant != "no_gap", "bit": variant != "no_bit"}
    jv = rs_edge_vector(jbm, **parts)
    tv = rs_edge_vector(tbm, "cpu", **parts)
    st = tv._struct
    kinds = set(st.cls.tolist())
    assert C.CLS_FULL in kinds and st.has_runs
    assert (C.CLS_GAP in kinds) == (variant != "no_gap")
    assert (C.CLS_BIT in kinds) == (variant != "no_bit")
    if variant == "all":
        assert np.diff(tv._gaps.offs).max() == BPB
    words = tv.to_words().ravel()
    np.testing.assert_array_equal(words, np.asarray(jv.to_words()).ravel())
    jr, tr = jv.build_rs_index(), tv.build_rs_index()
    np.testing.assert_array_equal(tr.cum, jr.cum)
    if variant != "no_bit":
        # the SUB's empty BIT block is a zero-count segment: cum repeats
        assert (np.diff(tr.cum) == 0).any()
    total, size = tr.count(), tv.size
    rng = np.random.default_rng(12)
    cum = tr.cum
    ranks = np.concatenate([
        [-1, 0, 1, total, total + 1, -(2**40), 2**40], cum, cum + 1,
        np.concatenate([[0], cum[:-1]]) + 1,
        rng.integers(1, total + 1, 1500)])
    borders = np.arange(49) * BPB
    gap_nb = st.nb[st.cls == C.CLS_GAP]
    ids = np.concatenate([
        [0, size - 1, size, 47 * BPB + 5, BPB + 3, 6 * BPB, 9 * BPB - 1,
         44 * BPB, -1, -(2**40)], borders - 1, borders, borders + 1,
        gap_nb * BPB, gap_nb * BPB + BPB - 1, 4 * BPB + np.arange(64),
        45 * BPB + np.arange(0, BPB, 4099), rng.integers(0, size, 1500)])
    calls = _counting(monkeypatch, ("rs_select", "rs_rank"))
    got_s, got_r = tr.select_batch(ranks), tr.rank_batch(ids)
    assert calls == {"rs_select": 1, "rs_rank": 1}
    want_s, want_r = jr.select_batch(ranks), jr.rank_batch(ids)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_r, want_r)
    # and against the word image
    ones = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little"))
    ok = (ranks >= 1) & (ranks <= total)
    np.testing.assert_array_equal(got_s[ok], ones[ranks[ok] - 1])
    assert (got_s[~ok] == -1).all()
    np.testing.assert_array_equal(
        got_r, np.searchsorted(ones, np.clip(ids, -1, None), side="right"))
    # one-query calls, a 2-D batch, an empty batch
    for x in (1, total, int(ranks[-1])):
        assert tr.select(x) == jr.select(x) == tv.select(x)
    for i in (0, size - 1, int(ids[-1])):
        assert tr.rank(i) == jr.rank(i)
    np.testing.assert_array_equal(tr.select_batch(ranks[:6].reshape(2, 3)),
                                  got_s[:6].reshape(2, 3))
    assert tr.rank_batch(np.zeros(0, np.int64)).shape == (0,)
    # the vector's select goes through its cached index: one call each
    assert calls == {"rs_select": 8, "rs_rank": 5}


def test_rs_wrappers_take_the_plain_route_on_cpu_tensors():
    """On CPU tensors each wrapper is its plain version; a tensor on
    another device kind is refused before any launch."""
    tv = rs_edge_vector(tbm, "cpu")
    tr = tv.build_rs_index()
    runs = tr._gap_runs()
    q = torch.arange(-2, tr.count() + 3, 997, dtype=torch.int64)
    args = (tr._seg, tr._cum0_dev, runs, tr.pool, tr.gwc)
    assert torch.equal(ck.rs_select(*args, q, tr.total, tr._select_tables()),
                       tsel.rs_select(*args, q, tr.total))
    ids = torch.arange(-5, tv.size + 5, 1009, dtype=torch.int64)
    args = (tr._seg, tr._nb_dev, runs, tr.pool, tr.gwc)
    assert torch.equal(ck.rs_rank(*args, ids, tr._rank_tables()),
                       tsel.rs_rank(*args, ids))
    with pytest.raises(ValueError, match="devices"):
        ck.rs_rank(*args, ids.to("meta"), tr._rank_tables())


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_mod.make_mesh(8)


def test_sharded_flat_forms_match_jax(jmesh, monkeypatch):
    """ShardedRSIndex's select and rank (select_flat / rank_flat per shard
    with queries) against the JAX ShardedRSIndex; one wrapper call per
    shard that holds queries."""
    rng = np.random.default_rng(13)
    size = 16 * BPB + 333
    ids = np.unique(np.concatenate([
        rng.integers(0, 4 * BPB, 30_000),       # shards 0-1 dense
        rng.integers(9 * BPB, 10 * BPB, 50),    # shard 4 sparse
        [size - 1]])).astype(np.int64)
    jv = jsh.ShardedBitVector.from_indices(ids, size, jmesh)
    tv = tsh.ShardedBitVector.from_indices(ids, size, Mesh(["cpu"] * 8))
    ji, ti = jv.build_rs_index(), tv.build_rs_index()
    np.testing.assert_array_equal(ti.shard_totals, ji.shard_totals)
    n = ids.size
    ranks = np.concatenate([[-1, 0, 1, n, n + 1], rng.integers(1, n + 1,
                                                                2000)])
    qs = np.concatenate([[0, size - 1, size, -1, 5 * BPB, 9 * BPB],
                         ids[:100], rng.integers(0, size, 2000)])
    calls = _counting(monkeypatch, ("select_flat", "rank_flat"))
    got_s, got_r = ti.select_batch(ranks), ti.rank_batch(qs)
    shards_s = np.unique(np.searchsorted(ti.cum, ranks[(ranks >= 1)
                                                       & (ranks <= n)]))
    shards_r = np.unique(np.clip(qs[qs >= 0], 0, 16 * BPB - 1)
                         // ti.shard_span)
    assert calls == {"select_flat": shards_s.size,
                     "rank_flat": shards_r.size}
    np.testing.assert_array_equal(got_s, ji.select_batch(ranks))
    np.testing.assert_array_equal(got_r, ji.rank_batch(qs))
    ok = (ranks >= 1) & (ranks <= n)
    np.testing.assert_array_equal(got_s[ok], ids[ranks[ok] - 1])


# ---------------------------------------------------------------------------
# rs_select's tables (ops/select.select_tables): each equals what it is
# built from, and the kernel's sampled searches over them (mirrored here
# in numpy, index for index) give what the plain version's searches give
# ---------------------------------------------------------------------------
def _index_of(kind):
    """A port RSIndex on the CPU: the edge vector (every class, a
    65536-run D-GAP block), cell 1's mix at 48 blocks, or one class."""
    import chip_smoke as cs
    rng = np.random.default_rng(21)
    if kind == "edge":
        return rs_edge_vector(tbm, "cpu").build_rs_index()
    if kind == "mix":
        words = rng.integers(0, 2**32, (48, 2048), dtype=np.uint64).astype(
            np.uint32)
        words[rng.permutation(48)[:24]] = cs.run_rows(rng, 24)
        bv = tbm.BitVector.from_words(words.ravel(), device="cpu")
        bv.optimize()
        return bv.build_rs_index()
    return cs.class_vectors(tbm, rng, "cpu")[kind].build_rs_index()


def _sampled_gap_run(cum1, gcs, lo, hi, rem):
    """rs_select.cu gap_run: the block's runs [lo, hi) through the sample
    gcs (every 8th run's ones count) and an 8-run window."""
    jlo, jhi = lo >> 3, hi >> 3
    J = jlo + int(np.searchsorted(gcs[jlo:jhi], rem))
    s0, s1 = max(lo, 8 * J), (8 * J + 7 if J < jhi else hi)
    r = s0 + int(np.searchsorted(cum1[s0:s1], rem))
    return min(r, cum1.size - 1)


def _sector_select(words, wsp_e, rem):
    """rs_select.cu wave_select on one wave's 32 words."""
    e = [0, wsp_e & 1023, (wsp_e >> 10) & 1023, wsp_e >> 20]
    k = sum(int(x < rem) for x in e[1:])
    before = e[k]
    for j in range(8):
        x = int(words[8 * k + j])
        after = before + bin(x).count("1")
        if after >= rem or j == 7:
            break
        before = after
    r, pos, cur = rem - before, 0, x           # bitops.word_select32
    for width in (16, 8, 4, 2, 1):
        low = cur & ((1 << width) - 1)
        c = bin(low).count("1")
        if r > c:
            r, pos, cur = r - c, pos + width, cur >> width
        else:
            cur = low
    return (8 * k + j) * 32 + pos


@pytest.mark.parametrize("kind", ["edge", "mix", "full_only", "gap_only",
                                  "bit_only"])
def test_select_tables_match_their_searches(kind):
    rs = _index_of(kind)
    seg = rs._seg.numpy()
    ec = rs._gap_runs()[0].numpy()
    key_cum = rs._gap_runs()[2].numpy()
    gwc = rs.gwc.numpy().astype(np.int64)
    pool = rs.pool.numpy().view(np.uint32)
    t = rs._select_tables()
    sel, gws, gcs, wsp = (x.numpy() for x in (t.sel, t.gws, t.gcs, t.wsp))
    flat = tsel.flat_tables(rs.pool, rs.gwc)
    np.testing.assert_array_equal(flat.gws.numpy(), gws)
    np.testing.assert_array_equal(flat.wsp.numpy(), wsp)
    assert flat.sel is None and flat.gcs is None
    a = (sel[:, 1] & 0xFFFFFFFF).astype(np.int64)
    a = np.where(a >= 2**31, a - 2**32, a)
    b = sel[:, 1] >> 32
    cls = seg[:, tsel.CLS]
    bit = (cls == C.CLS_BIT) & (gwc.size > 0)
    gap = (cls == C.CLS_GAP) & (ec.shape[0] > 0)
    np.testing.assert_array_equal(
        sel[:, 0], np.where(bit, seg[:, tsel.BITOFF], seg[:, tsel.BASE]))
    np.testing.assert_array_equal(a[bit], seg[bit, tsel.SLOT])
    np.testing.assert_array_equal(b[bit], seg[bit, tsel.BEFORE])
    assert (a[~bit & ~gap] == -1).all()
    first = seg[gap, tsel.GOFFS]
    np.testing.assert_array_equal(-2 - a[gap], first)
    np.testing.assert_array_equal(b[gap], np.append(first[1:], ec.shape[0])
                                  if first.size else b[gap])
    np.testing.assert_array_equal(gws, gwc[7::8])
    np.testing.assert_array_equal(gcs, ec[7::8, 1])
    pc = np.bitwise_count(pool.reshape(-1, 4, 8)).sum(-1)
    e = np.cumsum(pc[:, :3], 1)
    np.testing.assert_array_equal(wsp, e[:, 0] | e[:, 1] << 10
                                  | e[:, 2] << 20)
    # every segment's rank range, through the kernel's sampled searches
    rng = np.random.default_rng(22)
    cum0 = rs._cum0_dev.numpy()
    ranks = np.unique(np.concatenate([cum0[1:], cum0[1:] - 1,
                                      rng.integers(1, rs.total + 1, 3000)]))
    ranks = ranks[(ranks >= 1) & (ranks <= rs.total)]
    got = []
    for x in ranks:
        s = int(np.searchsorted(cum0, x))
        rem = int(x - cum0[s - 1])
        pos = int(sel[s, 0]) + rem - 1
        if a[s] <= -2:
            r = _sampled_gap_run(ec[:, 1], gcs, -2 - a[s], b[s], rem)
            assert r == min(int(np.searchsorted(
                key_cum, seg[s, tsel.GKEYS] + rem)), ec.shape[0] - 1)
            pos += int(ec[r, 0] - ec[r, 1]) + 1
        elif a[s] >= 0:
            w0, g = 64 * int(a[s]), rem + int(b[s])
            J = int((gws[8 * int(a[s]):8 * int(a[s]) + 8] < g).sum())
            assert J < 8
            c = int((gwc[w0 + 8 * J:w0 + 8 * J + 8] < g).sum())
            wave = w0 + 8 * J + c
            assert wave == int(np.searchsorted(gwc, g))
            prev = int(gwc[wave - 1]) if wave else 0
            pos += 1 - rem + wave * 1024 + _sector_select(
                pool.reshape(-1, 32)[wave], int(wsp[wave]), g - prev)
        got.append(pos)
    q = torch.from_numpy(ranks.astype(np.int64))
    np.testing.assert_array_equal(got, tsel.rs_select(
        rs._seg, rs._cum0_dev, rs._gap_runs(), rs.pool, rs.gwc, q,
        rs.total).numpy())


@pytest.mark.parametrize("shape", ["cell", "big_cum0", "many_waves",
                                   "many_runs"])
def test_select_staging_plan(shape):
    """The staging plan of an rs_select launch over an index of m + 1
    segment rows, W waves and R D-GAP runs: cum0 whole, or as a sample
    that fits RS_CUM_SAMPLE_BYTES when it is past the budget; then sel,
    gws and gcs, in that order, each staged while the budget lasts; and
    select_flat's gws, whole or as the sample that fits the budget."""
    m1, W, R = {"cell": (1537, 768 * 64, 196_412),
                "big_cum0": (30_001, 768 * 64, 196_412),
                "many_waves": (1537, 8000 * 64, 196_412),
                "many_runs": (1537, 768 * 64, 2_000_000)}[shape]
    budget = ck.RS_STAGE_BYTES
    stride, s_sel, s_gws, s_gcs, used = ck._select_staging(m1, W, R)
    cum = ck._r16(8 * -(-m1 // stride))
    assert (stride == 1) == (ck._r16(8 * m1) <= budget)
    assert cum <= budget and (stride == 1 or cum <= ck.RS_CUM_SAMPLE_BYTES)
    sizes = [ck._r16(16 * m1), ck._r16(4 * W // 8), ck._r16(4 * (R // 8))]
    assert used == cum + sum(f * n for f, n in zip(
        (s_sel, s_gws, s_gcs), sizes))
    assert used <= budget
    left = budget - cum
    for flag, n in zip((s_sel, s_gws, s_gcs), sizes):
        assert flag == int(n <= left)
        left -= n * flag
    expect = {"cell": (1, 1, 1, 1), "big_cum0": (8, 0, 1, 1),
              "many_waves": (1, 1, 0, 1), "many_runs": (1, 1, 1, 0)}[shape]
    assert (stride, s_sel, s_gws, s_gcs) == expect
    f_stride, f_bytes = ck._flat_staging(W // 8)
    assert f_bytes <= budget and (f_stride == 1) == (4 * W // 8 <= budget)


# ---------------------------------------------------------------------------
# rs_rank's tables (ops/select.rank_tables): each record decodes to the
# segment row it is built from, and the kernel's steps over them (mirrored
# here in numpy, index for index, under the launch's staging plan) give
# what the plain version and the JAX package give
# ---------------------------------------------------------------------------
def _rank_index(kind):
    """A port RSIndex on the CPU: ``_index_of``'s kinds; ``cell``: cell
    1's shape (1536 blocks, 768 of them D-GAP of 1-256 runs); ``big_nb``:
    30,000 one-bit D-GAP blocks (nb past the staging budget, so staged as
    a sample; no pool); ``many_runs``: seven 65536-run D-GAP blocks and
    a BIT one (the run-end samples past the budget)."""
    import chip_smoke as cs
    rng = np.random.default_rng(23)
    if kind == "cell":
        bv, _ = cs.rs_cell_vector(tbm, rng, "cpu")
        return bv.build_rs_index()
    if kind == "big_nb":
        n = 30_000
        ids = np.arange(n) * BPB + rng.integers(0, BPB, n)
        return tbm.BitVector.from_indices(ids, n * BPB, strategy=C.BM_GAP,
                                          device="cpu").build_rs_index()
    if kind == "many_runs":
        levels = tbm.config.gap_levels
        try:
            tbm.config.gap_levels = (128, 256, 512, BPB + 8)
            words = np.full((8, 2048), 0x55555555, np.uint32)
            words[3] = rng.integers(0, 2**32, 2048, dtype=np.uint64)
            bv = tbm.BitVector.from_words(words.ravel(), device="cpu")
            bv.optimize()
        finally:
            tbm.config.gap_levels = levels
        return bv.build_rs_index()
    return _index_of(kind)


def _pool_rank(pool, wrk, wave, bit):
    """rs_select.cu pool_rank: the wave's wrk entry (the ones before it,
    its sector prefix) and the masked popcount of the one sector holding
    the bit."""
    k, wi = bit >> 8, (bit >> 5) & 7
    sec = pool.reshape(-1, 32)[wave, 8 * k:8 * k + 8].astype(np.int64)
    before, e = (int(x) for x in wrk[wave])
    n = 0 if k == 0 else (e >> (10 * (k - 1))) & 1023
    n += int(np.bitwise_count(sec[:wi]).sum())
    n += bin(int(sec[wi]) & ((2 << (bit & 31)) - 1)).count("1")
    return before + n


def _kernel_rs_rank(rs, ids):
    """rs_select.cu rs_rank_kernel over ``rs``'s tables, step for step,
    with the staging plan its launch gets (cuda_kernels._rank_staging)."""
    t = rs._rank_tables()
    nb = rs._nb_dev.numpy()
    ec = rs._gap_runs()[0].numpy().astype(np.int64)
    rec, ges = t.rec.numpy(), t.ges.numpy().astype(np.int64)
    pool = rs.pool.numpy().view(np.uint32)
    wrk = t.wrk.numpy()
    m, R = nb.size, ec.shape[0]
    S, _, stage_ges, _ = ck._rank_staging(m, R)
    smp = nb[np.minimum(np.arange(-(-m // S)) * S + S - 1, m - 1)]
    out = []
    for q in ids.tolist():
        blk, bit = q >> 16, q & 0xFFFF
        J = int(np.searchsorted(smp, blk, side="right"))
        if J == smp.size:
            s = m
        else:
            lo, hi = J * S, min(J * S + S - 1, m - 1)
            s = lo + int(np.searchsorted(nb[lo:hi], blk, side="right"))
        x, word = int(rec[s, 0]), int(rec[s, 1])
        route, pay = word & 3, word >> 2
        b0 = int(nb[s - 1]) if s else 0
        if s == 0 or (blk >= pay if route == tsel.ROUTE_FULL
                      else blk != b0):
            out.append(int(rec[s + 1, 0]))
            continue
        if route == tsel.ROUTE_FULL:
            x += q - (b0 << 16) + 1
        elif route == tsel.ROUTE_GAP:
            lo = pay & 0x7FFFFFFF
            hi = lo + ((pay >> 31) & 0x1FFFF)
            if stage_ges:
                jlo, jhi = lo >> 3, hi >> 3
                w = 8 * (jlo + int(np.searchsorted(ges[jlo:jhi], bit)))
                s0, s1 = max(w, lo), min(w + 8, hi)
                r = s0 + int((ec[s0:s1, 0] < bit).sum())
                assert r < s1
            else:
                r = lo + int(np.searchsorted(ec[lo:hi - 1, 0], bit))
            end, ones = ec[r]
            x += ones - (end - bit) if ((pay >> 48) ^ (r - lo)) & 1 else ones
        elif route == tsel.ROUTE_BIT:
            wave = (pay & (2**30 - 1)) * 64 + (bit >> 10)
            x += _pool_rank(pool, wrk, wave, bit & 1023) - (pay >> 30)
        out.append(x)
    return np.asarray(out, np.int64)


def _rank_ids(rs, rng, n=3000):
    """Ids at every segment's edges, in zero blocks, past the vector, at
    2^31 + bits and negative, then uniform ones."""
    nb = rs.nb.astype(np.int64)
    end = nb + rs.span
    size = rs.size
    edges = np.concatenate([nb << 16, (nb << 16) + 1, (end << 16) - 1,
                            end << 16, [-1, -(2**40), 0, size - 1, size,
                                        size + 5, 2**31 + 7, 2**40]])
    return np.concatenate([edges, rng.integers(0, size, n)]).astype(np.int64)


@pytest.mark.parametrize("kind", ["edge", "mix", "cell", "big_nb",
                                  "many_runs", "full_only", "gap_only",
                                  "bit_only"])
def test_rank_tables_match_their_searches(kind):
    rs = _rank_index(kind)
    seg = rs._seg.numpy()
    ec = rs._gap_runs()[0].numpy()
    t = rs._rank_tables()
    assert t is rs._rank_tables()
    rec, ges = t.rec.numpy(), t.ges.numpy()
    assert rec.shape == (seg.shape[0] + 1, 2)
    gwc = rs.gwc.numpy()
    np.testing.assert_array_equal(t.wrk.numpy(), np.stack(
        [np.concatenate([[0], gwc[:-1]])[:gwc.size],
         rs._select_tables().wsp.numpy()], 1).reshape(-1, 2))
    np.testing.assert_array_equal(rec[:-1, 0], seg[:, tsel.CB])
    assert rec[-1, 0] == rs.total and rec[-1, 1] == 0 and rec[0, 1] == 0
    np.testing.assert_array_equal(ges, ec[7::8, 0])
    route, pay = rec[:-1, 1] & 3, rec[:-1, 1] >> 2
    cls = seg[:, tsel.CLS]
    np.testing.assert_array_equal(
        route, np.select([cls == C.CLS_FULL, (cls == C.CLS_BIT)
                          & (rs.gwc.numel() > 0), (cls == C.CLS_GAP)
                          & (ec.shape[0] > 0)], [1, 2, 3], 0))
    full, bit, gap = route == 1, route == 2, route == 3
    np.testing.assert_array_equal(pay[full], seg[full, tsel.END])
    np.testing.assert_array_equal(pay[bit] & (2**30 - 1),
                                  seg[bit, tsel.SLOT])
    np.testing.assert_array_equal(pay[bit] >> 30, seg[bit, tsel.BEFORE])
    first = pay[gap] & 0x7FFFFFFF
    np.testing.assert_array_equal(first, seg[gap, tsel.GOFFS])
    n_runs = (pay[gap] >> 31) & 0x1FFFF
    np.testing.assert_array_equal(first + n_runs, np.append(
        first[1:], ec.shape[0]) if first.size else first)
    np.testing.assert_array_equal((pay[gap] >> 48) & 1,
                                  (ec[first, 1] > 0).astype(np.int64)
                                  if first.size else first)
    assert ((pay[~(full | bit | gap)]) == 0).all()
    # the kernel's steps, under its staging plan, against the plain version
    rng = np.random.default_rng(24)
    ids = _rank_ids(rs, rng)
    want = tsel.rs_rank(rs._seg, rs._nb_dev, rs._gap_runs(), rs.pool,
                        rs.gwc, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(_kernel_rs_rank(rs, ids), want)
    np.testing.assert_array_equal(rs.rank_batch(ids), want)
    plan = ck._rank_staging(len(rs.nb), ec.shape[0])
    if kind == "big_nb":
        assert plan[0] > 1 and rs.pool.shape[0] == 0
    if kind == "many_runs":
        assert plan[2] == 0 and ec.shape[0] > 400_000


@pytest.mark.parametrize("variant", ["all", "no_gap", "no_bit"])
def test_rank_kernel_steps_match_jax(variant):
    """The rs_rank kernel's steps (mirrored) on rs_edge_vector, and the
    rank_flat kernel's over its pool, against the JAX RSIndex and
    _rank_in_rows."""
    parts = {"gap": variant != "no_gap", "bit": variant != "no_bit"}
    jr = rs_edge_vector(jbm, **parts).build_rs_index()
    tr = rs_edge_vector(tbm, "cpu", **parts).build_rs_index()
    rng = np.random.default_rng(25)
    ids = _rank_ids(tr, rng)
    np.testing.assert_array_equal(_kernel_rs_rank(tr, ids),
                                  jr.rank_batch(ids))
    if not tr.pool.shape[0]:
        return
    words = tr.pool.numpy().view(np.uint32)
    slots = rng.integers(0, words.shape[0], 2000).astype(np.int32)
    bits = rng.integers(0, BPB, 2000).astype(np.int32)
    want = np.asarray(jrs._rank_in_rows(jnp.asarray(words),
                                        jnp.asarray(slots),
                                        jnp.asarray(bits)))
    before = np.concatenate([[0], np.cumsum(np.bitwise_count(words).sum(
        1, dtype=np.int64))])[slots]
    wrk = tsel.flat_rank_tables(tr.gwc, tsel.wave_sectors(tr.pool)).wrk
    rel = slots.astype(np.int64) * BPB + bits
    got = [_pool_rank(words, wrk.numpy(), r >> 10, r & 1023) for r in rel]
    np.testing.assert_array_equal(got, before + want)


def test_sharded_rank_flat_steps_match_jax(jmesh):
    """The rank_flat kernel's step (mirrored) per shard of an 8-shard
    ShardedRSIndex over its flat tables against the JAX ShardedRSIndex."""
    rng = np.random.default_rng(26)
    size = 16 * BPB + 333
    ids = np.unique(np.concatenate([rng.integers(0, 4 * BPB, 30_000),
                                    rng.integers(9 * BPB, 10 * BPB, 50),
                                    [size - 1]])).astype(np.int64)
    ji = jsh.ShardedBitVector.from_indices(ids, size, jmesh).build_rs_index()
    ti = tsh.ShardedBitVector.from_indices(
        ids, size, Mesh(["cpu"] * 8)).build_rs_index()
    qs = np.concatenate([[0, size - 1, 5 * BPB, 9 * BPB], ids[:100],
                         rng.integers(0, size, 2000)])
    tgt = qs // ti.shard_span
    got = []
    for q, i in zip(qs.tolist(), tgt.tolist()):
        rel = q - i * ti.shard_span
        pool = ti.sbv.shards[i].numpy().view(np.uint32)
        got.append(int(ti.before[i]) + _pool_rank(
            pool, ti.rank_tables(i).wrk.numpy(), rel >> 10, rel & 1023))
    np.testing.assert_array_equal(got, ji.rank_batch(qs))


@pytest.mark.parametrize("shape", ["cell", "wide", "big_nb", "many_runs"])
def test_rank_staging_plan(shape):
    """The staging plan of an rs_rank launch over m segments and R D-GAP
    runs: nb whole, or as a sample that fits RS_CUM_SAMPLE_BYTES when it
    is past the budget; then rec and ges, each staged while the budget
    lasts."""
    m, R = {"cell": (1536, 98_000), "wide": (26_100, 600_000),
            "big_nb": (30_000, 60_000), "many_runs": (8, 458_752)}[shape]
    budget = ck.RS_STAGE_BYTES
    stride, s_rec, s_ges, used = ck._rank_staging(m, R)
    nb = ck._r16(8 * -(-m // stride))
    assert (stride == 1) == (ck._r16(8 * m) <= budget)
    assert stride == 1 or nb <= ck.RS_CUM_SAMPLE_BYTES
    sizes = [ck._r16(16 * (m + 2)), ck._r16(4 * (R // 8))]
    assert used == nb + s_rec * sizes[0] + s_ges * sizes[1] <= budget
    expect = {"cell": (1, 1, 1), "wide": (7, 0, 0), "big_nb": (8, 0, 1),
              "many_runs": (1, 1, 0)}[shape]
    assert (stride, s_rec, s_ges) == expect
