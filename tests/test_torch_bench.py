"""bench_torch.py, the port's benchmark, on the CPU at a cut size.

The three cells' steps run with ``device="cpu"`` (the kernels' plain
versions) on their configurations' draws at a cut size: 24 blocks and
10,000 queries; 8 vectors x 4 blocks, 4 planes x 2 blocks and a
65,536-value column; a 262,144-row column and 4,096 ids.  Their answers
must equal the numpy oracle and the JAX package's entry points on the same
seeded inputs, exactly (integer results).  A tampered answer must make the
oracle check raise; built sizes that differ from the configuration must
raise; the last line must carry bench.py's keys and every metric path
BENCHMARK.json names; without ``device="cpu"`` the twin must raise where
there is no card.  The bytes each hand kernel must move are held against
what the kernels' wrappers were handed in a step.  The trace's breakdown,
kernel rows and per-layer medians are held against synthetic events: on
the card they read real ones.  With JAX in the process the twin reports
nothing; the tests, which import the JAX package for their comparisons,
pass ``allow_jax=True``.
"""
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench_torch as bt
import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu.parallel import mesh as jmesh_mod
from bitmagic_tpu.parallel import sharded as jsh
from bitmagic_tpu.sv.scanner import scanner as jscanner
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch.core.gapstore import GapStore
from bitmagic_tpu_torch.ops import blockops
from bitmagic_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 42
CPU = torch.device("cpu")
SET, SEARCH = "bvsetalgebra_rank_select", "aggregator_scanner_search"
RANGE = "column_range_gather"
CELLS = [SET, SEARCH, RANGE]
ROW, BITS = bt.ROW, bt.BLOCK_BITS


def cut(name) -> dict:
    """The configuration's sizes, cut for the CPU."""
    _, cfg = bt.load_workload(name)
    s = dict(cfg["sizes"])
    if name == SET:
        s.update(blocks_per_vector=24, bits_per_vector=24 * BITS,
                 row_bytes_per_vector=24 * ROW, select_queries=10_000,
                 rank_queries=10_000)
    elif name == RANGE:
        s.update(column_rows=262_144, gather_ids=4_096,
                 value_plane_bytes=20 * 4 * ROW)
    else:
        s.update(aggregator_vectors=8, blocks_per_vector=4,
                 aggregator_row_bytes=8 * 4 * ROW, and_vectors=4,
                 scan_planes=4, scan_blocks=2, scan_bytes=4 * 2 * ROW,
                 column_rows=65_536)
    return s


def traffic(name, sizes=None):
    w, _ = bt.load_workload(name)
    return bt.TRAFFIC[w["traffic"]](SEED, cut(name) if sizes is None
                                    else sizes)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


@pytest.fixture(scope="module")
def stepped():
    """Each cell built on the CPU, one step's answers and the oracle."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbm.config, "device", "cpu")
        for name in CELLS:
            cell = traffic(name)
            cell.build(CPU)
            out[name] = (cell, cell.step(bt.Step(CPU)), cell.oracle())
    return out


@pytest.mark.parametrize("name", CELLS)
def test_answers_equal_the_oracle(stepped, name):
    cell, answers, oracle = stepped[name]
    bt.check_answers("step", answers, oracle)


def test_set_algebra_equals_jax(stepped):
    cell, ans, _ = stepped[SET]
    # the draw mixes dense and D-GAP blocks in both vectors
    for v in ("a", "b"):
        st = cell.structure()[v]
        assert st["gap_blocks"] > 0 and st["bit_blocks"] > 0, st
    ja = jbm.BitVector.from_words(cell.wa)
    jb = jbm.BitVector.from_words(cell.wb)
    ja.optimize()
    jb.optimize()
    assert ans["count_and"] == jbm.count_and(ja, jb)
    for op, dunder in bt.OPS.items():
        r = getattr(ja, dunder)(jb)
        assert ans[op] == r.count(), op
        np.testing.assert_array_equal(
            ans["vectors"][op].to_words().ravel(),
            np.asarray(r.to_words()).ravel(), err_msg=op)
    assert ans["distance"] == jbm.distance_operation(ja, jb,
                                                     list(bt.METRICS))
    rs = ja.build_rs_index()
    np.testing.assert_array_equal(ans["select"],
                                  rs.select_batch(cell.ranks))
    np.testing.assert_array_equal(ans["rank"], rs.rank_batch(cell.ids))
    jc = ja.copy()
    jc.shift_right()
    assert ans["shift_count"] == jc.count()
    np.testing.assert_array_equal(
        ans["vectors"]["shift"].to_words().ravel(),
        np.asarray(jc.to_words()).ravel())


def test_search_equals_jax(stepped):
    cell, ans, _ = stepped[SEARCH]
    h = cell.n_and
    jvecs = [jbm.BitVector.from_words(w.ravel()) for w in cell.stack]
    jr = jbm.Aggregator().combine_and_sub(jvecs[:h], jvecs[h:])
    assert ans["and_sub_count"] == jr.count()
    np.testing.assert_array_equal(
        ans["vectors"]["and_sub"].to_words().ravel(),
        np.asarray(jr.to_words()).ravel())
    jsv = jbm.SparseVector.from_array(cell.vals, nullable=True)
    assert ans["pipeline_counts"] == \
        jscanner.prepare_pipeline(jsv).counts(cell.queries)
    S, nb = cell.planes.shape[:2]
    jscan, _ = jsh.scan_throughput_program(jmesh_mod.make_mesh(1), S, nb)
    value = cell.sizes["scan_value"]
    assert ans["scan_find_eq"] == int(jscan(cell.planes, np.uint32(value)))


def test_range_gather_equals_jax(stepped):
    cell, ans, _ = stepped[RANGE]
    jsv = jbm.SparseVector.from_array(cell.vals, nullable=True)
    jr = jscanner.find_gt(jsv, cell.value)
    assert ans["count"] == jr.count()
    np.testing.assert_array_equal(ans["vectors"]["gt"].indices(),
                                  np.asarray(jr.indices()))
    np.testing.assert_array_equal(ans["gather"], jsv.gather(cell.ids))
    # the cut keeps the configuration's draw: about 64.7 % of rows pass
    assert ans["count"] / cell.sizes["column_rows"] == pytest.approx(
        0.647, abs=0.01)


def _tampered(ans, oracle, key):
    bad = dict(ans, vectors=dict(ans["vectors"]))
    if key in bad["vectors"]:
        # another vector over the oracle's words in place of the result
        bad["vectors"][key] = tbm.BitVector.from_words(
            np.zeros_like(oracle["words"][key]), device="cpu")
    elif isinstance(bad[key], dict):
        bad[key] = dict(bad[key], count_and=bad[key]["count_and"] + 1)
    elif isinstance(bad[key], list):
        bad[key] = [bad[key][0] + 1] + bad[key][1:]
    elif isinstance(bad[key], np.ndarray):
        bad[key] = bad[key].copy()
        bad[key][-1] += 1
    else:
        bad[key] = bad[key] + 1
    return bad


TAMPER = [(SET, k) for k in ("count_and", "and", "or", "xor", "sub",
                             "distance", "select", "rank", "shift_count",
                             "shift")] + \
         [(SET, f"vector {op}") for op in bt.OPS] + \
         [(SEARCH, k) for k in ("and_sub_count", "pipeline_counts",
                                "scan_find_eq", "and_sub")] + \
         [(RANGE, k) for k in ("count", "vector gt", "gather")]


@pytest.mark.parametrize("name,key", TAMPER)
def test_a_tampered_answer_raises(stepped, name, key):
    _, ans, oracle = stepped[name]
    key = key.removeprefix("vector ")
    with pytest.raises(bt.AnswerMismatch, match="differ"):
        bt.check_answers("step", _tampered(ans, oracle, key), oracle)


@pytest.mark.parametrize("name", CELLS)
def test_output_schema(name):
    lines = []
    res = bt.run_cell(name, SEED, device="cpu", sizes=cut(name), warmup=1,
                      steps=3, out=lines.append, allow_jax=True)
    assert json.loads(json.dumps(res)) == res
    for key in ("metric", "value", "unit", "vs_baseline", "configs",
                "metrics", "cell", "seed", "correct", "device", "host"):
        assert key in res, key
    assert res["correct"] is True and res["cell"] == name
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    want = {SET: ({"and_count_gbps", "select_mqps", "step_ms"},
                  {"1_and_count", "1c_shift_r1", "2_select1", "2_rank1"}),
            SEARCH: ({"agg_and_sub_gbps", "scan_pipeline_gsearch_elem_s",
                      "step_ms"},
                     {"3_agg_and_sub", "4_scan_find_eq",
                      "4b_scan_pipeline"}),
            RANGE: ({"find_gt_gelem_s", "gather_mqps", "step_ms"},
                    {"4b_find_gt", "4b_gather"})}[name]
    assert set(res["metrics"]) == want[0]
    assert set(res["configs"]) == want[1]
    for key, m in res["metrics"].items():
        assert m["n"] == 3 and m["value"] > 0, key
        assert m["median_ms"] > 0 and m["p90_ms"] >= m["median_ms"]
    # a rate is the window's work over the sum of the calls' walls
    w, _ = bt.load_workload(name)
    head = res["metrics"][bt.TRAFFIC[w["traffic"]].headline]
    sizes = cut(name)
    work = {SET: lambda: 2 * sizes["row_bytes_per_vector"] / 1e9,
            SEARCH: lambda: sizes["aggregator_row_bytes"] / 1e9,
            RANGE: lambda: sizes["gather_ids"] / 1e6}[name]()
    assert head["value"] == pytest.approx(3 * work / (head["wall_ms"] / 1e3))
    step = res["metrics"]["step_ms"]
    assert step["value"] == pytest.approx(step["window_ms"] / 3)
    assert res["value"] == head["value"] and res["unit"] == head["unit"]
    assert res["vs_baseline"] == res["value"] / res["baseline"]["value"]
    for m in w["metrics"].values():
        assert bt.resolve(res, m["path"]) > 0
    # no device metric from a CPU run
    assert res["idle_share"] == "not measured"
    assert res["layers"] == "not measured"
    assert len(step["mean_ms_by_tenth"]) == 3
    assert res["host"]["python_loop_ms"] > 0
    assert [ln.split(":")[0] for ln in lines] == [
        "host", "setup", "launches per step", "entry points",
        "host after the window"]


def test_a_rate_is_work_over_the_summed_walls():
    r = bt._rate([1.0, 3.0], 2.0, "GB/s")
    assert r["value"] == pytest.approx(2 * 2.0 / 4e-3)
    assert r["wall_ms"] == 4.0 and r["n"] == 2


@pytest.mark.parametrize("name", CELLS)
def test_each_workload_names_its_configuration(name):
    """The workload names a traffic and a run length; its configuration's
    derived sizes agree with the sizes they derive from."""
    w, cfg = bt.load_workload(name)
    assert w["traffic"] in bt.TRAFFIC and w["steps"] >= 100
    assert cfg["seed"] == w["seed"] and len(cfg["source"]) <= 200
    s = cfg["sizes"]
    if name == SET:
        assert s["bits_per_vector"] == s["blocks_per_vector"] * BITS
        assert s["row_bytes_per_vector"] == s["blocks_per_vector"] * ROW
        assert s["distance_metrics"] == len(bt.METRICS)
    elif name == RANGE:
        # half of the value's bits set: the descent takes both branches
        assert s["gt_value"] < 1 << s["column_value_bits"]
        assert bin(s["gt_value"]).count("1") == s["column_value_bits"] // 2
        assert s["value_plane_bytes"] == (s["column_value_bits"]
                                          * -(-s["column_rows"] // BITS)
                                          * ROW)
    else:
        assert s["aggregator_row_bytes"] == (
            s["aggregator_vectors"] * s["blocks_per_vector"] * ROW)
        assert s["scan_bytes"] == s["scan_planes"] * s["scan_blocks"] * ROW
    with pytest.raises(KeyError, match="no workload"):
        bt.load_workload(name + "_x")


@pytest.mark.parametrize("name,key", [(SET, "bits_per_vector"),
                                      (SEARCH, "scan_bytes"),
                                      (RANGE, "value_plane_bytes")])
def test_built_sizes_must_equal_the_configuration(name, key):
    sizes = cut(name)
    sizes[key] += 1
    with pytest.raises(ValueError, match="built sizes differ"):
        bt.run_cell(name, SEED, device="cpu", sizes=sizes, warmup=0,
                    steps=1, out=lambda _: None)


def test_p90_leaves_a_tenth_beyond():
    xs = list(range(100))
    assert bt.p90(xs) == 89 and sum(x > bt.p90(xs) for x in xs) == 10
    assert bt.p90([3.0]) == 3.0


def test_without_a_card_the_twin_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in CELLS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bt.run_cell(name, SEED, sizes=cut(name))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bt.main(["--cell", name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.run_serialization(SEED, blocks=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.run_cell(SET, SEED, device="cuda", sizes=cut(SET))


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would measure it")
    r = subprocess.run([sys.executable, "bench_torch.py", "--cell", SET],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())


def test_serialization_configs_round_trip():
    res = bt.run_serialization(SEED, device="cpu", blocks=16,
                               allow_jax=True)
    assert res["correct"] is True
    assert set(res["configs"]) == {"5_serialize", "5_deserialize",
                                   "5_count_and_on_blob", "5_blob_size",
                                   "5b_gap_corpus"}
    assert res["configs"]["5_serialize"]["n"] == 21
    assert res["configs"]["5b_gap_corpus"]["ser"]["n"] == 11


def test_set_algebra_kernel_bytes(stepped):
    """Every operation reads both operands' 24 rows; K3 reads the dense
    rows of each counted vector."""
    cell, ans, _ = stepped[SET]
    n = 24
    got = cell.kernel_bytes(ans)
    assert got["logical_op_digest"] == 4 * (3 * n * ROW
                                            + 4 * C.BLOCK_WAVES * n)
    assert got["count_op"] == 4 * n * ROW + 8 * 8
    dense = [v.calc_stat()["bit_blocks"] for v in ans["vectors"].values()]
    assert len(dense) == 5 and 0 < min(dense) and max(dense) <= n
    assert got["block_counts"] == sum(dense) * ROW + 5 * 8


def test_search_kernel_bytes(stepped):
    """B4 reads a column's operands until its accumulator is zero: all 8
    of 4 random AND and 4 SUB rows at the cut (256 bits survive the ANDs
    in a block), one row per column when the first operand is empty."""
    cell, ans, _ = stepped[SEARCH]
    got = cell.kernel_bytes(ans)
    assert cell.b4_rows == 8 * 4
    assert got["agg_and_sub"] == (32 + 4) * ROW
    assert got["pipeline_counts"] == 21 * 1 * ROW + 8 * 256
    assert got["scan_eq"] == 5 * 2 * ROW
    res = ans["vectors"]["and_sub"].calc_stat()["bit_blocks"]
    assert got["block_counts"] == (res + 2) * ROW + 16
    other = traffic(SEARCH)
    other.stack[0] = 0
    assert other.and_sub_rows() == 4


def test_the_draw_holds_no_empty_or_full_block():
    """An empty block would leave the operations' plans and the kernels'
    byte counts; the draw refuses one."""
    sizes = dict(cut(SET), density=0.0)
    with pytest.raises(ValueError, match="empty or a full block"):
        traffic(SET, sizes)


def _ev(name, start, end, dev):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


def test_breakdown_of_a_trace():
    """Busy is the union of device events inside the step span; each idle
    gap is named by the host span it overlaps most."""
    H, D = "host", "device"
    events = [_ev("bench:step", 0, 100, H), _ev("bench:a", 0, 40, H),
              _ev("bench:b", 40, 100, H), _ev("bench:a", 5, 30, D),
              _ev("k1", 10, 20, D), _ev("k1", 15, 25, D),
              _ev("k2", 60, 70, D), _ev("memcpy", 95, 110, D)]
    got = bt.breakdown(events, D)
    assert got["traced_wall_ms"] == 0.1
    assert got["busy_ms"] == pytest.approx((15 + 10 + 5) / 1e3)
    assert got["top_device_ops"][0] == {"name": "k1", "ms": 0.02,
                                        "count": 2}
    assert [(g["span"], round(g["ms"] * 1e3)) for g in got["idle_gaps"]] \
        == [("b", 35), ("b", 25), ("a", 10)]
    assert got["spans"]["a"]["busy_ms"] == pytest.approx(0.015)
    assert got["kernel_ms"] == {}
    assert bt.breakdown([_ev("bench:step", 0, 1, H)], D) is None


def test_kernel_rows_from_a_trace():
    """Each hand kernel's device events, matched by its device function's
    name, give its ms per launch; the row carries the launches counted in
    the timed steps and the bytes it must move."""
    H, D = "host", "device"
    events = [_ev("bench:step", 0, 100, H),
              _ev("void agg_sweep_kernel<2>(bm::Operand const*)", 10, 26, D),
              _ev("block_counts_kernel", 30, 38, D),
              _ev("block_counts_kernel", 50, 60, D),
              _ev("pipeline_regs_kernel", 70, 90, D)]
    got = bt.breakdown(events, D)
    assert got["kernel_ms"] == {"agg_and_sub": [0.016],
                                "block_counts": [0.008, 0.010],
                                "pipeline_counts": [0.02]}
    rows = bt.kernel_rows(got["kernel_ms"],
                          {"agg_and_sub": 1, "block_counts": 2,
                           "pipeline_counts": 1, "scan_eq": 1},
                          {"agg_and_sub": 16e6, "block_counts": 1,
                           "pipeline_counts": 2, "scan_eq": 3})
    by = {r["kernel"]: r for r in rows}
    assert list(by) == ["K3", "B4", "B5", "B6"]
    assert by["K3"]["traced_launches"] == 2
    assert by["K3"]["ms_per_step"] == pytest.approx(0.018)
    assert by["B4"]["gb_per_s"] == pytest.approx(16e6 / 0.016 / 1e6)
    # counted in the steps, missing from the trace: no rate is made up
    assert by["B6"]["traced_launches"] == 0
    assert by["B6"]["gb_per_s"] == "not measured"


def _device_functions() -> dict:
    """Every ``__global__`` function of the port's CUDA sources, by name:
    its source."""
    out = {}
    csrc = os.path.join(ROOT, bt.CSRC)
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                for fn in re.findall(
                        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                        r"\s+)?(\w+)\s*\(", fh.read()):
                    out[fn] = bt.CSRC + f
    return out


def test_every_launch_counter_names_its_device_functions():
    """Each launch counter of the wrappers has a KERNELS entry; its names
    match device functions of its own source only, and every device
    function is matched by exactly one counter's names, so a trace event
    is never given to two kernels."""
    assert set(ck.launches) == set(bt.KERNELS)
    fns = _device_functions()
    assert len(fns) == 21, fns
    owner = {}
    for counter, (_, source, names) in bt.KERNELS.items():
        assert os.path.exists(os.path.join(ROOT, source)), source
        for name in names:
            hits = [fn for fn in fns if name in fn]
            assert hits, (counter, name)
            for fn in hits:
                assert fns[fn] == source, (counter, name, fn)
                assert owner.setdefault(fn, counter) == counter, \
                    (fn, owner[fn], counter)
    assert set(owner) == set(fns)


def test_the_set_algebra_path_needs_the_gap_kernels():
    cell = bt.TRAFFIC["set_algebra_rank_select"]
    step = {k: 1 for k in cell.needs}
    bt.check_launches(SET, cell.needs, step)
    for k in ("gap_expand", "gap_compress"):
        with pytest.raises(RuntimeError, match=f"launched \\['{k}'\\]"):
            bt.check_launches(SET, cell.needs, dict(step, **{k: 0}))


def test_gap_kernel_bytes(stepped, monkeypatch):
    """The GAP kernels' bytes per step, counted from the built stores,
    equal what one step hands the wrappers: gap_expand's selected blocks
    with their run ends in the stores' mirrors (a pair of stores per
    launch but in shift_right), gap_compress's rows and the run ends of
    the stores it returns (7 and 4 calls)."""
    cell, ans, _ = stepped[SET]
    seen = {"gap_expand": [], "gap_compress": []}
    expand, pair = ck.gap_expand, ck.gap_expand_pair
    compress = ck.gap_compress

    def expand_bytes(offs, sel):
        o = offs.to(torch.int64)
        s = sel.to(torch.int64)
        return 4 * int((o[s + 1] - o[s]).sum()) + (9 + ROW) * s.numel()

    def rec_expand(ends, offs, first, sel):
        seen["gap_expand"].append(expand_bytes(offs, sel))
        return expand(ends, offs, first, sel)

    def rec_pair(mirror_a, mirror_b, sel, k_a):
        seen["gap_expand"].append(sum(
            expand_bytes(m[1], s) for m, s in ((mirror_a, sel[:k_a]),
                                               (mirror_b, sel[k_a:]))
            if s.numel()))
        return pair(mirror_a, mirror_b, sel, k_a)

    def rec_compress(rows, cap):
        out = compress(rows, cap)
        n = rows.shape[0]
        ends, offs, _ = blockops.gap_unpack(out, n)
        assert int(offs[-1]) == ends.numel() <= cap
        seen["gap_compress"].append(n * ROW + 4 * ends.numel()
                                    + 4 * (n + 1) + n)
        return out

    monkeypatch.setattr(ck, "gap_expand", rec_expand)
    monkeypatch.setattr(ck, "gap_expand_pair", rec_pair)
    monkeypatch.setattr(ck, "gap_compress", rec_compress)
    again = cell.step(bt.Step(CPU))
    assert len(seen["gap_expand"]) == 7
    assert len(seen["gap_compress"]) == len(bt.OPS)
    got = cell.kernel_bytes(again)
    assert got["gap_expand"] == sum(seen["gap_expand"])
    assert got["gap_compress"] == sum(seen["gap_compress"])
    assert got == cell.kernel_bytes(ans)
    # the ends the count makes are the port's own D-GAP encoding's
    both = cell.gap_pairs()
    assert both.size > 0
    rows = ans["vectors"]["and"].to_words().reshape(-1, bt.WORDS)[both]
    np.testing.assert_array_equal(bt.run_ends(rows),
                                  GapStore.from_dense(rows).n_runs())


def _recorded_range_bytes(cell, monkeypatch):
    """The bytes one find_gt with its count hands the sv_descent and K3
    wrappers: each stepped plane's and the universe's BIT rows and D-GAP
    runs read once (counted from the plane tables' entries), the walked
    block ids, gt's rows and digests (and eq's when asked) written once
    and the classes; K3 the result's rows and its total; with the
    number of sv_descent calls and the find_gt's answers."""
    moved = {"sv_descent": 0, "block_counts": 0}
    calls = []
    descent, totals = ck.sv_descent, ck.block_counts_total

    def plane(t, p):
        o, n = (int(x) for x in t.meta[p, :2])
        ent = t.ent[o:o + n]
        runs = int(t.gaps[p][1][-1]) if t.gaps[p] is not None else 0
        return (ROW * int((ent >= 0).sum()) + 4 * runs
                + 9 * int((ent <= -2).sum()))

    def rec(table, utable, blocks, rows, bits, want_eq=True):
        k = blocks.shape[0]
        calls.append(len(rows))
        moved["sv_descent"] += (
            sum(plane(table, r) for r in rows) + plane(utable, 0) + 10 * k
            + (1 + bool(want_eq)) * (ROW + 4 * C.BLOCK_WAVES) * k)
        return descent(table, utable, blocks, rows, bits, want_eq)

    def k3(pool, per_block=False):
        moved["block_counts"] += pool.shape[0] * (ROW + 4 * per_block) + 8
        return totals(pool, per_block)

    with monkeypatch.context() as mp:
        mp.setattr(ck, "sv_descent", rec)
        mp.setattr(ck, "block_counts_total", k3)
        count, r = cell.find_gt_count()
    return moved, calls, {"count": count, "vectors": {"gt": r}}


def test_range_kernel_bytes(stepped, monkeypatch):
    """The descent is one sv_descent launch of 20 steps over the column's
    4 blocks: the 20 value planes' 80 BIT rows read once (the NULL plane's
    4 FULL blocks read nothing), the 4 block ids, gt's 4 rows and digests
    written, 8 bytes of classes.  K3 counts the result's 4 rows.  The count
    from the planes equals what the wrappers are handed."""
    cell, ans, _ = stepped[RANGE]
    assert cell.structure()["null_plane"]["full_blocks"] == 4
    got = cell.kernel_bytes(ans)
    assert got == {"sv_descent": 80 * ROW + 4 * (10 + ROW
                                                 + 4 * C.BLOCK_WAVES),
                   "block_counts": 4 * ROW + 8}
    moved, calls, again = _recorded_range_bytes(cell, monkeypatch)
    assert calls == [20]
    assert moved == got == cell.kernel_bytes(again)


def test_range_kernel_bytes_with_a_partial_block(monkeypatch):
    """A column that ends inside a block, as config 4b's 16M rows do:
    the NULL plane's last block is a BIT row that the descent reads
    beside the planes' rows, which the planes' block states count."""
    sizes = dict(cut(RANGE), column_rows=200_000,
                 value_plane_bytes=20 * 4 * ROW)
    cell = traffic(RANGE, sizes)
    cell.build(CPU)
    st = cell.structure()["null_plane"]
    assert st["full_blocks"] == 3 and st["bit_blocks"] == 1
    moved, calls, ans = _recorded_range_bytes(cell, monkeypatch)
    assert cell.kernel_bytes(ans) == moved and calls == [20]
    assert moved["sv_descent"] == (
        (80 + 1) * ROW + 4 * (10 + ROW + 4 * C.BLOCK_WAVES))


def test_layer_metrics_of_three_traces():
    """Device busy and the hand kernels' device time are medians over the
    traced steps; the host-only time is the untraced window's mean step
    less the busy median, so the profiler's cost stays out of it."""
    H, D = "host", "device"
    traces = []
    for busy, k3 in ((30, 8), (10, 4), (20, 6)):
        events = [_ev("bench:step", 0, 100, H),
                  _ev("block_counts_kernel", 10, 10 + k3, D),
                  _ev("gap_compress_kernel", 40, 42, D),
                  _ev("memcpy", 60, 60 + busy - k3 - 2, D)]
        traces.append(bt.breakdown(events, D))
    got = bt.layer_metrics(traces, 0.075)
    assert set(got) == {"device_busy_ms", "hand_kernels_ms", "host_only_ms"}
    assert got["device_busy_ms"]["value"] == pytest.approx(0.020)
    assert got["device_busy_ms"]["steps"] == pytest.approx(
        [0.030, 0.010, 0.020])
    assert got["hand_kernels_ms"]["value"] == pytest.approx(0.008)
    assert got["host_only_ms"]["value"] == pytest.approx(0.055)
    assert got["host_only_ms"]["step_ms"] == 0.075
    assert all(m["n"] == 3 and m["unit"] == "ms" for m in got.values())
    # gap_compress's one device function is its
    assert traces[0]["kernel_ms"]["gap_compress"] == pytest.approx([0.002])


def test_short_steps_trace_more():
    """Every cell traces an odd number of steps, 21 where a step takes
    well under a second."""
    for name in CELLS:
        w, _ = bt.load_workload(name)
        assert w["traced_steps"] % 2 == 1, name
        assert w["traced_steps"] == (5 if name == RANGE else 21), name


def test_layer_metrics_are_declared_for_every_cell():
    """Each per-layer metric names its layer, unit, direction, the cells
    that report it and, in each cell, the end-to-end metric it should
    move; each cell's entry repeats them with its path and bounds."""
    with open(bt.BENCHMARK) as f:
        bench = json.load(f)
    layers = {"device", "hand kernels", "host planning"}
    decl = bench["layer_metrics"]
    assert set(decl) == {"device_busy_ms", "hand_kernels_ms",
                         "host_only_ms"}
    for key, m in decl.items():
        assert m["layer"] in layers and m["unit"] == "ms"
        assert m["better"] == "lower"
        assert m["path"] == f"layers.{key}.value"
        assert m["workloads"] == [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        for key, m in w["layer_metrics"].items():
            assert m["path"] == decl[key]["path"]
            assert m["layer"] == decl[key]["layer"]
            assert m["moves"] == decl[key]["moves"][w["name"]]
            assert set(m["moves"]) <= set(w["metrics"]), m["moves"]
            assert m["bound_pct"] % 5 == 0 and m["bound_pct"] > 0
            assert m["spread_pct"] >= 0
        for m in w["metrics"].values():
            assert m["bound_pct"] % 5 == 0 and m["bound_pct"] > 0


def _tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_gather_host_split(stepped):
    """tools/gather_host_split.py profiles whole gathers beside the
    untraced gather's wall: the gather runs kernel sv_gather over the
    column's plane table, so it counts no host block lookup inside them;
    no device time off the card."""
    cell, _, _ = stepped[RANGE]
    got = _tool("gather_host_split").split(cell, CPU, rounds=2)
    assert len(got["rounds"]) == 2
    for r in got["rounds"]:
        assert r["lookup_calls"] == 0 and r["lookup_ms"] == 0
        assert r["profiled_gather_ms"] > 0
        assert r["gather_ms"] > 0 and r["device_busy_ms"] is None
    assert "device_busy_ms" not in got["median"]


def test_a_process_with_jax_reports_nothing(monkeypatch):
    """The port is measured without JAX: with jax, jaxlib, flax or the
    JAX package in the process, a cell raises after its window and
    returns no result, and so does the serialization run."""
    alone = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in bt.JAX_MODULES}
    assert "bitmagic_tpu_torch" in alone
    bt.forbid_jax(alone)
    for mod in ("jax", "jaxlib", "flax", "bitmagic_tpu",
                "bitmagic_tpu.core"):
        with pytest.raises(RuntimeError, match="without JAX"):
            bt.forbid_jax(dict(alone, **{mod: SimpleNamespace()}))
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "jax", SimpleNamespace())
        with pytest.raises(RuntimeError, match="without JAX"):
            bt.forbid_jax()
    # this process holds the JAX package
    with pytest.raises(RuntimeError, match="without JAX"):
        bt.run_cell(SET, SEED, device="cpu", sizes=cut(SET), warmup=0,
                    steps=1, out=lambda _: None)
    with pytest.raises(RuntimeError, match="without JAX"):
        bt.run_serialization(SEED, device="cpu", blocks=16)


def test_a_bound_is_twice_the_spread_of_the_middle_runs():
    """tools/bench_torch_turns.py: the spread is the range of all the
    runs (none dropped) over their median; the bound is twice the larger
    of the change's and the parent's spread, rounded up to 5, so no run
    set spreads by more than half its bound."""
    turns = _tool("bench_torch_turns")
    assert turns.spread_pct([100, 2, 3, 4, 1]) == pytest.approx(99 / 3 * 100)
    assert turns.spread_pct([10.0] * 5) == 0
    assert [turns.bound_pct(x) for x in (0, 2.5, 2.6, 3.2, 46.0)] == \
        [5, 5, 10, 10, 95]
    got = turns.bounds_of({"a": {"spread_pct": 3.0},
                           "b": {"spread_pct": 20.0}},
                          {"a": {"spread_pct": 12.0}})
    assert got == {"a": {"spread_pct": 12.0, "bound_pct": 25},
                   "b": {"spread_pct": 20.0, "bound_pct": 40}}
