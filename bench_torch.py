"""bench.py's twin for the PyTorch port: one benchmark cell on one card.

Usage (from the repository root, on a machine with an NVIDIA card):

    python bench_torch.py --cell bvsetalgebra_rank_select [--seed 42]
    python bench_torch.py --cell aggregator_scanner_search [--seed 42]
    python bench_torch.py --cell column_range_gather [--seed 42]
    python bench_torch.py --cell serialization [--seed 42]

A cell is a workload of ``BENCHMARK.json``.  Its entry names the traffic
(the step the cell repeats), the run length and the configuration file in
``bench_cells/`` whose ``sizes`` the cell is drawn and built at; the sizes
of what was built are checked against that file, and every metric path the
entry names must resolve in the result.  ``serialization`` runs bench.py's
configs 5 and 5b on request and is no cell.

A cell draws its data from ``numpy.random.default_rng(seed)`` in bench.py's
order, builds the containers on the card outside the timed window, runs the
untimed and then the timed steps through the port's public entry points
(each call's host wall ended by a device synchronize, the 50 MB L2 evicted
at the start of every step) and times the whole window once: each
entry-point rate is its work over the sum of its walls in the window, the
step time the window's wall over its steps.  It checks the first and the
last timed step's answers against a numpy oracle of the same words and
that the step launched every hand kernel its path needs.  The workload's
``traced_steps`` more steps are traced with ``torch.profiler``: the first
gives device busy, idle share, each hand kernel's device time per launch,
the top device operations and the longest idle gaps, each named by the
entry point the host was in; all of them give the per-layer metrics (the
medians of device busy and of the hand kernels' device time per step, and
the host-only time: the window's mean step less that busy median).  The
last line is one JSON object with bench.py's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``configs``), the cell's end-to-end metrics
and, on the card, its per-layer metrics (``layers``).

Without a card it raises: the CPU is taken only when a caller passes
``device="cpu"`` to ``run_cell`` (the tests do, at cut sizes).  The port
is measured without JAX: a process that has loaded JAX or the JAX package
reports nothing, unless a caller passes ``allow_jax=True`` (the tests,
which compare against it).  A wrong answer, a kernel that did not launch,
or a kernel that fails to build or launch ends the run with a non-zero
exit code.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch import constants as C
from bitmagic_tpu_torch import parallel
from bitmagic_tpu_torch.ops import _build
from bitmagic_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
WORDS = 2048                    # words per block (bench.py:33)
ROW = WORDS * 4                 # bytes per block row
BLOCK_BITS = WORDS * 32
METRICS = ("count_and", "count_xor", "count_or", "count_sub_ab",
           "count_sub_ba", "count_a", "count_b")
OPS = {"and": "__and__", "or": "__or__", "xor": "__xor__", "sub": "__sub__"}
SERIAL_BLOCKS = 512             # configs 5 and 5b (bench.py:315, :381)
L2_EVICT_WORDS = 32 * 2**20     # a 128 MiB memset evicts the 50 MB L2
# modules whose presence in the process voids a measurement of the port
JAX_MODULES = ("jax", "jaxlib", "flax", "bitmagic_tpu")
# the hand kernels by launch counter: (name, source, device functions);
# a trace event is the kernel's when its name holds one of the functions'
# names, and no name may match another kernel's function
CSRC = "bitmagic_tpu_torch/ops/csrc/"
KERNELS = {
    "logical_op_digest": ("K1", CSRC + "logical_op_digest.cu",
                          ("binary_digest_kernel",)),
    "count_op": ("K2", CSRC + "count_op.cu", ("count_metrics_kernel",)),
    "block_counts": ("K3", CSRC + "block_counts.cu",
                     ("block_counts_kernel",)),
    "agg_and_sub": ("B4", CSRC + "agg_sub.cu", ("agg_sweep_kernel",)),
    "pipeline_counts": ("B5", CSRC + "pipeline_counts.cu", ("pipeline_",)),
    "scan_eq": ("B6", CSRC + "scan_eq.cu", ("scan_eq_kernel",)),
    "gap_expand": ("gap_expand", CSRC + "gap_rows.cu",
                   ("gap_expand_kernel",)),
    "gap_compress": ("gap_compress", CSRC + "gap_rows.cu",
                     ("gap_compress_kernel",)),
    "sv_gather": ("sv_gather", CSRC + "sv_planes.cu", ("sv_gather_kernel",)),
    "sv_transpose": ("sv_transpose", CSRC + "sv_planes.cu",
                     ("sv_transpose_kernel",)),
    "rs_select": ("rs_select", CSRC + "rs_select.cu",
                  ("rs_select_kernel", "select_flat_kernel")),
    "rs_rank": ("rs_rank", CSRC + "rs_select.cu",
                ("rs_rank_kernel", "rank_flat_kernel")),
    "sv_descent": ("sv_descent", CSRC + "sv_descent.cu",
                   ("sv_descent_kernel", "descent_rows_kernel")),
    "shift_and_chain": ("B8", CSRC + "shift_chain.cu",
                        ("shift_and_chain_kernel",)),
}


def log(msg):
    print(msg, flush=True)


def forbid_jax(modules=None) -> None:
    """Raise when JAX or the JAX package is loaded in this process
    (``modules``, default ``sys.modules``): the port is measured alone."""
    modules = sys.modules if modules is None else modules
    loaded = sorted(m for m in modules
                    if m.split(".")[0] in JAX_MODULES)
    if loaded:
        raise RuntimeError(
            f"bench_torch: {loaded[:4]} loaded in this process; the port is "
            f"measured without JAX and the run reports no result")


def bench_device(device=None) -> torch.device:
    """The card, or ``device`` when a caller names one.  There is no
    fallback: without a card the default raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"bench_torch: unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bench_torch: no CUDA device (torch.cuda.is_available() is "
            "False); the benchmark measures the card and does not fall "
            "back to the CPU")
    return (torch.device("cuda", torch.cuda.current_device())
            if dev.index is None else dev)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def host_info() -> dict:
    """The host the entry points' host work runs on: its CPU, the cores
    this process may use, the load average, and the wall of a fixed pure
    Python loop (the host's single-thread speed at this moment)."""
    model = platform.processor() or "unknown"
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), model)
    t0 = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    return {"machine": platform.machine(), "cpu": model,
            "cores": os.cpu_count(), "usable_cores":
            len(os.sched_getaffinity(0)), "torch_threads":
            torch.get_num_threads(), "loadavg": list(os.getloadavg()),
            "python_loop_ms": (time.perf_counter() - t0) * 1e3}


def p90(xs) -> float:
    """The sample with a tenth of the samples beyond it."""
    s = sorted(xs)
    return float(s[len(s) - len(s) // 10 - 1])


def stats(ms) -> dict:
    return {"median_ms": float(np.median(ms)), "p90_ms": p90(ms),
            "n": len(ms)}


# ---------------------------------------------------------------------------
# the workloads and their configuration files
# ---------------------------------------------------------------------------
def load_workload(name) -> tuple[dict, dict]:
    """(the workload entry named ``name`` in BENCHMARK.json, its
    configuration file)."""
    with open(BENCHMARK) as f:
        workloads = {w["name"]: w for w in json.load(f)["workloads"]}
    if name not in workloads:
        raise KeyError(f"bench_torch: no workload {name!r} in "
                       f"BENCHMARK.json; there are {sorted(workloads)}")
    w = workloads[name]
    with open(os.path.join(ROOT, w["config"])) as f:
        return w, json.load(f)


def check_sizes(sizes, built) -> None:
    """Every size of what was built equals the configuration's."""
    bad = {k: (sizes.get(k), v) for k, v in built.items()
           if sizes.get(k) != v}
    if bad:
        raise ValueError(f"bench_torch: built sizes differ from the "
                         f"configuration (file, built): {bad}")


def resolve(result, path):
    """The number at a dotted ``path`` of the result."""
    x = result
    for part in path.split("."):
        x = x[part]
    if not isinstance(x, (int, float)) or not math.isfinite(x):
        raise ValueError(f"bench_torch: metric {path} is {x!r}")
    return x


# ---------------------------------------------------------------------------
# draws and the numpy oracle
# ---------------------------------------------------------------------------
def make_pool(rng, nblk, density=0.5) -> np.ndarray:
    """bench.py's ``make_pool`` (bench.py:86-91) as host words."""
    if density >= 0.5:
        return rng.integers(0, 2**32, (nblk, WORDS),
                            dtype=np.uint64).astype(np.uint32)
    return (rng.random((nblk, WORDS)) < density).astype(np.uint32)


def run_block(rng, runs) -> np.ndarray:
    """One block of ``runs`` runs of ones between 2 * runs boundaries
    drawn uniformly in [1, 65536): its first bit is 0 and it holds ones,
    so it is neither empty nor full, and optimize() keeps it as D-GAP."""
    bounds = np.unique(rng.integers(1, BLOCK_BITS, 2 * runs))
    bounds = bounds[: bounds.size // 2 * 2]
    marks = np.zeros(BLOCK_BITS, np.int8)
    marks[bounds] = 1
    bits = (np.cumsum(marks) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").view(np.uint32)


def overlay_gap_blocks(rng, pool, share, max_runs) -> np.ndarray:
    """Replace each block of ``pool`` with probability ``share`` by a
    run-structured block of 1 to ``max_runs`` runs."""
    out = pool.copy()
    for i in np.flatnonzero(rng.random(len(pool)) < share):
        out[i] = run_block(rng, int(rng.integers(1, max_runs + 1)))
    return out


def popcount(words) -> int:
    return int(np.bitwise_count(words).sum(dtype=np.int64))


def oracle_rank(words, ids) -> np.ndarray:
    """popcount of bits [0, i] of the word image for each id."""
    wcum = np.concatenate([[0], np.cumsum(np.bitwise_count(words),
                                          dtype=np.int64)])
    ids = np.asarray(ids, np.int64)
    w = ids >> 5
    mask = ((np.uint64(2) << (ids & 31).astype(np.uint64))
            - np.uint64(1)).astype(np.uint32)
    return wcum[w] + np.bitwise_count(words[w] & mask).astype(np.int64)


def oracle_select(words, ranks) -> np.ndarray:
    """Position of each 1-based rank's set bit, -1 past the last one."""
    ones = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little"))
    ranks = np.asarray(ranks, np.int64)
    ok = (ranks >= 1) & (ranks <= ones.size)
    return np.where(ok, ones[np.clip(ranks - 1, 0, max(ones.size - 1, 0))],
                    -1)


def shifted_up(words) -> np.ndarray:
    """The word image shifted one bit up; the top bit drops off."""
    return (words << np.uint32(1)) | np.concatenate(
        [[np.uint32(0)], words[:-1] >> np.uint32(31)])


def run_ends(rows) -> np.ndarray:
    """Run ends of each block row's D-GAP encoding: its bit transitions
    plus one."""
    inner = np.bitwise_count((rows ^ (rows >> np.uint32(1)))
                             & np.uint32(0x7FFFFFFF)).sum(axis=1,
                                                          dtype=np.int64)
    edge = ((rows[:, :-1] >> np.uint32(31)) ^ (rows[:, 1:] & np.uint32(1)))
    return inner + edge.sum(axis=1, dtype=np.int64) + 1


def expand_bytes(store) -> int:
    """gap_expand of every block of a D-GAP store: 4 B per run end, 4 B of
    offset, 1 B of ``first`` and 4 B of block id per block read, a row
    written per block."""
    return 4 * store.ends.size + (9 + ROW) * store.n_blocks


def compress_bytes(rows) -> int:
    """gap_compress of block rows uint32[n, 2048]: the rows read, 4 B per
    run end, the n + 1 offsets and n ``first`` bytes written."""
    n = len(rows)
    return n * ROW + 4 * int(run_ends(rows).sum()) + 4 * (n + 1) + n


class AnswerMismatch(AssertionError):
    pass


def _differs(got, want) -> str | None:
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        if got.shape == want.shape and np.array_equal(got, want):
            return None
        if got.shape != want.shape:
            return f"shape {got.shape}, oracle {want.shape}"
        i = int(np.flatnonzero(got.ravel() != want.ravel())[0])
        return (f"{int((got != want).sum())} entries differ, first at {i}: "
                f"{got.ravel()[i]} against {want.ravel()[i]}")
    return None if got == want else f"{got!r} against {want!r}"


def word_image(bv, n_words) -> np.ndarray:
    """The vector's word image of bits [0, 32 * n_words): a search result
    spans the whole 48-bit id space, of which the oracle holds the
    column's blocks (its count covers the rest)."""
    if bv.size > 32 * n_words:
        bv = bv.copy().resize(32 * n_words)
    return bv.to_words().ravel()


def check_answers(step, answers, oracle) -> None:
    """Compare one step's answers with the oracle: counts, positions and
    values exactly, result vectors by their word images.  Prints what
    differed and raises ``AnswerMismatch``."""
    bad = []
    for key, want in oracle.items():
        if key == "words":
            for name, w in want.items():
                d = _differs(word_image(answers["vectors"][name], w.size),
                             w)
                if d:
                    bad.append(f"{name} words: {d}")
            continue
        d = _differs(answers[key], want)
        if d:
            bad.append(f"{key}: {d}")
    if bad:
        for b in bad:
            log(f"bench_torch: {step}: {b}")
        raise AnswerMismatch(f"{step}: {len(bad)} answers differ from the "
                             f"numpy oracle: {'; '.join(bad)}")


class Step:
    """Host wall (ms) of each entry-point call of one step, each call
    ended by a device synchronize; with ``spans`` each call also runs in a
    ``torch.profiler`` span ``bench:<name>``."""

    def __init__(self, device, spans=False):
        self.device, self.spans, self.ms = device, spans, {}

    def __call__(self, name, fn, *args):
        ctx = (torch.profiler.record_function(f"bench:{name}")
               if self.spans else contextlib.nullcontext())
        with ctx:
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args)
            sync(self.device)
            self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out


def _rate(walls, amount, unit) -> dict:
    """``amount`` units of work per call over the sum of the calls' walls
    in the window, beside the calls' median and p90 walls."""
    return {"value": amount * len(walls) / (sum(walls) / 1e3), "unit": unit,
            "wall_ms": float(sum(walls)), **stats(walls)}


def _config(rate) -> dict:
    return {"value": rate["value"], "unit": rate["unit"]}


# ---------------------------------------------------------------------------
# the traffic: what one step of a cell does
# ---------------------------------------------------------------------------
class SetAlgebraTraffic:
    """bench.py configs 1, 1c and 2 through BitVector: count_and, the four
    operations each with its count, distance_operation of 7 metrics, a
    select and a rank batch on A's rs-index, shift_right of a copy of A."""
    needs = ("logical_op_digest", "count_op", "block_counts", "gap_expand",
             "gap_compress", "rs_select", "rs_rank")
    metric, headline = "bvsetalgebra_and_count_throughput", "and_count_gbps"

    def __init__(self, seed, sizes):
        rng = np.random.default_rng(seed)
        self.sizes = sizes
        n, q = sizes["blocks_per_vector"], sizes["select_queries"]
        density = sizes["density"]
        pa = make_pool(rng, n, density)                     # bench.py:96
        pb = make_pool(rng, n, density)
        # ranks as at bench.py:205-207, then the rank batch's ids
        self.ranks = rng.integers(1, n * WORDS * 16, q)
        self.ids = rng.integers(0, n * BLOCK_BITS, sizes["rank_queries"])
        share, runs = sizes["gap_block_share"], sizes["gap_runs_max"]
        self.wa = overlay_gap_blocks(rng, pa, share, runs).ravel()
        self.wb = overlay_gap_blocks(rng, pb, share, runs).ravel()
        per_block = np.bitwise_count(np.stack([self.wa, self.wb]).reshape(
            2, n, WORDS)).sum(axis=2, dtype=np.int64)
        # every block is kernel work in every operation's plan, which the
        # kernels' byte counts rest on
        if ((per_block == 0) | (per_block == BLOCK_BITS)).any():
            raise ValueError("bench_torch: the draw holds an empty or a "
                             "full block")

    def oracle(self) -> dict:
        wa, wb = self.wa, self.wb
        out = {"count_and": popcount(wa & wb)}
        words = {"and": wa & wb, "or": wa | wb, "xor": wa ^ wb,
                 "sub": wa & ~wb}
        for op, w in words.items():
            out[op] = popcount(w)
        metric = {"count_and": wa & wb, "count_xor": wa ^ wb,
                  "count_or": wa | wb, "count_sub_ab": wa & ~wb,
                  "count_sub_ba": wb & ~wa, "count_a": wa, "count_b": wb}
        out["distance"] = {m: popcount(metric[m]) for m in METRICS}
        out["select"] = oracle_select(wa, self.ranks)
        out["rank"] = oracle_rank(wa, self.ids)
        words["shift"] = shifted_up(wa)
        out["shift_count"] = popcount(words["shift"])
        out["words"] = words
        return out

    def build(self, device):
        self.a = tbm.BitVector.from_words(self.wa, device=device)
        self.b = tbm.BitVector.from_words(self.wb, device=device)
        self.a.optimize()
        self.b.optimize()
        self.rs = self.a.build_rs_index()

    def built(self) -> dict:
        """The sizes of what was built, in the configuration's keys."""
        n = len(self.wa) // WORDS
        return {"vectors": 2, "blocks_per_vector": n,
                "bits_per_vector": self.a.size,
                "row_bytes_per_vector": self.wa.nbytes,
                "select_queries": len(self.ranks),
                "rank_queries": len(self.ids),
                "distance_metrics": len(METRICS)}

    def structure(self) -> dict:
        return {v: {k: s[k] for k in ("bit_blocks", "gap_blocks",
                                      "full_blocks", "zero_blocks")}
                for v, s in (("a", self.a.calc_stat()),
                             ("b", self.b.calc_stat()))}

    def step(self, t: Step) -> dict:
        a, b, rs = self.a, self.b, self.rs

        def op_count(dunder):
            r = getattr(a, dunder)(b)
            return r.count(), r

        out = {"count_and": t("count_and", tbm.count_and, a, b),
               "vectors": {}}
        for op, dunder in OPS.items():
            out[op], out["vectors"][op] = t(op, op_count, dunder)
        out["distance"] = t("distance_operation", tbm.distance_operation,
                            a, b, list(METRICS))
        out["select"] = t("select_batch", rs.select_batch, self.ranks)
        out["rank"] = t("rank_batch", rs.rank_batch, self.ids)
        c = a.copy()                    # outside the timed span
        out["shift_count"] = t("shift_right",
                               lambda: c.shift_right().count())
        out["vectors"]["shift"] = c
        return out

    def kernel_bytes(self, answers) -> dict:
        """Bytes each hand kernel must move in one step: each input row
        read once, each output written once.  No block of A or B is empty
        or full, so every operation's plan holds all n blocks (dense rows
        or expanded GAP rows); K3 reads each counted vector's dense rows.
        gap_expand expands every GAP block of both operands in count_and,
        each operation and distance_operation, and A's in shift_right (the
        copy's store is A's); gap_compress re-encodes each operation's rows
        that are GAP in A and in B."""
        n = len(self.wa) // WORDS
        counted = list(answers["vectors"].values())
        ga, gb = self.a._gaps, self.b._gaps
        both = self.gap_pairs()
        return {
            "logical_op_digest": len(OPS) * (3 * n * ROW
                                             + 4 * C.BLOCK_WAVES * n),
            "count_op": 2 * 2 * n * ROW + 8 * (1 + len(METRICS)),
            "block_counts": sum(v.calc_stat()["bit_blocks"] * ROW + 8
                                for v in counted),
            "gap_expand": (len(OPS) + 2) * (expand_bytes(ga)
                                            + expand_bytes(gb))
            + expand_bytes(ga),
            "gap_compress": sum(compress_bytes(
                answers["vectors"][op].to_words().reshape(-1, WORDS)[both])
                for op in OPS)}

    def gap_pairs(self) -> np.ndarray:
        """The block numbers that are D-GAP in both A and B."""
        return np.intersect1d(*(v._struct.nb[v._struct.cls == C.CLS_GAP]
                                for v in (self.a, self.b)))

    def metrics(self, ms) -> tuple[dict, dict]:
        """(end-to-end metrics, bench.py's configs) from the timed calls'
        walls."""
        pool = self.wa.nbytes
        e2e = {"and_count_gbps": _rate(ms["count_and"], 2 * pool / 1e9,
                                       "GB/s"),
               "select_mqps": _rate(ms["select_batch"],
                                    len(self.ranks) / 1e6, "Mq/s")}
        configs = {
            "1_and_count": _config(e2e["and_count_gbps"]),
            "1c_shift_r1": _config(_rate(ms["shift_right"], pool / 1e9,
                                         "GB/s")),
            "2_select1": _config(e2e["select_mqps"]),
            "2_rank1": _config(_rate(ms["rank_batch"],
                                     len(self.ids) / 1e6, "Mq/s"))}
        return e2e, configs

    def baseline(self, reps=5) -> tuple[float, str]:
        """numpy AND + popcount of the same two operands on this host
        (GB/s), bench.py's numpy baseline (bench.py:186-198)."""
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            popcount(self.wa & self.wb)
            ts.append(time.perf_counter() - t0)
        return (2 * self.wa.nbytes / 1e9 / float(np.median(ts)),
                "numpy AND + popcount of A and B on this host, median of "
                f"{reps}")


class SearchTraffic:
    """bench.py configs 3, 4 and 4b through the search entry points:
    combine_and_sub of an AND and a SUB group with its count, a prepared
    scanner pipeline's counts over a nullable column, config 4's find_eq
    over bit planes through scan_throughput_program on a one-card mesh."""
    needs = ("agg_and_sub", "pipeline_counts", "scan_eq", "block_counts")
    metric, headline = "aggregator_and_sub_throughput", "agg_and_sub_gbps"

    def __init__(self, seed, sizes):
        rng = np.random.default_rng(seed)
        self.sizes = s = sizes
        self.stack = rng.integers(                          # bench.py:227
            0, 2**32, (s["aggregator_vectors"], s["blocks_per_vector"],
                       WORDS), dtype=np.uint64).astype(np.uint32)
        self.planes = rng.integers(                         # bench.py:256
            0, 2**32, (s["scan_planes"], s["scan_blocks"], WORDS),
            dtype=np.uint64).astype(np.uint32)
        self.vals = rng.integers(                           # bench.py:286
            0, 1 << s["column_value_bits"],
            s["column_rows"]).astype(np.uint32)
        self.queries = [int(v) for v in rng.integers(       # bench.py:290
            1, 1 << s["column_value_bits"], s["pipeline_values"])]
        self.n_and = s["and_vectors"]

    def and_sub_words(self):
        h = self.n_and
        return (np.bitwise_and.reduce(self.stack[:h], axis=0)
                & ~np.bitwise_or.reduce(self.stack[h:], axis=0)).ravel()

    def and_sub_rows(self) -> int:
        """Operand rows the AND-SUB needs: each column reads its operands
        in order until its accumulator is zero."""
        acc = np.full(self.stack.shape[1:], 0xFFFFFFFF, np.uint32)
        live = np.ones(len(acc), bool)
        rows = 0
        for i, v in enumerate(self.stack):
            rows += int(live.sum())
            acc &= v if i < self.n_and else ~v
            live &= acc.any(axis=1)
        return rows

    def oracle(self) -> dict:
        w = self.and_sub_words()
        acc = np.full(self.planes.shape[1:], 0xFFFFFFFF, np.uint32)
        value = self.sizes["scan_value"]
        for s, plane in enumerate(self.planes):
            acc &= plane if (value >> s) & 1 else ~plane
        hist = np.bincount(self.vals,
                           minlength=1 << self.sizes["column_value_bits"])
        return {"and_sub_count": popcount(w),
                "pipeline_counts": hist[self.queries].tolist(),
                "scan_find_eq": popcount(acc),
                "words": {"and_sub": w}}

    def build(self, device):
        self.vecs = [tbm.BitVector.from_words(w.ravel(), device=device)
                     for w in self.stack]
        self.agg = tbm.Aggregator()
        self.sv = tbm.SparseVector.from_array(
            self.vals, nullable=self.sizes["column_nullable"],
            device=device)
        self.prep = tbm.scanner.prepare_pipeline(self.sv)
        mesh = parallel.Mesh([device])
        self.scan, sharding = parallel.scan_throughput_program(
            mesh, self.planes.shape[0], self.planes.shape[1])
        self.shards = sharding.place(self.planes)
        self.b4_rows = self.and_sub_rows()

    def built(self) -> dict:
        s = self.stack.shape
        return {"aggregator_vectors": len(self.vecs),
                "blocks_per_vector": s[1],
                "aggregator_row_bytes": self.stack.nbytes,
                "and_vectors": self.n_and,
                "scan_planes": self.planes.shape[0],
                "scan_blocks": self.planes.shape[1],
                "scan_bytes": self.planes.nbytes,
                "column_rows": self.sv.size,
                "column_nullable": self.sv.is_nullable(),
                "pipeline_values": len(self.queries)}

    def structure(self) -> dict:
        return {"and_sub_operand_rows_needed": self.b4_rows}

    def step(self, t: Step) -> dict:
        h = self.n_and
        r = t("combine_and_sub", self.agg.combine_and_sub, self.vecs[:h],
              self.vecs[h:])
        return {"and_sub_count": t("count", r.count),
                "pipeline_counts": t("pipeline_counts", self.prep.counts,
                                     self.queries),
                "scan_find_eq": int(t("scan_find_eq", self.scan,
                                      self.shards,
                                      self.sizes["scan_value"])),
                "vectors": {"and_sub": r}}

    def kernel_bytes(self, answers) -> dict:
        """Bytes each hand kernel must move in one step, each input row
        read once and each output written once: B4 the operand rows its
        columns need before they reach zero and its result rows, B5 the
        NULL and value planes of every value, B6 the planes and its result,
        K3 the AND-SUB result's dense rows and B6's result."""
        s = self.sizes
        nb = self.stack.shape[1]
        col_blocks = -(-s["column_rows"] // BLOCK_BITS)
        planes = s["column_value_bits"] + bool(s["column_nullable"])
        res = answers["vectors"]["and_sub"].calc_stat()["bit_blocks"]
        return {
            "agg_and_sub": (self.b4_rows + nb) * ROW,
            "pipeline_counts": planes * col_blocks * ROW
            + 8 * len(self.queries),
            "scan_eq": (s["scan_planes"] + 1) * s["scan_blocks"] * ROW,
            "block_counts": (res + s["scan_blocks"]) * ROW + 16}

    def metrics(self, ms) -> tuple[dict, dict]:
        s = self.sizes
        e2e = {"agg_and_sub_gbps": _rate(ms["combine_and_sub"],
                                         self.stack.nbytes / 1e9, "GB/s"),
               "scan_pipeline_gsearch_elem_s": _rate(
                   ms["pipeline_counts"],
                   len(self.queries) * s["column_rows"] / 1e9,
                   "Gsearch-elem/s")}
        configs = {
            "3_agg_and_sub": _config(e2e["agg_and_sub_gbps"]),
            "4_scan_find_eq": _config(_rate(
                ms["scan_find_eq"], s["scan_blocks"] * BLOCK_BITS / 1e9,
                "Gelem/s")),
            "4b_scan_pipeline": _config(e2e["scan_pipeline_gsearch_elem_s"])}
        return e2e, configs

    def baseline(self, reps=5) -> tuple[float, str]:
        """numpy AND-SUB + popcount of the same vectors on this host
        (GB/s)."""
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            popcount(self.and_sub_words())
            ts.append(time.perf_counter() - t0)
        return (self.stack.nbytes / 1e9 / float(np.median(ts)),
                "numpy AND-SUB + popcount of the same vectors on this host, "
                f"median of {reps}")


def descent_bytes(planes, universe, n_blocks, want_eq=False) -> int:
    """Bytes sv_descent must move for one descent over ``planes`` (the
    stepped planes) from ``universe`` (BitVectors) over ``n_blocks``
    walked blocks: each plane's and the universe's BIT rows read once
    (8 KiB), their D-GAP blocks (4 B a run, 9 B a block: its offsets and
    first bit), the block ids (8 B), gt's rows and wave digests (and eq's
    with ``want_eq``) written once and both classes (1 B each)."""
    out = 1 + bool(want_eq)
    moved = 10 * n_blocks + out * (ROW + 4 * C.BLOCK_WAVES) * n_blocks
    for p in [*planes, universe]:
        cls = p._struct.cls
        moved += ROW * int((cls == C.CLS_BIT).sum())
        if p._gaps is not None:
            moved += (4 * int(p._gaps.offs[-1])
                      + 9 * int((cls == C.CLS_GAP).sum()))
    return moved


class RangeGatherTraffic:
    """Config 4b's column under the scanner's ordered search and a gather:
    find_gt of a constant with its count (BitMagic svsample10), then the
    values at random ids, late materialization in random order
    (sparse_vector<>::gather, rscsample06)."""
    needs = ("sv_descent", "block_counts")
    metric, headline = "column_range_gather_throughput", "gather_mqps"

    def __init__(self, seed, sizes):
        rng = np.random.default_rng(seed)
        self.sizes = s = sizes
        self.vals = rng.integers(                           # bench.py:286
            0, 1 << s["column_value_bits"],
            s["column_rows"]).astype(np.uint32)
        self.ids = rng.integers(0, s["column_rows"], s["gather_ids"])
        self.value = s["gt_value"]

    def oracle(self) -> dict:
        hits = self.vals > self.value
        bits = np.zeros(-(-hits.size // BLOCK_BITS) * BLOCK_BITS, bool)
        bits[:hits.size] = hits
        return {"count": int(hits.sum()), "gather": self.vals[self.ids],
                "words": {"gt": np.packbits(
                    bits, bitorder="little").view(np.uint32)}}

    def build(self, device):
        self.sv = tbm.SparseVector.from_array(
            self.vals, nullable=self.sizes["column_nullable"],
            device=device)
        self.scanner = tbm.SparseVectorScanner()

    def built(self) -> dict:
        planes = [i for i, p in enumerate(self.sv.planes) if p is not None]
        return {"column_rows": self.sv.size,
                "column_value_bits": max(planes) + 1,
                "column_nullable": self.sv.is_nullable(),
                "value_plane_bytes": sum(
                    self.sv.planes[i].calc_stat()["bit_blocks"]
                    for i in planes) * ROW,
                "gt_value": self.value, "gather_ids": len(self.ids)}

    def structure(self) -> dict:
        """Block classes summed over the value planes, and the NULL
        plane's."""
        keys = ("bit_blocks", "gap_blocks", "full_blocks")
        stats = [p.calc_stat() for p in self.sv.planes if p is not None]
        out = {"value_planes": {k: sum(st[k] for st in stats)
                                for k in keys}}
        if self.sv.is_nullable():
            st = self.sv.null_plane.calc_stat()
            out["null_plane"] = {k: st[k] for k in keys}
        return out

    def find_gt_count(self):
        r = self.scanner.find_gt(self.sv, self.value)
        return r.count(), r

    def step(self, t: Step) -> dict:
        count, r = t("find_gt", self.find_gt_count)
        return {"count": count,
                "gather": t("gather", self.sv.gather, self.ids),
                "vectors": {"gt": r}}

    def kernel_bytes(self, answers) -> dict:
        """Bytes sv_descent and K3 must move in one find_gt with its
        count: the descent's planes, NULL plane and results
        (``descent_bytes``, over the blocks the planes or the NULL plane
        hold), K3 the result's dense rows and its total.  The gather's
        kernel, sv_gather, has no bytes here yet."""
        sv = self.sv
        if not sv.is_nullable():
            raise ValueError("bench_torch: the descent's bytes start from "
                             "the NULL plane; the column must be nullable")
        table, steps, _ = tbm.scanner._descent_steps(sv, self.value,
                                                     sv.n_slices)
        bit = table.meta[:, -1]
        planes = [sv.planes[int(bit[r])] for r, _, _ in steps]
        walked = np.union1d(table.blocks, sv.null_plane._struct.nb).size
        res = answers["vectors"]["gt"].calc_stat()["bit_blocks"]
        return {"sv_descent": descent_bytes(planes, sv.null_plane, walked),
                "block_counts": res * ROW + 8}

    def metrics(self, ms) -> tuple[dict, dict]:
        s = self.sizes
        e2e = {"find_gt_gelem_s": _rate(ms["find_gt"],
                                        s["column_rows"] / 1e9, "Gelem/s"),
               "gather_mqps": _rate(ms["gather"], len(self.ids) / 1e6,
                                    "Mq/s")}
        configs = {"4b_find_gt": _config(e2e["find_gt_gelem_s"]),
                   "4b_gather": _config(e2e["gather_mqps"])}
        return e2e, configs

    def baseline(self, reps=5) -> tuple[float, str]:
        """numpy ``(vals > c).sum()`` and ``vals[ids]`` of the same column
        on this host, as Mq/s of the gather's ids."""
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            int((self.vals > self.value).sum())
            self.vals[self.ids]
            ts.append(time.perf_counter() - t0)
        return (len(self.ids) / 1e6 / float(np.median(ts)),
                "numpy (vals > c).sum() + vals[ids] of the same column on "
                f"this host, Mq/s of the ids, median of {reps}")


TRAFFIC = {"set_algebra_rank_select": SetAlgebraTraffic,
           "and_sub_pipeline_scan": SearchTraffic,
           "range_gather": RangeGatherTraffic}


# ---------------------------------------------------------------------------
# one traced step: device busy, idle share, the kernels, the breakdown
# ---------------------------------------------------------------------------
def _merge(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def breakdown(events, device_type) -> dict | None:
    """From one trace: the step's host wall and device busy (the union of
    the device events inside the step span), each hand kernel's device ms
    per launch, the 8 device operations that took the most time, the 5
    longest idle gaps each named by the span the host was in, and each
    span's host and busy ms."""
    spans = [(e.time_range.start, e.time_range.end, e.name[len("bench:"):])
             for e in events if e.name.startswith("bench:")
             and e.device_type != device_type]
    step = [s for s in spans if s[2] == "step"]
    calls = [s for s in spans if s[2] != "step"]
    # the spans' annotations on the device timeline are not device work
    dev = sorted((e for e in events if e.device_type == device_type
                  and not e.name.startswith("bench:")),
                 key=lambda e: e.time_range.start)
    if not step or not dev:
        return None
    s0, s1 = step[0][0], step[0][1]
    busy = [[max(a, s0), min(b, s1)] for a, b in _merge(
        (e.time_range.start, e.time_range.end) for e in dev)
        if b > s0 and a < s1]
    by_name = {}
    for e in dev:
        n = by_name.setdefault(e.name[:80], [0.0, 0])
        n[0] += e.time_range.end - e.time_range.start
        n[1] += 1
    kernels = {counter: [(e.time_range.end - e.time_range.start) / 1e3
                         for e in dev if any(f in e.name for f in fns)]
               for counter, (_, _, fns) in KERNELS.items()}
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    gaps = []
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        best = max(calls, key=lambda c: _overlap(g0, g1, c[0], c[1]),
                   default=None)
        where = (best[2] if best is not None
                 and _overlap(g0, g1, best[0], best[1]) > 0
                 else "between spans")
        gaps.append({"ms": (g1 - g0) / 1e3, "span": where})
    gaps.sort(key=lambda g: -g["ms"])
    return {
        "traced_wall_ms": (s1 - s0) / 1e3,
        "busy_ms": sum(b - a for a, b in busy) / 1e3,
        "kernel_ms": {k: v for k, v in kernels.items() if v},
        "top_device_ops": [
            {"name": k, "ms": v[0] / 1e3, "count": v[1]}
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]],
        "idle_gaps": gaps[:5],
        "spans": {c[2]: {"host_ms": (c[1] - c[0]) / 1e3,
                         "busy_ms": sum(_overlap(a, b, c[0], c[1])
                                        for a, b in busy) / 1e3}
                  for c in calls}}


def check_launches(name, needs, per_step) -> None:
    """Every hand kernel the cell's path needs launched in the step."""
    missing = [k for k in needs if not per_step.get(k)]
    if missing:
        raise RuntimeError(f"bench_torch: {name}: the step launched "
                           f"{[KERNELS[k][0] for k in missing]} no time; "
                           f"its path needs them")


def layer_metrics(traces, step_ms) -> dict:
    """The per-layer metrics, ms per step: device busy (the union of the
    device events inside the step) and the hand kernels' device time, each
    the median over the traced steps, and the host-only time, the untraced
    window's mean step ``step_ms`` less that busy median (the profiler's
    own cost stays out of it)."""
    per = {"device_busy_ms": [t["busy_ms"] for t in traces],
           "hand_kernels_ms": [sum(map(sum, t["kernel_ms"].values()))
                               for t in traces]}
    out = {k: {"value": float(np.median(v)), "unit": "ms", "steps": v,
               "n": len(v)} for k, v in per.items()}
    out["host_only_ms"] = {
        "value": step_ms - out["device_busy_ms"]["value"], "unit": "ms",
        "step_ms": step_ms, "n": len(traces)}
    return out


def kernel_rows(kernel_ms, launches, nbytes) -> list:
    """One row per hand kernel of the step: launches counted in the timed
    steps and seen in the trace, device ms per launch and per step, the
    bytes it must move per step and the rate that makes."""
    rows = []
    for counter, (short, source, _) in KERNELS.items():
        ms = kernel_ms.get(counter, [])
        if not ms and not launches.get(counter):
            continue
        total = sum(ms)
        b = nbytes.get(counter)
        rows.append({"kernel": short, "name": counter, "source": source,
                     "launches_per_step": launches.get(counter, 0),
                     "traced_launches": len(ms), "ms_per_launch": ms,
                     "ms_per_step": total, "bytes_per_step": b,
                     "gb_per_s": (b / total / 1e6 if b and total
                                  else "not measured")})
    return rows


def trace_step(cell, device, evict, attempts=3):
    """Trace one step that is none of the timed ones; an empty trace is
    traced again, at most twice.  Returns (breakdown or None, the step's
    answers)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    answers = None
    for attempt in range(1, attempts + 1):
        evict()
        sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            with record_function("bench:step"):
                answers = cell.step(Step(device, spans=True))
            sync(device)
        got = breakdown(prof.events(), DeviceType.CUDA)
        if got is not None:
            got["attempts"] = attempt
            return got, answers
        log(f"trace: attempt {attempt} recorded no device events"
            + ("; tracing again" if attempt < attempts else ""))
    return None, answers


# ---------------------------------------------------------------------------
# a cell from end to end
# ---------------------------------------------------------------------------
def run_cell(name, seed=42, device=None, sizes=None, warmup=None,
             steps=None, out=log, allow_jax=False) -> dict:
    """Run the workload ``name`` of BENCHMARK.json; prints the per-layer
    lines through ``out`` and returns the result object (the last line).
    ``device=None`` is the card.  ``sizes``, ``warmup`` and ``steps``
    replace the configuration's (the tests' cut).  Raises after the timed
    window when JAX is loaded, unless ``allow_jax``."""
    workload, cfg = load_workload(name)
    sizes = cfg["sizes"] if sizes is None else sizes
    warmup = workload["warmup"] if warmup is None else warmup
    steps = workload["steps"] if steps is None else steps
    dev = bench_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        out(f"card: {card_line()}")
    host = host_info()
    out(f"host: {json.dumps(host)}")
    cell = TRAFFIC[workload["traffic"]](seed, sizes)
    t0 = time.perf_counter()
    oracle = cell.oracle()
    setup = {"oracle_ms": (time.perf_counter() - t0) * 1e3}
    if on_card:
        t0 = time.perf_counter()
        _build.build_all()
        for src in _build.SOURCES:
            _build.load(src)
        setup["kernel_build_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    cell.build(dev)
    sync(dev)
    setup["setup_ms"] = (time.perf_counter() - t0) * 1e3
    check_sizes(sizes, cell.built())
    setup["structure"] = cell.structure()
    if on_card:
        setup["device_memory_mb"] = torch.cuda.memory_allocated(dev) / 1e6
    out(f"setup: {json.dumps(setup)}")

    flush = (torch.empty(L2_EVICT_WORDS, dtype=torch.int32, device=dev)
             if on_card else None)

    def evict():
        if flush is not None:
            flush.zero_()

    for _ in range(warmup):
        evict()
        cell.step(Step(dev))
    walls, step_ms, launches = {}, [], []
    first = last = None
    sync(dev)
    t_window = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        evict()
        t = Step(dev)
        before = dict(ck.launches)
        answers = cell.step(t)
        launches.append({k: ck.launches[k] - before[k] for k in before})
        for k, v in t.ms.items():
            walls.setdefault(k, []).append(v)
        if i == 0:
            first = answers
        last = answers
        step_ms.append((time.perf_counter() - t0) * 1e3)
    window_ms = (time.perf_counter() - t_window) * 1e3
    if not allow_jax:
        forbid_jax()
    check_answers("first timed step", first, oracle)
    check_answers("last timed step", last, oracle)
    del first, last, answers
    per_step = {k: v for k, v in launches[0].items() if v}
    varied = [k for k in ck.launches if len({ln[k] for ln in launches}) > 1]
    out(f"launches per step: {json.dumps(per_step)}"
        + (f"; varied across the timed steps: {varied}" if varied else ""))
    if on_card:
        check_launches(name, cell.needs, launches[0])
    out(f"entry points: {json.dumps({k: stats(v) for k, v in walls.items()})}")
    e2e, configs = cell.metrics(walls)
    tenths = np.array_split(np.asarray(step_ms), min(10, steps))
    e2e["step_ms"] = {"value": window_ms / steps, "unit": "ms",
                      "window_ms": window_ms, **stats(step_ms),
                      "mean_ms_by_tenth": [float(t.mean()) for t in tenths]}
    host_after = host_info()
    out(f"host after the window: {json.dumps(host_after)}")

    idle = layers = "not measured"
    if on_card:
        traced = [trace_step(cell, dev, evict)
                  for _ in range(workload["traced_steps"])]
        tr, answers = traced[0]
        if tr is None:
            out("kernels: not measured (three traces recorded no device "
                "events)")
            out("trace: not measured (three traces recorded no device "
                "events)")
        else:
            kernels = kernel_rows(tr["kernel_ms"], per_step,
                                  cell.kernel_bytes(answers))
            out(f"kernels: {json.dumps(kernels)}")
            mean = e2e["step_ms"]["value"]
            tr = {k: v for k, v in tr.items() if k != "kernel_ms"}
            tr["step_ms"] = mean
            tr["idle_share"] = idle = (mean - tr["busy_ms"]) / mean
            tr["tracing_overhead_ms"] = tr["traced_wall_ms"] - mean
            out(f"trace: {json.dumps(tr)}")
        traces = [t for t, _ in traced if t is not None]
        if not traces:
            raise RuntimeError(f"bench_torch: {name}: no traced step "
                               f"recorded device events; the per-layer "
                               f"metrics cannot be read")
        layers = layer_metrics(traces, e2e["step_ms"]["value"])
        out(f"layers: {json.dumps(layers)}")
        del answers, traced
    del flush
    base, what = cell.baseline()
    head = cell.headline
    result = {
        "metric": cell.metric, "value": e2e[head]["value"],
        "unit": e2e[head]["unit"],
        "vs_baseline": e2e[head]["value"] / base,
        "baseline": {"value": base, "unit": e2e[head]["unit"],
                     "what": what},
        "cell": name, "seed": seed, "correct": True,
        "metrics": e2e, "configs": configs, "setup": setup,
        "launches_per_step": per_step, "idle_share": idle,
        "layers": layers, "host": host, "host_after_window": host_after,
        "device": device_info(dev)}
    for m in workload["metrics"].values():
        resolve(result, m["path"])
    if on_card:
        for m in workload["layer_metrics"].values():
            resolve(result, m["path"])
    return result


def device_info(dev) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


# ---------------------------------------------------------------------------
# configs 5 and 5b on request (no cell)
# ---------------------------------------------------------------------------
def _median_call(fn, n, device):
    fn()
    ms, r = [], None
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        r = fn()
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return stats(ms), r


def run_serialization(seed=42, device=None, blocks=SERIAL_BLOCKS,
                      out=log, allow_jax=False) -> dict:
    """bench.py configs 5 and 5b (bench.py:307, :371) at their shapes:
    BMT1 level 6 serialize and deserialize MB/s, COUNT_AND on the BLOB and
    the BLOB's KB, each round trip checked.  The reference codec's live
    A/B of bench.py needs the reference's sources and is left out.
    Raises when JAX is loaded, unless ``allow_jax``."""
    dev = bench_device(device)
    if dev.type == "cuda":
        out(f"card: {card_line()}")
    rng = np.random.default_rng(seed)
    bpb = C.BITS_PER_BLOCK
    size = blocks * bpb
    raw_mb = size / 8 / 1e6
    # config 5 (bench.py:315-319)
    idx = np.unique(rng.integers(0, size, size // 100))
    bv = tbm.BitVector.from_indices(idx, size, device=dev)
    bv.set_range(2 * bpb, 4 * bpb - 1)
    bv.optimize()
    want = np.union1d(idx, np.arange(2 * bpb, 4 * bpb))
    ser = tbm.Serializer(6)
    od = tbm.OperationDeserializer()
    t_ser, blob = _median_call(lambda: ser.serialize(bv), 21, dev)
    t_de, back = _median_call(lambda: tbm.deserialize(blob, device=dev),
                              21, dev)
    t_op, cnt = _median_call(
        lambda: od.deserialize(bv, blob, C.SET_COUNT_AND), 21, dev)
    if not (back.equal(bv) and np.array_equal(back.indices(), want)
            and cnt == want.size):
        raise AnswerMismatch("config 5: the BMT1 round trip or COUNT_AND "
                             "on the BLOB differs from the ids set")
    configs = {
        "5_serialize": {"value": raw_mb / (t_ser["median_ms"] / 1e3),
                        "unit": "MB/s", **t_ser},
        "5_deserialize": {"value": raw_mb / (t_de["median_ms"] / 1e3),
                          "unit": "MB/s", **t_de},
        "5_count_and_on_blob": {"value": t_op["median_ms"], "unit": "ms",
                                **t_op},
        "5_blob_size": {"value": len(blob) / 1e3, "unit": "KB"}}
    # config 5b (bench.py:381-396): sparse ids in blocks [0, 100), a FULL
    # span [100, 300), bursty runs above (of 512 blocks; scaled when cut)
    b1, b2 = blocks * 100 // 512, blocks * 300 // 512
    lo, hi = b1 * bpb, b2 * bpb - 1
    ids = np.unique(rng.integers(0, b1 * bpb, 20_000))
    starts = rng.integers(b2 * bpb, size - 400, 2000)
    lens = rng.integers(30, 300, 2000)
    burst = np.concatenate([np.arange(s, s + n)
                            for s, n in zip(starts, lens)])
    all_ids = np.unique(np.concatenate([ids, burst]))
    bv = tbm.BitVector.from_indices(all_ids, size, device=dev)
    bv.set_range(lo, hi)
    bv.optimize()
    t_ser, blob = _median_call(lambda: ser.serialize(bv), 11, dev)
    t_de, back = _median_call(lambda: tbm.deserialize(blob, device=dev),
                              11, dev)
    if not np.array_equal(back.indices(),
                          np.union1d(all_ids, np.arange(lo, hi + 1))):
        raise AnswerMismatch("config 5b: the BMT1 round trip differs")
    configs["5b_gap_corpus"] = {
        "ser_mbps": raw_mb / (t_ser["median_ms"] / 1e3),
        "deser_mbps": raw_mb / (t_de["median_ms"] / 1e3),
        "blob_kb": len(blob) / 1e3, "unit": "MB/s,KB",
        "ser": t_ser, "deser": t_de}
    if not allow_jax:
        forbid_jax()
    head = configs["5_serialize"]
    return {"metric": "bmt1_serialize_throughput", "value": head["value"],
            "unit": "MB/s", "vs_baseline": None, "cell": None, "seed": seed,
            "correct": True, "configs": configs, "device": device_info(dev)}


def main(argv=None) -> int:
    with open(BENCHMARK) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True,
                    choices=cells + ["serialization"])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if args.cell == "serialization":
        result = run_serialization(args.seed)
    else:
        result = run_cell(args.cell, args.seed)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
