#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bitmagic_tpu_torch``) on one NVIDIA card
and check it.

    python3 chip_smoke.py            # from the repository root, on the card

Phases (any failure raises and exits non-zero; the last line is printed
only when every phase passed):

 1. probe   — require CUDA; print the card's name and power limit;
 2. build   — compile the three kernels from ``ops/csrc`` with nvcc;
 3. kernels — each kernel against its plain PyTorch version on the card,
              bit for bit: all four ops, all seven metrics, 0 / 13 / 1536
              rows, descriptors with -1 slots, FULL rows and aux rows;
 4. main    — the benchmark's configs 1-2 through the entry points: two
              100.6M-bit vectors (1536 blocks) mixing BIT, GAP and FULL-run
              blocks; AND/OR/XOR/SUB, count(), distance_operation and
              count_and/or/xor/sub, 64 count_range calls, build_rs_index
              plus 1M select and 1M rank; every answer against numpy;
 5. fixtures — the reference C++ fixtures (tests/fixtures) through the port;
 6. scale   — two 2^30-bit vectors (16384 dense blocks, 128 MiB per pool)
              from seeded word images: the four ops, counts and metrics;
 7. timing  — each kernel, its plain version and the nearest single PyTorch
              call at the config-1 shapes (CUDA events, L2 flushed before
              each launch), beside the bound from bytes and popcounts.

The oracles are numpy and the committed fixtures; nothing of JAX or of the
JAX package is imported.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BPB = 65536                     # bits per block
N_BLOCKS = 1536                 # configs 1-2: ~100.6M bits (bench.py:35)
SCALE_BLOCKS = 16384            # 2^30 bits
SEED = 20261016
N_QUERIES = 1_000_000           # config-2 select / rank batch
N_RANGES = 64
METRICS = ("count_and", "count_xor", "count_or", "count_sub_ab",
           "count_sub_ba", "count_a", "count_b")
OPS = ("and", "or", "xor", "sub")
DUNDER = {"and": "__and__", "or": "__or__", "xor": "__xor__",
          "sub": "__sub__"}
# peak device-memory bandwidth by card (NVIDIA data sheets)
PEAK_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
           "H100": 3.35e12}
POPC_PER_CLK_PER_SM = 16        # __popc throughput, compute capability 9.0

KERNELS = {
    "block_counts": dict(
        source="bitmagic_tpu_torch/ops/csrc/block_counts.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:146"),
    "count_op": dict(
        source="bitmagic_tpu_torch/ops/csrc/count_op.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:118"),
    "logical_op_digest": dict(
        source="bitmagic_tpu_torch/ops/csrc/logical_op_digest.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:73"),
}


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: check failed: {what}")


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Clock:
    """Host wall time of a phase, ending in a device synchronize."""

    def __init__(self, name, out):
        self.name, self.out = name, out

    def __enter__(self):
        sync()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        sync()
        self.out[self.name] = round((time.perf_counter() - self.t0) * 1e3, 3)


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------
def image(bits: np.ndarray) -> np.ndarray:
    """bool[n_bits] -> uint32 words, LSB-first (the reference's layout)."""
    return np.packbits(bits, bitorder="little").view(np.uint32)


def oracle_op(op, a, b):
    return {"and": a & b, "or": a | b, "xor": a ^ b, "sub": a & ~b}[op]


def oracle_metric(m, a, b):
    x = {"count_and": a & b, "count_xor": a ^ b, "count_or": a | b,
         "count_sub_ab": a & ~b, "count_sub_ba": b & ~a, "count_a": a,
         "count_b": b}[m]
    return int(np.bitwise_count(x).sum(dtype=np.int64))


def oracle_rank(words: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """popcount of bits [0, i] for each id (ids >= -1)."""
    wcum = np.concatenate([[0], np.cumsum(np.bitwise_count(words),
                                          dtype=np.int64)])
    ids = np.asarray(ids, np.int64)
    ok = ids >= 0
    w = np.where(ok, ids >> 5, 0)
    mask = ((np.uint64(2) << (ids & 31).astype(np.uint64))
            - np.uint64(1)).astype(np.uint32)
    part = np.bitwise_count(words[w] & mask).astype(np.int64)
    return np.where(ok, wcum[w] + part, 0)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
def _rand_pool(rng, n, device):
    p = rng.integers(0, 2**32, (n, 2048), dtype=np.uint64).astype(np.uint32)
    if n > 3:
        p[1] = 0
        p[2] = 0xFFFFFFFF
        p[3, :1024] = 0
        p[3, ::64] = 0
    return torch.from_numpy(p.view(np.int32).copy()).to(device)


def _descriptor(rng, pool, k, n_aux, device):
    r = pool.shape[0]
    slot = (rng.integers(-1, r, k) if r else np.full(k, -1)).astype(np.int32)
    full = rng.random(k) < 0.15
    aux = _rand_pool(rng, n_aux, device)
    aux_slot = (np.where(rng.random(k) < 0.25, rng.integers(0, n_aux, k), -1)
                if n_aux else np.full(k, -1)).astype(np.int32)
    return (pool, torch.from_numpy(slot).to(device),
            torch.from_numpy(full).to(device), aux,
            torch.from_numpy(aux_slot).to(device))


def kernels_vs_plain(device, sizes=(0, 13, N_BLOCKS)):
    """Max |kernel - plain| per kernel over every case (0 required)."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(SEED + 1)
    err = {k: 0 for k in KERNELS}
    cases = {k: 0 for k in KERNELS}

    def cmp(name, got, want):
        sync()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(want.shape)} {want.dtype}")
        e = (int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
             if got.numel() else 0)
        err[name] = max(err[name], e)
        cases[name] += 1

    for n in sizes:
        a, b = _rand_pool(rng, n, device), _rand_pool(rng, n, device)
        cmp("block_counts", ck.block_counts(a), blockops.block_counts(a))
        for op in OPS:
            out, dig = ck.logical_op_digest(op, a, b)
            w_out, w_dig = blockops.logical_op_digest(op, a, b)
            cmp("logical_op_digest", out, w_out)
            cmp("logical_op_digest", dig, w_dig)
            # the digest is the wave digest of the written rows
            cmp("logical_op_digest", dig, blockops.calc_digest(out))
            cmp("count_op", ck.count_op(op, a, b),
                blockops.count_op(op, a, b))
    # gather-fused forms: -1 slots, FULL rows, aux rows, a 0-row pool,
    # an empty aux, a row count that is no tile multiple
    for k, ra, rb, aux_a, aux_b in ((13, 13, 7, 3, 0), (1, 0, 5, 2, 2),
                                    (301, 64, 0, 0, 5),
                                    (N_BLOCKS, N_BLOCKS, N_BLOCKS, 16, 0)):
        da = _descriptor(rng, _rand_pool(rng, ra, device), k, aux_a, device)
        db = _descriptor(rng, _rand_pool(rng, rb, device), k, aux_b, device)
        for op in OPS:
            out, dig = ck.binary_op_digest(op, da, db)
            w_out, w_dig = blockops.binary_op_digest(op, da, db)
            cmp("logical_op_digest", out, w_out)
            cmp("logical_op_digest", dig, w_dig)
        cmp("count_op", ck.count_metrics(METRICS, da, db),
            blockops.count_metrics(METRICS, da, db))
        sub = ("count_b", "count_sub_ba", "count_and")
        cmp("count_op", ck.count_metrics(sub, da, db),
            blockops.count_metrics(sub, da, db))
    for name, e in err.items():
        check(e == 0, f"{name} disagrees with its plain version: max "
                      f"abs err {e}")
    return err, cases


# ---------------------------------------------------------------------------
# phase 4: the main path at configs 1-2
# ---------------------------------------------------------------------------
def _clustered(rng, blk0, blk1, runs=20, max_len=200):
    """Ids in few runs per block (blocks that stay GAP)."""
    nblk = blk1 - blk0
    if nblk <= 0:
        return np.zeros(0, np.int64)
    starts = rng.integers(0, BPB - max_len, (nblk, runs))
    lens = rng.integers(1, max_len, (nblk, runs))
    off = np.arange(max_len)
    base = (np.arange(blk0, blk1, dtype=np.int64) * BPB)[:, None, None]
    ids = base + starts[..., None] + off[None, None, :]
    return ids[off[None, None, :] < lens[..., None]]


def build_main_vectors(tbm, n_blocks, device, times):
    """Vectors A and B of ``n_blocks`` blocks through the entry points, and
    their oracle bit arrays.  Regions, in units u = n_blocks / 24:
      A: BIT [0,16u)  GAP [16u,20u)  FULL run [20u,22u)  sparse [22u,24u)
      B: GAP [0,4u)  FULL run [4u,6u)  BIT [8u,16u)  GAP [16u,20u)
         BIT [20u,23u)
    so the four ops meet BIT x BIT, BIT x GAP, BIT x FULL, BIT x ZERO
    (device kernel), GAP x GAP (host run merge) and GAP x ZERO (GAP
    pass-through)."""
    from bitmagic_tpu_torch import constants as C
    u = n_blocks // 24
    size = n_blocks * BPB
    rng = np.random.default_rng(SEED)

    def dense_ids(blk0, blk1, per_block=8192):
        return rng.integers(blk0 * BPB, blk1 * BPB,
                            (blk1 - blk0) * per_block)

    bits = {}
    ids_a = dense_ids(0, 16 * u)
    gap_a = _clustered(rng, 16 * u, 20 * u)
    sparse_a = rng.integers(22 * u * BPB, size, 200)
    gap_b = np.concatenate([_clustered(rng, 0, 4 * u),
                            _clustered(rng, 16 * u, 20 * u)])
    ids_b = np.concatenate([dense_ids(8 * u, 16 * u),
                            dense_ids(20 * u, 23 * u)])
    with Clock("a_from_indices_ms", times):
        a = tbm.BitVector.from_indices(ids_a, size, device=device)
    with Clock("a_or_gap_ms", times):
        a |= tbm.BitVector.from_indices(gap_a, size, strategy=C.BM_GAP,
                                        device=device)
    with Clock("a_set_range_ms", times):
        a.set_range(20 * u * BPB, 22 * u * BPB - 1)
    with Clock("a_set_optimize_ms", times):
        for i in sparse_a:
            a.set(int(i))                    # staged, flushed by optimize
        a.optimize()
    with Clock("b_from_indices_ms", times):
        b = tbm.BitVector.from_indices(ids_b, size, device=device)
    with Clock("b_or_gap_ms", times):
        b |= tbm.BitVector.from_indices(gap_b, size, strategy=C.BM_GAP,
                                        device=device)
    with Clock("b_set_range_optimize_ms", times):
        b.set_range(4 * u * BPB, 6 * u * BPB - 1)
        b.optimize()
    for name, parts in (("a", [ids_a, gap_a, sparse_a]),
                        ("b", [ids_b, gap_b])):
        x = np.zeros(size, bool)
        for p in parts:
            x[p] = True
        bits[name] = x
    bits["a"][20 * u * BPB:22 * u * BPB] = True
    bits["b"][4 * u * BPB:6 * u * BPB] = True
    for v in (a, b):
        cls = set(np.unique(v._struct.cls).tolist())
        check({C.CLS_BIT, C.CLS_GAP} <= cls, f"block mix {cls}")
    if n_blocks >= 24 * 32:
        check(a._struct.has_runs and b._struct.has_runs, "FULL runs")
    return a, b, bits


def main_path(tbm, device, n_blocks=N_BLOCKS, n_queries=N_QUERIES):
    """Configs 1-2 through the entry points; returns the phase times (ms)
    and the state the steady-state profile reuses."""
    times = {}
    a, b, bits = build_main_vectors(tbm, n_blocks, device, times)
    wa, wb = image(bits["a"]), image(bits["b"])
    check(np.array_equal(a.to_words().ravel(), wa), "A word image")
    check(np.array_equal(b.to_words().ravel(), wb), "B word image")

    rng = np.random.default_rng(SEED + 2)
    results = {}
    for op in OPS:
        with Clock(f"{op}_ms", times):
            r = getattr(a, DUNDER[op])(b)
        with Clock(f"{op}_count_ms", times):
            cnt = r.count()
        results[op] = (r, cnt)
    for op, (r, cnt) in results.items():
        want = oracle_op(op, wa, wb)
        check(cnt == int(np.bitwise_count(want).sum(dtype=np.int64)),
              f"count({op})")
        check(np.array_equal(r.to_words().ravel(), want), f"{op} words")

    with Clock("distance_operation_ms", times):
        dist = tbm.distance_operation(a, b, list(METRICS))
    for m in METRICS:
        check(dist[m] == oracle_metric(m, wa, wb), f"distance {m}")
    with Clock("count_and_or_xor_sub_ms", times):
        pair = (tbm.count_and(a, b), tbm.count_or(a, b),
                tbm.count_xor(a, b), tbm.count_sub(a, b))
    check(pair == (dist["count_and"], dist["count_or"], dist["count_xor"],
                   dist["count_sub_ab"]), "count_* free functions")

    size = n_blocks * BPB
    lo = rng.integers(0, size, N_RANGES)
    hi = np.minimum(lo + rng.integers(0, size // 4, N_RANGES), size - 1)
    with Clock("count_range_x64_ms", times):
        got = [(a.count_range(x, y), b.count_range(x, y))
               for x, y in zip(lo, hi)]
    for (ga, gb), x, y in zip(got, lo, hi):
        for g, w in ((ga, wa), (gb, wb)):
            want = int(oracle_rank(w, [y])[0] - oracle_rank(w, [x - 1])[0])
            check(g == want, f"count_range({x}, {y})")

    with Clock("build_rs_index_ms", times):
        rs = a.build_rs_index()
    total = rs.count()
    check(total == int(bits["a"].sum()), "rs_index count")
    ranks = rng.integers(1, total + 1, n_queries)
    with Clock("select_1M_ms", times):
        pos = rs.select_batch(ranks)
    check(np.array_equal(pos, np.flatnonzero(bits["a"])[ranks - 1]),
          "select")
    ids = rng.integers(0, size, n_queries)
    with Clock("rank_1M_ms", times):
        rk = rs.rank_batch(ids)
    check(np.array_equal(rk, oracle_rank(wa, ids)), "rank")
    return times, (a, b, rs, ranks)


def steady_pass(tbm, a, b, rs, ranks):
    """One more pass of the main path's query work on built vectors."""
    for op in OPS:
        getattr(a, DUNDER[op])(b).count()
    tbm.distance_operation(a, b, list(METRICS))
    rs.select_batch(ranks)


def device_busy(fn):
    """(host wall ms of fn, device-busy ms, device ms by kernel name): the
    wall time from an unprofiled run, the device time from the kernel and
    copy events of a torch.profiler run of the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall, busy, {k[:60]: round(v / 1e3, 4) for k, v in top}


def fixtures_path(tbm, device):
    """The reference C++ fixtures through the port (as
    tests/test_reference_parity.py)."""
    fix = os.path.join(ROOT, "tests", "fixtures")

    def rd(f, n):
        return np.frombuffer(f.read(8 * n), "<u8").astype(np.int64)

    def u64(f):
        return struct.unpack("<Q", f.read(8))[0]

    with open(os.path.join(fix, "inputs.bin"), "rb") as f:
        ia = rd(f, u64(f))
        ib = rd(f, u64(f))
    with open(os.path.join(fix, "expected.bin"), "rb") as f:
        counts = rd(f, 6)
        ranks = rd(f, 2 * u64(f)).reshape(-1, 2)
        sels = rd(f, 2 * u64(f)).reshape(-1, 2)
        and_idx = rd(f, u64(f))
    a = tbm.BitVector.from_indices(ia, 100_000_000, device=device)
    b = tbm.BitVector.from_indices(ib, 100_000_000, device=device)
    got = [a.count(), b.count(), tbm.count_and(a, b), tbm.count_or(a, b),
           tbm.count_xor(a, b), tbm.count_sub(a, b)]
    check(got == counts.tolist(), f"fixture counts {got}")
    check(np.array_equal((a & b).indices(), and_idx), "fixture AND ids")
    rs = a.build_rs_index()
    check(np.array_equal(rs.rank_batch(ranks[:, 0]), ranks[:, 1]),
          "fixture ranks")
    check(np.array_equal(rs.select_batch(sels[:, 0]), sels[:, 1]),
          "fixture selects")


def scale_path(tbm, device, n_blocks=SCALE_BLOCKS):
    """Two 2^30-bit vectors from seeded word images: ops, counts, metrics."""
    times = {}
    rng = np.random.default_rng(SEED + 3)
    n_words = n_blocks * 2048
    wa = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    wb = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    wb[: n_words // 8] = 0                   # some zero blocks in B
    with Clock("from_words_ms", times):
        a = tbm.BitVector.from_words(wa, device=device)
        b = tbm.BitVector.from_words(wb, device=device)
    for op in OPS:
        with Clock(f"{op}_count_ms", times):
            cnt = getattr(a, {"and": "__and__", "or": "__or__",
                              "xor": "__xor__", "sub": "__sub__"}[op])(
                b).count()
        check(cnt == int(np.bitwise_count(oracle_op(op, wa, wb)).sum(
            dtype=np.int64)), f"scale count({op})")
    r = a & b
    check(np.array_equal(r.to_words().ravel(), wa & wb), "scale AND words")
    with Clock("distance_operation_ms", times):
        dist = tbm.distance_operation(a, b, list(METRICS))
    for m in METRICS:
        check(dist[m] == oracle_metric(m, wa, wb), f"scale distance {m}")
    return times


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------
def time_ms(fn, flush, reps=25):
    """Median device time of ``fn`` over ``reps`` runs after a warm-up.
    Before each run a 512 MiB memset evicts the 50 MB L2 and keeps the
    stream busy while the host enqueues the run, so the events bracket the
    device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def timings(device, card):
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(SEED + 4)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    out = {}
    for n in (N_BLOCKS, SCALE_BLOCKS):
        a, b = _rand_pool(rng, n, device), _rand_pool(rng, n, device)
        row, words = 8192, n * 2048
        cases = {
            # name: (kernel, plain, library call or None,
            #        bytes read + written, popcounts)
            "block_counts": (lambda: ck.block_counts(a),
                             lambda: blockops.block_counts(a), None,
                             n * row + n * 4, words),
            "count_op": (lambda: ck.count_op("and", a, b),
                         lambda: blockops.count_op("and", a, b), None,
                         2 * n * row + n * 4, words),
            "logical_op_digest": (
                lambda: ck.logical_op_digest("and", a, b),
                lambda: blockops.logical_op_digest("and", a, b),
                lambda: torch.bitwise_and(a, b),
                3 * n * row + n * 256, 0),
        }
        for name, (kern, plain, lib, nbytes, popc) in cases.items():
            ms = time_ms(kern, flush)
            pms = time_ms(plain, flush, reps=5)
            lms = time_ms(lib, flush) if lib is not None else None
            bytes_ms = nbytes / card["peak_bw"] * 1e3
            ops_ms = popc / card["popc_rate"] * 1e3
            out[(name, n)] = dict(
                ms=ms, plain_ms=pms, library_ms=lms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, gb_per_s=nbytes / (ms * 1e-3) / 1e9)
        del a, b
    return out


# ---------------------------------------------------------------------------
def nvidia_smi(fields):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on an NVIDIA card and has nothing to run "
              "here", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import _build
    from bitmagic_tpu_torch.ops import cuda_kernels as ck

    # 1. probe
    device = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak_bw = next((v for k, v in PEAK_BW.items() if k in name),
                   PEAK_BW["H100"])
    card = dict(name=name, smi=smi, peak_bw=peak_bw,
                popc_rate=props.multi_processor_count * POPC_PER_CLK_PER_SM
                * max_clk_mhz * 1e6)
    log(f"probe: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{props.multi_processor_count} SMs, max SM clock {max_clk_mhz} MHz; "
        f"peak memory bandwidth used for bounds {peak_bw / 1e12} TB/s")
    check(tbm.simd_version() == "cuda:kernel", "simd_version")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    for src in _build.SOURCES:
        _build.load(src)
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.SOURCES)} "
        f"sources into {_build.BUILD_DIR}")
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {src}: {line.strip()}")

    # 3. kernels against their plain versions
    err, cases = kernels_vs_plain(device)
    log(f"kernels: bit-identical to the plain versions: {cases} cases, "
        f"max abs err {err}")

    # 4. main path: counts read just before and just after
    ck.reset_launches()
    t0 = time.perf_counter()
    main_times, state = main_path(tbm, device)
    main_launches = dict(ck.launches)
    log(f"main: configs 1-2 passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {main_launches}; phase ms {json.dumps(main_times)}")
    for k in KERNELS:
        check(main_launches[k] > 0, f"main path never launched {k}")
    wall, busy, top = device_busy(lambda: steady_pass(tbm, *state))
    log(f"profile: steady pass (4 ops + counts, distance_operation, 1M "
        f"select) host wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f} % busy); device ms by kernel "
        f"{json.dumps(top)}" if busy else
        f"profile: steady pass host wall {wall:.3f} ms; device busy not "
        f"measured (the profiler recorded no device events)")
    del state

    # 5. reference fixtures
    ck.reset_launches()
    fixtures_path(tbm, device)
    log(f"fixtures: reference counts, AND ids, ranks and selects match; "
        f"launches {dict(ck.launches)}")

    # 6. 2^30-bit scale phase
    ck.reset_launches()
    t0 = time.perf_counter()
    scale_times = scale_path(tbm, device)
    log(f"scale: 2^30 bits passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {dict(ck.launches)}; phase ms {json.dumps(scale_times)}")

    # 7. timing
    tm = timings(device, card)
    kernels = []
    for k, meta in KERNELS.items():
        for n in (N_BLOCKS, SCALE_BLOCKS):
            t = tm[(k, n)]
            log(json.dumps({"kernel": k, "rows": n, **{
                x: t[x] for x in ("ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by", "bytes",
                                  "gb_per_s")},
                "main_path_launches": main_launches[k],
                "card": card["smi"]}))
        t = tm[(k, N_BLOCKS)]
        kernels.append({"name": k, "route": "cuda", **meta,
                        "launches": main_launches[k],
                        "max_abs_err": err[k], "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    log(f"card: {nvidia_smi('name,power.limit')}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
