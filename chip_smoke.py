#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bitmagic_tpu_torch``) on one NVIDIA card
and check it.

    python3 chip_smoke.py            # from the repository root, on the card

Phases (any failure raises and exits non-zero; the last line is printed
only when every phase passed):

 1. probe   — require CUDA; print the card's name and power limit;
 2. build   — compile the six kernels from ``ops/csrc`` with nvcc, all at
              once;
 3. kernels — each kernel against its plain PyTorch version on the card,
              bit for bit: all four ops, every subset of the seven metrics,
              0 to 16384 rows, descriptors with -1 slots, FULL rows and aux
              rows, K2 and K3 with and without their totals; the
              K-way sweep (B4) in arena and descriptor form, with -1 slots
              on both sides, early-dying and never-dying columns, an empty
              pool, OR mode, rows-off counts summed over the slices of
              a column, slices dying at different operands, and the
              batched form with 1 and 64 requests (one launch each); the
              pipeline counts (B5) for 1 / 7 / 130 / 256 values over 0 to
              400 planes (every ceiling of the register path, the shared
              path at its edges), with and without skipped planes; the
              equality scan (B6) at config 4;
 4. main    — the benchmark's configs 1-2 through the entry points: two
              100.6M-bit vectors (1536 blocks) mixing BIT, GAP and FULL-run
              blocks; AND/OR/XOR/SUB, count(), distance_operation and
              count_and/or/xor/sub, 64 count_range calls, build_rs_index
              plus 1M select and 1M rank; every answer against numpy;
              count() and distance_operation each launch their kernel once
              and a profiler trace shows no other kernel (no sum) in them;
 5. agg     — config 3 (bench.py:225): 200 vectors x 128 blocks mixing
              dense, GAP and FULL-run blocks; combine_and_sub with 100 AND /
              100 SUB and with 3 / 2, combine_and, combine_or,
              find_first_and_sub, combine_and_sub_arena over one arena of
              all 200, and a 64-request pipeline in counts and in result
              mode (one B4 launch for the batch); every answer against
              numpy;
 6. scan    — config 4b (bench.py:280): a nullable 16M-element uint32
              SparseVector (values < 2^20, ~1 % NULL); a prepared pipeline
              counting 256 values, pipeline_find_eq of 8 values, find_eq,
              find_first_eq, find_ne and find_nonzero against numpy;
 7. algo    — the rest of BitVector and the algorithms on configs 1-2's
              vectors A and B: insert and erase (a block edge, mid-block,
              bit 0), shift_left, flip, compare / find_first_mismatch,
              merge, bit_or_and, calc_stat, the find walks, intervals and
              count_intervals, rank_compress both ways, random_subset,
              rank_range_split, Kleene AND / OR, the enumerator (a walk of
              ENUM_WALK positions, then jumps across the vector); a
              similarity batch over 16 dense vectors of config-1 width
              (201 MB of rows, 120 pairs) and the Jaccard batch over config
              4b's value planes; every answer against numpy.  It lists the
              kernels each entry point puts on the card (K1 for insert and
              erase, K2 for the batches, K3 for count()), profiles a steady
              pass and requires the native codec library from the port's
              own ``_build/``;
 8. serial  — serialization: configs 1-2's A and B as BMT1 BLOBs (levels
              1, 4, 6, 6 with bookmarks) and reference-format BLOBs, each
              decoded back onto the card and byte-identical to the BLOB of
              the same vector built on the CPU; the OperationDeserializer's
              four set ops and eight counts and deserialize_range with B's
              BLOBs of both formats into A; the stream iterator over A's
              BLOB; bench.py configs 5 and 5b at their own shapes
              (serialize, deserialize, COUNT_AND on the BLOB, best of 21 /
              11, MB/s of the raw bitmap); the 94 bit-vector BLOBs of the
              reference (tests/fixtures/refblobs) decoded onto the card.
              It lists the kernels each entry point puts on the card (K1
              for the set ops on a run-coded BLOB and deserialize_range, K2
              for COUNT_AND on it, K3 for the pass-through counts of a
              streamed BLOB), counts the host copies of one streamed op and
              profiles config 5's steady pass;
 9. sv      — the rest of the sparse vectors, in groups: config 4b's column
              through find_gt/ge/lt/le/range/nonnegative (plain, then under
              an AND mask and a search range); a 16M-element nullable int32
              column across zero and at the iinfo edges; 16M sorted uint32
              with bind and SV_PROBES lower_bound / bfind_eq probes; a
              16M-element nullable float32 column with +-0.0 and repeats
              through the float searches; a dictionary of 2^22 sorted
              catalog ids, remapped, optimized and frozen, and a raw copy:
              exact, prefix and first-hit searches, SV_PROBES bound
              bfind_eq_str probes and the string pipeline of 500 present +
              100 missing ids on both forms; samples/11's RSC column (100M
              rows, 100k values) through from_sparse_vector, gather, the
              RSC searches, count_range_notnull and load_to; and
              find_first_mismatch, set2set_transform and BitMatrix rows on
              config 4b's column; every answer against numpy or Python.
              Each group has its own launch counts and required kernels;
              it logs one find_gt's K1 launches and profiles a steady pass;
10. sv_serial — every column of phase 9 (config 4b's, the signed and
              float columns, the dictionary remapped and raw, the RSC
              column) through BMSV with XOR groups on and off,
              deserialize_range, deserialize_gather of 1M ids and the
              reference-format BLOBs: each BLOB byte-equal to the same
              column's on the CPU, each decode equal to the source on the
              card (MB/s of serialize / deserialize, ms of the reference
              routes); then the reference's five sparse-vector BLOBs;
11. sharded — a mesh of 8 shards on the one card: two 2^30-bit vectors and
              one of 2^31 + 2^16 bits (both select routes) through the four
              ops, count, count_range, 1M select and rank, get_bits,
              reshard to one shard and the checkpoint; sharded_and_many over
              8 vectors with and without digest narrowing,
              sharded_and_sub_count, group_and_exchange on a vector-axis
              mesh; the config 4b stack through pipeline_counts_host (256
              selectors) and scan_throughput_program; the four sharded
              sparse vectors built from phase 9's columns (searches,
              pipelines, gather, checkpoint); then the bit-vector group and
              config 4b's searches on make_mesh() (every visible card);
              exact per-step launch counts (one per shard) and a profile of
              one steady pass;
12. fixtures — the reference C++ fixtures (tests/fixtures) through the port;
13. scale   — two 2^30-bit vectors (16384 dense blocks, 128 MiB per pool)
              from seeded word images: the four ops, counts and metrics;
              then 200 vectors x 1536 blocks (2.5 GB of operand rows): the
              combine_and_sub pair of phase 5 and a 64-request counts
              pipeline;
14. timing  — each kernel, its plain version and the nearest single PyTorch
              call at the main paths' shapes (CUDA events, L2 flushed
              before each launch), beside the bound from bytes and integer
              operations: K2 and K3 also at config 1's own shapes and in
              their total forms; the floor of a timed launch; K3 after a
              flush that leaves L2 clean.

Each path (4, 5, 6, 7, 8, 10 and each group of 9 and 11) is driven with the launch
counts set to 0 just before and read just after; a kernel of the path
launched no time fails it.

The oracles are numpy and the committed fixtures; nothing of JAX or of the
JAX package is imported.
"""

from __future__ import annotations

import itertools
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
LOP_PER_CLK_PER_SM = 64         # 32-bit logic ops (LOP3), compute cap. 9.0
AGG_K, AGG_BLOCKS = 200, 128    # config 3: 200 vectors x 8.4M bits
AGG_SCALE_BLOCKS = 1536         # 200 x 1536 blocks = 2.5 GB of rows
N_REQUESTS = 64                 # aggregator pipeline batch
SV_N, SV_BITS = 16_000_000, 20  # config 4b: 16M values < 2^20
SV_QUERIES, SV_EQ = 256, 8
SCAN_PLANES, SCAN_BLOCKS = 32, 512   # config 4 (bench.py:255)
SIM_VECTORS = 16                # algo phase: 16 x 1536 dense rows, 201 MB
# The algo phase walks A's enumerator one position at a time only this
# far: a Python step costs about a microsecond, and A holds ~17M positions
# (a full walk would take a large share of the script's time limit);
# go_to, skip and skip_to_rank jumps cover the rest of the vector.
ENUM_WALK = 1 << 20
# sv phase: SV_PROBES sorted probes per column, a string dictionary of
# STR_N catalog ids with a pipeline of STR_PRESENT + STR_MISSING ids
# (samples/16_compressed_dictionary.py's mix), and samples/11's RSC column
SV_PROBES = 1000
STR_N, STR_PRESENT, STR_MISSING = 1 << 22, 500, 100
RSC_ROWS, RSC_VALUES = 100_000_000, 100_000

KERNELS = {
    "block_counts": dict(
        source="bitmagic_tpu_torch/ops/csrc/block_counts.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:147"),
    "count_op": dict(
        source="bitmagic_tpu_torch/ops/csrc/count_op.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:119"),
    "logical_op_digest": dict(
        source="bitmagic_tpu_torch/ops/csrc/logical_op_digest.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:74"),
    "agg_and_sub": dict(
        source="bitmagic_tpu_torch/ops/csrc/agg_sub.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:270"),
    "pipeline_counts": dict(
        source="bitmagic_tpu_torch/ops/csrc/pipeline_counts.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:428"),
    "scan_eq": dict(
        source="bitmagic_tpu_torch/ops/csrc/scan_eq.cu",
        replaces="bitmagic_tpu/ops/pallas_kernels.py:310"),
}
FIRST_SLICE = ("block_counts", "count_op", "logical_op_digest")
# the kernel (launch counter, device function) an algo-phase entry point
# must put on the card
ALGO_KERNEL = {"insert": ("logical_op_digest", "binary_digest_kernel"),
               "erase": ("logical_op_digest", "binary_digest_kernel"),
               "count": ("block_counts", "block_counts_kernel"),
               "similarity_batch": ("count_op", "count_metrics_kernel"),
               "jaccard_batch": ("count_op", "count_metrics_kernel")}


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
    count_kernels_vs_plain(rng, device, cmp)
    search_kernels_vs_plain(rng, device, cmp)
    for name, e in err.items():
        check(e == 0, f"{name} disagrees with its plain version: max "
                      f"abs err {e}")
    return err, cases


def count_kernels_vs_plain(rng, device, cmp):
    """K3 and K2 at 1 to 16384 rows (the total's atomics from many CTAs);
    every subset of the seven metrics in a random order, counted directly
    or combined from |a&b|, |a| and |b| (blockops.count_plan), over rows
    of all ones and zeros, FULL, aux and -1 rows; the total forms with and
    without the per-block output."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck

    def cmp_total(name, got, want):
        cmp(name, got[0], want[0])
        check((got[1] is None) == (want[1] is None), f"{name}: per-block")
        if want[1] is not None:
            cmp(name, got[1], want[1])

    for n in (1, 31, 32, 33, 4097, SCALE_BLOCKS):
        a, b = _rand_pool(rng, n, device), _rand_pool(rng, n, device)
        cmp("block_counts", ck.block_counts(a), blockops.block_counts(a))
        for per_block in (False, True):
            cmp_total("block_counts", ck.block_counts_total(a, per_block),
                      blockops.block_counts_total(a, per_block))
        for op in OPS:
            cmp("count_op", ck.count_op(op, a, b),
                blockops.count_op(op, a, b))
        del a, b
    for n in (0, N_BLOCKS):
        a = _rand_pool(rng, n, device)
        for per_block in (False, True):
            cmp_total("block_counts", ck.block_counts_total(a, per_block),
                      blockops.block_counts_total(a, per_block))
    # every subset of the metrics, in a random order, at 301 blocks; all
    # seven and one metric, per block and in total, in both regimes
    subsets = [tuple(rng.permutation([m for j, m in enumerate(METRICS)
                                      if mask >> j & 1]).tolist())
               for mask in range(1, 1 << len(METRICS))]
    for k, ra, rb, aux_a, aux_b in ((301, 64, 90, 5, 3), (33, 40, 0, 0, 4),
                                    (N_BLOCKS, N_BLOCKS, 900, 16, 8),
                                    (SCALE_BLOCKS, 2048, 2048, 32, 0)):
        da = _descriptor(rng, _rand_pool(rng, ra, device), k, aux_a, device)
        db = _descriptor(rng, _rand_pool(rng, rb, device), k, aux_b, device)
        for ms in (subsets if k == 301 else [METRICS, ("count_and",),
                                              ("count_sub_ba", "count_or")]):
            cmp("count_op", ck.count_metrics(ms, da, db),
                blockops.count_metrics(ms, da, db))
            for per_block in (False, True):
                cmp_total("count_op",
                          ck.count_metrics_total(ms, da, db, per_block),
                          blockops.count_metrics_total(ms, da, db,
                                                       per_block))
        del da, db
    # rows of all ones against rows of zeros and against themselves
    ones = torch.full((40, 2048), -1, dtype=torch.int32, device=device)
    zeros = torch.zeros_like(ones)
    for x, y in ((ones, zeros), (zeros, ones), (ones, ones)):
        dx, dy = _aligned_desc(x), _aligned_desc(y)
        cmp("count_op", ck.count_metrics(METRICS, dx, dy),
            blockops.count_metrics(METRICS, dx, dy))


def _aligned_desc(pool):
    """The gather descriptor of an aligned pool: row i at slot i."""
    k, dev = pool.shape[0], pool.device
    return (pool, torch.arange(k, dtype=torch.int32, device=dev),
            torch.zeros(k, dtype=torch.bool, device=dev), pool[:0],
            torch.full((k,), -1, dtype=torch.int32, device=dev))


def _bits_pool(rng, n, or_k, device):
    """n rows whose bits are set with probability 1 - 2^-or_k (the OR of
    or_k uniform random words)."""
    w = np.zeros((n, 2048), np.uint32)
    for _ in range(or_k):
        w |= rng.integers(0, 2**32, (n, 2048), dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def search_kernels_vs_plain(rng, device, cmp):
    """B4, B5 and B6 against their plain versions at sizes 0, 13 and the
    config shapes (config 3: K = 200 over 128 columns; config 4b: 21 planes
    x 245 blocks x 256 values; config 4: 32 planes x 512 blocks)."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    i32 = torch.int32
    # B4, arena form: -1 slots on both sides; at config 3 random rows die
    # after ~17 ANDs while dense rows (density 0.97) never die
    for K, n_and, nb, rows, dens in ((7, 4, 0, 20, 1), (7, 4, 13, 20, 1),
                                     (AGG_K, AGG_K // 2, AGG_BLOCKS,
                                      AGG_K * 4, 1),
                                     (5, 3, AGG_BLOCKS, 64, 5),
                                     (21, 13, 245, 21 * 8, 4)):
        pool = _bits_pool(rng, rows, dens, device)
        slots = rng.integers(0, rows, (K, nb)).astype(np.int32)
        slots[rng.random((K, nb)) < 0.1] = -1
        sl = torch.from_numpy(slots).to(device)
        cmp("agg_and_sub", ck.agg_and_sub_arena(n_and, K - n_and, sl, pool),
            blockops.agg_and_sub_arena(n_and, K - n_and, sl, pool))
    # an empty pool: every slot -1
    empty = torch.full((3, 13), -1, dtype=i32, device=device)
    cmp("agg_and_sub", ck.agg_and_sub_arena(2, 1, empty, pool[:0]),
        blockops.agg_and_sub_arena(2, 1, empty, pool[:0]))
    # descriptor form: FULL rows, aux rows, OR mode, rows-off counts
    for k, K in ((13, 6), (AGG_BLOCKS, 40)):
        pool = _bits_pool(rng, 64, 4, device)
        descs = [_descriptor(rng, pool, k, 3 if j % 2 else 0, device)
                 for j in range(K)]
        for n_and, or_mode in ((K // 2, False), (K, False), (0, True)):
            r, c = ck.agg_and_sub(n_and, descs, or_mode=or_mode, counts=True)
            wr, wc = blockops.agg_and_sub(n_and, descs, or_mode=or_mode,
                                          counts=True)
            cmp("agg_and_sub", r, wr)
            cmp("agg_and_sub", c, wc)
            cmp("agg_and_sub", ck.agg_and_sub(n_and, descs, or_mode=or_mode,
                                              rows=False, counts=True)[1], wc)
    # the four slices of one column die at different operands (0, 5,
    # never, 9); rows and rows-off counts summed over the slices
    srows = np.full((16, 2048), 0xFFFFFFFF, np.uint32)
    srows[:, 512:1536] = rng.integers(0, 2**32, (16, 1024), dtype=np.uint32
                                      ) | np.uint32(1)
    srows[0, :512] = 0
    srows[5, 512:1024] = 0
    srows[1:12, 1024:1536] = 0xFFFFFFFF
    srows[12:, 1024:1536] = 0
    srows[9, 1536:] = 0
    spool = torch.from_numpy(srows.view(np.int32).copy()).to(device)
    descs = [(spool[j:j + 1], None, None, None, None) for j in range(16)]
    r, c = ck.agg_and_sub(12, descs, counts=True)
    wr, wc = blockops.agg_and_sub(12, descs, counts=True)
    check(bool((wr[0, :512] == 0).all()) and bool(wr[0, 1024:1536].any()),
          "B4 slice case: slices die at different operands")
    cmp("agg_and_sub", r, wr)
    cmp("agg_and_sub", c, wc)
    cmp("agg_and_sub", ck.agg_and_sub(12, descs, rows=False,
                                      counts=True)[1], wc)
    # the batched form: 1 request and 64 (n_and = 0, no SUB, no operands),
    # one launch each
    stack = _bits_pool(rng, 12 * AGG_BLOCKS, 3, device).reshape(
        12, AGG_BLOCKS, 2048)
    sdescs = [(stack[j], None, None, None, None) for j in range(12)]
    for V in (1, N_REQUESTS):
        sel = rng.integers(-1, 2, (V, 12)).astype(np.int32)
        sel[0, 0] = 1
        if V > 3:
            sel[1] = 0
            sel[2] = -np.abs(sel[2])
            sel[3] = np.abs(sel[3])
        req = blockops.selector_requests(sel)
        n0 = ck.launches["agg_and_sub"]
        r, c = ck.agg_and_sub_batch(sdescs, *req, counts=True)
        check(ck.launches["agg_and_sub"] == n0 + 1, "batched B4: one launch")
        wr, wc = blockops.agg_and_sub_batch(sdescs, *req, counts=True)
        cmp("agg_and_sub", r, wr)
        cmp("agg_and_sub", c, wc)
    # B5: 1 / 7 / 256 values over 21 / 33 planes, with and without skips;
    # the config-4b and config-3 pipeline shapes; every ceiling of the
    # register path and the shared path at its edges (0 .. 400 planes)
    b5_cases = [(21, 13, 1), (21, 13, 7), (33, 13, 256), (21, 0, 7),
                (SV_BITS + 1, 245, SV_QUERIES),
                (AGG_K, AGG_BLOCKS, N_REQUESTS)]
    b5_cases += [(S, 2, 130 if S <= ck.PIPELINE_REG_PLANES else 9)
                 for S in (0, 1, 8, 16, 24, 32, 33, 40, 48, 56, 64, 65, 72,
                           73, 144, 145, 200, 400)]
    for S, nb, V in b5_cases:
        planes = _bits_pool(rng, S * nb, 1, device).reshape(S, nb, 2048)
        for skip in (False, True):
            sel = rng.choice(np.asarray([-1, 1], np.int32), (V, S))
            if skip:
                sel[rng.random((V, S)) < 0.5] = 0
                sel[0] = 0                       # a row of skips only
                if S > 2:
                    sel[:, S // 2] = 0           # a plane never staged
            st = torch.from_numpy(sel).to(device)
            cmp("pipeline_counts", ck.pipeline_counts(planes, st),
                blockops.pipeline_counts(planes, sel))
    # B6: config 4, and 0 / 13 blocks
    for S, nb in ((SCAN_PLANES, 0), (SCAN_PLANES, 13),
                  (SCAN_PLANES, SCAN_BLOCKS)):
        planes = _rand_pool(rng, S * nb, device).reshape(S, nb, 2048)
        for value in (0, 123456789, 0xFFFFFFFF):
            cmp("scan_eq", ck.scan_eq(S, planes, value),
                blockops.scan_eq(S, planes, value))


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

    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(SEED + 2)
    results = {}
    for op in OPS:
        with Clock(f"{op}_ms", times):
            r = getattr(a, DUNDER[op])(b)
        n0 = ck.launches["block_counts"]
        with Clock(f"{op}_count_ms", times):
            cnt = r.count()
        check(ck.launches["block_counts"] == n0 + 1,
              f"count({op}) launched K3 once")
        results[op] = (r, cnt)
    for op, (r, cnt) in results.items():
        want = oracle_op(op, wa, wb)
        check(cnt == int(np.bitwise_count(want).sum(dtype=np.int64)),
              f"count({op})")
        check(np.array_equal(r.to_words().ravel(), want), f"{op} words")

    n0 = ck.launches["count_op"]
    with Clock("distance_operation_ms", times):
        dist = tbm.distance_operation(a, b, list(METRICS))
    check(ck.launches["count_op"] == n0 + 1,
          "distance_operation launched K2 once")
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


def device_kernels(fn):
    """Names of the kernels one run of ``fn`` put on the card (copies and
    memsets left out), from a torch.profiler trace after a warm-up run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def k2_operands(a, b):
    """The gather descriptors distance_operation hands K2 for vectors a and
    b: the candidate blocks where at least one side is a BIT row."""
    from bitmagic_tpu_torch.core.blocks import operand_args
    cand = np.union1d(a._struct.nb, b._struct.nb)
    st_a, _ = a._struct.lookup(cand)
    st_b, _ = b._struct.lookup(cand)
    rows = cand[(st_a == 2) | (st_b == 2)]
    return operand_args(a, rows), operand_args(b, rows)


def profile(what, fn):
    wall, busy, top = device_busy(fn)
    log(f"profile: {what}: host wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} % busy); device ms by "
        f"kernel {json.dumps(top)}" if busy else
        f"profile: {what}: host wall {wall:.3f} ms; device busy not "
        f"measured (the profiler recorded no device events)")


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
# phases 5, 6 and the search scale phase: the aggregator and the scanner
# ---------------------------------------------------------------------------
def agg_words(rng, k, n_blocks):
    """Word images uint32[k, n_blocks * 2048] of config 3's vectors: uniform
    random words (bench.py:227) in the first 3/4 of the blocks; in the last
    quarter vector j is all ones (j % 5 == 0: a FULL run once 32 blocks or
    more), absent (j % 5 == 1) or ten word runs per block (GAP after
    optimize)."""
    w = rng.integers(0, 2**32, (k, n_blocks * 2048), dtype=np.uint32)
    q = (3 * n_blocks // 4) * 2048
    idx = np.arange(2048)
    for j in range(k):
        w[j, q:] = 0xFFFFFFFF if j % 5 == 0 else 0
        if j % 5 < 2:
            continue
        tail = w[j, q:].reshape(-1, 2048)
        starts = rng.integers(0, 2048 - 40, (tail.shape[0], 10))
        lens = rng.integers(1, 40, (tail.shape[0], 10))
        on = ((idx[None, None] >= starts[..., None])
              & (idx[None, None] < (starts + lens)[..., None])).any(axis=1)
        tail[on] = 0xFFFFFFFF
    return w


def oracle_and_sub(W, and_idx, sub_idx):
    acc = np.bitwise_and.reduce(W[and_idx], axis=0)
    if len(sub_idx):
        acc &= ~np.bitwise_or.reduce(W[sub_idx], axis=0)
    return acc


def _popcount(words) -> int:
    return int(np.bitwise_count(words).sum(dtype=np.int64))


def agg_requests(rng, k, n):
    """n pipeline requests of 1-4 AND and 0-3 SUB vector indices."""
    reqs = []
    for _ in range(n):
        a = rng.choice(k, int(rng.integers(1, 5)), replace=False)
        s = rng.choice(np.setdiff1d(np.arange(k), a), int(rng.integers(0, 4)),
                       replace=False)
        reqs.append((a.tolist(), s.tolist()))
    return reqs


def agg_path(tbm, device, n_blocks=AGG_BLOCKS):
    """Config 3 through the aggregator's entry points; every answer against
    numpy.  Returns the phase times (ms) and the state of the steady pass."""
    from bitmagic_tpu_torch import constants as C
    from bitmagic_tpu_torch.agg.arena import OperandArena
    times = {}
    rng = np.random.default_rng(SEED + 5)
    W = agg_words(rng, AGG_K, n_blocks)
    with Clock("build_200_optimize_ms", times):
        vecs = [tbm.BitVector.from_words(W[j], device=device).optimize()
                for j in range(AGG_K)]
    cls = set()
    for v in vecs:
        cls |= set(np.unique(v._struct.cls).tolist())
    check({C.CLS_BIT, C.CLS_GAP} <= cls, f"config 3 block mix {cls}")
    if n_blocks // 4 >= 32:
        check(any(v._struct.has_runs for v in vecs), "config 3 FULL runs")
    agg = tbm.Aggregator()
    big = (list(range(AGG_K // 2)), list(range(AGG_K // 2, AGG_K)))
    small = ([0, 2, 3], [7, 12])
    for name, (a, sb) in (("and_sub_100_100", big), ("and_sub_3_2", small)):
        with Clock(f"{name}_ms", times):
            r = agg.combine_and_sub([vecs[i] for i in a],
                                    [vecs[i] for i in sb])
        want = oracle_and_sub(W, a, sb)
        check(np.array_equal(r.to_words().ravel(), want), f"config 3 {name}")
        if name == "and_sub_3_2":
            check(want.any(), "config 3: the 3 / 2 result is not empty")
            with Clock("find_first_and_sub_ms", times):
                ff = agg.find_first_and_sub([vecs[i] for i in a],
                                            [vecs[i] for i in sb])
            bits = np.unpackbits(want.view(np.uint8), bitorder="little")
            check(ff == int(np.flatnonzero(bits)[0]), "find_first_and_sub")
    with Clock("combine_and_4_ms", times):
        r = agg.combine_and([vecs[i] for i in (0, 2, 5, 8)])
    check(np.array_equal(r.to_words().ravel(),
                         oracle_and_sub(W, [0, 2, 5, 8], [])), "combine_and")
    # the vectors without FULL runs (a run sends combine_or to the
    # run-aware left fold instead of the K-way kernel)
    no_run = [j for j in range(AGG_K) if j % 5]
    with Clock("combine_or_160_ms", times):
        r = agg.combine_or([vecs[j] for j in no_run])
    check(np.array_equal(r.to_words().ravel(),
                         np.bitwise_or.reduce(W[no_run], axis=0)),
          "combine_or")
    with Clock("arena_build_ms", times):
        arena = OperandArena(vecs)
        arena.pool
    for name, (a, sb) in (("arena_100_100", big), ("arena_3_2", small)):
        with Clock(f"{name}_ms", times):
            r = agg.combine_and_sub_arena(arena, a, sb)
        check(np.array_equal(r.to_words().ravel(), oracle_and_sub(W, a, sb)),
              f"config 3 {name}")
    reqs = agg_requests(rng, AGG_K, N_REQUESTS)
    groups = [([vecs[i] for i in a], [vecs[i] for i in sb]) for a, sb in reqs]
    wants = [oracle_and_sub(W, a, sb) for a, sb in reqs]
    with Clock("pipeline_64_counts_ms", times):
        out = agg.pipeline(groups, tbm.AggOptions().set_compute_count())
    check([o["count"] for o in out] == [_popcount(w) for w in wants],
          "pipeline counts")
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    n0 = ck.launches["agg_and_sub"]
    with Clock("pipeline_64_results_ms", times):
        out = agg.pipeline(groups, tbm.AggOptions(compute_counts=True))
    check(ck.launches["agg_and_sub"] == n0 + 1,
          "the 64-request result pipeline made one B4 launch, not "
          f"{ck.launches['agg_and_sub'] - n0}")
    for o, w in zip(out, wants):
        check(o["count"] == _popcount(w), "pipeline result count")
        check(np.array_equal(o["bv"].to_words().ravel(), w),
              "pipeline result rows")
    return times, (agg, vecs, big, small, groups)


def agg_steady_pass(tbm, agg, vecs, big, small, groups):
    for a, sb in (big, small):
        agg.combine_and_sub([vecs[i] for i in a], [vecs[i] for i in sb])
    agg.pipeline(groups, tbm.AggOptions().set_compute_count())


def config4b_values():
    """(the generator, values, NULL mask) of config 4b's column."""
    rng = np.random.default_rng(SEED + 6)
    vals = rng.integers(0, 1 << SV_BITS, SV_N).astype(np.uint32)
    return rng, vals, rng.random(SV_N) < 0.01


def scan_path(tbm, device):
    """Config 4b through the scanner's entry points: a nullable 16M-element
    uint32 SparseVector with values < 2^20 and ~1 % NULL; answers against
    np.bincount and ==."""
    times = {}
    rng, vals, nm = config4b_values()
    live = np.where(nm, np.uint32(0), vals)
    with Clock("from_array_16M_ms", times):
        sv = tbm.SparseVector.from_array(vals, nullable=True, null_mask=nm,
                                         device=device)
    check(sv.size == SV_N and sv.effective_slices() == SV_BITS,
          "config 4b planes")
    ids = rng.integers(0, SV_N, 100_000)
    check(np.array_equal(sv.gather(ids), live[ids]), "config 4b gather")
    counts = np.bincount(vals[~nm], minlength=1 << SV_BITS)
    queries = rng.integers(1, 1 << SV_BITS, SV_QUERIES)
    queries[0] = 0                              # the find_zero route
    # values that occur, for the searches that return positions
    queries[1:1 + SV_EQ] = vals[rng.choice(np.flatnonzero(live), SV_EQ)]
    sc = tbm.scanner
    with Clock("prepare_pipeline_ms", times):
        prep = sc.prepare_pipeline(sv)
    with Clock("pipeline_counts_256_ms", times):
        got = prep.counts(queries.tolist())
    check(got == counts[queries].tolist(), "config 4b pipeline counts")
    eqv = queries[1:1 + SV_EQ].tolist()
    with Clock("pipeline_find_eq_8_ms", times):
        res = sc.pipeline_find_eq(sv, eqv)
    for v, bv in zip(eqv, res):
        check(np.array_equal(bv.indices(), np.flatnonzero((vals == v) & ~nm)),
              f"pipeline_find_eq({v})")
    v0 = eqv[0]
    want0 = np.flatnonzero((vals == v0) & ~nm)
    with Clock("find_eq_ms", times):
        r = sc.find_eq(sv, v0)
    check(np.array_equal(r.indices(), want0), "find_eq")
    with Clock("find_first_eq_ms", times):
        ff = sc.find_first_eq(sv, v0)
    check(ff == int(want0[0]), "find_first_eq")
    with Clock("find_ne_ms", times):
        ne = sc.find_ne(sv, v0)
    check(ne.count() == int((~nm).sum()) - want0.size, "find_ne")
    with Clock("find_nonzero_ms", times):
        nz = sc.find_nonzero(sv)
    check(np.array_equal(nz.indices(), np.flatnonzero(live != 0)),
          "find_nonzero")
    return times, (prep, sv, queries.tolist(), eqv)


def scan_steady_pass(tbm, prep, sv, queries, eqv):
    prep.counts(queries)
    tbm.scanner.pipeline_find_eq(sv, eqv)


def agg_scale_path(tbm, device, n_blocks=AGG_SCALE_BLOCKS):
    """200 vectors x 1536 dense blocks (2.5 GB of operand rows) from seeded
    word images: the combine_and_sub pair of phase 5 and a 64-request
    counts pipeline, against numpy."""
    times = {}
    rng = np.random.default_rng(SEED + 7)
    W = rng.integers(0, 2**32, (AGG_K, n_blocks * 2048), dtype=np.uint32)
    with Clock("from_words_200_ms", times):
        vecs = [tbm.BitVector.from_words(W[j], device=device)
                for j in range(AGG_K)]
    agg = tbm.Aggregator()
    big = (list(range(AGG_K // 2)), list(range(AGG_K // 2, AGG_K)))
    small = ([0, 2, 3], [7, 12])
    for name, (a, sb) in (("and_sub_100_100", big), ("and_sub_3_2", small)):
        with Clock(f"{name}_ms", times):
            cnt = agg.combine_and_sub([vecs[i] for i in a],
                                      [vecs[i] for i in sb]).count()
        check(cnt == _popcount(oracle_and_sub(W, a, sb)), f"scale {name}")
    reqs = agg_requests(rng, AGG_K, N_REQUESTS)
    groups = [([vecs[i] for i in a], [vecs[i] for i in sb]) for a, sb in reqs]
    with Clock("pipeline_64_counts_ms", times):
        out = agg.pipeline(groups, tbm.AggOptions().set_compute_count())
    check([o["count"] for o in out]
          == [_popcount(oracle_and_sub(W, a, sb)) for a, sb in reqs],
          "scale pipeline counts")
    return times


# ---------------------------------------------------------------------------
# phase 7: the rest of BitVector and the algorithms at config-1 width
# ---------------------------------------------------------------------------
def _first_at_or_after(idx, p):
    """First of the sorted positions ``idx`` at or after p, or 0."""
    k = int(np.searchsorted(idx, p))
    return int(idx[k]) if k < idx.size else 0


def _runs_np(x):
    """Inclusive (start, end) runs of ones of a bool array."""
    d = np.diff(np.concatenate([[0], x.view(np.int8), [0]]))
    return np.stack([np.flatnonzero(d == 1), np.flatnonzero(d == -1) - 1],
                    axis=1)


def algo_positions(n_blocks):
    """Probe positions in A's regions (build_main_vectors): a block edge
    in a BIT row, mid-block in a GAP block, inside the FULL run."""
    u = n_blocks // 24
    return 9 * u * BPB, 17 * u * BPB + 777, (20 * u + 1) * BPB + 9


def algo_path(tbm, device, sv, sv_live, n_blocks=N_BLOCKS):
    """The rest of BitVector and the algorithms through the entry points,
    on configs 1-2's vectors A and B (``n_blocks`` blocks, BIT / GAP /
    FULL-run mixed), 16 dense vectors of the same width and config 4b's
    SparseVector ``sv`` (values ``sv_live``, NULL slots 0); every answer
    against numpy.  Returns the phase times (ms) and the state the kernel
    listing and the steady pass reuse."""
    from bitmagic_tpu_torch import constants as C
    from bitmagic_tpu_torch.serial import native
    times = {}
    a, b, bits = build_main_vectors(tbm, n_blocks, device, {})
    xa, xb = bits["a"], bits["b"]
    size = a.size
    idx_a, idx_b = np.flatnonzero(xa), np.flatnonzero(xb)

    def same(v, x, what):
        check(np.array_equal(v.to_words().ravel(), image(x)), what)

    # the native library the iteration paths decode with: the port's own
    lib_path = os.path.realpath(native.load()._name)
    build_dir = os.path.realpath(os.path.join(ROOT, "bitmagic_tpu_torch",
                                              "_build"))
    check(os.path.dirname(lib_path) == build_dir,
          f"native codec library {lib_path} is not under {build_dir}")
    log(f"algo: native codec library loaded from {lib_path}")

    # insert / erase at a block edge (a BIT row), mid-block (a GAP block)
    # and at bit 0; shift_left
    edge, mid, in_run = algo_positions(n_blocks)
    u = n_blocks // 24
    for i, val in ((edge, True), (mid, False), (0, True)):
        with Clock(f"insert_{i}_ms", times):
            v = a.copy().insert(i, val)
        same(v, np.concatenate([xa[:i], [val], xa[i:-1]]), f"insert({i})")
        with Clock(f"erase_{i}_ms", times):
            v = a.copy().erase(i)
        same(v, np.concatenate([xa[:i], xa[i + 1:], [False]]), f"erase({i})")
    with Clock("shift_left_ms", times):
        v = a.copy().shift_left()
    same(v, np.concatenate([xa[1:], [False]]), "shift_left")
    with Clock("flip_ms", times):
        v = a.copy().flip()
    same(v, ~xa, "flip()")
    flips = [3, edge + 1, mid, in_run, size - 1]
    v = a.copy()
    for i in flips:
        v.flip(i)
    x = xa.copy()
    x[flips] = ~x[flips]
    same(v, x, "flip(i)")

    # compare / find_first_mismatch: A against B, against a copy with one
    # flipped bit, against itself
    m = int(np.argmax(xa != xb))
    with Clock("compare_ms", times):
        got = (a.compare(b), a.find_first_mismatch(b))
    check(got == ((1 if xa[m] else -1), m), f"compare(A, B) {got}")
    for j in (mid, in_run):
        c = a.copy().flip(j)
        check((a.find_first_mismatch(c), a.compare(c), c.compare(a))
              == (j, 1 if xa[j] else -1, -1 if xa[j] else 1),
              f"compare against one flipped bit {j}")
    check(a.compare(a.copy()) == 0 and a.find_first_mismatch(a) == -1,
          "compare(A, A)")

    # merge, bit_or_and
    rng = np.random.default_rng(SEED + 9)
    z_ids = rng.integers(0, size, 2_000_000)
    z = tbm.BitVector.from_indices(z_ids, size, device=device)
    xz = np.zeros(size, bool)
    xz[z_ids] = True
    c, d = a.copy(), b.copy()
    with Clock("merge_ms", times):
        c.merge(d)
    same(c, xa | xb, "merge")
    check(d.count() == 0 and not d.any(), "merge empties its argument")
    e = z.copy()
    with Clock("bit_or_and_ms", times):
        e.bit_or_and(a, b)
    same(e, xz | (xa & xb), "bit_or_and")

    # calc_stat against the blocks' popcounts
    with Clock("calc_stat_ms", times):
        st = a.calc_stat()
    bc = np.bitwise_count(image(xa).reshape(n_blocks, 2048)).sum(axis=1)
    n_entries = len(a._struct.nb)
    check((st["full_blocks"], st["zero_blocks"],
           st["bit_blocks"] + st["gap_blocks"], st["device_memory_used"])
          == (int((bc == BPB).sum()), int((bc == 0).sum()),
              int(((bc > 0) & (bc < BPB)).sum()),
              st["bit_blocks"] * 8192 + 9 * n_entries)
          and st["gap_blocks"] == int((a._struct.cls == C.CLS_GAP).sum()),
          f"calc_stat {st}")

    # the find walks
    probe = [0, 5, edge, mid, in_run, 22 * u * BPB - 1, 23 * u * BPB,
             size - 1]
    with Clock("get_next_check_or_next_ms", times):
        got = [a.get_first()] + [(a.get_next(p), a.check_or_next(p))
                                 for p in probe]
    check(got == [int(idx_a[0])] + [(_first_at_or_after(idx_a, p + 1),
                                     _first_at_or_after(idx_a, p))
                                    for p in probe], "get_next / "
          "check_or_next")

    # intervals and count_intervals of B
    with Clock("intervals_B_ms", times):
        iv = tbm.algo.intervals(b)
    check(np.array_equal(iv, _runs_np(xb)), "intervals(B)")
    with Clock("count_intervals_B_ms", times):
        n_iv = tbm.count_intervals(b)
    check(n_iv == 1 + int(np.count_nonzero(xb[1:] != xb[:-1])),
          "count_intervals(B)")

    # rank_compress of A by B, and back
    with Clock("compress_ms", times):
        comp = tbm.rank_compress.compress(a, b)
    hits = np.flatnonzero(xa & xb)
    check(comp.size == idx_b.size and np.array_equal(
        comp.indices(), np.searchsorted(idx_b, hits)), "compress(A, B)")
    with Clock("decompress_ms", times):
        back = tbm.rank_compress.decompress(comp, b)
    check(np.array_equal(back.indices(), hits), "decompress")

    # random_subset, rank_range_split
    with Clock("random_subset_100k_ms", times):
        sub = tbm.random_subset(a, 100_000, SEED)
    ranks = np.random.default_rng(SEED).choice(idx_a.size, 100_000,
                                               replace=False)
    check(np.array_equal(sub.indices(), np.sort(idx_a[ranks])),
          "random_subset")
    k = 1 << 20
    with Clock("rank_range_split_ms", times):
        parts = tbm.rank_range_split(a, k)
    n_parts = -(-idx_a.size // k)
    check(parts == [(int(idx_a[j * k]),
                     int(idx_a[min(j * k + k - 1, idx_a.size - 1)]))
                    for j in range(n_parts)], "rank_range_split")

    # Kleene AND / OR of (value A, known A|B) and (value B, known B|Z)
    k1, k2 = a | b, b | z
    with Clock("kleene_ms", times):
        va, ka = tbm.and_kleene(a, k1, b, k2)
        vo, ko = tbm.or_kleene(a, k1, b, k2)
    xk1, xk2 = xa | xb, xb | xz
    same(va, xa & xb, "and_kleene value")
    same(ka, (xk1 & xk2) | (xk1 & ~xa) | (xk2 & ~xb), "and_kleene known")
    same(vo, xa | xb, "or_kleene value")
    same(ko, xa | xb | (xk1 & xk2), "or_kleene known")

    # the enumerator: the first ENUM_WALK positions one at a time, then
    # go_to / skip / skip_to_rank jumps across the whole vector
    with Clock("indices_A_ms", times):
        got_idx = a.indices()
    check(np.array_equal(got_idx, idx_a), "indices(A)")
    with Clock("enumerator_walk_ms", times):
        walk = np.fromiter(itertools.islice(a.get_enumerator(), ENUM_WALK),
                           np.int64)
    check(np.array_equal(walk, idx_a[:ENUM_WALK]), "enumerator walk")
    en = a.get_enumerator()
    with Clock("enumerator_jumps_ms", times):
        for p in rng.integers(0, size, 64).tolist() + [size - 1]:
            en.go_to(p)
            want = _first_at_or_after(idx_a, p)
            check(en.valid() == (p <= idx_a[-1]) and (
                not en.valid() or en.value() == want), f"go_to({p})")
        en.go_first()
        at = 0
        for n in [7] + [int(idx_a.size * f) for f in (0.013, 0.09, 0.21,
                                                       0.33)]:
            en.skip(n)
            at += n
            check(en.value() == idx_a[at], f"skip({n})")
        check(not en.skip(idx_a.size), "skip past the end")
        for p, r in ((edge + 3, 1), (mid, idx_a.size // 7),
                     (5, idx_a.size // 2)):
            en = a.get_enumerator(p)
            en.skip_to_rank(r)
            check(en.value() == idx_a[np.searchsorted(idx_a, p) + r - 1],
                  f"skip_to_rank({r}) from {p}")

    # similarity batch: 16 dense vectors of config-1 width
    W = rng.integers(0, 2**32, (SIM_VECTORS, n_blocks * 2048),
                     dtype=np.uint32)
    W[1::2] &= rng.integers(0, 2**32, W[1::2].shape, dtype=np.uint32)
    sims = [tbm.BitVector.from_words(W[j], device=device)
            for j in range(SIM_VECTORS)]
    with Clock("similarity_batch_16_ms", times):
        mat = tbm.similarity_batch(sims)
    want = np.zeros((SIM_VECTORS, SIM_VECTORS), np.int64)
    for i in range(SIM_VECTORS):
        want[i, i] = _popcount(W[i])
        for j in range(i + 1, SIM_VECTORS):
            want[i, j] = want[j, i] = _popcount(W[i] & W[j])
    check(np.array_equal(mat, want), "similarity_batch")
    del W

    # the Jaccard batch over config 4b's value planes
    with Clock("jaccard_batch_ms", times):
        jac = tbm.build_jaccard_similarity_batch(sv)
    planes = [(s, np.packbits(((sv_live >> s) & 1).astype(bool)))
              for s in range(32) if ((sv_live >> s) & 1).any()]
    check([s for s, _ in planes] == [s for s, p in enumerate(sv.planes)
                                     if p is not None], "SV planes")
    want = []
    for x, (i, pi) in enumerate(planes):
        for j, pj in planes[x + 1:]:
            c_and, c_or = _popcount(pi & pj), _popcount(pi | pj)
            want.append((i, j, c_and, c_or, (c_and / c_or) if c_or else 0.0))
    want.sort(key=lambda t: t[4], reverse=True)
    check(jac == want, "build_jaccard_similarity_batch")
    return times, (a, b, z, sims, sv, n_blocks)


def algo_entry_points(tbm, a, b, z, sims, sv, n_blocks):
    """Entry point -> a call of it on the phase's vectors (mutators act on
    copies, so each call does the same work)."""
    edge, mid, _ = algo_positions(n_blocks)
    return {
        "insert": lambda: a.copy().insert(edge, True),
        "erase": lambda: a.copy().erase(mid),
        "shift_left": lambda: a.copy().shift_left(),
        "flip": lambda: a.copy().flip(),
        "compare": lambda: a.compare(b),
        "merge": lambda: a.copy().merge(b.copy()),
        "bit_or_and": lambda: z.copy().bit_or_and(a, b),
        "count": lambda: a.count(),
        "intervals": lambda: tbm.algo.intervals(b),
        "compress": lambda: tbm.rank_compress.compress(a, b),
        "random_subset": lambda: tbm.random_subset(a, 100_000, SEED),
        "rank_range_split": lambda: tbm.rank_range_split(a, 1 << 20),
        "and_kleene": lambda: tbm.and_kleene(a, a | b, b, b | z),
        "similarity_batch": lambda: tbm.similarity_batch(sims),
        "jaccard_batch": lambda: tbm.build_jaccard_similarity_batch(sv),
    }


# ---------------------------------------------------------------------------
# phase 8: serialization (BMT1 and reference-format BLOBs, set ops on BLOBs)
# ---------------------------------------------------------------------------
def best_ms(fn, n):
    """(best host wall ms of ``n`` runs after a warm-up, the last result),
    each run ending in a device synchronize (bench.py's best())."""
    fn()
    sync()
    best, r = float("inf"), None
    for _ in range(n):
        t0 = time.perf_counter()
        r = fn()
        sync()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, r


def serial_path(tbm, device, n_blocks=N_BLOCKS):
    """Configs 1-2's A and B through the serialization entry points, on
    ``device``: BMT1 at levels 1, 4, 6 and 6 with bookmarks and the
    reference format, each decoded back onto the device; every BLOB equal
    to that of the same vectors built on the CPU; the operation
    deserializer's set and count ops and deserialize_range on both formats;
    a walk of the stream iterator.  Every answer against numpy.  Returns
    the phase times (ms) and the state the kernel listing reuses."""
    from bitmagic_tpu_torch import constants as C
    from bitmagic_tpu_torch.serial import refcodec
    times = {}
    a, b, bits = build_main_vectors(tbm, n_blocks, device, {})
    ca, cb, _ = build_main_vectors(tbm, n_blocks, "cpu", {})
    words = {"A": image(bits["a"]), "B": image(bits["b"])}
    bookmarks = tbm.Serializer(6)
    bookmarks.set_bookmarks(True, 64)
    levels = [("L1", tbm.Serializer(1)), ("L4", tbm.Serializer(4)),
              ("L6", tbm.Serializer(6)), ("L6_bookmarks", bookmarks)]
    blobs = {}
    for name, v, cv in (("A", a, ca), ("B", b, cb)):
        ids = np.flatnonzero(bits[name.lower()])
        for label, ser in levels:
            with Clock(f"serialize_{name}_{label}_ms", times):
                blob = ser.serialize(v)
            check(blob == ser.serialize(cv),
                  f"{name} {label}: the card's BLOB is the CPU's")
            with Clock(f"deserialize_{name}_{label}_ms", times):
                back = tbm.deserialize(blob)
            check(back.device == v.device, f"{name} {label} decode device")
            check((v ^ back).count() == 0, f"{name} {label}: (x ^ back)")
            check(np.array_equal(back.indices(), ids),
                  f"{name} {label}: decoded ids")
            blobs[(name, label)] = blob
        with Clock(f"ref_serialize_{name}_ms", times):
            rblob = refcodec.ref_serialize(v)
        check(rblob == refcodec.ref_serialize(cv),
              f"{name}: the card's reference-format BLOB is the CPU's")
        with Clock(f"ref_deserialize_{name}_ms", times):
            back = refcodec.ref_deserialize(rblob)
        check(back.device == v.device and (v ^ back).count() == 0,
              f"{name}: reference-format round trip")
        check(np.array_equal(back.to_words().ravel(), words[name]),
              f"{name}: reference-format words")
        blobs[(name, "ref")] = rblob
        log(f"serial: {name} BLOB bytes: " + json.dumps(
            {lab: len(blobs[(name, lab)]) for lab in ("L1", "L4", "L6",
                                                      "L6_bookmarks",
                                                      "ref")}))
    del ca, cb

    wa, wb = words["A"], words["B"]
    dist = tbm.distance_operation(a, b, list(METRICS))
    od = tbm.OperationDeserializer()
    size = a.size
    lo, hi = 3 * size // 10 + 12345, 7 * size // 10 - 77
    win = np.zeros(size, bool)
    win[lo:hi + 1] = True
    win_b = image(bits["b"] & win)
    for fmt in ("L6", "ref"):
        blob_b = blobs[("B", fmt)]
        for op, name in ((C.SET_AND, "and"), (C.SET_OR, "or"),
                         (C.SET_XOR, "xor"), (C.SET_SUB, "sub")):
            t = a.copy()
            with Clock(f"opdeser_{fmt}_{name}_ms", times):
                od.deserialize(t, blob_b, op)
            check(t.device == a.device, f"{fmt} {name}: result device")
            check(np.array_equal(t.to_words().ravel(),
                                 oracle_op(name, wa, wb)),
                  f"OperationDeserializer {fmt} {name}")
        for op, metric in (
                (C.SET_COUNT_AND, "count_and"), (C.SET_COUNT_OR, "count_or"),
                (C.SET_COUNT_XOR, "count_xor"),
                (C.SET_COUNT_SUB_AB, "count_sub_ab"),
                (C.SET_COUNT_SUB_BA, "count_sub_ba"),
                (C.SET_COUNT_A, "count_a"), (C.SET_COUNT_B, "count_b"),
                (C.SET_COUNT, "count_b")):
            with Clock(f"opdeser_{fmt}_{metric}_ms", times):
                got = od.deserialize(a, blob_b, op)
            check(got == dist[metric], f"{fmt} SET_COUNT {metric}")
        with Clock(f"deserialize_range_{fmt}_ms", times):
            part = tbm.Deserializer().deserialize_range(blob_b, lo, hi)
        check(np.array_equal(part.to_words().ravel(), win_b),
              f"{fmt} deserialize_range window")
        t = a.copy()
        with Clock(f"opdeser_range_{fmt}_ms", times):
            od.deserialize_range(t, blob_b, lo, hi)
        check(np.array_equal(t.to_words().ravel(), wa & win_b),
              f"{fmt} OperationDeserializer.deserialize_range")

    # the stream iterator over A's BLOB, block by block against numpy
    it = tbm.SerialStreamIterator(blobs[("A", "L6")])
    blocks = wa.reshape(-1, 2048)
    seen = np.zeros(blocks.shape[0], bool)
    with Clock("stream_iterator_walk_A_ms", times):
        while it.next():
            check(np.array_equal(it.get_block_words(),
                                 blocks[it.block_idx]),
                  f"stream iterator block {it.block_idx}")
            seen[it.block_idx] = True
    check(np.array_equal(seen, blocks.any(axis=1)),
          "the stream iterator visits every non-empty block")
    return times, (a, b, blobs, od, (lo, hi))


def serial_entry_points(tbm, a, b, blobs, od, window):
    """Entry point -> a call of it on the phase's vectors and BLOBs."""
    from bitmagic_tpu_torch import constants as C
    lo, hi = window
    return {
        "serialize": lambda: tbm.serialize(a),
        "deserialize": lambda: tbm.deserialize(blobs[("A", "L6")]),
        # B's BMT1 BLOB holds FULL_RUN records: decode, then the set
        # algebra (K1) or distance_operation (K2) on the card
        "and_run_coded_blob": lambda: od.deserialize(
            a.copy(), blobs[("B", "L6")], C.SET_AND),
        "count_and_run_coded_blob": lambda: od.deserialize(
            a, blobs[("B", "L6")], C.SET_COUNT_AND),
        "deserialize_range": lambda: od.deserialize_range(
            a.copy(), blobs[("B", "L6")], lo, hi),
        # the reference format streams: A's blocks that B's BLOB never
        # mentions pass through on the card (gathered; counted by K3)
        "or_ref_streamed": lambda: od.deserialize(
            a.copy(), blobs[("B", "ref")], C.SET_OR),
        "count_or_ref_streamed": lambda: od.deserialize(
            a, blobs[("B", "ref")], C.SET_COUNT_OR),
    }


# the kernel (launch counter) a serial-phase entry point must put on the card
SERIAL_KERNEL = {"and_run_coded_blob": "logical_op_digest",
                 "count_and_run_coded_blob": "count_op",
                 "deserialize_range": "logical_op_digest",
                 "count_or_ref_streamed": "block_counts"}


def config5(tbm, device):
    """bench.py config 5 (bench.py:307-366) at its own shape: 512 blocks of
    1 % random bits with blocks 2-3 set, optimize(), Serializer(6);
    serialize, deserialize and COUNT_AND on the BLOB, best of 21."""
    from bitmagic_tpu_torch import constants as C
    rng = np.random.default_rng(SEED + 11)
    size = 512 * BPB
    idx = np.unique(rng.integers(0, size, size // 100))
    bv = tbm.BitVector.from_indices(idx, size, device=device)
    bv.set_range(2 * BPB, 4 * BPB - 1)
    bv.optimize()
    x = np.zeros(size, bool)
    x[idx] = True
    x[2 * BPB:4 * BPB] = True
    ser = tbm.Serializer(6)
    od = tbm.OperationDeserializer()
    t_ser, blob = best_ms(lambda: ser.serialize(bv), 21)
    t_deser, back = best_ms(lambda: tbm.deserialize(blob), 21)
    check(back.equal(bv) and back.device == bv.device, "config 5 round trip")
    t_op, cnt = best_ms(lambda: od.deserialize(bv, blob, C.SET_COUNT_AND),
                        21)
    check(cnt == int(x.sum()), "config 5 COUNT_AND on the BLOB")
    raw_mb = size / 8 / 1e6
    out = {"raw_mb": raw_mb, "blob_kb": len(blob) / 1e3,
           "ser_mbps": raw_mb / (t_ser / 1e3),
           "deser_mbps": raw_mb / (t_deser / 1e3),
           "count_and_blob_ms": t_op, "ser_ms": t_ser, "deser_ms": t_deser,
           "codes": ser.get_compression_stat()}
    return out, (bv, blob, ser, od)


def config5_steady(tbm, bv, blob, ser, od):
    from bitmagic_tpu_torch import constants as C
    ser.serialize(bv)
    tbm.deserialize(blob)
    od.deserialize(bv, blob, C.SET_COUNT_AND)


def config5b(tbm, device):
    """bench.py config 5b (bench.py:371-438), its GAP/run corpus: 512
    blocks, a sparse array section, a 200-block FULL span, 2000 bursty runs;
    round trip, best of 11, and our reference-format BLOB's size."""
    from bitmagic_tpu_torch.serial import refcodec
    rng = np.random.default_rng(SEED + 12)
    n_blk = 512
    size = n_blk * BPB
    lo, hi = 100 * BPB, 300 * BPB - 1
    ids = np.unique(rng.integers(0, 100 * BPB, 20_000))
    starts = rng.integers(300 * BPB, size - 400, 2000)
    lens = rng.integers(30, 300, 2000)
    burst = np.concatenate([np.arange(s, s + n)
                            for s, n in zip(starts, lens)])
    all_ids = np.unique(np.concatenate([ids, burst]))
    bv = tbm.BitVector.from_indices(all_ids, size, device=device)
    bv.set_range(lo, hi)
    bv.optimize()
    check(bv._struct.has_runs and bv._gaps is not None,
          "config 5b holds FULL runs and GAP blocks")
    ser = tbm.Serializer(6)
    t_ser, blob = best_ms(lambda: ser.serialize(bv), 11)
    t_deser, back = best_ms(lambda: tbm.deserialize(blob), 11)
    check(back.equal(bv), "config 5b round trip")
    want = np.union1d(all_ids, np.arange(lo, hi + 1))
    check(np.array_equal(back.indices(), want), "config 5b decoded ids")
    rblob = refcodec.ref_serialize(bv, level=6)
    check(refcodec.ref_deserialize(rblob).equal(bv),
          "config 5b reference-format round trip")
    raw_mb = size / 8 / 1e6
    return {"raw_mb": raw_mb, "blob_kb": len(blob) / 1e3,
            "ser_mbps": raw_mb / (t_ser / 1e3),
            "deser_mbps": raw_mb / (t_deser / 1e3), "ser_ms": t_ser,
            "deser_ms": t_deser, "reffmt_blob_kb": len(rblob) / 1e3}


def refblob_fixtures(tbm, device):
    """The 94 bit-vector BLOBs the reference wrote
    (tests/fixtures/refblobs), decoded onto the card against inputs.npz;
    the two XOR BLOBs with their reference vectors."""
    from bitmagic_tpu_torch.serial import refcodec
    fix = os.path.join(ROOT, "tests", "fixtures", "refblobs")
    with open(os.path.join(fix, "manifest.json")) as f:
        manifest = json.load(f)
    inputs = np.load(os.path.join(fix, "inputs.npz"))
    size = manifest["size"]
    xor_refs = {"xor_target.bin": ("xor_inputs.npz", ((0, "ref"),)),
                "xor_chain.bin": ("xor_chain_inputs.npz",
                                  ((0, "ref"), (2, "ref2")))}
    n = 0
    for e in manifest["blobs"]:
        if e["dist"] in ("sv", "rsc", "strsv"):
            continue                       # sparse-vector BLOBs
        with open(os.path.join(fix, e["file"]), "rb") as f:
            blob = f.read()
        refs = []
        want = inputs[e["dist"]] if e["dist"] in inputs else None
        if e["file"] in xor_refs:
            npz, rows = xor_refs[e["file"]]
            data = np.load(os.path.join(fix, npz))
            want = data["target"]
            refs = [(r, tbm.BitVector.from_indices(data[k], size,
                                                   device=device))
                    for r, k in rows]
        got = refcodec.RefDeserializer(refs, device=device).deserialize(blob)
        check(got.device.type == torch.device(device).type
              and got.size == size, f"{e['file']}: decoded onto {device}")
        check(np.array_equal(got.indices(), want), f"{e['file']} ids")
        n += 1
    check(n == 94, f"{n} bit-vector BLOBs, not 94")
    return n


def short_kernel_names(names):
    """{short kernel name: count} of a profiler listing."""
    short = {}
    for n in names:
        n = n.replace("(anonymous namespace)::", "").split("(")[0]
        n = n.removeprefix("void ")[:60]
        short[n] = short.get(n, 0) + 1
    return short


def serial_phase(tbm, device, card):
    """Phase 8: the serialization entry points at configs 1-2, 5 and 5b and
    the reference's BLOBs, with the launch counts set to 0 just before and
    read just after; then the kernels each entry point puts on the card,
    the host copies of one streamed op and a profile of config 5's steady
    pass.  Returns the phase's launch counts."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launches()
    t0 = time.perf_counter()
    times, state = serial_path(tbm, device)
    c5, state5 = config5(tbm, device)
    c5b = config5b(tbm, device)
    n_fix = refblob_fixtures(tbm, device)
    launches = dict(ck.launches)
    log(f"serial: passed in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}; phase ms {json.dumps(times)}")
    for k in FIRST_SLICE:
        check(launches[k] > 0, f"serial phase never launched {k}")
    log(json.dumps({"serial_config": "5", **c5, "card": card["smi"]}))
    log(json.dumps({"serial_config": "5b", **c5b, "card": card["smi"]}))
    log(f"serial: the {n_fix} bit-vector BLOBs of the reference decode onto "
        f"the card to their input ids")
    entry_points = serial_entry_points(tbm, *state)
    del state
    for what, fn in entry_points.items():
        before = dict(ck.launches)
        names = device_kernels(fn)        # runs fn twice: warm-up, traced
        counted = {k: (ck.launches[k] - before[k]) // 2 for k in FIRST_SLICE
                   if ck.launches[k] > before[k]}
        log(f"serial: {what} put these kernels on the card: "
            f"{json.dumps(short_kernel_names(names))}; launch counters per "
            f"call {counted}")
        if what in SERIAL_KERNEL:
            check(counted.get(SERIAL_KERNEL[what], 0) > 0,
                  f"{what} launched no {SERIAL_KERNEL[what]}")
    # host copies of one streamed reference-format op on a fresh target
    calls = []
    orig = blockops.to_host_words
    blockops.to_host_words = lambda t: calls.append(t.shape[0]) or orig(t)
    try:
        entry_points["or_ref_streamed"]()
    finally:
        blockops.to_host_words = orig
    log(f"serial: one streamed reference-format OR copied {len(calls)} "
        f"pool(s) of {sum(calls)} rows to the host")
    check(len(calls) <= 1, "one host copy of the target's pool per op")
    del entry_points
    # ten passes: the profiler can drop the lone events of a short trace
    profile("serial steady pass (config 5, 10 x: serialize, deserialize, "
            "COUNT_AND on the BLOB)",
            lambda: [config5_steady(tbm, *state5) for _ in range(10)])
    return launches


# ---------------------------------------------------------------------------
# phase 9: the rest of the sparse vectors (ordered and sorted searches, the
# float, string and RSC vectors, BitMatrix and the sv algorithms)
# ---------------------------------------------------------------------------
ORDER_OPS = {"find_gt": np.greater, "find_ge": np.greater_equal,
             "find_lt": np.less, "find_le": np.less_equal}
FLOAT_OPS = {"find_eq_float": np.equal, "find_gt_float": np.greater,
             "find_ge_float": np.greater_equal, "find_lt_float": np.less,
             "find_le_float": np.less_equal}


def require_launches(what, launches, kernels):
    for k in kernels:
        check(launches[k] > 0, f"{what} never launched {k}")


def same_ids(bv, want, what):
    check(np.array_equal(bv.indices(), want), what)


def sv_4b_ordered(tbm, ck, sv, vals, nm, times):
    """Config 4b's column through the ordered searches, plain and under an
    AND mask plus a search range, against numpy."""
    rng = np.random.default_rng(SEED + 20)
    v64 = vals.astype(np.int64)
    ok = ~nm
    drawn = int(vals[rng.integers(0, SV_N)])
    sc = tbm.SparseVectorScanner()
    for q in (0, 1 << 19, (1 << SV_BITS) - 1, drawn, -1, 1 << 32):
        for name, op in ORDER_OPS.items():
            same_ids(getattr(sc, name)(sv, q), np.flatnonzero(op(v64, q) & ok),
                     f"config 4b {name}({q})")
    for lo, hi in ((1000, 1 << 19), (drawn, drawn), (0, (1 << SV_BITS) - 1)):
        same_ids(sc.find_range(sv, lo, hi),
                 np.flatnonzero((v64 >= lo) & (v64 <= hi) & ok),
                 f"config 4b find_range({lo}, {hi})")
    check(sc.find_nonnegative(sv).count() == SV_N, "config 4b nonnegative")
    # one find_gt alone: the K1 launches of one ordered descent
    before = ck.launches["logical_op_digest"]
    with Clock("find_gt_ms", times):
        sc.find_gt(sv, drawn)
    times["find_gt_k1_launches"] = ck.launches["logical_op_digest"] - before
    mask_ids = np.flatnonzero(rng.random(SV_N) < 0.5)
    in_mask = np.zeros(SV_N, bool)
    in_mask[mask_ids] = True
    lo, hi = SV_N // 5, SV_N - SV_N // 7
    in_mask[:lo] = in_mask[hi + 1:] = False
    sc.set_and_mask(tbm.BitVector.from_indices(mask_ids, tbm.constants.ID_MAX48,
                                               device=sv.device))
    sc.set_search_range(hi, lo)
    for name, op in ORDER_OPS.items():
        same_ids(getattr(sc, name)(sv, drawn),
                 np.flatnonzero(op(v64, drawn) & ok & in_mask),
                 f"config 4b masked {name}")
    same_ids(sc.find_range(sv, 1000, 1 << 19),
             np.flatnonzero((v64 >= 1000) & (v64 <= 1 << 19) & ok & in_mask),
             "config 4b masked find_range")
    same_ids(sc.find_nonnegative(sv), np.flatnonzero(in_mask),
             "config 4b masked find_nonnegative")
    return sc, drawn


def sv_signed(tbm, device):
    """A 16M-element nullable int32 column, uniform in [-2^19, 2^19), ~1 %
    NULL: find_gt / find_lt / find_range across zero and at the iinfo
    edges, against numpy.  Returns (column, values, NULL mask)."""
    rng = np.random.default_rng(SEED + 21)
    vals = rng.integers(-(1 << 19), 1 << 19, SV_N).astype(np.int32)
    nm = rng.random(SV_N) < 0.01
    sv = tbm.SparseVector.from_array(vals, null_mask=nm, device=device)
    v64, ok = vals.astype(np.int64), ~nm
    info = np.iinfo(np.int32)
    sc = tbm.scanner
    for q in (-1, 0, 1, -(1 << 19), (1 << 19) - 1, info.min, info.max,
              int(info.min) - 1, int(info.max) + 1, int(vals[12345])):
        for name in ("find_gt", "find_lt"):
            same_ids(getattr(sc, name)(sv, q),
                     np.flatnonzero(ORDER_OPS[name](v64, q) & ok),
                     f"signed {name}({q})")
    for lo, hi in ((-5, 5), (info.min, -1), (0, info.max),
                   (-(1 << 19), (1 << 19) - 1)):
        same_ids(sc.find_range(sv, lo, hi),
                 np.flatnonzero((v64 >= lo) & (v64 <= hi) & ok),
                 f"signed find_range({lo}, {hi})")
    return sv, vals, nm


def sv_sorted(tbm, device, times):
    """16M sorted uint32: bind, then SV_PROBES lower_bound and bfind_eq
    probes against np.searchsorted."""
    rng = np.random.default_rng(SEED + 22)
    vals = np.sort(rng.integers(0, 1 << 32, SV_N, dtype=np.uint64)
                   ).astype(np.uint32)
    sv = tbm.SparseVector.from_array(vals, device=device)
    sc = tbm.SparseVectorScanner()
    with Clock("bind_ms", times):
        sc.bind(sv)
    probes = np.concatenate([
        vals[rng.integers(0, SV_N, SV_PROBES // 2)],
        rng.integers(0, 1 << 32, SV_PROBES // 2 - 2, dtype=np.uint64),
        [0, (1 << 32) - 1]]).astype(np.uint32)
    # the oracle outside the timed loop: a searchsorted of a Python int
    # would widen the 16M column to int64 on every probe
    want = np.searchsorted(vals, probes, side="left")
    hit = np.where((want < SV_N) & (vals[np.minimum(want, SV_N - 1)]
                                    == probes), want, -1)
    got = []
    with Clock(f"lower_bound_bfind_eq_{SV_PROBES}_ms", times):
        for q in probes.tolist():
            got.append((sc.lower_bound(sv, q), sc.bfind_eq(sv, q)))
    check(got == list(zip(want.tolist(), hit.tolist())),
          "lower_bound / bfind_eq against np.searchsorted")
    return sc, sv, probes[:10].tolist()


def sv_float(tbm, device, times):
    """A 16M-element nullable float32 column, standard_normal() * 1000,
    ~1 % NULL, with +-0.0 and repeats: the float searches against numpy."""
    rng = np.random.default_rng(SEED + 23)
    vals = (rng.standard_normal(SV_N) * 1000).astype(np.float32)
    vals[rng.integers(0, SV_N, 5000)] = 0.0
    vals[rng.integers(0, SV_N, 5000)] = -0.0
    vals[::97] = 12.5
    vals[1::89] = -12.5
    nm = rng.random(SV_N) < 0.01
    with Clock("float_import_ms", times):
        fv = tbm.FloatSparseVector.from_array(vals, nullable=True,
                                              device=device)
        for i in np.flatnonzero(nm).tolist():
            fv.set_null(i)
    ok = ~nm
    sc = tbm.scanner
    for q in (0.0, -0.0, 12.5, -12.5, float(vals[777])):
        for name, op in FLOAT_OPS.items():
            same_ids(getattr(sc, name)(fv, q),
                     np.flatnonzero(op(vals, np.float32(q)) & ok),
                     f"float {name}({q})")
    same_ids(sc.find_range_float(fv, 12.5, -12.5),
             np.flatnonzero((vals >= -12.5) & (vals <= 12.5) & ok),
             "find_range_float")
    same_ids(sc.find_range_float_unbounded(fv, -1000.0, 0.0),
             np.flatnonzero((vals > -1000) & (vals < 0) & ok),
             "find_range_float_unbounded")
    return fv, vals, nm


def _catalog_ids(rng, n):
    nums = np.sort(rng.choice(10 ** 7, n, replace=False))
    return nums, [f"NGC {x:07d}" for x in nums.tolist()]


def sv_strings(tbm, device, times):
    """A sorted dictionary of STR_N catalog ids "NGC %07d" drawn without
    replacement from 10^7 (samples/16_compressed_dictionary.py's form),
    remapped, optimized and frozen, and a raw copy: exact and prefix
    searches, the first hit, SV_PROBES bound bfind_eq_str probes and the
    string pipeline (STR_PRESENT present + STR_MISSING missing ids) on both
    forms, against Python."""
    rng = np.random.default_rng(SEED + 24)
    nums, names = _catalog_ids(rng, STR_N)
    with Clock("str_import_ms", times):
        cat = tbm.StrSparseVector.from_strings(names, device=device)
    raw = tbm.StrSparseVector.from_strings(names, device=device)
    with Clock("remap_ms", times):
        cat.remap()
    with Clock("optimize_freeze_ms", times):
        cat.optimize()
        cat.freeze()
    raw.optimize()
    check(cat.is_remap() and cat.is_ro() and cat.size == STR_N, "dictionary")
    ids = rng.integers(0, STR_N, 1000)
    check(cat.gather(ids) == [names[i] for i in ids.tolist()],
          "dictionary gather")
    absent = np.setdiff1d(rng.integers(0, 10 ** 7, 4 * STR_MISSING), nums)
    missing = ([f"NGC {x:07d}" for x in absent[:STR_MISSING // 2].tolist()]
               + [f"XYZ {i}" for i in range(STR_MISSING
                                            - STR_MISSING // 2)])
    sc = tbm.SparseVectorScanner()
    k = int(rng.integers(0, STR_N))
    for v in (cat, raw):
        same_ids(sc.find_eq_str(v, names[k]), [k], "find_eq_str")
        check(sc.find_eq_str_count(v, names[k]) == 1, "find_eq_str_count")
        check(sc.find_eq_str(v, missing[0]).count() == 0, "missing id")
        check(sc.find_first_eq_str(v, names[k]) == k, "find_first_eq_str")
        check(sc.find_first_eq_str(v, missing[0]) == -1, "first of missing")
        for p, lo, hi in (("NGC 12", 1_200_000, 1_300_000),
                          ("NGC 00000", 0, 100),
                          ("NGC 9", 9_000_000, 10 ** 7)):
            same_ids(sc.find_eq_str_prefix(v, p),
                     np.flatnonzero((nums >= lo) & (nums < hi)),
                     f"find_eq_str_prefix({p})")
    with Clock("bind_str_ms", times):
        sc.bind(cat)
    probe_ids = rng.integers(0, STR_N, SV_PROBES - STR_MISSING)
    with Clock(f"bfind_eq_str_{SV_PROBES}_ms", times):
        for i in probe_ids.tolist():
            check(sc.bfind_eq_str(cat, names[i]) == i, f"bfind_eq_str({i})")
        for s in missing:
            check(sc.bfind_eq_str(cat, s) == -1, f"bfind_eq_str({s})")
    queries = [names[i] for i in rng.integers(0, STR_N, STR_PRESENT)] \
        + missing
    want = [1] * STR_PRESENT + [0] * len(missing)
    for form, v in (("remapped", cat), ("raw", raw)):
        with Clock(f"pipeline_{form}_ms", times):
            got = sc.pipeline_find_eq_str(v, queries)
        check(got == want, f"string pipeline on the {form} dictionary")
        times[f"pipeline_{form}_planes"] = sc.prepare_pipeline_str(v).K
    return cat, queries, raw, names, nums


def sv_rsc(tbm, device, times):
    """samples/11_rsc_collections.py's shape: a column of RSC_ROWS rows
    holding RSC_VALUES values < 2^20, compressed from a nullable
    SparseVector; gather, the RSC searches, count_range_notnull and the
    load_to round trip, against numpy."""
    rng = np.random.default_rng(SEED + 25)
    idx = np.unique(rng.integers(0, RSC_ROWS, RSC_VALUES)).astype(np.int64)
    rv = rng.integers(1, 1 << 20, idx.size).astype(np.uint32)
    arr = np.zeros(int(idx[-1]) + 1, np.uint32)
    arr[idx] = rv
    mask = np.ones(arr.size, bool)
    mask[idx] = False
    with Clock("source_from_array_ms", times):
        src = tbm.SparseVector.from_array(arr, null_mask=mask, device=device)
    with Clock("from_sparse_vector_ms", times):
        rsc = tbm.RSCSparseVector.from_sparse_vector(src)
    del src, mask
    check(rsc.count() == idx.size and rsc.size == arr.size, "rsc counts")
    probe = np.concatenate([rng.integers(0, arr.size, 10_000), idx[::97]])
    check(np.array_equal(rsc.gather(probe), arr[probe]), "rsc gather")
    sc = tbm.scanner
    for name, op, q in (("find_eq_rsc", np.equal, int(rv[5])),
                        ("find_gt_rsc", np.greater, 1 << 19),
                        ("find_lt_rsc", np.less, 1000)):
        same_ids(getattr(sc, name)(rsc, q), idx[op(rv, q)], f"{name}({q})")
    for lo, hi in ((0, arr.size - 1), (12345, 54_321_000), (arr.size // 2,
                                                            arr.size // 3)):
        a, b = min(lo, hi), max(lo, hi)
        want = int(np.searchsorted(idx, b, "right")
                   - np.searchsorted(idx, a, "left"))
        check(rsc.count_range_notnull(lo, hi) == want,
              f"count_range_notnull({lo}, {hi})")
    with Clock("load_to_ms", times):
        back = rsc.load_to()
    check(back.size == arr.size, "load_to size")
    same_ids(back.get_null_bvector(), idx, "load_to NULL plane")
    check(np.array_equal(back.gather(probe), arr[probe]), "load_to values")
    return rsc, int(rv[5]), idx, rv


def sv_algorithms(tbm, sv, vals, nm):
    """find_first_mismatch of config 4b's column against a copy that
    differs at one late position, set2set_transform and BitMatrix rows over
    its planes, against numpy."""
    rng = np.random.default_rng(SEED + 26)
    late = int(np.flatnonzero(~nm[SV_N - 5000:])[0]) + SV_N - 5000
    vals2 = vals.copy()
    vals2[late] ^= 1
    copy = tbm.SparseVector.from_array(vals2, null_mask=nm, device=sv.device)
    check(tbm.find_first_mismatch(sv, copy) == late, "find_first_mismatch")
    check(tbm.find_first_mismatch(sv, sv) == -1, "no mismatch")
    ids = np.unique(rng.integers(0, SV_N, 100_000))
    img = tbm.set2set_transform(sv, tbm.BitVector.from_indices(
        ids, tbm.constants.ID_MAX48, device=sv.device))
    same_ids(img, np.unique(vals[ids[~nm[ids]]]).astype(np.int64),
             "set2set_transform")
    m = tbm.BitMatrix(device=sv.device)
    for s, p in enumerate(sv.planes):
        if p is not None:
            m.set_row(s, p)
    live = np.where(nm, 0, vals)
    probe = rng.integers(0, SV_N, 10_000)
    for o in range(3):
        check(np.array_equal(m.octets(probe, o),
                             ((live[probe] >> (8 * o)) & 0xFF).astype(
                                 np.uint8)), f"BitMatrix octet {o}")
    return copy


# the kernels (launch counters) each group of the sv phase must launch
SV_GROUP_KERNELS = {
    "config 4b ordered": ("logical_op_digest",),
    "signed": ("logical_op_digest",),
    "sorted": (),
    "float": ("logical_op_digest", "agg_and_sub"),
    "strings": ("agg_and_sub", "pipeline_counts", "block_counts"),
    "rsc": ("agg_and_sub", "logical_op_digest"),
    "sv algorithms": ("logical_op_digest",),
}


def sv_phase(tbm, device, card, sv, vals, nm):
    """Phase 9: each group of the sv phase with the launch counts set to 0
    just before it and read just after, then a profile of one steady pass.
    Returns the phase's launch counts summed over the groups and its
    columns (for the sv_serial and sharded phases)."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    total = {k: 0 for k in KERNELS}
    times, state = {}, {}
    groups = (
        ("config 4b ordered",
         lambda: state.update(ordered=sv_4b_ordered(tbm, ck, sv, vals, nm,
                                                    times))),
        ("signed", lambda: state.update(signed=sv_signed(tbm, device))),
        ("sorted",
         lambda: state.update(sorted=sv_sorted(tbm, device, times))),
        ("float", lambda: state.update(fv=sv_float(tbm, device, times))),
        ("strings", lambda: state.update(cat=sv_strings(tbm, device, times))),
        ("rsc", lambda: state.update(rsc=sv_rsc(tbm, device, times))),
        ("sv algorithms",
         lambda: state.update(copy=sv_algorithms(tbm, sv, vals, nm))))
    for name, run in groups:
        ck.reset_launches()
        t0 = time.perf_counter()
        run()
        sync()
        launches = dict(ck.launches)
        log(f"sv: {name} passed in {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        require_launches(f"sv {name}", launches, SV_GROUP_KERNELS[name])
        for k in total:
            total[k] += launches[k]
    log(f"sv: phase ms {json.dumps(times)}")
    log(json.dumps({"sv_find_gt_config4b": {
        "ms": times["find_gt_ms"],
        "k1_launches": times["find_gt_k1_launches"],
        "planes": SV_BITS}, "card": card["smi"]}))
    sc, drawn = state["ordered"]
    sc.reset_and_mask()
    sc.reset_search_range()
    cat, queries, raw, names, nums = state["cat"]
    rsc, rq, rsc_idx, rsc_vals = state["rsc"]
    fv = state["fv"][0]
    profile("sv steady pass (find_gt on config 4b, find_range_float, "
            "pipeline_find_eq_str of 600 ids, find_eq_rsc, "
            "find_first_mismatch)",
            lambda: (sc.find_gt(sv, drawn),
                     tbm.scanner.find_range_float(fv, -12.5, 12.5),
                     tbm.scanner.pipeline_find_eq_str(cat, queries),
                     tbm.scanner.find_eq_rsc(rsc, rq),
                     tbm.find_first_mismatch(sv, state["copy"])))
    ssc, ssv, probes = state["sorted"]
    profile("sv sorted probes (10 x lower_bound + bfind_eq on the bound "
            "16M column)",
            lambda: [(ssc.lower_bound(ssv, q), ssc.bfind_eq(ssv, q))
                     for q in probes])
    cols = {"4b": (sv, vals, nm), "signed": state["signed"],
            "float": state["fv"], "dict": (cat, raw, names, queries, nums),
            "rsc": (rsc, rsc_idx, rsc_vals)}
    return total, cols


# ---------------------------------------------------------------------------
# phase 10: sv_serial — the sv phase's columns through BMSV and the
# reference's sparse-vector format
# ---------------------------------------------------------------------------
SV_GATHER = 1 << 20             # deserialize_gather / sharded gather ids


def _planes_of(c):
    """(size, every BitVector of container ``c`` in a fixed order)."""
    kind = type(c).__name__
    if kind == "SparseVector":
        bvs = list(c.planes) + [c.null_plane if c.nullable else None]
    elif kind == "RSCSparseVector":
        bvs = list(c.dense.planes) + [c.null_bv]
    elif kind == "StrSparseVector":
        bvs = [p for o in c.octets for p in o.planes] + [
            c.null_plane if c.nullable else None]
    else:
        bvs = [c.sign] + list(c.exponent.planes) + list(c.mantissa.planes) \
            + [c.null_plane if c.nullable else None]
    return c.size, bvs


def same_container(a, b, what):
    """Every plane of ``a`` equals ``b``'s (one XOR + none() each; an
    absent plane equals an empty one), sizes and remap matrices equal."""
    sa, pa = _planes_of(a)
    sb, pb = _planes_of(b)
    check(sa == sb and len(pa) == len(pb), f"{what}: shape")
    for i, (x, y) in enumerate(zip(pa, pb)):
        if x is None or y is None:
            check((x is None or x.none()) and (y is None or y.none()),
                  f"{what}: plane {i}")
        else:
            check(x.equal(y), f"{what}: plane {i}")
    if type(a).__name__ == "StrSparseVector":
        for m in ("remap_matrices", "unmap_matrices"):
            x, y = getattr(a, m), getattr(b, m)
            check((x is None) == (y is None)
                  and (x is None or np.array_equal(x, y)), f"{what}: {m}")


def same_str_ref(back, c, what):
    """A string vector decoded from its reference-format BLOB: the
    reader's template width (32 octets) and an assigned-everywhere NULL
    row around the source's octet planes and remap matrices."""
    w = c.max_str_size
    check(back.size == c.size and back.max_str_size >= w, f"{what}: shape")
    for k in range(back.max_str_size):
        for b in range(8):
            x = back.octets[k].planes[b]
            y = c.octets[k].planes[b] if k < w else None
            if x is None or y is None:
                check((x is None or x.none()) and (y is None or y.none()),
                      f"{what}: octet {k} plane {b}")
            else:
                check(x.equal(y), f"{what}: octet {k} plane {b}")
    check(back.null_plane.count() == c.size, f"{what}: NULL row")
    if c.unmap_matrices is not None:
        check(np.array_equal(back.unmap_matrices[:w], c.unmap_matrices)
              and not back.unmap_matrices[w:].any(), f"{what}: unmap")
    else:
        check(back.unmap_matrices is None, f"{what}: no remap")


def same_values(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind == "f":
        got, want = got.view(np.uint8), want.view(np.uint8)
    check(got.shape == want.shape and np.array_equal(got, want), what)


def _cpu_copy(tbm, c):
    """The same container built on the CPU, from its parts."""
    from bitmagic_tpu_torch import interop
    kind = type(c).__name__
    to, frm = {"SparseVector": ("sparse_vector_to_parts",
                                "sparse_vector_from_parts"),
               "RSCSparseVector": ("rsc_vector_to_parts",
                                   "rsc_vector_from_parts"),
               "StrSparseVector": ("str_vector_to_parts",
                                   "str_vector_from_parts"),
               "FloatSparseVector": ("float_vector_to_parts",
                                     "float_vector_from_parts")}[kind]
    return getattr(interop, frm)(**getattr(interop, to)(c), device="cpu")


def _value_bytes(c) -> int:
    kind = type(c).__name__
    if kind == "RSCSparseVector":
        return c.count() * c.dtype.itemsize
    if kind == "StrSparseVector":
        return c.size * c.max_str_size
    return c.size * c.dtype.itemsize


def _ref_blob(ref_sv, c, xor_refs):
    kind = type(c).__name__
    if kind == "SparseVector":
        return ref_sv.serialize_sv_blob(c, xor_refs=xor_refs)
    if kind == "RSCSparseVector":
        return ref_sv.serialize_rsc_blob(c, xor_refs=xor_refs)
    if kind == "StrSparseVector":
        return ref_sv.serialize_str_blob(c, xor_refs=xor_refs)
    return ref_sv.serialize_float_blob(c)


def _ref_decode(ref_sv, c, blob, device):
    kind = type(c).__name__
    if kind == "SparseVector":
        return ref_sv.deserialize_sv_blob(blob, c.dtype, device=device)
    if kind == "RSCSparseVector":
        return ref_sv.deserialize_rsc_blob(blob, c.dtype, device=device)
    if kind == "StrSparseVector":
        return ref_sv.deserialize_str_blob(blob, device=device)
    return ref_sv.deserialize_float_blob(blob, device=device)


def sv_serial_column(tbm, device, name, c, cc, ref_xor, times, rng):
    """One column of the sv phase (``c`` on the card, ``cc`` the same on
    the CPU): BMSV with XOR groups on and off, range and gather decodes,
    the reference-format BLOB; every BLOB byte-equal to the CPU copy's,
    every decode equal to the source on the card."""
    from bitmagic_tpu_torch.serial import ref_sv, sv_serial
    n = c.size
    mb = _value_bytes(c) / 1e6
    ids = np.sort(rng.choice(n, min(SV_GATHER, n), replace=False))
    want = c.gather(ids[:10_000] if name.startswith("dict") else ids)
    out = {"values_MB": round(mb, 3)}
    for xor in (True, False):
        ser = sv_serial.SparseVectorSerializer(6, xor_filter=xor)
        fn = {"SparseVector": ser.serialize,
              "RSCSparseVector": ser.serialize_rsc,
              "StrSparseVector": ser.serialize_str,
              "FloatSparseVector": ser.serialize_float}[type(c).__name__]
        t = {}
        with Clock("ser", t):
            blob = fn(c)
        check(blob == fn(cc), f"{name} BMSV (xor={xor}) equals the CPU copy's")
        de = sv_serial.SparseVectorDeserializer(device)
        with Clock("deser", t):
            back = de.deserialize(blob)
        check(back.device == c.device, f"{name} decoded onto the card")
        same_container(back, c, f"{name} BMSV round trip (xor={xor})")
        tag = "xor" if xor else "plain"
        out[f"bmsv_{tag}_bytes"] = len(blob)
        out[f"bmsv_{tag}_serialize_MB_s"] = round(mb / (t["ser"] / 1e3), 3)
        out[f"bmsv_{tag}_deserialize_MB_s"] = round(
            mb / (t["deser"] / 1e3), 3)
        lo, hi = n // 3, min(n // 3 + (1 << 20), n - 1)
        part = de.deserialize_range(blob, lo, hi)
        rid = np.arange(lo, min(hi + 1, lo + 10_000))
        same_values(part.gather(rid), c.gather(rid),
                    f"{name} deserialize_range (xor={xor})")
        with Clock(f"gather_{tag}_ms", out):
            part = de.deserialize_gather(blob, ids)
        got = part.gather(ids[:10_000] if name.startswith("dict") else ids)
        if name.startswith("dict"):
            check(got == want, f"{name} deserialize_gather (xor={xor})")
        else:
            same_values(got, want, f"{name} deserialize_gather (xor={xor})")
    t = {}
    with Clock("ref_ser", t):
        rblob = _ref_blob(ref_sv, c, ref_xor)
    if type(c).__name__ != "FloatSparseVector":
        # the float column's 'bf0' BLOB takes about a minute of host
        # Python per copy (its planes' XOR-reference search): the card's
        # BLOB is checked by its round trip only
        check(rblob == _ref_blob(ref_sv, cc, ref_xor),
              f"{name} reference-format BLOB equals the CPU copy's")
    with Clock("ref_deser", t):
        rback = _ref_decode(ref_sv, c, rblob, device)
    if type(c).__name__ == "FloatSparseVector":
        same_values(rback.to_numpy()[:n], c.to_numpy(),
                    f"{name} reference-format round trip")
    elif type(c).__name__ == "StrSparseVector":
        same_str_ref(rback, c, f"{name} reference-format round trip")
    else:
        same_container(rback, c, f"{name} reference-format round trip")
    out.update(ref_bytes=len(rblob), ref_xor_refs=ref_xor,
               ref_serialize_ms=t["ref_ser"], ref_deserialize_ms=t["ref_deser"])
    times[name] = out


def sv_ref_fixtures(tbm, device):
    """The reference's five sparse-vector BLOBs decoded onto the card."""
    from bitmagic_tpu_torch.serial import ref_sv
    fix = os.path.join(ROOT, "tests", "fixtures", "refblobs")
    inp = np.load(os.path.join(fix, "sv_inputs.npz"))
    vals, nn = inp["vals"], inp["notnull"].astype(bool)
    idx = np.flatnonzero(nn).astype(np.int64)
    strings = [s or None for s in np.load(
        os.path.join(fix, "str_inputs.npz"),
        allow_pickle=True)["strings"].tolist()]

    def rd(name):
        with open(os.path.join(fix, name), "rb") as f:
            return f.read()
    for name in ("sv_plain.bin", "sv_xor.bin"):
        sv = ref_sv.deserialize_sv_blob(rd(name), np.uint32, device=device)
        check(sv.device.type == torch.device(device).type
              and sv.size == len(vals)
              and np.array_equal(sv.gather(idx), vals[idx]), name)
        nz = sv.null_plane.indices()
        check(np.array_equal(nz[nz < len(vals)], idx), f"{name} NULL plane")
    rsc = ref_sv.deserialize_rsc_blob(rd("rsc.bin"), np.uint32, device=device)
    check(np.array_equal(rsc.gather(idx), vals[idx]), "rsc.bin")
    for name in ("strsv_plain.bin", "strsv_remap.bin"):
        ssv = ref_sv.deserialize_str_blob(rd(name), device=device)
        check([g or None for g in ssv.to_list()] == strings, name)


def sv_serial_phase(tbm, device, card, cols):
    """Phase 10: every column of the sv phase through BMSV (XOR groups on
    and off), deserialize_range, deserialize_gather of SV_GATHER ids and
    the reference-format BLOBs, byte-equal to the same column on the CPU;
    then the reference's sparse-vector fixtures.  Returns the launches."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(SEED + 30)
    sv, vals, nm = cols["4b"]
    cat, raw = cols["dict"][:2]
    columns = (
        ("config 4b", sv, tbm.SparseVector.from_array(vals, null_mask=nm,
                                                      device="cpu"), True),
        ("signed", cols["signed"][0], None, False),
        ("float", cols["float"][0], None, True),
        ("dict remapped", cat, None, True),
        ("dict raw", raw, None, False),
        ("rsc", cols["rsc"][0], None, True))
    times = {}
    ck.reset_launches()
    t0 = time.perf_counter()
    for name, c, cc, ref_xor in columns:
        t1 = time.perf_counter()
        sv_serial_column(tbm, device, name, c, cc or _cpu_copy(tbm, c),
                         ref_xor, times, rng)
        times[name]["column_s"] = round(time.perf_counter() - t1, 3)
        log(f"sv_serial: {name}: {json.dumps(times[name])}")
    sv_ref_fixtures(tbm, device)
    launches = dict(ck.launches)
    log(f"sv_serial: passed in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}; reference sparse-vector fixtures decoded onto the card")
    log(json.dumps({"sv_serial": times, "card": card["smi"]}))
    return launches


# ---------------------------------------------------------------------------
# phase 11: sharded — the sharded containers on a mesh of 8 shards on the
# one card, and on every visible card
# ---------------------------------------------------------------------------
SHARDS = 8
SHARD_BLOCKS = 16384            # 2^30 bits
BIG_BITS = (1 << 31) + (1 << 16)  # past the JAX package's int32 select cap
AND_MANY = 8


def oracle_select(words: np.ndarray, ranks: np.ndarray) -> np.ndarray:
    """Bit position of each 1-based rank (all within [1, total])."""
    wcum = np.cumsum(np.bitwise_count(words), dtype=np.int64)
    k = np.searchsorted(wcum, ranks, side="left")
    rem = ranks - np.where(k > 0, wcum[np.maximum(k - 1, 0)], 0)
    w = words[k].astype(np.int64)
    pos = np.full(ranks.shape, -1, np.int64)
    cnt = np.zeros(ranks.shape, np.int64)
    for bit in range(32):
        b = (w >> bit) & 1
        cnt += b
        pos[(b == 1) & (cnt == rem) & (pos < 0)] = bit
    return k * 32 + pos


def _block_words(rng, n_blocks, keep=None):
    w = rng.integers(0, 2**32, (n_blocks, 2048), dtype=np.uint64).astype(
        np.uint32)
    if keep is not None:
        w[~keep] = 0
    return w


def shard_launch_check(what, before, want):
    """Exact launch counts of a sharded step since ``before`` (a copy of
    the counters): one per shard per launch."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    for k, n in want.items():
        got = ck.launches[k] - before[k]
        check(got == n, f"{what}: {k} launched {got} times, expected {n}")


def sharded_bitvectors(tbm, device, mesh, times, tag):
    """Two 2^30-bit vectors and one of 2^31 + 2^16 bits over ``mesh``:
    AND/OR/XOR/SUB, count, count_range, select and rank batches (both
    select routes), get_bits, reshard to one shard, checkpoint; every
    answer against numpy and every step's launches counted."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import Mesh, ShardedBitVector
    n = mesh.size
    rng = np.random.default_rng(SEED + 31)
    size = SHARD_BLOCKS * BPB
    wa, wb = _block_words(rng, SHARD_BLOCKS), _block_words(rng, SHARD_BLOCKS)
    with Clock(f"{tag}_build_ms", times):
        a = ShardedBitVector.from_words(wa, size, mesh)
        b = ShardedBitVector.from_words(wb, size, mesh)
    fa, fb = wa.reshape(-1), wb.reshape(-1)
    for op in OPS:
        before = dict(ck.launches)
        r = getattr(a, DUNDER[op])(b)
        shard_launch_check(f"sharded {op}", before,
                           {"logical_op_digest": n})
        want = oracle_op(op, fa, fb)
        check(np.array_equal(r.to_words().reshape(-1), want),
              f"sharded {op} rows")
        before = dict(ck.launches)
        check(r.count() == int(np.bitwise_count(want).sum(dtype=np.int64)),
              f"sharded {op} count")
        shard_launch_check(f"sharded {op} count", before,
                           {"block_counts": n})
    lo = rng.integers(0, size, N_RANGES)
    hi = np.minimum(lo + rng.integers(0, size // 4, N_RANGES), size - 1)
    want = oracle_rank(fa, hi) - oracle_rank(fa, lo - 1)
    check([a.count_range(int(x), int(y)) for x, y in zip(lo, hi)]
          == want.tolist(), "sharded count_range")
    total = a.count()
    ranks = rng.integers(1, total + 1, N_QUERIES)
    with Clock(f"{tag}_select_1M_ms", times):
        got = a.select_batch(ranks)
    check(a._rs is None, "2^30 bits: the select below the cap")
    check(np.array_equal(got, oracle_select(fa, ranks)), "sharded select")
    ids = rng.integers(0, size, N_QUERIES)
    with Clock(f"{tag}_rank_1M_ms", times):
        got = a.build_rs_index().rank_batch(ids)
    check(np.array_equal(got, oracle_rank(fa, ids)), "sharded rank")
    bits = ((fa[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1).astype(bool)
    check(np.array_equal(a.get_bits(ids), bits), "sharded get_bits")
    one = a.reshard(Mesh([mesh.devices[0]]))
    check(one.mesh.size == 1 and np.array_equal(one.to_words(), wa),
          f"reshard {n} -> 1")
    with Clock(f"{tag}_checkpoint_ms", times):
        blob = a.checkpoint_bytes()
        back = ShardedBitVector.from_checkpoint(blob, mesh)
    check(np.array_equal(back.to_words(), wa), "sharded checkpoint")
    del one, back, r
    nbig = -(-BIG_BITS // BPB)
    if -(-nbig // n) * BPB >= 2**31:
        log(f"sharded: {BIG_BITS} bits on {n} shard(s): a shard would span "
            f"2^31 bits or more, past the rank/select index's int32 "
            f"prefix; the vector needs at least 2 shards")
        return a, b, wa, wb
    # past 2^31 bits: the select takes the rank/select index route
    wc = _block_words(rng, nbig)
    wc.reshape(-1)[BIG_BITS // 32:] = 0
    c = ShardedBitVector.from_words(wc, BIG_BITS, mesh)
    fc = wc.reshape(-1)
    total = c.count()
    check(total == int(np.bitwise_count(fc).sum(dtype=np.int64)),
          "2^31 + 2^16 bits: count")
    ranks = np.concatenate([rng.integers(1, total + 1, N_QUERIES),
                            [total, total + 1, 0]])
    with Clock(f"{tag}_big_select_1M_ms", times):
        got = c.select_batch(ranks)
    check(c._rs is not None, "2^31 + 2^16 bits: the select past the cap")
    want = np.full(ranks.size, -1, np.int64)
    want[:-2] = oracle_select(fc, ranks[:-2])
    check(np.array_equal(got, want), "2^31 + 2^16 bits: select")
    ids = np.concatenate([rng.integers(0, BIG_BITS, N_QUERIES),
                          [BIG_BITS - 1, BIG_BITS - BPB + 5]])
    check(np.array_equal(c.build_rs_index().rank_batch(ids),
                         oracle_rank(fc, ids)), "2^31 + 2^16 bits: rank")
    return a, b, wa, wb


def sharded_and_groups(tbm, device, mesh, times):
    """sharded_and_many over AND_MANY 2^30-bit vectors whose content lies
    in half the blocks each (digest narrowing on and off),
    sharded_and_sub_count, and group_and_exchange on a vector-axis mesh;
    against numpy."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import (Mesh, ShardedBitVector,
                                             group_and_exchange,
                                             sharded_and_many,
                                             sharded_and_sub_count)
    n = mesh.size
    rng = np.random.default_rng(SEED + 32)
    size = SHARD_BLOCKS * BPB
    keeps = rng.random((AND_MANY, SHARD_BLOCKS)) < 0.5
    words = [_block_words(rng, SHARD_BLOCKS, k) for k in keeps]
    vs = [ShardedBitVector.from_words(w, size, mesh) for w in words]
    want = np.bitwise_and.reduce(np.stack(words), axis=0)
    alive = keeps.all(axis=0)
    for narrow in (True, False):
        before = dict(ck.launches)
        with Clock(f"and_many_{'narrowed' if narrow else 'full'}_ms",
                   times):
            r = sharded_and_many(vs, digest_narrowing=narrow)
        check(np.array_equal(r.to_words(), want),
              f"sharded_and_many (narrowing {narrow})")
        check(r.last_narrowing == ((int(alive.sum()) if narrow
                                    else SHARD_BLOCKS), SHARD_BLOCKS),
              f"last_narrowing {r.last_narrowing}")
        busy = np.count_nonzero(alive.reshape(n, -1).any(axis=1))
        shard_launch_check("sharded_and_many", before,
                           {"agg_and_sub": busy if narrow else n})
    times["and_many_survivors"] = int(alive.sum())
    sub = np.bitwise_or.reduce(np.stack(words[4:6]), axis=0)
    want_c = int(np.bitwise_count(np.bitwise_and.reduce(
        np.stack(words[:4]), axis=0) & ~sub).sum(dtype=np.int64))
    for narrow in (True, False):
        check(sharded_and_sub_count(vs[:4], vs[4:6], narrow) == want_c,
              f"sharded_and_sub_count (narrowing {narrow})")
    vmesh = Mesh([mesh.devices[i % mesh.size] for i in range(AND_MANY)], "v")
    stack = np.stack(words)
    before = dict(ck.launches)
    with Clock("group_and_exchange_ms", times):
        rows, surv, traffic = group_and_exchange(stack, vmesh, "v")
    check(np.array_equal(surv, np.flatnonzero(alive)), "exchange survivors")
    check(traffic == (int(alive.sum()), SHARD_BLOCKS), "exchange traffic")
    # no survivor: one zero row stands for the empty result
    want_rows = want[surv] if surv.size else np.zeros((1, 2048), np.uint32)
    check(np.array_equal(rows.cpu().numpy().view(np.uint32), want_rows),
          "exchange rows")
    cnt, _, _ = group_and_exchange(stack, vmesh, "v", count_only=True)
    check(cnt == int(np.bitwise_count(want).sum(dtype=np.int64)),
          "exchange count")
    times["exchange_launches"] = {k: v - before[k]
                                  for k, v in ck.launches.items()
                                  if v > before[k]}
    return vs


def sharded_scans(tbm, mesh, ssv, live, assigned, times):
    """The config 4b stack: pipeline_counts_host with SV_QUERIES selectors,
    pipeline_find_eq and scan_throughput_program, against numpy."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import (pipeline_counts_host,
                                             scan_throughput_program)
    n = mesh.size
    rng = np.random.default_rng(SEED + 33)
    values = rng.integers(0, 1 << SV_BITS, SV_QUERIES)
    values[:8] = live[rng.integers(0, SV_N, 8)]
    hist = np.bincount(live[assigned], minlength=1 << SV_BITS)
    want = [int(hist[v]) for v in values]
    sels = np.stack([ssv._selector(int(v)) for v in values])
    before = dict(ck.launches)
    with Clock("pipeline_counts_256_ms", times):
        got = pipeline_counts_host(mesh, ssv.stack, sels)
    shard_launch_check("pipeline_counts_host", before,
                       {"pipeline_counts": n})
    check(got.tolist() == want, "sharded pipeline counts")
    check(ssv.pipeline_find_eq(values.tolist()) == want,
          "sharded pipeline_find_eq")
    v = int(values[0]) or 1
    bps = ssv.stack[0].shape[1]
    # the scan reads the 20 value planes only: NULL rows hold value 0
    scan, _ = scan_throughput_program(mesh, SV_BITS, bps)
    before = dict(ck.launches)
    with Clock("scan_throughput_ms", times):
        hits = scan(ssv.stack, v)
    shard_launch_check("scan_throughput_program", before,
                       {"scan_eq": n, "block_counts": n})
    check(int(hits) == int(hist[v]), "scan_throughput_program count")


def sharded_svs(tbm, device, mesh, cols, times):
    """The four sharded sparse vectors built from the sv phase's columns:
    find_eq / ne / gt / ge / lt / le / range, pipelines, gather and the
    checkpoint round trip, against numpy or Python."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import (ShardedFloatVector,
                                             ShardedRSCVector,
                                             ShardedSparseVector,
                                             ShardedStrSparseVector)
    rng = np.random.default_rng(SEED + 34)
    sv, vals, nm = cols["4b"]
    v64, ok = vals.astype(np.int64), ~nm
    live = np.where(nm, 0, vals)

    def hits(r):
        return r.to_bitvector().indices()
    with Clock("sv_4b_build_ms", times):
        ssv = ShardedSparseVector.from_sparse_vector(sv, mesh)
    drawn = int(vals[rng.integers(0, SV_N)])
    check(np.array_equal(hits(ssv.find_eq(drawn)),
                         np.flatnonzero((v64 == drawn) & ok)), "4b find_eq")
    check(ssv.find_eq_count(drawn) == int(((v64 == drawn) & ok).sum()),
          "4b find_eq_count")
    check(np.array_equal(hits(ssv.find_ne(drawn)),
                         np.flatnonzero((v64 != drawn) & ok)), "4b find_ne")
    for name, op in ORDER_OPS.items():
        check(np.array_equal(hits(getattr(ssv, name)(drawn)),
                             np.flatnonzero(op(v64, drawn) & ok)),
              f"4b sharded {name}")
    check(np.array_equal(hits(ssv.find_range(1000, 1 << 19)),
                         np.flatnonzero((v64 >= 1000) & (v64 <= 1 << 19)
                                        & ok)), "4b sharded find_range")
    before = ck.launches["logical_op_digest"]
    with Clock("find_gt_ms", times):
        ssv.find_gt(drawn)
    times["find_gt_k1_launches"] = ck.launches["logical_op_digest"] - before
    ids = rng.integers(0, SV_N, SV_GATHER)
    with Clock("sv_4b_gather_1M_ms", times):
        got = ssv.gather(ids)
    check(np.array_equal(got, live[ids]), "4b sharded gather")
    blob = ssv.checkpoint_bytes()
    again = ShardedSparseVector.from_checkpoint(blob, mesh)
    check(all(torch.equal(x, y) for x, y in zip(again.stack, ssv.stack)),
          "4b sharded checkpoint")
    sharded_scans(tbm, mesh, ssv, live, ok, times)
    # RSC: samples/11's column
    rsc, idx, rv = cols["rsc"]
    with Clock("rsc_build_ms", times):
        srsc = ShardedRSCVector.from_rsc(rsc, mesh)
    q = int(rv[5])
    check(np.array_equal(hits(srsc.find_eq(q)), idx[rv == q]),
          "rsc sharded find_eq")
    for name, op, v in (("find_gt", np.greater, 1 << 19),
                        ("find_le", np.less_equal, 1000),
                        ("find_ne", np.not_equal, q)):
        check(np.array_equal(hits(getattr(srsc, name)(v)), idx[op(rv, v)]),
              f"rsc sharded {name}")
    check(srsc.pipeline_find_eq([q, 0]) == [int((rv == q).sum()), 0],
          "rsc sharded pipeline")
    probe = np.concatenate([rng.integers(0, srsc.size, 100_000), idx[::97]])
    gv, gok = srsc.gather(probe)
    check(np.array_equal(gv, rsc.gather(probe)) and np.array_equal(
        gok, np.isin(probe, idx)), "rsc sharded gather")
    again = ShardedRSCVector.from_checkpoint(srsc.checkpoint_bytes(), mesh)
    check(np.array_equal(again.gather(probe)[0], gv), "rsc sharded checkpoint")
    # strings: the remapped dictionary
    cat, _, names, queries, nums = cols["dict"]
    with Clock("dict_build_ms", times):
        sstr = ShardedStrSparseVector.from_str_vector(cat, mesh)
    k = int(rng.integers(0, STR_N))
    check(hits(sstr.find_eq_str(names[k])).tolist() == [k],
          "dict sharded find_eq_str")
    check(sstr.find_eq_str_count(queries[-1]) == 0, "dict missing id")
    lo = int(np.searchsorted(nums, 1_200_000))
    hi = int(np.searchsorted(nums, 1_300_000))
    check(np.array_equal(hits(sstr.find_eq_str_prefix("NGC 12")),
                         np.arange(lo, hi)), "dict sharded prefix")
    with Clock("dict_pipeline_600_ms", times):
        got = sstr.pipeline_find_eq_str(queries)
    check(got == [1] * STR_PRESENT + [0] * STR_MISSING,
          "dict sharded string pipeline")
    gid = rng.integers(0, STR_N, 1000)
    check(sstr.gather(gid) == [names[i] for i in gid.tolist()],
          "dict sharded gather")
    again = ShardedStrSparseVector.from_checkpoint(sstr.checkpoint_bytes(),
                                                   mesh)
    check(again.gather(gid) == [names[i] for i in gid.tolist()],
          "dict sharded checkpoint")
    # floats
    fv, fvals, fnm = cols["float"]
    fok = ~fnm
    with Clock("float_build_ms", times):
        sfv = ShardedFloatVector.from_float_vector(fv, mesh)
    for qf in (12.5, -12.5, 0.0):
        q32 = np.float32(qf)
        for name, op in (("find_eq", np.equal), ("find_gt", np.greater),
                         ("find_le", np.less_equal)):
            check(np.array_equal(hits(getattr(sfv, name)(q32)),
                                 np.flatnonzero(op(fvals, q32) & fok)),
                  f"float sharded {name}({qf})")
    check(sfv.pipeline_find_eq([np.float32(12.5), np.float32(-12.5)])
          == [int(((fvals == 12.5) & fok).sum()),
              int(((fvals == -12.5) & fok).sum())], "float sharded pipeline")
    fid = rng.integers(0, SV_N, 100_000)
    same_values(sfv.gather(fid), np.where(fnm, np.float32(0), fvals)[fid],
                "float sharded gather")
    again = ShardedFloatVector.from_checkpoint(sfv.checkpoint_bytes(), mesh)
    same_values(again.gather(fid), sfv.gather(fid), "float sharded checkpoint")
    return ssv, drawn


def sharded_phase(tbm, device, card, cols):
    """Phase 11: the sharded containers on a mesh of SHARDS shards on the
    one card, in groups with their own launch counts, then the bit-vector
    group and config 4b's searches on ``make_mesh()`` (every visible card);
    a profile of one steady pass.  Returns the phase's launches."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import (Mesh, ShardedSparseVector,
                                             make_mesh)
    mesh = Mesh([device] * SHARDS)
    total = {k: 0 for k in KERNELS}
    times, state = {}, {}
    groups = (
        ("bit-vectors", ("logical_op_digest", "block_counts"),
         lambda: state.update(bv=sharded_bitvectors(
             tbm, device, mesh, times, f"mesh{SHARDS}"))),
        ("and groups", ("agg_and_sub",),
         lambda: sharded_and_groups(tbm, device, mesh, times)),
        ("sparse vectors", ("logical_op_digest", "agg_and_sub",
                            "pipeline_counts", "scan_eq", "block_counts"),
         lambda: state.update(sv=sharded_svs(tbm, device, mesh, cols,
                                             times))))
    for name, need, run in groups:
        ck.reset_launches()
        t0 = time.perf_counter()
        run()
        sync()
        launches = dict(ck.launches)
        log(f"sharded: {name} on {SHARDS} shards passed in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}")
        require_launches(f"sharded {name}", launches, need)
        for k in total:
            total[k] += launches[k]
    # every visible card
    full = make_mesh()
    ck.reset_launches()
    t0 = time.perf_counter()
    sharded_bitvectors(tbm, device, full, times, f"cards{full.size}")
    sv, vals, nm = cols["4b"]
    s1 = ShardedSparseVector.from_sparse_vector(sv, full)
    drawn = state["sv"][1]
    ok = ~nm
    check(np.array_equal(s1.find_gt(drawn).to_bitvector().indices(),
                         np.flatnonzero((vals > drawn) & ok)),
          "make_mesh find_gt")
    check(s1.find_eq_count(drawn) == int(((vals == drawn) & ok).sum()),
          "make_mesh find_eq_count")
    launches = dict(ck.launches)
    log(f"sharded: make_mesh() over {full.size} card(s) passed in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    for k in total:
        total[k] += launches[k]
    log(f"sharded: phase ms {json.dumps(times)}")
    log(json.dumps({"sharded_find_gt_config4b": {
        "shards": SHARDS, "ms": times["find_gt_ms"],
        "k1_launches": times["find_gt_k1_launches"]}, "card": card["smi"]}))
    a, b = state["bv"][0], state["bv"][1]
    ssv = state["sv"][0]
    ranks = np.random.default_rng(SEED + 35).integers(1, a.count() + 1,
                                                      N_QUERIES)
    profile(f"sharded steady pass ({SHARDS} shards: 4 ops + counts on 2^30 "
            f"bits, 1M select, find_gt on config 4b)",
            lambda: ([getattr(a, DUNDER[op])(b).count() for op in OPS],
                     a.select_batch(ranks), ssv.find_gt(drawn)))
    return total


# ---------------------------------------------------------------------------
# phase 14: timing
# ---------------------------------------------------------------------------
def time_ms(fn, flush, reps=25, clean=None):
    """Median device time of ``fn`` over ``reps`` runs after a warm-up.
    Before each run a 512 MiB memset evicts the 50 MB L2 and keeps the
    stream busy while the host enqueues the run, so the events bracket the
    device work and not the host's launch overhead.  The memset leaves L2
    full of dirty lines, which the run's reads write back; with ``clean``
    (a second buffer) a read-only pass over it follows the memset and
    leaves L2 holding clean lines instead."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        if clean is not None:
            clean.max()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def record(out, key, card, flush, kern, plain, lib, nbytes, lops, popcs):
    """Time ``kern``, its plain version and the library call (or None)
    into ``out[key]``, beside the bound: the larger of ``nbytes`` over the
    card's bandwidth and ``lops`` logic ops / ``popcs`` popcounts over
    their peak rates."""
    ms = time_ms(kern, flush)
    pms = time_ms(plain, flush, reps=5)
    lms = time_ms(lib, flush) if lib is not None else None
    bytes_ms = nbytes / card["peak_bw"] * 1e3
    ops_ms = max(lops / card["lop_rate"], popcs / card["popc_rate"]) * 1e3
    out[key] = dict(
        ms=ms, plain_ms=pms, library_ms=lms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes, gb_per_s=nbytes / (ms * 1e-3) / 1e9)


def desc_rows_read(desc) -> int:
    """Rows one gather descriptor makes a kernel read: aux rows and pool
    rows; FULL and absent rows are not read."""
    pool, slot, full, aux, aux_slot = desc
    on_aux = aux_slot >= 0
    on_pool = (~on_aux) & (~full) & (slot >= 0) & (pool.shape[0] > 0)
    return int(on_aux.sum()) + int(on_pool.sum())


def timings(device, card, cfg1):
    """K1-K3 at 1536 and 16384 rows; K3 and K2 at config 1's own shapes
    (``cfg1``: A's pool and the descriptors distance_operation hands K2),
    per block and in total form; the floor of a timed launch; K3 at 1536
    and 16384 rows after a flush that leaves L2 clean."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(SEED + 4)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    row = 8192
    out = {}
    one = torch.empty(1, dtype=torch.int32, device=device)
    out["floor"] = time_ms(one.zero_, flush)
    for n in (N_BLOCKS, SCALE_BLOCKS):
        a, b = _rand_pool(rng, n, device), _rand_pool(rng, n, device)
        words = n * 2048
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
        if n == N_BLOCKS:
            cases["block_counts", "total_1536"] = (
                lambda: ck.block_counts_total(a),
                lambda: blockops.block_counts_total(a), None,
                n * row + 8, words)
        for name, (kern, plain, lib, nbytes, popc) in cases.items():
            key = name if isinstance(name, tuple) else (name, n)
            record(out, key, card, flush, kern, plain, lib, nbytes, 0, popc)
        clean = torch.empty_like(flush)
        ms = time_ms(lambda: ck.block_counts(a), flush, clean=clean)
        t = out["block_counts", n]
        out["block_counts", f"{n}_clean_l2"] = dict(
            t, ms=ms, plain_ms=None, gb_per_s=t["bytes"] / (ms * 1e-3) / 1e9)
        del clean
        del a, b
    # config 1's shapes: count() on A's pool; distance_operation's 7
    # metrics and count_and's 1 over the candidate blocks
    pool, da, db = cfg1
    n = pool.shape[0]
    for key, per_block in (("config1_A", True), ("total_config1_A", False)):
        record(out, ("block_counts", key), card, flush,
               (lambda: ck.block_counts(pool)) if per_block
               else (lambda: ck.block_counts_total(pool)),
               lambda: blockops.block_counts_total(pool, per_block), None,
               n * row + (n * 4 if per_block else 8), 0, n * 2048)
    k = da[1].shape[0]
    reads = desc_rows_read(da) + desc_rows_read(db)
    for ms_name, ms in (("7", METRICS), ("1", ("count_and",))):
        n_popc = len(blockops.count_plan(ms)[0])
        for form in ("config1_", "total_config1_"):
            per_block = form == "config1_"
            nbytes = (reads * row + 2 * k * 9
                      + (len(ms) * k * 4 if per_block else len(ms) * 8))
            record(out, ("count_op", form + ms_name), card, flush,
                   (lambda ms=ms: ck.count_metrics(ms, da, db)) if per_block
                   else (lambda ms=ms: ck.count_metrics_total(ms, da, db)),
                   lambda ms=ms, per_block=per_block:
                       blockops.count_metrics_total(ms, da, db, per_block),
                   None, nbytes, 0, n_popc * k * 2048)
            out["count_op", form + ms_name].update(
                rows=k, rows_read=reads, popcounts_per_word_pair=n_popc)
    return out


def _sweep_reads(rows_by_operand, n_and, slices, group=4):
    """(rows needed, rows fetched, bool[K, nb] needed) of one AND-SUB
    sweep.  Needed: per column, every operand up to and including the one
    that zeroes its accumulator (the bound counts these).  Fetched: what
    agg_sub.cu reads, per slice (16 per column for one request, 8 in a
    batch) every operand of the groups of four up to the one whose vote
    finds the slice zero, in units of whole rows."""
    K = len(rows_by_operand)
    acc = torch.full_like(rows_by_operand[0], -1)
    nb = acc.shape[0]
    used = torch.zeros((K, nb), dtype=torch.bool, device=acc.device)
    fetched = 0
    for g0 in range(0, K, group):
        alive = (acc.reshape(nb, slices, -1) != 0).any(dim=2)
        fetched += int(alive.sum()) * min(group, K - g0)
        for k in range(g0, min(g0 + group, K)):
            used[k] = (acc != 0).any(dim=1)
            r = rows_by_operand[k]
            acc = acc & (r if k < n_and else ~r)
    return int(used.sum()), fetched / slices, used


def _b4_single(ck, device, table, K, n_and, nb, res):
    return lambda: ck._launch("bm_agg_and_sub", "agg_and_sub", device,
                              ck._ptr(table), None, 1, K, n_and, 0, nb,
                              ck._ptr(res), None)


def _b4_batch_case(ck, blockops, rng, device):
    """Config 3's 64-request result pipeline over its 200-plane stack:
    (one batched launch as ``cuda_kernels.agg_and_sub_batch`` makes it, the
    64 single launches, plain, bytes, word-ops, rows needed per request
    summed, distinct rows needed, rows fetched, the plain rows, output)."""
    stack = _bits_pool(rng, AGG_K * AGG_BLOCKS, 1, device).reshape(
        AGG_K, AGG_BLOCKS, 2048)
    sel = np.zeros((N_REQUESTS, AGG_K), np.int32)
    for i, (a, sb) in enumerate(agg_requests(rng, AGG_K, N_REQUESTS)):
        sel[i, a] = 1
        sel[i, sb] = -1
    index, offs, n_and = blockops.selector_requests(sel)
    descs = [(stack[k], None, None, None, None) for k in range(AGG_K)]
    buf, req_ptr = ck._batch_table(descs, index, offs, n_and, AGG_BLOCKS,
                                   device)
    out = torch.empty((N_REQUESTS, AGG_BLOCKS, 2048), dtype=torch.int32,
                      device=device)

    def batch():
        ck._launch("bm_agg_and_sub", "agg_and_sub", device, ck._ptr(buf),
                   req_ptr, N_REQUESTS, 0, 0, 0, AGG_BLOCKS, ck._ptr(out),
                   None)

    rows = ck._descriptor_rows(descs, AGG_BLOCKS)
    singles = []
    needed = fetched = 0
    used = torch.zeros((AGG_K, AGG_BLOCKS), dtype=torch.bool, device=device)
    for r in range(N_REQUESTS):
        ops = index[offs[r]:offs[r + 1]]
        table = torch.from_numpy(rows[ops]).to(device)
        singles.append(_b4_single(ck, device, table, ops.size, int(n_and[r]),
                                  AGG_BLOCKS, out[r]))
        singles[-1].table = table
        nd, ft, u = _sweep_reads([stack[k] for k in ops], int(n_and[r]), 8)
        needed += nd
        fetched += ft
        used[torch.from_numpy(ops).to(device)] |= u

    def all_singles():
        for f in singles:
            f()

    def plain():
        return blockops.agg_and_sub_batch(descs, index, offs, n_and)[0]

    row = 8192
    distinct = int(used.sum())
    # bytes: each needed row once (a row several requests select is
    # counted once), the rows written, the uploaded table
    nbytes = (distinct * row + N_REQUESTS * AGG_BLOCKS * row
              + buf.numel() * 8)
    return (batch, all_singles, plain, nbytes, needed * 2048, needed,
            distinct, fetched, plain(), out)


def search_timings(device, card):
    """B4, B5 and B6 at the config-3, config-4b and config-4 shapes.  The
    kernels are launched directly with inputs prepared on the card (the
    wrappers' descriptor and selector uploads are host work, counted in
    the paths' phase times)."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(SEED + 8)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    ptr = ck._ptr
    row = 8192
    out = {}

    def rec(key, kern, plain, nbytes, lops, popcs):
        record(out, key, card, flush, kern, plain, None, nbytes, lops, popcs)

    # B4, arena form: config 3 (200 operands, 100 AND / 100 SUB, 128
    # columns of uniform random rows) and config 4b's find_eq (20 planes
    # + the NULL plane over 245 columns, 11 AND / 10 SUB)
    for key, K, n_and, nb, or_k in (("config3", AGG_K, AGG_K // 2,
                                     AGG_BLOCKS, 1),
                                    ("config4b", SV_BITS + 1, 11, 245, 1)):
        pool = _bits_pool(rng, K * nb, or_k, device)
        slots = torch.arange(K * nb, dtype=torch.int32,
                             device=device).reshape(K, nb)
        descs = blockops.arena_descriptors(n_and, slots, pool)
        res = torch.empty((nb, 2048), dtype=torch.int32, device=device)
        table = ck._descriptor_table(descs, nb, device)
        reads, fetched, _ = _sweep_reads(list(pool.reshape(K, nb, 2048)),
                                         n_and, 16)
        rec(("agg_and_sub", key),
            _b4_single(ck, device, table, K, n_and, nb, res),
            lambda: blockops.agg_and_sub(n_and, descs),
            reads * row + nb * row + K * nb * 4, reads * 2048, 0)
        out[("agg_and_sub", key)].update(rows_read=reads,
                                         rows_fetched=fetched,
                                         rows_total=K * nb)
    # B4 batched: config 3's 64-request result pipeline in one launch,
    # against the 64 single launches it replaces
    (batch, singles, plain, nbytes, lops, reads, distinct, fetched, want,
     res) = _b4_batch_case(ck, blockops, rng, device)
    batch()
    sync()
    check(torch.equal(res, want), "timed batched B4 launch = plain")
    rec(("agg_and_sub", "config3_batch64"), batch, plain, nbytes, lops, 0)
    sync()
    check(torch.equal(res, want), "timed batched B4 launch = plain")
    out[("agg_and_sub", "config3_batch64")].update(
        singles_ms=time_ms(singles, flush), rows_read=reads,
        rows_distinct=distinct, rows_fetched=fetched)
    del res, want
    # B5: config 4b (21 planes x 245 blocks, 256 values) and config 3's
    # counts pipeline (200 planes x 128 blocks, 64 requests)
    for key, S, nb, V in (("config4b", SV_BITS + 1, 245, SV_QUERIES),
                          ("config3", AGG_K, AGG_BLOCKS, N_REQUESTS)):
        planes = _bits_pool(rng, S * nb, 1, device).reshape(S, nb, 2048)
        sel = _b5_selectors(rng, key, S, V)
        buf, args = ck.pipeline_prepare(planes, sel)
        cnt = torch.zeros(V, dtype=torch.int64, device=device)

        def kern(args=args, cnt=cnt):
            cnt.zero_()
            ck._launch("bm_pipeline_counts", "pipeline_counts", device,
                       *args, ptr(cnt))

        words = nb * 2048
        n_sel = int((sel != 0).any(axis=0).sum())
        n_codes = int((sel != 0).sum())
        # bytes: the staged planes once, the selector input, the counts
        rec(("pipeline_counts", key), kern,
            lambda planes=planes, sel=sel: blockops.pipeline_counts(
                planes, sel),
            n_sel * nb * row + buf.numel() * 4 + V * 8,
            n_codes * words, V * words)
        out[("pipeline_counts", key)].update(planes_staged=n_sel,
                                             planes_total=S)
        del buf
    # B6: config 4 (32 planes x 512 blocks) and config 4b's planes
    for key, S, nb in (("config4", SCAN_PLANES, SCAN_BLOCKS),
                       ("config4b", SV_BITS, 245)):
        planes = _rand_pool(rng, S * nb, device).reshape(S, nb, 2048)
        res = torch.empty((nb, 2048), dtype=torch.int32, device=device)
        rec(("scan_eq", key),
            lambda planes=planes, S=S, nb=nb, res=res: ck._launch(
                "bm_scan_eq", "scan_eq", device, ptr(planes), S, nb,
                123456789, ptr(res)),
            lambda planes=planes, S=S: blockops.scan_eq(S, planes,
                                                        123456789),
            (S + 1) * nb * row, S * nb * 2048, 0)
    return out


def _b5_selectors(rng, key, S, V):
    """Config 4b: V values' 20 bits plus the NULL plane; config 3: the 64
    requests of 1-4 AND and 0-3 SUB operands."""
    if key == "config4b":
        vals = rng.integers(1, 1 << SV_BITS, V)
        bits = (vals[:, None] >> np.arange(SV_BITS)) & 1
        sel = np.concatenate([np.where(bits == 1, 1, -1),
                              np.ones((V, 1), np.int64)], axis=1)
    else:
        sel = np.zeros((V, S), np.int64)
        for i, (a, sb) in enumerate(agg_requests(rng, S, V)):
            sel[i, a] = 1
            sel[i, sb] = -1
    return sel.astype(np.int32)


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
                * max_clk_mhz * 1e6,
                lop_rate=props.multi_processor_count * LOP_PER_CLK_PER_SM
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
    for k in FIRST_SLICE:
        check(main_launches[k] > 0, f"main path never launched {k}")
    a, b = state[0], state[1]
    r = a & b
    for what, fn, kernel in (
            ("count()", r.count, "block_counts_kernel"),
            ("distance_operation", lambda: tbm.distance_operation(
                a, b, list(METRICS)), "count_metrics_kernel")):
        names = device_kernels(fn)
        log(f"main: {what} put these kernels on the card: {names}")
        check(len(names) == 1 and kernel in names[0],
              f"{what}: one launch of {kernel} and no sum kernel after it")
    cfg1 = (a._pool, *k2_operands(a, b))
    del a, b, r
    profile("steady pass (4 ops + counts, distance_operation, 1M select)",
            lambda: steady_pass(tbm, *state))
    del state

    # 5-6. the search paths: config 3 (aggregator), config 4b (scanner)
    path_launches = {}
    for path, run, steady, what in (
            ("agg", agg_path, agg_steady_pass,
             "the 100/100 and 3/2 combine_and_sub + a 64-request counts "
             "pipeline"),
            ("scan", scan_path, scan_steady_pass,
             "prepared counts of 256 values + pipeline_find_eq of 8")):
        ck.reset_launches()
        t0 = time.perf_counter()
        times, state = run(tbm, device)
        path_launches[path] = dict(ck.launches)
        log(f"{path}: config {'3' if path == 'agg' else '4b'} passed in "
            f"{time.perf_counter() - t0:.1f} s; launches "
            f"{path_launches[path]}; phase ms {json.dumps(times)}")
        for k in ("agg_and_sub", "pipeline_counts"):
            check(path_launches[path][k] > 0,
                  f"{path} path never launched {k}")
        if path == "agg":
            log(f"agg: config-3 arena build {times['arena_build_ms']} ms "
                f"(GAP blocks expanded by the native gaps_to_dense)")
        profile(f"{path} steady pass ({what})",
                lambda: steady(tbm, *state))
        if path == "scan":
            sv = state[1]
        del state
    search_launches = {k: path_launches["agg"][k] + path_launches["scan"][k]
                       for k in KERNELS}

    # 7. the algo phase: the rest of BitVector and the algorithms
    _, vals, nm = config4b_values()
    ck.reset_launches()
    t0 = time.perf_counter()
    algo_times, state = algo_path(tbm, device, sv,
                                  np.where(nm, np.uint32(0), vals))
    algo_launches = dict(ck.launches)
    log(f"algo: passed in {time.perf_counter() - t0:.1f} s; launches "
        f"{algo_launches}; phase ms {json.dumps(algo_times)}")
    for k in FIRST_SLICE:
        check(algo_launches[k] > 0, f"algo path never launched {k}")
    entry_points = algo_entry_points(tbm, *state)
    del state
    for what, fn in entry_points.items():
        before = dict(ck.launches)
        names = device_kernels(fn)        # runs fn twice: warm-up, traced
        counted = {k: (ck.launches[k] - before[k]) // 2 for k in FIRST_SLICE
                   if ck.launches[k] > before[k]}
        log(f"algo: {what} put these kernels on the card: "
            f"{json.dumps(short_kernel_names(names))}; launch counters per "
            f"call {counted}")
        if what in ALGO_KERNEL:
            # the counters decide: the profiler can drop the events of a
            # short trace (on an H100 it once listed none for count())
            counter, kernel = ALGO_KERNEL[what]
            check(counted.get(counter, 0) > 0, f"{what} launched no {kernel}")
            if not any(kernel in n for n in names):
                log(f"algo: {what}: the profiler recorded no {kernel} event "
                    f"where the counters show {counted[counter]} launch(es)")
    steady = ("insert", "erase", "compare", "similarity_batch",
              "jaccard_batch")
    profile(f"algo steady pass ({', '.join(steady)})",
            lambda: [entry_points[k]() for k in steady])
    del entry_points

    # 8. the serial phase: BMT1 and reference-format BLOBs, set ops on
    # BLOBs, configs 5 and 5b, the reference's 94 bit-vector BLOBs
    serial_launches = serial_phase(tbm, device, card)

    # 9. the sv phase: ordered and sorted searches, the float, string and
    # RSC vectors, BitMatrix and the sv algorithms
    t0 = time.perf_counter()
    sv_launches, cols = sv_phase(tbm, device, card, sv, vals, nm)
    log(f"sv: passed in {time.perf_counter() - t0:.1f} s; launches "
        f"{sv_launches}")
    require_launches("sv phase", sv_launches,
                     ("logical_op_digest", "agg_and_sub", "pipeline_counts",
                      "block_counts"))

    # 10. the sv_serial phase: the sv phase's columns through BMSV and the
    # reference's sparse-vector format, then its five fixtures
    sv_serial_launches = sv_serial_phase(tbm, device, card, cols)

    # 11. the sharded phase: sharded bit-vectors and sparse vectors on a
    # mesh of SHARDS shards on the one card and on every visible card
    t0 = time.perf_counter()
    sharded_launches = sharded_phase(tbm, device, card, cols)
    log(f"sharded: passed in {time.perf_counter() - t0:.1f} s; launches "
        f"{sharded_launches}")
    require_launches("sharded phase", sharded_launches,
                     ("logical_op_digest", "block_counts", "agg_and_sub",
                      "pipeline_counts", "scan_eq"))
    del sv, vals, nm, cols

    # 12. reference fixtures
    ck.reset_launches()
    fixtures_path(tbm, device)
    log(f"fixtures: reference counts, AND ids, ranks and selects match; "
        f"launches {dict(ck.launches)}")

    # 13. scale phases: 2^30-bit pair, then 200 x 1536 blocks
    ck.reset_launches()
    t0 = time.perf_counter()
    scale_times = scale_path(tbm, device)
    log(f"scale: 2^30 bits passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {dict(ck.launches)}; phase ms {json.dumps(scale_times)}")
    ck.reset_launches()
    t0 = time.perf_counter()
    scale_times = agg_scale_path(tbm, device)
    log(f"scale: 200 x {AGG_SCALE_BLOCKS} blocks passed in "
        f"{time.perf_counter() - t0:.1f} s; launches {dict(ck.launches)}; "
        f"phase ms {json.dumps(scale_times)}")
    check(ck.launches["agg_and_sub"] > 0 and ck.launches["pipeline_counts"]
          > 0, "search scale phase launched B4 and B5")

    # 14. timing
    tm = timings(device, card, cfg1)
    del cfg1
    log(json.dumps({"floor_ms": tm["floor"], "what": "one-element zero_() "
                    "timed like every kernel", "card": card["smi"]}))
    tm.update(search_timings(device, card))
    kernels = []
    shapes = {k: (N_BLOCKS, SCALE_BLOCKS) for k in FIRST_SLICE}
    shapes["block_counts"] += ("1536_clean_l2", "16384_clean_l2",
                               "config1_A", "total_1536", "total_config1_A")
    shapes["count_op"] += ("config1_7", "config1_1", "total_config1_7",
                           "total_config1_1")
    shapes.update(agg_and_sub=("config3", "config4b", "config3_batch64"),
                  pipeline_counts=("config4b", "config3"),
                  scan_eq=("config4", "config4b"))
    for k, meta in KERNELS.items():
        launches = (main_launches[k] if k in FIRST_SLICE
                    else search_launches[k])
        for shape in shapes[k]:
            t = tm[(k, shape)]
            log(json.dumps({"kernel": k, "shape": shape, **{
                x: t[x] for x in ("ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by", "bytes",
                                  "gb_per_s", "rows", "rows_read",
                                  "rows_distinct", "rows_fetched",
                                  "rows_total", "singles_ms",
                                  "popcounts_per_word_pair",
                                  "planes_staged", "planes_total")
                if x in t}, "main_path_launches": launches,
                "card": card["smi"]}))
        t = tm[(k, shapes[k][0])]
        entry = {"name": k, "route": "cuda", **meta, "launches": launches,
                 "algo_launches": algo_launches[k],
                 "serial_launches": serial_launches[k],
                 "sv_launches": sv_launches[k],
                 "sv_serial_launches": sv_serial_launches[k],
                 "sharded_launches": sharded_launches[k],
                 "max_abs_err": err[k], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if k == "scan_eq":
            entry["note"] = ("its entry point is scan_throughput_program "
                             "(sharded phase); the main paths do not call "
                             "it")
        kernels.append(entry)
    # the card's name and power limit, exactly as nvidia-smi prints them
    log(nvidia_smi("name,power.limit"))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
