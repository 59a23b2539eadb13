#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bitmagic_tpu_torch``) on one NVIDIA card
and check it.

    python3 chip_smoke.py            # from the repository root, on the card
    python3 chip_smoke.py --single-query ROOT
                                     # only the one-query timing of the
                                     # main path, with the package under
                                     # ROOT (two trees in turns, one call)
    python3 chip_smoke.py --descent  # phases 1-2, then only the ordered
                                     # descent's checks and timings

Phases (any failure raises and exits non-zero; the last line is printed
only when every phase passed):

 1. probe   — require CUDA; print the card's name and power limit;
 2. build   — compile the kernels from ``ops/csrc`` with nvcc, all at
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
              equality scan (B6) at config 4; gap_expand and gap_compress
              at bvsetalgebra_rank_select's shapes (768 D-GAP blocks of 1
              to 256 runs expanded, 400 AND rows re-encoded) and on edge
              rows (1-run blocks, lone bits at 0 and 65535, 65536 runs),
              gap_compress over compress_cases (20,000 rows, more CTAs
              than the card holds, for its look-back; rows of 65536 runs;
              cap equal to the total, above and below it), each store
              equal to GapStore.from_dense's,
              gap_expand's pair launch (two stores' blocks in one launch)
              and its many-store launch (the aggregator's operands)
              over gap_cases (1-run blocks, runs ending on bits 31 and 32
              of a word and on 65534, 1280 runs, the default top GAP
              level, and above it: 1281, 3000 and 65536, either side
              empty);
              sv_gather over columns with BIT, D-GAP, FULL and FULL-run
              blocks, absent planes, a NULL plane that is BIT and one
              that is a FULL run, signed and 64-bit values and ids past
              the end (and against the values), and over gather_cases
              (every id in one block, sorted ids, duplicates, ids past
              the end and in absent blocks, sparse ids over a 2100-block
              column and 2.8M ids grouped over it, its directory too large
              for shared memory; 65 planes staged 24 rows at a time), each
              on the route its size gives it,
              sv_transpose over 1 to 64 slices of 4- and 8-byte values
              (n of 1, 31, 33, 1023 and 1025 too, and views not 16-byte
              aligned);
              rs_select and rs_rank and their flat forms (select_flat,
              rank_flat) at bvsetalgebra_rank_select's shapes (1536
              blocks, 768 of them D-GAP of 1 to 256 runs, 1M uniform
              ranks and ids) and on an edge vector (D-GAP blocks of one
              run and of 65536 runs, FULL and FULL-run blocks, absent
              blocks, a BIT block emptied by a SUB; ranks -1, 0, 1,
              total, total + 1, ids past the end); rs_select over
              select_cases on both and on FULL-, D-GAP- and BIT-only
              indices and on one of 26,100 segments (one rank, one wave,
              segment edges, ranks outside [1, total]; the large index
              stages only a sample of cum0, and select_flat over its
              pool only a sample of gws); rs_rank over rank_cases and
              rank_flat over the pool on the same six indices (segment
              edges, one id, ids in zero blocks, past the vector and at
              2^31 + bits; the large index stages only a sample of nb);
              select_flat and rank_flat per shard of an 8-shard index;
              sv_descent over columns with BIT, FULL-run, absent and 1-3000
              run D-GAP blocks (GAP pairs of 4096 and 4097 runs) from
              their universe and from a D-GAP plane, with and without eq,
              and over descent_ring_columns (one step, 64 steps, blocks
              that stop early), and descent_rows in its three modes with
              zero planes, at 29, 31 and 245 rows and up to 64 steps;
 4. main    — the benchmark's configs 1-2 through the entry points: two
              100.6M-bit vectors (1536 blocks) mixing BIT, GAP and FULL-run
              blocks; AND/OR/XOR/SUB, count(), distance_operation and
              count_and/or/xor/sub, 64 count_range calls, build_rs_index
              plus 1M select and 1M rank (one rs_select / rs_rank
              launch each, and a profiler trace of each batch shows that
              kernel and its two copies and nothing else), then
              SINGLE_CALLS one-query calls each of select, rank and
              BitVector.select (median host wall, one launch each);
              every answer against numpy; GAP operands are
              expanded by gap_expand and GAP x GAP results re-encoded by
              gap_compress, both required; one set-algebra step shaped as
              bvsetalgebra_rank_select's (cell1_step) launches gap_expand
              CELL1_GAP_EXPANDS = 7 times, one per operand pair;
              count() launches K3 once and distance_operation K2 once, and
              a profiler trace shows no other kernel (no sum) in them but
              distance_operation's gap_expand of each operand;
 5. agg     — config 3 (bench.py:225): 200 vectors x 128 blocks mixing
              dense, GAP and FULL-run blocks; combine_and_sub with 100 AND /
              100 SUB and with 3 / 2, combine_and, combine_or,
              find_first_and_sub, combine_and_sub_arena over one arena of
              all 200, and a 64-request pipeline in counts and in result
              mode (one B4 launch for the batch); every answer against
              numpy;
 6. scan    — config 4b (bench.py:280): a nullable 16M-element uint32
              SparseVector (values < 2^20, ~1 % NULL) from from_array
              (sv_transpose's device time split out), a gather of 1M ids
              (sv_gather; host wall and device busy); a prepared pipeline
              counting 256 values, pipeline_find_eq of 8 values, find_eq,
              find_first_eq, find_ne and find_nonzero against numpy; then
              the trace of the column's find_gt with its count that the
              descent phase checks (find_gt_trace: up to TRACE_TRIES
              traces, early in the run, where the profiler records);
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
              it logs one find_gt's launches and profiles a steady pass;
 9b. descent — the ordered searches' descent in one launch: on columns
              with every block class (uint32 nullable and not, int16,
              uint64), each descent equal in every part to the chain of
              bit_and / bit_or / bit_sub on the card; config 4b's
              find_gt(0x5A5A5) with its count, then find_ge / lt / le /
              range against numpy (the path's launches): one sv_descent
              and one K3 launch, its trace (phase 6's) those two
              kernels only, its result equal to the K1 chain's; a
              sharded find_gt on 8
              shards one launch per shard and no K1;
10. sv_serial — every column of phase 9 (config 4b's, the signed and
              float columns, the dictionary remapped and raw, the RSC
              column) through BMSV with XOR groups on and off,
              deserialize_range, deserialize_gather of 1M ids and the
              reference-format BLOBs (the float column's from its first
              2^20 values): each BLOB byte-equal to the same
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
              exact per-step launch counts (one per shard; the select and
              rank batches one select_flat / rank_flat launch per shard
              that holds queries) and a profile of one steady pass;
12. capi    — configs 1-2's A and B through the C-API facade
              (``bitmagic_tpu_torch.capi``): built with BM_bvector_construct
              + BM_bvector_set_bits and equal to phase 4's; the four
              combines, their 3-operand and opcode forms, the five array
              forms and merge; count, 64 count_range, count_/any_ AND, OR,
              XOR, SUB; compare, equal, find_first_mismatch; CAPI_CALLS
              calls each of get_bit, find, get_next, select, rank and
              find_rank after BM_bvector_optimize; serialize, deserialize
              and the operation deserializer; statistics; frozen copies (a
              write returns an error code); the enumerator (ENUM_WALK
              positions, then goto jumps); extract_next.  Every call must
              return BM_OK where the JAX package's facade does, the phase
              stops at the first bad code, and every answer is held against
              numpy; it logs ms per entry point;
13. utils   — debug.print_stat (one K3 launch) and print_bvector_stat on A,
              print_svector_stat on config 4b's column, each printed count
              against numpy; compute_serialization_size; the save / load
              round trips of A and the column through files; ChronoTaker
              around one config-1 AND (at least the device time of the
              events inside it); profiler_trace writing a trace that names
              a kernel of the port;
14. samples — the 24 programs of samples_torch/ in this process on the
              card, each printing the lines it prints on the CPU (apart
              from the mesh's device list and sample 22's wall times), with
              its wall seconds and launches; then B8, the Bitap chain
              (combine_shift_right_and, one shift_and_chain launch a
              call) at samples/06's shape and at config-1 width (4
              occurrence vectors of a 100.7M-base text, 16- and 32-letter
              patterns; a 100.7M-symbol text over 20 letters, a 32-letter
              pattern), and over chains of 33, 34 and 65 operands on a
              block list with gaps, of 65538 and 131075 operands on a
              contiguous one and of 40 whose first vector zeroes every
              row (bitap_chains), each against a numpy Bitap and the
              kernel bit for bit against its plain version, with host
              wall ms, device busy ms and launches per call; the kernel's
              ms at the three config-1-width shapes (L2 dirty and clean)
              beside its bound, the smaller of its two byte counts;
15. tools   — the four BLOB tools of tools_torch/ in this process on the
              card, each leg with its seconds and launches: svutil over
              config 4b's live values (16M) to sv and RSC BLOBs (MB/s;
              both decode to the column), the first 2^22 values' BLOBs
              back to the same u32 bytes, and at the demo's size BLOBs
              equal to the CPU's; range_idx over 1M ranges in a
              3.1e9-position space (its 2000-query self-check, the
              payload BLOB, 100k point queries against numpy, half outside
              every range); lnkutil over 2048 x 512 links (build, save,
              load, the 2-hop benchmark; every loaded row equals its built
              row, the neighborhood equals a numpy BFS; s per 1000 rows);
              inv_list over its synthetic corpus as a Gov2-style file
              (BMT1 on 40 lists, the reference format on 8, the columns
              equal a CPU run's on those 8);
16. fuzz    — tools_torch/fuzz_containers.py in this process on a mesh of
              8 shards on the card: every family at seeds 0, 1 and 2, then
              24 trials from seed 1000 in the random order; a failed trial
              prints its FAIL line and exits; seconds and launches per
              family;
17. bench_tools — the benchmarking tools of tools_torch/ in this process
              on the card, each with its seconds and launches: bench_tpch
              at TPC-H SF1's 150,000 customers and SF100's 15,000,000 (200
              nations, top 10; orders against numpy, SF1's index bytes
              against a CPU run), microbench's nine families at 768 blocks
              (20 labelled lines, 3 BLOB sizes), scaling_check over 1, 2,
              4 and 8 shards (one B6 and one K3 per shard per scan, one B5
              per shard per pipeline);
18. multihost — two fresh interpreters of 4 shards each on cuda:0,
              joined over gloo (a file:// store, 120 s per collective):
              multihost_check's steps, then the sharded phase's work
              across them (two 2^30-bit vectors, the four ops and counts,
              1M select and rank, config 4b's column through find_gt,
              find_eq_count and pipeline_find_eq); every answer against
              numpy in each process and equal to this process's run on
              one mesh of the 8 shards, one launch per local shard per
              step (find_gt one descent_rows); a worker's failure or
              timeout fails the phase;
19. fixtures — the reference C++ fixtures (tests/fixtures) through the port;
20. scale   — two 2^30-bit vectors (16384 dense blocks, 128 MiB per pool)
              from seeded word images: the four ops, counts and metrics;
              then 200 vectors x 1536 blocks (2.5 GB of operand rows): the
              combine_and_sub pair of phase 5 and a 64-request counts
              pipeline;
21. timing  — each kernel, its plain version and the nearest single PyTorch
              call at the main paths' shapes (CUDA events, L2 flushed
              before each launch), beside the bound from bytes and integer
              operations: K2 and K3 also at config 1's own shapes and in
              their total forms; gap_expand over 768 blocks and in one
              pair launch over two stores' 1536, gap_compress's launch
              over 400 rows (and its whole call, and compress_rows with
              its download, against the plain version's); sv_gather at
              column_range_gather's shape (16M rows, 1M ids) and
              sv_transpose at 16M values and 20 slices (also with L2
              clean) and at 16M 8-byte values and 64 slices; rs_select and
              rs_rank at bvsetalgebra_rank_select's shape (1M queries) and
              in their flat forms; sv_descent at column_range_gather's
              shape (20 steps over 245 blocks) and descent_rows at one
              shard of it, each also with L2 clean; the floor of a timed launch; K3 after a flush
              that leaves L2 clean.

Each path (4, 5, 6, 7, 8, 9b, 10, 12, 13, 14, each group of 9 and 11, each leg
of 15, 16 and 17, and each step of 18) is driven with the launch counts set
to 0 just before and read just after; a kernel of the path launched no time
fails it.

The oracles are numpy and the committed fixtures; nothing of JAX or of the
JAX package is imported.
"""

from __future__ import annotations

import collections
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
SINGLE_CALLS = 200              # one-query select / rank calls timed
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
    # no TPU kernel: the JAX package's host run-domain merges
    "gap_expand": dict(
        source="bitmagic_tpu_torch/ops/csrc/gap_rows.cu",
        replaces="bitmagic_tpu/core/gapstore.py:375 (host numpy "
                 "gap_metric_counts; no TPU kernel)"),
    "gap_compress": dict(
        source="bitmagic_tpu_torch/ops/csrc/gap_rows.cu",
        replaces="bitmagic_tpu/core/gapstore.py:313 (host numpy "
                 "gap_binary_op; no TPU kernel)"),
    # the SparseVector's two jitted device programs (no Pallas)
    "sv_gather": dict(
        source="bitmagic_tpu_torch/ops/csrc/sv_planes.cu",
        replaces="bitmagic_tpu/sv/sparse_vector.py:70 "
                 "(_gather_decode_kernel, jitted XLA)"),
    "sv_transpose": dict(
        source="bitmagic_tpu_torch/ops/csrc/sv_planes.cu",
        replaces="bitmagic_tpu/sv/sparse_vector.py:53 "
                 "(_transpose_kernel, jitted XLA)"),
    # the rank/select index's batches: a jitted program each and the host
    # numpy of RSIndex.select_batch / rank_batch around it
    "rs_select": dict(
        source="bitmagic_tpu_torch/ops/csrc/rs_select.cu",
        replaces="bitmagic_tpu/ops/select.py:77 (select_flat, jitted XLA; "
                 "with core/rs_index.py:147 select_batch's host numpy)"),
    "rs_rank": dict(
        source="bitmagic_tpu_torch/ops/csrc/rs_select.cu",
        replaces="bitmagic_tpu/core/rs_index.py:191 (_rank_in_rows, "
                 "jitted XLA; with :106 rank_batch's host numpy)"),
    # the ordered searches' descent: a chain of set operations on one
    # card, a fused jitted program per search over a sharded stack
    "sv_descent": dict(
        source="bitmagic_tpu_torch/ops/csrc/sv_descent.cu",
        replaces="bitmagic_tpu/sv/scanner.py:210 (_cmp_unsigned's chain "
                 "of set operations; with parallel/sharded_sv.py:1182 "
                 "_descent_prog and :1208 _float_gt_prog, jitted XLA)"),
    # the Bitap chain of combine_shift_right_and
    "shift_and_chain": dict(
        source="bitmagic_tpu_torch/ops/csrc/shift_chain.cu",
        replaces="bitmagic_tpu/agg/aggregator.py:117 (_shift_and_chain, "
                 "jitted XLA lax.scan)"),
}
FIRST_SLICE = ("block_counts", "count_op", "logical_op_digest")
# the D-GAP kernels the main path's set ops and metrics launch
GAP_ROWS = ("gap_expand", "gap_compress")
# the kernels config 4b's from_array and gather launch (scan path)
SV_PLANES = ("sv_gather", "sv_transpose")
SV_GATHER_IDS = 1_000_000       # config 4b's gather (column_range_gather's)
# traces taken before a check of a trace's kernels gives up on a trace that
# recorded no event (torch.profiler on the card's machine sometimes
# records none; PERF.md, open questions)
TRACE_TRIES = 8
# the rank/select batches of the main path (bvsetalgebra_rank_select)
RS_KERNELS = ("rs_select", "rs_rank")
# bvsetalgebra_rank_select's D-GAP shapes: each vector holds about 768
# D-GAP blocks of 1 to 256 runs; 400 block pairs are GAP in both
GAP_BLOCKS, GAP_RUNS_MAX, GAP_PAIRS = 768, 256, 400
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
    gap_kernels_vs_plain(rng, device, cmp)
    sv_kernels_vs_plain(rng, device, cmp)
    rs_kernels_vs_plain(rng, device, cmp)
    descent_kernels_vs_plain(rng, device, cmp)
    for name, e in err.items():
        check(e == 0, f"{name} disagrees with its plain version: max "
                      f"abs err {e}")
    return err, cases


def run_rows(rng, n):
    """``n`` block rows drawn as bvsetalgebra_rank_select draws its GAP
    blocks: per row a run count uniform in [1, GAP_RUNS_MAX] and twice
    that many bounds uniform in [1, 65536) (duplicates dropped, an odd one
    dropped), bits alternating 0, 1 -> uint32[n, 2048]."""
    rows = np.zeros((n, BPB), np.uint8)
    for r in rows:
        cuts = np.unique(rng.integers(1, BPB, 2 * int(
            rng.integers(1, GAP_RUNS_MAX + 1))))
        cuts = cuts[:cuts.size - cuts.size % 2].reshape(-1, 2)
        for lo, hi in cuts:
            r[lo:hi] = 1
    return np.packbits(rows, axis=1, bitorder="little").view(np.uint32)


def gap_stores(rng):
    """Two D-GAP stores of GAP_BLOCKS blocks each, drawn by ``run_rows``."""
    from bitmagic_tpu_torch.core.gapstore import GapStore
    return [GapStore.from_dense(run_rows(rng, GAP_BLOCKS)) for _ in range(2)]


def gap_edge_rows(device):
    """Rows at the encoder's edges: all zero, all one, a lone bit at 0
    and at 65535, ones up to bit 65534, and 65536 one-bit runs."""
    rows = np.zeros((6, 2048), np.uint32)
    rows[1] = 0xFFFFFFFF
    rows[2, 0] = 1
    rows[3, -1] = 0x80000000
    rows[4] = 0xFFFFFFFF
    rows[4, -1] = 0x7FFFFFFF
    rows[5] = 0x55555555
    return torch.from_numpy(rows.view(np.int32).copy()).to(device)


def runs_row(ends, first):
    """uint32[2048]: the block whose runs end at ``ends`` (inclusive, the
    last 65535), the first of value ``first``, then alternating."""
    ends = np.asarray(ends, np.int64)
    val = (np.arange(ends.size) + first) & 1
    bits = np.repeat(val, np.diff(np.concatenate([[-1], ends])))
    return np.packbits(bits.astype(np.uint8), bitorder="little").view(
        np.uint32)


# gap_expand's cases (gap_cases), by name
GAP_CASES = ("edges", "one_row", "top_level", "above_top_level", "pair",
             "pair_a_empty", "pair_b_empty")


def gap_cases(rng, device):
    """gap_expand's risky inputs, each (name, mirror a or None, mirror b or
    None, sel int32 on ``device``, k_a) for ``gap_expand_pair``: store A's
    blocks are 1-run (zero, full), runs ending on bits 31 and 32 of a word,
    on 65534 and 65535, 1280 runs (the default top GAP level) and more
    (1281, 3000 and 65536 runs, which only a raised GAP level table
    makes; rows 5-8); store B's are drawn as cell 1's
    (``run_rows``).  One store alone, and both in one launch with repeats
    and with either side empty."""
    from bitmagic_tpu_torch.core.gapstore import GapStore
    cut = lambda n: np.sort(rng.choice(  # noqa: E731
        np.arange(BPB - 1), n - 1, replace=False))
    rows_a = np.stack([
        runs_row([BPB - 1], 0), runs_row([BPB - 1], 1),
        runs_row([31, 32, 63, 64, 95, BPB - 1], 1),
        runs_row([30, 31, BPB - 2, BPB - 1], 0),
        runs_row([0, 31, 32, 33, BPB - 33, BPB - 32, BPB - 1], 1),
        runs_row(np.append(cut(1280), BPB - 1), 0),
        runs_row(np.append(cut(1281), BPB - 1), 1),
        runs_row(np.append(cut(3000), BPB - 1), 0),
        np.full(2048, 0x55555555, np.uint32)])
    sa, sb = GapStore.from_dense(rows_a), GapStore.from_dense(
        run_rows(rng, 64))
    check(list(np.diff(sa.offs)[5:]) == [1280, 1281, 3000, BPB],
          "gap cases: blocks of 1280, 1281, 3000 and 65536 runs")
    ma, mb = sa.device_arrays(device), sb.device_arrays(device)

    def sel(*parts):
        return torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(
            device)
    edges = np.arange(5)
    pa = np.asarray([8, 0, 2, 2, 5, 7, 3, 6, 1])
    pb = rng.integers(0, 64, 40)
    return [("edges", ma, None, sel(edges), 5),
            ("one_row", ma, None, sel([3]), 1),
            ("top_level", ma, None, sel([5, 5]), 2),
            ("above_top_level", ma, None, sel([6, 7, 8]), 3),
            ("pair", ma, mb, sel(pa, pb), pa.size),
            ("pair_a_empty", None, mb, sel(pb), 0),
            ("pair_b_empty", ma, None, sel(pa), pa.size)]


def gap_kernels_vs_plain(rng, device, cmp):
    """gap_expand over all GAP_BLOCKS blocks of a store drawn as
    bvsetalgebra_rank_select's, over a shuffled subset with repeats, both
    in one pair launch, and over ``gap_cases``; gap_compress over
    GAP_PAIRS AND rows of the two stores and over the edge rows; each
    against its plain version on the card, and the round trip back to the
    host store."""
    from bitmagic_tpu_torch.core.gapstore import GapStore
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    sa, sb = gap_stores(rng)
    ma, mb = sa.device_arrays(device), sb.device_arrays(device)
    every = torch.arange(GAP_BLOCKS, dtype=torch.int32, device=device)
    some = torch.from_numpy(rng.integers(0, GAP_BLOCKS, 300).astype(
        np.int32)).to(device)
    for m, sel in ((ma, every), (mb, every), (ma, some)):
        cmp("gap_expand", ck.gap_expand(*m, sel),
            blockops.gap_expand(*m, sel))
    ra = ck.gap_expand(*ma, every)
    check(np.array_equal(blockops.to_host_words(ra), sa.to_dense()),
          "gap_expand equals GapStore.to_dense")
    pair = ck.gap_expand_pair(ma, mb, torch.cat([every, some]), GAP_BLOCKS)
    cmp("gap_expand", pair, torch.cat([ra, ck.gap_expand(*mb, some)]))
    cases = gap_cases(rng, device)
    check(tuple(c[0] for c in cases) == GAP_CASES, "gap cases by name")
    for name, *args in cases:
        pair = ck.gap_expand_pair(*args)
        cmp("gap_expand", pair, blockops.gap_expand_pair(*args))
        # the many-store form over the same stores and blocks
        m_a, m_b, sel, k_a = args
        sel = sel.cpu().numpy()
        parts = [(m, x) for m, x in ((m_a, sel[:k_a]), (m_b, sel[k_a:]))
                 if x.size]
        many = [m for m, _ in parts], [x for _, x in parts]
        cmp("gap_expand", ck.gap_expand_many(*many), pair)
    # three stores, one of them twice, in one launch
    many = [ma, mb, ma], [np.arange(GAP_BLOCKS), some.cpu().numpy(),
                          np.asarray([5, 0, 5])]
    cmp("gap_expand", ck.gap_expand_many(*many),
        blockops.gap_expand_many(*many))
    rows = ra[:GAP_PAIRS] & ck.gap_expand(*mb, every)[:GAP_PAIRS]
    cases = [("cell1_400", rows, None, None),
             ("edges", gap_edge_rows(device), None, None)]
    for name, r, cap, store in cases + compress_cases(rng, device):
        if store is None:
            store = GapStore.from_dense(blockops.to_host_words(r))
        total, n = int(store.offs[-1]), r.shape[0]
        cap = total if cap is None else cap
        caps = [cap] if name.startswith("cap") else [cap, cap + 257]
        if name == "cap_below":
            caps.append(0)
        for cap in caps:
            n0 = ck.launches["gap_compress"]
            buf = ck.gap_compress(r, cap)
            sync()
            check(ck.launches["gap_compress"] == n0 + 1,
                  f"gap_compress {name}: one launch")
            for g, w in zip(blockops.gap_unpack(buf, n), blockops.gap_unpack(
                    blockops.gap_compress(r, cap), n)):
                cmp("gap_compress", g, w)
            if cap < total:
                try:
                    GapStore.from_packed(buf, n)
                except RuntimeError:
                    continue
                check(False, f"gap_compress {name}: a total above cap "
                             f"raises")
            back = GapStore.from_packed(buf, n)
            for key in ("ends", "offs", "first"):
                check(np.array_equal(getattr(back, key),
                                     getattr(store, key)),
                      f"gap_compress {name} {key} equals "
                      f"GapStore.from_dense")


def random_gap_store(rng, n, runs_max):
    """A D-GAP store of ``n`` blocks, each of 1 to ``runs_max`` runs (run
    ends drawn uniform in [0, 65535), repeats dropped), drawn in bulk."""
    from bitmagic_tpu_torch.core.gapstore import GapStore
    m = rng.integers(1, runs_max + 1, n)
    row = np.repeat(np.arange(n, dtype=np.int64), m - 1)
    key = np.unique(row * BPB + rng.integers(0, BPB - 1, row.size))
    r = key >> 16
    cuts = np.bincount(r, minlength=n)
    offs = np.concatenate([[0], np.cumsum(cuts + 1)])
    ends = np.full(int(offs[-1]), BPB - 1, np.int64)
    first_cut = np.concatenate([[0], np.cumsum(cuts)])[:-1]
    ends[offs[r] + np.arange(key.size) - first_cut[r]] = key & (BPB - 1)
    return GapStore(ends, offs, rng.integers(0, 2, n).astype(np.uint8))


def compress_cases(rng, device):
    """gap_compress's risky inputs, each (name, rows int32[n, 2048] on
    ``device``, cap, the store they encode to): 20,000 rows of 1 to 256
    runs (more CTAs than the card holds at once: the look-back waits on
    rows still running), rows of 65536 runs, one row, and cap at the total
    (``cap_total``) and below it (``cap_below``)."""
    from bitmagic_tpu_torch.core.gapstore import GapStore
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    out = []
    for name, store in (
            ("rows_20000", random_gap_store(rng, 20_000, GAP_RUNS_MAX)),
            ("runs_65536", GapStore.from_dense(np.stack(
                [np.full(2048, w, np.uint32)
                 for w in (0x55555555, 0xAAAAAAAA) * 4]))),
            ("one_row", random_gap_store(rng, 1, 3000)),
            ("cap_total", random_gap_store(rng, 400, GAP_RUNS_MAX)),
            ("cap_below", random_gap_store(rng, 400, GAP_RUNS_MAX))):
        sel = torch.arange(store.n_blocks, dtype=torch.int32, device=device)
        rows = ck.gap_expand(*store.device_arrays(device), sel)
        total = int(store.offs[-1])
        out.append((name, rows, total - (name == "cap_below"), store))
    return out


def sv_columns(tbm, rng, device):
    """Columns on the card with every block kind, each with its values
    as the gather must return them (NULL rows 0): a nullable uint32
    column of 34 blocks (block 0 random BIT rows, blocks 1-2 D-GAP after
    optimize, bit 21 set on every row, so plane 21 is one FULL run, planes
    20 and 22-31 absent; 1 % NULL past block 0, so the NULL plane is FULL
    then BIT), the same values with every row assigned (the NULL plane a
    FULL run), a nullable int64 column at the dtype's edges and a
    non-nullable int32 column."""
    n = 34 * BPB + 777
    v = rng.integers(0, 1 << SV_BITS, n).astype(np.uint32)
    sparse = v[BPB:3 * BPB]
    sparse[rng.random(sparse.size) > 0.002] = 0
    v |= np.uint32(1 << 21)
    nm = rng.random(n) < 0.01
    nm[:BPB] = False
    s64 = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                       200_000, endpoint=True)
    s64[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1]
    s32 = s64.astype(np.int32)
    out = []
    for vals, kw, live in ((v, dict(null_mask=nm), np.where(nm, 0, v)),
                           (v, dict(nullable=True), v),
                           (s64, dict(nullable=True), s64), (s32, {}, s32)):
        c = tbm.SparseVector.from_array(vals, device=device, **kw)
        c.optimize()
        out.append((c, live))
    return out


def wide_sparse_column(tbm, rng, device, blocks=2100):
    """A uint32 column of ``blocks`` one-value blocks with an absent block
    after each (values 1-15): its block directory has 2 * blocks
    breakpoints, more than the gather's passes hold in shared memory
    (``GATHER_STAGE_BPS``) -> (column, the values' ids, the values)."""
    ids = (np.arange(blocks, dtype=np.int64) * 2 * BPB
           + rng.integers(0, BPB, blocks))
    vals = rng.integers(1, 16, blocks).astype(np.uint32)
    c = tbm.SparseVector(np.uint32, device=device)
    c._write(ids, np.zeros(blocks, bool), vals)
    c._size = int(ids[-1]) + 1
    return c, ids, vals


def gather_cases(tbm, rng, device):
    """The cases the grouped gather makes risky, each (name, column, ids
    int64 on the card, whether its size takes the grouped route), over
    ``sv_columns``' first (every block kind) and third (65 planes)
    columns and ``wide_sparse_column``: every id in one block (one
    directory row cut into many chunks), sorted ids, duplicates, ids past
    the end and in absent blocks, sparse ids over the wide column (the
    direct launch, its breakpoints searched in global memory), 2.8M ids
    over the wide column (grouped: its breakpoints and 4201 row counts
    too many for shared memory), 65 planes (staged 24 rows at a time)
    and uniform ids."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    cols = sv_columns(tbm, rng, device)
    (c0, live0), (c64, live64) = cols[0], cols[2]
    n0, n64 = live0.size, live64.size
    wide, wide_ids, _ = wide_sparse_column(tbm, rng, device)
    check(wide._plane_table().bps.shape[0] > ck.GATHER_STAGE_BPS,
          "the wide column's directory exceeds the gather's shared memory")

    def d(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(device)

    many = rng.integers(0, n0, 200_000)
    past = np.concatenate([rng.integers(n0, n0 + 40 * BPB, 60_000),
                           [n0, 1 << 40, (1 << 47) - 1]])
    n_wide = 2_800_000
    spread = (rng.integers(0, 2 * len(wide_ids), n_wide) * BPB
              + rng.integers(0, BPB, n_wide))
    return [
        ("one_block", c0, d(5 * BPB + rng.integers(0, BPB, 60_000)), True),
        ("sorted", c0, d(np.sort(many)), True),
        ("duplicates", c0, d(np.repeat(many[:2000], 50)), True),
        ("past_end_absent", c0, d(past), True),
        ("sparse_direct", wide, d(wide_ids[::3]), False),
        ("wide_directory", wide, d(np.concatenate([
            np.repeat(wide_ids[:8], 4096), spread])), True),
        ("planes65", c64, d(rng.integers(0, n64, 100_000)), True),
        ("uniform", c0, d(many), True),
    ]


def sv_kernels_vs_plain(rng, device, cmp):
    """sv_gather over the plane tables of ``sv_columns`` (every block kind
    in value planes and NULL planes, signed and 64-bit values, ids past
    the end) and sv_transpose over 1 to 64 slices of 4- and 8-byte values,
    each against its plain version on the card; the gathers also against
    the columns' values."""
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    kinds = set()
    for c, live in sv_columns(tbm, rng, device):
        for p in c.planes + [c.null_plane]:
            if p is None:
                kinds.add("absent")
                continue
            kinds.update(int(k) for k in np.unique(p._struct.cls))
            if p._struct.has_runs:
                kinds.add("runs")
        n = live.size
        ids = np.concatenate([rng.integers(0, n + 3 * BPB, 200_000),
                              [0, n - 1, n, 1 << 40]])
        table = c._plane_table()
        d_ids = torch.from_numpy(ids).to(device)
        cmp("sv_gather", ck.sv_gather(d_ids, table),
            blockops.sv_gather(d_ids, table))
        want = np.zeros(ids.size, live.dtype)
        inside = ids < n
        want[inside] = live[ids[inside]]
        check(np.array_equal(c.gather(ids), want),
              f"sv_gather: {c.dtype} column gather equals its values")
    check(kinds >= {"absent", "runs", 1, 2, 3},
          f"sv columns hold every block kind: {kinds}")
    for name, c, ids, grouped in gather_cases(tbm, rng, device):
        table = c._plane_table()
        check(ck._gather_grouped(ids.shape[0], table) == grouped,
              f"sv_gather case {name}: its size takes the "
              f"{'grouped' if grouped else 'direct'} route")
        cmp("sv_gather", ck.sv_gather(ids, table),
            blockops.sv_gather(ids, table))
    # ragged tails (n short of a word and of a warp's 1024 values), both
    # value widths, 1 to 64 slices, and values not 16-byte aligned
    for n, n_slices, dt in ((32 * 999 + 5, 1, torch.int32),
                            (32 * 999 + 5, 32, torch.int32),
                            (SV_GATHER_IDS + 3, SV_BITS, torch.int32),
                            (32 * 999 + 5, 33, torch.int64),
                            (SV_GATHER_IDS + 3, 64, torch.int64),
                            (SV_GATHER_IDS + 3, SV_BITS, torch.int64),
                            *((m, s, dt) for m in (1, 31, 33, 1023, 1025)
                              for s, dt in ((1, torch.int32),
                                            (20, torch.int32),
                                            (32, torch.int32),
                                            (33, torch.int64),
                                            (64, torch.int64)))):
        info = torch.iinfo(dt)
        vals = torch.from_numpy(rng.integers(
            info.min, info.max, n + 1, endpoint=True)).to(dt).to(device)
        for v in (vals[:n], vals[1:]):
            cmp("sv_transpose", ck.sv_transpose(v, n_slices),
                blockops.sv_transpose(v, n_slices))


def rs_cell_vector(tbm, rng, device):
    """A vector drawn as bvsetalgebra_rank_select's A: N_BLOCKS blocks,
    GAP_BLOCKS of them ``run_rows`` (D-GAP after optimize()), the rest
    random dense words -> (vector, its words)."""
    words = rng.integers(0, 2**32, (N_BLOCKS, 2048), dtype=np.uint64).astype(
        np.uint32)
    words[rng.permutation(N_BLOCKS)[:GAP_BLOCKS]] = run_rows(rng, GAP_BLOCKS)
    bv = tbm.BitVector.from_words(words.ravel(), device=device)
    bv.optimize()
    return bv, words.ravel()


def rs_edge_vector(pkg, device=None, gap=True, bit=True):
    """48 blocks + 777 bits holding, by block: 0, 46 BIT; 2 a D-GAP run of
    ones from bit 0; 3 one that starts with zeros; 4 65536 D-GAP runs; 5 a
    run ending at bit 65535; 7 FULL; 10-43 a FULL run; 45 a BIT block with
    no bit left after a SUB; the rest absent, 47 and the tail past the last
    segment.  ``gap=False`` leaves out the D-GAP blocks, ``bit=False`` the
    BIT ones.  ``pkg`` is the package whose BitVector is built (the tests
    build the same vector in the JAX package, which takes no device)."""
    from bitmagic_tpu_torch import constants as C
    rng = np.random.default_rng(11)
    kw = {} if device is None else {"device": device}
    size = 48 * BPB + 777
    bv = pkg.BitVector(size, **kw)
    if gap:
        g = np.concatenate([2 * BPB + np.arange(100),
                            3 * BPB + np.arange(500, 900),
                            5 * BPB + np.arange(BPB - 50, BPB)])
        bv = pkg.BitVector.from_indices(g, size, strategy=C.BM_GAP, **kw)
    bv.set_range(10 * BPB, 44 * BPB - 1)
    bv.optimize()
    if bit:
        dense = np.concatenate([rng.integers(0, BPB, 9000),
                                46 * BPB + rng.integers(0, BPB, 9000)])
        bv |= pkg.BitVector.from_indices(dense, size, **kw)
    bv.set_range(7 * BPB, 8 * BPB - 1)
    if gap:
        levels = pkg.config.gap_levels
        try:
            # a 65536-run block stays D-GAP only above the top GAP level
            pkg.config.gap_levels = (128, 256, 512, BPB + 8)
            bv |= pkg.BitVector.from_indices(
                4 * BPB + np.arange(0, BPB, 2), size, strategy=C.BM_GAP,
                **kw)
        finally:
            pkg.config.gap_levels = levels
    if bit:
        e = pkg.BitVector.from_indices(45 * BPB + np.arange(0, BPB, 7),
                                       size, **kw)
        bv |= e
        bv -= e
    return bv


def rs_queries(rng, rs, size, n):
    """``n`` uniform ranks and ids on an rs-index with the edges before
    them: ranks -1, 0, 1, total, total + 1 and every segment's first and
    last rank; ids -1, 0, size - 1, size and every block border."""
    total = rs.total
    ranks = np.concatenate([[-1, 0, 1, total, total + 1], rs.cum,
                            rs.cum + 1, rng.integers(1, total + 1, n)])
    borders = np.arange(-(-size // BPB) + 1) * BPB
    ids = np.concatenate([[-1, 0, size - 1, size], borders - 1, borders,
                          rng.integers(0, size, n)])
    return ranks.astype(np.int64), ids.astype(np.int64)


def class_vectors(tbm, rng, device):
    """Vectors whose rank/select index holds one block class: FULL (block
    1 and a FULL run over blocks 3-37), D-GAP (40 ``run_rows`` blocks
    after optimize()) and BIT (40 random dense blocks), by name."""
    from bitmagic_tpu_torch import constants as C
    full = tbm.BitVector(40 * BPB, device=device)
    full.set_range(BPB, 2 * BPB - 1)
    full.set_range(3 * BPB, 38 * BPB - 1)
    gap = tbm.BitVector.from_words(run_rows(rng, 40).ravel(), device=device)
    gap.optimize()
    dense = rng.integers(0, 2**32, (40, 2048), dtype=np.uint64).astype(
        np.uint32)
    bit = tbm.BitVector.from_words(dense.ravel(), device=device)
    for v, want in ((full, {C.CLS_FULL}), (gap, {C.CLS_GAP}),
                    (bit, {C.CLS_BIT})):
        check(set(v._struct.cls.tolist()) == want,
              f"class vector holds {want} only")
    check(full._struct.has_runs, "the FULL vector holds a FULL run")
    return {"full_only": full, "gap_only": gap, "bit_only": bit}


def wide_index_vector(tbm, rng, device, blocks=26_100):
    """A vector of ``blocks`` blocks, every 4th random dense words (BIT),
    the others 16 random bits each (D-GAP after optimize()): its
    rank/select index has 26,101 segment rows, so ``rs_select`` stages
    only a sample of cum0 and reads sel, gws and the ~600K runs' samples
    in global memory, and ``select_flat`` over its 417,600 waves stages
    only a sample of gws (``RS_STAGE_BYTES``)."""
    words = np.zeros((blocks, 2048), np.uint32)
    bit = np.arange(0, blocks, 4)
    words[bit] = rng.integers(0, 2**32, (bit.size, 2048),
                              dtype=np.uint64).astype(np.uint32)
    gap = np.setdiff1d(np.arange(blocks), bit)
    pos = rng.integers(0, BPB, (gap.size, 16))
    np.bitwise_or.at(words, (np.repeat(gap, 16), (pos >> 5).ravel()),
                     (np.uint32(1) << (pos & 31).astype(np.uint32)).ravel())
    bv = tbm.BitVector.from_words(words.ravel(), device=device)
    bv.optimize()
    return bv


def select_cases(rs, rng, n=5000):
    """The rank batches the redesigned select makes risky on index
    ``rs``, each (name, int64 ranks): uniform ranks and the edges, one
    rank, every rank in one wave, the ranks at segment boundaries, and
    ranks outside [1, total]."""
    from bitmagic_tpu_torch import constants as C
    total = rs.total
    ranks, _ = rs_queries(rng, rs, rs.size, n)
    out = [("batch", ranks),
           ("one", ranks[-1:]),
           ("segment_edges", np.resize(np.concatenate(
               [rs.cum, rs.cum + 1, np.maximum(rs.cum - 1, 1)]), n)),
           ("out_of_range", np.resize(np.asarray(
               [-5, -1, 0, total + 1, total + 2, 1 << 40, -(1 << 40), 1,
                total]), n))]
    bit = np.flatnonzero(rs.cls == C.CLS_BIT)
    if bit.size:
        s = int(bit[len(bit) // 2])
        before = int(rs.cum[s - 1]) if s else 0
        slot = int(rs.slots[s])
        g = rs.gwc.cpu().numpy()
        ones = int(g[slot * 64]) - (int(g[slot * 64 - 1]) if slot else 0)
        if ones:
            out.append(("one_wave", before + 1 + rng.integers(0, ones, n)))
    return [(name, r.astype(np.int64)) for name, r in out]


def rs_kernels_vs_plain(rng, device, cmp):
    """rs_select and rs_rank, and their flat forms select_flat and
    rank_flat, each against its plain version on the card: on a vector of
    cell 1's shapes with 1M uniform ranks and ids, and on the edge vector;
    the index's batches also against numpy."""
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.ops import select as plain
    from bitmagic_tpu_torch import constants as C
    cell, words = rs_cell_vector(tbm, rng, device)
    edge = rs_edge_vector(tbm, device)
    st = edge._struct
    check(set(st.cls.tolist()) == {C.CLS_BIT, C.CLS_GAP, C.CLS_FULL}
          and st.has_runs and int(np.diff(edge._gaps.offs).max()) == BPB,
          "rs edge vector: BIT, D-GAP (65536 runs), FULL and FULL runs")
    for v, n in ((cell, N_QUERIES), (edge, 20_000)):
        rs = v.build_rs_index()
        runs = rs._gap_runs()
        ranks, ids = rs_queries(rng, rs, v.size, n)
        q = torch.from_numpy(ranks).to(device)
        i = torch.from_numpy(ids).to(device)
        sargs = (rs._seg, rs._cum0_dev, runs, rs.pool, rs.gwc)
        cmp("rs_select", ck.rs_select(*sargs, q, rs.total,
                                      rs._select_tables()),
            plain.rs_select(*sargs, q, rs.total))
        select_vs_plain(rs, rng, cmp)
        rank_vs_plain(rs, i, cmp)
        rank_cases_vs_plain(rs, rng, cmp)
        g = rs.gwc.cpu().numpy().astype(np.int64)
        pool_total = int(g[-1])
        granks = np.concatenate([[1, pool_total], np.clip(g, 1, None),
                                 rng.integers(1, pool_total + 1, n)])
        granks = torch.from_numpy(granks.astype(np.int32)).to(device)
        flat = plain.flat_tables(rs.pool, rs.gwc)
        cmp("rs_select", ck.select_flat(rs.pool, rs.gwc, granks, flat),
            plain.select_flat(rs.pool, rs.gwc, granks))
        cmp("rs_select", ck.select_flat(rs.pool, rs.gwc, granks[-1:], flat),
            plain.select_flat(rs.pool, rs.gwc, granks[-1:]))
        n_bits = rs.pool.shape[0] * BPB
        rel = np.concatenate([[0, n_bits - 1], np.arange(0, n_bits, 1024),
                              rng.integers(0, n_bits, n)])
        rel = torch.from_numpy(rel).to(device)
        frank = plain.flat_rank_tables(rs.gwc, flat.wsp)
        cmp("rs_rank", ck.rank_flat(rs.pool, rs.gwc, rel, frank),
            plain.rank_flat(rs.pool, rs.gwc, rel))
        cmp("rs_rank", ck.rank_flat(rs.pool, rs.gwc, rel[-1:], frank),
            plain.rank_flat(rs.pool, rs.gwc, rel[-1:]))
        w = v.to_words().ravel() if v is edge else words
        ones = np.flatnonzero(np.unpackbits(w.view(np.uint8),
                                            bitorder="little"))
        got = rs.select_batch(ranks)
        ok = (ranks >= 1) & (ranks <= rs.total)
        check(np.array_equal(got[ok], ones[ranks[ok] - 1])
              and (got[~ok] == -1).all(), "rs_select: the index's select "
              "batch equals numpy")
        check(np.array_equal(rs.rank_batch(ids), np.searchsorted(
            ones, ids, side="right")), "rs_rank: the index's rank batch "
            "equals numpy")
    for name, v in class_vectors(tbm, rng, device).items():
        select_vs_plain(v.build_rs_index(), rng, cmp)
        rank_cases_vs_plain(v.build_rs_index(), rng, cmp)
    wide = wide_index_vector(tbm, rng, device).build_rs_index()
    check(ck._rank_staging(len(wide.nb), wide._gap_runs()[0].shape[0])[:3]
          == (-(-len(wide.nb) // (ck.RS_CUM_SAMPLE_BYTES // 8)), 0, 0),
          "the wide index's rank stages only a sample of nb")
    rank_cases_vs_plain(wide, rng, cmp)
    m1, W = len(wide.nb) + 1, wide.gwc.shape[0]
    R = wide._gap_runs()[0].shape[0]
    check(ck._select_staging(m1, W, R)[:4] == (-(-m1 // (
        ck.RS_CUM_SAMPLE_BYTES // 8)), 0, 0, 0) and ck._flat_staging(
        W // 8)[0] > 1, f"the wide index ({m1} segment rows, {W} waves, {R} "
        f"runs) stages only a sample of cum0, and its flat form of gws")
    select_vs_plain(wide, rng, cmp)
    g = wide.gwc.cpu().numpy().astype(np.int64)
    granks = torch.from_numpy(np.concatenate([
        [1, int(g[-1])], np.clip(g[::97], 1, None),
        rng.integers(1, int(g[-1]) + 1, 20_000)]).astype(np.int32)).to(device)
    cmp("rs_select", ck.select_flat(wide.pool, wide.gwc, granks,
                                    plain.flat_tables(wide.pool, wide.gwc)),
        plain.select_flat(wide.pool, wide.gwc, granks))
    sharded_select_vs_plain(cell, words, device, rng, cmp)


def rank_cases(rs, rng, n=5000):
    """The id batches the redesigned rank makes risky on index ``rs``,
    each (name, int64 ids): uniform ids with every block border, one id,
    each segment's first and last bit and the bits around them, ids in
    zero blocks and past the vector (2^31 + bits, 2^40, negative)."""
    size = rs.size
    _, ids = rs_queries(rng, rs, size, n)
    nb = rs.nb.astype(np.int64)
    end = nb + rs.span
    edges = np.concatenate([nb << 16, (nb << 16) + 1, (end << 16) - 1,
                            end << 16, (end << 16) + 31, (nb << 16) + 32])
    out = [("batch", ids), ("one", ids[-1:]),
           ("segment_edges", np.resize(edges, n)),
           ("outside", np.resize(np.asarray(
               [-1, -(1 << 40), size, size + 1, (1 << 31) + 5, 1 << 40,
                size - 1, 0]), n))]
    return [(name, r.astype(np.int64)) for name, r in out]


def rank_vs_plain(rs, ids, cmp):
    """rs_rank over int64 ids ``ids`` (on the card) of index ``rs``
    against its plain version."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.ops import select as plain
    rargs = (rs._seg, rs._nb_dev, rs._gap_runs(), rs.pool, rs.gwc)
    cmp("rs_rank", ck.rs_rank(*rargs, ids, rs._rank_tables()),
        plain.rs_rank(*rargs, ids))


def rank_cases_vs_plain(rs, rng, cmp):
    """rs_rank over ``rank_cases`` of index ``rs``, and rank_flat over its
    pool (every wave's first and last bit, uniform offsets, one offset),
    against their plain versions on the card."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.ops import select as plain
    dev = rs.pool.device
    for _, ids in rank_cases(rs, rng):
        rank_vs_plain(rs, torch.from_numpy(ids).to(dev), cmp)
    n_bits = rs.pool.shape[0] * BPB
    if n_bits:
        rel = np.concatenate([np.arange(0, n_bits, 1024),
                              np.arange(1023, n_bits, 1024),
                              rng.integers(0, n_bits, 20_000)])
        rel = torch.from_numpy(rel).to(dev)
        frank = plain.flat_rank_tables(rs.gwc, rs._select_tables().wsp)
        for r in (rel, rel[-1:]):
            cmp("rs_rank", ck.rank_flat(rs.pool, rs.gwc, r, frank),
                plain.rank_flat(rs.pool, rs.gwc, r))


def select_vs_plain(rs, rng, cmp):
    """rs_select over ``select_cases`` of index ``rs`` against its plain
    version on the card."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.ops import select as plain
    dev = rs.pool.device
    runs = rs._gap_runs()
    sargs = (rs._seg, rs._cum0_dev, runs, rs.pool, rs.gwc)
    for name, ranks in select_cases(rs, rng):
        q = torch.from_numpy(ranks).to(dev)
        cmp("rs_select", ck.rs_select(*sargs, q, rs.total,
                                      rs._select_tables()),
            plain.rs_select(*sargs, q, rs.total))


def sharded_select_vs_plain(bv, words, device, rng, cmp):
    """select_flat and rank_flat on each shard of an 8-shard
    ShardedRSIndex of ``bv`` on ``device`` against their plain versions,
    and the index's select and rank batches against numpy."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.ops import select as plain
    from bitmagic_tpu_torch.parallel import Mesh, ShardedBitVector
    sbv = ShardedBitVector.from_bitvector(bv, Mesh([device] * 8))
    srs = sbv.build_rs_index()
    for i, (t, g) in enumerate(zip(sbv.shards, srs.gwc)):
        if not g.numel() or int(g[-1]) == 0:
            continue
        flat = srs.flat_tables(i)
        granks = torch.from_numpy(rng.integers(
            1, int(g[-1]) + 1, 20_000).astype(np.int32)).to(device)
        cmp("rs_select", ck.select_flat(t, g, granks, flat),
            plain.select_flat(t, g, granks))
        rel = torch.from_numpy(rng.integers(0, t.shape[0] * BPB,
                                            20_000)).to(device)
        cmp("rs_rank", ck.rank_flat(t, g, rel, srs.rank_tables(i)),
            plain.rank_flat(t, g, rel))
    ones = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                        bitorder="little"))
    ranks = np.concatenate([[-1, 0, 1, ones.size, ones.size + 1],
                            rng.integers(1, ones.size + 1, 100_000)])
    ok = (ranks >= 1) & (ranks <= ones.size)
    got = srs.select_batch(ranks)
    check(np.array_equal(got[ok], ones[ranks[ok] - 1])
          and (got[~ok] == -1).all(),
          "rs_select: an 8-shard index's select batch equals numpy")
    ids = np.concatenate([[-1, 0, bv.size - 1, bv.size],
                          rng.integers(0, bv.size, 100_000)])
    check(np.array_equal(srs.rank_batch(ids), np.searchsorted(
        ones, ids, side="right")), "rs_rank: an 8-shard index's rank batch "
        "equals numpy")


DESCENT_BLOCKS = 37             # descent_column: a 32-block FULL run fits
DESCENT_GAP_LEVELS = (128, 256, 512, 4096)   # D-GAP blocks of 3000 runs
DESCENT_GT = 0x5A5A5            # column_range_gather's find_gt value


def _run_bits(rng, n_runs):
    """One block's bits with exactly ``n_runs`` runs."""
    cuts = rng.choice(np.arange(1, BPB), n_runs - 1, replace=False)
    flips = np.zeros(BPB, np.int64)
    flips[cuts] = 1
    return (np.cumsum(flips) + rng.integers(0, 2)) % 2 == 1


def descent_column(pkg, dtype, nullable=False, seed=7, device=None):
    """A column of ``pkg`` (the port, or the JAX package in the tests)
    with every block class in its planes: blocks 0-3 and 6 random values
    (BIT rows; the dtype's edges first), blocks 4-5 D-GAP patterns of 1 to
    3000 runs per plane, the two top planes 2000 + 2096 runs in block 4
    (a GAP x GAP pair merged in the run domain) and 2000 + 2097 in block 5
    (a BIT row); then grown to DESCENT_BLOCKS blocks, a FULL run over
    blocks 4-35 in planes 1 and bits - 3, the NULL plane (20 % NULL in
    blocks 0-3 and 6) a FULL run over blocks 5-36, plane bits // 2
    absent."""
    rng = np.random.default_rng(seed)
    kw = {} if device is None else {"device": device}
    bits = np.iinfo(dtype).bits
    n = 6 * BPB + 777
    u = rng.integers(0, 2**63, n, dtype=np.uint64) << np.uint64(1)
    u |= rng.integers(0, 2, n, dtype=np.uint64)
    if bits < 64:
        u &= np.uint64((1 << bits) - 1)
    for b, top in ((4, (2000, 2096)), (5, (2000, 2097))):
        blk = np.zeros(BPB, np.uint64)
        for s in range(bits):
            runs = {bits - 1: top[0], bits - 2: top[1]}.get(
                s, int(rng.integers(1, 9 if s % 5 == 0 else 3001)))
            blk |= _run_bits(rng, runs).astype(np.uint64) << np.uint64(s)
        u[b * BPB:(b + 1) * BPB] = blk
    vals = pkg.SparseVector(dtype, **kw).u2s(u)
    info = np.iinfo(dtype)
    vals[:4] = [info.min, info.max, -1 if info.min else 1, 0]
    if nullable:
        nm = rng.random(n) < 0.2
        nm[4 * BPB:6 * BPB] = False
        kw["null_mask"] = nm
    levels = pkg.config.gap_levels
    try:
        pkg.config.gap_levels = DESCENT_GAP_LEVELS
        sv = pkg.SparseVector.from_array(vals, **kw)
        sv.optimize()
    finally:
        pkg.config.gap_levels = levels
    size = DESCENT_BLOCKS * BPB + 99
    sv.resize(size)
    for s in (1, bits - 3):
        sv.planes[s].set_range(3 * BPB + 17, DESCENT_BLOCKS * BPB - 1)
    if nullable:
        sv.null_plane.set_range(4 * BPB, size - 1)
    sv.planes[bits // 2] = None
    return sv


def descent_chain(tbm, planes, uni, value, n_bits):
    """The descent as the chain of set operations sv_descent replaces:
    ``(gt, eq)`` from ``eq = uni``, for each bit from the top a 1-bit
    ``eq &= p``, a 0-bit ``gt |= eq & p; eq -= p`` (K1 on the card)."""
    kw = {"device": uni.device}
    gt = tbm.BitVector(tbm.constants.ID_MAX48, **kw)
    eq = uni.copy()
    for s in range(n_bits - 1, -1, -1):
        p = planes[s] if s < len(planes) else None
        if (value >> s) & 1:
            if p is None:
                return gt, tbm.BitVector(tbm.constants.ID_MAX48, **kw)
            eq.bit_and(p)
        elif p is not None:
            gt.bit_or(eq & p)
            eq.bit_sub(p)
    return gt, eq


def descent_queries(bits):
    """Descent values over ``bits`` planes: the ends, both top bits, a
    1-bit on descent_column's absent plane, a few inside."""
    top = 1 << (bits - 1)
    return sorted({0, 1, top, top - 1, top | (top >> 1), (1 << bits) - 2,
                   (1 << (bits // 2)) | 5, 12345 % (1 << bits),
                   0x5A5A5A5A5A5A5A5A % (1 << bits)})


def descent_ring_columns(tbm, rng, device):
    """Columns for sv_descent's ring of staged rows -> [(name, column,
    n_bits, query)]: one step; 64 steps of BIT rows (the ring wraps eight
    times); and blocks whose eq empties early, block 3 at its first step
    (planes 4-19 absent there) and block 2 at plane 5 (absent there) after
    14 BIT steps, with the copies of later steps still in flight."""
    u = rng.integers(0, 2**64, 3 * BPB + 5, dtype=np.uint64)
    u[:4] = [0, 2**64 - 1, 2**63, 1]
    wide = tbm.SparseVector.from_array(u, device=device)
    v = rng.integers(0, 1 << 20, 4 * BPB + 9).astype(np.uint32)
    v[2 * BPB:3 * BPB] &= ~np.uint32(1 << 5)
    v[3 * BPB:4 * BPB] &= np.uint32(0xF)
    v[:2] = (1 << 20) - 1
    early = tbm.SparseVector.from_array(v, device=device)
    early.optimize()
    return [("one step", early, 1, 1), ("one step, 0-bit", early, 1, 0),
            ("64 steps", wide, 64, int(u[7])),
            ("early stop", early, 20, 0xFFFFF),
            ("early stop, 0-bits", early, 20, 0xF0020)]


def descent_kernels_vs_plain(rng, device, cmp):
    """sv_descent over descent_column's columns (uint32 nullable and not,
    int16 nullable; the column's universe and a D-GAP plane as universe;
    descent_queries) and descent_rows over a random stack with zero rows
    and zero planes in its three modes, each against its plain version on
    the card."""
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.core.bitvector import descent_args
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.sv.scanner import _universe
    sc = tbm.SparseVectorScanner()
    for dtype, nullable in ((np.uint32, False), (np.uint32, True),
                            (np.int16, True)):
        c = descent_column(tbm, dtype, nullable, device=device)
        bits = np.iinfo(dtype).bits
        for uni in (_universe(c), c.planes[bits - 1]):
            for q in descent_queries(bits):
                table, steps, _ = sc._descent_steps(c, q, bits)
                blocks = np.union1d(table.blocks, uni._struct.nb)
                args = descent_args(table, uni, steps, blocks)
                for want_eq in (True, False):
                    got = ck.sv_descent(table, *args, want_eq)
                    want = blockops.sv_descent(table, *args, want_eq)
                    for g, w in zip(got, want):
                        if w is not None:
                            cmp("sv_descent", g, w)
    for _, c, n_bits, q in descent_ring_columns(tbm, rng, device):
        uni = _universe(c)
        table, steps, _ = sc._descent_steps(c, q, n_bits)
        args = descent_args(table, uni, steps,
                            np.union1d(table.blocks, uni._struct.nb))
        for g, w in zip(ck.sv_descent(table, *args),
                        blockops.sv_descent(table, *args)):
            cmp("sv_descent", g, w)
    n, k = 29, 24
    stack = _rand_pool(rng, k * n, device).reshape(k, n, 2048)
    stack[3] = 0
    stack[:, 5] = 0
    rows = [7, -1, 3, 0, 12, -1, 22, 9, 1, 2, 4, 6, 8, 10, 11, 13]
    for mode in (0, 1, 2):
        for bits in (0, 0b1011001110001011, 0xFFFF, 0x5A5A):
            got = ck.descent_rows(stack, stack[23], rows, bits, stack[0],
                                  mode)
            want = blockops.descent_rows(stack, stack[23], rows, bits,
                                         stack[0], mode)
            for g, w in zip(got, want):
                cmp("sv_descent", g, w)
    # a shard of 31 rows and one of 245 under 64 steps (two batches of a
    # thread's loads), zero planes among them
    for n in (31, 245):
        stack = _rand_pool(rng, 8 * n, device).reshape(8, n, 2048)
        stack[2] = 0
        rows = [int(r) for r in rng.integers(-1, 7, 64)]
        bits = int(rng.integers(0, 2**63)) | 1 << 63
        for mode in (0, 1, 2):
            for g, w in zip(
                    ck.descent_rows(stack, stack[7], rows, bits, stack[0],
                                    mode),
                    blockops.descent_rows(stack, stack[7], rows, bits,
                                          stack[0], mode)):
                cmp("sv_descent", g, w)


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

    n0 = ck.launches["gap_expand"]
    cell1_step(tbm, a, b)
    check(ck.launches["gap_expand"] - n0 == CELL1_GAP_EXPANDS,
          f"a bvsetalgebra_rank_select step launched gap_expand "
          f"{ck.launches['gap_expand'] - n0} times, not "
          f"{CELL1_GAP_EXPANDS}")

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
    n0 = dict(ck.launches)
    with Clock("select_1M_ms", times):
        pos = rs.select_batch(ranks)
    check(np.array_equal(pos, np.flatnonzero(bits["a"])[ranks - 1]),
          "select")
    ids = rng.integers(0, size, n_queries)
    with Clock("rank_1M_ms", times):
        rk = rs.rank_batch(ids)
    check(np.array_equal(rk, oracle_rank(wa, ids)), "rank")
    check({k: ck.launches[k] - n0[k] for k in RS_KERNELS}
          == {"rs_select": 1, "rs_rank": 1},
          "select_batch launched rs_select once, rank_batch rs_rank once")
    n0 = dict(ck.launches)
    times.update(single_query_ms(a, rs, ranks, pos, ids, rk))
    # each one-query call is one launch (and one warm-up call each)
    check({k: ck.launches[k] - n0[k] for k in RS_KERNELS}
          == {"rs_select": 2 * (SINGLE_CALLS + 1),
              "rs_rank": SINGLE_CALLS + 1},
          "one launch per one-query select, rank and BitVector.select")
    return times, (a, b, rs, ranks, ids)


# gap_expand launches in one bvsetalgebra_rank_select step (cell1_step):
# one per operand pair in count_and, the four operations and
# distance_operation, one for the shifted copy of A
CELL1_GAP_EXPANDS = 7


def cell1_step(tbm, a, b):
    """The set algebra of one bvsetalgebra_rank_select step
    (bench_torch.SetAlgebraTraffic) on vectors a and b that both hold
    D-GAP blocks: count_and, the four operations each with its count,
    distance_operation of 7 metrics, shift_right of a copy of a with its
    count."""
    tbm.count_and(a, b)
    for op in OPS:
        getattr(a, DUNDER[op])(b).count()
    tbm.distance_operation(a, b, list(METRICS))
    a.copy().shift_right().count()


def single_query_ms(a, rs, ranks, pos, ids, rk, calls=SINGLE_CALLS):
    """Median host wall ms of one-query calls on a built index (the
    callers that pass one query: BitVector.select, RSCSparseVector,
    sv.util): ``rs.select``, ``rs.rank`` and ``a.select``, each on the
    first ``calls`` queries after one warm-up call; each call returns a
    host int, so its wall ends with the answer's download.  ``pos`` and
    ``rk`` are the batches' checked answers to the same queries."""
    out = {}
    for what, fn, qs, want in (("select", rs.select, ranks, pos),
                               ("rank", rs.rank, ids, rk),
                               ("bv_select", a.select, ranks, pos)):
        fn(int(qs[0]))
        walls, got = [], []
        for q in qs[:calls]:
            t0 = time.perf_counter()
            got.append(fn(int(q)))
            walls.append(time.perf_counter() - t0)
        check(got == want[:calls].tolist(), f"one-query {what}")
        out[f"one_{what}_ms"] = round(float(np.median(walls)) * 1e3, 4)
    return out


def single_query_main(root):
    """``--single-query ROOT``: config 1's A and its rs-index built by the
    package under ROOT, the main path's 1M select and rank batches as its
    oracle, then ``single_query_ms``; prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import bitmagic_tpu_torch as tbm
    device = torch.device("cuda")
    a, _, bits = build_main_vectors(tbm, N_BLOCKS, device, {})
    rs = a.build_rs_index()
    rng = np.random.default_rng(SEED + 4)
    ranks = rng.integers(1, rs.count() + 1, N_QUERIES)
    ids = rng.integers(0, N_BLOCKS * BPB, N_QUERIES)
    pos, rk = rs.select_batch(ranks), rs.rank_batch(ids)
    check(np.array_equal(pos, np.flatnonzero(bits["a"])[ranks - 1]),
          "select")
    check(np.array_equal(rk, oracle_rank(image(bits["a"]), ids)), "rank")
    log(json.dumps({"root": root, "package": tbm.__file__,
                    **single_query_ms(a, rs, ranks, pos, ids, rk),
                    "calls": SINGLE_CALLS,
                    "card": nvidia_smi("name,power.limit")}))
    return 0


def steady_pass(tbm, a, b, rs, ranks, ids):
    """One more pass of the main path's query work on built vectors."""
    for op in OPS:
        getattr(a, DUNDER[op])(b).count()
    tbm.distance_operation(a, b, list(METRICS))
    rs.select_batch(ranks)
    rs.rank_batch(ids)


def traced_device_events(fn):
    """The device events of one torch.profiler trace of ``fn``, kept with
    acc_events=True (without it torch warns that the profiler clears its
    events at the end of each cycle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        sync()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_busy(fn):
    """(host wall ms of fn, device-busy ms, device ms by kernel name): the
    wall time from an unprofiled run, the device time from the kernel and
    copy events of a torch.profiler run of the same work."""
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in traced_device_events(fn):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall, busy, {k[:60]: round(v / 1e3, 4) for k, v in top}


def trace_retry_pause(what):
    """Log a trace that recorded no kernel, and wait a second before the
    next."""
    log(f"{what}: a trace recorded no kernel; tracing again")
    time.sleep(1.0)


def device_kernels(fn):
    """Names of the kernels one run of ``fn`` put on the card (copies and
    memsets left out), from a torch.profiler trace after a warm-up run."""
    fn()
    sync()
    return [e.name for e in traced_device_events(fn)
            if not e.name.startswith(("Memcpy", "Memset"))]


def k2_operands(a, b):
    """The gather descriptors distance_operation hands K2 for vectors a and
    b: the candidate blocks where at least one side is a BIT row or a GAP
    block (expanded into aux rows)."""
    from bitmagic_tpu_torch.core.blocks import operand_args_pair
    cand = np.union1d(a._struct.nb, b._struct.nb)
    st_a, _ = a._struct.lookup(cand)
    st_b, _ = b._struct.lookup(cand)
    rows = cand[(st_a >= 2) | (st_b >= 2)]
    return operand_args_pair(a, b, rows)


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
    uint32 SparseVector with values < 2^20 and ~1 % NULL, built by
    from_array (its wall split into sv_transpose's device time and the
    rest), a gather of SV_GATHER_IDS ids (host wall and device busy);
    answers against np.bincount, == and the values."""
    times = {}
    rng, vals, nm = config4b_values()
    live = np.where(nm, np.uint32(0), vals)

    def build():
        return tbm.SparseVector.from_array(vals, nullable=True, null_mask=nm,
                                           device=device)

    with Clock("from_array_16M_ms", times):
        sv = build()
    check(sv.size == SV_N and sv.effective_slices() == SV_BITS,
          "config 4b planes")
    ev = [e.device_time_total for e in traced_device_events(build)
          if "sv_transpose_kernel" in e.name]
    if ev:
        times["from_array_16M_sv_transpose_device_ms"] = sum(ev) / 1e3
        times["from_array_16M_rest_ms"] = (times["from_array_16M_ms"]
                                           - sum(ev) / 1e3)
    else:
        times["from_array_16M_sv_transpose_device_ms"] = "not measured"
    ids = rng.integers(0, SV_N, SV_GATHER_IDS)
    check(np.array_equal(sv.gather(ids), live[ids]), "config 4b gather")
    wall, busy, top = device_busy(lambda: sv.gather(ids))
    times["gather_1M_ms"], times["gather_1M_busy_ms"] = wall, busy
    times["gather_1M_device_ms_by_kernel"] = top
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
    # one find_gt alone: the launches of one ordered descent
    before = dict(ck.launches)
    with Clock("find_gt_ms", times):
        sc.find_gt(sv, drawn)
    times["find_gt_launches"] = {k: v - before[k] for k, v in
                                 ck.launches.items() if v > before[k]}
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
    "config 4b ordered": ("sv_descent", "logical_op_digest"),
    "signed": ("sv_descent", "logical_op_digest"),
    "sorted": (),
    "float": ("sv_descent", "logical_op_digest", "agg_and_sub"),
    "strings": ("agg_and_sub", "pipeline_counts", "block_counts"),
    "rsc": ("agg_and_sub", "logical_op_digest", "sv_descent"),
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
        "ms": times["find_gt_ms"], "launches": times["find_gt_launches"],
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
# phase 9b: descent — the ordered searches' slice descent in one launch
# ---------------------------------------------------------------------------
def same_parts(a, b, what):
    """Every ``interop.PARTS`` field of two BitVectors equal."""
    from bitmagic_tpu_torch import interop
    pa, pb = interop.bitvector_to_parts(a), interop.bitvector_to_parts(b)
    for key in interop.PARTS:
        check(np.array_equal(np.asarray(pa[key]), np.asarray(pb[key])),
              f"{what}: {key}")


def find_gt_trace(tbm, sv):
    """The kernels one config 4b ``find_gt(DESCENT_GT)`` with its count
    puts on the card, from a trace in this process (up to TRACE_TRIES
    traces while one records no kernel), for the descent phase's check.
    The scan path takes it on its own column: late in a full run, after
    the serial and sv phases, the profiler records no device event (PERF.md,
    open questions)."""
    sc = tbm.SparseVectorScanner()
    for retries in range(TRACE_TRIES):
        names = device_kernels(lambda: sc.find_gt(sv, DESCENT_GT).count())
        if names:
            break
        trace_retry_pause("config 4b find_gt + count")
    log(f"scan: config 4b find_gt + count put these kernels on the card: "
        f"{short_kernel_names(names)}; empty traces before this one: "
        f"{retries}")
    return names


def descent_phase(tbm, device, card, sv, vals, nm, find_gt_names):
    """Phase 9b.  (1) On descent_column's mixed-block columns on the card
    (uint32 nullable and not, int16 nullable, uint64), every descent of
    descent_queries, from the column's universe and from a D-GAP plane,
    equals in every part the same descent chained from bit_and / bit_or /
    bit_sub on the card (K1); the ordered searches equal the same column's
    on the CPU.  (2) Config 4b's column with the counts set to 0 just
    before and read just after: find_gt(DESCENT_GT) with its count, then
    find_ge / lt / le and find_range against numpy (the path's launches).
    One find_gt with its count is one sv_descent and one K3 launch, its
    trace (``find_gt_names``, taken by ``find_gt_trace`` on the same
    column) sv_descent_kernel and block_counts_kernel and no other
    kernel, its result equal in every part to the K1 chain's.  (3) A sharded
    find_gt on SHARDS shards is one descent_rows launch per shard and no
    K1.  Returns (the path's launches, ms)."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import Mesh, ShardedSparseVector
    from bitmagic_tpu_torch.sv.scanner import _universe
    sc = tbm.SparseVectorScanner()
    times = {}
    t0 = time.perf_counter()
    n = 0
    for dtype, nullable in ((np.uint32, False), (np.uint32, True),
                            (np.int16, True), (np.uint64, False)):
        c = descent_column(tbm, dtype, nullable, device=device)
        bits = np.iinfo(dtype).bits
        name = np.dtype(dtype).name
        for uni in (_universe(c), c.planes[bits - 1]):
            for q in descent_queries(bits):
                fused = sc._cmp_unsigned(c, uni, q, bits)
                chain = descent_chain(tbm, c.planes, uni, q, bits)
                for f, w, what in zip(fused, chain, ("gt", "eq")):
                    same_parts(f, w, f"descent {name} {what}({q})")
                n += 1
        if dtype == np.int16:
            cpu = descent_column(tbm, dtype, nullable, device="cpu")
            for q in (-32768, -1, 0, 77, 32767):
                for op in ORDER_OPS:
                    same_parts(getattr(sc, op)(c, q), getattr(sc, op)(cpu, q),
                               f"descent int16 {op}({q}) card vs CPU")
    times["mixed_columns_s"] = time.perf_counter() - t0
    log(f"descent: {n} descents over mixed-block columns equal the K1 "
        f"chain in every part ({times['mixed_columns_s']:.1f} s)")
    # (2) config 4b's column: the path
    v64, ok = vals.astype(np.int64), ~nm
    ck.reset_launches()
    t0 = time.perf_counter()
    r = sc.find_gt(sv, DESCENT_GT)
    check(r.count() == int(((v64 > DESCENT_GT) & ok).sum()),
          "config 4b find_gt count")
    sync()
    one = {k: v for k, v in ck.launches.items() if v}
    for name, op in ORDER_OPS.items():
        same_ids(getattr(sc, name)(sv, DESCENT_GT),
                 np.flatnonzero(op(v64, DESCENT_GT) & ok),
                 f"config 4b {name}({DESCENT_GT})")
    same_ids(sc.find_range(sv, 1000, DESCENT_GT),
             np.flatnonzero((v64 >= 1000) & (v64 <= DESCENT_GT) & ok),
             "config 4b find_range")
    sync()
    launches = dict(ck.launches)
    times["path_ms"] = (time.perf_counter() - t0) * 1e3
    require_launches("descent path", launches, ("sv_descent",))
    check(one == {"sv_descent": 1, "block_counts": 1},
          f"config 4b find_gt + count launched {one}, not one sv_descent "
          f"and one K3")
    check(bool(find_gt_names), f"config 4b find_gt + count: all "
          f"{TRACE_TRIES} traces of it recorded no device event")
    names = find_gt_names
    check(len(names) == 2 and sum("sv_descent_kernel" in x for x in names)
          == 1 and sum("block_counts_kernel" in x for x in names) == 1,
          "config 4b find_gt + count: one sv_descent_kernel, one "
          "block_counts_kernel, no other kernel")
    walls = []
    for _ in range(20):
        t1 = time.perf_counter()
        sc.find_gt(sv, DESCENT_GT)
        sync()
        walls.append((time.perf_counter() - t1) * 1e3)
    times["find_gt_ms_median"] = float(np.median(walls))
    before = ck.launches["logical_op_digest"]
    uni = _universe(sv)
    chain = descent_chain(tbm, sv.planes, uni, DESCENT_GT, sv.n_slices)[0]
    times["chain_k1_launches"] = ck.launches["logical_op_digest"] - before
    same_parts(sc.find_gt(sv, DESCENT_GT), chain,
               "config 4b find_gt: fused vs K1 chain")
    profile("descent: config 4b find_gt + count",
            lambda: sc.find_gt(sv, DESCENT_GT).count())
    # (3) one launch per shard
    ssv = ShardedSparseVector.from_sparse_vector(sv, Mesh([device] * SHARDS))
    before = dict(ck.launches)
    hits = ssv.find_gt(DESCENT_GT)
    sync()
    shard_launch_check("sharded find_gt", before,
                       {"sv_descent": SHARDS, "logical_op_digest": 0})
    check(np.array_equal(hits.to_bitvector().indices(),
                         np.flatnonzero((v64 > DESCENT_GT) & ok)),
          "sharded find_gt")
    log(json.dumps({"descent_config4b": {
        "find_gt_count_launches": one, "find_gt_ms_median":
        times["find_gt_ms_median"], "chain_k1_launches":
        times["chain_k1_launches"], "sharded_launches_per_find_gt":
        SHARDS}, "card": card["smi"]}))
    return launches, times


# ---------------------------------------------------------------------------
# phase 10: sv_serial — the sv phase's columns through BMSV and the
# reference's sparse-vector format
# ---------------------------------------------------------------------------
SV_GATHER = 1 << 20             # deserialize_gather / sharded gather ids
# The float column's reference-format ('bf0') BLOB is written from its
# first REF_FLOAT_HEAD values only: the XOR-reference search over its planes
# is host Python, about a minute to write and half a minute to read the
# whole 16M column on the card's host, which the script's time limit cannot
# hold beside the tools and fuzz phases.
REF_FLOAT_HEAD = 1 << 20


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


def sv_serial_column(tbm, device, name, c, cc, ref_xor, times, rng,
                     ref=None):
    """One column of the sv phase (``c`` on the card, ``cc`` the same on
    the CPU): BMSV with XOR groups on and off, range and gather decodes,
    the reference-format BLOB (of ``ref``, a (card, CPU) pair of another
    column, where given); every BLOB byte-equal to the CPU copy's, every
    decode equal to the source on the card."""
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
    if ref is not None:
        c, cc = ref
        n = c.size
    t = {}
    with Clock("ref_ser", t):
        rblob = _ref_blob(ref_sv, c, ref_xor)
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
    out.update(ref_values=n, ref_bytes=len(rblob), ref_xor_refs=ref_xor,
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
    fv, fvals, fnm = cols["float"]
    head = tbm.FloatSparseVector.from_array(fvals[:REF_FLOAT_HEAD],
                                            nullable=True, device=device)
    for i in np.flatnonzero(fnm[:REF_FLOAT_HEAD]).tolist():
        head.set_null(i)
    refs = {"float": (head, _cpu_copy(tbm, head))}
    times = {}
    ck.reset_launches()
    t0 = time.perf_counter()
    for name, c, cc, ref_xor in columns:
        t1 = time.perf_counter()
        sv_serial_column(tbm, device, name, c, cc or _cpu_copy(tbm, c),
                         ref_xor, times, rng, refs.get(name))
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
    before = dict(ck.launches)
    with Clock(f"{tag}_select_1M_ms", times):
        got = a.select_batch(ranks)
    check(a._rs is None, "2^30 bits: the select below the cap")
    check(np.array_equal(got, oracle_select(fa, ranks)), "sharded select")
    # the flat forms: one launch per shard that holds queries
    shard_launch_check("sharded select", before, {
        "rs_select": np.unique(got // a.shard_span).size})
    ids = rng.integers(0, size, N_QUERIES)
    before = dict(ck.launches)
    with Clock(f"{tag}_rank_1M_ms", times):
        got = a.build_rs_index().rank_batch(ids)
    check(np.array_equal(got, oracle_rank(fa, ids)), "sharded rank")
    shard_launch_check("sharded rank", before, {
        "rs_rank": np.unique(ids // a.shard_span).size})
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
    before = dict(ck.launches)
    with Clock(f"{tag}_big_select_1M_ms", times):
        got = c.select_batch(ranks)
    check(c._rs is not None, "2^31 + 2^16 bits: the select past the cap")
    want = np.full(ranks.size, -1, np.int64)
    want[:-2] = oracle_select(fc, ranks[:-2])
    check(np.array_equal(got, want), "2^31 + 2^16 bits: select")
    shard_launch_check("2^31 + 2^16 bits: select", before, {
        "rs_select": np.unique(got[got >= 0] // c.shard_span).size})
    ids = np.concatenate([rng.integers(0, BIG_BITS, N_QUERIES),
                          [BIG_BITS - 1, BIG_BITS - BPB + 5]])
    before = dict(ck.launches)
    check(np.array_equal(c.build_rs_index().rank_batch(ids),
                         oracle_rank(fc, ids)), "2^31 + 2^16 bits: rank")
    shard_launch_check("2^31 + 2^16 bits: rank", before, {
        "rs_rank": np.unique(ids // c.shard_span).size})
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
    before = dict(ck.launches)
    with Clock("find_gt_ms", times):
        ssv.find_gt(drawn)
    shard_launch_check("4b sharded find_gt", before,
                       {"sv_descent": mesh.size, "logical_op_digest": 0})
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
                            "pipeline_counts", "scan_eq", "block_counts",
                            "sv_descent"),
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
        "sv_descent_launches": SHARDS}, "card": card["smi"]}))
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
# phases 12-14: the surface — the C-API facade, utils and the samples
# ---------------------------------------------------------------------------
CAPI_CALLS = 1000               # per-call queries (get_bit, rank, select...)
CAPI_ARR = 100_000              # ids of each *_arr combine
SAMPLES_DIR = os.path.join(ROOT, "samples_torch")
# the lines a port sample may print differently on the card and on the CPU:
# the mesh's device list (07, 21), the wall times of sample 22 (its counts
# still compare) and sample 07's run over every visible card (card only)
SAMPLE_MESH_LINE = {"07_sharded_scaling.py", "21_sharded_succinct_scan.py"}
SAMPLE_TIMED = {"22_wide_ranges_48bit.py": ("set_range(0, 2^47-1): ",
                                            "invert() @ 2^48     : ")}
SAMPLE_CARD_ONLY = {"07_sharded_scaling.py": "make_mesh() over "}
BITAP_PATTERNS = (16, 32)       # B8 at config-1 width: pattern lengths
# B8's low-reuse shape at config-1 width: a text over 20 letters (a
# protein alphabet) and a 32-letter pattern drawn from it
PROTEIN_LETTERS, PROTEIN_PATTERN = 20, 32
# B8's timed shapes (bitap_timing), each also with L2 left clean
B8_SHAPES = ("config1_32", "config1_16", "protein_32")


def capi_ok(capi, ret, what):
    """The value of a BM_* call whose code must be BM_OK: a failed kernel
    build or launch comes back from the facade as an error code, and after
    a CUDA error the context is unusable, so the phase stops at the first
    bad code.  Returns None (code only), the value, or the tuple of values."""
    code = ret[0] if isinstance(ret, tuple) else ret
    check(code == capi.BM_OK,
          f"capi: {what} returned {code} ({capi.BM_error_msg(code)})")
    if not isinstance(ret, tuple):
        return None
    return ret[1] if len(ret) == 2 else ret[1:]


def _first_mismatch(wa, wb):
    x = np.flatnonzero(wa ^ wb)
    if not x.size:
        return -1
    w = int(x[0])
    d = int(wa[w] ^ wb[w])
    return w * 32 + (d & -d).bit_length() - 1


def capi_path(tbm, device, times, n_blocks=N_BLOCKS):
    """Configs 1-2's A and B through the C-API facade, every answer against
    numpy; ``times`` gets ms per entry point (per call for the per-call
    queries).  Returns A (optimized), B and their bit arrays."""
    from bitmagic_tpu_torch import capi
    from bitmagic_tpu_torch import constants as C
    size = n_blocks * BPB
    a, b, bits = build_main_vectors(tbm, n_blocks, device, {})
    wa, wb = image(bits["a"]), image(bits["b"])
    ids_a = np.flatnonzero(bits["a"])
    rng = np.random.default_rng(SEED + 40)

    def ok(ret, what):
        return capi_ok(capi, ret, what)

    def per_call(name, fn, n=CAPI_CALLS):
        sync()
        t0 = time.perf_counter()
        out = [fn(k) for k in range(n)]
        sync()
        times[f"{name}_ms_per_call"] = round(
            (time.perf_counter() - t0) * 1e3 / n, 4)
        return out

    # A and B through BM_bvector_construct + BM_bvector_set_bits
    built = {}
    for name, ids in (("a", ids_a), ("b", np.flatnonzero(bits["b"]))):
        with Clock(f"construct_set_bits_{name}_ms", times):
            v = ok(capi.BM_bvector_construct(size), "construct")
            ok(capi.BM_bvector_set_bits(v, ids), f"set_bits {name}")
        check(v.device.type == device.type, "construct builds on the card")
        built[name] = v
    check(ok(capi.BM_bvector_equal(built["a"], a), "equal") is True
          and ok(capi.BM_bvector_equal(built["b"], b), "equal") is True,
          "A and B through the facade equal phase 4's")
    check(np.array_equal(built["a"].to_words().ravel(), wa),
          "A through the facade: word image")
    del built

    def copy(v):
        return ok(capi.BM_bvector_construct_copy(v), "construct_copy")

    # the four combines, their 3-operand forms, arrays and merge
    for op in ("AND", "OR", "XOR", "SUB"):
        want = oracle_op(op.lower(), wa, wb)
        x = copy(a)
        with Clock(f"combine_{op}_ms", times):
            ok(getattr(capi, f"BM_bvector_combine_{op}")(x, b), op)
        check(np.array_equal(x.to_words().ravel(), want), f"combine_{op}")
        t = ok(capi.BM_bvector_construct(size), "construct")
        with Clock(f"combine_{op}_2sc_ms", times):
            ok(getattr(capi, f"BM_bvector_combine_{op}_2sc")(t, a, b),
               f"{op}_2sc")
        check(np.array_equal(t.to_words().ravel(), want),
              f"combine_{op}_2sc")
        x = copy(a)
        with Clock(f"combine_operation_{op}_ms", times):
            ok(capi.BM_bvector_combine_operation(
                x, b, ("AND", "OR", "SUB", "XOR").index(op)), op)
        check(np.array_equal(x.to_words().ravel(), want),
              f"combine_operation {op}")
    arr = rng.integers(0, size, CAPI_ARR)
    arr_bits = np.zeros(size, bool)
    arr_bits[arr] = True
    warr = image(arr_bits)
    for form, op in (("OR", "or"), ("AND", "and"), ("XOR", "xor"),
                     ("SUB", "sub"), ("AND", "and_sorted")):
        x = copy(a)
        fn = (capi.BM_bvector_combine_AND_arr_sorted if op == "and_sorted"
              else getattr(capi, f"BM_bvector_combine_{form}_arr"))
        with Clock(f"combine_{op}_arr_ms", times):
            ok(fn(x, np.sort(arr) if op == "and_sorted" else arr),
               f"{op}_arr")
        check(np.array_equal(x.to_words().ravel(),
                             oracle_op(form.lower(), wa, warr)),
              f"combine_{op}_arr")
    x, y = copy(a), copy(b)
    with Clock("merge_ms", times):
        ok(capi.BM_bvector_merge(x, y), "merge")
    check(np.array_equal(x.to_words().ravel(), wa | wb), "merge")
    del x, y, t

    # counts
    for name, v, w in (("a", a, wa), ("b", b, wb)):
        with Clock(f"count_{name}_ms", times):
            cnt = ok(capi.BM_bvector_count(v), "count")
        check(cnt == int(np.bitwise_count(w).sum(dtype=np.int64)),
              f"count {name}")
    lo = rng.integers(0, size, N_RANGES)
    hi = np.minimum(lo + rng.integers(0, size // 4, N_RANGES), size - 1)
    got = per_call("count_range", lambda k: ok(capi.BM_bvector_count_range(
        a, int(lo[k]), int(hi[k])), "count_range"), N_RANGES)
    want = oracle_rank(wa, hi) - oracle_rank(wa, lo - 1)
    check(np.array_equal(got, want), "count_range x64")
    for op, metric in (("AND", "count_and"), ("OR", "count_or"),
                       ("XOR", "count_xor"), ("SUB", "count_sub_ab")):
        want = oracle_metric(metric, wa, wb)
        with Clock(f"count_{op}_ms", times):
            got = ok(getattr(capi, f"BM_bvector_count_{op}")(a, b), op)
        check(got == want, f"count_{op}")
        with Clock(f"any_{op}_ms", times):
            got = ok(getattr(capi, f"BM_bvector_any_{op}")(a, b), op)
        check(got == (want > 0), f"any_{op}")

    # compare, equal, the first mismatch
    m = _first_mismatch(wa, wb)
    with Clock("compare_ms", times):
        cmp = ok(capi.BM_bvector_compare(a, b), "compare")
    check(cmp == (1 if bits["a"][m] else -1), "compare")
    with Clock("equal_ms", times):
        check(ok(capi.BM_bvector_equal(a, b), "equal") is False, "equal")
    with Clock("find_first_mismatch_ms", times):
        got = ok(capi.BM_bvector_find_first_mismatch(a, b), "mismatch")
    check(tuple(got) == (True, m), "find_first_mismatch")
    check(tuple(ok(capi.BM_bvector_find_first_mismatch(a, copy(a)),
                   "mismatch")) == (False, -1), "no mismatch with a copy")

    # single-bit queries and the find family, CAPI_CALLS calls each
    pos = rng.integers(0, size, CAPI_CALLS)
    got = per_call("get_bit", lambda k: ok(capi.BM_bvector_get_bit(
        a, int(pos[k])), "get_bit"))
    check(np.array_equal(got, bits["a"][pos]), "get_bit")
    nxt = np.searchsorted(ids_a, pos)
    want = [(bool(i < ids_a.size), int(ids_a[i]) if i < ids_a.size else -1)
            for i in nxt]
    got = per_call("find", lambda k: tuple(ok(capi.BM_bvector_find(
        a, int(pos[k])), "find")))
    check(got == want, "find")
    walk = [tuple(ok(capi.BM_bvector_get_first(a), "get_first"))]

    def get_next(k):
        walk.append(tuple(ok(capi.BM_bvector_get_next(a, walk[-1][1]),
                             "get_next")))
    per_call("get_next", get_next)
    check(walk == [(True, int(p)) for p in ids_a[:CAPI_CALLS + 1]],
          "get_first / get_next")
    check(tuple(ok(capi.BM_bvector_find_reverse(a), "find_reverse"))
          == (True, int(ids_a[-1])), "find_reverse")

    # optimize, then rank / select / find_rank on the rank-select index
    with Clock("optimize_ms", times):
        st = ok(capi.BM_bvector_optimize(a), "optimize")
    check(np.array_equal(a.to_words().ravel(), wa), "optimize keeps A")
    blk = wa.reshape(n_blocks, -1)
    check(st["full_blocks"] == int((blk == 0xFFFFFFFF).all(1).sum())
          and st["zero_blocks"] == int((blk == 0).all(1).sum())
          and st["bit_blocks"] + st["gap_blocks"] + st["full_blocks"]
          + st["zero_blocks"] == n_blocks, f"optimize statistics {st}")
    with Clock("statistics_ms", times):
        check(ok(capi.BM_bvector_statistics(a), "statistics") == st,
              "statistics")
    ranks = rng.integers(1, ids_a.size + 1, CAPI_CALLS)
    got = per_call("select", lambda k: tuple(ok(capi.BM_bvector_select(
        a, int(ranks[k])), "select")))
    check(got == [(True, int(p)) for p in ids_a[ranks - 1]], "select")
    check(tuple(ok(capi.BM_bvector_select(a, 0), "select")) == (False, -1),
          "select(0)")
    got = per_call("rank", lambda k: ok(capi.BM_bvector_rank(
        a, int(pos[k])), "rank"))
    check(np.array_equal(got, oracle_rank(wa, pos)), "rank")
    got = per_call("rank_corrected", lambda k: ok(
        capi.BM_bvector_rank_corrected(a, int(pos[k])), "rank_corrected"),
        N_RANGES)
    check(np.array_equal(got, oracle_rank(wa, pos[:N_RANGES])
                         - bits["a"][pos[:N_RANGES]]), "rank_corrected")
    frm = rng.integers(1, size, CAPI_CALLS)
    rr = rng.integers(1, 1000, CAPI_CALLS)
    at = oracle_rank(wa, frm - 1) + rr - 1
    want = [(bool(i < ids_a.size), int(ids_a[i]) if i < ids_a.size else -1)
            for i in at]
    got = per_call("find_rank", lambda k: tuple(ok(capi.BM_bvector_find_rank(
        a, int(rr[k]), int(frm[k])), "find_rank")))
    check(got == want, "find_rank")

    # serialization, the operation deserializer
    with Clock("serialize_ms", times):
        blob = ok(capi.BM_bvector_serialize(a), "serialize")
    with Clock("deserialize_ms", times):
        back = ok(capi.BM_bvector_deserialize(blob), "deserialize")
    check(back.device.type == device.type
          and np.array_equal(back.to_words().ravel(), wa), "deserialize")
    for op, want in ((C.SET_AND, wa & wb), (C.SET_OR, wa | wb),
                     (C.SET_SUB, wb & ~wa)):
        x = copy(b)
        with Clock(f"operation_deserialize_{op}_ms", times):
            ok(capi.BM_bvector_operation_deserialize(x, blob, op),
               f"operation_deserialize {op}")
        check(np.array_equal(x.to_words().ravel(), want),
              f"operation_deserialize {op}")
    with Clock("operation_deserialize_count_and_ms", times):
        got = ok(capi.BM_bvector_operation_deserialize(
            copy(b), blob, C.SET_COUNT_AND), "COUNT_AND")
    check(got == oracle_metric("count_and", wa, wb),
          "operation_deserialize COUNT_AND")
    del back, x

    # read-only copies: a write returns an error code, never raises
    with Clock("construct_copy_ro_ms", times):
        ro = ok(capi.BM_bvector_construct_copy_ro(a), "construct_copy_ro")
    check(ok(capi.BM_bvector_is_ro(ro), "is_ro") is True, "is_ro")
    log("capi: a write to a frozen copy must return an error code; the "
        "facade prints the ReadOnlyError it caught:")
    code = capi.BM_bvector_set_bit(ro, 5)
    check(code == capi.BM_ERR_BADARG, f"write to a frozen copy gave {code}")
    x = copy(b)
    ok(capi.BM_bvector_freeze(x), "freeze")
    check(ok(capi.BM_bvector_is_ro(x), "is_ro") is True, "freeze")
    rw = ok(capi.BM_bvector_construct_copy_rw(ro), "construct_copy_rw")
    check(ok(capi.BM_bvector_is_ro(rw), "is_ro") is False
          and ok(capi.BM_bvector_count(ro), "count")
          == ids_a.size, "read-write copy")
    del ro, rw, x

    # the enumerator: ENUM_WALK positions one at a time, then goto jumps
    with Clock("enumerator_construct_from_ms", times):
        en = ok(capi.BM_bvector_enumerator_construct_from(a, 0),
                "enumerator_construct_from")
    first = ok(capi.BM_bvector_enumerator_get_value(en), "get_value")
    walk_n = min(ENUM_WALK, ids_a.size)
    steps = per_call("enumerator_next_value", lambda k: tuple(ok(
        capi.BM_bvector_enumerator_next_value(en), "next_value")),
        walk_n - 1)
    check([first] + [v for _, v in steps] == ids_a[:walk_n].tolist()
          and all(f for f, _ in steps), "enumerator walk")
    jumps = np.sort(rng.integers(0, size, CAPI_CALLS))

    def goto(k):
        valid = ok(capi.BM_bvector_enumerator_goto(en, int(jumps[k])), "goto")
        check(valid == ok(capi.BM_bvector_enumerator_is_valid(en),
                          "is_valid"), "is_valid after goto")
        return (valid, ok(capi.BM_bvector_enumerator_get_value(en),
                          "get_value") if valid else -1)
    got = per_call("enumerator_goto", goto)
    nxt = np.searchsorted(ids_a, jumps)
    check(got == [(True, int(ids_a[i])) if i < ids_a.size else (False, -1)
                  for i in nxt], "enumerator goto")
    ok(capi.BM_bvector_enumerator_free(en), "enumerator_free")
    tail = 22 * (n_blocks // 24) * BPB          # A's sparse region
    it = ok(capi.BM_bvector_enumerator_construct(a, tail),
            "enumerator_construct")
    seen = []
    while True:
        err, found, v = capi.BM_bvector_enumerator_next(it)
        check(err == capi.BM_OK, "enumerator_next")
        if not found:
            break
        seen.append(v)
    check(seen == ids_a[ids_a >= tail].tolist(), "enumerator_next")

    # extract_next: the next set bit, cleared
    x = copy(a)
    prev = [-1]

    def extract(k):
        prev.append(ok(capi.BM_bvector_extract_next(x, prev[-1]),
                       "extract_next"))
    per_call("extract_next", extract)
    check(prev[1:] == ids_a[:CAPI_CALLS].tolist()
          and ok(capi.BM_bvector_count(x), "count")
          == ids_a.size - CAPI_CALLS, "extract_next")
    return a, b, bits


def capi_phase(tbm, device, n_blocks=N_BLOCKS):
    """Phase 12: the C-API facade on configs 1-2's A and B with the launch
    counts set to 0 just before and read just after.  Returns the phase's
    launches and (A, B, their bit arrays) for the utils phase."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    times = {}
    ck.reset_launches()
    t0 = time.perf_counter()
    state = capi_path(tbm, device, times, n_blocks)
    launches = dict(ck.launches)
    log(f"capi: configs 1-2 through the BM_* facade passed in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}; ms per "
        f"entry point {json.dumps(times)}")
    require_launches("capi phase", launches, FIRST_SLICE)
    return launches, state


def utils_path(tbm, device, a, b, bits, sv, vals, nm, times):
    """debug, timer and the file helpers on config 1's A and B and config
    4b's column, every printed number against numpy."""
    import glob
    import io
    import tempfile
    from bitmagic_tpu_torch import constants as C
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.serial.serializer import serialize
    from bitmagic_tpu_torch.serial.sv_serial import sparse_vector_serialize
    from bitmagic_tpu_torch.utils import debug, timer
    wa = image(bits["a"])
    blk = wa.reshape(-1, 2048)
    bc = np.bitwise_count(blk).sum(1, dtype=np.int64)

    # print_stat: one K3 launch for the dense rows' counts
    out = io.StringIO()
    before = dict(ck.launches)
    with Clock("print_stat_ms", times):
        debug.print_stat(a, out=out)
    n = {k: ck.launches[k] - before[k] for k in before}
    check(n["block_counts"] == 1 and sum(n.values()) == 1,
          f"print_stat launched K3 once and nothing else: {n}")
    lines = out.getvalue().splitlines()
    check(len(lines) == len(a._struct.nb), "print_stat: a line per block")
    kinds = set()
    for ln in lines:
        head, rest = ln.split(": ", 1)
        nb = int(head.split()[1])
        kind = rest.split()[0]
        kinds.add(kind)
        if kind == "FULL":
            check(bc[nb] == BPB, f"print_stat {ln}")
        else:
            got = int(rest.split("bc=")[1].split()[0])
            check(got == bc[nb], f"print_stat {ln}: numpy {bc[nb]}")
    check(kinds == {"BIT", "GAP", "FULL"} or kinds == {"BIT", "GAP"},
          f"print_stat block classes {kinds}")
    out = io.StringIO()
    debug.print_bvector_stat(a, out=out)
    st = a.calc_stat()
    check(out.getvalue().splitlines() == [
        f"size: {a.size}  count: {int(bc.sum())}",
        f"blocks: bit={st['bit_blocks']} full={st['full_blocks']} "
        f"zero={st['zero_blocks']} gap={st['gap_blocks']}",
        f"memory: {st['memory_used']} bytes "
        f"(max serialize {st['max_serialize_mem']})"], "print_bvector_stat")

    # print_svector_stat on config 4b's column
    out = io.StringIO()
    with Clock("print_svector_stat_ms", times):
        debug.print_svector_stat(sv, out=out)
    with Clock("plane_counts_numpy_ms", times):
        live = np.where(nm, np.uint32(0), vals)
        planes = [int(np.count_nonzero((live >> np.uint32(s))
                                       & np.uint32(1))) for s in range(32)]
    lines = out.getvalue().splitlines()
    check(lines[0] == f"size: {vals.size} dtype: uint32 planes: "
          f"{sum(p is not None for p in sv.planes)}/{sv.n_slices} "
          f"nullable: True", f"print_svector_stat {lines[0]}")
    check(lines[1:] == [f"  plane {s}: count={c}" for s, c in
                        enumerate(planes) if c], "print_svector_stat planes")

    # serialization sizes and the file round trips
    with Clock("compute_serialization_size_a_ms", times):
        n_a = debug.compute_serialization_size(a)
    check(n_a == len(serialize(a)), "compute_serialization_size(A)")
    with Clock("compute_serialization_size_sv_ms", times):
        n_sv = debug.compute_serialization_size(sv)
    check(n_sv == len(sparse_vector_serialize(sv)),
          "compute_serialization_size(config 4b)")
    with tempfile.TemporaryDirectory() as d:
        with Clock("save_load_bvector_ms", times):
            debug.save_bvector(os.path.join(d, "a.bv"), a)
            back = debug.load_bvector(os.path.join(d, "a.bv"), device=device)
        check(back.device.type == device.type
              and np.array_equal(back.to_words().ravel(), wa),
              "save_bvector / load_bvector")
        with Clock("save_load_svector_ms", times):
            debug.file_save_svector(os.path.join(d, "4b.sv"), sv)
            back = debug.file_load_svector(os.path.join(d, "4b.sv"),
                                           device=device)
        # plane by plane on the card (a full decode of 16M values takes
        # tens of seconds of host work: B9 in ROADMAP)
        with Clock("svector_planes_equal_ms", times):
            same = all((x is None) == (y is None)
                       and (x is None or x.equal(y)) for x, y in
                       zip(back.planes + [back.null_plane],
                           sv.planes + [sv.null_plane]))
        check(back.device.type == device.type and same,
              "file_save_svector / file_load_svector")
        del back

        # ChronoTaker around one config-1 AND: at least the device time
        # the events inside it bracket
        timer.reset_statistics()
        r = a & b
        sync()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        with timer.ChronoTaker("config1_and", track=a):
            s.record()
            r = a & b
            e.record()
        ct_ms = timer.statistics["config1_and"]["total_s"] * 1e3
        ev_ms = s.elapsed_time(e)
        times["chrono_taker_and_ms"] = round(ct_ms, 4)
        times["cuda_event_and_ms"] = round(ev_ms, 4)
        check(ct_ms >= ev_ms, f"ChronoTaker {ct_ms} ms < events {ev_ms} ms")
        check(np.array_equal(r.to_words().ravel(), wa & image(bits["b"])),
              "config-1 AND")
        timer.reset_statistics()

        # profiler_trace: a trace file that names a kernel of the port.
        # One run (torch 2.11, H100) wrote a trace with no kernel in it,
        # as the main phase's traces once did: trace again, up to
        # TRACE_TRIES times in all, when it names none, and log how often
        for retries in range(TRACE_TRIES):
            td = os.path.join(d, f"trace{retries}")
            with Clock("profiler_trace_ms", times), \
                    timer.profiler_trace(td):
                for _ in range(10):     # a short trace can lose lone events
                    (a & b).count()
                sync()
            files = glob.glob(os.path.join(td, "*.pt.trace.json"))
            check(len(files) == 1 and os.path.getsize(files[0]) > 0,
                  f"profiler_trace wrote {files}")
            with open(files[0]) as f:
                text = f.read()
            named = [k for k in ("binary_digest_kernel",
                                 "block_counts_kernel") if k in text]
            if named:
                break
        times["profiler_trace_bytes"] = os.path.getsize(files[0])
        check(named, "the trace names a kernel of the port")
        log(f"utils: profiler_trace wrote {os.path.basename(files[0])} "
            f"({times['profiler_trace_bytes']} bytes) naming {named}; "
            f"traces naming no kernel before this one: {retries}")


def utils_phase(tbm, device, a, b, bits, sv, vals, nm):
    """Phase 13: ``utils`` with the launch counts set to 0 just before and
    read just after.  Returns the phase's launches."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    times = {}
    ck.reset_launches()
    t0 = time.perf_counter()
    utils_path(tbm, device, a, b, bits, sv, vals, nm, times)
    launches = dict(ck.launches)
    log(f"utils: passed in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}; ms {json.dumps(times)}")
    require_launches("utils phase", launches,
                     ("logical_op_digest", "block_counts"))
    return launches


def _sample_lines(name, text, card):
    """A sample's printed lines, with the lines that may differ between
    the card and the CPU normalised (SAMPLE_MESH_LINE, SAMPLE_TIMED) and
    the card-only lines dropped."""
    import re
    out = []
    for ln in text.splitlines():
        if card and ln.startswith(SAMPLE_CARD_ONLY.get(name, "\0")):
            continue
        if name in SAMPLE_MESH_LINE and ln.startswith("mesh: "):
            ln = "mesh: <repr>"
        elif ln.startswith(SAMPLE_TIMED.get(name, ())):
            ln = re.sub(r"\d+\.\d ms;", "<ms>;", ln)
        out.append(ln)
    return out


def run_sample(tbm, path, device):
    """(stdout, wall s) of one port sample run in this process with
    ``config.device`` set to ``device``."""
    import contextlib
    import io
    import runpy
    old_dev, old_path = tbm.config.device, list(sys.path)
    buf = io.StringIO()
    tbm.config.device = device
    try:
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
        sync()
        return buf.getvalue(), time.perf_counter() - t0
    finally:
        tbm.config.device = old_dev
        sys.path[:] = old_path


def samples_phase(tbm, device, card, n_blocks=N_BLOCKS):
    """Phase 14: the 24 port samples in this process on the card, each with
    the launch counts set to 0 just before and read just after, its lines
    equal to the same sample's on the CPU; then B8 (the Bitap chain).
    Returns the launches of the 24 samples."""
    import glob
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    check(not os.environ.get("BMTPU_PLATFORM"),
          "BMTPU_PLATFORM would send the samples to the CPU")
    paths = sorted(glob.glob(os.path.join(SAMPLES_DIR, "[0-9]*.py")))
    check(len(paths) == 24, f"24 samples, found {len(paths)}")
    total = {k: 0 for k in KERNELS}
    per = {}
    t0 = time.perf_counter()
    for path in paths:
        name = os.path.basename(path)
        ck.reset_launches()
        text, wall = run_sample(tbm, path, "cuda")
        launches = {k: v for k, v in ck.launches.items() if v}
        for k, v in launches.items():
            total[k] += v
        check(text.strip(), f"sample {name} printed nothing")
        cpu_text, cpu_wall = run_sample(tbm, path, "cpu")
        check(_sample_lines(name, text, True)
              == _sample_lines(name, cpu_text, False),
              f"sample {name}: the card's lines differ from the CPU's")
        per[name] = {"s": round(wall, 3), "cpu_s": round(cpu_wall, 3),
                     "launches": launches}
        log(f"samples: {name} passed in {wall:.3f} s on the card "
            f"({cpu_wall:.3f} s on the CPU); launches {launches}")
    log(json.dumps({"samples": per, "card": card["smi"]}))
    log(f"samples: 24 samples passed in {time.perf_counter() - t0:.1f} s "
        f"(card and CPU runs); launches {total}")
    require_launches("samples phase", total, ("logical_op_digest",
                                              "block_counts", "agg_and_sub",
                                              "pipeline_counts"))
    b8 = bitap_timing(tbm, device, card, n_blocks)
    return total, b8


def bitap_oracle(codes, pat) -> np.ndarray:
    """End positions of ``pat`` (letter codes) in ``codes``, numpy."""
    n, m = codes.size, len(pat)
    hit = np.ones(n - m + 1, bool)
    for k, c in enumerate(pat):
        hit &= codes[k:n - m + 1 + k] == c
    return np.flatnonzero(hit) + (m - 1)


# B8's chains beside the DNA texts: operands over a block list with gaps,
# and one chain longer than a block's bits over a contiguous list
CHAIN_BLOCKS = (0, 1, 2, 4, 5, 8, 9, 10, 13)
CHAIN_SIZE = 15 * BPB
CHAIN_KS = (33, 34, 65)
LONG_CHAIN = 65538
# a chain whose shifts reach three blocks back (a row's windows span list
# blocks b - 3 .. b), and one whose first vector in the kernel's order
# zeroes every row (ZERO_CHAIN operands, half of them that vector)
WIDE_CHAIN = 2 * BPB + 3
ZERO_CHAIN = 40


def chain_holes(rng, n):
    """uint32[2048]: a block of ones with ``n`` holes of 1 to 40 bits."""
    bits = np.ones(BPB, bool)
    for p, w in zip(rng.integers(0, BPB, n), rng.integers(1, 41, n)):
        bits[p:p + w] = False
    return image(bits)


def gapped_chain(tbm, rng, k, device):
    """``k`` operand vectors of CHAIN_SIZE bits over CHAIN_BLOCKS (the
    list has gaps): each block the block's base row (ones with 40 holes)
    less 3 holes of its own, blocks 5 and 13 absent in one operand in ten,
    block 9 all ones in one in five; every third operand optimized (D-GAP
    and FULL blocks), the rest BIT rows."""
    base = {b: chain_holes(rng, 40) for b in CHAIN_BLOCKS}
    vecs = []
    for j in range(k):
        words = np.zeros((CHAIN_SIZE // BPB, 2048), np.uint32)
        for b in CHAIN_BLOCKS:
            if b in (5, 13) and rng.random() < 0.1:
                continue
            words[b] = (0xFFFFFFFF if b == 9 and rng.random() < 0.2
                        else base[b] & chain_holes(rng, 3))
        v = tbm.BitVector.from_words(words.ravel(), CHAIN_SIZE,
                                     device=device)
        if j % 3 == 0:
            v.optimize()
        vecs.append(v)
    return vecs


def long_chain(tbm, device):
    """LONG_CHAIN operands: three 3-block vectors repeated, ones but for
    holes at bit 0 and at the end of block 1 (and one more in two of
    them), so that block 1 keeps windows of 65538 clean bits; the chain
    takes a contiguous block list (agg/aggregator.py's long-chain
    route), and its shifts reach two blocks back."""
    vecs = []
    for extra in ((), (100,), (3 * BPB - 600,)):
        bits = np.ones(3 * BPB, bool)
        bits[[0, 2 * BPB - 1, *extra]] = False
        vecs.append(tbm.BitVector.from_words(image(bits), 3 * BPB,
                                             device=device))
    return [vecs[j % 3] for j in range(LONG_CHAIN)]


def wide_chain(tbm, device):
    """WIDE_CHAIN operands over three 5-block vectors repeated on a
    contiguous list (the long-chain route): each vector ones but for bit 0
    and one hole of its own in block 2, 3 or 4, so that the result keeps
    about a third of the bits past 131074; the second and third optimized
    (FULL and D-GAP blocks).  A row's deepest shifts read three blocks
    back, before the list for rows 0-2."""
    vecs = []
    for i, hole in enumerate((2 * BPB + 7, 3 * BPB + 100, 4 * BPB + 5000)):
        bits = np.ones(5 * BPB, bool)
        bits[[0, hole]] = False
        v = tbm.BitVector.from_words(image(bits), 5 * BPB, device=device)
        if i:
            v.optimize()
        vecs.append(v)
    return [vecs[j % 3] for j in range(WIDE_CHAIN)]


def zero_chain(tbm, rng, device):
    """ZERO_CHAIN operands over CHAIN_BLOCKS (a list with gaps): the first
    half one vector of alternating bits, so that its two adjacent shifts
    zero every row at the kernel's first segment (it has the most shifts),
    so that every CTA stops after its first copy; the rest three
    ``gapped_chain`` vectors."""
    words = np.zeros((CHAIN_SIZE // BPB, 2048), np.uint32)
    words[list(CHAIN_BLOCKS)] = 0x55555555
    alt = tbm.BitVector.from_words(words.ravel(), CHAIN_SIZE, device=device)
    rest = gapped_chain(tbm, rng, 3, device)
    half = ZERO_CHAIN // 2
    return [alt] * half + [rest[j % 3] for j in range(ZERO_CHAIN - half)]


def chain_words_oracle(images):
    """The Bitap chain in numpy, step by step over word images of one
    address space: acc = images[0], then acc = shift_up1(acc) & images[j]
    (the carry across words; bits past the end dropped)."""
    acc = images[0].copy()
    one = np.uint32(1)
    for img in images[1:]:
        carry = np.concatenate([np.zeros(1, np.uint32), acc[:-1] >> 31])
        acc = ((acc << one) | carry) & img
    return acc


def bitap_chains(tbm, device):
    """(name, operand vectors, numpy Bitap words) of the chains of
    CHAIN_KS operands over a block list with gaps, of LONG_CHAIN and
    WIDE_CHAIN over a contiguous one, and of ZERO_CHAIN whose first
    vector zeroes every row."""
    rng = np.random.default_rng(SEED + 43)
    out = []
    for k in CHAIN_KS:
        vecs = gapped_chain(tbm, rng, k, device)
        out.append((f"k{k}_gaps", vecs, chain_words_oracle(
            [v.to_words().ravel() for v in vecs])))
    for k, vecs in ((LONG_CHAIN, long_chain(tbm, device)),
                    (WIDE_CHAIN, wide_chain(tbm, device))):
        images = {id(v): v.to_words().ravel() for v in vecs[:3]}
        out.append((f"k{k}_contiguous", vecs, chain_words_oracle(
            [images[id(v)] for v in vecs])))
    vecs = zero_chain(tbm, rng, device)
    out.append((f"k{ZERO_CHAIN}_first_zero", vecs, chain_words_oracle(
        [v.to_words().ravel() for v in vecs])))
    return out


def sample06_case(tbm, device):
    """samples/06's occurrence vectors of "ACGG" and the numpy Bitap's
    ends."""
    text = "ACGTACGTTTACGGACGTACGT" * 1000
    codes = np.frombuffer(text.encode(), np.uint8)
    occ = {c: tbm.BitVector.from_indices(
        np.flatnonzero(codes == ord(c)), len(text) + 1, device=device)
        for c in "ACGT"}
    return ([occ[c] for c in "ACGG"],
            bitap_oracle(codes, [ord(c) for c in "ACGG"]))


def chain_args(tbm, vecs):
    """``(first_mask, descs)``, the arguments combine_shift_right_and
    hands kernel B8 for ``vecs`` (its one chain), and its result."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    real, seen = ck.shift_and_chain, []

    def keep(first_mask, descs):
        seen.append((first_mask, descs))
        return real(first_mask, descs)
    ck.shift_and_chain = keep
    try:
        res = tbm.Aggregator().combine_shift_right_and(vecs)
    finally:
        ck.shift_and_chain = real
    check(len(seen) == 1, "combine_shift_right_and runs one chain")
    return seen[0], res


def bitap_kernel_cases(tbm, device):
    """(name, (first_mask, descs)) of B8 at samples/06's shape and over
    ``bitap_chains`` (the card test's cases)."""
    cases = [("sample06_ACGG", sample06_case(tbm, device)[0])]
    cases += [(name, vecs) for name, vecs, _ in bitap_chains(tbm, device)]
    return [(name, chain_args(tbm, vecs)[0]) for name, vecs in cases]


def b8_sources(desc, n):
    """Where each of the n blocks of one B8 descriptor ``(pool, slot,
    full, aux, aux_slot)`` reads its row: ``(tensor address, row)``
    int64[n] each, the address -1 where no row is read (a FULL or absent
    block)."""
    pool, slot, full, aux, aux_slot = desc
    row = (np.arange(n) if slot is None
           else slot.cpu().numpy().astype(np.int64))
    on = (row >= 0) & (pool.shape[0] > 0)
    if full is not None:
        on &= ~full.cpu().numpy().astype(bool)
    ptr = np.where(on, pool.data_ptr(), -1)
    if aux is not None and aux.shape[0]:
        a = aux_slot.cpu().numpy().astype(np.int64)
        ptr = np.where(a >= 0, aux.data_ptr(), ptr)
        row = np.where(a >= 0, a, row)
    return ptr, row


def b8_bytes(first_mask, descs):
    """The bytes kernel B8 moves: ``(every distinct operand row read once
    and the result written once, the same at its early exit)``.
    Operands that repeat a vector (a pattern's repeated letter) share
    their rows, so a row counts once however many operands read it.  The
    exit is replayed in numpy in the kernel's own order
    (``blockops.chain_groups`` / ``chain_segments``): a row's CTA needs a
    segment's window (shift_chain.cu's ``window``) while its AND is not
    zero, up to and including the segment that zeroes it; each 16-byte
    vector of an operand row counts once however many windows need it,
    FULL, absent and before-the-run blocks not at all."""
    from bitmagic_tpu_torch.ops import blockops
    n = first_mask.shape[0]
    vecs, offs, shifts = blockops.chain_groups(descs)
    segs = blockops.chain_segments(offs, shifts)[0]
    fm = first_mask.cpu().numpy()
    start = (fm & 1) == 0
    start[0] = True
    blk = np.arange(n)
    run = np.maximum.accumulate(np.where(start, blk, 0))
    lo = np.repeat(run * 2048, 2048)
    x = np.arange(n * 2048)
    acc = np.full(n * 2048, 0xFFFFFFFF, np.uint64)
    alive = np.ones(n, bool)
    srcs = [b8_sources(d, n)[0] for d in vecs]
    words = {}
    need = np.zeros((len(vecs), n, 512), bool)
    for v, qa, nq, _ in segs.tolist():
        ws = -((qa + nq + 3) // 4 * 4)
        we = 2048 - qa // 4 * 4
        o = ws // 2048
        split = (o + 1) * 2048
        for off, w0, w1 in ((o, ws - o * 2048, min(we, split) - o * 2048),
                            (o + 1, 0, we - split)):
            if w1 <= w0:
                continue
            p = blk + off
            p = p[alive & (p >= run)]
            need[v, p[srcs[v][p] >= 0], w0 // 4:w1 // 4] = True
        if v not in words:
            words[v] = blockops.to_host_words(blockops.gather_rows(
                *vecs[v])).ravel().astype(np.uint64)
        w = words[v]

        def src(y):
            return np.where(y >= lo, w[np.maximum(y, 0)], 0)
        s = shifts[offs[v]:offs[v + 1]]
        for q in range(qa, qa + nq):
            rs = s[(s >> 5) == q] & 31
            if rs.size == 0:
                continue
            pair = (src(x - q) << np.uint64(32)) | src(x - q - 1)
            for r in rs.tolist():
                acc &= (pair >> np.uint64(32 - r)) & np.uint64(0xFFFFFFFF)
        alive &= (acc.reshape(n, 2048) != 0).any(axis=1)
    every = np.concatenate([np.stack(b8_sources(d, n)) for d in vecs], 1)
    every = every[:, every[0] >= 0]
    distinct = np.unique(every, axis=1).shape[1]
    return (distinct + n) * 8192, int(need.sum()) * 16 + n * 8192


def protein_case(tbm, device, n_blocks=N_BLOCKS):
    """B8's low-reuse shape at config-1 width: a seeded text of n_blocks x
    65536 symbols over PROTEIN_LETTERS letters and a PROTEIN_PATTERN-letter
    pattern drawn from it -> (operand vectors, numpy Bitap ends)."""
    rng = np.random.default_rng(SEED + 44)
    n = n_blocks * BPB
    codes = rng.integers(0, PROTEIN_LETTERS, n).astype(np.uint8)
    p = int(rng.integers(0, n - PROTEIN_PATTERN))
    pat = codes[p:p + PROTEIN_PATTERN]
    occ = {int(c): tbm.BitVector.from_words(image(codes == c), n,
                                            device=device)
           for c in np.unique(pat)}
    return [occ[int(c)] for c in pat], bitap_oracle(codes, pat)


def b8_launcher(device, fm, descs):
    """A launch of kernel B8 through its C interface on the arguments
    ``combine_shift_right_and`` handed it (``fm``, ``descs``), its host
    plan made once: ``(launch, result rows)``."""
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    nb = fm.shape[0]
    buf, args = ck._chain_plan(descs, nb, device)
    res = torch.empty((nb, 2048), dtype=torch.int32, device=device)

    def launch(buf=buf, descs=descs):
        ck._launch("bm_shift_and_chain", "shift_and_chain", device, *args,
                   ck._ptr(fm), nb, ck._ptr(res))
    return launch, res


def bitap_timing(tbm, device, card, n_blocks=N_BLOCKS):
    """B8: ``combine_shift_right_and`` (one shift_and_chain launch a call)
    at samples/06's shape, at config-1 width (4 occurrence vectors of a
    seeded 100.7M-base text, 1536 blocks each, BITAP_PATTERNS letters; and
    ``protein_case``'s 20-letter text) and over ``bitap_chains``: each
    result against a numpy Bitap, the kernel against its plain version bit
    for bit on the arguments the call hands it; host wall ms, device busy
    ms and launches per call.  The kernel at B8_SHAPES through its C
    interface (L2 dirty and clean) beside its bound: the bytes it must
    move, the smaller of every distinct operand row read once with the
    result written once and the bytes its early exit leaves
    (``b8_bytes``), each also reported alone.  ->
    (launches of the calls, each counted from 0, {(kernel, shape):
    timing}, (cases held against the plain version, their max abs
    err))."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    agg = tbm.Aggregator()
    rng = np.random.default_rng(SEED + 41)
    n = n_blocks * BPB
    codes = rng.integers(0, 4, n).astype(np.uint8)
    occ = [tbm.BitVector.from_words(image(codes == c), n, device=device)
           for c in range(4)]
    cases = [("sample06_ACGG", *sample06_case(tbm, device), None)]
    for m in BITAP_PATTERNS:
        p = int(rng.integers(0, n - m))
        pat = codes[p:p + m]
        cases.append((f"config1_{m}", [occ[c] for c in pat],
                      bitap_oracle(codes, pat), None))
    cases.append((f"protein_{PROTEIN_PATTERN}",
                  *protein_case(tbm, device, n_blocks), None))
    cases += [(name, vecs, None, words)
              for name, vecs, words in bitap_chains(tbm, device)]
    launches = {k: 0 for k in KERNELS}
    args, plain_rows = {}, {}
    err = 0
    for what, vecs, want, words in cases:
        ck.reset_launches()
        t0 = time.perf_counter()
        res = agg.combine_shift_right_and(vecs)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        counted = {k: v for k, v in ck.launches.items() if v}
        for k, v in counted.items():
            launches[k] += v
        check(counted.get("shift_and_chain") == 1,
              f"B8 {what}: one shift_and_chain launch a call, counted "
              f"{counted}")
        if want is not None:
            check(np.array_equal(res.indices(), want),
                  f"B8 {what}: Bitap ends against numpy")
        else:
            check(np.array_equal(res.to_words().ravel(), words),
                  f"B8 {what}: Bitap words against numpy")
        (fm, descs), _ = chain_args(tbm, vecs)
        got = ck.shift_and_chain(fm, descs)
        sync()
        plain = blockops.shift_and_chain(fm, descs)
        err = max(err, int((got.to(torch.int64) - plain.to(torch.int64))
                           .abs().max()))
        check(torch.equal(got, plain), f"B8 {what}: kernel = plain version")
        args[what] = (fm, descs)
        plain_rows[what] = plain
        line = {"b8": what, "operands": len(vecs),
                "distinct": len({id(v) for v in vecs}),
                "blocks": int(fm.shape[0]), "hit_bits": int(
                    want.size if want is not None
                    else np.bitwise_count(words).sum()),
                "first_call_wall_ms": round(first_ms, 3),
                "counted_launches": counted, "card": card["smi"]}
        if len(vecs) < LONG_CHAIN:
            wall, busy, top = device_busy(
                lambda: agg.combine_shift_right_and(vecs))
            kernels = device_kernels(lambda: agg.combine_shift_right_and(
                vecs))
            line.update(host_wall_ms=round(wall, 3),
                        device_busy_ms=round(busy, 4),
                        device_kernels_per_call=len(kernels),
                        device_ms_by_kernel=top)
        log(json.dumps(line))
    out = {}
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    clean = torch.empty_like(flush)
    for shape in B8_SHAPES:
        fm, descs = args[shape]
        launch, rows = b8_launcher(device, fm, descs)
        launch()
        sync()
        check(torch.equal(rows, plain_rows[shape]),
              f"B8 {shape}: the timed launch = plain version")
        row_bytes, exit_bytes = b8_bytes(fm, descs)
        for name, c in ((shape, None), (f"{shape}_clean_l2", clean)):
            record(out, ("shift_and_chain", name), card, flush, launch,
                   lambda fm=fm, descs=descs: blockops.shift_and_chain(
                       fm, descs), None, min(row_bytes, exit_bytes), 0, 0,
                   clean=c)
            t = out["shift_and_chain", name]
            t.update(operands=len(descs), blocks=int(fm.shape[0]),
                     distinct=len({id(d) for d in descs}),
                     distinct_row_bytes=row_bytes,
                     distinct_row_bound_ms=row_bytes / card["peak_bw"]
                     * 1e3,
                     exit_bytes=exit_bytes,
                     exit_bound_ms=exit_bytes / card["peak_bw"] * 1e3)
            log(json.dumps({"kernel": "shift_and_chain", "shape": name,
                            **t, "card": card["smi"]}))
    return launches, out, (len(cases), err)


# ---------------------------------------------------------------------------
# phases 15-16: the port's tools (tools_torch/) and the container fuzzer
# ---------------------------------------------------------------------------
SVUTIL_HEAD = 1 << 22           # svutil's decode legs: the first 2^22 values
SVUTIL_DEMO_N = 100_000         # svutil --demo's size
RANGES = 1_000_000              # range_idx: ranges of 10-89 positions ...
RANGE_SPACE = 3_100_000_000     # ... over a genome-sized coordinate space
RANGE_QUERIES = 100_000         # further point queries, half outside
LNK_SOURCES, LNK_LINKS = 2048, 512      # lnkutil: ~1M links over 2^22 ids
INV_LISTS_CPU = 8               # inv_list lists compared with a CPU run
FUZZ_SEEDS = (0, 1, 2)          # every family at each of these seeds
FUZZ_RANDOM = ("24", "1000")    # then --trials, --seed in random order
FUZZ_CORRUPT = ("40", "100")    # then corrupt BLOBs: --trials, --seed


def run_tool(tbm, name, argv, device):
    """(stdout, wall s, launches) of ``tools_torch/<name>.main(argv)`` run
    in this process with ``config.device`` set to ``device``; the launch
    counts are set to 0 just before and read just after."""
    import contextlib
    import importlib
    import io
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    mod = importlib.import_module(f"tools_torch.{name}")
    old = tbm.config.device
    buf = io.StringIO()
    tbm.config.device = device
    try:
        sync()
        ck.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ck.launches.items() if v}
    finally:
        tbm.config.device = old
    check(rc == 0, f"{name} {argv}: exit code {rc}")
    return buf.getvalue(), wall, launches


class ToolLegs:
    """Seconds and launches of each tool leg, summed per tool and over the
    phase (``phase`` prefixes the log lines)."""

    def __init__(self, phase="tools"):
        self.phase = phase
        self.legs, self.total = {}, {k: 0 for k in KERNELS}

    def run(self, tbm, leg, name, argv):
        text, wall, launches = run_tool(tbm, name, argv, "cuda")
        for k, v in launches.items():
            self.total[k] += v
        self.legs[leg] = {"s": round(wall, 3), "launches": launches}
        log(f"{self.phase}: {leg}: {wall:.3f} s; launches {launches}")
        for ln in text.splitlines():
            log(f"{self.phase}:   | {ln}")
        return text, wall


def tools_svutil(tbm, legs, tmp):
    """svutil over config 4b's live values (16M, < 2^20, NULLs as 0) to an
    sv and an RSC BLOB; both decoded back from the first SVUTIL_HEAD
    values' BLOBs to the same bytes; at the demo's size the BLOBs equal
    the CPU's."""
    from tools_torch import normalised
    from bitmagic_tpu_torch.serial.sv_serial import sparse_vector_deserialize
    p = lambda f: os.path.join(tmp, f)                     # noqa: E731
    _, vals, nm = config4b_values()
    live = np.where(nm, np.uint32(0), vals)
    live.astype("<u4").tofile(p("4b.u32"))
    text, wall = legs.run(tbm, "svutil -u32in 16M -svout -rscout", "svutil", [
        "-u32in", p("4b.u32"), "-svout", p("4b.sv"), "-rscout", p("4b.rsc"),
        "-diag", "-timing"])
    legs.legs["svutil -u32in 16M -svout -rscout"]["mb_per_s"] = round(
        live.nbytes / 1e6 / wall, 3)
    lines = normalised(text)
    check(lines[0] == f"import: <s> ({live.size} values)"
          and lines[1].startswith(f"size={live.size} nonzero="
                                  f"{int((live != 0).sum())} memory_used="),
          "svutil: the import and size lines")
    check(lines[2].startswith(f"sv BLOB: {os.path.getsize(p('4b.sv'))} "
                              "bytes") and lines[3] ==
          f"rsc BLOB: {os.path.getsize(p('4b.rsc'))} bytes",
          "svutil: the BLOB sizes printed are the files'")
    want = tbm.SparseVector.from_array(live, nullable=True,
                                       null_mask=live == 0)
    with open(p("4b.sv"), "rb") as f:
        same_container(sparse_vector_deserialize(f.read()), want,
                       "svutil: the 16M sv BLOB decodes to the column")
    with open(p("4b.rsc"), "rb") as f:
        same_container(sparse_vector_deserialize(f.read()),
                       tbm.RSCSparseVector.from_sparse_vector(want),
                       "svutil: the 16M RSC BLOB decodes to the column")
    del want
    head = live[:SVUTIL_HEAD]
    head.astype("<u4").tofile(p("head.u32"))
    legs.run(tbm, "svutil -u32in 2^22 -svout -rscout", "svutil", [
        "-u32in", p("head.u32"), "-svout", p("head.sv"), "-rscout",
        p("head.rsc")])
    for flag, ext in (("-svin", "sv"), ("-rscin", "rsc")):
        legs.run(tbm, f"svutil {flag} 2^22 -u32out", "svutil", [
            flag, p(f"head.{ext}"), "-u32out", p(f"back_{ext}.u32")])
        with open(p(f"back_{ext}.u32"), "rb") as f, \
                open(p("head.u32"), "rb") as g:
            check(f.read() == g.read(),
                  f"svutil {flag}: the u32 file equals the input")
    # the demo's size: the card's BLOBs and lines equal the CPU's
    rng = np.random.default_rng(1)
    demo = rng.integers(0, 1 << 16, SVUTIL_DEMO_N).astype(np.uint32)
    demo[rng.random(demo.size) < 0.5] = 0
    demo.astype("<u4").tofile(p("demo.u32"))
    out = {}
    for dev in ("cuda", "cpu"):
        argv = ["-u32in", p("demo.u32"), "-svout", p(f"demo_{dev}.sv"),
                "-rscout", p(f"demo_{dev}.rsc"), "-diag"]
        if dev == "cuda":
            out[dev] = legs.run(tbm, "svutil 100k (demo size)", "svutil",
                                argv)[0]
        else:
            out[dev] = run_tool(tbm, "svutil", argv, "cpu")[0]
    check(out["cuda"] == out["cpu"], "svutil at the demo's size: the "
          "card's lines differ from the CPU's")
    for ext in ("sv", "rsc"):
        with open(p(f"demo_cuda.{ext}"), "rb") as f, \
                open(p(f"demo_cpu.{ext}"), "rb") as g:
            check(f.read() == g.read(), f"svutil at the demo's size: the "
                  f"card's {ext} BLOB differs from the CPU's")


def tools_range_idx(tbm, legs, tmp):
    """range_idx over RANGES genome-sized ranges: the tool's own 2000-query
    self-check, the payload BLOB, then RANGE_QUERIES point queries (half
    outside every range) through the index the tool built, against
    numpy."""
    from tools_torch import normalised
    from tools_torch import range_idx
    from bitmagic_tpu_torch.serial.sv_serial import sparse_vector_deserialize
    rng = np.random.default_rng(SEED + 51)
    starts = np.sort(rng.choice(RANGE_SPACE // 100, RANGES,
                                replace=False)) * 100      # range_idx.py:75
    ends = starts + rng.integers(10, 90, RANGES)
    payloads = rng.integers(1, 1 << 20, RANGES)
    tab = os.path.join(tmp, "ranges.tab")
    order = rng.permutation(RANGES)                       # unsorted rows
    np.savetxt(tab, np.stack([starts, ends, payloads], 1)[order], fmt="%d",
               delimiter="\t")
    pfile = os.path.join(tmp, "payload.sv")
    built = []                          # the index the tool builds

    class Recorded(range_idx.RangeIndex):
        def __init__(self, *args):
            super().__init__(*args)
            built.append(self)

    range_idx.RangeIndex = Recorded
    try:
        text, _ = legs.run(tbm, "range_idx -i 1M ranges -t -svout",
                           "range_idx", ["-i", tab, "-t", "-svout", pfile])
    finally:
        range_idx.RangeIndex = Recorded.__base__
    check(len(built) == 1, "range_idx built one index")
    idx = built[0]
    check(normalised(text)[2] == "2000 point queries OK (<ms> ms/1k)",
          "range_idx: the tool's self-check")
    with open(pfile, "rb") as f:
        back = sparse_vector_deserialize(f.read())
    check(back.size == RANGES and np.array_equal(
        back.gather(np.arange(RANGES)), payloads.astype(np.uint32)),
        "range_idx: the payload BLOB holds the payloads in start order")
    # the last range is left out: a point past it lies past the index
    k = rng.integers(0, RANGES - 1, RANGE_QUERIES)
    inside = rng.random(RANGE_QUERIES) < 0.5
    off = np.where(inside, rng.integers(0, 1 << 30, RANGE_QUERIES)
                   % (ends[k] - starts[k] + 1),
                   ends[k] - starts[k] + 1 + rng.integers(
                       0, 1 << 30, RANGE_QUERIES) % (
                       starts[k] + 100 - ends[k] - 1))
    pts = starts[k] + off
    t0 = time.perf_counter()
    got = idx.query_batch(pts)
    q_s = time.perf_counter() - t0
    j = np.searchsorted(starts, pts, side="right") - 1
    hit = (j >= 0) & (pts <= ends[np.maximum(j, 0)])
    check(np.array_equal(hit, inside), "range_idx: the oracle's hits")
    want = [int(payloads[i]) if h else None for i, h in zip(j, hit)]
    check(got == want, f"range_idx: {RANGE_QUERIES} point queries against "
          f"numpy")
    legs.legs["range_idx checks"] = {
        "index_build_line": text.splitlines()[0], "queries": RANGE_QUERIES,
        "ms_per_1k": round(q_s * 1e6 / RANGE_QUERIES, 3),
        "cover_blocks": int(idx.cover._struct.nb.size)}
    log(f"tools: range_idx: {RANGE_QUERIES} point queries against numpy "
        f"({int(inside.sum())} inside a range) in {q_s:.3f} s; "
        f"{legs.legs['range_idx checks']}")


def tools_lnkutil(tbm, legs, tmp):
    """lnkutil over LNK_SOURCES x LNK_LINKS links (half of the targets are
    sources): build and save the matrix, load it and run the 2-hop
    benchmark; every loaded row equals its built row and the 2-hop
    neighborhood equals a numpy BFS."""
    from tools_torch import normalised
    from tools_torch import lnkutil
    rng = np.random.default_rng(SEED + 52)
    src = rng.choice(lnkutil.N_NODES, LNK_SOURCES, replace=False)
    frm = np.repeat(src, LNK_LINKS)
    to = np.where(rng.random(frm.size) < 0.5, rng.choice(src, frm.size),
                  rng.integers(0, lnkutil.N_NODES, frm.size))
    pairs = np.stack([frm, to], 1)
    tab, mfile = os.path.join(tmp, "links.tab"), os.path.join(tmp, "m.lm")
    np.savetxt(tab, pairs, fmt="%d", delimiter="\t")
    _, wall = legs.run(tbm, "lnkutil -lin 1M links -lmout", "lnkutil",
                       ["-lin", tab, "-lmout", mfile])
    text, _ = legs.run(tbm, "lnkutil -lmin -bench", "lnkutil",
                       ["-lmin", mfile, "-bench"])
    t0 = time.perf_counter()
    built = lnkutil.build_matrix(pairs)
    sync()
    build_s = time.perf_counter() - t0
    loaded = lnkutil.load_matrix(mfile)
    check(sorted(built) == sorted(loaded) == sorted(int(s) for s in src),
          "lnkutil: the matrix's row keys")
    for key in built:
        check(built[key].equal(loaded[key]), f"lnkutil: row {key} loaded "
              f"from the file equals its built row")
    by_src = np.argsort(frm, kind="stable")
    cut = np.flatnonzero(np.diff(frm[by_src])) + 1
    adj = {int(frm[i[0]]): np.unique(to[i]) for i in np.split(by_src, cut)}
    seed = min(adj)
    visited = {seed}
    frontier = [seed]
    for _ in range(2):
        nxt = set()
        for f in frontier:
            nxt.update(adj.get(f, np.empty(0, np.int64)).tolist())
        frontier = sorted(nxt - visited)
        visited |= nxt
    hood = lnkutil.neighborhood(loaded, seed, 2)
    check(np.array_equal(hood.indices(), np.asarray(sorted(visited))),
          "lnkutil: the 2-hop neighborhood against a numpy BFS")
    check(f"2-hop neighborhood of {seed}: {len(visited)} nodes in <ms>"
          in normalised(text), "lnkutil: the bench line")
    legs.legs["lnkutil checks"] = {
        "build_s_per_1000_rows": round(build_s * 1000 / len(built), 3),
        "tool_leg_s_per_1000_rows": round(wall * 1000 / len(built), 3),
        "two_hop_nodes": len(visited)}
    log(f"tools: lnkutil: {len(built)} rows equal after the file round "
        f"trip; {legs.legs['lnkutil checks']}")


def tools_inv_list(tbm, legs, tmp):
    """inv_list over its own synthetic corpus (seed 42, 40 lists) written
    as a Gov2-style flat file: BMT1 at levels 0, 4, 6 on every list, the
    reference's format at level 6 on INV_LISTS_CPU lists; on those lists
    the bytes/int and bits/int columns equal a CPU run's."""
    from tools_torch import normalised
    from tools_torch import inv_list
    flat = os.path.join(tmp, "gov2.bin")
    n_ints = 0
    with open(flat, "wb") as f:
        for ids in inv_list.synthetic(np.random.default_rng(42), 40):
            f.write(np.uint32(ids.size).tobytes())
            f.write(ids.astype("<u4").tobytes())
            n_ints += int(ids.size)
    text, _ = legs.run(tbm, "inv_list BMT1 0,4,6 (40 lists)", "inv_list",
                       ["--file", flat, "--format", "bmt1", "--levels",
                        "0,4,6"])
    check(text.splitlines()[0] == f"# 40 lists, {n_ints} ints total",
          "inv_list: the corpus line")
    short = ["--max-lists", str(INV_LISTS_CPU)]
    for fmt, levels in (("ref", "6"), ("bmt1", "0,4,6")):
        argv = ["--file", flat, "--format", fmt, "--levels", levels] + short
        card = legs.run(tbm, f"inv_list {fmt} {levels} ({INV_LISTS_CPU} "
                        f"lists)", "inv_list", argv)[0]
        cpu = run_tool(tbm, "inv_list", argv, "cpu")[0]
        check(normalised(card) == normalised(cpu),
              f"inv_list {fmt}: the card's columns differ from the CPU's")


def tools_phase(tbm, card):
    """Phase 15: the four BLOB tools of tools_torch/ in this process on the
    card, each leg with the launch counts set to 0 just before and read
    just after.  Returns the phase's launches summed over the legs."""
    import tempfile
    check(not os.environ.get("BMTPU_PLATFORM"),
          "BMTPU_PLATFORM would send the tools to the CPU")
    legs = ToolLegs()
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="bmtools_") as tmp:
        for name, fn in (("svutil", tools_svutil),
                         ("range_idx", tools_range_idx),
                         ("lnkutil", tools_lnkutil),
                         ("inv_list", tools_inv_list)):
            t0 = time.perf_counter()
            fn(tbm, legs, tmp)
            seconds[name] = round(time.perf_counter() - t0, 3)
            log(f"tools: {name} passed in {seconds[name]} s (legs and "
                f"checks)")
    log(json.dumps({"tools": legs.legs, "tool_s": seconds,
                    "card": card["smi"]}))
    log(f"tools: passed in {sum(seconds.values()):.1f} s; launches "
        f"{legs.total}")
    require_launches("tools phase", legs.total,
                     ("logical_op_digest", "block_counts", "agg_and_sub"))
    return legs.total


def fuzz_phase(tbm, card):
    """Phase 16: tools_torch/fuzz_containers.py in this process on
    Mesh([cuda:0] * 8): every family at FUZZ_SEEDS, then FUZZ_RANDOM
    trials in the random family order.  A failed trial prints its FAIL
    line and exits (the SystemExit ends this script).  Returns the phase's
    launches."""
    from tools_torch import fuzz_containers as fz
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    check(not os.environ.get("BMTPU_PLATFORM"),
          "BMTPU_PLATFORM would send the fuzzer to the CPU")
    total = {k: 0 for k in KERNELS}
    per = {}
    runs = [(f.__name__.removeprefix("trial_"),
             ["--family", f.__name__.removeprefix("trial_"), "--seed",
              str(s), "--trials", "1"]) for f in fz.TRIALS
            for s in FUZZ_SEEDS]
    runs.append((f"random {FUZZ_RANDOM[0]} from seed {FUZZ_RANDOM[1]}",
                 ["--trials", FUZZ_RANDOM[0], "--seed", FUZZ_RANDOM[1]]))
    runs.append(("corrupt", ["--family", "corrupt", "--seed",
                             FUZZ_CORRUPT[1], "--trials", FUZZ_CORRUPT[0]]))
    fz.REJECTIONS.clear()
    t0 = time.perf_counter()
    for name, argv in runs:
        sync()
        ck.reset_launches()
        t1 = time.perf_counter()
        check(fz.main(argv) == 0, f"fuzz {argv}")
        sync()
        wall = time.perf_counter() - t1
        entry = per.setdefault(name, {"s": 0.0, "trials": 0, "launches": {}})
        entry["s"] = round(entry["s"] + wall, 3)
        entry["trials"] += int(argv[argv.index("--trials") + 1])
        for k, v in ck.launches.items():
            total[k] += v
            if v:
                entry["launches"][k] = entry["launches"].get(k, 0) + v
    log(json.dumps({"fuzz": per, "card": card["smi"]}))
    # a corrupt BLOB is either decoded to a consistent vector or rejected
    # with an exception that is no fault of the card (those propagate)
    for seed, t, cls, msg in fz.REJECTIONS:
        log(f"fuzz: corrupt seed {seed} trial {t}: rejected with {cls}: "
            f"{msg}")
    n_corrupt = per["corrupt"]["trials"]
    log(f"fuzz: trial_corrupt ran {n_corrupt} times by family (more in the "
        f"random run); {len(fz.REJECTIONS)} BLOBs rejected, by class "
        f"{json.dumps(dict(collections.Counter(r[2] for r in fz.REJECTIONS)))}")
    log(f"fuzz: {sum(e['trials'] for e in per.values())} trials passed in "
        f"{time.perf_counter() - t0:.1f} s; launches {total}")
    require_launches("fuzz phase", total, ("logical_op_digest",
                                           "block_counts", "agg_and_sub",
                                           "pipeline_counts"))
    return total


# ---------------------------------------------------------------------------
# phases 17-18: the benchmarking tools, and sharding across processes
# ---------------------------------------------------------------------------
TPCH_SF1, TPCH_SF100 = 150_000, 15_000_000      # TPC-H customers
MICRO_LABELS = ("stream", "count", "and", "or", "xor", "sub", "and_cnt",
                "or_cnt", "enum", "select", "rank", "sv_gath", "sv_dec",
                "scan_eq", "scan_gt", "agg", "ser_L1", "ser_L4", "ser_L6",
                "deser_L6")
MH_PROCESSES, MH_LOCAL = 2, 4     # multihost: 2 processes x 4 shards
MH_TIMEOUT_S = 900


def tpch_oracle(customers, nations=200, top=10):
    """bench_tpch's result orders, from its own draws."""
    nation_of = np.random.default_rng(9).integers(0, nations, customers)
    return int(np.isin(nation_of, range(top)).sum()) * 5


def bench_tools_phase(tbm, card):
    """Phase 17: bench_tpch at TPC-H SF1's and SF100's customer counts,
    microbench's nine families at 768 blocks and scaling_check, in this
    process on the card; each with its seconds and launches.  Returns the
    phase's launches."""
    import re
    check(not os.environ.get("BMTPU_PLATFORM"),
          "BMTPU_PLATFORM would send the tools to the CPU")
    legs = ToolLegs("bench_tools")
    tpch = {}
    for tag, customers in (("sf1", TPCH_SF1), ("sf100", TPCH_SF100)):
        text, _ = legs.run(tbm, f"bench_tpch {tag}", "bench_tpch",
                           ["--customers", str(customers), "--json"])
        tpch[tag] = json.loads(text.strip().splitlines()[-1])
        check(tpch[tag]["result_orders"] == tpch_oracle(customers),
              f"bench_tpch {tag}: {tpch[tag]['result_orders']} orders")
    # the BLOBs do not depend on the device: SF1's index on the CPU
    cpu, _, _ = run_tool(tbm, "bench_tpch", ["--json"], "cpu")
    cpu = json.loads(cpu.strip().splitlines()[-1])
    check(cpu["index_bytes"] == tpch["sf1"]["index_bytes"],
          f"bench_tpch sf1 index bytes {tpch['sf1']['index_bytes']} on the "
          f"card, {cpu['index_bytes']} on the CPU")
    text, _ = legs.run(tbm, "microbench", "microbench", [])
    labels = tuple(re.findall(r"^\[(\w+) *\]", text, re.M))
    check(labels == MICRO_LABELS, f"microbench families {labels}")
    check(len(re.findall(r"^ +blob \d+\.\d KB$", text, re.M)) == 3,
          "microbench BLOB lines")
    text, _ = legs.run(tbm, "scaling_check", "scaling_check", [])
    rows = re.findall(r"^mesh=(\d+): .*; launches per step: scan (\d+) B6 "
                      r"\+ (\d+) K3, pipeline (\d+) B5$", text, re.M)
    check([int(r[0]) for r in rows] == [1, 2, 4, 8],
          f"scaling_check meshes {rows}")
    for r in rows:
        check(len(set(r)) == 1, f"scaling_check: mesh={r[0]} launched "
              f"{r[1]} B6, {r[2]} K3 and {r[3]} B5 per step, not one each "
              f"per shard")
    log(json.dumps({"bench_tools": legs.legs, "bench_tpch": tpch,
                    "card": card["smi"]}))
    require_launches("bench_tools phase", legs.total,
                     ("logical_op_digest", "count_op", "block_counts",
                      "agg_and_sub", "pipeline_counts", "scan_eq"))
    return legs.total


def _digest_of(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


class Steps:
    """Launches and host wall ms of each step of a sharded run, read
    around the step (which ends in a synchronize)."""

    def __init__(self):
        self.launches, self.ms = {}, {}

    def __call__(self, name, fn):
        from bitmagic_tpu_torch.ops import cuda_kernels as ck
        sync()
        before = dict(ck.launches)
        t0 = time.perf_counter()
        out = fn()
        sync()
        self.ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        self.launches[name] = {k: v - before[k] for k, v in
                               ck.launches.items() if v > before[k]}
        return out


def multihost_scale(tbm, mesh):
    """The sharded phase's work over ``mesh`` (one process or many): two
    2^30-bit vectors through the four ops and counts, 1M select and rank,
    and config 4b's 16M-element column through find_gt, find_eq_count and
    pipeline_find_eq; every answer against numpy.  Returns (results,
    launches per step, ms per step)."""
    from bitmagic_tpu_torch.parallel import (ShardedBitVector,
                                             ShardedSparseVector)
    step = Steps()
    rng = np.random.default_rng(SEED + 31)
    size = SHARD_BLOCKS * BPB
    wa, wb = _block_words(rng, SHARD_BLOCKS), _block_words(rng, SHARD_BLOCKS)
    a = ShardedBitVector.from_words(wa, size, mesh)
    b = ShardedBitVector.from_words(wb, size, mesh)
    fa, fb = wa.reshape(-1), wb.reshape(-1)
    res = {}
    for op in OPS:
        r = step(op, lambda: getattr(a, DUNDER[op])(b))
        want = oracle_op(op, fa, fb)
        res[f"{op}_count"] = step(f"{op} count", r.count)
        check(res[f"{op}_count"] == int(np.bitwise_count(want).sum(
            dtype=np.int64)), f"multihost {op} count")
        if op == "and":
            check(np.array_equal(r.to_words().reshape(-1), want),
                  "multihost and rows")
    del r
    qrng = np.random.default_rng(SEED + 36)
    total = step("count", a.count)
    ranks = qrng.integers(1, total + 1, N_QUERIES)
    got = step("select 1M", lambda: a.select_batch(ranks))
    check(np.array_equal(got, oracle_select(fa, ranks)), "multihost select")
    res["select_sha256"] = _digest_of(got)
    ids = qrng.integers(0, size, N_QUERIES)
    got = step("rank 1M", lambda: a.build_rs_index().rank_batch(ids))
    check(np.array_equal(got, oracle_rank(fa, ids)), "multihost rank")
    res["rank_sha256"] = _digest_of(got)
    del a, b
    _, vals, nm = config4b_values()
    ok = ~nm
    sv = tbm.SparseVector.from_array(vals, nullable=True, null_mask=nm,
                                     device="cpu")
    ssv = ShardedSparseVector.from_sparse_vector(sv, mesh)
    del sv
    drawn = int(vals[qrng.integers(0, SV_N)])
    hits = step("find_gt", lambda: ssv.find_gt(drawn))
    check(np.array_equal(hits.to_bitvector().indices(),
                         np.flatnonzero((vals > drawn) & ok)),
          "multihost find_gt")
    res["find_eq_count"] = step("find_eq_count",
                                lambda: ssv.find_eq_count(drawn))
    check(res["find_eq_count"] == int(((vals == drawn) & ok).sum()),
          "multihost find_eq_count")
    values = qrng.integers(0, 1 << SV_BITS, SV_QUERIES)
    values[:8] = vals[qrng.integers(0, SV_N, 8)]
    res["pipeline_find_eq"] = step(
        "pipeline_find_eq", lambda: ssv.pipeline_find_eq(values.tolist()))
    hist = np.bincount(vals[ok], minlength=1 << SV_BITS)
    check(res["pipeline_find_eq"] == hist[values].tolist(),
          "multihost pipeline_find_eq")
    return res, step.launches, step.ms


# the steps with exactly one launch of these kernels per shard
MH_ONE_PER_SHARD = {**{op: ("logical_op_digest",) for op in OPS},
                    **{f"{op} count": ("block_counts",) for op in OPS},
                    "count": ("block_counts",), "find_gt": ("sv_descent",),
                    "select 1M": ("rs_select",), "rank 1M": ("rs_rank",),
                    "pipeline_find_eq": ("pipeline_counts",)}


def multihost_worker(rank, world, init, out_dir, device):
    """One process of the multihost phase: multihost_check's steps, then
    the sharded phase's work, over a mesh of MH_LOCAL shards on ``device``
    in every process of the gloo group; its results and launches go to
    ``out_dir/rank<r>.json``."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import process_mesh
    from tools_torch import multihost_check as mh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    device = torch.device(device)
    tbm.config.device = str(device)
    out = {}
    try:
        ck.reset_launches()
        t0 = time.perf_counter()
        out["tool"] = mh.worker_steps(rank, world, device)
        sync()
        out["tool_s"] = time.perf_counter() - t0
        out["tool_launches"] = dict(ck.launches)
        mesh = process_mesh([device] * MH_LOCAL)
        t0 = time.perf_counter()
        out["scale"], out["scale_launches"], out["scale_ms"] = \
            multihost_scale(tbm, mesh)
        out["scale_s"] = time.perf_counter() - t0
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def multihost_phase(tbm, card, device="cuda:0"):
    """Phase 18: MH_PROCESSES fresh interpreters of MH_LOCAL shards each on
    ``device``, joined over gloo, run multihost_check's steps and the sharded
    phase's work; their results must equal numpy (each process checks)
    and this process's run on one mesh of all the shards, with one launch
    per local shard per step.  A worker's failure or timeout fails the
    phase.  Returns the launches of the workers, summed."""
    import tempfile
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import Mesh
    from tools_torch import multihost_check as mh
    n_all = MH_PROCESSES * MH_LOCAL
    mesh = Mesh([device] * n_all)
    # the same work in this process, on one mesh of every shard
    ck.reset_launches()
    d = mh.draws(n_all, 0, MH_PROCESSES)
    one_tool = mh.containers(mesh, d, mh.local_planes(mesh, d["planes"]))
    one_scale, one_steps, one_ms = multihost_scale(tbm, mesh)
    log(f"multihost: one process, {n_all} shards on {device}: launches per "
        f"step {json.dumps(one_steps)}; ms per step {json.dumps(one_ms)}")
    with tempfile.TemporaryDirectory(prefix="bm_multihost_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        t0 = time.perf_counter()
        rc = mh.run_workers(
            lambda r: [sys.executable, os.path.abspath(__file__),
                       "--multihost-worker", str(r), str(MH_PROCESSES), init,
                       tmp, device], MH_PROCESSES, MH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check(rc == 0, f"multihost: a worker failed (exit code {rc})")
        outs = []
        for r in range(MH_PROCESSES):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    for k in ("scan_s", "merged_count", "n_global"):
        for o in outs:
            o["tool"].pop(k)
    one_tool.pop("scan_s")
    total = {k: 0 for k in KERNELS}
    for r, o in enumerate(outs):
        check(o["tool"] == one_tool, f"multihost: process {r}'s "
              f"multihost_check results differ from one process's")
        check(o["scale"] == one_scale, f"multihost: process {r}'s sharded "
              f"results differ from one process's")
        for name, kernels in MH_ONE_PER_SHARD.items():
            for k in kernels:
                got = o["scale_launches"][name].get(k, 0)
                check(got == MH_LOCAL, f"multihost: process {r} step "
                      f"{name}: {got} {k} launches for {MH_LOCAL} shards")
        for k in KERNELS:
            total[k] += o["tool_launches"][k] + sum(
                s.get(k, 0) for s in o["scale_launches"].values())
        log(f"multihost: process {r}: multihost_check steps "
            f"{o['tool_s']:.1f} s, sharded work {o['scale_s']:.1f} s, peak "
            f"{o['peak_mib']:.0f} MiB; launches per step "
            f"{json.dumps(o['scale_launches'])}; ms per step "
            f"{json.dumps(o['scale_ms'])}")
    # across the processes every step launched what one process did
    for name, want in one_steps.items():
        got = {k: sum(o["scale_launches"][name].get(k, 0) for o in outs)
               for k in want}
        check(got == want, f"multihost: step {name}: {got} launches over "
              f"the processes, {want} in one process")
    log(json.dumps({"multihost": {"processes": MH_PROCESSES,
                                  "local_shards": MH_LOCAL, "wall_s": wall,
                                  "results": one_scale},
                    "card": card["smi"]}))
    log(f"multihost: passed in {wall:.1f} s of worker wall; launches "
        f"{total}")
    require_launches("multihost phase", total,
                     ("logical_op_digest", "block_counts", "agg_and_sub",
                      "pipeline_counts", "scan_eq"))
    return total


# ---------------------------------------------------------------------------
# phase 21: timing
# ---------------------------------------------------------------------------
# clock cycles a timed run is held back after the flush: about 1 ms on an
# H100 at 1980 MHz, longer than the host thread's usual stalls
HOLD_CYCLES = 2_000_000


def time_ms(fn, flush, reps=25, clean=None, samples=None,
            hold=HOLD_CYCLES):
    """Median device time of ``fn`` over ``reps`` runs after a warm-up.
    Before each run a 512 MiB memset evicts the 50 MB L2, and a kernel
    that spins ``hold`` clock cycles and touches no memory keeps the
    stream busy while the host enqueues the run, so the events bracket the
    device work and not the host's launch overhead, nor a stall of the
    host thread that outlasts the memset.  The memset leaves L2 full of
    dirty lines, which the run's reads write back; with ``clean`` (a
    second buffer) a read-only pass over it follows the memset and leaves
    L2 holding clean lines instead.  ``samples``: a list that receives
    each run's time."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        if clean is not None:
            clean.max()
        if hold:
            torch.cuda._sleep(hold)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    if samples is not None:
        samples.extend(ts)
    return float(np.median(ts))


def record(out, key, card, flush, kern, plain, lib, nbytes, lops, popcs,
           clean=None):
    """Time ``kern``, its plain version and the library call (or None)
    into ``out[key]``, beside the bound: the larger of ``nbytes`` over the
    card's bandwidth and ``lops`` logic ops / ``popcs`` popcounts over
    their peak rates.  ``clean``: the kernel is timed with L2 left clean
    (``time_ms``)."""
    ms = time_ms(kern, flush, clean=clean)
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


def k1_same_as_plain(kern, plain, what):
    """K1 bit-identical to its plain version, rows and digests, for each
    op."""
    for op in OPS:
        got, want = kern(op), plain(op)
        sync()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"logical_op_digest at {what}, {op}: kernel against plain")


def timings(device, card, cfg1):
    """K1-K3 at 1536 and 16384 rows; K3 and K2 at config 1's own shapes
    (``cfg1``: A's pool and the descriptors distance_operation hands K2),
    per block and in total form, and K1's gather form over those
    descriptors; the floor of a timed launch; K3 and K1 at 1536 and 16384
    rows, and K1's gather form, after a flush that leaves L2 clean.  Each
    K1 case is checked bit-identical to its plain version first."""
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
        # K1 with L2 left clean, its library call beside it
        k1_same_as_plain(lambda op: ck.logical_op_digest(op, a, b),
                         lambda op: blockops.logical_op_digest(op, a, b),
                         f"{n} aligned rows")
        ms = time_ms(lambda: ck.logical_op_digest("and", a, b), flush,
                     clean=clean)
        t = out["logical_op_digest", n]
        out["logical_op_digest", f"{n}_clean_l2"] = dict(
            t, ms=ms, plain_ms=None, gb_per_s=t["bytes"] / (ms * 1e-3) / 1e9,
            library_ms=time_ms(lambda: torch.bitwise_and(a, b), flush,
                               clean=clean))
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
    # K1's gather form over the same descriptors: the rows read, the
    # result rows and digests written, the descriptors read once
    k1_same_as_plain(lambda op: ck.binary_op_digest(op, da, db),
                     lambda op: blockops.binary_op_digest(op, da, db),
                     "config 1's descriptors")
    clean = torch.empty_like(flush)
    for key, cl in (("config1_gather", None),
                    ("config1_gather_clean_l2", clean)):
        record(out, ("logical_op_digest", key), card, flush,
               lambda: ck.binary_op_digest("and", da, db),
               lambda: blockops.binary_op_digest("and", da, db), None,
               reads * row + k * (row + 256) + 2 * k * 9, 0, 0, clean=cl)
        out["logical_op_digest", key].update(rows=k, rows_read=reads)
    del clean
    gap_timings(rng, device, card, flush, out)
    sv_timings(rng, device, card, flush, out)
    rs_timings(rng, device, card, flush, out)
    descent_timings(rng, device, card, flush, out)
    return out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rs_timings(rng, device, card, flush, out):
    """rs_select and rs_rank at cell 1's shape (a vector drawn as
    bvsetalgebra_rank_select's A, N_QUERIES uniform ranks and ids) and
    their flat forms over the same pool (N_QUERIES uniform pool ranks and
    bit offsets).  Bounds: the queries read and the answers written once,
    each 128 B wave that a query reaching a BIT block touches read once
    (a wave many queries share comes from L2 after its first read, as
    sv_gather_bytes counts each pool row once), the index's tables read
    once (L2-resident); the popcounts these queries need (the wave's
    words up to the answer's, and select's five in-word steps)."""
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch import constants as C
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.ops import select as plain
    v, _ = rs_cell_vector(tbm, rng, device)
    rs = v.build_rs_index()
    runs = rs._gap_runs()
    ec, key_end, key_cum = runs
    n = N_QUERIES
    q = torch.from_numpy(rng.integers(1, rs.total + 1, n)).to(device)
    i = torch.from_numpy(rng.integers(0, v.size, n)).to(device)
    sargs = (rs._seg, rs._cum0_dev, runs, rs.pool, rs.gwc)
    rargs = (rs._seg, rs._nb_dev, runs, rs.pool, rs.gwc)
    st, rt = rs._select_tables(), rs._rank_tables()
    flat = plain.flat_tables(rs.pool, rs.gwc)
    frank = plain.flat_rank_tables(rs.gwc, flat.wsp)
    # which queries reach a BIT block, and the words their waves need
    s_bit = rs._seg[torch.searchsorted(rs._cum0_dev, q), plain.CLS] \
        == C.CLS_BIT
    s_pos = ck.rs_select(*sargs, q, rs.total, st)
    s_words = ((s_pos & 1023) >> 5) + 1
    row = torch.searchsorted(rs._nb_dev, i >> 16, right=True)
    r_bit = ((rs._seg[row, plain.CLS] == C.CLS_BIT)
             & ((i >> 16) < rs._seg[row, plain.END]))
    r_words = ((i & 1023) >> 5) + 1
    tables = _nbytes(rs._seg, ec, rs.gwc)
    g = torch.from_numpy(rng.integers(1, int(rs.gwc[-1]) + 1, n).astype(
        np.int32)).to(device)
    rel = torch.from_numpy(rng.integers(0, rs.pool.shape[0] * BPB, n)).to(
        device)
    f_pos = ck.select_flat(rs.pool, rs.gwc, g, flat)
    f_words = ((f_pos & 1023) >> 5) + 1
    every = torch.ones(n, dtype=torch.bool, device=device)
    for key, kern, pln, nbytes, popcs, bit, bits in (
            (("rs_select", "cell1_1M"),
             lambda: ck.rs_select(*sargs, q, rs.total, st),
             lambda: plain.rs_select(*sargs, q, rs.total),
             16 * n + tables + _nbytes(rs._cum0_dev, key_cum),
             int((s_words + 5)[s_bit].sum()), s_bit, s_pos),
            (("rs_rank", "cell1_1M"), lambda: ck.rs_rank(*rargs, i, rt),
             lambda: plain.rs_rank(*rargs, i),
             16 * n + tables + _nbytes(rs._nb_dev, key_end),
             int(r_words[r_bit].sum()), r_bit, i),
            (("rs_select", "flat_1M"),
             lambda: ck.select_flat(rs.pool, rs.gwc, g, flat),
             lambda: plain.select_flat(rs.pool, rs.gwc, g),
             12 * n + _nbytes(rs.gwc), int((f_words + 5).sum()), every,
             f_pos),
            (("rs_rank", "flat_1M"),
             lambda: ck.rank_flat(rs.pool, rs.gwc, rel, frank),
             lambda: plain.rank_flat(rs.pool, rs.gwc, rel),
             16 * n + _nbytes(rs.gwc), int((((rel & 1023) >> 5) + 1).sum()),
             every, rel)):
        # the distinct waves the BIT-class queries touch: a BIT block is
        # one pool row, so a bit position's >> 10 names its wave
        waves = int(torch.unique(bits[bit] >> 10).numel())
        record(out, key, card, flush, kern, pln, None,
               nbytes + 128 * waves, 0, popcs)
        out[key].update(queries=n, bit_queries=int(bit.sum()), waves=waves)


def sv_gather_bytes(table, n_ids) -> int:
    """Bytes sv_gather must move: each id read and its image written (8 B
    each), the plane table, and every plane's BIT rows and D-GAP mirror
    read once."""
    nbytes = 16 * n_ids + sum(t.numel() * t.element_size() for t in (
        table.table, table.nb, table.ent, table.runs))
    nbytes += sum(p.shape[0] * 8192 for p in table.pools)
    nbytes += sum(a.numel() * a.element_size() for g in table.gaps
                  if g is not None for a in g)
    return nbytes


def sv_timings(rng, device, card, flush, out):
    """sv_gather at column_range_gather's shape (16M nullable values <
    2^20, every row assigned, SV_GATHER_IDS uniform ids) and sv_transpose
    at config 4b's import (16M 4-byte values, 20 slices; also with L2
    left clean, ``time_ms``) and over 16M 8-byte values x 64 slices.
    Bounds: the bytes read and written once, at the card's memory
    rate."""
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    vals = rng.integers(0, 1 << SV_BITS, SV_N).astype(np.uint32)
    sv = tbm.SparseVector.from_array(vals, nullable=True, device=device)
    table = sv._plane_table()
    ids = torch.from_numpy(rng.integers(0, SV_N, SV_GATHER_IDS)).to(device)
    record(out, ("sv_gather", "cell3"), card, flush,
           lambda: ck.sv_gather(ids, table),
           lambda: blockops.sv_gather(ids, table), None,
           sv_gather_bytes(table, SV_GATHER_IDS), 0, 0)
    out["sv_gather", "cell3"].update(
        ids=SV_GATHER_IDS, planes=table.meta.shape[0],
        rows=sum(p.shape[0] for p in table.pools))
    d = torch.from_numpy(vals.view(np.int32)).to(device)
    n_words = -(-SV_N // 32)
    record(out, ("sv_transpose", "16M_20"), card, flush,
           lambda: ck.sv_transpose(d, SV_BITS),
           lambda: blockops.sv_transpose(d, SV_BITS), None,
           4 * SV_N + 4 * SV_BITS * n_words, 0, 0)
    clean = torch.empty_like(flush)
    record(out, ("sv_transpose", "16M_20_clean_l2"), card, flush,
           lambda: ck.sv_transpose(d, SV_BITS),
           lambda: blockops.sv_transpose(d, SV_BITS), None,
           4 * SV_N + 4 * SV_BITS * n_words, 0, 0, clean=clean)
    del clean
    # 8-byte values over all 64 slices (a column with values past 2^32)
    d = torch.from_numpy(rng.integers(0, 2**64, SV_N, dtype=np.uint64).view(
        np.int64)).to(device)
    check(torch.equal(ck.sv_transpose(d, 64), blockops.sv_transpose(d, 64)),
          "sv_transpose of 16M 8-byte values x 64 slices = plain")
    record(out, ("sv_transpose", "16M_64_8byte"), card, flush,
           lambda: ck.sv_transpose(d, 64),
           lambda: blockops.sv_transpose(d, 64), None,
           8 * SV_N + 4 * 64 * n_words, 0, 0)


def descent_timings(rng, device, card, flush, out):
    """sv_descent at column_range_gather's shape (16M nullable values <
    2^20, every row assigned; find_gt(DESCENT_GT): 20 steps over 245
    blocks, gt only) and descent_rows at one shard of the same column's
    SHARDS-shard stack; each first held bit for bit against its plain
    version; each also timed with L2 left clean (``time_ms``).  Bounds:
    the bytes read and written once (``bench_torch.descent_bytes``; the
    dense form reads every stepped row and the universe and writes gt and
    eq)."""
    import bitmagic_tpu_torch as tbm
    from bench_torch import descent_bytes
    from bitmagic_tpu_torch.core.bitvector import descent_args
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    from bitmagic_tpu_torch.parallel import Mesh, ShardedSparseVector
    vals = rng.integers(0, 1 << SV_BITS, SV_N).astype(np.uint32)
    sv = tbm.SparseVector.from_array(vals, nullable=True, device=device)
    table, steps, _ = tbm.scanner._descent_steps(sv, DESCENT_GT,
                                                 sv.n_slices)
    uni = sv.null_plane
    blocks = np.union1d(table.blocks, uni._struct.nb)
    args = descent_args(table, uni, steps, blocks)
    for g, w in zip(ck.sv_descent(table, *args, False),
                    blockops.sv_descent(table, *args, False)):
        check(g is None and w is None or torch.equal(g, w),
              "sv_descent at the cell's shape = plain")
    bit = table.meta[:, -1]
    planes = [sv.planes[int(bit[r])] for r, _, _ in steps]
    k = blocks.size
    record(out, ("sv_descent", "cell3"), card, flush,
           lambda: ck.sv_descent(table, *args, False),
           lambda: blockops.sv_descent(table, *args, False), None,
           descent_bytes(planes, uni, k), 4 * 2048 * k * len(steps), 0)
    clean = torch.empty_like(flush)
    record(out, ("sv_descent", "cell3_clean_l2"), card, flush,
           lambda: ck.sv_descent(table, *args, False),
           lambda: blockops.sv_descent(table, *args, False), None,
           descent_bytes(planes, uni, k), 4 * 2048 * k * len(steps), 0,
           clean=clean)
    for shape in ("cell3", "cell3_clean_l2"):
        out["sv_descent", shape].update(
            blocks=k, steps=len(steps),
            rows=sum(p._struct.n_rows() for p in planes)
            + uni._struct.n_rows())
    ssv = ShardedSparseVector.from_sparse_vector(sv, Mesh([device] * SHARDS))
    st = ssv.stack[0]
    rows, bits = blockops.descent_steps(list(range(ssv.n_eff)), DESCENT_GT)
    got = ck.descent_rows(st, st[ssv.UNI], rows, bits)
    want = blockops.descent_rows(st, st[ssv.UNI], rows, bits)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "descent_rows at the shard's shape = plain")
    nb = st.shape[1]
    for shape, c in (("shard4b", None), ("shard4b_clean_l2", clean)):
        record(out, ("sv_descent", shape), card, flush,
               lambda: ck.descent_rows(st, st[ssv.UNI], rows, bits),
               lambda: blockops.descent_rows(st, st[ssv.UNI], rows, bits),
               None, (len(rows) + 3) * nb * 8192, 4 * 2048 * nb * len(rows),
               0, clean=c)
        out["sv_descent", shape].update(blocks=nb, steps=len(rows))


def gap_timings(rng, device, card, flush, out):
    """gap_expand over the GAP_BLOCKS blocks of a store drawn as
    bvsetalgebra_rank_select's, and over both stores' in one pair launch
    (as an operation on two such vectors) and in one many-store launch
    (as the aggregator's operands); gap_compress's launch over
    GAP_PAIRS AND rows of two such stores (into a prepared buffer), its
    whole call, and ``compress_rows`` (the call and
    the download; host wall, median of 21) against the same through the
    plain version.  Bounds: the bytes read and written once, at the card's
    memory rate."""
    from bitmagic_tpu_torch.ops import blockops
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    sa, sb = gap_stores(rng)
    ma, mb = sa.device_arrays(device), sb.device_arrays(device)
    every = torch.arange(GAP_BLOCKS, dtype=torch.int32, device=device)
    # the runs of the selected blocks, their offs pair, first, sel; rows
    nbytes = 4 * int(sa.offs[-1]) + GAP_BLOCKS * (8 + 1 + 4 + 8192)
    record(out, ("gap_expand", "cell1_768"), card, flush,
           lambda: ck.gap_expand(*ma, every),
           lambda: blockops.gap_expand(*ma, every), None, nbytes, 0, 0)
    out["gap_expand", "cell1_768"].update(rows=GAP_BLOCKS,
                                          runs=int(sa.offs[-1]))
    # one pair launch: both stores' blocks, as an operation expands them
    both = torch.cat([every, every])
    nbytes = (4 * int(sa.offs[-1] + sb.offs[-1])
              + 2 * GAP_BLOCKS * (8 + 1 + 4 + 8192))
    record(out, ("gap_expand", "cell1_pair"), card, flush,
           lambda: ck.gap_expand_pair(ma, mb, both, GAP_BLOCKS),
           lambda: blockops.gap_expand_pair(ma, mb, both, GAP_BLOCKS), None,
           nbytes, 0, 0)
    out["gap_expand", "cell1_pair"].update(
        rows=2 * GAP_BLOCKS, runs=int(sa.offs[-1] + sb.offs[-1]))
    # the many-store launch over the same blocks (the aggregator's form),
    # its table of mirrors and rows uploaded once: one round trip more a
    # CTA than the pair launch
    many = [ma, mb], [np.arange(GAP_BLOCKS)] * 2
    buf, args = ck._expand_many_plan(*many, device)
    many_rows = torch.empty((2 * GAP_BLOCKS, 2048), dtype=torch.int32,
                            device=device)

    def many_launch(buf=buf):
        ck._launch("bm_gap_expand_many", "gap_expand", device, *args,
                   ck._ptr(many_rows))
    many_launch()
    sync()
    check(torch.equal(many_rows,
                      ck.gap_expand_pair(ma, mb, both, GAP_BLOCKS)),
          "gap_expand: the timed many-store launch = the pair launch")
    record(out, ("gap_expand", "cell1_pair_many"), card, flush, many_launch,
           lambda: blockops.gap_expand_many(*many), None,
           nbytes + 2 * GAP_BLOCKS * 4 + 2 * 24, 0, 0)
    out["gap_expand", "cell1_pair_many"].update(
        rows=2 * GAP_BLOCKS, runs=int(sa.offs[-1] + sb.offs[-1]))
    rows = (ck.gap_expand(*ma, every)[:GAP_PAIRS]
            & ck.gap_expand(*mb, every)[:GAP_PAIRS])
    from bitmagic_tpu_torch.core import gapstore
    n = GAP_PAIRS
    # the pairs' summed runs: the bound _binary hands gap_compress
    cap = int(sa.n_runs()[:n].sum() + sb.n_runs()[:n].sum())
    buf = ck.gap_compress(rows, cap)
    scratch = torch.empty(n + 1, dtype=torch.int64, device=device)

    def one_launch():           # the memset and the kernel, no allocation
        ck._launch("bm_gap_compress", "gap_compress", device, ck._ptr(rows),
                   n, cap, ck._ptr(buf), ck._ptr(scratch))

    def median_ms(fn, reps=21):
        fn()
        sync()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    total = int(buf[n])
    nbytes = n * 8192 + 4 * total + 4 * (n + 1) + n
    record(out, ("gap_compress", "cell1_400"), card, flush, one_launch,
           lambda: blockops.gap_compress(rows, cap), None, nbytes, 0, 0)
    out["gap_compress", "cell1_400"].update(
        rows=n, runs=total, cap=cap,
        call_ms=time_ms(lambda: ck.gap_compress(rows, cap), flush),
        compress_rows_ms=median_ms(lambda: gapstore.compress_rows(rows,
                                                                  cap)),
        compress_rows_plain_ms=median_ms(
            lambda: gapstore.GapStore.from_packed(
                blockops.gap_compress(rows, cap), n)))
    # what the kernels replace: the host's run-domain merge of the pairs
    # and its metric sweep over them, the host expansion of every block
    # and the host encoding of the pairs' rows (best host ms of 5 after a
    # warm-up)
    pairs, blocks = np.arange(n), np.arange(GAP_BLOCKS)
    host_rows = blockops.to_host_words(rows)
    out["gap_host_ms"] = {
        what: best_ms(fn, 5)[0]
        for what, fn in (
            ("gap_binary_op_and_400", lambda: gapstore.gap_binary_op(
                "and", sa, pairs, sb, pairs)),
            ("gap_metric_counts_400", lambda: gapstore.gap_metric_counts(
                sa, pairs, sb, pairs)),
            ("to_dense_768", lambda: sa.subset(blocks).to_dense()),
            ("from_dense_400", lambda: gapstore.GapStore.from_dense(
                host_rows)))}


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


def probe_and_build():
    """Phases 1-2: the card (name, power limit, the peak rates the bounds
    use), then every kernel built from ops/csrc at once.  -> (device,
    card)."""
    sys.path.insert(0, ROOT)
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import _build
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
    return device, card


def descent_main():
    """``--descent``: phases 1-2, then the descent's checks alone: its
    kernels against their plain versions, the descent phase on config 4b's
    column and the kernels' timings (one line each)."""
    import bitmagic_tpu_torch as tbm
    device, card = probe_and_build()
    errs = []

    def cmp(name, got, want):
        sync()
        check(got.shape == want.shape and got.dtype == want.dtype, name)
        errs.append(int((got.to(torch.int64) - want.to(torch.int64)).abs()
                        .max()) if got.numel() else 0)

    descent_kernels_vs_plain(np.random.default_rng(SEED + 1), device, cmp)
    check(max(errs) == 0, "sv_descent disagrees with its plain version")
    log(f"kernels: sv_descent bit-identical to its plain version: "
        f"{len(errs)} cases")
    _, vals, nm = config4b_values()
    sv = tbm.SparseVector.from_array(vals, null_mask=nm, device=device)
    launches, times = descent_phase(tbm, device, card, sv, vals, nm,
                                    find_gt_trace(tbm, sv))
    log(f"descent: launches {launches}; phase ms {json.dumps(times)}")
    out = {}
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    descent_timings(np.random.default_rng(SEED + 4), device, card, flush,
                    out)
    for (k, shape), t in out.items():
        log(json.dumps({"kernel": k, "shape": shape, **t,
                        "card": card["smi"]}))
    return 0


def main():
    if sys.argv[1:2] == ["--multihost-worker"]:
        rank, world, init, out_dir, device = sys.argv[2:7]
        return multihost_worker(int(rank), int(world), init, out_dir, device)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on an NVIDIA card and has nothing to run "
              "here", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--single-query"]:
        return single_query_main(sys.argv[2])
    if sys.argv[1:2] == ["--descent"]:
        return descent_main()
    sys.path.insert(0, ROOT)
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import cuda_kernels as ck

    # 1-2. probe and build
    device, card = probe_and_build()
    smi = card["smi"]

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
    for k in FIRST_SLICE + GAP_ROWS + RS_KERNELS:
        check(main_launches[k] > 0, f"main path never launched {k}")
    log(f"main: one query per call, median host wall ms of "
        f"{SINGLE_CALLS} calls: select {main_times['one_select_ms']}, rank "
        f"{main_times['one_rank_ms']}, BitVector.select "
        f"{main_times['one_bv_select_ms']}; {smi}")
    a, b = state[0], state[1]
    r = a & b
    for what, fn, kernel, beside in (
            ("count()", r.count, "block_counts_kernel", 0),
            ("distance_operation", lambda: tbm.distance_operation(
                a, b, list(METRICS)), "count_metrics_kernel", 2)):
        # one run of this check (torch 2.11, H100) once got a trace with
        # no event at all (PERF.md, open questions): trace again, up to
        # TRACE_TRIES times in all, when it recorded no kernel, and log
        # how often
        for retries in range(TRACE_TRIES):
            names = device_kernels(fn)
            if names:
                break
            trace_retry_pause(f"main: {what}")
        log(f"main: {what} put these kernels on the card: {names}; "
            f"empty traces before this one: {retries}")
        # beside K2, distance_operation expands each operand's GAP blocks
        main = [n for n in names if "gap_expand_kernel" not in n]
        check(len(main) == 1 and kernel in main[0]
              and len(names) - len(main) <= beside,
              f"{what}: one launch of {kernel} and no sum kernel after it")
    rs, ranks, ids = state[2:]
    for what, fn, kernel in (
            ("select_batch", lambda: rs.select_batch(ranks),
             "rs_select_kernel"),
            ("rank_batch", lambda: rs.rank_batch(ids), "rs_rank_kernel")):
        fn()
        sync()
        for retries in range(TRACE_TRIES):
            names = [e.name for e in traced_device_events(fn)]
            if names:
                break
            trace_retry_pause(f"main: {what}")
        main = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
        copies = sorted(n for n in names if n.startswith("Memcpy"))
        log(f"main: one 1M {what} put these on the card: {names}; empty "
            f"traces before this one: {retries}")
        check(len(main) == 1 and kernel in main[0] and len(copies) == 2
              and len(names) == 3, f"{what}: one {kernel} launch and its "
              f"two copies, nothing else")
    del rs, ranks, ids
    cfg1 = (a._pool, *k2_operands(a, b))
    del a, b, r
    profile("steady pass (4 ops + counts, distance_operation, 1M select, "
            "1M rank)", lambda: steady_pass(tbm, *state))
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
        for k in ("agg_and_sub", "pipeline_counts") + (
                SV_PLANES if path == "scan" else ()):
            check(path_launches[path][k] > 0,
                  f"{path} path never launched {k}")
        if path == "agg":
            log(f"agg: config-3 arena build {times['arena_build_ms']} ms "
                f"(GAP blocks expanded by the native gaps_to_dense)")
        profile(f"{path} steady pass ({what})",
                lambda: steady(tbm, *state))
        if path == "scan":
            sv = state[1]
            find_gt_names = find_gt_trace(tbm, sv)
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
                      "block_counts", "sv_descent"))

    # 9b. the descent phase: the ordered searches' descent in one launch
    t0 = time.perf_counter()
    descent_launches, descent_times = descent_phase(tbm, device, card, sv,
                                                    vals, nm, find_gt_names)
    log(f"descent: passed in {time.perf_counter() - t0:.1f} s; launches "
        f"{descent_launches}; phase ms {json.dumps(descent_times)}")

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
                      "pipeline_counts", "scan_eq", "sv_descent")
                     + RS_KERNELS)
    del cols

    # 12. the capi phase: configs 1-2's A and B through the BM_* facade
    capi_launches, (a, b, bits) = capi_phase(tbm, device)

    # 13. the utils phase: debug, timer and the file helpers
    utils_launches = utils_phase(tbm, device, a, b, bits, sv, vals, nm)
    del a, b, bits, sv, vals, nm

    # 14. the samples phase: the 24 port samples on the card, then B8
    samples_launches, (b8_launches, b8_times, b8_cmp) = samples_phase(
        tbm, device, card)
    # B8 is held against its plain version in its own runs (bitap_timing)
    cases["shift_and_chain"], err["shift_and_chain"] = b8_cmp
    log(f"kernels: shift_and_chain bit-identical to its plain version: "
        f"{b8_cmp[0]} cases, max abs err {b8_cmp[1]}")

    # 15. the tools phase: svutil, range_idx, lnkutil and inv_list
    tools_launches = tools_phase(tbm, card)

    # 16. the fuzz phase: every family of the container fuzzer, then a
    # random run
    fuzz_launches = fuzz_phase(tbm, card)

    # 17. the bench_tools phase: bench_tpch, microbench and scaling_check
    t0 = time.perf_counter()
    bench_tools_launches = bench_tools_phase(tbm, card)
    log(f"bench_tools: passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {bench_tools_launches}")

    # 18. the multihost phase: sharding across two processes
    t0 = time.perf_counter()
    multihost_launches = multihost_phase(tbm, card)
    log(f"multihost: phase passed in {time.perf_counter() - t0:.1f} s")

    # 19. reference fixtures
    ck.reset_launches()
    fixtures_path(tbm, device)
    log(f"fixtures: reference counts, AND ids, ranks and selects match; "
        f"launches {dict(ck.launches)}")

    # 20. scale phases: 2^30-bit pair, then 200 x 1536 blocks
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

    # 21. timing
    tm = timings(device, card, cfg1)
    del cfg1
    log(json.dumps({"floor_ms": tm["floor"], "what": "one-element zero_() "
                    "timed like every kernel", "card": card["smi"]}))
    log(json.dumps({"gap_host_ms": tm["gap_host_ms"], "what": "the host "
                    "numpy that gap_expand and gap_compress replace, at "
                    "bvsetalgebra_rank_select's shapes"}))
    tm.update(search_timings(device, card))
    tm.update(b8_times)
    kernels = []
    shapes = {k: (N_BLOCKS, SCALE_BLOCKS) for k in FIRST_SLICE}
    shapes["block_counts"] += ("1536_clean_l2", "16384_clean_l2",
                               "config1_A", "total_1536", "total_config1_A")
    shapes["count_op"] += ("config1_7", "config1_1", "total_config1_7",
                           "total_config1_1")
    shapes["logical_op_digest"] += ("1536_clean_l2", "16384_clean_l2",
                                    "config1_gather",
                                    "config1_gather_clean_l2")
    shapes.update(agg_and_sub=("config3", "config4b", "config3_batch64"),
                  pipeline_counts=("config4b", "config3"),
                  scan_eq=("config4", "config4b"),
                  gap_expand=("cell1_768", "cell1_pair", "cell1_pair_many"),
                  gap_compress=("cell1_400",),
                  sv_gather=("cell3",),
                  sv_transpose=("16M_20", "16M_20_clean_l2",
                                "16M_64_8byte"),
                  rs_select=("cell1_1M", "flat_1M"),
                  rs_rank=("cell1_1M", "flat_1M"),
                  sv_descent=("cell3", "cell3_clean_l2", "shard4b",
                              "shard4b_clean_l2"),
                  shift_and_chain=tuple(
                      x for shape in B8_SHAPES
                      for x in (shape, f"{shape}_clean_l2")))
    for k, meta in KERNELS.items():
        launches = (main_launches[k] if k in FIRST_SLICE + GAP_ROWS
                    + RS_KERNELS else descent_launches[k]
                    if k == "sv_descent" else b8_launches[k]
                    if k == "shift_and_chain" else search_launches[k])
        for shape in shapes[k]:
            t = tm[(k, shape)]
            log(json.dumps({"kernel": k, "shape": shape, **{
                x: t[x] for x in ("ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by", "bytes",
                                  "gb_per_s", "rows", "rows_read",
                                  "rows_distinct", "rows_fetched",
                                  "rows_total", "singles_ms",
                                  "popcounts_per_word_pair",
                                  "planes_staged", "planes_total", "runs",
                                  "call_ms", "compress_rows_ms",
                                  "compress_rows_plain_ms", "ids", "planes",
                                  "queries", "bit_queries", "blocks",
                                  "steps", "operands", "distinct",
                                  "distinct_row_bytes",
                                  "distinct_row_bound_ms", "exit_bytes",
                                  "exit_bound_ms")
                if x in t}, "main_path_launches": launches,
                "card": card["smi"]}))
        t = tm[(k, shapes[k][0])]
        entry = {"name": k, "route": "cuda", **meta, "launches": launches,
                 "algo_launches": algo_launches[k],
                 "serial_launches": serial_launches[k],
                 "sv_launches": sv_launches[k],
                 "descent_launches": descent_launches[k],
                 "sv_serial_launches": sv_serial_launches[k],
                 "sharded_launches": sharded_launches[k],
                 "capi_launches": capi_launches[k],
                 "utils_launches": utils_launches[k],
                 "samples_launches": samples_launches[k],
                 "tools_launches": tools_launches[k],
                 "fuzz_launches": fuzz_launches[k],
                 "bench_tools_launches": bench_tools_launches[k],
                 "multihost_launches": multihost_launches[k],
                 "max_abs_err": err[k], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "bytes": t["bytes"],
                 "library_ms": t["library_ms"]}
        if k == "scan_eq":
            entry["note"] = ("its entry point is scan_throughput_program "
                             "(sharded phase); the main paths do not call "
                             "it")
        if k in SV_PLANES:
            entry["note"] = ("launches: config 4b's from_array and gather "
                             "(scan path)")
        if k in RS_KERNELS:
            entry["note"] = ("launches: one per 1M batch and per one-query "
                             "call (main path); the flat forms count here")
        if k == "sv_descent":
            entry["note"] = ("launches: config 4b's find_gt with its count "
                             "and its find_ge / lt / le / range (descent "
                             "phase); descent_rows, the dense form, counts "
                             "here")
        if k == "gap_compress":
            entry["call_ms"] = t["call_ms"]
            entry["note"] = ("one launch per call (after a memset of its "
                             "scratch); call_ms the whole call")
        if k == "shift_and_chain":
            entry["distinct_row_bound_ms"] = t["distinct_row_bound_ms"]
            entry["exit_bound_ms"] = t["exit_bound_ms"]
            entry["note"] = ("launches: one per combine_shift_right_and call "
                             "of the B8 runs (samples phase); bound_ms the "
                             "smaller of distinct_row_bound_ms (every "
                             "distinct operand row read once) and "
                             "exit_bound_ms (the bytes its early exit "
                             "leaves in the kernel's order)")
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
