#!/usr/bin/env python3
"""Time the port's K3 (block_counts) and K2 (count_op) kernels against the
version of commit ba114ee, in turns, on one NVIDIA card.

    git archive ba114ee bitmagic_tpu_torch/ops/csrc | tar -x -C DIR
    python3 tools/torch_kernel_turns.py DIR/bitmagic_tpu_torch/ops/csrc

DIR's ``block_counts.cu`` and ``count_op.cu`` are built with their own
``bm_common.cuh`` and the port's nvcc flags.  They have that commit's C
interfaces, which this script names: ``bm_block_counts(pool, n, out,
stream)`` and ``bm_count_metrics(a (7 arguments), b (7 arguments), codes,
n_metrics, k, out, stream)``.  Both versions run on the same inputs
(chip_smoke.py's shapes: K3 at 1536 and 16384 rows and on the pool of
config 1's vector A; K2 aligned with one metric at 1536 and 16384 rows and
on the blocks config 1's distance_operation hands it, with its 7 metrics
and with count_and's one; and the device work of ``count()`` and of
``distance_operation`` as each calls it: before, the per-block kernel and
a ``torch.sum``; now, one launch of the total form), must agree bit for
bit, and are timed old, new, new, old: medians of 25 launches, CUDA
events, L2 evicted before each (``chip_smoke.time_ms``).  Prints one JSON
line per shape, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import bitmagic_tpu_torch as tbm  # noqa: E402
from bitmagic_tpu_torch.ops import _build  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

VP, INT = ctypes.c_void_p, ctypes.c_int
OPERAND = [VP, INT, VP, VP, VP, INT, VP]


def build_old(old_dir):
    """The two sources of ``old_dir``, built side by side into it."""
    procs = []
    for src in ("block_counts.cu", "count_op.cu"):
        so = os.path.join(old_dir, f"old_{src[:-3]}.so")
        procs.append((src, so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(old_dir, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, so, p in procs:
        text, _ = p.communicate()
        cs.check(p.returncode == 0, f"build of the old {src}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"old {src}: {line.strip()}")
        libs[src] = ctypes.CDLL(so)
    k3 = libs["block_counts.cu"].bm_block_counts
    k3.argtypes = [VP, INT, VP, VP]
    k2 = libs["count_op.cu"].bm_count_metrics
    k2.argtypes = OPERAND + OPERAND + [INT, INT, INT, VP, VP]
    k3.restype = k2.restype = INT
    return k3, k2


def main(argv):
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    device = torch.device("cuda")
    _build.build_all()
    for line in "".join(_build.build_log.values()).splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"new: {line.strip()}")
    old_k3, old_k2 = build_old(os.path.abspath(argv[0]))
    stream = torch.cuda.current_stream(device).cuda_stream
    rng = np.random.default_rng(cs.SEED + 9)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    ptr = ck._ptr
    a_vec, b_vec, _ = cs.build_main_vectors(tbm, cs.N_BLOCKS, device, {})
    cfg1_pool = a_vec._pool
    cfg1_da, cfg1_db = cs.k2_operands(a_vec, b_vec)

    def k3_case(pool, total):
        n = pool.shape[0]
        res = torch.empty(n, dtype=torch.int32, device=device)

        def old():
            cs.check(old_k3(ptr(pool), n, ptr(res), stream) == 0,
                     "old K3 launch")
            return res.sum(dtype=torch.int64) if total else res

        def new():
            return (ck.block_counts_total(pool)[0] if total
                    else ck.block_counts(pool))

        return old, new

    def k2_old(metrics, a_args, b_args, k, total):
        res = torch.empty((len(metrics), k), dtype=torch.int32,
                          device=device)
        # that commit's codes: metric j's index in METRICS at bits 3j..
        codes = sum(cs.METRICS.index(m) << (3 * j)
                    for j, m in enumerate(metrics))
        args = a_args + b_args + [codes, len(metrics), k, ptr(res)]

        def old():
            cs.check(old_k2(*args, stream) == 0, "old K2 launch")
            return res.sum(dim=1, dtype=torch.int64) if total else res

        return old

    def k2_case(metrics, da, db, total):
        k = da[1].shape[0]

        def new():
            return (ck.count_metrics_total(metrics, da, db)[0] if total
                    else ck.count_metrics(metrics, da, db))

        return k2_old(metrics, ck._operand(da, k, "a"),
                      ck._operand(db, k, "b"), k, total), new

    def k2_aligned(n):
        a, b = (cs._rand_pool(rng, n, device) for _ in range(2))
        old = k2_old(one, ck._aligned(a, "a"), ck._aligned(b, "b"), n, False)
        return (lambda: old()[0]), (lambda: ck.count_op("and", a, b))

    one = ("count_and",)
    # each case's inputs are made just before it is timed and freed after
    cases = {
        ("block_counts", "1536"): lambda: k3_case(
            cs._rand_pool(rng, 1536, device), False),
        ("block_counts", "16384"): lambda: k3_case(
            cs._rand_pool(rng, 16384, device), False),
        ("block_counts", "config1_A"): lambda: k3_case(cfg1_pool, False),
        ("block_counts", "count() on config1_A: per-block kernel + "
         "torch.sum before, total form now"): lambda: k3_case(cfg1_pool,
                                                              True),
        ("count_op", "aligned and, 1536"): lambda: k2_aligned(1536),
        ("count_op", "aligned and, 16384"): lambda: k2_aligned(16384),
        ("count_op", "config1, 7 metrics"): lambda: k2_case(
            cs.METRICS, cfg1_da, cfg1_db, False),
        ("count_op", "config1, 1 metric"): lambda: k2_case(
            one, cfg1_da, cfg1_db, False),
        ("count_op", "distance_operation on config1, 7 metrics: per-block "
         "kernel + torch.sum before, total form now"): lambda: k2_case(
            cs.METRICS, cfg1_da, cfg1_db, True),
        ("count_op", "count_and on config1: per-block kernel + torch.sum "
         "before, total form now"): lambda: k2_case(one, cfg1_da, cfg1_db,
                                                    True),
    }
    smi = cs.nvidia_smi("name,power.limit")
    for (kernel, shape), make in cases.items():
        old, new = make()
        want, got = old(), new()
        cs.sync()
        cs.check(torch.equal(want, got),
                 f"{kernel} @ {shape}: old and new agree")
        t = {"old_ms": [cs.time_ms(old, flush)],
             "new_ms": [cs.time_ms(new, flush)]}
        t["new_ms"].append(cs.time_ms(new, flush))
        t["old_ms"].append(cs.time_ms(old, flush))
        cs.log(json.dumps({"kernel": kernel, "shape": shape, **t,
                           "card": smi}))
        del old, new, want, got
    cs.log(cs.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
