#!/usr/bin/env python3
"""Time the port's B4 and B5 kernels against the version of commit e3185fc,
in turns, on one NVIDIA card.

    git archive e3185fc bitmagic_tpu_torch/ops/csrc | tar -x -C DIR
    python3 tools/torch_kernel_turns.py DIR/bitmagic_tpu_torch/ops/csrc

DIR's ``agg_sub.cu`` and ``pipeline_counts.cu`` are built with their own
``bm_common.cuh`` and the port's nvcc flags.  They have that commit's C
interfaces, which this script names: ``bm_agg_and_sub(ops, n_ops, n_and,
or_mode, k, out, counts, stream)`` and ``bm_pipeline_counts(planes,
n_planes, plane_words, offs, codes, n_values, out, stream)``.  Both
versions run on the same inputs (chip_smoke.py's timing shapes: B4 at
configs 3 and 4b and over 1 and 32 never-dying operands, B5 at configs 4b
and 3), must agree bit for bit, and are timed old, new, new, old: medians
of 25 launches, CUDA events, L2 evicted before each (``chip_smoke.time_ms``).
Prints one JSON line per shape, then the card's name and power limit.
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
from bitmagic_tpu_torch.ops import _build, blockops  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

VP, INT = ctypes.c_void_p, ctypes.c_int


def build_old(old_dir):
    """The two sources of ``old_dir``, built side by side into it."""
    procs = []
    for src in ("agg_sub.cu", "pipeline_counts.cu"):
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
    b4 = libs["agg_sub.cu"].bm_agg_and_sub
    b4.argtypes = [VP, INT, INT, INT, INT, VP, VP, VP]
    b5 = libs["pipeline_counts.cu"].bm_pipeline_counts
    b5.argtypes = [VP, INT, ctypes.c_longlong, VP, VP, INT, VP, VP]
    b4.restype = b5.restype = INT
    return b4, b5


def main(argv):
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    device = torch.device("cuda")
    _build.build_all()
    old_b4, old_b5 = build_old(os.path.abspath(argv[0]))
    stream = torch.cuda.current_stream(device).cuda_stream
    rng = np.random.default_rng(cs.SEED + 9)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    ptr = ck._ptr

    def b4_case(K, n_and, nb, or_k=1):
        pool = cs._bits_pool(rng, K * nb, or_k, device)
        slots = torch.arange(K * nb, dtype=torch.int32,
                             device=device).reshape(K, nb)
        # the table points into descs' slot and FULL rows: keep them
        descs = blockops.arena_descriptors(n_and, slots, pool)
        table = ck._descriptor_table(descs, nb, device)
        res = [torch.empty((nb, 2048), dtype=torch.int32, device=device)
               for _ in range(2)]

        def old():
            cs.check(old_b4(ptr(table), K, n_and, 0, nb, ptr(res[0]), None,
                            stream) == 0, "old B4 launch")

        return old, cs._b4_single(ck, device, table, K, n_and, nb, res[1]), (
            res, table, descs, pool)

    def b5_case(key, S, nb, V):
        planes = cs._bits_pool(rng, S * nb, 1, device).reshape(S, nb, 2048)
        sel = cs._b5_selectors(rng, key, S, V)
        offs, codes = (torch.from_numpy(x).to(device)
                       for x in blockops.pipeline_codes(sel))
        buf, args = ck.pipeline_prepare(planes, sel)
        res = [torch.zeros(V, dtype=torch.int64, device=device)
               for _ in range(2)]

        def old():
            res[0].zero_()
            cs.check(old_b5(ptr(planes), S, nb * 2048, ptr(offs), ptr(codes),
                            V, ptr(res[0]), stream) == 0, "old B5 launch")

        def new():
            res[1].zero_()
            ck._launch("bm_pipeline_counts", "pipeline_counts", device,
                       *args, ptr(res[1]))

        return old, new, (res, buf, planes, offs, codes)

    # each case's inputs are made just before it is timed and freed after
    cases = {
        ("agg_and_sub", "config3"): lambda: b4_case(cs.AGG_K, cs.AGG_K // 2,
                                                    cs.AGG_BLOCKS),
        ("agg_and_sub", "config4b"): lambda: b4_case(cs.SV_BITS + 1, 11, 245),
        ("agg_and_sub", "1 never-dying operand x 128 columns"):
            lambda: b4_case(1, 1, cs.AGG_BLOCKS, or_k=6),
        ("agg_and_sub", "32 never-dying operands x 128 columns"):
            lambda: b4_case(32, 32, cs.AGG_BLOCKS, or_k=6),
        ("pipeline_counts", "config4b"): lambda: b5_case(
            "config4b", cs.SV_BITS + 1, 245, cs.SV_QUERIES),
        ("pipeline_counts", "config3"): lambda: b5_case(
            "config3", cs.AGG_K, cs.AGG_BLOCKS, cs.N_REQUESTS)}
    smi = cs.nvidia_smi("name,power.limit")
    for (kernel, shape), make in cases.items():
        old, new, keep = make()
        old()
        new()
        cs.sync()
        cs.check(torch.equal(keep[0][0], keep[0][1]),
                 f"{kernel} @ {shape}: old and new agree")
        t = {"old_ms": [cs.time_ms(old, flush)],
             "new_ms": [cs.time_ms(new, flush)]}
        t["new_ms"].append(cs.time_ms(new, flush))
        t["old_ms"].append(cs.time_ms(old, flush))
        cs.log(json.dumps({"kernel": kernel, "shape": shape, **t,
                           "card": smi}))
        del old, new, keep
    cs.log(cs.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
