#!/usr/bin/env python3
"""Time the port's K1 (logical_op_digest) against earlier trees' K1, in
turns, on one NVIDIA card.

    git archive 3ae8acf bitmagic_tpu_torch/ops/csrc | tar -x -C DIR
    python3 tools/torch_k1_turns.py [NAME=]DIR/bitmagic_tpu_torch/ops/csrc \
        [[NAME=]DIR2/... ...] [--rounds N] [--shapes aligned_1536,...] \
        [--clocks FILE] [--hold CYCLES]

Each DIR's ``logical_op_digest.cu`` is built with its own
``bm_common.cuh`` (``torch_gather_turns.build_old``).  A DIR without a
NAME is the arm ``parent``.  The earlier trees are called by ctypes
through the C interface of 3ae8acf, which is also this tree's:
``bm_logical_op_digest(op, a (7 arguments), b (7 arguments), k, out,
digest, stream)``, on the C arguments this tree's ``cuda_kernels``
builds, their outputs allocated as the wrapper allocates them; this
tree's K1 (arm ``new``) runs through its wrapper.  Shapes (by default):
aligned at 1536 and 16384 rows (``chip_smoke._rand_pool``), and the
gather form at config 1's candidate-block descriptors (the ``cfg1`` that
``chip_smoke.timings`` is given: ``chip_smoke.k2_operands`` of configs
1-2's A and B).  At every shape every arm must agree with this tree's K1
bit for bit, rows and digests, for each of the four operations.

Each round times the arms in turns, in order and then in reverse (the
earlier trees, ``new``, and ``torch.bitwise_and`` at the aligned shapes),
with L2 left dirty and then clean (``chip_smoke.time_ms``: the median of
25 launches, CUDA events, L2 evicted before each and the launch held
back ``--hold`` clock cycles after it; 0 holds nothing).  Per shape and
L2 state it prints one JSON line: each arm's medians, their median
(``usual``), its share of the bound, the median host ms an arm takes to
enqueue a launch beside the flush's device ms, and the medians above
1.5 times ``usual`` (``slow``), each with its 25 launch times, their
host ms and the host's clock when it ended.  With ``--clocks FILE``, ``nvidia-smi`` writes the card's clocks,
power and clock-event reasons into FILE every 100 ms meanwhile.  Prints
both builds' registers first and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import bitmagic_tpu_torch as tbm  # noqa: E402
from bitmagic_tpu_torch.ops import _build, blockops  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from torch_gather_turns import INT, VP, build_old, peak_bw  # noqa: E402
from torch_sv_turns import c_fn, call, checked  # noqa: E402

OPERAND = [VP, INT, VP, VP, VP, INT, VP]
ROW = 8192
SHAPES = ("aligned_1536", "aligned_16384", "config1_gather")
SLOW = 1.5
CLOCKS = ("timestamp,clocks.sm,clocks.mem,power.draw,temperature.gpu,"
          "clocks_throttle_reasons.active")


def old_k1(csrc):
    """An earlier tree's ops/csrc -> its built K1 entry."""
    return c_fn(build_old(csrc, ["logical_op_digest.cu"])
                ["logical_op_digest.cu"], "bm_logical_op_digest",
                [INT] + OPERAND + OPERAND + [INT, VP, VP, VP])


def old_side(f, a_args, b_args, k, dev):
    """An earlier tree's K1 entry on this tree's wrapper arguments -> op ->
    (rows, digest)."""
    def run(op):
        out = torch.empty((k, 2048), dtype=torch.int32, device=dev)
        dig = torch.empty((k, 64), dtype=torch.int32, device=dev)
        call(f, "old K1", blockops.OP_CODES[op], *a_args, *b_args, k,
             out.data_ptr(), dig.data_ptr())
        return out, dig
    return run


def turns(fns, flush, clean, rounds, hold):
    """Each arm's medians, and of each median (median, launch times, the
    host's ms to enqueue each launch, host clock), over ``rounds`` rounds
    of turns: in order, then in reverse."""
    names = list(fns)
    ms = {x: [] for x in names}
    runs = {x: [] for x in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            ts, host = [], []

            def fn(f=fns[name]):
                t0 = time.perf_counter()
                f()
                host.append((time.perf_counter() - t0) * 1e3)
            m = cs.time_ms(fn, flush, clean=clean, samples=ts, hold=hold)
            ms[name].append(m)
            runs[name].append((m, ts, host[1:],
                               datetime.datetime.now().strftime(
                                   "%Y/%m/%d %H:%M:%S.%f")[:-3]))
    return ms, runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+",
                    help="[NAME=]DIR: an earlier tree's ops/csrc")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated: aligned_<rows> or "
                         "config1_gather")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns (each arm twice a round)")
    ap.add_argument("--clocks", help="file for nvidia-smi's samples")
    ap.add_argument("--hold", type=int, default=cs.HOLD_CYCLES,
                    help="clock cycles each timed launch is held back "
                         "after the flush (chip_smoke.time_ms)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_turns: needs an NVIDIA card", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) if "=" in t else ("parent", t)
                 for t in args.trees)
    dev = torch.device("cuda")
    _build.build_all()
    trees = {t: old_k1(os.path.abspath(d)) for t, d in trees.items()}
    for line in _build.build_log.get("logical_op_digest.cu",
                                     "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"new: {line.strip()}")
    rng = np.random.default_rng(cs.SEED + 4)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=dev)
    clean = torch.empty_like(flush)
    a_vec, b_vec, _ = cs.build_main_vectors(tbm, cs.N_BLOCKS, dev, {})
    cfg1 = cs.k2_operands(a_vec, b_vec)
    del a_vec, b_vec

    def shape_case(name):
        """-> (a args, b args, k, new call(op), library call or None,
        bytes to move, shape fields)."""
        if name == "config1_gather":
            da, db = cfg1
            k = da[1].shape[0]
            reads = cs.desc_rows_read(da) + cs.desc_rows_read(db)
            return (ck._operand(da, k, "a"), ck._operand(db, k, "b"), k,
                    lambda op: ck.binary_op_digest(op, da, db), None,
                    reads * ROW + k * (ROW + 256) + 2 * k * 9,
                    dict(rows=k, rows_read=reads))
        n = int(name.split("_")[1])
        a, b = cs._rand_pool(rng, n, dev), cs._rand_pool(rng, n, dev)
        return (ck._aligned(a, "a"), ck._aligned(b, "b"), n,
                lambda op: ck.logical_op_digest(op, a, b),
                lambda: torch.bitwise_and(a, b), 3 * n * ROW + n * 256,
                dict(rows=n))

    smi = cs.nvidia_smi("name,power.limit")
    memset_ms = cs.time_ms(flush.zero_, clean)
    sampler = None
    if args.clocks:
        with open(args.clocks, "w") as log:
            sampler = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={CLOCKS}", "--format=csv",
                 "-lms", "100"], stdout=log, stderr=subprocess.STDOUT)
    try:
        for name in args.shapes.split(","):
            a_args, b_args, k, new, lib, nbytes, extra = shape_case(name)
            sides = {t: old_side(f, a_args, b_args, k, dev)
                     for t, f in trees.items()}
            sides["new"] = new
            for op in cs.OPS:
                checked({t: (lambda f=f: f(op)) for t, f in sides.items()},
                        new(op))
            fns = {t: (lambda f=f: f("and")) for t, f in sides.items()}
            if lib is not None:
                fns["bitwise_and"] = lib
            bound_ms = nbytes / peak_bw() * 1e3
            for state, cl in (("dirty", None), ("clean", clean)):
                ms, runs = turns(fns, flush, cl, args.rounds, args.hold)
                usual = {x: float(np.median(v)) for x, v in ms.items()}
                slow = {x: [dict(ms=m, launches=ts, host_ms=host, at=at)
                            for m, ts, host, at in runs[x]
                            if m > SLOW * usual[x]]
                        for x in ms}
                host = {x: float(np.median([h for r in runs[x]
                                            for h in r[2]]))
                        for x in ms}
                cs.log(json.dumps({
                    "kernel": "logical_op_digest", "shape": name,
                    "l2": state, "hold": args.hold, "usual": usual,
                    "n_slow": {x: len(v) for x, v in slow.items()},
                    "n": {x: len(v) for x, v in ms.items()},
                    "host_ms": host, "memset_ms": memset_ms,
                    "share_of_bound": {x: bound_ms / u
                                       for x, u in usual.items()},
                    "bound_ms": bound_ms, "bytes": nbytes, **extra,
                    "ms": ms, "slow": slow, "card": smi}))
            del sides, fns, new, lib
    finally:
        if sampler is not None:
            sampler.terminate()
            sampler.wait()
    cs.log(cs.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
