#!/usr/bin/env python3
"""Time the port's gap_expand against a parent commit's, in turns, on one
NVIDIA card.

    git archive <parent> | tar -x -C _archive/parent
    python3 tools/torch_gap_turns.py [--parent _archive/parent]

The parent's ``bitmagic_tpu_torch/ops/csrc/gap_rows.cu`` is built with
its own ``bm_common.cuh`` and the port's nvcc flags, and called through
its C interface (``bm_gap_expand(ends, offs, first, sel, k, out,
stream)``: one store per launch).  The stores are
``bvsetalgebra_rank_select``'s (``chip_smoke.gap_stores``: two stores of
768 D-GAP blocks of 1 to 256 runs).  Times are medians of 25 runs between
CUDA events, L2 evicted before each (``chip_smoke.time_ms``); every
answer must equal the plain version's.

turns: parent, new, new, parent, at 768 blocks of one store
    (``chip_smoke``'s ``cell1_768``), and at one operation's expansion of
    both stores: the parent's two launches against one pair launch.
blocks: parent, new, new, parent at one block of 1280, 3000 and 65536
    runs (``chip_smoke.gap_cases``).
floor: a one-element ``zero_()`` timed the same way.

Prints one JSON line per measurement, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench_torch as bt  # noqa: E402
import chip_smoke as cs  # noqa: E402
from bitmagic_tpu_torch.ops import _build  # noqa: E402
from bitmagic_tpu_torch.ops import blockops  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from torch_gather_turns import INT, VP, build_old  # noqa: E402


def turns(fns, flush, order=("parent", "new", "new", "parent")):
    """{name: [ms, ...]} of ``fns`` timed in ``order``."""
    ms = {k: [] for k in fns}
    for name in order:
        ms[name].append(cs.time_ms(fns[name], flush))
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "_archive",
                                                     "parent"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gap_turns: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build_all()
    for line in _build.build_log.get("gap_rows.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"new gap_rows.cu: {line.strip()}")
    lib = build_old(os.path.join(args.parent, "bitmagic_tpu_torch", "ops",
                                 "csrc"), ("gap_rows.cu",))["gap_rows.cu"]
    old = lib.bm_gap_expand
    old.argtypes = [VP, VP, VP, VP, INT, VP, VP]
    old.restype = INT
    card = bt.card_line()
    rng = np.random.default_rng(cs.SEED + 21)
    sa, sb = cs.gap_stores(rng)
    ma, mb = sa.device_arrays(dev), sb.device_arrays(dev)
    every = torch.arange(cs.GAP_BLOCKS, dtype=torch.int32, device=dev)
    both = torch.cat([every, every])
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=dev)

    def parent(m, sel):
        out = torch.empty((sel.shape[0], 2048), dtype=torch.int32,
                          device=dev)
        err = old(*(t.data_ptr() for t in m), sel.data_ptr(), sel.shape[0],
                  out.data_ptr(), stream)
        cs.check(err == 0, f"parent gap_expand: CUDA error {err}")
        return out

    def parent_pair():
        return torch.cat([parent(ma, every), parent(mb, every)])

    def checked(fns, want):
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"{name} equals the plain "
                     f"version")
        return fns

    lines = [{"measure": "floor", "ms": cs.time_ms(
        torch.empty(1, dtype=torch.int32, device=dev).zero_, flush)}]
    one = checked({"parent": lambda: parent(ma, every),
                   "new": lambda: ck.gap_expand(*ma, every)},
                  blockops.gap_expand(*ma, every))
    lines.append({"measure": "turns", "shape": "cell1_768",
                  "runs": int(sa.offs[-1]), "ms": turns(one, flush)})
    pair = checked({"parent": parent_pair,
                    "new": lambda: ck.gap_expand_pair(ma, mb, both,
                                                      cs.GAP_BLOCKS)},
                   blockops.gap_expand_pair(ma, mb, both, cs.GAP_BLOCKS))
    lines.append({"measure": "turns", "shape": "cell1_pair",
                  "what": "parent: two launches, new: one pair launch",
                  "runs": int(sa.offs[-1] + sb.offs[-1]),
                  "ms": turns(pair, flush)})
    # store A of the gap cases: its blocks 5, 7 and 8 hold 1280, 3000 and
    # 65536 runs
    m = cs.gap_cases(rng, dev)[0][1]
    for shape, blk in (("runs_1280", 5), ("runs_3000", 7),
                       ("runs_65536", 8)):
        sel = torch.tensor([blk], dtype=torch.int32, device=dev)
        fns = checked({"parent": lambda sel=sel: parent(m, sel),
                       "new": lambda sel=sel: ck.gap_expand(*m, sel)},
                      blockops.gap_expand(*m, sel))
        lines.append({"measure": "blocks", "shape": shape,
                      "ms": turns(fns, flush)})
    for line in lines:
        print(json.dumps({**line, "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
