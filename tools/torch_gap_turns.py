#!/usr/bin/env python3
"""Time the port's D-GAP kernels (gap_compress, gap_expand) against a
parent commit's, in turns, on one NVIDIA card.

    git archive <parent> | tar -x -C _archive/parent
    python3 tools/torch_gap_turns.py [--parent _archive/parent]
                                     [--variant name=CSRC ...]

The parent's ``bitmagic_tpu_torch/ops/csrc/gap_rows.cu`` is built with
its own ``bm_common.cuh`` and the port's nvcc flags, and called through
its C interface: ``bm_gap_compress`` where it has one (a memset of the
call's scratch, then one launch into a packed buffer), else the two
passes ``bm_gap_count`` and ``bm_gap_write``; ``bm_gap_expand`` of a
pair of stores (both trees' pair interface).  This tree's kernels are
called through their C interfaces too, and so is each ``--variant``:
another ``gap_rows.cu`` (with a ``bm_common.cuh`` beside it) that has
this tree's C interface, timed in the same turns.  The stores are
``bvsetalgebra_rank_select``'s (``chip_smoke.gap_stores``: two stores of 768 D-GAP blocks of 1 to 256
runs); the compressed rows are the AND of their first 400 blocks
(``chip_smoke``'s ``cell1_400``), with ``cap`` the pairs' summed runs as
``core/bitvector._binary`` passes it.  Every answer must equal the plain
version's.  Device times are medians of 25 runs between CUDA events, L2
evicted before each (``chip_smoke.time_ms``), in turns (parent, new,
new, parent): ``ms`` after the eviction's memset alone (L2 left full of
dirty lines) and ``ms_clean_l2`` with a read pass after it.

compress_launch: the parent's two launches (offsets scanned beforehand)
    against one launch, at cell1_400, at 20,000
    rows of 1 to 256 runs (``chip_smoke.compress_cases``) and at 8 rows
    of 65536 runs.
compress_call: each tree's whole call at cell1_400: the parent's two
    launches with the ``torch.cumsum`` and the scalar sync between them,
    against the allocation and the one launch.
compress_rows: host wall (median of 21, each ending in a synchronize)
    of the call and its one download into a host store: the parent's
    ``torch.cat`` of offs, first and ends and a copy, against the packed
    buffer's copy (``GapStore.from_packed``).
expand: gap_expand of one store's 768 blocks and of both stores' in one
    pair launch (the same kernel in both trees: a check on the turns'
    noise).
floor: a one-element ``zero_()`` timed the same way.

Prints one JSON line per measurement, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench_torch as bt  # noqa: E402
import chip_smoke as cs  # noqa: E402
from bitmagic_tpu_torch.core.gapstore import GapStore  # noqa: E402
from bitmagic_tpu_torch.ops import _build  # noqa: E402
from bitmagic_tpu_torch.ops import blockops  # noqa: E402
from torch_gather_turns import INT, LL, VP, build_old, peak_bw  # noqa: E402
from torch_sv_turns import c_fn, call, checked, timed, turns  # noqa: E402

ROW = 8192


def compress_side(lib, dev):
    """gap_compress through one built tree's C interface -> (one
    launch over prepared outputs, the whole call -> the packed buffer or
    (ends, offs, first), the call and the download into a host store)."""
    if hasattr(lib, "bm_gap_compress"):
        f = c_fn(lib, "bm_gap_compress", [VP, INT, LL, VP, VP, VP])

        def buffers(rows, cap):
            n = rows.shape[0]
            return (torch.empty(2 * n + 1 + cap, dtype=torch.int32,
                                device=dev),
                    torch.empty(n + 1, dtype=torch.int64, device=dev))

        def launch(rows, cap, out, scratch):
            call(f, "gap_compress", rows.data_ptr(), rows.shape[0], cap,
                 out.data_ptr(), scratch.data_ptr())

        def prepared(rows, cap):
            bufs = buffers(rows, cap)
            return lambda: launch(rows, cap, *bufs)

        def whole(rows, cap):
            bufs = buffers(rows, cap)
            launch(rows, cap, *bufs)
            return bufs[0]

        def host(rows, cap):
            return GapStore.from_packed(whole(rows, cap), rows.shape[0])
        return prepared, whole, host
    count = c_fn(lib, "bm_gap_count", [VP, INT, VP, VP, VP])
    write = c_fn(lib, "bm_gap_write", [VP, INT, VP, VP, VP])

    def whole(rows, cap):
        n = rows.shape[0]
        counts = torch.empty(n, dtype=torch.int32, device=dev)
        first = torch.empty(n, dtype=torch.uint8, device=dev)
        offs = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        call(count, "gap_count", rows.data_ptr(), n, counts.data_ptr(),
             first.data_ptr())
        offs[1:] = torch.cumsum(counts + 1, 0, dtype=torch.int32)
        ends = torch.empty(int(offs[-1]), dtype=torch.int32, device=dev)
        call(write, "gap_write", rows.data_ptr(), n, offs.data_ptr(),
             ends.data_ptr())
        return ends, offs, first

    def prepared(rows, cap):
        ends, offs, first = whole(rows, cap)
        n = rows.shape[0]
        counts = torch.empty(n, dtype=torch.int32, device=dev)

        def run():
            call(count, "gap_count", rows.data_ptr(), n, counts.data_ptr(),
                 first.data_ptr())
            call(write, "gap_write", rows.data_ptr(), n, offs.data_ptr(),
                 ends.data_ptr())
        return run

    def host(rows, cap):
        ends, offs, first = whole(rows, cap)
        n = first.shape[0]
        h = torch.cat([offs, first.to(torch.int32), ends]).cpu().numpy()
        return GapStore(h[2 * n + 1:], h[:n + 1],
                        h[n + 1:2 * n + 1].astype(np.uint8))
    return prepared, whole, host


def packed(got, n):
    """The defined part of a packed buffer, or the parent's three
    arrays, as (ends, offs, first int32)."""
    if isinstance(got, tuple):
        ends, offs, first = got
        return ends, offs, first.to(torch.int32)
    return blockops.gap_unpack(got, n)


def wall_turns(fns, reps=21):
    """{name: [host ms, ...]}: the median of ``reps`` calls of each of
    ``fns`` (each ending in a synchronize), in turns as ``turns``."""
    names = list(fns)
    ms = {k: [] for k in names}
    for name in names + names[::-1]:
        fns[name]()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms[name].append(float(np.median(walls)))
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "_archive",
                                                     "parent"))
    ap.add_argument("--variant", action="append", default=[],
                    help="name=CSRC: another gap_rows.cu with this tree's "
                         "C interface, timed in the same turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gap_turns: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build_all()
    for line in _build.build_log.get("gap_rows.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"new gap_rows.cu: {line.strip()}")
    libs = {"parent": build_old(os.path.join(
        args.parent, "bitmagic_tpu_torch", "ops", "csrc"),
        ("gap_rows.cu",))["gap_rows.cu"],
        "new": _build.load("gap_rows.cu")}
    for v in args.variant:
        name, csrc = v.split("=", 1)
        libs[name] = build_old(csrc, ("gap_rows.cu",))["gap_rows.cu"]
    card = bt.card_line()
    bw = peak_bw()
    rng = np.random.default_rng(cs.SEED + 21)
    sa, sb = cs.gap_stores(rng)
    ma, mb = sa.device_arrays(dev), sb.device_arrays(dev)
    every = torch.arange(cs.GAP_BLOCKS, dtype=torch.int32, device=dev)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=dev)
    clean = torch.empty_like(flush)
    lines = [{"measure": "floor", "ms": cs.time_ms(
        torch.empty(1, dtype=torch.int32, device=dev).zero_, flush)}]

    expand = {}
    for name, lib in libs.items():
        f = c_fn(lib, "bm_gap_expand", [VP] * 7 + [INT, INT, VP, VP])

        def run(sel, k_a, f=f):
            out = torch.empty((sel.shape[0], 2048), dtype=torch.int32,
                              device=dev)
            call(f, "gap_expand", *(t.data_ptr() for t in ma),
                 *(t.data_ptr() for t in mb), sel.data_ptr(), k_a,
                 sel.shape[0], out.data_ptr())
            return out
        expand[name] = run
    rows = expand["new"](torch.cat([every[:cs.GAP_PAIRS]] * 2),
                         cs.GAP_PAIRS)
    rows = rows[:cs.GAP_PAIRS] & rows[cs.GAP_PAIRS:]
    cap = int(sa.n_runs()[:cs.GAP_PAIRS].sum()
              + sb.n_runs()[:cs.GAP_PAIRS].sum())
    sides = {k: compress_side(v, dev) for k, v in libs.items()}
    cases = [("cell1_400", rows, cap)]
    for name, r, c, _ in cs.compress_cases(rng, dev):
        if name in ("rows_20000", "runs_65536"):
            cases.append((name, r, c))
    for shape, r, c in cases:
        n = r.shape[0]
        want = packed(blockops.gap_compress(r, c), n)
        for name, (_, whole, _) in sides.items():
            got = packed(whole(r, c), n)
            torch.cuda.synchronize()
            cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                     f"{name} gap_compress {shape} equals the plain version")
        total = int(want[1][-1])
        nbytes = n * ROW + 4 * total + 4 * (n + 1) + n
        fns = {k: v[0](r, c) for k, v in sides.items()}
        lines.append({"measure": "compress_launch", "shape": shape,
                      "rows": n, "runs": total, "cap": c, "bytes": nbytes,
                      "bound_ms": nbytes / bw * 1e3,
                      **timed(fns, flush, clean)})
    lines.append({"measure": "compress_call", "shape": "cell1_400",
                  "ms": turns({k: (lambda w=v[1]: w(rows, cap))
                               for k, v in sides.items()}, flush)})
    want = GapStore.from_dense(blockops.to_host_words(rows))
    for name, (_, _, host) in sides.items():
        got = host(rows, cap)
        cs.check(all(np.array_equal(getattr(got, key), getattr(want, key))
                     for key in ("ends", "offs", "first")),
                 f"{name} compress_rows equals GapStore.from_dense")
    lines.append({"measure": "compress_rows", "shape": "cell1_400",
                  "host_ms": wall_turns({k: (lambda h=v[2]: h(rows, cap))
                                         for k, v in sides.items()})})
    both = torch.cat([every, every])
    for shape, sel, k_a in (("cell1_768", every, cs.GAP_BLOCKS),
                            ("cell1_pair", both, cs.GAP_BLOCKS)):
        fns = checked({k: (lambda f=f: f(sel, k_a))
                       for k, f in expand.items()},
                      blockops.gap_expand_pair(ma, mb, sel, k_a))
        lines.append({"measure": "expand", "shape": shape,
                      **timed(fns, flush, clean)})
    for line in lines:
        print(json.dumps({**line, "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
