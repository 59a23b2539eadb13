#!/usr/bin/env python3
"""Time the port's sv_transpose, sv_descent and descent_rows against a
parent commit's, in turns, on one NVIDIA card.

    git archive <parent> | tar -x -C _archive/parent
    python3 tools/torch_sv_turns.py [--parent _archive/parent]
                                    [--arms transpose,descent]

The parent's ``bitmagic_tpu_torch/ops/csrc/sv_planes.cu`` and
``sv_descent.cu`` are built with its own ``bm_common.cuh`` and the port's
nvcc flags, and called through their C interfaces with this tree's
arguments: ``bm_sv_transpose``, ``bm_sv_descent`` (the walked blocks'
entry codes; its classes a byte each, where this tree's are int32 with a
D-GAP result's run count above) and ``bm_descent_rows``.  This tree's
kernels are called through their C interfaces too, on the same inputs
(no wrapper's host work in the timed span).  Each side is first held bit
for bit against the plain version at every shape it is timed at.  Times
are medians of 25 runs between CUDA events, L2 evicted before each
(``chip_smoke.time_ms``), in turns (parent, new, new, parent; with
``--variants``, each further tree between new and its mirror): ``ms``
after the eviction's memset alone, as ``chip_smoke.py`` times every
kernel (L2 left full of dirty lines, which a run's reads write back: up
to 50 MB more device-memory traffic), and ``ms_clean_l2`` with a read
pass after the memset (L2 left clean).

transpose: config 4b's import (``chip_smoke.SV_N`` = 16,000,000 4-byte
    values < 2^20, 20 slices), 16M 8-byte values x 64 slices, 1M 4-byte
    values x 20 slices, and 16M - 333 values (no multiple of 1024) x 20.
descent: sv_descent at column_range_gather's shape (config 4b's nullable
    column, find_gt(0x5A5A5): 20 steps over 245 blocks, gt only;
    ``chip_smoke.descent_timings``), and descent_rows at one shard of
    ``chip_smoke.SHARDS`` of the same column (31 rows) and at the eight
    shards' rows in one stack (248).
floor: a one-element ``zero_()`` timed the same way.

Prints one JSON line per measurement (with each kernel's bound at the
card's memory rate), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
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
import bitmagic_tpu_torch as tbm  # noqa: E402
from bitmagic_tpu_torch.core.bitvector import descent_args  # noqa: E402
from bitmagic_tpu_torch.ops import _build  # noqa: E402
from bitmagic_tpu_torch.ops import blockops  # noqa: E402
from torch_gather_turns import (INT, LL, VP, build_old,  # noqa: E402
                                peak_bw, stream)

ULL = ctypes.c_ulonglong
IP = ctypes.POINTER(INT)


def turns(fns, flush, clean=None):
    """{name: [ms, ...]} of ``fns`` (parent first) timed in turns: each in
    order, then in reverse order."""
    names = list(fns)
    ms = {k: [] for k in names}
    for name in names + names[::-1]:
        ms[name].append(cs.time_ms(fns[name], flush, clean=clean))
    return ms


def timed(fns, flush, clean):
    """Both timings of ``fns`` in turns: L2 dirty, then L2 clean."""
    return {"ms": turns(fns, flush), "ms_clean_l2": turns(fns, flush, clean)}


def checked(fns, want):
    """``fns`` after each one's answer equals ``want`` (tuples: each
    element that is not None)."""
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        cs.check(all(w is None or torch.equal(g, w) for g, w in pairs),
                 f"{name} equals the plain version")
    return fns


def c_fn(lib, name, argtypes):
    f = getattr(lib, name)
    f.argtypes = argtypes
    f.restype = INT
    return f


def call(f, what, *args):
    err = f(*args, stream())
    cs.check(err == 0, f"{what}: CUDA error {err}")


def transpose_side(lib, dev):
    """sv_transpose through one built tree's C interface."""
    f = c_fn(lib, "bm_sv_transpose", [VP, LL, INT, INT, VP, VP])

    def run(vals, n_slices):
        out = torch.empty((n_slices, -(-vals.shape[0] // 32)),
                          dtype=torch.int32, device=dev)
        call(f, "sv_transpose", vals.data_ptr(), vals.shape[0],
             vals.element_size(), n_slices, out.data_ptr())
        return out
    return run


def rows_side(lib):
    """descent_rows through one built tree's C interface (mode 0)."""
    f = c_fn(lib, "bm_descent_rows",
             [VP, INT, LL, VP, VP, INT, IP, INT, ULL, VP, VP, VP])

    def run(st, uni, rows, bits):
        gt, eq = torch.empty_like(uni), torch.empty_like(uni)
        call(f, "descent_rows", st.data_ptr(), st.shape[0], st.shape[1],
             uni.data_ptr(), None, 0, (INT * len(rows))(*rows), len(rows),
             bits, gt.data_ptr(), eq.data_ptr())
        return gt, eq
    return run


def transpose_arm(sides, dev, rng, flush, clean, bw):
    runs = {k: transpose_side(v["sv_planes.cu"], dev)
            for k, v in sides.items()}
    lines = []
    for shape, n, n_slices, dt in (
            ("16M_20", cs.SV_N, cs.SV_BITS, np.uint32),
            ("16M_64_8byte", cs.SV_N, 64, np.uint64),
            ("1M_20", 1 << 20, cs.SV_BITS, np.uint32),
            ("16M-333_20", cs.SV_N - 333, cs.SV_BITS, np.uint32)):
        top = 1 << n_slices if n_slices < 64 else 2**64
        v = rng.integers(0, top, n, dtype=np.uint64).astype(dt)
        vals = torch.from_numpy(v.view(np.int32 if dt == np.uint32
                                       else np.int64)).to(dev)
        fns = checked({k: (lambda f=f: f(vals, n_slices))
                       for k, f in runs.items()},
                      blockops.sv_transpose(vals, n_slices))
        nbytes = vals.numel() * vals.element_size() + 4 * n_slices * (
            -(-n // 32))
        lines.append({"measure": "transpose", "shape": shape,
                      "bytes": nbytes, "bound_ms": nbytes / bw * 1e3,
                      **timed(fns, flush, clean)})
    return lines


def descent_arm(sides, dev, rng, flush, clean, bw):
    from bitmagic_tpu_torch.parallel import Mesh, ShardedSparseVector
    vals = rng.integers(0, 1 << cs.SV_BITS, cs.SV_N).astype(np.uint32)
    sv = tbm.SparseVector.from_array(vals, nullable=True, device=dev)
    table, steps, _ = tbm.scanner._descent_steps(sv, cs.DESCENT_GT,
                                                 sv.n_slices)
    uni = sv.null_plane
    blocks = np.union1d(table.blocks, uni._struct.nb)
    args = descent_args(table, uni, steps, blocks)
    utable, codes, rows, bits = args
    c_rows = (INT * len(rows))(*rows)
    k = blocks.size

    def side(lib, cls_dtype):
        f = c_fn(lib, "bm_sv_descent",
                 [VP, INT, VP, VP, LL, IP, INT, ULL, VP, VP, VP, VP, VP])

        def run():
            gt = torch.empty((k, 2048), dtype=torch.int32, device=dev)
            dig = torch.empty((k, 64), dtype=torch.int32, device=dev)
            cls = torch.empty(2 * k, dtype=cls_dtype, device=dev)
            call(f, "sv_descent", table.table.data_ptr(), table.meta.shape[0],
                 utable.table.data_ptr(), codes.data_ptr(), k, c_rows,
                 len(rows), bits, gt.data_ptr(), dig.data_ptr(), None, None,
                 cls.data_ptr())
            return gt, dig, None, None, cls
        return run

    want = blockops.sv_descent(table, *args, False)
    # the parent's classes: a byte each, the class alone
    old = (*want[:4], (want[4] & 0xFF).to(torch.uint8))
    fns = checked({"parent": side(sides["parent"]["sv_descent.cu"],
                                  torch.uint8)}, old)
    fns.update(checked({k: side(v["sv_descent.cu"], torch.int32)
                        for k, v in sides.items() if k != "parent"}, want))
    planes = [sv.planes[int(table.meta[r, -1])] for r in rows]
    nbytes = bt.descent_bytes(planes, uni, k)
    lines = [{"measure": "sv_descent", "shape": "cell3", "blocks": k,
              "steps": len(rows), "bytes": nbytes,
              "bound_ms": nbytes / bw * 1e3, **timed(fns, flush, clean)}]
    ssv = ShardedSparseVector.from_sparse_vector(sv, Mesh([dev] * cs.SHARDS))
    drows, dbits = blockops.descent_steps(list(range(ssv.n_eff)),
                                          cs.DESCENT_GT)
    whole = torch.cat(list(ssv.stack), dim=1)
    runs = {k: rows_side(v["sv_descent.cu"]) for k, v in sides.items()}
    for shape, st in (("shard_of_8", ssv.stack[0]), ("8_shards", whole)):
        u = st[ssv.UNI]
        fns = checked({k: (lambda f=f: f(st, u, drows, dbits))
                       for k, f in runs.items()},
                      blockops.descent_rows(st, u, drows, dbits))
        nb = st.shape[1]
        nbytes = (len(drows) + 3) * nb * 8192
        lines.append({"measure": "descent_rows", "shape": shape,
                      "blocks": nb, "steps": len(drows), "bytes": nbytes,
                      "bound_ms": nbytes / bw * 1e3,
                      **timed(fns, flush, clean)})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "_archive",
                                                     "parent"))
    ap.add_argument("--variants", default="",
                    help="name=DIR,...: more trees whose kernels take this "
                         "tree's C interfaces, timed in the same turns")
    ap.add_argument("--arms", default="transpose,descent")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sv_turns: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build_all()
    for src in ("sv_planes.cu", "sv_descent.cu"):
        for line in _build.build_log.get(src, "").splitlines():
            if any(w in line for w in ("registers", "spill", "entry")):
                cs.log(f"new {src}: {line.strip()}")
    trees = {"parent": args.parent}
    trees.update(v.split("=", 1) for v in args.variants.split(",") if v)
    sides = {name: build_old(os.path.join(root, "bitmagic_tpu_torch", "ops",
                                          "csrc"),
                             ("sv_planes.cu", "sv_descent.cu"))
             for name, root in trees.items()}
    sides = {"parent": sides.pop("parent"),
             "new": {src: _build.load(src)
                     for src in ("sv_planes.cu", "sv_descent.cu")},
             **sides}
    card = bt.card_line()
    rng = np.random.default_rng(cs.SEED + 22)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=dev)
    clean = torch.empty_like(flush)
    bw = peak_bw()
    lines = [{"measure": "floor", "ms": cs.time_ms(
        torch.empty(1, dtype=torch.int32, device=dev).zero_, flush)}]
    arms = args.arms.split(",")
    if "transpose" in arms:
        lines += transpose_arm(sides, dev, rng, flush, clean, bw)
    if "descent" in arms:
        lines += descent_arm(sides, dev, rng, flush, clean, bw)
    for line in lines:
        print(json.dumps({**line, "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
