"""Inverted-list compression benchmark (reference utils/inv_list analog).

The reference's `utils/inv_list/inv_list.cpp` is the harness behind its
published Gov2 compression studies (reference README.md:121-123): read
sorted integer lists, build bit-vectors, serialize at various levels and
report bytes/int.  This tool does the same over either a Gov2-style flat
binary file (u32 count + u32 ids per list, little-endian) or synthetic
lists, for both the native BMT1 format and the reference-compatible
format (serial/refcodec.py).

Usage:
  python tools_torch/inv_list.py                      # synthetic corpus
  python tools_torch/inv_list.py --file lists.bin     # Gov2-style flat file
  python tools_torch/inv_list.py --levels 4,6 --format ref

Runs on the card; with BMTPU_PLATFORM=cpu on the CPU.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch import BitVector  # noqa: E402
from bitmagic_tpu_torch.serial import refcodec, serializer  # noqa: E402


def read_gov2_flat(path, max_lists):
    """Yield sorted u32 id arrays from a flat (count, ids...) binary file."""
    with open(path, "rb") as f:
        k = 0
        while k != max_lists:
            hdr = f.read(4)
            if len(hdr) < 4:
                return
            n = int(np.frombuffer(hdr, "<u4")[0])
            ids = np.frombuffer(f.read(4 * n), "<u4").astype(np.int64)
            yield ids
            k += 1


def synthetic(rng, n_lists=40):
    """Mixed-density postings lists like the reference's test corpus."""
    space = 30_000_000
    for k in range(n_lists):
        kind = k % 4
        if kind == 0:        # rare term
            yield np.unique(rng.integers(0, space, 500))
        elif kind == 1:      # medium
            yield np.unique(rng.integers(0, space, 50_000))
        elif kind == 2:      # common, clustered
            starts = rng.integers(0, space - 3000, 300)
            yield np.unique(np.concatenate(
                [np.arange(s, s + rng.integers(5, 2000)) for s in starts]))
        else:                # stop-word-like
            yield np.unique(rng.integers(0, space // 4, 1_500_000))


def main(argv=None):
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    ap = argparse.ArgumentParser()
    ap.add_argument("--file", help="Gov2-style flat file (u32 count + ids)")
    ap.add_argument("--max-lists", type=int, default=40)
    ap.add_argument("--levels", default="0,4,6")
    ap.add_argument("--format", choices=["bmt1", "ref", "both"],
                    default="both")
    args = ap.parse_args(argv)

    levels = [int(x) for x in args.levels.split(",")]
    lists = (read_gov2_flat(args.file, args.max_lists) if args.file
             else synthetic(np.random.default_rng(42), args.max_lists))

    fmts = []
    if args.format in ("bmt1", "both"):
        fmts.append(("BMT1", lambda bv, lv: serializer.serialize(bv, lv)))
    if args.format in ("ref", "both"):
        fmts.append(("ref ", lambda bv, lv: refcodec.ref_serialize(bv, lv)))

    tot_ints = 0
    tot_bytes = {(f, lv): 0 for f, _ in fmts for lv in levels}
    tot_time = dict(tot_bytes)
    n_lists = 0
    for ids in lists:
        if ids.size == 0:
            continue
        n_lists += 1
        tot_ints += ids.size
        bv = BitVector.from_indices(ids, int(ids[-1]) + 1)
        bv.optimize()
        for fname, fn in fmts:
            for lv in levels:
                t0 = time.perf_counter()
                blob = fn(bv, lv)
                tot_time[(fname, lv)] += time.perf_counter() - t0
                tot_bytes[(fname, lv)] += len(blob)

    print(f"# {n_lists} lists, {tot_ints} ints total")
    print(f"{'format':8} {'level':5} {'bytes/int':>10} {'bits/int':>9} "
          f"{'Mint/s':>8}")
    for (fname, lv), b in tot_bytes.items():
        bpi = b / tot_ints
        rate = tot_ints / max(tot_time[(fname, lv)], 1e-9) / 1e6
        print(f"{fname:8} {lv:5} {bpi:10.3f} {bpi * 8:9.3f} {rate:8.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
