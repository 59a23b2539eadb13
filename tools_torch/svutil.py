"""Succinct-vector file utility (reference utils/svutil analog).

The reference's `utils/svutil/svutil.cpp` converts between raw u32 files,
sparse_vector BLOBs, rsc BLOBs and bvector BLOBs, printing diagnostics
and timings.  Same surface here over the BMT1 formats:

  -u32in  FILE   raw little-endian u32 file to load
  -svin   FILE   sparse-vector BLOB to load
  -rscin  FILE   RSC sparse-vector BLOB to load
  -bvin   FILE   bit-vector BLOB to load
  -svout  FILE   write loaded data as a sparse-vector BLOB
  -rscout FILE   write loaded data as an RSC BLOB (zeros become NULL)
  -u32out FILE   write loaded data as a raw u32 file
  -diag          print statistics
  -timing        time the conversions
  --demo         run on synthetic data (no files needed)

Runs on the card; with BMTPU_PLATFORM=cpu on the CPU.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch.serial.serializer import Deserializer  # noqa: E402
from bitmagic_tpu_torch.serial.sv_serial import (  # noqa: E402
    SparseVectorDeserializer, sparse_vector_serialize)
from bitmagic_tpu_torch.sv import RSCSparseVector, SparseVector  # noqa: E402


def load(args):
    if args.u32in:
        return np.fromfile(args.u32in, "<u4")
    de = SparseVectorDeserializer()
    if args.svin:
        with open(args.svin, "rb") as f:
            return de.deserialize(f.read()).to_numpy()
    if args.rscin:
        with open(args.rscin, "rb") as f:
            rsc = de.deserialize(f.read())
        return np.asarray(rsc.gather(np.arange(rsc.size, dtype=np.int64)),
                          np.uint32)
    if args.bvin:
        with open(args.bvin, "rb") as f:
            bv = Deserializer().deserialize(f.read())
        out = np.zeros(int(bv.size), np.uint32)
        out[bv.indices()] = 1
        return out
    return None


def main(argv=None):
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for f in ("u32in", "svin", "rscin", "bvin",
              "svout", "rscout", "u32out"):
        p.add_argument(f"-{f}", f"--{f}")
    p.add_argument("-diag", "-d", action="store_true")
    p.add_argument("-timing", "-t", action="store_true")
    p.add_argument("--demo", action="store_true")
    args = p.parse_args(argv)

    if args.demo:
        rng = np.random.default_rng(1)
        vals = rng.integers(0, 1 << 16, 100_000).astype(np.uint32)
        vals[rng.random(vals.size) < 0.5] = 0       # NULL-heavy
    else:
        vals = load(args)
        if vals is None:
            p.print_help()
            return 1

    t0 = time.perf_counter()
    sv = SparseVector.from_array(vals, nullable=True,
                                 null_mask=(vals == 0))
    if args.timing:
        print(f"import: {time.perf_counter() - t0:.3f}s "
              f"({vals.size} values)")
    if args.diag or args.demo:
        st = sv.calc_stat()
        print(f"size={vals.size} nonzero={int((vals != 0).sum())} "
              f"memory_used={st['memory_used']}")

    if args.svout or args.demo:
        blob = sparse_vector_serialize(sv)
        if args.svout:
            with open(args.svout, "wb") as f:
                f.write(blob)
        print(f"sv BLOB: {len(blob)} bytes "
              f"({8 * len(blob) / max(vals.size, 1):.2f} bits/value)")
    if args.rscout or args.demo:
        rsc = RSCSparseVector.from_sparse_vector(sv)
        blob = sparse_vector_serialize(rsc)
        if args.rscout:
            with open(args.rscout, "wb") as f:
                f.write(blob)
        print(f"rsc BLOB: {len(blob)} bytes")
    if args.u32out:
        vals.astype("<u4").tofile(args.u32out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
