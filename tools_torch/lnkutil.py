"""Link-matrix utility (reference utils/lnkutil analog).

The reference's `utils/lnkutil/lnkutil.cpp` loads id-pair links, builds a
compressed link matrix (per-node adjacency bit-vectors, bmcompvect.h) and
benchmarks neighborhood joins.  Same here: adjacency rows are
BitVectors in a keyed collection; a k-hop neighborhood is an aggregator
OR over the frontier's rows.

  -lin FILE    "from<TAB>to" pairs to load
  -lmout FILE  save the link matrix (compressed collection BLOB)
  -lmin FILE   load a link matrix instead of pairs
  -bench       run the neighborhood-join benchmark
  --demo       synthetic graph, self-checked

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
from bitmagic_tpu_torch.agg import Aggregator  # noqa: E402
from bitmagic_tpu_torch.serial.serializer import (  # noqa: E402
    Deserializer, Serializer)
from bitmagic_tpu_torch.serial.sv_serial import (  # noqa: E402
    deserialize_compressed_collection, serialize_compressed_collection)
from bitmagic_tpu_torch.sv.util import (  # noqa: E402
    CompressedBufferCollection)

N_NODES = 1 << 22


def build_matrix(pairs):
    """{from: adjacency BitVector} from (from, to) pairs."""
    order = np.argsort(pairs[:, 0], kind="stable")
    pairs = pairs[order]
    rows = {}
    bounds = np.flatnonzero(np.diff(pairs[:, 0])) + 1
    for chunk in np.split(pairs, bounds):
        rows[int(chunk[0, 0])] = BitVector.from_indices(
            np.unique(chunk[:, 1]), N_NODES)
    return rows


def save_matrix(rows, path):
    ser = Serializer(6)
    coll = CompressedBufferCollection()
    for k in sorted(rows):
        coll.push_back(k, ser.serialize(rows[k]))
    coll.sync()
    with open(path, "wb") as f:
        f.write(serialize_compressed_collection(coll))


def load_matrix(path):
    with open(path, "rb") as f:
        coll = deserialize_compressed_collection(f.read())
    de = Deserializer()
    return {int(k): de.deserialize(coll[int(k)]) for k in coll.keys()}


def neighborhood(rows, seed, hops):
    """k-hop frontier via aggregator OR over the frontier's rows."""
    agg = Aggregator()
    visited = BitVector.from_indices([seed], N_NODES)
    frontier = [seed]
    for _ in range(hops):
        operands = [rows[f] for f in frontier if f in rows]
        if not operands:
            break
        nxt = agg.combine_or(operands) - visited
        visited |= nxt
        frontier = nxt.indices().tolist()
    return visited


def main(argv=None):
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-lin", "--lin")
    p.add_argument("-lmout", "--lmout")
    p.add_argument("-lmin", "--lmin")
    p.add_argument("-bench", "-b", action="store_true")
    p.add_argument("--demo", action="store_true")
    args = p.parse_args(argv)

    if args.lmin:
        rows = load_matrix(args.lmin)
    elif args.lin:
        pairs = np.loadtxt(args.lin, dtype=np.int64, delimiter="\t",
                           ndmin=2)
        rows = build_matrix(pairs)
    else:                                        # demo graph
        rng = np.random.default_rng(4)
        hubs = rng.integers(0, N_NODES, 50)
        frm = np.repeat(hubs, 40)
        to = rng.integers(0, N_NODES, frm.size)
        pairs = np.stack([frm, to], 1)
        rows = build_matrix(pairs)

    deg = {k: v.count() for k, v in rows.items()}
    print(f"link matrix: {len(rows)} rows, {sum(deg.values())} links, "
          f"max degree {max(deg.values())}")

    if args.lmout:
        save_matrix(rows, args.lmout)
        sz = os.path.getsize(args.lmout)
        print(f"saved {sz} bytes -> {args.lmout}")

    if args.bench or args.demo or not (args.lin or args.lmin):
        seed = sorted(rows)[0]
        t0 = time.perf_counter()
        hood = neighborhood(rows, seed, 2)
        dt = time.perf_counter() - t0
        direct = rows[seed]
        if (direct - hood).count() != 0:
            raise AssertionError("lnkutil: the 1-hop neighborhood is not "
                                 "inside the 2-hop one")
        print(f"2-hop neighborhood of {seed}: {hood.count()} nodes "
              f"in {dt * 1000:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
