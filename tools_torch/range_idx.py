"""Range-index utility (reference utils/range_idx analog).

The reference's `utils/range_idx/range_idx.cpp` reads a tab file of
[start, end, payload] ranges and builds a succinct range index: an
interval bit-vector marking range starts/extents plus a sparse vector of
payloads addressed by range rank.  A point query is then
rank(find_interval_start(p)) -> payload, all on compressed structures.

  -i FILE     tab-separated "start<TAB>end<TAB>payload" input
  -svout F    save the payload sparse-vector BLOB
  -t          timings
  --demo      synthetic ranges, runs queries and self-checks

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
from bitmagic_tpu_torch.serial.sv_serial import (  # noqa: E402
    sparse_vector_serialize)
from bitmagic_tpu_torch.sv import SparseVector  # noqa: E402


class RangeIndex:
    """Interval bvector (coverage) + start bvector (rank domain) +
    payloads at start-rank positions."""

    def __init__(self, starts, ends, payloads, space):
        order = np.argsort(starts)
        starts, ends = starts[order], ends[order]
        payloads = payloads[order]
        covered = np.concatenate(
            [np.arange(s, e + 1) for s, e in zip(starts, ends)])
        self.cover = BitVector.from_indices(np.unique(covered), space)
        self.starts = BitVector.from_indices(starts, space)
        self.payload = SparseVector.from_array(payloads.astype(np.uint32))
        self.rs = self.starts.build_rs_index()

    def query(self, p):
        """payload of the range covering p, or None."""
        return self.query_batch([p])[0]

    def query_batch(self, pts):
        """Batched point queries: one pass over the cover rows for the
        coverage tests, one rs_index batch rank for the start ranks (the
        nearest range start at or before p wins when covered intervals
        merge) and one payload gather."""
        pts = np.asarray(pts, np.int64)
        hit = np.asarray(self.cover.get_bits(pts), bool)
        ranks = self.rs.rank_batch(pts)
        vals = self.payload.gather(np.maximum(ranks - 1, 0))
        return [int(v) if (h and r > 0) else None
                for v, h, r in zip(vals, hit, ranks)]


def main(argv=None):
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-i", "--input")
    p.add_argument("-svout", "--svout")
    p.add_argument("-t", "--timing", action="store_true")
    p.add_argument("--demo", action="store_true")
    args = p.parse_args(argv)

    if args.demo or not args.input:
        rng = np.random.default_rng(2)
        n, space = 5_000, 50_000_000
        starts = np.sort(rng.choice(space // 100, n, replace=False)) * 100
        lens = rng.integers(10, 90, n)
        ends = starts + lens
        payloads = rng.integers(1, 1 << 20, n)
    else:
        tab = np.loadtxt(args.input, dtype=np.int64, delimiter="\t")
        starts, ends, payloads = tab[:, 0], tab[:, 1], tab[:, 2]
        space = int(ends.max()) + 2

    t0 = time.perf_counter()
    idx = RangeIndex(starts, ends, payloads, space)
    if args.timing or args.demo:
        print(f"index build: {time.perf_counter() - t0:.3f}s "
              f"for {len(starts)} ranges")
    st = idx.payload.calc_stat()
    print(f"payload sv memory: {st['memory_used']} bytes; "
          f"cover blocks: {idx.cover.calc_stat()['bit_blocks']}")

    # queries (and self-check in demo mode)
    rng = np.random.default_rng(3)
    k = rng.integers(0, len(starts), 2000)
    t0 = time.perf_counter()
    got = idx.query_batch(starts[k] + 5)
    dt = time.perf_counter() - t0
    if got != [int(v) for v in payloads[k]]:
        raise AssertionError("range_idx: point queries disagree with the "
                             "payloads")
    if idx.query(int(starts[0]) - 1) is not None:
        raise AssertionError("range_idx: a point before the first range "
                             "has a payload")
    print(f"{len(k)} point queries OK "
          f"({dt * 1000 / len(k) * 1000:.1f} ms/1k)")

    if args.svout:
        with open(args.svout, "wb") as f:
            f.write(sparse_vector_serialize(idx.payload))
        print("payload sv written to", args.svout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
