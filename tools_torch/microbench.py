"""Microbenchmark harness mirroring the reference's tests/perf families.

The reference ships a perf binary (tests/perf/perf.cpp, REPEATS=1200) that
times every subsystem with chrono_taker: memcpy baseline, popcounts, the
logic-op family, enumerators, find/select/rank, SV access, scanner and
aggregator runs, serialization.  This tool is the breadth equivalent — one
timing line per family, through the PUBLIC container APIs.

Run on the card:           python tools_torch/microbench.py
Run on the CPU:            python tools_torch/microbench.py --cpu
                           (or BMTPU_PLATFORM=cpu)
Subset:                    python tools_torch/microbench.py --only count,logic

Timing: ``memcpy`` (a plain torch read of the pool, the bandwidth
baseline) and ``count`` (K3, ``block_counts_total``) are timed on the card
with CUDA events, the 50 MB L2 flushed before each of 25 runs (median),
and on the CPU with the host clock (best of 5).  The container families
time whole public calls ended by ``torch.cuda.synchronize()`` (best of 5
unless the line says otherwise): they measure the API, host work
included, not the bare kernel.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch.config import resolve_device  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tools_torch import sync  # noqa: E402

WORDS = 2048
FLUSH_BYTES = 512 << 20         # evicts the card's 50 MB L2


class Bench:
    """One run's size, seeded generator and device."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.size = blocks * 65536
        self.mb = self.size / 8 / 1e6
        self.rng = np.random.default_rng(1234)
        self.device = resolve_device()
        self._flush = None

    def mk(self, density=0.5):
        ids = np.unique(self.rng.integers(0, self.size,
                                          int(self.size * density // 16)))
        return bm.BitVector.from_indices(ids.astype(np.int64), self.size)

    def device_s(self, fn, reps=25):
        """Seconds of one ``fn`` run: on the card the median of ``reps``
        CUDA-event timings, L2 flushed before each; on the CPU the best of
        5 host-clock runs.  One warm-up run first."""
        fn()
        if self.device.type != "cuda":
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return min(ts)
        if self._flush is None:
            self._flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                      device=self.device)
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            self._flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) / 1e3)
        return float(np.median(ts))


def make_pool(rng, nblk):
    """Random dense rows, the draws of the JAX benchmark's pools."""
    return rng.integers(0, 2**32, (nblk, WORDS),
                        dtype=np.uint64).astype(np.uint32)


def _report(name, secs, unit_val, unit):
    print(f"[{name:8s}] {secs * 1e3:8.3f} ms  -> {unit_val:10.2f} {unit}")


def _wall(fn, n=5, warmup=2):
    """Best wall seconds of ``n`` calls of ``fn``, each ended by a
    synchronize."""
    for _ in range(warmup):
        fn()
    sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def fam_memcpy(b):
    pool = torch.from_numpy(make_pool(b.rng, b.blocks).view(np.int32)).to(
        b.device)
    pool_gb = b.blocks * 2048 * 4 / 1e9
    t = b.device_s(lambda: torch.sum(pool, dtype=torch.int64))
    _report("stream", t, pool_gb / t, "GB/s")       # one full read


def fam_count(b):
    a = b.mk()
    a._flush()
    pool = a._pool
    t = b.device_s(lambda: ck.block_counts_total(pool))
    _report("count", t, b.mb / 1e3 / t, "GB/s")


def fam_logic(b):
    a, c = b.mk(), b.mk()
    for name, fn in [("and", lambda: (a & c).count()),
                     ("or", lambda: (a | c).count()),
                     ("xor", lambda: (a ^ c).count()),
                     ("sub", lambda: (a - c).count()),
                     ("and_cnt", lambda: bm.count_and(a, c)),
                     ("or_cnt", lambda: bm.count_or(a, c))]:
        t = _wall(fn)
        _report(name, t, 2 * b.mb / 1e3 / t, "GB/s")


def fam_enum(b):
    a = b.mk(0.03)
    n = a.count()
    t = _wall(a.indices, n=1)
    _report("enum", t, n / 1e6 / t, "Mint/s")


def fam_select(b):
    a = b.mk()
    a.build_rs_index()
    total = a.count()
    ranks = b.rng.integers(1, total, 100_000).astype(np.int64)
    rs = a.build_rs_index()
    for _ in range(2):
        rs.select_batch(ranks[:100])
    t = _wall(lambda: rs.select_batch(ranks), n=1, warmup=0)
    _report("select", t, len(ranks) / 1e6 / t, "Mq/s")
    probes = b.rng.integers(0, b.size, 100_000).astype(np.int64)
    t = _wall(lambda: rs.rank_batch(probes), n=1, warmup=0)
    _report("rank", t, len(probes) / 1e6 / t, "Mq/s")


def fam_sv(b):
    n = b.size // 32
    vals = b.rng.integers(0, 2**20, n).astype(np.uint32)
    sv = bm.SparseVector.from_array(vals)
    ids = b.rng.integers(0, n, 1_000_000).astype(np.int64)
    for _ in range(2):
        sv.gather(ids[:1000])
    t = _wall(lambda: sv.gather(ids), n=1, warmup=0)
    _report("sv_gath", t, len(ids) / 1e6 / t, "Melem/s")
    t = _wall(lambda: sv.decode(0, n), n=1, warmup=0)
    _report("sv_dec", t, n / 1e6 / t, "Melem/s")


def fam_scanner(b):
    n = b.size // 32
    vals = (b.rng.integers(0, 64, n) * 7).astype(np.uint32)
    sv = bm.SparseVector.from_array(vals)
    sc = bm.SparseVectorScanner()
    for _ in range(2):
        sc.find_eq(sv, 21)
    t = _wall(lambda: sc.find_eq(sv, 21).count(), n=1, warmup=0)
    _report("scan_eq", t, n / 1e9 / t, "Gelem/s")
    t = _wall(lambda: sc.find_gt(sv, 200).count(), n=1, warmup=0)
    _report("scan_gt", t, n / 1e9 / t, "Gelem/s")


def fam_agg(b):
    k = 50
    vs = [b.mk(0.2) for _ in range(6)] * (k // 6)
    agg = bm.Aggregator()
    for _ in range(2):
        agg.combine_or(vs[:4])
    t = _wall(lambda: agg.combine_and_sub(vs[: k // 2], vs[k // 2:]).count(),
              n=1, warmup=0)
    _report("agg", t, k * b.mb / 1e3 / t, "GB/s")


def fam_serial(b):
    a = b.mk(0.12)
    blob = None
    for lvl in (1, 4, 6):
        s = bm.Serializer(lvl)
        for _ in range(2):
            blob = s.serialize(a)
        n = 3
        t0 = time.perf_counter()
        for _ in range(n):
            blob = s.serialize(a)
        t = (time.perf_counter() - t0) / n
        _report(f"ser_L{lvl}", t, b.mb / t / 1e3, "GB/s")
        print(f"          blob {len(blob) / 1e3:.1f} KB")
    d = bm.Deserializer()
    for _ in range(2):
        d.deserialize(blob)
    sync()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        d.deserialize(blob)
    sync()
    t = (time.perf_counter() - t0) / n
    _report("deser_L6", t, b.mb / t / 1e3, "GB/s")


FAMS = {"memcpy": fam_memcpy, "count": fam_count, "logic": fam_logic,
        "enum": fam_enum, "select": fam_select, "sv": fam_sv,
        "scanner": fam_scanner, "agg": fam_agg, "serial": fam_serial}


def main(argv=None):
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--only", type=str, default=None,
                    help="comma list: memcpy,count,logic,enum,select,sv,"
                         "scanner,agg,serial")
    ap.add_argument("--blocks", type=int, default=768,
                    help="vector size in 64K blocks (default ~50M bits)")
    args = ap.parse_args(argv)
    if args.cpu:
        bm.config.device = "cpu"
    b = Bench(args.blocks)
    only = args.only.split(",") if args.only else list(FAMS)
    print(f"devices: [{b.device}]  size: {b.size / 1e6:.0f} Mbit")
    for name in only:
        FAMS[name](b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
