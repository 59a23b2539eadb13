"""Succinct in-memory residency and run-domain set algebra.

The point of a succinct bit-vector library: memory-compressed vectors that
stay OPERABLE without decompression (reference bvsample02/bvsample09 +
src/bmfunc.h:3738 gap_buff_op).  Here:

  * optimize() moves sparse blocks into the host D-GAP store — a 100M-bit
    vector with 50k scattered bits costs KBs, not MBs, and device HBM holds
    almost nothing;
  * sparse AND/OR/XOR/SUB run entirely in the run domain (no dense
    expansion, no device pass) and their RESULTS stay succinct;
  * rank/select/count answer straight from the runs.

Run: python samples_torch/20_succinct_memory.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm  # noqa: E402

SIZE = 100_000_000
rng = np.random.default_rng(7)

ids_a = np.unique(rng.integers(0, SIZE, 50_000)).astype(np.int64)
ids_b = np.unique(rng.integers(0, SIZE, 50_000)).astype(np.int64)

a = bm.BitVector.from_indices(ids_a, SIZE)
st_dense = a.calc_stat()
a.optimize()
st_gap = a.calc_stat()
print(f"dense residency : {st_dense['memory_used']:>12,} bytes "
      f"({st_dense['device_memory_used']:,} on device)")
print(f"succinct        : {st_gap['memory_used']:>12,} bytes "
      f"({st_gap['device_memory_used']:,} on device), "
      f"{st_gap['gap_blocks']} GAP blocks")
print(f"compression     : {st_dense['memory_used'] / st_gap['memory_used']:.0f}x "
      "smaller after optimize()")

# BM_GAP strategy: built succinct from the start — no dense pass at all
b = bm.BitVector.from_indices(ids_b, SIZE,
                              strategy=bm.constants.BM_GAP)

# run-domain set algebra: both operands AND the results stay succinct
inter = a & b
union = a | b
diff = a - b
print(f"a & b: {inter.count():,} bits, result device bytes = "
      f"{inter.calc_stat()['device_memory_used']:,}")
print(f"a | b: {union.count():,} bits | a - b: {diff.count():,} bits")
assert inter.count() == np.intersect1d(ids_a, ids_b).size

# queries answer from the runs
a.build_rs_index()
mid = a.select(len(ids_a) // 2)
print(f"median set bit: {mid:,} (rank check: {a.rank(mid):,})")

# serialization is representation-independent
blob = bm.serial.serializer.serialize(a)
print(f"BLOB: {len(blob):,} bytes; round-trip "
      f"{'OK' if bm.serial.serializer.deserialize(blob) == a else 'FAIL'}")
