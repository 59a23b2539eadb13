"""rank/select queries (reference samples/rscsample01, bvsample*rank)."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm

rng = np.random.default_rng(0)
ids = np.unique(rng.integers(0, 10_000_000, 100_000))
bv = bm.BitVector.from_indices(ids, 10_000_000)

rs = bv.build_rs_index()
print("total:", rs.count())
print("rank(1e6):", rs.rank(1_000_000))
print("select(50000):", rs.select(50_000))
# batched: thousands of queries in one device pass
ranks = rng.integers(1, ids.size, 10_000)
pos = rs.select_batch(ranks)
print("batch select ok:", bool((np.sort(pos) >= 0).all()))
