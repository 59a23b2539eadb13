"""Bit-sliced sparse vector + compressed-form search (reference
samples/svsample02/06)."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.sv import SparseVector, scanner

rng = np.random.default_rng(2)
vals = rng.integers(0, 10_000, 5_000_000).astype(np.uint32)
sv = SparseVector.from_array(vals)
sv.optimize()
print("stat:", sv.calc_stat())

eq = scanner.find_eq(sv, 777)            # search WITHOUT decompressing
print("find_eq(777):", eq.count())
rng_hits = scanner.find_range(sv, 100, 120)
print("find_range[100,120]:", rng_hits.count())
counts = scanner.pipeline_find_eq(sv, range(10), counts_only=True)
print("pipeline counts:", counts)
