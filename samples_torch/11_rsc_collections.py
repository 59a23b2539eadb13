"""Rank-select-compressed vectors and keyed BLOB collections.

bm::rsc_sparse_vector + compressed_collection equivalents (rscsample01,
sample for bmsparsevec_util.h): sparse columns whose NULL positions cost
nothing, and a NoSQL-ish keyed store of compressed byte buffers.

Run: python samples_torch/11_rsc_collections.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch.sv.rsc_vector import RSCSparseVector  # noqa: E402
from bitmagic_tpu_torch.sv.sparse_vector import SparseVector  # noqa: E402
from bitmagic_tpu_torch.sv.util import (AddressResolver,  # noqa: E402
                                  CompressedBufferCollection)

# --- RSC: a 100M-row column with 0.1% density --------------------------------
rng = np.random.default_rng(0)
n = 100_000_000
idx = np.unique(rng.integers(0, n, 100_000)).astype(np.int64)
vals = rng.integers(1, 1 << 20, idx.size).astype(np.uint32)

rsc = RSCSparseVector(np.uint32)
for i, v in zip(idx[:5], vals[:5]):
    rsc.set(int(i), int(v))              # single sets stage + flush
arr = np.zeros(int(idx[-1]) + 1, np.uint32)
arr[idx] = vals
mask = np.ones(arr.size, bool)
mask[idx] = False
sv = SparseVector.from_array(arr, nullable=True, null_mask=mask)
rsc = RSCSparseVector.from_sparse_vector(sv)
rsc.sync()

probe = idx[::ma if (ma := max(1, idx.size // 5)) else 1][:5]
print("rsc get:", [(int(i), int(rsc.get(int(i)))) for i in probe])
print("rsc density:", f"{idx.size / n:.4%}",
      "| stored values:", rsc.count())

# --- keyed compressed BLOB collection ----------------------------------------
coll = CompressedBufferCollection()
coll.push_back(10, b"alpha payload")
coll.push_back(42, b"beta " * 100)
coll.push_back(10_000_000, b"far away")
coll.sync()
print("keys:", list(coll.keys())[:5])
print("coll[42] len:", len(coll.get(42)), "| 10 in coll:", 10 in coll)

# --- address resolver ---------------------------------------------------------
res = AddressResolver()
res.set_many([5, 100, 70_000])
res.sync()
print("resolve(100):", res.resolve(100), "| resolve(6):", res.resolve(6))
