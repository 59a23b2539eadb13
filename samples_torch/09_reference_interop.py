"""Migrating data from the reference C++ library (reference-format interop).

Every serialized artifact of the reference — bvector BLOBs (any of its
~70 block codes, any compression level, bookmarks, XOR reference
filters), sparse_vector / rsc_sparse_vector / str_sparse_vector
bit-matrix BLOBs, and sparse_vector_float composites — loads directly
into this framework with the standalone clean-room codec
(serial/refcodec.py, serial/ref_sv.py).  The writers emit BLOBs any
reference build can read back, so the two systems can share storage.

Run: python samples_torch/09_reference_interop.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch.serial import (ref_serialize, ref_deserialize,
                                 serialize_sv_blob, deserialize_sv_blob,
                                 ref_sv)
from bitmagic_tpu_torch.sv.sparse_vector import SparseVector
from bitmagic_tpu_torch.sv.str_vector import StrSparseVector

# --- bit-vectors -----------------------------------------------------------
rng = np.random.default_rng(0)
ids = np.unique(rng.integers(0, 80_000_000, 250_000)).astype(np.int64)
bv = bm.BitVector.from_indices(ids, 100_000_000)
bv.set_range(40_000_000, 40_500_000)
bv.optimize()

blob = ref_serialize(bv, level=6)        # reference-readable BLOB
back = ref_deserialize(blob)             # reads ANY reference BLOB
assert back.equal(bv)
print(f"bvector: {bv.count()} bits -> {len(blob)} byte reference BLOB, "
      f"round-trip OK")

# --- integer sparse vectors ------------------------------------------------
vals = rng.integers(0, 1 << 24, 100_000).astype(np.uint32)
nn = rng.random(100_000) > 0.3
arr = vals.copy()
arr[~nn] = 0
sv = SparseVector.from_array(arr, nullable=True, null_mask=~nn)
sv_blob = serialize_sv_blob(sv)          # 'BM' bit-matrix BLOB
sv2 = deserialize_sv_blob(sv_blob, np.uint32)
idx = np.flatnonzero(nn).astype(np.int64)
assert np.array_equal(np.asarray(sv2.gather(idx), np.uint32), vals[idx])
print(f"sparse_vector<u32>: {len(vals)} elems -> {len(sv_blob)} bytes, "
      f"round-trip OK")

# --- string sparse vectors (with remap) -------------------------------------
chroms = [f"chr{rng.integers(1, 23)}" for _ in range(50_000)]
ssv = StrSparseVector.from_strings(chroms, nullable=True)
ssv.remap()                              # frequency recoding, as upstream
str_blob = ref_sv.serialize_str_blob(ssv)
ssv2 = ref_sv.deserialize_str_blob(str_blob)
assert ssv2.to_list() == chroms
print(f"str_sparse_vector: {len(chroms)} strings -> {len(str_blob)} bytes "
      f"(remapped), round-trip OK")

# --- float sparse vectors ----------------------------------------------------
fvals = (rng.standard_normal(40_000) * 100).astype(np.float32)
from bitmagic_tpu_torch.sv.float_vector import FloatSparseVector
fv = FloatSparseVector.from_array(fvals)
f_blob = ref_sv.serialize_float_blob(fv)
fv2 = ref_sv.deserialize_float_blob(f_blob)
assert np.array_equal(fv2.to_numpy()[:len(fvals)], fvals)
print(f"sparse_vector_float: {len(fvals)} floats -> {len(f_blob)} bytes, "
      f"round-trip OK")
