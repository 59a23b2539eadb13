"""Memory-compressed string dictionary with fast search (reference
samples/xsample05, bitmagic.io/star-search.html — NED star catalog).

A sorted str_sparse_vector with frequency remap is the dictionary;
bfind_eq_str does sampled binary search over the compressed form, and the
scanner pipeline answers bulk membership queries in one device pass.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
from bitmagic_tpu_torch.sv import StrSparseVector, scanner as sc

rng = np.random.default_rng(5)
# synthetic catalog ids in the NED style: "NGC 0012345"
names = sorted({f"NGC {int(x):07d}" for x in rng.integers(0, 3_000_000,
                                                          30_000)})
cat = StrSparseVector.from_strings(names)
cat.remap()                              # frequency recoding per position
cat.optimize()
cat.freeze()                             # immutable, defragmented

st = cat.calc_stat()
raw_bytes = sum(len(s) + 1 for s in names)
print(f"{len(names)} catalog ids: {raw_bytes} raw bytes -> "
      f"{st['memory_used']} succinct bytes")

# sorted search over the compressed dictionary
probe = names[len(names) // 3]
idx = sc.bfind_eq_str(cat, probe)
assert names[idx] == probe
print(f"bfind_eq_str('{probe}') -> row {idx}")

missing = "NGC 9999999"
assert sc.bfind_eq_str(cat, missing) < 0 or \
    (sc.bfind_eq_str(cat, missing) < len(names)
     and names[sc.bfind_eq_str(cat, missing)] != missing)

# bulk membership: thousand-query pipeline, one device batch
queries = [names[i] for i in rng.integers(0, len(names), 500)] + \
    [f"XYZ {i}" for i in range(100)]
counts = sc.pipeline_find_eq_str(cat, queries, counts_only=True)
hits = sum(1 for c in counts if c)
assert hits == 500 and sum(counts[500:]) == 0
print(f"pipeline: {len(queries)} queries, {hits} present")
