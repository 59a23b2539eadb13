"""DNA k-mer counting (reference samples/xsample07): k-mer presence in a
BitVector over the 4^k code space, frequencies in an RSC vector, with a
task batch fanning the per-chunk scans out to threads (map) and a merge()
union (reduce).
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.parallel.plan import TaskBatch, run_task_batch
from bitmagic_tpu_torch.sv import RSCSparseVector, SparseVector

rng = np.random.default_rng(11)
K = 11                                   # 4^11 = 4M code space
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
seq = "".join(rng.choice(list("ACGT"), 200_000))

# 2-bit pack then rolling k-mer codes, vectorized
packed = np.asarray([CODE[c] for c in seq], np.int64)
weights = 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)
codes = np.lib.stride_tricks.sliding_window_view(packed, K) @ weights

# map: each chunk builds its k-mer presence vector on a worker thread
def chunk_presence(chunk):
    return bm.BitVector.from_indices(np.unique(chunk), 4 ** K)

batch = TaskBatch()
for part in np.array_split(codes, 8):
    batch.add(chunk_presence, part)
parts = run_task_batch(batch, n_threads=4)

# reduce: destructive union (bvector::merge) of the partial indexes
present = parts[0]
for p in parts[1:]:
    present.merge(p)
uniq, counts = np.unique(codes, return_counts=True)
assert present.count() == len(uniq)
print(f"{len(seq)} bp, k={K}: {present.count()} distinct k-mers")

# term frequencies in an RSC vector addressed by k-mer code
arr = np.zeros(int(uniq[-1]) + 1, np.uint32)
arr[uniq] = counts.astype(np.uint32)
mask = np.ones(arr.size, bool)
mask[uniq] = False
tf = RSCSparseVector.from_sparse_vector(
    SparseVector.from_array(arr, nullable=True, null_mask=mask))
probe = int(uniq[len(uniq) // 2])
found, n = tf.try_get(probe)
assert found and int(n) == int(counts[len(uniq) // 2])
print(f"k-mer code {probe} occurs {int(n)} times; "
      f"tf vector memory {tf.calc_stat()['memory_used']} bytes")
