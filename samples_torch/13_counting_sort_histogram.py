"""Counting sort / histogram construction on a succinct vector (reference
samples/xsample02 + xsample09, bitmagic.io/hist-sort.html).

Values live bit-sliced in a SparseVector; the scanner's bulk pipeline
computes the whole histogram in ONE device pass per batch, and the sorted
order falls out of the histogram (counting sort) without ever comparing
elements.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
from bitmagic_tpu_torch.sv import SparseVector, scanner as sc

rng = np.random.default_rng(7)
N, K = 200_000, 64                       # N samples over K distinct codes
vals = rng.integers(0, K, N).astype(np.uint32)

sv = SparseVector.from_array(vals)       # one fused bit-transpose import

# histogram: bulk find_eq counts for all K codes in one pipeline
hist = np.asarray(sc.pipeline_find_eq(sv, list(range(K)), counts_only=True))
assert np.array_equal(hist, np.bincount(vals, minlength=K))
print("histogram over", K, "codes, total", int(hist.sum()))

# counting sort from the histogram

sorted_vals = np.repeat(np.arange(K, dtype=np.uint32), hist)
assert np.array_equal(sorted_vals, np.sort(vals))
print("counting sort of", N, "values verified against np.sort")

# top-5 most frequent codes (term-frequency style)
top = np.argsort(hist)[::-1][:5]
print("top-5 codes:", [(int(c), int(hist[c])) for c in top])
