"""Bitap (shift-AND) DNA substring search (reference samples/xsample04)."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.agg import Aggregator

text = "ACGTACGTTTACGGACGTACGT" * 1000
pattern = "ACGG"
occ = {c: bm.BitVector.from_indices(
    [i for i, ch in enumerate(text) if ch == c], len(text) + 1)
    for c in "ACGT"}

res = Aggregator().combine_shift_right_and([occ[c] for c in pattern])
ends = res.indices()
print(f"'{pattern}' occurs {ends.size} times; first end at {ends[0]}")
assert all(text[e - len(pattern) + 1:e + 1] == pattern for e in ends[:5])
