"""Interval views and three-valued (Kleene) logic.

bm::interval_enumerator / bm3vl equivalents (samples bvintervals,
bv3vlogic): treat a bit-vector as coordinate ranges, and run SQL-style
TRUE/FALSE/UNKNOWN logic on (value, known) vector pairs.

Run: python samples_torch/10_intervals_3vl.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch.algo.intervals import (  # noqa: E402
    find_interval_end, find_interval_start, intervals, is_interval)
import bitmagic_tpu_torch.algo.kleene as kleene  # noqa: E402

# --- intervals ---------------------------------------------------------------
bv = bm.BitVector(1_000_000)
bv.set_range(100, 200)
bv.set_range(500, 500)
bv.set_range(70_000, 95_000)

print("intervals:", [tuple(iv) for iv in intervals(bv)])
print("is_interval(100,200):", is_interval(bv, 100, 200))
print("interval around bit 80_000:",
      find_interval_start(bv, 80_000),
      "..", find_interval_end(bv, 80_000))

# --- 3-valued logic ----------------------------------------------------------
# column A: TRUE at 1,3; FALSE at 2; UNKNOWN elsewhere
N = 10
a_val, a_known = bm.BitVector(N), bm.BitVector(N)
kleene.set_value_kleene(a_val, a_known, 1, 1)    # TRUE
kleene.set_value_kleene(a_val, a_known, 3, 1)    # TRUE
kleene.set_value_kleene(a_val, a_known, 2, -1)   # FALSE
# column B: TRUE at 2,3; FALSE at 1
b_val, b_known = bm.BitVector(N), bm.BitVector(N)
kleene.set_value_kleene(b_val, b_known, 2, 1)
kleene.set_value_kleene(b_val, b_known, 3, 1)
kleene.set_value_kleene(b_val, b_known, 1, -1)

and_v, and_k = kleene.and_kleene(a_val, a_known, b_val, b_known)
or_v, or_k = kleene.or_kleene(a_val, a_known, b_val, b_known)
name = {1: "TRUE", -1: "FALSE", 0: "UNKNOWN"}
for i in range(5):
    print(f"row {i}: A AND B = "
          f"{name[kleene.get_value_kleene(and_v, and_k, i)]:8} "
          f"A OR B = {name[kleene.get_value_kleene(or_v, or_k, i)]}")
