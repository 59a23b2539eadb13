"""Set algebra basics (reference samples/bvsetalgebra, bvsample01-04)."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm

a = bm.BitVector.from_indices([10, 20, 30, 10_000_000], size=2**32)
b = bm.BitVector(2**32)
b.set_range(15, 25)

print("a & b:", (a & b).indices())          # [20]
print("a | b count:", (a | b).count())
print("a - b:", (a - b).indices())
print("a ^ b count:", (a ^ b).count())

# 3-operand form into a target + optimize
t = bm.BitVector(2**32)
t.bit_or(a, b, opt_mode=bm.constants.OPT_COMPRESS)
print("3-op OR:", t.count(), t.calc_stat())
