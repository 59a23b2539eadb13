"""Wide-range operations over the full 48-bit address space.

The reference treats a whole all-ones sub-tree as one FULL sentinel
(src/bm.h:6628-6650, src/bmblocks.h:644 set_all_set), so set_range /
invert / copy_range over ANY span are O(occupied structure).  This
design mirrors that with run-coded metadata: a [start, end) interval set
of FULL blocks that resolves by pure host interval algebra — and the
serializer folds each run into ONE record (reference multi-scale one-run
codes, src/bmserial.h:1183-1199).

Run: python samples_torch/22_wide_ranges_48bit.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch import constants as C  # noqa: E402

SIZE = 1 << 48

# -- 140 trillion bits set in milliseconds --------------------------------
t0 = time.time()
bv = bm.BitVector(SIZE)
bv.set_range(0, (1 << 47) - 1)
ms = (time.time() - t0) * 1e3
assert bv.count() == 1 << 47
print(f"set_range(0, 2^47-1): {ms:.1f} ms; count = {bv.count():,}")

# -- whole-space inversion ------------------------------------------------
t0 = time.time()
bv.invert()
ms = (time.time() - t0) * 1e3
assert bv.count() == 1 << 47 and bv.test(1 << 47) and not bv.test(5)
print(f"invert() @ 2^48     : {ms:.1f} ms; count = {bv.count():,}")

# -- carving windows out of runs -----------------------------------------
bv.set_range(0, (1 << 47) - 1)                 # now the whole space is set
bv.clear_range(1 << 30, (1 << 40) - 1)         # punch a 1.1-trillion-bit hole
assert not bv.test(1 << 35) and bv.test((1 << 30) - 1) and bv.test(1 << 40)
print(f"after clear_range   : count = {bv.count():,} "
      f"(runs: {bv._struct.runs.tolist()})")

# -- rank/select stay O(structure) ----------------------------------------
bv.build_rs_index()
r = bv.rank((1 << 42))
s = bv.select(r)
assert s == 1 << 42
print(f"rank(2^42) = {r:,}; select back -> {s:,}")

# -- set algebra against point data ---------------------------------------
pts = bm.BitVector.from_indices(
    [5, (1 << 31) + 7, (1 << 45) + 1234], SIZE)
both = bv & pts
print("AND with point vector:", sorted(both.indices().tolist()))

# -- one record per run in the BLOB ---------------------------------------
blob = bm.serialize(bv, level=6)
back = bm.deserialize(blob)
assert back.equal(bv)
print(f"serialized 2^47-bit span structure: {len(blob)} bytes "
      f"(FULL_RUN records); round-trip OK")
