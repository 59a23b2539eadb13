"""String and float succinct vectors (reference strsvsample*, svfsample)."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
from bitmagic_tpu_torch.sv import StrSparseVector, FloatSparseVector, scanner

words = ["apple", "banana", "apple", "cherry", "apple", "date"] * 100
ssv = StrSparseVector.from_strings(words)
ssv.remap()                      # frequency recoding shrinks the planes
hits = scanner.find_eq_str(ssv, "apple")
print("apple rows:", hits.count())
print("sorted search:", scanner.bfind_eq_str(
    StrSparseVector.from_strings(sorted(set(words))), "cherry"))

fv = FloatSparseVector.from_array(np.linspace(-1, 1, 1000, dtype=np.float32))
print("float roundtrip exact:", bool((fv.to_numpy() ==
      np.linspace(-1, 1, 1000, dtype=np.float32)).all()))
