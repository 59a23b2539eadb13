"""Serialization: compressed BLOBs, range decode, ops on BLOBs (reference
samples/bvsample14 / svsample09)."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
import bitmagic_tpu_torch.constants as C
from bitmagic_tpu_torch.serial import Serializer, Deserializer, OperationDeserializer

rng = np.random.default_rng(3)
bv = bm.BitVector.from_indices(
    np.unique(rng.integers(0, 50_000_000, 100_000)), 50_000_000)
bv.set_range(1_000_000, 3_000_000)
bv.optimize()

blob = Serializer(level=6).serialize(bv)
print(f"{bv.size/8/1e6:.1f} MB bitmap -> {len(blob)/1e3:.1f} KB blob")
back = Deserializer().deserialize(blob)
assert back.equal(bv)

part = Deserializer().deserialize_range(blob, 1_500_000, 1_500_100)
print("range decode count:", part.count())

other = bm.BitVector.from_indices([1_000_001, 42], 50_000_000)
n = OperationDeserializer().deserialize(other, blob, C.SET_COUNT_AND)
print("count_and directly on blob:", n)
