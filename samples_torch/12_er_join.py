"""Entity-resolution join over super-sparse id sets (reference
samples/xsample01, bitmagic.io/case-ER-join.html).

Each entity owns a sparse set of record ids; resolving an entity pair
means intersecting their sets.  Super-sparse sets cost almost nothing
here: ZERO blocks are free, and optimize() re-classifies whatever the
ops leave behind.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.agg import Aggregator
from bitmagic_tpu_torch.serial.serializer import Serializer

rng = np.random.default_rng(42)
ID_SPACE = 1 << 32                     # 4G record-id space, super sparse

# 40 entities drawing records from 8 shared regions of a huge key space
# (the realistic ER shape: local clumps, partial overlap between entities)
region_pool = rng.integers(0, ID_SPACE - 100_000, 8)
entities = []
for e in range(40):
    regions = rng.choice(region_pool, 3, replace=False)
    ids = np.unique(np.concatenate(
        [r + rng.integers(0, 100_000, 800) for r in regions]))
    entities.append(bm.BitVector.from_indices(ids, ID_SPACE))

# find entity0's best match (max shared records), then join = AND
from bitmagic_tpu_torch.algo import setops
overlaps = [setops.count_and(entities[0], e) for e in entities[1:]]
best = 1 + int(np.argmax(overlaps))
j01 = entities[0] & entities[best]
print(f"entity0 best match is entity{best}:", j01.count(), "shared records")

# one entity against the union of a whole group in ONE fused pass
group_or = Aggregator().combine_or(entities[1:])
hits = entities[0] & group_or
print("entity0 vs 39-entity union:", hits.count(), "of", entities[0].count())

# memory story: stats before/after optimize, serialized footprint
ent = entities[0]
ent.optimize()
st = ent.calc_stat()
blob = Serializer(6).serialize(ent)
print(f"entity0: {ent.count()} ids in a {ID_SPACE:,}-bit space -> "
      f"{st['memory_used']} bytes in RAM, {len(blob)} bytes serialized")
assert j01.count() == np.intersect1d(entities[0].indices(),
                                     entities[best].indices()).size
