"""Succinct-vector scans through the MESH containers (SURVEY §2.7
"sharding rules per container"): ShardedSparseVector /
ShardedStrSparseVector run the scanner workload
(bm::sparse_vector_scanner, reference src/bmsparsevec_algo.h:612) across
a device mesh — digest narrowing and slice algebra stay shard-local, only
per-query counts and gathered scalars are combined on the host.

The mesh holds 8 shards on the one device in use (the card, or the CPU
with BMTPU_PLATFORM=cpu), so the results equal those of the JAX sample on
its 8-device mesh."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.parallel import Mesh
from bitmagic_tpu_torch.parallel.sharded_sv import (ShardedSparseVector,
                                              ShardedStrSparseVector)

mesh = Mesh([bm.config.device] * 8)
print("mesh:", mesh)
rng = np.random.default_rng(7)

# --- integer vector: equality / range scans at mesh scale ----------------
N = 65536 * 8 * mesh.size
vals = rng.integers(0, 50_000, N).astype(np.uint32)
vals[123] = 777_777
ssv = ShardedSparseVector.from_array(vals, mesh)
print(ssv)
hits = ssv.find_eq(777_777)
surv, total = hits.last_narrowing
print("find_eq(777777):",
      np.asarray(hits.to_bitvector().indices()).tolist(),
      f"(digest narrowing {surv}/{total} blocks)")
q = int(vals[42])
print(f"find_eq_count({q}):", ssv.find_eq_count(q),
      " numpy:", int((vals == q).sum()))
print("find_range(100, 5000).count():", ssv.find_range(100, 5000).count())
batch = [int(v) for v in vals[:6]] + [10**9]
print("pipeline_find_eq:", ssv.pipeline_find_eq(batch))
print("gather[0,123]:", ssv.gather([0, 123]).tolist())

# --- string vector: remapped equality scans at mesh scale ----------------
words = ["tpu", "mesh", "shard", "digest", "succinct", "scan"]
strs = [words[i] for i in rng.integers(0, len(words), 100_000)]
strs[5_000] = "needle"
sstr = ShardedStrSparseVector.from_strings(strs, mesh)
print(sstr)
print("find_eq_str('needle'):",
      np.asarray(sstr.find_eq_str("needle").to_bitvector()
                 .indices()).tolist())
print("pipeline_find_eq_str:",
      sstr.pipeline_find_eq_str(["mesh", "needle", "absent"]))
print("gather[0, 5000]:", sstr.gather([0, 5_000]))

# --- RSC vector: compressed-domain search + sharded rank decompress ------
from bitmagic_tpu_torch.parallel.sharded_sv import ShardedRSCVector
from bitmagic_tpu_torch.sv.sparse_vector import SparseVector

nmask = rng.random(300_000) < 0.85              # 85% NULL
rvals = rng.integers(1, 2000, 300_000).astype(np.uint32)
srsc = ShardedRSCVector.from_sparse_vector(
    SparseVector.from_array(rvals, nullable=True, null_mask=nmask), mesh)
print(srsc)
qv = int(rvals[np.flatnonzero(~nmask)[0]])
print(f"rsc find_eq({qv}) logical hits:",
      srsc.find_eq(qv).to_bitvector().count())
print("rsc try_get:", srsc.try_get(int(np.flatnonzero(~nmask)[1])),
      srsc.try_get(int(np.flatnonzero(nmask)[0])))

# --- float vector: IEEE sign/exp/mantissa descent at mesh scale ----------
from bitmagic_tpu_torch.parallel import ShardedFloatVector

fvals = (rng.normal(0, 25, 200_000)
         * rng.choice([1.0, 0.0], 200_000)).astype(np.float32)
fvals[77] = -3.75
sfv = ShardedFloatVector.from_array(fvals, mesh)
print(sfv)
print("float find_eq(-3.75):",
      np.asarray(sfv.find_eq(np.float32(-3.75)).to_bitvector()
                 .indices()).tolist())
print("float find_gt(0).count():", sfv.find_gt(np.float32(0)).count(),
      " numpy:", int((fvals > 0).sum()))
print("float find_range(-10, 10).count():",
      sfv.find_range(np.float32(-10), np.float32(10)).count())
print("float gather[0, 77]:", sfv.gather([0, 77]).tolist())

# checkpoint: succinct at rest, resharded on load
blob = ssv.checkpoint_bytes()
again = ShardedSparseVector.from_checkpoint(blob, mesh)
print(f"checkpoint: {len(blob)/1e3:.1f} KB; reload find_eq_count({q}):",
      again.find_eq_count(q))
