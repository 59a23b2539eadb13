"""Mesh-sharded vectors + per-shard counts combined on the host (the
scale-out story; SURVEY §2.7).  The mesh holds 8 shards on the one device
in use (the card, or the CPU with BMTPU_PLATFORM=cpu), so the counts equal
those of the JAX sample on its 8-device mesh; on a card the same
intersection runs once more over every visible card (make_mesh())."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.parallel import (Mesh, ShardedBitVector, make_mesh,
                                         sharded_and_many)

mesh = Mesh([bm.config.device] * 8)
print("mesh:", mesh)
rng = np.random.default_rng(4)
SIZE = 16 * 65536 * mesh.size
vs = [ShardedBitVector.from_indices(
    np.unique(rng.integers(0, SIZE, SIZE // 4)), SIZE, mesh) for _ in range(4)]
inter = sharded_and_many(vs)
print("sharded AND count (psum):", inter.count_shardmap())
print("rank(1/2 size):", inter.rank(SIZE // 2))

if mesh.devices[0].type == "cuda":
    cards = make_mesh()
    again = sharded_and_many([v.reshard(cards) for v in vs])
    assert again.count_shardmap() == inter.count_shardmap()
    assert again.rank(SIZE // 2) == inter.rank(SIZE // 2)
    print(f"make_mesh() over {cards.size} card(s): same count and rank")
