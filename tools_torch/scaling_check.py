"""Sharded scaling validation over meshes of 1, 2, 4 and 8 shards.

Validates the SCALING STRUCTURE of the sharded programs — that the
sharded scan / count / select, the bulk-search pipeline and the sharded
succinct-vector container run with one kernel launch per shard per step
at every mesh size — and reports indicative weak-scaling timings.  On the
card the shards are ``Mesh([card] * N)`` (N shards on one card), on the
CPU ``Mesh(["cpu"] * N)`` (CPU arithmetic, no launches).  Each line gives
the launches of one step: one B6 and one K3 per shard per scan, one B5
per shard per pipeline.

Run on the card: python tools_torch/scaling_check.py
On the CPU:      BMTPU_PLATFORM=cpu python tools_torch/scaling_check.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch.config import resolve_device  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from bitmagic_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from bitmagic_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedBitVector, pipeline_counts_program, scan_throughput_program)
from bitmagic_tpu_torch.parallel.sharded_sv import (  # noqa: E402
    ShardedSparseVector)
from tools_torch import sync  # noqa: E402

MESH_SIZES = (1, 2, 4, 8)


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"scaling_check: {what}")


def _launched(before):
    return {k: v - before[k] for k, v in ck.launches.items()}


def main(argv=None):
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    if argv:
        raise SystemExit(f"scaling_check takes no arguments: {argv}")
    dev = resolve_device()
    print(f"backend={dev.type} devices={max(MESH_SIZES)}")
    rng = np.random.default_rng(0)
    blocks_per_shard = 8
    n_planes = 32

    for n in MESH_SIZES:
        mesh = Mesh([dev] * n)
        scan, sharding = scan_throughput_program(mesh, n_planes,
                                                 blocks_per_shard)
        nblk = blocks_per_shard * n
        planes_h = rng.integers(0, 2**32, (n_planes, nblk, 2048),
                                dtype=np.uint64).astype(np.uint32)
        planes = sharding.place(planes_h)
        scan(planes, 123)
        sync()
        before = dict(ck.launches)
        t0 = time.perf_counter()
        for _ in range(3):
            scan(planes, 124)
        sync()
        dt = (time.perf_counter() - t0) / 3
        per_scan = {k: v // 3 for k, v in _launched(before).items()}
        elems = nblk * 2048 * 32

        # sharded count + select on the same mesh size
        ids = np.unique(rng.integers(0, nblk * 65536, 20_000))
        sbv = ShardedBitVector.from_indices(ids.astype(np.int64),
                                            nblk * 65536, mesh)
        _check(sbv.count() == len(ids), f"mesh={n}: count")
        _check(sbv.count_shardmap() == len(ids), f"mesh={n}: count_shardmap")
        sel = sbv.select_batch([1, len(ids)])
        _check(sel[0] == ids[0] and sel[1] == ids[-1], f"mesh={n}: select")

        # sharded bulk-search pipeline (per-shard sweep + host combine)
        sels = np.zeros((16, n_planes), np.int32)
        sels[:, 0] = 1
        sels[:, 1:4] = rng.integers(-1, 2, (16, 3))
        prog = pipeline_counts_program(mesh)
        prog(planes, sels)
        sync()
        before = dict(ck.launches)
        t0 = time.perf_counter()
        prog(planes, sels)
        sync()
        dtp = time.perf_counter() - t0
        per_pipe = _launched(before)

        # succinct-vector scan through the CONTAINER API
        # (parallel/sharded_sv.py), pinned to numpy ground truth
        vals = rng.integers(0, 1 << 16, nblk * 65536 // 8).astype(np.uint32)
        ssv = ShardedSparseVector.from_array(vals, mesh)
        q = int(vals[42])
        _check(ssv.find_eq_count(q) == int((vals == q).sum()),
               f"mesh={n}: find_eq_count")
        _check(ssv.find_gt(1 << 15).count() == int((vals > (1 << 15)).sum()),
               f"mesh={n}: find_gt")
        batch = [int(v) for v in vals[:8]]
        ssv.pipeline_find_eq(batch)
        sync()
        t0 = time.perf_counter()
        got = ssv.pipeline_find_eq(batch)
        dts = time.perf_counter() - t0
        _check(got == [int((vals == b).sum()) for b in batch],
               f"mesh={n}: pipeline_find_eq")

        print(f"mesh={n}: scan {elems/1e6:.0f}M elems in {dt*1e3:.1f} ms "
              f"(weak scaling), 16-query pipeline {dtp*1e3:.1f} ms, "
              f"sharded-SV container 8-query pipeline {dts*1e3:.1f} ms, "
              f"count/psum + shard-prefix select OK; launches per step: "
              f"scan {per_scan['scan_eq']} B6 + {per_scan['block_counts']} "
              f"K3, pipeline {per_pipe['pipeline_counts']} B5")
    return 0


if __name__ == "__main__":
    sys.exit(main())
