"""Sharding over a mesh of devices (port of ``bitmagic_tpu/parallel``):
meshes, sharded bit-vectors and sparse vectors whose per-shard steps run
the port's kernels, host task plans, and BLOB broadcast between processes
through ``torch.distributed``."""

from .mesh import (BLOCK_AXIS, Mesh, block_sharding, make_mesh, pad_rows,
                   replicated)
from .sharded import (ShardedBitVector, ShardedRSIndex,
                      group_and_exchange, pipeline_counts_host,
                      pipeline_counts_program, scan_throughput_program,
                      sharded_and_many, sharded_and_sub,
                      sharded_and_sub_count)
from .sharded_sv import (ShardedFloatVector, ShardedRSCVector,
                         ShardedSparseVector, ShardedStrSparseVector)
from .blobcast import (all_gather_blobs, broadcast_bitvector,
                       broadcast_bytes, broadcast_sparse_vector,
                       merge_broadcast_parts)
from .plan import (TaskBatch, build_optimize_plan, build_sim_matrix_plan,
                   build_sv_serialization_plan, run_task_batch)

__all__ = [
    "BLOCK_AXIS", "block_sharding", "make_mesh", "replicated",
    "ShardedBitVector", "ShardedRSIndex", "ShardedFloatVector",
    "ShardedRSCVector",
    "ShardedSparseVector", "ShardedStrSparseVector", "group_and_exchange",
    "pipeline_counts_host", "pipeline_counts_program",
    "scan_throughput_program", "sharded_and_many", "sharded_and_sub",
    "sharded_and_sub_count", "TaskBatch", "build_optimize_plan",
    "build_sim_matrix_plan", "build_sv_serialization_plan",
    "run_task_batch", "all_gather_blobs", "broadcast_bitvector",
    "broadcast_bytes", "broadcast_sparse_vector", "merge_broadcast_parts",
    "Mesh", "pad_rows",
]
