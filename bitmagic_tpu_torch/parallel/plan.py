"""Parallel plan builders: coarse-grained task fan-out on the host (port
of ``bitmagic_tpu/parallel/plan.py``).

Equivalent of `src/bmsparsevec_parallel.h` (optimize_plan_builder :36,
compute_sim_matrix_plan_builder :103, sv_serialization_plan_builder :162)
and the task/thread-pool layer (src/bmtask.h, src/bmthreadpool.h).  Task
batches run on a host thread pool; the per-plane structure of succinct
vectors gives the task granularity.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


class TaskBatch:
    """Ordered task list (reference task_batch, src/bmtask.h:139)."""

    def __init__(self):
        self.tasks = []

    def add(self, fn, *args, **kwargs):
        self.tasks.append((fn, args, kwargs))
        return self

    def __len__(self):
        return len(self.tasks)


def run_task_batch(batch: TaskBatch, n_threads: int = 0) -> list:
    """Run a batch (reference run_task_batch, src/bmtask.h:194 /
    thread_pool_executor::run, src/bmthreadpool.h:330).  n_threads=0 runs
    sequentially (the reference's default executor)."""
    if n_threads <= 1:
        return [fn(*a, **k) for fn, a, k in batch.tasks]
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        futs = [pool.submit(fn, *a, **k) for fn, a, k in batch.tasks]
        return [f.result() for f in futs]


def build_optimize_plan(sv) -> TaskBatch:
    """Per-plane optimize tasks (reference optimize_plan_builder)."""
    batch = TaskBatch()
    sv._flush()
    for p in sv.planes:
        if p is not None:
            batch.add(p.optimize)
    if getattr(sv, "nullable", False) and sv.null_plane is not None:
        batch.add(sv.null_plane.optimize)
    return batch


def build_sv_serialization_plan(sv, level: int = 6) -> TaskBatch:
    """Per-plane serialization tasks (reference
    sv_serialization_plan_builder): a batch whose results are (slice_id,
    blob) pairs."""
    from ..serial.serializer import Serializer
    batch = TaskBatch()
    sv._flush()
    for s, p in enumerate(sv.planes):
        if p is not None and p.any():
            batch.add(lambda p=p, s=s: (s, Serializer(level).serialize(p)))
    return batch


def build_sim_matrix_plan(vectors, metric=None) -> TaskBatch:
    """All-pairs similarity tasks (reference
    compute_sim_matrix_plan_builder)."""
    from ..algo import setops
    metric = metric or setops.COUNT_XOR
    batch = TaskBatch()
    n = len(vectors)
    for i in range(n):
        for j in range(i + 1, n):
            batch.add(lambda i=i, j=j: (
                i, j, setops.distance_operation(vectors[i], vectors[j],
                                                [metric])[metric]))
    return batch
