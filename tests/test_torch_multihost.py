"""Sharding across processes in the PyTorch port: ``parallel.process_mesh``
and ``sharded._host_fetch`` over ``torch.distributed`` (gloo, CPU
tensors), on the CPU.

``tools_torch/multihost_check.py`` runs in two gloo processes of 4 CPU
shards each and passes every check of the JAX tool's worker (steps 1-6,
each against numpy) plus the rest of the sharded bit-vector's entry
points (count, count_range, select_batch, rank_batch, get_bits, to_words,
to_bitvector, the checkpoint, reshard, the AND groups and the vector-axis
exchange); both processes report the same results, and those equal a
one-process run of the same containers on ``Mesh(["cpu"] * 8)``.  A
second pair of processes owns 3 and 5 shards, so a gather that ignored
the mesh order would scramble them.  Without a process group
``_host_fetch`` returns its input as it is.  The processes meet in a
``file://`` store (no fixed port) and every collective times out after
120 s.  Tolerance: exact equality (integer results).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch.parallel import Mesh, ShardedBitVector
from bitmagic_tpu_torch.parallel.sharded import _host_fetch
from tools_torch import multihost_check as mh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
# per-run numbers that are no result: the scan's wall time, the BLOB
# merge (one partition per process) and the mesh size
NOT_RESULTS = ("scan_s", "merged_count", "n_global")


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def test_host_fetch_without_a_group_returns_its_input():
    parts = [np.arange(3), np.zeros((2, 4), np.uint8)]
    assert _host_fetch(Mesh(["cpu"] * 2), parts) is parts
    mesh = Mesh(["cpu"] * 4)
    assert mesh.ranks is None and mesh.local == (0, 1, 2, 3)


def test_two_processes_equal_one_process_and_numpy(tmp_path, monkeypatch):
    monkeypatch.setenv("BMTPU_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "out"
    assert mh.main(["2", "--out", str(out)]) == 0
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["n_global"] == 8
    for r in ranks:
        for k in NOT_RESULTS:
            r.pop(k)
    assert ranks[0] == ranks[1]
    # one process, the same containers on 8 CPU shards
    mesh = Mesh(["cpu"] * 8)
    d = mh.draws(8, 0, 2)
    one = mh.containers(mesh, d, mh.local_planes(mesh, d["planes"]))
    one.pop("scan_s")
    assert one == ranks[0]
    # a few of them against numpy here as well
    pg = d["planes"]
    assert one["popcount"] == int(np.bitwise_count(pg[0]).sum())
    assert one["count"] == int(np.bitwise_count(
        pg[2] & pg[3] & pg[4]).sum())
    assert one["find_eq_count"] == int((d["vals"] == d["vals"][55]).sum())
    assert one["and_many_narrowing"][1] == d["nblk"]


_UNEVEN = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch.distributed as dist
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.parallel import (Mesh, ShardedBitVector,
                                             ShardedSparseVector,
                                             process_mesh)
    rank, init = int(sys.argv[1]), sys.argv[2]
    tbm.config.device = "cpu"
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    mesh = process_mesh(["cpu"] * (3 if rank == 0 else 5))
    again = process_mesh(["cpu"] * (3 if rank == 0 else 5))
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (16, 2048), dtype=np.uint64).astype(
        np.uint32)
    words[rng.random(16) < 0.5] = 0
    a = ShardedBitVector.from_words(words, 16 * 65536 - 100, mesh)
    b = ShardedBitVector.from_words(words[::-1].copy(), 16 * 65536, again)
    vals = rng.integers(0, 300, 16 * 65536 // 4).astype(np.uint32)
    sv = ShardedSparseVector.from_array(vals, mesh)
    out = {"local": list(mesh.local), "ranks": list(mesh.ranks),
           "equal": mesh == again and hash(mesh) == hash(again),
           "n_shards": len(a.shards),
           "words": bool(np.array_equal(a.to_words(), words)),
           "count": a.count(), "and": (a & b).count(),
           "select": a.select_batch([1, 5000, a.count()]).tolist(),
           "rank": a.build_rs_index().rank_batch(
               [0, 70000, 16 * 65536 - 101]).tolist(),
           "gather": bool(np.array_equal(sv.gather(np.arange(0, vals.size,
                                                             7)),
                                          vals[::7])),
           "find_eq": sv.find_eq_count(17),
           "repr": repr(mesh)}
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_uneven_local_shards_keep_the_mesh_order(tmp_path):
    init = "file://" + str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _UNEVEN, str(r), init],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, e[-3000:]
            outs.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs[0]["local"] == [0, 1, 2] and outs[1]["local"] == [3, 4, 5,
                                                                  6, 7]
    assert outs[0]["n_shards"] == 3 and outs[1]["n_shards"] == 5
    for o in outs:
        o.pop("local")
        o.pop("n_shards")
    assert outs[0] == outs[1]
    o = outs[0]
    assert o["ranks"] == [0, 0, 0, 1, 1, 1, 1, 1] and o["equal"]
    assert o["words"] and o["gather"]
    assert "ranks=[0, 0, 0, 1, 1, 1, 1, 1]" in o["repr"]
    # the same vectors in one process
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (16, 2048), dtype=np.uint64).astype(
        np.uint32)
    words[rng.random(16) < 0.5] = 0
    mesh = Mesh(["cpu"] * 8)
    a = ShardedBitVector.from_words(words, 16 * 65536 - 100, mesh)
    b = ShardedBitVector.from_words(words[::-1].copy(), 16 * 65536, mesh)
    vals = rng.integers(0, 300, 16 * 65536 // 4).astype(np.uint32)
    assert o["count"] == a.count() == int(np.bitwise_count(words).sum())
    assert o["and"] == (a & b).count()
    assert o["select"] == a.select_batch([1, 5000, a.count()]).tolist()
    assert o["rank"] == a.build_rs_index().rank_batch(
        [0, 70000, 16 * 65536 - 101]).tolist()
    assert o["find_eq"] == int((vals == 17).sum())


def test_a_failing_worker_fails_the_run_at_once():
    """run_workers stops the others at the first non-zero exit."""
    import time
    t0 = time.monotonic()
    rc = mh.run_workers(lambda i: [sys.executable, "-c",
                                   "import sys, time; "
                                   f"time.sleep({0 if i == 0 else 60}); "
                                   "sys.exit(3)"], 2, 120)
    assert rc == 3 and time.monotonic() - t0 < 30
    assert mh.run_workers(lambda i: [sys.executable, "-c", "pass"], 2,
                          120) == 0
    assert mh.run_workers(lambda i: [sys.executable, "-c",
                                     "import time; time.sleep(60)"], 1,
                          1) == 124
