"""BLOB broadcast and gather between processes (``parallel/blobcast.py``)
in the PyTorch port, on the CPU: the single-process cases of
``tests/test_blobcast.py`` held against the JAX package's BLOBs, then a
two-process ``torch.distributed`` run over gloo (the counterpart of
``tools/multihost_check.py``), initialised through a ``file://`` store.
The two-process run has a hard time limit: the children are joined with a
timeout, then terminated, and the test fails.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bitmagic_tpu as jbm
import bitmagic_tpu_torch as tbm
from bitmagic_tpu_torch.parallel import (all_gather_blobs,
                                         broadcast_bitvector,
                                         broadcast_bytes,
                                         broadcast_sparse_vector,
                                         merge_broadcast_parts)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOO_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(tbm.config, "device", "cpu")


def test_broadcast_bytes_identity():
    assert broadcast_bytes(b"abc\x00\xff") == b"abc\x00\xff"
    with pytest.raises(ValueError):
        broadcast_bytes(None)


def test_broadcast_bitvector_roundtrip():
    rng = np.random.default_rng(1)
    ids = np.unique(rng.integers(0, 2**34, 5000)).astype(np.int64)
    bv = tbm.BitVector.from_indices(ids, 2**34)
    bv.set_range(100_000, 200_000)
    bv.optimize()
    got = broadcast_bitvector(bv, device="cpu")
    assert got == bv and got.device.type == "cpu"
    jbv = jbm.BitVector.from_indices(ids, 2**34)
    jbv.set_range(100_000, 200_000)
    jbv.optimize()
    from bitmagic_tpu.parallel import broadcast_bitvector as jbroadcast
    np.testing.assert_array_equal(got.indices(),
                                  np.asarray(jbroadcast(jbv).indices()))


def test_partition_merge_pattern():
    rng = np.random.default_rng(2)
    size = 10_000_000
    parts = [tbm.BitVector.from_indices(
        np.unique(rng.integers(i * 2_500_000, (i + 1) * 2_500_000, 3000)),
        size) for i in range(4)]
    blobs = [tbm.Serializer(6).serialize(p) for p in parts]
    merged = merge_broadcast_parts(blobs)
    want = parts[0]
    for p in parts[1:]:
        want = want | p
    assert merged == want
    assert all_gather_blobs(blobs[0]) == [blobs[0]]


def test_broadcast_sparse_vector():
    vals = np.arange(5000, dtype=np.uint32) * 7
    sv = tbm.SparseVector.from_array(vals, nullable=True)
    got = broadcast_sparse_vector(sv)
    assert got.equal(sv)


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.parallel import (all_gather_blobs,
        broadcast_bitvector, broadcast_bytes, broadcast_sparse_vector,
        merge_broadcast_parts)
    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    tbm.config.device = "cpu"
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    root = rank == 0
    out = {}
    out["bytes"] = broadcast_bytes(b"payload\\x00\\xff" * 3 if root
                                   else None).hex()
    out["empty"] = broadcast_bytes(b"" if root else None).hex()
    ids = np.arange(0, 3_000_000, 7)
    bv = tbm.BitVector.from_indices(ids, 1 << 22) if root else None
    got = broadcast_bitvector(bv)
    out["bv"] = [int(got.count()), int(got.indices()[-1])]
    vals = np.arange(5000, dtype=np.uint32) * 7
    sv = tbm.SparseVector.from_array(vals, nullable=True) if root else None
    gsv = broadcast_sparse_vector(sv)
    out["sv"] = bool(np.array_equal(gsv.to_numpy(), vals))
    mine = tbm.BitVector.from_indices(
        np.arange(rank * 1000, rank * 1000 + 10 + rank), 1 << 20)
    parts = all_gather_blobs(tbm.Serializer(6).serialize(mine))
    out["parts"] = [len(p) for p in parts]
    out["merged"] = merge_broadcast_parts(parts).indices().tolist()
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_two_process_gloo(tmp_path):
    init = "file://" + str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2",
                               init], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=GLOO_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo run did not end within {GLOO_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs[0] == outs[1]
    o = outs[0]
    assert bytes.fromhex(o["bytes"]) == b"payload\x00\xff" * 3
    assert o["empty"] == ""
    ids = np.arange(0, 3_000_000, 7)
    assert o["bv"] == [ids.size, int(ids[-1])]
    assert o["sv"] is True
    want_parts = [tbm.Serializer(6).serialize(tbm.BitVector.from_indices(
        np.arange(r * 1000, r * 1000 + 10 + r), 1 << 20)) for r in range(2)]
    assert o["parts"] == [len(p) for p in want_parts]
    assert o["merged"] == list(range(10)) + list(range(1000, 1011))
