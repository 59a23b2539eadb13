"""Multi-process sharding validation.

The single-process meshes (tools_torch/scaling_check.py) validate
sharding inside one process; this harness validates the CROSS-PROCESS
path: N separate processes, each owning 4 local shards (4 CPU shards, or
4 shards on ``cuda:0`` on the card), joined through ``torch.distributed``
over gloo on 127.0.0.1 into one mesh that spans them
(``parallel.process_mesh``).  Every cross-shard combine then crosses
process boundaries (``parallel.sharded._host_fetch``).  The programs
under test are the library's own: the global popcount, the sharded scan,
the bulk-search pipeline, the BLOB broadcast, the four sharded
succinct-vector containers, and the rest of the sharded bit-vector's
entry points (count, count_range, select, rank, get_bits, the host image,
the checkpoint, reshard, the digest-narrowed AND groups and the
vector-axis exchange).  Every process knows the global content (one seed
everywhere) and checks every result against numpy.

Run on the card: python tools_torch/multihost_check.py [n_processes]
On the CPU:      BMTPU_PLATFORM=cpu python tools_torch/multihost_check.py

``--out DIR`` makes each process write its results to
``DIR/rank<r>.json``.  The processes meet in a ``file://`` store in a new
temporary directory (no fixed port); every collective times out after
COLLECTIVE_TIMEOUT_S, and a process that fails, or a run that outlives
RUN_TIMEOUT_S, stops the others and fails the run.
"""
import argparse
import datetime
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch.config import resolve_device  # noqa: E402
from bitmagic_tpu_torch.parallel import (  # noqa: E402
    Mesh, ShardedBitVector, ShardedFloatVector, ShardedRSCVector,
    ShardedSparseVector, ShardedStrSparseVector, all_gather_blobs,
    broadcast_bitvector, group_and_exchange, merge_broadcast_parts,
    pipeline_counts_host, process_mesh, scan_throughput_program,
    sharded_and_many, sharded_and_sub_count)
from bitmagic_tpu_torch.serial.serializer import Serializer  # noqa: E402
from bitmagic_tpu_torch.sv import (  # noqa: E402
    FloatSparseVector, RSCSparseVector, SparseVector, StrSparseVector)
from tools_torch import sync  # noqa: E402

N_LOCAL = 4                     # shards per process
N_PLANES, BLOCKS_PER_DEV = 16, 2
BLOB_SIZE = 4_000_000
COLLECTIVE_TIMEOUT_S = 120
RUN_TIMEOUT_S = 600             # the whole run, every process


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"multihost_check: {what}")


def _popcount(words) -> int:
    return int(np.bitwise_count(np.asarray(words, np.uint32)).sum(
        dtype=np.int64))


def draws(n_global: int, pid: int, n_proc: int) -> dict:
    """Every input of one process, drawn from one seed in the JAX tool's
    order (the same everywhere but ``my_ids``, each process's BLOB
    partition)."""
    rng = np.random.default_rng(7)
    nblk = BLOCKS_PER_DEV * n_global
    d = {"nblk": nblk}
    d["planes"] = rng.integers(0, 2**32, (N_PLANES, nblk, 2048),
                               dtype=np.uint64).astype(np.uint32)
    d["root_ids"] = np.unique(rng.integers(0, BLOB_SIZE, 3000)).astype(
        np.int64)
    span = BLOB_SIZE // n_proc
    d["my_ids"] = np.unique(rng.integers(pid * span, (pid + 1) * span,
                                         1000)).astype(np.int64)
    vals = rng.integers(0, 4096, nblk * 65536 // 8).astype(np.uint32)
    vals[3] = 9999
    d["vals"] = vals
    ivals = rng.integers(-5000, 5000, 40_000).astype(np.int64)
    ivals[7] = np.iinfo(np.int64).min
    d["ivals"] = ivals
    fvals = np.round(rng.normal(0, 100, 20_000), 1).astype(np.float32)
    fvals[11] = 777.5
    d["fvals"] = fvals
    strs = [f"k{int(x):04d}" for x in rng.integers(0, 2000, 15_000)]
    strs[5] = "needle"
    d["strs"] = strs
    d["rvals"] = rng.integers(0, 1000, 30_000).astype(np.uint32)
    d["rnull"] = rng.random(30_000) < 0.7
    return d


def local_planes(mesh: Mesh, planes_global: np.ndarray) -> list:
    """This process's shards of the plane stack, cut from the host rows
    it owns (the counterpart of ``host_local_array_to_global_array``)."""
    per = planes_global.shape[1] // mesh.size
    return [torch.from_numpy(np.ascontiguousarray(
        planes_global[:, j * per:(j + 1) * per]).view(np.int32)).to(
            mesh.devices[j]) for j in mesh.local]


def _scan_oracle(planes, n_planes, value) -> int:
    acc = np.full(planes.shape[1:], 0xFFFFFFFF, np.uint32)
    for b in range(n_planes):
        acc &= planes[b] if (value >> b) & 1 else ~planes[b]
    return _popcount(acc)


def scan_step(mesh: Mesh, planes) -> tuple:
    """Step 2: the sharded scan (one B6 and one K3 per shard) -> (hits,
    seconds)."""
    scan, _ = scan_throughput_program(mesh, N_PLANES, BLOCKS_PER_DEV)
    sync()
    t0 = time.perf_counter()
    hits = int(scan(planes, 123))
    sync()
    return hits, time.perf_counter() - t0


def containers(mesh: Mesh, d: dict, planes) -> dict:
    """Steps 1-3, 5 and 6 of the JAX tool's worker over ``mesh`` (any
    mesh: one process or many), then the rest of the sharded bit-vector's
    entry points; every result checked against numpy and returned."""
    pg = d["planes"]
    nblk = d["nblk"]
    out = {}

    # 1. global popcount (per-shard K3 partials, combined across processes)
    pop = ShardedBitVector([p[0] for p in planes], nblk * 65536,
                           mesh).count()
    _check(pop == _popcount(pg[0]), f"popcount {pop}")
    out["popcount"] = pop

    # 2. sharded scan (fused AND-SUB + global count)
    hits, out["scan_s"] = scan_step(mesh, planes)
    _check(hits == _scan_oracle(pg, N_PLANES, 123), f"scan {hits}")
    out["scan_hits"] = hits

    # 3. bulk-search pipeline (per-shard sweep; host int64 combine)
    sels = np.zeros((8, N_PLANES), np.int32)
    sels[:, 0] = 1
    sels[:, 1] = [-1, 0, 1, -1, 0, 1, -1, 0]
    counts = pipeline_counts_host(mesh, planes, sels)
    want0 = _popcount(pg[0] & ~pg[1])
    _check(int(counts[0]) == want0, f"pipeline {int(counts[0])} != {want0}")
    out["pipeline"] = [int(c) for c in counts]

    # 5. the sharded succinct-vector CONTAINER: find_eq digest narrowing +
    #    pipeline, each process checking the global result
    vals = d["vals"]
    ssv = ShardedSparseVector.from_array(vals, mesh)
    qv = int(vals[55])
    out["find_eq_count"] = ssv.find_eq_count(qv)
    _check(out["find_eq_count"] == int((vals == qv).sum()), "find_eq_count")
    hit = ssv.find_eq(9999)
    surv, tot = hit.last_narrowing
    n_hit = hit.count()
    _check(surv <= 1 and n_hit == 1, f"find_eq(9999) {surv} {tot}")
    out["find_eq_9999"] = [surv, tot, n_hit]
    pc = ssv.pipeline_find_eq([qv, 9999])
    _check(pc == [int((vals == qv).sum()), 1], f"pipeline_find_eq {pc}")
    out["pipeline_find_eq"] = pc

    # 6. the REST of the sharded container family: signed ordered search,
    #    string scanner with remap, float magnitude descent, RSC rank
    #    decompression
    ivals = d["ivals"]
    issv = ShardedSparseVector.from_array(ivals, mesh)
    out["signed_find_gt"] = issv.find_gt(-17).count()
    _check(out["signed_find_gt"] == int((ivals > -17).sum()), "find_gt")
    out["signed_find_le_min"] = issv.find_le(np.iinfo(np.int64).min).count()
    _check(out["signed_find_le_min"] == 1, "find_le(int64 min)")

    fvals = d["fvals"]
    sfv = ShardedFloatVector.from_float_vector(
        FloatSparseVector.from_array(fvals), mesh)
    out["float_find_eq"] = sfv.find_eq(777.5).count()
    _check(out["float_find_eq"] == int((fvals == np.float32(777.5)).sum()),
           "float find_eq")
    out["float_find_gt"] = sfv.find_gt(50.0).count()
    _check(out["float_find_gt"] == int((fvals > 50.0).sum()),
           "float find_gt")

    strs = d["strs"]
    sv_str = StrSparseVector.from_strings(strs, max_str_size=8)
    sv_str.remap()
    sss = ShardedStrSparseVector.from_str_vector(sv_str, mesh)
    out["str_find_eq"] = sss.find_eq_str("needle").count()
    _check(out["str_find_eq"] == 1, "find_eq_str(needle)")
    out["str_find_eq_count"] = sss.find_eq_str_count(strs[100])
    _check(out["str_find_eq_count"] == strs.count(strs[100]),
           "find_eq_str_count")

    rvals, rnull = d["rvals"], d["rnull"]
    rsc = RSCSparseVector.from_sparse_vector(
        SparseVector.from_array(rvals, nullable=True, null_mask=rnull))
    srsc = ShardedRSCVector.from_rsc(rsc, mesh)
    qr = int(rvals[~rnull][0]) if (~rnull).any() else 0
    out["rsc_find_eq"] = srsc.find_eq(qr).count()
    _check(out["rsc_find_eq"] == int(((~rnull) & (rvals == qr)).sum()),
           "rsc find_eq")

    out.update(bitvector_entry_points(mesh, d))
    return out


def bitvector_entry_points(mesh: Mesh, d: dict) -> dict:
    """The sharded bit-vector's other entry points over ``mesh``, on rows
    of the plane stack: count_range, select and rank batches, get_bits,
    block counts, digests, the host image, collect, checkpoint, reshard
    onto this process's first device, the AND groups and the vector-axis
    exchange."""
    pg, nblk = d["planes"], d["nblk"]
    size = nblk * 65536
    words = pg[2] & pg[3] & pg[4]           # a quarter of the bits
    flat = words.reshape(-1)
    a = ShardedBitVector.from_words(words, size, mesh)
    out = {"count": a.count()}
    _check(out["count"] == _popcount(words), "count")
    lo, hi = size // 3, size - 12345
    out["count_range"] = a.count_range(lo, hi)
    bits = np.unpackbits(flat.view(np.uint8), bitorder="little")
    _check(out["count_range"] == int(bits[lo:hi + 1].sum()), "count_range")
    ones = np.flatnonzero(bits)
    rng = np.random.default_rng(11)
    ranks = np.concatenate([rng.integers(1, ones.size + 1, 500),
                            [1, ones.size, 0, ones.size + 1]])
    got = a.select_batch(ranks)
    want = np.where((ranks >= 1) & (ranks <= ones.size),
                    ones[np.clip(ranks - 1, 0, ones.size - 1)], -1)
    _check(np.array_equal(got, want), "select_batch")
    out["select"] = got.tolist()
    ids = np.concatenate([rng.integers(0, size, 500), [0, size - 1]])
    got = a.build_rs_index().rank_batch(ids)
    _check(np.array_equal(got, np.cumsum(bits)[ids]), "rank_batch")
    out["rank"] = got.tolist()
    got = a.get_bits(ids)
    _check(np.array_equal(got, bits[ids].astype(bool)), "get_bits")
    out["block_counts"] = a.block_counts().tolist()
    _check(out["block_counts"] == np.bitwise_count(words).sum(
        axis=1).tolist(), "block_counts")
    dig = a.digests()
    _check(np.array_equal(dig.astype(bool), (words.reshape(nblk, 64, 32)
                                             != 0).any(axis=2)), "digests")
    host = a.to_words()
    _check(np.array_equal(host, words), "to_words")
    out["to_words_sha256"] = hashlib.sha256(host.tobytes()).hexdigest()
    _check(a.to_bitvector().count() == out["count"], "to_bitvector")
    blob = a.checkpoint_bytes()
    out["checkpoint_sha256"] = hashlib.sha256(blob).hexdigest()
    back = ShardedBitVector.from_checkpoint(blob, mesh)
    _check(np.array_equal(back.to_words(), words), "checkpoint round trip")
    one = a.reshard(Mesh([mesh.devices[mesh.local[0]]]))
    _check(np.array_equal(one.to_words(), words), "reshard to one shard")
    # the first operand holds every third block only: narrowing skips 2/3
    first = pg[5] & np.where(np.arange(nblk)[:, None] % 3 == 0, pg[8],
                             0).astype(np.uint32)
    vs = [ShardedBitVector.from_words(w, size, mesh)
          for w in (first, pg[6], pg[7])]
    r = sharded_and_many(vs)
    _check(np.array_equal(r.to_words(), first & pg[6] & pg[7]),
           "sharded_and_many")
    out["and_many_narrowing"] = list(r.last_narrowing)
    out["and_sub_count"] = sharded_and_sub_count(vs[:2], vs[2:])
    _check(out["and_sub_count"] == _popcount(first & pg[6] & ~pg[7]),
           "sharded_and_sub_count")
    vmesh = (process_mesh([mesh.devices[j] for j in mesh.local], "v")
             if mesh.ranks is not None else Mesh(mesh.devices, "v"))
    stack = pg[np.arange(mesh.size) % N_PLANES] & pg[9]
    rows, surv, traffic = group_and_exchange(stack, vmesh, "v")
    want_rows = np.bitwise_and.reduce(stack, axis=0)
    _check(np.array_equal(rows.cpu().numpy().view(np.uint32),
                          want_rows[surv] if surv.size
                          else np.zeros((1, 2048), np.uint32)),
           "group_and_exchange rows")
    cnt, _, _ = group_and_exchange(stack, vmesh, "v", count_only=True)
    _check(cnt == _popcount(want_rows), "group_and_exchange count")
    out["exchange"] = [surv.tolist(), list(traffic), cnt]
    return out



def blob_steps(d: dict, pid: int):
    """Step 4: BLOB broadcast + partition/merge over the process group:
    compressed bytes travel, never dense bitmaps."""
    root_ids, my_ids = d["root_ids"], d["my_ids"]
    root_bv = (bm.BitVector.from_indices(root_ids, BLOB_SIZE) if pid == 0
               else None)
    got = broadcast_bitvector(root_bv)
    _check(np.array_equal(got.indices(), root_ids), "blob broadcast")
    my_blob = Serializer(6).serialize(bm.BitVector.from_indices(
        my_ids, BLOB_SIZE))
    merged = merge_broadcast_parts(all_gather_blobs(my_blob))
    _check(merged.count() > 0 and merged.test(int(my_ids[0])),
           "partition/merge")
    return merged.count()


def worker_steps(pid: int, n_proc: int, device) -> dict:
    """Every step over a mesh of N_LOCAL shards of ``device`` in each
    process of the (initialised) default group."""
    mesh = process_mesh([device] * N_LOCAL)
    d = draws(mesh.size, pid, n_proc)
    res = containers(mesh, d, local_planes(mesh, d["planes"]))
    res["merged_count"] = blob_steps(d, pid)
    res["n_global"] = mesh.size
    return res


def worker(pid: int, n_proc: int, init: str, out_dir=None) -> int:
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    device = resolve_device()
    dist.init_process_group(
        "gloo", init_method=init, rank=pid, world_size=n_proc,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        res = worker_steps(pid, n_proc, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if out_dir:
        with open(os.path.join(out_dir, f"rank{pid}.json"), "w") as f:
            json.dump(res, f)
    if pid == 0:
        print(f"multihost OK: {n_proc} processes x {N_LOCAL} devices = "
              f"{res['n_global']} global; popcount/psum, scan "
              f"({res['scan_s'] * 1e3:.1f} ms), 8-query pipeline, BLOB "
              f"broadcast + partition/merge, sharded int/signed/float/str/"
              f"RSC container scans all verified cross-host", flush=True)
    return 0


def run_workers(argv_of, n: int, timeout: float) -> int:
    """Start ``n`` fresh interpreters (``argv_of(rank)``) and wait for all;
    the first non-zero exit or the timeout stops the rest.  Returns 0 or
    the failing exit code (124 on the timeout)."""
    procs = [subprocess.Popen(argv_of(i)) for i in range(n)]
    deadline = time.monotonic() + timeout
    rc = 0
    try:
        while rc == 0 and any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                rc = 124
                break
            rc = next((p.returncode for p in procs
                       if p.returncode not in (None, 0)), 0)
            time.sleep(0.1)
        if rc == 0:
            rc = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:
        pid, n_proc, init = int(argv[1]), int(argv[2]), argv[3]
        return worker(pid, n_proc, init, argv[4] if len(argv) > 4 else None)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2,
                   help="processes (default 2)")
    p.add_argument("--out", help="directory for each process's results")
    args = p.parse_args(argv)
    bm.config.device_from_env()
    resolve_device()              # no card and no BMTPU_PLATFORM: raises
    tmp = tempfile.mkdtemp(prefix="bm_multihost_")
    init = "file://" + os.path.join(tmp, "store")
    extra = []
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        extra = [os.path.abspath(args.out)]
    try:
        rc = run_workers(lambda i: [sys.executable, os.path.abspath(__file__),
                                    "--worker", str(i), str(args.n), init]
                         + extra, args.n, RUN_TIMEOUT_S)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rc:
        print(f"multihost_check: a worker failed (exit code {rc})",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
