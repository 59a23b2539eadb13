#!/usr/bin/env python3
"""Time the port's sv_gather against a parent commit's, in turns, on one
NVIDIA card, and measure the gather's cut-over.

    git archive <parent> | tar -x -C _archive/parent
    python3 tools/torch_gather_turns.py [--parent _archive/parent]

The parent's ``bitmagic_tpu_torch/ops/csrc/sv_planes.cu`` is built with
its own ``bm_common.cuh`` and the port's nvcc flags, and called through
its C interface (``bm_sv_gather(ids, n, table, n_planes, nb, ent, runs,
out, stream)``: one thread per id over the plane table's per-plane
lists).  The column is ``column_range_gather``'s (chip_smoke.sv_timings:
16M nullable values < 2^20, every row assigned, 21 planes); its plane
table serves both versions (the directory is ignored by the parent's).
Times are medians of 25 runs between CUDA events, L2 evicted before each
(``chip_smoke.time_ms``); every answer must equal the plain version's.

turns: 1M uniform ids, parent, new, new, parent.
density: uniform ids from 1 to 1M, each timed through the direct launch
    and the grouped passes (``cuda_kernels._gather``) and the parent's:
    the direct launch's cut-over (GATHER_DIRECT_MAX, GATHER_ROW_IDS) at
    the ids per directory row each count gives.
split: the device ms of each launch of one 1M-id gather (profiler
    events, five gathers, L2 evicted before each), uniform and sorted ids.

Prints one JSON line per measurement, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import bitmagic_tpu_torch as tbm  # noqa: E402
from bitmagic_tpu_torch.ops import _build  # noqa: E402
from bitmagic_tpu_torch.ops import blockops  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

VP, INT, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
DENSITIES = (1, 1000, 4096, 16384, 65536, 131072, 262144, 393216,
             524288, 786432, 1_000_000)


def build_old(csrc, sources):
    """``sources`` of the parent's ``csrc`` directory, built side by side
    into it with the port's nvcc flags -> {source: CDLL}; logs each
    kernel's registers and spills."""
    procs = []
    for src in sources:
        so = os.path.join(csrc, f"old_{src[:-3]}.so")
        procs.append((src, so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so,
             os.path.join(csrc, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, so, p in procs:
        text, _ = p.communicate()
        cs.check(p.returncode == 0, f"build of the parent's {src}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"parent {src}: {line.strip()}")
        libs[src] = ctypes.CDLL(so)
    return libs


def log_new_build():
    _build.build_all()
    for src in ("sv_planes.cu", "rs_select.cu"):
        for line in _build.build_log.get(src, "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                cs.log(f"new {src}: {line.strip()}")


def peak_bw():
    """The card's memory rate that chip_smoke.py's bounds use."""
    name = torch.cuda.get_device_name(0)
    return next((v for k, v in cs.PEAK_BW.items() if k in name),
                cs.PEAK_BW["H100"])


def launch_split(fn, flush, reps=5):
    """Device ms per launch kind of ``fn`` (profiler events, ``reps``
    calls, L2 evicted before each): sv_gather's passes and the memset."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for k in ("hist", "scatter", "answer", "direct", "Memset"):
            if f"sv_gather_kernel_{k}" in e.key or (k == "Memset"
                                                    and k in e.key):
                out[k] = out.get(k, 0.0) + e.device_time_total / 1e3 / reps
    return out


def stream():
    return torch.cuda.current_stream().cuda_stream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "_archive",
                                                     "parent"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    log_new_build()
    csrc = os.path.join(args.parent, "bitmagic_tpu_torch", "ops", "csrc")
    old = build_old(csrc, ("sv_planes.cu",))["sv_planes.cu"].bm_sv_gather
    old.argtypes = [VP, LL, VP, INT, VP, VP, VP, VP, VP]
    old.restype = INT
    rng = np.random.default_rng(cs.SEED + 20)
    vals = rng.integers(0, 1 << cs.SV_BITS, cs.SV_N).astype(np.uint32)
    sv = tbm.SparseVector.from_array(vals, nullable=True, device=device)
    table = sv._plane_table()
    P = table.meta.shape[0]
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=device)
    card = cs.nvidia_smi("name,power.limit")

    def parent(ids):
        out = torch.empty_like(ids)
        err = old(ids.data_ptr(), ids.shape[0], table.table.data_ptr(), P,
                  table.nb.data_ptr(), table.ent.data_ptr(),
                  table.runs.data_ptr(), out.data_ptr(), stream())
        cs.check(err == 0, f"parent sv_gather launch: CUDA error {err}")
        return out

    def ids_of(n):
        return torch.from_numpy(rng.integers(0, cs.SV_N, n)).to(device)

    routes = {"parent": parent,
              "direct": lambda i: ck._gather(i, table, False),
              "grouped": lambda i: ck._gather(i, table, True),
              "default": lambda i: ck.sv_gather(i, table)}

    def checked(ids, names):
        want = blockops.sv_gather(ids, table)
        for name in names:
            got = routes[name](ids)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"gather route {name}")

    ids = ids_of(cs.SV_GATHER_IDS)
    checked(ids, routes)
    times = {"parent": [], "default": []}
    for name in ("parent", "default", "default", "parent"):
        times[name].append(cs.time_ms(lambda: routes[name](ids), flush))
    print(json.dumps({"measure": "turns", "ids": cs.SV_GATHER_IDS,
                      "planes": P, "bit_rows": table.bit_rows,
                      "bound_ms": cs.sv_gather_bytes(table, ids.shape[0])
                      / peak_bw() * 1e3,
                      "ms": times, "card": card}))
    for n in DENSITIES:
        ids = ids_of(n)
        checked(ids, routes)
        row = {name: cs.time_ms(lambda: routes[name](ids), flush)
               for name in routes}
        print(json.dumps({"measure": "density", "ids": n,
                          "ids_per_bit_row": n / max(table.bit_rows, 1),
                          "grouped_by_default": ck._gather_grouped(n, table),
                          "ms": row, "card": card}))
    ids = ids_of(cs.SV_GATHER_IDS)
    split = {name: launch_split(lambda x=x: ck.sv_gather(x, table), flush)
             for name, x in (("uniform", ids),
                             ("sorted", torch.sort(ids).values))}
    print(json.dumps({"measure": "split", "ids": cs.SV_GATHER_IDS,
                      "device_ms": split, "card": card}))
    cs.log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
