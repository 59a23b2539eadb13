#!/usr/bin/env python3
"""Find which earlier work leaves torch.profiler recording no device event
on one NVIDIA card.

    python3 tools/torch_trace_probe.py [--roots . _archive/pre] [--tries 8]
                                       [--arms ARM ...]

Each arm runs in a fresh interpreter on the package of one ROOT (a
checkout of the repo: its ``bitmagic_tpu_torch`` and its
``chip_smoke.py``): config 4b's column (``chip_smoke.config4b_values``)
is built, the arm's work runs with no profiler, then ``--tries`` traces
(``chip_smoke.device_kernels``) of the column's ``find_gt`` with its
count, and as many of a tiny op, are taken; the arm reports how many came
back with no kernel (``phase_empty``: the empty ones among the phases'
own traces, which chip_smoke logs).  Arms:

    none             nothing before the traces
    direct_gathers   25,000 ``sv_gather`` calls of 100 ids (one direct
                     launch each; the sv phase's string group makes
                     21,505)
    grouped_gathers  50 gathers of 1M ids (three launches each)
    one_selects      5,000 one-query ``RSIndex.select`` calls on cell 1's
                     vector (``chip_smoke.rs_cell_vector``)
    sv_phase         ``chip_smoke.sv_phase`` as the full run runs it just
                     before the descent phase's traces
    descent_phase    ``chip_smoke.find_gt_trace`` then
                     ``chip_smoke.descent_phase``, which checks that
                     trace (where the full run took its empty ones until
                     the scan path took it)
    sv_then_descent  the two phases in the full run's order
    sessions         300 profiler sessions of the tiny op (how many of
                     them came back empty is reported as ``arm_empty``)
    kernels_prefix   chip_smoke's kernels phase, then the sv and descent
                     phases
    main_serial_prefix  its main path, serial phase, sv and descent
    full_prefix      kernels, main path, algo, serial, sv and descent, in
                     the full run's order (its search paths left out)
    main_prefix      the main path, sv and descent
    serial_prefix    the serial phase, sv and descent
    main_serial_nosv the main path, the serial phase and descent

After its traces each arm reads the card's free and PyTorch's reserved
memory, returns PyTorch's cached blocks (``torch.cuda.empty_cache``),
reads them again and takes its traces once more (``after_free``).

A phase whose own check fails (the descent phase's trace of ``find_gt``
naming other kernels than its two) is reported as ``phase_error`` and
the arm goes on to its traces.  ``no_descent`` counts the traces of
``find_gt`` that name kernels but no ``sv_descent_kernel``.

The arms run root by root, in the order given, each arm of every root
before the next arm.  Prints one JSON line per arm and root (an arm whose
phases fail a check of their own gives its error and last log lines),
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("none", "direct_gathers", "grouped_gathers", "one_selects",
        "sv_phase", "descent_phase", "sv_then_descent", "sessions",
        "kernels_prefix", "main_serial_prefix", "full_prefix",
        "main_prefix", "serial_prefix", "main_serial_nosv")
# the phases each prefix arm runs before the traces
PREFIX = {"kernels_prefix": ("kernels", "sv", "descent"),
          "main_serial_prefix": ("main", "serial", "sv", "descent"),
          "full_prefix": ("kernels", "main", "algo", "serial", "sv",
                          "descent"),
          "main_prefix": ("main", "sv", "descent"),
          "serial_prefix": ("serial", "sv", "descent"),
          "main_serial_nosv": ("main", "serial", "descent")}


def descent(tbm, device, card, sv, vals, nm):
    """The descent phase on config 4b's column ``sv``, with the trace of
    its ``find_gt`` taken just before it."""
    import chip_smoke as cs
    cs.descent_phase(tbm, device, card, sv, vals, nm,
                     cs.find_gt_trace(tbm, sv))


def run_arm(arm, tries):
    """One arm in this interpreter (its root first on sys.path) -> the
    counts of empty traces."""
    import numpy as np
    import torch
    import bitmagic_tpu_torch as tbm
    import chip_smoke as cs
    from bitmagic_tpu_torch.ops import _build
    device = torch.device("cuda")
    _build.build_all()
    _, vals, nm = cs.config4b_values()
    sv = tbm.SparseVector.from_array(vals, nullable=True, null_mask=nm,
                                     device=device)
    rng = np.random.default_rng(cs.SEED + 30)
    card = {"smi": cs.nvidia_smi("name,power.limit")}
    x = torch.arange(4096, device=device)
    arm_empty = None
    t0 = time.perf_counter()
    if arm == "direct_gathers":
        ids = rng.integers(0, cs.SV_N, 100)
        for _ in range(25_000):
            sv.gather(ids)
    elif arm == "grouped_gathers":
        ids = rng.integers(0, cs.SV_N, cs.SV_GATHER_IDS)
        for _ in range(50):
            sv.gather(ids)
    elif arm == "one_selects":
        rs = cs.rs_cell_vector(tbm, rng, device)[0].build_rs_index()
        for r in rng.integers(1, rs.total + 1, 5_000):
            rs.select(int(r))
    elif arm in ("sv_phase", "sv_then_descent"):
        cs.sv_phase(tbm, device, card, sv, vals, nm)
    if arm in ("descent_phase", "sv_then_descent"):
        descent(tbm, device, card, sv, vals, nm)
    elif arm == "sessions":
        arm_empty = sum(not cs.device_kernels(lambda: (x * 3).sum())
                        for _ in range(300))
    phase_error = None
    for phase in PREFIX.get(arm, ()):
        if phase == "kernels":
            cs.kernels_vs_plain(device)
        elif phase == "main":
            cs.main_path(tbm, device)
        elif phase == "algo":
            cs.algo_path(tbm, device, sv, np.where(nm, np.uint32(0), vals))
        elif phase == "serial":
            cs.serial_phase(tbm, device, card)
        elif phase == "sv":
            cs.sv_phase(tbm, device, card, sv, vals, nm)
        else:
            try:
                descent(tbm, device, card, sv, vals, nm)
            except AssertionError as e:       # reported, then traced on
                phase_error = str(e)
    torch.cuda.synchronize()
    arm_s = time.perf_counter() - t0
    def traces():
        empty = {"find_gt": 0, "tiny_op": 0, "no_descent": 0}
        for _ in range(tries):
            names = cs.device_kernels(
                lambda: tbm.scanner.find_gt(sv, cs.DESCENT_GT).count())
            if not names:
                empty["find_gt"] += 1
            elif not any("sv_descent_kernel" in n for n in names):
                empty["no_descent"] += 1
            if not cs.device_kernels(lambda: (x * 3).sum()):
                empty["tiny_op"] += 1
        free, total = torch.cuda.mem_get_info()
        return {"empty": empty, "free_gb": round(free / 1e9, 3),
                "reserved_gb": round(torch.cuda.memory_reserved() / 1e9, 3),
                "card_gb": round(total / 1e9, 3)}

    out = {"arm": arm, "arm_s": round(arm_s, 3), "tries": tries,
           "arm_empty": arm_empty, "phase_error": phase_error, **traces()}
    torch.cuda.empty_cache()
    out["after_free"] = traces()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[ROOT])
    ap.add_argument("--tries", type=int, default=8)
    ap.add_argument("--arms", nargs="+", choices=ARMS, default=ARMS)
    ap.add_argument("--arm", choices=ARMS)
    ap.add_argument("--root")
    args = ap.parse_args(argv)
    if args.arm:                               # one arm, in this process
        sys.path.insert(0, os.path.abspath(args.root))
        print(json.dumps(run_arm(args.arm, args.tries)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_probe: no CUDA card", file=sys.stderr)
        return 1
    for arm in args.arms:
        for root in args.roots:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--arm", arm,
                 "--root", root, "--tries", str(args.tries)],
                capture_output=True, text=True, timeout=900)
            if r.returncode:
                # a phase's own check failed: report it with the arm's
                # last log lines (the kernels its traces named) and go on
                print(json.dumps({"root": root, "arm": arm,
                                  "exit": r.returncode,
                                  "error": r.stderr.strip()[-300:],
                                  "log": r.stdout.splitlines()[-12:]}),
                      flush=True)
                continue
            line = json.loads(r.stdout.strip().splitlines()[-1])
            # the phases' own traces: each empty one logs a retry
            line["phase_empty"] = r.stdout.count("a trace recorded no kernel")
            print(json.dumps({"root": root, **line}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
