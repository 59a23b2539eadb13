#!/usr/bin/env python3
"""Time B8, the Bitap chain of ``combine_shift_right_and``, and the
aggregator's calls on D-GAP operands, in two trees of the port, in turns,
on one NVIDIA card.

    git archive <parent> | tar -x -C _archive/parent
    python3 tools/torch_b8_turns.py [--parent _archive/parent] [--profile]

Each turn is a fresh process that imports ``bitmagic_tpu_torch`` from one
tree (the parent, or this repository, "new"; both trees name their
package alike), builds chip_smoke.py's config-1 Bitap operands (4
occurrence vectors of a seeded 100.7M-base text, 1536 blocks each;
``chip_smoke.BITAP_PATTERNS`` letters, the same draws as its samples
phase) and ``chip_smoke.protein_case``'s (a 100.7M-symbol text over 20
letters, a 32-letter pattern drawn from it), and times
``combine_shift_right_and`` at each shape: ``host_ms``, the host wall
(median of 21 calls, each ending in a synchronize), and ``ms`` /
``ms_clean_l2``, the calls' device span between CUDA events
(``chip_smoke.time_ms``: medians of 25, L2 evicted before each, left
dirty or clean), which holds the gaps in which the host plans and
enqueues.  ``kernel_ms`` / ``kernel_ms_clean_l2`` time the kernel alone
through the tree's own wrapper (``cuda_kernels.shift_and_chain`` on the
arguments the call hands it): the device duration of its kernel in a
torch.profiler trace of 25 wrapper calls, each after the same eviction,
median.  Every result must equal the numpy Bitap, and the wrapper's rows
the result's.  Then chip_smoke.py's config 3 (200 optimized vectors of
128 blocks, D-GAP, FULL and BIT blocks; its agg phase's draws) through
the calls whose operand descriptors (``agg/aggregator._operand_descs``)
expand D-GAP blocks: ``combine_and_sub`` of 100 / 100 and 3 / 2
vectors, ``combine_and`` of 4, ``combine_or`` of 160 and
``find_first_and_sub`` of 3 / 2 (a descriptor set per hit block it
walks): each answer against numpy, its host wall (median of 21 calls,
each ending in a synchronize) and its launches.  Turns run parent, new,
new, parent.  Prints one JSON line
per turn, then the card's name and power limit.  With ``--profile`` a
last fresh process of the new tree profiles 20 calls at each shape
(cProfile, after a warm-up call) and prints the 20 entries that hold the
most cumulative host time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, profile=False) -> dict:
    """One turn: the Bitap chains through the tree's port (with
    ``profile``: the host profile of its calls instead of the times)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.ops import _build
    from bitmagic_tpu_torch.ops import cuda_kernels as ck
    cs = _chip_smoke()
    pkg = os.path.dirname(os.path.abspath(tbm.__file__))
    cs.check(os.path.commonpath([pkg, tree]) == tree,
             f"imported {pkg}, not the package of {tree}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED + 41)
    n = cs.N_BLOCKS * cs.BPB
    codes = rng.integers(0, 4, n).astype(np.uint8)
    occ = [tbm.BitVector.from_words(cs.image(codes == c), n, device=dev)
           for c in range(4)]
    shapes = {}
    for m in cs.BITAP_PATTERNS:
        p = int(rng.integers(0, n - m))
        pat = codes[p:p + m]
        shapes[f"config1_{m}"] = ([occ[c] for c in pat],
                                  cs.bitap_oracle(codes, pat))
    shapes[f"protein_{cs.PROTEIN_PATTERN}"] = cs.protein_case(tbm, dev)
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=dev)
    clean = torch.empty_like(flush)
    agg = tbm.Aggregator()
    out = {"tree": tree}
    for name, (vecs, want) in shapes.items():

        def call(vecs=vecs):
            return agg.combine_shift_right_and(vecs)
        if profile:
            out[name] = host_profile(call, cs)
            continue
        ck.reset_launches()
        res = call()
        cs.sync()
        counted = {k: v for k, v in ck.launches.items() if v}
        cs.check(np.array_equal(res.indices(), want),
                 f"{name}: Bitap ends against numpy")
        walls = []
        for _ in range(21):
            t0 = time.perf_counter()
            call()
            cs.sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        (fm, descs), _ = cs.chain_args(tbm, vecs)

        def kernel(fm=fm, descs=descs):
            return ck.shift_and_chain(fm, descs)
        cs.check(torch.equal(kernel(), res_rows(tbm, res, fm.shape[0], dev)),
                 f"{name}: the wrapper's rows are the result's")
        out[name] = {"launches": counted, "host_ms": float(np.median(walls)),
                     "ms": cs.time_ms(call, flush),
                     "ms_clean_l2": cs.time_ms(call, flush, clean=clean),
                     "kernel_ms": kernel_ms(cs, kernel, flush),
                     "kernel_ms_clean_l2": kernel_ms(cs, kernel, flush,
                                                     clean)}
    if not profile:
        out["agg"] = agg_walls(cs, tbm, ck, dev)
    out["card"] = cs.nvidia_smi("name,power.limit")
    out["torch"] = torch.__version__
    return out


def agg_walls(cs, tbm, ck, dev, reps=21):
    """Config 3's aggregator calls on D-GAP operands: {call: {"host_ms":
    median wall, "launches": per call}}, each answer against numpy."""
    import numpy as np
    rng = np.random.default_rng(cs.SEED + 5)
    W = cs.agg_words(rng, cs.AGG_K, cs.AGG_BLOCKS)
    vecs = [tbm.BitVector.from_words(W[j], device=dev).optimize()
            for j in range(cs.AGG_K)]
    agg = tbm.Aggregator()
    half = cs.AGG_K // 2
    big = (list(range(half)), list(range(half, cs.AGG_K)))
    small = ([0, 2, 3], [7, 12])
    no_run = [j for j in range(cs.AGG_K) if j % 5]
    pick = lambda idx: [vecs[i] for i in idx]  # noqa: E731

    def words(r):
        return r.to_words().ravel()

    def first_bit(w):
        return int(np.flatnonzero(np.unpackbits(
            w.view(np.uint8), bitorder="little"))[0])
    calls = {
        "combine_and_sub_100_100": (
            lambda: agg.combine_and_sub(pick(big[0]), pick(big[1])), words,
            cs.oracle_and_sub(W, *big)),
        "combine_and_sub_3_2": (
            lambda: agg.combine_and_sub(pick(small[0]), pick(small[1])),
            words, cs.oracle_and_sub(W, *small)),
        "combine_and_4": (
            lambda: agg.combine_and(pick([0, 2, 5, 8])), words,
            cs.oracle_and_sub(W, [0, 2, 5, 8], [])),
        "combine_or_160": (
            lambda: agg.combine_or(pick(no_run)), words,
            np.bitwise_or.reduce(W[no_run], axis=0)),
        "find_first_and_sub_3_2": (
            lambda: agg.find_first_and_sub(pick(small[0]), pick(small[1])),
            lambda r: r, first_bit(cs.oracle_and_sub(W, *small))),
    }
    out = {}
    for name, (call, view, want) in calls.items():
        ck.reset_launches()
        got = view(call())
        cs.sync()
        counted = {k: v for k, v in ck.launches.items() if v}
        cs.check(np.array_equal(got, want), f"config 3 {name} against numpy")
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            cs.sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"host_ms": float(np.median(walls)),
                     "host_ms_min": float(np.min(walls)),
                     "launches": counted}
    return out


def kernel_ms(cs, kernel, flush, clean=None, reps=25):
    """Median device duration of the shift_and_chain kernel in a
    torch.profiler trace of ``reps`` calls of ``kernel`` (the wrapper),
    each after ``time_ms``'s eviction of L2 (left clean with ``clean``)."""
    import numpy as np

    def run():
        for _ in range(reps):
            flush.zero_()
            if clean is not None:
                clean.max()
            kernel()
    kernel()
    cs.sync()
    us = [e.device_time_total for e in cs.traced_device_events(run)
          if "shift_and_chain" in e.name]
    cs.check(len(us) == reps, f"the trace holds {len(us)} shift_and_chain "
             f"kernels of {reps}")
    return float(np.median(us)) / 1e3


def host_profile(call, cs, calls=20, top=20):
    """The ``top`` entries of a cProfile of ``calls`` calls of ``call``
    (each ending in a synchronize) by cumulative time: [ms per call,
    function] each."""
    import cProfile
    import pstats

    def run():
        for _ in range(calls):
            call()
            cs.sync()
    run()
    prof = cProfile.Profile()
    prof.runcall(run)
    st = pstats.Stats(prof)
    rows = sorted(((v[3], k) for k, v in st.stats.items()),
                  key=lambda r: -r[0])[:top]
    return [[round(t / calls * 1e3, 4),
             f"{os.path.basename(k[0])}:{k[1]}({k[2]})"] for t, k in rows]


def res_rows(tbm, res, nb, dev):
    """The result's words as rows int32[nb, 2048] on ``dev``."""
    import numpy as np
    import torch
    words = res.to_words().ravel()[:nb * 2048]
    return torch.from_numpy(np.ascontiguousarray(words).view(
        np.int32).reshape(nb, 2048)).to(dev)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] in ("--worker", "--worker-profile"):
        print(json.dumps(worker(os.path.realpath(argv[1]),
                                argv[0] == "--worker-profile")), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "_archive",
                                                     "parent"))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_b8_turns: needs an NVIDIA card", file=sys.stderr)
        return 2
    trees = {"parent": os.path.realpath(args.parent), "new": ROOT}
    turns = [("--worker", name) for name in ("parent", "new", "new",
                                              "parent")]
    if args.profile:
        turns.append(("--worker-profile", "new"))
    for mode, name in turns:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            mode, trees[name]], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        row = json.loads(r.stdout.strip().splitlines()[-1])
        row["turn"] = name
        print(json.dumps(row), flush=True)
    print(_chip_smoke().nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
