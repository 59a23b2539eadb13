#!/usr/bin/env python3
"""Time B8, the Bitap chain of ``combine_shift_right_and``, in two trees of
the port, in turns, on one NVIDIA card.

    git archive <parent> | tar -x -C _archive/parent
    python3 tools/torch_b8_turns.py [--parent _archive/parent]

Each turn is a fresh process that imports ``bitmagic_tpu_torch`` from one
tree (the parent, or this repository, "new"; both trees name their
package alike), builds chip_smoke.py's config-1 Bitap operands (4
occurrence vectors of a seeded 100.7M-base text, 1536 blocks each;
``chip_smoke.BITAP_PATTERNS`` letters, the same draws as its samples
phase) and times ``combine_shift_right_and`` at each pattern length:
``host_ms``, the host wall (median of 21 calls, each ending in a
synchronize), and ``ms`` / ``ms_clean_l2``, the calls' device span
between CUDA events (``chip_smoke.time_ms``: medians of 25, L2 evicted
before each, left dirty or clean), which for an eager chain holds the
gaps in which the host enqueues its kernels.  In the new tree it also
times the kernel alone through its C interface (``kernel_ms``,
``kernel_ms_clean_l2``).  Every result must equal the numpy Bitap.
Turns run parent, new, new, parent.  Prints one JSON line per turn,
then the card's name and power limit.  With ``--profile`` a last fresh
process of the new tree profiles 20 calls at each pattern length
(cProfile, after a warm-up call) and prints the 20 entries that hold
the most cumulative host time.
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
    """One turn: config 1's Bitap chains through the tree's port (with
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
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=dev)
    clean = torch.empty_like(flush)
    agg = tbm.Aggregator()
    out = {"tree": tree}
    for m in cs.BITAP_PATTERNS:
        p = int(rng.integers(0, n - m))
        pat = codes[p:p + m]
        vecs = [occ[c] for c in pat]

        def call(vecs=vecs):
            return agg.combine_shift_right_and(vecs)
        if profile:
            out[f"config1_{m}"] = host_profile(call, cs)
            continue
        ck.reset_launches()
        res = call()
        cs.sync()
        counted = {k: v for k, v in ck.launches.items() if v}
        cs.check(np.array_equal(res.indices(), cs.bitap_oracle(codes, pat)),
                 f"config1_{m}: Bitap ends against numpy")
        walls = []
        for _ in range(21):
            t0 = time.perf_counter()
            call()
            cs.sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        row = {"launches": counted, "host_ms": float(np.median(walls)),
               "ms": cs.time_ms(call, flush),
               "ms_clean_l2": cs.time_ms(call, flush, clean=clean)}
        if "shift_and_chain" in ck.launches:
            (fm, descs), _ = cs.chain_args(tbm, vecs)
            nb = fm.shape[0]
            table = ck._descriptor_table(descs, nb, dev)
            dst = torch.empty((nb, 2048), dtype=torch.int32, device=dev)

            def launch():
                ck._launch("bm_shift_and_chain", "shift_and_chain", dev,
                           ck._ptr(table), len(descs), ck._ptr(fm), nb,
                           ck._ptr(dst))
            launch()
            cs.sync()
            cs.check(torch.equal(dst, res_rows(tbm, res, nb, dev)),
                     f"config1_{m}: the kernel's rows are the result's")
            row.update(kernel_ms=cs.time_ms(launch, flush),
                       kernel_ms_clean_l2=cs.time_ms(launch, flush,
                                                     clean=clean))
        out[f"config1_{m}"] = row
    out["card"] = cs.nvidia_smi("name,power.limit")
    out["torch"] = torch.__version__
    return out


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
