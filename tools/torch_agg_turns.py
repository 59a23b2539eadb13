#!/usr/bin/env python3
"""Time config 3's host-bound aggregator work in two trees of the port, in
turns, on one NVIDIA card: the operand arena build and the 64-request
counts pipeline, whose host side expands GAP blocks (``GapStore.to_dense``)
and reads operand rows on the host (``BitVector._pool_host``).

    git archive COMMIT bitmagic_tpu_torch | tar -x -C DIR
    python3 tools/torch_agg_turns.py DIR

Each turn is a fresh process that imports ``bitmagic_tpu_torch`` from one
tree (DIR, "old", or this repository, "new"), builds chip_smoke.py's config
3 (200 vectors x 128 blocks from the same seed, ``from_words`` then
``optimize``) and times, each ending in a device synchronize: a first arena
build over the fresh vectors (``OperandArena(vecs).pool``: every GAP store
expands), a second one, the first 64-request counts pipeline and the best
of 5 more.  Turns run old, new, new, old; both trees must give the same
counts.  Prints one JSON line per turn, then the card's name and power
limit.
"""

from __future__ import annotations

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


def worker(tree: str) -> dict:
    """One turn: config 3 through the tree's port (run in its own
    process: both trees name their package ``bitmagic_tpu_torch``)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import bitmagic_tpu_torch as tbm
    from bitmagic_tpu_torch.agg.arena import OperandArena
    from bitmagic_tpu_torch.ops import _build
    cs = _chip_smoke()
    pkg = os.path.dirname(os.path.abspath(tbm.__file__))
    cs.check(os.path.commonpath([pkg, tree]) == tree,
             f"imported {pkg}, not the package of {tree}")
    _build.build_all()
    rng = np.random.default_rng(cs.SEED + 5)
    W = cs.agg_words(rng, cs.AGG_K, cs.AGG_BLOCKS)
    vecs = [tbm.BitVector.from_words(W[j], device="cuda").optimize()
            for j in range(cs.AGG_K)]
    reqs = cs.agg_requests(rng, cs.AGG_K, cs.N_REQUESTS)
    groups = [([vecs[i] for i in a], [vecs[i] for i in s]) for a, s in reqs]
    opts = tbm.AggOptions().set_compute_count()
    agg = tbm.Aggregator()

    def ms(fn):
        cs.sync()
        t0 = time.perf_counter()
        r = fn()
        cs.sync()
        return (time.perf_counter() - t0) * 1e3, r

    out = {"tree": tree}
    out["arena_first_ms"], _ = ms(lambda: OperandArena(vecs).pool)
    out["arena_second_ms"], _ = ms(lambda: OperandArena(vecs).pool)
    out["pipeline_first_ms"], res = ms(lambda: agg.pipeline(groups, opts))
    out["pipeline_best_ms"] = min(ms(lambda: agg.pipeline(groups, opts))[0]
                                  for _ in range(5))
    counts = [o["count"] for o in res]
    cs.check(counts == [cs._popcount(cs.oracle_and_sub(W, a, s))
                        for a, s in reqs], "pipeline counts against numpy")
    out["counts_sum"] = int(sum(counts))
    out["card"] = cs.nvidia_smi("name,power.limit")
    out["torch"] = torch.__version__
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(os.path.realpath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_agg_turns: needs an NVIDIA card", file=sys.stderr)
        return 2
    trees = {"old": os.path.realpath(sys.argv[1]), "new": ROOT}
    results = []
    for name in ("old", "new", "new", "old"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", trees[name]], capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        row = json.loads(r.stdout.strip().splitlines()[-1])
        row["turn"] = name
        results.append(row)
        print(json.dumps(row), flush=True)
    if len({r["counts_sum"] for r in results}) != 1:
        print("torch_agg_turns: the trees disagree", file=sys.stderr)
        return 1
    print(_chip_smoke().nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
