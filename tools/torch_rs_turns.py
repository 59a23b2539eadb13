#!/usr/bin/env python3
"""Two measurements of the rs-index's select and rank batches on one
NVIDIA card, each taken in turns in one process.

    python3 tools/torch_rs_turns.py [--rounds 6] [--steps 20] [--seed 42]

staging: ``RSIndex.select_batch`` / ``rank_batch`` on 1M queries and on
    one query, as the index runs them (one pageable copy each way), and
    with the queries and answers staged through one pinned host buffer
    instead (host copies into and out of it).  Per staging, the median
    host wall ms of each; both stagings' answers must agree.
route: the step of cell ``bvsetalgebra_rank_select`` (``bench_torch.py``,
    at ``BENCHMARK.json``'s sizes) with its select and rank batches
    answered three ways: ``kernel`` (the index as it is: ``rs_select`` /
    ``rs_rank``, pageable copies), ``kernel_pinned`` (the same launches,
    staged through a pinned buffer) and ``plain`` (the kernels' plain
    versions, ``ops/select.py``, run on the card: the eager PyTorch
    sequence the index ran before the kernels, pageable copies).  Each
    round runs ``--steps`` steps of each route, in a rotating order, with
    L2 evicted before each step as ``bench_torch.py`` does; the answers of
    each route's first step are checked against the cell's numpy oracle.
    Per route, the median host wall ms of every entry point of the step,
    so a change in the set operations that follow one route's batches
    shows beside the batches' own.

Prints one JSON line per measurement, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch as bt  # noqa: E402
from bitmagic_tpu_torch.ops import _build  # noqa: E402
from bitmagic_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from bitmagic_tpu_torch.ops import select as plain  # noqa: E402

CELL = "bvsetalgebra_rank_select"
ROUTES = ("kernel", "kernel_pinned", "plain")


class Answers:
    """The index's select and rank batches by route: the functions that
    take a batch of int64 queries on the card to its answers there, and
    the staging of the queries and answers around them."""

    def __init__(self, rs, n):
        self.rs, self.runs = rs, rs._gap_runs()
        self.buf = torch.empty(n, dtype=torch.int64, pin_memory=True)

    def on_card(self, what, route):
        rs, runs = self.rs, self.runs
        mod = plain if route == "plain" else ck
        if what == "select":
            return lambda q: mod.rs_select(rs._seg, rs._cum0_dev, runs,
                                           rs.pool, rs.gwc, q, rs.total)
        return lambda q: mod.rs_rank(rs._seg, rs._nb_dev, runs, rs.pool,
                                     rs.gwc, q)

    def batch(self, what, route):
        """The host-to-host batch function of ``route``."""
        if route == "kernel":
            return getattr(self.rs, f"{what}_batch")
        fn = self.on_card(what, route)
        if route == "plain":
            return lambda v: self.rs._batch(v, fn)
        dev = self.rs.pool.device

        def pinned(values):
            values = np.asarray(values, np.int64)
            b = self.buf[:values.size]
            host = b.numpy()
            host[:] = values.reshape(-1)
            b.copy_(fn(b.to(dev, non_blocking=True)), non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            return host.copy().reshape(values.shape)
        return pinned


def staging(ans, ranks, ids, reps=5, calls=200) -> dict:
    """Median host wall ms of the 1M batches (``reps`` each) and of
    ``calls`` one-query batches each, pageable against pinned in turns
    (pinned, pageable, pageable, pinned)."""
    walls = {m: collections.defaultdict(list) for m in ("pageable", "pinned")}
    want = {}
    for mode in ("pinned", "pageable", "pageable", "pinned"):
        route = "kernel" if mode == "pageable" else "kernel_pinned"
        for what, qs in (("select", ranks), ("rank", ids)):
            fn = ans.batch(what, route)
            for _ in range(reps):
                t0 = time.perf_counter()
                got = fn(qs)
                walls[mode][f"{what}_1M"].append(time.perf_counter() - t0)
            if not np.array_equal(want.setdefault(what, got), got):
                raise AssertionError(f"{what}: pinned and pageable answers "
                                     "differ")
            for x in qs[:calls]:
                one = np.asarray([x])
                t0 = time.perf_counter()
                fn(one)
                walls[mode][f"one_{what}"].append(time.perf_counter() - t0)
    return {m: {k: float(np.median(v)) * 1e3 for k, v in w.items()}
            for m, w in walls.items()}


def routes(cell, ans, oracle, dev, rounds, steps) -> dict:
    """Per route, per entry point of the cell's step: the median host wall
    ms over ``rounds`` x ``steps`` steps, and the step's own median."""
    flush = torch.empty(bt.L2_EVICT_WORDS, dtype=torch.int32, device=dev)
    rs = cell.rs
    walls = {r: collections.defaultdict(list) for r in ROUTES}
    for rnd in range(rounds):
        order = ROUTES[rnd % 3:] + ROUTES[:rnd % 3]
        for route in order:
            rs.select_batch = ans.batch("select", route)
            rs.rank_batch = ans.batch("rank", route)
            cell.step(bt.Step(dev))                     # warm-up
            for i in range(steps):
                flush.zero_()
                t = bt.Step(dev)
                t0 = time.perf_counter()
                answers = cell.step(t)
                walls[route]["step"].append(
                    (time.perf_counter() - t0) * 1e3)
                for k, v in t.ms.items():
                    walls[route][k].append(v)
                if rnd == 0 and i == 0:
                    bt.check_answers(f"route {route}", answers, oracle)
            del rs.select_batch, rs.rank_batch
    return {r: {k: float(np.median(v)) for k, v in w.items()}
            for r, w in walls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rs_turns: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    workload, cfg = bt.load_workload(CELL)
    cell = bt.TRAFFIC[workload["traffic"]](args.seed, cfg["sizes"])
    oracle = cell.oracle()
    _build.build_all()
    cell.build(dev)
    ans = Answers(cell.rs, max(len(cell.ranks), len(cell.ids)))
    card = bt.card_line()
    print(json.dumps({"staging_ms": staging(ans, cell.ranks, cell.ids),
                      "card": card}), flush=True)
    print(json.dumps({"route_ms": routes(cell, ans, oracle, dev,
                                         args.rounds, args.steps),
                      "rounds": args.rounds, "steps": args.steps,
                      "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
