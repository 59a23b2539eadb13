#!/usr/bin/env python3
"""Measurements of the rs-index's select and rank batches on one NVIDIA
card, each taken in turns in one process.

    python3 tools/torch_rs_turns.py [--rounds 6] [--steps 20] [--seed 42]
    python3 tools/torch_rs_turns.py --kernels _archive/parent

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

kernels (``--kernels PARENT``, instead of the two above): rs_select,
    select_flat, rs_rank and rank_flat at ``chip_smoke.rs_timings``' shape
    (a vector drawn as the cell's A, 1M uniform ranks, ids and pool
    offsets) against the versions of the commit unpacked at PARENT (its
    ``rs_select.cu``, built by ``torch_gather_turns.build_old`` and called
    through its C interface: the select kernels' as this tree's, the rank
    kernels' ``bm_rs_rank(seg, nb, n_seg, runs, key_end, n_runs, pool,
    gwc, n_waves, ids, n, out, stream)`` and ``bm_rank_flat(pool, gwc,
    n_waves, rel, n, out, stream)``), parent, new, new, parent; then, per
    batch size from 1 to 1M, the parent's and the new one.  Medians of 25
    runs between CUDA events, L2 evicted before each
    (``chip_smoke.time_ms``); every answer must equal the plain version's.

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
        if what == "select" and route == "plain":
            return lambda q: plain.rs_select(rs._seg, rs._cum0_dev, runs,
                                             rs.pool, rs.gwc, q, rs.total)
        if what == "select":
            tables = rs._select_tables()
            return lambda q: ck.rs_select(rs._seg, rs._cum0_dev, runs,
                                          rs.pool, rs.gwc, q, rs.total,
                                          tables)
        if route == "plain":
            return lambda q: plain.rs_rank(rs._seg, rs._nb_dev, runs,
                                           rs.pool, rs.gwc, q)
        tables = rs._rank_tables()
        return lambda q: ck.rs_rank(rs._seg, rs._nb_dev, runs, rs.pool,
                                    rs.gwc, q, tables)

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


BATCHES = (1, 64, 1024, 4096, 16384, 65536, 262144, 1_000_000)


def kernel_turns(parent, dev):
    """The ``kernels`` measurement's JSON lines (module docstring)."""
    import chip_smoke as cs
    import bitmagic_tpu_torch as tbm
    from torch_gather_turns import VP, INT, LL, build_old, log_new_build
    log_new_build()
    lib = build_old(os.path.join(parent, "bitmagic_tpu_torch", "ops",
                                 "csrc"), ("rs_select.cu",))["rs_select.cu"]
    old = {name: getattr(lib, name) for name in
           ("bm_rs_select", "bm_select_flat", "bm_rs_rank", "bm_rank_flat")}
    for name in ("bm_rs_select", "bm_select_flat"):
        old[name].argtypes = ck._SIGNATURES[name][1]
    old["bm_rs_rank"].argtypes = [VP, VP, LL, VP, VP, LL, VP, VP, LL, VP,
                                  LL, VP, VP]
    old["bm_rank_flat"].argtypes = [VP, VP, LL, VP, LL, VP, VP]
    for f in old.values():
        f.restype = INT
    rng = np.random.default_rng(cs.SEED + 21)
    v, _ = cs.rs_cell_vector(tbm, rng, dev)
    rs = v.build_rs_index()
    runs, tables = rs._gap_runs(), rs._select_tables()
    rtables = rs._rank_tables()
    ftables = plain.flat_tables(rs.pool, rs.gwc)
    frank = plain.flat_rank_tables(rs.gwc, ftables.wsp)
    sargs = (rs._seg, rs._cum0_dev, runs, rs.pool, rs.gwc)
    rargs = (rs._seg, rs._nb_dev, runs, rs.pool, rs.gwc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(128 * 2**20, dtype=torch.int32, device=dev)
    card = bt.card_line()
    p = lambda t: t.data_ptr()  # noqa: E731
    W, R = rs.gwc.shape[0], runs[0].shape[0]

    def parent(name, out_n, *args):
        out = torch.empty(out_n, dtype=torch.int64, device=dev)
        err = old[name](*args[:-1], p(out), *args[-1], stream)
        cs.check(err == 0, f"parent {name}: CUDA error {err}")
        return out

    new = {"rs_select": lambda q: ck.rs_select(*sargs, q, rs.total, tables),
           "select_flat": lambda g: ck.select_flat(rs.pool, rs.gwc, g,
                                                   ftables),
           "rs_rank": lambda i: ck.rs_rank(*rargs, i, rtables),
           "rank_flat": lambda r: ck.rank_flat(rs.pool, rs.gwc, r, frank)}
    for fn, q in zip(new.values(), (torch.ones(1, dtype=torch.int64,
                                               device=dev),
                                    torch.ones(1, dtype=torch.int32,
                                               device=dev),
                                    torch.zeros(1, dtype=torch.int64,
                                                device=dev),
                                    torch.zeros(1, dtype=torch.int64,
                                                device=dev))):
        fn(q)                   # each tables object's staging plan, set
    olds = {
        "rs_select": lambda q: parent(
            "bm_rs_select", q.shape[0], p(rs._cum0_dev), rs._seg.shape[0],
            p(tables.sel), p(runs[0]), p(tables.gcs), R, p(rs.pool),
            p(rs.gwc), p(tables.gws), p(tables.wsp), W, p(q), q.shape[0],
            rs.total, tables.staging[1]),
        "select_flat": lambda g: parent(
            "bm_select_flat", g.shape[0], p(rs.pool), p(rs.gwc),
            p(ftables.gws), p(ftables.wsp), W, p(g), g.shape[0],
            ftables.staging[1]),
        "rs_rank": lambda i: parent(
            "bm_rs_rank", i.shape[0], p(rs._seg), p(rs._nb_dev),
            rs._nb_dev.shape[0], p(runs[0]), p(runs[1]), R, p(rs.pool),
            p(rs.gwc), W, p(i), i.shape[0], ()),
        "rank_flat": lambda r: parent(
            "bm_rank_flat", r.shape[0], p(rs.pool), p(rs.gwc), W, p(r),
            r.shape[0], ())}
    plain_of = {"rs_select": lambda q: plain.rs_select(*sargs, q, rs.total),
                "select_flat": lambda g: plain.select_flat(rs.pool, rs.gwc,
                                                           g),
                "rs_rank": lambda i: plain.rs_rank(*rargs, i),
                "rank_flat": lambda r: plain.rank_flat(rs.pool, rs.gwc, r)}

    def queries(what, n):
        if what == "rs_select":
            x = rng.integers(1, rs.total + 1, n)
        elif what == "select_flat":
            x = rng.integers(1, int(rs.gwc[-1]) + 1, n).astype(np.int32)
        elif what == "rs_rank":
            x = rng.integers(0, v.size, n)
        else:
            x = rng.integers(0, rs.pool.shape[0] * cs.BPB, n)
        return torch.from_numpy(x).to(dev)

    def timed(what, q, name):
        fn = (olds if name == "parent" else new)[what]
        got = fn(q)
        torch.cuda.synchronize()
        cs.check(torch.equal(got, plain_of[what](q)),
                 f"{name} {what} equals the plain version")
        return cs.time_ms(lambda: fn(q), flush)

    lines = []
    for what in new:
        q = queries(what, cs.N_QUERIES)
        ms = {"parent": [], "new": []}
        for name in ("parent", "new", "new", "parent"):
            ms[name].append(timed(what, q, name))
        lines.append({"measure": "turns", "kernel": what,
                      "queries": cs.N_QUERIES, "ms": ms, "card": card})
        for n in BATCHES:
            q = queries(what, n)
            lines.append({"measure": "batch", "kernel": what, "queries": n,
                          "ms": {"parent": timed(what, q, "parent"),
                                 "new": timed(what, q, "new")},
                          "card": card})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--kernels", metavar="PARENT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rs_turns: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.kernels:
        for line in kernel_turns(args.kernels, dev):
            print(json.dumps(line), flush=True)
        print(bt.card_line())
        return 0
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
