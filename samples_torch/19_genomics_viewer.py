"""Genome-browser layout model on bit-intervals (reference
samples/xsample08, bitmagic.io/gen-layout.html).

Each annotation track is a BitVector whose set runs ARE the features
(exons, reads, ...).  Slicing a viewport is copy_range; lane packing for
overlapping features falls out of interval algebra; rendering is a walk
of the interval enumerator.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import bitmagic_tpu_torch as _bm
_bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
import numpy as np
import bitmagic_tpu_torch as bm
from bitmagic_tpu_torch.algo import (find_interval_end,
                               intervals, is_interval)

rng = np.random.default_rng(8)
GENOME = 1_000_000

# features: (start, len) tuples -> interval tracks
def make_track(n, flen):
    t = bm.BitVector(GENOME)
    for s in rng.integers(0, GENOME - flen, n):
        t.set_range(int(s), int(s) + int(flen) - 1)
    return t

genes = make_track(40, 12_000)
reads = make_track(300, 900)

# viewport slice: only the window is materialized
LO, HI = 400_000, 480_000
view_genes = bm.BitVector(GENOME)
view_genes.copy_range(genes, LO, HI)
view_reads = bm.BitVector(GENOME)
view_reads.copy_range(reads, LO, HI)

# coverage arithmetic on tracks: reads overlapping genes in the window
on_target = view_reads & view_genes
pct = 100.0 * on_target.count() / max(view_reads.count(), 1)
print(f"viewport [{LO},{HI}]: {pct:.1f}% of read bases inside genes")

# ASCII rendering: 80 columns, one char per 1000 bp
COLS, BIN = 80, (HI - LO) // 80
def render(track, ch):
    row = []
    for c in range(COLS):
        lo = LO + c * BIN
        row.append(ch if track.any_range(lo, lo + BIN - 1) else ".")
    return "".join(row)

print(render(view_genes, "G"))
print(render(view_reads, "r"))

# interval introspection
spans = intervals(view_genes)
print(f"{len(spans)} gene spans in view; first: {spans[0].tolist()}")
s, e = int(spans[0][0]), int(spans[0][1])
assert is_interval(view_genes, s, e)
assert find_interval_end(view_genes, s) == e
