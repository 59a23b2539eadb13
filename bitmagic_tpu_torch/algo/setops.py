"""Set-algebra free functions over BitVectors without materializing results
(port of ``bitmagic_tpu/algo/setops.py:1-176``).

Equivalents of `src/bmalgo.h:49-165` (count_and/or/xor/sub, any_*) and the
batched distance pipeline of `src/bmalgo_impl.h:57-600`
(distance_metric_descriptor / distance_operation): N metrics computed in ONE
pass over aligned block pairs.  On the card the pass is one launch of the
gather-fused multi-metric kernel K2, totals included; all requested metrics
share the same reads of device memory.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..core.blocks import (operand_args, runs_diff, runs_intersect,
                           runs_subtract_points, runs_total)
from ..core.bitvector import BitVector
from ..core.gapstore import const_extended, gap_metric_counts
from ..ops import cuda_kernels as ck
from ..ops.blockops import METRICS as _METRICS

COUNT_AND, COUNT_XOR, COUNT_OR, COUNT_SUB_AB, COUNT_SUB_BA, COUNT_A, \
    COUNT_B = _METRICS

_GAP_NAME = {COUNT_AND: "and_", COUNT_OR: "or_", COUNT_XOR: "xor_",
             COUNT_SUB_AB: "sub_ab", COUNT_SUB_BA: "sub_ba",
             COUNT_A: "a_", COUNT_B: "b_"}


def distance_operation(a: BitVector, b: BitVector, metrics) -> dict:
    """Compute a batch of distance metrics in one pass (reference
    distance_operation, src/bmalgo_impl.h:447), on the vectors' device."""
    for m in metrics:
        if m not in _METRICS:
            raise ValueError(f"unknown metric {m}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and "
                         f"{b.device}")
    a._flush()
    b._flush()
    # align on the union of allocated blocks; FULL/FULL and FULL/ZERO pairs
    # resolve symbolically on host, only rows where at least one side is a
    # BIT row reach the device
    cand = np.union1d(a._struct.nb, b._struct.nb)
    st_a, _ = a._struct.lookup(cand)
    st_b, _ = b._struct.lookup(cand)
    sym = (st_a <= 1) & (st_b <= 1)
    n_ff = int(((st_a == 1) & (st_b == 1) & sym).sum())
    n_fz = int(((st_a == 1) & (st_b == 0) & sym).sum())
    n_zf = int(((st_a == 0) & (st_b == 1) & sym).sum())
    # FULL-run coverage outside any allocated point block resolves by pure
    # interval arithmetic (runs are disjoint from nb)
    if a._struct.has_runs or b._struct.has_runs:
        ra, rb = a._struct.runs, b._struct.runs
        n_ff += runs_total(runs_intersect(ra, rb))
        n_fz += runs_total(runs_subtract_points(runs_diff(ra, rb),
                                                b._struct.nb))
        n_zf += runs_total(runs_subtract_points(runs_diff(rb, ra),
                                                a._struct.nb))
    BB = C.BITS_PER_BLOCK
    table = {
        COUNT_AND: n_ff * BB,
        COUNT_OR: (n_ff + n_fz + n_zf) * BB,
        COUNT_XOR: (n_fz + n_zf) * BB,
        COUNT_SUB_AB: n_fz * BB,
        COUNT_SUB_BA: n_zf * BB,
        COUNT_A: (n_ff + n_fz) * BB,
        COUNT_B: (n_ff + n_zf) * BB,
    }
    # run-domain part: pairs where neither side is a dense row compute on
    # the host from run boundaries; symbolic FULL/ZERO sides join as
    # synthetic 1-run blocks
    vals = np.zeros(len(metrics), np.int64)
    kern = ~sym
    gap_elig = kern & (st_a != 2) & (st_b != 2)
    if gap_elig.any():
        ext_a, za, fa = const_extended(a._gaps)
        ext_b, zb, fb = const_extended(b._gaps)
        st_ae, sl_ae = a._struct.lookup(cand[gap_elig])
        st_be, sl_be = b._struct.lookup(cand[gap_elig])
        sel_a = np.where(st_ae == 3, sl_ae, np.where(st_ae == 1, fa, za))
        sel_b = np.where(st_be == 3, sl_be, np.where(st_be == 1, fb, zb))
        mc = gap_metric_counts(ext_a, sel_a, ext_b, sel_b)
        for i, m in enumerate(metrics):
            vals[i] += int(mc[_GAP_NAME[m]].sum())
        kern = kern & ~gap_elig
    # device part: rows where at least one side is a dense BIT row (K2,
    # which sums each metric's per-block counts into int64 in its launch)
    if kern.any():
        totals, _ = ck.count_metrics_total(
            tuple(metrics), operand_args(a, cand[kern]),
            operand_args(b, cand[kern]))
        vals += totals.cpu().numpy()
    return {m: int(v) + table[m] for m, v in zip(metrics, vals)}


def count_and(a, b):
    """popcount(a & b) without materializing (src/bmalgo.h:49)."""
    return distance_operation(a, b, [COUNT_AND])[COUNT_AND]


def count_or(a, b):
    return distance_operation(a, b, [COUNT_OR])[COUNT_OR]


def count_xor(a, b):
    return distance_operation(a, b, [COUNT_XOR])[COUNT_XOR]


def count_sub(a, b):
    return distance_operation(a, b, [COUNT_SUB_AB])[COUNT_SUB_AB]


def any_and(a, b):
    """Any bit in a & b (src/bmalgo.h:106)."""
    return count_and(a, b) > 0


def any_or(a, b):
    return count_or(a, b) > 0


def any_xor(a, b):
    return count_xor(a, b) > 0


def any_sub(a, b):
    return count_sub(a, b) > 0
