"""Set-algebra free functions over BitVectors (port of
``bitmagic_tpu/algo/setops.py``).

Equivalents of `src/bmalgo.h:49-165` (count_and/or/xor/sub, any_*), the
batched distance pipeline of `src/bmalgo_impl.h:57-600`
(distance_metric_descriptor / distance_operation): N metrics computed in ONE
pass over aligned block pairs, the similarity batches of
`src/bmalgo_similarity.h`, the combine family and the raw-image imports.
On the card a distance pass is one launch of the gather-fused
multi-metric kernel K2, totals included; all requested metrics share the
same reads of device memory.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..core.blocks import (operand_args_pair, runs_diff, runs_intersect,
                           runs_subtract_points, runs_total)
from ..core.bitvector import BitVector
from ..ops import cuda_kernels as ck
from ..ops.blockops import METRICS as _METRICS

COUNT_AND, COUNT_XOR, COUNT_OR, COUNT_SUB_AB, COUNT_SUB_BA, COUNT_A, \
    COUNT_B = _METRICS


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
    # resolve symbolically on host, every pair with a BIT or GAP side
    # reaches the device
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
    # device part: every other pair (K2, which sums each metric's
    # per-block counts into int64 in its launch); GAP sides are expanded
    # on the device by gap_expand, FULL and ZERO sides are the
    # descriptor's full flag and slot -1
    vals = np.zeros(len(metrics), np.int64)
    kern = ~sym
    if kern.any():
        totals, _ = ck.count_metrics_total(
            tuple(metrics), *operand_args_pair(a, b, cand[kern]))
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


def distance_and_operation(a: BitVector, b: BitVector) -> int:
    """AND-distance shortcut (reference distance_and_operation,
    src/bmalgo_impl.h:853)."""
    return distance_operation(a, b, [COUNT_AND])[COUNT_AND]


def distance_operation_any(a: BitVector, b: BitVector, metrics) -> dict:
    """Boolean variant of distance_operation (reference
    distance_operation_any, src/bmalgo_impl.h:922): per requested metric,
    whether the combined vector has ANY bit."""
    out = {}
    for m in metrics:
        if m == COUNT_AND:
            out[m] = any_and(a, b)
        elif m == COUNT_OR:
            out[m] = any_or(a, b)
        elif m == COUNT_XOR:
            out[m] = any_xor(a, b)
        elif m == COUNT_SUB_AB:
            out[m] = any_sub(a, b)
        elif m == COUNT_SUB_BA:
            out[m] = any_sub(b, a)
        elif m == COUNT_A:
            out[m] = a.any()
        elif m == COUNT_B:
            out[m] = b.any()
        else:
            raise ValueError(f"unknown metric {m}")
    return out


# ---------------------------------------------------------------------------
# similarity batches (reference bmalgo_similarity.h): all-pairs metric
# matrices over groups of vectors
# ---------------------------------------------------------------------------
def similarity_batch(vectors, metric=COUNT_AND) -> np.ndarray:
    """All-pairs similarity matrix over a vector group (reference
    similarity_batch + build_similarity_batch, src/bmalgo_similarity.h:85+):
    an [n, n] int64 matrix whose diagonal holds each vector's count (K3),
    each pair one distance_operation (one K2 launch)."""
    n = len(vectors)
    out = np.zeros((n, n), np.int64)
    for i in range(n):
        out[i, i] = vectors[i].count()
        for j in range(i + 1, n):
            v = distance_operation(vectors[i], vectors[j], [metric])[metric]
            out[i, j] = out[j, i] = v
    return out


def build_similarity_batch(vectors, metric=COUNT_AND):
    """Builder-name alias of similarity_batch (reference
    build_similarity_batch, src/bmalgo_similarity.h:173)."""
    return similarity_batch(vectors, metric)


def build_jaccard_similarity_batch(sv) -> list:
    """Pairwise Jaccard similarity over the value planes of a sparse vector
    (reference build_jaccard_similarity_batch + similarity_batch
    calculate()/sort(), src/bmalgo_similarity.h:186): one fused
    (COUNT_AND, COUNT_OR) distance pass per upper-triangular plane pair;
    (i, j, count_and, count_or, jaccard) sorted by descending similarity
    (a stable sort, so ties keep the pair order)."""
    planes = [(i, p) for i, p in enumerate(sv.planes) if p is not None]
    out = []
    for x in range(len(planes)):
        i, bi = planes[x]
        for y in range(x + 1, len(planes)):
            j, bj = planes[y]
            d = distance_operation(bi, bj, [COUNT_AND, COUNT_OR])
            c_and, c_or = d[COUNT_AND], d[COUNT_OR]
            out.append((i, j, c_and, c_or, (c_and / c_or) if c_or else 0.0))
    out.sort(key=lambda t: t[4], reverse=True)
    return out


# ---------------------------------------------------------------------------
# combine family: bvector vs integer-sequence set algebra (reference
# src/bmalgo_impl.h:1080-1423), each one bulk operand through set_many /
# clear_many / bit_and
# ---------------------------------------------------------------------------
def combine_or(bv: BitVector, ids):
    """bv |= set(ids) (reference combine_or, src/bmalgo_impl.h:1080)."""
    ids = np.asarray(ids, np.int64)
    if ids.size:
        bv.set_many(np.unique(ids))
    return bv


def combine_xor(bv: BitVector, ids):
    """bv ^= set(ids) (reference combine_xor, src/bmalgo_impl.h:1161)."""
    ids = np.unique(np.asarray(ids, np.int64))
    if not ids.size:
        return bv
    bv._flush()
    present = bv.get_bits(ids)
    if present.any():
        bv.clear_many(ids[present])
    if (~present).any():
        bv.set_many(ids[~present])
    return bv


def combine_sub(bv: BitVector, ids):
    """bv -= set(ids) (reference combine_sub, src/bmalgo_impl.h:1248)."""
    ids = np.asarray(ids, np.int64)
    if ids.size:
        bv.clear_many(np.unique(ids))
    return bv


def combine_and(bv: BitVector, ids):
    """bv &= set(ids) (reference combine_and, src/bmalgo_impl.h:1365)."""
    ids = np.unique(np.asarray(ids, np.int64))
    mask = (BitVector.from_indices(ids, bv.size or C.ID_MAX48,
                                   device=bv.device)
            if ids.size else BitVector(bv.size or 1, device=bv.device))
    bv.bit_and(mask)
    return bv


def combine_and_sorted(bv: BitVector, ids):
    """Sorted-input variant (reference combine_and_sorted,
    src/bmalgo_impl.h:1333); the same bulk path, input checked sorted."""
    ids = np.asarray(ids, np.int64)
    if ids.size and (np.diff(ids) < 0).any():
        raise ValueError("combine_and_sorted needs sorted ids")
    return combine_and(bv, ids)


def export_array(bv: BitVector, arr):
    """Import a raw typed array as the bit image of ``bv`` (reference
    export_array, src/bmalgo_impl.h:1423 — despite the name it moves the
    ARRAY into the bvector).  Any 8/16/32/64-bit integer dtype."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind not in "ui":
        raise ValueError("integer array required")
    raw = arr.view(np.uint8)
    pad = (-raw.size) % 4
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    bit_cnt = arr.size * arr.dtype.itemsize * 8
    out = BitVector.from_words(raw.view(np.uint32),
                               size=max(bv.size, bit_cnt), device=bv.device)
    if bit_cnt < bv.size:
        out.resize(bv.size)
    bv._flush()
    bv._adopt(out)
    return bv


def bit_import(bv: BitVector, words):
    """Build from a raw dense u32 word image (reference bit_import_u32,
    src/bmbvimport.h:52)."""
    words = np.ascontiguousarray(words, np.uint32)
    out = BitVector.from_words(words, size=max(bv.size, words.size * 32),
                               device=bv.device)
    bv._flush()
    bv._adopt(out)
    return bv


def bit_import_u32(bv: BitVector, words, size=None, optimize=False):
    """Name-parity front of bit_import (the reference free function
    bit_import_u32, src/bmbvimport.h:46).  ``size`` clips the import to the
    first ``size`` bits; the default is 32 * len(words)."""
    words = np.ascontiguousarray(words, np.uint32)
    if size is not None:
        n_bits = int(size)
        if n_bits > words.size * 32:
            raise ValueError("size exceeds the provided word image")
        full, rem = divmod(n_bits, 32)
        w = words[:full + (1 if rem else 0)].copy()
        if rem:
            w[-1] &= np.uint32((1 << rem) - 1)
        words = w
    bit_import(bv, words)
    if optimize:
        bv.optimize()
    return bv
