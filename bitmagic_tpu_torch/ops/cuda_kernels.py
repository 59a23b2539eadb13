"""Wrappers of the port's hand-written Hopper kernels (``ops/csrc``).

=====================  ===========================  =========================
wrapper                kernel (source)              replaces (TPU kernel)
=====================  ===========================  =========================
block_counts,          K3 block_counts.cu           pallas_kernels.py:147
block_counts_total
count_op,              K2 count_op.cu               pallas_kernels.py:119,
count_metrics,                                      setops.py:39 (_metric_kernel)
count_metrics_total
logical_op_digest,     K1 logical_op_digest.cu      pallas_kernels.py:74,
binary_op_digest                                    bitvector.py:43 (_binary_kernel)
agg_and_sub,           B4 agg_sub.cu                pallas_kernels.py:270,
agg_and_sub_arena,                                  aggregator.py:80/108/875
agg_and_sub_batch
shift_and_chain        B8 shift_chain.cu            agg/aggregator.py:117
                                                    (_shift_and_chain, a
                                                    jitted XLA scan)
pipeline_counts        B5 pipeline_counts.cu        pallas_kernels.py:428
scan_eq                B6 scan_eq.cu                pallas_kernels.py:310
gap_expand,            gap_rows.cu                  no TPU kernel: the host
gap_expand_pair,                                    GAP merges gapstore.py:313
gap_expand_many,                                    and :375
gap_compress
sv_gather              sv_planes.cu                 sv/sparse_vector.py:70
                                                    (_gather_decode_kernel)
sv_transpose           sv_planes.cu                 sv/sparse_vector.py:53
                                                    (_transpose_kernel)
rs_select,             rs_select.cu                 ops/select.py:77
select_flat                                         (select_flat), and
                                                    core/rs_index.py:147
                                                    (select_batch's numpy)
rs_rank,               rs_select.cu                 core/rs_index.py:191
rank_flat                                           (_rank_in_rows), and
                                                    :106 (rank_batch's
                                                    numpy)
sv_descent,            sv_descent.cu                sv/scanner.py:210
descent_rows                                        (_cmp_unsigned's chain),
                                                    parallel/sharded_sv.py:
                                                    1182 (_descent_prog),
                                                    :1208 (_float_gt_prog)
=====================  ===========================  =========================

Each wrapper runs its kernel's plain PyTorch version (``ops/blockops.py``;
``ops/select.py`` for the rank/select kernels; same signature) only when
its tensors lie on the CPU.  On CUDA tensors it
launches the kernel on the current stream or raises: a failed build or
launch is never answered by the plain version.  ``launches`` counts the
launches of each kernel; a wrapper adds one where it launches and nowhere
else.

Gather-fused forms take each operand as the descriptor
``(pool, slot, full, aux, aux_slot)`` of ``core/blocks.operand_args``;
the aligned forms (``count_op(op, a, b)``, ``logical_op_digest(op, a, b)``)
have the signatures of the TPU kernels they are held against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import BLOCK_WAVES, SET_BLOCK_SIZE
from . import _build, blockops
from . import select as plain_select

_I32 = torch.int32
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_OPERAND = [_VP, _INT, _VP, _VP, _VP, _INT, _VP]

_I64 = torch.int64
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_IP = ctypes.POINTER(ctypes.c_int)

launches = {"block_counts": 0, "count_op": 0, "logical_op_digest": 0,
            "agg_and_sub": 0, "pipeline_counts": 0, "scan_eq": 0,
            "gap_expand": 0, "gap_compress": 0, "sv_gather": 0,
            "sv_transpose": 0, "rs_select": 0, "rs_rank": 0,
            "sv_descent": 0, "shift_and_chain": 0}
# most planes B5 stages per CTA (pipeline_counts.cu: 100 KiB of shared
# memory at 256 bytes per plane and tile)
PIPELINE_MAX_PLANES = 400
# most staged planes B5 keeps in registers (pipeline_counts.cu register
# path); above it the shared-memory path runs
PIPELINE_REG_PLANES = 72
# most planes sv_gather takes: 64 value planes and the NULL plane
SV_MAX_PLANES = 65
# sv_gather's cut-over (measured on the card in turns, PERF.md): a gather
# of at most GATHER_DIRECT_MAX ids, or of fewer than GATHER_ROW_IDS ids
# per directory row with a BIT entry on average, is one direct launch;
# else three grouped ones.  GATHER_STAGE_BPS: sv_planes.cu's kStageBps,
# the most breakpoints its passes hold in shared memory
GATHER_DIRECT_MAX = 16384
GATHER_ROW_IDS = 1280
GATHER_STAGE_BPS = 4096
# rs_select / select_flat / rs_rank (rs_select.cu): every batch stages its
# search tables in shared memory, up to RS_STAGE_BYTES a CTA (a cum0 or nb
# beyond it as a sample of at most RS_CUM_SAMPLE_BYTES); the tables past
# the budget are read in global memory
RS_STAGE_BYTES = 200 * 1024
RS_CUM_SAMPLE_BYTES = 32 * 1024
# most steps of one descent (sv_descent.cu kMaxSteps): a 64-bit value
DESCENT_MAX_STEPS = 64

_SIGNATURES = {
    "bm_block_counts": ("block_counts.cu", [_VP, _INT, _VP, _VP, _VP]),
    "bm_count_metrics": ("count_op.cu",
                         _OPERAND + _OPERAND
                         + [_INT, _INT, _INT, ctypes.c_ulonglong, _INT,
                            _VP, _VP, _VP]),
    "bm_logical_op_digest": ("logical_op_digest.cu",
                             [_INT] + _OPERAND + _OPERAND
                             + [_INT, _VP, _VP, _VP]),
    "bm_agg_and_sub": ("agg_sub.cu",
                       [_VP, _VP, _INT, _INT, _INT, _INT, _INT, _VP, _VP,
                        _VP]),
    "bm_pipeline_counts": ("pipeline_counts.cu",
                           [_VP, _LL, _VP, _INT, _VP, _INT, _VP, _VP, _INT,
                            _VP, _VP]),
    "bm_scan_eq": ("scan_eq.cu", [_VP, _INT, _INT, ctypes.c_uint, _VP, _VP]),
    "bm_gap_expand": ("gap_rows.cu",
                      [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP,
                       _VP]),
    "bm_gap_expand_many": ("gap_rows.cu", [_VP, _VP, _INT, _VP, _VP]),
    "bm_gap_compress": ("gap_rows.cu", [_VP, _INT, _LL, _VP, _VP, _VP]),
    "bm_shift_and_chain": ("shift_chain.cu",
                           [_VP, _INT, _VP, _INT, _VP, _INT, _VP, _VP]),
    "bm_sv_gather": ("sv_planes.cu",
                     [_VP, _LL, _VP, _INT, _VP, _LL, _VP, _INT, _VP, _VP,
                      _VP, _VP]),
    "bm_sv_transpose": ("sv_planes.cu", [_VP, _LL, _INT, _INT, _VP, _VP]),
    "bm_rs_select": ("rs_select.cu",
                     [_VP, _LL, _VP, _VP, _VP, _LL, _VP, _VP, _VP, _VP, _LL,
                      _VP, _LL, _LL, _VP, _INT, _INT, _INT, _INT, _LL, _VP]),
    "bm_select_flat": ("rs_select.cu",
                       [_VP, _VP, _VP, _VP, _LL, _VP, _LL, _VP, _INT, _LL,
                        _VP]),
    "bm_rs_rank": ("rs_select.cu",
                   [_VP, _LL, _VP, _VP, _VP, _LL, _VP, _VP, _VP, _LL, _VP,
                    _INT, _INT, _INT, _LL, _VP]),
    "bm_rank_flat": ("rs_select.cu", [_VP, _VP, _LL, _VP, _LL, _VP, _VP]),
    "bm_sv_descent": ("sv_descent.cu",
                      [_VP, _INT, _VP, _VP, _LL, _IP, _INT, _ULL, _VP, _VP,
                       _VP, _VP, _VP, _VP]),
    "bm_descent_rows": ("sv_descent.cu",
                        [_VP, _INT, _LL, _VP, _VP, _INT, _IP, _INT, _ULL,
                         _VP, _VP, _VP]),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn(name):
    src, argtypes = _SIGNATURES[name]
    f = getattr(_build.load(src), name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _launch(name, counter, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"bitmagic_tpu_torch: launch of {name} failed "
                           f"with CUDA error {err}")
    launches[counter] += 1


def _on_cuda(*tensors) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"operands on mixed or unsupported devices: {kinds}")


def _check(t, name, dtype, shape_tail=(), align=16):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape[1:]) != tuple(shape_tail):
        raise ValueError(f"{name}: expected shape [n, {shape_tail}], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.numel() and t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


def _rows(t, name):
    _check(t, name, _I32, (SET_BLOCK_SIZE,))
    return t


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def _operand(desc, k, name):
    """C arguments of one gather descriptor (see bm_common.cuh Operand)."""
    pool, slot, full, aux, aux_slot = desc
    _rows(pool, f"{name}.pool")
    for t, what, dt in ((slot, "slot", _I32), (full, "full", torch.bool),
                        (aux_slot, "aux_slot", _I32)):
        _check(t, f"{name}.{what}", dt)
        if t.shape[0] != k:
            raise ValueError(f"{name}.{what}: expected {k} entries")
    aux_rows = 0
    if aux is not None:
        _rows(aux, f"{name}.aux")
        aux_rows = aux.shape[0]
    return [_ptr(pool), pool.shape[0], _ptr(slot), _ptr(full),
            _ptr(aux), aux_rows, _ptr(aux_slot)]


def _aligned(t, name):
    """C arguments of an aligned operand: row i of ``t``."""
    _rows(t, name)
    return [_ptr(t), t.shape[0], None, None, None, 0, None]


# ---------------------------------------------------------------------------
# K3: per-block popcount, its total
# ---------------------------------------------------------------------------
def _block_counts_launch(pool, per_block, total):
    _rows(pool, "pool")
    n = pool.shape[0]
    out = torch.empty(n, dtype=_I32, device=pool.device) if per_block \
        else None
    # the launcher zeroes the total on the stream before the kernel
    tot = torch.empty((), dtype=_I64, device=pool.device) if total else None
    if n:
        _launch("bm_block_counts", "block_counts", pool.device, _ptr(pool),
                n, _ptr(out), _ptr(tot))
    elif total:
        tot.zero_()
    return tot, out


def block_counts(pool):
    """Per-block popcount -> int32[n]."""
    if not _on_cuda(pool):
        return blockops.block_counts(pool)
    return _block_counts_launch(pool, True, False)[1]


def block_counts_total(pool, per_block=False):
    """``(int64`` 0-d sum of the per-block popcounts, ``int32[n]``
    per-block popcounts or None), in one launch."""
    if not _on_cuda(pool):
        return blockops.block_counts_total(pool, per_block)
    return _block_counts_launch(pool, per_block, True)


# ---------------------------------------------------------------------------
# K2: per-block popcount of a OP b / multi-metric, result rows not written
# ---------------------------------------------------------------------------
def _count_args(metrics):
    """K2's metric arguments for ``metrics``: ``(n_counted, counted codes,
    n_metrics, recipe)`` of count_op.cu from ``blockops.count_plan``."""
    if not 1 <= len(metrics) <= len(blockops.METRICS):
        raise ValueError(f"between 1 and {len(blockops.METRICS)} metrics")
    counted, coefs = blockops.count_plan(metrics)
    codes = 0
    for s, m in enumerate(counted):
        codes |= blockops.METRICS.index(m) << (3 * s)
    recipe = 0
    for j, row in enumerate(coefs):
        for s, c in enumerate(row):
            recipe |= (c + 4) << (9 * j + 3 * s)
    return len(counted), codes, len(metrics), recipe


def _count_launch(metrics, a_args, b_args, k, device, per_block=True,
                  total=False):
    """-> (int64[m] totals or None, int32[m, k] per-block counts or None)."""
    args = _count_args(metrics)
    m = len(metrics)
    out = torch.empty((m, k), dtype=_I32, device=device) if per_block \
        else None
    # the launcher zeroes the totals on the stream before the kernel
    tot = torch.empty(m, dtype=_I64, device=device) if total else None
    if k:
        _launch("bm_count_metrics", "count_op", device, *a_args, *b_args,
                *args, k, _ptr(out), _ptr(tot))
    elif total:
        tot.zero_()
    return tot, out


def count_op(op, a, b):
    """Per-block popcount of (a OP b) over aligned rows -> int32[n]."""
    if not _on_cuda(a, b):
        return blockops.count_op(op, a, b)
    if a.shape != b.shape:
        raise ValueError("count_op: operands differ in shape")
    return _count_launch((blockops.OP_METRIC[op],), _aligned(a, "a"),
                         _aligned(b, "b"), a.shape[0], a.device)[1][0]


def count_metrics(metrics, a_desc, b_desc):
    """Per-block popcounts of every requested metric over gather-described
    operands -> int32[len(metrics), k]."""
    if not _on_cuda(*a_desc, *b_desc):
        return blockops.count_metrics(metrics, a_desc, b_desc)
    k = a_desc[1].shape[0]
    return _count_launch(tuple(metrics), _operand(a_desc, k, "a"),
                         _operand(b_desc, k, "b"), k, a_desc[0].device)[1]


def count_metrics_total(metrics, a_desc, b_desc, per_block=False):
    """``(int64[len(metrics)]`` sums of the per-block popcounts of every
    requested metric, ``int32[len(metrics), k]`` per-block popcounts or
    None) over gather-described operands, in one launch."""
    if not _on_cuda(*a_desc, *b_desc):
        return blockops.count_metrics_total(metrics, a_desc, b_desc,
                                            per_block)
    k = a_desc[1].shape[0]
    return _count_launch(tuple(metrics), _operand(a_desc, k, "a"),
                         _operand(b_desc, k, "b"), k, a_desc[0].device,
                         per_block, True)


# ---------------------------------------------------------------------------
# K1: a OP b rows plus their wave digest
# ---------------------------------------------------------------------------
def _digest_launch(op, a_args, b_args, k, device):
    out = torch.empty((k, SET_BLOCK_SIZE), dtype=_I32, device=device)
    digest = torch.empty((k, BLOCK_WAVES), dtype=_I32, device=device)
    if k:
        _launch("bm_logical_op_digest", "logical_op_digest", device,
                blockops.OP_CODES[op], *a_args, *b_args, k, _ptr(out),
                _ptr(digest))
    return out, digest


def logical_op_digest(op, a, b):
    """(a OP b, int32[n, 64] wave digest) over aligned rows."""
    if not _on_cuda(a, b):
        return blockops.logical_op_digest(op, a, b)
    if a.shape != b.shape:
        raise ValueError("logical_op_digest: operands differ in shape")
    return _digest_launch(op, _aligned(a, "a"), _aligned(b, "b"),
                          a.shape[0], a.device)


def binary_op_digest(op, a_desc, b_desc):
    """(a OP b rows, wave digest) over gather-described operands."""
    if not _on_cuda(*a_desc, *b_desc):
        return blockops.binary_op_digest(op, a_desc, b_desc)
    k = a_desc[1].shape[0]
    return _digest_launch(op, _operand(a_desc, k, "a"),
                          _operand(b_desc, k, "b"), k, a_desc[0].device)


# ---------------------------------------------------------------------------
# B4: K-way AND-SUB sweep with early exit (OR mode, rows-off counts)
# ---------------------------------------------------------------------------
def _descriptor_rows(descs, k):
    """The bm::Operand table of ``descs`` as int64[n, 7] on the host
    (agg_sub.cu: 7 x 8 bytes each, ints in the low half).  ``slot``,
    ``full``, ``aux`` and ``aux_slot`` may be None."""
    table = np.zeros((len(descs), 7), np.int64)
    done = {}                       # a repeated descriptor is checked once
    for j, desc in enumerate(descs):
        if id(desc) in done:
            table[j] = table[done[id(desc)]]
            continue
        done[id(desc)] = j
        pool, slot, full, aux, aux_slot = desc
        name = f"operand {j}"
        _rows(pool, f"{name}.pool")
        if slot is None and pool.shape[0] < k:
            raise ValueError(f"{name}: aligned pool has fewer than {k} rows")
        for t, what, dt in ((slot, "slot", _I32), (full, "full", torch.bool),
                            (aux_slot, "aux_slot", _I32)):
            if t is None:
                continue
            # index arrays may be rows of a matrix: element alignment
            _check(t, f"{name}.{what}", dt, align=t.element_size())
            if t.shape[0] != k:
                raise ValueError(f"{name}.{what}: expected {k} entries")
        aux_rows = 0
        if aux is not None and aux_slot is not None:
            _rows(aux, f"{name}.aux")
            aux_rows = aux.shape[0]
        table[j] = (_ptr(pool) or 0, pool.shape[0], _ptr(slot) or 0,
                    _ptr(full) or 0, (_ptr(aux) or 0) if aux_rows else 0,
                    aux_rows, (_ptr(aux_slot) or 0) if aux_rows else 0)
    return table


def _descriptor_table(descs, k, device):
    """``_descriptor_rows`` of ``descs`` on ``device``."""
    return torch.from_numpy(_descriptor_rows(descs, k)).to(device)


def _sweep_outputs(shape, device, rows, counts):
    out = (torch.empty(shape + (SET_BLOCK_SIZE,), dtype=_I32, device=device)
           if rows else None)
    # the kernel adds each slice's popcount into its column's counter
    cnt = torch.zeros(shape, dtype=_I32, device=device) if counts else None
    return out, cnt


def agg_and_sub(n_and, descs, or_mode=False, rows=True, counts=False):
    """AND of the first ``n_and`` operands' rows AND-NOT the others' (or,
    with ``or_mode``, the OR of all), per column of K gather descriptors
    ``(pool, slot, full, aux, aux_slot)`` aligned on k columns -> ``(rows
    int32[k, 2048] or None, popcounts int32[k] or None)``.  ``slot=None``
    is the aligned form (row i of the pool); ``full``, ``aux`` and
    ``aux_slot`` may be None."""
    if not descs:
        raise ValueError("agg_and_sub: no operands")
    if not rows and not counts:
        raise ValueError("agg_and_sub: nothing to compute")
    if not 0 <= n_and <= len(descs):
        raise ValueError("agg_and_sub: n_and out of range")
    if not _on_cuda(*(t for d in descs for t in d)):
        return blockops.agg_and_sub(n_and, descs, or_mode, rows, counts)
    k = blockops._desc_cols(descs[0])
    device = descs[0][0].device
    out, cnt = _sweep_outputs((k,), device, rows, counts)
    if k:
        table = _descriptor_table(descs, k, device)
        _launch("bm_agg_and_sub", "agg_and_sub", device, _ptr(table), None,
                1, len(descs), int(n_and), int(bool(or_mode)), k, _ptr(out),
                _ptr(cnt))
    return out, cnt


def agg_and_sub_batch(descs, index, offs, n_and, rows=True, counts=False):
    """B4 over a batch of requests in one launch (bitmagic_tpu
    ``_pipeline_results_kernel``): request r sweeps the operands
    ``descs[index[offs[r]:offs[r + 1]]]`` (gather descriptors aligned on k
    columns), ANDing the first ``n_and[r]`` and AND-NOTing the rest;
    ``n_and[r] = 0`` is the complement of the OR of its operands, a request
    with no operands is all ones -> ``(rows int32[V, k, 2048] or None,
    popcounts int32[V, k] or None)``.  The wrapper uploads one table: the
    operand descriptors of every request in order, then the requests."""
    if not descs:
        raise ValueError("agg_and_sub_batch: no operands")
    if not rows and not counts:
        raise ValueError("agg_and_sub_batch: nothing to compute")
    index = np.asarray(index, np.int64)
    offs = np.asarray(offs, np.int64)
    n_and = np.asarray(n_and, np.int64)
    V = offs.size - 1
    n_ops = np.diff(offs)
    if (V < 0 or n_and.shape != (V,) or offs[0] != 0 or (n_ops < 0).any()
            or offs[-1] != index.size or (n_and < 0).any()
            or (n_and > n_ops).any()
            or ((index < 0) | (index >= len(descs))).any()):
        raise ValueError("agg_and_sub_batch: malformed request table")
    if not _on_cuda(*(t for d in descs for t in d)):
        return blockops.agg_and_sub_batch(descs, index, offs, n_and, rows,
                                          counts)
    k = blockops._desc_cols(descs[0])
    device = descs[0][0].device
    out, cnt = _sweep_outputs((V, k), device, rows, counts)
    if k and V:
        buf, req_ptr = _batch_table(descs, index, offs, n_and, k, device)
        _launch("bm_agg_and_sub", "agg_and_sub", device, _ptr(buf), req_ptr,
                V, 0, 0, 0, k, _ptr(out), _ptr(cnt))
    return out, cnt


# ---------------------------------------------------------------------------
# B8: the Bitap chain of combine_shift_right_and in one launch
# ---------------------------------------------------------------------------
def shift_and_chain(first_mask, descs):
    """The Bitap chain over K gather descriptors ``(pool, slot, full, aux,
    aux_slot)`` aligned on a block list of n blocks (``first_mask``
    int32[n]: bit 0 clear where a block is not its list predecessor's
    address successor) -> int32[n, 2048]: ``acc = rows_0``, then ``acc =
    shift_up1(acc) & rows_j`` over the list as one flat bit string, in
    the closed form of ``blockops.shift_and_chain``.  Repeated descriptors
    (the same tuple) are one vector with several shifts.  One launch."""
    if not descs:
        raise ValueError("shift_and_chain: no operands")
    if not _on_cuda(first_mask, *(t for d in descs for t in d)):
        return blockops.shift_and_chain(first_mask, descs)
    n = blockops._desc_cols(descs[0])
    dev = descs[0][0].device
    _check(first_mask, "shift_and_chain: first_mask", _I32, align=4)
    if first_mask.shape[0] != n:
        raise ValueError(f"shift_and_chain: first_mask has "
                         f"{first_mask.shape[0]} entries for {n} blocks")
    out = torch.empty((n, SET_BLOCK_SIZE), dtype=_I32, device=dev)
    if n:
        buf, args = _chain_plan(descs, n, dev)
        _launch("bm_shift_and_chain", "shift_and_chain", dev, *args,
                _ptr(first_mask), n, _ptr(out))
    return out


def _chain_plan(descs, n, device):
    """The one upload of a shift_and_chain launch: per segment of
    ``blockops.chain_segments`` (vector, qa, nq, mask offset) and its
    vector's descriptor row (``_descriptor_rows`` of
    ``blockops.chain_groups``' distinct descriptors), 80 bytes each, then
    the shift masks -> ``(buffer on device, (the segments' address, their
    count, the masks' address, the deepest block offset))``, the C entry's
    first arguments.  The buffer points into the descriptors' tensors:
    keep both alive while a launch may read them."""
    vecs, offs, shifts = blockops.chain_groups(descs)
    segs, masks, deep = blockops.chain_segments(offs, shifts)
    recs = np.zeros((segs.shape[0], 10), np.int64)
    recs[:, :2] = segs.view(np.int64)
    recs[:, 2:9] = _descriptor_rows(vecs, n)[segs[:, 0]]
    if masks.size % 2:
        masks = np.append(masks, np.uint32(0))
    buf = torch.from_numpy(np.concatenate(
        [recs.ravel(), masks.view(np.int64)])).to(device)
    base = buf.data_ptr()
    return buf, (base, segs.shape[0], base + recs.nbytes, deep)


def _batch_table(descs, index, offs, n_and, k, device):
    """The one upload of a batched B4 launch: the descriptors of every
    request's operands in order (``descs[index]``), then one agg_sub.cu
    Request ``(begin, n_ops, n_and, 0)`` per request -> ``(table on
    device, address of its first Request)``.  The table points into the
    descriptors' pools and index tensors: keep ``descs`` alive while a
    launch may read it."""
    offs = np.asarray(offs, np.int64)
    reqs = np.zeros((offs.size - 1, 4), np.int32)
    reqs[:, 0], reqs[:, 1], reqs[:, 2] = offs[:-1], np.diff(offs), n_and
    ops = _descriptor_rows(descs, k)[np.asarray(index, np.int64)]
    buf = torch.from_numpy(np.concatenate(
        [ops.ravel(), reqs.view(np.int64).ravel()])).to(device)
    return buf, buf.data_ptr() + ops.nbytes


def agg_and_sub_arena(n_and, n_sub, slots, pool):
    """B4 in the signature of bitmagic_tpu ``agg_and_sub_pallas``: slots
    int32[n_and + n_sub, nb] into the combined ``pool`` (slot -1 = the
    identity) -> int32[nb, 2048]."""
    if not _on_cuda(slots, pool):
        return blockops.agg_and_sub_arena(n_and, n_sub, slots, pool)
    if slots.dim() != 2 or slots.shape[0] != n_and + n_sub:
        raise ValueError("agg_and_sub_arena: slots must be [n_and + n_sub, "
                         "nb]")
    _check(slots, "slots", _I32, (slots.shape[1],))
    return agg_and_sub(n_and, blockops.arena_descriptors(n_and, slots,
                                                         pool))[0]


# ---------------------------------------------------------------------------
# B5: batched pipeline counts
# ---------------------------------------------------------------------------
def pipeline_inputs(selectors):
    """The kernel's selector input for ``selectors`` int[V, S]: ``(plane_idx
    int32[n], masks uint32[V, 2, ceil(n / 32)] or None, offs int32[V + 1]
    or None, codes int32[m] or None)``.  Only the n planes some row selects
    are staged; up to ``PIPELINE_REG_PLANES`` of them the register path
    takes bit masks, above it the shared path CSR codes."""
    idx, compact = blockops.pipeline_planes(selectors)
    if idx.size <= PIPELINE_REG_PLANES:
        return idx, blockops.pipeline_masks(compact), None, None
    return (idx, None, *blockops.pipeline_codes(compact))


def pipeline_counts(planes, selectors):
    """Hit counts of V selector rows (1 AND / -1 AND-NOT / 0 skip, int[V,
    S]) over the plane stack int32[S, nb, 2048] -> int64[V] (the signature
    of bitmagic_tpu ``pipeline_counts``; that one sums in int32)."""
    if not _on_cuda(planes):
        return blockops.pipeline_counts(planes, selectors)
    if planes.dim() != 3 or planes.shape[2] != SET_BLOCK_SIZE:
        raise ValueError("pipeline_counts: planes must be [S, nb, 2048]")
    S, nb = planes.shape[0], planes.shape[1]
    if S > PIPELINE_MAX_PLANES:
        raise ValueError(f"pipeline_counts: {S} planes; the kernel stages "
                         f"at most {PIPELINE_MAX_PLANES}")
    _check(planes, "planes", _I32, (nb, SET_BLOCK_SIZE))
    sel = (selectors.detach().cpu().numpy() if torch.is_tensor(selectors)
           else np.asarray(selectors))
    if sel.ndim != 2 or sel.shape[1] != S:
        raise ValueError(f"pipeline_counts: selectors must be [V, {S}]")
    out = torch.zeros(sel.shape[0], dtype=_I64, device=planes.device)
    if sel.shape[0] == 0 or nb == 0:
        return out
    buf, args = pipeline_prepare(planes, sel)
    _launch("bm_pipeline_counts", "pipeline_counts", planes.device, *args,
            _ptr(out))
    return out


def pipeline_prepare(planes, selectors):
    """Upload B5's input for ``selectors`` int[V, S] over ``planes`` as one
    int32 buffer (the staged plane list, then the masks or the CSR codes of
    ``pipeline_inputs``) -> ``(buffer, C arguments of bm_pipeline_counts up
    to n_values)``; keep the buffer alive until the launch has run."""
    idx, masks, offs, codes = pipeline_inputs(selectors)
    parts = [idx] + [a.view(np.int32).ravel() for a in (masks, offs, codes)
                     if a is not None]
    buf = torch.from_numpy(np.concatenate(parts)).to(planes.device)
    at = [int(x) for x in np.cumsum([0] + [p.size * 4 for p in parts])
          + buf.data_ptr()]
    nw = masks.shape[2] if masks is not None else 0
    p_masks = at[1] if masks is not None and masks.size else None
    p_offs, p_codes = (at[1], at[2]) if offs is not None else (None, None)
    return buf, [_ptr(planes), planes.shape[1] * SET_BLOCK_SIZE,
                 at[0] if idx.size else None, idx.size, p_masks, nw, p_offs,
                 p_codes, len(np.asarray(selectors))]


# ---------------------------------------------------------------------------
# B6: bit-sliced equality scan
# ---------------------------------------------------------------------------
def scan_eq(n_planes, planes, value):
    """Hit mask int32[nb, 2048] of ``value`` (uint32) over the first
    ``n_planes`` planes of the aligned stack int32[S, nb, 2048] (the
    signature of bitmagic_tpu ``scan_eq_pallas``)."""
    if not _on_cuda(planes):
        return blockops.scan_eq(n_planes, planes, value)
    n_planes = int(n_planes)
    if planes.dim() != 3 or planes.shape[2] != SET_BLOCK_SIZE:
        raise ValueError("scan_eq: planes must be [S, nb, 2048]")
    if not 0 <= n_planes <= planes.shape[0]:
        raise ValueError("scan_eq: n_planes out of range")
    nb = planes.shape[1]
    _check(planes, "planes", _I32, (nb, SET_BLOCK_SIZE))
    out = torch.empty((nb, SET_BLOCK_SIZE), dtype=_I32, device=planes.device)
    if nb:
        _launch("bm_scan_eq", "scan_eq", planes.device, _ptr(planes),
                n_planes, nb, int(value) & 0xFFFFFFFF, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# D-GAP blocks to dense rows and back (gap_rows.cu)
# ---------------------------------------------------------------------------
def gap_expand(ends, offs, first, sel):
    """Dense rows int32[k, 2048] of the D-GAP blocks ``sel`` int32[k] of a
    store's device mirror ``(ends int32, offs int32[m + 1], first
    uint8[m])`` (``GapStore.device_arrays``), as ``GapStore.to_dense``."""
    if not _on_cuda(ends, offs, first, sel):
        return blockops.gap_expand(ends, offs, first, sel)
    return _gap_expand((ends, offs, first), None, sel, sel.shape[0])


def gap_expand_pair(mirror_a, mirror_b, sel, k_a):
    """Dense rows int32[k, 2048] of two stores' D-GAP blocks in one
    launch: rows [0, k_a) are blocks ``sel[:k_a]`` of ``mirror_a``, the
    rest blocks ``sel[k_a:]`` of ``mirror_b`` (each a
    ``GapStore.device_arrays``; None for a side that selects no block)."""
    tensors = (*(mirror_a or ()), *(mirror_b or ()), sel)
    if not _on_cuda(*tensors):
        return blockops.gap_expand_pair(mirror_a, mirror_b, sel, k_a)
    _one_device("gap_expand_pair", tensors)
    return _gap_expand(mirror_a, mirror_b, sel, k_a)


def gap_expand_many(mirrors, sel):
    """Dense rows int32[k, 2048] of several stores' D-GAP blocks in one
    launch: blocks ``sel[i]`` (host int array) of ``mirrors[i]`` (a
    ``GapStore.device_arrays``), the stores' rows one after another in
    that order."""
    if len(mirrors) != len(sel):
        raise ValueError(f"gap_expand_many: {len(sel)} selections for "
                         f"{len(mirrors)} mirrors")
    tensors = tuple(t for m in mirrors for t in m)
    if not tensors:
        raise ValueError("gap_expand_many: no mirror")
    if not _on_cuda(*tensors):
        return blockops.gap_expand_many(mirrors, sel)
    dev = _one_device("gap_expand_many", tensors)
    buf, args = _expand_many_plan(mirrors, sel, dev)
    out = torch.empty((args[-1], SET_BLOCK_SIZE), dtype=_I32, device=dev)
    if args[-1]:
        _launch("bm_gap_expand_many", "gap_expand", dev, *args, _ptr(out))
    return out


def _expand_many_plan(mirrors, sel, device):
    """The one upload of a gap_expand_many launch: the mirrors' table
    (three pointers each), then each row's (store, block) -> ``(buffer on
    device, (the table's address, the rows' address, the row count))``,
    the C entry's first arguments (None for the buffer and the addresses
    where no row is selected).  The table points into the mirrors: keep
    them alive while a launch may read it."""
    sizes = [int(np.asarray(x).size) for x in sel]
    k = sum(sizes)
    if not k:
        return None, (None, None, 0)
    table = np.zeros((len(mirrors), 3), np.int64)
    for i, (ends, offs, first) in enumerate(mirrors):
        for t, name, dt in ((ends, "ends", _I32), (offs, "offs", _I32),
                            (first, "first", torch.uint8)):
            _check(t, f"gap_expand_many: {name}", dt, align=t.element_size())
        if offs.shape[0] != first.shape[0] + 1:
            raise ValueError("gap_expand_many: offs must have one entry "
                             "more than first")
        table[i] = (_ptr(ends), _ptr(offs), _ptr(first))
    rows = np.empty((k, 2), np.int32)
    rows[:, 0] = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    rows[:, 1] = np.concatenate([np.asarray(x).ravel() for x in sel])
    buf = torch.from_numpy(np.concatenate(
        [table.ravel(), rows.view(np.int64).ravel()])).to(device)
    base = buf.data_ptr()
    return buf, (base, base + table.nbytes, k)


def _gap_expand(mirror_a, mirror_b, sel, k_a):
    _check(sel, "gap_expand: sel", _I32, align=4)
    k = sel.shape[0]
    if not 0 <= k_a <= k:
        raise ValueError(f"gap_expand: {k_a} rows of the first store of {k}")
    args = []
    for m, rows, what in ((mirror_a, k_a, "a"), (mirror_b, k - k_a, "b")):
        if m is None:
            if rows:
                raise ValueError(f"gap_expand: no mirror {what} for {rows} "
                                 f"rows")
            args += [None, None, None]
            continue
        ends, offs, first = m
        for t, name, dt in ((ends, "ends", _I32), (offs, "offs", _I32),
                            (first, "first", torch.uint8)):
            _check(t, f"gap_expand: {what}.{name}", dt,
                   align=t.element_size())
        if offs.shape[0] != first.shape[0] + 1:
            raise ValueError("gap_expand: offs must have one entry more "
                             "than first")
        args += [_ptr(ends), _ptr(offs), _ptr(first)]
    out = torch.empty((k, SET_BLOCK_SIZE), dtype=_I32, device=sel.device)
    if k:
        _launch("bm_gap_expand", "gap_expand", sel.device, *args, _ptr(sel),
                k_a, k, _ptr(out))
    return out


def gap_compress(rows, cap):
    """D-GAP encoding of rows int32[n, 2048], as ``GapStore.from_dense``,
    into one packed int32[2n + 1 + cap] buffer on the rows' device:
    ``offs`` (n + 1, ``offs[n]`` the true total), ``first`` (n, a word
    each), then the run ends, at most ``cap`` of them (past the total the
    buffer is undefined; ``blockops.gap_unpack``).  ``cap`` is the
    caller's upper bound on the total run count; ``GapStore.from_packed``
    raises where the total exceeds it.  One launch (after a memset of its
    scratch), no scalar sync."""
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"gap_compress: cap {cap} < 0")
    if not _on_cuda(rows):
        return blockops.gap_compress(rows, cap)
    _rows(rows, "rows")
    n, dev = rows.shape[0], rows.device
    if 2 * n + 1 + cap >= 2**31:
        raise ValueError(f"gap_compress: {n} rows and cap {cap} exceed "
                         f"an int32 buffer")
    out = torch.empty(2 * n + 1 + cap, dtype=_I32, device=dev)
    if not n:
        out[:1] = 0
        return out
    # the ticket counter and the look-back flags, cleared by the C entry
    scratch = torch.empty(n + 1, dtype=_I64, device=dev)
    _launch("bm_gap_compress", "gap_compress", dev, _ptr(rows), n, cap,
            _ptr(out), _ptr(scratch))
    return out


# ---------------------------------------------------------------------------
# SparseVector planes: multi-plane gather, import transpose (sv_planes.cu)
# ---------------------------------------------------------------------------
def _gather_grouped(n, table):
    """Whether a gather of ``n`` ids takes the grouped passes: more than
    GATHER_DIRECT_MAX ids, and on average at least GATHER_ROW_IDS of them
    per directory row with a BIT entry."""
    return (n > GATHER_DIRECT_MAX
            and n >= GATHER_ROW_IDS * max(table.bit_rows, 1))


def sv_gather(ids, table):
    """Value image int64[n] of ids int64[n] over a column's plane table
    (``blockops.PlaneTable`` of ``core/blocks.plane_table``): bit s of an
    id's image is its bit in the plane of value bit s, and the image is 0
    where the NULL plane's bit is 0.  One direct launch, or (where
    ``_gather_grouped``) three: the ids grouped by directory row, then
    each group answered from its staged BIT rows."""
    tensors = (ids, table.table, table.nb, table.ent, table.runs, table.bps,
               table.dir, *table.pools,
               *(a for g in table.gaps if g is not None for a in g))
    if not _on_cuda(*tensors):
        return blockops.sv_gather(ids, table)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("sv_gather: ids and plane table on different "
                         "devices")
    return _gather(ids, table, _gather_grouped(ids.shape[0], table))


def _gather(ids, table, grouped):
    """``sv_gather`` on the card through the route ``grouped`` names (the
    timing tools call it to hold the two routes against each other)."""
    _check(ids, "ids", _I64, align=8)
    P = table.meta.shape[0]
    if table.table.shape != (P, len(blockops.PLANE_COLS)):
        raise ValueError("sv_gather: malformed plane table")
    B = table.bps.shape[0]
    for t, what, dt in ((table.table, "table", _I64), (table.nb, "nb", _I64),
                        (table.ent, "ent", _I32), (table.runs, "runs", _I64),
                        (table.bps, "bps", _I64), (table.dir, "dir", _I32)):
        _check(t, what, dt, tuple(t.shape[1:]), align=t.element_size())
    if table.dir.shape != (B + 1, P):
        raise ValueError("sv_gather: the directory must hold one row per "
                         "breakpoint and one before them, a column per plane")
    if P > SV_MAX_PLANES:
        raise ValueError(f"sv_gather: {P} planes; at most {SV_MAX_PLANES}")
    if any(p.numel() and p.data_ptr() % 16 for p in table.pools):
        raise ValueError("sv_gather: pools must be 16-byte aligned")
    n = ids.shape[0]
    out = torch.empty(n, dtype=_I64, device=ids.device)
    if not n:
        return out
    scratch = perm = None
    if grouped:
        scratch = torch.empty(4 * (B + 1) + 2, dtype=_I64, device=ids.device)
        perm = torch.empty(n, dtype=_I64, device=ids.device)
    _launch("bm_sv_gather", "sv_gather", ids.device, _ptr(ids), n,
            _ptr(table.table), P, _ptr(table.bps), B, _ptr(table.dir),
            int(bool(grouped)), _ptr(scratch), _ptr(perm), _ptr(out))
    if grouped:                     # the hist and scatter passes
        launches["sv_gather"] += 2
    return out


def sv_transpose(vals, n_slices):
    """Plane word image int32[n_slices, ceil(n / 32)] of values ``vals``
    int32[n] (uint32 values, n_slices <= 32) or int64[n] (uint64 values):
    word w of plane s holds bit s of values 32w .. 32w + 31, LSB first."""
    if not _on_cuda(vals):
        return blockops.sv_transpose(vals, n_slices)
    n_slices = int(n_slices)
    if vals.dtype not in (_I32, _I64) or vals.dim() != 1:
        raise TypeError("sv_transpose: values must be int32[n] or int64[n]")
    _check(vals, "vals", vals.dtype, align=vals.element_size())
    if not 1 <= n_slices <= (32 if vals.dtype == _I32 else 64):
        raise ValueError(f"sv_transpose: {n_slices} slices of "
                         f"{vals.element_size()}-byte values")
    n = vals.shape[0]
    out = torch.empty((n_slices, -(-n // 32)), dtype=_I32,
                      device=vals.device)
    if n:
        _launch("bm_sv_transpose", "sv_transpose", vals.device, _ptr(vals),
                n, vals.element_size(), n_slices, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# rank/select batches over an rs-index's device tables (rs_select.cu)
# ---------------------------------------------------------------------------
def _one_device(what, tensors):
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: tensors on different devices")
    return tensors[0].device


def _pool_tables(what, pool, gwc):
    _rows(pool, f"{what}: pool")
    _check(gwc, f"{what}: gwc", _I32, align=4)
    if gwc.shape[0] != pool.shape[0] * BLOCK_WAVES:
        raise ValueError(f"{what}: gwc must hold {BLOCK_WAVES} entries per "
                         f"pool row")


def _index_tables(what, seg, runs, pool, gwc):
    """Check an rs-index's segment, D-GAP run and pool tables."""
    _check(seg, f"{what}: seg", _I64, (len(plain_select.SEG_COLS),),
           align=8)
    ec, key_end, key_cum = runs
    _check(ec, f"{what}: runs", _I32, (2,), align=4)
    for t, name in ((key_end, "key_end"), (key_cum, "key_cum")):
        _check(t, f"{what}: {name}", _I64, align=8)
        if t.shape[0] != ec.shape[0]:
            raise ValueError(f"{what}: {name} must have one key per run")
    _pool_tables(what, pool, gwc)


def _r16(nbytes):
    return -(-nbytes // 16) * 16


def _staging(n, item, sizes):
    """(stride, flags..., bytes) of a staged launch: a search table of
    ``n`` entries of ``item`` bytes, whole or (past RS_STAGE_BYTES) every
    stride-th entry in at most RS_CUM_SAMPLE_BYTES; then the tables of
    ``sizes`` bytes in order, each staged (flag 1) while the budget
    lasts."""
    budget = RS_STAGE_BYTES
    stride = 1
    if _r16(item * n) > budget:
        stride = -(-n // (RS_CUM_SAMPLE_BYTES // item))
    used = _r16(item * -(-n // stride))
    flags = []
    for nbytes in sizes:
        flags.append(int(used + _r16(nbytes) <= budget))
        used += _r16(nbytes) * flags[-1]
    return (stride, *flags, max(used, 16))


def _select_staging(seg_rows, n_waves, n_runs):
    """(cum_stride, stage_sel, stage_gws, stage_gcs, bytes) of an
    ``rs_select`` launch (rs_select.cu SelectArgs): cum0, then sel, gws
    and gcs."""
    S = plain_select.SAMPLE
    return _staging(seg_rows, 8, (16 * seg_rows, 4 * (n_waves // S),
                                  4 * (n_runs // S)))


def _rank_staging(n_seg, n_runs):
    """(nb_stride, stage_rec, stage_ges, bytes) of an ``rs_rank`` launch
    (rs_select.cu RankArgs): nb, then rec and ges."""
    return _staging(n_seg, 8, (16 * (n_seg + 2),
                               4 * (n_runs // plain_select.SAMPLE)))


def _flat_staging(n_samples):
    """(gws_stride, bytes) of a ``select_flat`` launch: every S-th of the
    ``n_samples`` gws entries, the whole table where it fits
    RS_STAGE_BYTES."""
    stride = max(1, -(-4 * n_samples // RS_STAGE_BYTES))
    return stride, _r16(4 * -(-n_samples // stride))


def _checked_tables(what, tables, key, specs, staging):
    """The launch plan cached on ``tables`` (``select.SelectTables`` or
    ``RankTables``) for an index of shape ``key``: on first use (or
    another key) each table ``name`` of ``specs`` is checked to be
    ``(entries, dtype, shape tail, alignment)`` on the key's device, and
    the plan is ``staging()``."""
    got = tables.staging
    if got is not None and got[0] == key:
        return got[1]
    for name, (n, dtype, tail, align) in specs.items():
        t = getattr(tables, name)
        _check(t, f"{what}: {name}", dtype, tail, align=align)
        if t.shape[0] != n or t.device != key[-1]:
            raise ValueError(f"{what}: tables.{name} is not the index's "
                             f"own")
    tables.staging = (key, staging())
    return tables.staging[1]


def rs_select(seg, cum0, runs, pool, gwc, ranks, total, tables):
    """Position of each 1-based rank int64[Q] of an rs-index's vector, -1
    outside [1, total] -> int64[Q], in one launch (``ops/select.rs_select``
    has the tables' layout).  ``tables``: ``select.select_tables`` of the
    index, built once by it (``RSIndex._select_tables``)."""
    tensors = (seg, cum0, *runs, pool, gwc, ranks)
    if not _on_cuda(*tensors):
        return plain_select.rs_select(seg, cum0, runs, pool, gwc, ranks,
                                      total)
    dev = _one_device("rs_select", tensors)
    _index_tables("rs_select", seg, runs, pool, gwc)
    _check(cum0, "rs_select: cum0", _I64, align=8)
    _check(ranks, "rs_select: ranks", _I64, align=8)
    if cum0.shape[0] != seg.shape[0] or seg.shape[0] < 1:
        raise ValueError("rs_select: cum0 must have one entry per seg row")
    if gwc.data_ptr() % 16 or runs[0].data_ptr() % 16:
        raise ValueError("rs_select: gwc and runs must be 16-byte aligned")
    m1, W, R = seg.shape[0], gwc.shape[0], runs[0].shape[0]
    S = plain_select.SAMPLE
    stage = _checked_tables(
        "rs_select", tables, ("rs_select", m1, W, R, dev),
        {"sel": (m1, _I64, (2,), 16), "gws": (W // S, _I32, (), 16),
         "gcs": (R // S, _I32, (), 4), "wsp": (W, _I32, (), 16)},
        lambda: _select_staging(m1, W, R))
    n = ranks.shape[0]
    out = torch.empty(n, dtype=_I64, device=dev)
    if n:
        _launch("bm_rs_select", "rs_select", dev, _ptr(cum0), m1,
                _ptr(tables.sel), _ptr(runs[0]), _ptr(tables.gcs), R,
                _ptr(pool), _ptr(gwc), _ptr(tables.gws), _ptr(tables.wsp),
                W, _ptr(ranks), n, int(total), _ptr(out), *stage)
    return out


def select_flat(pool, gwc, ranks, tables):
    """Global bit positions (pool_row * 65536 + offset) of 1-based int32
    global ranks int32[Q] over a whole pool -> int64[Q] (the signature of
    bitmagic_tpu ``select_flat``), in one ``rs_select`` launch.
    ``tables``: ``select.flat_tables`` of the pool, built once by the
    index that owns it (``ShardedRSIndex.flat_tables``)."""
    if not _on_cuda(pool, gwc, ranks):
        return plain_select.select_flat(pool, gwc, ranks)
    dev = _one_device("select_flat", (pool, gwc, ranks))
    _pool_tables("select_flat", pool, gwc)
    _check(ranks, "select_flat: ranks", _I32, align=4)
    if gwc.data_ptr() % 16:
        raise ValueError("select_flat: gwc must be 16-byte aligned")
    W = gwc.shape[0]
    S = plain_select.SAMPLE
    stage = _checked_tables(
        "select_flat", tables, ("select_flat", W, dev),
        {"gws": (W // S, _I32, (), 16), "wsp": (W, _I32, (), 16)},
        lambda: _flat_staging(W // S))
    n = ranks.shape[0]
    out = torch.empty(n, dtype=_I64, device=dev)
    if n:
        if not W:
            raise ValueError("select_flat: ranks over an empty pool")
        _launch("bm_select_flat", "rs_select", dev, _ptr(pool), _ptr(gwc),
                _ptr(tables.gws), _ptr(tables.wsp), W, _ptr(ranks), n,
                _ptr(out), *stage)
    return out


def rs_rank(seg, nb, runs, pool, gwc, ids, tables):
    """rank(i) = popcount[0, i] for each id int64[Q] of an rs-index's
    vector -> int64[Q], in one launch (``ops/select.rs_rank``).
    ``tables``: ``select.rank_tables`` of the index, built once by it
    (``RSIndex._rank_tables``)."""
    tensors = (seg, nb, *runs, pool, gwc, ids)
    if not _on_cuda(*tensors):
        return plain_select.rs_rank(seg, nb, runs, pool, gwc, ids)
    dev = _one_device("rs_rank", tensors)
    _index_tables("rs_rank", seg, runs, pool, gwc)
    _check(nb, "rs_rank: nb", _I64, align=8)
    _check(ids, "rs_rank: ids", _I64, align=8)
    if seg.shape[0] != nb.shape[0] + 1:
        raise ValueError("rs_rank: seg must have one row per segment and "
                         "the sentinel")
    if runs[0].data_ptr() % 16:
        raise ValueError("rs_rank: runs must be 16-byte aligned")
    m, W, R = nb.shape[0], gwc.shape[0], runs[0].shape[0]
    stage = _checked_tables(
        "rs_rank", tables, ("rs_rank", m, W, R, dev),
        {"rec": (m + 2, _I64, (2,), 16),
         "ges": (R // plain_select.SAMPLE, _I32, (), 4),
         "wrk": (W, _I32, (2,), 8)},
        lambda: _rank_staging(m, R))
    n = ids.shape[0]
    out = torch.empty(n, dtype=_I64, device=dev)
    if n:
        _launch("bm_rs_rank", "rs_rank", dev, _ptr(nb), m, _ptr(tables.rec),
                _ptr(runs[0]), _ptr(tables.ges), R, _ptr(pool),
                _ptr(tables.wrk), _ptr(ids), n, _ptr(out), *stage)
    return out


def rank_flat(pool, gwc, rel, tables):
    """popcount of bits [0, rel] of a whole pool for each rel int64[Q] in
    [0, rows * 65536) -> int64[Q], in one ``rs_rank`` launch.
    ``tables``: ``select.flat_rank_tables`` of the pool, built once by the
    index that owns it (``ShardedRSIndex.rank_tables``)."""
    if not _on_cuda(pool, gwc, rel):
        return plain_select.rank_flat(pool, gwc, rel)
    dev = _one_device("rank_flat", (pool, gwc, rel))
    _pool_tables("rank_flat", pool, gwc)
    _check(rel, "rank_flat: rel", _I64, align=8)
    W, wrk = gwc.shape[0], tables.wrk
    _check(wrk, "rank_flat: wrk", _I32, (2,), align=8)
    if wrk.shape[0] != W or wrk.device != dev:
        raise ValueError("rank_flat: tables.wrk is not the pool's own")
    n = rel.shape[0]
    out = torch.empty(n, dtype=_I64, device=dev)
    if n:
        if not W:
            raise ValueError("rank_flat: ids over an empty pool")
        _launch("bm_rank_flat", "rs_rank", dev, _ptr(pool), _ptr(wrk), W,
                _ptr(rel), n, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# the ordered searches' MSB-first slice descent (sv_descent.cu)
# ---------------------------------------------------------------------------
def _table_tensors(t):
    return (t.table, t.nb, t.ent, t.runs, *t.pools,
            *(a for g in t.gaps if g is not None for a in g))


def _check_table(t, what):
    if t.table.shape != (t.meta.shape[0], len(blockops.PLANE_COLS)):
        raise ValueError(f"{what}: malformed plane table")
    for x, name, dt in ((t.table, "table", _I64), (t.nb, "nb", _I64),
                        (t.ent, "ent", _I32), (t.runs, "runs", _I64)):
        _check(x, f"{what}.{name}", dt, tuple(x.shape[1:]),
               align=x.element_size())


def _steps(what, rows, bits, lo, hi):
    """The steps as the C interface takes them: a host int array."""
    rows = [int(r) for r in rows]
    if len(rows) > DESCENT_MAX_STEPS:
        raise ValueError(f"{what}: {len(rows)} steps; at most "
                         f"{DESCENT_MAX_STEPS}")
    if any(not lo <= r < hi for r in rows) or not 0 <= bits < 1 << 64:
        raise ValueError(f"{what}: a step's row or the bits out of range")
    return (ctypes.c_int * max(len(rows), 1))(*rows), len(rows)


def sv_descent(table, utable, codes, rows, bits, want_eq=True):
    """The MSB-first descent of a column's ordered search over K walked
    blocks, in one launch: ``table`` the column's plane table, ``utable``
    the universe's one-plane table (both ``core/blocks.plane_table``),
    ``codes`` int32[K, len(rows) + 1] the blocks' entry codes
    (``core/blocks.descent_codes``), step i the plane of table row
    ``rows[i]`` with bit i of ``bits`` (``blockops.sv_descent`` has the
    semantics).  -> ``(gt int32[K, 2048], its digest int32[K, 64], eq, its
    digest (None without want_eq), classes int32[2K]: a class | a D-GAP
    result's run count << 8)``."""
    tensors = (codes, *_table_tensors(table), *_table_tensors(utable))
    if not _on_cuda(*tensors):
        return blockops.sv_descent(table, utable, codes, rows, bits,
                                   want_eq)
    dev = _one_device("sv_descent", tensors)
    _check_table(table, "sv_descent: table")
    _check_table(utable, "sv_descent: universe")
    if utable.meta.shape[0] != 1:
        raise ValueError("sv_descent: the universe is a one-plane table")
    steps, n = _steps("sv_descent", rows, bits, 0, table.meta.shape[0])
    _check(codes, "sv_descent: codes", _I32, (n + 1,), align=4)
    if any(p.numel() and p.data_ptr() % 16 for p in (*table.pools,
                                                     *utable.pools)):
        raise ValueError("sv_descent: pools must be 16-byte aligned")
    k = codes.shape[0]
    gt = torch.empty((k, SET_BLOCK_SIZE), dtype=_I32, device=dev)
    gt_dig = torch.empty((k, BLOCK_WAVES), dtype=_I32, device=dev)
    eq = torch.empty_like(gt) if want_eq else None
    eq_dig = torch.empty_like(gt_dig) if want_eq else None
    cls = torch.empty(2 * k, dtype=_I32, device=dev)
    if k:
        _launch("bm_sv_descent", "sv_descent", dev, _ptr(table.table),
                table.meta.shape[0], _ptr(utable.table), _ptr(codes), k,
                steps, n, bits, _ptr(gt), _ptr(gt_dig), _ptr(eq),
                _ptr(eq_dig), _ptr(cls))
    return gt, gt_dig, eq, eq_dig, cls


def descent_rows(stack, uni, rows, bits, sign=None, mode=0):
    """The MSB-first descent over one shard's stack int32[K, n, 2048] in
    one launch: eq starts as ``uni`` int32[n, 2048] (mode 1: ``uni &
    ~sign``, mode 2: ``uni & sign``), step i takes stack row ``rows[i]``
    (-1: a zero plane) with bit i of ``bits``.  -> ``(gt, eq)``
    int32[n, 2048] (``blockops.descent_rows``)."""
    if mode not in (0, 1, 2) or (mode and sign is None):
        raise ValueError(f"descent_rows: mode {mode} with sign {sign}")
    tensors = (stack, uni, sign) if mode else (stack, uni)
    if not _on_cuda(*tensors):
        return blockops.descent_rows(stack, uni, rows, bits, sign, mode)
    dev = _one_device("descent_rows", tensors)
    n = stack.shape[1] if stack.dim() == 3 else -1
    _check(stack, "descent_rows: stack", _I32, (n, SET_BLOCK_SIZE))
    _check(uni, "descent_rows: uni", _I32, (SET_BLOCK_SIZE,))
    if uni.shape[0] != n:
        raise ValueError("descent_rows: uni must have the stack's rows")
    if mode:
        _check(sign, "descent_rows: sign", _I32, (SET_BLOCK_SIZE,))
        if sign.shape != uni.shape:
            raise ValueError("descent_rows: sign must have uni's shape")
    steps, n_steps = _steps("descent_rows", rows, bits, -1, stack.shape[0])
    gt, eq = torch.empty_like(uni), torch.empty_like(uni)
    if n:
        _launch("bm_descent_rows", "sv_descent", dev, _ptr(stack),
                stack.shape[0], n, _ptr(uni), _ptr(sign if mode else None),
                mode, steps, n_steps, bits, _ptr(gt), _ptr(eq))
    return gt, eq
