"""Wrappers of the six hand-written Hopper kernels (``ops/csrc``).

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
pipeline_counts        B5 pipeline_counts.cu        pallas_kernels.py:428
scan_eq                B6 scan_eq.cu                pallas_kernels.py:310
=====================  ===========================  =========================

Each wrapper runs its kernel's plain PyTorch version (``ops/blockops.py``,
same signature) only when its tensors lie on the CPU.  On CUDA tensors it
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

_I32 = torch.int32
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_OPERAND = [_VP, _INT, _VP, _VP, _VP, _INT, _VP]

_I64 = torch.int64
_LL = ctypes.c_longlong

launches = {"block_counts": 0, "count_op": 0, "logical_op_digest": 0,
            "agg_and_sub": 0, "pipeline_counts": 0, "scan_eq": 0}
# most planes B5 stages per CTA (pipeline_counts.cu: 100 KiB of shared
# memory at 256 bytes per plane and tile)
PIPELINE_MAX_PLANES = 400
# most staged planes B5 keeps in registers (pipeline_counts.cu register
# path); above it the shared-memory path runs
PIPELINE_REG_PLANES = 72

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
    for j, (pool, slot, full, aux, aux_slot) in enumerate(descs):
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
