"""Wrappers of the three hand-written Hopper kernels (``ops/csrc``).

=====================  ===========================  =========================
wrapper                kernel (source)              replaces (TPU kernel)
=====================  ===========================  =========================
block_counts           K3 block_counts.cu           pallas_kernels.py:146
count_op,              K2 count_op.cu               pallas_kernels.py:118,
count_metrics                                       setops.py:39 (_metric_kernel)
logical_op_digest,     K1 logical_op_digest.cu      pallas_kernels.py:73,
binary_op_digest                                    bitvector.py:43 (_binary_kernel)
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

import torch

from ..constants import BLOCK_WAVES, SET_BLOCK_SIZE
from . import _build, blockops

_I32 = torch.int32
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_OPERAND = [_VP, _INT, _VP, _VP, _VP, _INT, _VP]

launches = {"block_counts": 0, "count_op": 0, "logical_op_digest": 0}

_SIGNATURES = {
    "bm_block_counts": ("block_counts.cu", [_VP, _INT, _VP, _VP]),
    "bm_count_metrics": ("count_op.cu",
                         _OPERAND + _OPERAND + [_INT, _INT, _INT, _VP, _VP]),
    "bm_logical_op_digest": ("logical_op_digest.cu",
                             [_INT] + _OPERAND + _OPERAND
                             + [_INT, _VP, _VP, _VP]),
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


def _check(t, name, dtype, shape_tail=()):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape[1:]) != tuple(shape_tail):
        raise ValueError(f"{name}: expected shape [n, {shape_tail}], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


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
# K3: per-block popcount
# ---------------------------------------------------------------------------
def block_counts(pool):
    """Per-block popcount -> int32[n]."""
    if not _on_cuda(pool):
        return blockops.block_counts(pool)
    _rows(pool, "pool")
    n = pool.shape[0]
    out = torch.empty(n, dtype=_I32, device=pool.device)
    if n:
        _launch("bm_block_counts", "block_counts", pool.device,
                _ptr(pool), n, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# K2: per-block popcount of a OP b / multi-metric, result rows not written
# ---------------------------------------------------------------------------
def _metric_codes(metrics):
    if not 1 <= len(metrics) <= len(blockops.METRICS):
        raise ValueError(f"between 1 and {len(blockops.METRICS)} metrics")
    codes = 0
    for j, m in enumerate(metrics):
        codes |= blockops.METRICS.index(m) << (3 * j)
    return codes


def _count_launch(metrics, a_args, b_args, k, device):
    codes = _metric_codes(metrics)
    out = torch.empty((len(metrics), k), dtype=_I32, device=device)
    if k:
        _launch("bm_count_metrics", "count_op", device, *a_args, *b_args,
                codes, len(metrics), k, _ptr(out))
    return out


def count_op(op, a, b):
    """Per-block popcount of (a OP b) over aligned rows -> int32[n]."""
    if not _on_cuda(a, b):
        return blockops.count_op(op, a, b)
    if a.shape != b.shape:
        raise ValueError("count_op: operands differ in shape")
    return _count_launch((blockops.OP_METRIC[op],), _aligned(a, "a"),
                         _aligned(b, "b"), a.shape[0], a.device)[0]


def count_metrics(metrics, a_desc, b_desc):
    """Per-block popcounts of every requested metric over gather-described
    operands -> int32[len(metrics), k]."""
    if not _on_cuda(*a_desc, *b_desc):
        return blockops.count_metrics(metrics, a_desc, b_desc)
    k = a_desc[1].shape[0]
    return _count_launch(tuple(metrics), _operand(a_desc, k, "a"),
                         _operand(b_desc, k, "b"), k, a_desc[0].device)


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
