"""Operand arena: a combined device pool over a group of BitVectors (port of
``bitmagic_tpu/agg/arena.py``).

The reference aggregator keeps operand block lists in arena-allocated lists
(src/bmaggregator.h arg_groups/arena) and its pipeline caches decoded blocks
across hundreds of searches (pipeline_bcache :197).  Here the operand pools
concatenate once into one device tensor; every later group op is a
slot-matrix lookup (host numpy) plus one launch of the K-way sweep (kernel
B4, ``ops/cuda_kernels.agg_and_sub_arena``) that reads each needed 8 KiB
row once and stops a column at zero.

Building the arena costs one device concat.  It pays off when the same
vector group is queried repeatedly: the scanner and pipeline workloads
(``bench.py`` configs 3 and 4).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..config import resolve_device
from ..core.blocks import _B, _F, _G
from ..ops import blockops

_I64 = np.int64


class OperandArena:
    """Combined pool + per-vector structure tables for fast slot lookups.

    The combined device pool is built lazily (first ``.pool`` access):
    succinct-aware pipelines narrow to survivor blocks in the run domain
    and never touch the full arena, so GAP-resident operands only expand
    when a caller sweeps the whole arena."""

    def __init__(self, vectors):
        for v in vectors:
            v._flush()
        self.vectors = list(vectors)
        self.device = (self.vectors[0].device if self.vectors
                       else resolve_device())
        self.row_offset = []
        off = 0
        for v in self.vectors:
            self.row_offset.append(off)
            off += v._struct.n_rows()
        self.gap_offset = []
        for v in self.vectors:
            self.gap_offset.append(off)
            if v._gaps is not None:
                off += v._gaps.n_blocks
        self._pool = None

    @property
    def pool(self) -> torch.Tensor:
        if self._pool is None:
            pools = [v._pool for v in self.vectors if v._struct.n_rows()]
            # GAP blocks expand into extra arena rows (non-mutating: the
            # owning vectors keep their succinct host residency)
            gap_parts = [blockops.to_device_words(v._gaps.to_dense(),
                                                  self.device)
                         for v in self.vectors
                         if v._gaps is not None and v._gaps.n_blocks]
            parts = pools + gap_parts
            self._pool = (torch.cat(parts, dim=0) if parts
                          else blockops.zero_pool(0, self.device))
        return self._pool

    def slot_row(self, vector_index: int, blocklist: np.ndarray,
                 full_as: int) -> np.ndarray:
        """Arena slot per block for one operand: -1 where the operand has no
        payload there.  ``full_as``: what a FULL block maps to (-1 = the
        identity, when FULL was already resolved by the planner)."""
        v = self.vectors[vector_index]
        st, slot = v._struct.lookup(blocklist)
        out = np.where(st == _B, slot + self.row_offset[vector_index], -1)
        out = np.where(st == _G, slot + self.gap_offset[vector_index], out)
        if full_as >= 0:
            out = np.where(st == _F, full_as, out)
        return out.astype(np.int32)

    def slots_matrix(self, indices, blocklist) -> np.ndarray:
        return np.stack([self.slot_row(i, blocklist, -1) for i in indices])


def build_dense_stack(arena: OperandArena):
    """[K, nb_union, 2048] dense operand stack over the union of all block
    ids, with synthetic zero / all-ones rows standing in for absent / FULL
    blocks: the shared input layout of the batched pipeline kernels.
    Returns None when no operand holds any payload."""
    K = len(arena.vectors)
    nb_union = np.unique(np.concatenate(
        [v._flat_nb() for v in arena.vectors] or [np.zeros(0, _I64)]))
    if nb_union.size == 0:
        return None
    pool = arena.pool
    zero_row = int(pool.shape[0])
    ones_row = zero_row + 1
    aug = torch.cat([pool, blockops.zero_pool(1, pool.device),
                     torch.full((1, C.SET_BLOCK_SIZE), -1, dtype=torch.int32,
                                device=pool.device)])
    slot_tab = np.empty((K, nb_union.size), _I64)
    for k in range(K):
        s = arena.slot_row(k, nb_union, full_as=ones_row)
        slot_tab[k] = np.where(s < 0, zero_row, s)
    idx = torch.from_numpy(slot_tab.reshape(-1)).to(pool.device)
    return aug[idx].reshape(K, nb_union.size, C.SET_BLOCK_SIZE)


def operands_succinct(vectors) -> bool:
    """True when the operand group is mostly GAP-resident: the signal to
    prefer survivor-narrowed host assembly over a full device arena."""
    n_gap = sum(v._gaps.n_blocks for v in vectors if v._gaps is not None)
    n_bit = sum(v._struct.n_rows() for v in vectors)
    return n_gap > n_bit


def presence_table(vectors):
    """(nb_union, present int32[K, NB]): the symbolic presence matrix of an
    operand group (state != ZERO per (operand, union block)).  Callers that
    re-narrow many batches over the same operands cache this pair."""
    nb_union = np.unique(np.concatenate(
        [v._flat_nb() for v in vectors] or [np.zeros(0, _I64)]))
    if not vectors or nb_union.size == 0:
        return nb_union, np.zeros((len(vectors), nb_union.size), np.int32)
    present = np.stack([v._struct.lookup(nb_union)[0] != 0
                        for v in vectors]).astype(np.int32)
    return nb_union, present


def narrow_survivors(nb_union, present, sels: np.ndarray):
    """(nb_sel, n_union): survivor blocks of a request batch: a block
    survives iff some request's whole AND group (sels row == 1) is present
    there (the run-domain analog of the aggregator's digest pre-pass,
    src/bmaggregator.h:1764)."""
    need = (sels == 1).astype(np.int32)
    n_need = need.sum(axis=1, keepdims=True)
    got = need @ present
    # all-zero selector rows are requests resolved outside the fused sweep;
    # without the n_need > 0 guard one such row would mark every block
    surv = ((got == n_need) & (n_need > 0)).any(axis=0)
    return nb_union[surv], int(nb_union.size)


def narrowed_union(vectors, sels: np.ndarray):
    """One-shot presence_table + narrow_survivors."""
    nb_union, present = presence_table(vectors)
    if nb_union.size == 0:
        return nb_union, 0
    return narrow_survivors(nb_union, present, sels)


def build_dense_stack_host(vectors, nb_sel: np.ndarray) -> np.ndarray:
    """[K, len(nb_sel), 2048] uint32 dense stack over a chosen block list,
    assembled on the host: the succinct pipeline's narrowed input (memory
    O(survivors), not O(union)).  GAP blocks expand only where selected;
    FULL / absent blocks are synthesised."""
    K = len(vectors)
    out = np.zeros((K, len(nb_sel), C.SET_BLOCK_SIZE), np.uint32)
    for k, v in enumerate(vectors):
        st, slot = v._struct.lookup(nb_sel)
        fm = st == _F
        if fm.any():
            out[k][fm] = C.ALL_ONES_WORD
        bm = st == _B
        if bm.any():
            out[k][bm] = v._pool_host()[slot[bm]]
        gm = st == _G
        if gm.any():
            out[k][gm] = v._gaps.to_dense(slot[gm])
    return out
