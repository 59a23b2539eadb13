"""Multi-vector aggregator: fused group operations OR(v1..vN), AND(v1..vN)
and AND(and_group) MINUS OR(sub_group) over large vector groups (port of
``bitmagic_tpu/agg/aggregator.py``).

Equivalent of `bm::aggregator<BV>` (src/bmaggregator.h:121): the reference
evaluates horizontally, for each block position all N source blocks with
digest narrowing (combine_and_sub :1719-1790).  Here:

  * the block work-list is computed on the host from the operand
    structures: AND-group intersection / OR-group union of allocated block
    sets; a missing block in any AND operand kills the column ("golden
    block" early-out, reference :1731), a FULL block on the SUB side too;
  * the device pass is one launch of the K-way sweep kernel B4
    (``ops/cuda_kernels.agg_and_sub``) over the operands' gather
    descriptors: each needed row is read once, and a column stops at zero.
    The JAX package runs the same pass as an XLA fusion (``_agg_kernel``).

The pipeline API (reference :223) batches many AND-SUB searches: counts-only
batches are one launch of kernel B5 over a dense operand stack, result
batches one launch of B4's batched form over the same stack.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np
import torch

from .. import constants as C
from ..core.bitvector import BitVector
from ..core.blocks import _B, _F, _G, Structure
from ..ops import blockops
from ..ops import cuda_kernels as ck

_I64 = np.int64


def _structures(vectors):
    """Flushed raw structures, not materialized: every consumer reads them
    through the run-aware lookup() or the run-aware blocklist helpers, so
    wide FULL runs stay interval-coded end to end."""
    for v in vectors:
        v._flush()
    return [v._struct for v in vectors]


def _and_blocklist(structs):
    """Intersection of operand block sets.  The flat candidate list comes
    from the smallest operand only (bounded materialization); the others
    restrict it via the run-aware lookup."""
    if not structs:
        return np.zeros(0, _I64)
    base = min(structs, key=lambda s: len(s.nb) + s.run_block_count())
    nb = base.materialized().nb if base.has_runs else base.nb
    for s in structs:
        if s is base or nb.size == 0:
            continue
        st, _ = s.lookup(nb)
        nb = nb[st != 0]
    return nb


def _or_blocklist(structs):
    """Union of operand block sets (runs expand, bounded: combine_or routes
    run-coded operands through the symbolic left-fold first)."""
    if not structs:
        return np.zeros(0, _I64)
    return functools.reduce(
        np.union1d,
        ((s.materialized().nb if s.has_runs else s.nb) for s in structs))


def _union_sorted(a, b):
    """``np.union1d`` of two sorted arrays of unique ids, by one sort (no
    hash of the values)."""
    c = np.concatenate([a, b])
    c.sort()
    keep = np.ones(c.size, bool)
    keep[1:] = c[1:] != c[:-1]
    return c[keep]


def _operand_descs(vectors, blocklist):
    """Gather descriptors ``(pool, slot, full, aux, aux_slot)`` of every
    vector on ``blocklist`` (the per-vector ``core/blocks.operand_args``
    batched): a vector that repeats (a Bitap pattern's letter) is looked
    up once and its descriptor is the same tuple; the slot, aux-slot and
    FULL rows of the distinct vectors go up in one copy, and the GAP
    blocks of all of them are expanded on the device by one
    ``gap_expand_many`` launch into one aux tensor that their descriptors
    share (``aux`` and ``aux_slot`` None for a vector with no GAP block on
    the list)."""
    first = {}
    for v in vectors:
        first.setdefault(id(v), v)
    distinct = list(first.values())
    D, k = len(distinct), int(blocklist.size)
    ints = np.full((2, D, k), -1, np.int32)         # slot, aux_slot
    full = np.zeros((D, k), bool)
    dev = vectors[0].device
    mirrors, sel, gapped, n_aux = [], [], [], 0
    for i, v in enumerate(distinct):
        st, sl = v._struct.lookup(blocklist)
        ints[0, i] = np.where(st == _B, sl, -1)
        full[i] = st == _F
        gap = st == _G
        if gap.any():
            used = np.unique(sl[gap])
            ints[1, i] = np.where(gap, np.searchsorted(
                used, np.where(gap, sl, used[0])) + n_aux, -1)
            mirrors.append(v._gaps.device_arrays(dev))
            sel.append(used)
            gapped.append(i)
            n_aux += used.size
    aux = ck.gap_expand_many(mirrors, sel) if mirrors else None
    host = np.concatenate([ints.view(np.uint8).ravel(),
                           full.view(np.uint8).ravel()])
    buf = torch.empty(host.size, dtype=torch.uint8, device=dev)
    buf.copy_(torch.from_numpy(host))
    ints_d = buf[:ints.nbytes].view(torch.int32).view(2, D, k)
    full_d = buf[ints.nbytes:].view(torch.bool).view(D, k)
    gapped = set(gapped)
    descs = {id(v): (v._pool, ints_d[0, i], full_d[i],
                     aux if i in gapped else None,
                     ints_d[1, i] if i in gapped else None)
             for i, v in enumerate(distinct)}
    return [descs[id(v)] for v in vectors]


def _agg_kernel(n_and, n_sub, descs):
    """AND(and rows) & ~OR(sub rows) in one B4 launch; ``n_and = 0`` is the
    OR of the rows (bitmagic_tpu ``_agg_kernel(0, n)``, used by
    combine_or)."""
    return ck.agg_and_sub(n_and, descs, or_mode=(n_and == 0))[0]


def _agg_any_kernel(n_and, n_sub, descs):
    """Per-block popcounts of AND(and rows) & ~OR(sub rows): the early-exit
    probe, int32[n_blocks]; no result rows are written (B4 rows-off)."""
    return ck.agg_and_sub(n_and, descs, rows=False, counts=True)[1]


def _shift_and_chain(first_mask, descs):
    """acc = rows0; acc = shift_up1(acc) & rows_k over the whole chain, in
    one launch of kernel B8 (``cuda_kernels.shift_and_chain``; its plain
    closed form on the CPU; bitmagic_tpu runs this as an XLA scan, not a
    Pallas kernel).  The shift carries bits across words and blocks by
    viewing the block list as one flat bit string; ``first_mask``
    (int32[n_blocks]) clears bit 0 of each block's first word when its
    list predecessor is not its address predecessor."""
    return ck.shift_and_chain(first_mask, descs)


class OperationStatus(enum.IntEnum):
    """Staged-execution states (reference aggregator::operation_status,
    src/bmaggregator.h:147-153)."""
    op_undefined = 0
    op_prepared = 1
    op_in_progress = 2
    op_done = 3


BM_NOT_DEFINED = 0      # reference aggregator::operation (src/bmaggregator.h:141)
BM_SHIFT_R_AND = 1


@dataclasses.dataclass
class AggOptions:
    """Run options (reference agg_run_options, src/bmaggregator.h:65):
    counts-only / masks-only modes for pipelines, plus the reference
    pipeline knobs (set_or_target / set_search_count_limit,
    src/bmaggregator.h:251/260)."""
    make_results: bool = True
    compute_counts: bool = False
    or_target: object = None            # BitVector to OR all results into
    search_count_limit: int | None = None

    def set_compute_count(self, count_mode: bool = True):
        """reference pipeline set_compute_count (src/bmaggregator.h:363)."""
        self.compute_counts = bool(count_mode)
        self.make_results = not count_mode
        return self

    def set_or_target(self, bv_or):
        self.or_target = bv_or
        return self

    def set_search_count_limit(self, limit):
        self.search_count_limit = None if limit is None else int(limit)
        return self


def _fold(vectors, size, op_and=True, sub=()):
    """Left-fold through the run-aware planner (run-coded or succinct
    groups): the result keeps wide spans interval-coded and GAP blocks
    succinct.  Never aliases an input."""
    acc = vectors[0]
    for v in vectors[1:]:
        acc = (acc & v) if op_and else (acc | v)
    for v in sub:
        acc = acc - v
    if acc is vectors[0]:
        acc = acc.copy()
    if acc.size != size:
        acc.resize(size)
    return acc


class Aggregator:
    """Group set operations over vector lists (bm::aggregator equivalent).

    Supports both the functional style (pass vector lists directly) and the
    reference's stateful style: ``add(bv[, group])`` then ``combine_*()``
    with no arguments (reference aggregator::add, src/bmaggregator.h:391).
    Group 0 = AND/OR arguments, group 1 = SUB arguments.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        """Clear added argument groups (reference reset, :386, which also
        calls reset_range_hint, src/bmaggregator.h:941-946)."""
        self._groups = ([], [])
        self._operation = BM_NOT_DEFINED
        self._op_status = OperationStatus.op_undefined
        self._op_k = 0
        self._bv_target: BitVector | None = None
        self._range_hint = None

    def add(self, bv, group: int = 0) -> int:
        self._groups[group].append(bv)
        return len(self._groups[group])

    # ------------------------------------------------------------------
    # staged execution (reference pipeline-operations API,
    # src/bmaggregator.h:595-622 + the interleaved run_step pattern at
    # :867-898): set_operation -> stage -> run_step*
    # ------------------------------------------------------------------
    def set_operation(self, op_code: int):
        """src/bmaggregator.h:609."""
        if op_code not in (BM_NOT_DEFINED, BM_SHIFT_R_AND):
            raise ValueError(f"unknown aggregator operation {op_code}")
        self._operation = op_code
        return self

    def get_operation(self) -> int:
        """src/bmaggregator.h:606."""
        return self._operation

    def get_operation_status(self) -> OperationStatus:
        """src/bmaggregator.h:622."""
        return self._op_status

    def get_target(self) -> BitVector | None:
        """Result vector of the staged operation (src/bmaggregator.h:623)."""
        return self._bv_target

    def stage(self, temp_block=None):
        """Prepare the staged operation (src/bmaggregator.h:615).  Steps go
        per operand (each one full-width device op), not per (i, j) block
        pair."""
        if self._operation != BM_SHIFT_R_AND:
            raise ValueError("set_operation(BM_SHIFT_R_AND) first")
        if not self._groups[0]:
            raise ValueError("no argument vectors added")
        self._op_k = 0
        self._bv_target = None
        self._op_status = OperationStatus.op_prepared
        return self

    def run_step(self, i: int | None = None, j: int | None = None
                 ) -> OperationStatus:
        """One step of the staged operation (src/bmaggregator.h:620).  The
        (i, j) coordinates are accepted for signature parity and ignored:
        steps are operand-ordered (see stage())."""
        if self._op_status not in (OperationStatus.op_prepared,
                                   OperationStatus.op_in_progress):
            raise RuntimeError("stage() the operation first")
        vecs = self._groups[0]
        if self._op_k == 0:
            self._bv_target = vecs[0].copy()
        else:
            self._bv_target.shift_right()
            self._bv_target.bit_and(vecs[self._op_k])
        self._op_k += 1
        self._op_status = (OperationStatus.op_done
                           if self._op_k >= len(vecs)
                           else OperationStatus.op_in_progress)
        return self._op_status

    def run(self, i_from: int = 0, j_from: int = 0) -> OperationStatus:
        """Run the staged operation to completion (src/bmaggregator.h:618)
        as one fused chain (combine_shift_right_and); stepping is only for
        interleaving."""
        if self._op_status == OperationStatus.op_undefined:
            self.stage()
        if self._op_status == OperationStatus.op_prepared \
                and self._op_k == 0:
            self._bv_target = self.combine_shift_right_and(self._groups[0])
            self._op_k = len(self._groups[0])
            self._op_status = OperationStatus.op_done
            return self._op_status
        while self._op_status != OperationStatus.op_done:
            self.run_step()
        return self._op_status

    def combine_or(self, vectors=None) -> BitVector:
        """OR(v1..vN) (reference combine_or, src/bmaggregator.h:404)."""
        if vectors is None:
            vectors = self._groups[0]
        if not vectors:
            return BitVector(0)
        size = max(v.size for v in vectors)
        for v in vectors:
            v._flush()
        if any(v._struct.has_runs for v in vectors):
            return _fold(vectors, size, op_and=False)
        structs = _structures(vectors)
        nb = _or_blocklist(structs)
        dev = vectors[0].device
        if nb.size == 0:
            return BitVector(size, device=dev)
        if len(vectors) > 1 and self._all_succinct(vectors, nb):
            return _fold(vectors, size, op_and=False)
        # blocks where any operand is FULL are FULL
        full_any = np.zeros(nb.size, bool)
        for s in structs:
            st, _ = s.lookup(nb)
            full_any |= st == _F
        kern_nb = nb[~full_any]
        pool = (_agg_kernel(0, len(vectors), _operand_descs(vectors, kern_nb))
                if kern_nb.size else None)
        return _assemble(nb, full_any, pool, size, dev)

    @staticmethod
    def _all_succinct(vectors, nb) -> bool:
        """True when no operand holds a dense row on any listed block: the
        whole group op can fold in the run domain (host)."""
        for v in vectors:
            st, _ = v._struct.lookup(nb)
            if (st == _B).any():
                return False
        return True

    def combine_and(self, vectors=None) -> BitVector:
        """AND(v1..vN) (reference combine_and, src/bmaggregator.h:412)."""
        if vectors is None:
            vectors = self._groups[0]
        if not vectors:
            return BitVector(0)
        size = max(v.size for v in vectors)
        structs = _structures(vectors)
        try:
            nb = _and_blocklist(structs)
        except MemoryError:
            # every operand is wide-run-coded: fold through the planner
            return _fold(vectors, size)
        dev = vectors[0].device
        if nb.size == 0:
            return BitVector(size, device=dev)
        if len(vectors) > 1 and self._all_succinct(vectors, nb):
            return _fold(vectors, size)
        full_all = np.ones(nb.size, bool)
        for s in structs:
            st, _ = s.lookup(nb)
            full_all &= st == _F
        kern_nb = nb[~full_all]
        pool = (_agg_kernel(len(vectors), 0, _operand_descs(vectors, kern_nb))
                if kern_nb.size else None)
        return _assemble(nb, full_all, pool, size, dev)

    # -- range hint (reference set_range_hint, src/bmaggregator.h:481) --
    def set_range_hint(self, from_, to) -> bool:
        """Block-granular search range restriction for combine_and_sub /
        find_first_and_sub (reference set_range_hint,
        src/bmaggregator.h:481).  Returns True when the range is one-block
        bound."""
        lo, hi = int(from_), int(to)
        if lo > hi:
            lo, hi = hi, lo
        self._range_hint = (lo, hi)
        return (lo >> C.SET_BLOCK_SHIFT) == (hi >> C.SET_BLOCK_SHIFT)

    def reset_range_hint(self) -> None:
        """src/bmaggregator.h:486."""
        self._range_hint = None

    def _apply_range_hint(self, nb: np.ndarray) -> np.ndarray:
        if self._range_hint is None or nb.size == 0:
            return nb
        lo, hi = self._range_hint
        return nb[(nb >= (lo >> C.SET_BLOCK_SHIFT))
                  & (nb <= (hi >> C.SET_BLOCK_SHIFT))]

    # -- target optimize mode (reference set_optimization) ---------------
    _opt_mode = False

    def set_optimization(self, opt=True) -> None:
        """Request optimize() (block re-classification) on every combine_*
        target before it is returned (reference set_optimization)."""
        self._opt_mode = bool(opt)

    def _maybe_optimize(self, bv: BitVector) -> BitVector:
        if self._opt_mode:
            bv.optimize()
        return bv

    def _groups_of(self, and_group, sub_group):
        if and_group is None:
            and_group = self._groups[0]
        if sub_group is None:
            sub_group = self._groups[1] if and_group is self._groups[0] else ()
        return list(and_group), list(sub_group)

    def combine_and_sub(self, and_group=None, sub_group=None) -> BitVector:
        """AND(and_group) MINUS OR(sub_group): the reference's flagship
        fused search op (combine_and_sub, src/bmaggregator.h:420)."""
        and_group, sub_group = self._groups_of(and_group, sub_group)
        if not and_group:
            return BitVector(0)
        sa = _structures(and_group)
        ss = _structures(sub_group)
        size = max(v.size for v in and_group + sub_group)
        dev = and_group[0].device
        try:
            nb = self._apply_range_hint(_and_blocklist(sa))
        except MemoryError:
            # all-run-coded AND group: symbolic fold (see combine_and)
            acc = and_group[0].copy()
            for v in and_group[1:]:
                acc.bit_and(v)
            for v in sub_group:
                acc.bit_sub(v)
            if acc.size != size:
                acc.resize(size)
            return acc
        if nb.size == 0:
            return BitVector(size, device=dev)
        # drop blocks where any SUB operand is FULL (result zero there)
        keep = np.ones(nb.size, bool)
        for s in ss:
            st, _ = s.lookup(nb)
            keep &= st != _F
        nb = nb[keep]
        if nb.size == 0:
            return BitVector(size, device=dev)
        # FULL result only if every AND op is FULL and no SUB bits exist
        full_all = np.ones(nb.size, bool)
        for s in sa:
            st, _ = s.lookup(nb)
            full_all &= st == _F
        sub_absent = np.ones(nb.size, bool)
        for s in ss:
            st, _ = s.lookup(nb)
            sub_absent &= st == 0
        pure_full = full_all & sub_absent
        kern_nb = nb[~pure_full]
        if kern_nb.size and self._all_succinct(and_group + sub_group,
                                               kern_nb):
            # sparse group: run-domain fold (no expansion, succinct result)
            return _fold(and_group, size, sub=sub_group)
        pool = None
        if kern_nb.size:
            pool = _agg_kernel(len(and_group), len(sub_group),
                               _operand_descs(and_group + sub_group, kern_nb))
        return _assemble(nb, pure_full, pool, size, dev)

    def find_first_and_sub(self, and_group=None, sub_group=None) -> int:
        """First bit of the AND-SUB result, -1 if none (reference
        find_first_and_sub with per-block early exit,
        src/bmaggregator.h:460).  One B4 pass computes per-block popcounts
        only (no result rows are written or fetched); the first hit block
        alone is then computed and scanned."""
        and_group, sub_group = self._groups_of(and_group, sub_group)
        if not and_group:
            return -1
        sa = _structures(and_group)
        ss = _structures(sub_group)
        try:
            nb = self._apply_range_hint(_and_blocklist(sa))
        except MemoryError:
            acc = and_group[0].copy()
            for v in and_group[1:]:
                acc.bit_and(v)
            for v in sub_group:
                acc.bit_sub(v)
            return acc.find(0)
        if nb.size == 0:
            return -1
        keep = np.ones(nb.size, bool)
        for s in ss:
            st, _ = s.lookup(nb)
            keep &= st != _F
        nb = nb[keep]
        if nb.size == 0:
            return -1
        ops = and_group + sub_group
        flags = _agg_any_kernel(len(and_group), len(sub_group),
                                _operand_descs(ops, nb)).cpu().numpy()
        hits = np.flatnonzero(flags)
        # with a range hint the edge blocks need a bit-precise scan (the
        # reference installs a precise filter for the one-block case,
        # src/bmaggregator.h:974-987/2006-2011): walk hit blocks until a
        # real in-range bit
        for k in hits:
            k = int(k)
            one = nb[k: k + 1]
            row = blockops.to_host_words(_agg_kernel(
                len(and_group), len(sub_group), _operand_descs(ops, one)))[0]
            bits = np.unpackbits(row.view(np.uint8), bitorder="little")
            base = int(nb[k]) << C.SET_BLOCK_SHIFT
            if self._range_hint is not None:
                lo, hi = self._range_hint
                lo_in = max(lo - base, 0)
                hi_in = min(hi - base, C.BITS_PER_BLOCK - 1)
                if hi_in < lo_in:
                    continue
                nz = np.flatnonzero(bits[lo_in:hi_in + 1])
                if nz.size == 0:
                    continue
                return base + lo_in + int(nz[0])
            nz = np.flatnonzero(bits)
            if nz.size:
                return base + int(nz[0])
        return -1

    def combine_shift_right_and(self, vectors) -> BitVector:
        """Bitap-style fingerprint combine: acc = v0; acc = (acc shifted one
        position up) & v[k] for k = 1..N-1 (reference
        combine_shift_right_and, src/bmaggregator.h:510; DNA-search sample
        06/xsample04).  The block list is narrowed first: a final hit at
        block B needs every operand present in {B-1, B} (total shift drift
        is N-1 < 2^16 bits), so only those candidates plus their address
        predecessors (the carry history) materialize."""
        vectors = list(vectors)
        if not vectors:
            return BitVector(0)
        for v in vectors:
            v._flush()
        size = max(v.size for v in vectors)
        dev = vectors[0].device
        # materialize runs once per vector (a letter repeats in a pattern)
        distinct = {}
        flat = [distinct[id(v)] if id(v) in distinct
                else distinct.setdefault(id(v), v._flat_nb())
                for v in vectors]
        nbs = [x for x in flat if len(x)]
        if not nbs or not len(flat[0]):
            return BitVector(size, device=dev)
        hi = min(int(max(x[-1] for x in nbs)) + 1,      # shift spill
                 (size - 1) >> C.SET_BLOCK_SHIFT)
        if len(vectors) - 1 <= C.BITS_PER_BLOCK:
            cand = None
            for nbv in distinct.values():
                ext = _union_sorted(nbv, nbv + 1)
                cand = ext if cand is None else np.intersect1d(
                    cand, ext, assume_unique=True)
            blocklist = _union_sorted(cand - 1, cand)
            blocklist = blocklist[(blocklist >= 0) & (blocklist <= hi)]
        else:
            # chains longer than one block's bits can drift further: keep
            # the contiguous covering range
            lo = int(min(x[0] for x in nbs))
            blocklist = np.arange(lo, hi + 1, dtype=_I64)
        if blocklist.size == 0:
            return BitVector(size, device=dev)
        adj = np.empty(blocklist.size, bool)
        adj[0] = False
        adj[1:] = blocklist[1:] == blocklist[:-1] + 1
        # block 0 of the list has no carry-in by construction; only true
        # gaps need their first bit cleared after each shift
        first_mask = np.where(adj | (np.arange(blocklist.size) == 0),
                              np.uint32(0xFFFFFFFF), np.uint32(0xFFFFFFFE))
        pool = _shift_and_chain(
            torch.from_numpy(first_mask.view(np.int32)).to(dev),
            _operand_descs(vectors, blocklist))
        res = BitVector._from_parts(
            Structure(blocklist.astype(_I64).copy(),
                      np.full(blocklist.size, C.CLS_BIT, np.uint8)),
            pool, size)
        res._drop_trailing(size)
        res.optimize(C.OPT_FREE_01)
        return res

    # ------------------------------------------------------------------
    # arena path: the K-way sweep over a combined operand pool (see
    # agg/arena.py and kernel B4)
    # ------------------------------------------------------------------
    def combine_and_sub_arena(self, arena, and_idx, sub_idx=()) -> BitVector:
        """AND-SUB over vectors addressed by index into an OperandArena: one
        B4 launch in arena form reads each needed block once and stops a
        column at zero."""
        and_idx = list(and_idx)
        sub_idx = list(sub_idx)
        if not and_idx:
            return BitVector(0)
        structs = [arena.vectors[i]._struct for i in and_idx]
        nb = _and_blocklist(structs)
        size = max(arena.vectors[i].size for i in and_idx + sub_idx)
        dev = arena.device
        if nb.size == 0:
            return BitVector(size, device=dev)
        # a FULL SUB operand kills the block (the kernel's identity for a
        # missing SUB row is zero, which would be wrong for FULL)
        keep = np.ones(nb.size, bool)
        for i in sub_idx:
            st, _ = arena.vectors[i]._struct.lookup(nb)
            keep &= st != _F
        nb = nb[keep]
        if nb.size == 0:
            return BitVector(size, device=dev)
        slots = arena.slots_matrix(and_idx + sub_idx, nb)
        pool = ck.agg_and_sub_arena(len(and_idx), len(sub_idx),
                                    torch.from_numpy(slots).to(dev),
                                    arena.pool)
        cls = np.full(nb.size, C.CLS_BIT, np.uint8)
        return BitVector._from_parts(Structure(nb.copy(), cls), pool, size)

    # ------------------------------------------------------------------
    # pipeline (reference aggregator::pipeline, src/bmaggregator.h:223):
    # batch many AND-SUB searches with a shared block cache
    # ------------------------------------------------------------------
    def pipeline(self, requests, options: AggOptions = AggOptions()):
        """Run a batch of (and_group, sub_group) AND-SUB searches.

        Returns a list of per-request results: BitVectors (make_results)
        and/or counts (compute_counts).  Counts-only batches run as one B5
        launch over the dense operand stack (the reference pipeline's shared
        block cache, src/bmaggregator.h:197, as a kernel); result batches as
        one launch of B4's batched form over the same stack; the rest as
        per-request combines."""
        norm = [((*req, ())[:2] if isinstance(req, tuple) else (req, ()))
                for req in requests]
        lim = options.search_count_limit

        def _cap(c):
            return c if lim is None else min(c, lim)

        if (options.compute_counts and not options.make_results
                and options.or_target is None
                and len(norm) > 1 and all(len(a) for a, _ in norm)):
            counts = self._pipeline_counts_fused(norm)
            if counts is not None:
                return [{"count": _cap(int(c))} for c in counts]
        if (options.make_results and options.or_target is None
                and lim is None and len(norm) > 1
                and all(len(a) for a, _ in norm)):
            out = self._pipeline_results_fused(norm, options)
            if out is not None:
                return out
        out = []
        for and_g, sub_g in norm:
            bv = self.combine_and_sub(and_g, sub_g)
            if options.or_target is not None:
                options.or_target.bit_or(bv)
            entry = {}
            if options.make_results:
                entry["bv"] = bv
            if options.compute_counts:
                entry["count"] = _cap(bv.count())
            out.append(entry)
        return out

    # device-memory budget for the fused result-mode output [V, nb, 2048]
    _PIPE_RESULT_BUDGET_BYTES = 1 << 30

    @staticmethod
    def _selectors(norm):
        """(operands, sels int32[V, K], forced_zero bool[V]) of a request
        batch: 1 = AND, -1 = AND-NOT per distinct operand."""
        operands, index_of = [], {}
        for and_g, sub_g in norm:
            for v in (*and_g, *sub_g):
                if id(v) not in index_of:
                    index_of[id(v)] = len(operands)
                    operands.append(v)
        for v in operands:
            v._flush()
        sels = np.zeros((len(norm), len(operands)), np.int32)
        forced_zero = np.zeros(len(norm), bool)
        for i, (and_g, sub_g) in enumerate(norm):
            for v in and_g:
                sels[i, index_of[id(v)]] = 1
            for v in sub_g:
                k = index_of[id(v)]
                if sels[i, k] == 1:
                    # same vector ANDed and subtracted: x & ~x == 0; the
                    # selector can hold only one role per operand
                    forced_zero[i] = True
                sels[i, k] = -1
        return operands, sels, forced_zero

    def _pipeline_results_fused(self, norm, options):
        """Result-producing pipeline over one shared dense operand stack
        (reference agg_run_options result mode, src/bmaggregator.h:65-103):
        one launch of B4's batched form (bitmagic_tpu
        ``_pipeline_results_kernel``) writes every request's AND-SUB rows
        and their per-block counts from one uploaded request table.  Returns None when the fused path does not apply
        (no payload, or output over budget)."""
        from .arena import (OperandArena, build_dense_stack,
                            build_dense_stack_host, narrowed_union,
                            operands_succinct)
        operands, sels, forced_zero = self._selectors(norm)
        V = len(norm)
        dev = operands[0].device
        if operands_succinct(operands):
            # survivor-narrowed: only blocks some request can hit expand
            # (host side); memory O(survivors), not O(union)
            nb_union, n_u = narrowed_union(operands, sels)
            if n_u == 0:
                return None
            if V * nb_union.size * C.SET_BLOCK_SIZE * 4 \
                    > self._PIPE_RESULT_BUDGET_BYTES:
                return None
            if nb_union.size == 0:
                size = max(v.size for v in operands)
                return [dict(
                    **({"bv": BitVector(size, device=dev)}
                       if options.make_results else {}),
                    **({"count": 0} if options.compute_counts else {}))
                    for _ in range(V)]
            planes = blockops.to_device_words(
                build_dense_stack_host(operands, nb_union), dev)
        else:
            planes = build_dense_stack(OperandArena(operands))
            if planes is None:
                return None
            nb_union = np.unique(np.concatenate(
                [v._flat_nb() for v in operands]))
            if V * nb_union.size * C.SET_BLOCK_SIZE * 4 \
                    > self._PIPE_RESULT_BUDGET_BYTES:
                return None
        rows, counts = ck.agg_and_sub_batch(
            [(planes[k], None, None, None, None)
             for k in range(planes.shape[0])],
            *blockops.selector_requests(sels), counts=True)
        counts = counts.sum(dim=1, dtype=torch.int64).cpu().numpy()
        size = max(v.size for v in operands)
        out = []
        cls = np.full(nb_union.size, C.CLS_BIT, np.uint8)
        for i in range(V):
            entry = {}
            if forced_zero[i]:
                bv = BitVector(size, device=dev)
                cnt = 0
            else:
                bv = BitVector._from_parts(
                    Structure(nb_union.copy(), cls.copy()), rows[i], size)
                cnt = int(counts[i])
            if options.make_results:
                entry["bv"] = bv
            if options.compute_counts:
                entry["count"] = cnt
            out.append(entry)
        return out

    def _pipeline_counts_fused(self, norm):
        """Counts for a request batch in one B5 launch, or None when the
        fused path does not apply (empty universe, or more distinct
        operands than the kernel stages)."""
        from .arena import (OperandArena, build_dense_stack,
                            build_dense_stack_host, narrowed_union,
                            operands_succinct)
        operands, sels, forced_zero = self._selectors(norm)
        if len(operands) > ck.PIPELINE_MAX_PLANES:
            return None
        if operands_succinct(operands):
            nb_sel, n_u = narrowed_union(operands, sels)
            if n_u == 0:
                return None
            if nb_sel.size == 0:
                return np.zeros(len(norm), np.int64)
            planes = blockops.to_device_words(
                build_dense_stack_host(operands, nb_sel), operands[0].device)
        else:
            planes = build_dense_stack(OperandArena(operands))
            if planes is None:
                return None
        counts = ck.pipeline_counts(planes, sels).cpu().numpy()
        counts[forced_zero] = 0
        return counts


def _optimized(fn):
    """Honor set_optimization() on combine_* targets (reference aggregator
    set_optimization)."""
    @functools.wraps(fn)
    def wrap(self, *a, **kw):
        return self._maybe_optimize(fn(self, *a, **kw))
    return wrap


def _range_hinted(fn):
    """Enforce the range hint on the combine_and_sub result regardless of
    internal path (the succinct run-domain fold ignores the block-list
    narrowing).  One-block hints are bit-precise, matching the reference's
    gap_init_range_block filter (src/bmaggregator.h:974-987, 2006-2011);
    wider hints stay block-granular like the reference."""
    @functools.wraps(fn)
    def wrap(self, *a, **kw):
        out = fn(self, *a, **kw)
        rh = self._range_hint
        if rh is not None and isinstance(out, BitVector) and out.size:
            lo, hi = rh
            blo, bhi = lo >> C.SET_BLOCK_SHIFT, hi >> C.SET_BLOCK_SHIFT
            if blo == bhi:
                lo2, hi2 = lo, min(hi, out.size - 1)
            else:
                lo2 = blo << C.SET_BLOCK_SHIFT
                hi2 = min(((bhi + 1) << C.SET_BLOCK_SHIFT) - 1, out.size - 1)
            if hi2 < lo2:
                out.clear()
            else:
                out.keep_range(lo2, hi2)
        return out
    return wrap


Aggregator.combine_and_sub = _range_hinted(Aggregator.combine_and_sub)

for _n in ("combine_or", "combine_and", "combine_and_sub",
           "combine_shift_right_and"):
    setattr(Aggregator, _n, _optimized(getattr(Aggregator, _n)))

# Reference C-style "horizontal" entry points (src/bmaggregator.h:2216+).
# The horizontal/vertical split is a CPU cache-blocking evaluation-order
# detail; the fused device pass computes the same result either way.
Aggregator.combine_or_horizontal = Aggregator.combine_or
Aggregator.combine_and_horizontal = Aggregator.combine_and
Aggregator.combine_and_sub_horizontal = Aggregator.combine_and_sub


def _assemble(nb, full_mask, pool, size, device):
    """The result BitVector from FULL blocks + kernel rows (``pool`` holds
    one row per non-FULL entry of ``nb``, or is None when there is none)."""
    cls = np.where(full_mask, C.CLS_FULL, C.CLS_BIT).astype(np.uint8)
    if pool is None:
        keep = full_mask
        return BitVector._from_parts(
            Structure(nb[keep].copy(), cls[keep].copy()),
            blockops.zero_pool(0, device), size)
    return BitVector._from_parts(Structure(nb.copy(), cls), pool, size)


# module-level convenience instance (the reference is also used as a
# stateless engine most of the time)
aggregator = Aggregator()


def aggregator_pipeline_execute(aggregators):
    """Interleaved execution of several staged aggregators (reference free
    function aggregator_pipeline_execute, src/bmaggregator.h:874): stage
    every aggregator, then round-robin run_step until all report op_done.
    Each aggregator's result is then available via get_target()."""
    aggs = list(aggregators)
    for a in aggs:
        a.stage()
    pending = set(range(len(aggs)))
    while pending:
        done = set()
        for k in pending:
            st = aggs[k].run_step()
            if st == OperationStatus.op_done:
                done.add(k)
        pending -= done
    return aggs
