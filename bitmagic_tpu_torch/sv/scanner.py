"""Index-free equality search on bit-sliced succinct vectors in compressed
form (port of the equality part of ``bitmagic_tpu/sv/scanner.py``).

Equivalent of `bm::sparse_vector_scanner<SV>` (src/bmsparsevec_algo.h:612):

  * find_eq(value): decompose the value into 1-bits (AND slice group) and
    0-bits (SUB slice group) and run one aggregator AND-SUB pass
    (prepare_and_sub_aggregator :2286-2324 -> combine_and_sub), on the card
    one launch of the K-way sweep kernel B4;
  * find_zero / find_nonzero (:1055-1082), find_ne, invert, find_eq_set;
  * the pipeline API batches many find_eq searches (reference scanner
    pipeline :653 feeding the aggregator pipeline): counts run as one
    launch of kernel B5 over the dense plane stack, result batches as one
    B4 launch per value in arena form.

Unlike the JAX package, which takes the fused pipeline routes only where
Pallas is enabled, the port always takes them: the kernel on the card, the
plain version on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import constants as C
from ..agg.aggregator import Aggregator
from ..core.bitvector import BitVector, _range_vector
from ..ops import blockops
from ..ops import cuda_kernels as ck
from .sparse_vector import SparseVector, value_fits

_agg = Aggregator()


def _empty(sv: SparseVector) -> BitVector:
    return BitVector(C.ID_MAX48, device=sv.device)


def _universe(sv: SparseVector) -> BitVector:
    """Positions that hold assigned values: the NULL plane if nullable, else
    the full range [0, size)."""
    if sv.nullable:
        return sv.null_plane
    u = _empty(sv)
    if sv._size:
        u.set_range(0, sv._size - 1)
        u.optimize()
    return u


def _u_of(sv: SparseVector, value) -> int:
    return int(np.asarray(sv.s2u(np.asarray([value], sv.dtype)))[0])


def _eq_groups(sv: SparseVector, u: int):
    """(and_group, sub_group) planes of value code ``u``, or None when a
    required 1-bit has no plane (no element can match)."""
    and_group, sub_group = [], []
    for s in range(sv.n_slices):
        p = sv.planes[s]
        if (u >> s) & 1:
            if p is None:
                return None
            and_group.append(p)
        elif p is not None:
            sub_group.append(p)
    return and_group, sub_group


class SparseVectorScanner:
    """bm::sparse_vector_scanner equivalent (equality searches)."""

    #: external AND mask applied to every find_* result
    #: (reference set_and_mask, src/bmsparsevec_algo.h:1124)
    _and_mask = None

    def set_and_mask(self, bv_mask: BitVector | None) -> None:
        """Restrict subsequent find_* searches to positions set in
        ``bv_mask`` (reference set_and_mask, src/bmsparsevec_algo.h:1124;
        the reference seeds the aggregator's AND group with the mask, here
        it ANDs into the finalized result: same answer).  ``None`` resets.
        Pipelines are unaffected."""
        self._and_mask = bv_mask

    def reset_and_mask(self) -> None:
        self._and_mask = None

    #: closed-range restriction, held lazily as an (lo, hi) pair; results
    #: are trimmed with the block-narrowed keep_range (reference
    #: set_search_range, src/bmsparsevec_algo.h:1238)
    _search_range = None

    def set_search_range(self, from_, to) -> None:
        """Restrict subsequent find_* searches to the closed range
        [from, to] (reference set_search_range,
        src/bmsparsevec_algo.h:1238).  Composes with set_and_mask."""
        lo, hi = int(from_), int(to)
        if lo > hi:
            lo, hi = hi, lo
        self._search_range = (lo, hi)

    def reset_search_range(self) -> None:
        """src/bmsparsevec_algo.h:1241."""
        self._search_range = None

    def _range_operand(self, and_group) -> None:
        """Append the search range as an AND operand for the find-first
        paths, narrowed to the first operand's own blocks (absent blocks
        contribute nothing to an AND)."""
        if self._search_range is None or not and_group:
            return
        lo, hi = self._search_range
        and_group.append(_range_vector(lo, hi, C.ID_MAX48,
                                       and_group[0].device,
                                       within=and_group[0]._struct))

    # ------------------------------------------------------------------
    def find_zero(self, sv: SparseVector) -> BitVector:
        """Positions with value 0 (assigned, if nullable): reference
        find_zero (src/bmsparsevec_algo.h:1055)."""
        sv._flush()
        uni = _universe(sv)
        nz = self.find_nonzero(sv)
        return uni - nz

    def find_nonzero(self, sv: SparseVector) -> BitVector:
        """OR of all value slices (reference find_nonzero, :1082)."""
        sv._flush()
        ps = [p for p in sv.planes if p is not None]
        if not ps:
            return _empty(sv)
        return _agg.combine_or(ps)

    # ------------------------------------------------------------------
    def find_eq(self, sv: SparseVector, value) -> BitVector:
        """All positions holding exactly ``value`` (reference find_eq,
        src/bmsparsevec_algo.h:776)."""
        sv._flush()
        if not value_fits(value, sv.dtype):
            return _empty(sv)              # unrepresentable: never matches
        u = _u_of(sv, value)
        if u == 0:
            return self.find_zero(sv)
        if u.bit_length() > sv.n_slices:
            return _empty(sv)
        groups = _eq_groups(sv, u)
        if groups is None:                 # a required bit has no plane
            return _empty(sv)
        res = _agg.combine_and_sub(*groups)
        if sv.nullable:
            res.bit_and(sv.null_plane)
        return res

    def find_eq_count(self, sv, value) -> int:
        return self.find_eq(sv, value).count()

    def find_first_eq(self, sv: SparseVector, value) -> int:
        """First position holding ``value``, or -1 (reference find_eq(sv,
        value, pos&) -> find_first_eq, src/bmsparsevec_algo.h:804/:2118).
        Runs the aggregator's early-exit pass (find_first_and_sub): only
        the first hit block is materialized.  Honors the AND mask."""
        sv._flush()
        if not value_fits(value, sv.dtype):
            return -1
        u = _u_of(sv, value)
        if u == 0:
            return self.find_zero(sv).find()   # masked find_zero
        if u.bit_length() > sv.n_slices:
            return -1
        groups = _eq_groups(sv, u)
        if groups is None:
            return -1
        and_group, sub_group = groups
        if sv.nullable:
            and_group.append(sv.null_plane)
        if self._and_mask is not None:
            and_group.append(self._and_mask)
        self._range_operand(and_group)
        return _agg.find_first_and_sub(and_group, sub_group)

    def find_ne(self, sv: SparseVector, value) -> BitVector:
        uni = _universe(sv).copy()
        return uni - self.find_eq(sv, value)

    def invert(self, sv: SparseVector, bv: BitVector) -> BitVector:
        """Invert a search result within [0, sv.size) with NULL correction
        ("EQ" -> "not EQ"; reference scanner invert,
        src/bmsparsevec_algo.h:2014)."""
        uni = _universe(sv).copy()
        return uni - bv

    def find_eq_set(self, sv: SparseVector, values) -> BitVector:
        """Positions holding any of ``values``: A IN (C, D, E, ...)
        (reference set-iterator find_eq, src/bmsparsevec_algo.h:1092)."""
        out = _empty(sv)
        for v in values:
            out.bit_or(self.find_eq(sv, v))
        return out

    # ------------------------------------------------------------------
    # pipeline: batch many equality searches (reference scanner pipeline
    # :653; masks/counts modes mirror agg_run_options)
    # ------------------------------------------------------------------
    def _arena_of(self, sv):
        from ..agg.arena import OperandArena
        plane_ids = [s for s, p in enumerate(sv.planes) if p is not None]
        operands = [sv.planes[s] for s in plane_ids]
        if sv.nullable:
            operands.append(sv.null_plane)
        return OperandArena(operands), {s: k for k, s in enumerate(plane_ids)}

    def pipeline_find_eq(self, sv: SparseVector, values, counts_only=False):
        """find_eq for a batch of values (reference scanner pipeline,
        src/bmsparsevec_algo.h:653).  The plane pools concatenate once into
        an operand arena (reference pipeline_bcache analog); counts run as
        one B5 launch for the batch, results as one B4 launch in arena form
        per value."""
        sv._flush()
        arena, pos_of = self._arena_of(sv)
        null_idx = len(arena.vectors) - 1 if sv.nullable else None
        if counts_only:
            counts = self._pipeline_counts(sv, values, arena, pos_of)
            if counts is not None:
                return counts
        out = []
        for v in values:
            if not value_fits(v, sv.dtype):
                out.append(0 if counts_only else _empty(sv))
                continue
            u = _u_of(sv, v)
            if u == 0 or u.bit_length() > sv.n_slices or any(
                    (u >> s) & 1 and s not in pos_of
                    for s in range(sv.n_slices)):
                bv = self.find_eq(sv, v) if u == 0 else _empty(sv)
            else:
                and_idx = [pos_of[s] for s in range(sv.n_slices)
                           if (u >> s) & 1]
                sub_idx = [pos_of[s] for s in range(sv.n_slices)
                           if not (u >> s) & 1 and s in pos_of]
                if sv.nullable:
                    and_idx.append(null_idx)
                bv = _agg.combine_and_sub_arena(arena, and_idx, sub_idx)
            out.append(bv.count() if counts_only else bv)
        return out

    def prepare_pipeline(self, sv: SparseVector):
        """A reusable bulk-search pipeline over sv (the reference pipeline
        object with its shared block cache, bmaggregator.h:197): the dense
        plane stack is gathered once and every ``counts(values)`` batch
        afterwards is a single B5 launch."""
        sv._flush()
        arena, pos_of = self._arena_of(sv)
        return _PreparedPipeline(self, sv, arena, pos_of)

    def _pipeline_counts(self, sv, values, arena, pos_of):
        prep = _PreparedPipeline(self, sv, arena, pos_of)
        return prep.counts(values) if prep.ok else None


scanner = SparseVectorScanner()


def _masked(fn):
    """Apply the scanner's external AND mask and search range to a
    finalized find_* result (reference finalize_search_result,
    src/bmsparsevec_algo.h:2052).  Both are cleared for the duration of the
    body so composed searches mask exactly once, at the top."""
    @functools.wraps(fn)
    def wrap(self, *a, **kw):
        m, r = self._and_mask, self._search_range
        self._and_mask = None
        self._search_range = None
        try:
            out = fn(self, *a, **kw)
        finally:
            self._and_mask, self._search_range = m, r
        if m is not None:
            out.bit_and(m)
        if r is not None:
            out.keep_range(*r)          # block-narrowed, O(result blocks)
        return out
    return wrap


for _name in ("find_zero", "find_nonzero", "find_eq", "find_ne",
              "find_eq_set"):
    setattr(SparseVectorScanner, _name,
            _masked(getattr(SparseVectorScanner, _name)))


class _PreparedPipeline:
    """Reusable bulk-search state: the dense [K, nb_u, 2048] plane stack plus
    the slice -> operand mapping (scanner.prepare_pipeline).

    Succinct mode: when the operands are mostly GAP-resident, the dense
    stack is not prebuilt.  Each batch narrows to survivor blocks in the
    symbolic domain first (a block can hit query i only when every AND
    operand of i is present there: the host analog of the aggregator's
    digest skipping, src/bmaggregator.h:1764), then expands only the
    survivors host-side into a [K, n_surv, 2048] stack."""

    def __init__(self, sc, sv, arena, pos_of):
        self.sc = sc
        self.sv = sv
        self.pos_of = pos_of
        self._base_vectors = list(arena.vectors)
        self._mask = None
        self._count_limit = None
        self._or_target = None
        self._rebuild(arena)

    def _rebuild(self, arena):
        from ..agg.arena import (build_dense_stack, operands_succinct,
                                 presence_table)
        self.K = len(arena.vectors)
        self.arena = arena
        self.succinct = operands_succinct(arena.vectors)
        self.last_narrowing = None
        if self.succinct:
            # cached across batches (the prepared-pipeline payoff)
            self.nb_union, self._present = presence_table(arena.vectors)
            self.planes = None
            self.ok = self.nb_union.size > 0
        else:
            self.planes = build_dense_stack(arena)
            self.ok = self.planes is not None

    # -- reference pipeline options (scanner::pipeline<Opt>,
    # src/bmsparsevec_algo.h:678-695 / bmaggregator.h:245-260) ----------
    def set_search_mask(self, bv_mask):
        """AND-mask every request against ``bv_mask`` (reference
        set_search_mask).  The mask joins the operand stack as one more
        always-AND plane, so the batch stays one launch."""
        from ..agg.arena import OperandArena
        self._mask = bv_mask
        ops = list(self._base_vectors)
        if bv_mask is not None:
            ops.append(bv_mask)
        self._rebuild(OperandArena(ops))
        return self

    def set_search_count_limit(self, limit):
        """Stop counting a request past ``limit`` (reference
        set_search_count_limit: reported counts cap at the limit)."""
        self._count_limit = None if limit is None else int(limit)
        return self

    def set_or_target(self, bv_or):
        """Accumulate the union of every request's hits into ``bv_or``
        (reference set_or_target).  Forces per-request result vectors."""
        self._or_target = bv_or
        return self

    def _narrowed_counts(self, sels):
        """Survivor-narrowed batch: host-expand only blocks where some
        query's whole AND group is present, then one B5 launch."""
        from ..agg.arena import build_dense_stack_host, narrow_survivors
        nb_sel, n_union = narrow_survivors(self.nb_union, self._present,
                                           sels)
        self.last_narrowing = (int(nb_sel.size), n_union)
        if nb_sel.size == 0:
            return np.zeros(sels.shape[0], np.int64)
        stack = blockops.to_device_words(
            build_dense_stack_host(self.arena.vectors, nb_sel),
            self.arena.device)
        return ck.pipeline_counts(stack, sels).cpu().numpy()

    def counts(self, values) -> list:
        """Hit counts per value: one B5 launch for the whole batch (the
        per-request result path when an or-target is attached)."""
        sv, K, pos_of = self.sv, self.K, self.pos_of
        lim = self._count_limit

        def _cap(c):
            return c if lim is None else min(c, lim)

        if self._or_target is not None:
            out = []
            for v in values:
                res = self.sc.find_eq(sv, v)
                if self._mask is not None:
                    res = res & self._mask
                self._or_target.bit_or(res)
                out.append(_cap(res.count()))
            return out
        null_col = (len(self._base_vectors) - 1 if sv.nullable else None)
        mask_col = (K - 1 if self._mask is not None else None)
        sels = np.zeros((len(values), K), np.int32)
        fallback = {}
        fits = [value_fits(v, sv.dtype) for v in values]
        vals_c = np.asarray([v if f else 0 for v, f in zip(values, fits)],
                            sv.dtype)
        us = np.asarray(sv.s2u(vals_c), np.uint64)
        for i, u64 in enumerate(us):
            if not fits[i]:
                fallback[i] = None          # unrepresentable: known zero
                continue
            u = int(u64)
            if u == 0:
                fallback[i] = values[i]
                continue
            impossible = False
            for s in range(sv.n_slices):
                if (u >> s) & 1:
                    if s not in pos_of:
                        impossible = True
                        break
                    sels[i, pos_of[s]] = 1
                elif s in pos_of:
                    sels[i, pos_of[s]] = -1
            if impossible:
                sels[i] = 0
                fallback[i] = None          # known-zero count
                continue
            if null_col is not None:
                sels[i, null_col] = 1
            if mask_col is not None:
                sels[i, mask_col] = 1
        if self.succinct:
            cts = self._narrowed_counts(sels)
        else:
            cts = ck.pipeline_counts(self.planes, sels).cpu().numpy()
        out = []
        for i in range(len(values)):
            if i in fallback:
                fv = fallback[i]
                if fv is None:
                    out.append(0)
                else:
                    res = self.sc.find_eq(sv, fv)
                    if self._mask is not None:
                        res = res & self._mask
                    out.append(_cap(res.count()))
            else:
                out.append(_cap(int(cts[i])))
        return out
