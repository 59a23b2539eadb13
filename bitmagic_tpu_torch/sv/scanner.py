"""Index-free search on bit-sliced succinct vectors in compressed form
(port of ``bitmagic_tpu/sv/scanner.py``).

Equivalent of `bm::sparse_vector_scanner<SV>` (src/bmsparsevec_algo.h:612):

  * find_eq(value): decompose the value into 1-bits (AND slice group) and
    0-bits (SUB slice group) and run one aggregator AND-SUB pass
    (prepare_and_sub_aggregator :2286-2324 -> combine_and_sub), on the card
    one launch of the K-way sweep kernel B4;
  * find_gt/ge/lt/le/range: MSB-first slice descent keeping (greater,
    prefix-equal) accumulators, the slice-algebra form of
    find_gt_horizontal (:1144+), with the signed split handled through the
    s2u encoding (sign bit = slice 0); every AND, OR and SUB of the descent
    is one launch of kernel K1;
  * find_zero / find_nonzero (:1055-1082), find_ne, invert, find_eq_set,
    find_nonnegative;
  * sorted search: lower_bound / bfind_eq via a sample index (reference
    bind + sv_sample_index, :493);
  * string searches on StrSparseVector (per-octet slice masks,
    find_eq_str :2245) and the float and RSC fronts;
  * the pipeline API batches many find_eq searches (reference scanner
    pipeline :653 feeding the aggregator pipeline): counts run as one
    launch of kernel B5 over the dense plane stack, result batches as one
    B4 launch per value in arena form; the string pipeline is one B5
    launch over every octet plane.

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


def _empty(sv) -> BitVector:
    return BitVector(C.ID_MAX48, device=sv.device)


def _range_universe(n: int, device) -> BitVector:
    u = BitVector(C.ID_MAX48, device=device)
    if n:
        u.set_range(0, n - 1)
        u.optimize()
    return u


def _universe(sv: SparseVector) -> BitVector:
    """Positions that hold assigned values: the NULL plane if nullable, else
    the full range [0, size)."""
    if sv.nullable:
        return sv.null_plane
    return _range_universe(sv._size, sv.device)


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
    """bm::sparse_vector_scanner equivalent."""

    #: external AND mask applied to every find_* result
    #: (reference set_and_mask, src/bmsparsevec_algo.h:1124)
    _and_mask = None

    def set_and_mask(self, bv_mask: BitVector | None) -> None:
        """Restrict subsequent find_* searches to positions set in
        ``bv_mask`` (reference set_and_mask, src/bmsparsevec_algo.h:1124;
        the reference seeds the aggregator's AND group with the mask, here
        it ANDs into the finalized result: same answer).  ``None`` resets.
        Pipelines and the sorted bfind family are unaffected.  For RSC
        searches the mask is read in the logical address space (the
        reference masks pre-decompression coordinates)."""
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
    # ordered searches (slice descent)
    # ------------------------------------------------------------------
    def _cmp_unsigned(self, planes, uni: BitVector, value: int, n_bits: int):
        """MSB-first descent over the given planes: returns (gt, eq)
        BitVectors relative to the universe.  Up to three K1 launches per
        plane (the AND, the OR and the SUB)."""
        gt = BitVector(C.ID_MAX48, device=uni.device)
        eq = uni.copy()
        for s in range(n_bits - 1, -1, -1):
            p = planes[s] if s < len(planes) else None
            if (value >> s) & 1:
                if p is None:
                    # all elements have 0 here: none can stay equal
                    eq = BitVector(C.ID_MAX48, device=uni.device)
                    break
                eq.bit_and(p)
            elif p is not None:
                gt.bit_or(eq & p)
                eq.bit_sub(p)
        return gt, eq

    def find_gt(self, sv: SparseVector, value) -> BitVector:
        """Positions with element > value (reference find_gt,
        src/bmsparsevec_algo.h:1144 find_gt_horizontal).  Out-of-dtype
        values resolve symbolically (the descent sees dtype-width bits
        only; the reference takes a typed argument)."""
        sv._flush()
        value = int(value)
        info = np.iinfo(sv.dtype)
        if value < info.min:
            return _universe(sv).copy()
        if value >= info.max:
            return _empty(sv)
        uni = _universe(sv)
        if not sv.signed:
            gt, _ = self._cmp_unsigned(sv.planes, uni, value, sv.n_slices)
            return gt
        # signed split: s2u keeps the sign in slice 0, |v|-1 magnitude above
        sign_p = sv.planes[0]
        neg = (uni & sign_p) if sign_p is not None else _empty(sv)
        pos = uni - neg        # non-negative elements (zero included)
        mag_planes = sv.planes[1:]
        if value >= 0:
            gt, _ = self._cmp_unsigned(mag_planes, pos, value,
                                       sv.n_slices - 1)
            return gt
        # value < 0: every non-negative qualifies, plus negatives x > value,
        # i.e. stored magnitude (-x-1) < (-value-1)
        gtm, eqm = self._cmp_unsigned(mag_planes, neg, -value - 1,
                                      sv.n_slices - 1)
        return pos | (neg - gtm - eqm)

    def find_ge(self, sv: SparseVector, value) -> BitVector:
        sv._flush()
        value = int(value)
        info = np.iinfo(sv.dtype)
        if value <= info.min:
            return _universe(sv).copy()
        if value > info.max:
            return _empty(sv)
        if not sv.signed:
            gt, eq = self._cmp_unsigned(sv.planes, _universe(sv), value,
                                        sv.n_slices)
            return gt | eq
        return self.find_gt(sv, value - 1)

    def find_lt(self, sv: SparseVector, value) -> BitVector:
        return _universe(sv).copy() - self.find_ge(sv, value)

    def find_le(self, sv: SparseVector, value) -> BitVector:
        return _universe(sv).copy() - self.find_gt(sv, value)

    def find_range(self, sv: SparseVector, lo, hi) -> BitVector:
        """lo <= element <= hi (reference find_range)."""
        return self.find_ge(sv, lo) & self.find_le(sv, hi)

    def find_nonnegative(self, sv: SparseVector) -> BitVector:
        """All positions with element >= 0, NULLs included (they read 0):
        reference find_nonnegative (src/bmsparsevec_algo.h:1073 ->
        find_nonnegative_no_mask :1484, which does not null-correct): the
        [0, size) range minus the sign plane."""
        sv._flush()
        out = _range_universe(sv._size, sv.device)
        if sv.signed and sv.planes and sv.planes[0] is not None:
            out.bit_sub(sv.planes[0])
        return out

    # ------------------------------------------------------------------
    # sorted-vector search (reference bfind/lower_bound_str + sample index)
    # ------------------------------------------------------------------
    #: sampling stride of the bound index (reference sv_sample_index
    #: samples one element per block region, src/bmsparsevec_algo.h:493;
    #: 256 keeps the residual window one gather wide)
    BIND_SAMPLE_RATE = 256

    def bind(self, sv, sorted=True) -> None:
        """Attach a sorted vector to this scanner and build its sample
        index once (reference ``bind()`` + ``sv_sample_index``,
        src/bmsparsevec_algo.h:493).  Later ``lower_bound`` / ``bfind_eq``
        (or the ``_str`` forms) on the bound vector narrow through the host
        sample array and decode one window with a single gather instead of
        O(log n) single-element probes.  Re-bind after mutating the vector
        (reference contract)."""
        if not sorted:                       # parity with the ref signature
            self._bound = None
            return
        getattr(sv, "_flush", lambda: None)()   # str vectors flush per-octet
        n = len(sv)
        pos = np.arange(0, n, self.BIND_SAMPLE_RATE, dtype=np.int64)
        samples = sv.gather(pos) if n else []
        self._bound = (sv, pos, samples)

    def unbind(self) -> None:
        self._bound = None

    def reset_binding(self) -> None:
        """Alias of unbind (reference reset_binding,
        src/bmsparsevec_algo.h:1974)."""
        self.unbind()

    def _bound_lower_bound(self, sv, value, cmp_lt) -> int:
        """Sample-index descent shared by the int and str paths:
        binary-search the samples, then scan one decoded window."""
        _, pos, samples = self._bound
        n = len(sv)
        lo_s, hi_s = 0, len(samples)
        while lo_s < hi_s:                    # search the samples
            mid = (lo_s + hi_s) // 2
            if cmp_lt(samples[mid], value):
                lo_s = mid + 1
            else:
                hi_s = mid
        # the answer lies in (pos[lo_s-1], pos[lo_s]]: decode that window
        w_lo = 0 if lo_s == 0 else int(pos[lo_s - 1]) + 1
        w_hi = int(pos[lo_s]) if lo_s < len(pos) else n
        if w_lo >= w_hi:
            return w_hi
        window = sv.decode(w_lo, w_hi - w_lo)
        for k in range(len(window)):
            if not cmp_lt(window[k], value):
                return w_lo + k
        return w_hi

    def lower_bound(self, sv: SparseVector, value) -> int:
        """First index i with sv[i] >= value in a sorted vector (reference
        lower_bound, src/bmsparsevec_algo.h bfind family); bind() first for
        the sample-index path."""
        getattr(sv, "_flush", lambda: None)()
        b = getattr(self, "_bound", None)
        if b is not None and b[0] is sv:
            return self._bound_lower_bound(sv, value, lambda a, v: a < v)
        lo, hi = 0, len(sv)
        while lo < hi:
            mid = (lo + hi) // 2
            if sv.get(mid) < value:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def bfind_eq(self, sv: SparseVector, value) -> int:
        """Index of value in a sorted vector, or -1 (reference bfind,
        src/bmsparsevec_algo.h:819)."""
        i = self.lower_bound(sv, value)
        if i < len(sv) and sv.get(i) == value:
            return i
        return -1

    bfind = bfind_eq           # reference method name

    # ------------------------------------------------------------------
    # string searches (reference find_eq_str, src/bmsparsevec_algo.h:2245:
    # per-octet slice masks with remap translation, one AND-SUB sweep)
    # ------------------------------------------------------------------
    @staticmethod
    def _str_groups(ssv, img, n_octets):
        """(and_group, sub_group) over the first ``n_octets`` octet
        positions for the octet image ``img``, or None when a required
        1-bit has no plane."""
        and_group, sub_group = [], []
        for k in range(n_octets):
            osv = ssv.octets[k]
            osv._flush()
            groups = _eq_groups(osv, int(img[k]))
            if groups is None:
                return None
            and_group += groups[0]
            sub_group += groups[1]
        return and_group, sub_group

    def find_eq_str(self, ssv, s) -> BitVector:
        """All positions of string vector ``ssv`` equal to ``s``: one
        AND-SUB sweep (B4) over the union of all octet positions'
        bit-planes."""
        img = ssv.remap_value(s)
        if img is None:                  # unmappable char: cannot exist
            return _empty(ssv)
        groups = self._str_groups(ssv, img, ssv.max_str_size)
        if groups is None:
            return _empty(ssv)
        and_group, sub_group = groups
        if not and_group:
            # empty string: universe minus any octet bit anywhere
            uni = (ssv.null_plane.copy() if ssv.nullable
                   else _range_universe(ssv.size, ssv.device))
            if sub_group:
                uni.bit_sub(_agg.combine_or(sub_group))
            return uni
        res = _agg.combine_and_sub(and_group, sub_group)
        if ssv.nullable:
            res.bit_and(ssv.null_plane)
        return res

    def find_eq_str_count(self, ssv, s) -> int:
        return self.find_eq_str(ssv, s).count()

    def find_eq_str_prefix(self, ssv, s) -> BitVector:
        """Positions whose string starts with ``s`` (reference
        find_eq_str_prefix, src/bmsparsevec_algo.h:920 ->
        find_eq_str_impl(prefix_sub=false) :2239: octet positions past
        len(s) stay unconstrained; an empty query degrades to the exact
        empty-string search, as the reference's ``if (*str)`` branch
        does)."""
        s = s if isinstance(s, str) else bytes(s).decode("latin-1")
        if not s:
            return self.find_eq_str(ssv, "")
        img = ssv.remap_value(s)
        if img is None:                 # unmappable / longer than storable
            return _empty(ssv)
        groups = self._str_groups(ssv, img, len(s))
        if groups is None:
            return _empty(ssv)
        res = _agg.combine_and_sub(*groups)
        if ssv.nullable:
            res.bit_and(ssv.null_plane)
        return res

    def find_first_eq_str(self, ssv, s) -> int:
        """First position of exact string ``s``, or -1 (reference
        find_eq_str(sv, str, pos&), src/bmsparsevec_algo.h:902 ->
        find_first_eq :3080: B4's early-exit form).  Honors the AND
        mask."""
        s = s if isinstance(s, str) else bytes(s).decode("latin-1")
        if not s:
            return self.find_eq_str(ssv, "").find()
        img = ssv.remap_value(s)
        if img is None:
            return -1
        groups = self._str_groups(ssv, img, ssv.max_str_size)
        if groups is None:
            return -1
        and_group, sub_group = groups
        if ssv.nullable:
            and_group.append(ssv.null_plane)
        if self._and_mask is not None:
            and_group.append(self._and_mask)
        self._range_operand(and_group)
        return _agg.find_first_and_sub(and_group, sub_group)

    def lower_bound_str(self, ssv, s) -> int:
        """First index i with ssv[i] >= s in a sorted string vector
        (reference lower_bound_str / bfind_eq_str with the sample index,
        src/bmsparsevec_algo.h:493)."""
        s = s if isinstance(s, str) else bytes(s).decode("latin-1")
        b = getattr(self, "_bound", None)
        if b is not None and b[0] is ssv:
            # NULLs decode as None and sort as "" (the compare() contract)
            return self._bound_lower_bound(ssv, s,
                                           lambda a, v: (a or "") < v)
        lo, hi = 0, len(ssv)
        while lo < hi:
            mid = (lo + hi) // 2
            if ssv.compare(mid, s) < 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def bfind_eq_str(self, ssv, s) -> int:
        i = self.lower_bound_str(ssv, s)
        if i < len(ssv) and ssv.compare(i, s) == 0:
            return i
        return -1

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


    def prepare_pipeline_str(self, ssv):
        """A reusable string-equality pipeline over ``ssv``: one dense stack
        over every octet plane, each ``counts(strings)`` batch one B5
        launch."""
        return _PreparedStrPipeline(self, ssv)

    def pipeline_find_eq_str(self, ssv, strings, counts_only=True):
        """Batch string-equality searches; counts_only=True runs the whole
        batch as one B5 launch."""
        if not counts_only:
            return [self.find_eq_str(ssv, s) for s in strings]
        prep = _PreparedStrPipeline(self, ssv)
        if not prep.ok:
            return [self.find_eq_str(ssv, s).count() for s in strings]
        return prep.counts(strings)


scanner = SparseVectorScanner()


# ---------------------------------------------------------------------------
# RSC and float scanner fronts (reference scanner works across all SV
# families: rsc via address decompression, float via the IEEE field split,
# src/bmsparsevec_algo.h find_gt_horizontal float variants)
# ---------------------------------------------------------------------------
def _rsc_expand(rsc, bv_compressed: BitVector) -> BitVector:
    """Map compressed-domain hit positions to logical positions through the
    RSC NULL index (rank decompression)."""
    null_bv = rsc.get_null_bvector()
    pos = bv_compressed.indices()
    if pos.size == 0:
        return _empty(rsc)
    logical = null_bv.build_rs_index().select_batch(pos + 1)
    return BitVector.from_indices(logical, C.ID_MAX48, device=rsc.device)


class RSCScannerMixin:
    def find_eq_rsc(self, rsc, value) -> BitVector:
        """find_eq on a rank-select-compressed vector: search the dense
        payload, then rank-decompress the hits."""
        rsc._flush()
        return _rsc_expand(rsc, self.find_eq(rsc.dense, value))

    def find_gt_rsc(self, rsc, value) -> BitVector:
        rsc._flush()
        return _rsc_expand(rsc, self.find_gt(rsc.dense, value))

    def find_lt_rsc(self, rsc, value) -> BitVector:
        rsc._flush()
        return _rsc_expand(rsc, self.find_lt(rsc.dense, value))


def _float_universe(fv) -> BitVector:
    """Assigned positions of a float vector: [0, size), NULLs removed."""
    uni = _empty(fv)
    if fv._size:
        uni.set_range(0, fv._size - 1)
    if fv.nullable and fv.null_plane is not None:
        uni.bit_and(fv.null_plane)
    return uni


class FloatScannerMixin:
    def _float_parts(self, fv, value):
        u = int(np.asarray([value], fv.dtype).view(fv._uint)[0])
        sign = u >> (fv._eb + fv._mb)
        exp = (u >> fv._mb) & ((1 << fv._eb) - 1)
        mant = u & ((1 << fv._mb) - 1)
        if exp == 0 and mant == 0:
            sign = 0                     # -0.0 compares equal to +0.0
        return sign, exp, mant

    def find_eq_float(self, fv, value) -> BitVector:
        """Equality on a float sparse vector: AND of the exponent and
        mantissa matches (B4 each) with the sign plane constraint."""
        sign, exp, mant = self._float_parts(fv, value)
        hits = self.find_eq(fv.exponent, exp)
        hits.bit_and(self.find_eq(fv.mantissa, mant))
        if exp == 0 and mant == 0:
            pass                         # +-0.0 are numerically equal
        elif sign:
            hits.bit_and(fv.sign)
        else:
            hits.bit_sub(fv.sign)
        if fv.nullable and fv.null_plane is not None:
            hits.bit_and(fv.null_plane)
        return hits

    def find_gt_float(self, fv, value) -> BitVector:
        """x > value over IEEE floats via the sign/exp/mantissa split:
        lexicographic (exp, mantissa) comparison per sign class, with the
        order reversed for negatives."""
        uni = _float_universe(fv)
        sign, exp, mant = self._float_parts(fv, value)
        # -0.0 stored elements compare as zero: move them to the
        # non-negative class so the sign split is numerically consistent
        zeros_neg = self.find_eq(fv.exponent, 0)
        zeros_neg.bit_and(self.find_eq(fv.mantissa, 0))
        zeros_neg.bit_and(fv.sign)
        pos = uni.copy()
        pos.bit_sub(fv.sign)                 # x >= +0.0
        pos.bit_or(zeros_neg & uni)          # ... plus -0.0
        neg = uni.copy()
        neg.bit_and(fv.sign)
        neg.bit_sub(zeros_neg)               # strictly negative

        def magnitude_gt(uni_part, or_eq=False):
            """Elements (within uni_part) whose (exp, mantissa) compare
            lexicographically greater than the query's (or equal too)."""
            e_gt, e_eq = self._cmp_unsigned(fv.exponent.planes, uni_part,
                                            exp, fv._eb)
            m_gt, m_eq = self._cmp_unsigned(fv.mantissa.planes,
                                            e_eq, mant, fv._mb)
            out = e_gt
            out.bit_or(m_gt)
            if or_eq:
                out.bit_or(m_eq)
            out.bit_and(uni_part)
            return out

        if sign == 0:
            # value >= 0: positives with |x| > |v|, no negatives
            return magnitude_gt(pos)
        # value < 0: every non-negative qualifies, plus negatives with a
        # smaller magnitude: |x| < |v|  <=>  not (|x| >= |v|)
        less_mag = neg.copy()
        less_mag.bit_sub(magnitude_gt(neg, or_eq=True))
        pos.bit_or(less_mag)
        return pos

    def find_lt_float(self, fv, value) -> BitVector:
        """x < value = assigned and not (x > value) and not (x == value)."""
        gt = self.find_gt_float(fv, value)
        eq = self.find_eq_float(fv, value)
        uni = _float_universe(fv)
        uni.bit_sub(gt)
        uni.bit_sub(eq)
        return uni

    def find_ge_float(self, fv, value) -> BitVector:
        """x >= value (reference find_ge_float,
        src/bmsparsevec_algo.h:1001)."""
        out = self.find_gt_float(fv, value)
        out.bit_or(self.find_eq_float(fv, value))
        return out

    def find_le_float(self, fv, value) -> BitVector:
        """x <= value = assigned and not (x > value) (reference
        find_le_float, src/bmsparsevec_algo.h:1020)."""
        uni = _float_universe(fv)
        uni.bit_sub(self.find_gt_float(fv, value))
        return uni

    def find_range_float(self, fv, lo, hi) -> BitVector:
        """Closed interval [lo, hi] over floats (reference
        find_range_float, src/bmsparsevec_algo.h:1031: swaps reversed
        bounds, le(hi) & ge(lo))."""
        if lo > hi:
            lo, hi = hi, lo
        out = self.find_le_float(fv, hi)
        out.bit_and(self.find_ge_float(fv, lo))
        return out

    def find_range_float_unbounded(self, fv, lo, hi) -> BitVector:
        """Open interval (lo, hi) over floats (reference
        find_range_float_unbounded, src/bmsparsevec_algo.h:1043: swaps
        reversed bounds, lt(to) & gt(from))."""
        if lo > hi:
            lo, hi = hi, lo
        out = self.find_lt_float(fv, hi)
        out.bit_and(self.find_gt_float(fv, lo))
        return out


for _name in ("find_eq_rsc", "find_gt_rsc", "find_lt_rsc"):
    setattr(SparseVectorScanner, _name, getattr(RSCScannerMixin, _name))
for _name in ("_float_parts", "find_eq_float", "find_gt_float",
              "find_lt_float", "find_ge_float", "find_le_float",
              "find_range_float", "find_range_float_unbounded"):
    setattr(SparseVectorScanner, _name, getattr(FloatScannerMixin, _name))


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
              "find_eq_set", "find_gt", "find_ge", "find_lt", "find_le",
              "find_range", "find_nonnegative", "find_eq_str",
              "find_eq_str_prefix", "find_eq_rsc", "find_gt_rsc",
              "find_lt_rsc", "find_eq_float", "find_gt_float",
              "find_lt_float", "find_ge_float", "find_le_float",
              "find_range_float", "find_range_float_unbounded"):
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


class _PreparedStrPipeline:
    """Bulk string-equality pipeline: one dense stack over the union of all
    octet planes; counts(strings) is one B5 launch (reference find_eq_str
    pipeline, src/bmsparsevec_algo.h:653)."""

    def __init__(self, sc, ssv):
        from ..agg.arena import OperandArena, build_dense_stack
        self.sc = sc
        self.ssv = ssv
        for o in ssv.octets:
            o._flush()
        self.slots = []                  # (octet k, bit b) per operand
        operands = []
        for k in range(ssv.max_str_size):
            for b, p in enumerate(ssv.octets[k].planes):
                if p is not None:
                    self.slots.append((k, b))
                    operands.append(p)
        self.null_idx = None
        if ssv.nullable and ssv.null_plane is not None:
            self.null_idx = len(operands)
            operands.append(ssv.null_plane)
        self._stack = build_dense_stack(OperandArena(operands))
        self.K = len(operands)
        self.pos_of = {kb: i for i, kb in enumerate(self.slots)}

    @property
    def ok(self):
        return self._stack is not None

    def counts(self, strings) -> list:
        ssv, K = self.ssv, self.K
        sels = np.zeros((len(strings), K), np.int32)
        fallback = {}
        for i, s in enumerate(strings):
            img = ssv.remap_value(s)
            if img is None:
                fallback[i] = None       # unmappable: 0 hits
                continue
            if not img.any():
                fallback[i] = s          # empty string: the find_eq_str path
                continue
            impossible = False
            for k in range(ssv.max_str_size):
                code = int(img[k])
                for b in range(ssv.octets[k].n_slices):
                    idx = self.pos_of.get((k, b))
                    if (code >> b) & 1:
                        if idx is None:
                            impossible = True
                            break
                        sels[i, idx] = 1
                    elif idx is not None:
                        sels[i, idx] = -1
                if impossible:
                    break
            if impossible:
                sels[i] = 0
                fallback[i] = None
                continue
            if self.null_idx is not None:
                sels[i, self.null_idx] = 1
        cts = ck.pipeline_counts(self._stack, sels).cpu().numpy()
        out = []
        for i, s in enumerate(strings):
            if i in fallback:
                fv = fallback[i]
                out.append(0 if fv is None else
                           self.sc.find_eq_str(ssv, fv).count())
            else:
                out.append(int(cts[i]))
        return out
