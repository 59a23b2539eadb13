"""Block-structure bookkeeping of the bit-vector (port of
``bitmagic_tpu/core/blocks.py``).

The reference manages blocks with a two-level pointer tree + pointer tagging
(`blocks_manager`, src/bmblocks.h:41; GAP/FULL pointer tags src/bmdef.h:165-199).
The design replaces the tree with three parallel host-side numpy arrays
(tiny metadata) plus one dense device pool:

  * ``nb``  : int64[n_alloc]  — sorted unique logical block ids,
  * ``cls`` : uint8[n_alloc]  — CLS_BIT, CLS_GAP or CLS_FULL (CLS_ZERO
               blocks are simply absent, like NULL pointers in the reference),
  * pool    : int32[n_rows, 2048] on the device — one row per CLS_BIT
               block, in ``nb`` order.

Binary set-ops are *planned* on host over this metadata (pure numpy,
O(n_alloc)) and *executed* on the device as one gather-fused kernel that
takes the operands' descriptors ``(pool, slot, full, aux, aux_slot)``
directly — the analog of the reference's per-block dispatch loop
(`combine_operation_and`, src/bm.h:6604-7056), where FULL/ZERO fast paths
resolve symbolically and only genuine BIT x BIT work touches device memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import CLS_BIT, CLS_FULL, CLS_GAP, SET_BLOCK_SIZE
from ..ops.blockops import gather_rows, to_device_words

# symbolic per-block operand state used during planning
_Z, _F, _B, _G = 0, 1, 2, 3   # zero / full / bit-row / host GAP buffer

# interior FULL spans at least this many blocks wide are stored as one
# [start, end) run entry instead of per-block metadata — the
# analog of the reference's FULL sub-tree sentinels (src/bm.h:6628-6650,
# src/bmblocks.h:644 set_all_set), which make set_range/invert over any
# 48-bit span O(occupied structure), not O(blocks-in-range).
RUN_MIN = 32

_EMPTY_RUNS = np.zeros((0, 2), np.int64)


def _as_runs(r) -> np.ndarray:
    if r is None:
        return _EMPTY_RUNS
    r = np.asarray(r, np.int64)
    return r.reshape(-1, 2)


def runs_normalize(r: np.ndarray) -> np.ndarray:
    """Sort, drop empties, and merge overlapping/adjacent [start, end)
    intervals."""
    r = _as_runs(r)
    r = r[r[:, 1] > r[:, 0]]
    if r.shape[0] <= 1:
        return r
    r = r[np.argsort(r[:, 0], kind="stable")]
    # merge where next.start <= running max end
    ends = np.maximum.accumulate(r[:, 1])
    new_grp = np.concatenate([[True], r[1:, 0] > ends[:-1]])
    gid = np.cumsum(new_grp) - 1
    n = gid[-1] + 1
    starts = r[new_grp, 0]
    out_end = np.zeros(n, np.int64)
    np.maximum.at(out_end, gid, r[:, 1])
    return np.stack([starts, out_end], axis=1)


def runs_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two normalized interval sets."""
    a, b = _as_runs(a), _as_runs(b)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return _EMPTY_RUNS
    # for each a-interval, the b-intervals it can overlap
    out = []
    j0 = np.searchsorted(b[:, 1], a[:, 0], side="right")
    j1 = np.searchsorted(b[:, 0], a[:, 1], side="left")
    for i in range(a.shape[0]):
        lo, hi = j0[i], j1[i]
        if hi <= lo:
            continue
        s = np.maximum(b[lo:hi, 0], a[i, 0])
        e = np.minimum(b[lo:hi, 1], a[i, 1])
        out.append(np.stack([s, e], axis=1))
    if not out:
        return _EMPTY_RUNS
    return runs_normalize(np.concatenate(out))


def runs_union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = _as_runs(a), _as_runs(b)
    if a.shape[0] == 0:
        return b.copy()
    if b.shape[0] == 0:
        return a.copy()
    return runs_normalize(np.concatenate([a, b]))


def runs_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a minus b over normalized interval sets."""
    a, b = _as_runs(a), _as_runs(b)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return a.copy()
    out = []
    j0 = np.searchsorted(b[:, 1], a[:, 0], side="right")
    j1 = np.searchsorted(b[:, 0], a[:, 1], side="left")
    for i in range(a.shape[0]):
        cur = a[i, 0]
        for j in range(j0[i], j1[i]):
            if b[j, 0] > cur:
                out.append((cur, min(b[j, 0], a[i, 1])))
            cur = max(cur, b[j, 1])
            if cur >= a[i, 1]:
                break
        if cur < a[i, 1]:
            out.append((cur, a[i, 1]))
    if not out:
        return _EMPTY_RUNS
    return np.asarray(out, np.int64).reshape(-1, 2)


def runs_subtract_points(r: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Remove single block ids from an interval set (splitting runs)."""
    r = _as_runs(r)
    pts = np.asarray(pts, np.int64)
    if r.shape[0] == 0 or pts.size == 0:
        return r.copy()
    pts = np.unique(pts)
    inside = points_in_runs(pts, r)
    pts = pts[inside]
    if pts.size == 0:
        return r.copy()
    return runs_diff(r, np.stack([pts, pts + 1], axis=1))


def points_in_runs(pts: np.ndarray, r: np.ndarray) -> np.ndarray:
    """bool[n]: which block ids fall inside the interval set."""
    r = _as_runs(r)
    pts = np.asarray(pts, np.int64)
    if r.shape[0] == 0 or pts.size == 0:
        return np.zeros(pts.shape, bool)
    idx = np.searchsorted(r[:, 0], pts, side="right") - 1
    ok = idx >= 0
    res = np.zeros(pts.shape, bool)
    res[ok] = pts[ok] < r[idx[ok], 1]
    return res


def runs_clip(r: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Clip the interval set to [lo, hi)."""
    r = _as_runs(r)
    if r.shape[0] == 0:
        return r.copy()
    s = np.maximum(r[:, 0], lo)
    e = np.minimum(r[:, 1], hi)
    keep = e > s
    return np.stack([s[keep], e[keep]], axis=1)


def runs_total(r: np.ndarray) -> int:
    r = _as_runs(r)
    return int((r[:, 1] - r[:, 0]).sum()) if r.shape[0] else 0


def runs_overlap_bits(r: np.ndarray, lo_bit: int, hi_bit: int,
                      block_shift: int) -> int:
    """Number of bit positions in the closed bit range [lo_bit, hi_bit]
    covered by FULL runs (pure host arithmetic)."""
    r = _as_runs(r)
    if r.shape[0] == 0 or hi_bit < lo_bit:
        return 0
    s = np.maximum(r[:, 0] << block_shift, lo_bit)
    e = np.minimum((r[:, 1] << block_shift) - 1, hi_bit)
    d = e - s + 1
    return int(d[d > 0].sum())


def split_runs(r: np.ndarray, min_len: int = RUN_MIN):
    """Partition an interval set into (kept_runs, point_block_ids): runs
    shorter than min_len become explicit per-block FULL entries."""
    r = _as_runs(r)
    if r.shape[0] == 0:
        return r, np.zeros(0, np.int64)
    lens = r[:, 1] - r[:, 0]
    keep = lens >= min_len
    pts = [np.arange(s, e, dtype=np.int64) for s, e in r[~keep]]
    pts = np.concatenate(pts) if pts else np.zeros(0, np.int64)
    return r[keep], pts


@dataclasses.dataclass
class Structure:
    """Host metadata of one bit-vector's block structure.

    ``runs`` is a sorted, disjoint set of [start, end) block-id intervals
    that are entirely FULL — disjoint from ``nb`` (no block id covered by a
    run ever appears in ``nb``).  It is the compact representation of wide
    all-ones spans (reference FULL sub-tree sentinels, src/bm.h:6628-6650);
    narrow data never creates runs, so ``runs`` is empty for typical
    vectors and all per-block paths behave exactly as before.
    """
    nb: np.ndarray        # int64[n_alloc], sorted unique
    cls: np.ndarray       # uint8[n_alloc]
    runs: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY_RUNS)   # int64[k, 2]

    @classmethod
    def empty(cls_):
        return cls_(np.zeros(0, np.int64), np.zeros(0, np.uint8))

    @property
    def has_runs(self) -> bool:
        return self.runs.shape[0] > 0

    def run_block_count(self) -> int:
        return runs_total(self.runs)

    def materialized(self, limit: int = 1 << 22) -> "Structure":
        """Expand runs into per-block FULL entries (for consumers that
        need the flat per-block view).  Raises MemoryError when that view
        would exceed ``limit`` blocks of metadata."""
        if not self.has_runs:
            return self
        total = self.run_block_count()
        if total + len(self.nb) > limit:
            raise MemoryError(
                f"materializing {total} FULL run blocks exceeds the "
                f"{limit}-block metadata limit; this operation does not "
                "support run-coded wide spans yet")
        pts = np.concatenate([np.arange(s, e, dtype=np.int64)
                              for s, e in self.runs])
        nb = np.concatenate([self.nb, pts])
        cls = np.concatenate([self.cls,
                              np.full(pts.size, CLS_FULL, np.uint8)])
        order = np.argsort(nb, kind="stable")
        return Structure(nb[order], cls[order])

    def segments(self):
        """Merged per-segment view: (start, span, cls, slot, gslot) arrays
        sorted by start.  Normal entries span 1 block; FULL runs span
        (end - start) blocks and carry slot = gslot = -1.  O(n_alloc + k)
        — never expands run interiors."""
        n, k = len(self.nb), self.runs.shape[0]
        start = np.concatenate([self.nb, self.runs[:, 0]])
        span = np.concatenate([np.ones(n, np.int64),
                               self.runs[:, 1] - self.runs[:, 0]])
        cls = np.concatenate([self.cls, np.full(k, CLS_FULL, np.uint8)])
        slot = np.concatenate([self.slots(), np.full(k, -1, np.int64)])
        gslot = np.concatenate([self.gslots(), np.full(k, -1, np.int64)])
        order = np.argsort(start, kind="stable")
        return (start[order], span[order], cls[order], slot[order],
                gslot[order])

    def n_rows(self) -> int:
        return int((self.cls == CLS_BIT).sum())

    def slots(self) -> np.ndarray:
        """Pool-row index per entry (-1 for non-BIT)."""
        is_bit = self.cls == CLS_BIT
        s = np.cumsum(is_bit) - 1
        return np.where(is_bit, s, -1).astype(np.int64)

    def gslots(self) -> np.ndarray:
        """GAP-store index per entry (-1 for non-GAP)."""
        is_gap = self.cls == CLS_GAP
        s = np.cumsum(is_gap) - 1
        return np.where(is_gap, s, -1).astype(np.int64)

    def lookup(self, blocks: np.ndarray):
        """For each logical block id, return (state, slot):
        state in {_Z,_F,_B,_G}; slot = pool row (_B), GAP-store index (_G),
        else -1.  Block ids covered by a FULL run report _F."""
        blocks = np.asarray(blocks, np.int64)
        if len(self.nb) == 0:
            state = np.full(blocks.shape, _Z, np.int8)
            if self.has_runs:
                state[points_in_runs(blocks, self.runs)] = _F
            return state, np.full(blocks.shape, -1, np.int64)
        pos = np.searchsorted(self.nb, blocks)
        pos_c = np.minimum(pos, len(self.nb) - 1)
        found = self.nb[pos_c] == blocks
        cls = np.where(found, self.cls[pos_c], 255)
        state = np.full(blocks.shape, _Z, np.int8)
        state[cls == CLS_FULL] = _F
        state[cls == CLS_BIT] = _B
        state[cls == CLS_GAP] = _G
        slot = np.where(state == _B, self.slots()[pos_c], -1)
        slot = np.where(state == _G, self.gslots()[pos_c], slot)
        if self.has_runs:
            state[(state == _Z) & points_in_runs(blocks, self.runs)] = _F
        return state, slot.astype(np.int64)


@dataclasses.dataclass
class BinaryPlan:
    """Execution plan of one binary set-op."""
    nb: np.ndarray          # result block ids (all classes)
    cls: np.ndarray         # result classes (CLS_BIT entries computed by kernel)
    # for the CLS_BIT result blocks, operand gather descriptors:
    a_slot: np.ndarray      # int64[k] row in pool A or -1
    a_full: np.ndarray      # bool[k]  operand block is FULL
    a_gap: np.ndarray       # int64[k] GAP-store index in A or -1
    b_slot: np.ndarray
    b_full: np.ndarray
    b_gap: np.ndarray
    runs: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY_RUNS)  # result FULL runs


def _plan_runs_and_cand(op, sa: Structure, sb: Structure):
    """Symbolic FULL-run algebra: result runs + the per-block candidate
    ids the point-wise planner must evaluate.  Candidate points never lie
    inside the returned runs (disjointness invariant)."""
    ra, rb = sa.runs, sb.runs
    if op == "and":
        cand = np.intersect1d(sa.nb, sb.nb)
        if sa.has_runs or sb.has_runs:
            extra = [cand]
            if sb.has_runs:
                extra.append(sa.nb[points_in_runs(sa.nb, rb)])
            if sa.has_runs:
                extra.append(sb.nb[points_in_runs(sb.nb, ra)])
            cand = np.unique(np.concatenate(extra))
        rr = runs_intersect(ra, rb)
    elif op == "sub":
        cand = sa.nb.copy()
        if sa.has_runs:
            cand = np.union1d(cand, sb.nb[points_in_runs(sb.nb, ra)])
        rr = runs_subtract_points(runs_diff(ra, rb), sb.nb)
    elif op == "or":
        cand = np.union1d(sa.nb, sb.nb)
        rr = runs_union(ra, rb)
        if rr.shape[0]:
            cand = cand[~points_in_runs(cand, rr)]
    elif op == "xor":
        cand = np.union1d(sa.nb, sb.nb)
        sym = runs_union(runs_diff(ra, rb), runs_diff(rb, ra))
        rr = runs_subtract_points(sym, cand)
    else:
        raise ValueError(op)
    return rr, cand


def plan_binary(op: str, sa: Structure, sb: Structure) -> BinaryPlan:
    """Symbolically resolve FULL/ZERO algebra per block; emit kernel work for
    the rest.  Mirrors the FULL/NULL fast paths of the reference op loops
    (src/bm.h:6628-6676, combine_operation_block_and :7033-7056).  Wide
    FULL runs resolve by interval algebra (the sub-tree fast path)."""
    res_runs, cand = _plan_runs_and_cand(op, sa, sb)

    st_a, sl_a = sa.lookup(cand)
    st_b, sl_b = sb.lookup(cand)

    res_cls = np.full(cand.shape, CLS_BIT, np.uint8)
    drop = np.zeros(cand.shape, bool)

    if op == "and":
        drop |= (st_a == _Z) | (st_b == _Z)
        res_cls[(st_a == _F) & (st_b == _F)] = CLS_FULL
    elif op == "or":
        drop |= (st_a == _Z) & (st_b == _Z)
        res_cls[(st_a == _F) | (st_b == _F)] = CLS_FULL
    elif op == "xor":
        drop |= (st_a == _Z) & (st_b == _Z)
        both_f = (st_a == _F) & (st_b == _F)
        drop |= both_f
        res_cls[((st_a == _F) & (st_b == _Z)) | ((st_a == _Z) & (st_b == _F))] = CLS_FULL
    elif op == "sub":
        drop |= (st_a == _Z) | (st_b == _F)
        res_cls[(st_a == _F) & (st_b == _Z)] = CLS_FULL
    else:
        raise ValueError(op)

    keep = ~drop
    nb = cand[keep]
    cls = res_cls[keep]
    is_kernel = cls == CLS_BIT
    km = keep.copy()
    km[keep] = is_kernel
    return BinaryPlan(
        nb=nb, cls=cls,
        a_slot=np.where(st_a[km] == _B, sl_a[km], -1),
        a_full=(st_a[km] == _F),
        a_gap=np.where(st_a[km] == _G, sl_a[km], -1),
        b_slot=np.where(st_b[km] == _B, sl_b[km], -1),
        b_full=(st_b[km] == _F),
        b_gap=np.where(st_b[km] == _G, sl_b[km], -1),
        runs=res_runs,
    )


def gather_operand(pool, slot, full, aux=None, aux_slot=None):
    """Materialize aligned operand rows: pool rows where slot>=0, all-ones
    rows where full, zero rows otherwise; rows from the transient ``aux``
    array (expanded GAP blocks) where aux_slot>=0.  The kernels take the
    descriptor itself and never materialize these rows."""
    return gather_rows(pool, slot, full, aux, aux_slot)


def expand_gap_operand(store, gap_slots: np.ndarray):
    """Transient dense rows for the GAP blocks referenced by ``gap_slots``
    (-1 = not GAP).  Returns (aux_rows_np[k, 2048], aux_slot[n]) where
    aux_slot maps each input position to its row in aux (or -1).  The
    batched gap_convert_to_bitset upload (src/bmfunc.h:5223)."""
    gap_slots = np.asarray(gap_slots, np.int64)
    used = np.unique(gap_slots[gap_slots >= 0])
    if used.size == 0 or store is None:
        return (np.zeros((0, SET_BLOCK_SIZE), np.uint32),
                np.full(gap_slots.shape, -1, np.int64))
    rows = store.to_dense(used)
    pos = np.searchsorted(used, np.maximum(gap_slots, 0))
    aux_slot = np.where(gap_slots >= 0, pos, -1)
    return rows, aux_slot.astype(np.int64)


def descriptor(pool, slot, full, aux_np, aux_slot):
    """Upload one operand's gather descriptor (pool, slot, full, aux,
    aux_slot) to the pool's device: slots int32, full bool, aux rows from
    host uint32 words."""
    dev = pool.device
    return (pool,
            torch.from_numpy(np.asarray(slot, np.int32)).to(dev),
            torch.from_numpy(np.asarray(full, bool)).to(dev),
            to_device_words(aux_np, dev),
            torch.from_numpy(np.asarray(aux_slot, np.int32)).to(dev))


def operand_args(v, blocklist: np.ndarray):
    """Device-ready 5-tuple (pool, slot, full, aux, aux_slot) for one
    BitVector operand aligned on ``blocklist`` — the gather descriptor the
    set-op / metric kernels take."""
    st, slot = v._struct.lookup(blocklist)
    aux_np, aux_slot = expand_gap_operand(
        v._gaps, np.where(st == _G, slot, -1))
    return descriptor(v._pool, np.where(st == _B, slot, -1), st == _F,
                      aux_np, aux_slot)
