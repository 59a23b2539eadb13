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
from ..ops import cuda_kernels as ck
from ..ops.blockops import (DIR_RUN, DIR_ZERO, PLANE_COLS, PlaneTable,
                            gather_rows)

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


def expand_gap_operand(store, gap_slots: np.ndarray, device):
    """Transient dense rows for the GAP blocks referenced by ``gap_slots``
    (-1 = not GAP).  Returns (aux rows int32[k, 2048] on ``device``,
    aux_slot[n]) where aux_slot maps each input position to its row in aux
    (or -1).  The batched gap_convert_to_bitset (src/bmfunc.h:5223), built
    on the device by kernel gap_expand from the store's mirror."""
    gap_slots = np.asarray(gap_slots, np.int64)
    used = np.unique(gap_slots[gap_slots >= 0])
    if used.size == 0 or store is None:
        rows = torch.zeros((0, SET_BLOCK_SIZE), dtype=torch.int32,
                           device=device)
        return rows, np.full(gap_slots.shape, -1, np.int64)
    rows = ck.gap_expand(*store.device_arrays(device), torch.from_numpy(
        used.astype(np.int32)).to(device))
    pos = np.searchsorted(used, np.maximum(gap_slots, 0))
    aux_slot = np.where(gap_slots >= 0, pos, -1)
    return rows, aux_slot.astype(np.int64)


def descriptor(pool, slot, full, store, gap_slots):
    """One operand's gather descriptor (pool, slot, full, aux, aux_slot) on
    the pool's device: slots int32, full bool, and the GAP blocks
    ``gap_slots`` of ``store`` (-1 = not GAP) expanded there into aux."""
    dev = pool.device
    aux, aux_slot = expand_gap_operand(store, gap_slots, dev)
    return (pool,
            torch.from_numpy(np.asarray(slot, np.int32)).to(dev),
            torch.from_numpy(np.asarray(full, bool)).to(dev),
            aux,
            torch.from_numpy(np.asarray(aux_slot, np.int32)).to(dev))


def descriptor_pair(a, b):
    """Both operands' gather descriptors of a binary op, each given as
    ``(pool, slot, full, store, gap_slots)`` (see ``descriptor``), with
    the GAP blocks of both expanded by one ``gap_expand`` launch from one
    upload of their store indices: one aux tensor, a's rows first, whose
    halves are the two descriptors' aux."""
    dev = a[0].device
    used = [np.unique(np.asarray(g, np.int64)[np.asarray(g) >= 0])
            if store is not None else np.zeros(0, np.int64)
            for _, _, _, store, g in (a, b)]
    k_a = used[0].size
    sel = torch.from_numpy(np.concatenate(used).astype(np.int32)).to(dev)
    aux = ck.gap_expand_pair(*(
        x[3].device_arrays(dev) if u.size else None
        for x, u in ((a, used[0]), (b, used[1]))), sel, k_a)
    out = []
    for (pool, slot, full, _, g), u, rows in zip(
            (a, b), used, (aux[:k_a], aux[k_a:])):
        g = np.asarray(g, np.int64)
        aux_slot = np.where(g >= 0, np.searchsorted(u, np.maximum(g, 0)), -1)
        out.append((pool,
                    torch.from_numpy(np.asarray(slot, np.int32)).to(dev),
                    torch.from_numpy(np.asarray(full, bool)).to(dev),
                    rows,
                    torch.from_numpy(aux_slot.astype(np.int32)).to(dev)))
    return tuple(out)


def operand_args(v, blocklist: np.ndarray):
    """Device-ready 5-tuple (pool, slot, full, aux, aux_slot) for one
    BitVector operand aligned on ``blocklist`` — the gather descriptor the
    set-op / metric kernels take."""
    return descriptor(*_operand_parts(v, blocklist))


def _operand_parts(v, blocklist):
    st, slot = v._struct.lookup(blocklist)
    return (v._pool, np.where(st == _B, slot, -1), st == _F, v._gaps,
            np.where(st == _G, slot, -1))


def operand_args_pair(a, b, blocklist: np.ndarray):
    """``operand_args`` of vectors a and b on one blocklist, their GAP
    blocks expanded in one launch (``descriptor_pair``)."""
    return descriptor_pair(_operand_parts(a, blocklist),
                           _operand_parts(b, blocklist))


def plane_directory(nbs, ents, runs):
    """The host block directory of planes given by their sorted block ids
    ``nbs``, entry codes ``ents`` and FULL runs ``runs`` (int64[k, 2]
    each): the sorted breakpoints and int32[breakpoints + 1, P], row ``r``
    holding every plane's code for the blocks with ``r`` breakpoints at or
    below them (``blockops.PlaneTable``), ``DIR_RUN`` inside a FULL run
    (the device directory writes -1 there, as for a FULL entry)."""
    P = len(nbs)
    pts = np.unique(np.concatenate(
        [np.zeros(0, np.int64)] + [x for nb in nbs for x in (nb, nb + 1)]
        + [r.reshape(-1) for r in runs]))
    rows = pts.size + 1
    d = np.full((rows, P), DIR_ZERO, np.int32)
    for p in range(P):
        if runs[p].shape[0]:
            cover = np.zeros(rows + 1, np.int64)
            np.add.at(cover, np.searchsorted(pts, runs[p][:, 0]) + 1, 1)
            np.add.at(cover, np.searchsorted(pts, runs[p][:, 1]) + 1, -1)
            d[np.cumsum(cover)[:rows] > 0, p] = DIR_RUN
        d[np.searchsorted(pts, nbs[p]) + 1, p] = ents[p]
    return pts, d


def entry_codes(st: Structure) -> np.ndarray:
    """int32 entry code of each of a structure's blocks ``st.nb``: its
    pool row (BIT), -1 (FULL) or -2 - g (D-GAP block g of its store)."""
    ent = np.where(st.cls == CLS_BIT, st.slots(), -1)
    return np.where(st.cls == CLS_GAP, -2 - st.gslots(), ent).astype(
        np.int32)


def block_codes(st: Structure, blocks) -> np.ndarray:
    """int32 code of one plane at the sorted block ids ``blocks`` by
    searches of its block ids and FULL runs: its entry code
    (``entry_codes``), ``DIR_RUN`` inside a FULL run, else ``DIR_ZERO``."""
    blocks = np.asarray(blocks, np.int64)
    code = np.full(blocks.shape, DIR_ZERO, np.int32)
    runs = st.runs.reshape(-1, 2)
    if runs.shape[0]:               # the last run starting at or before
        k = np.searchsorted(runs[:, 0], blocks, side="right") - 1
        code[(k >= 0) & (blocks < runs[np.maximum(k, 0), 1])] = DIR_RUN
    if st.nb.size:
        pos = np.minimum(np.searchsorted(st.nb, blocks), st.nb.size - 1)
        hit = st.nb[pos] == blocks
        code[hit] = entry_codes(st)[pos[hit]]
    return code


def descent_codes(table: PlaneTable, rows, uni: Structure, blocks):
    """sv_descent's codes of the walked blocks ``blocks`` (sorted ids):
    int32[K, len(rows) + 1], column i the code of the column's plane of
    table row ``rows[i]`` (from the host directory: one search for every
    plane) and the last column the universe's (``block_codes``).  A code
    is a pool row (BIT), -1 (a FULL entry), ``DIR_RUN`` (inside a FULL
    run), -2 - g (D-GAP block g) or ``DIR_ZERO``."""
    blocks = np.asarray(blocks, np.int64)
    codes = np.empty((blocks.size, len(rows) + 1), np.int32)
    r = np.searchsorted(table.host_bps, blocks, side="right")
    codes[:, :-1] = table.host_dir.take(r, axis=0).take(rows, axis=1)
    codes[:, -1] = block_codes(uni, blocks)
    return codes


def plane_table(planes, device, extra=None) -> PlaneTable:
    """The plane table kernels sv_gather and sv_descent read
    (``blockops.PlaneTable``) of ``planes``, a list of ``(bit, Structure,
    pool, GapStore or None)`` (bit -1: the NULL plane), on ``device``:
    O(blocks + runs) host work from the structures' arrays and the block
    directory, one upload (with ``extra``, an int64 host array, when
    given), and each GAP store's device mirror."""
    P = len(planes)
    meta = np.zeros((P, len(PLANE_COLS)), np.int64)
    nbs, ents, runs, pools, gaps = [], [], [], [], []
    nb_off = run_off = 0
    for p, (bit, st, pool, store) in enumerate(planes):
        is_bit, is_gap = st.cls == CLS_BIT, st.cls == CLS_GAP
        if pool.shape[0] < int(is_bit.sum()) or (is_gap.any()
                                                 and store is None):
            raise ValueError("plane_table: structure and storage disagree")
        mirror = store.device_arrays(device) if store is not None else None
        nbs.append(st.nb)
        ents.append(entry_codes(st))
        runs.append(st.runs.reshape(-1, 2))
        pools.append(pool)
        gaps.append(mirror)
        gap_ptrs = ([m.data_ptr() for m in mirror] if mirror is not None
                    else [0, 0, 0])
        meta[p] = (nb_off, st.nb.size, run_off, st.runs.shape[0],
                   pool.data_ptr(), *gap_ptrs, bit)
        nb_off += st.nb.size
        run_off += st.runs.shape[0]
    pts, host_dir = plane_directory(nbs, ents, runs)
    dirs = np.where(host_dir == DIR_RUN, np.int32(-1), host_dir)

    def words(a):                   # int32 -> int64 words, zero padded
        return np.concatenate([a.ravel(), np.zeros(a.size % 2, np.int32)]
                              ).view(np.int64)

    extra = np.zeros(0, np.int64) if extra is None else np.asarray(
        extra, np.int64)
    parts = [meta.ravel(), *nbs, *(r.ravel() for r in runs),
             words(np.concatenate(ents + [np.zeros(0, np.int32)])), pts,
             words(dirs), extra]
    buf = torch.from_numpy(np.concatenate(parts)).to(device)
    at = np.cumsum([0, meta.size, nb_off, 2 * run_off, -(-nb_off // 2),
                    pts.size, -(-dirs.size // 2), extra.size])

    def int32s(k, n):
        if not n:
            return torch.zeros(0, dtype=torch.int32, device=buf.device)
        return buf[at[k]:at[k + 1]].view(torch.int32)[:n]

    return PlaneTable(
        meta=meta, table=buf[:at[1]].view(P, len(PLANE_COLS)),
        nb=buf[at[1]:at[2]], runs=buf[at[2]:at[3]].view(run_off, 2),
        ent=int32s(3, nb_off), pools=pools, gaps=gaps,
        blocks=np.unique(np.concatenate([np.zeros(0, np.int64), *nbs])),
        bps=buf[at[4]:at[5]], dir=int32s(5, dirs.size).view(pts.size + 1, P),
        bit_rows=int((dirs >= 0).any(axis=1).sum()) if P else 0,
        host_bps=pts, host_dir=host_dir,
        extra=buf[at[6]:at[7]] if extra.size else None)
