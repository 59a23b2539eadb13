"""Mesh-sharded bit-sliced succinct vectors: the scanner workload at scale
(port of ``bitmagic_tpu/parallel/sharded_sv.py``).

The reference scanner (``bm::sparse_vector_scanner``,
src/bmsparsevec_algo.h:612) searches bit-sliced vectors on one node.  These
containers are its mesh-scale form: ALL value slices of a vector live in
ONE stack ``int32[K, n_blocks_padded, 2048]`` split along the block axis
into one tensor per shard (``mesh.Mesh``); every plane shares the same
split, so slice algebra is entirely shard-local and only per-query counts
and gathered values come to the host.

Layout (rows of the stack):
  * rows ``0 .. n_eff-1`` — value slices (absent slices are zero rows,
    which make slice algebra degrade correctly: AND with an absent slice
    empties the result, AND-NOT is a no-op);
  * row ``n_eff`` (``UNI``) — the universe: the NULL plane when nullable
    (bit set = value assigned), else the dense ``[0, size)`` range.

Per-shard steps run through the ``ops/cuda_kernels`` wrappers of the
single-device port (the kernel on a CUDA tensor, its plain version on a
CPU one):
  * ``find_eq``: a digest pre-pass on the host decides the survivor blocks,
    then ONE B4 launch per shard ANDs / AND-NOTs only the surviving rows;
  * ``find_gt/ge/lt/le/range``: the MSB-first slice descent of the
    single-device scanner, one ``descent_rows`` launch per shard (the
    sign split and the closing unions K1);
  * ``pipeline_find_eq``: one B5 launch per shard for a whole value batch,
    the per-shard partials combined on the host in int64.
Digests and gathers stay plain PyTorch.  On a mesh that spans processes
each process holds its own shards' tensors, and every host combine (the
alive vector, counts, gathered bits, the host image) goes through
``sharded._host_fetch``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..core.bitvector import BitVector
from ..ops import blockops
from ..ops import cuda_kernels as ck
from .mesh import Mesh, block_sharding, make_mesh, pad_rows, zero_rows
from .sharded import (ShardedBitVector, _alive_rows, _answer_by_shard,
                      _host_concat, _host_sum, _index, _scatter_rows,
                      _survivor_rows, pipeline_counts_host)

_I64 = np.int64


def _plane_words(bv, nblk: int) -> np.ndarray:
    """Dense host word image of blocks [0, nblk) of one plane BitVector
    (planes span ID_MAX48, so BitVector.to_words() does not apply)."""
    words = np.zeros((nblk, C.SET_BLOCK_SIZE), np.uint32)
    if bv is None:
        return words
    bv._flush()
    st = bv._struct
    if st.has_runs:
        # run-covered FULL spans are not in st.nb: fill them, clipped
        from ..core.blocks import runs_clip
        for s, e in runs_clip(st.runs, 0, nblk):
            words[int(s):int(e)] = 0xFFFFFFFF
    keep = st.nb < nblk
    fm = keep & (st.cls == C.CLS_FULL)
    words[st.nb[fm]] = 0xFFFFFFFF
    bm = keep & (st.cls == C.CLS_BIT)
    if bm.any():
        sel = st.cls == C.CLS_BIT
        words[st.nb[bm]] = bv._pool_host()[keep[sel]]
    if bv._gaps is not None:
        gm = keep & (st.cls == C.CLS_GAP)
        if gm.any():
            sel = st.cls == C.CLS_GAP
            words[st.nb[gm]] = bv._gaps.to_dense()[keep[sel]]
    return words


def _fill_universe_row(host, row, size):
    """Dense [0, size) universe plane written into host[row] (the
    non-nullable case: every position is assigned)."""
    if not size:
        return
    full, rem = divmod(size, C.BITS_PER_BLOCK)
    host[row, :full] = 0xFFFFFFFF
    if rem:
        tail = np.zeros(C.SET_BLOCK_SIZE, np.uint32)
        fw, rb = divmod(rem, 32)
        tail[:fw] = 0xFFFFFFFF
        if rb:
            tail[fw] = (1 << rb) - 1
        host[row, full] = tail


def _stack_host(n_rows, size, mesh):
    """A zero host stack [n_rows, n_blocks_padded, 2048] for ``size``
    elements and the unpadded block count."""
    nblk = max(C.blocks_for_bits(max(size, 1)), 1)
    return np.zeros((n_rows, pad_rows(nblk, mesh.size), C.SET_BLOCK_SIZE),
                    np.uint32), nblk


def _bv_from_row(words, device):
    bv = BitVector.from_words(words, C.ID_MAX48, device=device)
    bv.optimize()
    return bv


def _k1(op, a, b):
    return ck.logical_op_digest(op, a, b)[0]


def _per_shard(op, pools_a, pools_b):
    return [_k1(op, a, b) for a, b in zip(pools_a, pools_b)]


class _SelectorSearchBase:
    """Shared digest-narrowing search flow for stacked-plane containers.

    Subclasses provide ``stack`` (int32[K, rows, 2048] per local shard),
    ``mesh``, ``size``, ``UNI`` and ``_selector(key) -> int32[K] | None``
    (1 = AND, -1 = AND-NOT per plane; None = the key cannot occur).  The
    flow mirrors the single-device scanner: digest pre-pass (8 B/block) ->
    survivor-only AND-SUB (B4); pipelines push whole key batches through
    one B5 launch per shard, partials combined on the host in int64."""

    @property
    def K(self) -> int:
        return int(self.stack[0].shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.stack[0].shape[1]) * self.mesh.size

    def _wrap(self, shards) -> ShardedBitVector:
        return ShardedBitVector(shards, self.size, self.mesh)

    def to_words(self) -> np.ndarray:
        """Host uint32 image of the whole stack [K, n_blocks, 2048]."""
        return _host_concat(self.mesh, [blockops.to_host_words(s)
                                        for s in self.stack], axis=1)

    def _empty_result(self) -> ShardedBitVector:
        out = self._wrap([zero_rows(s.shape[1], s.device)
                          for s in self.stack])
        out.last_narrowing = (0, self.n_blocks)
        return out

    def _universe_vector(self) -> ShardedBitVector:
        return self._wrap([s[self.UNI].clone() for s in self.stack])

    def _sub_from_uni(self, shards):
        return _per_shard("sub", [s[self.UNI] for s in self.stack], shards)

    def _alive(self, sel) -> np.ndarray:
        """Digest pre-pass for a selector: AND the wave digests of the AND
        rows -> bool[n_blocks] on the host."""
        and_rows = np.flatnonzero(sel == 1).tolist()
        return _alive_rows(self.mesh, [[s[r] for r in and_rows]
                                       for s in self.stack])

    def _sweep(self, sel, shard, rows, counts=False):
        """B4 over one shard's survivor ``rows`` for selector ``sel``."""
        order = np.concatenate([np.flatnonzero(sel == 1),
                                np.flatnonzero(sel == -1)]).tolist()
        slot = _index(rows, shard.device)
        return ck.agg_and_sub(int((sel == 1).sum()),
                              [(shard[r], slot, None, None, None)
                               for r in order],
                              rows=not counts, counts=counts)

    def _search(self, key) -> ShardedBitVector:
        return self._search_sel(self._selector(key))

    def _search_sel(self, sel) -> ShardedBitVector:
        """Digest-narrowed survivor AND-SUB for a prepared selector."""
        if sel is None:
            return self._empty_result()
        alive = self._alive(sel)
        shards = []
        for s, rows in zip(self.stack, _survivor_rows(alive, self.mesh)):
            res = self._sweep(sel, s, rows)[0] if rows.size else None
            shards.append(_scatter_rows(s.shape[1], rows, res, s.device))
        out = self._wrap(shards)
        out.last_narrowing = (int(alive.sum()), int(alive.size))
        return out

    def _search_count(self, key) -> int:
        sel = self._selector(key)
        if sel is None:
            return 0
        alive = self._alive(sel)
        return _host_sum(self.mesh, [
            self._sweep(sel, s, rows, counts=True)[1].sum(dtype=torch.int64)
            if rows.size else 0
            for s, rows in zip(self.stack, _survivor_rows(alive, self.mesh))])

    def _search_ne(self, key) -> ShardedBitVector:
        """Universe minus the eq hits (scanner find_ne)."""
        return self._wrap(self._sub_from_uni(self._search(key).shards))

    def _pipeline(self, keys) -> list:
        sels = np.zeros((len(keys), self.K), np.int32)
        known_zero = []
        for i, k in enumerate(keys):
            sel = self._selector(k)
            if sel is None:
                known_zero.append(i)
            else:
                sels[i] = sel
        out = [int(c) for c in pipeline_counts_host(self.mesh, self.stack,
                                                    sels)]
        for i in known_zero:
            out[i] = 0
        return out

    def _gather_bits(self, ids, rows) -> np.ndarray:
        """uint8[len(rows), n_ids] 0/1 bits of stack ``rows`` at element
        ``ids``: each shard reads one word per row for its own queries."""
        bps = int(self.stack[0].shape[1])
        blk = ids >> C.SET_BLOCK_SHIFT
        tgt = blk // bps

        def bits(i, s, sel):
            t = self.stack[i]
            ridx = _index(np.asarray(rows, np.int64), t.device)[:, None]
            local = _index((blk[sel] - s * bps), t.device)[None, :]
            widx = _index((ids[sel] & C.SET_BLOCK_MASK) >> 5,
                          t.device)[None, :]
            bit = _index(ids[sel] & 31, t.device)
            w = t[ridx, local, widx]                      # [rows, q]
            return ((w >> bit) & 1).to(torch.uint8).cpu().numpy()
        return _answer_by_shard(self.mesh, tgt, bits,
                                np.zeros((len(rows), ids.size), np.uint8),
                                axis=1)

    def _check_ids(self, ids) -> np.ndarray:
        ids = np.asarray(ids, _I64)
        if ids.size and ((ids < 0).any() or (ids >= max(self.size, 1)).any()):
            raise IndexError("gather index out of range")
        return ids


class ShardedSparseVector(_SelectorSearchBase):
    """Block-axis-sharded bit-sliced integer vector with scanner searches."""

    def __init__(self, stack, size: int, mesh: Mesh, dtype, signed: bool,
                 n_slices: int, n_eff: int, nullable: bool):
        self.stack = list(stack)      # int32[K, rows, 2048] per shard
        self.size = int(size)
        self.mesh = mesh
        self.dtype = np.dtype(dtype)
        self.signed = bool(signed)
        self.n_slices = int(n_slices)   # logical slice count (incl. sign)
        self.n_eff = int(n_eff)         # stack rows holding value slices
        self.nullable = bool(nullable)

    # row index of the universe plane
    @property
    def UNI(self) -> int:
        return self.n_eff

    # ------------------------------------------------------------------
    @classmethod
    def from_sparse_vector(cls, sv, mesh=None) -> "ShardedSparseVector":
        mesh = mesh or make_mesh()
        sv._flush()
        size = sv._size
        n_eff = max(sv.effective_slices(), 1)
        host, nblk = _stack_host(n_eff + 1, size, mesh)
        for s in range(n_eff):
            host[s, :nblk] = _plane_words(sv.planes[s], nblk)
        if sv.nullable:
            host[n_eff, :nblk] = _plane_words(sv.null_plane, nblk)
        else:
            _fill_universe_row(host, n_eff, size)
        return cls(block_sharding(mesh, 1).place(host), size, mesh, sv.dtype,
                   sv.signed, sv.n_slices, n_eff, sv.nullable)

    @classmethod
    def from_array(cls, values, mesh=None, dtype=None, nullable=False,
                   null_mask=None) -> "ShardedSparseVector":
        from ..sv.sparse_vector import SparseVector
        sv = SparseVector.from_array(values, dtype=dtype, nullable=nullable,
                                     null_mask=null_mask, device="cpu")
        return cls.from_sparse_vector(sv, mesh)

    def to_sparse_vector(self, device=None):
        """Collect into one SparseVector on ``device`` (by default the first
        local shard's device), planes optimized."""
        from ..sv.sparse_vector import SparseVector
        device = device or self.stack[0].device
        host = self.to_words()
        sv = SparseVector(self.dtype, nullable=self.nullable, device=device)
        for s in range(self.n_eff):
            if host[s].any():
                sv.planes[s] = _bv_from_row(host[s], device)
        if self.nullable:
            sv.null_plane = _bv_from_row(host[self.UNI], device)
        sv._size = self.size
        return sv

    # checkpoint: compressed BMSV blob (succinct at rest)
    def checkpoint_bytes(self, level: int = 6) -> bytes:
        from ..serial.sv_serial import sparse_vector_serialize
        return sparse_vector_serialize(self.to_sparse_vector("cpu"), level)

    @classmethod
    def from_checkpoint(cls, blob: bytes, mesh=None) -> "ShardedSparseVector":
        from ..serial.sv_serial import sparse_vector_deserialize
        return cls.from_sparse_vector(sparse_vector_deserialize(blob, "cpu"),
                                      mesh)

    # ------------------------------------------------------------------
    # selector construction (scanner find_eq decomposition,
    # src/bmsparsevec_algo.h:776: 1-bits -> AND group, 0-bits -> SUB group)
    # ------------------------------------------------------------------
    def _codec(self):
        """A payload-free SparseVector of this dtype (for s2u / u2s)."""
        from ..sv.sparse_vector import SparseVector
        sv = SparseVector.__new__(SparseVector)
        sv.signed = self.signed
        sv.dtype = self.dtype
        return sv

    def _s2u_one(self, value) -> int:
        return int(np.asarray(self._codec().s2u(
            np.asarray([value], self.dtype)))[0])

    def _selector(self, value):
        """int32[K] selector (1 = AND, -1 = AND-NOT per slice; UNI always
        AND), or None when the value cannot occur (a bit above every stored
        slice).  Value 0 maps to AND(UNI) - OR(all slices)."""
        from ..sv.sparse_vector import value_fits
        if not value_fits(value, self.dtype):
            return None                    # unrepresentable: never matches
        u = self._s2u_one(value)
        if u >> self.n_eff:            # a required bit has no stored slice
            return None
        sel = np.full(self.K, -1, np.int32)
        for s in range(self.n_eff):
            if (u >> s) & 1:
                sel[s] = 1
        sel[self.UNI] = 1
        return sel

    # ------------------------------------------------------------------
    def find_eq(self, value) -> ShardedBitVector:
        """All positions holding ``value``, as a sharded hit vector: digest
        narrowing first, then one B4 launch per shard over the survivors."""
        return self._search(value)

    def find_eq_count(self, value) -> int:
        """Global hit count: survivor-only popcount per shard, partials
        combined on the host in int64."""
        return self._search_count(value)

    def find_ne(self, value) -> ShardedBitVector:
        """Assigned positions holding anything but ``value``."""
        return self._search_ne(value)

    def find_zero(self) -> ShardedBitVector:
        """Assigned positions holding 0 (scanner find_zero)."""
        return self._search(0)

    def find_nonzero(self) -> ShardedBitVector:
        """OR of all value slices (scanner find_nonzero semantics,
        src/bmsparsevec_algo.h:1082, not null-masked): one B4 launch per
        shard in OR mode."""
        return self._wrap([
            ck.agg_and_sub(0, [(s[r], None, None, None, None)
                               for r in range(self.n_eff)],
                           or_mode=True)[0] for s in self.stack])

    # ------------------------------------------------------------------
    # ordered searches: MSB-first slice descent per shard
    # ------------------------------------------------------------------
    def _descent(self, universe_mode: int, value: int, lo_row: int,
                 n_bits: int):
        """Per-shard (gt, eq) pools relative to the universe: 0 = UNI,
        1 = UNI & ~sign, 2 = UNI & sign.  One descent_rows launch per
        shard."""
        rows, bits = blockops.descent_steps(
            [lo_row + b for b in range(n_bits)], value)
        out = [ck.descent_rows(s, s[self.UNI], rows, bits, s[0],
                               universe_mode) for s in self.stack]
        return [g for g, _ in out], [e for _, e in out]

    def find_gt(self, value) -> ShardedBitVector:
        """Positions with element > value (find_gt_horizontal,
        src/bmsparsevec_algo.h:1144).  The descent only sees the n_eff
        stored slices, so queries whose magnitude exceeds every storable
        value resolve symbolically here."""
        if not self.signed:
            u = int(value)
            if u < 0:
                return self._universe_vector()
            if u >= (1 << self.n_eff) - 1:
                return self._empty_result()   # no stored value can exceed u
            return self._wrap(self._descent(0, u, 0, self.n_eff)[0])
        value = int(value)
        n_mag = max(self.n_eff - 1, 0)
        max_mag = (1 << n_mag) - 1      # largest storable magnitude field
        if value >= 0:
            if value >= max_mag:
                return self._empty_result()
            return self._wrap(self._descent(1, value, 1, n_mag)[0])
        # negatives store |x|-1 in the magnitude slices (reference s2u):
        # x > value  <=>  stored (-x-1) < (-value-1)
        magq = -value - 1
        if magq > max_mag:
            return self._universe_vector()
        gts, eqs = self._descent(2, magq, 1, n_mag)
        # negatives with stored magnitude < magq, plus every non-negative
        out = []
        for s, gt, eq in zip(self.stack, gts, eqs):
            pos = _k1("sub", s[self.UNI], s[0])
            neg = _k1("and", s[self.UNI], s[0])
            out.append(_k1("or", pos, _k1("sub", neg, _k1("or", gt, eq))))
        return self._wrap(out)

    def find_ge(self, value) -> ShardedBitVector:
        if not self.signed:
            u = int(value)
            if u <= 0:
                return self._universe_vector()
            if u > (1 << self.n_eff) - 1:
                return self._empty_result()
            gts, eqs = self._descent(0, u, 0, self.n_eff)
            return self._wrap(_per_shard("or", gts, eqs))
        return self.find_gt(int(value) - 1)

    def find_lt(self, value) -> ShardedBitVector:
        return self._wrap(self._sub_from_uni(self.find_ge(value).shards))

    def find_le(self, value) -> ShardedBitVector:
        return self._wrap(self._sub_from_uni(self.find_gt(value).shards))

    def find_range(self, lo, hi) -> ShardedBitVector:
        return self._wrap(_per_shard("and", self.find_ge(lo).shards,
                                     self.find_le(hi).shards))

    # ------------------------------------------------------------------
    def pipeline_find_eq(self, values) -> list:
        """Hit counts for a value batch: one B5 launch per shard (scanner
        pipeline src/bmsparsevec_algo.h:653 at mesh scale)."""
        return self._pipeline(values)

    # ------------------------------------------------------------------
    # gather / decode: each shard answers the queries whose block it owns
    # ------------------------------------------------------------------
    def gather(self, ids) -> np.ndarray:
        ids = self._check_ids(ids)
        if ids.size == 0:
            return np.zeros(0, self.dtype)
        bits = self._gather_bits(ids, list(range(self.n_eff + 1)))
        u = np.zeros(ids.size, np.uint64)
        for s in range(self.n_eff):
            u |= bits[s].astype(np.uint64) << np.uint64(s)
        vals = self._codec().u2s(u)
        if self.nullable:
            vals = np.where(bits[self.UNI] == 0,
                            np.asarray(0, self.dtype), vals)
        return np.asarray(vals, self.dtype)

    def decode(self, lo: int, n: int) -> np.ndarray:
        return self.gather(np.arange(lo, lo + n, dtype=_I64))

    def get(self, i):
        return self.gather(np.asarray([i]))[0]

    __getitem__ = get

    def __len__(self):
        return self.size

    def __repr__(self):
        return (f"ShardedSparseVector(dtype={self.dtype}, size={self.size}, "
                f"slices={self.n_eff}, mesh={self.mesh.size} shards)")


class ShardedRSCVector:
    """Mesh-sharded rank-select-compressed vector
    (``bm::rsc_sparse_vector`` at mesh scale): the dense payload is a
    ``ShardedSparseVector`` over compressed slots, NULL membership a
    ``ShardedBitVector`` with a persistent ``ShardedRSIndex``; searches run
    in the compressed domain and rank-decompress through the index."""

    def __init__(self, dense, null_sbv, rs, size, mesh):
        self.dense = dense            # ShardedSparseVector (compressed)
        self.null_sbv = null_sbv      # ShardedBitVector (logical domain)
        self.rs = rs                  # ShardedRSIndex over null_sbv
        self.size = int(size)
        self.mesh = mesh

    # ------------------------------------------------------------------
    @classmethod
    def from_rsc(cls, rsc, mesh=None) -> "ShardedRSCVector":
        mesh = mesh or make_mesh()
        rsc._flush()
        dense = ShardedSparseVector.from_sparse_vector(rsc.dense, mesh)
        ids = np.asarray(rsc.null_bv.indices())
        ids = ids[ids < max(rsc._size, 1)]
        null_sbv = ShardedBitVector.from_indices(
            ids, max(rsc._size, 1), mesh)
        return cls(dense, null_sbv, null_sbv.build_rs_index(), rsc._size,
                   mesh)

    @classmethod
    def from_sparse_vector(cls, sv, mesh=None) -> "ShardedRSCVector":
        from ..sv.rsc_vector import RSCSparseVector
        return cls.from_rsc(RSCSparseVector.from_sparse_vector(sv), mesh)

    def to_rsc(self, device=None):
        """Collect into one RSCSparseVector on ``device`` (by default the
        first local shard's device)."""
        from ..sv.rsc_vector import RSCSparseVector
        device = device or self.dense.stack[0].device
        out = RSCSparseVector(self.dense.dtype, device=device)
        out.dense = self.dense.to_sparse_vector(device)
        out.dense.nullable = False
        out.dense.null_plane = None
        # the RSC NULL index lives in the ID_MAX48 address space
        wide = BitVector(C.ID_MAX48, device=device)
        ids = np.asarray(self.null_sbv.to_bitvector(device).indices())
        if ids.size:
            wide.set_many(ids)
        out.null_bv = wide
        out._size = self.size
        out._rs = None
        return out

    def checkpoint_bytes(self) -> bytes:
        from ..serial.sv_serial import SparseVectorSerializer
        return SparseVectorSerializer().serialize_rsc(self.to_rsc("cpu"))

    @classmethod
    def from_checkpoint(cls, blob: bytes, mesh=None) -> "ShardedRSCVector":
        from ..serial.sv_serial import SparseVectorDeserializer
        return cls.from_rsc(SparseVectorDeserializer("cpu").deserialize(blob),
                            mesh)

    # ------------------------------------------------------------------
    def count(self) -> int:
        """Assigned (non-NULL) element count."""
        return int(self.rs.count())

    def __len__(self):
        return self.size

    def _decompress(self, hits) -> ShardedBitVector:
        """Compressed-domain hit vector -> logical positions through the
        sharded rank-select index (reference rank decompression)."""
        pos = np.asarray(hits.to_bitvector().indices())
        if pos.size == 0:
            return ShardedBitVector.from_indices(
                np.zeros(0, _I64), max(self.size, 1), self.mesh)
        logical = self.rs.select_batch(np.asarray(pos + 1, _I64))
        out = ShardedBitVector.from_indices(
            np.asarray(logical, _I64), max(self.size, 1), self.mesh)
        out.last_narrowing = getattr(hits, "last_narrowing", None)
        return out

    def find_eq(self, value) -> ShardedBitVector:
        """Logical positions holding ``value`` (search shard-local in the
        compressed domain, then one sharded select pass)."""
        return self._decompress(self.dense.find_eq(value))

    def find_eq_count(self, value) -> int:
        return self.dense.find_eq_count(value)

    def find_gt(self, value) -> ShardedBitVector:
        return self._decompress(self.dense.find_gt(value))

    def find_ge(self, value) -> ShardedBitVector:
        return self._decompress(self.dense.find_ge(value))

    def find_lt(self, value) -> ShardedBitVector:
        return self._decompress(self.dense.find_lt(value))

    def find_le(self, value) -> ShardedBitVector:
        return self._decompress(self.dense.find_le(value))

    def find_ne(self, value) -> ShardedBitVector:
        """Assigned slots holding anything but ``value``."""
        return self._decompress(self.dense.find_ne(value))

    def find_range(self, lo, hi) -> ShardedBitVector:
        return self._decompress(self.dense.find_range(lo, hi))

    def pipeline_find_eq(self, values) -> list:
        return self.dense.pipeline_find_eq(values)

    # ------------------------------------------------------------------
    def gather(self, ids):
        """(values, not_null mask) for logical positions; NULL reads 0."""
        ids = np.asarray(ids, _I64)
        if ids.size == 0:
            return (np.zeros(0, self.dense.dtype), np.zeros(0, bool))
        if (ids < 0).any() or (ids >= max(self.size, 1)).any():
            raise IndexError("gather index out of range")
        # assigned = bit set at ids in null_sbv; then ONE rank pass over
        # just the assigned ids gives the value slots
        assigned = self.null_sbv.get_bits(ids)
        vals = np.zeros(ids.size, self.dense.dtype)
        if assigned.any():
            rk = np.asarray(self.rs.rank_batch(ids[assigned]))
            vals[assigned] = self.dense.gather((rk - 1).astype(_I64))
        return vals, assigned

    def try_get(self, i):
        """Value at logical position i, or None when NULL."""
        vals, ok = self.gather([i])
        return self.dense.dtype.type(vals[0]) if ok[0] else None

    def get(self, i):
        vals, _ = self.gather([i])
        return vals[0]

    __getitem__ = get

    def __repr__(self):
        return (f"ShardedRSCVector(dtype={self.dense.dtype}, "
                f"size={self.size}, assigned={self.count()}, "
                f"mesh={self.mesh.size} shards)")


class ShardedStrSparseVector(_SelectorSearchBase):
    """Mesh-sharded string vector: every present octet-bit plane of a
    ``StrSparseVector`` plus the universe plane in ONE stack — the string
    scanner at mesh scale (reference find_eq_str pipeline,
    src/bmsparsevec_algo.h:653 over src/bmstrsparsevec.h).  Selectors have
    one AND / AND-NOT entry per (octet, bit) plane from the remapped
    query image."""

    def __init__(self, stack, size, mesh, max_str_size, nullable, slots,
                 remap_matrices, unmap_matrices):
        self.stack = list(stack)
        self.size = int(size)
        self.mesh = mesh
        self.max_str_size = int(max_str_size)
        self.nullable = bool(nullable)
        self.slots = [tuple(kb) for kb in slots]   # (octet k, bit b) per row
        self.pos_of = {kb: i for i, kb in enumerate(self.slots)}
        self.remap_matrices = remap_matrices
        self.unmap_matrices = unmap_matrices

    @property
    def UNI(self) -> int:
        return len(self.slots)

    # ------------------------------------------------------------------
    @classmethod
    def from_str_vector(cls, ssv, mesh=None) -> "ShardedStrSparseVector":
        mesh = mesh or make_mesh()
        for o in ssv.octets:
            o._flush()
        size = ssv._size
        slots = [(k, b) for k in range(ssv.max_str_size)
                 for b, p in enumerate(ssv.octets[k].planes) if p is not None]
        host, nblk = _stack_host(len(slots) + 1, size, mesh)
        for i, (k, b) in enumerate(slots):
            host[i, :nblk] = _plane_words(ssv.octets[k].planes[b], nblk)
        if ssv.nullable:
            host[len(slots), :nblk] = _plane_words(ssv.null_plane, nblk)
        else:
            _fill_universe_row(host, len(slots), size)
        return cls(block_sharding(mesh, 1).place(host), size, mesh,
                   ssv.max_str_size, ssv.nullable, slots,
                   ssv.remap_matrices, ssv.unmap_matrices)

    @classmethod
    def from_strings(cls, strings, mesh=None, **kw) -> \
            "ShardedStrSparseVector":
        from ..sv.str_vector import StrSparseVector
        kw.setdefault("device", "cpu")
        return cls.from_str_vector(
            StrSparseVector.from_strings(strings, **kw), mesh)

    def _skel(self):
        """Remap-only StrSparseVector view (for remap_value without any
        payload)."""
        from ..sv.str_vector import StrSparseVector
        sk = StrSparseVector.__new__(StrSparseVector)
        sk.max_str_size = self.max_str_size
        sk.remap_matrices = self.remap_matrices
        sk.unmap_matrices = self.unmap_matrices
        return sk

    # ------------------------------------------------------------------
    def _selector_img(self, img, n_octets):
        """Selector of a remapped query image over its first ``n_octets``
        octet positions; None when a set bit has no stored plane."""
        sel = np.zeros(self.K, np.int32)
        for k in range(n_octets):
            code = int(img[k])
            for b in range(8):
                idx = self.pos_of.get((k, b))
                if (code >> b) & 1:
                    if idx is None:
                        return None
                    sel[idx] = 1
                elif idx is not None:
                    sel[idx] = -1
        sel[self.UNI] = 1
        return sel

    def _selector(self, s):
        """int32[K] selector for a query string, or None when the string
        cannot occur (remap miss or a set bit with no stored plane)."""
        img = self._skel().remap_value(s)
        if img is None:
            return None
        return self._selector_img(img, self.max_str_size)

    def find_eq_str(self, s) -> ShardedBitVector:
        """All positions holding string ``s``: digest narrowing + one B4
        launch per shard over the survivors."""
        return self._search(s)

    def _selector_prefix(self, s):
        """Prefix selector: only octet positions < len(s) constrained
        (reference find_eq_str_impl(prefix_sub=false),
        src/bmsparsevec_algo.h:2239; the empty query is the exact
        empty-string selector).  None = the prefix cannot occur."""
        s = s if isinstance(s, str) else bytes(s).decode("latin-1")
        if not s:
            return self._selector("")
        img = self._skel().remap_value(s)
        if img is None:
            return None
        return self._selector_img(img, len(s))

    def find_eq_str_prefix(self, s) -> ShardedBitVector:
        """All positions whose string starts with ``s``."""
        return self._search_sel(self._selector_prefix(s))

    def find_eq_str_count(self, s) -> int:
        return self._search_count(s)

    def pipeline_find_eq_str(self, strings) -> list:
        """Hit counts for a string batch: one B5 launch per shard."""
        return self._pipeline(strings)

    # ------------------------------------------------------------------
    def gather(self, ids) -> list:
        """Decode strings: the owning shard reads one word per plane per
        query; strings are read back as latin-1 (the JAX package's
        convention)."""
        from ..sv.str_vector import _rows_to_str
        ids = self._check_ids(ids)
        if ids.size == 0:
            return []
        bits = self._gather_bits(ids, list(range(self.K)))
        cols = np.zeros((ids.size, self.max_str_size), np.uint8)
        for i, (k, b) in enumerate(self.slots):
            cols[:, k] |= bits[i] << b
        if self.remap_matrices is not None:
            for k in range(self.max_str_size):
                cols[:, k] = self.unmap_matrices[k][cols[:, k]]
        return _rows_to_str(cols, (bits[self.UNI] == 0) if self.nullable
                            else None)

    def get(self, i):
        return self.gather([i])[0]

    __getitem__ = get

    def decode(self, lo: int, n: int) -> list:
        return self.gather(np.arange(lo, lo + n, dtype=_I64))

    def compare(self, i: int, s) -> int:
        """-1/0/1 of element i vs string s (NULL sorts as "")."""
        s = s if isinstance(s, str) else bytes(s).decode("latin-1")
        a = self.get(int(i)) or ""
        return (a > s) - (a < s)

    def __len__(self):
        return self.size

    # ------------------------------------------------------------------
    def to_str_vector(self, device=None):
        """Collect into one StrSparseVector on ``device`` (by default the
        first local shard's device)."""
        from ..sv.str_vector import StrSparseVector
        device = device or self.stack[0].device
        host = self.to_words()
        out = StrSparseVector(self.max_str_size, nullable=self.nullable,
                              device=device)
        for i, (k, b) in enumerate(self.slots):
            if host[i].any():
                out.octets[k].planes[b] = _bv_from_row(host[i], device)
        for o in out.octets:
            o._size = self.size
        if self.nullable:
            out.null_plane = _bv_from_row(host[self.UNI], device)
        out._size = self.size
        out.remap_matrices = self.remap_matrices
        out.unmap_matrices = self.unmap_matrices
        return out

    def checkpoint_bytes(self) -> bytes:
        from ..serial.sv_serial import SparseVectorSerializer
        return SparseVectorSerializer().serialize_str(
            self.to_str_vector("cpu"))

    @classmethod
    def from_checkpoint(cls, blob: bytes, mesh=None) -> \
            "ShardedStrSparseVector":
        from ..serial.sv_serial import SparseVectorDeserializer
        return cls.from_str_vector(
            SparseVectorDeserializer("cpu").deserialize(blob), mesh)

    def __repr__(self):
        return (f"ShardedStrSparseVector(size={self.size}, "
                f"octets={self.max_str_size}, planes={len(self.slots)}, "
                f"mesh={self.mesh.size} shards)")


class ShardedFloatVector(_SelectorSearchBase):
    """Mesh-sharded float vector (``bm::sparse_vector_float`` at mesh
    scale): the IEEE-754 sign/exponent/mantissa split of a
    ``FloatSparseVector`` in ONE stack.

    Stack rows: mantissa slices [0, man_eff), exponent slices
    [man_eff, man_eff+exp_eff), then the sign plane, then the universe.
    Magnitude bit s of the (exp << man_bits) | mantissa image maps through
    ``self.rows`` (-1 = no element stores that bit: the descent treats it
    as a zero plane, the eq selector resolves a required absent bit
    symbolically).

    find_eq rides the digest-narrowing selector flow; ordered searches run
    the magnitude descent with the float scanner's sign-class assembly
    (lexicographic (exp, mantissa) per sign class, order reversed for
    negatives, stored -0.0 moved to the non-negative class)."""

    def __init__(self, stack, size, mesh, dtype, rows, sign_row, nullable):
        self.stack = list(stack)
        self.size = int(size)
        self.mesh = mesh
        self.dtype = np.dtype(dtype)
        self._uint = np.uint32 if self.dtype == np.float32 else np.uint64
        self._eb = 8 if self.dtype == np.float32 else 11
        self._mb = 23 if self.dtype == np.float32 else 52
        self.rows = tuple(rows)        # magnitude bit s -> stack row / -1
        self.SIGN = int(sign_row)
        self.nullable = bool(nullable)

    @property
    def UNI(self) -> int:
        return self.SIGN + 1

    # ------------------------------------------------------------------
    @classmethod
    def from_float_vector(cls, fv, mesh=None) -> "ShardedFloatVector":
        mesh = mesh or make_mesh()
        fv.mantissa._flush()
        fv.exponent._flush()
        fv.sign._flush()
        size = fv._size
        man_eff = fv.mantissa.effective_slices()
        exp_eff = fv.exponent.effective_slices()
        eb = 8 if fv.dtype == np.float32 else 11
        mb = 23 if fv.dtype == np.float32 else 52
        rows = [(s if s < man_eff else -1) for s in range(mb)] + \
               [(man_eff + e if e < exp_eff else -1) for e in range(eb)]
        sign_row = man_eff + exp_eff
        host, nblk = _stack_host(sign_row + 2, size, mesh)
        for s in range(man_eff):
            host[s, :nblk] = _plane_words(fv.mantissa.planes[s], nblk)
        for e in range(exp_eff):
            host[man_eff + e, :nblk] = _plane_words(
                fv.exponent.planes[e], nblk)
        host[sign_row, :nblk] = _plane_words(fv.sign, nblk)
        if fv.nullable:
            host[sign_row + 1, :nblk] = _plane_words(fv.null_plane, nblk)
        else:
            _fill_universe_row(host, sign_row + 1, size)
        return cls(block_sharding(mesh, 1).place(host), size, mesh, fv.dtype,
                   rows, sign_row, fv.nullable)

    @classmethod
    def from_array(cls, values, mesh=None, dtype=None,
                   nullable=False) -> "ShardedFloatVector":
        from ..sv.float_vector import FloatSparseVector
        return cls.from_float_vector(
            FloatSparseVector.from_array(values, dtype=dtype,
                                         nullable=nullable, device="cpu"),
            mesh)

    def to_float_vector(self, device=None):
        """Collect into one FloatSparseVector on ``device`` (by default the
        first local shard's device)."""
        from ..sv.float_vector import FloatSparseVector
        device = device or self.stack[0].device
        host = self.to_words()
        fv = FloatSparseVector(self.dtype, nullable=self.nullable,
                               device=device)
        for s, r in enumerate(self.rows):
            if r < 0 or not host[r].any():
                continue
            part = fv.mantissa if s < self._mb else fv.exponent
            part.planes[s if s < self._mb else s - self._mb] = _bv_from_row(
                host[r], device)
        fv.sign = _bv_from_row(host[self.SIGN], device)
        if self.nullable:
            fv.null_plane = _bv_from_row(host[self.UNI], device)
        fv.mantissa._size = fv.exponent._size = self.size
        fv._size = self.size
        return fv

    def checkpoint_bytes(self) -> bytes:
        from ..serial.sv_serial import SparseVectorSerializer
        return SparseVectorSerializer().serialize_float(
            self.to_float_vector("cpu"))

    @classmethod
    def from_checkpoint(cls, blob: bytes, mesh=None) -> "ShardedFloatVector":
        from ..serial.sv_serial import SparseVectorDeserializer
        return cls.from_float_vector(
            SparseVectorDeserializer("cpu").deserialize(blob), mesh)

    # ------------------------------------------------------------------
    def _parts(self, value):
        u = int(np.asarray([value], self.dtype).view(self._uint)[0])
        sign = u >> (self._eb + self._mb)
        exp = (u >> self._mb) & ((1 << self._eb) - 1)
        mant = u & ((1 << self._mb) - 1)
        if exp == 0 and mant == 0:
            sign = 0                     # -0.0 compares equal to +0.0
        return sign, exp, mant

    def _selector(self, value):
        """Equality selector over magnitude rows + sign + universe (the
        scanner find_eq_float decomposition; None = value cannot occur)."""
        sign, exp, mant = self._parts(value)
        mag = (exp << self._mb) | mant
        sel = np.zeros(self.K, np.int32)
        for s, r in enumerate(self.rows):
            if (mag >> s) & 1:
                if r < 0:                # a required bit no element stores
                    return None
                sel[r] = 1
            elif r >= 0:
                sel[r] = -1
        if not (exp == 0 and mant == 0):
            sel[self.SIGN] = 1 if sign else -1
        sel[self.UNI] = 1
        return sel

    def find_eq(self, value) -> ShardedBitVector:
        """All positions holding ``value`` (digest narrowing + one B4 launch
        per shard; +-0.0 match each other)."""
        return self._search(value)

    def find_eq_count(self, value) -> int:
        return self._search_count(value)

    def find_ne(self, value) -> ShardedBitVector:
        """Assigned positions holding anything but ``value``."""
        return self._search_ne(value)

    def pipeline_find_eq(self, values) -> list:
        """Hit counts for a float batch: one B5 launch per shard."""
        return self._pipeline(values)

    # ------------------------------------------------------------------
    def _gt_eq(self, value):
        """Per-shard (x > value, x == value) pools of the float ordering
        (scanner find_gt_float semantics).  The zero-magnitude class is one
        B4 launch (UNI AND-NOT every magnitude row), the sign classes K1,
        the descent one descent_rows launch (a -1 row a zero plane)."""
        sign, exp, mant = self._parts(value)
        rows, bits = blockops.descent_steps(self.rows,
                                            (exp << self._mb) | mant)
        stored = [r for r in self.rows if r >= 0]
        gts, eqs = [], []
        for s in self.stack:
            uni, sgn = s[self.UNI], s[self.SIGN]
            mag_zero = ck.agg_and_sub(1, [(s[r], None, None, None, None)
                                          for r in [self.UNI] + stored])[0]
            pos = _k1("or", _k1("sub", uni, sgn), _k1("and", mag_zero, sgn))
            neg = _k1("sub", _k1("and", uni, sgn), mag_zero)
            gt, eq = ck.descent_rows(s, neg if sign else pos, rows, bits)
            if sign:
                gt = _k1("or", pos, _k1("sub", neg, _k1("or", gt, eq)))
            gts.append(gt)
            eqs.append(eq)
        return gts, eqs

    def find_gt(self, value) -> ShardedBitVector:
        return self._wrap(self._gt_eq(value)[0])

    def find_ge(self, value) -> ShardedBitVector:
        gts, eqs = self._gt_eq(value)
        return self._wrap(_per_shard("or", gts, eqs))

    def find_le(self, value) -> ShardedBitVector:
        return self._wrap(self._sub_from_uni(self._gt_eq(value)[0]))

    def find_lt(self, value) -> ShardedBitVector:
        gts, eqs = self._gt_eq(value)
        return self._wrap(self._sub_from_uni(_per_shard("or", gts, eqs)))

    def find_range(self, lo, hi) -> ShardedBitVector:
        return self._wrap(_per_shard("and", self.find_ge(lo).shards,
                                     self.find_le(hi).shards))

    # ------------------------------------------------------------------
    def gather(self, ids) -> np.ndarray:
        """Decode floats (NULL positions read 0.0)."""
        ids = self._check_ids(ids)
        if ids.size == 0:
            return np.zeros(0, self.dtype)
        bits = self._gather_bits(ids, list(range(self.K))).astype(np.uint64)
        u = np.zeros(ids.size, np.uint64)
        for s, r in enumerate(self.rows):
            if r >= 0:
                u |= bits[r] << np.uint64(s)
        u |= bits[self.SIGN] << np.uint64(self._eb + self._mb)
        vals = u.view(np.float64) if self.dtype == np.float64 \
            else u.astype(np.uint32).view(np.float32)
        if self.nullable:
            vals = np.where(bits[self.UNI] == 0,
                            np.asarray(0, self.dtype), vals)
        return np.asarray(vals, self.dtype)

    def decode(self, lo: int, n: int) -> np.ndarray:
        return self.gather(np.arange(lo, lo + n, dtype=_I64))

    def get(self, i):
        return self.gather(np.asarray([i]))[0]

    __getitem__ = get

    def __len__(self):
        return self.size

    def __repr__(self):
        return (f"ShardedFloatVector(dtype={self.dtype}, size={self.size}, "
                f"rows={self.K}, mesh={self.mesh.size} shards)")
