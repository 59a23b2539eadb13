"""Mesh-sharded bit-vector: dense block rows partitioned over devices (port
of ``bitmagic_tpu/parallel/sharded.py``).

A ``ShardedBitVector`` holds the FULL logical range as dense rows
``int32[n_blocks_padded, 2048]`` split along the block axis into one
tensor per shard, each on its shard's device (``mesh.Mesh``).  The JAX
package's ``shard_map`` programs become a loop over the shards with one
launch per shard per step; what they sum with ``psum`` or gather with
``all_gather`` comes to the host as per-shard partials and combines there
in int64.  It is a single controller, like a JAX mesh: no
``torch.distributed`` here.

Per-shard steps run through the same ``ops/cuda_kernels`` wrappers as the
single-device port (the kernel on a CUDA tensor, its plain version on a
CPU one):

  * set algebra: K1 ``logical_op_digest``;
  * ``count``, ``block_counts`` and the count partials: K3
    ``block_counts_total``;
  * the AND / AND-SUB over survivor rows (``sharded_and_many``,
    ``sharded_and_sub(_count)``, ``group_and_exchange``): B4
    ``agg_and_sub`` on a descriptor of that shard's rows;
  * ``pipeline_counts_program``: B5 per shard;
  * ``scan_throughput_program``: B6 ``scan_eq`` and K3 per shard.

Digests, gathers, rank / select and range masks stay plain PyTorch, as in
the single-device port.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..core.bitvector import BitVector
from ..ops import blockops
from ..ops import cuda_kernels as ck
from ..ops.bitops import popcount, u32_to_i32
from ..ops.select import global_wave_prefix, select_flat
from .mesh import Mesh, block_sharding, make_mesh, pad_rows, zero_rows

_I64 = torch.int64

# The JAX package's one-call select program carries GLOBAL ranks and
# positions as device int32; a pool of this many bits or more takes its
# rs_index path (host int64 cross-shard combine).  The port keeps the same
# routing; both of its paths combine on the host in int64.
_FUSED_SELECT_CAP = 2**31


def _aligned(t):
    """B4 descriptor of every row of ``t``."""
    return (t, None, None, None, None)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _host_total(totals) -> int:
    """Sum of per-shard 0-d int64 tensors, on the host in int64."""
    return int(sum(int(t) for t in totals))


def placed(x, mesh: Mesh, axis: int) -> list[torch.Tensor]:
    """``x`` as per-shard tensors split along ``axis`` over ``mesh``: a list
    of per-shard tensors (checked to lie on their shards' devices) or a
    host array / tensor to split."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
        for t, d in zip(x, mesh.devices):
            if t.device != d:
                raise ValueError(f"shard on {t.device}, mesh wants {d}")
        return list(x)
    return block_sharding(mesh, axis).place(x)


class ShardedBitVector:
    """Dense, mesh-sharded bit-vector covering [0, size)."""

    def __init__(self, shards, size: int, mesh: Mesh):
        self.shards = list(shards)   # int32[blocks_per_shard, 2048] each
        self.size = int(size)
        self.mesh = mesh
        self._rs = None              # cached ShardedRSIndex
        # (survivors, total) blocks of the digest-narrowed op that produced
        # this vector; None when no narrowing took place
        self.last_narrowing = None

    @property
    def blocks_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def n_blocks(self) -> int:
        return self.blocks_per_shard * self.mesh.size

    @property
    def shard_span(self) -> int:
        return self.blocks_per_shard * C.BITS_PER_BLOCK

    # ------------------------------------------------------------------
    @classmethod
    def from_words(cls, words, size: int, mesh=None) -> "ShardedBitVector":
        """From a host uint32 word image ``[n, 2048]`` of [0, size)."""
        mesh = mesh or make_mesh()
        nblk = max(C.blocks_for_bits(size), 1)
        nblk_p = pad_rows(nblk, mesh.size)
        w = np.asarray(words, np.uint32).reshape(-1, C.SET_BLOCK_SIZE)
        if w.shape[0] < nblk_p:
            w = np.concatenate([w, np.zeros((nblk_p - w.shape[0],
                                             C.SET_BLOCK_SIZE), np.uint32)])
        return cls(block_sharding(mesh).place(w[:nblk_p]), size, mesh)

    @classmethod
    def from_bitvector(cls, bv: BitVector, mesh=None) -> "ShardedBitVector":
        return cls.from_words(bv.to_words(), bv.size, mesh)

    @classmethod
    def from_indices(cls, ids, size: int, mesh=None) -> "ShardedBitVector":
        return cls.from_bitvector(
            BitVector.from_indices(ids, size, device="cpu"), mesh)

    def to_words(self) -> np.ndarray:
        """Host uint32 image of every row, padding rows included."""
        return np.concatenate([blockops.to_host_words(s)
                               for s in self.shards])

    def to_bitvector(self, device=None) -> BitVector:
        """Collect into one BitVector on ``device`` (by default the first
        shard's device), optimized."""
        bv = BitVector.from_words(self.to_words(), self.size,
                                  device=device or self.mesh.devices[0])
        bv.optimize()
        return bv

    def reshard(self, mesh: Mesh) -> "ShardedBitVector":
        """Repartition onto another mesh: each new shard takes its rows
        from the old shards, moved to its device explicitly."""
        nblk = max(C.blocks_for_bits(self.size), 1)
        bps = pad_rows(nblk, mesh.size) // mesh.size
        old = self.blocks_per_shard
        shards = []
        for j, dev in enumerate(mesh.devices):
            lo, hi = j * bps, (j + 1) * bps
            parts = []
            for s, t in enumerate(self.shards):
                a, b = max(lo, s * old), min(hi, (s + 1) * old)
                if a < b:
                    parts.append(t[a - s * old:b - s * old].to(dev))
            have = sum(p.shape[0] for p in parts)
            if have < bps:
                parts.append(zero_rows(bps - have, dev))
            shards.append(torch.cat(parts).contiguous())
        return ShardedBitVector(shards, self.size, mesh)

    # ------------------------------------------------------------------
    # checkpoint: compressed BLOB in, compressed BLOB out (the reference's
    # two-stage memory model, README "succinct in RAM <-> BLOB at rest")
    # ------------------------------------------------------------------
    def checkpoint_bytes(self, level: int = 6) -> bytes:
        """Serialize to a compressed BMT1 BLOB (succinct at rest)."""
        from ..serial.serializer import Serializer
        return Serializer(level).serialize(self.to_bitvector(device="cpu"))

    @classmethod
    def from_checkpoint(cls, blob: bytes, mesh=None) -> "ShardedBitVector":
        from ..serial.serializer import Deserializer
        return cls.from_bitvector(Deserializer("cpu").deserialize(blob),
                                  mesh)

    # ------------------------------------------------------------------
    # set algebra: block-local, one K1 launch per shard
    # ------------------------------------------------------------------
    def _bin(self, other, op):
        if self.mesh != other.mesh or \
                self.blocks_per_shard != other.blocks_per_shard:
            raise ValueError("operands are sharded differently")
        shards = [ck.logical_op_digest(op, a, b)[0]
                  for a, b in zip(self.shards, other.shards)]
        return ShardedBitVector(shards, max(self.size, other.size),
                                self.mesh)

    def __and__(self, o): return self._bin(o, "and")
    def __or__(self, o): return self._bin(o, "or")
    def __xor__(self, o): return self._bin(o, "xor")
    def __sub__(self, o): return self._bin(o, "sub")

    def invert(self) -> "ShardedBitVector":
        return ShardedBitVector([~s for s in self.shards], self.size,
                                self.mesh)

    # ------------------------------------------------------------------
    # reductions: per-shard partials, combined on the host in int64
    # ------------------------------------------------------------------
    def count(self) -> int:
        return _host_total(ck.block_counts_total(s)[0] for s in self.shards)

    def count_shardmap(self) -> int:
        """The JAX package's explicit-collective variant; here the same
        per-shard K3 partials as count()."""
        return self.count()

    def count_range(self, lo: int, hi: int) -> int:
        span = self.shard_span
        total = 0
        for s, t in enumerate(self.shards):
            a, b = max(int(lo), s * span), min(int(hi), (s + 1) * span - 1)
            if a <= b:
                total += blockops.count_range_pool(t, a - s * span,
                                                   b - s * span)
        return total

    def build_rs_index(self) -> "ShardedRSIndex":
        """Build (once) and cache the persistent sharded rank/select index
        (shard-local wave prefixes + host shard totals)."""
        if self._rs is None:
            self._rs = ShardedRSIndex(self)
        return self._rs

    def rank(self, i: int) -> int:
        """popcount[0, i] via the persistent index."""
        return self.build_rs_index().rank(i)

    def rank_scan(self, i: int) -> int:
        """Index-free rank: a masked count over the pool (kept for
        cross-checking the index path)."""
        return self.count_range(0, i)

    def block_counts(self) -> np.ndarray:
        """Per-block popcounts of every row (padding included), int32 on
        the host."""
        return np.concatenate([
            ck.block_counts_total(s, per_block=True)[1].cpu().numpy()
            for s in self.shards])

    # ------------------------------------------------------------------
    # select: shard totals' exclusive prefix on the host + local descent
    # ------------------------------------------------------------------
    def select_batch(self, ranks) -> np.ndarray:
        """Batched select1 across the mesh (rank/select = per-shard prefix
        sums + an exclusive scan across shards).  Uses the persistent
        ShardedRSIndex when built; out-of-range ranks answer -1."""
        if self._rs is not None:
            return self._rs.select_batch(ranks)
        capacity = self.n_blocks * C.BITS_PER_BLOCK
        if capacity >= _FUSED_SELECT_CAP:
            return self.build_rs_index().select_batch(ranks)
        return ShardedRSIndex(self).select_batch(ranks)

    def select(self, rank: int) -> int:
        return int(self.select_batch([rank])[0])

    def digests(self) -> np.ndarray:
        """Per-block wave digests int32[n_blocks, 64] of 0/1 on the host
        (the 8-byte/block exchange currency)."""
        return np.concatenate([blockops.calc_digest(s).cpu().numpy()
                               for s in self.shards])

    def get_bits(self, ids) -> np.ndarray:
        """Bit values at global positions ids, as a bool array: each shard
        reads the containing word of its own queries."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return np.zeros(0, bool)
        span = self.shard_span
        q = np.clip(ids, 0, self.n_blocks * C.BITS_PER_BLOCK - 1)
        tgt = q // span
        rel = q - tgt * span
        out = np.zeros(ids.size, bool)
        for s in np.unique(tgt).tolist():
            sel = tgt == s
            t = self.shards[s]
            r = _index(rel[sel], t.device)
            w = t.reshape(-1)[r >> 5]
            out[sel] = ((w >> (r & 31)) & 1).cpu().numpy().astype(bool)
        out[(ids < 0) | (ids != q)] = False      # out-of-range reads 0
        return out


def _gwc(shard) -> torch.Tensor:
    """Inclusive popcount prefix over every wave of one shard, int32."""
    return global_wave_prefix(shard)


def _rank_local(shard, gwc, rel) -> torch.Tensor:
    """popcount of bits [0, rel] of one shard (rel int64 on its device):
    whole waves from the prefix, the query's wave masked."""
    wave = rel >> 10
    prev = torch.where(wave > 0, gwc[(wave - 1).clamp(min=0)], 0)
    words = shard.reshape(-1, C.WAVE_WORDS)[wave]            # [q, 32]
    bit = rel & 1023
    wword = (bit >> 5)[:, None]
    part = u32_to_i32((torch.full_like(bit, 2) << (bit & 31)) - 1)[:, None]
    j = torch.arange(C.WAVE_WORDS, device=shard.device)[None, :]
    mask = torch.where(j < wword, -1, torch.where(j == wword, part, 0))
    return prev.to(_I64) + popcount(words & mask).sum(dim=1, dtype=_I64)


# ---------------------------------------------------------------------------
# persistent sharded rank/select index (the rs_index at mesh scale,
# src/bmrs.h:28-40: shard-local wave prefixes built ONCE + host shard totals)
# ---------------------------------------------------------------------------
class ShardedRSIndex:
    """Rank/select acceleration over one ShardedBitVector snapshot: one
    pass computing each shard's inclusive wave prefix (kept on its device)
    and the shard totals on the host.  Queries afterwards read one wave
    each; every cross-shard quantity is combined on the host in int64."""

    def __init__(self, sbv: ShardedBitVector):
        self.sbv = sbv
        self.mesh = sbv.mesh
        self.n_shards = self.mesh.size
        self.blocks_per_shard = sbv.blocks_per_shard
        self.shard_span = sbv.shard_span
        # the shard-local prefix is int32: a full shard's count must fit
        assert self.shard_span < 2**31, \
            "per-shard span exceeds the int32 prefix bound; add shards"
        self.gwc = [_gwc(s) for s in sbv.shards]
        self.shard_totals = np.asarray(
            [int(g[-1]) if g.numel() else 0 for g in self.gwc], np.int64)
        self.cum = np.cumsum(self.shard_totals)
        self.before = np.concatenate([[0], self.cum[:-1]]).astype(np.int64)
        self.total = int(self.cum[-1])

    def select_batch(self, ranks) -> np.ndarray:
        """Batched select1; -1 for out-of-range ranks."""
        ranks = np.asarray(ranks, np.int64)
        out = np.full(ranks.shape, -1, np.int64)
        ok = (ranks >= 1) & (ranks <= self.total)
        if not ok.any():
            return out
        rk = ranks[ok]
        tgt = np.searchsorted(self.cum, rk, side="left")
        local = rk - self.before[tgt]
        pos = np.zeros(rk.size, np.int64)
        for s in np.unique(tgt).tolist():
            sel = tgt == s
            t = self.sbv.shards[s]
            pos[sel] = select_flat(t, self.gwc[s], _index(
                local[sel].astype(np.int32), t.device)).cpu().numpy()
        out[ok] = tgt * self.shard_span + pos
        return out

    def select(self, rank: int) -> int:
        return int(self.select_batch([rank])[0])

    def rank_batch(self, ids) -> np.ndarray:
        """rank(i) = popcount[0, i] per query (count_to semantics)."""
        ids = np.asarray(ids, np.int64)
        out = np.zeros(ids.shape, np.int64)
        ok = ids >= 0
        if not ok.any():
            return out
        q = np.minimum(ids[ok], self.sbv.n_blocks * C.BITS_PER_BLOCK - 1)
        tgt = q // self.shard_span
        rel = q - tgt * self.shard_span
        part = np.zeros(q.size, np.int64)
        for s in np.unique(tgt).tolist():
            sel = tgt == s
            t = self.sbv.shards[s]
            part[sel] = _rank_local(t, self.gwc[s],
                                    _index(rel[sel], t.device)).cpu().numpy()
        out[ok] = self.before[tgt] + part
        return out

    def rank(self, i: int) -> int:
        return int(self.rank_batch([i])[0])

    def count(self) -> int:
        return self.total


# ---------------------------------------------------------------------------
# sharded aggregator with digest narrowing (communication-avoiding AND)
# ---------------------------------------------------------------------------
def _alive_rows(shard_groups) -> np.ndarray:
    """Digest pre-pass: per shard, AND the wave digests of its operand
    rows (one list of tensors per shard) -> bool[n_blocks] on the host."""
    alive = []
    for rows in shard_groups:
        acc = None
        for t in rows:
            d = blockops.calc_digest(t).to(torch.bool)
            acc = d if acc is None else (acc & d)
        alive.append(acc.any(dim=1).cpu().numpy())
    return np.concatenate(alive)


def _survivor_rows(alive: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Each shard's local survivor rows (int32), no padding."""
    per = alive.reshape(n_shards, -1)
    return [np.flatnonzero(p).astype(np.int32) for p in per]


def _survivor_sweep(n_and, shard_ops, rows, counts=False):
    """B4 over one shard's survivor ``rows``: AND of the first ``n_and`` of
    ``shard_ops`` (that shard's tensors) AND-NOT the rest -> (rows
    int32[k, 2048] or None, counts int32[k] or None), k = len(rows)."""
    slot = _index(rows, shard_ops[0].device)
    return ck.agg_and_sub(n_and, [(t, slot, None, None, None)
                                  for t in shard_ops],
                          rows=not counts, counts=counts)


def _scatter_rows(n, rows, out_rows, device) -> torch.Tensor:
    """A zero shard of ``n`` rows holding ``out_rows`` at ``rows``.  Only
    survivor rows are written: there is no padding slot to alias row 0."""
    out = zero_rows(n, device)
    if rows.size:
        out[_index(rows.astype(np.int64), device)] = out_rows
    return out


def sharded_and_many(vectors: list[ShardedBitVector],
                     digest_narrowing: bool = True) -> ShardedBitVector:
    """AND over a group of sharded vectors; the digest pre-pass mirrors the
    reference aggregator's digest narrowing (src/bmaggregator.h:1764): the
    blocks' wave digests are ANDed first, the survivor block list is
    decided on the host, and one B4 launch per shard ANDs ONLY the
    surviving rows (dead blocks are written as zeros without being read).
    ``result.last_narrowing`` reports (survivors, total) blocks."""
    assert vectors
    mesh = vectors[0].mesh
    size = max(v.size for v in vectors)
    n = len(vectors)
    nblk = vectors[0].n_blocks
    per_shard = list(zip(*[v.shards for v in vectors]))

    if not digest_narrowing or n < 2:
        shards = [ck.agg_and_sub(n, [_aligned(t) for t in ops])[0]
                  for ops in per_shard]
        sbv = ShardedBitVector(shards, size, mesh)
        sbv.last_narrowing = (nblk, nblk)      # nothing skipped
        return sbv

    alive = _alive_rows(per_shard)
    shards = []
    for ops, rows in zip(per_shard, _survivor_rows(alive, mesh.size)):
        res = _survivor_sweep(n, ops, rows)[0] if rows.size else None
        shards.append(_scatter_rows(ops[0].shape[0], rows, res,
                                    ops[0].device))
    sbv = ShardedBitVector(shards, size, mesh)
    sbv.last_narrowing = (int(alive.sum()), int(alive.size))
    return sbv


def sharded_and_sub_count(and_vs, sub_vs=(), digest_narrowing=True) -> int:
    """Global popcount of AND(and_vs) MINUS OR(sub_vs) with digest
    narrowing: only blocks whose AND-digest survives are read; per-shard
    partials combine on the host in int64 (the aggregator's count mode at
    mesh scale)."""
    assert and_vs
    mesh = and_vs[0].mesh
    per_shard = list(zip(*[v.shards for v in list(and_vs) + list(sub_vs)]))
    bps = and_vs[0].blocks_per_shard
    if digest_narrowing:
        alive = _alive_rows([ops[:len(and_vs)] for ops in per_shard])
        rows = _survivor_rows(alive, mesh.size)
    else:
        rows = [np.arange(bps, dtype=np.int32)] * mesh.size
    total = 0
    for ops, r in zip(per_shard, rows):
        if r.size:
            cnt = _survivor_sweep(len(and_vs), ops, r, counts=True)[1]
            total += int(cnt.sum(dtype=_I64))
    return total


def sharded_and_sub(and_vs, sub_vs) -> ShardedBitVector:
    """AND(and_vs) AND-NOT OR(sub_vs): one B4 launch per shard."""
    mesh = and_vs[0].mesh
    vs = list(and_vs) + list(sub_vs)
    shards = [ck.agg_and_sub(len(and_vs), [_aligned(t) for t in ops])[0]
              for ops in zip(*[v.shards for v in vs])]
    return ShardedBitVector(shards, max(v.size for v in and_vs), mesh)


# ---------------------------------------------------------------------------
# distributed vector GROUP: operands sharded over the mesh by VECTOR (each
# device owns whole vectors); the AND must cross devices.  Digests are
# exchanged first and only the surviving blocks travel.
# ---------------------------------------------------------------------------
def group_and_exchange(stack, mesh: Mesh, vec_axis: str = "v",
                       count_only: bool = False):
    """AND over a vector group sharded by vector.

    stack: uint32[K, nblk, 2048] split over ``mesh`` along the vector axis
    (a host array, or a list of per-shard ``[K/n, nblk, 2048]`` tensors) —
    each device holds K/n whole vectors.  Phase 1 ANDs each shard's
    vectors (one B4 launch) and brings the wave digests (8 B/block) to the
    host; phase 2 moves only the survivor rows of each shard's AND to the
    first device and ANDs them there.  Returns (result_rows_or_count,
    survivor_block_ids, traffic) where traffic = (blocks_shipped,
    blocks_total)."""
    if mesh.axis_name != vec_axis:
        raise ValueError(f"mesh axis {mesh.axis_name!r} is not {vec_axis!r}")
    shards = placed(stack, mesh, 0)
    nblk = int(shards[0].shape[1])
    local = [ck.agg_and_sub(t.shape[0], [_aligned(t[i])
                                         for i in range(t.shape[0])])[0]
             for t in shards]
    alive = None
    for acc in local:
        d = blockops.calc_digest(acc).to(torch.bool).cpu().numpy()
        alive = d if alive is None else (alive & d)
    alive = alive.any(axis=1)
    surv = np.flatnonzero(alive).astype(np.int32)
    surv_pad = surv if surv.size else np.zeros(1, np.int32)
    home = mesh.devices[0]
    out = None
    for acc in local:
        mine = acc[_index(surv_pad.astype(np.int64), acc.device)].to(home)
        out = mine if out is None else (out & mine)
    traffic = (int(surv.size), nblk)
    if count_only:
        res = int(ck.block_counts_total(out)[0]) if surv.size else 0
        return res, surv, traffic
    return out, surv, traffic


def pipeline_counts_program(mesh: Mesh):
    """Sharded bulk-search pipeline: ``counts(planes, sels)`` with planes
    ``[S, nblk, 2048]`` split on the block axis (a host array or per-shard
    tensors) and selectors int[V, S] -> int64[n_shards, V] PER-SHARD hit
    counts, one B5 launch per shard; ``pipeline_counts_host`` combines
    them on the host."""
    def counts(planes, sels):
        sels = (sels.detach().cpu().numpy() if torch.is_tensor(sels)
                else np.asarray(sels))
        parts = [ck.pipeline_counts(p, sels) for p in placed(planes, mesh, 1)]
        return np.stack([p.cpu().numpy() for p in parts])

    return counts


def pipeline_counts_host(mesh: Mesh, planes, sels) -> np.ndarray:
    """Run the sharded pipeline and combine the per-shard partials on the
    host: int64[V] global hit counts."""
    return pipeline_counts_program(mesh)(planes, sels).sum(axis=0)


def scan_throughput_program(mesh: Mesh, n_planes: int,
                            n_blocks_per_shard: int):
    """The sharded scan of the scaling benchmark: a bit-sliced equality
    scan (AND-SUB over n_planes planes split on the block axis) plus the
    global hit count, as one B6 ``scan_eq`` and one K3 launch per shard.
    Returns ``(scan, sharding)``; ``scan(planes, value_bits)`` gives the
    count as uint32, like the JAX package's program."""
    sharding = block_sharding(mesh, axis=1)

    def scan(planes, value_bits):
        shards = placed(planes, mesh, 1)
        for t in shards:
            if t.shape[0] < n_planes or t.shape[1] != n_blocks_per_shard:
                raise ValueError(f"planes shard {tuple(t.shape)}: expected "
                                 f"[>= {n_planes}, {n_blocks_per_shard}, "
                                 f"2048]")
        v = int(value_bits) & 0xFFFFFFFF
        total = _host_total(
            ck.block_counts_total(ck.scan_eq(n_planes, t, v))[0]
            for t in shards)
        return np.uint32(total & 0xFFFFFFFF)

    return scan, sharding

