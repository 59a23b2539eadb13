"""Succinct-vector serialization: the BMSV container format for the int,
RSC, string and float vectors (port of ``bitmagic_tpu/serial/sv_serial.py``).

Equivalent of `src/bmsparsevec_serial.h` (sparse_vector_serializer :190,
sparse_vector_deserializer :341, layout :69) and
`src/bmsparsevec_float_serial.h`: header + plane-presence mask + per-plane
BitVector BLOBs.  With the XOR filter on (the default) the present planes
of a vector are written as ONE ``xor_group`` section (block-level XOR
deltas across planes, flag ``GROUPED``); with it off each plane is its own
BMT1 BLOB.  The bytes equal the JAX package's for the same vector.

Decoders take ``device=`` and build every container there (by default
``config.device``); range and gather decodes skip the records outside the
selection (the per-record lengths serve as bookmarks).
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..config import resolve_device
from ..core.bitvector import BitVector
from ..sv.float_vector import FloatSparseVector
from ..sv.rsc_vector import RSCSparseVector
from ..sv.sparse_vector import SparseVector
from ..sv.str_vector import StrSparseVector
from . import native
from .encoding import ByteDecoder, ByteEncoder
from .opdeser import _materialize_subset, _stream_blocks
from .serializer import Deserializer, Serializer
from .xor_group import deserialize_group, serialize_group

MAGIC_SV = b"BMSV"
NO_XOR = 0xFF
# container-byte flag: plane sections are BMX1 groups (block-level XOR
# deltas across planes)
GROUPED = 0x40

_DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64,
           np.int8, np.int16, np.int32, np.int64]


class SparseVectorSerializer:
    """bm::sparse_vector_serializer equivalent."""

    def __init__(self, level: int = 6, xor_filter: bool = True):
        self.level = level
        self.xor_filter = xor_filter

    # -- XOR compression knobs (reference set_xor_ref /
    # enable_xor_compression / disable_xor_compression / is_xor_ref): the
    # XOR model is the cross-plane group, so the knobs toggle it
    def enable_xor_compression(self):
        self.xor_filter = True
        return self

    def disable_xor_compression(self):
        self.xor_filter = False
        return self

    def is_xor_ref(self) -> bool:
        return bool(self.xor_filter)

    def set_xor_ref(self, ref=True):
        """A collection (or True) enables the XOR filter, None/False
        disables it: the plane group is its own reference collection."""
        self.xor_filter = bool(ref) if not isinstance(ref, (list, tuple)) \
            else True
        return self

    def set_sim_model(self, model):
        """Accepted for parity: the plane-group XOR scan computes its match
        model per group."""
        self._sim_model = model
        return self

    def compute_sim_model(self, *a, **k):
        """Accepted for parity; returns None (the model is internal)."""
        return None

    def set_bookmarks(self, enable: bool, bm_interval: int = 256):
        """Recorded for parity: per-record lengths already give the range
        skip (see Serializer.set_bookmarks)."""
        self._bookmarks = (bool(enable), int(bm_interval))
        return self

    # ------------------------------------------------------------------
    def serialize(self, sv: SparseVector) -> bytes:
        sv._flush()
        enc = ByteEncoder()
        enc.put_bytes(MAGIC_SV)
        enc.put_8(0 | (GROUPED if self.xor_filter else 0))
        enc.put_8(_DTYPES.index(sv.dtype.type))
        enc.put_8(1 if sv.nullable else 0)
        enc.put_64(sv._size)
        enc.put_16(sv.n_slices)
        self._put_planes(enc, sv.planes)
        self._put_optional(enc, sv.null_plane if sv.nullable else None)
        return enc.get_bytes()

    def _put_planes(self, enc, planes):
        present = 0
        for s, p in enumerate(planes):
            if p is not None and p.any():
                present |= 1 << s
        enc.put_64(present)
        if self.xor_filter:
            group = serialize_group(
                [p for s, p in enumerate(planes) if (present >> s) & 1],
                level=self.level)
            enc.put_32(len(group))
            enc.put_bytes(group)
            return
        # plain per-plane BLOBs, always with ref = NO_XOR (the reader keeps
        # its plane-reference branch for older streams)
        ser = Serializer(self.level)
        for s, p in enumerate(planes):
            if not (present >> s) & 1:
                continue
            blob = ser.serialize(p)
            enc.put_8(s)
            enc.put_8(NO_XOR)
            enc.put_32(len(blob))
            enc.put_bytes(blob)

    def _put_optional(self, enc, bv):
        if bv is None:
            enc.put_8(0)
            return
        blob = Serializer(self.level).serialize(bv)
        enc.put_8(1)
        enc.put_32(len(blob))
        enc.put_bytes(blob)

    # ------------------------------------------------------------------
    def serialize_rsc(self, rsc: RSCSparseVector) -> bytes:
        rsc._flush()
        enc = ByteEncoder()
        enc.put_bytes(MAGIC_SV)
        enc.put_8(1 | (GROUPED if self.xor_filter else 0))
        enc.put_8(_DTYPES.index(rsc.dtype.type))
        enc.put_8(1)
        enc.put_64(rsc._size)
        enc.put_16(rsc.dense.n_slices)
        self._put_planes(enc, rsc.dense.planes)
        self._put_optional(enc, rsc.null_bv)
        return enc.get_bytes()

    def serialize_str(self, ssv: StrSparseVector) -> bytes:
        enc = ByteEncoder()
        enc.put_bytes(MAGIC_SV)
        enc.put_8(2 | (GROUPED if self.xor_filter else 0))
        enc.put_8(ssv.max_str_size)
        enc.put_8(1 if ssv.nullable else 0)
        enc.put_8(1 if ssv.is_remap() else 0)
        enc.put_64(ssv._size)
        if ssv.is_remap():
            enc.put_bytes(ssv.remap_matrices.tobytes())
            enc.put_bytes(ssv.unmap_matrices.tobytes())
        for k in range(ssv.max_str_size):
            ssv.octets[k]._flush()
            enc.put_16(ssv.octets[k].n_slices)
            self._put_planes(enc, ssv.octets[k].planes)
        self._put_optional(enc, ssv.null_plane if ssv.nullable else None)
        return enc.get_bytes()

    def serialize_float(self, fv: FloatSparseVector) -> bytes:
        enc = ByteEncoder()
        enc.put_bytes(MAGIC_SV)
        enc.put_8(3 | (GROUPED if self.xor_filter else 0))
        enc.put_8(0 if fv.dtype == np.float32 else 1)
        enc.put_8(1 if fv.nullable else 0)
        enc.put_64(fv._size)
        self._put_optional(enc, fv.sign)
        for part in (fv.exponent, fv.mantissa):
            part._flush()
            enc.put_16(part.n_slices)
            self._put_planes(enc, part.planes)
        self._put_optional(enc, fv.null_plane if fv.nullable else None)
        return enc.get_bytes()


class SparseVectorDeserializer:
    """bm::sparse_vector_deserializer equivalent (full, range and gather
    decode, src/bmsparsevec_serial.h:341).  ``device``: where the decoded
    containers live (``config.resolve_device``)."""

    def __init__(self, device=None):
        self.device = device

    def set_finalization(self, mode):
        """reference set_finalization (READONLY freezes every decoded
        container): the string "READONLY" / "open" or a truthy flag."""
        self._finalize_ro = (str(mode).lower() == "readonly"
                             if isinstance(mode, str) else bool(mode))
        return self

    def _finalize(self, sv):
        if getattr(self, "_finalize_ro", False):
            sv.freeze()
        return sv

    def deserialize(self, data: bytes):
        return self._finalize(self._dispatch(data, None))

    def deserialize_range(self, data: bytes, lo: int, hi: int):
        """Materialize only elements in [lo, hi]; plane records outside the
        range are skipped, not decoded.  Elements outside the range read as
        unassigned/zero; the logical size is kept."""
        if hi < lo:
            raise ValueError("empty range")
        return self._finalize(self._dispatch(data,
                                             ("range", (int(lo), int(hi)))))

    def deserialize_gather(self, data: bytes, ids):
        """Materialize only the blocks holding the requested element ids
        (reference gather deserialize); other elements read as
        unassigned/zero."""
        ids = np.unique(np.asarray(ids, np.int64))
        if ids.size == 0:
            raise ValueError("empty id list")
        want = frozenset((ids >> C.SET_BLOCK_SHIFT).tolist())
        return self._finalize(self._dispatch(data, ("blocks", want, ids)))

    def _dispatch(self, data, sel):
        self._dev = resolve_device(self.device)
        dec = ByteDecoder(data)
        if dec.get_bytes(4) != MAGIC_SV:
            raise ValueError("bad magic")
        ctype = dec.get_8()
        self._grouped = bool(ctype & GROUPED)
        ctype &= ~GROUPED
        if ctype == 0:
            return self._get_sv(dec, sel)
        if ctype == 1:
            if sel is None:
                return self._get_rsc(dec)
            return self._get_rsc_sel(dec, sel)
        if ctype == 2:
            return self._get_str(dec, sel)
        if ctype == 3:
            return self._get_float(dec, sel)
        raise ValueError(f"unknown container type {ctype}")

    def _empty_bv(self) -> BitVector:
        return BitVector(C.ID_MAX48, device=self._dev)

    def _decode_sel(self, deser, blob, sel):
        """Decode a plane BLOB under a selection: full, bit range, or an
        explicit block-id set (payloads of unselected blocks skipped)."""
        if sel is None:
            return deser.deserialize(blob)
        if sel[0] == "range":
            return deser.deserialize(blob, range_=sel[1])
        try:
            _, size, _ = next(_stream_blocks(blob))
            return _materialize_subset(blob, sel[1], size, self._dev)
        except native.RunCodedBlob:
            # a FULL_RUN record: the per-block subset walk cannot skip
            # through it; the full decode is O(records) and a superset is
            # a correct gather result
            return deser.deserialize(blob)

    def _group_planes(self, group_blob, present, n_slices, sel):
        decoded = deserialize_group(group_blob, sel, self._dev)
        planes = [None] * n_slices
        k = 0
        for s in range(n_slices):
            if (present >> s) & 1:
                planes[s] = decoded[k]
                k += 1
        return planes

    def _get_planes(self, dec, n_slices, sel=None):
        present = dec.get_64()
        if self._grouped:
            glen = dec.get_32()
            return self._group_planes(dec.get_bytes(glen), present, n_slices,
                                      sel)
        planes = [None] * n_slices
        deser = Deserializer(self._dev)
        raw: list[tuple[int, int, BitVector]] = []
        for s in range(n_slices):
            if not (present >> s) & 1:
                continue
            slice_id = dec.get_8()
            ref = dec.get_8()
            blob_len = dec.get_32()
            bv = self._decode_sel(deser, dec.get_bytes(blob_len), sel)
            raw.append((slice_id, ref, bv))
        resolved: dict[int, BitVector] = {}
        for slice_id, ref, bv in raw:       # refs always point backwards
            # untrusted stream: bad or duplicate slice ids and unresolved
            # refs fail as malformed
            if slice_id >= n_slices or planes[slice_id] is not None:
                raise ValueError(
                    "malformed stream: bad or duplicate slice id")
            if ref != NO_XOR:
                if ref not in resolved:
                    raise ValueError(
                        "malformed stream: unresolved plane XOR ref")
                bv = bv ^ resolved[ref]
            resolved[slice_id] = bv
            planes[slice_id] = bv
        return planes

    def _get_sv(self, dec, sel=None) -> SparseVector:
        dtype = _DTYPES[dec.get_8()]
        nullable = bool(dec.get_8())
        size = dec.get_64()
        n_slices = dec.get_16()
        sv = SparseVector(dtype, nullable=nullable, device=self._dev)
        sv.planes = self._get_planes(dec, n_slices, sel)
        null = self._get_optional(dec, sel)
        if nullable:
            sv.null_plane = null or self._empty_bv()
        sv._size = size
        return sv

    def _get_rsc(self, dec) -> RSCSparseVector:
        dtype = _DTYPES[dec.get_8()]
        dec.get_8()
        size = dec.get_64()
        n_slices = dec.get_16()
        rsc = RSCSparseVector(dtype, device=self._dev)
        rsc.dense = SparseVector(dtype, device=self._dev)
        rsc.dense.planes = self._get_planes(dec, n_slices)
        rsc.null_bv = self._get_optional(dec) or self._empty_bv()
        rsc._size = size
        rsc.dense._size = rsc.null_bv.count()
        rsc.sync()
        return rsc

    def _get_rsc_sel(self, dec, sel) -> RSCSparseVector:
        """RSC range/gather decode: the NULL row lives in the logical domain
        and the value rows in the rank-compressed one, so the NULL row is
        decoded first (the plane section is skipped over by its lengths)
        to translate the selection into the value planes' rank domain."""
        dtype = _DTYPES[dec.get_8()]
        dec.get_8()
        size = dec.get_64()
        n_slices = dec.get_16()
        present = dec.get_64()
        raw = []
        group_blob = None
        if self._grouped:
            glen = dec.get_32()
            group_blob = dec.get_bytes(glen)
        else:
            for s in range(n_slices):
                if not (present >> s) & 1:
                    continue
                slice_id = dec.get_8()
                ref = dec.get_8()
                blob_len = dec.get_32()
                raw.append((slice_id, ref, dec.get_bytes(blob_len)))
        null_bv = self._get_optional(dec) or self._empty_bv()
        rsc = RSCSparseVector(dtype, device=self._dev)
        rsc._size = size

        clip = BitVector(null_bv.size, device=self._dev)
        if sel[0] == "range":
            lo, hi = sel[1]
            hi = min(hi, max(size - 1, 0))
            if hi < lo:
                return rsc
            clip.copy_range(null_bv, lo, hi)
            rank_lo = null_bv.count_range(0, lo - 1) if lo else 0
            k = clip.count()
            if k == 0:
                return rsc
            rank_sel = ("range", (rank_lo, rank_lo + k - 1))
        else:
            ids = sel[2][sel[2] < size]
            hit = np.asarray(null_bv.get_bits(ids), bool)
            pos_ids = ids[hit]
            if pos_ids.size == 0:
                return rsc
            clip.set_many(pos_ids)
            rs = null_bv.build_rs_index()
            ranks = np.asarray(rs.rank_batch(pos_ids), np.int64) - 1
            rank_lo = int(ranks[0])
            rank_sel = ("blocks",
                        frozenset((ranks >> C.SET_BLOCK_SHIFT).tolist()))

        if group_blob is not None:
            planes = self._group_planes(group_blob, present, n_slices,
                                        rank_sel)
        else:
            planes = [None] * n_slices
            deser = Deserializer(self._dev)
            resolved: dict[int, BitVector] = {}
            for slice_id, ref, blob in raw:
                bv = self._decode_sel(deser, blob, rank_sel)
                if ref != NO_XOR:
                    bv = bv ^ resolved[ref]
                resolved[slice_id] = bv
                planes[slice_id] = bv
        dense = SparseVector(dtype, device=self._dev)
        dense.planes = planes
        pos = clip.indices()
        if sel[0] == "range":
            ranks = np.arange(rank_lo, rank_lo + len(pos), dtype=np.int64)
        dense._size = int(ranks[-1]) + 1
        vals = dense.gather(ranks)
        arr = np.zeros(int(pos[-1]) + 1, dtype)
        arr[pos] = np.asarray(vals, dtype)
        mask = np.ones(int(pos[-1]) + 1, bool)
        mask[pos] = False
        sv = SparseVector.from_array(arr, nullable=True, null_mask=mask,
                                     device=self._dev)
        out = RSCSparseVector.from_sparse_vector(sv)
        out._size = size
        return out

    def _get_str(self, dec, sel=None) -> StrSparseVector:
        max_str = dec.get_8()
        nullable = bool(dec.get_8())
        remap = bool(dec.get_8())
        size = dec.get_64()
        ssv = StrSparseVector(max_str, nullable=nullable, device=self._dev)
        if remap:
            ssv.remap_matrices = np.frombuffer(
                dec.get_bytes(max_str * 256), np.uint8).reshape(
                    max_str, 256).copy()
            ssv.unmap_matrices = np.frombuffer(
                dec.get_bytes(max_str * 256), np.uint8).reshape(
                    max_str, 256).copy()
        for k in range(max_str):
            n_slices = dec.get_16()
            ssv.octets[k] = SparseVector(np.uint8, device=self._dev)
            ssv.octets[k].planes = self._get_planes(dec, n_slices, sel)
            ssv.octets[k]._size = size
        if nullable:
            ssv.null_plane = self._get_optional(dec, sel) or self._empty_bv()
        else:
            self._get_optional(dec)
        ssv._size = size
        return ssv

    def _get_float(self, dec, sel=None) -> FloatSparseVector:
        dtype = np.float32 if dec.get_8() == 0 else np.float64
        nullable = bool(dec.get_8())
        size = dec.get_64()
        fv = FloatSparseVector(dtype, nullable=nullable, device=self._dev)
        fv.sign = self._get_optional(dec, sel) or self._empty_bv()
        for name in ("exponent", "mantissa"):
            n_slices = dec.get_16()
            part = getattr(fv, name)
            part.planes = self._get_planes(dec, n_slices, sel)
            part._size = size
        if nullable:
            fv.null_plane = self._get_optional(dec, sel) or self._empty_bv()
        fv._size = size
        return fv

    def _get_optional(self, dec, sel=None):
        if dec.get_8() == 0:
            return None
        n = dec.get_32()
        return self._decode_sel(Deserializer(self._dev), dec.get_bytes(n),
                                sel)


# one-shot helpers (reference sparse_vector_serialize/deserialize,
# src/bmsparsevec_serial.h:540-567)
def sparse_vector_serialize(sv, level: int = 6) -> bytes:
    s = SparseVectorSerializer(level)
    if isinstance(sv, SparseVector):
        return s.serialize(sv)
    if isinstance(sv, RSCSparseVector):
        return s.serialize_rsc(sv)
    if isinstance(sv, StrSparseVector):
        return s.serialize_str(sv)
    if isinstance(sv, FloatSparseVector):
        return s.serialize_float(sv)
    raise TypeError(type(sv))


def sparse_vector_deserialize(data: bytes, device=None):
    return SparseVectorDeserializer(device).deserialize(data)


# ---------------------------------------------------------------------------
# compressed collections (reference compressed_collection_serializer,
# src/bmsparsevec_serial.h:582)
# ---------------------------------------------------------------------------
def serialize_compressed_collection(coll, level: int = 6) -> bytes:
    """CompressedBufferCollection -> BLOB: magic | key-bvector BLOB |
    u32 count | per buffer u32 len + bytes."""
    coll.sync()
    enc = ByteEncoder()
    enc.put_bytes(b"BMCC")
    kb = Serializer(level).serialize(coll.resolver.addr_bv)
    enc.put_32(len(kb))
    enc.put_bytes(kb)
    enc.put_32(len(coll.values))
    for buf in coll.values:
        b = bytes(buf)
        enc.put_32(len(b))
        enc.put_bytes(b)
    return enc.get_bytes()


def deserialize_compressed_collection(data: bytes, device=None):
    """Inverse of serialize_compressed_collection, its key set on
    ``device``."""
    from ..sv.util import CompressedBufferCollection
    dec = ByteDecoder(data)
    if dec.get_bytes(4) != b"BMCC":
        raise ValueError("bad collection magic")
    klen = dec.get_32()
    key_bv = Deserializer(device).deserialize(dec.get_bytes(klen))
    n = dec.get_32()
    coll = CompressedBufferCollection(device=device)
    # count() is run-aware: check it before listing the keys (a crafted
    # key BLOB with a wide FULL span would list billions of ids)
    if key_bv.count() != n:
        raise ValueError("key/value count mismatch")
    for k in key_bv.indices():
        blen = dec.get_32()
        coll.push_back(int(k), dec.get_bytes(blen))
    coll.sync()
    return coll
