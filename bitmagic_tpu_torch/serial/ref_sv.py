"""Codec for the REFERENCE sparse-vector BLOB format (port of
``bitmagic_tpu/serial/ref_sv.py``).

Format (derived from src/bmsparsevec_serial.h:940-1160 serialize /
:1232-1700 deserialize):

  header (33 bytes, planes start at byte 33):
    'B' 'M'|'C'|'Z'   magic ('M' bit-matrix / 'C' rank-select-compressed /
                      'Z' empty)
    u8  byte order
    u8  legacy plane count (0 -> modern bit-matrix header follows)
    u8  matrix serialization version (1 = 32-bit, 2 = 64-bit/BM64ADDR)
    u64 planes_code   (row count; bit 63 set -> digest_offset present)
    u64 size          (sv.size_internal)
    u64 digest_offset (absolute offset of the plane-digest section)
    4 bytes reserved
  planes: per non-empty row, a standard bvector BLOB (optionally
    XOR-compressed against other rows — row id == plane index)
  [remap matrix section — only for remap-trait SVs (str vectors)]
  at digest_offset:
    plane-digest bvector BLOB (bit i set = row i non-empty)
    offset table: u8 '6' + u64 absolute offset per non-empty row, or
                  u8 '3' + u32 min + u32 max + BIC-u32-cm middle offsets

Row layout of a sparse_vector<Val> (src/bmbmatrix.h:485-496): rows
0..value_bits-1 are the s2u value bit-slices; the NULL ("not null") row is
the last row (index = stored value slices).

The reader handles 'BM' and 'BC'; the writer emits 'BM'/'BC' BLOBs, by
default with the cross-plane XOR reference filter (plane i may reference
planes j > i, matching the decoders' descending decode order).  The float
'bf0' composite (src/bmsparsevec_float_serial.h) wraps three of them.
BLOBs are byte-identical to the JAX package's; decoders take ``device=``
and build the container there.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..config import resolve_device
from ..core.bitvector import BitVector
from .refcodec import (RefDeserializer, RefSerializer, _BitIn, _BitOut,
                       _ByteReader, _ByteWriter, _bv_block_map)

_HDR_SIZE = 33

# cap for the paths that materialize DENSE element arrays while decoding
# (RSC expansion, float recombination): a BLOB-controlled size above it
# would exhaust host memory, so it fails with a clean error instead
_DENSE_DECODE_CAP = 1 << 31


def _cap_dense(n):
    if n > _DENSE_DECODE_CAP:
        raise ValueError(
            "decode exceeds the memory-safe dense materialization bound")
    return int(n)


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------
def _read_header(r: _ByteReader):
    h1, h2 = r.get_8(), r.get_8()
    if h1 != ord("B") or h2 not in (ord("M"), ord("C"), ord("Z")):
        raise ValueError("bad sparse-vector BLOB magic")
    if h2 == ord("Z"):
        return dict(kind="Z", planes=0, size=0, digest_offset=0)
    r.get_8()                                   # byte order
    planes = r.get_8()
    matr_ver = 1
    planes_code = 0
    if planes == 0:
        matr_ver = r.get_8()
        planes_code = r.get_64()
        planes = planes_code & ((1 << 63) - 1)
    size = r.get_64()
    digest_offset = r.get_64() if (planes_code & (1 << 63)) else 0
    return dict(kind=chr(h2), planes=int(planes), size=int(size),
                digest_offset=digest_offset, matr_ver=matr_ver)


def _row_offsets(data, hdr, device):
    """The non-empty rows and their BLOB offsets, read from the digest and
    offset table at ``hdr["digest_offset"]`` -> dict row -> offset."""
    if not hdr["digest_offset"]:
        raise ValueError("legacy sparse-vector BLOB without digest offset")
    de = RefDeserializer(device=device)
    tail = bytes(np.frombuffer(data, np.uint8)[hdr["digest_offset"]:])
    digest_bv = de.deserialize(tail)
    tab = _ByteReader(tail[de.bytes_consumed:])
    if int(hdr["planes"]) > 1 << 20:
        raise ValueError("malformed stream: implausible plane count")
    # clamp before listing positions: a crafted digest with a wide FULL
    # span would list billions of ids; keep_range is run-aware
    if digest_bv.find_reverse() >= int(hdr["planes"]):
        digest_bv.keep_range(0, max(int(hdr["planes"]) - 1, 0))
    nonempty = [int(i) for i in digest_bv.indices() if i < hdr["planes"]]
    dtype_code = tab.get_8()
    offsets = {}
    if dtype_code == ord("6"):
        for i in nonempty:
            offsets[i] = tab.get_64()
    elif dtype_code == ord("3"):
        min_v = tab.get_32()
        max_v = tab.get_32()
        bi = _BitIn(tab)
        mids = (bi.bic_decode_cm(len(nonempty) - 2, min_v, max_v)
                if len(nonempty) > 2 else [])
        vals = [min_v] + [int(x) for x in mids] + [max_v]
        for i, off in zip(nonempty, vals):
            offsets[i] = off
    else:
        raise ValueError(f"unknown offset table type {dtype_code}")
    return offsets


def _read_planes(data, hdr, range_=None, null_row=-1, rank_domain=False,
                 device=None):
    """Decode all non-empty rows -> (dict row -> BitVector, dict row ->
    offset).

    With ``range_=(lo, hi)`` only that element range is materialized per
    row (the NULL row always decodes fully so rank translation and
    assignment masks stay exact); ``rank_domain=True`` (RSC) converts the
    logical range to the value rows' rank domain through the NULL row."""
    offsets = _row_offsets(data, hdr, device)
    rows: dict[int, BitVector] = {}
    buf = bytes(data)
    refs = []
    row_range = range_ if (range_ is not None and not rank_domain) else None
    for i in sorted(offsets, reverse=True):   # backward: NULL row first
        de = RefDeserializer(ref_vectors=refs, device=device)
        if row_range is None or i == null_row:
            bv = de.deserialize(buf[offsets[i]:])
        else:
            bv = de.deserialize_range(buf[offsets[i]:], *row_range)
        if i == null_row and range_ is not None and rank_domain:
            # RSC: value rows live in the rank-compressed domain; convert
            # the logical range through the fully decoded NULL row
            lo, hi = range_
            k = bv.count_range(lo, hi)
            rank_lo = bv.count_range(0, lo - 1) if lo else 0
            row_range = (rank_lo, max(rank_lo + k - 1, rank_lo))
        rows[i] = bv
        refs.append((i, bv))
    return rows, offsets


def deserialize_sv_blob(data, dtype=np.uint32, range_=None, device=None):
    """Reference sparse-vector BLOB -> SparseVector on ``device``.  With
    ``range_=(lo, hi)`` only that element range of the value rows is
    materialized (the reference's deserialize_range)."""
    from ..sv.sparse_vector import SparseVector
    dev = resolve_device(device)
    r = _ByteReader(data)
    hdr = _read_header(r)
    if hdr["kind"] == "Z":
        return SparseVector(dtype, nullable=True, device=dev)
    if hdr["kind"] == "C":
        raise ValueError("RSC BLOB: use deserialize_rsc_blob")
    # the NULL row sits at index = stored value slices (8*sizeof(Val)); it
    # is present only when the row count includes it (load_null_plane)
    ref_val = 8 * np.dtype(dtype).itemsize
    null_row = ref_val if hdr["planes"] == ref_val + 1 else -1
    rows, _ = _read_planes(data, hdr, range_=range_, null_row=null_row,
                           device=dev)
    sv = SparseVector(dtype, nullable=True, device=dev)
    sv._size = hdr["size"]
    got_null = False
    for i, bv in rows.items():
        if i == null_row:
            sv.null_plane = bv
            got_null = True
        elif i < sv.n_slices:
            sv.planes[i] = bv
        elif bv.any():
            raise ValueError(f"value slice {i} exceeds dtype width")
    if not got_null:
        # no NULL row in the digest.  The reference's plane count always
        # includes the NULL slot, so its absence cannot be told from an
        # all-NULL vector by counting rows; the reference decides by the
        # target container type.  Default: every position assigned.  Our
        # writer emits the empty NULL row explicitly (digest bit set, empty
        # bvector BLOB), so all-NULL round trips land in got_null.
        sv.null_plane = BitVector(C.ID_MAX48, device=dev)
        if sv._size:
            sv.null_plane.set_range(0, sv._size - 1)
    return sv


def deserialize_rsc_blob(data, dtype=np.uint32, range_=None, device=None):
    """Reference rsc_sparse_vector BLOB ('BC') -> RSCSparseVector on
    ``device``.  With ``range_=(lo, hi)`` value rows are range-decoded in
    the rank domain through the NULL row (the reference's
    deserialize_range)."""
    from ..sv.rsc_vector import RSCSparseVector
    from ..sv.sparse_vector import SparseVector
    dev = resolve_device(device)
    r = _ByteReader(data)
    hdr = _read_header(r)
    rsc = RSCSparseVector(dtype, device=dev)
    if hdr["kind"] == "Z":
        return rsc
    if hdr["kind"] != "C":
        raise ValueError("not an RSC BLOB")
    ref_val = 8 * np.dtype(dtype).itemsize
    null_row = ref_val if hdr["planes"] == ref_val + 1 else -1
    rows, _ = _read_planes(data, hdr, range_=range_, null_row=null_row,
                           rank_domain=True, device=dev)
    dense = SparseVector(dtype, nullable=False, device=dev)
    dense._size = hdr["size"]
    null_bv = None
    for i, bv in rows.items():
        if i == null_row:
            null_bv = bv
        elif i < dense.n_slices:
            dense.planes[i] = bv
    # rows hold values at rank-compressed positions; expand via the index
    if null_bv is None:
        return rsc
    if range_ is not None:
        lo, hi = range_
        rank_lo = null_bv.count_range(0, lo - 1) if lo else 0
        clip = BitVector(null_bv.size, device=dev)
        clip.copy_range(null_bv, lo, hi)
        idx = clip.indices()
        if idx.size == 0:
            return rsc
        vals = dense.gather(np.arange(rank_lo, rank_lo + len(idx),
                                      dtype=np.int64))
    else:
        if null_bv.count() > _DENSE_DECODE_CAP:
            raise ValueError(
                "decode exceeds the memory-safe dense materialization bound")
        idx = null_bv.indices()
        vals = dense.gather(np.arange(len(idx), dtype=np.int64))
    n = _cap_dense(int(idx[-1]) + 1 if len(idx) else 0)
    arr = np.zeros(n, dtype)
    arr[idx] = vals
    mask = np.ones(n, bool)
    mask[idx] = False                           # True = NULL
    sv = SparseVector.from_array(arr, nullable=True, null_mask=mask,
                                 device=dev)
    return RSCSparseVector.from_sparse_vector(sv)


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------
def _clamped(bv: BitVector, size: int) -> BitVector:
    """Plane copy sized to the vector length (planes are stored with the
    element-count address space so 32-bit reference builds can read them)."""
    bv._flush()
    out = BitVector._from_parts(bv._struct, bv._pool, max(size, 1),
                                bv._gaps)
    out._drop_trailing(max(size, 1))
    return out


def _serialize_matrix(rows: dict[int, BitVector], n_rows: int, size: int,
                      kind: str, level: int, clamp: int | None = None,
                      remap_section: bytes | None = None,
                      xor_refs: bool = False) -> bytes:
    ser = RefSerializer(level)
    w = _ByteWriter()
    w.put_8(ord("B"))
    w.put_8(ord(kind))
    w.put_8(1)                                  # little-endian
    w.put_8(0)                                  # modern bit-matrix header
    w.put_8(1)                                  # matrix version (32-bit)
    w.put_64(n_rows | (1 << 63))
    w.put_64(size)
    digest_pos_at = len(w.parts)
    w.put_64(0)                                 # digest offset placeholder
    w.put_32(0)                                 # reserved
    assert len(w.parts) == _HDR_SIZE

    clamped = {i: _clamped(rows[i], clamp or size) for i in sorted(rows)
               if rows[i] is not None
               and (rows[i].any() or i == n_rows - 1)}
    # cross-plane XOR filter: the decoders (ours and the reference's) read
    # planes in DESCENDING row order building up the reference collection,
    # so plane i may only reference planes j > i
    maps = {i: _bv_block_map(bv) for i, bv in clamped.items()} \
        if (xor_refs and level >= 5) else None

    offsets = {}
    for i in sorted(clamped):
        if maps is not None:
            higher = [j for j in clamped if j > i]
            ser_i = RefSerializer(
                level, ref_vectors=[(j, clamped[j]) for j in higher])
            ser_i._ref_maps = {j: maps[j] for j in higher}
            ser_i._ref_maps_injected = True
        else:
            ser_i = ser
        offsets[i] = len(w.parts)
        w.parts += ser_i.serialize(clamped[i])

    if remap_section is not None:      # str vectors: after the last plane
        w.parts += remap_section

    digest_offset = len(w.parts)
    digest_bv = BitVector.from_indices(
        np.asarray(sorted(offsets), np.int64), max(n_rows, 1), device="cpu")
    w.parts += ser.serialize(digest_bv)
    w.put_8(ord("6"))
    for i in sorted(offsets):
        w.put_64(offsets[i])

    blob = bytearray(w.get_bytes())
    blob[digest_pos_at:digest_pos_at + 8] = int(digest_offset).to_bytes(
        8, "little")
    return bytes(blob)


def _assigned_row(size: int) -> BitVector:
    """The NULL row of a vector whose every position is assigned."""
    return BitVector.from_indices(np.arange(size, dtype=np.int64), size,
                                  device="cpu")


def serialize_sv_blob(sv, level: int = 6, xor_refs: bool = True) -> bytes:
    """SparseVector -> reference-format 'BM' BLOB (reference-readable).

    The NULL row lands at index 8*sizeof(Val) (the reference's layout);
    signed planes are bit-compatible because s2u matches the reference's
    -(v+1) magnitude mapping (src/bmbmatrix.h:2294)."""
    sv._flush()
    if sv.size == 0:
        return b"BZ"
    ref_val = 8 * sv.dtype.itemsize
    assert sv.n_slices <= ref_val
    rows = {}
    for i, bv in enumerate(sv.planes):
        if bv is None or not bv.any():
            continue
        rows[i] = bv
    if sv.nullable and sv.null_plane is not None:
        rows[ref_val] = sv.null_plane
    else:
        # reference vectors always mark assigned positions in the NULL row
        rows[ref_val] = _assigned_row(sv.size)
    return _serialize_matrix(rows, ref_val + 1, sv.size, "M", level,
                             xor_refs=xor_refs)


def serialize_rsc_blob(rsc, level: int = 6, xor_refs: bool = True) -> bytes:
    """RSCSparseVector -> reference-format 'BC' BLOB."""
    from ..sv.sparse_vector import SparseVector
    rsc._flush()
    null_bv = rsc.get_null_bvector()
    idx = null_bv.indices()
    if idx.size == 0:
        return b"BZ"
    vals = rsc.gather(idx)
    dense = SparseVector.from_array(np.asarray(vals, rsc.dtype),
                                    device=rsc.device)
    ref_val = 8 * np.dtype(rsc.dtype).itemsize
    rows = {}
    for i, bv in enumerate(dense.planes):
        if bv is None or not bv.any():
            continue
        if i >= ref_val:
            raise ValueError("value slice exceeds the reference layout")
        rows[i] = bv
    rows[ref_val] = null_bv
    # RSC size_internal is the ASSIGNED count (src/bmsparsevec_compr.h:935);
    # value rows live in the rank-compressed domain, the NULL row in the
    # logical one: every row is clamped by the logical size
    return _serialize_matrix(rows, ref_val + 1, len(idx), "C", level,
                             clamp=int(rsc.size), xor_refs=xor_refs)


# ---------------------------------------------------------------------------
# string sparse vectors (remap-trait SVs)
# ---------------------------------------------------------------------------
def _parse_remap_section(data, offsets, rows_decoded, device):
    """The remap section sits right after the byte-wise last plane BLOB
    (deserialize_planes records it off the highest-index row,
    src/bmsparsevec_serial.h).  Returns unmap ([rows][256] stored->char)
    or None."""
    if not offsets:
        return None
    last_row = max(offsets, key=offsets.get)
    # re-measure the last plane to find where the remap section starts
    de = RefDeserializer(
        ref_vectors=[(i, bv) for i, bv in rows_decoded.items()
                     if i != last_row], device=device)
    de.deserialize(bytes(data)[offsets[last_row]:])
    pos = offsets[last_row] + de.bytes_consumed
    r = _ByteReader(bytes(data)[pos:])
    tag = r.get_8()
    if tag == ord("N"):
        return None
    if tag == ord("R"):
        n = r.get_64()
        buf = np.frombuffer(bytes(data)[pos + 9:pos + 9 + n], np.uint8)
        return buf.reshape(-1, 256).copy()
    if tag == ord("C"):
        n_rows = r.get_32()
        if n_rows > 1024:
            raise ValueError(
                "malformed stream: implausible remap row count")
        r.get_16()                              # columns (256)
        bi = _BitIn(r)
        rlens = [bi.gamma() for _ in range(n_rows)]
        out = np.zeros((n_rows, 256), np.uint8)
        # (col, value) byte pairs follow the bitstream, byte-aligned
        for rr in range(n_rows):
            for _ in range(rlens[rr]):
                j = r.get_8()
                v = r.get_8()
                out[rr, j] = v
        if r.get_8() != ord("E"):
            raise ValueError("remap matrix integrity token missing")
        return out
    raise ValueError(f"unknown remap section tag {tag}")


def deserialize_str_blob(data, device=None):
    """Reference str_sparse_vector BLOB -> StrSparseVector on ``device``."""
    from ..sv.sparse_vector import SparseVector
    from ..sv.str_vector import StrSparseVector
    dev = resolve_device(device)
    r = _ByteReader(data)
    hdr = _read_header(r)
    if hdr["kind"] == "Z":
        return StrSparseVector(1, nullable=True, device=dev)
    if hdr["kind"] != "M":
        raise ValueError("not a bit-matrix BLOB")
    planes = hdr["planes"]
    has_null = (planes % 8) == 1
    max_str = planes // 8
    if max_str > 4096:
        raise ValueError(
            "malformed stream: implausible string width")
    rows, offsets = _read_planes(data, hdr, device=dev)
    unmap = _parse_remap_section(data, offsets, rows, dev)

    ssv = StrSparseVector(max_str, nullable=True, device=dev)
    ssv._size = hdr["size"]
    for k in range(max_str):
        osv = SparseVector(np.uint8, device=dev)
        osv._size = hdr["size"]
        for b in range(8):
            bv = rows.get(8 * k + b)
            if bv is not None:
                osv.planes[b] = bv
        ssv.octets[k] = osv
    if has_null and (8 * max_str) in rows:
        ssv.null_plane = rows[8 * max_str]
    else:
        ssv.null_plane = BitVector(C.ID_MAX48, device=dev)
        if ssv._size:
            ssv.null_plane.set_range(0, ssv._size - 1)
    if unmap is not None:
        um = np.zeros((max_str, 256), np.uint8)
        um[:unmap.shape[0], :unmap.shape[1]] = unmap[:max_str]
        rm = np.zeros((max_str, 256), np.uint8)
        for k in range(max_str):
            codes = np.flatnonzero(um[k])
            rm[k, um[k, codes]] = codes
        ssv.unmap_matrices = um
        ssv.remap_matrices = rm
    return ssv


def serialize_str_blob(ssv, level: int = 6, template_max_str: int = 32,
                       xor_refs: bool = True) -> bytes:
    """StrSparseVector -> reference-format BLOB (reference-readable; the
    remap matrix stored in CSR form when the vector is remapped).

    template_max_str must match the reading side's str_sparse_vector
    STR_SIZE template parameter: the reference fixes the NULL row at
    row 8*STR_SIZE (load_null_plane reads row planes-1), so the BLOB's
    row count is 8*STR_SIZE+1 whatever the strings' lengths."""
    for o in ssv.octets:
        o._flush()
    size = int(ssv._size)
    if size == 0:
        return b"BZ"
    max_str = ssv.max_str_size
    if max_str > template_max_str:
        raise ValueError(
            f"strings up to {max_str} octets exceed the reader template "
            f"STR_SIZE={template_max_str}")
    rows = {}
    for k in range(max_str):
        for b, bv in enumerate(ssv.octets[k].planes[:8]):
            if bv is not None and bv.any():
                rows[8 * k + b] = bv
    null_row = 8 * template_max_str
    if ssv.nullable and ssv.null_plane is not None:
        rows[null_row] = ssv.null_plane
    else:
        rows[null_row] = _assigned_row(size)

    w = _ByteWriter()
    if ssv.is_remap():
        # CSR form ('C'): rows/cols, gamma row lengths, (col, value) pairs.
        # Rows stop at the first empty row, as the reference's
        # encode_remap_matrix does (a zero length cannot be gamma-coded).
        um = ssv.unmap_matrices
        n_rows = um.shape[0]
        for k in range(um.shape[0]):
            if not np.count_nonzero(um[k]):
                n_rows = k
                break
        w.put_8(ord("C"))
        w.put_32(n_rows)
        w.put_16(256)
        bo = _BitOut(w)
        for k in range(n_rows):
            bo.gamma(int(np.count_nonzero(um[k])))
        bo.flush()
        for k in range(n_rows):
            for j in np.flatnonzero(um[k]):
                w.put_8(int(j))
                w.put_8(int(um[k, j]))
        w.put_8(ord("E"))
    else:
        w.put_8(ord("N"))
    return _serialize_matrix(rows, 8 * template_max_str + 1, size, "M",
                             level, remap_section=w.get_bytes(),
                             xor_refs=xor_refs)


# ---------------------------------------------------------------------------
# float sparse vectors ("bf0" composite, src/bmsparsevec_float_serial.h)
# ---------------------------------------------------------------------------
def serialize_float_blob(fv, level: int = 6) -> bytes:
    """FloatSparseVector (float32) -> reference 'bf0' BLOB: header + sign
    bvector BLOB + exponent SV BLOB + mantissa SV BLOB (sizes as u64)."""
    from ..sv.sparse_vector import SparseVector
    if fv.dtype != np.float32:
        raise ValueError("reference float format is float32 only")
    n = int(fv.size)
    sign_blob = RefSerializer(level).serialize(_clamped(fv.sign, n))

    def u32_blob(sv_small):
        vals = sv_small.to_numpy().astype(np.uint32) if n else \
            np.zeros(0, np.uint32)
        sv = SparseVector.from_array(vals, nullable=True, device=fv.device)
        if fv.nullable and fv.null_plane is not None:
            sv.null_plane = fv.null_plane
        return serialize_sv_blob(sv, level)

    exp_blob = u32_blob(fv.exponent)
    mant_blob = u32_blob(fv.mantissa)
    w = _ByteWriter()
    w.parts += b"bf0"
    w.put_64(len(sign_blob))
    w.put_64(len(exp_blob))
    w.put_64(len(mant_blob))
    w.parts += sign_blob + exp_blob + mant_blob
    return w.get_bytes()


def deserialize_float_blob(data, device=None):
    """Reference 'bf0' BLOB -> FloatSparseVector (float32) on ``device``."""
    from ..sv.float_vector import FloatSparseVector
    dev = resolve_device(device)
    data = bytes(data)
    if data[:3] != b"bf0":
        raise ValueError("bad float sparse-vector magic")
    r = _ByteReader(data[3:27])
    sizes = [r.get_64() for _ in range(3)]
    off = 27
    sign_bv = RefDeserializer(device=dev).deserialize(
        data[off:off + sizes[0]])
    off += sizes[0]
    exp_sv = deserialize_sv_blob(data[off:off + sizes[1]], np.uint32,
                                 device=dev)
    off += sizes[1]
    mant_sv = deserialize_sv_blob(data[off:off + sizes[2]], np.uint32,
                                  device=dev)

    n = _cap_dense(max(int(exp_sv.size), int(mant_sv.size)))
    fv = FloatSparseVector(np.float32, nullable=True, device=dev)
    if n == 0:
        return fv
    ids = np.arange(n, dtype=np.int64)
    exp = np.asarray(exp_sv.gather(ids), np.uint32)
    mant = np.asarray(mant_sv.gather(ids), np.uint32)
    sbits = sign_bv.to_numpy(n).astype(np.uint32)
    bits = (sbits << np.uint32(31)) | (exp << np.uint32(23)) | mant
    fv.import_values(bits.view(np.float32), 0)
    nn = exp_sv.null_plane
    if nn is not None:
        fv.null_plane = nn
    return fv
