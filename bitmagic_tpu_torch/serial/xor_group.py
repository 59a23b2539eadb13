"""Cross-vector XOR delta compression for groups of related bit-vectors
(port of ``bitmagic_tpu/serial/xor_group.py``).

Equivalent of the reference's bmxor.h machinery (bv_ref_vector +
xor_sim_model + serializer XOR filter, src/bmxor.h:623-1440) on the
native BMT1 format: when serializing a GROUP of related vectors, a block
whose XOR against the same block of an EARLIER group member is much
sparser is stored as that XOR product plus a reference id.

Unlike the reference (which scans match chains per block with GC/BC
heuristics), the similarity model here is computed in one vectorized
pass per vector pair: per-block popcounts of the XOR products for all
shared blocks at once (numpy popcount over aligned host views of the
pools) in place of the per-block scanner loop.

Group BLOB layout:
  magic b"BMX1" | u32 n_vectors
  per vector: u32 blob_len | payload
    payload = standard BMT1 BLOB whose record stream may contain
    XOR-reference records: code 9 | payload = u32 ref_vector_idx |
    inner_code u8 | inner payload (the XOR product, any BMT1 block code)
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..core.bitvector import BitVector
from ..ops.blockops import full_block_np
from . import native
from .encoding import ByteDecoder, ByteEncoder
from .opdeser import _materialize_subset, _stream_blocks
from .serializer import (CODE_END, CODE_FULL, CODE_FULL_RUN, Deserializer,
                         MAGIC, Serializer, _decode_payload,
                         read_blob_header, read_record_header, run_span,
                         write_end_record, write_record_header)

GROUP_MAGIC = b"BMX1"
CODE_XOR_REF = 9


def _pool_map(bv):
    """dict nb -> words (np, dense) for BIT/GAP blocks; FULL handled
    separately (GAP rows expand via the dense snapshot)."""
    nb_a, cls_a, pool = bv._dense_snapshot()
    out = {}
    row = 0
    for k in range(len(nb_a)):
        if cls_a[k] == C.CLS_BIT:
            out[int(nb_a[k])] = pool[row]
            row += 1
    return out


def serialize_group(vectors, level: int = 6, gain: float = 0.5) -> bytes:
    """Serialize related vectors with cross-vector XOR deltas.  A block is
    stored as an XOR product against vector j<i when the product popcount
    is below ``gain`` * original popcount (the reference's target_gain
    knob, src/bmxor.h:58-71)."""
    ser = Serializer(level)
    enc = ByteEncoder()
    enc.put_bytes(GROUP_MAGIC)
    enc.put_32(len(vectors))

    prev_maps = []                       # (vec_idx, dict nb -> words)
    for vi, bv in enumerate(vectors):
        bv._flush()
        my_map = _pool_map(bv)
        # vectorized similarity model: per-block XOR popcounts vs each
        # earlier vector, all shared blocks at once
        best = {}                        # nb -> (ref_idx, xor_words, xor_bc)
        if prev_maps and my_map:
            my_nbs = np.asarray(sorted(my_map), np.int64)
            mine = np.stack([my_map[int(nb)] for nb in my_nbs])
            my_bc = np.bitwise_count(mine).sum(axis=1).astype(np.int64)
            for rj, rmap in prev_maps:
                shared = [i for i, nb in enumerate(my_nbs)
                          if int(nb) in rmap]
                if not shared:
                    continue
                ref_stack = np.stack([rmap[int(my_nbs[i])] for i in shared])
                prod = mine[shared] ^ ref_stack
                pbc = np.bitwise_count(prod).sum(axis=1).astype(np.int64)
                for row, i in enumerate(shared):
                    nb = int(my_nbs[i])
                    if pbc[row] < gain * my_bc[i] and \
                            (nb not in best or pbc[row] < best[nb][2]):
                        best[nb] = (rj, prod[row], int(pbc[row]))

        blob = ser.serialize(bv)
        if best:
            blob = _rewrite_with_xor(blob, best, ser)
        enc.put_32(len(blob))
        enc.put_bytes(blob)
        prev_maps.append((vi, my_map))
    return enc.get_bytes()


def _rewrite_with_xor(blob: bytes, best: dict, ser: Serializer) -> bytes:
    """Replace records of blocks in ``best`` with XOR-reference records."""
    dec = ByteDecoder(blob)
    out = ByteEncoder()
    hdr_start = dec.pos
    _, compact = read_blob_header(dec)
    out.put_bytes(blob[hdr_start:dec.pos])
    prev_r = prev_w = -1
    while True:
        nb, code, plen = read_record_header(dec, prev_r, compact)
        if code == CODE_END:
            write_end_record(out, compact)
            break
        payload = dec.get_bytes(plen)
        # FULL_RUN records delta-base on the run's LAST block
        prev_r = (nb + run_span(payload) - 1 if code == CODE_FULL_RUN
                  else nb)

        def emit(c, p):
            nonlocal prev_w
            write_record_header(out, nb, prev_w, c, len(p), compact)
            out.put_bytes(p)
            prev_w = prev_r

        ent = best.get(nb)
        if ent is None or code == CODE_FULL:
            emit(code, payload)
            continue
        ref_idx, prod, pbc = ent
        inner_code, inner_payload = ser._encode_block(
            prod, pbc, _gap_count(prod))
        wrapped = ByteEncoder()
        wrapped.put_32(ref_idx)
        wrapped.put_8(inner_code)
        wrapped.put_bytes(inner_payload)
        w = wrapped.get_bytes()
        if len(w) >= plen:               # XOR did not actually help
            emit(code, payload)
            continue
        emit(CODE_XOR_REF, w)
    return out.get_bytes()


def _gap_count(words) -> int:
    return len(native.block_gap_boundaries(words)[1])


def deserialize_group(data: bytes, sel=None,
                      device=None) -> list[BitVector]:
    """Inverse of serialize_group, onto ``device``.  ``sel`` restricts
    decoding:
    ("range", (lo, hi)) materializes only that bit range; ("blocks", want)
    only the listed block ids — XOR references are block-aligned
    (same-nb against earlier vectors), so a restricted decode of the
    references resolves every in-selection patch."""
    dec = ByteDecoder(data)
    if dec.get_bytes(4) != GROUP_MAGIC:
        raise ValueError("bad group magic")
    n = dec.get_32()
    out: list[BitVector] = []
    deser = Deserializer(device)
    for _ in range(n):
        blen = dec.get_32()
        blob = dec.get_bytes(blen)
        out.append(_deserialize_with_xor(blob, out, deser, sel))
    return out


def _decode_plain(blob, deser, sel):
    if sel is None:
        return deser.deserialize(blob)
    if sel[0] == "range":
        return deser.deserialize(blob, range_=sel[1])
    _, size, _ = next(_stream_blocks(blob))
    try:
        return _materialize_subset(blob, sel[1], size, deser.device)
    except native.RunCodedBlob:
        # span-coded blob: full decode is O(records) anyway (runs are
        # interval metadata); a superset result is semantically fine here
        return deser.deserialize(blob)


def _deserialize_with_xor(blob, group, deser, sel=None) -> BitVector:
    """Decode a BMT1 BLOB that may contain CODE_XOR_REF records."""
    if CODE_XOR_REF not in _codes_present(blob):
        return _decode_plain(blob, deser, sel)
    # split: decode plain records via the native path, patch XOR records
    d = ByteDecoder(blob)
    out = ByteEncoder()
    hdr_start = d.pos
    size, compact = read_blob_header(d)
    out.put_bytes(blob[hdr_start:d.pos])
    patches = []                         # (nb, ref_idx, words)
    prev_r = prev_w = -1
    while True:
        nb, code, plen = read_record_header(d, prev_r, compact)
        if code == CODE_END:
            write_end_record(out, compact)
            break
        payload = d.get_bytes(plen)
        prev_r = (nb + run_span(payload) - 1 if code == CODE_FULL_RUN
                  else nb)
        if code != CODE_XOR_REF:
            write_record_header(out, nb, prev_w, code, plen, compact)
            out.put_bytes(payload)
            prev_w = prev_r
            continue
        pd = ByteDecoder(payload)
        ref_idx = pd.get_32()
        inner_code = pd.get_8()
        prod = _decode_payload(inner_code, payload[5:])
        patches.append((nb, ref_idx, prod))
    bv = _decode_plain(out.get_bytes(), deser, sel)
    if sel is not None:
        # keep only patches whose block is inside the selection
        if sel[0] == "range":
            lo_b, hi_b = sel[1][0] >> C.SET_BLOCK_SHIFT, \
                sel[1][1] >> C.SET_BLOCK_SHIFT
            patches = [p for p in patches if lo_b <= p[0] <= hi_b]
        else:
            patches = [p for p in patches if p[0] in sel[1]]
    if patches:
        ref_words = {}
        all_pos = []
        for nb, ref_idx, prod in patches:
            key = ref_idx
            if key not in ref_words:
                ref_words[key] = _pool_map(group[key])
            ref_blk = ref_words[key].get(nb)
            if ref_blk is None:
                # FULL or ZERO reference block
                st, _ = group[key]._struct.lookup(np.asarray([nb]))
                ref_blk = (full_block_np()
                           if st[0] == 1 else
                           np.zeros(C.SET_BLOCK_SIZE, np.uint32))
            words = prod ^ ref_blk
            base = nb << C.SET_BLOCK_SHIFT
            pos = np.flatnonzero(np.unpackbits(
                words.view(np.uint8), bitorder="little")).astype(np.int64)
            if pos.size:
                all_pos.append(base + pos)
        if all_pos:
            # single bulk scatter: one device pass for all patched blocks
            pos = np.concatenate(all_pos)
            if sel is not None and sel[0] == "range":
                lo, hi = sel[1]
                pos = pos[(pos >= lo) & (pos <= hi)]
            if pos.size:
                bv.set_many(pos)
    return bv


def _codes_present(blob) -> set:
    codes = set()
    d = ByteDecoder(blob)
    _, compact = read_blob_header(d)
    prev = -1
    while True:
        nb, code, plen = read_record_header(d, prev, compact)
        if code == CODE_END:
            return codes
        if code == CODE_FULL_RUN:
            prev = nb + run_span(d.data[d.pos:d.pos + plen]) - 1
        else:
            prev = nb
        codes.add(code)
        d.pos += plen
