"""BitVector serialization: compressed BMT1 BLOBs with a per-block format
choice (port of ``bitmagic_tpu/serial/serializer.py``).

Equivalent of `bm::serializer<BV>` / deserializers (src/bmserial.h:75-1241):
compression levels 0-6, a per-block best-format chooser driven by block
statistics (BC = popcount, GC = gap count — reference
find_bit_best_encoding, src/bmserial.h:2373), zero/full run folding,
set-bit arrays (direct & inverted) with Binary Interpolative Coding, D-GAP
encodings with gamma/BIC, and range deserialization.

Format (not byte-compatible with the reference BLOB format, which
``serial/refcodec.py`` reads and writes; this one keeps the same
capability classes with explicit per-record lengths so that range and
gather deserialization can skip payloads without bookmarks):

  header:  magic b"BMT1" | flags u8 | size u64
  record:  block_id u48 | code u8 | payload_len u32 | payload
  trailer: block_id = 0xFFFFFFFFFFFF, code = END

The whole BLOB encodes and decodes in one call of the port's native
library (``serial/native``).  Serializing a vector on the card costs one
device-to-host copy of its dense rows; GAP blocks encode straight from
their runs and FULL runs stay records.  Deserialization uploads the dense
rows to the requested device and keeps D-GAP records run-coded in a host
GapStore.  A BLOB the native decoder rejects is walked record by record in
Python, which raises the error of the malformed record.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..core.bitvector import BitVector
from ..core.blocks import RUN_MIN, Structure, runs_normalize, split_runs
from ..core.gapstore import GapStore
from . import native
from .encoding import BitReader, ByteDecoder, ByteEncoder
from .refcodec import (_BitIn, _BitOut, _ByteReader, _ByteWriter,
                       ref_deserialize)


def _bic_bytes(arr, lo, hi) -> bytes:
    """BIC payload: centered-minimal code in an LSB-first 32-bit-word
    bitstream — the tightest of the BIC variants (~0.5 bits/int better
    than plain minimal-binary on postings lists).  Shares the native C++
    hot loop with the reference-format codec (codecs.cpp
    bmref_bic_encode_cm)."""
    w = _ByteWriter()
    bo = _BitOut(w)
    bo.bic_encode_cm(np.asarray(arr, np.int64), int(lo), int(hi))
    bo.flush()
    return w.get_bytes()


def _bic_unbytes(data, n, lo, hi) -> np.ndarray:
    bi = _BitIn(_ByteReader(data))
    return np.asarray(bi.bic_decode_cm(int(n), int(lo), int(hi)), np.int64)


def _gamma_bytes(arr) -> bytes:
    return native.gamma_encode_bytes(np.asarray(arr, np.uint64))


def _gamma_unbytes(data, n) -> np.ndarray:
    return native.gamma_decode_bytes(data, n)


MAGIC = b"BMT1"
END_BLOCK = (1 << 48) - 1

# header flag bits
FLAG_64BIT = 1
FLAG_COMPACT = 2        # varint record headers (delta block id + length)


def read_blob_header(dec: ByteDecoder):
    """Parse the 13-byte file header -> (size, compact); dec is left at the
    first record."""
    if dec.get_bytes(4) != MAGIC:
        raise ValueError("bad magic")
    flags = dec.get_8()
    return dec.get_64(), bool(flags & FLAG_COMPACT)


def read_record_header(dec: ByteDecoder, prev_nb: int, compact: bool):
    """Parse one record header -> (nb, code, plen); code == CODE_END at the
    trailer.  Compact records carry varint(nb - prev_nb) (>= 1; 0 marks
    END) + code u8 + varint payload length; classic records are the fixed
    u48 | u8 | u32 form."""
    if compact:
        delta = dec.get_varint()
        if delta == 0:
            return END_BLOCK, CODE_END, 0
        return prev_nb + delta, dec.get_8(), dec.get_varint()
    return dec.get_48(), dec.get_8(), dec.get_32()


def write_record_header(enc: ByteEncoder, nb: int, prev_nb: int, code: int,
                        plen: int, compact: bool):
    if compact:
        enc.put_varint(nb - prev_nb)
        enc.put_8(code)
        enc.put_varint(plen)
    else:
        enc.put_48(nb)
        enc.put_8(code)
        enc.put_32(plen)


def write_end_record(enc: ByteEncoder, compact: bool):
    if compact:
        enc.put_varint(0)
    else:
        enc.put_48(END_BLOCK)
        enc.put_8(CODE_END)
        enc.put_32(0)


# block codes
CODE_END = 0
CODE_FULL = 1
CODE_RAW = 2
CODE_ARR16 = 3          # raw u16 set-bit positions
CODE_ARR16_INV = 4      # raw u16 clear-bit positions
CODE_ARR_BIC = 5        # BIC-coded set-bit positions
CODE_ARR_BIC_INV = 6    # BIC-coded clear-bit positions
CODE_GAP_GAMMA = 7      # gamma-coded D-GAP run lengths
CODE_GAP_BIC = 8        # BIC-coded D-GAP boundaries
CODE_FULL_RUN = 10      # N consecutive FULL blocks; payload = varint(N)
#   (9 is the group-level XOR_REF code, xor_group.py)
#   After a FULL_RUN record the delta base (prev_nb) is the run's LAST
#   block.  The reference encodes such runs with its multi-scale one-run
#   codes (src/bmserial.h:1183-1199); BMT1 zero runs are implicit because
#   record ids are explicit.

_CODE_NAMES = {
    CODE_FULL: "full", CODE_RAW: "raw", CODE_ARR16: "arr16",
    CODE_ARR16_INV: "arr16_inv", CODE_ARR_BIC: "arr_bic",
    CODE_ARR_BIC_INV: "arr_bic_inv", CODE_GAP_GAMMA: "gap_gamma",
    CODE_GAP_BIC: "gap_bic", CODE_FULL_RUN: "full_run",
}


def run_span(payload: bytes) -> int:
    """Decode a FULL_RUN record's span (varint payload)."""
    span = ByteDecoder(payload).get_varint()
    if span <= 0:
        raise ValueError("malformed FULL_RUN record")
    return span


def _coalesce_records(nb: np.ndarray, cls: np.ndarray, runs: np.ndarray):
    """Merge per-block FULL entries + FULL runs into span-coded records:
    (rec_nb, rec_cls, rec_span) sorted by block id; BIT entries keep their
    relative order (their rows align 1:1 with the pool rows).

    Spans below RUN_MIN stay per-block FULL records: they cost ~3 B each
    anyway, and keeping them single-block preserves the streamed
    operation_deserializer's no-materialize contract (span records route
    to decode-then-apply)."""
    fm = cls == C.CLS_FULL
    parts = []
    if fm.any():
        f = nb[fm]
        parts.append(np.stack([f, f + 1], axis=1))
    if runs.shape[0]:
        parts.append(runs)
    if not parts:
        return (nb, cls, np.ones(nb.size, np.int64))
    iv, pts = split_runs(runs_normalize(np.concatenate(parts)), RUN_MIN)
    bit_nb = nb[~fm]
    rec_nb = np.concatenate([bit_nb, pts, iv[:, 0]])
    rec_cls = np.concatenate([
        cls[~fm],                      # BIT / GAP classes pass through
        np.full(pts.size + iv.shape[0], C.CLS_FULL, np.uint8)])
    rec_span = np.concatenate([np.ones(bit_nb.size + pts.size, np.int64),
                               iv[:, 1] - iv[:, 0]])
    order = np.argsort(rec_nb, kind="stable")
    return rec_nb[order], rec_cls[order], rec_span[order]


class Serializer:
    """bm::serializer equivalent.  level 0..6 as in the reference
    (src/bmserial.h:115-127): 0 raw, 1-3 arrays/GAP, 4 +gamma, 5-6 +BIC."""

    def __init__(self, level: int = 6):
        self.set_compression_level(level)
        self.compression_stat = {}
        self._stat_reset = True

    def set_compression_level(self, level: int):
        if not (0 <= level <= 6):
            raise ValueError("level must be 0..6")
        self.level = level

    def get_compression_level(self) -> int:
        """src/bmserial.h get_compression_level()."""
        return self.level

    def get_compression_stat(self) -> dict:
        """Per-block-code usage counts of the last serialize()
        (reference compression_stat_, src/bmserial.h:214)."""
        return dict(self.compression_stat)

    def byte_order_serialization(self, enable: bool):
        """Reference knob (src/bmserial.h): BMT1 is always little-endian
        and self-describing, so there is nothing to toggle; kept for API
        parity."""
        self._bo_serial = bool(enable)

    def gap_length_serialization(self, enable: bool):
        """Reference knob (src/bmserial.h): BMT1 records carry their own
        lengths, so GAP level tables never serialize; kept for API
        parity."""
        self._gapl_serial = bool(enable)

    def set_bookmarks(self, enable: bool, bm_interval: int = 256):
        """Reference bookmark sync marks (src/bmserial.h:246) let range
        deserialization skip ahead; BMT1's compact self-describing records
        already support O(records-skipped) range skip without marks, so
        this is accepted for parity and recorded only."""
        self._bookmarks = (bool(enable), int(bm_interval))

    def reset_compression_stats(self):
        """src/bmserial.h reset_compression_stats()."""
        self.compression_stat = {}
        return self

    def allow_stat_reset(self, allow: bool = True):
        """Reference knob (src/bmserial.h:207): when False, serialize()
        accumulates code counts across calls instead of resetting."""
        self._stat_reset = bool(allow)
        return self

    def set_bic_coeff(self, coeff: int):
        """Reference BIC tuning knob (src/bmserial.h): the BMT1 BIC
        admission is cost-model driven per record, so the coefficient is
        recorded for parity only."""
        self._bic_coeff = int(coeff)
        return self

    def set_bic_dynamic_range_reduce(self, enable: bool):
        """Reference BIC dynamic-range knob; recorded for parity (BMT1's
        coder always narrows ranges per record)."""
        self._bic_drr = bool(enable)
        return self

    def optimize_serialize_destroy(self, bv) -> bytes:
        """optimize + serialize + free the vector's payload in one call
        (reference optimize_serialize_destroy, src/bmserial.h:189 — the
        memory-frugal bulk export path)."""
        bv.optimize()
        blob = self.serialize(bv)
        bv.clear()
        return blob

    # ------------------------------------------------------------------
    def serialize(self, bv: BitVector) -> bytes:
        """The BMT1 BLOB of ``bv``: one host copy of its dense rows, GAP
        blocks encoded from their runs, every record in one native call."""
        bv._flush()
        enc = ByteEncoder()
        enc.put_bytes(MAGIC)
        enc.put_8(FLAG_64BIT | FLAG_COMPACT)
        enc.put_64(bv.size)
        if self._stat_reset:
            self.compression_stat = {}
        st = bv._struct
        rec_nb, rec_cls, rec_span = _coalesce_records(st.nb, st.cls, st.runs)
        words = (bv._pool_host() if (st.cls == C.CLS_BIT).any()
                 else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
        store = bv._gaps
        gap_args = ({} if store is None else
                    dict(gap_ends=store.ends_i32(), gap_offs=store.offs,
                         gap_first=store.first))
        res = native.bmt1_encode(words, rec_nb, rec_cls, self.level,
                                 spans=rec_span, **gap_args)
        if res is None:
            raise RuntimeError("bitmagic_tpu_torch: the native BMT1 "
                               "encoder rejected the vector's structure")
        records, counts = res
        for code, cnt in enumerate(counts):
            if cnt:
                name = _CODE_NAMES.get(code, str(code))
                self.compression_stat[name] = (
                    self.compression_stat.get(name, 0) + int(cnt))
        return enc.get_bytes() + records

    # ------------------------------------------------------------------
    def _encode_block(self, words: np.ndarray, bc: int, gc: int):
        """Best-format chooser for one dense block (find_bit_best_encoding
        analog, src/bmserial.h:2373) — the XOR-group writer's record
        encoder.  The candidate order, cost formulas and strict-<
        tie-breaking mirror codecs.cpp bm_bmt1_encode exactly, so a block
        gets the code the whole-BLOB encoder would give it."""
        level = self.level
        best_cost, best_code = C.SET_BLOCK_SIZE * 4 + 1, CODE_RAW
        inv_bc = C.BITS_PER_BLOCK - bc

        def consider(est, code):
            nonlocal best_cost, best_code
            if est < best_cost:
                best_cost, best_code = est, code

        if level >= 1:
            if bc < C.BITS_PER_BLOCK:
                consider(3 + 2 * bc, CODE_ARR16)
            if inv_bc < C.BITS_PER_BLOCK:
                consider(3 + 2 * inv_bc, CODE_ARR16_INV)
        boundaries = None
        L = gc
        if level >= 4 and L < 16384:
            # exact gamma cost of the run-length list (matches the native
            # chooser's per-run bit count)
            first_val, bounds = native.block_gap_boundaries(words)
            boundaries = (int(first_val), np.asarray(bounds, np.int64))
            runs = np.diff(boundaries[1], prepend=-1)
            gamma_bits = int(np.sum(
                2 * np.int64(np.floor(np.log2(runs)) + 1) - 1))
            nL = int(boundaries[1].size)
            gamma_bits += 2 * int(nL).bit_length() - 1
            consider(2 + (gamma_bits + 7) // 8, CODE_GAP_GAMMA)
        if level >= 5:
            if 0 < bc <= C.BIE_CUT_OFF:
                consider(bc * 30 // 64 + 5, CODE_ARR_BIC)
            if 0 < inv_bc <= C.BIE_CUT_OFF:
                consider(inv_bc * 30 // 64 + 5, CODE_ARR_BIC_INV)
            if L < 16384:
                consider(L * 30 // 64 + 6, CODE_GAP_BIC)
        if level >= 6:
            # L6 admits denser arrays at the reference's 2.2 bits/int BIC
            # coefficient (src/bmserial.h:546)
            if C.BIE_CUT_OFF < bc <= 29789:
                consider(bc * 22 // 80 + 5, CODE_ARR_BIC)
            if C.BIE_CUT_OFF < inv_bc <= 29789:
                consider(inv_bc * 22 // 80 + 5, CODE_ARR_BIC_INV)
        return best_code, self._encode_payload(best_code, words, bc,
                                               boundaries)

    def _encode_payload(self, code, words, bc, boundaries=None):
        if code == CODE_RAW:
            return words.astype("<u4").tobytes()
        if code in (CODE_ARR16, CODE_ARR_BIC, CODE_ARR16_INV,
                    CODE_ARR_BIC_INV):
            inv = code in (CODE_ARR16_INV, CODE_ARR_BIC_INV)
            pos = native.block_positions(words, inv)
        else:
            # D-GAP runs: boundary positions where the bit value changes;
            # reference GAP buffer stores [last-index-of-run...] u16s
            first_val, bounds = (boundaries if boundaries is not None
                                 else native.block_gap_boundaries(words))
            change = bounds[:-1]
            if code == CODE_GAP_GAMMA:
                # 1 header byte (first_val) + gamma([n_runs, run lengths...])
                runs = np.diff(np.concatenate([[-1], change,
                                               [C.BITS_PER_BLOCK - 1]]))
                payload = _gamma_bytes(
                    np.concatenate([[runs.size], runs]).astype(np.uint64))
                return bytes([first_val]) + payload
            # CODE_GAP_BIC: boundaries are strictly increasing u16s
            e = ByteEncoder()
            e.put_8(first_val)
            e.put_32(change.size)
            e.put_bytes(_bic_bytes(change, 0, C.BITS_PER_BLOCK - 2))
            return e.get_bytes()
        if code in (CODE_ARR16, CODE_ARR16_INV):
            e = ByteEncoder()
            e.put_32(pos.size)
            e.put_array_u16(pos)
            return e.get_bytes()
        e = ByteEncoder()
        e.put_32(pos.size)
        e.put_bytes(_bic_bytes(pos, 0, C.BITS_PER_BLOCK - 1))
        return e.get_bytes()


class Deserializer:
    """bm::deserializer equivalent with range support (deserialize_range
    uses the per-record lengths the way the reference uses bookmarks,
    src/bmserial.h:647).  Reference-format BLOBs are sniffed by magic and
    routed through the standalone refcodec decoder (with any attached
    ref_vectors), so this is a drop-in decode entry for both formats.
    ``device``: where decoded vectors put their dense rows
    (``config.resolve_device``)."""

    def __init__(self, device=None):
        self.device = device
        self._range = None
        self._ref_vectors = []

    def set_range(self, lo: int, hi: int):
        """Pre-set a [lo, hi] clip window applied by plain deserialize()
        (reference set_range, src/bmserial.h:647)."""
        self._range = (int(lo), int(hi))
        return self

    def unset_range(self):
        """Clear the set_range window (reference unset_range)."""
        self._range = None
        return self

    def set_ref_vectors(self, ref_vectors):
        """XOR reference collection for decoding reference-format BLOBs
        compressed with XOR refs (reference set_ref_vectors,
        src/bmserial.h:672)."""
        self._ref_vectors = list(ref_vectors or [])
        return self

    def deserialize(self, data: bytes, range_=None) -> BitVector:
        if range_ is None:
            range_ = self._range
        if bytes(data[:4]) != MAGIC:
            # reference-format BLOB
            bv = ref_deserialize(data, ref_vectors=self._ref_vectors,
                                 device=self.device)
            if range_ is not None:
                bv.keep_range(int(range_[0]), int(range_[1]))
            return bv
        dec = ByteDecoder(data)
        size, compact = read_blob_header(dec)
        if range_ is None:
            # whole-BLOB decode in one native call; D-GAP records KEEP
            # their run form (cls 3 -> GapStore), as the reference's gap
            # blocks deserialize as gap blocks (src/bmserial.h
            # read_gap_block)
            res = native.bmt1_decode_gap(data, dec.pos)
            if res is not None:
                nbs_a, cls_a, spans_a, words, (g_ends, g_offs, g_first) \
                    = res
                struct = _struct_from_spans(nbs_a, cls_a, spans_a)
                gaps = (GapStore(g_ends.astype(np.int64), g_offs, g_first)
                        if g_first.size else None)
                return BitVector._from_parts(struct, words, size,
                                             gaps=gaps, device=self.device)
            res = native.bmt1_decode(data, dec.pos)
            if res is not None:
                nbs_a, cls_a, spans_a, words = res
                struct = _struct_from_spans(nbs_a, cls_a, spans_a)
                return BitVector._from_parts(struct, words, size,
                                             device=self.device)
        lo_blk, hi_blk = 0, (1 << 48)
        if range_ is not None:
            lo_blk = int(range_[0]) >> C.SET_BLOCK_SHIFT
            hi_blk = int(range_[1]) >> C.SET_BLOCK_SHIFT
        nbs, clss, spans, rows = [], [], [], []
        g_ends, g_first = [], []
        prev_nb = -1
        while True:
            nb, code, plen = read_record_header(dec, prev_nb, compact)
            if code == CODE_END:
                break
            prev_nb = nb
            if code == CODE_FULL_RUN:
                payload = dec.get_bytes(plen)
                span = run_span(payload)
                prev_nb = nb + span - 1
                # clip the run to the requested block window
                s = max(nb, lo_blk)
                e = min(nb + span, hi_blk + 1)
                if e > s:
                    nbs.append(s)
                    clss.append(C.CLS_FULL)
                    spans.append(e - s)
                continue
            if not (lo_blk <= nb <= hi_blk):
                dec.pos += plen            # skip payload (bookmark jump)
                continue
            payload = dec.get_bytes(plen)
            if code == CODE_FULL:
                nbs.append(nb)
                clss.append(C.CLS_FULL)
                spans.append(1)
                continue
            if code in (CODE_GAP_GAMMA, CODE_GAP_BIC):
                # D-GAP records keep run form (succinct GapStore
                # residency) — same contract as the native decode_gap
                first, ends = _decode_gap_ends(code, payload)
                g_first.append(first)
                g_ends.append(ends)
                nbs.append(nb)
                clss.append(C.CLS_GAP)
                spans.append(1)
                continue
            words = _decode_payload(code, payload)
            nbs.append(nb)
            clss.append(C.CLS_BIT)
            spans.append(1)
            rows.append(words)
        pool = (np.stack(rows) if rows
                else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
        struct = _struct_from_spans(np.asarray(nbs, np.int64),
                                    np.asarray(clss, np.uint8),
                                    np.asarray(spans, np.int64))
        gaps = None
        if g_first:
            offs = np.zeros(len(g_ends) + 1, np.int64)
            np.cumsum([e.size for e in g_ends], out=offs[1:])
            gaps = GapStore(np.concatenate(g_ends), offs,
                            np.asarray(g_first, np.uint8))
        bv = BitVector._from_parts(struct, pool, size, gaps=gaps,
                                   device=self.device)
        if range_ is not None:
            bv.keep_range(int(range_[0]), int(range_[1]))
        return bv

    def deserialize_range(self, data: bytes, lo: int, hi: int) -> BitVector:
        return self.deserialize(data, range_=(lo, hi))


def _struct_from_spans(nbs: np.ndarray, cls: np.ndarray,
                       spans: np.ndarray) -> Structure:
    """Structure from decoded span-coded records: wide FULL spans
    (>= RUN_MIN blocks) stay interval-coded as Structure runs — a 2^32-bit
    FULL span deserializes to O(1) metadata; narrower spans expand to
    per-block FULL entries (BIT row order is preserved by stable sort)."""
    wide = spans > 1
    if not wide.any():
        return Structure(nbs, cls)
    big = wide & (spans >= RUN_MIN)
    small = wide & ~big
    pts = [nbs[~wide]]
    pcls = [cls[~wide]]
    for s, sp in zip(nbs[small], spans[small]):
        pts.append(np.arange(s, s + sp, dtype=np.int64))
        pcls.append(np.full(int(sp), C.CLS_FULL, np.uint8))
    nb = np.concatenate(pts)
    cl = np.concatenate(pcls)
    order = np.argsort(nb, kind="stable")
    runs = (runs_normalize(np.stack(
        [nbs[big], nbs[big] + spans[big]], axis=1))
        if big.any() else np.zeros((0, 2), np.int64))
    return Structure(nb[order], cl[order], runs)


def _decode_payload(code, payload) -> np.ndarray:
    if code == CODE_RAW:
        return np.frombuffer(payload, "<u4").astype(np.uint32)
    if code in (CODE_ARR16, CODE_ARR16_INV):
        d = ByteDecoder(payload)
        n = d.get_32()
        pos = d.get_array_u16(n).astype(np.int64)
        return _bits_to_words(pos, invert=(code == CODE_ARR16_INV))
    if code in (CODE_ARR_BIC, CODE_ARR_BIC_INV):
        d = ByteDecoder(payload)
        n = d.get_32()
        pos = _bic_unbytes(payload[4:], n, 0, C.BITS_PER_BLOCK - 1)
        return _bits_to_words(pos, invert=(code == CODE_ARR_BIC_INV))
    if code == CODE_GAP_GAMMA:
        first = payload[0]
        # first gamma value is the run count; decode it, then the whole list
        r = BitReader(payload[1:])
        n = r.get_gamma()
        vals = _gamma_unbytes(payload[1:], n + 1)
        runs = vals[1:].astype(np.int64)
        return _runs_to_words(first, runs)
    if code == CODE_GAP_BIC:
        d = ByteDecoder(payload)
        first = d.get_8()
        n = d.get_32()
        change = _bic_unbytes(payload[5:], n, 0, C.BITS_PER_BLOCK - 2)
        runs = np.diff(np.concatenate([[-1], change, [C.BITS_PER_BLOCK - 1]]))
        return _runs_to_words(first, runs)
    raise ValueError(f"unknown block code {code}")


def _decode_gap_ends(code, payload):
    """(first, inclusive run ends int64 with final 65535) of a D-GAP
    record WITHOUT dense expansion — the Python analog of the native
    bmt1_gap_ends, used by the record loop to keep gap records in
    succinct GapStore residency (matching the native decode_gap path)."""
    if code == CODE_GAP_GAMMA:
        first = payload[0]
        if first > 1:
            raise ValueError("malformed stream: bad GAP first byte")
        r = BitReader(payload[1:])
        n = r.get_gamma()
        if n > 65536:
            raise ValueError("malformed stream: GAP run count over block")
        vals = _gamma_unbytes(payload[1:], n + 1)
        ends = np.cumsum(vals[1:].astype(np.int64)) - 1
        if ends.size == 0 or ends[-1] != C.BITS_PER_BLOCK - 1 \
                or (ends > C.BITS_PER_BLOCK - 1).any():
            raise ValueError("malformed stream: GAP runs must cover block")
        return int(first), ends
    d = ByteDecoder(payload)
    first = d.get_8()
    if first > 1:
        raise ValueError("malformed stream: bad GAP first byte")
    n = d.get_32()
    if n > 65535:
        raise ValueError("malformed stream: GAP boundary count")
    change = _bic_unbytes(payload[5:], n, 0, C.BITS_PER_BLOCK - 2)
    return int(first), np.concatenate(
        [np.asarray(change, np.int64), [C.BITS_PER_BLOCK - 1]])


def _bits_to_words(pos, invert=False):
    bits = np.zeros(C.BITS_PER_BLOCK, np.uint8)
    bits[pos] = 1
    if invert:
        bits = 1 - bits
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _runs_to_words(first_val, runs):
    # run k holds value first_val ^ (k & 1)
    bits = np.repeat((np.arange(runs.size) + first_val) % 2,
                     runs).astype(np.uint8)
    return np.packbits(bits, bitorder="little").view(np.uint32)


# ---------------------------------------------------------------------------
# convenience one-shots (reference bm::serialize/deserialize free functions)
# ---------------------------------------------------------------------------
def serialize(bv: BitVector, level: int = 6) -> bytes:
    return Serializer(level).serialize(bv)


def deserialize(data: bytes, device=None) -> BitVector:
    return Deserializer(device).deserialize(data)
