"""Set algebra directly against serialized BLOBs (port of
``bitmagic_tpu/serial/opdeser.py``).

Equivalent of `bm::operation_deserializer` (src/bmserial.h:1006) driven by
`serial_stream_iterator` (:847): AND/OR/XOR/SUB and every COUNT_* op apply
between a live BitVector and a compressed BMT1 BLOB **block-record by
block-record** — the BLOB is never materialized into a BitVector.  The C
engine (codecs.cpp bm_bmt1_stream_op) keeps O(1 block) scratch and skips
payload decodes that cannot affect the result (AND against an absent target
block, OR under a FULL target, SUB_BA under a FULL target...), with the
per-record length fields playing the reference's bookmark role.  When the
engine rejects a BLOB as malformed, the Python record-at-a-time engine with
the same semantics walks it and raises the record's decode error.

The TARGET side streams too: the op never takes a dense snapshot of the
target.  The native engine runs over chunk windows of the BLOB's records
with the target view restricted to each chunk's blocks (GAP-resident
target blocks expand O(chunk) at a time); the Python paths read the target
lazily one block per record.  For a succinct target, per-chunk results are
reclassified back into D-GAP runs, so host high-water stays O(chunk) even
when the BLOB covers the whole vector, and succinct residency survives the
operation.  Target blocks the BLOB never mentions pass through without any
representation change (GAP stays GAP; counts come from the run domain).

Reference-format BLOBs stream the same way: RefDeserializer's sink mode
delivers finalized blocks in ascending order (the serial_stream_iterator
analog) into the combining sink — set and count ops never materialize the
BLOB for either format; results are bit-identical to the materialized
path (tests enforce).

Where the host meets the card: the target's dense rows are read on the
host through ``BitVector._pool_host()``, one device-to-host copy per pool
tensor however many blocks or windows the op visits.  Result rows go back
to the target's device in one upload; target rows the BLOB never mentions
stay on the device and are gathered there, and their popcounts for the
COUNT_* ops come from one K3 launch (``cuda_kernels.block_counts_total``).
BLOBs with FULL_RUN span records decode first and then run through the
BitVector set algebra (K1) or ``distance_operation`` (K2) on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..algo import setops
from ..core.bitvector import BitVector, _index
from ..core.blocks import Structure
from ..core.gapstore import GapStore
from ..core import gaps as gaps_mod
from ..ops import cuda_kernels as ck
from ..ops.blockops import full_block_np, to_device_words
from .encoding import ByteDecoder
from .refcodec import RefDeserializer, ref_deserialize
from .serializer import (CODE_END, CODE_FULL, CODE_FULL_RUN, Deserializer,
                         MAGIC, _decode_payload, read_blob_header,
                         read_record_header, run_span)
from . import native

_I64 = np.int64

# records per streaming window: bounds host high-water at CHUNK dense rows
# (512 KB) regardless of blob/target size
_CHUNK = 64


def _stream_blocks(data: bytes, want=None):
    """Yield (block_id, code, payload_or_None).  If ``want`` is a set of
    block ids, payloads of other blocks are skipped without decoding."""
    dec = ByteDecoder(data)
    size, compact = read_blob_header(dec)
    yield ("header", size, None)
    prev_nb = -1
    while True:
        nb, code, plen = read_record_header(dec, prev_nb, compact)
        if code == CODE_END:
            return
        if code == CODE_FULL_RUN:
            # span records don't fit the one-block-per-record engines
            raise native.RunCodedBlob(
                "FULL_RUN record in stream; decode-then-apply")
        prev_nb = nb
        if want is not None and nb not in want:
            dec.pos += plen
            yield (nb, code, None)
            continue
        yield (nb, code, dec.get_bytes(plen))


_REC_OFFSET = 13          # MAGIC(4) + flags(1) + size u64


def _blob_size(data: bytes) -> int:
    dec = ByteDecoder(data)
    if dec.get_bytes(4) != MAGIC:
        raise ValueError("bad magic")
    dec.get_8()
    return dec.get_64()


def _blob_record_index(data: bytes):
    """One header pass (no payload decode): (nbs int64[R], offs int64[R])
    — block id and byte offset of every record.  This is the chunked
    walk's window table and the pass-through 'mentioned' set."""
    res = native.bmt1_record_index(data, _REC_OFFSET)
    if res is not None:
        return res
    dec = ByteDecoder(data)
    _, compact = read_blob_header(dec)
    nbs, offs = [], []
    prev_nb = -1
    while True:
        off = dec.pos
        nb, code, plen = read_record_header(dec, prev_nb, compact)
        if code == CODE_END:
            return np.asarray(nbs, _I64), np.asarray(offs, _I64)
        if code == CODE_FULL_RUN:
            prev_nb = nb + run_span(dec.data[dec.pos:dec.pos + plen]) - 1
        else:
            prev_nb = nb
        nbs.append(nb)
        offs.append(off)
        dec.pos += plen


class _TargetReader:
    """Lazy per-block target lookup: FULL/absent answered symbolically,
    BIT rows from the host view of the pool (one copy per pool tensor),
    GAP blocks expanded ONE at a time.
    State contract matches the stream engines: 0 absent, 1 FULL, 2 row."""

    def __init__(self, bv: BitVector):
        bv._flush()
        self.bv = bv
        self.st = bv._struct
        self._slots = self.st.slots()
        self._gslots = self.st.gslots()

    def lookup(self, nb):
        st = self.st
        pos = int(np.searchsorted(st.nb, nb))
        if pos >= st.nb.size or st.nb[pos] != nb:
            return 0, None
        cls_k = int(st.cls[pos])
        if cls_k == C.CLS_FULL:
            return 1, None
        if cls_k == C.CLS_BIT:
            return 2, self.bv._pool_host()[self._slots[pos]]
        return 2, self.bv._gaps.to_dense(
            np.asarray([self._gslots[pos]]))[0]


def _target_view(bv: BitVector, nbs: np.ndarray):
    """Target view RESTRICTED to blocks in ``nbs`` — the native engine's
    per-chunk snapshot.  GAP blocks stay RUN-CODED (cls 3): the native
    engine folds COUNT_* in the run domain and expands at most ONE block
    of scratch for dense combines, so the target side never leaves
    O(1-block) host scratch beyond the runs themselves.  Returns
    (nb_r, cls_r, rows, gap_ends, gap_offs, gap_first)."""
    st = bv._struct
    sel = np.isin(st.nb, nbs)
    nb_r = st.nb[sel]
    src_cls = st.cls[sel]
    gapm = src_cls == C.CLS_GAP
    if gapm.any():
        bitm = src_cls == C.CLS_BIT
        nrows = int(bitm.sum())
        rows = np.zeros((nrows, C.SET_BLOCK_SIZE), np.uint32)
        if nrows:
            rows[:] = bv._pool_host()[st.slots()[sel][bitm]]
        gsl = st.gslots()[sel][gapm]
        store = bv._gaps
        if gsl.size == store.n_blocks:
            # whole store mentioned (gslots are dense 0..n-1 in nb order):
            # hand the cached arrays over with no per-call copies
            ge, go, gf = store.ends_i32(), store.offs, store.first
        else:
            gs = store.subset(gsl)
            ge, go, gf = gs.ends.astype(np.int32), gs.offs, gs.first
        return nb_r, src_cls.astype(np.uint8), rows, ge, go, gf
    # no GAP blocks mentioned: dense rows only, empty run arrays
    nrows = int((src_cls == C.CLS_BIT).sum())
    rows = np.zeros((nrows, C.SET_BLOCK_SIZE), np.uint32)
    if nrows:
        rows[:] = bv._pool_host()[st.slots()[sel][src_cls == C.CLS_BIT]]
    return (nb_r, src_cls.astype(np.uint8), rows, np.zeros(0, np.int32),
            np.zeros(1, np.int64), np.zeros(0, np.uint8))


class _ResultAccum:
    """Accumulates per-record results in arrival (ascending nb) order.
    With compress=True each dense batch is reclassified ZERO/FULL/GAP/BIT
    the way optimize() would (core/gaps.py classify_blocks), so a succinct
    target's result comes out succinct and the dense high-water stays
    O(batch)."""

    def __init__(self, compress: bool, glevel):
        self.compress = compress
        self.glevel = glevel
        self._nbs, self._cls, self._rows = [], [], []
        self._gap_parts = []

    def add_batch(self, nbs, cls, rows):
        """One window of results: rows are the CLS_BIT entries in order."""
        nbs = np.asarray(nbs, _I64)
        cls = np.asarray(cls, np.uint8)
        if nbs.size == 0:
            return
        if not (self.compress and rows.shape[0]):
            self._nbs.append(nbs)
            self._cls.append(cls)
            if rows.shape[0]:
                self._rows.append(rows)
            return
        store = GapStore.from_dense(rows)
        bc = store.popcounts()
        gap_mask, _, _ = gaps_mod.classify_blocks(
            bc, store.n_runs(), self.glevel)
        zero = bc == 0
        full = bc == C.BITS_PER_BLOCK
        dense = ~gap_mask & ~zero & ~full
        new_cls = cls.copy()
        bit_pos = cls == C.CLS_BIT             # positions backed by rows
        sub = np.zeros(rows.shape[0], np.uint8)
        sub[zero] = C.CLS_ZERO
        sub[full] = C.CLS_FULL
        sub[gap_mask] = C.CLS_GAP
        sub[dense] = C.CLS_BIT
        new_cls[bit_pos] = sub
        keep = new_cls != C.CLS_ZERO
        self._nbs.append(nbs[keep])
        self._cls.append(new_cls[keep])
        if dense.any():
            self._rows.append(rows[dense])
        if gap_mask.any():
            self._gap_parts.append(store.subset(np.flatnonzero(gap_mask)))

    def finish(self):
        """(nbs, cls, pool_rows, gapstore_or_None) in ascending nb order."""
        nbs = (np.concatenate(self._nbs) if self._nbs
               else np.zeros(0, _I64))
        cls = (np.concatenate(self._cls) if self._cls
               else np.zeros(0, np.uint8))
        rows = (np.concatenate(self._rows) if self._rows
                else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
        store = GapStore.concat_many(self._gap_parts)
        return nbs, cls, rows, store


class _StreamCombiner:
    """THE record-at-a-time skip/emit/combine engine (Python twin of
    codecs.cpp bm_bmt1_stream_op's table) — shared by the BMT1 streamer,
    the public pull-iterator combine (stream_iter.IteratorDeserializer)
    and the reference-format sink, so the op semantics live in exactly one
    place per language.  feed() one record at a time; the payload decode
    is deferred to the ``get_words`` thunk so skip paths never decode."""

    def __init__(self, opc, reader: _TargetReader, count_mode,
                 accum: "_ResultAccum | None"):
        self.opc = opc
        self.reader = reader
        self.count_mode = count_mode
        self.accum = accum
        self.count = 0
        self.seen = []
        self._ones = full_block_np()
        self._zeros = np.zeros(C.SET_BLOCK_SIZE, np.uint32)
        self._b_nbs, self._b_cls, self._b_rows = [], [], []

    def _flush(self):
        if self._b_nbs:
            rows = (np.stack(self._b_rows) if self._b_rows
                    else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
            self.accum.add_batch(np.asarray(self._b_nbs, _I64),
                                 np.asarray(self._b_cls, np.uint8), rows)
            self._b_nbs.clear(); self._b_cls.clear(); self._b_rows.clear()

    def feed(self, nb, rec_full: bool, get_words):
        """One blob record: block id, FULL flag, thunk -> uint32[2048]."""
        opc = self.opc
        self.seen.append(nb)
        tstate, tw = self.reader.lookup(nb)
        # payload-skip fast paths (same table as the native engine)
        skip = emit_full = False
        if opc == native.OP_AND:
            skip = tstate == 0
            emit_full = tstate == 1 and rec_full
        elif opc == native.OP_OR:
            emit_full = tstate == 1 or rec_full
        elif opc == native.OP_XOR:
            emit_full = rec_full and tstate == 0
            skip = rec_full and tstate == 1
        elif opc == native.OP_SUB_AB:
            skip = tstate == 0 or rec_full
        else:                                   # OP_SUB_BA
            skip = tstate == 1
            emit_full = rec_full and tstate == 0
        if skip:
            return
        if emit_full:
            if self.count_mode:
                self.count += C.BITS_PER_BLOCK
            else:
                self._b_nbs.append(nb)
                self._b_cls.append(C.CLS_FULL)
            return
        b = self._ones if rec_full else get_words()
        t = tw if tstate == 2 else (self._ones if tstate == 1
                                    else self._zeros)
        if opc == native.OP_AND:
            r = t & b
        elif opc == native.OP_OR:
            r = t | b
        elif opc == native.OP_XOR:
            r = t ^ b
        elif opc == native.OP_SUB_AB:
            r = t & ~b
        else:
            r = b & ~t
        if self.count_mode:
            self.count += int(np.bitwise_count(r).sum())
        else:
            self._b_nbs.append(nb)
            self._b_cls.append(C.CLS_BIT)
            self._b_rows.append(r)
            if len(self._b_rows) >= _CHUNK:
                self._flush()

    def finish(self):
        """Count (count_mode) or None; set-mode results land in accum."""
        if self.count_mode:
            return self.count
        self._flush()
        return None

    @property
    def mentioned(self) -> np.ndarray:
        return np.asarray(self.seen, _I64)


def _finalize_set(bv: BitVector, accum: "_ResultAccum", opc, mentioned,
                  size: int) -> BitVector:
    """Install streamed set-op results into bv: the result rows go to
    bv's device in one upload, target blocks the BLOB never mentioned merge
    in on the device, then the structure swaps."""
    out_nbs, out_cls, out_rows, out_gaps = accum.finish()
    rows = to_device_words(out_rows, bv.device)
    if opc in _PASS_THROUGH and bv._struct.nb.size:
        out_nbs, out_cls, rows, out_gaps = _merge_passthrough_bv(
            out_nbs, out_cls, rows, out_gaps, bv, mentioned)
    bv._struct = Structure(np.asarray(out_nbs, _I64).copy(),
                           np.asarray(out_cls, np.uint8).copy())
    bv._pool = rows
    bv._gaps = out_gaps
    bv._size = max(bv._size, size)
    bv._dirty()
    return bv


def _stream_op_py(data, op, reader: _TargetReader, count_mode,
                  accum: "_ResultAccum | None"):
    """Pure-Python record-at-a-time engine with bm_bmt1_stream_op semantics
    (one decoded blob block live at a time, target read lazily one block at
    a time).  Returns the count in count_mode; otherwise results land in
    ``accum``."""
    eng = _StreamCombiner(op, reader, count_mode, accum)
    for nb, code, payload in _stream_blocks(data, want=None):
        if nb == "header":
            continue
        eng.feed(nb, code == CODE_FULL,
                 lambda code=code, payload=payload:
                 _decode_payload(code, payload))
    return eng.finish()


_SET_TO_OPC = {
    C.SET_AND: native.OP_AND, C.SET_OR: native.OP_OR,
    C.SET_XOR: native.OP_XOR, C.SET_SUB: native.OP_SUB_AB,
}
_COUNT_TO_OPC = {
    C.SET_COUNT_AND: native.OP_AND, C.SET_COUNT_OR: native.OP_OR,
    C.SET_COUNT_XOR: native.OP_XOR, C.SET_COUNT_SUB_AB: native.OP_SUB_AB,
    C.SET_COUNT_SUB_BA: native.OP_SUB_BA,
}
# ops where target blocks untouched by the BLOB survive / contribute
_PASS_THROUGH = {native.OP_OR, native.OP_XOR, native.OP_SUB_AB}


def _merge_passthrough_bv(out_nbs, out_cls, out_rows, out_gaps,
                          bv: BitVector, mentioned):
    """Merge per-record results (``out_rows``: rows on bv's device) with
    target blocks the BLOB never mentioned (which pass through unchanged
    for OR/XOR/SUB_AB).  Pass-through blocks keep their stored
    representation — GAP stays GAP, no expansion — and their dense rows
    never leave the device: one gather puts every row in nb order."""
    st = bv._struct
    keep = ~np.isin(st.nb, mentioned)
    if not keep.any():
        return out_nbs, out_cls, out_rows, out_gaps
    pt_nbs = st.nb[keep]
    pt_cls = st.cls[keep].copy()
    bit_pt = keep & (st.cls == C.CLS_BIT)
    gap_pt = keep & (st.cls == C.CLS_GAP)
    pt_gaps = (bv._gaps.subset(st.gslots()[gap_pt]) if gap_pt.any()
               else None)
    # record nbs and pass-through nbs are disjoint; stable sort interleaves
    all_nbs = np.concatenate([out_nbs, pt_nbs])
    all_cls = np.concatenate([out_cls, pt_cls])
    order = np.argsort(all_nbs, kind="stable")
    # pool rows into final nb order, gathered from the record rows followed
    # by the whole target pool (a pass-through row sits at its own slot)
    row_src = np.full(all_nbs.size, -1, _I64)
    n_rec_rows = int((out_cls == C.CLS_BIT).sum())
    row_src[: out_nbs.size][out_cls == C.CLS_BIT] = np.arange(n_rec_rows)
    row_src[out_nbs.size:][pt_cls == C.CLS_BIT] = \
        n_rec_rows + st.slots()[bit_pt]
    all_rows = torch.cat([out_rows, bv._pool])
    sel = row_src[order]
    rows_f = all_rows[_index(sel[sel >= 0], all_rows.device)]
    # GAP entries (record store first, then pass-through store) likewise
    gap_src = np.full(all_nbs.size, -1, _I64)
    n_rec_gaps = out_gaps.n_blocks if out_gaps is not None else 0
    gap_src[: out_nbs.size][out_cls == C.CLS_GAP] = np.arange(n_rec_gaps)
    gap_src[out_nbs.size:][pt_cls == C.CLS_GAP] = \
        n_rec_gaps + np.arange(int((pt_cls == C.CLS_GAP).sum()))
    gsel = gap_src[order]
    gsel = gsel[gsel >= 0]
    gaps_f = (GapStore.concat(out_gaps, pt_gaps).subset(gsel)
              if gsel.size else None)
    return all_nbs[order], all_cls[order], rows_f, gaps_f


def _passthrough_count_bv(bv: BitVector, mentioned) -> int:
    """Popcount contribution of target blocks the BLOB never mentioned —
    straight from the stored representation: dense rows gathered on the
    device and counted by one K3 launch, GAP answers from the run domain,
    no expansion."""
    st = bv._struct
    keep = ~np.isin(st.nb, mentioned)
    if not keep.any():
        return 0
    total = int((st.cls[keep] == C.CLS_FULL).sum()) * C.BITS_PER_BLOCK
    bitm = keep & (st.cls == C.CLS_BIT)
    if bitm.any():
        rows = bv._pool[_index(st.slots()[bitm], bv.device)]
        total += int(ck.block_counts_total(rows)[0])
    gapm = keep & (st.cls == C.CLS_GAP)
    if gapm.any():
        total += int(bv._gaps.popcounts()[st.gslots()[gapm]].sum())
    return total


class OperationDeserializer:
    """bm::operation_deserializer equivalent (streamed, no materialize).

    ``ref_vectors``: (row_id, BitVector) pairs — the bv_ref_vector
    collection needed to stream reference-format BLOBs compressed with
    the XOR filter (reference deserialize_xor, src/bmserial.h:1093;
    set_ref_vectors API)."""

    def __init__(self, ref_vectors=None):
        self.ref_vectors = list(ref_vectors or [])

    def set_ref_vectors(self, ref_vectors):
        """Reference set_ref_vectors (src/bmserial.h:1060)."""
        self.ref_vectors = list(ref_vectors or [])
        return self

    def set_compression_level(self, level: int):
        """Accepted for parity (reference set_compression_level on the
        internal serializer; decode here is self-describing per record)."""
        self._level = int(level)
        return self

    def deserialize_range(self, bv: BitVector, data: bytes,
                          idx_from: int, idx_to: int):
        """Range extraction: bv &= decode(blob) clipped to
        [idx_from, idx_to]; an empty target adopts the window directly
        (reference operation_deserializer::deserialize_range,
        src/bmserial.h:8142 — the SV gather/range deserialization
        workhorse).  Works for both formats, XOR-ref blobs included.  The
        window decodes onto bv's device; the AND is one K1 launch."""
        d = Deserializer(bv.device)
        if self.ref_vectors:
            d.set_ref_vectors(self.ref_vectors)
        win = d.deserialize_range(data, int(idx_from), int(idx_to))
        if bv.any():
            bv.bit_and(win)
        else:
            bv.swap(win)
        return bv

    def deserialize(self, bv: BitVector, data: bytes, op: int):
        """Apply ``op`` (constants.SET_*) between bv (in place) and the BLOB;
        COUNT_* ops return the count without modifying bv.  Accepts both the
        native BMT1 format and reference-format BLOBs (sniffed by magic)."""
        if bv._struct.has_runs and op not in (
                C.SET_ASSIGN, C.SET_COUNT, C.SET_COUNT_B, C.SET_COUNT_A):
            # the stream engine's target reader / pass-through walker use
            # the flat per-block view (bounded materialization + cache
            # invalidation).  Ops that never read the target's flat view
            # (assign discards it; COUNT/COUNT_B stream the blob against
            # an empty target; COUNT_A is the run-aware bv.count()) keep
            # wide run-coded targets intact instead of raising a spurious
            # MemoryError.
            bv._flush()
            bv._materialize_runs()
        if bytes(data[:4]) != MAGIC:
            # reference-format BLOB: the block-sequential decoder streams
            # finalized blocks into a combining sink (serial_stream_iterator
            # mode) — no materialization for set/count ops
            if op == C.SET_ASSIGN:
                bv.swap(ref_deserialize(data, ref_vectors=self.ref_vectors,
                                        device=bv.device))
                return bv
            try:
                if op in _SET_TO_OPC:
                    return self._ref_stream_apply(bv, data,
                                                  _SET_TO_OPC[op])
                if op in _COUNT_TO_OPC or op in (C.SET_COUNT_B, C.SET_COUNT,
                                                 C.SET_COUNT_A):
                    return self._ref_count_op(bv, data, op)
            except native.RunCodedBlob:
                # wide FULL one-run records cannot stream per-block
                # through the sink; decode (runs -> O(1) metadata) and
                # apply through the run-aware set algebra — the same
                # fallback BMT1 FULL_RUN records take
                other = ref_deserialize(data, ref_vectors=self.ref_vectors,
                                        device=bv.device)
                return self._apply_decoded(bv, other, op)
            raise ValueError(f"unsupported op {op}")
        if op == C.SET_ASSIGN:
            bv.swap(Deserializer(bv.device).deserialize(data))
            return bv
        try:
            if op in _SET_TO_OPC:
                return self._stream_apply(bv, data, _SET_TO_OPC[op])
            return self._count_op(bv, data, op)
        except native.RunCodedBlob:
            # FULL_RUN span records: decode (runs -> O(1) interval
            # metadata) and apply through the run-aware set algebra on the
            # card (K1 for the set ops, K2 for the counts)
            return self._apply_decoded(
                bv, Deserializer(bv.device).deserialize(data), op)

    # ------------------------------------------------------------------
    # BMT1 chunked streaming (native engine over record windows)
    # ------------------------------------------------------------------
    @staticmethod
    def _stream_chunks(bv, data, opc, count_mode, rec_nbs, rec_offs):
        """Drive the native engine over the BLOB's records with the target
        view restricted to the mentioned blocks.  GAP-resident target
        blocks travel RUN-CODED (cls 3): COUNT_* fold in the run domain
        and dense combines expand at most one block of C scratch, so the
        GAP side of the target never expands on the host at all.  One
        native call covers the stream unless the target's DENSE rows are
        themselves unbounded (set-op outputs / dense row gathers), in
        which case _CHUNK-record windows bound host high-water.  Returns
        the total count (count_mode) or a list of (nbs, cls, rows)
        batches; None when the native engine rejects the stream."""
        data = native.padded_blob(data)   # pad ONCE; windows reuse it
        small = bv._gaps is None or bv._gaps.n_blocks <= 1024
        if not small and count_mode:
            # run-coded targets make the GAP side free; one call is fine
            # while the mentioned DENSE rows stay bounded
            small = int((bv._struct.cls == C.CLS_BIT).sum()) <= 4096
        if small:
            nb_r, cls_r, rows, ge, go, gf = _target_view(bv, rec_nbs)
            res = native.bmt1_stream_op(data, _REC_OFFSET, opc, count_mode,
                                        nb_r, cls_r, rows, t_gap_ends=ge,
                                        t_gap_offs=go, t_gap_first=gf)
            return res if res is None or count_mode else [res]
        total = 0
        batches = []
        for lo in range(0, rec_nbs.size, _CHUNK):
            hi = min(lo + _CHUNK, rec_nbs.size)
            nb_r, cls_r, rows, ge, go, gf = _target_view(
                bv, rec_nbs[lo:hi])
            res = native.bmt1_stream_op(
                data, int(rec_offs[lo]), opc, count_mode,
                nb_r, cls_r, rows, n_rec=hi - lo,
                nb_prev=int(rec_nbs[lo - 1]) if lo else -1,
                t_gap_ends=ge, t_gap_offs=go, t_gap_first=gf)
            if res is None:
                return None
            if count_mode:
                total += int(res)
            else:
                batches.append(res)
        return total if count_mode else batches

    def _stream_apply(self, bv, data, opc):
        bv._check_writable()
        bv._flush()
        rec_nbs, rec_offs = _blob_record_index(data)
        compress = bv._gaps is not None
        accum = _ResultAccum(compress, bv._glevel)
        batches = self._stream_chunks(bv, data, opc, False,
                                      rec_nbs, rec_offs)
        if batches is None:
            _stream_op_py(data, opc, _TargetReader(bv), False, accum)
        else:
            for b in batches:
                accum.add_batch(*b)
        return _finalize_set(bv, accum, opc, rec_nbs, _blob_size(data))

    def _count_op(self, bv: BitVector, data: bytes, op: int) -> int:
        bv._flush()
        if op in (C.SET_COUNT_B, C.SET_COUNT):
            # count of the BLOB alone: stream against an empty target
            empty = np.zeros(0, _I64)
            res = native.bmt1_stream_op(
                data, _REC_OFFSET, native.OP_OR, True, empty,
                np.zeros(0, np.uint8),
                np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
            if res is None:
                res = _stream_op_py(
                    data, native.OP_OR,
                    _TargetReader(BitVector(1, device=bv.device)), True,
                    None)
            return int(res)
        if op == C.SET_COUNT_A:
            return bv.count()
        if op not in _COUNT_TO_OPC:
            raise ValueError(f"unsupported op {op}")
        opc = _COUNT_TO_OPC[op]
        rec_nbs, rec_offs = _blob_record_index(data)
        total = self._stream_chunks(bv, data, opc, True, rec_nbs, rec_offs)
        if total is None:
            total = _stream_op_py(data, opc, _TargetReader(bv), True, None)
        total = int(total)
        if opc in _PASS_THROUGH and bv._struct.nb.size:
            # target blocks the BLOB does not mention contribute themselves
            total += _passthrough_count_bv(bv, rec_nbs)
        return total

    # ------------------------------------------------------------------
    # reference-format streaming (RefDeserializer sink mode)
    # ------------------------------------------------------------------
    def _ref_stream(self, bv, data, opc, count_mode, compress=False):
        """Run the ref-format decoder in sink mode, combining per block
        through the shared _StreamCombiner engine.  Target blocks are read
        lazily one at a time (no snapshot); sink words=None means FULL."""
        accum = None if count_mode else _ResultAccum(compress, bv._glevel)
        eng = _StreamCombiner(opc, _TargetReader(bv), count_mode, accum)

        def sink(nb, words):
            eng.feed(nb, words is None, lambda: words)

        size = RefDeserializer(self.ref_vectors).deserialize(
            data, sink=sink)
        cnt = eng.finish()
        return eng.mentioned, size, (cnt if count_mode else accum)

    def _ref_stream_apply(self, bv, data, opc):
        bv._check_writable()
        bv._flush()
        compress = bv._gaps is not None
        seen, size, accum = self._ref_stream(bv, data, opc, False, compress)
        return _finalize_set(bv, accum, opc, seen, size)

    def _ref_count_op(self, bv, data, op):
        bv._flush()
        if op in (C.SET_COUNT_B, C.SET_COUNT):
            empty = BitVector(1, device=bv.device)
            _, _, cnt = self._ref_stream(empty, data, native.OP_OR, True)
            return cnt
        if op == C.SET_COUNT_A:
            return bv.count()
        opc = _COUNT_TO_OPC[op]
        seen, _, cnt = self._ref_stream(bv, data, opc, True)
        total = int(cnt)
        if opc in _PASS_THROUGH and bv._struct.nb.size:
            total += _passthrough_count_bv(bv, seen)
        return total

    def _apply_decoded(self, bv: BitVector, other: BitVector, op: int):
        if op == C.SET_AND:
            return bv.bit_and(other)
        if op == C.SET_OR:
            return bv.bit_or(other)
        if op == C.SET_XOR:
            return bv.bit_xor(other)
        if op == C.SET_SUB:
            return bv.bit_sub(other)
        if op == C.SET_ASSIGN:
            bv.swap(other)
            return bv
        if op in (C.SET_COUNT_B, C.SET_COUNT):
            return other.count()
        if op == C.SET_COUNT_A:
            return bv.count()
        metric = {
            C.SET_COUNT_AND: setops.COUNT_AND,
            C.SET_COUNT_OR: setops.COUNT_OR,
            C.SET_COUNT_XOR: setops.COUNT_XOR,
            C.SET_COUNT_SUB_AB: setops.COUNT_SUB_AB,
            C.SET_COUNT_SUB_BA: setops.COUNT_SUB_BA,
        }.get(op)
        if metric is None:
            raise ValueError(f"unsupported op {op}")
        return setops.distance_operation(bv, other, [metric])[metric]


def _materialize_subset(data, want, size, device=None):
    nbs, clss, rows = [], [], []
    for nb, code, payload in _stream_blocks(data, want=want):
        if nb == "header" or payload is None and code != CODE_FULL:
            continue
        if code == CODE_FULL:
            if nb in want:
                nbs.append(nb); clss.append(C.CLS_FULL)
            continue
        nbs.append(nb); clss.append(C.CLS_BIT)
        rows.append(_decode_payload(code, payload))
    pool = (np.stack(rows) if rows
            else np.zeros((0, C.SET_BLOCK_SIZE), np.uint32))
    return BitVector._from_parts(
        Structure(np.asarray(nbs, np.int64), np.asarray(clss, np.uint8)),
        pool, size, device=device)
