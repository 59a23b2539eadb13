"""Public pull-parser over serialized BLOBs (port of
``bitmagic_tpu/serial/stream_iter.py``).

Equivalent of the reference's reusable streaming pair:
  * ``bm::serial_stream_iterator`` (src/bmserial.h:847) — step a BLOB
    record-by-record, inspect the block id / record kind, decode or skip
    payloads on demand, O(1 block) memory;
  * ``bm::iterator_deserializer`` (src/bmserial.h:788) — combine a live
    BitVector with such an iterator under any SET_*/COUNT_* op.

The iterator pulls the native BMT1 format (both classic and compact record
headers).  Reference-format BLOBs stream through the push-mode sink of
``RefDeserializer`` (serial/refcodec.py) — `OperationDeserializer` wires
that up transparently; this module is the PULL surface for the native
format.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from .encoding import ByteDecoder
from .serializer import (CODE_END, CODE_FULL, CODE_FULL_RUN,
                         _decode_payload, read_blob_header,
                         read_record_header, run_span)

_I64 = np.int64

# record states (serial_stream_iterator::state(), src/bmserial.h:858)
E_UNKNOWN = "unknown"
E_BLOCK = "block"          # payload-carrying block record
E_FULL = "full"            # symbolic all-ones block
E_END = "end"


class SerialStreamIterator:
    """Pull one BMT1 record at a time (bm::serial_stream_iterator analog).

    Usage::

        it = SerialStreamIterator(blob)
        while it.next():
            if it.state == E_FULL:
                ...                        # it.block_idx is all-ones
            else:
                words = it.get_block_words()   # decode on demand
                # or it.skip() to jump the payload without decoding
    """

    def __init__(self, data: bytes):
        self._data = data
        self._dec = ByteDecoder(data)
        self.size, self._compact = read_blob_header(self._dec)
        self._prev_nb = -1
        self.block_idx = -1
        self.code = None
        self.state = E_UNKNOWN
        self._plen = 0
        self._payload_at = -1
        self._consumed = True
        self._run_left = 0     # remaining blocks of a FULL_RUN record

    def next(self) -> bool:
        """Advance to the next record; False once the END record is hit.
        FULL_RUN records present block-by-block as E_FULL states (the
        pull-parser view of a span-coded record)."""
        if self.state == E_END:
            return False
        if self._run_left > 1:
            self._run_left -= 1
            self.block_idx += 1
            return True
        self._run_left = 0
        if not self._consumed:
            self._dec.pos = self._payload_at + self._plen
        nb, code, plen = read_record_header(self._dec, self._prev_nb,
                                            self._compact)
        if code == CODE_END:
            self.state = E_END
            self.block_idx = -1
            self.code = CODE_END
            self._consumed = True
            return False
        if code == CODE_FULL_RUN:
            span = run_span(self._dec.get_bytes(plen))
            self._prev_nb = nb + span - 1
            self._run_left = span
            self.block_idx = int(nb)
            self.code = CODE_FULL          # callers see plain FULL blocks
            self._plen = 0
            self._payload_at = self._dec.pos
            self._consumed = True
            self.state = E_FULL
            return True
        self._prev_nb = nb
        self.block_idx = int(nb)
        self.code = int(code)
        self._plen = int(plen)
        self._payload_at = self._dec.pos
        self._consumed = False
        self.state = E_FULL if code == CODE_FULL else E_BLOCK
        return True

    def get_block_words(self) -> np.ndarray:
        """Decode the current record's payload -> uint32[2048] (all-ones
        for FULL records).  Idempotent within one record."""
        if self.state == E_END or self.block_idx < 0:
            raise ValueError("no current record")
        if self.state == E_FULL:
            return np.full(C.SET_BLOCK_SIZE, 0xFFFFFFFF, np.uint32)
        payload = self._data[self._payload_at:self._payload_at + self._plen]
        return _decode_payload(self.code, payload)

    def skip(self):
        """Mark the current payload as consumed without decoding it."""
        self._dec.pos = self._payload_at + self._plen
        self._consumed = True

    def __iter__(self):
        """Iterate (block_idx, state, get_words_callable) tuples."""
        while self.next():
            yield self.block_idx, self.state, self.get_block_words


class IteratorDeserializer:
    """Combine a BitVector with a SerialStreamIterator under a SET_*/
    COUNT_* op (bm::iterator_deserializer, src/bmserial.h:788).  The
    target side is read lazily one block per record; results of set ops on
    a succinct target reclassify back to D-GAP (same engine contracts as
    OperationDeserializer)."""

    def deserialize(self, bv, it, op: int):
        from .opdeser import OperationDeserializer
        if isinstance(it, SerialStreamIterator):
            data = it._data
        else:
            data = it
        return OperationDeserializer().deserialize(bv, data, op)

    def deserialize_streamed(self, bv, it: SerialStreamIterator, op: int):
        """Pure pull-driven variant: consumes ``it`` record by record with
        O(1 block) live state — the exact iterator pairing of the
        reference API (useful when the caller interleaves its own record
        inspection with the combine).  The skip/emit/combine semantics are
        the shared opdeser._StreamCombiner engine; skipped records never
        decode their payload (next() jumps unconsumed payloads)."""
        from .opdeser import (_COUNT_TO_OPC, _PASS_THROUGH, _SET_TO_OPC,
                              _ResultAccum, _StreamCombiner, _TargetReader,
                              _finalize_set, _passthrough_count_bv)
        count_mode = op in _COUNT_TO_OPC
        if not count_mode and op not in _SET_TO_OPC:
            raise ValueError(f"unsupported op {op}")
        opc = (_COUNT_TO_OPC if count_mode else _SET_TO_OPC)[op]
        if not count_mode:
            bv._check_writable()
        bv._flush()
        bv._materialize_runs()        # flat per-block target view (bounded)
        accum = None if count_mode else _ResultAccum(
            bv._gaps is not None, bv._glevel)
        eng = _StreamCombiner(opc, _TargetReader(bv), count_mode, accum)
        while it.next():
            eng.feed(it.block_idx, it.state == E_FULL, it.get_block_words)
        total = eng.finish()
        if count_mode:
            if opc in _PASS_THROUGH and bv._struct.nb.size:
                total += _passthrough_count_bv(bv, eng.mentioned)
            return total
        return _finalize_set(bv, accum, opc, eng.mentioned, it.size)
