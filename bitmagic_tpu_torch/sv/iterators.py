"""Reference-shaped iterators for the succinct-vector family (port of
``bitmagic_tpu/sv/iterators.py``; host code).

The reference exposes, on every SV container, a ``const_iterator`` with
``value()/is_null()/valid()/pos()/go_to()/advance()/invalidate()``
(src/bmsparsevec.h:178, src/bmstrsparsevec.h:944, src/bmsparsevec_compr.h:700,
src/bmsparsevec_float.h:161) and a buffered ``back_insert_iterator`` with
``add()/add_null()/flush()`` (src/bmsparsevec.h:278, src/bmstrsparsevec.h:959,
src/bmsparsevec_compr.h:717, src/bmsparsevec_float.h:225).

Iteration gathers a whole window of elements with one multi-plane gather
(the container's ``gather``) and serves values from the host window; the
back inserter buffers values on the host and lands them as one bulk import
per flush.  Same API as the reference, batch execution.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64
_WINDOW = 8192          # elements decoded per gather


class ConstIterator:
    """Window-buffered forward iterator (reference const_iterator shape)."""

    def __init__(self, vect, pos: int = 0):
        self._v = vect
        self._win_lo = -1
        self._win_vals = None
        self._win_nulls = None
        self._pos = int(pos)
        self._substr = None

    # -- reference API ---------------------------------------------------
    def valid(self) -> bool:
        return 0 <= self._pos < len(self._v)

    def pos(self) -> int:
        return self._pos

    def invalidate(self):
        self._pos = -1

    def go_to(self, pos: int):
        self._pos = int(pos)
        return self

    def advance(self) -> bool:
        self._pos += 1
        return self.valid()

    def value(self):
        if not self.valid():
            raise IndexError(self._pos)
        self._ensure_window()
        v = self._win_vals[self._pos - self._win_lo]
        if self._substr is not None and isinstance(v, str):
            frm, ln = self._substr
            v = v[frm:frm + ln] if ln else v[frm:]
        return v

    def set_substr(self, frm: int, length: int = 0) -> "ConstIterator":
        """Restrict value() to a substring window for string iterators
        (reference const_iterator::set_substr, src/bmstrsparsevec.h:257;
        length 0 = to the end of the string)."""
        self._substr = (int(frm), int(length))
        return self

    def get_string_view(self):
        """Current (sub)string (reference get_string_view,
        src/bmstrsparsevec.h:290)."""
        return self.value()

    def is_null(self) -> bool:
        if not self.valid():
            return True
        self._ensure_window()
        if self._win_nulls is None:
            return False
        return bool(self._win_nulls[self._pos - self._win_lo])

    # -- comparisons: two invalid iterators over the same vector compare
    # equal, so `while it != sv.end()` terminates (the bvector enumerator
    # semantics) -----------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, ConstIterator):
            return NotImplemented
        if self._v is not other._v:
            return False
        a = self._pos if self.valid() else None
        b = other._pos if other.valid() else None
        return a == b

    def __ne__(self, other):
        r = self.__eq__(other)
        return r if r is NotImplemented else not r

    def __hash__(self):
        return hash((id(self._v), self._pos if self.valid() else None))

    # -- python protocol ---------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if not self.valid():
            raise StopIteration
        v = None if self.is_null() else self.value()
        self._pos += 1
        return v

    # ----------------------------------------------------------------------
    def _ensure_window(self):
        if self._win_lo >= 0 and \
                self._win_lo <= self._pos < self._win_lo + _WINDOW:
            return
        lo = (self._pos // _WINDOW) * _WINDOW
        n = min(_WINDOW, len(self._v) - lo)
        ids = np.arange(lo, lo + n, dtype=_I64)
        vals = self._v.gather(ids)
        nulls = None
        get_null = getattr(self._v, "get_null_bvector", None)
        nbv = get_null() if get_null is not None else None
        if nbv is not None:
            nulls = ~nbv.get_bits(ids)
        self._win_lo, self._win_vals, self._win_nulls = lo, vals, nulls


class BackInsertIterator:
    """Buffered appender; flush() lands one bulk import (reference
    back_insert_iterator, src/bmsparsevec.h:278)."""

    def __init__(self, vect, buffer_size: int = 65536):
        self._v = vect
        self._buf: list = []
        self._cap = int(buffer_size)

    def add(self, v):
        self._buf.append(v)
        if len(self._buf) >= self._cap:
            self.flush()
        return self

    def add_null(self, count: int = 1):
        self._buf.extend([None] * int(count))
        if len(self._buf) >= self._cap:
            self.flush()
        return self

    def __call__(self, v):          # inserter(v) sugar, like operator=
        return self.add(v)

    def flush(self):
        if not self._buf:
            return self
        buf, self._buf = self._buf, []
        self._v._append_bulk(buf)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        return False
