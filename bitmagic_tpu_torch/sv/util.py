"""Succinct-vector utilities: address resolvers and keyed BLOB collections
(port of ``bitmagic_tpu/sv/util.py``).

Equivalents of `src/bmsparsevec_util.h`: bvps_addr_resolver (:45, bit-vector +
prefix-sum address resolution), sv_addr_resolver (:169), compressed_collection
(:226) and compressed_buffer_collection (:312): sparse id -> dense slot maps
and NoSQL-ish keyed collections built on them.  Their bit-vectors live on
the device given at construction (default: the card).
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..config import resolve_device
from ..core.bitvector import BitVector

_I64 = np.int64


class AddressResolver:
    """Sparse id -> dense address via rank (reference bvps_addr_resolver,
    src/bmsparsevec_util.h:45)."""

    def __init__(self, device=None):
        self.addr_bv = BitVector(C.ID_MAX48, device=device)
        self._rs = None

    def set(self, idx):
        self.addr_bv.set(int(idx), True)
        self._rs = None
        return self

    def set_many(self, ids):
        self.addr_bv.set_many(ids)
        self._rs = None
        return self

    def sync(self):
        self._rs = self.addr_bv.build_rs_index()
        return self

    def resolve(self, idx) -> int:
        """Dense 1-based address of id, or 0 if absent (reference resolve)."""
        if self._rs is None:
            self.sync()
        if not self.addr_bv.test(idx):
            return 0
        return int(self._rs.rank_batch(np.asarray([idx]))[0])

    def resolve_batch(self, ids) -> np.ndarray:
        if self._rs is None:
            self.sync()
        ids = np.asarray(ids, _I64)
        present = self.addr_bv.get_bits(ids)
        r = self._rs.rank_batch(ids)
        return np.where(present, r, 0)

    def count(self) -> int:
        return self.addr_bv.count()


class CompressedCollection:
    """Sparse-key -> value map with a succinct key set (reference
    compressed_collection<Value, BV>, src/bmsparsevec_util.h:226)."""

    def __init__(self, device=None):
        self.resolver = AddressResolver(device=device)
        self.values: list = []
        self._pending: list[tuple[int, object]] = []

    def push_back(self, key: int, value):
        """Keys must arrive in ascending order (reference contract)."""
        if self._pending and key <= self._pending[-1][0]:
            raise ValueError("keys must be pushed in ascending order")
        self._pending.append((int(key), value))
        return self

    def sync(self):
        if self._pending:
            ids = np.asarray([k for k, _ in self._pending], _I64)
            self.resolver.set_many(ids)
            self.values.extend(v for _, v in self._pending)
            self._pending.clear()
        self.resolver.sync()
        return self

    def get(self, key: int):
        self.sync()
        addr = self.resolver.resolve(key)
        if addr == 0:
            raise KeyError(key)
        return self.values[addr - 1]

    def __getitem__(self, key):
        return self.get(key)

    def __contains__(self, key):
        self.sync()
        return self.resolver.resolve(key) != 0

    def __len__(self):
        self.sync()
        return len(self.values)

    def keys(self) -> np.ndarray:
        self.sync()
        return self.resolver.addr_bv.indices()


class CompressedBufferCollection(CompressedCollection):
    """Keyed byte-buffer collection (reference compressed_buffer_collection,
    src/bmsparsevec_util.h:312)."""

    def push_back(self, key: int, buf):
        return super().push_back(key, bytes(buf))


class SVAddressResolver:
    """Sparse id -> assigned address via an explicit sparse-vector map
    (reference sv_addr_resolver, src/bmsparsevec_util.h:169).  Unlike
    AddressResolver (rank space), addresses are assigned at set() time in
    arrival order and stay stable under later insertions of smaller ids:
    no compaction, just the bit-sliced compression of the address map."""

    def __init__(self, device=None):
        from .sparse_vector import SparseVector
        device = resolve_device(device)
        self.set_flags = BitVector(C.ID_MAX48, device=device)
        self.addr_sv = SparseVector(dtype=np.uint64, device=device)
        self.max_addr = 0

    def set(self, idx) -> "SVAddressResolver":
        """Register id; assigns the next address if new (reference :578)."""
        idx = int(idx)
        if not self.set_flags.test(idx):
            self.set_flags.set(idx, True)
            self.max_addr += 1
            self.addr_sv.set(idx, self.max_addr)
        return self

    def resolve(self, idx) -> int:
        """Assigned address of id, or 0 if absent (reference :566)."""
        idx = int(idx)
        if not self.set_flags.test(idx):
            return 0
        return int(self.addr_sv.get(idx))

    get = resolve

    def resolve_batch(self, ids) -> np.ndarray:
        ids = np.asarray(ids, _I64)
        present = self.set_flags.get_bits(ids)
        vals = self.addr_sv.gather(ids).astype(_I64)
        return np.where(present, vals, 0)

    def count(self) -> int:
        return self.max_addr

    def get_bvector(self) -> BitVector:
        return self.set_flags

    def optimize(self) -> "SVAddressResolver":
        self.set_flags.optimize()
        self.addr_sv.optimize()
        return self
