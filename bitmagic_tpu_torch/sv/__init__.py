"""Bit-sliced sparse vectors (integer, float, string, rank-select
compressed), their scanner, the bit-matrix and the sv utilities."""
from .bmatrix import BitMatrix
from .sparse_vector import SparseVector
from .rsc_vector import RSCSparseVector
from .str_vector import StrSparseVector
from .float_vector import FloatSparseVector
from .scanner import SparseVectorScanner, scanner
from .util import (AddressResolver, CompressedBufferCollection,
                   CompressedCollection, SVAddressResolver)
from . import algo

__all__ = [
    "BitMatrix", "SparseVector", "RSCSparseVector", "StrSparseVector",
    "FloatSparseVector", "SparseVectorScanner", "scanner",
    "AddressResolver", "SVAddressResolver", "CompressedCollection",
    "CompressedBufferCollection",
    "algo",
]
