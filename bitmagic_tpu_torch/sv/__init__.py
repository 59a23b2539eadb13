"""Bit-sliced sparse vectors and their scanner."""
from .sparse_vector import SparseVector
from .scanner import SparseVectorScanner, scanner

__all__ = ["SparseVector", "SparseVectorScanner", "scanner"]
