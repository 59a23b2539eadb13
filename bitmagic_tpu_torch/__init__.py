"""bitmagic_tpu_torch — the PyTorch/CUDA port of bitmagic_tpu.

Block-structured compressed bit-vectors with set algebra, counts and
rank/select, the multi-vector aggregator, and bit-sliced integer sparse
vectors with their equality scanner, on one NVIDIA Hopper card (H100).  The hot block ops are
hand-written CUDA kernels for ``sm_90a`` (``ops/csrc``), built from source
with ``nvcc`` at first use; every other device step is plain PyTorch.
Entry points run on the card unless ``device="cpu"`` is given (or
``config.device`` is set to ``"cpu"``), where each kernel is replaced by
its plain PyTorch version.  The package imports neither ``jax`` nor
``bitmagic_tpu``; it mirrors that package's layout (``ops/``, ``core/``,
``algo/``, ``agg/``, ``sv/``) and is held bit for bit against it by the ``test_torch_*``
tests.

Bit ids and block ids are int64 on the host (numpy metadata); device
tensors are int32 only, holding the reference's uint32 words bit for bit.
"""

from . import constants
from .algo.setops import (any_and, any_or, any_sub, any_xor, count_and,
                          count_or, count_sub, count_xor, distance_operation)
from .agg.aggregator import AggOptions, Aggregator, aggregator
from .config import config, simd_version
from .core.bitvector import BitVector
from .sv.scanner import SparseVectorScanner, scanner
from .sv.sparse_vector import SparseVector

__version__ = "0.1.0"

__all__ = [
    "BitVector", "config", "constants", "simd_version",
    "Aggregator", "aggregator", "AggOptions",
    "SparseVector", "scanner", "SparseVectorScanner",
    "count_and", "count_or", "count_xor", "count_sub",
    "any_and", "any_or", "any_xor", "any_sub",
    "distance_operation",
    "__version__",
]
