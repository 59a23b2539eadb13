"""bitmagic_tpu_torch — the PyTorch/CUDA port of bitmagic_tpu.

Block-structured compressed bit-vectors with set algebra, counts,
rank/select, iteration and the free-function algorithms, their BLOB
serialization (the BMT1 format and the reference's own, set ops straight
against a BLOB), the multi-vector aggregator, bit-sliced sparse vectors (integer, float,
string, rank-select compressed) with their scanner and their BLOBs, and
containers sharded over a mesh of devices (``parallel``), with the
libbm-shaped C-API facade (``capi``) and the debug, timer and oracle helpers
(``utils``), on NVIDIA Hopper cards (H100).  The hot block ops are
hand-written CUDA kernels for ``sm_90a`` (``ops/csrc``), built from source
with ``nvcc`` at first use; every other device step is plain PyTorch, and
the host-side block codecs are the port's native C++ library
(``serial/native``, built with ``g++`` at first use).
Entry points run on the card unless ``device="cpu"`` is given (or
``config.device`` is set to ``"cpu"``), where each kernel is replaced by
its plain PyTorch version.  The package imports neither ``jax`` nor
``bitmagic_tpu``; it mirrors that package's layout (``ops/``, ``core/``,
``algo/``, ``agg/``, ``sv/``, ``serial/``) and is held bit for bit against
it by the ``test_torch_*`` tests.

Bit ids and block ids are int64 on the host (numpy metadata); device
tensors are int32 only, holding the reference's uint32 words bit for bit.
"""

from . import constants
from . import algo
from .algo import rank_compress
from .algo.intervals import (IntervalEnumerator, count_intervals,
                             find_interval_end, find_interval_start,
                             interval_enumerator, is_interval)
from .algo.kleene import (and_kleene, get_value_kleene, init_kleene,
                          invert_kleene, or_kleene, set_value_kleene)
from .algo.sampling import RandomSubset, random_subset
from .algo.setops import (
    any_and, any_or, any_sub, any_xor, bit_import, bit_import_u32,
    build_jaccard_similarity_batch, build_similarity_batch, combine_and,
    combine_and_sorted, combine_or, combine_sub, combine_xor, count_and,
    count_or, count_sub, count_xor, distance_and_operation,
    distance_operation, distance_operation_any, export_array,
    similarity_batch)
from .algo.traversal import (for_each_bit, for_each_bit_range,
                             rank_range_split, visit_each_bit,
                             visit_each_bit_range)
from . import agg
from .agg.aggregator import (AggOptions, Aggregator, aggregator,
                             aggregator_pipeline_execute)
from .config import config, simd_version
from .core.bitvector import BitVector, ReadOnlyError
from . import serial
from .serial.opdeser import OperationDeserializer
from .serial.serializer import (Deserializer, Serializer, deserialize,
                                serialize)
from .serial.stream_iter import IteratorDeserializer, SerialStreamIterator
from .serial.sv_serial import (SparseVectorDeserializer,
                               SparseVectorSerializer,
                               sparse_vector_deserialize,
                               sparse_vector_serialize)
from . import sv
from .sv import (BitMatrix, FloatSparseVector, RSCSparseVector,
                 SparseVector, SparseVectorScanner, StrSparseVector, scanner)
from .sv.algo import Set2SetTransform, find_first_mismatch, set2set_transform
from . import parallel
from . import utils

__version__ = "0.1.0"

__all__ = [
    "BitVector", "ReadOnlyError", "config", "constants", "simd_version",
    "serialize", "deserialize",
    "Serializer", "Deserializer", "OperationDeserializer",
    "SerialStreamIterator", "IteratorDeserializer",
    "serial", "parallel",
    "SparseVectorSerializer", "SparseVectorDeserializer",
    "sparse_vector_serialize", "sparse_vector_deserialize",
    "Aggregator", "aggregator", "AggOptions", "aggregator_pipeline_execute",
    "SparseVector", "RSCSparseVector", "StrSparseVector",
    "FloatSparseVector", "BitMatrix", "scanner", "SparseVectorScanner",
    "algo", "agg", "sv", "utils",
    "count_and", "count_or", "count_xor", "count_sub",
    "any_and", "any_or", "any_xor", "any_sub",
    "distance_operation", "distance_operation_any",
    "build_jaccard_similarity_batch", "distance_and_operation",
    "similarity_batch", "build_similarity_batch",
    "combine_or", "combine_and", "combine_and_sorted", "combine_xor",
    "combine_sub", "export_array", "bit_import", "bit_import_u32",
    "for_each_bit", "for_each_bit_range", "visit_each_bit",
    "visit_each_bit_range", "rank_range_split",
    "count_intervals", "interval_enumerator", "IntervalEnumerator",
    "RandomSubset", "is_interval", "find_interval_start",
    "find_interval_end",
    "init_kleene", "get_value_kleene", "set_value_kleene", "invert_kleene",
    "or_kleene", "and_kleene",
    "random_subset", "rank_compress",
    "find_first_mismatch", "set2set_transform", "Set2SetTransform",
    "__version__",
]
