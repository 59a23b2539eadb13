"""Free functions over bit-vectors."""
from .setops import (COUNT_A, COUNT_AND, COUNT_B, COUNT_OR, COUNT_SUB_AB,
                     COUNT_SUB_BA, COUNT_XOR, any_and, any_or, any_sub,
                     any_xor, build_jaccard_similarity_batch, count_and,
                     count_or, count_sub, count_xor, distance_operation,
                     distance_operation_any, similarity_batch)
from .traversal import (for_each_bit, for_each_bit_range,
                        visit_each_bit_range, rank_range_split,
                        visit_each_bit)
from .rank_compress import compress, compress_by_source, decompress
from .intervals import (count_intervals, find_interval_end,
                        find_interval_start, interval_enumerator, intervals,
                        is_interval)
from . import kleene
from .sampling import random_subset

__all__ = [
    "COUNT_A", "COUNT_AND", "COUNT_B", "COUNT_OR", "COUNT_SUB_AB",
    "COUNT_SUB_BA", "COUNT_XOR", "any_and", "any_or", "any_sub", "any_xor",
    "count_and", "count_or", "count_sub", "count_xor", "distance_operation",
    "distance_operation_any", "build_jaccard_similarity_batch",
    "similarity_batch", "for_each_bit", "for_each_bit_range",
    "rank_range_split", "visit_each_bit", "visit_each_bit_range",
    "compress", "compress_by_source", "decompress", "count_intervals",
    "find_interval_end", "find_interval_start", "interval_enumerator",
    "intervals", "is_interval", "kleene", "random_subset",
]
