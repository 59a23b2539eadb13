"""Multi-vector aggregator and its operand arena."""
from .aggregator import AggOptions, Aggregator, aggregator

__all__ = ["AggOptions", "Aggregator", "aggregator"]
