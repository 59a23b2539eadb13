"""Multi-vector aggregator and its operand arena."""
from .aggregator import (AggOptions, Aggregator, aggregator,
                         aggregator_pipeline_execute)

__all__ = ["AggOptions", "Aggregator", "aggregator",
           "aggregator_pipeline_execute"]
