"""Tensor-parallel layers of the port (``fleet.meta_parallel``)."""
from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
