"""Tensor-parallel layers of the port (``fleet.meta_parallel``)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding"]
