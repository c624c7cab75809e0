"""Hybrid-parallel layers of the port (``fleet.meta_parallel``): the
tensor-parallel layers and the pipeline's segmentation and wrapper."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pipeline_parallel import PipelineParallel
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "LayerDesc",
           "PipelineLayer", "SharedLayerDesc", "PipelineParallel"]
