"""Distributed training and serving of the port (counterpart of
``paddle_tpu.distributed``): the meshes (``mesh``: the serving mesh and
the training mesh over ``HYBRID_AXES``), their collectives
(``collective``) and sharding rules (``sharding_util``), data parallelism
(``parallel``), pipeline parallelism (``pipeline``) and context
parallelism (``context_parallel``), the fleet facade and its
tensor-parallel layers, pipeline layers and recompute (``fleet``), ZeRO
(``sharding``) and step checkpoints (``checkpoint``).

The names below are the JAX package's ``distributed/__init__.py`` exports
for these modules. Each rank (a process, or a thread of one process) holds
its own view of a mesh; the collectives take a process group.
"""
from . import (checkpoint, collective, context_parallel, fleet, mesh,
               parallel, pipeline, sharding)
from .collective import all_gather, all_reduce, broadcast, reduce_scatter
from .mesh import (HYBRID_AXES, HybridCommunicateGroup, build_mesh,
                   clear_mesh, get_mesh, init_hybrid_mesh, serving_mesh,
                   set_mesh)
from .parallel import (DataParallel, barrier, get_rank, get_world_size,
                       init_parallel_env, shard_batch)
from .fleet.meta_parallel import (LayerDesc, PipelineLayer,
                                  PipelineParallel, SharedLayerDesc)
from .sharding import group_sharded_parallel, save_group_sharded_model

__all__ = ["checkpoint", "collective", "context_parallel", "fleet", "mesh",
           "parallel", "pipeline", "sharding", "LayerDesc", "PipelineLayer",
           "PipelineParallel", "SharedLayerDesc", "all_gather", "all_reduce", "barrier", "broadcast",
           "get_rank", "get_world_size", "reduce_scatter", "HYBRID_AXES",
           "HybridCommunicateGroup", "build_mesh", "clear_mesh", "get_mesh",
           "init_hybrid_mesh", "serving_mesh", "set_mesh", "DataParallel",
           "init_parallel_env", "shard_batch", "group_sharded_parallel",
           "save_group_sharded_model"]
