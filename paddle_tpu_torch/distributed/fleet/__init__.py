"""``paddle.distributed.fleet`` of the port (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``): the strategy, ``init`` with
its ``hybrid_configs`` (``:86``), the topology object, ``distributed_model``
(``:135``), ``distributed_optimizer`` (``:154``), the per-axis groups and
the worker queries; and the subpackages, the tensor-parallel layers and
the pipeline's segmentation and wrapper (``meta_parallel``) and
activation recompute (``recompute``).

The JAX ``init`` builds one mesh over every device of the controller. Here
each rank calls it and holds its own view (a
:class:`~paddle_tpu_torch.distributed.mesh.HybridMesh` on its thread, and
this module's state with it): ``backend``, ``store``, ``rank`` and
``world_size`` are :func:`~paddle_tpu_torch.distributed.mesh.
init_hybrid_mesh`'s.
"""
from __future__ import annotations

import threading
from typing import Optional

from .. import collective, parallel
from ..mesh import HybridCommunicateGroup, get_hybrid_mesh, init_hybrid_mesh

__all__ = ["DistributedStrategy", "init", "is_initialized",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "worker_index", "worker_num",
           "is_first_worker", "barrier_worker", "get_data_parallel_group",
           "get_model_parallel_group", "get_sharding_parallel_group",
           "get_pipe_parallel_group", "get_sep_parallel_group"]


class DistributedStrategy:
    """The strategy tree the JAX package keeps (unknown attributes are
    stored, so paddle configs load unchanged)."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": -1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1, "ep_degree": 1}
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.without_graph_optimization = False
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                             "epsilon": 0.0, "exclude_from_weight_decay": []}

    def __repr__(self):
        pub = {k: v for k, v in self.__dict__.items()
               if not k.startswith("_")}
        return f"DistributedStrategy({pub})"


_state = threading.local()


def _get(name):
    return getattr(_state, name, None)


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, *,
         backend: Optional[str] = None, store=None,
         rank: Optional[int] = None, world_size: Optional[int] = None):
    """``fleet.init``: this rank's hybrid mesh from
    ``strategy.hybrid_configs`` (``dp_degree`` -1 takes the rest of the
    world), installed on the calling thread with the topology object."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    dp = int(hc.get("dp_degree", -1))
    mesh = init_hybrid_mesh(
        dp=1 if dp == -1 else dp, mp=int(hc.get("mp_degree", 1)),
        pp=int(hc.get("pp_degree", 1)),
        sharding=int(hc.get("sharding_degree", 1)),
        sep=int(hc.get("sep_degree", 1)), expert=int(hc.get("ep_degree", 1)),
        backend=backend, store=store, rank=rank, world_size=world_size)
    _state.strategy = strategy
    _state.hcg = HybridCommunicateGroup(mesh)
    return None


def is_initialized() -> bool:
    return _get("hcg") is not None


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _get("hcg")


def _mesh():
    mesh = get_hybrid_mesh()
    if mesh is None:
        raise RuntimeError("fleet.init() first (no training mesh on this "
                           "thread)")
    return mesh


def distributed_model(model):
    """Ready a model for the thread's mesh (``paddle_tpu/distributed/
    fleet/__init__.py:135``): over a model axis of more than one rank a
    GPT is split (``models.gpt.shard_model``, a GPT pipe model too;
    another model raises); a :class:`~.meta_parallel.PipelineLayer` on a
    pipe axis of more than one rank becomes a
    :class:`~.meta_parallel.PipelineParallel` (``:144-147``; it takes each
    rank's rows of a data axis itself); and where the mesh has a data group
    (:func:`~paddle_tpu_torch.distributed.parallel.data_group`: a data or a
    sep axis of more than one rank) another model is wrapped in
    :class:`~paddle_tpu_torch.distributed.parallel.DataParallel`, whose
    hooks average the eager path's gradients over data x sep. Build the
    optimizer on the returned model's parameters."""
    from .meta_parallel import PipelineLayer, PipelineParallel

    mesh = _mesh()
    if isinstance(model, PipelineLayer):
        if mesh.axis_size("model") > 1:
            from ...models import gpt

            gpt.shard_model(model, mesh)
        if mesh.axis_size("pipe") > 1:
            return PipelineParallel(model, _get("hcg"), _get("strategy"))
    elif mesh.axis_size("model") > 1:
        from ...models import gpt

        if not hasattr(model, "gpt") and not isinstance(model, gpt.GPTModel):
            raise NotImplementedError(
                f"distributed_model: splitting {type(model).__name__} over "
                "the model axis is not ported (GPT models are split by "
                "models.gpt.shard_model)")
        gpt.shard_model(model, mesh)
    if parallel.data_group(mesh) is not None:
        return parallel.DataParallel(model)
    return model


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """The optimizer for the thread's mesh (``paddle_tpu/distributed/
    fleet/__init__.py:154``): ``TrainStep`` averages gradients over the
    data group itself (``DataParallel`` on the eager path), and ZeRO is
    :func:`~paddle_tpu_torch.distributed.sharding.group_sharded_parallel`.
    ``strategy.lars`` upgrades a ``Momentum`` to ``LarsMomentum`` with the
    strategy's coefficients; gradient merge is not ported (``ROADMAP.md``
    §1 item 2e)."""
    if strategy is not None:
        _state.strategy = strategy
    strategy = strategy or _get("strategy")
    if strategy is None:
        return optimizer
    if getattr(strategy, "gradient_merge", False) and int(dict(
            strategy.gradient_merge_configs).get("k_steps", 1)) > 1:
        raise NotImplementedError("strategy.gradient_merge is not ported "
                                  "(ROADMAP.md §1 item 2e)")
    if getattr(strategy, "lars", False):
        from ...optimizer.optimizer import LarsMomentum, Momentum

        if isinstance(optimizer, Momentum):
            cfg = dict(strategy.lars_configs or {})
            optimizer = LarsMomentum(
                learning_rate=optimizer._learning_rate,
                momentum=optimizer._momentum,
                lars_coeff=float(cfg.get("lars_coeff", 0.001)),
                lars_weight_decay=float(cfg.get("lars_weight_decay",
                                                0.0005)),
                parameters=list(zip(optimizer._param_names,
                                    optimizer._parameter_list)),
                grad_clip=optimizer._grad_clip,
                exclude_from_weight_decay=cfg.get(
                    "exclude_from_weight_decay", []),
                epsilon=float(cfg.get("epsilon", 0.0)),
                rescale_grad=optimizer._rescale_grad)
    return optimizer


def worker_index() -> int:
    return parallel.get_rank()


def worker_num() -> int:
    return parallel.get_world_size()


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier_worker() -> None:
    """Wait for every rank of the world."""
    collective.barrier(_mesh().world)


def get_data_parallel_group():
    return _mesh().get_group("data")


def get_model_parallel_group():
    return _mesh().get_group("model")


def get_sharding_parallel_group():
    return _mesh().get_group("sharding")


def get_pipe_parallel_group():
    return _mesh().get_group("pipe")


def get_sep_parallel_group():
    return _mesh().get_group("sep")
