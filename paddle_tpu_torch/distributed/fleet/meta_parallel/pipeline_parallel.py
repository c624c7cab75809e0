"""``PipelineParallel`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

The schedule lives in the :class:`~.pp_layers.PipelineLayer`'s forward
(``distributed/pipeline.py``); ``train_batch`` runs one ``TrainStep`` of
the layer's loss over the global batch, ``eval_batch`` the forward. On a
data axis each rank takes its rows of the global batch
(``parallel.shard_batch``), and every rank returns the global loss.
"""
from __future__ import annotations

from torch import nn

from ... import parallel
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]


class PipelineParallel(nn.Module):
    """A :class:`PipelineLayer` with paddle's ``train_batch`` /
    ``eval_batch``. ``strategy.pipeline_configs["accumulate_steps"] > 1``
    sets the layer's microbatches (1, the strategy's default, leaves an
    explicit ``num_microbatches`` alone)."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        if strategy is not None:
            acc = getattr(strategy, "pipeline_configs", {}).get(
                "accumulate_steps", None)
            if acc and int(acc) > 1:
                layers.num_microbatches = int(acc)
        self._train_step = None
        self._train_opt = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """``data = (inputs, labels)``, the global batch; one step of the
        optimizer; returns the mean loss (a detached f32 scalar)."""
        x, y = data
        if self._layers.loss_fn is None:
            raise ValueError("PipelineLayer was built without a loss_fn")
        if self._train_step is None or self._train_opt is not optimizer:
            from ....jit import TrainStep

            def loss_f(xi, yi):
                return self._layers.loss_fn(self._layers(xi), yi)

            self._train_step = TrainStep(loss_f, optimizer)
            self._train_opt = optimizer
        loss = self._train_step(parallel.shard_batch(x),
                                parallel.shard_batch(y))
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        x, y = data
        out = self._layers(parallel.shard_batch(x))
        if compute_loss:
            return self._layers.loss_fn(out, parallel.shard_batch(y))
        return out
