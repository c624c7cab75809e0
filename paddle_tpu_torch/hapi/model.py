"""hapi ``Model`` (counterpart of ``paddle_tpu/hapi/model.py``):
``prepare`` / ``fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load``
and ``summary``.

``fit`` drives the port's :class:`paddle_tpu_torch.jit.TrainStep` on the
loss ``loss(network(*inputs), label)`` of each batch (the last field of a
batch is the label). Data may be a ``Dataset`` (a ``DataLoader`` is built
on the network's device), a ``DataLoader`` or any iterable of batches.

Where the port differs from the JAX package on purpose:

* ``save`` lets an error while saving the optimizer raise (the JAX
  package's ``Model.save`` swallows it: a checkpoint that silently lacks
  its optimizer is a quiet fallback).
* ``load`` also restores the optimizer from ``<path>.pdopt`` when the file
  exists, an optimizer is prepared and ``reset_optimizer`` is false (as
  paddle's hapi does; the JAX package reads only the parameters).

``prepare(amp_configs=)`` is accepted and not read, as in the JAX package:
for O2, ``amp.decorate`` the network and optimizer before ``prepare``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..framework import io as fio
from ..jit import TrainStep
from ..metric import Metric
from .callbacks import Callback, CallbackList, ProgBarLogger

__all__ = ["Model", "summary"]


class Model:
    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self.stop_training = False

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            metrics = []
        elif isinstance(metrics, Metric):
            metrics = [metrics]
        self._metrics = list(metrics)
        self._train_step = None
        return self

    def _loss_of(self, *batch):
        *xs, y = batch
        return self._loss(self.network(*xs), y)

    # ---------------------------------------------------------------- fit
    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 2, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0,
            callbacks: Optional[Sequence[Callback]] = None):
        """Train ``epochs`` epochs; returns ``{"loss": [last loss of each
        epoch]}``. Callbacks see ``{"loss": float}`` after each batch."""
        loader = self._as_loader(train_data, batch_size, shuffle, drop_last,
                                 num_workers)
        cbs = CallbackList(list(callbacks or [])
                           + [ProgBarLogger(log_freq, verbose)])
        cbs.set_model(self)
        cbs.set_params({"epochs": epochs, "verbose": verbose})
        self.stop_training = False
        if self._train_step is None:
            self._train_step = TrainStep(self._loss_of, self._optimizer)
        cbs.on_train_begin()
        history = {"loss": []}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbs.on_epoch_begin(epoch)
            self.network.train()
            last_loss = None
            for step, batch in enumerate(loader):
                cbs.on_train_batch_begin(step)
                loss = self._train_step(*self._to_tensors(batch))
                last_loss = float(loss)
                cbs.on_train_batch_end(step, {"loss": last_loss})
            history["loss"].append(last_loss)
            logs = {"loss": last_loss}
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                logs.update(self.evaluate(
                    eval_data, batch_size=batch_size, verbose=0,
                    num_workers=num_workers, callbacks=list(callbacks or [])))
            cbs.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch), "model"))
        cbs.on_train_end()
        return history

    # ------------------------------------------------------------ evaluate
    @torch.no_grad()
    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 2, num_workers: int = 0, callbacks=None):
        """The mean loss over the batches and each metric, in eval mode."""
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbs = CallbackList(list(callbacks or []))
        cbs.set_model(self)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        cbs.on_eval_begin()
        total_loss, batches = 0.0, 0
        for batch in loader:
            *xs, y = self._to_tensors(batch)
            out = self.network(*xs)
            if self._loss is not None:
                total_loss += float(self._loss(out, y))
                batches += 1
            for m in self._metrics:
                res = m.compute(out, y)
                m.update(*res) if isinstance(res, tuple) else m.update(res)
        logs = {}
        if batches:
            logs["loss"] = total_loss / batches
        for m in self._metrics:
            names, vals = m.name(), m.accumulate()
            if isinstance(names, list):
                logs.update(dict(zip(names, vals)))
            else:
                logs[names] = vals
        cbs.on_eval_end(logs)
        self.network.train()
        return logs

    # ------------------------------------------------------------- predict
    @torch.no_grad()
    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0,
                stack_outputs: bool = False, verbose: int = 1,
                callbacks=None):
        """The network's outputs as numpy arrays: ``[[per batch]]``, or
        ``[stacked]`` with ``stack_outputs``. A batch of more than one
        field is taken as inputs and a label."""
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        self.network.eval()
        outs = []
        for batch in loader:
            batch = self._to_tensors(batch)
            xs = batch[:-1] if len(batch) > 1 else batch
            out = self.network(*xs).detach().cpu()
            outs.append((out.float() if out.dtype == torch.bfloat16
                         else out).numpy())
        self.network.train()
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    # ------------------------------------------------------- save / load
    def save(self, path: str, training: bool = True):
        """``<path>.pdparams`` (the network's state) and, when training,
        ``<path>.pdopt`` (the optimizer's); an error in either raises."""
        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        state = fio.load(path + ".pdparams")
        self.network.load_state_dict(state, strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if (self._optimizer is not None and not reset_optimizer
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(fio.load(opt_path))
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    # -------------------------------------------------------------- utils
    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        from ..io import DataLoader, Dataset

        if data is None:
            raise ValueError("data is required")
        if isinstance(data, DataLoader):
            return data
        if (hasattr(data, "__iter__") and not isinstance(data, Dataset)
                and not hasattr(data, "__getitem__")):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers,
                          device=self._device())

    def _to_tensors(self, batch):
        dev = self._device()

        def one(b):
            if isinstance(b, torch.Tensor):
                return b.to(dev)
            return torch.as_tensor(np.asarray(b), device=dev)

        if isinstance(batch, (list, tuple)):
            return [one(b) for b in batch]
        return [one(batch)]


def summary(net: torch.nn.Module, input_size=None, dtypes=None, input=None):
    """paddle's ``summary``: a table of the parameters and their totals."""
    rows = []
    total, trainable = 0, 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, list(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Params':>12}"]
    lines += [f"{r[0]:<{width}}{str(r[1]):<20}{r[2]:>12,}" for r in rows]
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    lines.append(f"Non-trainable params: {total - trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
