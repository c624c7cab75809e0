"""One training step: forward, backward, clip and update (counterpart of
``paddle_tpu/jit/__init__.py:TrainStep``).

The JAX package compiles the step into one XLA program; the port runs it
eagerly: ``fn(*args)`` builds the loss, ``torch.autograd.grad`` takes the
gradients of the optimizer's trainable parameters, and the optimizer clips
and updates them in place (the JAX package donates their buffers instead).

* ``accumulate_steps=k`` splits every argument along dim 0 into k
  microbatches, takes each one's gradients at the step's initial
  parameters, sums them in f32 and averages them before one update; the
  returned loss is the microbatch mean.
* With ``FLAGS_trainstep_sentinel`` (read at the first call), a nonfinite
  loss or gradient skips the update: parameters, optimizer slots and the
  step count stay bit-identical and ``sentinel.skipped`` is bumped.

Counters (``core.compile_cache``): ``train_step.builds`` once per
TrainStep, at its first call (the JAX package's compile); ``train_step.
steps`` every call; ``sentinel.skipped`` every skipped step (the JAX
package keeps this one in ``core/resilience.py``, not ported yet).
"""
from __future__ import annotations

from typing import Callable, List

import torch

from ..core import compile_cache, flags

__all__ = ["TrainStep"]


class TrainStep:
    """``TrainStep(fn, optimizer)(*args)`` runs one step on the loss
    ``fn(*args)`` and returns it, detached, as an f32 scalar. The JAX
    package's ``layers`` argument (buffers to thread through the compiled
    step) has no counterpart: torch modules update their buffers in
    place."""

    def __init__(self, fn: Callable, optimizer, accumulate_steps: int = 1):
        if int(accumulate_steps) < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self._fn = fn
        self._opt = optimizer
        self._accumulate_steps = int(accumulate_steps)
        self._params: List[torch.Tensor] = [
            p for p in optimizer._parameter_list or [] if p.requires_grad]
        self._built = False
        self._sentinel = False

    def _loss_and_grads(self, args):
        loss = self._fn(*args).float()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._params, grads)]
        return loss.detach(), grads

    def _accumulated(self, args):
        k = self._accumulate_steps
        leading = {a.shape[0] if isinstance(a, torch.Tensor) and a.dim()
                   else None for a in args}
        dim = next(iter(leading)) if len(leading) == 1 else None
        if dim is None or dim % k:
            raise ValueError(
                f"accumulate_steps={k}: all inputs must be tensors sharing "
                f"one leading (batch) dim divisible by k; got {leading}")
        micro = [a.reshape((k, dim // k) + tuple(a.shape[1:])) for a in args]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in self._params]
        lsum = None
        for i in range(k):
            loss, grads = self._loss_and_grads([m[i] for m in micro])
            for a, g in zip(acc, grads):
                a.add_(g.float())
            lsum = loss if lsum is None else lsum + loss
            del grads
        scale = 1.0 / k
        return lsum * scale, [a * scale for a in acc]

    def __call__(self, *args) -> torch.Tensor:
        if not self._built:
            compile_cache.bump("train_step.builds")
            self._sentinel = bool(flags.flag("trainstep_sentinel"))
            self._built = True
        compile_cache.bump("train_step.steps")
        if self._accumulate_steps > 1:
            loss, grads = self._accumulated(args)
        else:
            loss, grads = self._loss_and_grads(args)
        if self._sentinel:
            finite = torch.stack([torch.isfinite(loss)] + [
                torch.isfinite(g).all() for g in grads]).all()
            if not bool(finite):
                compile_cache.bump("sentinel.skipped")
                return loss
        self._opt._apply_gradients(self._params, grads)
        return loss
