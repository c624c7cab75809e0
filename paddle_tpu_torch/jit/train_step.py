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
* Keys, as the JAX TrainStep threads them: one ``rng.next_key()`` per
  call, on the device of the first tensor argument; the loss runs
  under ``rng.key_guard(key)`` (its draw number n is ``fold_in(key, n)``),
  microbatch i of ``accumulate_steps`` under ``key_guard(fold_in(key,
  i))``. After the same ``seed``, the port and the JAX package draw the
  same dropout masks step after step.
* With ``FLAGS_trainstep_sentinel`` (read at the first call), a nonfinite
  loss or gradient skips the update: parameters, optimizer slots and the
  step count stay bit-identical and ``sentinel.skipped`` is bumped. An
  armed ``nonfinite_grads`` fault scales the step's loss and gradients
  by NaN.
  After ``FLAGS_max_bad_steps`` consecutive skipped steps (0: never) the
  step calls ``resilience.trigger_rollback``.
* The optimizer's slots are read from ``optimizer._accumulators`` at every
  call, so an ``optimizer.set_state_dict`` between two calls (a resume or
  a rollback) is what the next step continues from, as the JAX package's
  ``_state_version`` re-seed makes it. Each parameter's update is
  ``optimizer._update_for(name, param)``: Lamb's and LARS's exclusion
  from weight decay holds inside the step.

On a training mesh (the thread's :class:`~paddle_tpu_torch.distributed.
mesh.HybridMesh`; the JAX package's step over a ``("data", "sharding",
"model")`` mesh): the step averages every gradient over the data group
before the optimizer's clip and update (``distributed.parallel.
sync_gradients``; a ZeRO optimizer then reduce-scatters over the sharding
group); parameters
replicated over the model axis get no model-axis reduce (the *f* / *g*
pairs of the parallel layers make their gradients equal on every rank);
the clip's norm is the whole model's. Keys stay one ``rng.next_key()`` a
call, the same on every rank (each rank's key state starts equal). The
loss runs and its gradients are taken on the calling thread
(``torch.autograd.set_multithreading_enabled(False)``, so ranks that are
threads of one process never meet in autograd's device thread), under the
dropout box of inputs :func:`~paddle_tpu_torch.distributed.parallel.
shard_batch` tagged. The sentinel's verdict is every rank's: one rank's
nonfinite shard skips the step everywhere. ``accumulate_steps > 1`` over a
data axis of more than one rank is not ported (the JAX package's
microbatches are slices of the global batch).

Counters (``core.compile_cache``): ``train_step.builds`` once per
TrainStep, at its first call (the JAX package's compile); ``train_step.
steps`` every call; ``sentinel.skipped`` every skipped step (also in
``core.resilience``'s counters, where the JAX package keeps it).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List

import torch

from ..core import compile_cache, flags, resilience, rng
from ..distributed import collective, mesh as mesh_mod, parallel
from ..ops import dropout as dropout_op

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
        self._bad_steps = 0  # consecutive skipped steps

    def _loss_and_grads(self, args, key):
        with rng.key_guard(key):
            loss = self._fn(*args).float()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._params, grads)]
        return loss.detach(), grads

    def _accumulated(self, args, key):
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
            loss, grads = self._loss_and_grads([m[i] for m in micro],
                                               rng.fold_in(key, i))
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
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        key = rng.next_key(dev)
        mesh = mesh_mod.get_hybrid_mesh()
        with self._on_mesh(mesh, args):
            if self._accumulate_steps > 1:
                loss, grads = self._accumulated(args, key)
            else:
                loss, grads = self._loss_and_grads(args, key)
        if self._sentinel:
            if resilience.maybe_fault("nonfinite_grads"):
                # the JAX step multiplies its loss by NaN: loss and grads
                loss = loss * float("nan")
                grads = [g * float("nan") for g in grads]
            finite = torch.stack([torch.isfinite(loss)] + [
                torch.isfinite(g).all() for g in grads]).all()
            if mesh is not None and mesh.world_size > 1:
                bad = (~finite).float().reshape(1)
                finite = collective.all_reduce(bad, mesh.world,
                                               op="max")[0] == 0
            if not bool(finite):
                self._skip()
                return loss
            self._bad_steps = 0
        if mesh is not None:
            grads = parallel.sync_gradients(grads, mesh)
        self._opt._apply_gradients(self._params, grads)
        return loss

    def _on_mesh(self, mesh, args):
        """The context of a step on ``mesh``: backward on this thread and
        the inputs' dropout box (nothing without a mesh)."""
        if mesh is None:
            return contextlib.nullcontext()
        if self._accumulate_steps > 1 and mesh.axis_size("data") > 1:
            raise NotImplementedError(
                "TrainStep(accumulate_steps > 1) over a data axis of more "
                "than one rank is not ported: the JAX package's microbatches "
                "are slices of the global batch")
        stack = contextlib.ExitStack()
        stack.enter_context(torch.autograd.set_multithreading_enabled(False))
        stack.enter_context(dropout_op.box(parallel.batch_box(args)))
        return stack

    def _skip(self) -> None:
        """Count a skipped step; roll back after FLAGS_max_bad_steps."""
        compile_cache.bump("sentinel.skipped")
        resilience.bump("sentinel.skipped")
        self._bad_steps += 1
        limit = int(flags.flag("max_bad_steps"))
        if limit > 0 and self._bad_steps >= limit:
            self._bad_steps = 0
            resilience.trigger_rollback(
                f"TrainStep: {limit} consecutive nonfinite steps "
                "(loss/grads)")
