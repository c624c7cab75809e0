"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The update math runs in f32 on explicit tensors, as the JAX package's pure
``_update`` functions do, not through ``torch.optim``: the bias correction
and the order of the decay terms match the JAX package exactly. Parameters
are updated in place (the JAX package donates their buffers instead).

Slots per parameter: ``moment1`` and ``moment2`` (Adam family, stored in
``moment_dtype``) and, under ``multi_precision`` for a bf16/fp16
parameter, an f32 ``master_weight`` that the update runs on (the
parameter is then a cast of it). ``parameters`` may be plain parameters or
``(name, parameter)`` pairs such as ``model.named_parameters()``; the names
key ``apply_decay_param_fun`` and the slot arrays of
:meth:`Optimizer.optimizer_state_arrays` / :meth:`load_optimizer_state`
(``"<name>.<slot>"``; unnamed parameters are named by their index).

Two ways to step, with the same math: eager ``loss.backward();
opt.step(); opt.clear_grad()``, and :class:`paddle_tpu_torch.jit.TrainStep`,
which hands its gradients to :meth:`Optimizer._apply_gradients`.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _named(parameters):
    """``(names, params)`` from parameters or ``(name, param)`` pairs."""
    if parameters is None:
        return None, None
    items = list(parameters)
    if items and isinstance(items[0], tuple):
        return [n for n, _ in items], [p for _, p in items]
    return [str(i) for i in range(len(items))], items


class Optimizer:
    _state_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        self._param_names, self._parameter_list = _named(parameters)
        self._multi_precision = bool(multi_precision)
        self._learning_rate = learning_rate
        self._weight_decay = 0.0 if weight_decay is None else float(
            weight_decay)
        self._grad_clip = grad_clip
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # ------------------------------------------------------------ LR access
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = value

    # ----------------------------------------------------- pure update math
    def _init_slot(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        low = self._multi_precision and param.dtype in (torch.bfloat16,
                                                        torch.float16)
        # moments start from the f32 master under multi_precision, so their
        # dtype is what the master update produces
        master = param.detach().float() if low else None
        slots = self._init_moments(master if low else param.detach())
        if low:
            slots["master_weight"] = master
        return slots

    def _init_moments(self, param):
        md = getattr(self, "_moment_dtype", None)
        return {name: torch.zeros(param.shape, dtype=md or param.dtype,
                                  device=param.device)
                for name in self._state_names}

    def _update(self, param, grad, slots, lr, step):
        """Pure: ``(param, grad, slots, lr, step) -> (new_param,
        new_slots)``."""
        raise NotImplementedError

    def _update_for(self, name):
        """The update of the parameter called ``name``."""
        return self._update

    @staticmethod
    def _apply_with_master(upd, param, grad, slots, lr, step):
        """Run ``upd`` on the f32 ``master_weight`` when the slots carry
        one (the gradient consumed in f32, the parameter emitted as the
        master's cast), else on the parameter with the gradient in the
        parameter's dtype."""
        if "master_weight" not in slots:
            g = grad.to(param.dtype) if grad.dtype != param.dtype else grad
            return upd(param, g, slots, lr, step)
        sub = {k: v for k, v in slots.items() if k != "master_weight"}
        new_master, ns = upd(slots["master_weight"], grad.float(), sub, lr,
                             step)
        ns["master_weight"] = new_master
        return new_master.to(param.dtype), ns

    @torch.no_grad()
    def _apply_gradients(self, params, grads):
        """Clip ``grads`` (one per parameter of ``params``), advance the
        step count and update every parameter in place."""
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_arrays(list(grads))
        self._step_count += 1
        lr, step = self.get_lr(), self._step_count
        names = dict(zip(map(id, self._parameter_list), self._param_names))
        for p, g in zip(params, grads):
            slots = self._accumulators.get(id(p))
            if slots is None:
                slots = self._init_slot(p)
            new_p, self._accumulators[id(p)] = self._apply_with_master(
                self._update_for(names.get(id(p))), p.detach(), g, slots, lr,
                step)
            p.copy_(new_p)

    # --------------------------------------------------------- eager path
    def step(self):
        """Update every parameter that has a gradient (``p.grad``)."""
        if self._parameter_list is None:
            raise ValueError("optimizer created without a parameter list")
        params = [p for p in self._parameter_list
                  if p.grad is not None and p.requires_grad]
        if not params:
            self._step_count += 1
            return
        self._apply_gradients(params, [p.grad for p in params])

    def clear_grad(self):
        for p in self._parameter_list or []:
            p.grad = None

    # ---------------------------------------------------------- checkpoint
    def optimizer_state_arrays(self) -> Dict[str, np.ndarray]:
        """The slots as numpy arrays under ``"<param name>.<slot>"`` (the
        JAX optimizer's slot names: ``moment1``, ``moment2``,
        ``master_weight``) plus ``"step"``. bf16 slots come out as f32
        (exact)."""
        out = {"step": np.asarray(self._step_count, np.int64)}
        for name, p in zip(self._param_names or [],
                           self._parameter_list or []):
            for slot, t in self._accumulators.get(id(p), {}).items():
                out[f"{name}.{slot}"] = np.array(t.detach().float().cpu())
        return out

    def load_optimizer_state(self, arrays: Dict[str, np.ndarray]) -> None:
        """Restore the slots and the step count from arrays named as
        :meth:`optimizer_state_arrays` names them (for instance the JAX
        optimizer's accumulators under the JAX ``functional_state()``
        names). A parameter with no entry starts fresh; one with some but
        not all of its slots raises ``KeyError``; a wrong shape raises
        ``ValueError``. Each slot takes the dtype this optimizer keeps it
        in; a ``master_weight`` is read only under ``multi_precision``."""
        self._step_count = int(np.asarray(arrays.get("step", 0)))
        for name, p in zip(self._param_names or [],
                           self._parameter_list or []):
            base = self._init_slot(p)
            found = {k: arrays[f"{name}.{k}"] for k in base
                     if f"{name}.{k}" in arrays}
            if not found:
                self._accumulators.pop(id(p), None)
                continue
            if set(found) != set(base):
                raise KeyError(f"{name}: slots {sorted(found)} given, "
                               f"{sorted(base)} needed")
            for k, a in found.items():
                if tuple(np.shape(a)) != tuple(base[k].shape):
                    raise ValueError(f"{name}.{k}: shape {np.shape(a)} != "
                                     f"{tuple(base[k].shape)}")
                base[k] = torch.tensor(np.asarray(a, np.float32),
                                       dtype=base[k].dtype, device=p.device)
            self._accumulators[id(p)] = base


class Adam(Optimizer):
    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        # storage dtype of the moments (bf16 halves the optimizer state);
        # the update math stays f32
        self._moment_dtype = _DTYPES[moment_dtype or "float32"]

    def _moments(self, grad, slots, step):
        """f32 ``(m, v, m_hat, v_hat)``; the bias corrections in f32 as
        the JAX package computes ``1 - beta ** t``."""
        m = (self._beta1 * slots["moment1"].float()
             + (1 - self._beta1) * grad)
        v = (self._beta2 * slots["moment2"].float()
             + (1 - self._beta2) * torch.square(grad))
        t = np.float32(step)
        bc1 = np.float32(1) - np.float32(self._beta1) ** t
        bc2 = np.float32(1) - np.float32(self._beta2) ** t
        return m, v, m / float(bc1), v / float(bc2)

    def _update(self, param, grad, slots, lr, step):
        p32 = param.float()
        g = grad.float()
        if self._weight_decay:
            g = g + self._weight_decay * p32
        m, v, m_hat, v_hat = self._moments(g, slots, step)
        new_p = p32 - lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)
        md = self._moment_dtype
        return new_p.to(param.dtype), {"moment1": m.to(md),
                                       "moment2": v.to(md)}


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr * (m_hat / (sqrt(v_hat)
    + eps) + weight_decay * p)``. With ``apply_decay_param_fun``, only the
    parameters whose name it accepts are decayed (the JAX package stores
    the function but never reads it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision=multi_precision,
                         moment_dtype=moment_dtype)
        self._weight_decay = float(weight_decay or 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_for(self, name):
        fun = self._apply_decay_param_fun
        if fun is None or fun(name):
            return self._update
        return functools.partial(self._update, weight_decay=0.0)

    def _update(self, param, grad, slots, lr, step, weight_decay=None):
        wd = self._weight_decay if weight_decay is None else weight_decay
        m, v, m_hat, v_hat = self._moments(grad.float(), slots, step)
        p32 = param.float()
        new_p = p32 - lr * (m_hat / (torch.sqrt(v_hat) + self._epsilon)
                            + wd * p32)
        md = self._moment_dtype
        return new_p.to(param.dtype), {"moment1": m.to(md),
                                       "moment2": v.to(md)}
