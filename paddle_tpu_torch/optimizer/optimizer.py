"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The update math runs in f32 on explicit tensors, as the JAX package's pure
``_update`` functions do, not through ``torch.optim``: the bias correction
and the order of the terms match the JAX package's. Parameters are updated
in place (the JAX package donates their buffers instead).

Optimizers: ``SGD``, ``Momentum`` (``use_nesterov``, ``rescale_grad``),
``Adam``, ``AdamW``, ``Adagrad``, ``Adadelta``, ``RMSProp`` (``centered``,
``momentum``), ``Adamax``, ``Lamb`` (``exclude_from_weight_decay_fn``,
``moment_dtype``) and ``LarsMomentum`` (``exclude_from_weight_decay``,
``rescale_grad``); ``LBFGS`` is in :mod:`.lbfgs`. Slots per parameter carry
the JAX package's names (``moment1``/``moment2``, ``velocity``,
``moment``, ``avg_squared_grad``/``avg_squared_update``,
``mean_square``/``mean_grad``/``momentum``, ``moment``/``inf_norm``) and,
under ``multi_precision`` for a bf16/fp16 parameter, an f32
``master_weight`` that the update runs on (the parameter is then a cast of
it). ``parameters`` may be plain parameters or ``(name, parameter)`` pairs
such as ``model.named_parameters()``; the names key
``apply_decay_param_fun``, LARS's exclusion and the checkpoint keys
(:meth:`Optimizer._slot_keys`; an unnamed parameter is named by its index).

Three ways to step, with the same math: eager ``loss.backward();
opt.step(); opt.clear_grad()`` (or ``opt.minimize(loss)``);
:class:`paddle_tpu_torch.jit.TrainStep`, which hands its gradients to
:meth:`Optimizer._apply_gradients`; and the pure
:meth:`Optimizer.init_state` / :meth:`Optimizer.apply_gradients` over
dicts of tensors. Every path clips once over all gradients and then takes
each parameter's update from :meth:`Optimizer._update_for`, which is where
Lamb's and LARS's weight-decay exclusion (and AdamW's
``apply_decay_param_fun``) take effect.

Checkpoints: :meth:`Optimizer.state_dict` is ``{"step": n,
"<key>.<slot>": tensor, "LR_Scheduler": {...}}`` as in the JAX package;
:meth:`Optimizer.set_state_dict` lays the restored slots over freshly
initialised ones (a missing slot starts fresh, a ``master_weight`` is
read only under ``multi_precision``), so the next ``TrainStep`` call
continues from them (the JAX ``_state_version`` re-seed).
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "RMSProp", "Adamax", "Lamb", "LarsMomentum"]

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


def _f32(x: float) -> np.float32:
    return np.float32(x)


def _bias_correction(beta: float, step: int) -> float:
    """``1 - beta ** t`` in f32, as the JAX package computes it."""
    return float(_f32(1) - _f32(beta) ** _f32(step))


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


class Optimizer:
    _state_names: List[str] = []
    #: whether each element's update reads only that element (Lamb's and
    #: LARS's read whole-tensor norms, which a split shard does not hold)
    _elementwise = True
    #: the ZeRO sharding of the update and the slots (set by
    #: ``distributed.sharding.group_sharded_parallel``; None: every
    #: parameter whole): ``local(p, g)``, ``whole(p, new)``, ``done()``,
    #: ``whole_state(opt, sd)`` and ``local_state(opt, sd)``
    _shards = None

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._param_names, self._parameter_list = _named(parameters)
        self._multi_precision = bool(multi_precision)
        self._learning_rate = learning_rate
        self._set_weight_decay(weight_decay)
        self._grad_clip = grad_clip
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    def _set_weight_decay(self, weight_decay) -> None:
        """``weight_decay``: a float (L2), ``L2Decay`` or ``L1Decay`` (the
        decay term then follows ``sign(param)``), or None (no decay)."""
        self._wd_l1 = isinstance(weight_decay, L1Decay)
        if isinstance(weight_decay, (L1Decay, L2Decay)):
            weight_decay = weight_decay.coeff
        self._weight_decay = float(weight_decay or 0.0)

    def _decay_dir(self, p32):
        """The direction the decay term scales: the parameter, or its sign
        under ``L1Decay``."""
        return torch.sign(p32) if self._wd_l1 else p32

    def _decay_grad(self, grad, param):
        """The gradient plus the regularization term (``coeff * param``, or
        ``coeff * sign(param)`` under ``L1Decay``)."""
        if not self._weight_decay:
            return grad
        return grad + self._weight_decay * self._decay_dir(param)

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
        """Zeros per slot, in ``_moment_dtype`` where the optimizer has one
        (Adam family, Lamb), else in the parameter's dtype."""
        md = getattr(self, "_moment_dtype", None)
        return {name: torch.zeros(param.shape, dtype=md or param.dtype,
                                  device=param.device)
                for name in self._state_names}

    def _update(self, param, grad, slots, lr, step):
        """Pure: ``(param, grad, slots, lr, step) -> (new_param,
        new_slots)``."""
        raise NotImplementedError

    def _update_for(self, name, param=None):
        """The update of the parameter called ``name`` (``param`` itself
        when the caller has it): where an optimizer excludes parameters
        from its weight decay."""
        return self._update

    def _no_wd_update(self, wd_attr: str):
        """``_update`` with the decay attribute ``wd_attr`` at 0."""
        def upd(param, grad, slots, lr, step):
            saved = getattr(self, wd_attr)
            setattr(self, wd_attr, 0.0)
            try:
                return self._update(param, grad, slots, lr, step)
            finally:
                setattr(self, wd_attr, saved)

        return upd

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

    def _names_by_id(self) -> Dict[int, str]:
        return dict(zip(map(id, self._parameter_list or []),
                        self._param_names or []))

    @torch.no_grad()
    def _apply_gradients(self, params, grads):
        """Clip ``grads`` (one per parameter of ``params``, already
        averaged over any data axis by the caller) once over all of them,
        advance the step count and update every parameter in place with
        its :meth:`_update_for`. On a mesh the clip's norm is the whole
        model's: a tensor-parallel shard (``split_mesh``) and a ZeRO slice
        sum their squares over the groups that split them. Under ZeRO
        (:attr:`_shards`) a parameter is updated as this rank's slice, from
        its slice of the gradient, and gathered whole after."""
        from ..distributed import parallel

        shards = self._shards
        held, sliced = [p.detach() for p in params], None
        if shards is not None:
            held, grads, sliced = map(list, zip(*[
                shards.local(p, g) for p, g in zip(params, grads)]))
        groups = parallel.norm_groups(params, sliced)
        if groups is not None and not self._elementwise:
            raise NotImplementedError(
                f"{type(self).__name__} reads whole-tensor norms; on "
                "parameters split over a mesh it is not ported")
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_arrays(list(grads), groups)
        self._step_count += 1
        lr, step = self.get_lr(), self._step_count
        names = self._names_by_id()
        for p, h, g in zip(params, held, grads):
            slots = self._accumulators.get(id(p))
            if slots is None:
                slots = self._init_slot(h)
            new_p, self._accumulators[id(p)] = self._apply_with_master(
                self._update_for(names.get(id(p)), p), h, g, slots, lr, step)
            if shards is not None:
                new_p = shards.whole(p, new_p)
            p.copy_(new_p)
        if shards is not None:
            shards.done()

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

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then :meth:`step`."""
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad

    # ------------------------------------------------------ functional path
    def init_state(self, params: Dict[str, torch.Tensor]) -> dict:
        """Optimizer state for :meth:`apply_gradients`: fresh slots per
        named parameter and the step."""
        return {"slots": {n: self._init_slot(p) for n, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def apply_gradients(self, params, grads, state, lr=None):
        """Pure update over dicts of tensors: ``(new_params, new_state)``.
        The clip runs once over every gradient given; a parameter whose
        gradient is None passes through."""
        lr_v = self.get_lr() if lr is None else float(lr)
        step = int(state["step"]) + 1
        live = [n for n in params if grads.get(n) is not None]
        gl = [grads[n] for n in live]
        if self._grad_clip is not None:
            gl = self._grad_clip._clip_arrays(gl)
        new_params, new_slots = dict(params), dict(state["slots"])
        for n, g in zip(live, gl):
            p = params[n]
            new_params[n], new_slots[n] = self._apply_with_master(
                self._update_for(n, p), p.detach(), g, state["slots"][n],
                lr_v, step)
        return new_params, {"slots": new_slots, "step": step}

    # ---------------------------------------------------------- checkpoint
    def _slot_keys(self) -> List[str]:
        """One checkpoint key per parameter: its name, or its index when
        unnamed; a name two parameters share gets ``#0``, ``#1``."""
        names = list(self._param_names or [])
        counts = Counter(names)
        seen: Dict[str, int] = {}
        keys = []
        for n in names:
            if counts[n] > 1:
                seen[n] = seen.get(n, -1) + 1
                keys.append(f"{n}#{seen[n]}")
            else:
                keys.append(n)
        return keys

    def state_dict(self) -> dict:
        """``{"step": n, "<key>.<slot>": tensor, "LR_Scheduler": ...}``:
        copies of the slots, so a later in-place update leaves it as it
        was."""
        sd = {"step": self._step_count}
        for key, p in zip(self._slot_keys(), self._parameter_list or []):
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[f"{key}.{k}"] = v.detach().clone()
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        if self._shards is not None:
            sd = self._shards.whole_state(self, sd)
        return sd

    def set_state_dict(self, state_dict) -> None:
        """Restore the step, the LR scheduler and the slots from a
        :meth:`state_dict` (tensors or numpy arrays; keys by name or by
        index). Each parameter's restored slots are laid over fresh ones in
        this optimizer's dtypes; one with no entry starts fresh; a
        ``master_weight`` is read only under ``multi_precision``. Under
        ZeRO the slots are whole and each rank keeps its slices."""
        if self._shards is not None:
            state_dict = self._shards.local_state(self, state_dict)
        self._step_count = int(np.asarray(state_dict.get("step", 0)))
        if (isinstance(self._learning_rate, LRScheduler)
                and "LR_Scheduler" in state_dict):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for i, (key, p) in enumerate(zip(self._slot_keys(),
                                         self._parameter_list or [])):
            base = self._init_slot(p)
            found = False
            for name in base:
                if name == "master_weight" and not self._multi_precision:
                    continue
                for k in (f"{key}.{name}", f"{i}.{name}"):
                    if k in state_dict:
                        base[name] = _as_tensor(state_dict[k]).to(
                            device=p.device, dtype=base[name].dtype).clone()
                        found = True
                        break
            if found:
                self._accumulators[id(p)] = base
            else:
                self._accumulators.pop(id(p), None)

    set_dict = set_state_dict

    def optimizer_state_arrays(self) -> Dict[str, np.ndarray]:
        """The slots as numpy arrays under ``"<param name>.<slot>"`` plus
        ``"step"``. bf16 slots come out as f32 (exact)."""
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


class SGD(Optimizer):
    def _update(self, param, grad, slots, lr, step):
        grad = self._decay_grad(grad, param)
        return (param - lr * grad).to(param.dtype), slots


class Momentum(Optimizer):
    _state_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)
        self._rescale_grad = float(rescale_grad)

    def _update(self, param, grad, slots, lr, step):
        if self._rescale_grad != 1.0:
            grad = grad * self._rescale_grad
        grad = self._decay_grad(grad, param)
        v = self._momentum * slots["velocity"] + grad
        if self._use_nesterov:
            new_p = param - lr * (grad + self._momentum * v)
        else:
            new_p = param - lr * v
        return new_p.to(param.dtype), {"velocity": v}


class Adam(Optimizer):
    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
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
        return (m, v, m / _bias_correction(self._beta1, step),
                v / _bias_correction(self._beta2, step))

    def _update(self, param, grad, slots, lr, step):
        p32 = param.float()
        g = self._decay_grad(grad.float(), p32)
        m, v, m_hat, v_hat = self._moments(g, slots, step)
        new_p = p32 - lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)
        md = self._moment_dtype
        return new_p.to(param.dtype), {"moment1": m.to(md),
                                       "moment2": v.to(md)}


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr * (m_hat / (sqrt(v_hat)
    + eps) + weight_decay * p)`` (``sign(p)`` in place of ``p`` under
    ``L1Decay``). With ``apply_decay_param_fun``, only the
    parameters whose name it accepts are decayed (the JAX package stores
    the function but never reads it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, moment_dtype=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision=multi_precision,
                         moment_dtype=moment_dtype, name=name)
        self._set_weight_decay(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_for(self, name, param=None):
        fun = self._apply_decay_param_fun
        if fun is None or fun(name):
            return self._update
        return functools.partial(self._update, weight_decay=0.0)

    def _update(self, param, grad, slots, lr, step, weight_decay=None):
        wd = self._weight_decay if weight_decay is None else weight_decay
        m, v, m_hat, v_hat = self._moments(grad.float(), slots, step)
        p32 = param.float()
        new_p = p32 - lr * (m_hat / (torch.sqrt(v_hat) + self._epsilon)
                            + wd * self._decay_dir(p32))
        md = self._moment_dtype
        return new_p.to(param.dtype), {"moment1": m.to(md),
                                       "moment2": v.to(md)}


class Adagrad(Optimizer):
    _state_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _init_moments(self, param):
        return {"moment": torch.full(param.shape,
                                     self._initial_accumulator_value,
                                     dtype=torch.float32,
                                     device=param.device)}

    def _update(self, param, grad, slots, lr, step):
        p32 = param.float()
        g = self._decay_grad(grad.float(), p32)
        mom = slots["moment"] + torch.square(g)
        new_p = p32 - lr * g / (torch.sqrt(mom) + self._epsilon)
        return new_p.to(param.dtype), {"moment": mom}


class Adadelta(Optimizer):
    _state_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon

    def _update(self, param, grad, slots, lr, step):
        p32 = param.float()
        g = self._decay_grad(grad.float(), p32)
        rho = self._rho
        asg = rho * slots["avg_squared_grad"] + (1 - rho) * torch.square(g)
        upd = (torch.sqrt(slots["avg_squared_update"] + self._epsilon)
               / torch.sqrt(asg + self._epsilon) * g)
        asu = (rho * slots["avg_squared_update"]
               + (1 - rho) * torch.square(upd))
        new_p = p32 - lr * upd
        return new_p.to(param.dtype), {"avg_squared_grad": asg,
                                       "avg_squared_update": asu}


class RMSProp(Optimizer):
    _state_names = ["mean_square", "mean_grad", "momentum"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, bool(centered)

    def _update(self, param, grad, slots, lr, step):
        p32 = param.float()
        g = self._decay_grad(grad.float(), p32)
        rho = self._rho
        ms = rho * slots["mean_square"] + (1 - rho) * torch.square(g)
        if self._centered:
            mg = rho * slots["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
        else:
            mg = slots["mean_grad"]
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * slots["momentum"] + lr * g / denom
        new_p = p32 - mom
        return new_p.to(param.dtype), {"mean_square": ms, "mean_grad": mg,
                                       "momentum": mom}


class Adamax(Optimizer):
    _state_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, param, grad, slots, lr, step):
        p32 = param.float()
        g = self._decay_grad(grad.float(), p32)
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * slots["inf_norm"], torch.abs(g))
        # lr / (1 - beta1 ** t) as one f32 scalar, as the JAX package
        c = float(_f32(lr) / _f32(_bias_correction(self._beta1, step)))
        new_p = p32 - c * m / (u + self._epsilon)
        return new_p.to(param.dtype), {"moment": m, "inf_norm": u}


class Lamb(Optimizer):
    """LAMB: Adam's direction plus decoupled decay, scaled per parameter by
    the trust ratio ``||p|| / ||r||``. ``exclude_from_weight_decay_fn
    (param)`` returning True trains that parameter with no decay; it is
    called with the parameter tensor itself."""
    _state_names = ["moment1", "moment2"]
    _elementwise = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None, moment_dtype=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        self._moment_dtype = _DTYPES[moment_dtype or "float32"]

    def _update(self, param, grad, slots, lr, step):
        g = grad.float()
        p32 = param.float()
        m = (self._beta1 * slots["moment1"].float()
             + (1 - self._beta1) * g)
        v = (self._beta2 * slots["moment2"].float()
             + (1 - self._beta2) * torch.square(g))
        m_hat = m / _bias_correction(self._beta1, step)
        v_hat = v / _bias_correction(self._beta2, step)
        r = (m_hat / (torch.sqrt(v_hat) + self._epsilon)
             + self._lamb_weight_decay * p32)
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_p = p32 - lr * trust * r
        md = self._moment_dtype
        return new_p.to(param.dtype), {"moment1": m.to(md),
                                       "moment2": v.to(md)}

    def _update_for(self, name, param=None):
        if self._exclude_fn is None or not self._exclude_fn(param):
            return self._update
        return self._no_wd_update("_lamb_weight_decay")


class LarsMomentum(Optimizer):
    """LARS: momentum with layer-wise adaptive rate scaling::

        g' = rescale_grad * g
        local_lr = lr * lars_coeff * ||p|| / (||g'|| + wd * ||p|| + eps)
                   (plain lr when wd == 0 or either norm is 0)
        v = mu * v + local_lr * (g' + wd * p)
        p = p - v

    ``exclude_from_weight_decay`` lists parameter-name substrings that train
    with wd 0 (and so a plain-lr update). The clip runs once over all
    gradients before the split, in every path (the JAX package's
    ``apply_gradients`` override does the same)."""
    _state_names = ["velocity"]
    _elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon
        self._rescale_grad = rescale_grad
        self._exclude_names = list(exclude_from_weight_decay or [])

    def _init_moments(self, param):
        return {"velocity": torch.zeros(param.shape, dtype=torch.float32,
                                        device=param.device)}

    def _update(self, param, grad, slots, lr, step):
        p32 = param.float()
        g = grad.float() * self._rescale_grad
        wd = self._lars_weight_decay
        p_norm = torch.linalg.vector_norm(p32)
        g_norm = torch.linalg.vector_norm(g)
        # lr * lars_coeff as one f32 scalar, as the JAX package
        c = float(_f32(lr) * _f32(self._lars_coeff))
        lars_lr = c * p_norm / (g_norm + wd * p_norm + self._epsilon)
        use_lars = (p_norm > 0) & (g_norm > 0) & (wd > 0)
        local_lr = torch.where(use_lars, lars_lr,
                               torch.full_like(lars_lr, lr))
        v = self._momentum * slots["velocity"] + local_lr * (g + wd * p32)
        new_p = p32 - v
        return new_p.to(param.dtype), {"velocity": v}

    def _is_excluded(self, name) -> bool:
        return any(s in (name or "") for s in self._exclude_names)

    def _update_for(self, name, param=None):
        if not self._is_excluded(name):
            return self._update
        return self._no_wd_update("_lars_weight_decay")
