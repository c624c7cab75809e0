"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

A closure-driven full-batch optimizer: ``step(closure)`` evaluates the loss
(the closure runs the forward and ``loss.backward()``) again at every point
the line search probes along the two-loop-recursion direction. The history
of ``(s, y)`` pairs is kept as flat f32 tensors on the parameters' device;
the scalars of the recursion and the line search come to the host, as in
the JAX package. ``line_search_fn`` is None (one step of ``lr``, or of
``lr / ||g||_1`` on the first iteration) or ``"strong_wolfe"`` (halve on an
Armijo failure, grow by 2.1 on a curvature failure, at most 20 probes).

``state_dict`` also carries the history (``"lbfgs.s"``, ``"lbfgs.y"``:
lists of tensors), so a resumed run takes the same directions; the JAX
package's keeps only the base optimizer's entries.
"""
from __future__ import annotations

from typing import List

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _flatten(tensors):
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(f"line_search_fn must be None or "
                             f"'strong_wolfe', got {line_search_fn!r}")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []

    # -- flat views --------------------------------------------------------
    def _gather(self):
        return _flatten([p.detach() for p in self._parameter_list])

    def _grads(self):
        return _flatten([torch.zeros_like(p) if p.grad is None else p.grad
                         for p in self._parameter_list])

    @torch.no_grad()
    def _scatter(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _direction(self, flat_grad):
        """Two-loop recursion over the ``(s, y)`` history."""
        q = flat_grad
        pairs = list(zip(self._s, self._y))
        rhos = [1.0 / _dot(y, s) for s, y in pairs]
        alphas = []
        for (s, y), rho in zip(reversed(pairs), reversed(rhos)):
            a = rho * _dot(s, q)
            alphas.append(a)
            q = q - a * y
        if pairs:
            s, y = pairs[-1]
            q = q * (_dot(s, y) / max(_dot(y, y), 1e-20))
        for (s, y), rho, a in zip(pairs, rhos, reversed(alphas)):
            b = rho * _dot(y, q)
            q = q + s * (a - b)
        return -q

    def _evaluate(self, closure, x):
        self._scatter(x)
        self.clear_grad()
        return closure()

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure re-evaluating "
                             "the loss")
        lr = self.get_lr()
        loss = closure()
        loss_val = float(loss.detach())
        n_eval = 1
        for _ in range(self.max_iter):
            flat_grad = self._grads()
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            d = self._direction(flat_grad)
            x0 = self._gather()
            gtd = _dot(flat_grad, d)
            if gtd > -1e-15:  # not a descent direction: reset the history
                self._s.clear()
                self._y.clear()
                d = -flat_grad
                gtd = _dot(flat_grad, d)
            t = lr if self._y else min(
                1.0, 1.0 / max(float(flat_grad.abs().sum()), 1e-12)) * lr
            if self.line_search_fn == "strong_wolfe":
                c1, c2 = 1e-4, 0.9
                t_ok = None
                for _ls in range(20):
                    new_loss = self._evaluate(closure, x0 + t * d)
                    n_eval += 1
                    nl = float(new_loss.detach())
                    if nl > loss_val + c1 * t * gtd:
                        t *= 0.5
                    elif _dot(self._grads(), d) < c2 * gtd:
                        t *= 2.1
                    else:
                        t_ok = t
                        break
                    if n_eval >= self.max_eval:
                        break
                if t_ok is None:
                    new_loss = self._evaluate(closure, x0 + t * d)
                    n_eval += 1
            else:
                new_loss = self._evaluate(closure, x0 + t * d)
                n_eval += 1
            s = self._gather() - x0
            y = self._grads() - flat_grad
            if _dot(s, y) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            new_val = float(new_loss.detach())
            converged = abs(new_val - loss_val) < self.tolerance_change
            loss_val, loss = new_val, new_loss
            if converged or n_eval >= self.max_eval:
                break
        return loss

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            p.grad = None

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["lbfgs.s"] = [s.clone() for s in self._s]
        sd["lbfgs.y"] = [y.clone() for y in self._y]
        return sd

    def set_state_dict(self, state_dict) -> None:
        super().set_state_dict(state_dict)
        dev = (self._parameter_list[0].device if self._parameter_list
               else None)
        self._s = [torch.as_tensor(s).to(dev, torch.float32).clone()
                   for s in state_dict.get("lbfgs.s", [])]
        self._y = [torch.as_tensor(y).to(dev, torch.float32).clone()
                   for y in state_dict.get("lbfgs.y", [])]

    set_dict = set_state_dict
