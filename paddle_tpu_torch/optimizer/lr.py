"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``).

A scheduler is stepped by the caller (``sched.step()`` after each training
step, or ``ReduceOnPlateau.step(metric)``); the optimizer reads ``sched()``
at each update. The arithmetic is the JAX package's, in Python floats.
``state_dict()`` holds every attribute that is a number, a string, a bool
or a list (so a wrapped scheduler, a function or a ``None`` is left out, as
in the JAX package); ``set_state_dict`` writes them back.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "CosineAnnealingDecay", "CosineAnnealingWarmRestarts",
           "ReduceOnPlateau", "OneCycleLR", "MultiplicativeDecay", "CyclicLR"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.last_lr = learning_rate
        self.verbose = verbose
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def __call__(self):
        return self.last_lr

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state) -> None:
        self.__dict__.update(state)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries, self.values = boundaries, values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps, self.end_lr = decay_steps, end_lr
        self.power, self.cycle = power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(max(step, 1) / self.decay_steps)
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr)
                * ((1 - step / decay_steps) ** self.power) + self.end_lr)


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate``: a number, or a scheduler stepped to epoch
    ``last_epoch - warmup_steps`` at each step."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps, self.start_lr, self.end_lr = (warmup_steps,
                                                         start_lr, end_lr)
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return ((self.end_lr - self.start_lr) * self.last_epoch
                    / self.warmup_steps + self.start_lr)
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after()
        return self.lr_after


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones, self.gamma = milestones, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch
                                              // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1, verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t, ti = self.last_epoch, self.T_0
        while t >= ti:
            t -= ti
            ti *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / ti)) / 2


class ReduceOnPlateau(LRScheduler):
    """Scales the LR by ``factor`` once ``patience`` steps of
    ``step(metric)`` passed without improvement (``mode`` min or max,
    ``threshold_mode`` rel or abs), then waits ``cooldown`` steps.
    ``step()`` without a metric only counts the epoch."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self.last_lr if hasattr(self, "last_lr") else self.base_lr

    def _better(self, cur) -> bool:
        if self.threshold_mode == "abs":
            if self.mode == "min":
                return cur < self.best - self.threshold
            return cur > self.best + self.threshold
        if self.mode == "min":
            return cur < self.best * (1 - self.threshold)
        return cur > self.best * (1 + self.threshold)

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            self.last_epoch += 1
            return
        cur = float(metrics.item() if hasattr(metrics, "item") else metrics)
        if self.best is None:
            self.best = cur
        elif self._better(cur):
            self.best = cur
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_epoch += 1


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        up = int(self.total_steps * self.phase_pct)
        step = min(self.last_epoch, self.total_steps)
        if step <= up and up > 0:
            pct = step / up
            return self.initial_lr + (self.max_lr - self.initial_lr) * (
                1 - math.cos(math.pi * pct)) / 2
        pct = (step - up) / max(self.total_steps - up, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * (
            1 + math.cos(math.pi * pct)) / 2


class MultiplicativeDecay(LRScheduler):
    """``lr *= lr_lambda(epoch)`` at each step."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            return self.last_lr * self.lr_lambda(self.last_epoch)
        return self.base_lr


class CyclicLR(LRScheduler):
    """Triangular, triangular2 or exp_range cycles between
    ``base_learning_rate`` and ``max_learning_rate``, or ``scale_fn`` of
    the cycle (``scale_mode="cycle"``) or the iteration."""

    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_size_up + self.step_size_down
        it = max(self.last_epoch, 0)
        cycle = it // total
        pos = it - cycle * total
        if pos < self.step_size_up:
            frac = pos / self.step_size_up
        else:
            frac = 1.0 - (pos - self.step_size_up) / self.step_size_down
        amp = (self.max_lr - self.base_lr) * frac
        if self.scale_fn is not None:
            x = cycle + 1 if self.scale_mode == "cycle" else it
            return self.base_lr + amp * self.scale_fn(x)
        if self.mode == "triangular2":
            amp = amp / (2.0 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** it)
        return self.base_lr + amp
