"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``).

Only the schedulers of the training slice are ported. A scheduler is
stepped by the caller (``sched.step()`` after each training step); the
optimizer reads ``sched()`` at each update.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "CosineAnnealingDecay", "LinearWarmup"]


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


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a number or a scheduler stepped from 0)."""

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


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
