"""Optimizers and schedulers (counterpart of ``paddle_tpu.optimizer``)."""
from . import lr
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
