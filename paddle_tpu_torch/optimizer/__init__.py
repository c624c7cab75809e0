"""Optimizers and schedulers (counterpart of ``paddle_tpu.optimizer``)."""
from . import lr
from .lbfgs import LBFGS
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        LarsMomentum, Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "RMSProp", "Adamax", "Lamb", "LarsMomentum", "LBFGS",
           "lr"]
