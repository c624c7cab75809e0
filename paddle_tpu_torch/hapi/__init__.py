"""``paddle.hapi``: the high-level ``Model`` and its callbacks
(counterpart of ``paddle_tpu.hapi``)."""
from .callbacks import (Callback, EarlyStopping, LRScheduler, ModelCheckpoint,
                        ProgBarLogger)
from .model import Model, summary

__all__ = ["Callback", "EarlyStopping", "LRScheduler", "ModelCheckpoint",
           "ProgBarLogger", "Model", "summary"]
