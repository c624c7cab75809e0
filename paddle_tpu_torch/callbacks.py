"""``paddle.callbacks``: the hapi training callbacks under their public
alias (counterpart of ``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (Callback, CallbackList, EarlyStopping,
                             LRScheduler, ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, VisualDL, WandbCallback)

__all__ = ["Callback", "CallbackList", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger", "ReduceLROnPlateau",
           "VisualDL", "WandbCallback"]
