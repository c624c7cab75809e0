"""``paddle.framework``: save/load and the RNG-state aliases (counterpart of
``paddle_tpu.framework``)."""
from . import io, random
from .io import load, save

__all__ = ["io", "random", "save", "load"]
