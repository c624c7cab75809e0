"""The compiled-step API of the JAX package, run eagerly: ``TrainStep``
(counterpart of ``paddle_tpu.jit``)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
