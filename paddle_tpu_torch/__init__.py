"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

A package of its own beside the JAX package ``paddle_tpu``, which stays the
reference it is held against. It imports ``torch`` and numpy, never ``jax``
or anything of ``paddle_tpu``. Module names mirror the JAX package's
(``models.gpt``, ``ops.paged_attention``, ``serving.engine``, ...).

Every entry point takes an explicit ``device``, ``"cuda"`` by default; it
raises when CUDA is missing and runs on the CPU only when asked
(``device="cpu"``), where the hand-written kernels give way to their plain
PyTorch versions.
"""

from . import device, inference, jit, static
from .framework.io import load, save

__all__ = ["save", "load", "device", "inference", "jit", "static"]
