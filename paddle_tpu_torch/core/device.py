"""Device resolution for the port (counterpart of ``paddle_tpu/core/device.py``).

Every entry point of the port takes an explicit ``device``. It defaults to
``"cuda"`` and raises when no CUDA device is present: the port never moves
to the CPU on its own. ``"cpu"`` runs the plain PyTorch versions of the
kernels and is there for tests, only when the caller asks for it.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a concrete ``torch.device`` (``cuda`` gains the current
    device index). Raises ``RuntimeError`` for CUDA without a CUDA device and
    ``ValueError`` for a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
