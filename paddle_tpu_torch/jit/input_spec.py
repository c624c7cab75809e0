"""``InputSpec`` (counterpart of ``paddle_tpu/jit/__init__.py:944-969``).

A dim of None or -1 is dynamic: ``jit.save`` exports it as
``torch.export.Dim.DYNAMIC``, so the saved program runs at any size of
that axis the model allows (a range the model bounds, such as GPT's
sequence under its position table, is kept as the model bounds it).
Unnamed specs share one symbol per axis (``d0``, ``d1``, ...), so the
common "every input shares the dynamic batch" case exports with those dims
constrained equal (``jit.save`` checks each tie inside the program); a
spec with ``name=`` gets symbols of its own (``<name>_0``, ...), as the
JAX package's ``SymbolicScope`` does.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["InputSpec", "torch_dtype"]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name
    (``"float32"``, ``"int64"``, ``"bfloat16"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"InputSpec dtype {dtype!r} is not a torch dtype")
    return out


class InputSpec:
    """``paddle.static.InputSpec``: a shape (None or -1 for a dynamic
    dim), a dtype and an optional name."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def symbols(self) -> dict:
        """``{axis: symbol}`` of the dynamic axes: ``d<axis>`` unnamed,
        ``<name>_<axis>`` named."""
        prefix = f"{self.name}_" if self.name else "d"
        return {i: f"{prefix}{i}" for i, s in enumerate(self.shape)
                if s is None or s < 0}

    def example(self, sizes: dict, device) -> torch.Tensor:
        """A zero tensor of this spec for tracing: each dynamic dim at the
        size of its symbol in ``sizes`` (2, 3, ... in order of first use:
        distinct, so tracing never ties two independent symbols, and never
        0 or 1, which an export specializes)."""
        syms = self.symbols()
        shape = [sizes.setdefault(syms[i], len(sizes) + 2) if i in syms
                 else int(s) for i, s in enumerate(self.shape)]
        return torch.zeros(shape, dtype=torch_dtype(self.dtype),
                           device=device)
