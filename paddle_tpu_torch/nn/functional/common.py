"""Dropout functionals (counterpart of the dropout part of
``paddle_tpu/nn/functional/common.py``): dropout, its axis forms and
alpha dropout.

Each live draw takes one key from
:func:`paddle_tpu_torch.core.rng.next_key` (a split of the global key on
x's device, or the next fold of an enclosing ``key_guard``) and runs
:func:`paddle_tpu_torch.ops.dropout.dropout`: the hand-written kernel on
a CUDA tensor, its plain version on the CPU, with the JAX package's keep
mask bit for bit. In eval mode or at ``p == 0`` no
key is drawn, as in the JAX package: a serving step never draws.
"""
from __future__ import annotations

from ...core import rng
from ...ops import dropout as dropout_op

__all__ = ["dropout", "dropout2d", "dropout3d", "alpha_dropout"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train"):
    """paddle's ``dropout``: ``upscale_in_train`` keeps ``x / (1 - p)``
    while training and passes ``x`` in eval; ``downscale_in_infer`` keeps
    ``x`` while training and scales by ``1 - p`` (rounded to x's dtype) in
    eval. ``axis`` draws one keep decision per index of those dimensions,
    broadcast over the others."""
    if mode not in _MODES:
        raise ValueError(f"unsupported dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and p != 0.0:
            # a product of two values of x's dtype, rounded once
            return x * float(dropout_op.rounded_to(1.0 - float(p), x.dtype))
        return x
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return dropout_op.dropout(x, rng.next_key(x.device), float(p), ax,
                              mode == "upscale_in_train")


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """One keep decision per (sample, channel) of a 4-D input."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    """One keep decision per (sample, channel) of a 5-D input."""
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p: float = 0.5, training: bool = True):
    """paddle's ``alpha_dropout``: the SELU-preserving dropout, ``a *
    where(keep, x, alpha_p) + b`` under one key, on the dropout kernel's
    alpha form (:func:`paddle_tpu_torch.ops.dropout.alpha_dropout`). In
    eval mode or at ``p == 0`` it returns ``x`` and draws no key."""
    if not training or p == 0.0:
        return x
    return dropout_op.alpha_dropout(x, rng.next_key(x.device), float(p))
