"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``).

``auto_cast`` sets a per-thread policy; the port's layers consult it at
the op boundaries the JAX package names (``linear``, ``linear_nb``,
``matmul``, ``ln``, ``softmax``, ``sdpa``, ``ce``) through
:func:`cast_inputs`, which applies the JAX package's cast rule
(``_cast_inputs_with``): a black-listed op promotes inputs of the AMP
dtype to f32; a white-listed op, or any named op under O2, casts f32
inputs to the AMP dtype. ``torch.autocast`` is not used: its lists differ
from paddle's, so the dtype reaching attention and the loss would differ.
:func:`decorate` casts parameters (O2) and switches optimizers to
``multi_precision`` (f32 master weights). ``GradScaler`` is not ported yet
(bf16 has f32's exponent range and needs no loss scaling).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_state", "cast_inputs", "decorate",
           "WHITE_LIST", "BLACK_LIST"]

_state = threading.local()

# ops that benefit from low precision (matrix products)
WHITE_LIST = {"matmul", "conv", "conv2d", "conv1d", "conv3d", "einsum", "mm",
              "bmm", "addmm", "linear", "linear_nb", "chunked_lm_loss"}
# ops that need f32 accumulate / range
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax", "log_softmax", "ce", "bce", "bcel",
    "mse", "nll", "kl", "cumsum", "cumprod", "norm", "mean", "sum", "var", "std", "pow",
    "ln", "ln_nw", "bn", "rms", "rms_nw",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"AMP dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


def amp_state():
    return getattr(_state, "amp", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast: within the block, ops cast their inputs by
    the white/black lists (O1) or cast every f32 input outside the black
    list (O2)."""
    if level not in ("O0", "OD", "O1", "O2"):
        raise ValueError(f"bad amp level {level}")
    prev = amp_state()
    if not enable or level == "O0":
        _state.amp = None
    else:
        white = set(WHITE_LIST)
        black = set(BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        _state.amp = {"level": level, "dtype": _dtype(dtype),
                      "white": white, "black": black}
    try:
        yield
    finally:
        _state.amp = prev


def cast_inputs(name: str, *tensors):
    """The inputs of op ``name`` cast by the active policy (unchanged
    without one), as a tuple. ``None`` entries pass through."""
    st = amp_state()
    if st is None:
        return tensors
    dtype = st["dtype"]
    if name in st["black"]:
        return tuple(t.float() if t is not None and t.dtype == dtype else t
                     for t in tensors)
    if name in st["white"] or st["level"] == "O2":
        return tuple(t.to(dtype) if t is not None and t.dtype == torch.float32
                     else t for t in tensors)
    return tensors


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """Cast the models' floating parameters to the AMP dtype and, at O2,
    switch the optimizers to ``multi_precision`` so each low-precision
    parameter trains against an f32 ``master_weight`` slot
    (``master_weight=None`` means on, as in the JAX package)."""
    dt = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    with torch.no_grad():
        for m in ms:
            if m is None:
                continue
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    opts = [] if optimizers is None else (
        [optimizers] if not isinstance(optimizers, (list, tuple))
        else list(optimizers))
    if level == "O2":
        for opt in opts:
            if opt is not None:
                opt._multi_precision = (True if master_weight is None
                                        else bool(master_weight))
    if optimizers is None:
        return models if single else ms
    return (models, optimizers) if single else (ms, optimizers)
