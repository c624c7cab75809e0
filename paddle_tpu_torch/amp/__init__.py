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
``multi_precision`` (f32 master weights). :class:`GradScaler` is the JAX
package's dynamic loss scaling, the same state machine (float16 needs it;
bf16 has f32's exponent range).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_state", "cast_inputs", "decorate",
           "GradScaler", "AmpScaler", "WHITE_LIST", "BLACK_LIST"]

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


@contextlib.contextmanager
def with_state(st):
    """Reinstall a policy snapshotted with :func:`amp_state` (a recomputed
    forward runs after its ``auto_cast`` block has exited, and on CUDA in
    autograd's own thread: it must cast as the forward did)."""
    prev = amp_state()
    _state.amp = st
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


class GradScaler:
    """Dynamic loss scaling, the JAX package's ``GradScaler`` (paddle's
    ``amp.GradScaler``): ``scaler.scale(loss).backward();
    scaler.step(opt); scaler.update()`` or ``scaler.minimize(opt,
    scaled_loss)``.

    ``unscale_(opt)`` (once per optimizer per step; later calls in the same
    step do nothing) multiplies every gradient by ``1 / scale`` in place
    and finds whether any is not finite with one reduction over all of
    them, read on the host once, by ``step``. ``step`` skips the update of
    a step with a non-finite gradient (parameters and slots untouched) and
    calls ``update``: ``decr_every_n_nan_or_inf`` bad steps in a row scale
    by ``decr_ratio`` (never below 1.0), ``incr_every_n_steps`` good ones
    in a row by ``incr_ratio``; each kind of step resets the other's
    count. ``load_state_dict`` restores the scale and both counts (the JAX
    package restores the scale alone)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every = int(incr_every_n_steps)
        self._decr_every = int(decr_every_n_nan_or_inf)
        self._dynamic = bool(use_dynamic_loss_scaling)
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = set()  # ids of the optimizers unscaled this step

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer) -> None:
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        self._found_inf = False
        if not grads:
            return
        inv = 1.0 / self._scale
        with torch.no_grad():
            for g in grads:
                g.mul_(inv)
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
        # one device-wide reduction, read by step()
        self._found_inf = ~finite.all()

    def _step_is_bad(self) -> bool:
        if isinstance(self._found_inf, torch.Tensor):
            self._found_inf = bool(self._found_inf)
        return self._found_inf

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._step_is_bad():
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)

    def update(self) -> None:
        self._unscaled.clear()
        if not (self._enable and self._dynamic):
            return
        if self._step_is_bad():
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self) -> bool:
        return self._enable

    def get_loss_scaling(self) -> float:
        return self._scale

    def state_dict(self) -> dict:
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd) -> None:
        self._scale = float(sd.get("scale", self._scale))
        self._good_steps = int(sd.get("good_steps", self._good_steps))
        self._bad_steps = int(sd.get("bad_steps", self._bad_steps))


AmpScaler = GradScaler
