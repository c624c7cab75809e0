"""Dropout under JAX's threefry keys (counterpart of the XLA ops of
``paddle_tpu/nn/functional/common.py:dropout`` and
``paddle_tpu/nn/functional/attention.py:_prob_dropout``).

One kernel, ``drop::dropout_kernel`` of ``csrc/dropout.cu``, behind
:func:`dropout_apply`, with its plain PyTorch version :func:`dropout_ref`
beside it under the same signature. Both compute, for a key ``[2]`` (two
uint32 words in int64) and a Python ``p``:

* ``keep = bernoulli(key, 1 - p, mask_shape)`` (``core.rng.bernoulli``:
  ``uniform < float32(1 - p)``), ``mask_shape`` x's shape or, in the axis
  form, x's shape with every dimension outside ``axis`` set to 1;
* ``upscale_in_train``: ``y = keep ? x * scale : 0``, the product in
  float32 rounded once to x's dtype; ``downscale_in_infer`` (training):
  ``y = keep ? x : 0``.

``scale`` is :func:`upscale_factor`: the float32 number the JAX package's
program multiplies by. XLA rewrites ``x / (1 - p)`` with its weak-typed
divisor as a product with the divisor's reciprocal, computed in float32
for float32 and bfloat16 (of ``1 - p`` rounded to bfloat16 first) and in
float16 for float16; the port multiplies by the same number, so both are
bit-equal to the JAX package on the CPU in all three dtypes.

:class:`Dropout` is the ``torch.autograd.Function``: its backward is the
same computation on the upstream gradient under the same key (the JAX
gradient of ``where(keep, x * scale, 0)``); it keeps the key and ``p``,
never a mask.

Route: a wrapper runs its plain version only because its tensor lies on
the CPU. On a CUDA tensor it launches the kernel (built on first use by
:mod:`._build`) or raises. ``launches["dropout"]`` counts kernel launches.
The alpha form (:func:`alpha_dropout_apply`, plain version
:func:`alpha_dropout_ref`, Function :class:`AlphaDropout`) is the kernel's
third mode, under the same keep mask: ``keep ? a * x + b : fill`` with the
JAX package's SELU constants (:func:`alpha_constants`). Its bits are the
JAX package's compiled program's on the CPU, found by test: a kept element
is ``fma(a, x, b)`` rounded once in float32 and float16, and
``bf16(bf16(a * x) + b)`` in bfloat16; ``a``, ``b`` and ``alpha_p`` are
rounded to x's dtype first (they are weak-typed Python floats), and a
dropped element is the folded constant ``T(T(a * alpha_p) + b)``. Its
gradient is ``a * keep * g``: the upscale form on ``g`` with scale ``a``.

A mesh's box: under GSPMD the JAX package draws the whole tensor's bits,
and a rank holds a box of the whole tensor (its batch rows on the data
axis, its heads of the attention probabilities on the model axis). A
``box`` (the whole tensor's shape and the box's offsets, from the
:func:`box` contexts the data-parallel wrapper, ``TrainStep`` and a split
attention enter) makes each element's counter its flat index in the whole
tensor: the kernel maps a local index through the whole tensor's strides
from a base counter, and the plain version slices the whole mask.

Bound on an H100 SXM: the integer operations of threefry (about 75 a mask
element, see the source), not the bytes.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from ..core import rng

__all__ = ["dropout_apply", "dropout_ref", "Dropout", "dropout", "box",
           "box_state", "with_box_state", "box_of", "thread_launches",
           "alpha_dropout_apply", "alpha_dropout_ref", "AlphaDropout",
           "alpha_dropout", "alpha_constants", "mask_shape",
           "upscale_factor", "launches", "reset_launches", "load_kernels"]

#: kernel launches, one per launch (``alpha_dropout``: alpha dropout's,
#: forward and backward; they count under ``dropout`` too)
launches = {"dropout": 0, "alpha_dropout": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16}
MAX_DIMS = 8
_lib = None


_tl = threading.local()


def thread_launches() -> dict:
    """The calling thread's own launches (a rank run as a thread reads
    its share of :data:`launches` here)."""
    counts = getattr(_tl, "launches", None)
    if counts is None:
        counts = _tl.launches = dict.fromkeys(launches, 0)
    return counts


def _count(name: str) -> None:
    launches[name] += 1
    thread_launches()[name] += 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    counts = thread_launches()
    for k in counts:
        counts[k] = 0


def box_state() -> dict:
    """The calling thread's box dimensions: ``{dim: (offset, whole,
    local)}``."""
    return dict(getattr(_tl, "box", None) or {})


@contextlib.contextmanager
def with_box_state(state: dict):
    """Inside the block the box dimensions are exactly ``state`` (a
    recompute reinstates its forward's)."""
    prev = getattr(_tl, "box", None)
    _tl.box = dict(state)
    try:
        yield
    finally:
        _tl.box = prev


def box(dims: dict):
    """A context in which every draw's mask is a box of a whole tensor:
    along each ``dim`` of ``dims`` (``dim -> (offset, whole, local)``) the
    drawn tensor holds ``local`` indices at ``offset`` of ``whole``."""
    return with_box_state({**box_state(), **dims})


def box_of(shape):
    """``(whole shape, offsets)`` of a draw of ``shape`` under the current
    box, or None outside one. A boxed dimension whose size is not the
    box's ``local`` raises: that draw is not over the boxed layout."""
    dims = box_state()
    if not dims:
        return None
    whole, offs = list(shape), [0] * len(shape)
    for d, (off, tot, local) in dims.items():
        if d >= len(shape):
            continue
        if shape[d] != local:
            raise ValueError(f"a dropout draw of shape {tuple(shape)} under "
                             f"a box of {local} of {tot} along dim {d}: "
                             "only tensors laid out as the box draw inside "
                             "it")
        whole[d], offs[d] = int(tot), int(off)
    if tuple(whole) == tuple(shape):
        return None
    return tuple(whole), tuple(offs)


def load_kernels() -> ctypes.CDLL:
    """Build (on first use) and load the CUDA library; bind its launcher."""
    global _lib
    if _lib is None:
        from ._build import library

        lib = library("dropout")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        lib.dropout_launch.argtypes = [i32, ptr, ptr, ptr, i64, f32, f32,
                                       f32, f32, i32, i32, ptr, ptr, i64,
                                       ptr]
        lib.dropout_launch.restype = i32
        _lib = lib
    return _lib


def mask_shape(shape, axis=None) -> tuple:
    """The keep mask's shape: ``shape``, or with ``axis`` (an int or a
    sequence) every other dimension set to 1."""
    shape = tuple(int(s) for s in shape)
    if axis is None:
        return shape
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    kept = {a % len(shape) for a in axes}
    return tuple(s if i in kept else 1 for i, s in enumerate(shape))


def rounded_to(value: float, dtype: torch.dtype) -> np.float32:
    """``value`` rounded to ``dtype``, as a float32."""
    if dtype == torch.bfloat16:
        return np.float32(torch.tensor(value, dtype=torch.float32)
                          .to(torch.bfloat16).item())
    return np.float32(_NP_DTYPES[dtype](value))


@functools.lru_cache(maxsize=64)
def upscale_factor(p: float, dtype: torch.dtype) -> float:
    """The float32 factor of ``upscale_in_train`` for x of ``dtype``: the
    reciprocal of ``1 - p`` rounded to ``dtype``, taken in float32
    (float32, bfloat16) or rounded to float16 (float16)."""
    recip = np.float32(1.0) / rounded_to(1.0 - p, dtype)
    if dtype == torch.float16:
        recip = np.float32(np.float16(recip))
    return float(recip)


def keep_threshold(p: float) -> float:
    """``float32(1 - p)``, the bernoulli threshold of the keep mask."""
    return float(np.float32(1.0 - p))


def _refuse_box_axis(axis, box_) -> None:
    if box_ is not None and axis is not None:
        raise NotImplementedError("the axis form of dropout inside a "
                                  "mesh's box is not ported")


def dropout_ref(x, key, p: float, axis=None, upscale: bool = True,
                box=None):
    """Plain version: the keep mask from :func:`core.rng.bernoulli` (the
    whole tensor's mask sliced to the ``box``, when one is given), then
    the select and the scale in PyTorch ops."""
    _refuse_box_axis(axis, box)
    if box is not None:
        whole, offs = box
        keep = rng.bernoulli(key.to(x.device), 1.0 - p, whole)[tuple(
            slice(o, o + n) for o, n in zip(offs, x.shape))]
    else:
        keep = rng.bernoulli(key.to(x.device), 1.0 - p,
                             mask_shape(x.shape, axis))
    y = (x.float() * upscale_factor(p, x.dtype)).to(x.dtype) if upscale \
        else x
    return torch.where(keep, y, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


#: the kernel's forms (its template modes)
_DOWNSCALE, _UPSCALE, _ALPHA = 0, 1, 2


def _launch(x, key, p: float, axis, upscale: bool, alpha=None, scale=None,
            box=None):
    """Check what the kernel takes, launch it on the current stream and
    return y. ``alpha``: the alpha form's ``(a, b, fill)``, rounded to x's
    dtype (then ``axis`` must be None and ``upscale`` is not read);
    ``scale``: the upscale form's factor in place of
    :func:`upscale_factor`; ``box``: the whole tensor's shape and x's
    offsets in it (the counters are the whole tensor's flat indices)."""
    _refuse_box_axis(axis, box)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the dropout kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    n = x.numel()
    counted = n if box is None else int(np.prod(box[0]))
    if counted >= 2 ** 32:
        raise ValueError(f"the dropout kernel's counters are 32-bit: fewer "
                         f"than 2**32 elements, got {counted}")
    if x.dim() > MAX_DIMS:
        raise ValueError(f"at most {MAX_DIMS} dimensions, got {x.dim()}")
    key = key.to(device=x.device, dtype=torch.int64).contiguous()
    if key.shape != (2,):
        raise ValueError(f"a key is two words, got {tuple(key.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        # a view at an odd offset: the kernel reads and writes 16-byte packs
        # (y, a fresh allocation, is aligned)
        x = x.clone()
    y = torch.empty_like(x)
    ndim, shape, mstride, base = 0, None, None, 0
    if box is not None:
        whole, offs = box
        strides = [1] * len(whole)
        for d in range(len(whole) - 2, -1, -1):
            strides[d] = strides[d + 1] * int(whole[d + 1])
        base = sum(int(o) * st for o, st in zip(offs, strides))
        ndim = x.dim()
        shape = (ctypes.c_longlong * ndim)(*x.shape)
        mstride = (ctypes.c_longlong * ndim)(*strides)
    elif axis is not None:
        ms = mask_shape(x.shape, axis)
        strides = [0] * len(ms)
        acc = 1
        for d in range(len(ms) - 1, -1, -1):
            strides[d] = acc if ms[d] > 1 else 0
            acc *= ms[d]
        ndim = x.dim()
        shape = (ctypes.c_longlong * ndim)(*x.shape)
        mstride = (ctypes.c_longlong * ndim)(*strides)
    if alpha is not None:
        mode, (scale, shift, fill) = _ALPHA, alpha
    else:
        mode = _UPSCALE if upscale else _DOWNSCALE
        if scale is None:
            scale = upscale_factor(p, x.dtype) if upscale else 1.0
        shift = fill = 0.0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = load_kernels().dropout_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), key.data_ptr(), n,
        keep_threshold(p), scale, shift, fill, mode, ndim, shape, mstride,
        base, stream)
    if rc != 0:
        raise RuntimeError(f"dropout_launch failed: CUDA error {rc}")
    _count("dropout")
    if alpha is not None:
        _count("alpha_dropout")
    return y


def dropout_apply(x, key, p: float, axis=None, upscale: bool = True,
                  box=None):
    """``keep ? x * scale : 0`` (``upscale``) or ``keep ? x : 0`` under
    ``key`` (over the ``box`` of a whole tensor, when one is given): the
    plain version on the CPU, the kernel on a CUDA device. No gradient
    (see :class:`Dropout`)."""
    if x.device.type == "cpu":
        return dropout_ref(x, key, p, axis, upscale, box)
    return _launch(x, key, p, axis, upscale, None, None, box)


class Dropout(torch.autograd.Function):
    """``dropout_apply`` with its gradient: the same function of the
    upstream gradient under the same key. Keeps the key, ``p`` and the
    box."""

    @staticmethod
    def forward(ctx, x, key, p, axis, upscale, box_):
        ctx.key, ctx.args = key, (p, axis, upscale, box_)
        return dropout_apply(x, key, p, axis, upscale, box_)

    @staticmethod
    def backward(ctx, g):
        return (dropout_apply(g, ctx.key, *ctx.args), None, None, None, None,
                None)


def dropout(x, key, p: float, axis=None, upscale: bool = True):
    """Differentiable dropout of ``x`` under ``key`` (see the module
    docstring), over the current :func:`box` of a whole tensor."""
    return Dropout.apply(x, key, float(p), axis, bool(upscale),
                         box_of(x.shape))


# ----------------------------------------------------------- alpha dropout

SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805


@functools.lru_cache(maxsize=64)
def alpha_constants(p: float, dtype: torch.dtype):
    """``(a, b, fill)`` of the alpha form for x of ``dtype``, each a
    float32 value of that dtype: the JAX package's ``a`` and ``b`` rounded
    to it, and ``fill = T(T(a * alpha_p) + b)`` from the rounded
    ``alpha_p``."""
    alpha_p = -SELU_ALPHA * SELU_SCALE
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    a_t, b_t, ap_t = (rounded_to(v, dtype) for v in (a, b, alpha_p))
    fill = rounded_to(float(rounded_to(float(a_t * ap_t), dtype) + b_t),
                      dtype)
    return float(a_t), float(b_t), float(fill)


def _fma_f32(a: float, x, b: float):
    """``fma(a, x, b)`` of float32 ``x``, rounded once to float32: the
    product is exact in float64, the sum is taken exactly as a float64 and
    its rounding error (TwoSum), the float64 is made round-to-odd, whose
    rounding to float32 is the correctly rounded result."""
    p = x.double() * a
    d = p + b
    bb = d - p
    err = (p - (d - bb)) + (b - bb)
    even = (d.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(d, float("inf")),
                         torch.full_like(d, float("-inf")))
    odd = torch.where((err != 0) & even & torch.isfinite(d),
                      torch.nextafter(d, toward), d)
    return odd.float()


def alpha_dropout_ref(x, key, p: float):
    """Plain version of the alpha form: the keep mask from
    :func:`core.rng.bernoulli`, then the dtype's rule in PyTorch ops."""
    keep = rng.bernoulli(key.to(x.device), 1.0 - p, tuple(x.shape))
    a, b, fill = alpha_constants(p, x.dtype)
    xf = x.float()
    if x.dtype == torch.bfloat16:
        kept = (xf * a).to(torch.bfloat16).float() + b
    elif x.dtype == torch.float16:
        kept = xf * a + b  # the product is exact in float32
    else:
        kept = _fma_f32(a, xf, b)
    return torch.where(keep, kept, torch.full_like(kept, fill)).to(x.dtype)


def _alpha_grad_ref(g, key, p: float):
    """``a * keep * g``: the upscale form's plain version with scale a."""
    keep = rng.bernoulli(key.to(g.device), 1.0 - p, tuple(g.shape))
    a = alpha_constants(p, g.dtype)[0]
    return torch.where(keep, (g.float() * a).to(g.dtype),
                       torch.zeros((), dtype=g.dtype, device=g.device))


def alpha_dropout_apply(x, key, p: float):
    """The alpha form under ``key``: the plain version on the CPU, the
    kernel on a CUDA device. No gradient (see :class:`AlphaDropout`)."""
    if x.device.type == "cpu":
        return alpha_dropout_ref(x, key, p)
    return _launch(x, key, p, None, True, alpha_constants(p, x.dtype))


def _alpha_grad_apply(g, key, p: float):
    """``a * keep * g``: the kernel's upscale form with scale a (a product,
    not the affine with b = 0: ``-0 * a`` stays -0, as in JAX's
    gradient)."""
    if g.device.type == "cpu":
        return _alpha_grad_ref(g, key, p)
    y = _launch(g, key, p, None, True, scale=alpha_constants(p, g.dtype)[0])
    _count("alpha_dropout")
    return y


class AlphaDropout(torch.autograd.Function):
    """``alpha_dropout_apply`` with its gradient ``a * keep * g`` (the
    kernel's upscale form on g with scale a). Keeps the key and ``p``."""

    @staticmethod
    def forward(ctx, x, key, p):
        ctx.key, ctx.p = key, p
        return alpha_dropout_apply(x, key, p)

    @staticmethod
    def backward(ctx, g):
        return _alpha_grad_apply(g, ctx.key, ctx.p), None, None


def alpha_dropout(x, key, p: float):
    """Differentiable alpha dropout of ``x`` under ``key``."""
    return AlphaDropout.apply(x, key, float(p))
