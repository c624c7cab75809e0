"""Symmetric int8 quantizers of the serving path (counterpart of the three
primitives of ``paddle_tpu/quantization/__init__.py``: ``quantize_weight``,
``quantize_kv`` and ``dequantize_kv``). QAT and PTQ are not ported yet.

The math is the JAX package's, bit for bit:

    scale = max(amax, 1e-9) / 127
    q     = clip(round(x / scale), -128, 127)      (round half to even)
    dq    = (float32(q) * scale) cast once to the compute dtype

Both divisions are true divisions, not multiplies by a reciprocal.
PyTorch's CUDA kernel divides by a Python number as a multiply by its
reciprocal, which rounds some scales differently, so the 127 is a tensor
on the operand's device (:func:`_scale`). The JAX package quantizes weights
with numpy on the host: a bf16 weight's absmax is exact in bf16, and
``np.maximum(amax, 1e-9)`` promotes it to float32, so its scale and the
division run in float32. Here every weight is
quantized in float32 from the start, which gives the same int8 payloads and
float32 scales for float32 and bf16 weights, on the CPU and on a CUDA
device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["quantize_weight", "quantize_kv", "dequantize_kv"]

_Q_MAX = {}  # device -> 127.0 as a 0-dim float32 tensor there


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-9) / 127`` in float32, divided on every device. The
    divisor is made on the device by a fill, without a host copy, once per
    device; a serving engine's warm-up makes it before any capture."""
    # analysis: allow(mutable-global-capture) — a per-device constant made
    # once and never changed: a captured step bakes in its address, which
    # this table keeps alive
    q_max = _Q_MAX.get(amax.device)
    if q_max is None:
        q_max = _Q_MAX[amax.device] = torch.full(
            (), 127.0, dtype=torch.float32, device=amax.device)
    return torch.clamp_min(amax, 1e-9) / q_max


def quantize_weight(w: torch.Tensor, channel_axis: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float weight -> ``(int8 weight, float32 scale)``, per tensor or, with
    ``channel_axis`` (negative counts from the end), per channel. The scale
    keeps that axis (``keepdim``) so dequantization is a broadcast multiply.
    The arithmetic runs in float32 on ``w``'s device."""
    w = w.float()
    if channel_axis is None:
        amax = w.abs().amax()
    else:
        axis = channel_axis % w.dim()
        amax = w.abs().amax(dim=tuple(i for i in range(w.dim()) if i != axis),
                            keepdim=True)
    scale = _scale(amax)
    q = torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 quantization of a K/V chunk ``[..., heads, head_dim]``:
    one float32 scale per leading index, reduced over ``(heads, head_dim)``
    in float32. Returns ``(int8 payload, float32 scale[...])``."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=(-2, -1)))
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -128, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: the float32 product of payload and
    per-token scale, cast once to the compute ``dtype`` (a bf16 result rounds
    once, not twice). The paged kernels' int8 variants apply the same two
    steps to each element they load."""
    return (q.float() * scale[..., None, None]).to(dtype)
