"""Flash attention forward and backward (counterpart of the flash part of
``paddle_tpu/ops/pallas_ops.py``).

Three kernels, each behind a wrapper with its plain PyTorch version beside
it under the same signature:

* :func:`flash_forward` / :func:`flash_forward_ref` -- ``(o, lse)``;
  replaces ``pallas_ops.py:_flash_fwd_kernel``.
* :func:`flash_backward_dkv` / :func:`flash_backward_dkv_ref` --
  ``(dk, dv)``; replaces ``pallas_ops.py:_flash_bwd_dkv_kernel``.
* :func:`flash_backward_dq` / :func:`flash_backward_dq_ref` -- ``dq``;
  replaces ``pallas_ops.py:_flash_bwd_dq_kernel``.

:class:`FlashAttention` (a ``torch.autograd.Function``) stands for the
``_flash_attention`` custom_vjp: its forward saves q, k, v, o and lse, its
backward computes ``delta = rowsum(dO * O)`` in f32 with plain torch ops
(the JAX package computes it outside the kernels too) and launches the
dK/dV kernel, then the dQ kernel. :func:`flash_attention` is the public
entry with the JAX package's ``_shapes_ok`` gate: other shapes take
:func:`_attention_reference`, decided by shape alone.

Layouts are the public ``[batch, seq, heads, head_dim]``; ``lse`` and
``delta`` are ``[batch, heads, sq]`` f32 (the TPU's 128-lane broadcast of
these residuals is not kept). The kernels read the qkv split's strided
views in place: only each row's ``head_dim`` must be dense.

Route: a wrapper runs its plain version only because its tensors lie on the
CPU. On a CUDA tensor it launches the hand-written kernel of
``csrc/flash_attention.cu`` (built on first use by :mod:`._build`) or
raises; nothing falls back. ``launches`` counts kernel launches per kernel.

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the training path's
``[b, 2048, 16, 128]`` every kernel does hundreds of FLOPs per byte it must
move, so all three are bound by operations. bf16 at head_dim 64 and 128
runs on the tensor cores: all three kernels with TMA loads and ``wgmma``
(a producer warp and two consumer warpgroups); f32, float16, and bf16 at
head_dim 256, on CUDA cores (see the source). The TMA maps need each
operand's start and its batch, row and head strides 16-byte aligned, which
:func:`_rows16` provides for q, k, v and dO.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention", "FlashAttention", "flash_forward",
           "flash_backward_dkv", "flash_backward_dq", "flash_forward_ref",
           "flash_backward_dkv_ref", "flash_backward_dq_ref", "launches",
           "reset_launches", "load_kernels"]

NEG_INF = -1e30  # the Pallas kernels' finite mask value

#: kernel launches, one per launch of each CUDA kernel
launches = {"flash_forward": 0, "flash_backward_dkv": 0,
            "flash_backward_dq": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128, 256)
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (on first use) and load the CUDA library; bind its launchers."""
    global _lib
    if _lib is None:
        from ._build import library

        lib = library("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_launch.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr,
                                         ptr, i32, i32, i32, i32, f32, i32,
                                         ptr]
        bwd = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.flash_bwd_dkv_launch.argtypes = bwd + [ptr, ptr, i32, i32, i32,
                                                   i32, f32, i32, ptr]
        lib.flash_bwd_dq_launch.argtypes = bwd + [ptr, i32, i32, i32, i32,
                                                  f32, i32, ptr]
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch,
                   lib.flash_bwd_dq_launch):
            fn.restype = i32
        _lib = lib
    return _lib


# ------------------------------------------------------------ plain versions


def causal_mask(sq, sk, device):
    """Keep mask ``[sq, sk]``: row i sees key j where ``i + (sk - sq) >= j``."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def plain_attention(q, k, v, scale, mask=None, mask_value=NEG_INF):
    """The one plain attention body of the port's reference routes, layout
    ``[b, s, h, d]``: logits in the input dtype; a bool ``mask``
    (broadcasting against ``[b, h, sq, sk]``) keeps where true and sets
    ``mask_value`` rounded to the logits' dtype elsewhere (as ``jnp.where``
    does: -1e30 is -inf in float16, whose masked keys then get p = 0), any
    other mask is added to the logits; the softmax in fp32, the
    probabilities cast back before P.V."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if mask is not None and mask.dtype == torch.bool:
        fill = torch.tensor(mask_value, dtype=torch.float64)
        logits = logits.masked_fill(~mask, fill.to(logits.dtype).item())
    elif mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def _attention_reference(q, k, v, scale, causal):
    """The JAX package's fallback for shapes outside ``_shapes_ok``:
    masked logits -1e30, fp32 softmax cast back."""
    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return plain_attention(q, k, v, scale, mask)


def _scores(q, k, scale, causal):
    """f32 scores ``[b, h, sq, sk]`` of bf16/f32 inputs (exact products,
    f32 sums, as the kernels' dot products) and the keep mask (causal
    ``row + (sk - sq) >= col``)."""
    qf, kf = (t.transpose(1, 2).float() for t in (q, k))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    keep = (causal_mask(sq, sk, q.device) if causal
            else torch.ones(sq, sk, dtype=torch.bool, device=q.device))
    return s, keep


def flash_forward_ref(q, k, v, scale, causal):
    """Plain version of :func:`flash_forward`: ``o`` ``[b, sq, h, d]`` in
    q's dtype and ``lse`` ``[b, h, sq]`` f32. A row with no key gives
    o = 0 and lse = -1e30; p is rounded to v's dtype before P.V and the
    division by the row sum comes after, in f32."""
    s, keep = _scores(q, k, scale, causal)
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.transpose(1, 2).float())
    o = pv / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l > 0.0, m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      torch.full_like(l, NEG_INF))
    return o.to(q.dtype).transpose(1, 2), lse[..., 0]


def _probs_and_dscores(q, k, v, do, lse, delta, scale, causal):
    """p and ds ``[b, h, sq, sk]`` f32, recomputed from lse and delta as the
    Pallas ``_bwd_common``: rows whose lse is -1e30 (no key) get p = 0."""
    s, keep = _scores(q, k, scale, causal)
    live = keep & (lse > NEG_INF * 0.5)[..., None]
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.transpose(1, 2).float(),
                      v.transpose(1, 2).float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_backward_dkv_ref(q, k, v, do, lse, delta, scale, causal):
    """Plain version of :func:`flash_backward_dkv`: ``(dk, dv)``
    ``[b, sk, h, d]`` in k's and v's dtypes. p is rounded to dO's dtype for
    dV and ds to q's dtype for dK; sums in f32."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                      do.transpose(1, 2).float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.transpose(1, 2).float())
    return dk.to(k.dtype).transpose(1, 2), dv.to(v.dtype).transpose(1, 2)


def flash_backward_dq_ref(q, k, v, do, lse, delta, scale, causal):
    """Plain version of :func:`flash_backward_dq`: ``dq`` ``[b, sq, h, d]``
    in q's dtype; ds is rounded to k's dtype, sums in f32."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dq = torch.matmul(ds.to(k.dtype).float(), k.transpose(1, 2).float())
    return dq.to(q.dtype).transpose(1, 2)


# ----------------------------------------------------------------- kernels


def _strides(t, name, b, s, h, d):
    """(batch, row, head) strides of a ``[b, s, h, d]`` operand whose last
    dim is dense."""
    if tuple(t.shape) != (b, s, h, d) or t.stride(-1) != 1:
        raise ValueError(f"flash attention {name} {tuple(t.shape)} "
                         f"{t.stride()}: expected [{b}, {s}, {h}, {d}] with "
                         "a dense last dim")
    return [t.stride(0), t.stride(1), t.stride(2)]


def _check(q, k, v, extra):
    """Shape, dtype and device checks shared by the three launchers;
    returns ``(b, sq, sk, h, d)``."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must be "
                         "[batch, seq, heads, head_dim]")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; use one of "
                         f"{HEAD_DIMS}")
    for t in (q, k, v) + tuple(extra):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("every operand must lie on q's CUDA device")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError(f"q {q.dtype} and k/v {t.dtype} differ")
    return b, sq, sk, h, d


def _rows16(t):
    """A bf16 operand whose rows the tensor-core kernels can read 16 bytes
    at a time: its pointer and its batch, row and head strides 16-byte
    aligned. Any other bf16 operand is read from a contiguous copy."""
    if t.dtype != torch.bfloat16 or (
            t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _residual(t, name, b, h, sq):
    if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 [{b}, {h}, "
                         f"{sq}], got {t.dtype} {tuple(t.shape)}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def flash_forward(q, k, v, scale, causal):
    """Blockwise attention with an online softmax: ``(o, lse)``, o
    ``[b, sq, h, d]`` in q's dtype, lse ``[b, h, sq]`` f32."""
    if q.device.type == "cpu":
        return flash_forward_ref(q, k, v, scale, causal)
    b, sq, sk, h, d = _check(q, k, v, ())
    q, k, v = (_rows16(t) for t in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    st = (_strides(q, "q", b, sq, h, d) + _strides(k, "k", b, sk, h, d)
          + _strides(v, "v", b, sk, h, d) + [0, 0, 0]
          + _strides(o, "o", b, sq, h, d) + [0, 0, 0])
    strides = (ctypes.c_longlong * 18)(*st)
    rc = load_kernels().flash_fwd_launch(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), strides, b, h, sq, sk, float(scale),
        int(bool(causal)), _stream(q))
    _raise_on(rc, "flash_fwd_launch")
    launches["flash_forward"] += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta):
    b, sq, sk, h, d = _check(q, k, v, (do, lse, delta))
    if do.dtype != q.dtype:
        raise TypeError(f"dO {do.dtype} and q {q.dtype} differ")
    _residual(lse, "lse", b, h, sq)
    _residual(delta, "delta", b, h, sq)
    q, k, v, do = (_rows16(t) for t in (q, k, v, do))
    st = (_strides(q, "q", b, sq, h, d) + _strides(k, "k", b, sk, h, d)
          + _strides(v, "v", b, sk, h, d) + _strides(do, "dO", b, sq, h, d))
    return (b, sq, sk, h, d), (q, k, v, do), st


def flash_backward_dkv(q, k, v, do, lse, delta, scale, causal):
    """dK and dV ``[b, sk, h, d]`` (in k's and v's dtypes) from the saved
    lse and ``delta = rowsum(dO * O)`` f32 ``[b, h, sq]``."""
    if q.device.type == "cpu":
        return flash_backward_dkv_ref(q, k, v, do, lse, delta, scale, causal)
    (b, sq, sk, h, d), (q, k, v, do), st = _bwd_args(q, k, v, do, lse,
                                                     delta)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    st += (_strides(dk, "dk", b, sk, h, d) + _strides(dv, "dv", b, sk, h, d))
    strides = (ctypes.c_longlong * 18)(*st)
    rc = load_kernels().flash_bwd_dkv_launch(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), strides, b, h, sq, sk, float(scale),
        int(bool(causal)), _stream(q))
    _raise_on(rc, "flash_bwd_dkv_launch")
    launches["flash_backward_dkv"] += 1
    return dk, dv


def flash_backward_dq(q, k, v, do, lse, delta, scale, causal):
    """dQ ``[b, sq, h, d]`` in q's dtype, from the saved lse and delta."""
    if q.device.type == "cpu":
        return flash_backward_dq_ref(q, k, v, do, lse, delta, scale, causal)
    (b, sq, sk, h, d), (q, k, v, do), st = _bwd_args(q, k, v, do, lse,
                                                     delta)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    st += _strides(dq, "dq", b, sq, h, d) + [0, 0, 0]
    strides = (ctypes.c_longlong * 18)(*st)
    rc = load_kernels().flash_bwd_dq_launch(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        strides, b, h, sq, sk, float(scale), int(bool(causal)), _stream(q))
    _raise_on(rc, "flash_bwd_dq_launch")
    launches["flash_backward_dq"] += 1
    return dq


# --------------------------------------------------------------- public op


class FlashAttention(torch.autograd.Function):
    """The ``_flash_attention`` custom_vjp: forward through
    :func:`flash_forward`, backward through :func:`flash_backward_dkv` and
    :func:`flash_backward_dq`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_forward(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, ctx.scale,
                                    ctx.causal)
        dq = flash_backward_dq(q, k, v, do, lse, delta, ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None


def _shapes_ok(q, k, blk=128) -> bool:
    """The JAX package's gate (``pallas_ops.py:_shapes_ok``): d in
    {64, 128, 256}, each sequence a multiple of min(128, s) and at least
    8 long."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    return (sq % min(blk, sq) == 0 and sk % min(blk, sk) == 0
            and sq >= 8 and sk >= 8 and d in HEAD_DIMS)


def flash_attention(q, k, v, scale=None, causal=False):
    """Blockwise flash attention, layout ``[batch, seq, heads, head_dim]``,
    differentiable through :class:`FlashAttention`. Shapes outside
    :func:`_shapes_ok` take :func:`_attention_reference`, as in the JAX
    package."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _shapes_ok(q, k):
        return _attention_reference(q, k, v, scale, causal)
    return FlashAttention.apply(q, k, v, float(scale), bool(causal))
