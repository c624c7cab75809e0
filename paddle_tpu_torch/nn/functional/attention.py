"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layout ``[batch, seq, heads, head_dim]``. :func:`scaled_dot_product_attention`
routes as the JAX package does, with "the tensor is on CUDA" in place of
"the backend is a TPU": at kv length at or above
``FLAGS_flash_attention_min_seqlen`` (-1 = auto, 0 = always) a CUDA tensor
takes the hand-written flash kernels (:mod:`paddle_tpu_torch.ops.
flash_attention`); everything else takes :func:`_sdpa_reference`, the JAX
package's own off-TPU math. Never calls torch's
``scaled_dot_product_attention``. Sequence parallelism (the JAX package's
ring/ulysses modes) is not ported: one card runs no ``sep`` mesh axis.
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ...core import flags
from ...ops.flash_attention import causal_mask, flash_attention, \
    plain_attention

# the JAX package's untuned flash threshold: what its FLAGS default (-1,
# "auto") resolves to without an on-chip tuning record (the port has none)
_UNTUNED_MIN_SEQLEN = 4608


def _sdpa_reference(q, k, v, *, scale, causal):
    """Plain attention: logits in the input dtype, causal offset
    ``sk - sq`` masked to ``finfo.min``, softmax in fp32 cast back."""
    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return plain_attention(q, k, v, scale, mask, torch.finfo(q.dtype).min)


def _effective_min_seqlen(sk: int) -> int:
    """The flash-routing threshold: an explicit flag value wins (0 = always
    flash); -1 (auto) is 4608, the JAX package's value without a tuning
    record."""
    thr = int(flags.flag("flash_attention_min_seqlen"))
    return thr if thr >= 0 else _UNTUNED_MIN_SEQLEN


def _use_flash(query, sk: int) -> bool:
    """Device + threshold gate: the flash kernels run only on CUDA."""
    if not query.is_cuda:
        return False
    thr = _effective_min_seqlen(sk)
    return thr == 0 or sk >= thr


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """paddle's ``scaled_dot_product_attention``, layout
    ``[batch, seq, num_heads, head_dim]``. Dropout while training raises
    ``NotImplementedError``: it needs the JAX package's random bits."""
    if dropout_p and training:
        raise NotImplementedError(
            "attention dropout needs the bit-exact threefry port, which is "
            "not done yet")
    query, key, value = amp.cast_inputs("sdpa", query, key, value)
    scale = 1.0 / math.sqrt(query.shape[-1])
    if attn_mask is not None:
        # plain torch math: a bool mask keeps where true (finfo.min
        # elsewhere), any other mask is added to the logits
        return plain_attention(query, key, value, scale, attn_mask,
                               torch.finfo(query.dtype).min)
    if _use_flash(query, int(key.shape[1])):
        return flash_attention(query, key, value, scale=scale,
                               causal=bool(is_causal))
    return _sdpa_reference(query, key, value, scale=scale,
                           causal=bool(is_causal))
