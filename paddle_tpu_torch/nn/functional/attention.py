"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layout ``[batch, seq, heads, head_dim]``. :func:`scaled_dot_product_attention`
routes as the JAX package does, with "the tensor is on CUDA" in place of
"the backend is a TPU": at kv length at or above
``FLAGS_flash_attention_min_seqlen`` (-1 = auto, 0 = always) a CUDA tensor
takes the hand-written flash kernels (:mod:`paddle_tpu_torch.ops.
flash_attention`); everything else takes :func:`_sdpa_reference`, the JAX
package's own off-TPU math. The route is decided when the Python runs,
as the JAX package decides it at trace time: under ``torch.export`` a
symbolic kv length takes the route its whole range takes (at the auto
threshold, a range wholly below 4608 the plain route, wholly at or above
it the kernels), and a range that straddles the threshold raises
``ValueError``; the length is never specialized. Never calls torch's
``scaled_dot_product_attention``. Live dropout (``dropout_p`` while
training) takes the plain route with the probabilities dropped after the
softmax, never the flash kernels, and draws its key only then, as the JAX
package does. Context parallelism comes first, as in the JAX package's
``_sdpa`` (``paddle_tpu/nn/functional/attention.py:89-99``): on a
training mesh whose ``sep`` axis shards the sequence (or with
``FLAGS_sequence_parallel_mode`` ``ring`` / ``ulysses``), causal or full
attention without a mask and without live dropout goes to
:func:`paddle_tpu_torch.distributed.context_parallel.ring_attention` or
``ulysses_attention`` (:func:`_seq_parallel_mode`) and never to the flash
kernels. On a ``sep`` axis of more than one rank, a mask, live dropout
and the flag's ``none`` raise ``NotImplementedError``: each would attend
over this rank's block of positions alone, where the JAX package attends
over the whole sequence (its arrays are global, and XLA gathers it).
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ...core import flags, rng
from ...ops import flash_attention as fa
from ...ops.flash_attention import causal_mask, plain_attention

# the JAX package's untuned flash threshold: what its FLAGS default (-1,
# "auto") resolves to without an on-chip tuning record (the port has none)
_UNTUNED_MIN_SEQLEN = 4608


def _sdpa_reference(q, k, v, *, scale, causal, dropout_p=0.0, key=None):
    """Plain attention: logits in the input dtype, causal offset
    ``sk - sq`` masked to ``finfo.min``, softmax in fp32 cast back, then
    the probabilities dropped under ``key`` when ``dropout_p``."""
    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return plain_attention(q, k, v, scale, mask, torch.finfo(q.dtype).min,
                           dropout_p, key)


def _effective_min_seqlen(sk) -> int:
    """The flash-routing threshold: an explicit flag value wins (0 = always
    flash); -1 (auto) is 4608, the JAX package's value without a tuning
    record."""
    thr = int(flags.flag("flash_attention_min_seqlen"))
    return thr if thr >= 0 else _UNTUNED_MIN_SEQLEN


def _at_least(n, thr: int) -> bool:
    """``n >= thr`` for a concrete length; for a symbolic one, the answer
    its whole range in this trace gives, else ``ValueError``."""
    if not isinstance(n, torch.SymInt):
        return n >= thr
    vr = n.node.shape_env.bound_sympy(n.node.expr)
    lo, hi = vr.lower, vr.upper
    if hi < thr:
        return False
    if lo >= thr:
        return True
    raise ValueError(
        f"the flash route's threshold {thr} (FLAGS_flash_attention_min_"
        f"seqlen) falls inside the kv length's range [{lo}, {hi}] of this "
        "export: the two routes differ in numerics, and a traced program "
        "takes one. Bound the length below the threshold (a model's "
        "max_position_embeddings does), or set the flag to 0 (flash at "
        "every length) or to a value outside the range before saving")


def _use_flash(query, sk) -> bool:
    """Device + threshold gate: the flash kernels run only on CUDA."""
    if not query.is_cuda:
        return False
    thr = _effective_min_seqlen(sk)
    return thr == 0 or _at_least(sk, thr)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """paddle's ``scaled_dot_product_attention``, layout
    ``[batch, seq, num_heads, head_dim]``. Dropout while training takes the
    plain route and one key from ``rng.next_key()``."""
    drop = float(dropout_p) if (dropout_p and training) else 0.0
    query, key, value = amp.cast_inputs("sdpa", query, key, value)
    scale = 1.0 / math.sqrt(query.shape[-1])
    mode = _seq_parallel_mode()
    if _sep_degree() > 1:
        local = ("a mask" if attn_mask is not None else
                 "live dropout" if drop else
                 "FLAGS_sequence_parallel_mode=none" if mode == "none"
                 else None)
        if local is not None:
            raise NotImplementedError(
                f"attention with {local} on a sep axis is not ported: it "
                "would attend over this rank's block of positions alone, "
                "where the JAX package attends over the whole gathered "
                "sequence (ROADMAP.md §3)")
    if attn_mask is not None:
        # plain torch math: a bool mask keeps where true (finfo.min
        # elsewhere), any other mask is added to the logits
        return plain_attention(query, key, value, scale, attn_mask,
                               torch.finfo(query.dtype).min, drop,
                               rng.next_key(query.device) if drop else None)
    if drop:
        return _sdpa_reference(query, key, value, scale=scale,
                               causal=bool(is_causal), dropout_p=drop,
                               key=rng.next_key(query.device))
    if mode in ("ring", "ulysses"):
        from ...distributed import context_parallel as cp

        fn = cp.ring_attention if mode == "ring" else cp.ulysses_attention
        return fn(query, key, value, scale=scale, causal=bool(is_causal))
    if _use_flash(query, key.shape[1]):
        return fa.flash_attention(query, key, value, scale=scale,
                                  causal=bool(is_causal))
    return _sdpa_reference(query, key, value, scale=scale,
                           causal=bool(is_causal))


def _sep_degree() -> int:
    from ...distributed.mesh import get_hybrid_mesh

    mesh = get_hybrid_mesh()
    return 1 if mesh is None else mesh.axis_size("sep")


def _seq_parallel_mode() -> str:
    """The context-parallel route: ``FLAGS_sequence_parallel_mode`` when it
    names one (``ring``, ``ulysses``, ``none``), else (``auto``) ``ring``
    when the thread's training mesh has a ``sep`` axis of more than one
    rank, ``none`` otherwise (``paddle_tpu/nn/functional/attention.py:165``).
    """
    mode = flags.flag("sequence_parallel_mode")
    if mode in ("ring", "ulysses", "none"):
        return mode
    return "ring" if _sep_degree() > 1 else "none"


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True):
    """paddle's ``flash_attention``: :func:`scaled_dot_product_attention`
    with ``dropout`` and ``causal``; returns ``(out, None)`` (the softmax
    is not returned, as in the JAX package)."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None
