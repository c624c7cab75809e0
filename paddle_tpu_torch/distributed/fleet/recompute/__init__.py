"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/recompute/__init__.py``).

The JAX package wraps a region in ``jax.checkpoint``; the port wraps it in
``torch.utils.checkpoint.checkpoint`` (non-reentrant): the forward keeps
only what the policy names, and backward runs the region again for the
rest. Policies, as the JAX package's ``_POLICIES``:

* ``"full"`` saves nothing (``nothing_saveable``);
* ``"core_attn"`` saves the outputs of the weight matmuls, the products
  without batch dimensions (``aten.mm``/``addmm``:
  ``dots_with_no_batch_dims_saveable``), and recomputes attention and the
  elementwise ops;
* ``"full_attn"`` saves every matmul output, attention's batched products
  (``aten.bmm``/``baddbmm``) too (``dots_saveable``).

Both selective policies are ``torch.utils.checkpoint``'s
``create_selective_checkpoint_contexts`` over those ops. A custom kernel
(the flash forward) is not an aten op, so it is recomputed under every
policy, as the Pallas call is under JAX's.

Keys: the recomputed forward must draw the forward's dropout masks. A plain
re-run would call ``rng.next_key()`` again and move the global key or an
enclosing ``key_guard``'s counter, so its masks, and the gradients, would
differ silently. Each checkpointed call records the keys its forward draws
in a :class:`paddle_tpu_torch.core.rng.KeyTape` and the recompute replays
them in the same order; nothing advances the live state twice. The AMP
policy of the forward is reinstated in the recompute too (backward runs
after the ``auto_cast`` block has exited, and on CUDA in autograd's own
thread), and so is the forward's dropout box (a mesh rank's draws are
boxes of the whole tensor's masks, :func:`paddle_tpu_torch.ops.dropout.
box`).
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from .... import amp
from ....core import rng
from ....ops import dropout as dropout_op

__all__ = ["recompute", "recompute_sequential", "RecomputeLayer",
           "resolve_policy"]

_aten = torch.ops.aten
_POLICIES = {
    "full": (),
    "core_attn": (_aten.mm.default, _aten.addmm.default),
    "full_attn": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                  _aten.baddbmm.default),
}


def resolve_policy(name):
    """The aten ops whose outputs policy ``name`` saves; unknown names
    raise ``ValueError``."""
    if name not in _POLICIES:
        raise ValueError(f"unknown recompute policy {name!r}; valid: "
                         f"{sorted(_POLICIES)}")
    return _POLICIES[name]


class _Contexts:
    """A context manager that enters the context managers ``make()``
    returns, fresh on every entry (a recompute may run more than once)."""

    def __init__(self, make):
        self._make = make
        self._stack = None

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        for cm in self._make():
            self._stack.enter_context(cm)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


def _context_fn(saved_ops):
    """``checkpoint``'s ``context_fn``: the forward records its keys, the
    recompute replays them under the forward's AMP policy; with
    ``saved_ops`` each side also runs its selective-checkpoint context."""
    def make():
        tape = rng.KeyTape()
        policy = amp.amp_state()
        box = dropout_op.box_state()
        if saved_ops:
            fwd, rec = _ckpt.create_selective_checkpoint_contexts(
                list(saved_ops))
        else:
            fwd = rec = contextlib.nullcontext()
        return (_Contexts(lambda: (tape.record(), fwd)),
                _Contexts(lambda: (tape.replay(), amp.with_state(policy),
                                   dropout_op.with_box_state(box), rec)))
    return make


def recompute(function, *args, policy="full", use_reentrant=True,
              preserve_rng_state=True, **kwargs):
    """``paddle.distributed.fleet.recompute.recompute``: run
    ``function(*args, **kwargs)`` keeping only what ``policy`` saves, and
    run it again in backward for the rest, with the same dropout keys.

    ``policy``, ``use_reentrant`` and ``preserve_rng_state`` belong to
    recompute itself and never reach ``function``. The port always uses
    the non-reentrant checkpoint (``use_reentrant`` is accepted for
    paddle's signature); ``preserve_rng_state`` is what the key tape does
    (dropout draws no torch generator). Without grad mode the function
    just runs."""
    del use_reentrant, preserve_rng_state
    saved_ops = resolve_policy(policy)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    return _ckpt.checkpoint(function, *args, use_reentrant=False,
                            context_fn=_context_fn(saved_ops),
                            preserve_rng_state=False, **kwargs)


def recompute_sequential(ctx, functions: Sequence, *args):
    """Apply ``functions`` in order, ``ctx["segments"]`` segments of them
    each under one :func:`recompute` (paddle's
    ``recompute_sequential``)."""
    segments = int(ctx.get("segments", 1)) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    seg_len = max(1, len(funcs) // max(1, segments))
    out = args
    for i in range(0, len(funcs), seg_len):
        seg = funcs[i:i + seg_len]

        def run_seg(*xs, _seg=seg):
            for f in _seg:
                xs = f(*xs) if isinstance(xs, tuple) else f(xs)
                if not isinstance(xs, tuple):
                    xs = (xs,)
            return xs if len(xs) > 1 else xs[0]

        out = recompute(run_seg, *(out if isinstance(out, tuple) else (out,)))
        if not isinstance(out, tuple):
            out = (out,)
    return out if len(out) > 1 else out[0]


class RecomputeLayer(nn.Module):
    """A sublayer whose forward always runs under :func:`recompute`."""

    def __init__(self, inner: nn.Module, policy: str = "full"):
        super().__init__()
        self.inner = inner
        self.policy = policy

    def forward(self, *args, **kwargs):
        return recompute(self.inner, *args, policy=self.policy, **kwargs)
