"""Context (sequence) parallelism over the ``sep`` axis of the training
mesh: ring attention and Ulysses (counterpart of
``paddle_tpu/distributed/context_parallel.py``: ``_block_attn`` ``:38``,
``_ring_body`` ``:51``, ``ring_attention`` ``:87``, ``ulysses_attention``
``:123``).

The JAX functions take the global ``[b, s, h, d]`` arrays sharded over
``sep`` and run inside ``shard_map``; here each rank calls them with its
own rows of the sequence, ``[b, s/R, h, d]`` (rank ``r`` holds positions
``[r*s/R, (r+1)*s/R)``, :func:`~paddle_tpu_torch.distributed.parallel.
shard_batch`), and gets its rows of the output. Neither runs a kernel of
its own: the JAX package's are XLA math, and so are these.

* **Ring** (:func:`ring_attention`): Q stays put and K/V hop to the next
  sep rank each of R steps (:func:`~paddle_tpu_torch.distributed.
  collective.ppermute`); an online softmax in f32 with the finite ``-1e30``
  fill accumulates each block, causality decided from global positions.
  The backward is written out as the transpose of those steps: walking
  them in reverse, the K/V block and the gradient of the one held go back
  one rank a step (the reverse hop), each step adding its block's
  contribution, so each rank ends with the gradient of its own K/V.
* **Ulysses** (:func:`ulysses_attention`): an all-to-all takes each of q,
  k, v from sequence-sharded to head-sharded (``[b, s, h/R, d]``),
  :func:`~paddle_tpu_torch.nn.functional.attention._sdpa_reference` runs
  on the whole sequence, and an all-to-all takes the output back; each
  all-to-all's backward is the reverse one. Heads that ``R`` does not
  divide raise ``ValueError``.

Without a ``sep`` axis both are ``_sdpa_reference``.
"""
from __future__ import annotations

import torch

from . import collective
from .mesh import get_hybrid_mesh

__all__ = ["SEP_AXIS", "ring_attention", "ulysses_attention"]

SEP_AXIS = "sep"
_NEG_INF = -1e30  # finite: keeps exp(m_old - m_new) defined for empty rows


def _sep(mesh):
    mesh = mesh if mesh is not None else get_hybrid_mesh()
    if mesh is None or mesh.axis_size(SEP_AXIS) <= 1:
        return None, 1
    return mesh, mesh.axis_size(SEP_AXIS)


def _mask(rank, src, sq, sk, causal, device):
    """``[sq, sk]`` True where query row ``rank*sq + i`` sees key
    ``src*sk + j``."""
    if not causal:
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    qpos = rank * sq + torch.arange(sq, device=device)
    kpos = src * sk + torch.arange(sk, device=device)
    return qpos[:, None] >= kpos[None, :]


def _logits(q, k, scale):
    """``[b, h, sq, sk]`` logits in f32: the product in the inputs' dtype,
    then cast and scaled (``_block_attn``'s order)."""
    return torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale


class _Ring(torch.autograd.Function):
    """The R-step ring on ``[b, h, s_local, d]`` blocks."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, group):
        R, rank = collective.get_world_size(group), collective.get_rank(group)
        b, h, sq, d = q.shape
        sk = k.shape[2]
        m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for r in range(R):
            src = (rank - r) % R
            mask = _mask(rank, src, sq, sk, causal, q.device)
            s = _logits(q, kc, scale).masked_fill(~mask, _NEG_INF)
            bm = s.amax(-1)
            p = torch.exp(s - bm[..., None]).masked_fill(~mask, 0.0)
            bl = p.sum(-1)
            bo = torch.einsum("bhqk,bhkd->bhqd", p, vc.float())
            m_new = torch.maximum(m, bm)
            c_old, c_new = torch.exp(m - m_new), torch.exp(bm - m_new)
            l = l * c_old + bl * c_new
            o = o * c_old[..., None] + bo * c_new[..., None]
            m = m_new
            if r < R - 1:
                kc = collective.ppermute(kc, group, 1)
                vc = collective.ppermute(vc, group, 1)
        lsafe = torch.clamp_min(l, 1e-38)
        out = (o / lsafe[..., None]).to(q.dtype)
        # the last block held (rank + 1's) starts the reverse walk
        ctx.save_for_backward(q, kc, vc, out, m, lsafe)
        ctx.args = (scale, causal, group)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kc, vc, out, m, l = ctx.saved_tensors
        scale, causal, group = ctx.args
        R, rank = collective.get_world_size(group), collective.get_rank(group)
        sq, sk = q.shape[2], kc.shape[2]
        do = dout.float()
        delta = (do * out.float()).sum(-1)           # [b, h, sq]
        lse = m + torch.log(l)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(kc.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(vc.shape, dtype=torch.float32, device=q.device)
        for r in reversed(range(R)):
            src = (rank - r) % R
            mask = _mask(rank, src, sq, sk, causal, q.device)
            s = _logits(q, kc, scale)
            p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, do)
            dp = torch.einsum("bhqd,bhkd->bhqk", do, vc.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kc.float())
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
            if r > 0:
                # the transpose of step r - 1's hop: the block and the
                # gradient of the one held go back a rank
                kc = collective.ppermute(kc, group, -1)
                vc = collective.ppermute(vc, group, -1)
                dk = collective.ppermute(dk, group, -1)
                dv = collective.ppermute(dv, group, -1)
        return (dq.to(q.dtype), dk.to(kc.dtype), dv.to(vc.dtype), None, None,
                None)


def _reference(q, k, v, scale, causal):
    from ..nn.functional.attention import _sdpa_reference

    return _sdpa_reference(q, k, v, scale=scale, causal=causal)


def ring_attention(q, k, v, *, scale: float, causal: bool = True,
                   mesh=None):
    """Blockwise ring attention over the ``sep`` axis of ``mesh`` (the
    thread's by default). ``q``/``k``/``v``: this rank's rows ``[batch,
    s_local, heads, head_dim]``; returns its rows of the output."""
    mesh, R = _sep(mesh)
    if R <= 1:
        return _reference(q, k, v, scale, causal)
    group = mesh.get_group(SEP_AXIS)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = _Ring.apply(qt, kt, vt, float(scale), bool(causal), group)
    return out.transpose(1, 2)


def ulysses_attention(q, k, v, *, scale: float, causal: bool = True,
                      mesh=None):
    """Ulysses attention over the ``sep`` axis: sequence-sharded to
    head-sharded by an all-to-all, :func:`_sdpa_reference` on the whole
    sequence, and back. The heads must divide by the sep degree."""
    mesh, R = _sep(mesh)
    if R <= 1:
        return _reference(q, k, v, scale, causal)
    if q.shape[2] % R:
        raise ValueError(f"num_heads {q.shape[2]} not divisible by sep "
                         f"degree {R}")
    group = mesh.get_group(SEP_AXIS)

    def fwd(t):  # [b, s_l, h, d] -> [b, s, h_l, d]
        return collective.all_to_all_autograd(t.contiguous(), group, 2, 1)

    out = _reference(fwd(q), fwd(k), fwd(v), scale, causal)
    return collective.all_to_all_autograd(out.contiguous(), group, 1, 2)
