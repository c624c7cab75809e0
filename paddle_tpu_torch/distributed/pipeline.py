"""Pipeline parallelism over the ``pipe`` axis of the training mesh
(counterpart of ``paddle_tpu/distributed/pipeline.py``:
``stack_stage_params`` ``:52``, ``pipeline_apply`` ``:67``,
``pipeline_tick_cost`` ``:155``, ``stack_chunk_params`` ``:169``,
``pipeline_apply_interleaved`` ``:193``).

The JAX package runs the schedule as one ``lax.scan`` over clock ticks with
a ``ppermute`` hop a tick, and derives the backward by transposing it. Here
each pipe rank holds only its own stage's parameters (or its ``V`` chunks')
and the schedule is written out, forward and backward, as one
``torch.autograd.Function`` a call:

* The ticks are the JAX package's: at tick ``t`` device ``d`` holds the
  activation of microbatch ``m = g*S + i`` at global stage ``k`` (chunk
  ``k // S`` of device ``k mod S``), where ``i = (t - d) mod S``,
  ``k = (t - i) mod (S*V)`` and ``g = (t - i - k) / (S*V)``. A slot whose
  microbatch does not exist is idle (the JAX package computes on clamped
  garbage there and masks it); so a rank computes each of its
  ``M x V`` items once. GPipe is ``V = 1``; :func:`last_schedule` reports
  the ticks run, ``M + S - 1`` for GPipe and ``ceil(M/S)*S*V + S - 1``
  for the interleaved schedule, whose cost in stage units is
  :func:`pipeline_tick_cost`.
* After a tick's compute every rank of the pipe group calls one
  :func:`~paddle_tpu_torch.distributed.collective.ppermute` by +1 (the
  activation it made, or zeros when it sends none) unless no rank sends at
  that tick. The backward walks the ticks in reverse: before a tick's item
  the reverse hop (-1) brings each rank the gradient of the activation it
  sent, and the item's gradient comes from ``torch.autograd.grad`` of the
  graph its forward kept (``remat=False``) or of a recompute of it
  (``remat=True``, the port's :func:`~paddle_tpu_torch.distributed.fleet.
  recompute.recompute`, which replays the forward's dropout keys, as
  ``jax.checkpoint(..., nothing_saveable)``).
* The outputs end replicated on every pipe rank, as the masked ``psum``
  leaves them: the last stage broadcasts them. Their gradient is every
  rank's own (each computes the same loss) and only the last stage's is
  used: it reaches the schedule once, not ``S`` times. The input's
  gradient, made on stage 0, is broadcast to every pipe rank (the
  transpose of a replicated input).
* The ranks of other axes (``model`` inside a stage, ``data``) run the
  same schedule; a stage's collectives meet inside its items.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch
from torch.utils import _pytree as pytree

from . import collective
from .fleet.recompute import recompute
from .mesh import get_hybrid_mesh

__all__ = ["PIPE_AXIS", "stack_stage_params", "pipeline_apply",
           "pipeline_tick_cost", "stack_chunk_params",
           "pipeline_apply_interleaved", "last_schedule"]

PIPE_AXIS = "pipe"

_stats = threading.local()


def last_schedule() -> Optional[dict]:
    """The calling thread's last pipelined schedule: ``ticks``,
    ``stages``, ``chunks``, ``microbatches``, ``hops`` (forward) and
    ``cost`` (ticks / chunks, :func:`pipeline_tick_cost`'s unit)."""
    return getattr(_stats, "last", None)


def _pipe(mesh):
    mesh = mesh if mesh is not None else get_hybrid_mesh()
    if mesh is None or mesh.axis_size(PIPE_AXIS) <= 1:
        return mesh, 1, 0
    return mesh, mesh.axis_size(PIPE_AXIS), mesh.axis_rank(PIPE_AXIS)


def stack_stage_params(param_arrays, num_stages: int, mesh=None):
    """This pipe rank's stage of ``param_arrays`` (``num_stages`` pytrees,
    stage-major): stage ``r`` on pipe rank ``r``, stage 0 without a pipe
    axis. Each rank keeps only its own stage."""
    _, S, r = _pipe(mesh)
    if len(param_arrays) != num_stages:
        raise ValueError(f"expected {num_stages} stage pytrees, got "
                         f"{len(param_arrays)}")
    if S > 1 and S != num_stages:
        raise ValueError(f"{num_stages} stages on a pipe axis of {S}")
    return param_arrays[r]


def stack_chunk_params(param_arrays, num_stages: int, num_chunks: int,
                       mesh=None) -> list:
    """This pipe rank's ``num_chunks`` chunks of ``param_arrays`` (``S*V``
    pytrees, chunk ``j`` = global stage ``j``): device ``d`` holds chunks
    ``d, d+S, ..., d+(V-1)S``, the interleaved placement."""
    S, V = num_stages, num_chunks
    if len(param_arrays) != S * V:
        raise ValueError(f"expected {S * V} chunk pytrees, got "
                         f"{len(param_arrays)}")
    _, P, r = _pipe(mesh)
    if P > 1 and P != S:
        raise ValueError(f"{S} stages on a pipe axis of {P}")
    return [param_arrays[v * S + r] for v in range(V)]


def pipeline_tick_cost(num_microbatches: int, num_stages: int,
                       num_chunks: int = 1) -> float:
    """Schedule cost in full-stage units (1 unit = V chunk applications):
    GPipe ``M + S - 1``; interleaved ``(ceil(M/S)*S*V + S - 1) / V``."""
    m, s, v = num_microbatches, num_stages, num_chunks
    if v <= 1:
        return float(m + s - 1)
    m_pad = -(-m // s) * s
    return (m_pad * v + s - 1) / v


def _microbatches(x, M):
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by {M} "
                         "microbatches")
    return x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))


def _schedule(S: int, V: int, M: int):
    """``(T, items, hops)``: the tick count, ``items[d][t] = (m, k)`` of
    device ``d``'s work at tick ``t``, and whether any device sends at
    tick ``t``."""
    G = -(-M // S)
    T = M + S - 1 if V == 1 else G * S * V + S - 1
    items = [dict() for _ in range(S)]
    hops = [False] * T
    for d in range(S):
        for t in range(T):
            i = (t - d) % S
            k = (t - i) % (S * V)
            g = (t - i - k) // (S * V)
            m = g * S + i
            if 0 <= g < G and m < M:
                items[d][t] = (m, k)
                if k < S * V - 1:
                    hops[t] = True
    return T, items, hops


class _Scheduled(torch.autograd.Function):
    """The pipelined schedule on one pipe rank: inputs the global batch and
    this rank's chunks' parameter leaves, output the replicated result."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        S, V, M, rank, group = (plan["S"], plan["V"], plan["M"],
                                plan["rank"], plan["group"])
        chunks = _unflatten(plan, leaves)
        x_mb = _microbatches(x, M)
        T, items, hops = _schedule(S, V, M)
        mine = items[rank]
        keep = {}
        outs = [None] * M
        state = None
        needs_x = ctx.needs_input_grad[1]
        for t in range(T):
            send = None
            item = mine.get(t)
            if item is not None:
                m, k = item
                h = x_mb[m] if k == 0 else state
                h_in = h.detach().requires_grad_(needs_x or k > 0)
                with torch.enable_grad():
                    out = plan["run"](chunks[k // S], h_in, k // S)
                if tuple(out.shape) != tuple(h_in.shape) or \
                        out.dtype != h_in.dtype:
                    raise ValueError(
                        f"a pipeline stage must keep its input's shape and "
                        f"dtype: {tuple(h_in.shape)} {h_in.dtype} -> "
                        f"{tuple(out.shape)} {out.dtype}")
                keep[t] = (h_in, out)
                if k == S * V - 1:
                    outs[m] = out.detach()
                else:
                    send = out.detach()
            if hops[t]:
                payload = send if send is not None else torch.zeros_like(
                    x_mb[0])
                state = collective.ppermute(payload, group, 1)
        if rank == S - 1:
            result = torch.stack(outs).reshape(x.shape)
        else:
            result = torch.zeros_like(x)
        collective.broadcast(result, S - 1, group)
        ctx.plan, ctx.keep, ctx.mine, ctx.hops = plan, keep, mine, hops
        ctx.leaves, ctx.x_shape, ctx.dtype = leaves, tuple(x.shape), x.dtype
        ctx.T = T
        _stats.last = {"ticks": T, "stages": S, "chunks": V,
                       "microbatches": M, "hops": sum(hops),
                       "cost": T / V}
        return result

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        S, V, M, rank, group = (plan["S"], plan["V"], plan["M"],
                                plan["rank"], plan["group"])
        g_mb = _microbatches(grad.contiguous(), M)
        per_chunk = plan["per_chunk"]
        leaves = ctx.leaves
        grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        gx = torch.zeros(ctx.x_shape, dtype=ctx.dtype, device=grad.device) \
            if ctx.needs_input_grad[1] else None
        gx_mb = None if gx is None else _microbatches(gx, M)
        pending = None  # the gradient of the activation this rank received
        for t in reversed(range(ctx.T)):
            received = None
            if ctx.hops[t]:
                payload = pending if pending is not None else \
                    torch.zeros_like(g_mb[0])
                received = collective.ppermute(payload, group, -1)
            pending = None
            item = ctx.mine.get(t)
            if item is None:
                continue
            m, k = item
            h_in, out = ctx.keep.pop(t)
            g_out = g_mb[m] if k == S * V - 1 else received
            v = k // S
            lo = sum(per_chunk[:v])
            mine = list(leaves[lo:lo + per_chunk[v]])
            lead = [h_in] if h_in.requires_grad else []
            wants = lead + [p for p in mine if p.requires_grad]
            got = torch.autograd.grad(out, wants, g_out, allow_unused=True)
            g_in = got[0] if lead else None
            it = iter(got[len(lead):])
            for j, p in enumerate(mine):
                if not p.requires_grad:
                    continue
                g = next(it)
                if g is None:
                    continue
                acc = grads[lo + j]
                grads[lo + j] = g if acc is None else acc + g
            if k == 0:
                if gx_mb is not None and g_in is not None:
                    gx_mb[m] += g_in
            else:
                pending = g_in if g_in is not None else torch.zeros_like(
                    h_in)
        ctx.keep = None
        if gx is not None:
            collective.broadcast(gx, 0, group)
        return (None, gx, *grads)


def _unflatten(plan, leaves):
    """The chunks' pytrees of the flat parameter leaves."""
    out, lo = [], 0
    for n, spec in zip(plan["per_chunk"], plan["specs"]):
        out.append(pytree.tree_unflatten(list(leaves[lo:lo + n]), spec))
        lo += n
    return out


def _run_scheduled(chunk_fn, chunks, x, M, V, mesh, S, rank, remat):
    """``x`` through :class:`_Scheduled` with this rank's ``chunks``."""
    run = ((lambda p, h, v: recompute(chunk_fn, p, h, v)) if remat
           else chunk_fn)
    flat, per_chunk, specs = [], [], []
    for c in chunks:
        leaves, spec = pytree.tree_flatten(c)
        flat += leaves
        per_chunk.append(len(leaves))
        specs.append(spec)
    plan = {"S": S, "V": V, "M": M, "rank": rank,
            "group": mesh.get_group(PIPE_AXIS), "run": run,
            "per_chunk": per_chunk, "specs": specs}
    return _Scheduled.apply(plan, x, *flat)


def pipeline_apply(stage_fn: Callable, stage_params, x, *,
                   num_microbatches: int, mesh=None, remat: bool = True):
    """``x`` ([B, ...], the global batch, on every pipe rank) through the S
    stages of the pipe axis of ``mesh`` (the thread's by default) in
    ``num_microbatches`` microbatches, the GPipe schedule.

    ``stage_fn(local_params, h) -> h`` is one stage's computation and
    ``stage_params`` this rank's stage (:func:`stack_stage_params`). The
    result ``[B, ...]`` is on every pipe rank. Without a pipe axis the
    microbatches run through the one stage in turn."""
    mesh, S, rank = _pipe(mesh)
    M = int(num_microbatches)
    x_mb = _microbatches(x, M)
    if S <= 1:
        body = (lambda p, h: recompute(stage_fn, p, h)) if remat \
            else stage_fn
        return torch.cat([body(stage_params, h) for h in x_mb.unbind(0)])
    return _run_scheduled(lambda p, h, v: stage_fn(p, h), [stage_params], x,
                          M, 1, mesh, S, rank, remat)


def pipeline_apply_interleaved(chunk_fn: Callable, chunk_params, x, *,
                               num_microbatches: int, num_chunks: int,
                               mesh=None, remat: bool = True):
    """The interleaved virtual-stage schedule: ``chunk_fn(local_params, h,
    v) -> h`` is one chunk (1/V of a GPipe stage; ``v`` this device's local
    chunk slot, global stage ``v*S + rank``), ``chunk_params`` this rank's
    ``V`` chunks (:func:`stack_chunk_params`). Each microbatch passes the
    ``S*V`` chunks in global-stage order, V laps of the ring. Without a
    pipe axis every chunk runs in turn on each microbatch; ``V = 1`` is
    :func:`pipeline_apply`."""
    mesh, S, rank = _pipe(mesh)
    V, M = int(num_chunks), int(num_microbatches)
    if len(chunk_params) != V:
        raise ValueError(f"expected {V} chunks, got {len(chunk_params)}")
    x_mb = _microbatches(x, M)
    body = (lambda p, h, v: recompute(chunk_fn, p, h, v)) if remat \
        else chunk_fn
    if S <= 1:
        outs = []
        for h in x_mb.unbind(0):
            for j in range(V):
                h = body(chunk_params[j], h, j)
            outs.append(h)
        return torch.cat(outs)
    if V <= 1:
        return pipeline_apply(lambda p, h: chunk_fn(p, h, 0), chunk_params[0],
                              x, num_microbatches=M, mesh=mesh, remat=remat)
    return _run_scheduled(chunk_fn, list(chunk_params), x, M, V, mesh, S,
                          rank, remat)
