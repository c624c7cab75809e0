"""The parallel environment and data parallelism of the port (counterpart of
``paddle_tpu/distributed/parallel.py``: ``init_parallel_env`` ``:33``,
``shard_batch`` ``:98``, ``DataParallel`` ``:132``).

The JAX package shards a global batch over the mesh's ``data`` axis and
XLA inserts the gradients' cross-replica sum. Here each rank holds a
:class:`~paddle_tpu_torch.distributed.mesh.HybridMesh` view (installed on
its thread) and does that work itself:

* :func:`shard_batch` takes the global batch and returns this rank's rows
  (contiguous blocks in data-axis order, ``device_put``'s) and, on a
  ``sep`` axis, its contiguous block of the sequence (the next dim),
  tagged with their place in the global batch;
* a mean loss is the JAX package's global value on every rank: a mean
  over the global batch (``cross_entropy``, the GPT losses,
  :func:`global_mean`) divides this rank's sum, summed over the data group
  in the forward, by the global count. A token loss with ``-100`` labels
  is the global sum over the global valid count, not the mean of the
  ranks' means. With a ``sep`` axis the data group is the ``data_sep``
  group (the ranks holding different tokens of the same parameters): the
  sums and the gradient average span data x sep;
* gradients are averaged over the data group (paddle's ``DataParallel``):
  ``TrainStep`` runs :func:`sync_gradients` before the optimizer's clip
  and update (one all-reduce per bucket), and :class:`DataParallel`
  averages each gradient as backward accumulates it, for the eager
  ``loss.backward(); opt.step()``. So a plain ``.mean()`` over each rank's
  equal rows trains as the global mean, and the global means above scale
  their gradient by the data axis's size to match;
* :class:`DataParallel` broadcasts the parameters from data rank 0 when it
  wraps, shards its inputs' rows, and draws dropout as boxes of the global
  batch's masks.

:func:`run_thread_ranks` runs the ranks of a mesh as threads of this
process (the CPU tests, and one card): a shared ``HashStore``, a key of
each rank's own (``core.rng.use_thread_state``) and backward on the
calling thread (``torch.autograd.set_multithreading_enabled(False)``: the
ranks' collectives inside backward would otherwise meet on autograd's one
thread per device and wait on each other).
"""
from __future__ import annotations

import gc
import threading
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..core import rng
from ..ops import dropout as dropout_op
from . import collective
from .mesh import clear_hybrid_mesh, get_hybrid_mesh, init_hybrid_mesh

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "barrier",
           "shard_batch", "DataParallel", "data_group", "global_mean",
           "global_token_mean", "sync_gradients", "norm_groups",
           "run_thread_ranks"]

#: elements of one all-reduce bucket of :func:`sync_gradients`
BUCKET = 1 << 25


def init_parallel_env(backend: Optional[str] = None, store=None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None):
    """The calling rank's mesh, built (a data axis over the whole world)
    and installed unless the thread holds one already; returns its world
    group. Arguments as :func:`~.mesh.init_hybrid_mesh`."""
    mesh = get_hybrid_mesh()
    if mesh is None:
        mesh = init_hybrid_mesh(backend=backend, store=store, rank=rank,
                                world_size=world_size)
    return mesh.world


def _mesh(mesh=None):
    mesh = mesh if mesh is not None else get_hybrid_mesh()
    if mesh is None:
        raise RuntimeError("no training mesh on this thread: call "
                           "init_hybrid_mesh, init_parallel_env or "
                           "fleet.init first")
    return mesh


def get_rank(group=None) -> int:
    """This rank in ``group``, or its global rank (0 without a mesh)."""
    if group is not None:
        return collective.get_rank(group)
    mesh = get_hybrid_mesh()
    return 0 if mesh is None else mesh.rank


def get_world_size(group=None) -> int:
    """The ranks of ``group``, or of the world (1 without a mesh)."""
    if group is not None:
        return collective.get_world_size(group)
    mesh = get_hybrid_mesh()
    return 1 if mesh is None else mesh.world_size


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the world by default)."""
    collective.barrier(group if group is not None else _mesh().world)


def data_group(mesh=None):
    """The group over which ``mesh``'s (the thread's by default) losses are
    summed and gradients averaged: the ``data_sep`` group when its ``sep``
    axis has more than one rank, else the data group when its data axis
    has; else None."""
    mesh = mesh if mesh is not None else get_hybrid_mesh()
    if mesh is None:
        return None
    if mesh.axis_size("sep") > 1:
        return mesh.get_group("data_sep")
    if mesh.axis_size("data") <= 1:
        return None
    return mesh.get_group("data")


def _block(t, dim: int, n: int, k: int, what: str):
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"shard_batch: {size} {what} along dim {dim} do "
                         f"not divide the {n} ranks of the axis")
    per = size // n
    return t.narrow(dim, k * per, per), (k * per, size)


def shard_batch(t, axis: str = "data", batch_dim: int = 0):
    """This rank's part of the global batch ``t``: along ``batch_dim`` the
    ``k``-th of ``n`` equal contiguous blocks for coordinate ``k`` of
    ``axis`` (``device_put``'s order), and, for ``axis="data"`` on a mesh
    with a ``sep`` axis, the ``j``-th block of the sequence (dim
    ``batch_dim + 1``) for sep coordinate ``j``. A tensor this function
    returned passes unchanged. The part carries ``data_box = {dim:
    (offset, whole)}``, which ``TrainStep`` and :class:`DataParallel` read
    for dropout."""
    mesh = get_hybrid_mesh()
    if mesh is None or getattr(t, "data_box", None) is not None:
        return t
    out, box = t, {}
    if mesh.axis_size(axis) > 1:
        out, box[batch_dim] = _block(out, batch_dim, mesh.axis_size(axis),
                                     mesh.axis_rank(axis), "rows")
    if axis == "data" and mesh.axis_size("sep") > 1 and \
            t.dim() > batch_dim + 1:
        out, box[batch_dim + 1] = _block(out, batch_dim + 1,
                                         mesh.axis_size("sep"),
                                         mesh.axis_rank("sep"), "positions")
    if not box:
        return t
    out.data_box = box
    return out


def batch_box(args):
    """The dropout box of a step's inputs: from the first of ``args``
    that :func:`shard_batch` tagged, ``{dim: (offset, whole, local)}``."""
    for a in args:
        tag = getattr(a, "data_box", None)
        if tag is not None:
            return {dim: (off, whole, a.shape[dim])
                    for dim, (off, whole) in tag.items()}
    return {}


class _DataSum(torch.autograd.Function):
    """``x`` summed over ``group`` in the forward; the gradient times the
    group's size in the backward, since the data group's gradients are
    then averaged (:func:`sync_gradients`): a rank's share of a global sum
    gets its whole gradient back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = collective.get_world_size(group)
        return collective.all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def global_token_mean(total: torch.Tensor, count: torch.Tensor,
                      group=None, floor: float = 1.0) -> torch.Tensor:
    """``sum(total) / max(sum(count), floor)`` over the data group of the
    thread's mesh (``group``: that group or None), both sums taken in the
    forward: the JAX package's mean over the global batch, the same on
    every rank. Its gradient, averaged over the data group, is the global
    mean's."""
    group = group if group is not None else data_group()
    if group is None:
        return total / torch.clamp_min(count, floor)
    count = collective.all_reduce(count.detach().float().clone(), group)
    return _DataSum.apply(total, group) / torch.clamp_min(count, floor)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch: this rank's sum over the
    data group's element count (the JAX package's ``mean`` of a sharded
    batch; ``x.mean()`` without a data axis)."""
    group = data_group()
    if group is None:
        return x.mean()
    return global_token_mean(x.sum(), torch.tensor(
        float(x.numel()), device=x.device), group)


def sync_gradients(grads, mesh=None) -> List[torch.Tensor]:
    """``grads`` averaged over the data group of ``mesh`` (the thread's by
    default; unchanged without a data axis), one all-reduce per bucket of
    up to :data:`BUCKET` elements of one dtype and device."""
    group = data_group(mesh)
    if group is None:
        return list(grads)
    n = collective.get_world_size(group)
    out = [g.contiguous() for g in grads]
    order = sorted(range(len(out)), key=lambda i: (str(out[i].dtype),
                                                   str(out[i].device)))
    start = 0
    while start < len(order):
        first = out[order[start]]
        stop, size = start, 0
        while stop < len(order):
            g = out[order[stop]]
            if (g.dtype, g.device) != (first.dtype, first.device) or (
                    size and size + g.numel() > BUCKET):
                break
            size += g.numel()
            stop += 1
        idx = order[start:stop]
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        collective.all_reduce(flat, group).div_(n)
        for i, piece in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = piece.view_as(out[i])
        start = stop
    return out


def norm_groups(params, sliced=None):
    """Per parameter, the process groups over which its gradient is split,
    for a global norm: the model group for a tensor-parallel shard
    (``split_mesh``), the pipe group for a pipe rank's stacked rows
    (``pipe_mesh``), and ``sliced[i]`` (a ZeRO slice's sharding group) when
    given. None when nothing is split (the one-card norm)."""
    groups = []
    for i, p in enumerate(params):
        g = ()
        mesh = getattr(p, "split_mesh", None)
        if mesh is not None:
            g += (mesh.group,)
        pipe = getattr(p, "pipe_mesh", None)
        if pipe is not None:
            g += (pipe.get_group("pipe"),)
        if sliced is not None and sliced[i] is not None:
            g += (sliced[i],)
        groups.append(g)
    return groups if any(groups) else None


class DataParallel(nn.Module):
    """``paddle.DataParallel`` (``paddle_tpu/distributed/parallel.py:132``):
    the wrapped layers' parameters and buffers are broadcast from data rank
    0 when it wraps; ``forward`` takes the global batch, runs the layers on
    this rank's rows (:func:`shard_batch`) and draws dropout as boxes of
    the global batch's masks. A gradient that backward accumulates into
    ``.grad`` is averaged over the data group there (every rank runs the
    same graph, so the all-reduces meet in one order); ``TrainStep``, which
    takes its gradients without ``.grad``, averages them itself. Names,
    state dicts and attributes are the wrapped layers'.
    ``comm_buffer_size`` and the other tuning knobs are accepted and change
    nothing."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        self._layers = layers
        mesh = _mesh()
        self._group = group if group is not None else data_group(mesh)
        if self._group is not None:
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    collective.broadcast(t.data, 0, self._group)
            hook = _averaging_hook(self._group)
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(hook)

    def forward(self, *inputs, **kwargs):
        if self._group is None:
            return self._layers(*inputs, **kwargs)
        inputs = tuple(shard_batch(x) if isinstance(x, torch.Tensor)
                       and x.dim() else x for x in inputs)
        with dropout_op.box(batch_box(inputs)):
            return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


def _averaging_hook(group):
    """A post-accumulate hook averaging a parameter's ``.grad`` over
    ``group``. An accumulated gradient adds this backward's local part to
    an average already equal on every rank, so averaging it again is
    exact."""
    n = collective.get_world_size(group)

    def hook(p):
        collective.all_reduce(p.grad, group).div_(n)

    return hook


def run_thread_ranks(fn: Callable, world_size: int,
                     timeout: float = 600.0) -> list:
    """``fn(rank, store)`` on ``world_size`` threads of this process, the
    ranks of one mesh (each builds its mesh on ``store``, a shared
    ``HashStore``); returns their results in rank order and raises the
    error that came first. The mesh a rank installed is closed when it
    returns. Each thread draws from its own copy of the
    process's key as it stands and runs backward on itself (see the module
    docstring)."""
    store = dist.HashStore()
    start = rng.get_rng_state()
    results: list = [None] * int(world_size)
    errors: list = []

    def body(r):
        try:
            rng.use_thread_state(start)
            with torch.autograd.set_multithreading_enabled(False):
                results[r] = fn(r, store)
        except BaseException as e:  # re-raised below, with its rank
            errors.append((r, e))
        finally:
            mesh = get_hybrid_mesh()
            if mesh is not None:
                mesh.close()
            clear_hybrid_mesh()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"rank{r}")
               for r in range(int(world_size))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank did not finish in {timeout} s")
    # a process group held only by a reference cycle would outlive the
    # interpreter's teardown, and its threads abort the process there
    gc.collect()
    if errors:
        r, e = errors[0]
        raise RuntimeError(f"rank {r} failed: {e!r}") from e
    return results
