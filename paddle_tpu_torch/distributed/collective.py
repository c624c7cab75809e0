"""Collectives of the port over ``torch.distributed`` process groups
(counterpart of ``paddle_tpu/distributed/collective.py``: ``new_group``
``:131``, ``all_reduce`` ``:305``, ``all_gather`` ``:332``, ``broadcast``
``:354``).

The JAX package's collectives are ``psum`` / ``all_gather`` over a named
mesh axis; here a group is a process group object, one process (or, in
tests, one thread) per rank, and every call runs on the group's backend:

* ``"nccl"``: a ``ProcessGroupNCCL`` on CUDA tensors. A call issued while
  a CUDA graph is being captured on the current stream is recorded into
  the graph (the serving engine's step programs at tp >= 1).
* ``"gloo"``: a ``ProcessGroupGloo`` on CPU tensors or on CUDA tensors
  (which it stages through the host). It cannot be captured.

Groups are built directly on a store (:func:`new_group`), never through
``init_process_group``: a process may hold several meshes one after
another (the card's smoke run does), and a test may run its ranks as
threads of one process over an in-process ``HashStore``.

Only ``all_reduce`` is called by the serving path (a sum, and a max for
the int8 arena's per-row absmax), on both backends: gloo has no
``all_gather`` on CUDA tensors, so the vocab
gather of the tensor-parallel head writes each rank's slice into a zeroed
buffer and sums (:func:`gather_by_sum`). Exactly one rank contributes each
element, so the sum is exact. The serving path's ``all_reduce`` runs in
place, outside autograd; its graphs capture it.

Training (counterpart of the transposes GSPMD inserts, ``all_reduce``
``:305``, ``all_gather`` ``:332``, ``broadcast`` ``:354``,
``reduce_scatter`` ``:390``, ``barrier`` ``:548``) needs the collectives'
backwards, written out as ``torch.autograd.Function`` objects (Megatron's
pair):

* :func:`copy_to_model_parallel` (*f*): the identity forward, a sum over
  the group backward: at the input of a column-split layer and of the
  tied head, whose ranks each see only their part of the input's gradient;
* :func:`reduce_from_model_parallel` (*g*): a sum forward, the identity
  backward: a row-split layer's partial products, the vocab-parallel
  embedding's rows, a loss's data-parallel sum;
* :func:`gather_from_model_parallel`: the last axis gathered whole, its
  backward this rank's slice of the gradient (the gathered value feeds a
  loss every rank computes alike, so the slice counts once).

:func:`all_gather_rows` and :func:`reduce_scatter` work on dim 0. NCCL runs
them natively; gloo has neither on CUDA tensors, so there they are built
from ``all_reduce`` as :func:`gather_by_sum` is: each rank writes its rows
into a zeroed buffer and the buffers are summed (exact), or the whole
tensor is summed and each rank keeps its rows. A sum over ranks is the
same on both backends; its order of addition may differ past two ranks.
Every backward captures its group when the forward runs, so it reads no
thread's state (autograd may run it on its own thread).

Pipeline and context parallelism (counterparts of ``lax.ppermute`` and
``lax.all_to_all``, which JAX transposes itself):

* :func:`ppermute` moves every rank's tensor to rank ``(r + shift) mod n``
  of the group: a send / recv pair, ordered even ranks first (send, then
  recv) and odd ranks second (recv, then send), so that no ring or chain
  deadlocks on a backend whose send waits for its receive (NCCL on one
  pair's stream, gloo's rendezvous). gloo's send and recv read host
  pointers (on an H100 a CUDA tensor's send fails: ``writev: Bad
  address``), so on gloo a CUDA tensor's hop is built from ``all_reduce``
  (:func:`ppermute_by_sum`: each rank writes its tensor into its
  destination's slot of a zeroed buffer and the buffers are summed;
  exact). The ring and the pipeline schedule call it inside their own
  autograd functions, whose backward runs the reverse hop.
* :func:`all_to_all` splits a tensor into ``n`` pieces along one dim,
  sends piece ``j`` to rank ``j`` and concatenates what it receives along
  another (``alltoall_base``, which both backends run on CPU and CUDA
  tensors). :func:`all_to_all_autograd`'s backward is the reverse
  all-to-all.
"""
from __future__ import annotations

import datetime
from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "new_group", "all_reduce", "broadcast", "all_gather",
           "gather_by_sum", "all_gather_rows", "reduce_scatter", "barrier",
           "get_rank", "get_world_size", "backend_of",
           "copy_to_model_parallel", "reduce_from_model_parallel",
           "gather_from_model_parallel", "ppermute", "ppermute_by_sum",
           "all_to_all", "all_to_all_autograd"]

#: the backends a serving mesh may name
BACKENDS = ("nccl", "gloo")


def new_group(backend: str, store, rank: int, size: int,
              timeout: float = 60.0, prefix: str = "model"):
    """A process group of ``size`` ranks on ``backend`` over ``store`` (a
    ``TCPStore`` across processes, a ``HashStore`` across threads),
    namespaced by ``prefix``; this caller is ``rank``. Every rank must call
    it: the constructor meets the others. ``timeout`` (seconds) bounds
    every collective the group runs, so a dead peer fails a call instead
    of hanging it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    span = datetime.timedelta(seconds=float(timeout))
    pstore = dist.PrefixStore(prefix, store)
    if backend == "gloo":
        return dist.ProcessGroupGloo(pstore, int(rank), int(size), span)
    if not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL backend; name "
                           "backend='gloo'")
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = span
    return dist.ProcessGroupNCCL(pstore, int(rank), int(size), opts)


def all_reduce(tensor: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``tensor`` over ``group``'s ranks (``op`` ``"sum"`` or
    ``"max"``), in place; returns it. Waits for the result (on NCCL: the
    current stream waits, the host does not)."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    group.allreduce([tensor], opts).wait()
    return tensor


def broadcast(tensor: torch.Tensor, src: int, group) -> torch.Tensor:
    """Copy rank ``src``'s ``tensor`` into every rank's, in place."""
    opts = dist.BroadcastOptions()
    opts.rootRank = int(src)
    opts.rootTensor = 0
    group.broadcast([tensor], opts).wait()
    return tensor


def all_gather(tensor_list: List[torch.Tensor], tensor: torch.Tensor,
               group) -> List[torch.Tensor]:
    """Every rank's ``tensor`` into ``tensor_list[rank]`` (the list holds
    one tensor of ``tensor``'s shape per rank). CPU tensors or NCCL."""
    group.allgather([tensor_list], [tensor]).wait()
    return tensor_list


def gather_by_sum(local: torch.Tensor, lo: int, total: int,
                  group: Optional[object]) -> torch.Tensor:
    """The last axis gathered whole on every rank: ``local`` ``[..., n]``
    is this rank's slice ``[lo, lo + n)`` of ``[..., total]``; it is
    written into a zeroed buffer and the buffers summed over ``group``
    (one code path on both backends). Every element has one contributor,
    so the result is exact."""
    out = torch.zeros(local.shape[:-1] + (int(total),), dtype=local.dtype,
                      device=local.device)
    out[..., lo:lo + local.shape[-1]] = local
    if group is not None:
        all_reduce(out, group)
    return out


def backend_of(group) -> str:
    """``"nccl"`` or ``"gloo"``: the backend ``group`` was built on."""
    return "nccl" if isinstance(group, getattr(dist, "ProcessGroupNCCL",
                                               ())) else "gloo"


def get_rank(group) -> int:
    """This caller's rank in ``group``."""
    return int(group.rank())


def get_world_size(group) -> int:
    """The ranks of ``group``."""
    return int(group.size())


def barrier(group) -> None:
    """Return once every rank of ``group`` has called it (a one-element
    sum, on the host for gloo and on the current card for NCCL)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend_of(group) == "nccl" else torch.device("cpu"))
    all_reduce(torch.zeros(1, device=dev), group)


def all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``local`` ``[n, ...]`` stacked along dim 0 in rank
    order: ``[size * n, ...]`` on every rank (exact on both backends)."""
    size, rank = get_world_size(group), get_rank(group)
    n = local.shape[0]
    if size == 1:
        return local.clone()
    if backend_of(group) == "nccl":
        out = torch.empty((size * n,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        group._allgather_base(out, local.contiguous()).wait()
        return out
    out = torch.zeros((size * n,) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    out[rank * n:(rank + 1) * n] = local
    return all_reduce(out, group)


def reduce_scatter(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``tensor`` ``[size * n, ...]``, this rank's
    rows ``[rank * n, (rank + 1) * n)`` of it (a new tensor)."""
    size, rank = get_world_size(group), get_rank(group)
    if tensor.shape[0] % size:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(tensor.shape)} "
                         f"does not divide {size} ranks")
    n = tensor.shape[0] // size
    if backend_of(group) == "nccl" and size > 1:
        out = torch.empty((n,) + tuple(tensor.shape[1:]), dtype=tensor.dtype,
                          device=tensor.device)
        group._reduce_scatter_base(out, tensor.contiguous()).wait()
        return out
    whole = all_reduce(tensor.detach().clone(), group)
    return whole[rank * n:(rank + 1) * n].clone()


def ppermute_by_sum(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """:func:`ppermute` built from ``all_reduce``: each rank writes ``x``
    into slot ``(r + shift) mod n`` of a zeroed ``[n, *x.shape]`` buffer,
    the buffers are summed and each rank keeps its own slot (one
    contributor an element: exact)."""
    n, r = get_world_size(group), get_rank(group)
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[(r + shift) % n] = x
    return all_reduce(buf, group)[r].clone()


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The tensor rank ``(r - shift) mod n`` of ``group`` holds, received
    while this rank's ``x`` goes to rank ``(r + shift) mod n`` (every rank
    calls it with a tensor of one shape and dtype; a new tensor)."""
    n, r = get_world_size(group), get_rank(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    if backend_of(group) == "gloo" and x.is_cuda:
        return ppermute_by_sum(x, group, shift)
    x = x.contiguous()
    out = torch.empty_like(x)
    dst, src = (r + shift) % n, (r - shift) % n

    def send():
        group.send([x], dst, 0).wait()

    def recv():
        group.recv([out], src, 0).wait()

    for step in ((send, recv) if r % 2 == 0 else (recv, send)):
        step()
    return out


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``x`` split into ``n`` equal pieces along ``split_dim``, piece ``j``
    sent to rank ``j``, and the ``n`` pieces received (rank order)
    concatenated along ``concat_dim`` (``lax.all_to_all(..., tiled=True)``).
    """
    n, r = get_world_size(group), get_rank(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide {n} ranks")
    if n == 1:
        return x.clone()
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(send)
    group.alltoall_base(out, send, [], [], dist.AllToAllOptions()).wait()
    return torch.cat(out.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; its backward the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, int(split_dim), int(concat_dim))
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return (all_to_all(g.contiguous(), group, concat_dim, split_dim),
                None, None, None)


def all_to_all_autograd(x: torch.Tensor, group, split_dim: int,
                        concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all` with autograd (the reverse all-to-all
    backward)."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _CopyToModelParallel(torch.autograd.Function):
    """*f*: the identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    """*g*: the sum over the group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModelParallel(torch.autograd.Function):
    """The last axis gathered whole forward, this rank's slice of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, lo, total, group):
        ctx.lo, ctx.n = int(lo), x.shape[-1]
        return gather_by_sum(x, lo, total, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n].contiguous(), None, None, None


def _taped(x) -> bool:
    """Whether autograd records an op on ``x`` (host flags: a captured
    serving step runs under no_grad and takes the in-place path)."""
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """*f* over ``group``: ``x`` itself, its gradient summed over the ranks
    (``x`` untouched when no gradient is recorded)."""
    return _CopyToModelParallel.apply(x, group) if _taped(x) else x


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """*g* over ``group``: ``x`` summed over the ranks, the gradient passed
    through. Without a recorded gradient the sum runs in place (the serving
    path's :func:`all_reduce`)."""
    # analysis: allow(traced-branch) -- requires_grad is a host flag
    if _taped(x):
        return _ReduceFromModelParallel.apply(x, group)
    return all_reduce(x, group)


def gather_from_model_parallel(x: torch.Tensor, lo: int, total: int,
                               group) -> torch.Tensor:
    """:func:`gather_by_sum` whose backward takes this rank's slice
    ``[lo, lo + n)`` of the gradient."""
    # analysis: allow(traced-branch) -- requires_grad is a host flag
    if _taped(x):
        return _GatherFromModelParallel.apply(x, lo, total, group)
    return gather_by_sum(x, lo, total, group)
