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
element, so the sum is exact.
"""
from __future__ import annotations

import datetime
from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "new_group", "all_reduce", "broadcast", "all_gather",
           "gather_by_sum"]

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
