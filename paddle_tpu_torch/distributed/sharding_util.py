"""The sharding rules of tensor-parallel serving (counterpart of
``paddle_tpu/distributed/sharding_util.py``: ``mesh_axes_key``,
``shard_kv_entry`` ``:248`` and the rule of ``headwise_shard_map``
``:119-166``).

The JAX package annotates: weights and pools are placed with a
``NamedSharding`` and the paged kernels run under ``shard_map`` over the
local heads. Here each rank holds its shard as an ordinary tensor, and
these functions state which part of a whole array a rank holds:

* attention is split by heads: rank ``r`` of ``mp`` holds heads ``[r * H
  / mp, (r + 1) * H / mp)``. The fused ``qkv`` weight is paddle's ``[in,
  3h]`` laid out as ``[3, H, D]`` (``paddle_tpu/models/gpt.py:288-290``),
  so a rank's columns are its heads' columns of each of q, k and v
  (:func:`qkv_columns`), never one contiguous third; the output
  projection's rows are its heads' (:func:`head_rows`).
* the KV arena's payload pools hold ``H / mp`` heads per rank; the int8
  arena's per-row scale pools are whole on every rank
  (:func:`shard_kv_entry`). Heads that do not divide ``mp`` stay whole on
  every rank (the JAX guard, ``:268-276``): attention is then computed
  whole on every rank, and no collective joins it.
* the MLP's up projection is split by contiguous columns and its down
  projection by the same rows; the vocabulary by contiguous rows of the
  token embedding. An axis that does not divide ``mp`` stays whole.

There is no ``shard_map``: each rank calls a kernel on its local heads
(:func:`local_heads`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["MODEL_AXIS", "mesh_axes_key", "model_parallel", "model_rank",
           "local_heads", "heads_split", "split_range", "qkv_columns",
           "head_rows", "shard_kv_entry"]

MODEL_AXIS = "model"


def mesh_axes_key(mesh) -> Optional[Tuple]:
    """The hashable fingerprint of a mesh, ``((axis, size), ...)`` over the
    axes of size above 1 (``(("data", 1),)`` when there are none), or None
    without a mesh: the JAX package's key for the same sizes. A one-rank
    mesh keys differently from no mesh on purpose."""
    if mesh is None:
        return None
    axes = tuple((a, int(n)) for a, n in mesh.shape.items() if int(n) > 1)
    return axes or (("data", 1),)


def model_parallel(mesh) -> int:
    """Ranks on the model axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.model_parallel)


def model_rank(mesh) -> int:
    """This rank's place on the model axis (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.model_rank)


def heads_split(num_heads: int, mesh) -> bool:
    """Whether attention is split by heads over the model axis: more than
    one rank, and the heads divide them."""
    mp = model_parallel(mesh)
    return mp > 1 and int(num_heads) % mp == 0


def local_heads(num_heads: int, mesh) -> int:
    """The heads a rank attends and holds in its pools: ``num_heads //
    mp`` when they divide, else all of them."""
    if heads_split(num_heads, mesh):
        return int(num_heads) // model_parallel(mesh)
    return int(num_heads)


def split_range(n: int, mesh) -> Tuple[int, int]:
    """This rank's contiguous slice ``[lo, hi)`` of an axis of ``n``: an
    ``mp``-th when ``mp`` divides ``n``, else the whole axis."""
    mp = model_parallel(mesh)
    if mp == 1 or int(n) % mp:
        return 0, int(n)
    per = int(n) // mp
    lo = model_rank(mesh) * per
    return lo, lo + per


def qkv_columns(num_heads: int, head_dim: int, mesh) -> np.ndarray:
    """The columns of the fused ``[in, 3 * H * D]`` qkv weight (and of its
    bias and int8 scale) that this rank holds: of each of q, k and v, the
    ``D`` columns of every local head, in order, so the local output
    reshapes as ``[..., 3, H / mp, D]``."""
    h = int(num_heads) * int(head_dim)
    lo, hi = head_rows(num_heads, head_dim, mesh)
    return np.concatenate([np.arange(j * h + lo, j * h + hi)
                           for j in range(3)]).astype(np.int64)


def head_rows(num_heads: int, head_dim: int, mesh) -> Tuple[int, int]:
    """The slice ``[lo, hi)`` of a ``H * D`` axis laid out ``[H, D]`` that
    carries this rank's heads (the output projection's input rows)."""
    nh = local_heads(num_heads, mesh)
    first = model_rank(mesh) * nh if heads_split(num_heads, mesh) else 0
    return first * int(head_dim), (first + nh) * int(head_dim)


def shard_kv_entry(entry, mesh):
    """This rank's shard of one whole pool entry ``(k, v)`` ``[NB, bs, H,
    D]`` or int8 ``(k, v, k_scale, v_scale)``: the payloads' heads sliced
    to the local heads, the ``[NB, bs]`` scale pools whole (every head's
    dequant reads them). Heads that do not divide ``mp`` stay whole. On
    arrays (numpy or torch); the arena allocates its pools at the shapes
    this gives for the whole entry's (``KVArena._fresh_entry``, on meta
    tensors)."""
    out = []
    for i, arr in enumerate(entry):
        if i < 2 and heads_split(arr.shape[2], mesh):
            nh = local_heads(arr.shape[2], mesh)
            lo = model_rank(mesh) * nh
            out.append(arr[:, :, lo:lo + nh])
        else:
            out.append(arr)
    return tuple(out)
