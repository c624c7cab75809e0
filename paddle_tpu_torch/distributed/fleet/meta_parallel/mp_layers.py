"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``:
``VocabParallelEmbedding`` ``:24``, ``ColumnParallelLinear`` ``:41``,
``RowParallelLinear`` ``:71``).

The JAX layers keep the logical shape and let GSPMD insert the collectives.
Here each layer is an ``nn.Module`` that holds only its rank's shard, in
paddle's ``[in, out]`` layout, and calls the collective itself over its
mesh's model group (:mod:`paddle_tpu_torch.distributed.collective`):

* :class:`ColumnParallelLinear` holds the output columns ``columns`` of a
  whole ``[in, out]`` weight (and of its bias and int8 scale); its output
  stays split. With ``gather_output`` the columns are gathered whole on
  every rank (the vocab-parallel head of an untied model).
* :class:`RowParallelLinear` holds the input rows ``[lo, hi)``; it
  multiplies its split input, all-reduces the partial products and adds
  its (whole) bias once, after the reduce.
* :class:`VocabParallelEmbedding` holds the rows ``[lo, hi)`` of the token
  embedding; ids outside its range look up row 0 and are zeroed, and the
  ranks' rows are summed. :meth:`VocabParallelEmbedding.logits` is the tied
  head over the same shard, gathered whole on every rank.

An axis that does not divide the ranks is held whole on every rank
(``sharding_util``); a row linear then adds no collective. On a one-rank
mesh every layer still runs its collective (the identity), so the
programs of tp = 1 hold the same collectives as those of tp > 1.

Each layer is made from a whole :class:`paddle_tpu_torch.nn.layers.Linear`
or ``Embedding`` (``from_linear``, ``from_embedding``): the serving engine
shards a model in place (``models.gpt.shard_model``), after any int8
quantization of the whole weights.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .... import amp
from ....nn.layers import Linear
from ... import collective
from ...sharding_util import model_parallel, split_range

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "is_split"]


def is_split(module) -> bool:
    """Whether ``module`` is a parallel layer holding part of its whole
    weight (a model sharded over more than one rank)."""
    return bool(getattr(module, "split", False))


def _take(t: torch.Tensor, index, dim: int) -> torch.Tensor:
    """A contiguous copy of ``t``'s ``index`` along ``dim`` (an index
    array, or a ``(lo, hi)`` slice)."""
    if isinstance(index, tuple):
        return t.narrow(dim, index[0], index[1] - index[0]).contiguous()
    idx = torch.as_tensor(index, dtype=torch.long, device=t.device)
    return t.index_select(dim, idx).contiguous()


def _reduces(split: bool, mesh) -> bool:
    """A row-split layer all-reduces its partial products; at one rank the
    reduce is the identity and still runs."""
    return split or model_parallel(mesh) == 1


class ColumnParallelLinear(Linear):
    """``y = x @ W[:, columns] + b[columns]``: the output columns
    ``columns`` (an index array into ``out_features``) of a whole weight.
    With ``gather_output`` the split output is gathered whole on every
    rank; the columns must then be one contiguous slice."""

    def __init__(self, in_features: int, out_features: int, mesh,
                 columns: Optional[Sequence[int]] = None,
                 has_bias: bool = True, gather_output: bool = False,
                 device=None):
        cols = (np.arange(out_features) if columns is None
                else np.asarray(columns, np.int64))
        super().__init__(in_features, int(cols.size), device=device,
                         bias=has_bias)
        self.mesh = mesh
        self.columns = cols
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.split = int(cols.size) != int(out_features)
        self.gather_output = bool(gather_output)
        if self.gather_output and cols.size and not np.array_equal(
                cols, np.arange(cols[0], cols[0] + cols.size)):
            raise ValueError("a gathered column split must be contiguous")

    @classmethod
    def from_linear(cls, lin, mesh, columns,
                    gather_output: bool = False) -> "ColumnParallelLinear":
        """The shard of the whole ``lin`` (weight ``[in, out]``, its bias
        and an int8 ``weight_scale`` ``[1, out]``) at ``columns``."""
        fi, fo = (int(d) for d in lin.weight.shape)
        out = cls(fi, fo, mesh, columns, has_bias=lin.bias is not None,
                  gather_output=gather_output, device="meta")
        idx = out.columns
        with torch.no_grad():
            out.weight = nn.Parameter(_take(lin.weight, idx, 1),
                                      requires_grad=lin.weight.requires_grad)
            if lin.bias is not None:
                out.bias = nn.Parameter(_take(lin.bias, idx, 0),
                                        requires_grad=lin.bias.requires_grad)
            scale = getattr(lin, "weight_scale", None)
            if scale is not None:
                out.register_buffer("weight_scale", _take(scale, idx, 1))
        return out

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The split output ``[..., len(columns)]`` whole on every rank."""
        if not self.gather_output:
            return y
        lo = int(self.columns[0]) if self.columns.size else 0
        return collective.gather_by_sum(y, lo, self.out_features,
                                        self.mesh.group)

    def forward(self, x):
        return self.gather(super().forward(x))


class RowParallelLinear(Linear):
    """``y = all_reduce(x_local @ W[lo:hi]) + b``: the input rows
    ``[lo, hi)`` of a whole weight, the bias whole and added once, after
    the reduce. The input is this rank's split of the whole input."""

    def __init__(self, in_features: int, out_features: int, mesh,
                 rows=None, has_bias: bool = True, device=None):
        lo, hi = (0, int(in_features)) if rows is None else rows
        super().__init__(hi - lo, out_features, device=device, bias=has_bias)
        self.mesh = mesh
        self.rows = (int(lo), int(hi))
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.split = (hi - lo) != int(in_features)
        #: whether the partial products are all-reduced (:func:`_reduces`)
        self.reduces = _reduces(self.split, mesh)

    @classmethod
    def from_linear(cls, lin, mesh, rows) -> "RowParallelLinear":
        """The shard of the whole ``lin`` at input rows ``rows``; its bias
        and an int8 ``weight_scale`` ``[1, out]`` stay whole (the scale is
        the whole weight's: quantize before sharding)."""
        fi, fo = (int(d) for d in lin.weight.shape)
        out = cls(fi, fo, mesh, rows, has_bias=lin.bias is not None,
                  device="meta")
        with torch.no_grad():
            out.weight = nn.Parameter(_take(lin.weight, out.rows, 0),
                                      requires_grad=lin.weight.requires_grad)
            if lin.bias is not None:
                out.bias = nn.Parameter(lin.bias.detach().clone(),
                                        requires_grad=lin.bias.requires_grad)
            scale = getattr(lin, "weight_scale", None)
            if scale is not None:
                out.register_buffer("weight_scale", scale.detach().clone())
        return out

    def partial(self, x):
        """This rank's partial product ``x_local @ W_local``, no bias."""
        x, w = amp.cast_inputs("linear_nb", x, self.weight)
        return torch.matmul(x, w)

    def reduce(self, y):
        """Sum the ranks' partial products, in place (the identity without
        a split at more than one rank)."""
        if self.reduces:
            collective.all_reduce(y, self.mesh.group)
        return y

    def add_bias(self, y):
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype)

    def forward(self, x):
        if self.bias is None:
            return self.reduce(self.partial(x))
        x, w, b = amp.cast_inputs("linear", x, self.weight, self.bias)
        y = self.reduce(torch.matmul(x, w))
        return y + b


class VocabParallelEmbedding(nn.Module):
    """The token embedding's rows ``[lo, hi)``; a lookup masks the ids
    outside the range and sums the ranks' rows."""

    def __init__(self, num_embeddings: int, embedding_dim: int, mesh,
                 rows=None, device=None):
        super().__init__()
        lo, hi = (0, int(num_embeddings)) if rows is None else rows
        self.weight = nn.Parameter(torch.empty(hi - lo, embedding_dim,
                                               device=device))
        self.mesh = mesh
        self.rows = (int(lo), int(hi))
        self.num_embeddings = int(num_embeddings)
        self.split = (hi - lo) != int(num_embeddings)
        self.reduces = _reduces(self.split, mesh)

    @classmethod
    def from_embedding(cls, emb, mesh) -> "VocabParallelEmbedding":
        """This rank's rows of the whole embedding ``emb``
        (``split_range`` of its vocabulary)."""
        n, d = (int(x) for x in emb.weight.shape)
        out = cls(n, d, mesh, split_range(n, mesh), device="meta")
        with torch.no_grad():
            out.weight = nn.Parameter(_take(emb.weight, out.rows, 0),
                                      requires_grad=emb.weight.requires_grad)
        return out

    def forward(self, ids):
        if not self.reduces:
            return F.embedding(ids, self.weight)
        lo, hi = self.rows
        inside = (ids >= lo) & (ids < hi)
        rows = F.embedding(torch.where(inside, ids - lo, 0), self.weight)
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return collective.all_reduce(rows, self.mesh.group)

    def logits(self, h, weight=None):
        """The tied head ``h @ W^T`` over this shard (``weight``: the shard
        as the caller cast it), gathered whole on every rank: ``[...,
        num_embeddings]``."""
        w = self.weight if weight is None else weight
        local = torch.matmul(h, w.t())
        if not self.reduces:
            return local
        return collective.gather_by_sum(local, self.rows[0],
                                        self.num_embeddings, self.mesh.group)
