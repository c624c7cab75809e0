"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``:
``VocabParallelEmbedding`` ``:24``, ``ColumnParallelLinear`` ``:41``,
``RowParallelLinear`` ``:71``, ``ParallelCrossEntropy`` ``:101``).

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

Gradients (GSPMD transposes the JAX layers' collectives; here each is an
autograd pair of :mod:`..collective`): a column layer's input and the tied
head's input pass through *f* (identity forward, the gradient summed over
the model group), a row layer's partial products and the embedding's rows
through *g* (summed forward, the gradient passed through), and a gathered
output's gradient is sliced back to this rank's columns. Without a
recorded gradient (serving) the layers run their in-place collectives as
before. A split shard's parameters carry ``is_distributed = True``,
``split_mesh`` (the mesh whose model group holds the other parts), which
the global-norm clip reads, and ``split_index`` (where their part sits in
the whole), which a checkpoint reads to save them whole and load a whole
value onto them; a replicated parameter (a row layer's bias) carries
none. :class:`ParallelCrossEntropy` is the loss over a
vocabulary split by rows: it never gathers ``[tokens, vocab]``.
"""
from __future__ import annotations

import threading
import weakref
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
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_cross_entropy", "is_split"]


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


#: every live split parameter: a state dict's detached leaves share their
#: parameter's storage, by which :func:`split_of` finds it
_SPLITS = weakref.WeakSet()
_SPLITS_LOCK = threading.Lock()  # ranks that are threads mark and look up


def _mark(param, mesh, dim: int, index, whole: int):
    """Tag a split shard's parameter (see the module docstring): it holds
    ``index`` (an index array, or a ``(lo, hi)`` slice) of the ``whole``
    entries of dim ``dim``."""
    param.is_distributed = True
    param.split_mesh = mesh
    param.split_index = (int(dim), index, int(whole))
    with _SPLITS_LOCK:
        _SPLITS.add(param)
    return param


def split_of(t: torch.Tensor):
    """The split parameter ``t`` is, or whose storage and shape it shares
    (a state dict's leaf); None for any other tensor."""
    if getattr(t, "split_index", None) is not None:
        return t
    ptr = t.data_ptr()
    with _SPLITS_LOCK:
        splits = list(_SPLITS)
    return next((p for p in splits if p.data_ptr() == ptr and
                 p.shape == t.shape and p.dtype == t.dtype), None)


def split_indices(p) -> torch.Tensor:
    """The whole's entries, along ``p.split_index``'s dim, that the split
    parameter ``p`` holds."""
    _, index, _ = p.split_index
    if isinstance(index, tuple):
        return torch.arange(index[0], index[1])
    return torch.as_tensor(np.asarray(index), dtype=torch.long)


def _copy_in(layer, x):
    """*f* on a split layer's input while a gradient is recorded."""
    # analysis: allow(traced-branch) -- requires_grad is a host flag; a
    # captured serving step runs under no_grad
    if layer.reduces and torch.is_grad_enabled() and x.requires_grad:
        return collective.copy_to_model_parallel(x, layer.mesh.group)
    return x


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
        #: whether its input's gradient is summed over the model group
        self.reduces = _reduces(self.split, mesh)
        self.gather_output = bool(gather_output)
        if self.gather_output and cols.size and not np.array_equal(
                cols, np.arange(cols[0], cols[0] + cols.size)):
            raise ValueError("a gathered column split must be contiguous")
        if self.split:
            _mark(self.weight, mesh, 1, cols, self.out_features)
            if self.bias is not None:
                _mark(self.bias, mesh, 0, cols, self.out_features)

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
        if out.split:
            _mark(out.weight, mesh, 1, idx, fo)
            if out.bias is not None:
                _mark(out.bias, mesh, 0, idx, fo)
        return out

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The split output ``[..., len(columns)]`` whole on every rank."""
        if not self.gather_output:
            return y
        lo = int(self.columns[0]) if self.columns.size else 0
        return collective.gather_from_model_parallel(y, lo, self.out_features,
                                                     self.mesh.group)

    def forward(self, x):
        return self.gather(super().forward(_copy_in(self, x)))


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
        if self.split:
            _mark(self.weight, mesh, 0, self.rows, self.in_features)

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
        if out.split:
            _mark(out.weight, mesh, 0, out.rows, fi)
        return out

    def partial(self, x):
        """This rank's partial product ``x_local @ W_local``, no bias."""
        x, w = amp.cast_inputs("linear_nb", x, self.weight)
        return torch.matmul(x, w)

    def reduce(self, y):
        """Sum the ranks' partial products (*g*: in place when no gradient
        is recorded; the identity without a split at more than one
        rank)."""
        if self.reduces:
            return collective.reduce_from_model_parallel(y, self.mesh.group)
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
        if self.split:
            _mark(self.weight, mesh, 0, self.rows, self.num_embeddings)

    @classmethod
    def from_embedding(cls, emb, mesh) -> "VocabParallelEmbedding":
        """This rank's rows of the whole embedding ``emb``
        (``split_range`` of its vocabulary)."""
        n, d = (int(x) for x in emb.weight.shape)
        out = cls(n, d, mesh, split_range(n, mesh), device="meta")
        with torch.no_grad():
            out.weight = nn.Parameter(_take(emb.weight, out.rows, 0),
                                      requires_grad=emb.weight.requires_grad)
        if out.split:
            _mark(out.weight, mesh, 0, out.rows, n)
        return out

    def forward(self, ids):
        if not self.reduces:
            return F.embedding(ids, self.weight)
        lo, hi = self.rows
        inside = (ids >= lo) & (ids < hi)
        rows = F.embedding(torch.where(inside, ids - lo, 0), self.weight)
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return collective.reduce_from_model_parallel(rows, self.mesh.group)

    def local_logits(self, h, weight=None):
        """The tied head over this shard, ``h @ W_local^T`` ``[..., hi -
        lo]`` (``weight``: the shard as the caller cast it), ``h`` through
        *f*: the logits a vocab-parallel loss reads."""
        w = self.weight if weight is None else weight
        return torch.matmul(_copy_in(self, h), w.t())

    def logits(self, h, weight=None):
        """The tied head ``h @ W^T`` over this shard, gathered whole on
        every rank: ``[..., num_embeddings]``."""
        local = self.local_logits(h, weight)
        if not self.reduces:
            return local
        return collective.gather_from_model_parallel(
            local, self.rows[0], self.num_embeddings, self.mesh.group)


class _ParallelCE(torch.autograd.Function):
    """Per-row cross entropy of logits split by columns over ``group``:
    the row max, the sum of exps and the picked logit all-reduced, the
    backward local (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, logits, label, group, lo, ignore_index):
        x = logits.float()
        n = x.shape[-1]
        m = x.max(dim=-1).values
        collective.all_reduce(m, group, op="max")
        e = torch.exp(x - m[:, None])
        s = e.sum(dim=-1)
        collective.all_reduce(s, group)
        keep = label != ignore_index
        inside = keep & (label >= lo) & (label < lo + n)
        at = torch.where(inside, label - lo, torch.zeros_like(label))
        picked = torch.where(inside, logits.gather(-1, at[:, None])[:, 0]
                             .float(), torch.zeros_like(m))
        collective.all_reduce(picked, group)
        loss = torch.where(keep, torch.log(s) + m - picked,
                           torch.zeros_like(m))
        ctx.save_for_backward(e, s, at, inside, keep)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, at, inside, keep = ctx.saved_tensors
        g = torch.where(keep, g, torch.zeros_like(g))
        d = e * (g / s)[:, None]
        d.scatter_add_(-1, at[:, None],
                       -torch.where(inside, g, torch.zeros_like(g))[:, None])
        return d.to(ctx.dtype), None, None, None, None


def parallel_cross_entropy(logits, label, group, lo: int,
                           ignore_index: int = -100):
    """Each row's cross entropy ``logsumexp(x) - x[label]`` (0 where the
    label is ``ignore_index``) of logits ``[N, n]`` holding the columns
    ``[lo, lo + n)`` of a vocabulary split over ``group``, in f32, as the
    JAX package's ``cross_entropy`` computes it over the whole row: the
    ranks' row maxima, sums of exps and picked logits are all-reduced, and
    nothing ``[N, vocab]`` is made."""
    return _ParallelCE.apply(logits, label.reshape(-1).long(), group,
                             int(lo), int(ignore_index))


class ParallelCrossEntropy(nn.Module):
    """``ParallelCrossEntropy`` (``paddle_tpu/distributed/fleet/
    meta_parallel/mp_layers.py:101``): the per-token loss (``reduction=
    "none"``) of this rank's vocabulary-split logits ``[..., n]``, the
    ``n`` columns of model rank ``r`` being ``[r * n, (r + 1) * n)``.
    ``mp_group``: a mesh (its model group) or a process group; by default
    the calling thread's training mesh."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        group = self.mp_group
        if group is None:
            from ...mesh import get_hybrid_mesh

            group = get_hybrid_mesh()
            if group is None:
                raise RuntimeError("ParallelCrossEntropy: no mp_group and "
                                   "no training mesh on this thread")
        group = getattr(group, "group", group)
        n = input.shape[-1]
        lo = collective.get_rank(group) * n
        out = parallel_cross_entropy(input.reshape(-1, n), label, group, lo,
                                     self.ignore_index)
        return out.reshape(label.shape)
