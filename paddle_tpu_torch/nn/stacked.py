"""Stacked layers (counterpart of ``paddle_tpu/nn/stacked.py:27
StackedLayers``).

The JAX package holds ``num_layers`` structurally identical layers as ONE
template plus parameters stacked along a leading layer dim and scans over
it. The port keeps that state: each of the template's parameters becomes a
parameter ``[rows, ...]`` named as the JAX package names it (the
template's name with ``.`` replaced by ``__``), so a JAX ``PipelineLayer``'s
``blocks.*`` leaves map one to one. Layer ``i`` runs the template with its
row of each (``torch.func.functional_call``; gradients reach the stacked
parameters through the row views) under ``key_guard(fold_in(base_key,
i))``, so its dropout draws the JAX package's bits.

A pipe rank holds only the rows of its stage (``rows``, the global layer
indices, in local order): those parameters carry ``pipe_rows``,
``pipe_whole`` and ``pipe_mesh``, which the global-norm clip and the
checkpoint read (a whole ``[num_layers, ...]`` is gathered over the pipe
group on save, and a rank takes its rows on load). Split over a model axis
(:meth:`StackedLayers.split_template`) each stacked parameter holds the
split template's part of every row, tagged as the parallel layers tag
theirs (``split_index`` one dim further out).
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core import rng

__all__ = ["StackedLayers", "pipe_split_of", "mark_pipe_rows"]

#: every live pipe-split parameter: a state dict's detached leaves share
#: their parameter's storage, by which :func:`pipe_split_of` finds it
_PIPE = weakref.WeakSet()
_PIPE_LOCK = threading.Lock()


def mark_pipe_rows(param, mesh, rows: Sequence[int], whole: int):
    """Tag a stacked parameter that holds layers ``rows`` of ``whole``
    along dim 0, the other rows on the other ranks of ``mesh``'s pipe
    group."""
    param.pipe_rows = np.asarray(rows, np.int64)
    param.pipe_whole = int(whole)
    param.pipe_mesh = mesh
    with _PIPE_LOCK:
        _PIPE.add(param)
    return param


def pipe_split_of(t: torch.Tensor):
    """The pipe-split parameter ``t`` is, or whose storage and shape it
    shares (a state dict's leaf); None for any other tensor."""
    if getattr(t, "pipe_rows", None) is not None:
        return t
    if t.device.type == "meta":
        return None
    ptr = t.data_ptr()
    with _PIPE_LOCK:
        params = list(_PIPE)
    return next((p for p in params if p.device == t.device and
                 p.data_ptr() == ptr and p.shape == t.shape and
                 p.dtype == t.dtype), None)


def _on_meta(factory, i) -> nn.Module:
    """Layer ``i`` of ``factory`` with its tensors on the ``meta`` device
    (where the factory names no device): a layer this module does not hold
    is built for its structure only."""
    with torch.device("meta"):
        return factory(i)


def _signature(layer: nn.Module):
    return tuple((n, tuple(p.shape), str(p.dtype))
                 for n, p in layer.named_parameters())


class StackedLayers(nn.Module):
    """``num_layers`` structurally identical layers with stacked
    parameters. ``factory(i)`` builds layer ``i``; ``rows`` (default all)
    are the layers this module holds, and the others are built on the
    ``meta`` device (structure only). Layers with buffers are refused, as
    in the JAX package. ``remat`` runs each layer of :meth:`forward` under
    recompute."""

    def __init__(self, factory: Callable[[int], nn.Module], num_layers: int,
                 remat: bool = False, rows: Optional[Sequence[int]] = None):
        super().__init__()
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self.num_layers = int(num_layers)
        self.remat = bool(remat)
        self.rows: List[int] = (list(range(self.num_layers)) if rows is None
                                else [int(r) for r in rows])
        held = set(self.rows)
        insts = [factory(i) if i in held else _on_meta(factory, i)
                 for i in range(self.num_layers)]
        template = insts[0]
        if any(True for _ in template.named_buffers()):
            raise ValueError("StackedLayers does not support layers with "
                             "buffers")
        sig = _signature(template)
        if any(_signature(l) != sig for l in insts[1:]):
            raise ValueError("StackedLayers needs structurally identical "
                             "layers")
        self._t_names = [n for n, _ in template.named_parameters()]
        by_layer = [dict(insts[i].named_parameters()) for i in self.rows]
        for n in self._t_names:
            first = by_layer[0][n]
            with torch.no_grad():
                stacked = torch.stack([d[n].detach() for d in by_layer])
            self.register_parameter(n.replace(".", "__"), nn.Parameter(
                stacked, requires_grad=first.requires_grad))
        # the template's own weights are the stacked rows': it keeps only
        # its structure
        template.to("meta")
        object.__setattr__(self, "_template", template)
        template.train(self.training)

    def train(self, mode: bool = True):
        super().train(mode)
        self._template.train(mode)
        return self

    @property
    def template(self) -> nn.Module:
        return self._template

    def stacked_parameters(self) -> List[nn.Parameter]:
        """The stacked parameters, in the template's parameter order."""
        return [getattr(self, n.replace(".", "__")) for n in self._t_names]

    def mark_pipe(self, mesh) -> None:
        """Tag every stacked parameter as this pipe rank's rows."""
        for p in self.stacked_parameters():
            mark_pipe_rows(p, mesh, self.rows, self.num_layers)

    def split_template(self, split: Callable[[nn.Module], None]) -> None:
        """``split(template)`` replaces the template's layers by parallel
        ones holding parts of each weight (``models.gpt``'s block split);
        every stacked parameter whose template parameter is then a part
        (``split_index`` ``(dim, index, whole)``) keeps that part of each
        row along ``dim + 1``."""
        from ..distributed.fleet.meta_parallel.mp_layers import (
            _mark, split_indices)

        split(self._template)
        tparams = dict(self._template.named_parameters())
        for n in self._t_names:
            part = tparams[n]
            if getattr(part, "split_index", None) is None:
                continue
            dim, index, whole = part.split_index
            old = getattr(self, n.replace(".", "__"))
            idx = split_indices(part).to(old.device)
            with torch.no_grad():
                new = nn.Parameter(old.index_select(dim + 1, idx).contiguous(),
                                   requires_grad=old.requires_grad)
            _mark(new, part.split_mesh, dim + 1, index, whole)
            if getattr(old, "pipe_rows", None) is not None:
                mark_pipe_rows(new, old.pipe_mesh, old.pipe_rows,
                               old.pipe_whole)
            setattr(self, n.replace(".", "__"), new)

    def apply_one(self, arrays, h, layer_key):
        """The template on ``h`` with one layer's parameters ``arrays``
        (template order), drawing under ``layer_key``."""
        with rng.key_guard(layer_key):
            return torch.func.functional_call(
                self._template, dict(zip(self._t_names, arrays)), (h,))

    def run(self, arrays, h, base_key, first: int):
        """Layers ``first, first + 1, ...`` of the whole stack on ``h``:
        ``arrays`` their stacked parameters (``[n, ...]`` each, template
        order); layer ``j`` draws under ``fold_in(base_key, j)``."""
        for i in range(arrays[0].shape[0]):
            h = self.apply_one([a[i] for a in arrays], h,
                               rng.fold_in(base_key, first + i))
        return h

    def forward(self, x):
        """Every held layer in turn (all of them: ``rows`` is the whole
        stack off a pipe axis), under one ``rng.next_key()``."""
        from ..distributed.fleet.recompute import recompute

        key = rng.next_key(x.device)
        params = self.stacked_parameters()
        for i, j in enumerate(self.rows):
            arrays = [p[i] for p in params]
            if self.remat and torch.is_grad_enabled():
                x = recompute(self.apply_one, arrays, x,
                              rng.fold_in(key, j))
            else:
                x = self.apply_one(arrays, x, rng.fold_in(key, j))
        return x
