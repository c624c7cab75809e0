"""Pipeline layer segmentation (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``: ``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer``).

The contract is the JAX package's: the layer list holds one maximal run of
structurally identical layers (the blocks), split into ``num_stages x
num_virtual_pipeline_stages`` equal parts; the layers before and after it
(embedding, final norm, head) are the pre and post sections. The port
differs in where things live:

* The blocks are a :class:`~paddle_tpu_torch.nn.stacked.StackedLayers`
  holding only this pipe rank's rows: stage ``s`` holds blocks ``[s*per,
  (s+1)*per)``, and under the interleaved schedule device ``d`` holds the
  chunks ``d, d+S, ...`` (global stage ``v*S + d``), ``per`` blocks each.
  On a pipe axis every :class:`LayerDesc` is first built on the ``meta``
  device (shapes only, to find the run), then only the sections and this
  rank's blocks are built for real: a rank never holds the whole model.
* The pre and post sections run on every pipe rank, replicated, as they do
  under GSPMD in the JAX package: each rank embeds the whole batch and
  takes the loss of the replicated outputs, so their parameters' gradients
  are the same on every pipe rank and need no reduce. A tied weight (the
  embedding shared with the head, :class:`SharedLayerDesc`) is one
  parameter used twice on every rank: its two gradient paths are summed
  once, by autograd.
* Dropout keys fold the GLOBAL block index (``(v*S + s)*per + i``) into
  the key the layer draws once, so every schedule draws the same streams
  (``:169-177``): one microbatch's masks are the one-rank schedule's.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn

from ....core import rng
from ....nn.stacked import StackedLayers
from ...mesh import get_hybrid_mesh
from ...pipeline import (PIPE_AXIS, pipeline_apply,
                         pipeline_apply_interleaved)

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A layer to build: ``layer_cls(*args, **kwargs)``."""

    def __init__(self, layer_cls, *args, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, nn.Module)):
            raise TypeError(f"LayerDesc expects a Module subclass, got "
                            f"{layer_cls}")
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self, device=None) -> nn.Module:
        """The layer; with ``device`` built there (a ``device`` keyword of
        the desc is replaced, and factories without one default to it)."""
        if device is None:
            return self.layer_cls(*self.args, **self.kwargs)
        kwargs = dict(self.kwargs)
        if "device" in kwargs:
            kwargs["device"] = device
        with torch.device(device):
            return self.layer_cls(*self.args, **kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A tied layer: every desc of one ``key`` is the same instance (its
    first build); ``forward_func(layer, x)`` runs a later use."""

    def __init__(self, key, layer_cls, *args,
                 forward_func: Optional[Callable] = None,
                 shared_weight_attr: str = "weight", **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _signature(layer: nn.Module):
    return tuple((n, tuple(p.shape), str(p.dtype))
                 for n, p in layer.named_parameters())


def _pipe_of(mesh) -> int:
    return mesh.axis_size(PIPE_AXIS) if mesh is not None else 1


def _rate(v) -> float:
    return float(v) if isinstance(v, (int, float)) else 0.0


def _drops(layer: "PipelineLayer") -> bool:
    """Whether ``layer`` (its sections and its blocks' template) draws
    dropout while training: a ``*Dropout`` module with ``p > 0`` or a
    layer with a ``dropout`` rate (an attention's)."""
    for m in [*layer.modules(), *layer.blocks.template.modules()]:
        if type(m).__name__.endswith("Dropout") and _rate(
                getattr(m, "p", 0)) > 0:
            return True
        if _rate(getattr(m, "dropout", 0)) > 0:
            return True
    return False


class PipelineLayer(nn.Module):
    """A layer list split into stages over the ``pipe`` axis of the
    thread's mesh (see the module docstring). ``num_stages`` defaults to
    the pipe degree; ``recompute_interval > 0`` recomputes each stage's
    forward in the backward; ``num_virtual_pipeline_stages`` > 1 selects
    the interleaved schedule; ``num_microbatches`` splits the batch."""

    def __init__(self, layers: List, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0,
                 num_virtual_pipeline_stages: Optional[int] = None,
                 num_microbatches: int = 1):
        super().__init__()
        self.loss_fn = loss_fn
        self.num_microbatches = int(num_microbatches)
        self.recompute = recompute_interval > 0
        self.num_virtual_stages = int(num_virtual_pipeline_stages or 1)
        mesh = get_hybrid_mesh()
        pipe = _pipe_of(mesh)
        self.num_stages = int(num_stages or pipe)

        # on a pipe axis of this layer's stages the descs are first built
        # on the meta device; this rank's rows are known only after the run
        split = pipe > 1 and pipe == self.num_stages
        shared: dict = {}
        built: List[nn.Module] = []
        funcs: List[Optional[Callable]] = []
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in shared:
                    shared[d.layer_name] = d.build_layer()
                inst = shared[d.layer_name]
                funcs.append(d.forward_func)
            elif isinstance(d, LayerDesc):
                inst = d.build_layer("meta" if split else None)
                funcs.append(None)
            elif isinstance(d, nn.Module):
                inst = d
                funcs.append(None)
            else:
                raise TypeError(f"expected LayerDesc or Module, got "
                                f"{type(d)}")
            built.append(inst)

        # the maximal run of structurally identical layers
        sigs = [_signature(l) for l in built]
        best = (0, 0)
        i = 0
        while i < len(built):
            j = i
            while j + 1 < len(built) and sigs[j + 1] == sigs[i] and sigs[i]:
                j += 1
            if j - i + 1 > best[0]:
                best = (j - i + 1, i)
            i = j + 1
        run_len, run_start = best
        S, V = self.num_stages, self.num_virtual_stages
        parts = S * V
        if run_len < parts:
            raise ValueError(
                f"homogeneous block run of length {run_len} cannot be split "
                f"into {S} stages x {V} virtual chunks")
        if run_len % parts:
            raise ValueError(
                f"{run_len} blocks not divisible by {S} stages x {V} "
                "virtual chunks")
        self.per = run_len // parts

        rows = None
        if split:
            d = mesh.axis_rank(PIPE_AXIS)
            rows = [(v * S + d) * self.per + i for v in range(V)
                    for i in range(self.per)]
            held = {run_start + r for r in rows}
            in_run = range(run_start, run_start + run_len)
            for k, desc in enumerate(layers):
                meta = (isinstance(desc, LayerDesc) and
                        not isinstance(desc, SharedLayerDesc))
                if meta and (k not in in_run or k in held):
                    built[k] = desc.build_layer()
        blocks = built[run_start:run_start + run_len]
        self.blocks = StackedLayers(lambda k: blocks[k], run_len,
                                    remat=self.recompute, rows=rows)
        if rows is not None:
            self.blocks.mark_pipe(mesh)
        self._pre_fns = funcs[:run_start]
        self._post_fns = funcs[run_start + run_len:]
        self._n_pre = run_start
        self._n_post = len(built) - run_start - run_len
        for k, l in enumerate(built[:run_start]):
            self.add_module(f"pre_{k}", l)
        for k, l in enumerate(built[run_start + run_len:]):
            self.add_module(f"post_{k}", l)

    @property
    def _pre(self):
        return [getattr(self, f"pre_{k}") for k in range(self._n_pre)]

    @property
    def _post(self):
        return [getattr(self, f"post_{k}") for k in range(self._n_post)]

    def get_num_stages(self) -> int:
        return self.num_stages

    @staticmethod
    def _run_section(layers, fns, x):
        for l, f in zip(layers, fns):
            x = f(l, x) if f is not None else l(x)
        return x

    def _pipelined(self, h, mesh):
        """The blocks through this rank's stage (or chunks) on the pipe
        schedule, under one key drawn here."""
        key = rng.next_key(h.device)
        S, V, per = self.num_stages, self.num_virtual_stages, self.per
        s = mesh.axis_rank(PIPE_AXIS)
        blocks = self.blocks
        stacked = blocks.stacked_parameters()

        def chunk_fn(local, hh, v):
            return blocks.run(local, hh, key, (v * S + s) * per)

        M = self.num_microbatches
        if V > 1:
            chunks = [[p[v * per:(v + 1) * per] for p in stacked]
                      for v in range(V)]
            return pipeline_apply_interleaved(
                chunk_fn, chunks, h, num_microbatches=M, num_chunks=V,
                mesh=mesh, remat=self.recompute)
        return pipeline_apply(lambda local, hh: chunk_fn(local, hh, 0),
                              stacked, h, num_microbatches=M, mesh=mesh,
                              remat=self.recompute)

    def forward(self, x):
        mesh = get_hybrid_mesh()
        pipe = _pipe_of(mesh)
        if pipe > 1 and pipe != self.num_stages:
            raise ValueError(
                f"PipelineLayer was built with num_stages={self.num_stages} "
                f"but the mesh pipe degree is {pipe}; stage slices would be "
                "silently dropped")
        if pipe > 1 and len(self.blocks.rows) != \
                self.blocks.num_layers // pipe:
            raise ValueError("PipelineLayer was built without this mesh's "
                             "pipe axis: build it after init_hybrid_mesh")
        if (pipe > 1 and mesh.axis_size("data") > 1 and self.training
                and _drops(self)):
            raise NotImplementedError(
                "dropout in a PipelineLayer over a data axis is not ported: "
                "the JAX package's microbatches are slices of the global "
                "batch, a rank's are slices of its own rows (ROADMAP.md §3)")
        h = self._run_section(self._pre, self._pre_fns, x)
        if pipe > 1:
            h = self._pipelined(h, mesh)
        else:
            h = self.blocks(h)
        return self._run_section(self._post, self._post_fns, h)
