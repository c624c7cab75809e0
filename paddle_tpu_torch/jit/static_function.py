"""``jit.to_static`` (counterpart of ``paddle_tpu/jit/__init__.py:160-575``
and its dy2static knobs, ``:1141-1181``).

The JAX package traces the decorated function into one XLA program per
(input signature, AMP policy). PyTorch runs eagerly, so the port keeps the
same surface and the same counters and runs each call by what it is:

* **taped** -- gradients enabled and a live input or parameter (one that
  requires grad): the function runs eagerly on autograd's tape, as the JAX
  package records it as one tape op (``to_static.taped_calls``). Never
  bucketed: padded rows would enter batch reductions.
* **not taped, on CUDA** (every array input a CUDA tensor): a
  ``torch.cuda.CUDAGraph`` captured once per cache entry and replayed,
  built on ``serving/graphs.py``: the first call of an entry warms the
  function up once on the capture stream, then captures it under a
  :class:`~paddle_tpu_torch.serving.graphs.LaunchCredit`, so the kernels'
  launch counters move once per kernel on every replay. Inputs are copied
  into the entry's static buffers before each replay; outputs are copied
  out of the graph's buffers before they are returned.
* **not taped, on the CPU**: the function runs eagerly, as the CPU
  serving engine does.

A cache entry is one signature: the inputs' shapes, dtypes and devices
after bucketing, the other arguments by value, and the AMP policy
(``to_static.misses`` at its first call, ``to_static.hits`` after). A
graph reads the parameters by address, so an in-place update (an
optimizer step, ``load_state_dict``, which copies) is seen by the next
replay; a replaced tensor (``load_state_dict(..., assign=True)``,
``.to()``, a reassigned parameter) changes the addresses the entry was
captured over, and the entry is captured again
(``to_static.rebuilds``). Parameters are found, as in the JAX package,
through a bound layer, the closure cells and the names the function loads
as globals (modules, lists of them, and nested :class:`StaticFunction`\\ s),
and are read from those modules at every call.

A function that draws from :mod:`paddle_tpu_torch.core.rng` (dropout)
would replay the key it drew at capture. The warm-up records the keys a
call draws; an entry whose warm-up drew any is never captured, and its
calls run eagerly (``to_static.rng_eager_calls``), each with fresh keys.
The warm-up's own outputs are that first call's result.

``bucket_batch=True`` (or ``FLAGS_shape_bucketing`` when it is None) pads
the shared leading dim of the array inputs up to
:func:`~paddle_tpu_torch.core.compile_cache.bucket_dim` and slices every
output whose leading dim is the padded size back to the batch.
"""
from __future__ import annotations

import dis
import functools
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import amp
from ..core import compile_cache, flags, rng

__all__ = ["StaticFunction", "to_static", "enable_to_static",
           "not_to_static", "ignore_module", "set_code_level",
           "set_verbosity"]

_to_static_enabled = True


def _launch_counters():
    """Every kernel's launch counter: a capture takes its launches back
    out and each replay credits them."""
    from ..ops import dropout, flash_attention, paged_attention, sampling

    return (flash_attention.launches, paged_attention.launches,
            sampling.launches, dropout.launches)


def _amp_key(st):
    """Hashable identity of an autocast policy (None = no autocast)."""
    if st is None:
        return None
    return (st["level"], str(st["dtype"]), frozenset(st["white"]),
            frozenset(st["black"]))


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray)) and leaf.ndim >= 1


class _Entry:
    """One signature's captured call: the static inputs, the graph, its
    outputs and their structure, the launch credit and the parameter
    addresses it was captured over. ``graph`` None: the call draws random
    keys and runs eagerly."""

    __slots__ = ("inputs", "graph", "outputs", "out_spec", "credit", "ptrs")

    def __init__(self, ptrs):
        self.ptrs = ptrs
        self.inputs = self.graph = self.outputs = None
        self.out_spec = self.credit = None

    def drop(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.inputs = self.graph = self.outputs = None


class StaticFunction:
    """The result of :func:`to_static`: a callable with one cache entry per
    (input signature, AMP policy); see the module docstring. ``backend``
    is what captures and replays (``serving.graphs.CudaGraphs`` of the
    inputs' device, made at the first capture); a test may set one that
    captures CPU tensors. ``builds`` counts captures."""

    def __init__(self, function: Callable, layer=None,
                 bucket_batch: Optional[bool] = None, input_spec=None):
        self._fn = function
        self._layer = layer
        self._bucket_batch = bucket_batch
        self.input_spec = input_spec
        self._found = None  # (modules, nested StaticFunctions)
        self._discovering = False
        self._seen_sigs = set()
        self._entries = {}
        self.backend = None
        self.builds = 0
        functools.update_wrapper(self, function, updated=[])

    def __get__(self, obj, objtype=None):
        """Decorating a method binds one StaticFunction per instance (the
        instance is then the bound layer)."""
        if obj is None:
            return self
        key = f"_static_{id(self)}"
        bound = obj.__dict__.get(key)
        if bound is None:
            bound = StaticFunction(self._fn.__get__(obj, objtype),
                                   layer=obj if isinstance(
                                       obj, torch.nn.Module) else None,
                                   bucket_batch=self._bucket_batch,
                                   input_spec=self.input_spec)
            obj.__dict__[key] = bound
        return bound

    # ------------------------------------------------------------ state

    def _discover(self):
        """The modules and nested StaticFunctions whose state is this
        function's: a bound layer, else closure cells and the names the
        code loads as globals (``LOAD_GLOBAL`` only: ``co_names`` also
        lists attribute names)."""
        if self._found is not None:
            return self._found
        layer = self._layer
        if layer is None and isinstance(getattr(self._fn, "__self__", None),
                                        torch.nn.Module):
            layer = self._fn.__self__
        modules, inner = [], []
        if layer is not None:
            modules.append(layer)
        else:
            candidates = []
            for cell in getattr(self._fn, "__closure__", None) or ():
                try:
                    candidates.append(cell.cell_contents)
                except ValueError:  # an empty cell
                    continue
            code = getattr(self._fn, "__code__", None)
            gl = getattr(self._fn, "__globals__", None)
            if code is not None and gl is not None:
                names = {i.argval for i in dis.get_instructions(code)
                         if i.opname == "LOAD_GLOBAL"}
                candidates.extend(gl[n] for n in sorted(names) if n in gl)
            for v in candidates:
                for x in (v if isinstance(v, (list, tuple)) else (v,)):
                    if isinstance(x, torch.nn.Module):
                        modules.append(x)
                    elif isinstance(x, StaticFunction) and x is not self:
                        inner.append(x)
        self._found = (modules, inner)
        return self._found

    def _state(self) -> List[torch.Tensor]:
        """The parameters and buffers of the discovered modules, read now
        (a reassigned parameter is a new tensor), nested StaticFunctions'
        included; each once."""
        if self._discovering:
            return []  # a nested function that reaches this one again
        self._discovering = True
        try:
            modules, inner = self._discover()
            out, seen = [], set()
            tensors = [t for m in modules for t in m.parameters()]
            tensors += [t for m in modules for t in m.buffers()]
            tensors += [t for f in inner for t in f._state()]
            for t in tensors:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
            return out
        finally:
            self._discovering = False

    # ------------------------------------------------------------- calls

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled or torch.compiler.is_compiling():
            return self._fn(*args, **kwargs)
        state = self._state()
        leaves, spec = pytree.tree_flatten((args, kwargs))
        if torch.is_grad_enabled() and (
                any(isinstance(x, torch.Tensor) and x.requires_grad
                    for x in leaves)
                or any(t.requires_grad for t in state)):
            compile_cache.bump("to_static.taped_calls")
            return self._fn(*args, **kwargs)
        bucket = (self._bucket_batch if self._bucket_batch is not None
                  else flags.flag("shape_bucketing"))
        orig = padded = None
        if bucket:
            leaves, orig, padded = _pad_leaves(leaves)
            if orig is not None:
                args, kwargs = pytree.tree_unflatten(leaves, spec)
        sig = self._count_signature(leaves)
        backend = self._backend_for(leaves)
        if sig is None or backend is None:
            out = self._fn(*args, **kwargs)
        else:
            out = self._run(sig, leaves, spec, state, backend)
        if orig is not None:
            out = _slice_batch(out, padded, orig)
        return out

    def _count_signature(self, leaves):
        """The call's cache key, counted as a miss at its first call and a
        hit after; None (uncounted) when a leaf is unhashable."""
        parts = []
        for x in leaves:
            if isinstance(x, torch.Tensor):
                parts.append((tuple(x.shape), x.dtype, x.device))
            elif isinstance(x, np.ndarray):
                parts.append((x.shape, str(x.dtype)))
            else:
                parts.append((type(x).__name__, x))
        sig = (tuple(parts), _amp_key(amp.amp_state()))
        try:
            hash(sig)
        except TypeError:
            return None
        if sig in self._seen_sigs:
            compile_cache.bump("to_static.hits")
        else:
            self._seen_sigs.add(sig)
            compile_cache.bump("to_static.misses")
        return sig

    def _backend_for(self, leaves):
        """What captures this call: the set backend, else the CUDA graphs
        of the inputs' device when every array input is a tensor on one
        CUDA device; None runs it eagerly."""
        if self.backend is not None:
            return self.backend
        if any(isinstance(x, np.ndarray) for x in leaves):
            return None
        devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
        if len(devices) != 1:
            return None
        device = devices.pop()
        if device.type != "cuda":
            return None
        from ..serving.graphs import CudaGraphs

        self.backend = CudaGraphs(device)
        return self.backend

    def _run(self, sig, leaves, spec, state, backend):
        ptrs = tuple(t.data_ptr() for t in state)
        entry = stale = self._entries.get(sig)
        if entry is not None and entry.ptrs != ptrs:
            entry = None  # a parameter was replaced: its address moved
            compile_cache.bump("to_static.rebuilds")
        if entry is None:
            entry = _Entry(ptrs)
            self._entries[sig] = entry
            out = self._build(entry, leaves, spec, backend)
            if stale is not None:
                # dropped only now: a graph pool whose last graph is reset
                # cannot take another capture
                stale.drop()
            if entry.graph is None:
                return out
        elif entry.graph is None:
            compile_cache.bump("to_static.rng_eager_calls")
            args, kwargs = pytree.tree_unflatten(leaves, spec)
            return self._fn(*args, **kwargs)
        for buf, x in zip(entry.inputs, leaves):
            if isinstance(buf, torch.Tensor):
                buf.copy_(x)
        entry.graph.replay()
        entry.credit.replay()
        outs = [o.clone() if isinstance(o, torch.Tensor) else o
                for o in entry.outputs]
        return pytree.tree_unflatten(outs, entry.out_spec)

    def _build(self, entry, leaves, spec, backend):
        """Warm the call up over static copies of its inputs, recording the
        keys it draws; capture it unless it drew any. Returns the warm-up's
        outputs when it drew (that call's result), else None."""
        from ..ops.paged_attention import workspace_stream
        from ..serving.graphs import _BUILD_LOCK, LaunchCredit

        entry.inputs = [x.clone() if isinstance(x, torch.Tensor) else x
                        for x in leaves]
        args, kwargs = pytree.tree_unflatten(entry.inputs, spec)
        tape, warm = rng.KeyTape(), []
        device = _device_of(leaves)
        stream = (torch.cuda.current_stream(device)
                  if device is not None and device.type == "cuda" else None)
        with torch.no_grad(), _BUILD_LOCK, workspace_stream(stream):
            with tape.record():
                backend.warmup(lambda: warm.append(self._fn(*args,
                                                            **kwargs)))
            if tape.keys:
                out = warm[0]
                for t in pytree.tree_leaves(out):
                    if stream is not None and isinstance(t, torch.Tensor):
                        t.record_stream(stream)  # made on the side stream
                compile_cache.bump("to_static.rng_eager_calls")
                return out
            del warm
            entry.credit = LaunchCredit(_launch_counters())

            def step():
                outs, entry.out_spec = pytree.tree_flatten(
                    self._fn(*args, **kwargs))
                return outs

            entry.graph, entry.outputs = entry.credit.capture(
                lambda: backend.capture(step))
        self.builds += 1
        compile_cache.bump("to_static.captures")
        return None


def _device_of(leaves):
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _pad_leaves(leaves):
    """Pad the shared leading dim of the array leaves up to its bucket.
    Returns ``(leaves, orig_b, padded_b)``; ``orig_b`` None when nothing
    was padded (no array leaf, ambiguous leading dims, already on a
    bucket)."""
    dims = {x.shape[0] for x in leaves if _is_array(x)}
    if len(dims) != 1:
        if dims:
            compile_cache.bump("bucket.skipped_ambiguous")
        return leaves, None, None
    b = dims.pop()
    pb = compile_cache.bucket_dim(b)
    if pb == b:
        return leaves, None, None
    leaves = [compile_cache.pad_to_bucket(x)[0] if _is_array(x) else x
              for x in leaves]
    return leaves, b, pb


def _slice_batch(out, padded_b: int, orig_b: int):
    """Undo the bucket padding: every array output whose leading dim is
    the padded size is sliced back to the batch."""
    def cut(x):
        if _is_array(x) and x.shape[0] == padded_b:
            return x[:orig_b]
        return x

    return pytree.tree_map(cut, out)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """``@paddle.jit.to_static``: a function, a method or a layer (whose
    ``forward`` becomes the StaticFunction). ``bucket_batch=True`` opts
    into batch bucketing, ``False`` out of ``FLAGS_shape_bucketing``.
    ``input_spec`` is kept for :func:`~paddle_tpu_torch.jit.save`."""
    bucket_batch = kwargs.pop("bucket_batch", None)

    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn.forward, layer=fn,
                                        bucket_batch=bucket_batch,
                                        input_spec=input_spec)
            return fn
        return StaticFunction(fn, bucket_batch=bucket_batch,
                              input_spec=input_spec)

    if function is not None:
        return deco(function)
    return deco


# ------------------------------------------------------ dy2static knobs


def enable_to_static(enable: bool = True) -> None:
    """Globally toggle to_static (off: a StaticFunction calls the function
    as written)."""
    global _to_static_enabled
    _to_static_enabled = bool(enable)


def not_to_static(function):
    """Mark a function to stay eager inside to_static regions. Nothing is
    rewritten, so the marked function simply runs; the marker is kept."""
    function._paddle_not_to_static = True
    return function


_ignored_modules: list = []


def ignore_module(modules) -> None:
    """Register modules the dy2static transformer should skip: nothing is
    transformed, so this is bookkeeping for the API."""
    _ignored_modules.extend(modules if isinstance(modules, (list, tuple))
                            else [modules])


_levels = {"code": 0, "verbosity": 0}


def set_code_level(level=100, also_to_stdout=False) -> None:
    _levels["code"] = level


def set_verbosity(level=0, also_to_stdout=False) -> None:
    _levels["verbosity"] = level
