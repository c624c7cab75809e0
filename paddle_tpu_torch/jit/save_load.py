"""``jit.save`` / ``jit.load`` / ``TranslatedLayer`` (counterpart of
``paddle_tpu/jit/__init__.py:972-1138``).

``save(layer, path, input_spec=[...])`` writes:

* ``path.pdparams`` -- the layer's ``state_dict()`` as the JAX package's
  ``jit.save`` writes it, a pickle of ``{name: ndarray}`` (bfloat16 as an
  ``ml_dtypes`` array; :func:`paddle_tpu_torch.framework.io.save_arrays`),
  keyed by the names the JAX package's ``state_dict()`` gives the same
  model, so either package's file loads in the other's model;
* ``path.pdmodel`` -- a pickle of ``{"format": "torch.export", "program":
  <torch.export archive>, "param_keys": [...], "device": ...}``. The
  program is ``fwd(params, *inputs)``: the parameters and buffers are
  lifted as its first input, in ``param_keys`` order, as the JAX package
  lifts them (``:1011-1016``), so the weights are written once, in
  ``.pdparams``, never inside the archive.

The export runs in eval mode (training mode is restored after) on the
layer's device, with each dynamic :class:`~.input_spec.InputSpec` dim
``torch.export.Dim.DYNAMIC`` and the dims that share a symbol checked
equal inside the program. A dynamic dim keeps the range the model gives
it (GPT's position table bounds the sequence); a dim the model
specializes to one size fails the export. The attention route is decided while the
export traces (``nn/functional/attention.py``): the flash forward enters
the program as the registered op ``paddle_tpu_torch::flash_forward``.

``load(prefix)`` returns a :class:`TranslatedLayer` that runs the saved
program on the saved weights without the model's Python code, on the
card unless ``device="cpu"`` is asked (a program saved on one device is
moved to the other by ``torch.export``'s device pass); without a
``.pdmodel`` it returns the state dict. A JAX ``.pdmodel`` (a StableHLO
program) raises ``ValueError``: the port does not run it. ``native=True``
(the JAX package's ``.pdnative`` for its C++ runner) raises
``NotImplementedError``.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch
from torch.export import Dim

from ..core import device as device_mod
from ..core import resilience
from ..framework import io as fio

__all__ = ["save", "load", "TranslatedLayer", "FORMAT"]

FORMAT = "torch.export"


class _Program(torch.nn.Module):
    """``fwd(params, *inputs)``: the layer run on the given parameters and
    buffers, after checking that the dims sharing a symbol are equal
    (``ties``: pairs of ``(input, axis)``). The layer is held outside the
    module tree, so the export lifts none of its weights."""

    def __init__(self, layer: torch.nn.Module, keys, ties=()):
        super().__init__()
        self.__dict__["_layer"] = layer
        self._keys = list(keys)
        self._ties = list(ties)

    def forward(self, params, *inputs):
        for (i, a), (j, b) in self._ties:
            torch._check(inputs[i].shape[a] == inputs[j].shape[b])
        return torch.func.functional_call(
            self._layer, dict(zip(self._keys, params)), inputs)


def _lifted(layer: torch.nn.Module) -> dict:
    """The tensors the program takes as inputs: every parameter and every
    buffer of the state dict, by state-dict name."""
    names = set(layer.state_dict().keys())
    out = {k: p for k, p in layer.named_parameters()}
    out.update((k, b) for k, b in layer.named_buffers() if k in names)
    return out


def _export(layer, specs, device):
    state = _lifted(layer)
    keys = list(state)
    sizes, first, ties = {}, {}, []
    examples, dyn = [], []
    for i, s in enumerate(specs):
        if isinstance(s, torch.Tensor):
            examples.append(s.to(device))
            dyn.append(None)
            continue
        examples.append(s.example(sizes, device))
        syms = s.symbols()
        for axis, sym in syms.items():
            if sym in first:
                ties.append((first[sym], (i, axis)))
            else:
                first[sym] = (i, axis)
        dyn.append({axis: Dim.DYNAMIC for axis in syms} or None)
    args = (tuple(t.detach() for t in state.values()), *examples)
    # by the signature: the params tuple, then the varargs tuple
    shapes = ((None,) * len(state), tuple(dyn))
    ep = torch.export.export(_Program(layer, keys, ties), args,
                             dynamic_shapes=shapes)
    return ep, keys


def save(layer, path, input_spec=None, **configs) -> None:
    """Write ``path.pdparams`` and, given an ``input_spec`` (or a
    ``to_static`` forward made with one), ``path.pdmodel``; see the module
    docstring."""
    if configs.get("native"):
        raise NotImplementedError(
            "jit.save(native=True): the .pdnative artifact of the C++ "
            "deploy runner (paddle_tpu/native/) is a later slice of the "
            "port; save without native= and serve the .pdmodel through "
            "jit.load or inference.create_predictor")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    is_layer = isinstance(layer, torch.nn.Module)
    fio.save_arrays(layer.state_dict() if is_layer else {},
                    path + ".pdparams")
    if input_spec is None and is_layer:
        input_spec = getattr(layer.forward, "input_spec", None)
    if not (input_spec and is_layer):
        return
    params = list(layer.parameters()) + list(layer.buffers())
    device = params[0].device if params else torch.device("cpu")
    was_training = layer.training
    layer.eval()
    try:
        ep, keys = _export(layer, list(input_spec), device)
    finally:
        if was_training:
            layer.train()
    ep.example_inputs = None  # they hold the weights: keep them out
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    meta = {"format": FORMAT, "program": buf.getvalue(), "param_keys": keys,
            "device": str(device)}
    resilience.atomic_write(path + ".pdmodel",
                            lambda f: pickle.dump(meta, f, protocol=4),
                            name="jit.save")


class TranslatedLayer:
    """The result of :func:`load` on a saved program: runs it on the saved
    weights (no model code). Inputs are tensors or numpy arrays, moved to
    the layer's device; the outputs are tensors there."""

    def __init__(self, program, params, device):
        self._program = program
        self._module = program.module()
        self._params = tuple(params)
        self.device = torch.device(device)

    def __call__(self, *inputs):
        xs = [(x if isinstance(x, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(x))).to(self.device)
              for x in inputs]
        with torch.no_grad():
            return self._module(self._params, *xs)

    def forward(self, *inputs):
        return self(*inputs)

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")


def _read_program(path):
    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    if not isinstance(meta, dict) or meta.get("format") != FORMAT:
        what = ("the JAX package's StableHLO program (jax.export)"
                if isinstance(meta, dict) and "stablehlo" in meta
                else "not a torch.export program")
        raise ValueError(
            f"{path}.pdmodel is {what}; paddle_tpu_torch runs programs "
            "saved by paddle_tpu_torch.jit.save (format "
            f"{FORMAT!r}): save the model again with the port")
    return meta


def load(path, **configs):
    """A :class:`TranslatedLayer` of ``path.pdmodel`` on ``device``
    (default: the port's, ``"cuda"``), or the state dict of
    ``path.pdparams`` when there is no ``.pdmodel``."""
    if not os.path.exists(path + ".pdmodel"):
        return fio.load(path + ".pdparams")
    meta = _read_program(path)
    from ..ops import flash_attention  # noqa: F401 -- registers the op

    device = device_mod.resolve(configs.get("device",
                                            device_mod.DEFAULT_DEVICE))
    program = torch.export.load(io.BytesIO(meta["program"]))
    if torch.device(meta["device"]).type != device.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    state = fio.load(path + ".pdparams")
    params = [torch.as_tensor(state[k]).to(device)
              for k in meta["param_keys"]]
    return TranslatedLayer(program, params, device)
