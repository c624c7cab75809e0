"""Inference predictor surface (counterpart of ``paddle_tpu/inference``):
``Config``, ``create_predictor`` and the tensor handle.

``Config(model_path)`` keeps the reference's path conventions (a
``.pdmodel`` / ``.pdiparams`` / ``.pdparams`` file or its prefix, or a
directory holding exactly one ``.pdmodel``) and its knobs: ``enable_use_gpu``
picks the CUDA device, ``disable_gpu`` the CPU (the plain versions of the
kernels, for tests), ``enable_serving_engine`` routes the predictor
through the continuous-batching engine, and the rest are accepted no-ops.
The requested placement is logged once per (requested, actual) pair and
maps to a torch device: ``"cuda:<device_id>"`` after ``enable_use_gpu``,
``"cpu"`` after ``disable_gpu``, else the port's default device
(``"cuda"``); an ``enable_serving_engine`` ``device=`` argument overrides
them.

``create_predictor(config)`` after ``config.enable_serving_engine(model=
...)`` returns :class:`paddle_tpu_torch.serving.EnginePredictor`; without
it, a :class:`Predictor` over the exported program of
``config.model_prefix`` (``jit.save``'s ``.pdmodel``, run by ``jit.load``'s
``TranslatedLayer``), with the JAX ``Predictor``'s names and handles
(``paddle_tpu/inference/__init__.py:130-168``): inputs ``input_0``, ...,
outputs ``output_0``, ..., ``run()`` over the handles' arrays or
``run(inputs)`` returning the outputs as numpy arrays (bfloat16 ones as
float32, exactly).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..core import device as device_mod

__all__ = ["Config", "Predictor", "PredictorTensor", "create_predictor"]

_logger = logging.getLogger("paddle_tpu_torch.inference")
_logged_placements: set = set()


def _log_once(key: str, msg: str) -> None:
    if key not in _logged_placements:
        _logged_placements.add(key)
        _logger.warning(msg)


class Config:
    """A predictor's configuration (``paddle_tpu/inference/__init__.py:30``).
    ``model_prefix`` is the path prefix without its suffix."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        prefix = model_path or ""
        if prefix and os.path.isdir(prefix):
            pdmodels = sorted(n for n in os.listdir(prefix)
                              if n.endswith(".pdmodel"))
            if len(pdmodels) != 1:
                raise ValueError(
                    f"Config(dir) needs exactly one .pdmodel in {prefix!r}; "
                    f"found {pdmodels or 'none'}")
            prefix = os.path.join(prefix, pdmodels[0])
        for suffix in (".pdmodel", ".pdiparams", ".pdparams"):
            if prefix.endswith(suffix):
                prefix = prefix[: -len(suffix)]
        self.model_prefix = prefix
        self._mem_optim = True
        self._device = None
        self._serving: Optional[dict] = None

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on CUDA device ``device_id`` (the pool size is the caching
        allocator's business and is ignored)."""
        self._device = ("gpu", int(device_id))

    def disable_gpu(self):
        """Run on the CPU: the plain versions of the kernels."""
        self._device = ("cpu", 0)

    def _resolve_placement(self) -> str:
        """The torch device the predictor runs on, logged once per
        (requested, actual) pair."""
        serving = self._serving or {}
        if serving.get("engine_kw", {}).get("device") is not None:
            actual = str(serving["engine_kw"]["device"])
        elif self._device is not None:
            actual = ("cpu" if self._device[0] == "cpu"
                      else f"cuda:{self._device[1]}")
        else:
            actual = device_mod.DEFAULT_DEVICE
        if self._device is None:
            return actual
        want, dev_id = self._device
        _log_once(f"{want}:{dev_id}:{actual}",
                  f"inference placement: {want}:{dev_id} requested, running "
                  f"on {actual}")
        return actual

    def enable_serving_engine(self, model=None, max_new_tokens: int = 32,
                              stop_token_id: Optional[int] = None,
                              **engine_kw) -> None:
        """Route this config's predictor through the continuous-batching
        engine. ``model`` is an in-memory ``GPTForCausalLM`` (the slot
        engine drives its decode step, which an exported program cannot
        give); ``engine_kw`` goes to ``EnginePredictor`` (``config=`` a
        ``ServingConfig``, ``priority``, ``sampling``, ``adapter``,
        ``device``, ``max_queue``). The predictor's ``close()`` logs its
        lifetime summary, with the prefix and tier hit rates and the
        adapter arena's admissions and rows when the config has them."""
        self._serving = dict(model=model, max_new_tokens=max_new_tokens,
                             stop_token_id=stop_token_id,
                             engine_kw=engine_kw)

    def enable_memory_optim(self, flag=True):
        self._mem_optim = flag

    def disable_glog_info(self):
        pass

    def switch_ir_optim(self, flag=True):
        pass  # nothing is compiled ahead of time

    def set_cpu_math_library_num_threads(self, n):
        pass


class PredictorTensor:
    """A named input or output handle of a predictor, mirroring paddle's
    ``copy_from_cpu`` / ``copy_to_cpu`` / ``shape`` surface over the
    owner's ``_inputs`` / ``_outputs`` dicts of numpy arrays."""

    def __init__(self, owner, name):
        self._owner = owner
        self._name = name

    def copy_from_cpu(self, arr: np.ndarray):
        self._owner._inputs[self._name] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._owner._outputs[self._name])

    def shape(self):
        src = self._owner._inputs.get(self._name)
        if src is None:
            src = self._owner._outputs.get(self._name)
        return list(np.asarray(src).shape)


class Predictor:
    """The exported-program predictor: ``jit.load`` of the config's prefix
    on the device the config resolves."""

    def __init__(self, config: Config):
        from ..jit import load as jit_load

        self._layer = jit_load(config.model_prefix,
                               device=config._resolve_placement())
        self._inputs = {}
        self._outputs = {}

    def get_input_names(self):
        return ["input_0"] if not self._inputs else sorted(self._inputs)

    def get_output_names(self):
        return sorted(self._outputs) or ["output_0"]

    def get_input_handle(self, name: str) -> PredictorTensor:
        return PredictorTensor(self, name)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return PredictorTensor(self, name)

    def run(self, inputs=None):
        """Run the program on ``inputs`` (arrays in input order), or on the
        input handles' arrays in name order; the outputs go to the output
        handles and, when ``inputs`` were given, are returned."""
        if inputs is not None:
            arrs = [np.asarray(a) for a in inputs]
        else:
            arrs = [self._inputs[k] for k in sorted(self._inputs)]
        out = self._layer(*arrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        # numpy has no bfloat16: such outputs come back as float32 (exact)
        self._outputs = {f"output_{i}": (o.float() if o.dtype == torch.bfloat16
                                         else o).cpu().numpy()
                         for i, o in enumerate(outs)}
        if inputs is not None:
            return [self._outputs[k] for k in sorted(self._outputs)]
        return None


def create_predictor(config: Config):
    """The predictor of ``config``: after ``enable_serving_engine`` an
    ``EnginePredictor`` over the slot engine, else a :class:`Predictor`
    over the exported program; on the device ``config`` resolves."""
    opts = config._serving
    if opts is None:
        return Predictor(config)
    if opts.get("model") is None:
        raise ValueError(
            "enable_serving_engine() needs an in-memory GPT model (pass "
            "model=...); an exported .pdmodel program cannot be driven "
            "per slot")
    kw = dict(opts["engine_kw"])
    kw["device"] = config._resolve_placement()
    from ..serving import EnginePredictor

    return EnginePredictor(opts["model"],
                           max_new_tokens=opts["max_new_tokens"],
                           stop_token_id=opts["stop_token_id"], **kw)
