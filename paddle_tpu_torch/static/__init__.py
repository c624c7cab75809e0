"""``paddle.static``'s deploy entry points (counterpart of
``paddle_tpu/static/__init__.py:17-35``, ``:99-102``): ``InputSpec``, the
layer form of ``save_inference_model(path, layer, input_spec)`` (a
``jit.save`` export) and ``load_inference_model`` (``jit.load``). The
feed/fetch ``Program`` form and the static ``Program`` / ``Executor`` are
a later slice of the port: that form raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ..jit import InputSpec
from ..jit import load as _jit_load
from ..jit import save as _jit_save

__all__ = ["InputSpec", "save_inference_model", "load_inference_model"]


def save_inference_model(path_prefix, feed_vars, fetch_vars=None,
                         executor=None, program=None, **kwargs) -> None:
    """``save_inference_model(path, layer, input_spec)``: the layer
    exported by ``jit.save``."""
    if not isinstance(feed_vars, torch.nn.Module):
        raise NotImplementedError(
            "save_inference_model(path, feed_vars, fetch_vars, exe): the "
            "static Program / Executor form is a later slice of the port "
            "(paddle_tpu/static/program.py); pass a layer and its "
            "input_spec instead")
    _jit_save(feed_vars, path_prefix, input_spec=fetch_vars, **kwargs)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """The :class:`~paddle_tpu_torch.jit.TranslatedLayer` of
    ``path_prefix`` (``device=`` as ``jit.load``)."""
    return _jit_load(path_prefix, **kwargs)
