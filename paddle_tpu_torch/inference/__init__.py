"""Inference predictor surface (counterpart of ``paddle_tpu/inference``),
so far only the tensor handle that ``serving.api.EnginePredictor`` hands out
(``paddle_tpu/inference/__init__.py:110 PredictorTensor``). ``Config``,
``Config.enable_serving_engine()`` and ``create_predictor`` come with the
rest of the inference module."""
from __future__ import annotations

import numpy as np

__all__ = ["PredictorTensor"]


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
