"""``paddle.regularizer`` (counterpart of ``paddle_tpu/regularizer.py``):
the weight-decay regularizers every optimizer takes as ``weight_decay=``.
``L2Decay`` decays along the parameter, ``L1Decay`` along its sign; a bare
float keeps meaning L2."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        # paddle's attribute name for the coefficient
        self._regularization_coeff = self.coeff

    def __repr__(self):
        return f"L1Decay, coeff={self.coeff}"


class L2Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        self._regularization_coeff = self.coeff

    def __repr__(self):
        return f"L2Decay, coeff={self.coeff}"
