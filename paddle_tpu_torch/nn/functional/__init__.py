"""Functionals of the port (counterpart of ``paddle_tpu.nn.functional``)."""
from .attention import flash_attention, scaled_dot_product_attention
from .common import alpha_dropout, dropout, dropout2d, dropout3d
from .loss import cross_entropy, softmax_with_cross_entropy

__all__ = ["scaled_dot_product_attention", "flash_attention", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout", "cross_entropy",
           "softmax_with_cross_entropy"]
