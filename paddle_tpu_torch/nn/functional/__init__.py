"""Functionals of the port (counterpart of ``paddle_tpu.nn.functional``)."""
from .attention import scaled_dot_product_attention
from .loss import cross_entropy

__all__ = ["scaled_dot_product_attention", "cross_entropy"]
