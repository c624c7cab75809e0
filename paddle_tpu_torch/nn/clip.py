"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each clip takes the list of gradients and returns the clipped list; the
norms are taken in f32 and each gradient keeps its dtype.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def _clip_arrays(self, grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_arrays(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to L2 norm at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_arrays(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one factor so that their joint L2 norm is at
    most ``clip_norm``. ``group_name`` and ``auto_skip_clip`` are paddle's
    arguments and change nothing here, as in the JAX package (one group on
    one card)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = bool(auto_skip_clip)

    def _clip_arrays(self, grads):
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]
