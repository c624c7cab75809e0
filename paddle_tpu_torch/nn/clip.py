"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each clip takes the list of gradients and returns the clipped list; the
norms are taken in f32 and each gradient keeps its dtype. On a mesh a
gradient may be one rank's part of a whole tensor (a tensor-parallel shard,
a ZeRO slice): ``groups`` names, per gradient, the process groups over
which its whole is split, and a norm sums its squares over them, so that
every rank clips by the whole model's norm; a replicated gradient counts
once.
"""
from __future__ import annotations

import torch

from ..distributed import collective

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _sum_squares(grads, groups):
    """The f32 sum of the squares of ``grads``, each part of a split whole
    summed over its ``groups`` (None: nothing is split)."""
    local = [torch.sum(torch.square(g.float())) for g in grads]
    if groups is None:
        return sum(local)
    by_groups = {}
    for sq, gs in zip(local, groups):
        key = tuple(id(g) for g in gs)
        acc = by_groups.get(key)
        by_groups[key] = (sq if acc is None else acc[0] + sq, gs)
    total = None
    for sq, gs in by_groups.values():
        for g in gs:
            sq = collective.all_reduce(sq.clone(), g)
        total = sq if total is None else total + sq
    return total


class ClipGradBase:
    def _clip_arrays(self, grads, groups=None):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_arrays(self, grads, groups=None):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to L2 norm at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_arrays(self, grads, groups=None):
        out = []
        for i, g in enumerate(grads):
            n = torch.sqrt(_sum_squares(
                [g], None if groups is None else [groups[i]]))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one factor so that their joint L2 norm (the
    whole model's, on a mesh) is at most ``clip_norm``. ``group_name`` and
    ``auto_skip_clip`` are paddle's arguments and change nothing here, as
    in the JAX package."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = bool(auto_skip_clip)

    def global_norm(self, grads, groups=None):
        """The joint L2 norm of ``grads`` (f32), whole over ``groups``."""
        return torch.sqrt(_sum_squares(grads, groups))

    def _clip_arrays(self, grads, groups=None):
        gn = self.global_norm(grads, groups)
        scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]
