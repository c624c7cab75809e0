"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Only the hard-label cross entropy of the training path is ported: soft
labels, class weights, ``use_softmax=False`` and label smoothing raise
``NotImplementedError`` until a later slice.
"""
from __future__ import annotations

import torch

from ... import amp


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Hard-label softmax cross entropy, ``loss = logsumexp(x) - x[label]``
    in f32, rows whose label is ``ignore_index`` weighted 0. ``reduction``
    ``mean`` divides by the number of kept rows (paddle's weighted mean),
    ``sum`` sums, ``none`` returns one loss per row."""
    if (weight is not None or soft_label or not use_softmax
            or label_smoothing):
        raise NotImplementedError(
            "cross_entropy: soft labels, class weights, use_softmax=False "
            "and label smoothing are not ported yet")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    (logits,) = amp.cast_inputs("ce", input)
    lbl = label
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    keep = lbl != ignore_index
    safe = torch.where(keep, lbl, torch.zeros_like(lbl))
    lse = torch.logsumexp(logits.float(), dim=axis)
    picked = logits.gather(axis, safe.unsqueeze(axis)).squeeze(axis).float()
    wt = keep.float()
    loss = (lse - picked) * wt
    if reduction == "mean":
        return loss.sum() / wt.sum().clamp_min(1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss
