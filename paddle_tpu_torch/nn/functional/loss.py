"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``:
``cross_entropy`` and ``softmax_with_cross_entropy``)."""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def _reduce(x, reduction):
    if reduction == "mean":
        from ...distributed import parallel

        return parallel.global_mean(x)
    if reduction == "sum":
        return x.sum()
    return x


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """paddle's ``cross_entropy``, in f32, as the JAX package computes it.

    * Hard labels with the softmax and no smoothing: ``logsumexp(x) -
      x[label]`` (no ``[.., V]`` log-softmax is made).
    * ``use_softmax=False``: the input holds probabilities; their log,
      floored at 1e-30, takes the log-softmax's place.
    * ``soft_label``: ``-sum(label * log_softmax(x))`` (no class weights,
      no ignore_index; ``reduction`` as given).
    * ``label_smoothing`` s (hard labels): the target is ``one_hot * (1 -
      s) + s / classes``.
    * Hard labels: rows whose label is ``ignore_index`` weigh 0, the others
      ``weight[label]`` (1 without ``weight``); ``mean`` divides the
      weighted sum by the kept rows' weights (at least 1e-12), ``sum``
      sums, ``none`` returns each row's weighted loss.

    On a training mesh with a data axis, ``mean`` is over the global batch,
    as the JAX package's over a sharded batch: this rank's (weighted) sum,
    summed over the data group, over the global weights or rows
    (``distributed.parallel.global_token_mean``), hard labels and soft
    alike."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    (logits,) = amp.cast_inputs("ce", input)
    x32 = logits.float()
    logp = None if use_softmax else torch.log(torch.clamp_min(x32, 1e-30))
    if soft_label:
        if logp is None:
            logp = torch.log_softmax(x32, dim=axis)
        loss = -(label.float() * logp).sum(dim=axis)
        return _reduce(loss, reduction)
    lbl = label
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    keep = lbl != ignore_index
    safe = torch.where(keep, lbl, torch.zeros_like(lbl))
    if label_smoothing > 0.0:
        if logp is None:
            logp = torch.log_softmax(x32, dim=axis)
        n_cls = logits.shape[axis]
        oh = torch.nn.functional.one_hot(safe, n_cls).float()
        oh = torch.where(keep.unsqueeze(-1), oh, torch.zeros_like(oh))
        tgt = oh.movedim(-1, axis) * (1.0 - label_smoothing) \
            + label_smoothing / n_cls
        loss = -(tgt * logp).sum(dim=axis)
    elif logp is None:
        lse = torch.logsumexp(x32, dim=axis)
        picked = logits.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        loss = lse - picked.float()
    else:
        loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    wt = keep.float()
    if weight is not None:
        wt = wt * weight.float()[safe]
    loss = loss * wt
    if reduction == "mean":
        from ...distributed import parallel

        return parallel.global_token_mean(loss.sum(), wt.sum(), floor=1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """paddle's ``softmax_with_cross_entropy``: the per-row loss with the
    class axis kept (size 1), and the softmax when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
