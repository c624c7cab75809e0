"""``paddle.metric``: ``Metric``, ``Accuracy`` (top-k), ``Precision``,
``Recall``, ``Auc`` and the functional ``accuracy`` (counterpart of
``paddle_tpu/metric/__init__.py``). Metrics accumulate on the host in
numpy, as in the JAX package; inputs may be torch tensors (any device) or
numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Pre-processing hook ``Model`` calls before ``update``
        (identity)."""
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        """Whether each of the top ``maxk`` predictions is the label."""
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim > 1 and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        return topk_idx == label_np[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].sum()
            self.count[i] += correct.shape[0] if correct.ndim else 1
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = self.total / np.maximum(self.count, 1)
        return (float(res[0]) if len(self.topk) == 1
                else [float(r) for r in res])

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC over ``num_thresholds + 1`` score buckets (trapezoids over
    the thresholds, descending)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1).astype(np.int64)
        scores = (preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2
                  else preds.reshape(-1))
        idx = np.clip((scores * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._pos, idx[labels == 1], 1)
        np.add.at(self._neg, idx[labels == 0], 1)

    def accumulate(self):
        tot_pos, tot_neg = self._pos.sum(), self._neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        tpr = np.cumsum(self._pos[::-1]) / tot_pos
        fpr = np.cumsum(self._neg[::-1]) / tot_neg
        return float(np.trapezoid(tpr, fpr))


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy of ``input`` [N, C] scores against ``label`` [N, 1]
    or [N], as a float32 scalar tensor on the input's device (ties go to
    the lower index, as a stable sort of the negated scores gives)."""
    topk = torch.argsort(-input, dim=-1, stable=True)[:, :int(k)]
    hit = (topk == label.reshape(-1, 1)).any(dim=1)
    return hit.float().mean()
