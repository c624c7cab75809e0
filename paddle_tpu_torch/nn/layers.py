"""The layers GPT uses, in paddle's conventions (counterpart of ``paddle_tpu.nn``).

``Linear`` keeps paddle's ``[in, out]`` weight layout (``y = x @ W + b``) so
the JAX package's ``functional_state()`` arrays load unchanged. On one card
the JAX package's parallel layers (``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding``) are these plain layers.
Parameters start uninitialised in float32; the model initialises them.
``Linear`` and ``LayerNorm`` cast their inputs under an active
:func:`paddle_tpu_torch.amp.auto_cast` as the JAX package's ``linear`` and
``ln`` ops do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import amp
from .functional import common


class Linear(nn.Module):
    """``y = x @ W + b``; with ``bias=False`` there is no ``b`` and the op
    is the JAX package's ``linear_nb`` under AMP."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)

    def forward(self, x):
        if self.bias is None:
            x, w = amp.cast_inputs("linear_nb", x, self.weight)
            return torch.matmul(x, w)
        x, w, b = amp.cast_inputs("linear", x, self.weight, self.bias)
        return torch.matmul(x, w) + b


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """Normalises in fp32 and casts back to the dtype of its input as the
    ``ln`` op sees it (under AMP ``ln`` is black-listed, so a bf16 input is
    promoted first and the output stays f32), as the JAX package's
    layer_norm does."""

    def __init__(self, dim: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x):
        x, w, b = amp.cast_inputs("ln", x, self.weight, self.bias)
        out = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                           self.epsilon)
        return out.to(x.dtype)


class Dropout(nn.Module):
    """paddle's ``Dropout`` (:func:`paddle_tpu_torch.nn.functional.dropout`
    in the module's training mode: no key is drawn in eval or at p 0)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return common.dropout(x, self.p, axis=self.axis,
                              training=self.training, mode=self.mode)


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return common.dropout2d(x, self.p, training=self.training,
                                data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return common.dropout3d(x, self.p, training=self.training,
                                data_format=self.data_format)


class AlphaDropout(nn.Module):
    """paddle's ``AlphaDropout`` (:func:`paddle_tpu_torch.nn.functional.
    alpha_dropout` in the module's training mode)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return common.alpha_dropout(x, self.p, training=self.training)


def gelu_tanh(x):
    """paddle's ``gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")
