"""GPT family in PyTorch (counterpart of ``paddle_tpu/models/gpt.py``).

The module tree and parameter names match the JAX package's
``functional_state()`` exactly (``gpt.wte.weight``,
``gpt.layers.0.attn.qkv.weight`` of shape ``[h, 3h]``, ...), so
:func:`load_functional_state` carries the JAX weights across unchanged and a
port model can be held against the JAX one on the same arrays.

Attention has three routes, as in the JAX package:

* a ``cache`` object with ``update_and_attend`` (the serving engine's paged
  arena views) owns its storage and attends through the paged kernels;
* a contiguous ``(k_buf, v_buf)`` cache (``generate()``) is written in place
  at ``start_pos`` and attended with :func:`masked_attention`;
* no cache: :func:`paddle_tpu_torch.nn.functional.scaled_dot_product_attention`
  with ``is_causal``, which takes the flash kernels on a CUDA tensor at kv
  length at or above ``FLAGS_flash_attention_min_seqlen`` and the JAX
  package's ``_sdpa_reference`` math otherwise.

``GPTForCausalLM(ids, labels)`` returns the mean cross-entropy loss over
the head's f32 logits (the head is the token embedding, tied, or an
``lm_head`` of its own with ``tie_word_embeddings=False``); its gradient
flows through the flash kernels' backward. ``loss_chunk_size > 0`` fuses
the head and the loss over chunks of tokens, so the ``[tokens, vocab]``
logits never exist whole.

Split over a mesh's model axis (:func:`shard_model`), the model trains as
the whole one does: the parallel layers' collectives have backwards, and
the loss is the vocab-parallel cross entropy over this rank's rows of the
vocabulary (``parallel_cross_entropy``), chunked or not, which never
gathers ``[tokens, vocab]``. On a data axis the mean is over the global
batch (the global valid count). ``generate()`` on a split model runs the
same decode loop on every rank, the logits gathered whole for the pick
only, so the collectives meet and every rank emits the whole model's
tokens.

On a training mesh's ``sep`` axis each rank holds its block of the
sequence (``shard_batch``): positions are offset by ``sep_rank * s`` and
attention takes the ring (or Ulysses) route. :func:`GPTForCausalLMPipe`
is the pipeline-parallel GPT (``paddle_tpu/models/gpt.py:441-526``): an
embedding section, the blocks as a stacked run split into stages, and a
head section tied to the embedding; :func:`pipe_arrays` carries a
:class:`GPTForCausalLM`'s weights to it and :func:`load_pipe_state` loads
them on any pipe degree.

Training options, as in the JAX package: ``dropout`` (the embedding, the
residual branches and the attention probabilities, each a draw of the
port's threefry dropout, bit-equal to the JAX package's masks);
``use_recompute`` runs each decoder block under
:func:`paddle_tpu_torch.distributed.fleet.recompute.recompute` with
``recompute_policy`` while gradients are recorded; ``use_scan_layers`` is
accepted and runs the unrolled stack: a scan is XLA's lever for compile
time, eager PyTorch compiles nothing, and the JAX scan path computes the
same math (it too falls back to the unrolled stack with live dropout).

Serving quantization: :func:`quantize_serving_weights` turns the attention
and MLP weights into int8 with per-output-channel float32 scales, in place,
and every such matmul runs through :func:`_serving_linear`, so
``generate()`` and the serving engine share one numerics contract on a
quantized model, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import amp, quantization
from ..core import device as device_mod
from ..core import rng
from ..distributed import sharding_util
from ..distributed import collective, parallel
from ..distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    is_split, parallel_cross_entropy)
from ..distributed.fleet.recompute import recompute
from ..nn.functional import cross_entropy, scaled_dot_product_attention
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear, gelu_tanh
from ..ops import dropout as dropout_op
from ..ops.flash_attention import plain_attention
from ..ops.sampling import sample as sample_rows


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    intermediate_size: int = 0  # 0 -> 4*hidden
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    use_recompute: bool = False
    # "full" (save nothing), "core_attn" (save the weight matmuls' outputs)
    # or "full_attn" (every matmul's): distributed.fleet.recompute
    recompute_policy: str = "full"
    # accepted for the JAX package's recipes; runs the unrolled stack
    use_scan_layers: bool = False
    tie_word_embeddings: bool = True
    # > 0: the head and the loss over chunks of this many tokens
    loss_chunk_size: int = 0

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=4, max_position_embeddings=256, **kw)


def gpt_base(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_1p3b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_position_embeddings=2048, **kw)


def _filter_logits(scaled, top_k: int, top_p: float, vocab: int):
    """Top-k and/or nucleus (top-p) filtering of ``scaled [b, V]`` with
    static ``top_k``/``top_p`` (the JAX package's sort-based version, used by
    ``generate()``'s legacy ``do_sample``): ties at the k-th value all
    survive; top-p keeps a token while the probability mass BEFORE it, in
    descending order, is still below ``top_p``, so the top token always
    survives."""
    k_eff = min(int(top_k), vocab)
    if k_eff > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -k_eff][:, None]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if 0.0 < float(top_p) < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(desc.float(), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, desc, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < thresh, -torch.inf, scaled)
    return scaled


def _wrap_int32(x):
    """int64 values wrapped to int32, as int32 arithmetic wraps."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def quantize_serving_weights(model, mesh=None) -> int:
    """Per-channel int8 weight-only quantization of every attention and MLP
    matmul of a :class:`GPTForCausalLM`, in place (the serving engine calls
    it at construction under ``quant_weights``).

    Each ``qkv``, ``proj``, ``up`` and ``down`` weight ``[in, out]`` becomes
    an int8 parameter without gradient, quantized per OUTPUT channel by
    :func:`paddle_tpu_torch.quantization.quantize_weight`, and its float32
    ``[1, out]`` scale a ``weight_scale`` buffer. No full-precision copy is
    kept. Embeddings, the head (tied or not) and the LayerNorms stay in
    the compute dtype. Quantize after the model's dtype is set:
    ``Module.to(dtype)`` would cast the scale buffers
    (:func:`_serving_linear` then raises).

    The whole weights are quantized, then split: with a ``mesh``
    (``paddle_tpu/models/gpt.py:145-198``) the model is sharded in place
    afterwards (:func:`shard_model`), a column linear's scale split with its
    columns, a row linear's kept whole. A scale taken over a rank's slice
    of ``in_features`` would differ from the JAX package's, so a model
    already split over more than one rank is refused.
    Idempotent; returns the number of layers quantized by this call."""
    n = 0
    for blk in model.gpt.layers:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.up, blk.mlp.down):
            if getattr(lin, "weight_scale", None) is not None:
                continue
            if is_split(lin):
                raise ValueError("quantize the whole weights before they "
                                 "are split over the mesh: a row shard's "
                                 "per-channel scales are not the whole "
                                 "weight's")
            with torch.no_grad():
                qw, scale = quantization.quantize_weight(lin.weight,
                                                         channel_axis=1)
            lin.weight = nn.Parameter(qw, requires_grad=False)
            lin.register_buffer("weight_scale", scale)
            n += 1
    if mesh is not None:
        shard_model(model, mesh)
    return n


def sharded_mesh(model):
    """The mesh a model was sharded for by :func:`shard_model` (None for a
    whole model)."""
    return getattr(getattr(model, "gpt", model), "_mesh", None)


def shard_model(model, mesh) -> bool:
    """Split a whole :class:`GPTForCausalLM` (or bare :class:`GPTModel`)
    over ``mesh``'s model axis in place, keeping this rank's shard
    (``paddle_tpu/models/gpt.py:282-290``, ``:374``, ``:474``): ``qkv``
    becomes a :class:`ColumnParallelLinear` over this rank's heads of each
    of q, k and v (``sharding_util.qkv_columns``, the bias and an int8
    scale with them), ``proj`` a :class:`RowParallelLinear` over the same
    heads' rows, ``up`` / ``down`` a column / row pair over contiguous
    slices of the intermediate axis, the token embedding a
    :class:`VocabParallelEmbedding` (the tied head with it) and an untied
    ``lm_head`` a gathered column linear over the vocabulary. Each
    attention then attends ``sharding_util.local_heads`` heads (its
    dropout draws the box of its heads in the whole probabilities). An
    axis that does not divide the ranks stays whole. Quantize first
    (:func:`quantize_serving_weights`). ``mesh``: a serving mesh or a
    training mesh (:class:`~paddle_tpu_torch.distributed.mesh.HybridMesh`,
    its model axis); build the optimizer on the split parameters.

    A model is sharded once, for one mesh: True when this call sharded it,
    False when it already was for ``mesh``; another mesh raises."""
    from ..distributed.fleet.meta_parallel.pp_layers import PipelineLayer

    gpt = getattr(model, "gpt", model)
    done = getattr(gpt, "_mesh", None)
    if done is not None:
        if done is not mesh:
            raise ValueError(f"the model is sharded for {done!r}; it cannot "
                             f"serve on {mesh!r}")
        return False
    if isinstance(model, PipelineLayer):
        return _shard_pipe(model, mesh)
    cfg = gpt.cfg
    for blk in gpt.layers:
        _shard_block(blk, cfg, mesh)
    gpt.wte = VocabParallelEmbedding.from_embedding(gpt.wte, mesh)
    if getattr(model, "lm_head", None) is not None:
        model.lm_head = _vocab_columns(model.lm_head, cfg, mesh)
    gpt._mesh = mesh
    return True


def _shard_block(blk, cfg: GPTConfig, mesh) -> None:
    """One decoder block split over ``mesh``'s model axis in place (see
    :func:`shard_model`)."""
    heads = cfg.num_heads
    head_dim = cfg.hidden_size // heads
    inter = np.arange(*sharding_util.split_range(cfg.intermediate_size,
                                                 mesh))
    attn, mlp = blk.attn, blk.mlp
    attn.qkv = ColumnParallelLinear.from_linear(
        attn.qkv, mesh, sharding_util.qkv_columns(heads, head_dim, mesh))
    attn.proj = RowParallelLinear.from_linear(
        attn.proj, mesh, sharding_util.head_rows(heads, head_dim, mesh))
    attn.num_heads = sharding_util.local_heads(heads, mesh)
    attn.head_offset = (sharding_util.head_rows(heads, head_dim, mesh)[0]
                        // head_dim)
    mlp.up = ColumnParallelLinear.from_linear(mlp.up, mesh, inter)
    mlp.down = RowParallelLinear.from_linear(
        mlp.down, mesh, (int(inter[0]), int(inter[-1]) + 1))


def _vocab_columns(head, cfg: GPTConfig, mesh):
    """An untied head ``[hidden, vocab]`` as a gathered column linear over
    this rank's vocabulary slice."""
    return ColumnParallelLinear.from_linear(
        head, mesh, np.arange(*sharding_util.split_range(cfg.vocab_size,
                                                         mesh)),
        gather_output=True)


def _shard_pipe(model, mesh) -> bool:
    """:func:`shard_model` of a :func:`GPTForCausalLMPipe`: the embedding
    section's ``wte`` vocab-parallel, the stacked blocks split as each
    block is (:meth:`~paddle_tpu_torch.nn.stacked.StackedLayers.
    split_template`), an untied head's columns gathered."""
    emb = model.pre_0
    if not isinstance(emb, GPTEmbeddingPipe):
        raise NotImplementedError(
            f"shard_model: a PipelineLayer whose first section is "
            f"{type(emb).__name__} is not a GPT pipe model")
    cfg = emb.cfg
    emb.wte = VocabParallelEmbedding.from_embedding(emb.wte, mesh)
    model.blocks.split_template(lambda blk: _shard_block(blk, cfg, mesh))
    head = model.post_0
    head = getattr(head, "head", head)
    if getattr(head, "head", None) is not None:
        head.head = _vocab_columns(head.head, cfg, mesh)
    model._mesh = mesh
    return True


#: the multi-LoRA hook (``serving.adapters``): called as ``hook(layer, x,
#: y)`` on the base output of every :func:`_serving_linear`; it adds a
#: per-lane low-rank update while an adapter binding is entered and returns
#: ``y`` untouched otherwise. None until an adapter arena exists.
_lora_hook = None


def set_lora_hook(fn) -> None:
    """Install the serving adapter hook (``serving.adapters`` does so when
    its first :class:`~paddle_tpu_torch.serving.adapters.AdapterArena` is
    made; ``paddle_tpu/models/gpt.py:127``). Idempotent."""
    global _lora_hook
    _lora_hook = fn


def _serving_linear(layer, x):
    """The attention/MLP matmul shared by the quantized and plain paths. An
    unquantized layer runs its own forward (the default path is unchanged);
    a layer with a ``weight_scale`` computes ``x @ ((int8 weight * scale)
    cast to x's dtype) + bias``, the JAX package's dequant-then-matmul.
    Either output then goes through the adapter hook, which is the identity
    unless an adapter binding is entered (training, ``generate()`` and the
    speculative verify run the same ops as without it).

    A :class:`RowParallelLinear` split over the ranks multiplies its split
    input, adds the adapter's partial product (this rank's rows of A),
    all-reduces, then adds its bias once (``paddle_tpu/models/gpt.py:
    201-245``); unsplit (one rank, or an axis held whole), the order is
    the whole layer's."""
    scale = getattr(layer, "weight_scale", None)
    if scale is not None and scale.dtype != torch.float32:
        raise TypeError(f"weight_scale is {scale.dtype}, not float32: "
                        "the model's dtype was changed after "
                        "quantization")
    # analysis: allow(mutable-global-capture) -- the hook is installed once,
    # before any engine with an adapter arena captures; what it adds is
    # decided by the binding its steps enter, not by this global
    hook = _lora_hook
    if isinstance(layer, RowParallelLinear) and getattr(layer, "split",
                                                        False):
        y = (layer.partial(x) if scale is None
             else torch.matmul(x, _dequant(layer, x.dtype)))
        if hook is not None:
            y = hook(layer, x, y)
        return layer.add_bias(layer.reduce(y))
    if scale is None:
        y = layer(x)
    else:
        y = torch.matmul(x, _dequant(layer, x.dtype))
        if isinstance(layer, RowParallelLinear):
            y = layer.reduce(y)
        y = y + layer.bias.to(y.dtype)
    return y if hook is None else hook(layer, x, y)


def _dequant(layer, dtype):
    """A quantized layer's weight, ``(int8 * scale)`` cast to ``dtype``."""
    return (layer.weight.float() * layer.weight_scale).to(dtype)


def serving_compute_dtype(model) -> torch.dtype:
    """The activation and KV dtype of a :class:`GPTForCausalLM` or bare
    :class:`GPTModel`: the attention weights' dtype, or the token
    embedding's (never quantized) once those weights are int8."""
    gpt = getattr(model, "gpt", model)
    dtype = gpt.layers[0].attn.qkv.weight.dtype
    return gpt.wte.weight.dtype if dtype == torch.int8 else dtype


def masked_attention(qa, ka, va, mask):
    """Core cached attention: ``qa`` ``[b, s, heads, dim]`` against an
    already updated K/V ``[b, kv_len, heads, dim]`` under a boolean ``mask``
    broadcasting against ``[b, heads, s, kv_len]``. Returns
    ``[b, s, heads, dim]``.

    The numerics contract shared by ``generate()`` and the serving engine's
    plain route: logits in the input dtype, masked to -1e30 (not -inf), a
    softmax in fp32, the probabilities cast back to the query dtype before
    P.V."""
    return plain_attention(qa, ka, va, 1.0 / math.sqrt(qa.shape[-1]), mask)


def causal_attention(q, k, v, dropout_p=0.0, training=False):
    """Non-cached causal attention ``[b, s, heads, dim]`` through
    :func:`scaled_dot_product_attention`: the flash kernels on a CUDA
    tensor at or above the flag's threshold, else the JAX package's
    ``_sdpa_reference`` math (mask ``finfo.min``, causal offset ``sk - sq``,
    fp32 softmax cast back)."""
    return scaled_dot_product_attention(q, k, v, is_causal=True,
                                        dropout_p=dropout_p,
                                        training=training)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        # whole on one card; shard_model makes them a ColumnParallelLinear
        # over this rank's heads and a RowParallelLinear over their rows
        self.qkv = Linear(h, 3 * h, device=device)
        self.proj = Linear(h, h, device=device)
        self.dropout = cfg.dropout
        #: the whole model's heads and this shard's first (shard_model)
        self.total_heads = cfg.num_heads
        self.head_offset = 0

    def forward(self, x, cache=None, start_pos=0):
        b, s, _ = x.shape
        # num_heads is the local count on a mesh (shard_model)
        qkv = _serving_linear(self.qkv, x).reshape(b, s, 3, self.num_heads,
                                                   self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is not None and hasattr(cache, "update_and_attend"):
            # the cache object owns its storage (the serving engine's paged
            # arena): it absorbs this chunk's k/v and attends q against it
            o, new_cache = cache.update_and_attend(q, k, v)
            return _serving_linear(self.proj, o.reshape(b, s, -1)), new_cache
        if cache is not None:
            # contiguous [b, max_len, heads, dim] buffers, written in place
            # at start_pos; attend over positions <= the query's position
            k_buf, v_buf = cache
            # analysis: allow(traced-cast) — generate()'s contiguous cache
            # only: a captured serving step's caches own update_and_attend
            pos = int(start_pos)
            k_buf[:, pos:pos + s] = k
            v_buf[:, pos:pos + s] = v
            j = torch.arange(k_buf.shape[1], device=x.device)[None, :]
            i = pos + torch.arange(s, device=x.device)[:, None]
            o = masked_attention(q, k_buf, v_buf, (j <= i)[None, None])
            return _serving_linear(self.proj, o.reshape(b, s, -1)), (k_buf,
                                                                     v_buf)
        with self._heads_box():
            o = causal_attention(q, k, v, dropout_p=self.dropout,
                                 training=self.training)
        return _serving_linear(self.proj, o.reshape(b, s, -1))

    def _heads_box(self):
        """A split attention's probabilities ``[b, heads, s, s]`` are a box
        of the whole model's along the heads: its dropout draws there."""
        if self.num_heads == self.total_heads:
            return contextlib.nullcontext()
        return dropout_op.box({1: (self.head_offset, self.total_heads,
                                   self.num_heads)})


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.up = Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.down = Linear(cfg.intermediate_size, cfg.hidden_size,
                           device=device)

    def forward(self, x):
        return _serving_linear(self.down,
                               gelu_tanh(_serving_linear(self.up, x)))


class GPTDecoderLayer(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln1 = LayerNorm(cfg.hidden_size, eps, device=device)
        self.attn = GPTAttention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.hidden_size, eps, device=device)
        self.mlp = GPTMLP(cfg, device=device)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x, cache=None, start_pos=0):
        if cache is not None:
            attn_out, new_cache = self.attn(self.ln1(x), cache=cache,
                                            start_pos=start_pos)
            x = x + self.drop(attn_out)
            x = x + self.drop(self.mlp(self.ln2(x)))
            return x, new_cache
        x = x + self.drop(self.attn(self.ln1(x)))
        return x + self.drop(self.mlp(self.ln2(x)))


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             device=device)
        self.drop = Dropout(cfg.dropout)
        self.layers = nn.ModuleList([GPTDecoderLayer(cfg, device=device)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device=device)

    def gen_kv_caches(self, batch: int, max_len: int):
        """Per-layer contiguous ``(k, v)`` buffers ``[b, max_len, heads,
        dim]`` in the compute dtype, for incremental decoding."""
        dtype, dev = serving_compute_dtype(self), self.wte.weight.device
        shape = (batch, max_len, self.layers[0].attn.num_heads,
                 self.cfg.hidden_size // self.cfg.num_heads)
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in self.layers]

    def forward(self, input_ids, caches=None, start_pos=0):
        b, s = input_ids.shape
        dev = input_ids.device
        steps = torch.arange(s, device=dev)
        if caches is None:
            # the position table bounds the length; under torch.export this
            # gives a symbolic length its range (the attention route reads it)
            torch._check(s <= self.cfg.max_position_embeddings,
                         lambda: f"sequence length {s} exceeds "
                         "max_position_embeddings "
                         f"{self.cfg.max_position_embeddings}")
            pos = steps + _seq_offset(s)
        elif isinstance(start_pos, torch.Tensor) and start_pos.ndim == 1:
            # per-sequence positions [b] (each serving slot sits at its own
            # context length)
            pos = start_pos.long()[:, None] + steps
        else:
            # an int or a device scalar: added on the device, no host copy
            # (a captured serving step passes its prefix length so)
            pos = steps + start_pos
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        if caches is None:
            remat = self.cfg.use_recompute and torch.is_grad_enabled()
            for layer in self.layers:
                x = (recompute(layer, x, policy=self.cfg.recompute_policy)
                     if remat else layer(x))
            return self.ln_f(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, nc = layer(x, cache=cache, start_pos=start_pos)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


def _seq_offset(s: int) -> int:
    """The global position of this rank's first token: ``sep_rank * s`` on
    a training mesh whose ``sep`` axis shards the sequence (each rank holds
    ``s`` of its tokens, :func:`~paddle_tpu_torch.distributed.parallel.
    shard_batch`), else 0."""
    from ..distributed.mesh import get_hybrid_mesh

    mesh = get_hybrid_mesh()
    if mesh is None or mesh.axis_size("sep") <= 1:
        return 0
    return mesh.axis_rank("sep") * s


class GPTForCausalLM(nn.Module):
    """GPT with the LM head tied to the token embedding or, with
    ``tie_word_embeddings=False``, an ``lm_head`` of its own (weight
    ``[hidden, vocab]``, no bias). Built on ``device`` (default ``"cuda"``,
    raising without CUDA) and initialised with an explicit
    ``torch.Generator`` seeded 0: N(0, 0.02) matrices and embeddings, zero
    biases, unit LayerNorm scales. :func:`load_functional_state` replaces
    them. ``train()`` / ``eval()`` switch dropout as in torch; a model
    starts in eval mode."""

    def __init__(self, cfg: GPTConfig, device=device_mod.DEFAULT_DEVICE):
        super().__init__()
        dev = device_mod.resolve(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=dev)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  device=dev, bias=False)
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
                    p.fill_(1.0)
                elif name.endswith(".bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=gen)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def _head(self, h):
        """The LM head: ``h @ wte^T`` (tied) or ``lm_head(h)``, each the
        JAX package's ``linear`` without bias (``linear_nb`` under AMP)."""
        if not self.cfg.tie_word_embeddings:
            return self.lm_head(h)
        h, w = amp.cast_inputs("linear_nb", h, self.gpt.wte.weight)
        if isinstance(self.gpt.wte, VocabParallelEmbedding):
            return self.gpt.wte.logits(h, w)
        return torch.matmul(h, w.t())

    def forward(self, input_ids, labels=None):
        """Logits ``[b, s, vocab]`` of a full causal forward (no cache) or,
        with ``labels`` ``[b, s]``, the mean cross entropy of the f32
        logits over ``[-1, vocab]`` (labels -100 are ignored), chunked
        when ``loss_chunk_size > 0``; on a split model over this rank's
        vocabulary rows (:meth:`_split_head`)."""
        h = self.gpt(input_ids)
        if labels is not None and self.cfg.loss_chunk_size > 0:
            return self._chunked_loss(h, labels)
        if labels is not None and self._split_head() is not None:
            return self._parallel_loss(h, labels)
        logits = self._head(h)
        if labels is None:
            return logits
        return cross_entropy(logits.reshape(-1, self.cfg.vocab_size).float(),
                             labels.reshape(-1), reduction="mean")

    def _split_head(self):
        """``(weight [vocab_local, hidden], lo, group)`` of a head split by
        vocabulary rows over the model axis (the tied embedding's rows, or
        an untied head's columns transposed), else None."""
        if self.cfg.tie_word_embeddings:
            wte = self.gpt.wte
            if isinstance(wte, VocabParallelEmbedding) and wte.split:
                return wte.weight, wte.rows[0], wte.mesh.group
            return None
        head = self.lm_head
        if isinstance(head, ColumnParallelLinear) and head.split:
            return (head.weight.t(), int(head.columns[0]), head.mesh.group)
        return None

    def _parallel_loss(self, h, labels):
        """The mean vocab-parallel cross entropy of this rank's logits
        ``h @ W_local^T`` (``h`` through *f*), the JAX package's ``linear``
        without bias and f32 loss; the mean over the valid labels (global
        on a data axis)."""
        w, lo, group = self._split_head()
        h, w = amp.cast_inputs("linear_nb", h, w)
        hf = collective.copy_to_model_parallel(h.reshape(-1, h.shape[-1]),
                                               group)
        yf = labels.reshape(-1).long()
        loss = parallel_cross_entropy(torch.matmul(hf, w.t()).float(), yf,
                                      group, lo)
        return parallel.global_token_mean(loss.sum(),
                                          (yf != -100).sum().float(),
                                          floor=1e-12)

    def _chunked_loss(self, h, labels):
        """The JAX package's fused head and cross entropy over chunks of
        ``loss_chunk_size`` tokens: the tokens padded to whole chunks with
        label -100, each chunk's ``[chunk, vocab]`` logits made in the
        ambient dtype under :func:`recompute` (made again in backward,
        never kept), logsumexp and the picked logit in f32, the
        chunks' sums added in order and divided by ``max(valid tokens,
        1)``. Under AMP the hidden states and the head weight are cast as
        the JAX package's ``chunked_lm_loss`` op (white-listed). On a split
        model each chunk's logits are this rank's vocabulary columns and
        its loss the vocab-parallel cross entropy (``h`` through *f* once,
        before the chunks); on a data axis the valid count is global."""
        split = self._split_head()
        if split is not None:
            w, lo, group = split
            w = w.t()
        else:
            w = (self.gpt.wte.weight.t() if self.cfg.tie_word_embeddings
                 else self.lm_head.weight)
        h, w = amp.cast_inputs("chunked_lm_loss", h, w)
        chunk = int(self.cfg.loss_chunk_size)
        hf = h.reshape(-1, h.shape[-1])
        if split is not None:
            hf = collective.copy_to_model_parallel(hf, group)
        yf = labels.reshape(-1).long()
        pad = (-hf.shape[0]) % chunk
        if pad:
            hf = torch.nn.functional.pad(hf, (0, 0, 0, pad))
            yf = torch.nn.functional.pad(yf, (0, pad), value=-100)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for a in range(0, hf.shape[0], chunk):
            if split is None:
                part = recompute(_chunk_loss_sum, hf[a:a + chunk],
                                 yf[a:a + chunk], w)
            else:
                part = recompute(_parallel_chunk_loss_sum, hf[a:a + chunk],
                                 yf[a:a + chunk], w, group, lo)
            total = total + part
        count = (yf != -100).sum().float()
        return parallel.global_token_mean(total, count)

    def _head_logits(self, h_last):
        """Next-token logits ``[b, vocab]`` from last hidden states
        ``[b, hidden]``: the one head computation ``generate()`` and the
        serving engine share: ``h @ wte^T``, or ``lm_head`` untied. On a
        mesh each rank's vocabulary slice is gathered whole on every rank
        (:meth:`VocabParallelEmbedding.logits`), so every rank samples the
        same token from the same keys."""
        if not self.cfg.tie_word_embeddings:
            return self.lm_head(h_last)
        if isinstance(self.gpt.wte, VocabParallelEmbedding):
            return self.gpt.wte.logits(h_last)
        return torch.matmul(h_last, self.gpt.wte.weight.t())

    def verify_logits(self, h_seq):
        """Verify-k head (``paddle_tpu/models/gpt.py:621``): next-token
        logits ``[b, s, vocab]`` of ``s`` hidden states ``[b, s, hidden]``,
        the head of the serving engine's speculative verify step. Never one
        ``[b*s, hidden]`` product: each position goes through
        :meth:`_head_logits` as a dense ``[b, hidden]`` operand, the shape
        and layout the decode step hands it, so that the product picks the
        same kernel and verifying k proposals gives the logits of k decode
        steps bit for bit. ``s`` is the engine's static ``k + 1``."""
        return torch.stack([self._head_logits(h_seq[:, j].contiguous())
                            for j in range(h_seq.shape[1])], dim=1)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token_id: int = -1,
                 seed: int = 0, use_cache: bool = True, stop_token_id=None,
                 sampling=None):
        """Autoregressive decoding with the JAX package's arguments and
        semantics, run eagerly: one prefill of the prompt into contiguous
        per-layer KV buffers, then one single-token step per new token
        (``use_cache=False`` instead re-runs the causal forward over the
        padded buffer at every step).

        Token selection, in order of precedence:

        * ``sampling`` (a ``SamplingParams``): the serving engine's sampling
          core (:func:`paddle_tpu_torch.ops.sampling.sample`) with
          positional keys: row ``i``'s token at context index ``pos`` draws
          under ``fold_in(PRNGKey(seed + i), pos)``, ``seed`` being
          ``sampling.seed`` or, when that is None, the ``seed`` argument
          (``seed + i`` wraps in int32). A request served with the same
          params emits the same tokens.
        * ``do_sample``: a sequential key, ``key, sub = split(key)`` per
          step from ``PRNGKey(seed)``, and ``categorical(sub,
          _filter_logits(logits / max(temperature, 1e-6)))``.
        * otherwise greedy ``argmax``.

        With ``stop_token_id`` each sequence finishes when it emits that
        token and decoding ends once every sequence has; with
        ``eos_token_id >= 0`` (used only without ``stop_token_id``) a
        finished row is filled with it. Positions after a finish carry
        that token. Returns ``[batch, prompt_len + max_new_tokens]`` int64
        token ids on the model's device.

        Runs in eval mode (no dropout), then restores the training mode,
        as the JAX package does. On a model split over a mesh every rank
        calls it with the same arguments: each runs the same loop (its
        collectives meet), gathers the logits whole for the pick only and
        draws under the same keys, so every rank returns the whole model's
        tokens."""
        was_training = self.training
        self.eval()
        try:
            return self._generate(input_ids, max_new_tokens, do_sample,
                                  temperature, top_k, top_p, eos_token_id,
                                  seed, use_cache, stop_token_id, sampling)
        finally:
            self.train(was_training)

    @torch.no_grad()
    def _generate(self, input_ids, max_new_tokens, do_sample, temperature,
                  top_k, top_p, eos_token_id, seed, use_cache,
                  stop_token_id, sampling):
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device).long()
        b, prompt_len = ids.shape
        total = prompt_len + int(max_new_tokens)
        if total > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt+new tokens {total} exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        dev, vocab = self.device, self.cfg.vocab_size
        stop = None if stop_token_id is None else int(stop_token_id)
        fill = stop if stop is not None else (
            int(eos_token_id) if eos_token_id >= 0 else None)
        key = None
        if sampling is not None:
            base = int(seed if sampling.seed is None else sampling.seed)
            if not -2 ** 31 <= base < 2 ** 31:
                raise OverflowError(f"seed {base} is not a 32-bit integer")
            seeds = _wrap_int32(base + torch.arange(b, device=dev))
            params = (torch.full((b,), sampling.temperature,
                                 dtype=torch.float32, device=dev),
                      torch.full((b,), sampling.top_k, dtype=torch.int32,
                                 device=dev),
                      torch.full((b,), sampling.top_p, dtype=torch.float32,
                                 device=dev), seeds)
        elif do_sample:
            key = rng.prng_key(seed, device=dev)
            divisor = torch.full((), max(float(temperature), 1e-6),
                                 dtype=torch.float32, device=dev)

        def sample_next(logits, pos):
            nonlocal key
            if sampling is not None:
                where = torch.full((b,), pos, dtype=torch.int32, device=dev)
                return sample_rows(logits, *params, where)[0]
            if do_sample:
                key, sub = rng.split(key).unbind(0)
                # in the logits' dtype, as JAX divides by a weak scalar
                scaled = _filter_logits(logits / divisor.to(logits.dtype),
                                        top_k, top_p, vocab)
                return rng.categorical(sub, scaled)
            return torch.argmax(logits, dim=-1)

        out = torch.full((b, total), 0 if stop is None else stop,
                         dtype=torch.long, device=dev)
        out[:, :prompt_len] = ids
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        if use_cache:
            caches = self.gpt.gen_kv_caches(b, total)
            h, caches = self.gpt(ids, caches=caches, start_pos=0)
            h_last = h[:, -1]
        for pos in range(prompt_len, total):
            logits = (self._head_logits(h_last) if use_cache
                      else self(out)[:, pos - 1])
            nxt = sample_next(logits, pos)
            if fill is not None:
                nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
                done |= nxt == fill
            out[:, pos] = nxt
            if pos + 1 == total or (stop is not None and bool(done.all())):
                break
            if use_cache:
                h, caches = self.gpt(nxt[:, None], caches=caches,
                                     start_pos=pos)
                h_last = h[:, 0]
        return out


class GPTEmbeddingPipe(nn.Module):
    """First pipeline section: token + position embeddings and their
    dropout (``paddle_tpu/models/gpt.py:441``)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             device=device)
        self.drop = Dropout(cfg.dropout)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device) + _seq_offset(s)
        return self.drop(self.wte(input_ids) + self.wpe(pos))


class GPTHeadPipe(nn.Module):
    """Last pipeline section: the final norm and the LM head, tied (the
    embedding's weight, ``shared``) or an untied ``head`` of its own
    (``paddle_tpu/models/gpt.py:458``). On a split model the logits are
    gathered whole on every rank."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device=device)
        if not cfg.tie_word_embeddings:
            self.head = Linear(cfg.hidden_size, cfg.vocab_size,
                               device=device, bias=False)

    def forward(self, x, shared=None):
        h = self.ln_f(x)
        if not self.cfg.tie_word_embeddings:
            return self.head(h)
        h, w = amp.cast_inputs("linear_nb", h, shared.weight)
        if isinstance(shared, VocabParallelEmbedding):
            return shared.logits(h, w)
        return torch.matmul(h, w.t())


def gpt_pipe_loss(logits, labels):
    """The pipe model's loss: the mean cross entropy of the f32 logits
    (``paddle_tpu/models/gpt.py:475``; global over a data axis)."""
    vocab = logits.shape[-1]
    return cross_entropy(logits.reshape(-1, vocab).float(),
                         labels.reshape(-1), reduction="mean")


class _TiedHead(nn.Module):
    """The head bound to the embedding section's token embedding (the
    ``SharedLayerDesc`` tie: one parameter, its two gradient paths summed
    by autograd); the embedding is not a sublayer, so it counts once."""

    def __init__(self, head: GPTHeadPipe, emb: GPTEmbeddingPipe):
        super().__init__()
        self.head = head
        object.__setattr__(self, "_emb_ref", emb)

    def forward(self, x):
        return self.head(x, shared=self._emb_ref.wte)


def GPTForCausalLMPipe(cfg: GPTConfig, num_stages=None,
                       num_microbatches: int = 1,
                       num_virtual_pipeline_stages=None,
                       device=device_mod.DEFAULT_DEVICE):
    """The pipeline-parallel GPT (``paddle_tpu/models/gpt.py:486``): the
    embedding section, ``num_layers`` decoder blocks (the stacked run,
    ``blocks.*``) and the head section (tied to the embedding unless
    ``tie_word_embeddings=False``), ``gpt_pipe_loss`` its loss. Built on the
    thread's mesh: a pipe rank builds and holds only its stage's blocks.
    Initialised as :class:`GPTForCausalLM` is (N(0, 0.02), zero biases,
    unit LayerNorm scales), each block's row of a stacked parameter drawn
    on its own (:func:`_draw_rows`), so a rank draws only its rows and
    every pipe degree holds the same model; ``load_pipe_state`` replaces
    them. Starts in eval mode."""
    from ..distributed.fleet.meta_parallel.pp_layers import (LayerDesc,
                                                             PipelineLayer)

    dev = device_mod.resolve(device)
    emb = GPTEmbeddingPipe(cfg, device=dev)
    descs = [emb]
    descs += [LayerDesc(GPTDecoderLayer, cfg, device=dev)
              for _ in range(cfg.num_layers)]
    head = GPTHeadPipe(cfg, device=dev)
    descs.append(_TiedHead(head, emb) if cfg.tie_word_embeddings else head)
    model = PipelineLayer(
        descs, num_stages=num_stages, loss_fn=gpt_pipe_loss,
        num_microbatches=num_microbatches,
        recompute_interval=1 if cfg.use_recompute else 0,
        num_virtual_pipeline_stages=num_virtual_pipeline_stages)
    stacked = {id(p) for p in model.blocks.stacked_parameters()}
    with torch.no_grad():
        for k, (name, p) in enumerate(model.named_parameters()):
            if name.endswith(("ln1__weight", "ln2__weight", "ln_f.weight")):
                p.fill_(1.0)
            elif name.endswith(("bias", "__bias")):
                p.zero_()
            else:
                _draw_rows(p, k, id(p) in stacked)
    model.eval()
    return model


def _draw_rows(p, k: int, stacked: bool) -> None:
    """Parameter ``k`` (in ``named_parameters`` order) of a pipe model
    filled with N(0, 0.02): a stacked parameter row by row, whole row ``r``
    of the model drawn from a generator seeded ``(k << 24) + r`` (this
    rank's rows only), any other whole from one seeded ``k << 24``; then
    this rank's model-axis part of each."""
    from ..distributed.fleet.meta_parallel.mp_layers import split_indices

    gen = torch.Generator(device=p.device)
    whole = list(_whole_shape(p))
    rows = (p.pipe_rows if getattr(p, "pipe_rows", None) is not None
            else range(whole[0])) if stacked else [0]
    split = getattr(p, "split_index", None)
    for i, r in enumerate(rows):
        gen.manual_seed((k << 24) + int(r))
        draw = torch.empty(whole[1:] if stacked else whole,
                           device=p.device).normal_(0.0, 0.02, generator=gen)
        if split is not None:
            draw = draw.index_select(split[0] - int(stacked),
                                     split_indices(p).to(p.device))
        (p[i] if stacked else p).copy_(draw)


def _whole_shape(p) -> tuple:
    """The whole model's shape of parameter ``p``: a pipe rank's stacked
    rows are ``[num_layers, ...]``, a split part is whole along its
    ``split_index`` dim."""
    shape = list(p.shape)
    if getattr(p, "pipe_rows", None) is not None:
        shape[0] = p.pipe_whole
    if getattr(p, "split_index", None) is not None:
        shape[p.split_index[0]] = p.split_index[2]
    return tuple(shape)


def _local_part(p, whole: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``whole``: its pipe rows, then its model-axis
    part (a split parameter's ``split_index``)."""
    from ..distributed.fleet.meta_parallel.mp_layers import split_indices

    out = whole
    if getattr(p, "pipe_rows", None) is not None:
        out = out.index_select(0, torch.as_tensor(p.pipe_rows,
                                                  device=out.device))
    if getattr(p, "split_index", None) is not None:
        out = out.index_select(p.split_index[0],
                               split_indices(p).to(out.device))
    return out


def pipe_arrays(arrays: Dict[str, np.ndarray],
                num_layers: int) -> Dict[str, np.ndarray]:
    """A :class:`GPTForCausalLM`'s (tied) ``functional_state()`` arrays under
    the pipe model's names: ``blocks.<name>`` the ``num_layers`` blocks'
    ``gpt.layers.<i>.<name>`` stacked, ``pre_0.wte`` / ``pre_0.wpe`` the
    embeddings, ``post_0.head.ln_f`` the final norm. The two models then
    hold the same weights."""
    out = {"pre_0.wte.weight": arrays["gpt.wte.weight"],
           "pre_0.wpe.weight": arrays["gpt.wpe.weight"],
           "post_0.head.ln_f.weight": arrays["gpt.ln_f.weight"],
           "post_0.head.ln_f.bias": arrays["gpt.ln_f.bias"]}
    prefix = "gpt.layers.0."
    for name in arrays:
        if name.startswith(prefix):
            rest = name[len(prefix):]
            out["blocks." + rest.replace(".", "__")] = np.stack(
                [arrays[f"gpt.layers.{i}.{rest}"] for i in range(num_layers)])
    return out


def load_pipe_state(model: nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Copy the JAX package's ``functional_state()`` arrays of a pipe model
    (``blocks.<name>`` ``[num_layers, ...]``, ``pre_0.*``, ``post_0.*``)
    into ``model``: each parameter takes its part (a pipe rank its rows, a
    split parameter its model-axis part). Names must match (``KeyError``),
    and each whole shape (``ValueError``)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unknown = sorted(set(arrays) - set(params))
    if missing or unknown:
        raise KeyError(f"functional state mismatch: missing {missing[:5]}, "
                       f"unknown {unknown[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            whole = torch.from_numpy(np.ascontiguousarray(arrays[name]))
            if tuple(whole.shape) != _whole_shape(p):
                raise ValueError(f"{name}: array shape {tuple(whole.shape)} "
                                 f"!= the whole parameter's "
                                 f"{_whole_shape(p)}")
            p.copy_(_local_part(p, whole))


def _chunk_loss_sum(h, y, w):
    """One chunk of :meth:`GPTForCausalLM._chunked_loss`: the summed
    cross entropy of ``h [chunk, hidden] @ w [hidden, vocab]`` (in h's
    dtype) over the labels that are not -100, logsumexp and the picked
    logit in f32."""
    return cross_entropy(torch.matmul(h, w), y, reduction="sum")


def _parallel_chunk_loss_sum(h, y, w, group, lo):
    """One chunk of a split model's chunked loss: the summed vocab-parallel
    cross entropy of ``h @ w`` (``w`` this rank's ``[hidden, vocab_local]``
    columns, starting at ``lo``; the reductions over ``group``)."""
    return parallel_cross_entropy(torch.matmul(h, w).float(), y, group,
                                  lo).sum()


def load_functional_state(model: nn.Module,
                          arrays: Dict[str, np.ndarray]) -> None:
    """Copy arrays named as the JAX package's ``functional_state()`` into
    ``model`` (cast to each parameter's dtype and device). Every name and
    shape must match: a missing or unknown name raises ``KeyError``, a wrong
    shape ``ValueError``."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unknown = sorted(set(arrays) - set(params))
    if missing or unknown:
        raise KeyError(f"functional state mismatch: missing {missing[:5]}, "
                       f"unknown {unknown[:5]}")
    for name, p in params.items():
        shape = tuple(np.shape(arrays[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: array shape {shape} != parameter "
                             f"shape {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.ascontiguousarray(arrays[name])))


def seeded_state(model: nn.Module, seed: int = 0,
                 std: float = 0.02) -> Dict[str, np.ndarray]:
    """float32 arrays for every parameter of ``model``, drawn from a numpy
    generator seeded with ``seed``: LayerNorm scales ``1 + N(0, std)``,
    everything else ``N(0, std)``. The same arrays load into the JAX model,
    so both packages can run on identical weights."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        a = rng.standard_normal(tuple(p.shape), dtype=np.float32)
        a *= np.float32(std)
        if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            a += np.float32(1.0)
        out[name] = a
    return out
