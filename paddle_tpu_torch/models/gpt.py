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
the tied head's f32 logits; its gradient flows through the flash kernels'
backward.

Serving quantization: :func:`quantize_serving_weights` turns the attention
and MLP weights into int8 with per-output-channel float32 scales, in place,
and every such matmul runs through :func:`_serving_linear`, so
``generate()`` and the serving engine share one numerics contract on a
quantized model, as in the JAX package.

The JAX package's recompute, scan-layers and chunked-loss options and
dropout while training are not ported yet and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import amp, quantization
from ..core import device as device_mod
from ..core import rng
from ..nn.functional import cross_entropy, scaled_dot_product_attention
from ..nn.layers import Embedding, LayerNorm, Linear, gelu_tanh
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
    # JAX-package training options not ported yet: any non-default raises
    use_recompute: bool = False
    use_scan_layers: bool = False
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


def quantize_serving_weights(model) -> int:
    """Per-channel int8 weight-only quantization of every attention and MLP
    matmul of a :class:`GPTForCausalLM`, in place (the serving engine calls
    it at construction under ``quant_weights``).

    Each ``qkv``, ``proj``, ``up`` and ``down`` weight ``[in, out]`` becomes
    an int8 parameter without gradient, quantized per OUTPUT channel by
    :func:`paddle_tpu_torch.quantization.quantize_weight`, and its float32
    ``[1, out]`` scale a ``weight_scale`` buffer. No full-precision copy is
    kept. Embeddings, the tied head and the LayerNorms stay in the compute
    dtype. Quantize after the model's dtype is set: ``Module.to(dtype)``
    would cast the scale buffers (:func:`_serving_linear` then raises).
    Idempotent; returns the number of layers quantized by this call."""
    n = 0
    for blk in model.gpt.layers:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.up, blk.mlp.down):
            if getattr(lin, "weight_scale", None) is not None:
                continue
            with torch.no_grad():
                qw, scale = quantization.quantize_weight(lin.weight,
                                                         channel_axis=1)
            lin.weight = nn.Parameter(qw, requires_grad=False)
            lin.register_buffer("weight_scale", scale)
            n += 1
    return n


def _serving_linear(layer, x):
    """The attention/MLP matmul shared by the quantized and plain paths. An
    unquantized layer runs its own forward (the default path is unchanged);
    a layer with a ``weight_scale`` computes ``x @ ((int8 weight * scale)
    cast to x's dtype) + bias``, the JAX package's dequant-then-matmul."""
    scale = getattr(layer, "weight_scale", None)
    if scale is None:
        return layer(x)
    if scale.dtype != torch.float32:
        raise TypeError(f"weight_scale is {scale.dtype}, not float32: the "
                        "model's dtype was changed after quantization")
    w = (layer.weight.float() * scale).to(x.dtype)
    y = torch.matmul(x, w)
    return y + layer.bias.to(y.dtype)


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
        self.qkv = Linear(h, 3 * h, device=device)   # ColumnParallelLinear
        self.proj = Linear(h, h, device=device)      # RowParallelLinear
        self.dropout = cfg.dropout

    def forward(self, x, cache=None, start_pos=0):
        b, s, h = x.shape
        qkv = _serving_linear(self.qkv, x).reshape(b, s, 3, self.num_heads,
                                                   self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is not None and hasattr(cache, "update_and_attend"):
            # the cache object owns its storage (the serving engine's paged
            # arena): it absorbs this chunk's k/v and attends q against it
            o, new_cache = cache.update_and_attend(q, k, v)
            return _serving_linear(self.proj, o.reshape(b, s, h)), new_cache
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
            return _serving_linear(self.proj, o.reshape(b, s, h)), (k_buf,
                                                                    v_buf)
        o = causal_attention(q, k, v, dropout_p=self.dropout,
                             training=self.training)
        return _serving_linear(self.proj, o.reshape(b, s, h))


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
        self.drop = nn.Dropout(cfg.dropout)

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
        self.drop = nn.Dropout(cfg.dropout)
        self.layers = nn.ModuleList([GPTDecoderLayer(cfg, device=device)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device=device)

    def gen_kv_caches(self, batch: int, max_len: int):
        """Per-layer contiguous ``(k, v)`` buffers ``[b, max_len, heads,
        dim]`` in the compute dtype, for incremental decoding."""
        dtype, dev = serving_compute_dtype(self), self.wte.weight.device
        shape = (batch, max_len, self.cfg.num_heads,
                 self.cfg.hidden_size // self.cfg.num_heads)
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in self.layers]

    def forward(self, input_ids, caches=None, start_pos=0):
        b, s = input_ids.shape
        dev = input_ids.device
        steps = torch.arange(s, device=dev)
        if caches is None:
            pos = steps
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
            for layer in self.layers:
                x = layer(x)
            return self.ln_f(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, nc = layer(x, cache=cache, start_pos=start_pos)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    """GPT with the LM head tied to the token embedding (every config of the
    family ties it). Built on ``device`` (default ``"cuda"``, raising without
    CUDA) and initialised with an explicit ``torch.Generator`` seeded 0:
    N(0, 0.02) matrices and embeddings, zero biases, unit LayerNorm scales.
    :func:`load_functional_state` replaces them. ``train()`` / ``eval()``
    switch dropout as in torch; a model starts in eval mode."""

    def __init__(self, cfg: GPTConfig, device=device_mod.DEFAULT_DEVICE):
        super().__init__()
        for opt in ("use_recompute", "use_scan_layers", "loss_chunk_size"):
            if getattr(cfg, opt):
                raise NotImplementedError(f"GPTConfig.{opt} is not ported "
                                          "yet")
        dev = device_mod.resolve(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=dev)
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

    def forward(self, input_ids, labels=None):
        """Logits ``[b, s, vocab]`` of a full causal forward (no cache) or,
        with ``labels`` ``[b, s]``, the mean cross entropy of the f32
        logits over ``[-1, vocab]`` (labels -100 are ignored). The tied
        head is the JAX package's ``linear`` without bias (``linear_nb``
        under AMP)."""
        h, w = amp.cast_inputs("linear_nb", self.gpt(input_ids),
                               self.gpt.wte.weight)
        logits = torch.matmul(h, w.t())
        if labels is None:
            return logits
        return cross_entropy(logits.reshape(-1, self.cfg.vocab_size).float(),
                             labels.reshape(-1), reduction="mean")

    def _head_logits(self, h_last):
        """Next-token logits ``[b, vocab]`` from last hidden states
        ``[b, hidden]``: the one head computation ``generate()`` and the
        serving engine share: ``h @ wte^T``."""
        return torch.matmul(h_last, self.gpt.wte.weight.t())

    @torch.no_grad()
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
        token ids on the model's device."""
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
