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
* no cache: causal attention in plain PyTorch, the math of
  ``paddle_tpu.nn.functional.attention._sdpa_reference``. Where the JAX
  package would take its flash kernel (kv length at or above
  ``FLAGS_flash_attention_min_seqlen``) a CUDA tensor raises until that
  kernel is ported.

The port runs eagerly and serves inference only: dropout is identity in
eval mode and no loss or gradient path is ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..core import device as device_mod
from ..core import flags
from ..nn.layers import Embedding, LayerNorm, Linear, gelu_tanh

# the JAX package's untuned flash threshold: what its FLAGS default (-1,
# "auto") resolves to without an on-chip tuning record
_FLASH_AUTO_MIN_SEQLEN = 4608


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


def masked_attention(qa, ka, va, mask):
    """Core cached attention: ``qa`` ``[b, s, heads, dim]`` against an
    already updated K/V ``[b, kv_len, heads, dim]`` under a boolean ``mask``
    broadcasting against ``[b, heads, s, kv_len]``. Returns
    ``[b, s, heads, dim]``.

    The numerics contract shared by ``generate()`` and the serving engine's
    plain route: logits in the input dtype, masked to -1e30 (not -inf), a
    softmax in fp32, the probabilities cast back to the query dtype before
    P.V."""
    qt, kt, vt = (t.transpose(1, 2) for t in (qa, ka, va))
    scale = 1.0 / math.sqrt(qa.shape[-1])
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits.float(), dim=-1).to(qa.dtype)
    return torch.matmul(p, vt).transpose(1, 2)


def _flash_min_seqlen() -> int:
    thr = int(flags.flag("flash_attention_min_seqlen"))
    return _FLASH_AUTO_MIN_SEQLEN if thr < 0 else thr


def causal_attention(q, k, v):
    """Non-cached causal attention ``[b, s, heads, dim]``: the JAX package's
    off-TPU ``_sdpa_reference`` (mask value ``finfo.min``, causal offset
    ``sk - sq``, fp32 softmax cast back). Never calls
    ``scaled_dot_product_attention``."""
    sk = k.shape[1]
    thr = _flash_min_seqlen()
    if q.is_cuda and (thr == 0 or sk >= thr):
        raise NotImplementedError(
            f"kv length {sk} routes to the flash attention kernel "
            f"(FLAGS_flash_attention_min_seqlen={thr}), which is not ported "
            "to CUDA yet")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    sq = logits.shape[-2]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
    logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(p, vt).transpose(1, 2)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.qkv = Linear(h, 3 * h, device=device)   # ColumnParallelLinear
        self.proj = Linear(h, h, device=device)      # RowParallelLinear

    def forward(self, x, cache=None, start_pos=0):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is not None and hasattr(cache, "update_and_attend"):
            # the cache object owns its storage (the serving engine's paged
            # arena): it absorbs this chunk's k/v and attends q against it
            o, new_cache = cache.update_and_attend(q, k, v)
            return self.proj(o.reshape(b, s, h)), new_cache
        if cache is not None:
            # contiguous [b, max_len, heads, dim] buffers, written in place
            # at start_pos; attend over positions <= the query's position
            k_buf, v_buf = cache
            pos = int(start_pos)
            k_buf[:, pos:pos + s] = k
            v_buf[:, pos:pos + s] = v
            j = torch.arange(k_buf.shape[1], device=x.device)[None, :]
            i = pos + torch.arange(s, device=x.device)[:, None]
            o = masked_attention(q, k_buf, v_buf, (j <= i)[None, None])
            return self.proj(o.reshape(b, s, h)), (k_buf, v_buf)
        o = causal_attention(q, k, v)
        return self.proj(o.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.up = Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.down = Linear(cfg.intermediate_size, cfg.hidden_size,
                           device=device)

    def forward(self, x):
        return self.down(gelu_tanh(self.up(x)))


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
        dim]`` in the model's dtype, for incremental decoding."""
        w = self.wte.weight
        shape = (batch, max_len, self.cfg.num_heads,
                 self.cfg.hidden_size // self.cfg.num_heads)
        return [(torch.zeros(shape, dtype=w.dtype, device=w.device),
                 torch.zeros(shape, dtype=w.dtype, device=w.device))
                for _ in self.layers]

    def forward(self, input_ids, caches=None, start_pos=0):
        b, s = input_ids.shape
        dev = input_ids.device
        steps = torch.arange(s, device=dev)
        if caches is None:
            pos = steps
        else:
            # an int, or per-sequence positions [b] (each serving slot sits
            # at its own context length)
            off = torch.as_tensor(start_pos, device=dev).long()
            pos = off[:, None] + steps if off.ndim == 1 else off + steps
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
    :func:`load_functional_state` replaces them."""

    def __init__(self, cfg: GPTConfig, device=device_mod.DEFAULT_DEVICE):
        super().__init__()
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

    def forward(self, input_ids):
        """Logits ``[b, s, vocab]`` of a full causal forward (no cache)."""
        return torch.matmul(self.gpt(input_ids), self.gpt.wte.weight.t())

    def _head_logits(self, h_last):
        """Next-token logits ``[b, vocab]`` from last hidden states
        ``[b, hidden]``: the one head computation ``generate()`` and the
        serving engine share: ``h @ wte^T``."""
        return torch.matmul(h_last, self.gpt.wte.weight.t())

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 stop_token_id=None):
        """Greedy decoding over contiguous per-layer KV buffers: one prefill
        of the prompt, then one single-token step per new token.

        With ``stop_token_id`` each sequence finishes when it emits that
        token and decoding ends once every sequence has; positions after a
        sequence's stop are filled with it. Returns ``[batch, prompt_len +
        max_new_tokens]`` int64 token ids on the model's device."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device).long()
        b, prompt_len = ids.shape
        total = prompt_len + int(max_new_tokens)
        if total > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt+new tokens {total} exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        stop = None if stop_token_id is None else int(stop_token_id)
        out = torch.full((b, total), 0 if stop is None else stop,
                         dtype=torch.long, device=self.device)
        out[:, :prompt_len] = ids
        caches = self.gpt.gen_kv_caches(b, total)
        h, caches = self.gpt(ids, caches=caches, start_pos=0)
        h_last = h[:, -1]
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        for pos in range(prompt_len, total):
            nxt = torch.argmax(self._head_logits(h_last), dim=-1)
            if stop is not None:
                nxt = torch.where(done, torch.full_like(nxt, stop), nxt)
                done |= nxt == stop
            out[:, pos] = nxt
            if pos + 1 == total or (stop is not None and bool(done.all())):
                break
            h, caches = self.gpt(nxt[:, None], caches=caches, start_pos=pos)
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
