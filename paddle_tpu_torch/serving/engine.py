"""Slot-based continuous-batching decode engine (counterpart of
``paddle_tpu/serving/engine.py``).

The engine runs ONE decode step over ``[num_slots]`` lanes. Each slot holds
at most one in-flight request: its last token, its write position and a
block table into the paged KV arena (:mod:`.kv_arena`). Admitting a request
prefills its prompt, padded to a ``compile_cache.prefill_bucket`` length,
and scatters the prompt's K/V into the slot's blocks; retiring returns the
blocks. All per-request state is data (block tables, positions, lane
masks), so any occupancy pattern runs the same step. Inactive lanes still
run the model, write to scratch block 0, and their tokens are discarded.

Attention always goes through the :mod:`paddle_tpu_torch.ops.paged_attention`
wrappers, which pick the route by the tensors' device: the hand-written CUDA
kernels on the card, their plain PyTorch versions on the CPU. There is no
switch between the two on the card; :meth:`ServingEngine.kernel_route`
reports the route.

Quantized serving (``ServingConfig.quant_weights`` / ``quant_kv``, or
``FLAGS_serving_quant_weights`` / ``FLAGS_serving_quant_kv``, both off by
default) and chunked prefill (``chunked_prefill`` /
``FLAGS_serving_chunked_prefill``) are captured once at construction. With
``quant_weights`` the model's attention and MLP weights become int8 with
per-channel scales (``models.gpt.quantize_serving_weights``); with
``quant_kv`` the arena holds int8 K/V with per-token-row scales, quantized
as rows are scattered (:func:`_scatter_rows`) and dequantized as they are
read (the int8 paged kernels). A prompt longer than the chunk size is
admitted by :meth:`ServingEngine.admit_begin` and prefilled one chunk per
:meth:`ServingEngine.admit_chunk` through the slot's block table
(:class:`_PrefixPrefillView`): running streams go on decoding between
chunks.

The engine owns one program per kind of model call, as the JAX engine owns
one compiled program each (:mod:`.graphs`): the decode step, one whole-prompt
prefill per ``compile_cache.prefill_bucket`` and one suffix/chunk prefill
per (clamped) suffix bucket. Each runs over static buffers refilled in
place with the call's data -- last tokens, positions, write rows and
offsets, block tables, the prefix length and the true length -- so admit,
retire, block growth and chunk progress never build a program again. On a
CUDA device a program is a captured CUDA graph, replayed on every call; on
the CPU the same step function runs eagerly over the same buffers. The
trace counters keep the JAX engine's meaning, one per build of a program
(a capture on CUDA, a first run on the CPU): ``decode_traces``,
``prefill_traces`` and ``prefix_prefill_traces`` by bucket, and
``compile_cache`` ``serving.decode_compiles`` / ``serving.prefill_compiles``
(with ``metrics`` ``kernel.decode_traces`` / ``kernel.prefill_traces`` on
the kernel route). The K/V pools are updated in place. :meth:`close`
drops the programs and their graph pool.

Per-slot scenario state is data too, as in the JAX engine: each slot's
``temperature``, ``top_k``, ``top_p`` and ``seed`` and its row of the
``[S, vocab]`` constraint mask (all-True when unconstrained) are installed
when the slot is claimed, before any prefill (:meth:`_install_slot_scenario`),
and reset when it is freed; the four parameters are the rows of one
``[4, S]`` int32 buffer (the floats bit-cast). Every step ends in
:func:`.sampling.sample_tokens`: the decode step over that buffer and
the resident mask (a :class:`.graphs.ResidentBuffer`: only rows that
changed are copied, :meth:`set_slot_mask`), its tokens keyed at
``positions + 1``; each prefill program over ``[1]`` buffers and the slot's
mask row, its token keyed at the context index it will sit at. On the card
that is the sampling kernel, one launch per step, prefill or chunk. The
prefix cache, preemption, speculation, LoRA, tiering and the supervisor are
later slices.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import compile_cache, flags
from ..core import device as device_mod
from ..models.gpt import quantize_serving_weights, serving_compute_dtype
from ..ops import paged_attention
from ..ops import sampling as sampling_ops
from ..ops.paged_attention import (check_servable, paged_decode_attention,
                                   paged_full_prefill_attention,
                                   paged_prefill_attention)
from ..quantization import quantize_kv
from . import metrics
from .graphs import ResidentBuffer, StepGraphs
from .kv_arena import KVArena, Reservation
from .sampling import sample_tokens


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _samp_params(samp: torch.Tensor) -> tuple:
    """The rows of a ``[4, R]`` int32 sampling buffer as ``(temperature,
    top_k, top_p, seeds)``, each ``[R]``, the floats bit-cast back."""
    return (samp[0].view(torch.float32), samp[1],
            samp[2].view(torch.float32), samp[3])


def _scatter_rows(entry, row, off, kc, vc) -> None:
    """Write one chunk's k/v rows ``[n, H, D]`` at ``(row, off)`` of a pool
    entry, in place. An int8 ``(k, v, k_scale, v_scale)`` entry quantizes
    each token row (:func:`paddle_tpu_torch.quantization.quantize_kv`) and
    writes its scale at the same ``(row, off)``."""
    if len(entry) == 2:
        kp, vp = entry
        kp.index_put_((row, off), kc)
        vp.index_put_((row, off), vc)
        return
    kp, vp, ks, vs = entry
    for pool, scales, x in ((kp, ks, kc), (vp, vs, vc)):
        q, scale = quantize_kv(x)
        pool.index_put_((row, off), q)
        scales.index_put_((row, off), scale)


class _PagedCacheView:
    """One layer's decode-step view of the arena (the ``cache`` protocol
    object ``GPTAttention.forward`` drives): write each lane's new k/v at its
    ``(row, off)`` -- inactive lanes carry row 0, the scratch block -- then
    attend through the paged decode wrapper. The JAX view derives the rows
    from the lane mask on the device; here the engine computes them on the
    host, where the tables live anyway, and hands them over in the decode
    program's static buffers."""

    def __init__(self, entry, block_tables, positions, rows, offs):
        self.entry = entry
        self.block_tables = block_tables  # [S, max_blocks] int32
        self.positions = positions        # [S] int32: write pos of new token
        self.rows = rows                  # [S] int64 physical write block
        self.offs = offs                  # [S] int64 offset in that block

    def update_and_attend(self, q, k, v):
        _scatter_rows(self.entry, self.rows, self.offs, k[:, 0], v[:, 0])
        o = paged_decode_attention(q[:, 0], self.entry, self.block_tables,
                                   self.positions)
        return o[:, None], self


class _CapturePrefillView:
    """Prefill-side cache protocol object: causal attention over the padded
    prompt through the full-prefill wrapper (the chunk's own K/V viewed as a
    contiguous pseudo-table), returning the chunk's k/v so the engine can
    scatter them into the slot's blocks."""

    def __init__(self, block_size: int):
        self.block_size = block_size

    def update_and_attend(self, q, k, v):
        o = paged_full_prefill_attention(q[0], k[0], v[0], self.block_size)
        return o[None], (k, v)


class _PrefixPrefillView:
    """One layer's view for a prefill over a slot whose first
    ``prefix_len`` positions are already in the arena (one chunk of a
    chunked admission): scatter the chunk's k/v at global positions
    ``prefix_len + i`` through the slot's table -- padded rows go to
    scratch block 0, rows and offsets computed by the engine on the host --
    then attend its queries through the paged prefill wrapper, which reads
    the resident prefix and the chunk through the table. ``prefix_len`` is
    an int32 device scalar: runtime data to the kernel."""

    def __init__(self, entry, bt_row, prefix_len, rows, offs):
        self.entry = entry
        self.bt_row = bt_row          # [max_blocks] int32: the slot's table
        self.prefix_len = prefix_len  # int32 device scalar
        self.rows = rows              # [bucket] int64 physical write block
        self.offs = offs              # [bucket] int64 offset in that block

    def update_and_attend(self, q, k, v):
        _scatter_rows(self.entry, self.rows, self.offs, k[0], v[0])
        o = paged_prefill_attention(q[0], self.entry, self.bt_row,
                                    self.prefix_len)
        return o[None], self


@dataclass
class ServingConfig:
    """Engine sizing and modes. Zeros and None defer to flags / the model
    config: ``num_slots`` -> ``FLAGS_serving_slots``, ``kv_block_size`` ->
    ``FLAGS_kv_block_size``, ``max_model_len`` ->
    ``cfg.max_position_embeddings``, ``num_blocks`` -> one full-length
    context per slot (+ scratch), ``prefill_bucket_min`` ->
    ``FLAGS_serving_prefill_bucket_min``, ``quant_weights`` ->
    ``FLAGS_serving_quant_weights`` (int8 weight-only matmuls; quantizes
    the model in place), ``quant_kv`` -> ``FLAGS_serving_quant_kv`` (int8
    KV arena), ``chunked_prefill`` -> ``FLAGS_serving_chunked_prefill``
    (chunk size in tokens, 0 = off)."""

    num_slots: int = 0
    kv_block_size: int = 0
    max_model_len: int = 0
    num_blocks: int = 0
    prefill_bucket_min: int = 0
    quant_weights: Optional[bool] = None
    quant_kv: Optional[bool] = None
    chunked_prefill: Optional[int] = None


@dataclass
class _AdmitState:
    """What an admission carries from its setup (slot and blocks claimed)
    to its finish (first token emitted, slot active): the unit of progress
    of a chunked prefill."""

    slot: int
    prompt: np.ndarray
    plen: int
    res: Reservation
    done: int = 0  # prompt positions already scattered (chunk progress)


class ServingEngine:
    """The slot runtime: slot bookkeeping, block-table growth, bucketed
    prefill and the decode step. Queueing and finish policy live in
    :class:`paddle_tpu_torch.serving.scheduler.Scheduler`."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=device_mod.DEFAULT_DEVICE):
        cfg = config or ServingConfig()
        self.device = device_mod.resolve(device)
        weight = model.gpt.wte.weight
        if weight.device != self.device:
            raise ValueError(f"the model lives on {weight.device}, the engine "
                             f"was asked to run on {self.device}")
        mcfg = model.cfg
        head_dim = mcfg.hidden_size // mcfg.num_heads
        dtype = serving_compute_dtype(model)
        # refused before anything is built or quantized in place
        check_servable(head_dim, dtype, self.device)
        self._model = model.eval()

        def mode(value, name):
            return flags.flag(name) if value is None else value

        self.quant_weights = bool(mode(cfg.quant_weights,
                                       "serving_quant_weights"))
        self.quant_kv = bool(mode(cfg.quant_kv, "serving_quant_kv"))
        self.chunk_size = int(mode(cfg.chunked_prefill,
                                   "serving_chunked_prefill"))
        self.num_slots = int(cfg.num_slots or flags.flag("serving_slots"))
        self.block_size = int(cfg.kv_block_size or flags.flag("kv_block_size"))
        self.max_model_len = int(cfg.max_model_len
                                 or mcfg.max_position_embeddings)
        if self.max_model_len > mcfg.max_position_embeddings:
            raise ValueError("max_model_len exceeds the model's "
                             "max_position_embeddings")
        self.blocks_per_slot = _ceil_div(self.max_model_len, self.block_size)
        num_blocks = int(cfg.num_blocks
                         or self.num_slots * self.blocks_per_slot + 1)
        self.prefill_bucket_min = int(
            cfg.prefill_bucket_min or flags.flag("serving_prefill_bucket_min"))
        if self.quant_weights:
            # in place and idempotent: engines may share one model
            n = quantize_serving_weights(model)
            if n:
                metrics.bump("quant.weight_layers", n)
        self.arena = KVArena(mcfg.num_layers, mcfg.num_heads, head_dim,
                             num_blocks, self.block_size, dtype=dtype,
                             quantized=self.quant_kv, device=self.device)

        s = self.num_slots
        self._bt_host = np.zeros((s, self.blocks_per_slot), np.int32)
        self._positions = np.zeros(s, np.int32)
        self._last_tok = np.zeros(s, np.int64)
        self._active = np.zeros(s, np.bool_)
        self._occupied = np.zeros(s, np.bool_)
        self._slot_res: List[Optional[Reservation]] = [None] * s
        self._slot_filled = np.zeros(s, np.int32)
        self._chunk = {}  # slot -> _AdmitState of a chunked prefill
        # per-slot sampling and constraint state, all data to the steps:
        # temperature 0 is greedy, the mask row all-True is unconstrained.
        # The four sampling parameters are the rows of one int32 array
        # (floats bit-cast): one static buffer and one copy per run
        self.vocab = int(mcfg.vocab_size)
        self._samp = np.zeros((4, s), np.int32)
        self._temp = self._samp[0].view(np.float32)
        self._top_k = self._samp[1]
        self._top_p = self._samp[2].view(np.float32)
        self._seed = self._samp[3]
        self._top_p[:] = 1.0
        self._constrained = np.zeros(s, np.bool_)  # mask row not all-True
        self._mask = ResidentBuffer(self.device, (s, self.vocab), torch.bool,
                                    True)
        self._mask_host = self._mask.host
        # lifetime per-engine admission counts
        self.sampled_admits = 0
        self.constrained_admits = 0
        # lifetime counts of this engine's model calls (each runs every
        # layer's attention once): what the kernel launch counters are
        # held against -- decode steps, whole-prompt prefills, and chunks
        # of chunked prefills
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_chunks = 0
        # builds of each program (the JAX engine's trace counters): churn
        # must never move them once a key exists
        self.decode_traces = 0
        self.prefill_traces: Dict[int, int] = {}
        self.prefix_prefill_traces: Dict[int, int] = {}
        self._graphs = StepGraphs(self.device,
                                  counters=(paged_attention.launches,
                                            sampling_ops.launches))
        self._meter = metrics.Meter()
        metrics.set_gauge("slots.total", s)
        self._refresh_gauges()

    # ----------------------------------------------------------- capacity

    def free_slots(self) -> int:
        return int((~self._occupied).sum())

    def active_slots(self) -> int:
        return int(self._active.sum())

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        return _ceil_div(prompt_len + max_new_tokens, self.block_size)

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        """Refuse at submit what could never be served."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt_len + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(f"prompt+new tokens {total} exceeds engine "
                             f"max_model_len {self.max_model_len}")
        need = self.blocks_needed(prompt_len, max_new_tokens)
        cap = self.arena.num_blocks - 1
        if need > cap:
            raise ValueError(f"request needs {need} KV blocks but the arena "
                             f"has only {cap} allocatable; it could never be "
                             "admitted")

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        return (self.free_slots() > 0 and self.arena.grantable()
                >= self.blocks_needed(prompt_len, max_new_tokens))

    # ----------------------------------------------------- slot lifecycle

    def admit(self, prompt, max_new_tokens: int, sampling=None,
              mask=None) -> Tuple[int, int]:
        """Prefill ``prompt`` into a free slot. Returns ``(slot,
        next_token)``: the first token comes out of the prefill itself,
        sampled under ``sampling`` (a ``SamplingParams`` with a seed; None is
        greedy) and the constraint ``mask`` (``[vocab]`` bool; None is
        unconstrained). Raises if there is no capacity; callers gate on
        :meth:`can_admit`."""
        st = self._admit_setup(prompt, max_new_tokens, sampling, mask)
        return st.slot, self._admit_prefill_all(st)

    def admit_begin(self, prompt, max_new_tokens: int, sampling=None,
                    mask=None) -> Tuple[int, Optional[int]]:
        """Chunked admission: claim a slot and its blocks now, prefill
        incrementally. Returns ``(slot, first_token)`` when the prompt fits
        one chunk (as :meth:`admit`), else ``(slot, None)`` with the prefill
        in progress: the scheduler then calls :meth:`admit_chunk` once per
        step until the first token appears. Until then the slot is occupied
        (its blocks are held) but not active (the decode step masks it)."""
        st = self._admit_setup(prompt, max_new_tokens, sampling, mask)
        if self.chunk_size <= 0 or st.plen <= self.chunk_size:
            return st.slot, self._admit_prefill_all(st)
        self._chunk[st.slot] = st
        metrics.bump("chunk.admits")
        self._refresh_gauges()
        return st.slot, None

    def admit_chunk(self, slot: int) -> Optional[int]:
        """Prefill the next chunk (at most ``chunk_size`` tokens) of the
        slot's chunked admission. Returns the first generated token once the
        whole prompt is scattered (the last chunk's last-position logits),
        else None. A failed chunk unwinds the admission and raises."""
        st = self._chunk.get(slot)
        if st is None:
            raise RuntimeError(f"slot {slot} has no chunked prefill in "
                               "progress")
        take = min(self.chunk_size, st.plen - st.done)
        try:
            # every chunk samples its token, as the JAX engine does; only
            # the last chunk's is the request's first
            nxt = self._suffix_prefill_call(st.prompt, st.done + take,
                                            st.done, slot)
        except BaseException:
            self._chunk.pop(slot, None)
            self._admit_abort(st)
            raise
        st.done += take
        metrics.bump("chunk.chunks")
        metrics.bump("chunk.tokens", take)
        if st.done < st.plen:
            return None
        self._chunk.pop(slot, None)
        return self._admit_finish(st, nxt)

    def _admit_prefill_all(self, st: _AdmitState) -> int:
        """The one-call prefill of a whole prompt; unwinds the admission on
        failure."""
        try:
            first = self._full_prefill_call(st.prompt, st.plen, st.res,
                                            st.slot)
        except BaseException:
            self._admit_abort(st)
            raise
        return self._admit_finish(st, first)

    def _admit_setup(self, prompt, max_new_tokens: int, sampling=None,
                     mask=None) -> _AdmitState:
        """Claim the slot, the block reservation and the blocks covering the
        prompt, and install the slot's sampling and constraint state before
        any prefill (the prefill programs sample the first token under it);
        unwinds completely on failure, a refused mask included."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        self.validate(plen, max_new_tokens)
        slot = int(np.argmin(self._occupied))
        if self._occupied[slot]:
            raise RuntimeError("no free slot")
        res = self.arena.reserve(self.blocks_needed(plen, max_new_tokens))
        st = _AdmitState(slot=slot, prompt=prompt, plen=plen, res=res)
        self._occupied[slot] = True
        self._slot_res[slot] = res
        try:
            self._install_slot_scenario(slot, sampling, mask)
            n = _ceil_div(plen, self.block_size)
            for bi in range(n):
                self._bt_host[slot, bi] = res.take()
            self._slot_filled[slot] = n
        except BaseException:
            self._admit_abort(st)
            raise
        return st

    def _admit_abort(self, st: _AdmitState) -> None:
        st.res.release()
        self._slot_res[st.slot] = None
        self._slot_filled[st.slot] = 0
        self._bt_host[st.slot, :] = 0
        self._occupied[st.slot] = False
        self._clear_slot_scenario(st.slot)
        self._refresh_gauges()

    def _admit_finish(self, st: _AdmitState, first: int) -> int:
        """Activate the slot: its context is scattered and its next token
        exists."""
        slot = st.slot
        self._positions[slot] = st.plen  # next write position
        self._last_tok[slot] = first
        self._active[slot] = True
        metrics.bump("engine.admits")
        metrics.bump("tokens.prefill", st.plen)
        metrics.bump("tokens.generated")  # the next token, out of prefill
        self._refresh_gauges()
        return first

    # ---------------------------------------------------- step programs

    def _decode_built(self) -> None:
        """Count one build of the decode program (the JAX engine counts at
        trace time)."""
        self.decode_traces += 1
        compile_cache.bump("serving.decode_compiles")
        if self.device.type == "cuda":
            metrics.bump("kernel.decode_traces")

    def _prefill_built(self, traces: Dict[int, int], bucket: int) -> None:
        """Count one build of a prefill program of ``bucket`` in
        ``traces`` (``prefill_traces`` or ``prefix_prefill_traces``)."""
        traces[bucket] = traces.get(bucket, 0) + 1
        compile_cache.bump("serving.prefill_compiles")
        if self.device.type == "cuda":
            metrics.bump("kernel.prefill_traces")

    def _decode_fn(self, last_tok, positions, rows, offs, block_tables,
                   samp, allowed):
        """The decode step over its static buffers: every lane's last token
        at its position, its k/v written at ``(rows, offs)`` (scratch block
        0 for inactive lanes), one token per lane sampled under the lane's
        parameters and mask row, keyed at ``positions + 1``: the context
        index where the new token will sit."""
        views = [_PagedCacheView(entry, block_tables, positions, rows, offs)
                 for entry in self.arena.pools]
        model = self._model
        h, _ = model.gpt(last_tok[:, None], caches=views, start_pos=positions)
        return (sample_tokens(model._head_logits(h[:, 0]),
                              *_samp_params(samp), positions + 1, allowed),)

    def _full_prefill_fn(self, ids, rows, offs, true_len, samp, spos,
                         allowed):
        """The whole-prompt prefill of one bucket: the model over the padded
        prompt, the token after position ``true_len - 1`` (runtime data, as
        the JAX program's ``dynamic_index_in_dim``), and every position's
        k/v scattered at ``(rows, offs)`` (padded ones to scratch block
        0). The token is sampled under the slot's ``[1]`` parameters and
        mask row, keyed at ``spos``, the context index it will sit at."""
        model = self._model
        views = [_CapturePrefillView(self.block_size)
                 for _ in range(model.cfg.num_layers)]
        h, chunks = model.gpt(ids, caches=views, start_pos=0)
        last = h.index_select(1, true_len.reshape(1) - 1)[:, 0]
        for (kc, vc), entry in zip(chunks, self.arena.pools):
            _scatter_rows(entry, rows, offs, kc[0], vc[0])
        return (sample_tokens(model._head_logits(last), *_samp_params(samp),
                              spos, allowed),)

    def _suffix_prefill_fn(self, ids, rows, offs, bt_row, prefix_len,
                           true_len, samp, spos, allowed):
        """The suffix/chunk prefill of one bucket through the slot's table
        row: positions ``prefix_len + i``, the chunk's k/v scattered before
        it is attended, the token after position ``true_len - 1`` of the
        chunk, sampled as in :meth:`_full_prefill_fn`."""
        views = [_PrefixPrefillView(entry, bt_row, prefix_len, rows, offs)
                 for entry in self.arena.pools]
        model = self._model
        h, _ = model.gpt(ids, caches=views, start_pos=prefix_len)
        last = h.index_select(1, true_len.reshape(1) - 1)[:, 0]
        return (sample_tokens(model._head_logits(last), *_samp_params(samp),
                              spos, allowed),)

    def _samp_row(self, slot: int, pos: int) -> dict:
        """One slot's sampling values for a prefill program: its ``[1]``
        parameters, the positional key ``pos`` (the context index where the
        emitted token will sit) and its mask row."""
        one = slice(slot, slot + 1)
        return dict(samp=self._samp[:, one], spos=np.int32(pos),
                    allowed=self._mask_host[one])

    @torch.no_grad()
    def _full_prefill_call(self, ctx: np.ndarray, clen: int,
                           res: Reservation, slot: int) -> int:
        """The whole-context prefill, padded to its bucket: the bucket's
        program over the prompt, the real positions' k/v scattered into the
        slot's blocks (padded positions to scratch block 0); the emitted
        token sits at context index ``clen`` and samples under the slot's
        parameters at that positional key."""
        bs = self.block_size
        p_bucket = compile_cache.prefill_bucket(clen, self.max_model_len,
                                                self.prefill_bucket_min)
        ids = np.zeros(p_bucket, np.int64)
        ids[:clen] = ctx
        rows = np.zeros(_ceil_div(p_bucket, bs), np.int64)
        rows[:len(res.taken)] = res.taken
        p_idx = np.arange(p_bucket)
        row = np.where(p_idx < clen, rows[p_idx // bs], 0)
        i64 = torch.int64
        prog = self._graphs.program(
            ("prefill", p_bucket), self._full_prefill_fn,
            functools.partial(self._prefill_built, self.prefill_traces,
                              p_bucket),
            ids=((1, p_bucket), i64), rows=((p_bucket,), i64),
            offs=((p_bucket,), i64), true_len=((), i64, 1),
            samp=((4, 1), torch.int32), spos=((1,), torch.int32),
            allowed=((1, self.vocab), torch.bool, 1))
        prog.run(ids=ids, rows=row, offs=p_idx % bs, true_len=clen,
                 **self._samp_row(slot, clen))
        nxt = int(prog.read()[0][0])
        self.prefills += 1
        # one count per call and bucket: the padding waste of the ladder
        compile_cache.bump(f"serving.prefill_bucket.{p_bucket}")
        metrics.bump("tokens.prefill_padding", p_bucket - clen)
        return nxt

    @torch.no_grad()
    def _suffix_prefill_call(self, ctx: np.ndarray, clen: int,
                             prefix_len: int, slot: int) -> int:
        """Prefill ``ctx[prefix_len:clen]``, padded to its bucket, attending
        the first ``prefix_len`` positions through the slot's (already
        filled) table instead of recomputing them; returns the token after
        position ``clen - 1``, sampled under the slot's parameters keyed at
        ``clen``. The chunk's k/v is scattered before it is attended; padded
        rows scatter to scratch block 0."""
        bs = self.block_size
        slen = clen - prefix_len
        s_bucket = compile_cache.prefill_bucket(slen, self.max_model_len,
                                                self.prefill_bucket_min)
        # padded rows only: keep every row's position inside the model's
        # position table (an embedding lookup past it would fault); the
        # clamped bucket is the program's key
        s_bucket = min(s_bucket,
                       self._model.cfg.max_position_embeddings - prefix_len)
        ids = np.zeros(s_bucket, np.int64)
        ids[:slen] = ctx[prefix_len:clen]
        table = self._bt_host[slot]
        p_idx = np.arange(s_bucket)
        gpos = prefix_len + p_idx
        row = np.where(p_idx < slen,
                       table[np.minimum(gpos // bs, table.shape[0] - 1)], 0)
        i64 = torch.int64
        prog = self._graphs.program(
            ("suffix", s_bucket), self._suffix_prefill_fn,
            functools.partial(self._prefill_built,
                              self.prefix_prefill_traces, s_bucket),
            ids=((1, s_bucket), i64), rows=((s_bucket,), i64),
            offs=((s_bucket,), i64),
            bt_row=((self.blocks_per_slot,), torch.int32),
            prefix_len=((), torch.int32), true_len=((), i64, 1),
            samp=((4, 1), torch.int32), spos=((1,), torch.int32),
            allowed=((1, self.vocab), torch.bool, 1))
        prog.run(ids=ids, rows=row, offs=gpos % bs, bt_row=table,
                 prefix_len=prefix_len, true_len=slen,
                 **self._samp_row(slot, clen))
        nxt = int(prog.read()[0][0])
        self.prefill_chunks += 1
        compile_cache.bump(f"serving.suffix_prefill_bucket.{s_bucket}")
        return nxt

    def retire(self, slot: int) -> None:
        """Free a slot: deactivate its lane and return its blocks."""
        if not self._occupied[slot]:
            return
        self._occupied[slot] = False
        self._active[slot] = False
        self._chunk.pop(slot, None)  # a chunked prefill still in progress
        res = self._slot_res[slot]
        self._slot_res[slot] = None
        if res is not None:
            res.release()
        self._slot_filled[slot] = 0
        self._bt_host[slot, :] = 0
        self._positions[slot] = 0
        self._last_tok[slot] = 0
        self._clear_slot_scenario(slot)
        metrics.bump("engine.retires")
        self._refresh_gauges()

    # ------------------------------------------------- per-slot scenario

    def _check_mask(self, mask) -> np.ndarray:
        row = np.asarray(mask, np.bool_).reshape(-1)
        if row.shape[0] != self.vocab:
            raise ValueError(f"constraint mask covers {row.shape[0]} tokens, "
                             f"vocab is {self.vocab}")
        if not row.any():
            raise ValueError("constraint mask allows no token")
        return row

    def _install_slot_scenario(self, slot: int, sampling, mask) -> None:
        """Install the slot's sampling parameters and constraint mask row as
        data. Runs at claim time, before any prefill; a refused mask raises
        before anything is written."""
        row = None if mask is None else self._check_mask(mask)
        sp = sampling
        greedy = sp is None or sp.temperature <= 0.0
        self._temp[slot] = 0.0 if sp is None else float(sp.temperature)
        self._top_k[slot] = 0 if sp is None else int(sp.top_k)
        self._top_p[slot] = 1.0 if sp is None else float(sp.top_p)
        # an unset seed is drawn once here, as a request draws it
        self._seed[slot] = 0 if sp is None else int(sp.materialized().seed)
        if row is not None:
            self._mask.set_row(slot, row)
            self._constrained[slot] = True
            self.constrained_admits += 1
            metrics.bump("constrain.admits")
        if not greedy:
            self.sampled_admits += 1
            metrics.bump("sampling.admits")

    def _clear_slot_scenario(self, slot: int) -> None:
        """Reset the slot to greedy and unconstrained (retire and the
        admission unwind)."""
        self._temp[slot] = 0.0
        self._top_k[slot] = 0
        self._top_p[slot] = 1.0
        self._seed[slot] = 0
        if self._constrained[slot]:
            self._mask.set_row(slot, True)
            self._constrained[slot] = False

    def set_slot_mask(self, slot: int, mask) -> None:
        """A constrained slot's new allowed-vocab row (its walker advanced
        one token), copied to the device before the next step; ``None``
        lifts the constraint (all-True)."""
        if mask is None:
            if self._constrained[slot]:
                self._mask.set_row(slot, True)
                self._constrained[slot] = False
            return
        self._mask.set_row(slot, self._check_mask(mask))
        self._constrained[slot] = True
        metrics.bump("constrain.mask_updates")

    def check_invariants(self) -> None:
        """Audit the arena's refcounts against the occupied slots' tables."""
        tables = [[int(b) for b in self._bt_host[s, :int(self._slot_filled[s])]]
                  for s in np.flatnonzero(self._occupied)]
        self.arena.check_invariants(tables)

    # --------------------------------------------------------- decode step

    def _grow_slot_to(self, slot: int, pos_max: int) -> None:
        """Take blocks until the slot's table covers ``pos_max`` (the
        reservation guarantees ``take()`` cannot fail)."""
        res = self._slot_res[slot]
        need = pos_max // self.block_size + 1
        while int(self._slot_filled[slot]) < need:
            bi = int(self._slot_filled[slot])
            self._bt_host[slot, bi] = res.take()
            self._slot_filled[slot] = bi + 1

    @torch.no_grad()
    def decode_step(self) -> np.ndarray:
        """One iteration: every active slot's last token is forwarded at its
        own position, its k/v lands in its current block, and one new token
        per slot comes back (``[num_slots]`` int64; inactive lanes carry
        garbage -- callers mask by activity). The step is one run of the
        decode program; the host owns the tables and positions and refills
        its buffers."""
        act = self._active
        for slot in np.flatnonzero(act):
            self._grow_slot_to(slot, int(self._positions[slot]))
        bs = self.block_size
        pos = self._positions
        rows = np.where(act, self._bt_host[np.arange(self.num_slots),
                                           pos // bs], 0)
        S, i64 = self.num_slots, torch.int64
        prog = self._graphs.program(
            "decode", self._decode_fn, self._decode_built,
            last_tok=((S,), i64), positions=((S,), torch.int32),
            rows=((S,), i64), offs=((S,), i64),
            block_tables=((S, self.blocks_per_slot), torch.int32),
            samp=((4, S), torch.int32), resident=dict(allowed=self._mask))
        prog.run(last_tok=self._last_tok, positions=pos, rows=rows,
                 offs=pos % bs, block_tables=self._bt_host, samp=self._samp)
        out = prog.read()[0]
        self._positions[act] += 1
        self._last_tok[act] = out[act]
        self.decode_steps += 1
        n = int(act.sum())
        metrics.bump("engine.steps")
        metrics.bump("tokens.generated", n)
        self._meter.tick(n)
        metrics.set_gauge("tokens_per_sec", self._meter.rate())
        return out

    def close(self) -> None:
        """Drop the step programs (on CUDA their graphs and pool); any later
        model call raises. The arena stays until the engine is dropped."""
        self._graphs.close()

    # -------------------------------------------------------------- stats

    def kernel_route(self) -> str:
        """The attention route this engine runs: ``"kernel@single"`` on a
        CUDA device (the hand-written paged kernels), ``"plain@single"`` on
        the CPU (their plain PyTorch versions)."""
        route = "kernel" if self.device.type == "cuda" else "plain"
        return f"{route}@single"

    def _refresh_gauges(self) -> None:
        metrics.set_gauge("slots.active", self.active_slots())
        metrics.set_gauge("sampling.active_slots",
                          int(((self._temp > 0) & self._active).sum()))
        metrics.set_gauge("constrain.active_slots",
                          int((self._constrained & self._active).sum()))
        a = self.arena.stats()
        metrics.set_gauge("arena.blocks_free", a["blocks_free"])
        metrics.set_gauge("arena.blocks_total", a["blocks_total"])
        metrics.set_gauge("arena.high_water", a["high_water"])

    def stats(self) -> dict:
        layers = [m for m in self._model.modules()
                  if getattr(m, "weight_scale", None) is not None]
        out = {"slots.total": self.num_slots,
               "slots.active": self.active_slots(),
               "decode_steps": self.decode_steps,
               "prefills": self.prefills,
               "prefill_chunks": self.prefill_chunks,
               "decode_traces": self.decode_traces,
               "programs.graphs": self._graphs.graph_count(),
               "programs.pool_bytes": self._graphs.pool_bytes,
               "quant.weight_layers": len(layers),
               "sampling.admits": self.sampled_admits,
               "constrain.admits": self.constrained_admits,
               "kernel.route": self.kernel_route(),
               "device": str(self.device)}
        out.update({f"arena.{k}": v for k, v in self.arena.stats().items()})
        return out
