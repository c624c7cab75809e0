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
that is the sampling kernel, one launch per step, prefill or chunk.

With the radix prefix cache (``ServingConfig.prefix_cache`` /
``FLAGS_serving_prefix_cache``, off by default; :mod:`.prefix_cache`) an
admission walks the tree and attaches each resident full prompt block to
the slot's table by reference, then prefills only the unmatched suffix
through the suffix programs (the prefix length and the table are already
data, so a hit of any depth reuses them). A fully matched, block-aligned
context copies its last matched block into a private block (copy-on-write:
:meth:`ServingEngine._cow_copy`, one program of its own with the source and
destination blocks as data) and recomputes its last token there as a
one-token suffix at ``prefix_len = clen - 1``; shared blocks are never
written. After the prefill the prompt's full blocks are inserted into the
tree. An admission may also carry a token journal (``tokens=``): it
prefills ``prompt + journal`` and decoding resumes at the journal's next
token, which is how a preempted or replayed request re-enters.

Recovery (:meth:`ServingEngine.rebuild`, the counterpart of
``paddle_tpu/serving/engine.py:1745``) starts the engine over **in place**:
the JAX engine allocates a fresh arena because its programs depend only on
shapes, but every captured graph here holds the pool tensors' addresses,
so the pools are zeroed and kept, the host bookkeeping and every slot
start over, and no program is built again. Every step program's run goes
through one host-side helper (:meth:`ServingEngine._run`, the counterpart
of ``paddle_tpu/serving/engine.py:1188 _call``) that probes the
``serving_device`` and ``arena_corrupt`` faults before the run and times
the run and its read into ``self.hists`` (``latency.prefill``,
``latency.decode_step``), outside any captured function. The probes --
``serving_step`` beside those two -- and the run go through
``resilience.call_with_retry`` under ``ServingConfig.retry_policy`` (the
IO-class ``resilience.io_policy()`` by default), as the JAX ``_call`` does:
the port donates nothing, its runs write the pools in place, and every
probe fires on the host before the run, so a retried attempt has written
nothing. A CUDA runtime error is none of the retried classes and stays
fatal (sticky: ``supervisor.is_transient_serving_error``).

Speculative decoding (``ServingConfig.spec_k`` / ``FLAGS_serving_spec_k``,
off by default; :mod:`.spec_decode`) is the sidecar :class:`SpecDecoder`:
with a ``draft_model`` the arena gains a ``"draft"`` namespace (the default
arena doubles, and every admission reserves a second table's worst case),
each admission prefills the draft too, and :meth:`ServingEngine.
spec_decode_step` replaces the decode step: up to k tokens per slot from
one run of the captured speculative step, every one the token plain decode
would emit. Sampled and constrained slots (:meth:`ServingEngine.
spec_ineligible`, sticky per request) fall back to the decode step over
their own lanes (``decode_step(active=)``).

Multi-LoRA (``ServingConfig.lora_rank`` / ``lora_adapters``, or
``FLAGS_serving_lora_rank`` / ``FLAGS_serving_lora_adapters``; off by
default; :mod:`.adapters`): the engine owns an :class:`AdapterArena` of
stacked per-site adapter pools on its device, and each slot's adapter id is
a row of one ``[S]`` resident buffer (written when the slot is claimed and
cleared when it is freed), which the decode step binds around its model
call; a prefill binds its slot's ``[1]`` id. ``_serving_linear`` adds each
lane's low-rank update to the base output. Rank and capacity are fixed per
engine; ids, registration and unregistration are data, so adapter churn
builds nothing. An adapter lane is spec-ineligible: the speculative verify
binds no adapter.

The tiered KV cache (``ServingConfig.kv_tiering`` /
``FLAGS_serving_kv_tiering``, with the prefix cache; :mod:`.tiered`):
eviction spills a cold prefix block's rows to a host tier shared through
``ServingConfig.tier_store`` (else :func:`.tiered.get_tier_store`), which
overflows to disk, and an admission whose walk reaches spilled nodes
restores them first (:meth:`ServingEngine._restore_nodes`): only the live
blocks' host buffers are copied to the head of a device staging buffer,
then one captured program (key ``"restore"``) scatters the staging into
the destination blocks named by a ``[blocks_per_slot]`` id buffer padded
with scratch block 0. The tier view survives :meth:`ServingEngine.rebuild`,
so replays restore warm.

Tensor-parallel serving (``ServingConfig.mesh``, else the installed
``distributed.mesh.get_mesh()``; ``paddle_tpu/serving/engine.py:426-438``):
the mesh is captured at construction, before anything else. On a mesh the
model is sharded in place over its model axis (``models.gpt.shard_model``,
after any int8 quantization of the whole weights), the arena holds this
rank's heads, the paged kernels run at that head count, and
``stats()["mesh.key"]``, the arena's ``mesh`` and the tier signature's
``(model_parallel, rank)`` key the engine apart from one without a mesh.
On a mesh of ``model_parallel > 1`` the engine of rank 0 starts the other
ranks and sends them every operation (:mod:`.tp`); each follower's engine
replays it (:meth:`ServingEngine._follow_run`). A mesh whose backend cannot
be captured (gloo) runs every program uncaptured on the card, over the
same static buffers: the mesh states it (``ServingMesh.capturable``).
"""
from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import compile_cache, flags, resilience
from ..core import device as device_mod
from ..distributed import mesh as mesh_mod
from ..distributed.sharding_util import (mesh_axes_key, model_parallel,
                                         model_rank)
from ..models.gpt import (quantize_serving_weights, serving_compute_dtype,
                          shard_model, sharded_mesh)
from ..ops import paged_attention
from ..ops import sampling as sampling_ops
from ..ops.paged_attention import (check_servable, paged_decode_attention,
                                   paged_full_prefill_attention,
                                   paged_prefill_attention)
from ..quantization import quantize_kv
from . import metrics, telemetry, tp
from .adapters import AdapterArena
from .graphs import ResidentBuffer, StepGraphs
from .kv_arena import ArenaExhaustedError, KVArena, Reservation
from .prefix_cache import _ROOT_KEY, PrefixCache, adapter_root
from .sampling import sample_tokens
from .tiered import TierView, get_tier_store, state_fingerprint


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _samp_params(samp: torch.Tensor) -> tuple:
    """The rows of a ``[4, R]`` int32 sampling buffer as ``(temperature,
    top_k, top_p, seeds)``, each ``[R]``, the floats bit-cast back."""
    return (samp[0].view(torch.float32), samp[1],
            samp[2].view(torch.float32), samp[3])


def _scatter_rows(entry, row, off, kc, vc, amax_reduce=None) -> None:
    """Write one chunk's k/v rows ``[n, H, D]`` at ``(row, off)`` of a pool
    entry, in place. An int8 ``(k, v, k_scale, v_scale)`` entry quantizes
    each token row (:func:`paddle_tpu_torch.quantization.quantize_kv`) and
    writes its scale at the same ``(row, off)``; on a mesh its absmax is
    the whole row's (``amax_reduce``: ``KVArena.scale_reduce``)."""
    if len(entry) == 2:
        kp, vp = entry
        kp.index_put_((row, off), kc)
        vp.index_put_((row, off), vc)
        return
    kp, vp, ks, vs = entry
    for pool, scales, x in ((kp, ks, kc), (vp, vs, vc)):
        q, scale = quantize_kv(x, amax_reduce)
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

    def __init__(self, entry, block_tables, positions, rows, offs,
                 amax_reduce=None):
        self.entry = entry
        self.block_tables = block_tables  # [S, max_blocks] int32
        self.positions = positions        # [S] int32: write pos of new token
        self.rows = rows                  # [S] int64 physical write block
        self.offs = offs                  # [S] int64 offset in that block
        self.amax_reduce = amax_reduce    # int8 on a mesh: the whole row's

    def update_and_attend(self, q, k, v):
        _scatter_rows(self.entry, self.rows, self.offs, k[:, 0], v[:, 0],
                      self.amax_reduce)
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

    def __init__(self, entry, bt_row, prefix_len, rows, offs,
                 amax_reduce=None):
        self.entry = entry
        self.bt_row = bt_row          # [max_blocks] int32: the slot's table
        self.prefix_len = prefix_len  # int32 device scalar
        self.rows = rows              # [bucket] int64 physical write block
        self.offs = offs              # [bucket] int64 offset in that block
        self.amax_reduce = amax_reduce

    def update_and_attend(self, q, k, v):
        _scatter_rows(self.entry, self.rows, self.offs, k[0], v[0],
                      self.amax_reduce)
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
    (chunk size in tokens, 0 = off), ``prefix_cache`` ->
    ``FLAGS_serving_prefix_cache`` (the radix prefix cache), ``spec_k`` ->
    ``FLAGS_serving_spec_k`` (tokens proposed per speculative iteration, 0
    = off; ``draft_model`` a GPT of the target's vocabulary on the same
    device, else the target drafts for itself), ``quant_draft`` ->
    ``FLAGS_serving_quant_draft`` (int8 weights for the draft, quantized in
    place), ``retry_policy`` -> ``resilience.io_policy()`` (the policy a
    step program's run is retried under), ``lora_rank`` /
    ``lora_adapters`` -> ``FLAGS_serving_lora_rank`` /
    ``FLAGS_serving_lora_adapters`` (the adapter arena's rank, 0 = off,
    and capacity), ``kv_tiering`` -> ``FLAGS_serving_kv_tiering`` (spill
    evicted prefix blocks to the host and disk tiers; needs the prefix
    cache), ``tier_store`` -> :func:`.tiered.get_tier_store` (the
    :class:`.tiered.HostKVCache` to share), ``mesh`` ->
    ``distributed.mesh.get_mesh()`` (the tensor-parallel mesh this rank
    serves on; None: one card, no mesh)."""

    num_slots: int = 0
    kv_block_size: int = 0
    max_model_len: int = 0
    num_blocks: int = 0
    prefill_bucket_min: int = 0
    quant_weights: Optional[bool] = None
    quant_kv: Optional[bool] = None
    chunked_prefill: Optional[int] = None
    prefix_cache: Optional[bool] = None
    spec_k: Optional[int] = None
    draft_model: Optional[object] = None
    quant_draft: Optional[bool] = None
    retry_policy: Optional[resilience.RetryPolicy] = None
    kv_tiering: Optional[bool] = None
    tier_store: Optional[object] = None
    lora_rank: Optional[int] = None
    lora_adapters: Optional[int] = None
    mesh: Optional[object] = None


@dataclass
class _AdmitState:
    """What an admission carries from its setup (slot, blocks and shared
    references claimed) to its finish (first token emitted, slot active):
    the unit of progress of a chunked prefill. ``ctx`` is ``prompt +
    journal``; ``shared`` the blocks attached from the prefix cache (the
    first ``n_attached`` table entries); ``cow`` a fully matched
    block-aligned context whose last block was copied; ``prefix_len`` the
    context positions not prefilled."""

    slot: int
    prompt: np.ndarray
    ctx: np.ndarray
    plen: int
    clen: int
    max_new: int
    res: Reservation
    shared: List[int] = field(default_factory=list)
    n_attached: int = 0
    cow: bool = False
    prefix_len: int = 0
    done: int = 0  # context positions already scattered (chunk progress)
    skip_draft: bool = False  # spec-ineligible: no draft blocks or prefill
    root: bytes = _ROOT_KEY  # the prefix cache's chain root (the adapter's)


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
        # the mesh is captured first: quantization, sharding, the arena,
        # the adapters and the tier signature all follow it
        self.mesh = cfg.mesh if cfg.mesh is not None else mesh_mod.get_mesh()
        self.mesh_key = mesh_axes_key(self.mesh)
        if sharded_mesh(model) is not None and (
                self.mesh is None or model_parallel(self.mesh) > 1):
            raise ValueError(
                "the model is already sharded over a mesh: an engine on a "
                "mesh of more than one rank starts from the whole model "
                "(its followers load it), and one without a mesh cannot "
                "serve a shard")

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
        spec_k = int(mode(cfg.spec_k, "serving_spec_k"))
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.quant_draft = bool(mode(cfg.quant_draft, "serving_quant_draft"))
        # a draft doubles the default arena: every slot carries a second
        # (draft-namespace) table of the same worst case
        draft_on = spec_k > 0 and cfg.draft_model is not None
        num_blocks = int(cfg.num_blocks
                         or self.num_slots * self.blocks_per_slot
                         * (2 if draft_on else 1) + 1)
        self._retry = (cfg.retry_policy if cfg.retry_policy is not None
                       else resilience.io_policy())
        self.prefill_bucket_min = int(
            cfg.prefill_bucket_min or flags.flag("serving_prefill_bucket_min"))
        if self.quant_weights:
            # in place and idempotent: engines may share one model. The
            # whole weights, before any split
            n = quantize_serving_weights(model)
            if n:
                metrics.bump("quant.weight_layers", n)
        self._tp = None
        if self.mesh is not None:
            self._join_mesh(model, cfg)
        # the adapter arena: rank and capacity fixed, rows and ids data
        lora_rank = int(mode(cfg.lora_rank, "serving_lora_rank"))
        self.lora = (AdapterArena(model, lora_rank,
                                  int(mode(cfg.lora_adapters,
                                           "serving_lora_adapters")))
                     if lora_rank > 0 else None)
        if self.lora is not None:
            self.lora.bind_engine(self)
        self.arena = KVArena(mcfg.num_layers, mcfg.num_heads, head_dim,
                             num_blocks, self.block_size, dtype=dtype,
                             quantized=self.quant_kv, device=self.device,
                             mesh=self.mesh)
        self.use_prefix_cache = bool(mode(cfg.prefix_cache,
                                          "serving_prefix_cache"))
        # the tier view outlives rebuild(): its tiers are off the device.
        # Its signature keeps engines of other arena shapes, and arenas
        # filled by other weights (the served state's fingerprint, taken
        # after any in-place quantization), from ever exchanging entries
        # through a shared store
        self.kv_tiering = bool(mode(cfg.kv_tiering, "serving_kv_tiering"))
        self.tier = None
        #: seconds this engine's construction spent in state_fingerprint
        #: (a cold hash of every weight byte; memoized on the model)
        self.fingerprint_seconds = 0.0
        if self.kv_tiering and self.use_prefix_cache:
            t0 = time.perf_counter()
            fingerprint = state_fingerprint(model).hex()
            self.fingerprint_seconds = time.perf_counter() - t0
            signature = (mcfg.num_layers, mcfg.num_heads, head_dim,
                         self.block_size, str(dtype), self.quant_kv,
                         self.quant_weights, fingerprint)
            if self.mesh is not None:
                # a rank's rows are its heads only: they never restore into
                # another layout (paddle_tpu/serving/engine.py:619-622)
                signature += ((model_parallel(self.mesh),
                               model_rank(self.mesh)),)
            self.tier = TierView(
                cfg.tier_store if cfg.tier_store is not None
                else get_tier_store(), signature=signature)
            if self._tp is not None:
                self.tier.mirror = self._tp.tier_op
        self.prefix_cache = (PrefixCache(self.arena, self.block_size,
                                         tier=self.tier)
                             if self.use_prefix_cache else None)

        s = self.num_slots
        self._bt_host = np.zeros((s, self.blocks_per_slot), np.int32)
        self._positions = np.zeros(s, np.int32)
        self._last_tok = np.zeros(s, np.int64)
        self._active = np.zeros(s, np.bool_)
        self._occupied = np.zeros(s, np.bool_)
        # each slot's context cap (prompt + max_new): the bound speculation
        # depth keeps within, so that neither the reservation nor the
        # model's positions are overrun
        self._slot_limit = np.zeros(s, np.int32)
        self._slot_res: List[Optional[Reservation]] = [None] * s
        # blocks attached by reference from the prefix cache: dereferenced
        # at retire, not owned by the reservation
        self._slot_shared: List[List[int]] = [[] for _ in range(s)]
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
        # sticky speculation ineligibility: a slot that has sampled or worn
        # a constraint this request stays on the plain step, since the
        # draft cache saw none of its fallback tokens
        self._scenario_once = np.zeros(s, np.bool_)
        self._mask = ResidentBuffer(self.device, (s, self.vocab), torch.bool,
                                    True, attr="_mask")
        self._mask_host = self._mask.host
        # each slot's adapter row (0: the base model), one [S] resident
        # buffer the decode step binds; without an arena always 0
        self._adapter_ids = (ResidentBuffer(self.device, (s,), torch.int64, 0,
                                            attr="_adapter_ids")
                             if self.lora is not None else None)
        self._adapter = (self._adapter_ids.host if self.lora is not None
                         else np.zeros(s, np.int64))
        # lifetime per-engine admission counts
        self.sampled_admits = 0
        self.constrained_admits = 0
        self.adapter_admits = 0
        # lifetime counts of this engine's model calls (each runs every
        # layer's attention once): what the kernel launch counters are
        # held against -- decode steps, whole-prompt prefills, and chunks
        # of chunked prefills
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_chunks = 0
        self.suffix_prefills = 0  # cache hits' suffix-only prefills
        self.cow_copies = 0
        self.rebuilds = 0
        # this engine's latency histograms (every sample also lands in the
        # process-global set: telemetry.observe)
        self.hists = telemetry.HistogramSet()
        # builds of each program (the JAX engine's trace counters): churn
        # must never move them once a key exists
        self.decode_traces = 0
        self.prefill_traces: Dict[int, int] = {}
        self.prefix_prefill_traces: Dict[int, int] = {}
        self.cow_traces = 0
        # builds of the restore program (the JAX ``restore_traces``), and of
        # them the CUDA graph captures
        self.restore_traces = 0
        self.restore_captures = 0
        # the restore's device staging, [blocks_per_slot, block bytes], and
        # its per-layer, per-array views: made at the first restore
        self._restore_staging: Optional[torch.Tensor] = None
        self._restore_views: list = []
        self._trace_ctx = ""  # the trace of the admission in progress
        # a mesh whose collectives cannot be captured (gloo) runs every
        # program uncaptured on the card
        self._graphs = StepGraphs(self.device,
                                  counters=(paged_attention.launches,
                                            sampling_ops.launches),
                                  capture=(self.mesh is None
                                           or self.mesh.capturable))
        # spills copy blocks on the stream whose replays wrote them
        self.arena.stream = self._graphs.stream
        self._meter = metrics.Meter()
        # the speculative sidecar, made after the arena (its draft namespace
        # binds there) and the step programs (its own live beside them)
        if spec_k > 0:
            from .spec_decode import SpecDecoder

            self.spec = SpecDecoder(self, cfg.draft_model, spec_k)
        else:
            self.spec = None
        metrics.set_gauge("slots.total", s)
        metrics.set_gauge("quant.weights", int(self.quant_weights))
        metrics.set_gauge("quant.kv", int(self.quant_kv))
        metrics.set_gauge("quant.draft", int(self._draft_quantized()))
        metrics.set_gauge("tier.enabled", int(self.tier is not None))
        self._publish_arena_bytes()
        self._refresh_gauges()
        #: each follower's boot report (rank 0 of a mesh of more than one)
        self.follower_reports = []
        if self._tp is not None:
            try:
                self.follower_reports = self._tp.wait_ready()
            except BaseException:
                self._tp.close()  # reaps the others, removes the file
                raise

    def _join_mesh(self, model, cfg) -> None:
        """Take this rank's place on the mesh: rank 0 of more than one
        starts the followers over the whole (quantized) model first
        (:class:`.tp.Leader`); every rank forms the model group, warms it
        (NCCL's communicator is made before any capture) and shards the
        model in place (``paddle_tpu/models/gpt.py`` TP path), the draft
        model too."""
        mesh = self.mesh
        if mesh.rank == 0:
            if model_parallel(mesh) > 1:
                self._tp = tp.Leader(model, cfg, mesh, self.device,
                                     draft=cfg.draft_model)
            elif not mesh.connected:
                mesh.open()
        try:
            mesh.connect()
            tp.warm(mesh, self.device)
        except BaseException:
            if self._tp is not None:
                self._tp.close()
            raise
        shard_model(model, mesh)
        if cfg.draft_model is not None and cfg.draft_model is not model:
            # quantized first by the speculative decoder when quant_draft
            if not self.quant_draft:
                shard_model(cfg.draft_model, mesh)

    # ----------------------------------------------------------- capacity

    def free_slots(self) -> int:
        return int((~self._occupied).sum())

    def active_slots(self) -> int:
        return int(self._active.sum())

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """The worst-case blocks of an admission: the slot's table, plus the
        draft table's with a draft model."""
        need = self._target_blocks_needed(prompt_len, max_new_tokens)
        if self.spec is not None:
            need += self.spec.blocks_needed(prompt_len, max_new_tokens)
        return need

    def _target_blocks_needed(self, prompt_len: int,
                              max_new_tokens: int) -> int:
        """The slot's own table's worst case alone: what matched prefix
        blocks subtract from."""
        return _ceil_div(prompt_len + max_new_tokens, self.block_size)

    def validate(self, prompt_len: int, max_new_tokens: int,
                 adapter: int = 0) -> None:
        """Refuse at submit what could never be served: an empty or too long
        request, or one naming an adapter this engine does not hold."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if int(adapter) != 0:
            if self.lora is None:
                raise ValueError(
                    f"request names adapter {adapter} but the engine has "
                    "no adapter arena (FLAGS_serving_lora_rank is 0)")
            self.lora.check_live(adapter)
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

    def reserved_blocks(self, slot: int) -> int:
        """The block budget ``slot`` holds (0 if empty): what retiring it
        returns to the arena's grantable pool, the quantity preemption's
        feasibility sums. The draft reservation is included."""
        res = self._slot_res[slot]
        n = res.total if res is not None else 0
        if self.spec is not None:
            n += self.spec.reserved_blocks(slot)
        return n

    def prefix_root(self, adapter: int = 0) -> bytes:
        """The prefix cache's chain root for lanes of ``adapter``: the base
        model's ``_ROOT_KEY`` for 0, else the root derived from the live
        row's weights fingerprint (``AdapterArena.fingerprint``)."""
        if int(adapter) == 0:
            return _ROOT_KEY
        return adapter_root(self.lora.fingerprint(adapter))

    def admit_sizing(self, prompt_len: int, max_new_tokens: int,
                     prompt=None, keys=None, journal_len: int = 0):
        """Both admission-feasibility numbers from one radix walk: (blocks
        this admission would reserve, matched blocks at refcount zero that
        ``grantable()`` counts evictable but the admission will pin).
        Device-resident matched prompt blocks attach by reference and leave
        the budget; a tier-restorable (spilled) one skips its prefill but
        takes a fresh block, its restore target, so it stays in the budget
        (restore cost, not prefill cost). A match covering the whole
        prefilled context (``prompt_len + journal_len``) reserves one block
        back, the copy-on-write target. ``keys``
        (``PrefixCache.chunk_keys`` under the request's adapter root, as
        the scheduler passes them) makes the walk hash-free; ``prompt`` is
        hashed under the base model's root; without ``prompt`` or ``keys``,
        or with the cache off, the plain worst case."""
        need = self.blocks_needed(prompt_len, max_new_tokens)
        if self.prefix_cache is None or (prompt is None and keys is None):
            return need, 0
        resident, spilled, unpinned = self.prefix_cache.match_stats(
            prompt, keys=keys)
        matched = resident + spilled
        if matched:
            need -= resident
            if matched * self.block_size >= prompt_len + int(journal_len):
                need += 1  # COW copy of the last fully matched block
        return need, unpinned

    def admit_blocks_needed(self, prompt_len: int, max_new_tokens: int,
                            prompt=None, journal_len: int = 0) -> int:
        """Blocks an admission would reserve (:meth:`admit_sizing`)."""
        return self.admit_sizing(prompt_len, max_new_tokens, prompt,
                                 journal_len=journal_len)[0]

    def can_admit(self, prompt_len: int, max_new_tokens: int, prompt=None,
                  keys=None, journal_len: int = 0) -> bool:
        if self.free_slots() <= 0:
            return False
        need, pinned = self.admit_sizing(prompt_len, max_new_tokens, prompt,
                                         keys=keys, journal_len=journal_len)
        return self.arena.grantable() - pinned >= need

    def prefetch(self, prompt, trace_id: str = "", adapter: int = 0) -> int:
        """Restore-ahead (``paddle_tpu/serving/engine.py:854``): restore the
        spilled or published tail of ``prompt``'s chain under ``adapter``'s
        root into fresh arena blocks now, through admission's
        :meth:`_restore_nodes` (no slot claimed, no reference taken), so a
        queued request's admission later finds the chain resident. Bounded
        by the free headroom above what eviction could reclaim
        (``grantable() - evictable_blocks()``): the restored blocks are
        cached at refcount zero, so ``grantable()`` is unchanged and
        admission is never starved, and no warmer prefix is evicted for a
        colder one. Returns the blocks restored (``disagg.prefetched_blocks``,
        a ``PREFETCHED`` span on ``trace_id``)."""
        if self.prefix_cache is None or self.tier is None:
            return 0
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        walked = self.prefix_cache.match(prompt, self.prefix_root(adapter))
        split = next((i for i, n in enumerate(walked) if n.spilled),
                     len(walked))
        tail = walked[split:]
        if not tail:
            return 0
        headroom = (self.arena.grantable()
                    - self.prefix_cache.evictable_blocks())
        if headroom <= 0:
            return 0
        self._trace_ctx = trace_id
        restored = self._restore_nodes(tail[:headroom])
        if restored:
            metrics.bump("disagg.prefetched_blocks", restored)
            telemetry.span(trace_id, telemetry.PREFETCHED, blocks=restored)
        return restored

    # ----------------------------------------------------- slot lifecycle

    def admit(self, prompt, max_new_tokens: int, sampling=None,
              mask=None, tokens=None, spec_exclude: bool = False,
              adapter: int = 0, trace_id: str = "") -> Tuple[int, int]:
        """Prefill ``prompt`` into a free slot. Returns ``(slot,
        next_token)``: the first token comes out of the prefill itself,
        sampled under ``sampling`` (a ``SamplingParams`` with a seed; None is
        greedy) and the constraint ``mask`` (``[vocab]`` bool; None is
        unconstrained).

        ``tokens`` is the request's journal when this admission resumes it
        (re-admission after preemption): the prefill runs over ``prompt +
        tokens`` and emits the journal's next token, leaving the slot as an
        uninterrupted decode would have (position ``len(prompt + tokens)``).
        ``max_new_tokens`` stays the request's original budget; the journal
        counts toward it. ``spec_exclude`` marks a request that must never
        take the speculative path (it carries a constraint, even one whose
        current mask is None): the slot skips the draft blocks and prefill.
        With a draft model the admission prefills the draft's cache over
        the same context too. ``adapter`` is the adapter row the slot
        decodes with (0: the base model); ``trace_id`` the request's trace,
        where a tier restore's RESTORED span lands. Raises if there is no
        capacity; callers gate on :meth:`can_admit`."""
        st = self._admit_setup(prompt, max_new_tokens, sampling, mask, tokens,
                               spec_exclude, adapter, trace_id)
        return st.slot, self._admit_prefill_all(st)

    def admit_begin(self, prompt, max_new_tokens: int, sampling=None,
                    mask=None, tokens=None, spec_exclude: bool = False,
                    adapter: int = 0, trace_id: str = ""
                    ) -> Tuple[int, Optional[int]]:
        """Chunked admission: claim a slot and its blocks now, prefill
        incrementally. Returns ``(slot, first_token)`` when the context left
        to prefill fits one chunk (as :meth:`admit`), else ``(slot, None)``
        with the prefill in progress: the scheduler then calls
        :meth:`admit_chunk` once per step until the first token appears. A
        cache hit's chunks start at its prefix length. Until then the slot
        is occupied (its blocks are held) but not active (the decode step
        masks it). The draft prefill runs when the last chunk lands."""
        st = self._admit_setup(prompt, max_new_tokens, sampling, mask, tokens,
                               spec_exclude, adapter, trace_id)
        if self.chunk_size <= 0 or st.clen - st.prefix_len <= self.chunk_size:
            return st.slot, self._admit_prefill_all(st)
        st.done = st.prefix_len
        self._chunk[st.slot] = st
        metrics.bump("chunk.admits")
        self._refresh_gauges()
        return st.slot, None

    def admit_chunk(self, slot: int) -> Optional[int]:
        """Prefill the next chunk (at most ``chunk_size`` tokens) of the
        slot's chunked admission. Returns the first generated token once the
        whole context is scattered (the last chunk's last-position logits),
        else None. Under ``FLAGS_serving_publish_chunks`` every prompt block
        a chunk finishes enters the prefix cache at once. A failed chunk
        unwinds the admission and raises."""
        st = self._chunk.get(slot)
        if st is None:
            raise RuntimeError(f"slot {slot} has no chunked prefill in "
                               "progress")
        take = min(self.chunk_size, st.clen - st.done)
        try:
            # every chunk samples its token, as the JAX engine does; only
            # the last chunk's is the request's first
            nxt = self._suffix_prefill_call(st.ctx, st.done + take,
                                            st.done, slot, chunked=True)
            st.done += take
            metrics.bump("chunk.chunks")
            metrics.bump("chunk.tokens", take)
            if (self.prefix_cache is not None
                    and flags.flag("serving_publish_chunks")):
                # insert() skips the blocks already resident; the new ones
                # are cached, so they outlive an abort of later chunks
                full = min(st.done, st.plen) // self.block_size
                if full > 0:
                    self.prefix_cache.insert(st.prompt, self._bt_host[slot],
                                             full, st.root)
            if (st.done >= st.clen and self.spec is not None
                    and not st.skip_draft):
                self.spec.prefill(slot, st.ctx)
        except BaseException:
            self._chunk.pop(slot, None)
            self._admit_abort(st)
            raise
        if st.done < st.clen:
            return None
        self._chunk.pop(slot, None)
        return self._admit_finish(st, nxt)

    def _admit_prefill_all(self, st: _AdmitState) -> int:
        """The one-call prefill of a whole context, or of a cache hit's
        suffix only, then the draft's prefill of the whole context; unwinds
        the admission on failure."""
        try:
            if st.n_attached or st.cow:
                first = self._suffix_prefill_call(st.ctx, st.clen,
                                                  st.prefix_len, st.slot)
            else:
                first = self._full_prefill_call(st.ctx, st.clen, st.res,
                                                st.slot)
            if self.spec is not None and not st.skip_draft:
                self.spec.prefill(st.slot, st.ctx)
        except BaseException:
            self._admit_abort(st)
            raise
        return self._admit_finish(st, first)

    def _admit_setup(self, prompt, max_new_tokens: int, sampling=None,
                     mask=None, tokens=None, spec_exclude: bool = False,
                     adapter: int = 0, trace_id: str = "") -> _AdmitState:
        """Claim everything an admission needs before any prefill: the slot,
        the references to the matched prefix blocks (a spilled tail
        restored first), the block reservations (the draft table's too,
        unless the slot is spec-ineligible), the filled block table, the
        copy-on-write copy, and the slot's sampling, constraint and adapter
        state (the prefill programs sample the first token under it).
        Unwinds completely on any failure, a refused mask included."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        self.validate(plen, max_new_tokens, adapter)
        self._trace_ctx = trace_id
        journal = np.asarray([] if tokens is None else tokens,
                             np.int64).reshape(-1)
        ctx = np.concatenate([prompt, journal]) if journal.size else prompt
        clen = int(ctx.shape[0])
        if clen >= plen + max_new_tokens:
            raise ValueError(
                f"journal of {journal.size} tokens already exhausts the "
                f"max_new_tokens={max_new_tokens} budget; nothing to resume")
        slot = int(np.argmin(self._occupied))
        if self._occupied[slot]:
            raise RuntimeError("no free slot")
        bs = self.block_size
        # the radix walk: every matched block is referenced BEFORE
        # reserve(), so that its eviction pass can never reclaim a block
        # this admission is about to share (or copy). With a tier the walk
        # is a resident prefix, each node pinned as it is reached (so a
        # restore's evictions cannot take it), then a spilled tail, first
        # restored into fresh blocks and then pinned. A restore that stops
        # short (an entry lost, no free block) truncates the match: the
        # rest prefills. The walk is under the adapter's root: a lane never
        # attaches blocks filled under other weights
        root = self.prefix_root(adapter)
        walked = (self.prefix_cache.match(prompt, root)
                  if self.prefix_cache is not None else [])
        chain = []
        try:
            split = next((i for i, n in enumerate(walked) if n.spilled),
                         len(walked))
            for node in walked[:split]:
                self.arena.ref(node.block)
                chain.append(node)
            if split < len(walked):
                restored = self._restore_nodes(walked[split:])
                for node in walked[split:split + restored]:
                    self.arena.ref(node.block)
                    chain.append(node)
        except BaseException:
            for node in chain:
                self.arena.deref(node.block)
            raise
        # a fully matched block-aligned context has no suffix, but its last
        # token must be recomputed for its logits: the last matched block
        # is copied into a private block and the token re-scattered there
        cow = bool(chain) and len(chain) * bs == clen
        attached = chain[:-1] if cow else chain
        shared = [node.block for node in attached]
        # the COW source is read, not attached: its reference is the pin
        # that keeps it across reserve(), dropped right after the copy
        cow_src: Optional[int] = chain[-1].block if cow else None
        try:
            res = self.arena.reserve(
                self._target_blocks_needed(plen, max_new_tokens)
                - len(attached))
        except BaseException:
            for node in chain:
                self.arena.deref(node.block)
            raise
        # a spec-ineligible lane never reads a draft cache: no draft blocks
        # and no draft prefill (feasibility stays the conservative worst
        # case, so this only under-consumes)
        skip_draft = self.spec is not None and (
            bool(spec_exclude) or mask is not None or int(adapter) != 0
            or (sampling is not None and sampling.temperature > 0))
        if self.spec is not None and not skip_draft:
            try:
                self.spec.alloc_slot(slot, plen, max_new_tokens)
            except BaseException:
                res.release()
                for node in chain:
                    self.arena.deref(node.block)
                raise
        n_attached = len(attached)
        st = _AdmitState(slot=slot, prompt=prompt, ctx=ctx, plen=plen,
                         clen=clen, max_new=int(max_new_tokens), res=res,
                         shared=shared, n_attached=n_attached, cow=cow,
                         prefix_len=clen - 1 if cow else n_attached * bs,
                         skip_draft=skip_draft, root=root)
        self._occupied[slot] = True
        self._slot_res[slot] = res
        self._slot_shared[slot] = shared
        try:
            self._install_slot_scenario(slot, sampling, mask, spec_exclude,
                                        int(adapter))
            self._bt_host[slot, :n_attached] = shared
            n = _ceil_div(clen, bs)
            for bi in range(n_attached, n):
                self._bt_host[slot, bi] = res.take()
            self._slot_filled[slot] = n
            if cow:
                self._cow_copy(cow_src, res.taken[0])
                self.arena.deref(cow_src)
                cow_src = None  # the copy is private now
        except BaseException:
            if cow_src is not None:
                self.arena.deref(cow_src)
            self._admit_abort(st)
            raise
        return st

    def _admit_abort(self, st: _AdmitState) -> None:
        """Unwind a claimed admission: drop the shared references, release
        both reservations, clear the slot."""
        for blk in st.shared:
            self.arena.deref(blk)
        st.shared = []
        st.res.release()
        if self.spec is not None:
            self.spec.release_slot(st.slot)
        self._slot_res[st.slot] = None
        self._slot_shared[st.slot] = []
        self._slot_filled[st.slot] = 0
        self._bt_host[st.slot, :] = 0
        self._occupied[st.slot] = False
        self._clear_slot_scenario(st.slot)
        if flags.flag("serving_arena_invariants"):
            self.check_invariants()
        self._refresh_gauges()

    def _admit_finish(self, st: _AdmitState, first: int) -> int:
        """Activate the slot: its context is scattered and its next token
        exists. With the prefix cache, count the hit or miss and make the
        prompt's freshly scattered full blocks shareable (the trailing
        partial block and the journal stay private to the slot)."""
        slot = st.slot
        cache = self.prefix_cache
        if cache is not None:
            hit = bool(st.n_attached or st.cow)
            cache.note_hit(st.prefix_len if hit else 0)
            cache.insert(st.prompt, self._bt_host[slot],
                         st.plen // self.block_size, st.root)
            if hit:
                metrics.bump("tokens.prefill_avoided", st.prefix_len)
        self._positions[slot] = st.clen  # next write position
        self._last_tok[slot] = first
        self._slot_limit[slot] = st.plen + st.max_new
        self._active[slot] = True
        metrics.bump("engine.admits")
        metrics.bump("tokens.prefill", st.clen - st.prefix_len)
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

    def _cow_built(self) -> None:
        """Count one build of the copy-on-write program."""
        self.cow_traces += 1
        compile_cache.bump("serving.cow_compiles")

    def _lora_bound(self, ids):
        """The adapter binding of a step's model call over one id per lane
        (a no-op without an arena)."""
        if self.lora is None:
            return contextlib.nullcontext()
        return self.lora.bind(ids)

    def _lora_spec(self) -> dict:
        """A prefill program's adapter buffer: the slot's ``[1]`` id."""
        return {} if self.lora is None else {"adapter": ((1,), torch.int64)}

    def _decode_fn(self, last_tok, positions, rows, offs, block_tables,
                   samp, allowed, adapter_ids=None):
        """The decode step over its static buffers: every lane's last token
        at its position, its k/v written at ``(rows, offs)`` (scratch block
        0 for inactive lanes), one token per lane sampled under the lane's
        parameters and mask row, keyed at ``positions + 1``: the context
        index where the new token will sit. With an adapter arena each
        lane's linears add the update of its row of ``adapter_ids``."""
        red = self.arena.scale_reduce()
        views = [_PagedCacheView(entry, block_tables, positions, rows, offs,
                                 red) for entry in self.arena.pools]
        model = self._model
        with self._lora_bound(adapter_ids):
            h, _ = model.gpt(last_tok[:, None], caches=views,
                             start_pos=positions)
        return (sample_tokens(model._head_logits(h[:, 0]),
                              *_samp_params(samp), positions + 1, allowed),)

    def _full_prefill_fn(self, ids, rows, offs, true_len, samp, spos,
                         allowed, adapter=None):
        """The whole-prompt prefill of one bucket: the model over the padded
        prompt, the token after position ``true_len - 1`` (runtime data, as
        the JAX program's ``dynamic_index_in_dim``), and every position's
        k/v scattered at ``(rows, offs)`` (padded ones to scratch block
        0). The token is sampled under the slot's ``[1]`` parameters and
        mask row, keyed at ``spos``, the context index it will sit at; the
        model runs under the slot's ``adapter`` row when there is an
        arena."""
        model = self._model
        views = [_CapturePrefillView(self.block_size)
                 for _ in range(model.cfg.num_layers)]
        with self._lora_bound(adapter):
            h, chunks = model.gpt(ids, caches=views, start_pos=0)
        last = h.index_select(1, true_len.reshape(1) - 1)[:, 0]
        red = self.arena.scale_reduce()
        for (kc, vc), entry in zip(chunks, self.arena.pools):
            _scatter_rows(entry, rows, offs, kc[0], vc[0], red)
        return (sample_tokens(model._head_logits(last), *_samp_params(samp),
                              spos, allowed),)

    def _suffix_prefill_fn(self, ids, rows, offs, bt_row, prefix_len,
                           true_len, samp, spos, allowed, adapter=None):
        """The suffix/chunk prefill of one bucket through the slot's table
        row: positions ``prefix_len + i``, the chunk's k/v scattered before
        it is attended, the token after position ``true_len - 1`` of the
        chunk, sampled as in :meth:`_full_prefill_fn`."""
        red = self.arena.scale_reduce()
        views = [_PrefixPrefillView(entry, bt_row, prefix_len, rows, offs,
                                    red) for entry in self.arena.pools]
        model = self._model
        with self._lora_bound(adapter):
            h, _ = model.gpt(ids, caches=views, start_pos=prefix_len)
        last = h.index_select(1, true_len.reshape(1) - 1)[:, 0]
        return (sample_tokens(model._head_logits(last), *_samp_params(samp),
                              spos, allowed),)

    def _cow_fn(self, src, dst):
        """Copy block ``src`` into block ``dst`` in every array of every
        layer's pool entry: with the int8 arena that includes the
        ``[num_blocks, block_size]`` scale pools, without which the copy
        would be dequantized with another block's scales. Returns no
        output."""
        for entry in self.arena.pools:
            for pool in entry:
                pool.index_copy_(0, dst, pool.index_select(0, src))
        return ()

    def _restore_fn(self, dsts):
        """Scatter the restore staging's rows into blocks ``dsts``
        (``[blocks_per_slot]``; padded entries name scratch block 0, where
        duplicates are harmless) in every array of every layer's entry, an
        int8 arena's scale pools included. Returns no output."""
        for entry, views in zip(self.arena.pools, self._restore_views):
            for pool, src in zip(entry, views):
                pool.index_copy_(0, dsts, src)
        return ()

    def _run(self, prog, hist: Optional[str], name: str, mirror: bool = True,
             **values) -> tuple:
        """Run one step program and read its outputs: the one host-side
        path of every run (decode, whole-prompt prefill, suffix or chunk
        prefill, COW, the speculative step, a draft prefill). The
        ``serving_step``, ``serving_device`` and ``arena_corrupt`` fault
        probes fire here, before the run: never inside a step function,
        which runs once, at capture, so a probe there would never fire on a
        replay. The probes and the run are retried under the engine's
        policy (``paddle_tpu/serving/engine.py:1188 _call``; ``name``
        keys its ``retry.<name>`` counters): an IO-class failure, such as
        an injected ``serving_step`` fault, is retried; the supervisor's
        classes and every CUDA runtime error are not retried. Nothing is
        donated and every probe fires before the run, so a retried attempt
        has written nothing. ``hist`` names the latency histogram of the
        run and its read (which blocks, so the host clock covers the device
        work).

        On rank 0 of a mesh the run is sent to the followers after the
        probes, just before it runs here (``mirror``; an operation that
        sends its own message, the tier restore, passes False). A failure
        while a follower is dead or has failed becomes
        :class:`.tp.FollowerDiedError`."""
        if self.mesh is not None and self.mesh.rank != 0:
            # a follower: rank 0 probed, retried and decided; this rank
            # only runs (its failure is reported to rank 0)
            prog.run(**values)
            return prog.read()

        def attempt():
            resilience.maybe_fault("serving_step")
            resilience.maybe_fault("serving_device")
            resilience.maybe_fault("arena_corrupt")
            t0 = time.perf_counter()
            if self._tp is None:
                prog.run(**values)
                out = prog.read()
            else:
                try:
                    if mirror:
                        self._tp.run(prog, values)
                    prog.run(**values)
                    out = prog.read()
                except tp.FollowerDiedError:
                    raise
                except Exception:
                    self._tp.check()  # a dead follower is the cause
                    raise
            if hist is not None:
                telemetry.observe(hist, time.perf_counter() - t0, self.hists)
            return out

        return resilience.call_with_retry(attempt, name=name,
                                          policy=self._retry)

    def _samp_row(self, slot: int, pos: int) -> dict:
        """One slot's scenario values for a prefill program: its ``[1]``
        sampling parameters, the positional key ``pos`` (the context index
        where the emitted token will sit), its mask row and, with an
        adapter arena, its adapter id."""
        one = slice(slot, slot + 1)
        out = dict(samp=self._samp[:, one], spos=np.int32(pos),
                   allowed=self._mask_host[one])
        if self.lora is not None:
            out["adapter"] = self._adapter[one]
        return out

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
            allowed=((1, self.vocab), torch.bool, 1), **self._lora_spec())
        nxt = int(self._run(prog, "latency.prefill", "serving.prefill",
                            ids=ids, rows=row, offs=p_idx % bs, true_len=clen,
                            **self._samp_row(slot, clen))[0][0])
        self.prefills += 1
        # one count per call and bucket: the padding waste of the ladder
        compile_cache.bump(f"serving.prefill_bucket.{p_bucket}")
        metrics.bump("tokens.prefill_padding", p_bucket - clen)
        return nxt

    @torch.no_grad()
    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy-on-write: copy one physical block's K/V (every layer, every
        array of the entry) into a privately taken block, so that a slot
        that must write inside its matched prefix never writes a shared
        block. One program for the engine, keyed by nothing but the arena's
        block shape: ``src`` and ``dst`` are data, so a COW never builds it
        again. On the card it is a captured graph replayed on the stream
        the prefill replays run on, ahead of the suffix program."""
        prog = self._graphs.program(
            "cow", self._cow_fn, self._cow_built,
            src=((1,), torch.int64), dst=((1,), torch.int64))
        self._run(prog, None, "serving.cow_copy", src=src, dst=dst)
        self.cow_copies += 1
        metrics.bump("prefix.cow_copies")

    def _restore_built(self) -> None:
        """Count one build of the restore program."""
        self.restore_traces += 1
        if self.device.type == "cuda":
            self.restore_captures += 1
        compile_cache.bump("serving.restore_compiles")

    def _restore_buffers(self) -> torch.Tensor:
        """The restore's device staging, made once: ``[blocks_per_slot,
        block bytes]`` uint8 rows laid out as a payload's buffer
        (``KVArena.block_layout``), with a view per layer and array in the
        pool's dtype and block shape for :meth:`_restore_fn`."""
        if self._restore_staging is None:
            pieces, total = self.arena.block_layout()
            staging = torch.zeros((self.blocks_per_slot, total),
                                  dtype=torch.uint8, device=self.device)
            self._restore_views = [
                tuple(staging[:, off:off + n].view(t.dtype).unflatten(1, shape)
                      for t, (off, n, shape, _) in zip(entry, row))
                for entry, row in zip(self.arena.pools, pieces)]
            self._restore_staging = staging
        return self._restore_staging

    @torch.no_grad()
    def _restore_call(self, payloads, blocks: List[int]) -> None:
        """Write ``payloads`` into ``blocks``: each live block's host buffer
        is copied to the head of the staging (asynchronously from pinned
        memory on the card, on the engine's stream), never the padded
        batch, then one run of the restore program scatters the staging
        into the destinations. One program for the engine: the destinations
        are data, padded with scratch block 0."""
        staging = self._restore_buffers()
        cuda = self.device.type == "cuda"
        with self._graphs.on_stream():
            for i, payload in enumerate(payloads):
                staging[i].copy_(payload.buffer, non_blocking=cuda)
        dsts = np.zeros(self.blocks_per_slot, np.int64)
        dsts[:len(blocks)] = blocks
        prog = self._graphs.program(
            "restore", self._restore_fn, self._restore_built,
            dsts=((self.blocks_per_slot,), torch.int64))
        self._run(prog, None, "serving.tier_restore", mirror=False,
                  dsts=dsts)

    def _restore_nodes(self, nodes) -> int:
        """Restore a spilled radix chain into fresh arena blocks
        (``paddle_tpu/serving/engine.py:1065``): load each node's payload
        from the tier, take cached refcount-zero blocks (evicting colder
        prefixes under pressure), write them all through one run of the
        restore program, and re-point each node at its block. Stops at the
        first node whose entry was lost (pruned: the match truncates there
        and the rest prefills) or when no block is left to take (what fits
        is restored, the tail prefills). A failed restore returns the
        blocks it took and raises. Returns how many leading nodes of
        ``nodes`` were restored."""
        t0 = time.perf_counter()
        cache = self.prefix_cache
        payloads, live = [], []
        for node in nodes:
            if len(live) >= self.blocks_per_slot:
                break  # a chain never exceeds one slot's table
            payload = self.tier.lookup(node.key)
            if payload is None:
                cache.prune_lost(node)
                break
            payloads.append(payload)
            live.append(node)
        blocks: List[int] = []
        for _ in live:
            try:
                blocks.append(self.arena.take_cached_block())
            except ArenaExhaustedError:
                break
        if not blocks:
            return 0
        live, payloads = live[:len(blocks)], payloads[:len(blocks)]
        try:
            if self._tp is not None:
                # every rank restores its own rows: as far as all hold them
                held = self._tp.probe([node.key for node in live])
                if held < len(live):
                    cache.prune_lost(live[held])
                    for blk in blocks[held:]:
                        self.arena.uncache(blk)
                    live, payloads = live[:held], payloads[:held]
                    blocks = blocks[:held]
                if not live:
                    return 0
                self._tp.send("restore", [node.key for node in live],
                              blocks)
            self._restore_call(payloads, blocks)
        except BaseException:
            for blk in blocks:
                self.arena.uncache(blk)
            raise
        for node, blk in zip(live, blocks):
            cache.mark_restored(node, blk)
        self.tier.note_restored(payloads)
        telemetry.observe("latency.restore", time.perf_counter() - t0,
                          self.hists)
        # the admission's own timeline (the API lock serialises them)
        telemetry.span(self._trace_ctx, telemetry.RESTORED,
                       blocks=len(live))
        return len(live)

    # ------------------------------------------------- a follower's side

    @torch.no_grad()
    def _follow_run(self, key, defn, values: dict, rows: dict) -> None:
        """A follower's replay of rank 0's run of program ``key``: made at
        its first run from ``defn`` (rank 0's ``StepProgram.definition``:
        the step function's site -- this engine or its speculative decoder
        -- and name, the buffer specs and the resident buffers' attribute
        names), its resident buffers' changed ``rows`` applied, then run
        over ``values`` through :meth:`_run`; the outputs are read (rank 0
        reports the tokens)."""
        if defn is not None:
            site, fn_name, specs, resident = defn
            owner = self.spec if site == "spec" else self
            self._graphs.program(
                key, getattr(owner, fn_name), lambda: None,
                resident={name: getattr(owner, attr)
                          for name, attr in resident.items()}, site=site,
                **specs)
        prog = self._graphs.programs[key]
        for name, (idx, vals) in rows.items():
            buf = prog.resident[name]
            for row, value in zip(idx, vals):
                buf.set_row(row, value)
        self._run(prog, None, "serving.follow", **values)

    def _tier_held(self, keys) -> int:
        """How many leading ``keys`` this rank's tier holds."""
        n = 0
        for key in keys:
            if self.tier is None or not self.tier.has(key):
                break
            n += 1
        return n

    @torch.no_grad()
    def _follow_restore(self, keys, blocks) -> None:
        """A follower's side of rank 0's tier restore: this rank's rows of
        ``keys`` from its own tier into ``blocks``."""
        payloads = [self.tier.lookup(key) for key in keys]
        if any(p is None for p in payloads):
            raise RuntimeError("a tier entry rank 0 restores is gone from "
                               "this rank's tier")
        self._restore_call(payloads, list(blocks))
        self.tier.note_restored(payloads)

    @torch.no_grad()
    def _suffix_prefill_call(self, ctx: np.ndarray, clen: int,
                             prefix_len: int, slot: int,
                             chunked: bool = False) -> int:
        """Prefill ``ctx[prefix_len:clen]``, padded to its bucket, attending
        the first ``prefix_len`` positions through the slot's (already
        filled) table instead of recomputing them: one chunk of a chunked
        admission, or a cache hit's suffix. Returns the token after
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
            allowed=((1, self.vocab), torch.bool, 1), **self._lora_spec())
        nxt = int(self._run(prog, "latency.prefill", "serving.prefix_prefill",
                            ids=ids, rows=row, offs=gpos % bs, bt_row=table,
                            prefix_len=prefix_len, true_len=slen,
                            **self._samp_row(slot, clen))[0][0])
        if chunked:
            self.prefill_chunks += 1
        else:
            self.suffix_prefills += 1
            metrics.bump("prefix.suffix_prefills")
        compile_cache.bump(f"serving.suffix_prefill_bucket.{s_bucket}")
        return nxt

    def retire(self, slot: int) -> None:
        """Free a slot: deactivate its lane, return its private blocks and
        drop its references to shared prefix blocks (a shared block stays
        resident while the prefix cache holds it). Also frees a slot in the
        middle of a chunked prefill."""
        if not self._occupied[slot]:
            return
        self._occupied[slot] = False
        self._active[slot] = False
        self._chunk.pop(slot, None)  # a chunked prefill still in progress
        res = self._slot_res[slot]
        self._slot_res[slot] = None
        if res is not None:
            res.release()
        for blk in self._slot_shared[slot]:
            self.arena.deref(blk)
        if self.spec is not None:
            self.spec.release_slot(slot)
        self._slot_shared[slot] = []
        self._slot_filled[slot] = 0
        self._bt_host[slot, :] = 0
        self._positions[slot] = 0
        self._last_tok[slot] = 0
        self._slot_limit[slot] = 0
        self._clear_slot_scenario(slot)
        metrics.bump("engine.retires")
        if flags.flag("serving_arena_invariants"):
            self.check_invariants()
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

    def _install_slot_scenario(self, slot: int, sampling, mask,
                               spec_exclude: bool = False,
                               adapter: int = 0) -> None:
        """Install the slot's sampling parameters, constraint mask row and
        adapter id as data. Runs at claim time, before any prefill; a
        refused mask raises before anything is written. A sampled, masked,
        adapter-wearing or ``spec_exclude`` slot is spec-ineligible for the
        request's life."""
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
        if adapter:
            self._adapter_ids.set_row(slot, adapter)
            self.adapter_admits += 1
            metrics.bump("lora.admits")
        self._scenario_once[slot] = (not greedy or row is not None
                                     or bool(adapter) or bool(spec_exclude))

    def _clear_slot_scenario(self, slot: int) -> None:
        """Reset the slot to greedy and unconstrained (retire and the
        admission unwind)."""
        self._temp[slot] = 0.0
        self._top_k[slot] = 0
        self._top_p[slot] = 1.0
        self._seed[slot] = 0
        self._scenario_once[slot] = False
        if self._constrained[slot]:
            self._mask.set_row(slot, True)
            self._constrained[slot] = False
        if self._adapter[slot]:
            self._adapter_ids.set_row(slot, 0)

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
        self._scenario_once[slot] = True  # sticky: see spec_ineligible
        metrics.bump("constrain.mask_updates")

    def spec_ineligible(self) -> np.ndarray:
        """Per-slot mask of the lanes speculation must not cover
        (``paddle_tpu/serving/engine.py:1562``): sampled slots (the verify
        step is greedy), constrained slots (it applies no mask),
        adapter-wearing slots (it binds no adapter) and, sticky per
        request, any slot that was one of these (a constraint that lifts
        mid-stream does not hand the lane back: its draft cache missed
        every token of the fallback). They take the plain decode step over
        their own lanes instead."""
        return ((self._temp > 0) | self._constrained | (self._adapter != 0)
                | self._scenario_once)

    def check_invariants(self) -> None:
        """Audit the arena's refcounts against the tables of the occupied
        slots (a slot in the middle of a chunked prefill holds blocks too),
        shared blocks included: a shared block appears in as many tables
        as its refcount says. Runs on every release path under
        ``FLAGS_serving_arena_invariants``."""
        tables = [[int(b) for b in self._bt_host[s, :int(self._slot_filled[s])]]
                  for s in np.flatnonzero(self._occupied)]
        if self.spec is not None:
            # the draft tables: private blocks, one reference per entry
            tables.extend(self.spec.slot_tables())
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

    def _decode_resident(self) -> dict:
        """The decode step's resident buffers: the constraint mask and, with
        an adapter arena, the lanes' adapter ids."""
        out = dict(allowed=self._mask)
        if self.lora is not None:
            out["adapter_ids"] = self._adapter_ids
        return out

    @torch.no_grad()
    def decode_step(self, active=None) -> np.ndarray:
        """One iteration: every active slot's last token is forwarded at its
        own position, its k/v lands in its current block, and one new token
        per slot comes back (``[num_slots]`` int64; inactive lanes carry
        garbage -- callers mask by activity). The step is one run of the
        decode program; the host owns the tables and positions and refills
        its buffers. ``active`` overrides the lane mask (data, the same
        program): the speculative decoder drives its fallback lanes through
        here, and the other lanes write to scratch block 0."""
        act = (self._active if active is None
               else np.asarray(active, np.bool_))
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
            samp=((4, S), torch.int32), resident=self._decode_resident())
        out = self._run(prog, "latency.decode_step", "serving.step",
                        last_tok=self._last_tok, positions=pos, rows=rows,
                        offs=pos % bs, block_tables=self._bt_host,
                        samp=self._samp)[0]
        self._positions[act] += 1
        self._last_tok[act] = out[act]
        self.decode_steps += 1
        n = int(act.sum())
        metrics.bump("engine.steps")
        metrics.bump("tokens.generated", n)
        self._meter.tick(n)
        metrics.set_gauge("tokens_per_sec", self._meter.rate())
        return out

    @torch.no_grad()
    def spec_decode_step(self) -> Dict[int, List[int]]:
        """One speculative iteration (``spec_k`` > 0): up to k tokens per
        active slot, ``{slot: [tokens]}``, every one what plain decode would
        emit (:meth:`.spec_decode.SpecDecoder.step`)."""
        t0 = time.perf_counter()
        out = self.spec.step()
        telemetry.observe("latency.spec_step", time.perf_counter() - t0,
                          self.hists)
        return out

    def rebuild(self) -> None:
        """Start the engine over after a transient device or arena failure
        (the supervisor's recovery primitive; ``paddle_tpu/serving/
        engine.py:1745``), in place: the arena's pools are zeroed on the
        engine's stream, outside any capture, and keep their storage, so
        every captured graph -- which holds their addresses -- stays
        valid; the arena's bookkeeping starts over (``KVArena.reset``); a
        fresh prefix tree over it carries the lifetime counters; every slot
        array is cleared and the constraint mask set back to all-True with
        every row marked, so the next run writes them all (a replayed
        unconstrained slot must not inherit a dead request's row). No
        program, graph or build counter is touched: the supervisor then
        replays each live request from its journal through the same
        programs. The draft namespace's pools are zeroed in place with the
        others and the speculative decoder's slot state cleared
        (``SpecDecoder.rebuild``); each replay prefills its draft cache
        again at admission.

        The decode kernel's workspace (``ops.paged_attention._workspace``)
        is left alone: its ticket counters are zero after every launch
        that ran to its end, and the faults recovered here fire on the
        host before a run. A kernel fault on the card is a sticky CUDA
        error that no rebuild clears; the supervisor fails fast on it.

        On rank 0 of a mesh the followers rebuild too (a dead one raises
        :class:`.tp.FollowerDiedError` here)."""
        if self._tp is not None:
            self._tp.send("rebuild")
        with self._graphs.on_stream():
            self.arena.reset()
        if self.use_prefix_cache:
            # the tier view is kept: the replays' walks restore from it
            old = self.prefix_cache
            self.prefix_cache = PrefixCache(self.arena, self.block_size,
                                            tier=self.tier)
            if old is not None:
                for k in ("hits", "misses", "hit_tokens", "inserted_blocks",
                          "evictions", "spills", "restores"):
                    setattr(self.prefix_cache, k, getattr(old, k))
                if old._index is not None:
                    # a gateway replica: the fresh tree is empty, so the
                    # binding resets its published residency; the replays
                    # publish again
                    self.prefix_cache.bind_index(old._index, old._replica)
        self._bt_host[:] = 0
        self._positions[:] = 0
        self._last_tok[:] = 0
        self._active[:] = False
        self._occupied[:] = False
        self._slot_limit[:] = 0
        self._scenario_once[:] = False
        self._slot_res = [None] * self.num_slots
        self._slot_shared = [[] for _ in range(self.num_slots)]
        self._slot_filled[:] = 0
        self._chunk.clear()
        self._temp[:] = 0.0
        self._top_k[:] = 0
        self._top_p[:] = 1.0
        self._seed[:] = 0
        self._constrained[:] = False
        self._mask.fill_all(True)
        # the adapter arena keeps its rows: replays re-install their ids
        if self._adapter_ids is not None:
            self._adapter_ids.fill_all(0)
        if self.spec is not None:
            self.spec.rebuild()
        self.rebuilds += 1
        metrics.bump("engine.rebuilds")
        self._publish_arena_bytes()
        self._refresh_gauges()

    def close(self) -> None:
        """Drop the step programs (on CUDA their graphs and pool); any later
        model call raises. The arena stays until the engine is dropped (a
        gateway pool frees a retired replica's at once:
        ``KVArena.free_storage``)."""
        self._graphs.close()
        self._restore_staging = None
        self._restore_views = []
        if self._tp is not None:
            self._tp.close()
        if self.mesh is not None and self.mesh.rank == 0:
            self.mesh.close()

    # -------------------------------------------------------------- stats

    def kernel_route(self) -> str:
        """The attention route this engine runs: ``"kernel@single"`` on a
        CUDA device (the hand-written paged kernels), ``"plain@single"`` on
        the CPU (their plain PyTorch versions); ``@model<mp>`` on a mesh
        of ``mp > 1`` ranks, each attending its local heads."""
        route = "kernel" if self.device.type == "cuda" else "plain"
        mp = model_parallel(self.mesh)
        return f"{route}@{'single' if mp == 1 else f'model{mp}'}"

    def _draft_quantized(self) -> bool:
        """``quant_draft`` in effect: it quantizes nothing without a draft
        model."""
        return bool(self.quant_draft and self.spec is not None
                    and self.spec.draft_mode)

    def _publish_arena_bytes(self) -> None:
        """Byte and dtype gauges per arena namespace, scale pools broken out
        (``arena.kv_bytes``, ``arena.scale_bytes``, ``arena.bytes.<ns>``,
        ``arena.dtype.<ns>``): the int8 arena's and the draft namespace's
        memory, reported."""
        by_ns = self.arena.bytes_by_namespace()
        metrics.set_gauge("arena.kv_bytes",
                          sum(d["bytes"] for d in by_ns.values()))
        metrics.set_gauge("arena.scale_bytes",
                          sum(d["scale_bytes"] for d in by_ns.values()))
        for name, d in by_ns.items():
            metrics.set_gauge(f"arena.bytes.{name}", d["bytes"])
            metrics.set_gauge(f"arena.dtype.{name}", d["dtype"])

    def _refresh_gauges(self) -> None:
        metrics.set_gauge("slots.active", self.active_slots())
        metrics.set_gauge("sampling.active_slots",
                          int(((self._temp > 0) & self._active).sum()))
        metrics.set_gauge("constrain.active_slots",
                          int((self._constrained & self._active).sum()))
        if self.lora is not None:
            metrics.set_gauge("lora.active_slots",
                              int(((self._adapter != 0)
                                   & self._active).sum()))
        a = self.arena.stats()
        metrics.set_gauge("arena.blocks_free", a["blocks_free"])
        metrics.set_gauge("arena.blocks_total", a["blocks_total"])
        metrics.set_gauge("arena.high_water", a["high_water"])
        metrics.set_gauge("arena.blocks_cached", a["blocks_cached"])
        if self.prefix_cache is not None:
            metrics.set_gauge("prefix.resident_blocks",
                              self.prefix_cache.resident_blocks())

    def stats(self) -> dict:
        layers = [m for m in self._model.modules()
                  if getattr(m, "weight_scale", None) is not None]
        out = {"slots.total": self.num_slots,
               "slots.active": self.active_slots(),
               "decode_steps": self.decode_steps,
               "prefills": self.prefills,
               "prefill_chunks": self.prefill_chunks,
               "suffix_prefills": self.suffix_prefills,
               "cow_copies": self.cow_copies,
               "rebuilds": self.rebuilds,
               "decode_traces": self.decode_traces,
               "cow_traces": self.cow_traces,
               "restore_traces": self.restore_traces,
               "restore_captures": self.restore_captures,
               "tier.enabled": int(self.tier is not None),
               "programs.graphs": self._graphs.graph_count(),
               "programs.pool_bytes": self._graphs.pool_bytes,
               "quant.weight_layers": len(layers),
               "quant.weights": int(self.quant_weights),
               "quant.kv": int(self.quant_kv),
               "quant.draft": int(self._draft_quantized()),
               "sampling.admits": self.sampled_admits,
               "constrain.admits": self.constrained_admits,
               "lora.admits": self.adapter_admits,
               "kernel.route": self.kernel_route(),
               "mesh.key": self.mesh_key,
               "mesh.model_axis": model_parallel(self.mesh),
               "mesh.data_axis": 1,
               "mesh.rank": model_rank(self.mesh),
               "mesh.backend": (None if self.mesh is None
                                else self.mesh.backend),
               "mesh.captured": self._graphs.backend is not None,
               "device": str(self.device)}
        out.update({f"arena.{k}": v for k, v in self.arena.stats().items()})
        if self.prefix_cache is not None:
            out.update({f"prefix.{k}": v
                        for k, v in self.prefix_cache.stats().items()})
        if self.tier is not None:
            out.update(self.tier.stats())
        if self.spec is not None:
            out.update(self.spec.stats())
        if self.lora is not None:
            out.update(self.lora.stats())
        return out
