"""Speculative decoding over the paged slot arena (counterpart of
``paddle_tpu/serving/spec_decode.py``).

A cheap **draft** proposes ``k`` tokens, the **target** verifies all of them
in one run of a captured step, and the longest prefix of proposals that
matches the target's own greedy picks is accepted, plus the target's
correction token at the first mismatch. Every emitted token is the token
sequential greedy decode would emit: verify sub-step ``j`` picks the
target's token after the true context extended by the already matched
proposals, so a bad draft costs speed, never tokens.

Each sub-step runs exactly the ops and shapes of the engine's decode step
(``ServingEngine._decode_fn``): the :class:`~.engine._PagedCacheView` over
``[S]`` lanes, ``model.gpt(last_tok[:, None], ...)``, the head as one dense
``[S, hidden]`` product (``GPTForCausalLM.verify_logits`` for the target's
``k + 1`` positions) and the greedy pick through
:func:`.sampling.sample_tokens` with greedy parameters and an all-True mask,
the plain step's route for a greedy lane, ties included. One ``[S, k+1]``
forward would be the same math but not the same bits (its products take
other shapes).

Two modes, by whether a draft model is configured:

* **Draft mode** (``ServingConfig.draft_model``): the draft proposes from
  its own K/V, the arena's ``"draft"`` namespace (the same block ids, free
  list and reservations; pools shaped for the draft's layers and heads),
  through a second per-slot table. Proposal and verification are ONE
  captured step: ``k`` draft sub-steps and ``k + 1`` target sub-steps.
* **Lockstep self-draft** (no draft): ``k`` target sub-steps per run, each
  fed the previous one's pick; acceptance is 1 by construction.

All of a lane's state -- positions, tables, write rows and offsets of every
sub-step, its depth ``allow`` -- is data in the step's static buffers,
computed on the host, so acceptance, rejection and churn never build the
step again. Rejected K/V is never copied back: positions roll back on the
host, the position mask hides stale entries and the next iteration writes
over them. A lane's depth is clamped so its budget, reservation and the
model's positions are never overrun; a masked sub-step (``j`` past
``allow``) writes to scratch block 0 at a position clamped to ``pos +
allow``, inside the slot's table and the model's position table (XLA clamps
such a gather; the paged kernels and the position embedding do not). Each
draft prefill bucket is one captured program too.

Differences from the JAX package, on purpose: the draft must cover
``max_model_len`` positions (``ValueError`` otherwise; the JAX decoder checks
only the vocabulary), and :meth:`SpecDecoder.rebuild` keeps the draft
namespace, zeroed in place with the arena (the captured step holds its
addresses), where the JAX one binds a fresh namespace.

Counters (``serving.metrics``): ``spec.proposed`` / ``spec.accepted`` /
``spec.rollback_tokens`` / ``spec.emitted`` / ``spec.iterations`` /
``spec.draft_prefills``, the ``spec.acceptance_rate`` gauge,
``quant.draft_layers`` and the ``quant.draft_acceptance`` gauge, and
``sampling.spec_fallback_slots``; histograms ``latency.spec_verify`` (the
speculative run alone) and ``latency.spec_step`` (the whole iteration).
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import compile_cache, flags, resilience
from ..models.gpt import quantize_serving_weights, serving_compute_dtype
from ..ops.paged_attention import check_servable
from . import metrics, telemetry
from .engine import (_CapturePrefillView, _PagedCacheView, _samp_params,
                     _scatter_rows)
from .graphs import ResidentBuffer
from .kv_arena import Reservation
from .sampling import sample_tokens

__all__ = ["SpecDecoder"]

_ONE_BITS = int(np.float32(1.0).view(np.int32))  # top_p 1.0, bit-cast


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class SpecDecoder:
    """The speculative sidecar of one :class:`~.engine.ServingEngine`: the
    draft namespace, the second per-slot table and its reservations, the
    captured speculative step and the draft prefill programs, and the
    acceptance accounting. The engine drives it: :meth:`alloc_slot` and
    :meth:`prefill` at admission, :meth:`release_slot` at retire,
    :meth:`rebuild` in its rebuild, and :meth:`step` in place of the decode
    step."""

    NAMESPACE = "draft"

    def __init__(self, engine, draft_model=None, k: Optional[int] = None):
        self.k = int(k if k is not None else flags.flag("serving_spec_k"))
        if self.k < 1:
            raise ValueError("SpecDecoder needs k >= 1 "
                             "(FLAGS_serving_spec_k)")
        self.engine = engine
        self.draft = draft_model
        s = engine.num_slots
        self._bt_host = np.zeros((s, engine.blocks_per_slot), np.int32)
        self._filled = np.zeros(s, np.int32)
        self._res: List[Optional[Reservation]] = [None] * s
        # builds of the programs (the JAX trace counters) and lifetime
        # counts of this engine stack
        self.spec_traces = 0
        self.draft_prefill_traces: Dict[int, int] = {}
        self.draft_prefills = 0
        self.proposed = 0
        self.accepted = 0
        self.rollback_tokens = 0
        self.emitted = 0
        self.iterations = 0
        self.quant_draft = bool(engine.quant_draft)
        if draft_model is not None:
            self._check_draft(draft_model)
            draft_model.eval()
            if self.quant_draft:
                # in place and idempotent; moves acceptance, never tokens.
                # The whole weights, then split on a mesh as the target's
                n = quantize_serving_weights(draft_model, mesh=engine.mesh)
                if n:
                    metrics.bump("quant.draft_layers", n)
            dcfg = draft_model.cfg
            engine.arena.add_namespace(
                self.NAMESPACE, dcfg.num_layers, dcfg.num_heads,
                dcfg.hidden_size // dcfg.num_heads,
                serving_compute_dtype(draft_model))
        # every sub-step's greedy pick: temperature 0, top_k 0, top_p 1,
        # seed 0 and an all-True mask, resident on the device (never
        # refilled)
        self._greedy = ResidentBuffer(engine.device, (4, s), torch.int32, 0,
                                      attr="_greedy")
        self._greedy.set_row(2, _ONE_BITS)
        self._allow_all = ResidentBuffer(engine.device, (s, engine.vocab),
                                         torch.bool, True, attr="_allow_all")

    def _check_draft(self, draft) -> None:
        """Refuse a draft that could not serve beside the target: another
        vocabulary, another device, fewer positions than ``max_model_len``
        (its position embedding would be read past its end), or a head dim
        or dtype the card's kernels do not take."""
        engine = self.engine
        dcfg, tcfg = draft.cfg, engine._model.cfg
        if dcfg.vocab_size != tcfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{tcfg.vocab_size}: proposals would be meaningless ids")
        if dcfg.max_position_embeddings < engine.max_model_len:
            raise ValueError(
                f"draft max_position_embeddings "
                f"{dcfg.max_position_embeddings} < max_model_len "
                f"{engine.max_model_len}: the draft could not reach every "
                "position the engine serves")
        weight = draft.gpt.wte.weight
        if weight.device != engine.device:
            raise ValueError(f"the draft lives on {weight.device}, the engine "
                             f"runs on {engine.device}")
        check_servable(dcfg.hidden_size // dcfg.num_heads,
                       serving_compute_dtype(draft), engine.device)

    # ------------------------------------------------------------- state

    @property
    def draft_mode(self) -> bool:
        return self.draft is not None

    def rebuild(self) -> None:
        """Start over with the engine's rebuild: every slot's draft state
        is cleared. The namespace's pools were zeroed in place by
        ``KVArena.reset`` and stay bound (the captured step holds their
        addresses); the replays prefill each draft cache again at
        admission, so it is rebuilt, not approximated."""
        self._bt_host[:] = 0
        self._filled[:] = 0
        self._res = [None] * self.engine.num_slots

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """The draft table's worst case of an admission (0 in lockstep)."""
        if not self.draft_mode:
            return 0
        return _ceil_div(prompt_len + max_new_tokens, self.engine.block_size)

    def alloc_slot(self, slot: int, prompt_len: int,
                   max_new_tokens: int) -> None:
        """Reserve the slot's draft budget from the shared free list; raises
        ``ArenaExhaustedError`` under pressure (the engine unwinds the
        admission)."""
        if self.draft_mode:
            self._res[slot] = self.engine.arena.reserve(
                self.blocks_needed(prompt_len, max_new_tokens))

    def release_slot(self, slot: int) -> None:
        res = self._res[slot]
        self._res[slot] = None
        if res is not None:
            res.release()
        self._bt_host[slot, :] = 0
        self._filled[slot] = 0

    def reserved_blocks(self, slot: int) -> int:
        res = self._res[slot]
        return res.total if res is not None else 0

    def slot_tables(self) -> List[List[int]]:
        """The occupied slots' draft block lists, for the arena's audit."""
        return [[int(b) for b in self._bt_host[slot, :int(self._filled[slot])]]
                for slot in range(self.engine.num_slots) if self._filled[slot]]

    def _grow(self, slot: int, pos_max: int) -> None:
        """Take draft blocks until the table covers ``pos_max`` (the
        reservation guarantees ``take()`` cannot fail)."""
        need = pos_max // self.engine.block_size + 1
        res = self._res[slot]
        while int(self._filled[slot]) < need:
            bi = int(self._filled[slot])
            self._bt_host[slot, bi] = res.take()
            self._filled[slot] = bi + 1

    # ----------------------------------------------------------- prefill

    def _draft_prefill_fn(self, ids, rows, offs):
        """One draft prefill bucket over its static buffers: the draft over
        the padded context, every position's k/v scattered at ``(rows,
        offs)`` of the draft namespace (padded ones to scratch block 0). No
        head: the target's prefill emitted the token."""
        draft = self.draft
        views = [_CapturePrefillView(self.engine.block_size)
                 for _ in range(draft.cfg.num_layers)]
        _, chunks = draft.gpt(ids, caches=views, start_pos=0)
        arena = self.engine.arena
        red = arena.scale_reduce(self.NAMESPACE)
        for (kc, vc), entry in zip(chunks, arena.ns_pools(self.NAMESPACE)):
            _scatter_rows(entry, rows, offs, kc[0], vc[0], red)
        return ()

    def _prefill_built(self, bucket: int) -> None:
        self.draft_prefill_traces[bucket] = \
            self.draft_prefill_traces.get(bucket, 0) + 1
        compile_cache.bump("serving.prefill_compiles")
        if self.engine.device.type == "cuda":
            metrics.bump("kernel.prefill_traces")

    @torch.no_grad()
    def prefill(self, slot: int, ctx: np.ndarray) -> None:
        """Scatter the draft's K/V of the whole context into the slot's
        draft blocks: one run of the context's bucket program. Runs at
        admission and at every journal replay, so recovery rebuilds the
        draft cache exactly; nothing in lockstep."""
        if not self.draft_mode:
            return
        engine = self.engine
        bs = engine.block_size
        clen = int(ctx.shape[0])
        self._grow(slot, clen - 1)
        p_bucket = compile_cache.prefill_bucket(
            clen, engine.max_model_len, engine.prefill_bucket_min)
        ids = np.zeros(p_bucket, np.int64)
        ids[:clen] = ctx
        p_idx = np.arange(p_bucket)
        table = self._bt_host[slot]
        row = np.where(p_idx < clen,
                       table[np.minimum(p_idx // bs, table.shape[0] - 1)], 0)
        i64 = torch.int64
        prog = engine._graphs.program(
            ("draft_prefill", p_bucket), self._draft_prefill_fn,
            functools.partial(self._prefill_built, p_bucket),
            site="spec", ids=((1, p_bucket), i64), rows=((p_bucket,), i64),
            offs=((p_bucket,), i64))
        engine._run(prog, None, "serving.draft_prefill", ids=ids, rows=row,
                    offs=p_idx % bs)
        self.draft_prefills += 1
        metrics.bump("spec.draft_prefills")

    # -------------------------------------------------------------- step

    def _forward(self, model, pools, block_tables, positions, rows, offs,
                 last_tok):
        """One single-token forward of ``model`` over its pools: the decode
        step's ops and shapes, head excluded. Returns the ``[S, hidden]``
        last hidden states."""
        arena = self.engine.arena
        red = arena.scale_reduce("primary" if pools is arena.pools
                                 else self.NAMESPACE)
        views = [_PagedCacheView(entry, block_tables, positions, rows, offs,
                                 red) for entry in pools]
        h, _ = model.gpt(last_tok[:, None], caches=views, start_pos=positions)
        return h[:, 0]

    def _sub_step(self, model, pools, block_tables, positions, rows, offs,
                  last_tok, samp, allowed):
        """A whole decode sub-step: forward, head and the greedy pick,
        keyed at ``positions + 1`` as the decode step keys its tokens."""
        h = self._forward(model, pools, block_tables, positions, rows, offs,
                          last_tok)
        return sample_tokens(model._head_logits(h), *_samp_params(samp),
                             positions + 1, allowed)

    def _draft_fn(self, last_tok, t_pos, t_rows, t_offs, t_bt, d_pos, d_rows,
                  d_offs, d_bt, samp, allowed):
        """The fused draft-mode step: ``k`` draft sub-steps over the draft
        namespace propose ``[S, k]`` tokens, then ``k + 1`` target
        sub-steps verify them (sub-step ``j`` feeds proposal ``j - 1``; 0
        the last token), the head over all ``k + 1`` hidden states through
        ``verify_logits`` and each position's greedy pick. Returns the
        target's picks ``[S, k + 1]`` and the proposals ``[S, k]``."""
        eng = self.engine
        model = eng._model
        d_pools = eng.arena.ns_pools(self.NAMESPACE)
        toks = last_tok
        props = []
        for j in range(self.k):
            toks = self._sub_step(self.draft, d_pools, d_bt, d_pos[j],
                                  d_rows[j], d_offs[j], toks, samp, allowed)
            props.append(toks)
        toks = last_tok
        hs = []
        for j in range(self.k + 1):
            hs.append(self._forward(model, eng.arena.pools, t_bt, t_pos[j],
                                    t_rows[j], t_offs[j], toks))
            if j < self.k:
                toks = props[j]
        logits = model.verify_logits(torch.stack(hs, 1))
        tgt = [sample_tokens(logits[:, j], *_samp_params(samp),
                             t_pos[j] + 1, allowed)
               for j in range(self.k + 1)]
        return torch.stack(tgt, 1), torch.stack(props, 1)

    def _lockstep_fn(self, last_tok, t_pos, t_rows, t_offs, t_bt, samp,
                     allowed):
        """The lockstep step: ``k`` target sub-steps, each fed the previous
        one's pick. Returns ``[S, k]`` tokens."""
        eng = self.engine
        toks = last_tok
        outs = []
        for j in range(self.k):
            toks = self._sub_step(eng._model, eng.arena.pools, t_bt, t_pos[j],
                                  t_rows[j], t_offs[j], toks, samp, allowed)
            outs.append(toks)
        return (torch.stack(outs, 1),)

    def _spec_built(self) -> None:
        """Count one build of the speculative step."""
        self.spec_traces += 1
        compile_cache.bump("serving.decode_compiles")
        if self.engine.device.type == "cuda":
            metrics.bump("kernel.verify_traces")

    def _lanes(self, act: np.ndarray, allow: np.ndarray, n: int,
               table: np.ndarray, limit: np.ndarray) -> tuple:
        """The ``[n, S]`` positions, write rows and offsets of ``n``
        sub-steps: a lane of ``act`` writes sub-step ``j`` at ``pos + j``
        through ``table`` while ``j < limit`` (per lane); a masked sub-step
        writes to scratch block 0 at ``pos + min(j, allow)``, inside the
        table and the model's positions; any other lane sits at its own
        position, as in the decode step."""
        eng = self.engine
        bs = eng.block_size
        pos = eng._positions.astype(np.int64)
        j = np.arange(n)[:, None]
        live = act[None, :] & (j < limit[None, :])
        at = pos[None, :] + np.where(act[None, :], np.minimum(j, allow), 0)
        slots = np.broadcast_to(np.arange(eng.num_slots), at.shape)
        rows = np.where(live, table[slots, np.minimum(
            at // bs, table.shape[1] - 1)], 0)
        return at.astype(np.int32), rows, at % bs

    def step(self) -> Dict[int, List[int]]:
        """One speculative iteration over every active slot: ``{slot:
        tokens}``, 1 to ``k`` tokens each. Spec-ineligible lanes
        (``engine.spec_ineligible()``: sampled, constrained or wearing an
        adapter, sticky) fall back to one plain decode step over their own
        lanes, sampled, masked and adapted as a speculation-off engine
        does (the verify step binds no adapter); both programs are built
        once and cover disjoint lanes of the same arena."""
        engine = self.engine
        inel = engine.spec_ineligible()
        act_spec = engine._active & ~inel
        act_plain = engine._active & inel
        out: Dict[int, List[int]] = {}
        if act_spec.any():
            t0 = time.perf_counter()
            out.update(self._spec_step(act_spec))
            telemetry.observe("latency.spec_verify",
                              time.perf_counter() - t0, engine.hists)
        if act_plain.any():
            metrics.bump("sampling.spec_fallback_slots",
                         int(act_plain.sum()))
            resilience.bump("sampling.spec_fallbacks")
            toks = engine.decode_step(active=act_plain)
            for slot in np.flatnonzero(act_plain):
                out[int(slot)] = [int(toks[slot])]
        return out

    def _spec_step(self, act: np.ndarray) -> Dict[int, List[int]]:
        """One run of the speculative step over the eligible lanes ``act``,
        then acceptance on the host."""
        engine = self.engine
        k = self.k
        slots = np.flatnonzero(act)
        # per-lane depth: target writes reach pos + allow, draft writes
        # pos + allow - 1; the pending last token already counts toward the
        # budget, so a lane may emit allow + 1 <= limit - pos - 1 tokens
        allow = np.zeros(engine.num_slots, np.int64)
        cap = k if self.draft_mode else k - 1
        for slot in slots:
            pos = int(engine._positions[slot])
            remaining = int(engine._slot_limit[slot]) - pos - 1
            allow[slot] = max(0, min(cap, remaining - 1))
            engine._grow_slot_to(slot, pos + int(allow[slot]))
            if self.draft_mode and allow[slot] > 0:
                self._grow(slot, pos + int(allow[slot]) - 1)
        S, i32, i64 = engine.num_slots, torch.int32, torch.int64
        n_t = k + 1 if self.draft_mode else k
        t_pos, t_rows, t_offs = self._lanes(act, allow, n_t, engine._bt_host,
                                            allow + 1)
        values = dict(last_tok=engine._last_tok, t_pos=t_pos, t_rows=t_rows,
                      t_offs=t_offs, t_bt=engine._bt_host)
        specs = dict(last_tok=((S,), i64), t_pos=((n_t, S), i32),
                     t_rows=((n_t, S), i64), t_offs=((n_t, S), i64),
                     t_bt=((S, engine.blocks_per_slot), i32))
        if self.draft_mode:
            d_pos, d_rows, d_offs = self._lanes(act, allow, k, self._bt_host,
                                                allow)
            values.update(d_pos=d_pos, d_rows=d_rows, d_offs=d_offs,
                          d_bt=self._bt_host)
            specs.update(d_pos=((k, S), i32), d_rows=((k, S), i64),
                         d_offs=((k, S), i64),
                         d_bt=((S, engine.blocks_per_slot), i32))
        prog = engine._graphs.program(
            "spec", self._draft_fn if self.draft_mode else self._lockstep_fn,
            self._spec_built,
            resident=dict(samp=self._greedy, allowed=self._allow_all),
            site="spec", **specs)
        res = engine._run(prog, None, "serving.spec_step", **values)
        tgt = res[0]
        props = res[1] if self.draft_mode else tgt  # lockstep: its own picks

        out: Dict[int, List[int]] = {}
        n_emitted = n_proposed = n_accepted = n_rollback = 0
        for slot in slots:
            a = int(allow[slot])
            if self.draft_mode:
                n = 0
                while n < a and props[slot, n] == tgt[slot, n]:
                    n += 1
                # full acceptance takes the k matched proposals and skips
                # the bonus token: the draft cache then covers exactly the
                # positions before the new one
                accepted = [int(t) for t in tgt[slot, :k if n == k
                                                else n + 1]]
                n_proposed += a
                n_accepted += n
                n_rollback += a - n
            else:
                accepted = [int(t) for t in tgt[slot, :a + 1]]
                n_proposed += a + 1
                n_accepted += a + 1
            engine._positions[slot] += len(accepted)
            engine._last_tok[slot] = accepted[-1]
            out[int(slot)] = accepted
            n_emitted += len(accepted)
        self.iterations += 1
        self.proposed += n_proposed
        self.accepted += n_accepted
        self.rollback_tokens += n_rollback
        self.emitted += n_emitted
        metrics.bump("spec.iterations")
        metrics.bump("spec.emitted", n_emitted)
        metrics.bump("spec.proposed", n_proposed)
        metrics.bump("spec.accepted", n_accepted)
        if n_rollback:
            metrics.bump("spec.rollback_tokens", n_rollback)
        metrics.bump("engine.steps")
        metrics.bump("tokens.generated", n_emitted)
        engine._meter.tick(n_emitted)
        metrics.set_gauge("tokens_per_sec", round(engine._meter.rate(), 1))
        metrics.set_gauge("spec.acceptance_rate",
                          round(self.acceptance_rate(), 4))
        if self.quant_draft and self.draft_mode:
            metrics.set_gauge("quant.draft_acceptance",
                              round(self.acceptance_rate(), 4))
        return out

    # ------------------------------------------------------------- stats

    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def mode(self) -> str:
        """``lockstep``, ``draft`` or ``draft-int8``."""
        if not self.draft_mode:
            return "lockstep"
        return "draft-int8" if self.quant_draft else "draft"

    def stats(self) -> dict:
        return {
            "spec.k": self.k,
            "spec.mode": self.mode(),
            "spec.proposed": self.proposed,
            "spec.accepted": self.accepted,
            "spec.rollback_tokens": self.rollback_tokens,
            "spec.emitted": self.emitted,
            "spec.iterations": self.iterations,
            "spec.acceptance_rate": round(self.acceptance_rate(), 4),
            "spec.traces": self.spec_traces,
            "spec.draft_prefill_traces": dict(self.draft_prefill_traces),
        }
