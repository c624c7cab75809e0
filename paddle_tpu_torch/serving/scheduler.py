"""Iteration-level (continuous) batching scheduler (counterpart of
``paddle_tpu/serving/scheduler.py``).

Between any two decode steps the scheduler retires finished requests and
admits waiting ones into the freed slots:

* **Priority admission with capacity gating**: the best waiting request
  (lowest ``priority`` value, then earliest arrival; default 0, FCFS within
  a class) is admitted when a slot is free AND the KV arena can reserve its
  block budget (``ServingEngine.can_admit``, which subtracts the blocks a
  resident prefix attaches by reference), so a running request is never
  starved of cache mid-decode. Admission is strict head-of-line: nothing
  jumps a blocked better waiter.
* **Preemption under starvation**: when the best waiter has been blocked on
  capacity for more than ``FLAGS_serving_starvation_steps`` steps and a
  strictly lower-priority request is running, the lowest-priority, most
  recently admitted victim is preempted: its slot and blocks are released
  and it re-queues with its token journal, so re-admission prefills
  ``prompt + journal`` and resumes token for token (its walker state is
  rebuilt from the journal; a seeded sampled request's keys are
  positional). The preemption is declined when even every eligible victim
  could not seat the waiter.
* **Cache-aware admission** (``FLAGS_serving_cache_affinity`` = W > 0):
  with the prefix cache on, a same-priority waiter whose prefix is
  resident may be admitted ahead of a cache-cold head, at most W times per
  head.
* **Finish rules** at every step boundary: the stop token, the token
  budget, cancellation and the request's wall-clock deadline
  (``core.resilience.Deadline``); cancelled and expired waiters are culled
  before they cost a prefill.
* **Chunked prefill** (engine ``chunk_size > 0``): a prompt longer than a
  chunk is admitted through ``ServingEngine.admit_begin`` and waits in
  ``prefilling``; each step advances the oldest such admission by one chunk
  before it admits and decodes, so a long prompt stalls running streams by
  one chunk per step, not by its whole prefill. A cancel mid-prefill frees
  the slot and its blocks.

* **Per-request scenario state**: a request's ``sampling`` (seed pinned
  at creation) and ``constraint`` walker reach the engine at admission
  (:func:`admit_kwargs`); after each emitted token the walker advances and
  the slot's mask row is replaced (``ServingEngine.set_slot_mask``). A
  walker that fails fails its own request only.
* **Transient failures** (``supervisor.is_transient_serving_error``): an
  admission or chunk that fails transiently re-queues its request
  untouched and re-raises, so the API's supervisor rebuilds the engine and
  replays everything (``paddle_tpu/serving/scheduler.py:489-498``,
  ``:571-580``); any other failure fails that request alone.
* **Telemetry** (``serving.telemetry``): ``Request.trace_id`` is minted at
  creation and kept through preemption re-queue and supervisor replay; the
  spans QUEUED, ADMITTED, PREFILL_CHUNK, FIRST_TOKEN, PREEMPTED, FINISHED
  and FAILED, and the ``latency.{ttft,inter_token,queue_wait,e2e}``
  histograms, are recorded where the JAX scheduler records them.

* **Speculative decoding** (engine ``spec`` set): the step's iteration is
  ``ServingEngine.spec_decode_step``, up to k tokens per slot, emitted one
  at a time through the same finish rules, so stop, budget and deadline
  boundaries keep ``generate()``'s semantics: tokens past a stop are
  dropped, as the sequential path would never have made them.

Served tokens are held token for token against
``GPTForCausalLM.generate()``, with ``sampling=`` for sampled requests.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..core import flags, resilience
from . import metrics, telemetry

_req_counter = itertools.count()
_seq_counter = itertools.count()  # arrival and admission ordering ticks


class RequestState:
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    CANCELLED = "CANCELLED"
    FAILED = "FAILED"


@dataclass(eq=False)  # identity equality: list membership must never
class Request:        # compare numpy prompt payloads
    """One generation request moving through the engine. ``tokens``
    accumulates generated ids; the stop token, when hit, is the last one.
    ``tokens`` is also the request's journal: a preempted request
    re-prefills ``prompt + tokens`` to resume where it left off.
    ``priority`` follows the vLLM convention: lower values are served
    first, 0 is normal traffic. ``stream_queue``/``done_event`` are what
    ``ServingAPI.stream`` reads."""

    prompt: np.ndarray
    max_new_tokens: int = 32
    stop_token_id: Optional[int] = None
    request_id: str = ""
    priority: int = 0
    # the request's scenario: sampling params (serving.sampling.
    # SamplingParams; None is greedy) and an incremental decoding
    # constraint (serving.constrain.Constraint), whose walker state
    # `_cstate` is a pure function of `tokens`
    sampling: Optional[object] = None
    constraint: Optional[object] = None
    # the adapter arena row this request decodes with (0: the base model)
    adapter_id: int = 0
    deadline: resilience.Deadline = field(
        default_factory=resilience.Deadline)
    state: str = RequestState.QUEUED
    tokens: List[int] = field(default_factory=list)
    error: Optional[BaseException] = None
    slot: Optional[int] = None
    stream_queue: "_queue.SimpleQueue" = field(
        default_factory=_queue.SimpleQueue)
    done_event: threading.Event = field(default_factory=threading.Event)
    _cancel: bool = False
    _arrival: int = 0      # submit-order tick (priority tie-break)
    _admit_seq: int = 0    # last admission tick (the most recent victim)
    _starved: int = 0      # steps blocked at the head of the queue
    _cache_skips: int = 0  # times cache affinity admitted someone past it
    _prefix_keys: Optional[list] = None  # memoized radix chunk-key chain
    preemptions: int = 0   # times this request was preempted
    # one id names the request's whole life: minted here unless the caller
    # carries one, kept through preemption re-queue and supervisor replay
    trace_id: str = ""
    _submit_ts: float = 0.0     # perf_counter at creation (ttft, e2e)
    _queued_ts: float = 0.0     # perf_counter at enqueue (queue_wait)
    _last_emit_ts: float = 0.0  # perf_counter of the last emitted token

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int64).reshape(-1)
        self.priority = int(self.priority)
        self.adapter_id = int(self.adapter_id)
        self._arrival = next(_seq_counter)
        self._submit_ts = time.perf_counter()
        if not self.trace_id:
            self.trace_id = telemetry.mint_trace_id()
        if self.sampling is not None:
            # pin an unset seed now: the request's stream is then fixed
            self.sampling = self.sampling.materialized()
        if not self.request_id:
            self.request_id = f"req-{next(_req_counter)}"
        self._cstate = (None if self.constraint is None
                        else self.constraint.initial())
        self._dead_ended = False

    @property
    def finished(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.FAILED)

    def cancel(self) -> None:
        self._cancel = True

    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int64)])

    # ------------------------------------------------ constraint walker

    def reset_constraint(self) -> None:
        """Rebuild the walker state from the token journal."""
        if self.constraint is None:
            return
        st = self.constraint.initial()
        for t in self.tokens:
            st = self.constraint.advance(st, int(t))
        self._cstate = st
        self._dead_ended = False

    def advance_constraint(self, token: int) -> None:
        if self.constraint is not None:
            self._cstate = self.constraint.advance(self._cstate, int(token))

    def allowed_mask(self) -> Optional[np.ndarray]:
        """The walker's current allowed-vocab mask (None = unconstrained).
        An empty mask -- a dead-ended user walker -- is sanitized to
        unconstrained and counted once per dead end
        (``constrain.dead_ends``), not once per token."""
        if self.constraint is None:
            return None
        mask = self.constraint.allowed(self._cstate)
        if mask is not None and not mask.any():
            if not self._dead_ended:
                self._dead_ended = True
                metrics.bump("constrain.dead_ends")
            return None
        return mask


def admit_kwargs(req: Request) -> dict:
    """The engine-admission keywords of one request's scenario, shared by
    the scheduler's admissions and the supervisor's replay: its sampling
    params, its adapter id, its walker's current mask, ``spec_exclude`` when
    it carries a constraint at all (even one whose current mask is None:
    such a lane never takes the speculative path, so its draft blocks and
    prefill are skipped from the start), and its trace, where a tier
    restore's span lands."""
    return {"sampling": req.sampling, "adapter": req.adapter_id,
            "mask": req.allowed_mask(),
            "spec_exclude": req.constraint is not None,
            "trace_id": req.trace_id}


class Scheduler:
    """Drives one :class:`ServingEngine` at iteration granularity. Not
    thread-safe by itself: ``ServingAPI`` serialises access."""

    def __init__(self, engine):
        self.engine = engine
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.prefilling: List[Request] = []  # chunked prefills in progress
        self.preempt_count = 0  # this scheduler's lifetime preemptions
        #: called with the error of every request failure a step caused (a
        #: failed admission or prefill chunk, ``fail_all``), after the
        #: request failed: a process replica's worker exits on a sticky
        #: CUDA error there (``gateway.worker``)
        self.on_error: Optional[Callable[[BaseException], None]] = None

    @property
    def _hists(self):
        """The engine's own histogram set (None for an engine without
        one): every latency sample lands there and in the global set."""
        return getattr(self.engine, "hists", None)

    def submit(self, request: Request) -> Request:
        """Enqueue; what could never be served is refused here (overload
        shedding is ``ServingAPI.submit``'s)."""
        self.engine.validate(int(request.prompt.shape[0]),
                             int(request.max_new_tokens),
                             adapter=request.adapter_id)
        request.state = RequestState.QUEUED
        request._queued_ts = time.perf_counter()
        self.waiting.append(request)
        metrics.bump("requests.submitted")
        telemetry.span(request.trace_id, telemetry.QUEUED,
                       request_id=request.request_id,
                       priority=request.priority,
                       journal_tokens=len(request.tokens))
        self._gauges()
        return request

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.prefilling)

    def _finish(self, req: Request, state: str,
                error: Optional[BaseException] = None) -> None:
        if req.finished:
            return
        if req.slot is not None:
            self.engine.retire(req.slot)
            if req in self.running:
                self.running.remove(req)
            if req in self.prefilling:
                self.prefilling.remove(req)
            req.slot = None
        req.state = state
        req.error = error
        metrics.bump({RequestState.FINISHED: "requests.finished",
                      RequestState.CANCELLED: "requests.cancelled",
                      RequestState.FAILED: "requests.failed"}[state])
        if isinstance(error, resilience.DeadlineExceededError):
            metrics.bump("requests.expired")
            resilience.bump("deadline.exceeded")
        if state == RequestState.FINISHED:
            # only requests that delivered their output: failures and
            # cancels would skew the tail
            telemetry.observe("latency.e2e",
                              time.perf_counter() - req._submit_ts,
                              self._hists)
        telemetry.span(req.trace_id,
                       telemetry.FINISHED if state == RequestState.FINISHED
                       else telemetry.FAILED,
                       request_id=req.request_id, state=state,
                       tokens=len(req.tokens),
                       error=type(error).__name__ if error else None)
        req.stream_queue.put(None)  # stream sentinel
        req.done_event.set()

    def _emit(self, req: Request, token: int) -> None:
        if req.finished:
            return  # its walker failed earlier in this step
        now = time.perf_counter()
        if not req.tokens and req._last_emit_ts == 0.0:
            # the true first token only: a journal-seeded submit arrives
            # with tokens, a replayed or preempted request keeps its
            # _last_emit_ts; neither records TTFT again
            telemetry.observe("latency.ttft", now - req._submit_ts,
                              self._hists)
            telemetry.span(req.trace_id, telemetry.FIRST_TOKEN,
                           request_id=req.request_id, token=int(token))
        elif req._last_emit_ts > 0.0:
            telemetry.observe("latency.inter_token",
                              now - req._last_emit_ts, self._hists)
        req._last_emit_ts = now
        req.tokens.append(int(token))
        req.stream_queue.put(int(token))
        if req.constraint is not None:
            # advance the walker one token and replace the slot's mask row
            # (data: the next step constrains under it, nothing is built)
            try:
                req.advance_constraint(token)
                if req.slot is not None:
                    self.engine.set_slot_mask(req.slot, req.allowed_mask())
            # analysis: allow(broad-except) -- a user-supplied walker (a
            # wrong-width mask, a raising advance) fails THIS request,
            # never the pump
            except Exception as e:
                self._finish(req, RequestState.FAILED, e)

    def _check_boundary(self, req: Request) -> bool:
        """Finish rules at a step boundary; True if the request ended.
        Completion outranks the deadline: output that is whole on the step
        the clock ran out is returned."""
        if req._cancel:
            self._finish(req, RequestState.CANCELLED)
            return True
        stop = req.stop_token_id
        if req.tokens and ((stop is not None and req.tokens[-1] == stop)
                           or len(req.tokens) >= req.max_new_tokens):
            self._finish(req, RequestState.FINISHED)
            return True
        if req.deadline.expired():
            self._finish(req, RequestState.FAILED,
                         resilience.DeadlineExceededError(
                             f"{req.request_id} exceeded its deadline"))
            return True
        return False

    def _start(self, req: Request, first: int) -> None:
        """The request's prefill is done: it decodes from the next step."""
        req._admit_seq = next(_seq_counter)
        self.running.append(req)
        self._emit(req, first)
        self._check_boundary(req)  # may retire at once (stop/budget)

    # ----------------------------------------------------- admission order

    def _next_waiter(self) -> Optional[Request]:
        """Best waiting request: lowest priority value, earliest arrival."""
        if not self.waiting:
            return None
        return min(self.waiting, key=lambda r: (r.priority, r._arrival))

    def _keys_for(self, r: Request):
        """The request's radix chunk-key chain under its adapter's root
        (``ServingEngine.prefix_root``), hashed once at its first probe
        (None with the prefix cache off: sizing is then the plain worst
        case)."""
        cache = self.engine.prefix_cache
        if cache is None:
            return None
        if r._prefix_keys is None:
            r._prefix_keys = cache.chunk_keys(
                r.prompt, self.engine.prefix_root(r.adapter_id))
        return r._prefix_keys

    def _can_admit(self, r: Request) -> bool:
        return self.engine.can_admit(int(r.prompt.shape[0]),
                                     int(r.max_new_tokens),
                                     keys=self._keys_for(r),
                                     journal_len=len(r.tokens))

    def _cache_preferred(self, head: Request) -> Request:
        """Cache-aware admission (``FLAGS_serving_cache_affinity`` = W > 0):
        prefer a same-priority waiter whose prefix is resident over a
        cache-cold head. The head may be skipped at most W times (each skip
        is counted on it), priorities are never crossed, and a head that is
        warm itself, or not admissible, is never skipped."""
        window = int(flags.flag("serving_cache_affinity"))
        if window <= 0 or head._cache_skips >= window:
            return head
        engine = self.engine
        cache = engine.prefix_cache
        if cache is None or engine.free_slots() == 0:
            return head
        if cache.resident_tokens_for(self._keys_for(head)) > 0:
            return head  # the head is warm: no reason to skip it
        if not self._can_admit(head):
            # a blocked head belongs to the starvation machinery: skipping
            # it would spend its window on passes it could not use
            return head
        best, best_tokens = head, 0
        for r in self.waiting:
            if r is head or r.priority != head.priority:
                continue
            tokens = cache.resident_tokens_for(self._keys_for(r))
            if tokens > best_tokens and self._can_admit(r):
                best, best_tokens = r, tokens
        if best is not head:
            head._cache_skips += 1
            metrics.bump("scheduler.cache_skips")
        return best

    def _preempt_for(self, waiter: Request) -> bool:
        """Preempt the lowest-priority, most recently admitted running
        request that is strictly lower-priority than ``waiter``: it releases
        its slot and blocks and re-queues with its journal. Declines (False)
        when retiring every eligible victim still could not seat the waiter:
        the victims' work would be lost for nothing. Feasibility uses
        admission's own cache-aware sizing."""
        candidates = [r for r in self.running if r.priority > waiter.priority]
        if not candidates:
            return False
        eng = self.engine
        need, pinned = eng.admit_sizing(int(waiter.prompt.shape[0]),
                                        int(waiter.max_new_tokens),
                                        keys=self._keys_for(waiter),
                                        journal_len=len(waiter.tokens))
        reclaimable = (eng.arena.grantable() - pinned
                       + sum(eng.reserved_blocks(r.slot) for r in candidates))
        if reclaimable < need:
            return False
        victim = max(candidates, key=lambda r: (r.priority, r._admit_seq))
        eng.retire(victim.slot)
        telemetry.span(victim.trace_id, telemetry.PREEMPTED,
                       request_id=victim.request_id, slot=victim.slot,
                       by=waiter.request_id, tokens=len(victim.tokens))
        self.running.remove(victim)
        victim.slot = None
        victim.state = RequestState.QUEUED
        victim._queued_ts = time.perf_counter()  # re-queued: a new wait
        telemetry.span(victim.trace_id, telemetry.QUEUED,
                       request_id=victim.request_id,
                       journal_tokens=len(victim.tokens))
        victim._starved = 0
        victim.preemptions += 1
        # the walker is a pure function of the journal: rebuild it so the
        # re-admission installs the mask of the next token (the trace_id
        # stays: one timeline)
        victim.reset_constraint()
        self.waiting.append(victim)
        self.preempt_count += 1
        metrics.bump("scheduler.preemptions")
        resilience.bump("serving.preemptions")
        return True

    # --------------------------------------------------------------- step

    def _expired(self, req: Request, where: str):
        return resilience.DeadlineExceededError(
            f"{req.request_id} expired {where}")

    def _advance_prefill(self) -> bool:
        """Retire every cancelled or expired in-progress admission, then
        advance the oldest survivor by one chunk; its last chunk emits the
        first token and moves it to ``running``."""
        progress = False
        for req in list(self.prefilling):
            if req._cancel:
                self._finish(req, RequestState.CANCELLED)  # frees the slot
                progress = True
            elif req.deadline.expired():
                self._finish(req, RequestState.FAILED,
                             self._expired(req, "mid-prefill"))
                progress = True
        if not self.prefilling:
            return progress
        req = self.prefilling[0]
        try:
            first = self.engine.admit_chunk(req.slot)
            telemetry.span(req.trace_id, telemetry.PREFILL_CHUNK,
                           request_id=req.request_id, slot=req.slot,
                           done=first is not None)
        # analysis: allow(broad-except) -- classified here: a transient
        # failure re-queues the request and re-raises for the supervisor;
        # any other fails THIS request, never the pump. The engine has
        # already unwound the admission.
        except Exception as e:
            from .supervisor import is_transient_serving_error

            self.prefilling.remove(req)
            req.slot = None
            if is_transient_serving_error(e):
                req.state = RequestState.QUEUED
                self.waiting.append(req)
                raise
            self._finish(req, RequestState.FAILED, e)
            self._on_error(e)
            return True
        if first is not None:
            self.prefilling.remove(req)
            self._start(req, first)
        return True

    def step(self) -> bool:
        """One iteration: cull cancelled and expired waiters, advance one
        chunked prefill, admit in priority order while capacity allows
        (preempting under starvation), run one decode step, retire finished
        requests. Returns True if any request made progress."""
        progress = False
        for req in list(self.waiting):
            if req._cancel or req.deadline.expired():
                self.waiting.remove(req)
                if req._cancel:
                    self._finish(req, RequestState.CANCELLED)
                else:
                    self._finish(req, RequestState.FAILED,
                                 self._expired(req, "in queue"))
                progress = True
        if self.prefilling:
            progress |= self._advance_prefill()
        starve_after = int(flags.flag("serving_starvation_steps"))
        starved_this_step = False
        chunked = self.engine.chunk_size > 0
        while True:
            req = self._next_waiter()
            if req is None:
                break
            req = self._cache_preferred(req)
            if not self._can_admit(req):
                # the head is blocked on capacity: count its starvation
                # once per step, then preempt one victim per pass until it
                # fits or no strictly lower-priority victim is left
                if not starved_this_step:
                    req._starved += 1
                    starved_this_step = True
                if (starve_after > 0 and req._starved > starve_after
                        and self._preempt_for(req)):
                    progress = True
                    continue
                break
            req._starved = 0
            admit = self.engine.admit_begin if chunked else self.engine.admit
            # the request leaves ``waiting`` only once it is seated, so that
            # ``outstanding()``, read from other threads (a router's load),
            # counts it through its prefill
            try:
                slot, first = admit(req.prompt, req.max_new_tokens,
                                    tokens=req.tokens, **admit_kwargs(req))
            # analysis: allow(broad-except) -- classified here: a transient
            # failure means the engine is sick, not this request, which
            # re-queues untouched while the supervisor rebuilds; any other
            # failed prefill fails THIS request (its error is delivered
            # through its handle), never the pump. The engine has already
            # unwound the admission.
            except Exception as e:
                from .supervisor import is_transient_serving_error

                self.waiting.remove(req)
                if is_transient_serving_error(e):
                    req.state = RequestState.QUEUED
                    self.waiting.append(req)
                    raise
                self._finish(req, RequestState.FAILED, e)
                self._on_error(e)
                progress = True
                continue
            self.waiting.remove(req)
            req.slot = slot
            req.state = RequestState.RUNNING
            telemetry.observe("latency.queue_wait",
                              time.perf_counter() - req._queued_ts,
                              self._hists)
            telemetry.span(req.trace_id, telemetry.ADMITTED,
                           request_id=req.request_id, slot=slot,
                           chunked=first is None,
                           journal_tokens=len(req.tokens))
            progress = True
            if first is None:
                # chunked prefill in progress: the slot and its blocks are
                # held; it decodes once its last chunk emits a token
                self.prefilling.append(req)
            else:
                self._start(req, first)
        if self.running:
            if self.engine.spec is not None:
                # up to k tokens per slot from one speculative iteration,
                # emitted one at a time through the finish rules
                accepted = self.engine.spec_decode_step()
                for req in list(self.running):
                    for tok in accepted.get(req.slot, ()):
                        self._emit(req, int(tok))
                        if self._check_boundary(req):
                            break
            else:
                toks = self.engine.decode_step()
                for req in list(self.running):
                    self._emit(req, int(toks[req.slot]))
                    self._check_boundary(req)
            progress = True
        self._gauges()
        return progress

    def fail_all(self, error: BaseException) -> None:
        """Fail every queued and running request (shutdown): each gets its
        error, stream sentinel and done_event."""
        for req in list(self.waiting):
            self.waiting.remove(req)
            self._finish(req, RequestState.FAILED, error)
        for req in list(self.prefilling):
            self._finish(req, RequestState.FAILED, error)
        for req in list(self.running):
            self._finish(req, RequestState.FAILED, error)
        self._gauges()
        self._on_error(error)

    def _on_error(self, error: BaseException) -> None:
        if self.on_error is not None:
            self.on_error(error)

    def run_until_idle(self, max_steps: Optional[int] = None) -> None:
        """Step until no request is left; with ``max_steps``, raise
        ``RuntimeError`` once that many steps ran and work remains."""
        steps = 0
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"scheduler still busy after {max_steps} steps")
            self.step()
            steps += 1

    def _gauges(self) -> None:
        metrics.set_gauge("queue.depth", len(self.waiting))
        metrics.set_gauge("queue.prefilling", len(self.prefilling))
