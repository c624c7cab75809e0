"""Iteration-level (continuous) batching scheduler (counterpart of
``paddle_tpu/serving/scheduler.py``).

Between any two decode steps the scheduler retires finished requests and
admits waiting ones into the freed slots:

* **FCFS admission with capacity gating**: the oldest waiting request is
  admitted when a slot is free AND the KV arena can reserve its worst-case
  block budget (``ServingEngine.can_admit``), so a running request is never
  starved of cache mid-decode. Nothing jumps a blocked head.
* **Finish rules** at every step boundary: the stop token, the token budget
  and cancellation.
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

Priorities, preemption, speculation and deadlines are later slices. Served
tokens are held token for token against ``GPTForCausalLM.generate()``,
with ``sampling=`` for sampled requests.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import metrics

_req_counter = itertools.count()


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
    ``stream_queue``/``done_event`` are what ``ServingAPI.stream`` reads."""

    prompt: np.ndarray
    max_new_tokens: int = 32
    stop_token_id: Optional[int] = None
    request_id: str = ""
    # the request's scenario: sampling params (serving.sampling.
    # SamplingParams; None is greedy) and an incremental decoding
    # constraint (serving.constrain.Constraint), whose walker state
    # `_cstate` is a pure function of `tokens`
    sampling: Optional[object] = None
    constraint: Optional[object] = None
    state: str = RequestState.QUEUED
    tokens: List[int] = field(default_factory=list)
    error: Optional[BaseException] = None
    slot: Optional[int] = None
    stream_queue: "_queue.SimpleQueue" = field(
        default_factory=_queue.SimpleQueue)
    done_event: threading.Event = field(default_factory=threading.Event)
    _cancel: bool = False

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int64).reshape(-1)
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
    """The engine-admission keywords of one request's scenario: its
    sampling params and its walker's current mask."""
    return {"sampling": req.sampling, "mask": req.allowed_mask()}


class Scheduler:
    """Drives one :class:`ServingEngine` at iteration granularity. Not
    thread-safe by itself: ``ServingAPI`` serialises access."""

    def __init__(self, engine):
        self.engine = engine
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.prefilling: List[Request] = []  # chunked prefills in progress

    def submit(self, request: Request) -> Request:
        """Enqueue; what could never be served is refused here."""
        self.engine.validate(int(request.prompt.shape[0]),
                             int(request.max_new_tokens))
        request.state = RequestState.QUEUED
        self.waiting.append(request)
        metrics.bump("requests.submitted")
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
        req.stream_queue.put(None)  # stream sentinel
        req.done_event.set()

    def _emit(self, req: Request, token: int) -> None:
        if req.finished:
            return  # its walker failed earlier in this step
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
        """Finish rules at a step boundary; True if the request ended."""
        if req._cancel:
            self._finish(req, RequestState.CANCELLED)
            return True
        stop = req.stop_token_id
        if req.tokens and ((stop is not None and req.tokens[-1] == stop)
                           or len(req.tokens) >= req.max_new_tokens):
            self._finish(req, RequestState.FINISHED)
            return True
        return False

    def _start(self, req: Request, first: int) -> None:
        """The request's prefill is done: it decodes from the next step."""
        self.running.append(req)
        self._emit(req, first)
        self._check_boundary(req)  # may retire at once (stop/budget)

    def _advance_prefill(self) -> bool:
        """Retire every cancelled in-progress admission, then advance the
        oldest survivor by one chunk; its last chunk emits the first token
        and moves it to ``running``."""
        progress = False
        for req in list(self.prefilling):
            if req._cancel:
                self._finish(req, RequestState.CANCELLED)  # frees the slot
                progress = True
        if not self.prefilling:
            return progress
        req = self.prefilling[0]
        try:
            first = self.engine.admit_chunk(req.slot)
        # analysis: allow(broad-except) -- a failed chunk fails THIS
        # request, never the pump; the engine has already unwound it
        except Exception as e:
            self.prefilling.remove(req)
            req.slot = None
            self._finish(req, RequestState.FAILED, e)
            return True
        if first is not None:
            self.prefilling.remove(req)
            self._start(req, first)
        return True

    def step(self) -> bool:
        """One iteration: cull cancelled waiters, advance one chunked
        prefill, admit in FCFS order while capacity allows, run one decode
        step, retire finished requests. Returns True if any request made
        progress."""
        progress = False
        for req in list(self.waiting):
            if req._cancel:
                self.waiting.remove(req)
                self._finish(req, RequestState.CANCELLED)
                progress = True
        if self.prefilling:
            progress |= self._advance_prefill()
        chunked = self.engine.chunk_size > 0
        while self.waiting:
            req = self.waiting[0]
            if not self.engine.can_admit(int(req.prompt.shape[0]),
                                         int(req.max_new_tokens)):
                break
            self.waiting.pop(0)
            admit = self.engine.admit_begin if chunked else self.engine.admit
            try:
                slot, first = admit(req.prompt, req.max_new_tokens,
                                    **admit_kwargs(req))
            # analysis: allow(broad-except) -- a failed prefill fails THIS
            # request (its error is delivered through its handle), never the
            # pump; the engine has already unwound the admission
            except Exception as e:
                self._finish(req, RequestState.FAILED, e)
                progress = True
                continue
            req.slot = slot
            req.state = RequestState.RUNNING
            progress = True
            if first is None:
                # chunked prefill in progress: the slot and its blocks are
                # held; it decodes once its last chunk emits a token
                self.prefilling.append(req)
            else:
                self._start(req, first)
        if self.running:
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

    def run_until_idle(self) -> None:
        while self.has_work():
            self.step()

    def _gauges(self) -> None:
        metrics.set_gauge("queue.depth", len(self.waiting))
        metrics.set_gauge("queue.prefilling", len(self.prefilling))
