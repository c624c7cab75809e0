"""Serving front door (counterpart of ``paddle_tpu/serving/api.py``).

:class:`ServingAPI` owns one engine and its scheduler. ``submit`` applies
queue-overload shedding (``core.resilience.check_overload`` at
``FLAGS_serving_max_queue``), attaches the request's wall-clock deadline and
priority class (lower is served first) and an optional token journal, then
enqueues it and returns its handle; ``stream`` yields its tokens as they are
generated, pumping scheduler steps from the consumer's thread;
``run_until_idle`` pumps until every request has finished; ``close`` fails
whatever is still queued or running and closes the engine's step programs.
The supervisor (rebuild and replay after a device failure), drain and the
``EnginePredictor`` bridge are later slices.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Iterator, Optional, Sequence

from ..core import device as device_mod
from ..core import resilience
from . import metrics
from .engine import ServingConfig, ServingEngine
from .scheduler import Request, RequestState, Scheduler


class ServingAPI:
    """One served model: engine + scheduler, pumped in the foreground."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=device_mod.DEFAULT_DEVICE,
                 max_queue: Optional[int] = None):
        self.engine = ServingEngine(model, config, device=device)
        self.scheduler = Scheduler(self.engine)
        self._max_queue = max_queue  # None defers to the flag
        # the engine serialisation point: one thread steps at a time
        self._lock = threading.RLock()
        self._closed = False

    def submit(self, prompt, max_new_tokens: int = 32,
               stop_token_id: Optional[int] = None,
               timeout: Optional[float] = None, request_id: str = "",
               priority: int = 0, journal: Optional[Sequence[int]] = None,
               shed: bool = True, sampling=None,
               constraint=None) -> Request:
        """Enqueue one generation request; returns its handle at once.
        Refuses what could never be served (too long or empty).

        ``timeout`` is the request's end-to-end wall-clock deadline (queue
        wait included): an expired request fails with
        ``DeadlineExceededError``, in the queue or mid-decode, and frees
        its slot. ``priority`` follows the vLLM convention: lower values
        are served first, 0 is normal traffic (FCFS within a class). Raises
        ``QueueOverloadError`` (counted in ``requests.shed``) when the
        waiting queue is at the shedding limit; ``shed=False`` bypasses it
        for work that was already accepted once.

        ``journal`` seeds the request's token journal: admission prefills
        ``prompt + journal`` and decoding resumes at the journal's next
        token. The journal counts toward ``max_new_tokens`` (one that
        exhausts it is refused), and only tokens past it are streamed.

        ``sampling`` (a :class:`~.sampling.SamplingParams`; None is greedy)
        and ``constraint`` (a :class:`~.constrain.Constraint` walker that
        masks the vocabulary at each step) select the request's decode
        scenario. Both are per-slot data in the one decode step: mixing
        them across a batch builds no program. A seed left unset is drawn
        once, here; the same seed, prompt and params give the same
        tokens."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingAPI is closed")
            if shed:
                try:
                    resilience.check_overload(len(self.scheduler.waiting),
                                              self._max_queue, name="serving")
                except resilience.QueueOverloadError:
                    metrics.bump("requests.shed")
                    raise
            req = Request(prompt, max_new_tokens=int(max_new_tokens),
                          stop_token_id=stop_token_id,
                          request_id=request_id, priority=priority,
                          sampling=sampling, constraint=constraint,
                          deadline=resilience.Deadline.after(timeout))
            if journal:
                if len(journal) >= int(max_new_tokens):
                    raise ValueError(
                        f"journal of {len(journal)} tokens already exhausts "
                        f"max_new_tokens={max_new_tokens}; nothing to resume")
                req.tokens = [int(t) for t in journal]
                # the walker never saw the journal's tokens
                req.reset_constraint()
            return self.scheduler.submit(req)

    def stream(self, req: Request) -> Iterator[int]:
        """Yield ``req``'s tokens as they are generated; raises the
        request's error at the end of a failed stream."""
        while True:
            try:
                tok = req.stream_queue.get_nowait()
            except _queue.Empty:
                if req.done_event.is_set():
                    break
                self._pump_once()
                continue
            if tok is None:  # finish sentinel
                break
            yield tok
        if req.state == RequestState.FAILED and req.error is not None:
            raise req.error

    def run_until_idle(self) -> None:
        with self._lock:
            self.scheduler.run_until_idle()

    def close(self) -> None:
        """Fail every request still queued or running, then close the
        engine's step programs (on CUDA their graphs and pool, so that work
        after serving gets the memory back); idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.scheduler.fail_all(RuntimeError("ServingAPI is closed"))
            self.engine.close()

    def _pump_once(self) -> None:
        with self._lock:
            if self.scheduler.has_work():
                self.scheduler.step()
