"""Serving front door (counterpart of ``paddle_tpu/serving/api.py``).

:class:`ServingAPI` owns one engine and its scheduler. ``submit`` enqueues a
request and returns its handle; ``stream`` yields its tokens as they are
generated, pumping scheduler steps from the consumer's thread;
``run_until_idle`` pumps until every request has finished; ``close`` fails
whatever is still queued or running and closes the engine's step programs. The supervisor (rebuild and replay
after a device failure), queue shedding, deadlines, drain and the
``EnginePredictor`` bridge are later slices.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Iterator, Optional

from ..core import device as device_mod
from .engine import ServingConfig, ServingEngine
from .scheduler import Request, RequestState, Scheduler


class ServingAPI:
    """One served model: engine + scheduler, pumped in the foreground."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=device_mod.DEFAULT_DEVICE):
        self.engine = ServingEngine(model, config, device=device)
        self.scheduler = Scheduler(self.engine)
        # the engine serialisation point: one thread steps at a time
        self._lock = threading.RLock()
        self._closed = False

    def submit(self, prompt, max_new_tokens: int = 32,
               stop_token_id: Optional[int] = None, request_id: str = "",
               sampling=None, constraint=None) -> Request:
        """Enqueue one generation request; returns its handle at once.
        Refuses what could never be served (too long or empty).

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
            req = Request(prompt, max_new_tokens=int(max_new_tokens),
                          stop_token_id=stop_token_id,
                          request_id=request_id, sampling=sampling,
                          constraint=constraint)
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
