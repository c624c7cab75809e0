"""Engine supervisor: rebuild-and-replay recovery for the serving runtime
(counterpart of ``paddle_tpu/serving/supervisor.py:57-264``).

Each request journals what it needs to resume (``Request.prompt`` and the
emitted ``Request.tokens``), so a transient failure need not fail the
requests in flight. The API routes every pump step through
:meth:`EngineSupervisor.handle`:

1. **Classify** (:func:`is_transient_serving_error`). Transient on the
   H100: the two injected classes, ``core.resilience.ServingDeviceError``
   and ``core.resilience.ArenaCorruptError``, and ``torch.OutOfMemoryError``
   (the caching allocator's failure, which leaves the context usable: the
   counterpart of XLA's RESOURCE_EXHAUSTED, which the JAX classifier takes
   as transient). Fatal: every other error, and every other error of the
   CUDA runtime in particular. An illegal address or a launch failure
   leaves a sticky error that poisons the context for the life of the
   process; a rebuild in the same process cannot clear it and a replay
   would only fail again, so the supervisor fails fast on it.
2. **Rebuild** (``ServingEngine.rebuild``): in place, unlike the JAX
   engine, whose programs depend only on shapes. The captured graphs hold
   the pools' addresses, so the pools are zeroed and kept, the host
   bookkeeping and every slot start over, the prefix tree is replaced, and
   no program is built again.
3. **Replay**: every live request is prefilled again from its journal
   (``engine.admit(prompt, max_new, tokens=...)``, one-shot even under
   chunked prefill) and emits the journal's next token, leaving its slot
   where an uninterrupted decode would be: the same tokens, greedy or
   seeded (keys are positional; the walker is a function of the journal).
   A replay of ``prompt + journal`` may fall in a prefill bucket not yet
   captured; its first admission captures it then, a new key, not a
   rebuilt one. Each replay re-admits with the request's own scenario
   (sampling, constraint mask and adapter id: ``scheduler.admit_kwargs``;
   the adapter arena keeps its rows through the rebuild). With the prefix
   cache on, the replays re-insert their prompts' blocks into the fresh
   tree and share them again; with the tiered KV cache their walks find
   the prefixes spilled before the fault in the tier, which the rebuild
   keeps, and restore them instead of prefilling them. With
   speculation on, each replay's admission prefills its draft cache again
   over ``prompt + journal`` (``paddle_tpu/serving/supervisor.py:178``), so
   a fault in the middle of a verify replays to the same streams.
4. **Break the crash loop**: ``FLAGS_serving_max_rebuilds`` rebuilds within
   ``FLAGS_serving_rebuild_window`` scheduler steps open the breaker; later
   transient failures fail fast with :class:`CrashLoopError`.

Counters: ``serving.rebuilds`` / ``serving.replays`` (``core.resilience``),
mirrored as ``supervisor.rebuilds`` / ``supervisor.replays``
(``serving.metrics``); each replay emits a REPLAYED span on the request's
own ``trace_id``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core import flags, resilience
from . import metrics, telemetry
from .scheduler import RequestState, _seq_counter, admit_kwargs


class CrashLoopError(RuntimeError):
    """The crash-loop breaker is open: too many engine rebuilds in too few
    steps. The transient error is chained as ``__cause__``; in-flight
    requests fail fast with this error instead of replaying into a device
    that keeps failing."""


#: error classes the supervisor recovers by rebuild and replay
TRANSIENT_ERRORS = (resilience.ServingDeviceError,
                    resilience.ArenaCorruptError,
                    torch.OutOfMemoryError)


def is_transient_serving_error(exc: BaseException) -> bool:
    """True when a step or prefill failure is worth a rebuild and replay:
    the injected ``serving_device`` / ``arena_corrupt`` classes and an
    allocation failure. Everything else keeps the fail-fast path: bugs,
    validation, deadlines, interrupts, and any other CUDA runtime error
    (sticky: it poisons the context, and no rebuild in this process
    clears it)."""
    return isinstance(exc, TRANSIENT_ERRORS)


class EngineSupervisor:
    """Recovery policy for one engine and scheduler. :meth:`handle`
    returning True means the engine was rebuilt and every live request
    replayed: the pump goes on."""

    def __init__(self, engine, scheduler,
                 max_rebuilds: Optional[int] = None,
                 window: Optional[int] = None):
        self.engine = engine
        self.scheduler = scheduler
        self.max_rebuilds = int(flags.flag("serving_max_rebuilds")
                                if max_rebuilds is None else max_rebuilds)
        self.window = int(flags.flag("serving_rebuild_window")
                          if window is None else window)
        self._steps = 0  # successful scheduler steps (the breaker's clock)
        self._rebuild_steps: List[int] = []
        self.breaker_open = False
        # lifetime totals of this engine stack (the metrics counters are
        # process-global)
        self.rebuild_count = 0
        self.replay_count = 0

    def note_step(self) -> None:
        """Called by the pump after each successful scheduler step: the
        breaker's window is measured in steps of progress."""
        self._steps += 1

    def wrap(self, error: BaseException) -> BaseException:
        """The error to fail requests with when recovery was declined: a
        transient error meeting an open breaker becomes a
        :class:`CrashLoopError`; anything else passes through."""
        if self.breaker_open and is_transient_serving_error(error):
            wrapped = CrashLoopError(
                f"serving supervisor crash-loop breaker open: "
                f"{len(self._rebuild_steps)} engine rebuilds within "
                f"{self.window} steps (FLAGS_serving_max_rebuilds="
                f"{self.max_rebuilds}); failing fast on: {error!r}")
            wrapped.__cause__ = error
            return wrapped
        return error

    def handle(self, error: BaseException) -> bool:
        """Recover from ``error`` if it is transient and the breaker allows:
        rebuild the engine and replay every live request. False means the
        caller must fail fast (:meth:`wrap` gives the error), also when the
        breaker ran out in the middle of a recovery."""
        if not is_transient_serving_error(error):
            return False
        if not self._allow_rebuild():
            return False
        return self._recover()

    def _allow_rebuild(self) -> bool:
        """Breaker bookkeeping for one rebuild: prune rebuilds that aged out
        of the window, open the breaker when the budget is spent, else
        record this one and allow it."""
        if self.breaker_open:
            return False
        self._rebuild_steps = [s for s in self._rebuild_steps
                               if self._steps - s < self.window]
        if len(self._rebuild_steps) >= self.max_rebuilds:
            self.breaker_open = True
            return False
        self._rebuild_steps.append(self._steps)
        return True

    def _recover(self) -> bool:
        """Rebuild and prefill every live request again from prompt and
        journal. Chunked admissions in progress died with the arena too:
        they replay through one-shot ``admit``. If recovery itself raises,
        every request still staged is failed before the error propagates:
        none is left without a slot and with its done_event unset."""
        sched = self.scheduler
        pending = list(sched.running) + list(sched.prefilling)
        sched.running.clear()
        sched.prefilling.clear()
        for req in pending:
            req.slot = None  # the old slot numbers die with the arena
        try:
            return self._rebuild_and_replay(pending)
        # analysis: allow(broad-except) -- any replay failure must fail the
        # staged requests (done_event and sentinel), never strand them
        except Exception as e:
            for req in list(pending):
                sched._finish(req, RequestState.FAILED, e)
            raise
        finally:
            sched._gauges()

    def _rebuild_and_replay(self, pending) -> bool:
        # mutates ``pending`` in place, so that _recover fails exactly the
        # requests still staged if this raises
        sched = self.scheduler
        while True:
            self.engine.rebuild()
            self.rebuild_count += 1
            metrics.bump("supervisor.rebuilds")
            resilience.bump("serving.rebuilds")
            died_again: Optional[BaseException] = None
            for req in list(pending):
                try:
                    slot, nxt = self.engine.admit(req.prompt,
                                                  req.max_new_tokens,
                                                  tokens=req.tokens,
                                                  **admit_kwargs(req))
                # analysis: allow(broad-except) -- classified here: a
                # transient error restarts the replay, any other fails its
                # request alone
                except Exception as e:
                    if is_transient_serving_error(e):
                        died_again = e
                        break
                    pending.remove(req)
                    sched._finish(req, RequestState.FAILED, e)
                    continue
                pending.remove(req)
                req.slot = slot
                req._admit_seq = next(_seq_counter)
                sched.running.append(req)
                # REPLAYED before the replayed token's emit, on the trace
                # the request carried since submit
                telemetry.span(req.trace_id, telemetry.REPLAYED,
                               request_id=req.request_id, slot=slot,
                               journal_tokens=len(req.tokens),
                               rebuilds=self.rebuild_count)
                sched._emit(req, nxt)
                self.replay_count += 1
                metrics.bump("supervisor.replays")
                resilience.bump("serving.replays")
                sched._check_boundary(req)  # the replayed token may end it
            if died_again is None:
                return True
            # every slot replayed so far sits in the arena that just
            # failed: retire it (host bookkeeping: frees the slot and its
            # reservation, so the breaker's exhaustion leaks nothing) and
            # stage the request again, then let the breaker decide
            for req in list(sched.running):
                self.engine.retire(req.slot)
                req.slot = None
                pending.append(req)
            sched.running.clear()
            if not self._allow_rebuild():
                err = self.wrap(died_again)
                for req in list(pending):
                    pending.remove(req)
                    sched._finish(req, RequestState.FAILED, err)
                return False
