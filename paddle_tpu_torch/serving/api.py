"""Serving front door (counterpart of ``paddle_tpu/serving/api.py``):
``submit`` / ``stream`` / ``result`` / ``cancel`` / ``drain``.

A thread-safe policy shell over the engine, scheduler and supervisor:

* **submit** applies queue-overload shedding (``core.resilience.
  check_overload`` at ``FLAGS_serving_max_queue``), attaches the request's
  wall-clock deadline, priority class (lower is served first) and an
  optional token journal, emits its SUBMITTED span and returns its handle.
* **stream** yields tokens as they are generated. In the foreground
  (default) the consumer's iteration pumps scheduler steps; with
  ``background=True`` a pump thread drives the engine and streams only
  read queues. **result** blocks until a request ends and returns prompt
  plus tokens; **cancel** flags a request, and the scheduler frees its
  slot at the next step boundary (a queued request never costs a prefill);
  **outstanding** counts waiting, prefilling and running requests.
* **supervision**: every pump step goes through
  :class:`.supervisor.EngineSupervisor`. A transient failure rebuilds the
  engine in place and replays the requests in flight from their journals;
  any other error fails them all; the crash-loop breaker degrades to
  :class:`.supervisor.CrashLoopError`.
* **drain**: ``drain(grace)`` stops admissions, pumps the requests in
  flight within ``grace`` seconds, then fails the stragglers with the
  retriable ``core.resilience.RequestDrainedError``. ``close()`` goes
  through ``drain(grace=0)`` and then closes the engine's step programs;
  ``bind_preemption_guard`` turns SIGTERM/SIGINT (or the ``preempt``
  fault) into a drain at the next step boundary. :func:`drain_all` drains
  every live API, and runs at interpreter exit.

Every engine call of every thread runs on the engine's one stream
(``graphs.StepGraphs.on_stream``) and under the API lock: one thread steps
at a time, and a busy pump lets a waiting caller in between two steps. A
background pump may capture a step program while the caller's thread does
its own CUDA work: captures run in ``"thread_local"`` error mode
(``serving/graphs.py``).

:meth:`ServingAPI.register_adapter` / :meth:`ServingAPI.unregister_adapter`
manage the engine's LoRA adapter rows under the API lock, between two
steps; ``submit(adapter=)`` names one. :class:`EnginePredictor`
(``paddle_tpu/serving/api.py:505``) gives the ``paddle.inference``
predictor surface a continuous-batching backend: one request per row of a
batch, under one adapter. ``prefetch`` comes with the gateway slice.
"""
from __future__ import annotations

import atexit
import contextlib
import logging
import queue as _queue
import threading
import time
import weakref
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..core import device as device_mod
from ..core import flags, resilience
from . import metrics, telemetry
from .engine import ServingConfig, ServingEngine
from .scheduler import Request, RequestState, Scheduler
from .supervisor import EngineSupervisor

_logger = logging.getLogger("paddle_tpu_torch.serving")

#: every live ServingAPI, so that process-level shutdown can drain them all
_live_apis: "weakref.WeakSet" = weakref.WeakSet()


def drain_all(grace: float = 0.0) -> int:
    """Drain every live :class:`ServingAPI` that is neither closed nor
    draining already; returns how many were drained."""
    n = 0
    for api in list(_live_apis):
        if not api._closed and not api._draining:
            api.drain(grace)
            n += 1
    return n


@atexit.register
def _drain_at_exit() -> None:  # pragma: no cover - interpreter shutdown
    """Interpreter shutdown never strands a request mid-decode: every API
    still live is drained with zero grace (admissions stop, the requests
    in flight fail with the retriable ``RequestDrainedError``, every
    done_event fires). A drain makes no device call, so a live CUDA
    context is never touched here; APIs already closed or draining are
    skipped."""
    try:
        drain_all(grace=0.0)
    # analysis: allow(broad-except) -- shutdown epilogue: must never turn a
    # clean exit into a traceback
    except Exception:
        pass


class ServingAPI:
    """One served model: engine, scheduler, supervisor and, with
    ``background=True``, a pump thread."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=device_mod.DEFAULT_DEVICE,
                 max_queue: Optional[int] = None, background: bool = False):
        self.engine = ServingEngine(model, config, device=device)
        self.scheduler = Scheduler(self.engine)
        self.supervisor = EngineSupervisor(self.engine, self.scheduler)
        self._max_queue = max_queue  # None defers to the flag
        # the engine serialisation point: one thread steps at a time
        self._lock = threading.RLock()
        # callers waiting for the lock, whom a busy pump lets in
        self._waiters = 0
        self._waiters_lock = threading.Lock()
        self._closed = False
        self._draining = False
        self.drain_count = 0  # this API's lifetime drains
        self._guard = None
        self._guard_grace: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        _live_apis.add(self)
        if background:
            self._thread = threading.Thread(target=self._pump_loop,
                                            name="serving-pump", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- public

    def submit(self, prompt, max_new_tokens: int = 32,
               stop_token_id: Optional[int] = None,
               timeout: Optional[float] = None, request_id: str = "",
               priority: int = 0, journal: Optional[Sequence[int]] = None,
               shed: bool = True, sampling=None, constraint=None,
               adapter: int = 0, trace_id: str = "") -> Request:
        """Enqueue one generation request; returns its handle at once.
        Refuses what could never be served (too long or empty).

        ``timeout`` is the request's end-to-end wall-clock deadline (queue
        wait included): an expired request fails with
        ``DeadlineExceededError``, in the queue or mid-decode, and frees
        its slot. ``priority`` follows the vLLM convention: lower values
        are served first, 0 is normal traffic (FCFS within a class). Raises
        ``QueueOverloadError`` (counted in ``requests.shed``) when the
        waiting queue is at the shedding limit; ``shed=False`` bypasses it
        for work that was already accepted once. During a drain it raises
        the retriable ``RequestDrainedError``.

        ``journal`` seeds the request's token journal: admission prefills
        ``prompt + journal`` and decoding resumes at the journal's next
        token. The journal counts toward ``max_new_tokens`` (one that
        exhausts it is refused), and only tokens past it are streamed.

        ``sampling`` (a :class:`~.sampling.SamplingParams`; None is greedy)
        and ``constraint`` (a :class:`~.constrain.Constraint` walker that
        masks the vocabulary at each step) and ``adapter`` (a row id
        :meth:`register_adapter` returned; 0 is the base model) select the
        request's decode scenario. All three are per-slot data in the one
        decode step: mixing them across a batch builds no program. A seed
        left unset is drawn once, here; the same seed, prompt and params
        give the same tokens. An adapter that is not registered is refused
        here.

        ``trace_id`` carries an existing lifecycle trace onto the request;
        empty mints one and emits its SUBMITTED span here."""
        with self._locked():
            # checked under the lock: a submit racing drain() or close()
            # must never enqueue after the straggler sweep
            if self._closed:
                raise RuntimeError("ServingAPI is closed")
            if self._draining:
                raise resilience.RequestDrainedError(
                    "ServingAPI is draining: admissions are stopped; "
                    "resubmit to another instance")
            if shed:
                try:
                    resilience.check_overload(len(self.scheduler.waiting),
                                              self._max_queue, name="serving")
                except resilience.QueueOverloadError:
                    metrics.bump("requests.shed")
                    raise
            minted = not trace_id
            req = Request(prompt, max_new_tokens=int(max_new_tokens),
                          stop_token_id=stop_token_id,
                          request_id=request_id, priority=priority,
                          sampling=sampling, constraint=constraint,
                          adapter_id=int(adapter), trace_id=trace_id,
                          deadline=resilience.Deadline.after(timeout))
            if minted:
                telemetry.span(req.trace_id, telemetry.SUBMITTED,
                               request_id=req.request_id,
                               prompt_tokens=int(req.prompt.shape[0]),
                               max_new_tokens=int(max_new_tokens))
            if journal:
                if len(journal) >= int(max_new_tokens):
                    raise ValueError(
                        f"journal of {len(journal)} tokens already exhausts "
                        f"max_new_tokens={max_new_tokens}; nothing to resume")
                req.tokens = [int(t) for t in journal]
                # the walker never saw the journal's tokens
                req.reset_constraint()
            return self.scheduler.submit(req)

    def register_adapter(self, adapter, name: Optional[str] = None) -> int:
        """Write a :class:`~.adapters.LoraAdapter` into a free row of the
        engine's adapter arena; returns the id requests pass as
        ``adapter=``. The rows are written in place between two steps:
        nothing is built again. The engine needs ``lora_rank`` > 0."""
        lora = self.engine.lora
        if lora is None:
            raise RuntimeError("this engine has no adapter arena "
                               "(FLAGS_serving_lora_rank is 0)")
        with self._locked():
            return lora.register(adapter, name=name)

    def unregister_adapter(self, adapter) -> None:
        """Free one adapter row (by id or name). Refused while any request,
        running, prefilling or still queued, names it: the arena's own
        guard sees occupied slots only, and a queued request would
        otherwise be admitted onto a freed row, or one recycled to another
        adapter."""
        lora = self.engine.lora
        if lora is None:
            raise RuntimeError("this engine has no adapter arena "
                               "(FLAGS_serving_lora_rank is 0)")
        with self._locked():
            idx = (lora.adapter_id(adapter) if isinstance(adapter, str)
                   else int(adapter))
            sched = self.scheduler
            worn = [r.request_id for r in (sched.waiting + sched.prefilling
                                           + sched.running)
                    if r.adapter_id == idx]
            if worn:
                raise RuntimeError(
                    f"adapter {adapter!r} (id {idx}) is named by "
                    f"in-flight/queued request(s) {worn[:4]}; let them "
                    "finish (or cancel them) before unregistering")
            lora.unregister(idx)

    def outstanding(self) -> int:
        """Waiting + prefilling + running requests: committed work, a
        router's least-outstanding signal."""
        sched = self.scheduler
        return len(sched.waiting) + len(sched.prefilling) + len(sched.running)

    def prefetch(self, prompt, trace_id: str = "", adapter: int = 0) -> int:
        """Restore-ahead: :meth:`ServingEngine.prefetch` of ``prompt``'s
        chain under ``adapter``'s root, between two pump steps (under the
        API lock; the restore runs on the engine's stream). A closed or
        draining API declines and returns 0."""
        with self._locked():
            if self._closed or self._draining:
                return 0
            return self.engine.prefetch(prompt, trace_id=trace_id,
                                        adapter=adapter)

    def stream(self, req: Request) -> Iterator[int]:
        """Yield ``req``'s tokens as they are generated; raises the
        request's error at the end of a failed stream."""
        while True:
            try:
                tok = req.stream_queue.get_nowait()
            except _queue.Empty:
                if req.done_event.is_set():
                    break
                if self._thread is None:
                    self._pump_once()
                else:
                    time.sleep(0.001)
                continue
            if tok is None:  # finish sentinel (always the queue's last)
                break
            yield tok
        if req.state == RequestState.FAILED and req.error is not None:
            raise req.error

    def cancel(self, req: Request) -> None:
        """Flag ``req``; its slot and blocks are freed at the next step
        boundary (in the foreground, pumped here at once)."""
        req.cancel()
        if self._thread is None:
            self._pump_once()

    def result(self, req: Request, timeout: Optional[float] = None
               ) -> np.ndarray:
        """Block until ``req`` ends; returns prompt + generated ids. Raises
        the request's error if it failed, ``RuntimeError`` if it was
        cancelled, ``DeadlineExceededError`` past ``timeout`` seconds."""
        if self._thread is None:
            deadline = resilience.Deadline.after(timeout)
            while not req.finished:
                deadline.check(f"result({req.request_id})")
                self._pump_once()
        elif not req.done_event.wait(timeout):
            raise resilience.DeadlineExceededError(
                f"result({req.request_id}) timed out")
        if req.state == RequestState.FAILED:
            raise req.error
        if req.state == RequestState.CANCELLED:
            raise RuntimeError(f"{req.request_id} was cancelled")
        return req.output_ids()

    def run_until_idle(self) -> None:
        """Pump until no request is left (or a bound guard drains)."""
        while True:
            if self._check_guard():
                return
            with self._locked():
                if not self.scheduler.has_work():
                    return
                # analysis: allow(blocking-call-in-lock) -- the API lock
                # is the engine serialisation point: one thread steps
                self._step_guarded()

    # ------------------------------------------------------ drain / close

    def drain(self, grace: Optional[float] = None,
              reason: str = "serving drain") -> None:
        """Stop admissions at once (``submit`` raises the retriable
        ``RequestDrainedError``), pump the accepted work to completion
        within ``grace`` seconds (default ``FLAGS_serving_drain_grace``),
        then fail the stragglers with the same retriable error. Idempotent.
        Counters: ``serving.drains`` / ``serving.drain_stragglers``
        (``core.resilience``), ``api.drains`` / ``api.drain_stragglers``
        (``serving.metrics``)."""
        if grace is None:
            grace = float(flags.flag("serving_drain_grace"))
        grace = max(0.0, float(grace))
        with self._locked():
            if self._draining:
                return
            self._draining = True
        self.drain_count += 1
        resilience.bump("serving.drains")
        metrics.bump("api.drains")
        deadline = resilience.Deadline.after(grace)
        # with a background pump the thread steps and the drain waits; in
        # the foreground (or from the pump thread itself, through a bound
        # guard) the drain pumps here
        own_pump = (self._thread is None
                    or threading.current_thread() is self._thread)
        while grace > 0 and not deadline.expired():
            with self._locked():
                if not self.scheduler.has_work():
                    break
                if own_pump:
                    try:
                        # analysis: allow(blocking-call-in-lock) -- the
                        # drain pumps under the serialisation lock
                        self._step_guarded()
                    # analysis: allow(broad-except) -- a failed step has
                    # already failed every request with its own error:
                    # nothing is left to pump
                    except Exception:
                        break
            if not own_pump:
                time.sleep(0.001)
        self._fail_stragglers(grace, reason)

    def _fail_stragglers(self, grace: float, reason: str) -> None:
        with self._locked():
            sched = self.scheduler
            left = sched.waiting + sched.prefilling + sched.running
            if not left:
                return
            for req in left:
                # DRAINED precedes the FAILED span fail_all emits
                telemetry.span(req.trace_id, telemetry.DRAINED,
                               request_id=req.request_id, reason=reason)
            sched.fail_all(resilience.RequestDrainedError(
                f"{reason}: request drained before completion "
                f"(grace={grace:g}s); safe to resubmit"))
            resilience.bump("serving.drain_stragglers", len(left))
            metrics.bump("api.drain_stragglers", len(left))

    def close(self) -> None:
        """Shut down through :meth:`drain` with zero grace, stop the pump
        thread, then close the engine's step programs (on CUDA their graphs
        and pool, so that work after serving gets the memory back; later
        model calls raise). Idempotent, and never fails a request twice."""
        if self._closed:
            return
        self.drain(grace=0.0, reason="ServingAPI is closed")
        # a drain already in flight (a guard's, with a long grace) made the
        # call above return at once: close still owes its zero grace
        self._fail_stragglers(0.0, "ServingAPI is closed")
        with self._locked():
            self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._locked():
            self.engine.close()

    def paused(self):
        """Context in which no scheduler step runs: the caller holds the
        engine lock (a busy background pump lets it in between two steps),
        so what it reads or changes sits at one step boundary."""
        return self._locked()

    def bind_preemption_guard(self, guard,
                              grace: Optional[float] = None) -> "ServingAPI":
        """SIGTERM/SIGINT (or an injected ``preempt`` fault) drains this API
        instead of killing it mid-decode: the pump polls
        ``guard.requested()`` at step boundaries; once requested,
        admissions stop and the requests in flight get ``grace`` (default
        ``FLAGS_serving_drain_grace``) to finish. Returns ``self``."""
        self._guard = guard
        self._guard_grace = grace
        return self

    # ------------------------------------------------------------ pumping

    @contextlib.contextmanager
    def _locked(self):
        """The API lock for a caller. A Python lock is not fair: a busy
        background pump releases it between two steps and takes it back
        before a waiting caller wakes, step after step, so a caller
        announces itself and the pump waits until it holds the lock."""
        with self._waiters_lock:
            self._waiters += 1
        try:
            self._lock.acquire()
        finally:
            with self._waiters_lock:
                self._waiters -= 1
        try:
            yield
        finally:
            self._lock.release()

    def _check_guard(self) -> bool:
        """Poll the bound guard at a pump boundary: a pending preemption
        becomes a drain, never a kill mid-step."""
        g = self._guard
        if g is None or self._draining or not g.requested():
            return False
        metrics.bump("api.guard_drains")
        self.drain(self._guard_grace,
                   reason=f"preemption requested ({g.reason or 'signal'})")
        return True

    def _pump_once(self) -> None:
        if self._check_guard():
            return
        with self._locked():
            if self.scheduler.has_work():
                # analysis: allow(blocking-call-in-lock) -- the API lock
                # is the engine serialisation point (foreground pump)
                self._step_guarded()

    def _step_guarded(self) -> None:
        # the caller holds the lock. One supervised scheduler step: a
        # transient failure is recovered by rebuild and replay and the pump
        # goes on; anything else fails every request in flight (error,
        # sentinel, done_event) before it propagates, so no request is
        # stranded RUNNING holding a slot and blocks
        try:
            self.scheduler.step()
            self.supervisor.note_step()
        # analysis: allow(broad-except) -- THE classification point: the
        # supervisor decides transient or fatal for every step error
        except Exception as e:
            try:
                recovered = self.supervisor.handle(e)
            # analysis: allow(broad-except) -- a recovery that fails in any
            # way must fail the staged requests, never strand them
            except Exception as e2:
                self.scheduler.fail_all(e2)
                raise e2 from e
            if recovered:
                metrics.bump("api.recoveries")
                return
            err = self.supervisor.wrap(e)
            self.scheduler.fail_all(err)
            if err is e:
                raise
            raise err

    def _pump_loop(self) -> None:
        while not self._closed:
            self._check_guard()
            with self._lock:
                busy = self.scheduler.has_work() and not self._closed
                if busy:
                    try:
                        # analysis: allow(blocking-call-in-lock) -- the API
                        # lock is the engine serialisation point (the pump
                        # thread)
                        self._step_guarded()
                    # analysis: allow(broad-except) -- the pump thread must
                    # not die: _step_guarded already failed every request
                    # in flight (done_event and sentinel); later requests
                    # get their errors through their own handles
                    except Exception:
                        pass
            while self._waiters and not self._closed:
                time.sleep(0.0001)  # a caller takes the lock first
            if not busy:
                time.sleep(0.001)


class EnginePredictor:
    """The ``paddle.inference`` predictor surface over the serving engine
    (``paddle_tpu/serving/api.py:505``).

    The input ``input_ids`` is an int32 ``[batch, prompt_len]`` array;
    ``run`` submits one request per row and batches them continuously
    through the slot engine. The output ``output_0`` is ``[batch,
    prompt_len + max_new_tokens]`` with the positions after a stop token
    filled with it (0 without one): ``GPTForCausalLM.generate(
    stop_token_id=...)``'s contract. ``priority`` (the constructor's
    default, overridable per ``run``) rides the scheduler's priority
    admission; every row decodes with ``sampling`` and the adapter row
    ``adapter`` (0: the base model; register it on ``self._api`` first)."""

    def __init__(self, model, max_new_tokens: int = 32,
                 stop_token_id: Optional[int] = None, priority: int = 0,
                 sampling=None, adapter: int = 0,
                 config: Optional[ServingConfig] = None,
                 device=device_mod.DEFAULT_DEVICE,
                 max_queue: Optional[int] = None):
        self._api = ServingAPI(model, config, device=device,
                               max_queue=max_queue)
        self._max_new = int(max_new_tokens)
        self._stop = stop_token_id
        self._priority = int(priority)
        self._sampling = sampling  # SamplingParams of every row (None: greedy)
        self._adapter = int(adapter)  # the rows' adapter row (0: base)
        self._inputs = {}
        self._outputs = {}
        self._finished = 0  # this predictor's own rows, for close()'s
        self._failed = 0    # summary (metrics are process-global)

    def get_input_names(self) -> List[str]:
        return ["input_ids"]

    def get_output_names(self) -> List[str]:
        return sorted(self._outputs) or ["output_0"]

    def get_input_handle(self, name: str):
        from ..inference import PredictorTensor

        return PredictorTensor(self, name)

    def get_output_handle(self, name: str):
        from ..inference import PredictorTensor

        return PredictorTensor(self, name)

    def run(self, inputs: Optional[List[np.ndarray]] = None,
            priority: Optional[int] = None):
        """One predictor run over ``inputs[0]`` (or the ``input_ids``
        handle). ``priority`` overrides the constructor's class for this
        batch only (lower is served first; None keeps it)."""
        if inputs is not None:
            ids = np.asarray(inputs[0])
        else:
            ids = np.asarray(self._inputs["input_ids"])
        ids = np.atleast_2d(ids).astype(np.int32)
        b, plen = ids.shape
        pr = self._priority if priority is None else int(priority)
        reqs = []
        try:
            for row in ids:
                reqs.append(self._api.submit(row,
                                             max_new_tokens=self._max_new,
                                             stop_token_id=self._stop,
                                             priority=pr,
                                             sampling=self._sampling,
                                             adapter=self._adapter))
        # analysis: allow(broad-except) -- cleanup and re-raise: a submit
        # that fails mid-batch (a shed, a refusal) must not strand the rows
        # already queued, whose handles would be unreachable. Every cancel
        # is flagged before one pump, so the cull runs once and no doomed
        # row is admitted.
        except Exception:
            for req in reqs:
                req.cancel()
            if reqs:
                self._api._pump_once()
            raise
        self._api.run_until_idle()
        self._finished += sum(r.state == RequestState.FINISHED for r in reqs)
        self._failed += sum(r.state == RequestState.FAILED for r in reqs)
        fill = self._stop if self._stop is not None else 0
        out = np.full((b, plen + self._max_new), fill, np.int32)
        out[:, :plen] = ids
        for i, req in enumerate(reqs):
            if req.state == RequestState.FAILED:
                raise req.error
            toks = np.asarray(req.tokens, np.int32)
            out[i, plen:plen + len(toks)] = toks
        self._outputs = {"output_0": out}
        if inputs is not None:
            return [out]

    def close(self) -> None:
        """Close the API (a drain with zero grace) and log this predictor's
        lifetime summary from its own engine stack: supervisor replays and
        rebuilds, preemptions, drains, the prefix hit rate, the tiers' hit
        rate (host and disk hits, blocks spilled and restored),
        speculation (proposed, accepted, acceptance, emitted, mode and k),
        the quantized arena's bytes per namespace, sampled, constrained and
        adapter admissions with the adapter arena's rank, live rows and
        bytes, and the TTFT and inter-token percentiles of the engine's
        histograms."""
        api = self._api
        api.close()
        engine = api.engine
        cache = engine.prefix_cache
        prefix = ""
        if cache is not None and (cache.hits or cache.misses):
            prefix = (", prefix hit-rate %.0f%% (%d/%d admits, "
                      "%d prefill tokens avoided)") % (
                          100.0 * cache.hits / (cache.hits + cache.misses),
                          cache.hits, cache.hits + cache.misses,
                          cache.hit_tokens)
        tier = ""
        view = engine.tier
        if view is not None and (view.host_hits or view.disk_hits
                                 or view.misses or view.spilled_blocks):
            # each lookup of a spilled block answered by a tier, or a miss:
            # the entry was lost and the prefix recomputed
            lookups = view.host_hits + view.disk_hits + view.misses
            rate = (100.0 * (view.host_hits + view.disk_hits) / lookups
                    if lookups else 0.0)
            tier = (", tier hit-rate %.0f%% (%d host / %d disk hits, "
                    "%d blocks spilled, %d restored)") % (
                        rate, view.host_hits, view.disk_hits,
                        view.spilled_blocks, view.restored_blocks)
        spec = engine.spec
        speculation = ""
        if spec is not None and spec.proposed:
            speculation = (", speculation %d proposed / %d accepted "
                           "(%.0f%% acceptance, %d emitted, %s k=%d)") % (
                               spec.proposed, spec.accepted,
                               100.0 * spec.acceptance_rate(), spec.emitted,
                               spec.mode(), spec.k)
        quant = ""
        if engine.quant_weights or engine.quant_kv or engine.quant_draft:
            # per arena namespace, the draft's included
            by_ns = engine.arena.bytes_by_namespace()
            arena_desc = " + ".join(
                "%s %s %.2f MiB%s" % (
                    name, d["dtype"], d["bytes"] / 2 ** 20,
                    (" (%.2f MiB scales)" % (d["scale_bytes"] / 2 ** 20)
                     if d["scale_bytes"] else ""))
                for name, d in by_ns.items())
            quant = ", quantized serving [weights=%d kv=%d draft=%d]: %s" % (
                int(engine.quant_weights), int(engine.quant_kv),
                int(engine.quant_draft), arena_desc)
        scenario = ""
        if (engine.sampled_admits or engine.constrained_admits
                or engine.adapter_admits or engine.lora is not None):
            lora = ""
            if engine.lora is not None:
                st = engine.lora.stats()
                lora = ", lora arena rank %d: %d/%d live (%.2f MiB)" % (
                    st["lora.rank"], st["lora.live"], st["lora.slots"],
                    st["lora.arena_bytes"] / 2 ** 20)
            scenario = (", scenarios: %d sampled / %d constrained / "
                        "%d adapter admits%s") % (
                            engine.sampled_admits, engine.constrained_admits,
                            engine.adapter_admits, lora)
        latency = ""
        ttft_h = engine.hists.peek("latency.ttft")
        gap_h = engine.hists.peek("latency.inter_token")
        if ttft_h is not None and ttft_h.n:
            latency = ", ttft p50/p95/p99 %.1f/%.1f/%.1f ms" % (
                ttft_h.percentile(50) * 1e3, ttft_h.percentile(95) * 1e3,
                ttft_h.percentile(99) * 1e3)
            if gap_h is not None and gap_h.n:
                latency += ", inter-token p50/p95/p99 %.2f/%.2f/%.2f ms" % (
                    gap_h.percentile(50) * 1e3, gap_h.percentile(95) * 1e3,
                    gap_h.percentile(99) * 1e3)
        _logger.info(
            "EnginePredictor closed: %d finished, %d failed, "
            "%d supervisor replays (%d rebuilds), %d preemptions, "
            "%d drains%s%s%s%s%s%s",
            self._finished, self._failed,
            api.supervisor.replay_count, api.supervisor.rebuild_count,
            api.scheduler.preempt_count, api.drain_count, prefix, tier,
            speculation, quant, scenario, latency)
