"""The port's serving supervisor (``paddle_tpu_torch/serving/supervisor.py``)
and ``ServingEngine.rebuild`` against the JAX package's, on the CPU.

The same prompts and the same fault schedule go through the JAX
``ServingAPI`` and the port's, on ``gpt_tiny`` float32 with the JAX model's
``functional_state()`` weights (mirroring ``tests/test_serving.py``
``test_transient_serving_error_classifier``,
``test_crash_loop_breaker_opens_and_wraps``,
``test_crash_loop_breaker_window_slides``,
``test_recovery_failure_fails_staged_requests``,
``test_supervisor_replay_token_parity_mid_decode``,
``test_crash_loop_breaker_end_to_end``,
``test_breaker_mid_replay_death_leaks_nothing`` and
``test_supervisor_replay_with_live_shared_prefixes``). Both must give equal
``output_ids()``, equal replay and rebuild counts and equal
``arena.stats()`` right after each rebuild; the port's rebuild must keep
every pool tensor's storage (``data_ptr()``) and build nothing
(``decode_traces == 1``). Also: the H100 classifier on constructed
exceptions (an allocation failure is transient, any other CUDA runtime
error fatal), a replay of sampled, constrained and chunked requests, and
the rebuild's invariants through the fake capture backend of
``tests/test_torch_graphs.py`` (graph count, build counters, the
constraint mask rewritten whole).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import compile_cache as jax_compile_cache
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import CrashLoopError as JaxCrashLoopError
from paddle_tpu.serving import EngineSupervisor as JaxEngineSupervisor
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import constrain as jc
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu_torch.core import compile_cache, flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (CrashLoopError, EngineSupervisor,
                                      Request, RequestState, SamplingParams,
                                      Scheduler, ServingAPI, ServingConfig,
                                      is_transient_serving_error, metrics)
from paddle_tpu_torch.serving import constrain as pc
from paddle_tpu_torch.serving.graphs import StepGraphs

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

BS, MAX_LEN, VOCAB, STOP = 8, 64, 1024, 3
ARENA_KEYS = ("blocks_total", "blocks_free", "blocks_in_use",
              "blocks_reserved", "blocks_cached", "high_water", "block_size",
              "kv_bytes", "quantized")


@contextlib.contextmanager
def _flags(**values):
    """Set the same flags in both packages for the block."""
    keep_jax = {k: paddle.get_flags(k)[k] for k in values}
    keep = {k: flags.get_flags(k)[k] for k in values}
    paddle.set_flags(values)
    flags.set_flags(values)
    try:
        yield
    finally:
        paddle.set_flags(keep_jax)
        flags.set_flags(keep)
        jax_resilience.clear_faults()
        resilience.clear_faults()


@pytest.fixture(scope="module", autouse=True)
def _faults_on():
    with _flags(fault_injection=1, serving_arena_invariants=1):
        yield


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, {
        name: np.array(t._data)
        for name, t in jax_model.functional_state()[0].items()})
    return m


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


class Side:
    """One package's API, its fault registry and counters, and a record of
    the arena right after each rebuild."""

    def __init__(self, port, model, **cfg):
        cfg = dict(dict(num_slots=4, kv_block_size=BS,
                        max_model_len=MAX_LEN), **cfg)
        self.port = port
        if port:
            self.api = ServingAPI(model, ServingConfig(**cfg), device="cpu")
            self.res, self.met = resilience, metrics
            self.sp, self.cmod = SamplingParams, pc
            self.crash = CrashLoopError
        else:
            self.api = JaxServingAPI(model, JaxServingConfig(**cfg))
            self.res, self.met = jax_resilience, jax_metrics
            self.sp, self.cmod = JaxSamplingParams, jc
            self.crash = JaxCrashLoopError
        self.after_rebuild = []
        eng = self.api.engine
        rebuild = eng.rebuild

        def recorded():
            rebuild()
            st = eng.arena.stats()
            self.after_rebuild.append({k: st[k] for k in ARENA_KEYS})

        eng.rebuild = recorded
        self.before = self.counts()

    def counts(self):
        r, m = self.res.stats(), self.met.stats()
        return {"rebuilds": r.get("serving.rebuilds", 0),
                "replays": r.get("serving.replays", 0),
                "sup.rebuilds": m.get("supervisor.rebuilds", 0),
                "sup.replays": m.get("supervisor.replays", 0),
                "recoveries": m.get("api.recoveries", 0)}

    def moved(self):
        now = self.counts()
        return {k: now[k] - self.before[k] for k in now}

    def submit(self, prompt, n, sampling=None, constraint=None, **kw):
        if sampling is not None:
            kw["sampling"] = self.sp(**sampling)
        if constraint is not None:
            kw["constraint"] = self.cmod.TrieConstraint(
                constraint, vocab_size=VOCAB, stop_token_id=STOP)
            kw["stop_token_id"] = STOP
        if not self.port:
            prompt = np.asarray(prompt, np.int32)
        return self.api.submit(prompt, max_new_tokens=n, **kw)

    def pump(self, n):
        for _ in range(n):
            self.api._pump_once()

    def ptrs(self):
        """The port's pool addresses (the JAX arena has none to keep)."""
        if not self.port:
            return []
        return [t.data_ptr() for entry in self.api.engine.arena.pools
                for t in entry]


def _both(jax_model, model, script, **cfg):
    """Run ``script(side)`` on the JAX package, then on the port; returns
    both records (each a dict), which the caller compares."""
    out = []
    for port, m in ((False, jax_model), (True, model)):
        side = Side(port, m, **cfg)
        try:
            out.append(script(side))
        finally:
            side.api.close()
            side.res.clear_faults()
    return out


def _outputs(reqs):
    return [[int(t) for t in r.output_ids()] for r in reqs]


# ----------------------------------------------------------- classifier


def test_transient_serving_error_classifier():
    """The H100 classes: the injected ones and an allocation failure are
    transient; every other CUDA runtime error is sticky (it poisons the
    context) and fatal, as are bugs, validation, IO and interrupts. The
    JAX classifier's XLA runtime error has no counterpart here."""
    assert is_transient_serving_error(resilience.ServingDeviceError("x"))
    assert is_transient_serving_error(resilience.ArenaCorruptError("x"))
    assert is_transient_serving_error(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert is_transient_serving_error(torch.cuda.OutOfMemoryError("oom"))
    fatal = [RuntimeError("CUDA error: an illegal memory access was "
                          "encountered"),
             RuntimeError("CUDA error: unspecified launch failure"),
             OSError("io"), ValueError("bad request"),
             KeyboardInterrupt(), SystemExit(1)]
    if hasattr(torch, "AcceleratorError"):
        fatal.append(torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered"))

    class XlaRuntimeError(Exception):
        pass

    fatal.append(XlaRuntimeError("the JAX classifier's transient class"))
    for e in fatal:
        assert not is_transient_serving_error(e), e


class _FakeEngine:
    def __init__(self):
        self.rebuilds = 0

    def rebuild(self):
        self.rebuilds += 1


class _FakeSched:
    def __init__(self):
        self.running = []
        self.prefilling = []

    def _gauges(self):
        pass


def _breaker_script(sup_cls, err, crash_cls):
    eng = _FakeEngine()
    sup = sup_cls(eng, _FakeSched(), max_rebuilds=2, window=100)
    got = [sup.handle(err), sup.handle(err), sup.handle(err),
           sup.breaker_open, eng.rebuilds]
    wrapped = sup.wrap(err)
    got += [isinstance(wrapped, crash_cls), wrapped.__cause__ is err,
            "FLAGS_serving_max_rebuilds" in str(wrapped)]
    bug = ValueError("bug")
    got += [sup.handle(bug), sup.wrap(bug) is bug]
    # the window slides: 5 steps of progress age a rebuild out
    eng = _FakeEngine()
    sup = sup_cls(eng, _FakeSched(), max_rebuilds=1, window=5)
    got.append(sup.handle(err))
    for _ in range(5):
        sup.note_step()
    got += [sup.handle(err), eng.rebuilds, sup.breaker_open]
    return got


def test_crash_loop_breaker_opens_wraps_and_slides():
    port = _breaker_script(EngineSupervisor,
                           resilience.ServingDeviceError("flaky"),
                           CrashLoopError)
    ref = _breaker_script(JaxEngineSupervisor,
                          jax_resilience.ServingDeviceError("flaky"),
                          JaxCrashLoopError)
    assert port == ref
    assert port == [True, True, False, True, 2, True, True, True, False,
                    True, True, True, 2, False]


def test_recovery_failure_fails_staged_requests():
    """If recovery itself raises, every request staged for replay fails
    with that error: none is left RUNNING without a slot."""

    class DeadEngine:
        def rebuild(self):
            raise torch.OutOfMemoryError("pools could not be zeroed")

    sched = Scheduler(DeadEngine())
    reqs = [Request(np.arange(4), max_new_tokens=4) for _ in range(2)]
    for slot, r in enumerate(reqs):
        r.state = RequestState.RUNNING
        r.slot = slot
        sched.running.append(r)
    sup = EngineSupervisor(DeadEngine(), sched, max_rebuilds=3, window=10)
    with pytest.raises(torch.OutOfMemoryError):
        sup.handle(resilience.ServingDeviceError("step died"))
    for r in reqs:
        assert r.state == RequestState.FAILED
        assert isinstance(r.error, torch.OutOfMemoryError)
        assert r.done_event.is_set()
    assert not sched.running


# ---------------------------------------------------- rebuild and replay


def test_replay_token_parity_mid_decode(jax_model, model):
    """A serving_device fault with three requests mid-decode, then an
    arena_corrupt one: every request finishes with the tokens of an
    unfaulted pass, in both packages; the rebuild keeps the pools'
    storage and builds nothing; the drained arena is clean."""
    rng = np.random.default_rng(40)
    prompts = [_prompt(rng, n) for n in (5, 9, 12)]

    def script(s):
        reqs = [s.submit(p, 10) for p in prompts]
        s.api.run_until_idle()
        refs = _outputs(reqs)
        eng = s.api.engine
        ptrs = s.ptrs()
        cc = compile_cache if s.port else jax_compile_cache
        cc0 = cc.stats().get("serving.decode_compiles", 0)
        reqs2 = [s.submit(p, 10) for p in prompts]
        s.pump(3)
        assert all(r.state == RequestState.RUNNING for r in reqs2)
        s.res.inject_fault("serving_device", times=1)
        s.api.run_until_idle()
        reqs3 = [s.submit(p, 10) for p in prompts]
        s.pump(2)
        s.res.inject_fault("arena_corrupt", times=1)
        s.api.run_until_idle()
        cc1 = cc.stats().get("serving.decode_compiles", 0)
        s.api.drain(grace=5)
        a = eng.arena.stats()
        return dict(refs=refs, faulted=_outputs(reqs2),
                    corrupt=_outputs(reqs3),
                    states=[r.state for r in reqs2 + reqs3],
                    moved=s.moved(), after_rebuild=s.after_rebuild,
                    decode_traces=eng.decode_traces,
                    decode_compiles=cc1 - cc0,
                    same_storage=s.ptrs() == ptrs,
                    clean=(a["blocks_in_use"], a["blocks_reserved"],
                           eng.active_slots()))

    ref, port = _both(jax_model, model, script)
    assert port == ref
    assert port["faulted"] == port["refs"] == port["corrupt"]
    assert port["states"] == [RequestState.FINISHED] * 6
    assert port["moved"] == {"rebuilds": 2, "replays": 6, "sup.rebuilds": 2,
                             "sup.replays": 6, "recoveries": 2}
    assert port["decode_traces"] == 1 and port["decode_compiles"] == 0
    assert port["same_storage"] and port["clean"] == (0, 0, 0)
    # right after a rebuild the arena is a fresh arena's
    assert port["after_rebuild"][0]["blocks_in_use"] == 0
    assert port["after_rebuild"][0]["high_water"] == 0


def test_crash_loop_breaker_end_to_end(jax_model, model):
    """A device that keeps failing: two rebuilds, then the breaker fails
    the request fast with CrashLoopError (the transient cause chained),
    capacity comes back, and later work fails fast too."""
    rng = np.random.default_rng(42)
    p1, p2 = _prompt(rng, 5), _prompt(rng, 5)

    def script(s):
        s.api.supervisor.max_rebuilds = 2
        req = s.submit(p1, 8)
        s.pump(1)
        assert req.state == RequestState.RUNNING
        s.res.inject_fault("serving_device", times=100)
        with pytest.raises(s.crash):
            s.api.run_until_idle()
        eng = s.api.engine
        a = eng.arena.stats()
        req2 = s.submit(p2, 4)
        with pytest.raises(s.crash):
            s.api.run_until_idle()
        return dict(state=req.state, error=type(req.error).__name__,
                    cause=type(req.error.__cause__).__name__,
                    breaker=s.api.supervisor.breaker_open,
                    moved=s.moved(), after_rebuild=s.after_rebuild,
                    clean=(a["blocks_in_use"], a["blocks_reserved"],
                           eng.active_slots()),
                    error2=type(req2.error).__name__)

    ref, port = _both(jax_model, model, script, num_slots=2)
    assert port == ref
    assert port["error"] == "CrashLoopError"
    assert port["cause"] == "ServingDeviceError"
    assert port["moved"]["rebuilds"] == 2 and port["clean"] == (0, 0, 0)


def test_breaker_mid_replay_death_leaks_nothing(jax_model, model):
    """The engine fails again during the replay, after one request was
    re-admitted: the breaker opens, both requests fail with
    CrashLoopError, and the re-admitted slot is retired first."""
    rng = np.random.default_rng(48)
    p1, p2 = _prompt(rng, 5), _prompt(rng, 9)

    def script(s):
        s.api.supervisor.max_rebuilds = 1
        r1, r2 = s.submit(p1, 8), s.submit(p2, 8)
        s.pump(1)
        assert all(r.state == RequestState.RUNNING for r in (r1, r2))
        eng = s.api.engine
        real_admit = eng.admit
        calls = {"n": 0}

        def flaky_admit(prompt, max_new_tokens, tokens=None, **kw):
            calls["n"] += 1
            if calls["n"] == 2:  # the first replay succeeds, the second dies
                raise s.res.ServingDeviceError("died during replay")
            return real_admit(prompt, max_new_tokens, tokens=tokens, **kw)

        eng.admit = flaky_admit
        recovered = s.api.supervisor.handle(
            s.res.ServingDeviceError("step died"))
        a = eng.arena.stats()
        return dict(recovered=recovered,
                    breaker=s.api.supervisor.breaker_open,
                    states=[r.state for r in (r1, r2)],
                    errors=[type(r.error).__name__ for r in (r1, r2)],
                    done=[r.done_event.is_set() for r in (r1, r2)],
                    after_rebuild=s.after_rebuild,
                    clean=(a["blocks_in_use"], a["blocks_reserved"],
                           eng.active_slots()))

    ref, port = _both(jax_model, model, script, num_slots=2)
    assert port == ref
    assert port["recovered"] is False and port["breaker"]
    assert port["errors"] == ["CrashLoopError"] * 2
    assert port["clean"] == (0, 0, 0)


def test_replay_with_live_shared_prefixes(jax_model, model):
    """A serving_device fault while three slots share radix-cache prefix
    blocks: the rebuild resets the tree, the replays re-insert and share
    the prefix again, the tokens equal the unfaulted pass, and after
    drain_all nothing leaks (only cache-resident blocks stay)."""
    rng = np.random.default_rng(60)
    shared = _prompt(rng, 24)
    prompts = [np.concatenate([shared, _prompt(rng, n)]) for n in (4, 6, 9)]

    def script(s):
        reqs = [s.submit(p, 10) for p in prompts]
        s.api.run_until_idle()
        refs = _outputs(reqs)
        eng = s.api.engine
        reqs2 = [s.submit(p, 10) for p in prompts]
        s.pump(3)
        cache = eng.prefix_cache
        shared_refs = eng.arena.refcount(cache.match(
            np.asarray(shared, np.int32))[0].block)
        s.res.inject_fault("serving_device", times=1)
        s.api.run_until_idle()
        cache = eng.prefix_cache
        out = dict(refs=refs, faulted=_outputs(reqs2),
                   shared_refs=shared_refs, moved=s.moved(),
                   after_rebuild=s.after_rebuild,
                   resident=cache.resident_blocks(), hits=cache.hits,
                   decode_traces=eng.decode_traces)
        s.api.drain(grace=5)
        eng.check_invariants()
        a = eng.arena.stats()
        out["clean"] = (a["blocks_reserved"],
                        a["blocks_in_use"] - a["blocks_cached"],
                        eng.active_slots(),
                        sum(eng.arena.refcount(b)
                            for b in range(1, eng.arena.num_blocks)))
        return out

    ref, port = _both(jax_model, model, script, prefix_cache=True)
    assert port == ref
    assert port["faulted"] == port["refs"]
    assert port["shared_refs"] >= 2 and port["resident"] >= 3
    assert port["moved"]["rebuilds"] == 1 and port["decode_traces"] == 1
    assert port["clean"] == (0, 0, 0, 0)


def test_replay_of_sampled_constrained_and_chunked(jax_model, model):
    """Chunks of 8: a greedy, a seeded sampled and a constrained request
    decode while a long prompt is mid-chunked-prefill; an arena_corrupt
    fault on the decode step (the chunk's probe passes) replays all four
    through one-shot admissions, and the tokens equal the JAX package's
    under the same schedule."""
    rng = np.random.default_rng(61)
    prompts = [_prompt(rng, n) for n in (6, 7, 5, 40)]
    kw = [{}, dict(sampling=dict(temperature=0.8, top_k=50, top_p=0.95,
                                 seed=7)),
          dict(constraint=[[11, 12, 13, 14, 15], [11, 20, 21]]), {}]

    def script(s):
        reqs = [s.submit(p, 9, **k) for p, k in zip(prompts[:3], kw[:3])]
        s.pump(2)
        reqs.append(s.submit(prompts[3], 9))
        s.pump(2)
        eng = s.api.engine
        mid_chunk = bool(s.api.scheduler.prefilling)
        s.res.inject_fault("arena_corrupt", times=1, after=1)
        s.api.run_until_idle()
        return dict(mid_chunk=mid_chunk, outputs=_outputs(reqs),
                    states=[r.state for r in reqs], moved=s.moved(),
                    after_rebuild=s.after_rebuild,
                    decode_traces=eng.decode_traces)

    ref, port = _both(jax_model, model, script, chunked_prefill=8)
    assert port == ref
    assert port["mid_chunk"] and port["moved"]["replays"] == 4
    assert port["states"] == [RequestState.FINISHED] * 4


def test_admission_fault_requeues_and_replays(jax_model, model):
    """A fault on an admission (the transient re-queue branch): the
    request goes back to the queue untouched, the running ones replay,
    and it is admitted after the rebuild, in both packages alike."""
    rng = np.random.default_rng(62)
    prompts = [_prompt(rng, n) for n in (5, 11, 7)]

    def script(s):
        reqs = [s.submit(p, 6) for p in prompts[:2]]
        s.pump(2)
        reqs.append(s.submit(prompts[2], 6))
        # the next probe is the admission's prefill
        s.res.inject_fault("serving_device", times=1)
        s.pump(1)
        queued = reqs[2].state
        s.api.run_until_idle()
        return dict(queued=queued, outputs=_outputs(reqs),
                    states=[r.state for r in reqs], moved=s.moved(),
                    after_rebuild=s.after_rebuild)

    ref, port = _both(jax_model, model, script)
    assert port == ref
    assert port["states"] == [RequestState.FINISHED] * 3
    assert port["moved"]["rebuilds"] == 1 and port["moved"]["replays"] == 2


# ------------------------------------------- the rebuild's own invariants


class _FakeGraph:
    """A "captured" step (``tests/test_torch_graphs.py``): replay reruns it
    and copies into the kept outputs."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        for out, new in zip(self.outputs, self.fn()):
            out.copy_(new)

    def reset(self):
        self.fn = self.outputs = None


class _FakeGraphs:
    pool_bytes = 0

    def __init__(self):
        self.captures = 0

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        self.captures += 1
        out = fn()
        return _FakeGraph(fn, out), out

    def close(self):
        pass


def test_rebuild_keeps_storage_programs_and_rewrites_the_mask(model):
    """Through the fake capture backend: ``rebuild()`` keeps every pool
    tensor (same ``data_ptr()``, zeroed), builds and captures nothing,
    clears every slot array, marks every row of the constraint mask for
    the next flush, and a replay of ``prompt + journal`` crossing into a
    bucket not yet built builds exactly that bucket, once."""
    api = ServingAPI(model, ServingConfig(num_slots=4, kv_block_size=BS,
                                          max_model_len=MAX_LEN,
                                          prefill_bucket_min=16),
                     device="cpu")
    backend = _FakeGraphs()
    eng = api.engine
    eng._graphs = StepGraphs("cpu", backend=backend)
    rng = np.random.default_rng(63)
    # a 14-token prompt is in bucket 16; with 4 journal tokens its replay
    # prefills 18 tokens, in bucket 24, which nothing built before
    p_long, p_con = _prompt(rng, 14), _prompt(rng, 6)
    choice = list(range(11, 18))
    trie = pc.TrieConstraint([choice], vocab_size=VOCAB, stop_token_id=STOP)
    r1 = api.submit(p_long, max_new_tokens=10)
    r2 = api.submit(p_con, max_new_tokens=8, constraint=trie,
                    stop_token_id=STOP)
    for _ in range(4):
        api._pump_once()
    assert r1.state == RequestState.RUNNING and len(r1.tokens) == 5
    assert r2.state == RequestState.RUNNING and eng._constrained.any()
    ptrs = [t.data_ptr() for entry in eng.arena.pools for t in entry]
    built = (eng.decode_traces, dict(eng.prefill_traces),
             dict(eng.prefix_prefill_traces), eng._graphs.graph_count(),
             backend.captures)
    assert 24 not in eng.prefill_traces
    eng.rebuild()
    assert [t.data_ptr() for entry in eng.arena.pools
            for t in entry] == ptrs
    assert all(not t.any() for entry in eng.arena.pools for t in entry)
    assert (eng.decode_traces, dict(eng.prefill_traces),
            dict(eng.prefix_prefill_traces), eng._graphs.graph_count(),
            backend.captures) == built
    assert not eng._occupied.any() and not eng._active.any()
    assert not eng._bt_host.any() and not eng._constrained.any()
    assert (eng._top_p == 1.0).all() and eng._mask_host.all()
    assert eng._mask._dirty == set(range(eng.num_slots))
    assert eng.arena.stats()["blocks_in_use"] == 0
    assert eng.stats()["rebuilds"] == 1
    # the scheduler's view died with the arena: replay as the supervisor
    # does, through the pump
    resilience.inject_fault("serving_device", times=1)
    api.run_until_idle()
    assert r1.state == r2.state == RequestState.FINISHED
    assert r2.tokens == choice + [STOP]
    assert eng.prefill_traces.get(24) == 1
    assert eng.decode_traces == 1
    alone = ServingAPI(model, ServingConfig(num_slots=1, kv_block_size=BS,
                                            max_model_len=MAX_LEN),
                       device="cpu")
    ref = alone.submit(p_long, max_new_tokens=10)
    alone.run_until_idle()
    assert list(ref.tokens) == list(r1.tokens)
    alone.close()
    api.close()
