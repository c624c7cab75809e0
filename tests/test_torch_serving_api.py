"""The port's serving front door (``paddle_tpu_torch/serving/api.py``)
against the JAX package's, on the CPU: ``cancel``, ``result``,
``outstanding``, the background pump, ``drain`` / ``drain_all`` / ``close``,
``bind_preemption_guard`` and ``EnginePredictor``.

Mirrors ``tests/test_serving.py`` ``test_cancel_mid_decode_frees_slot``,
``test_cancel_while_queued_costs_no_prefill``,
``test_engine_predictor_bridge``, ``test_close_fails_outstanding_requests``,
``test_background_pump_thread``,
``test_drain_zero_grace_fails_stragglers_retriably``,
``test_drain_all_covers_live_apis``, ``test_preemption_guard_binds_to_drain``,
``test_close_during_inflight_drain_still_sweeps``,
``test_predictor_priority_kwarg_and_close_summary``,
``test_predictor_mid_batch_submit_failure_strands_nothing`` and
``test_drain_completes_in_flight_within_grace``, on ``gpt_tiny`` float32
with the JAX model's ``functional_state()`` weights; where both packages
run a script, their records must be equal, and ``EnginePredictor``'s
outputs must equal the JAX ``EnginePredictor``'s and
``generate(stop_token_id=)``'s row for row. Also: interpreter exit drains a
live background API without an error.
"""
import logging
import os
import queue as pyqueue
import subprocess
import sys
import textwrap
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu.serving.api import EnginePredictor as JaxEnginePredictor
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (EnginePredictor, Request,
                                      RequestDrainedError, RequestState,
                                      ServingAPI, ServingConfig, metrics)
from paddle_tpu_torch.serving import api as api_mod

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

BS, MAX_LEN, VOCAB = 8, 64, 1024
CFG = dict(num_slots=2, kv_block_size=BS, max_model_len=MAX_LEN)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(autouse=True)
def _only_own_apis(monkeypatch):
    """drain_all() must sweep only the APIs a test makes."""
    monkeypatch.setattr(api_mod, "_live_apis", weakref.WeakSet())


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


def _api(model, **kw):
    cfg = dict(CFG, **kw.pop("cfg", {}))
    return ServingAPI(model, ServingConfig(**cfg), device="cpu", **kw)


def _ref(model, prompt, n, stop=None):
    ids = torch.as_tensor(np.asarray(prompt, np.int64))[None]
    return model.generate(ids, max_new_tokens=n,
                          stop_token_id=stop)[0].numpy()


class Pkg:
    """One package's API constructor and modules."""

    def __init__(self, port, model):
        self.port = port
        self.model = model
        self.res = resilience if port else jax_resilience
        self.met = metrics if port else jax_metrics

    def api(self, **cfg):
        cfg = dict(CFG, **cfg)
        if self.port:
            return ServingAPI(self.model, ServingConfig(**cfg), device="cpu")
        return JaxServingAPI(self.model, JaxServingConfig(**cfg))

    def prompt(self, p):
        return p if self.port else np.asarray(p, np.int32)


def _both(jax_model, model, script):
    out = [script(Pkg(False, jax_model)), script(Pkg(True, model))]
    assert out[1] == out[0]
    return out[1]


# ------------------------------------------------------ cancel / result


def test_cancel_mid_decode_frees_slot(jax_model, model):
    rng = np.random.default_rng(5)
    p = _prompt(rng, 5)

    def script(k):
        api = k.api()
        try:
            req = api.submit(k.prompt(p), max_new_tokens=40)
            for _ in range(3):
                api._pump_once()
            running = (req.state, api.engine.active_slots(),
                       api.outstanding())
            api.cancel(req)
            a = api.engine.arena.stats()
            with pytest.raises(RuntimeError, match="cancelled"):
                api.result(req)
            return dict(running=running, state=req.state,
                        tokens=len(req.tokens),
                        after=(api.engine.active_slots(),
                               a["blocks_in_use"], a["blocks_reserved"],
                               api.outstanding()))
        finally:
            api.close()

    rec = _both(jax_model, model, script)
    assert rec["running"] == (RequestState.RUNNING, 1, 1)
    assert rec["state"] == RequestState.CANCELLED
    assert rec["after"] == (0, 0, 0, 0)


def test_cancel_while_queued_costs_no_prefill(model):
    api = _api(model)
    try:
        rng = np.random.default_rng(6)
        admits0 = metrics.stats().get("engine.admits", 0)
        req = api.submit(_prompt(rng, 5), max_new_tokens=4)
        assert api.outstanding() == 1
        api.cancel(req)
        assert req.state == RequestState.CANCELLED
        assert metrics.stats().get("engine.admits", 0) == admits0
        assert api.engine.prefill_traces == {} and api.outstanding() == 0
    finally:
        api.close()


@pytest.mark.parametrize("chunk", [0, 8])
def test_outstanding_counts_a_request_through_its_prefill(model, monkeypatch,
                                                          chunk):
    """A router reads ``outstanding()`` from another thread while the pump
    prefills: the request being seated is counted during its prefill (it
    leaves ``waiting`` only once seated), whole or chunked."""
    api = _api(model, cfg=dict(chunked_prefill=chunk))
    try:
        name = "admit_begin" if chunk else "admit"
        seated, during = getattr(api.engine, name), []

        def admit(*args, **kw):
            during.append(api.outstanding())
            return seated(*args, **kw)

        monkeypatch.setattr(api.engine, name, admit)
        req = api.submit(_prompt(np.random.default_rng(8), 20),
                         max_new_tokens=4)
        api._pump_once()
        assert during == [1] and api.outstanding() == 1
        api.run_until_idle()
        assert req.state == RequestState.FINISHED and api.outstanding() == 0
    finally:
        api.close()


def test_failed_admission_leaves_nothing_outstanding(model, monkeypatch):
    """An admission that fails (not transiently) fails its request and
    takes it out of ``waiting``: nothing stays outstanding."""
    api = _api(model)
    try:
        def admit(*args, **kw):
            raise ValueError("refused")

        monkeypatch.setattr(api.engine, "admit", admit)
        req = api.submit(_prompt(np.random.default_rng(9), 5),
                         max_new_tokens=4)
        api._pump_once()
        assert req.state == RequestState.FAILED
        assert isinstance(req.error, ValueError)
        assert api.outstanding() == 0 and api.scheduler.waiting == []
    finally:
        api.close()


def test_result_returns_prompt_and_tokens_and_times_out(model):
    rng = np.random.default_rng(7)
    p = _prompt(rng, 6)
    api = _api(model)
    try:
        req = api.submit(p, max_new_tokens=5)
        out = api.result(req)
        np.testing.assert_array_equal(out, _ref(model, p, 5))
        np.testing.assert_array_equal(out, req.output_ids())
        req2 = api.submit(p, max_new_tokens=20)
        with pytest.raises(resilience.DeadlineExceededError):
            api.result(req2, timeout=0.0)
        with pytest.raises(RuntimeError, match="still busy after 2 steps"):
            api.scheduler.run_until_idle(max_steps=2)
        api.scheduler.run_until_idle(max_steps=100)
        assert req2.state == RequestState.FINISHED
    finally:
        api.close()


def test_close_fails_outstanding_requests(model):
    api = _api(model)
    rng = np.random.default_rng(15)
    req = api.submit(_prompt(rng, 5), max_new_tokens=4)  # stays QUEUED
    api.close()
    assert req.state == RequestState.FAILED
    assert isinstance(req.error, RuntimeError) and req.done_event.is_set()
    with pytest.raises(RuntimeError, match="closed"):
        list(api.stream(req))
    with pytest.raises(RuntimeError, match="closed"):
        api.submit(_prompt(rng, 5), max_new_tokens=4)


def test_background_pump_thread(model):
    """The pump thread serves: result() and stream() only wait; a cancel
    and a second request go through the same thread; close() stops it."""
    rng = np.random.default_rng(12)
    p, q = _prompt(rng, 5), _prompt(rng, 9)
    api = _api(model, background=True)
    try:
        req = api.submit(p, max_new_tokens=6)
        np.testing.assert_array_equal(api.result(req, timeout=60),
                                      _ref(model, p, 6))
        req2 = api.submit(q, max_new_tokens=7)
        assert list(api.stream(req2)) == list(_ref(model, q, 7)[9:])
        long = api.submit(p, max_new_tokens=50)
        api.cancel(long)
        assert long.done_event.wait(60)
        assert long.state == RequestState.CANCELLED
        thread = api._thread
        assert thread.is_alive()
    finally:
        api.close()
    assert not thread.is_alive() and api.outstanding() == 0


# -------------------------------------------------------- drain / close


def test_drain_zero_grace_fails_stragglers_retriably(jax_model, model):
    rng = np.random.default_rng(44)
    p = _prompt(rng, 5)

    def script(k):
        api = k.api()
        req = api.submit(k.prompt(p), max_new_tokens=4)  # stays QUEUED
        d0 = k.res.stats().get("serving.drains", 0)
        s0 = k.res.stats().get("serving.drain_stragglers", 0)
        api.drain(grace=0)
        rec = dict(state=req.state, error=type(req.error).__name__,
                   drains=k.res.stats().get("serving.drains", 0) - d0,
                   stragglers=k.res.stats().get(
                       "serving.drain_stragglers", 0) - s0)
        with pytest.raises(k.res.RequestDrainedError, match="draining"):
            api.submit(k.prompt(p), max_new_tokens=4)
        api.drain()  # idempotent
        rec["drains_again"] = k.res.stats().get("serving.drains", 0) - d0
        api.close()
        rec["error_after_close"] = type(req.error).__name__
        return rec

    rec = _both(jax_model, model, script)
    assert rec == dict(state=RequestState.FAILED,
                       error="RequestDrainedError", drains=1, stragglers=1,
                       drains_again=1,
                       error_after_close="RequestDrainedError")


def test_close_after_failed_pump_single_fail(model, monkeypatch):
    api = _api(model)
    rng = np.random.default_rng(45)
    req = api.submit(_prompt(rng, 5), max_new_tokens=4)
    boom = RuntimeError("pump died")

    def dead_step():
        raise boom

    monkeypatch.setattr(api.scheduler, "step", dead_step)
    with pytest.raises(RuntimeError, match="pump died"):
        api.run_until_idle()
    assert req.state == RequestState.FAILED and req.error is boom
    api.close()
    assert req.error is boom
    assert req.stream_queue.get_nowait() is None  # exactly one sentinel
    with pytest.raises(pyqueue.Empty):
        req.stream_queue.get_nowait()


def test_drain_all_covers_live_apis(model):
    a, b = _api(model), _api(model)
    b.close()
    rng = np.random.default_rng(46)
    req = a.submit(_prompt(rng, 5), max_new_tokens=4)
    assert api_mod.drain_all() == 1  # b is closed: skipped
    assert req.state == RequestState.FAILED
    assert isinstance(req.error, RequestDrainedError)
    a.close()


@pytest.mark.chaos
@pytest.mark.parametrize("how", ["request", "preempt-fault"])
def test_preemption_guard_binds_to_drain(jax_model, model, how):
    """A bound guard (requested, or the injected ``preempt`` fault standing
    in for SIGTERM) drains the API at the next pump boundary: admissions
    stop and the stragglers fail with the retriable RequestDrainedError."""
    rng = np.random.default_rng(47)
    p = _prompt(rng, 5)

    def script(k):
        api = k.api()
        guard = k.res.PreemptionGuard(install=False)
        assert api.bind_preemption_guard(guard, grace=0.0) is api
        req = api.submit(k.prompt(p), max_new_tokens=4)  # stays QUEUED
        g0 = k.met.stats().get("api.guard_drains", 0)
        if how == "request":
            guard.request("test eviction")
        else:
            k.res.inject_fault("preempt", times=1)
        api._pump_once()
        rec = dict(state=req.state, error=type(req.error).__name__,
                   reason="preemption requested" in str(req.error),
                   guard_drains=k.met.stats().get("api.guard_drains", 0)
                   - g0, why=guard.reason)
        with pytest.raises(k.res.RequestDrainedError):
            api.submit(k.prompt(p), max_new_tokens=4)
        api.close()
        return rec

    keep = (paddle.get_flags("fault_injection")["fault_injection"],
            flags.flag("fault_injection"))
    paddle.set_flags({"fault_injection": 1})
    flags.set_flags({"fault_injection": 1})
    try:
        rec = _both(jax_model, model, script)
    finally:
        paddle.set_flags({"fault_injection": keep[0]})
        flags.set_flags({"fault_injection": keep[1]})
        jax_resilience.clear_faults()
        resilience.clear_faults()
    assert rec["state"] == RequestState.FAILED and rec["reason"]
    assert rec["error"] == "RequestDrainedError" and rec["guard_drains"] == 1


def test_close_during_inflight_drain_still_sweeps(model):
    api = _api(model)
    rng = np.random.default_rng(50)
    req = api.submit(_prompt(rng, 5), max_new_tokens=4)  # stays QUEUED
    api._draining = True  # a guard's long drain in flight elsewhere
    api.close()
    assert req.state == RequestState.FAILED
    assert isinstance(req.error, RequestDrainedError)
    assert req.done_event.is_set()


def test_drain_completes_in_flight_within_grace(model):
    for background in (False, True):
        api = _api(model, background=background)
        try:
            rng = np.random.default_rng(43)
            p = _prompt(rng, 5)
            req = api.submit(p, max_new_tokens=6)
            if not background:
                api._pump_once()
                assert req.state == RequestState.RUNNING
            api.drain(grace=30)
            assert req.state == RequestState.FINISHED
            np.testing.assert_array_equal(req.output_ids(),
                                          _ref(model, p, 6))
            assert api.engine.active_slots() == 0
            with pytest.raises(RequestDrainedError):
                api.submit(p, max_new_tokens=2)
        finally:
            api.close()


def test_interpreter_exit_drains_a_live_background_api():
    """A script that exits with a request in flight on a background API
    (never closed) exits 0 and prints no error: the atexit drain fails the
    request retriably and the pump thread never dies mid-step."""
    script = textwrap.dedent("""
        import numpy as np, torch
        torch.set_num_threads(1)
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.serving import ServingAPI, ServingConfig
        from paddle_tpu_torch.serving import api as api_mod
        m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
        api = ServingAPI(m, ServingConfig(num_slots=2, kv_block_size=8,
                                          max_model_len=64),
                         device="cpu", background=True)
        req = api.submit(np.arange(5), max_new_tokens=50)
        req.stream_queue.get(timeout=60)  # the first token is out
        print("in flight", len(api_mod._live_apis))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "in flight 1" in proc.stdout
    assert "Traceback" not in proc.stderr and "Error" not in proc.stderr


# ------------------------------------------------------- EnginePredictor


@pytest.mark.parametrize("stop", [None, "mid"])
def test_engine_predictor_bridge(jax_model, model, stop):
    """EnginePredictor over a batch of prompts equals the JAX
    EnginePredictor and generate(stop_token_id=) row for row, through the
    input/output handles and through run(inputs)."""
    rng = np.random.default_rng(10)
    ids = np.stack([_prompt(rng, 6) for _ in range(3)]).astype(np.int32)
    if stop == "mid":
        # a token the first row's greedy stream emits mid-way: that row
        # stops there and its tail is filled with the stop token
        stop = int(_ref(model, ids[0], 5)[6 + 2])
    cfg = dict(num_slots=2, kv_block_size=8, max_model_len=MAX_LEN)
    jp = JaxEnginePredictor(jax_model, max_new_tokens=5, stop_token_id=stop,
                            config=JaxServingConfig(**cfg))
    pp = EnginePredictor(model, max_new_tokens=5, stop_token_id=stop,
                         config=ServingConfig(**cfg), device="cpu")
    try:
        for pred in (jp, pp):
            h = pred.get_input_handle("input_ids")
            h.copy_from_cpu(ids)
            assert h.shape() == [3, 6]
            pred.run()
        want = jp.get_output_handle("output_0").copy_to_cpu()
        got = pp.get_output_handle("output_0").copy_to_cpu()
        assert got.shape == (3, 11) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        for i in range(3):
            np.testing.assert_array_equal(got[i], _ref(model, ids[i], 5,
                                                       stop))
        (again,) = pp.run([ids])
        np.testing.assert_array_equal(again, got)
        assert pp.get_output_names() == ["output_0"]
    finally:
        jp.close()
        pp.close()


def test_predictor_priority_kwarg_and_close_summary(model, monkeypatch,
                                                    caplog):
    pred = EnginePredictor(model, max_new_tokens=2, priority=7,
                           config=ServingConfig(**CFG), device="cpu")
    seen = []

    def fake_submit(prompt, max_new_tokens=32, stop_token_id=None,
                    priority=0, sampling=None, adapter=0):
        assert adapter == 0  # the predictor's default row: the base model
        seen.append(priority)
        r = Request(prompt, max_new_tokens=max_new_tokens, priority=priority)
        r.state = RequestState.FINISHED
        r.tokens = [1] * max_new_tokens
        return r

    monkeypatch.setattr(pred._api, "submit", fake_submit)
    monkeypatch.setattr(pred._api, "run_until_idle", lambda: None)
    ids = np.ones((2, 4), np.int32)
    pred.run([ids])
    assert seen == [7, 7]
    pred.run([ids], priority=1)
    assert seen[2:] == [1, 1]
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.serving"):
        pred.close()
    assert "supervisor replays" in caplog.text
    assert "preemptions" in caplog.text and "drains" in caplog.text


def test_predictor_close_summary_reports_latency(model, caplog):
    pred = EnginePredictor(model, max_new_tokens=3,
                           config=ServingConfig(**CFG), device="cpu")
    pred.run([np.arange(12, dtype=np.int32).reshape(2, 6)])
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.serving"):
        pred.close()
    assert "2 finished, 0 failed" in caplog.text
    assert "ttft p50/p95/p99" in caplog.text
    assert "inter-token p50/p95/p99" in caplog.text


def test_predictor_mid_batch_submit_failure_strands_nothing(model):
    pred = EnginePredictor(model, max_new_tokens=4,
                           config=ServingConfig(num_slots=1, kv_block_size=8,
                                                max_model_len=MAX_LEN),
                           device="cpu", max_queue=2)
    try:
        ids = np.tile(np.arange(5, dtype=np.int32), (6, 1))
        with pytest.raises(resilience.QueueOverloadError):
            pred.run([ids])
        assert not pred._api.scheduler.has_work()
    finally:
        pred.close()


def test_predictor_refuses_adapters(model):
    """An adapter the engine cannot serve (no adapter arena) is refused at
    the predictor's run, before any row is queued."""
    pred = EnginePredictor(model, adapter=1, config=ServingConfig(**CFG),
                           device="cpu")
    try:
        with pytest.raises(ValueError, match="no adapter arena"):
            pred.run([np.ones((2, 4), np.int32)])
        assert not pred._api.scheduler.has_work()
    finally:
        pred.close()


def test_flags_keep_their_default_type():
    """A flag keeps its default's type (the JAX registry's rule): a float
    grace of 0.5 stays 0.5, a bool parses from a string."""
    keep = flags.get_flags(["serving_drain_grace", "serving_telemetry",
                            "serving_max_rebuilds"])
    try:
        flags.set_flags({"serving_drain_grace": 0.5,
                         "serving_telemetry": "true",
                         "FLAGS_serving_max_rebuilds": "5"})
        got = flags.get_flags(["serving_drain_grace", "serving_telemetry",
                               "serving_max_rebuilds"])
        assert got == {"serving_drain_grace": 0.5,
                       "serving_telemetry": True,
                       "serving_max_rebuilds": 5}
        assert type(got["serving_max_rebuilds"]) is int
    finally:
        flags.set_flags(keep)
    for name in ("serving_max_rebuilds", "serving_rebuild_window",
                 "serving_drain_grace", "serving_telemetry",
                 "serving_trace_events", "fault_injection"):
        assert flags.get_flags(name)[name] == paddle.get_flags(name)[name]
