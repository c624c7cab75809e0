"""The port's request telemetry (``paddle_tpu_torch/serving/telemetry.py``)
against the JAX package's, on the CPU (mirrors ``tests/test_telemetry.py``).

Held: ``Histogram`` percentiles, means and buckets equal the JAX package's
exactly on the same samples (the same 96 log buckets), merge and minus;
``observe`` into the global and an engine's set, ``histograms_delta`` and
``percentile_table``; the windowed ``metrics.Meter``; span gating by
``FLAGS_serving_telemetry`` and the ring's oldest-first drop; a request's
lifecycle spans and latency histograms through ``ServingAPI``; the span
kinds of every request of one seeded workload -- a preemption, a supervisor
replay after an injected fault, a cancel and a drain -- equal to the JAX
package's; valid Prometheus text; ``chrome_events``.
"""
import contextlib
import json
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import telemetry as jax_telemetry
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (RequestState, ServingAPI,
                                      ServingConfig, metrics, telemetry)

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

MAX_LEN, VOCAB = 64, 1024
API_KW = dict(num_slots=4, kv_block_size=8, max_model_len=MAX_LEN)


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


@pytest.fixture()
def spans_on():
    with _flags(serving_telemetry=True):
        telemetry.reset_tracelog()
        jax_telemetry.reset_tracelog()
        yield
        telemetry.reset_tracelog()
        jax_telemetry.reset_tracelog()


# ------------------------------------------------------------- histograms


def _samples(seed, n):
    """Latencies from 0.5 us to 2000 s, log-uniform, plus exact bucket
    bounds, zero and a negative skew."""
    rng = np.random.default_rng(seed)
    xs = list(10.0 ** rng.uniform(-6.3, 3.3, n))
    xs += [telemetry.BUCKET_BOUNDS[i] for i in (0, 7, 50, 95)]
    return xs + [0.0, -1e-3]


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 37), (2, 1000)])
def test_histogram_equals_jax_exactly(seed, n):
    assert telemetry.BUCKET_BOUNDS == jax_telemetry.BUCKET_BOUNDS
    xs = _samples(seed, n)
    h, jh = telemetry.Histogram(), jax_telemetry.Histogram()
    for x in xs:
        h.record(x)
        jh.record(x)
    assert h.counts == jh.counts and h.n == jh.n and h.total == jh.total
    for p in (0, 1, 5, 25, 50, 75, 90, 95, 99, 99.9, 100):
        assert h.percentile(p) == jh.percentile(p), p
    assert h.mean() == jh.mean() and h.buckets() == jh.buckets()
    half, jhalf = telemetry.Histogram(), jax_telemetry.Histogram()
    for x in xs[::2]:
        half.record(x)
        jhalf.record(x)
    for a, b in ((h.merge(half), jh.merge(jhalf)),
                 (h.minus(half), jh.minus(jhalf))):
        assert a.counts == b.counts and a.n == b.n and a.total == b.total
        assert [a.percentile(p) for p in (50, 99)] == \
            [b.percentile(p) for p in (50, 99)]


def test_histogram_percentile_within_one_bucket():
    h = telemetry.Histogram()
    for _ in range(90):
        h.record(1e-3)
    for _ in range(10):
        h.record(0.5)
    assert 1e-3 / 1.25 <= h.percentile(50) <= 1e-3 * 1.25
    assert 0.5 / 1.25 <= h.percentile(99) <= 0.5 * 1.25
    assert abs(h.mean() - (90 * 1e-3 + 10 * 0.5) / 100) < 1e-9
    h.record(-1.0)
    assert h.n == 101
    assert telemetry.Histogram().percentile(99) == 0.0
    cums = [c for _, c in h.buckets()]
    assert cums == sorted(cums) and cums[-1] == h.n


def test_observe_records_global_and_extra_sets():
    telemetry.reset_histograms()
    extra = telemetry.HistogramSet()
    telemetry.observe("latency.ttft", 0.01, extra, None)
    telemetry.observe("latency.ttft", 0.02)
    assert telemetry.histogram("latency.ttft").n == 2
    assert extra.peek("latency.ttft").n == 1
    before = telemetry.histograms()
    telemetry.observe("latency.ttft", 0.03)
    assert telemetry.histograms_delta(before)["latency.ttft"].n == 1
    assert metrics.histograms()["latency.ttft"].n == 3
    table = telemetry.percentile_table()
    assert "latency.ttft" in table and "p99(ms)" in table


def test_meter_rate_decays_when_idle():
    t = [0.0]
    m = metrics.Meter(window=10.0, now=lambda: t[0])
    for s in range(5):
        t[0] = float(s)
        m.tick(10)
    t[0] = 5.0
    assert m.rate() == pytest.approx(10.0, rel=0.25)
    assert m.tokens() == 50
    t[0] = 16.0
    assert m.rate() == 0.0 and m.tokens() == 50
    t[0] = 17.0
    m.tick(20)
    assert m.rate() == pytest.approx(2.0, rel=0.25)
    m.reset()
    assert m.rate() == 0.0 and m.tokens() == 0


def test_metrics_reset_gauges_and_delta():
    metrics.bump("requests.submitted", 0)
    before = metrics.stats()
    metrics.bump("requests.submitted", 3)
    metrics.set_gauge("queue.depth", 7)
    d = metrics.stats_delta(before, metrics.stats(), drop_zero=True)
    assert d["requests.submitted"] == 3
    assert metrics.gauges()["queue.depth"] == 7
    keep = dict(metrics._counts), dict(metrics._gauges)
    try:
        metrics.reset_stats()
        assert metrics.stats() == {} and metrics.gauges() == {}
    finally:  # leave the process-global counters as they were
        metrics._counts.update(keep[0])
        metrics._gauges.update(keep[1])


# ---------------------------------------------------------------- tracing


def test_span_gated_by_flag(spans_on):
    flags.set_flags({"serving_telemetry": False})
    telemetry.span("tdeadbeef0001", telemetry.QUEUED, request_id="r1")
    assert telemetry.trace("tdeadbeef0001") == []
    flags.set_flags({"serving_telemetry": True})
    telemetry.span("tdeadbeef0001", telemetry.QUEUED, request_id="r1")
    telemetry.span("", telemetry.QUEUED)  # no trace_id: dropped
    evs = telemetry.trace("tdeadbeef0001")
    assert [e["event"] for e in evs] == [telemetry.QUEUED]
    assert evs[0]["request_id"] == "r1" and evs[0]["ts"] > 0
    raw = telemetry.events_since(-1)
    assert raw[-1][1:3] == ["tdeadbeef0001", telemetry.QUEUED]
    telemetry.ingest([[0, "tother0000001", telemetry.FINISHED, 1.5, {}],
                      ["malformed"]])
    assert [e["event"] for e in telemetry.trace("tother0000001")] == [
        telemetry.FINISHED]


def test_tracelog_ring_drops_oldest_and_counts():
    log = telemetry.TraceLog(capacity=16)
    s0 = metrics.stats().get("telemetry.spans_dropped", 0)
    for i in range(20):
        log.append("tring", telemetry.QUEUED, {"i": i})
    evs = log.trace("tring")
    assert [e["i"] for e in evs] == list(range(4, 20))
    assert metrics.stats()["telemetry.spans_dropped"] == s0 + 4
    seqs = [e["seq"] for e in evs]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_request_lifecycle_spans_and_histograms(model, spans_on):
    telemetry.reset_histograms()
    api = ServingAPI(model, ServingConfig(**API_KW), device="cpu")
    try:
        rng = np.random.default_rng(7)
        req = api.submit(rng.integers(0, VOCAB, 6), max_new_tokens=4)
        assert req.trace_id.startswith("t") and len(req.trace_id) == 13
        api.run_until_idle()
        assert req.state == RequestState.FINISHED
        evs = telemetry.trace(req.trace_id)
        assert [e["event"] for e in evs] == [
            telemetry.SUBMITTED, telemetry.QUEUED, telemetry.ADMITTED,
            telemetry.FIRST_TOKEN, telemetry.FINISHED]
        assert {e["trace_id"] for e in evs} == {req.trace_id}
        hists = telemetry.histograms()
        for name in ("latency.ttft", "latency.e2e", "latency.queue_wait",
                     "latency.prefill", "latency.decode_step",
                     "latency.inter_token"):
            assert hists[name].n > 0, name
        assert hists["latency.ttft"].n == 1 and hists["latency.e2e"].n == 1
        assert hists["latency.inter_token"].n == 3
        assert api.engine.hists.peek("latency.ttft").n == 1
        assert api.engine.hists.peek("latency.prefill").n == 1
        assert api.engine.hists.peek("latency.decode_step").n == 3
    finally:
        api.close()


def _kinds_of_workload(port, m):
    """One seeded workload, with spans on, through one package: two
    long low-priority requests on a tiny arena, a high-priority arrival
    that preempts one, a serving_device fault mid-decode (every live
    request replays), a cancel, and a drain that fails a queued request.
    Returns each request's span kinds in order."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, VOCAB, n) for n in (24, 24, 12, 6, 6)]
    if port:
        api = ServingAPI(m, ServingConfig(num_slots=2, kv_block_size=8,
                                          max_model_len=MAX_LEN,
                                          num_blocks=13), device="cpu")
        res, tel = resilience, telemetry
    else:
        api = JaxServingAPI(m, JaxServingConfig(
            num_slots=2, kv_block_size=8, max_model_len=MAX_LEN,
            num_blocks=13))
        res, tel = jax_resilience, jax_telemetry
        prompts = [np.asarray(p, np.int32) for p in prompts]
    try:
        low = [api.submit(p, max_new_tokens=20, priority=1)
               for p in prompts[:2]]
        for _ in range(3):
            api._pump_once()
        high = api.submit(prompts[2], max_new_tokens=8, priority=0)
        for _ in range(4):
            api._pump_once()
        res.inject_fault("serving_device", times=1)
        for _ in range(2):
            api._pump_once()
        gone = api.submit(prompts[3], max_new_tokens=4, priority=2)
        api.cancel(gone)
        api.run_until_idle()
        late = api.submit(prompts[4], max_new_tokens=4, priority=2)
        api.drain(grace=0)
        reqs = low + [high, gone, late]
        return ([[e["event"] for e in tel.trace(r.trace_id)] for r in reqs],
                [r.preemptions for r in reqs], [r.state for r in reqs])
    finally:
        api.close()
        res.clear_faults()


def test_span_kinds_of_a_workload_equal_jax(jax_model, model, spans_on):
    with _flags(serving_starvation_steps=1, fault_injection=1):
        jax_telemetry.reset_tracelog()
        ref = _kinds_of_workload(False, jax_model)
        telemetry.reset_tracelog()
        got = _kinds_of_workload(True, model)
    assert got == ref
    kinds, preemptions, states = got
    assert sum(preemptions) >= 1  # the arena pressure bit
    assert any(telemetry.REPLAYED in k for k in kinds)
    for k in kinds:
        assert k[0] == telemetry.SUBMITTED and k.count(telemetry.SUBMITTED) == 1
        assert k[-1] in (telemetry.FINISHED, telemetry.FAILED)
    victim = kinds[preemptions.index(max(preemptions))]
    i = victim.index(telemetry.PREEMPTED)
    assert telemetry.QUEUED in victim[i:] and telemetry.ADMITTED in victim[i:]
    assert kinds[4][-2:] == [telemetry.DRAINED, telemetry.FAILED]
    assert states[3] == RequestState.CANCELLED


# ------------------------------------------------------------ export plane


_PROM_LINE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*(\{[^{}]*\})? -?\d+(\.\d+)?([eE][+-]?\d+)?$")


def test_prometheus_text_is_valid_and_complete(model):
    telemetry.reset_histograms()
    api = ServingAPI(model, ServingConfig(**API_KW), device="cpu")
    try:
        api.submit(np.arange(5), max_new_tokens=3)
        api.run_until_idle()
    finally:
        api.close()
    text = telemetry.prometheus_text()
    assert text.endswith("\n")
    families = set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            _, _, fam, kind = line.split()
            assert kind in ("counter", "gauge", "histogram")
            families.add(fam)
        else:
            assert _PROM_LINE.match(line) or "+Inf" in line, line
    assert "paddle_serving_tokens_generated" in families
    assert "paddle_serving_slots_active" in families
    assert "paddle_latency_ttft_seconds" in families
    lines = text.splitlines()
    count = [ln for ln in lines
             if ln.startswith("paddle_latency_e2e_seconds_count")]
    inf = [ln for ln in lines
           if ln.startswith("paddle_latency_e2e_seconds_bucket")
           and 'le="+Inf"' in ln]
    assert count[0].rsplit(" ", 1)[1] == inf[0].rsplit(" ", 1)[1]
    assert 'quantile="0.99"' in text and 'quantile="0.50"' in text
    bucket_counts = [float(ln.rsplit(" ", 1)[1]) for ln in lines
                     if ln.startswith("paddle_latency_e2e_seconds_bucket")]
    assert bucket_counts == sorted(bucket_counts)


def test_chrome_events_structure(spans_on):
    for i in range(3):
        telemetry.span("tchrome000001", telemetry.SPAN_KINDS[i], step=i)
    telemetry.span("tchrome000002", telemetry.FINISHED)
    evs = telemetry.chrome_events(telemetry.trace_events())
    json.dumps(evs)
    lanes = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert lanes == {"tchrome000001", "tchrome000002"}
    slices = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]
    assert len(slices) == 2 and len(instants) == 2
    assert all(e["dur"] >= 0 and e["ts"] > 0 for e in slices)
    assert all(e["args"]["trace_id"] for e in slices + instants)
    assert telemetry.SPAN_KINDS == jax_telemetry.SPAN_KINDS
