"""The scheduler's admission policy of the PyTorch port against the JAX
package's: the same submit sequence goes through the JAX ``ServingAPI`` and
the port's, on ``gpt_tiny`` float32 with the JAX model's
``functional_state()`` weights, and these must be equal in both --

* the admission order by priority (FCFS within a class);
* starvation leading to preemption, and the victim chosen (lowest
  priority, most recently admitted);
* the decline when retiring every eligible victim could not seat the
  waiter;
* the bounded cache-affinity skips (``FLAGS_serving_cache_affinity``);
* the ``QueueOverloadError`` shed and ``shed=False``;
* deadline expiry in the queue and mid-decode, which frees the slot (an
  already expired ``Deadline``: no sleeps);
* journal resubmits (``submit(journal=)``), and a preempted greedy, seeded
  sampled and constrained request each resuming with the tokens of an
  uninterrupted run.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import constrain as jc
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (Deadline, DeadlineExceededError,
                                      QueueOverloadError, RequestState,
                                      SamplingParams, ServingAPI,
                                      ServingConfig, metrics)
from paddle_tpu_torch.serving import constrain as pc

torch.set_num_threads(1)

BS, MAX_LEN, VOCAB, STOP = 8, 64, 1024, 3
COUNTERS = ("scheduler.preemptions", "scheduler.cache_skips",
            "requests.shed", "requests.expired", "requests.finished",
            "requests.failed", "prefix.hits")


@pytest.fixture(scope="module", autouse=True)
def _invariants_on():
    with _flags(serving_arena_invariants=1):
        yield


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


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n)


class Side:
    """One package's API and the pieces a script needs from it."""

    def __init__(self, port, model, cfg, max_queue=None):
        self.port = port
        if port:
            self.api = ServingAPI(model, ServingConfig(**cfg), device="cpu",
                                  max_queue=max_queue)
            self.stats, self.sp, self.cmod = (metrics.stats, SamplingParams,
                                              pc)
        else:
            self.api = JaxServingAPI(model, JaxServingConfig(**cfg),
                                     max_queue=max_queue)
            self.stats, self.sp, self.cmod = (jax_metrics.stats,
                                              JaxSamplingParams, jc)
        self.before = self.stats()

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

    def pump(self, steps=None):
        if steps is None:
            self.api.run_until_idle()
        for _ in range(steps or 0):
            self.api.scheduler.step()

    def record(self, reqs):
        """What both packages must agree on."""
        admitted = sorted((r._admit_seq, i) for i, r in enumerate(reqs)
                          if r._admit_seq)
        now = self.stats()
        self.api.engine.check_invariants()
        assert self.api.engine.active_slots() == 0
        return dict(order=[i for _, i in admitted],
                    states=[r.state for r in reqs],
                    errors=[type(r.error).__name__ if r.error else None
                            for r in reqs],
                    preemptions=[r.preemptions for r in reqs],
                    skips=[r._cache_skips for r in reqs],
                    tokens=[[int(t) for t in r.tokens] for r in reqs],
                    counters={k: now.get(k, 0) - self.before.get(k, 0)
                              for k in COUNTERS})

    def close(self):
        self.api.close()


def _both(jax_model, model, cfg, script, max_queue=None):
    """Run ``script(side)`` (returns its requests) on the JAX package, then
    on the port; the two records must be equal. Returns the port's."""
    out = []
    for port, m in ((False, jax_model), (True, model)):
        side = Side(port, m, cfg, max_queue=max_queue)
        try:
            reqs = script(side)
            out.append(side.record(reqs))
        finally:
            side.close()
    assert out[1] == out[0]
    return out[1]


def _alone(model, prompt, n, **kw):
    """The tokens of an uninterrupted run of one request."""
    side = Side(True, model, dict(num_slots=1, kv_block_size=BS,
                                  max_model_len=MAX_LEN))
    try:
        r = side.submit(prompt, n, **kw)
        side.pump()
        assert r.state == RequestState.FINISHED
        return list(r.tokens)
    finally:
        side.close()


# ----------------------------------------------------------- admission


@pytest.mark.parametrize("priorities", [(5, 0, 5, 1, 0), (2, 2, 2),
                                        (9, 3, 7, 0, 3, 1)])
def test_priority_admission_order(jax_model, model, priorities):
    """One slot: requests are admitted lowest priority value first, in
    arrival order within a class."""
    rng = np.random.default_rng(len(priorities))
    prompts = [_prompt(rng, 4 + i) for i in range(len(priorities))]

    def script(side):
        reqs = [side.submit(p, 2, priority=pr)
                for p, pr in zip(prompts, priorities)]
        side.pump()
        return reqs

    rec = _both(jax_model, model, dict(num_slots=1, kv_block_size=BS,
                                       max_model_len=MAX_LEN), script)
    assert rec["order"] == sorted(range(len(priorities)),
                                  key=lambda i: (priorities[i], i))


@pytest.mark.parametrize("cache", [False, True], ids=["nocache", "cache"])
@pytest.mark.parametrize("starve", [1, 2, 4])
def test_starvation_preempts_lowest_most_recent(jax_model, model, starve,
                                                cache):
    """Two slots held by priorities 5 and 7; a priority-0 arrival starves
    for more than ``starve`` steps, then the priority-7 runner (the most
    recently admitted of the lowest class) is preempted, re-queued and
    resumed token for token. With the prefix cache on, the arrival's first
    two blocks are resident and the victim's re-admission hits its own
    prompt blocks and prefills only its journal."""
    rng = np.random.default_rng(40 + starve)
    lows = [_prompt(rng, 2 * BS + 1), _prompt(rng, 2 * BS + 3)]
    hp = np.concatenate([lows[0][:2 * BS], _prompt(rng, 5)])

    def script(side):
        reqs = [side.submit(lows[0], 20, priority=5),
                side.submit(lows[1], 20, priority=7)]
        side.pump(1)
        reqs.append(side.submit(hp, 10, priority=0))
        side.pump()
        return reqs

    with _flags(serving_starvation_steps=starve):
        rec = _both(jax_model, model, dict(num_slots=2, kv_block_size=BS,
                                           max_model_len=MAX_LEN,
                                           prefix_cache=cache), script)
    assert rec["preemptions"] == [0, 1, 0]
    assert rec["counters"]["scheduler.preemptions"] == 1
    assert rec["order"] == [0, 2, 1]  # the victim re-admitted last
    assert rec["counters"]["prefix.hits"] == (2 if cache else 0)
    for p, n, toks in ((lows[0], 20, rec["tokens"][0]),
                       (lows[1], 20, rec["tokens"][1]),
                       (hp, 10, rec["tokens"][2])):
        assert toks == _alone(model, p, n)


def test_preemption_declines_when_it_cannot_seat(jax_model, model):
    """4 allocatable blocks: a priority-0 holder of 2 and a priority-9
    runner of 1; a priority-0 waiter needing 4 cannot be seated even by
    retiring the victim, so nothing is preempted and all complete."""
    rng = np.random.default_rng(49)
    prompts = [_prompt(rng, 8), _prompt(rng, 4), _prompt(rng, 8)]

    def script(side):
        reqs = [side.submit(prompts[0], 8, priority=0),
                side.submit(prompts[1], 4, priority=9)]
        side.pump(1)
        reqs.append(side.submit(prompts[2], 24, priority=0))
        side.pump(4)
        assert reqs[1].preemptions == 0
        side.pump()
        return reqs

    with _flags(serving_starvation_steps=1):
        rec = _both(jax_model, model, dict(num_slots=3, kv_block_size=BS,
                                           max_model_len=MAX_LEN,
                                           num_blocks=5), script)
    assert rec["counters"]["scheduler.preemptions"] == 0
    assert rec["states"] == [RequestState.FINISHED] * 3


@pytest.mark.parametrize("window", [0, 1, 2])
def test_cache_affinity_skips_are_bounded(jax_model, model, window):
    """One slot, the prefix cache on: a warm prefix, then a cold head
    followed by three warm waiters of its class. With a window of W the
    cold head is skipped at most W times (counted on it and in
    ``scheduler.cache_skips``), never across priorities."""
    rng = np.random.default_rng(60)
    sys_p = _prompt(rng, 3 * BS)
    cold = _prompt(rng, 20)
    warm = [np.concatenate([sys_p, _prompt(rng, 2 + i)]) for i in range(3)]

    def script(side):
        reqs = [side.submit(np.concatenate([sys_p, _prompt(
            np.random.default_rng(1), 3)]), 3)]
        side.pump()
        reqs.append(side.submit(cold, 3))
        reqs += [side.submit(p, 3) for p in warm]
        reqs.append(side.submit(warm[0], 3, priority=1))
        side.pump()
        return reqs

    with _flags(serving_cache_affinity=window):
        rec = _both(jax_model, model, dict(num_slots=1, kv_block_size=BS,
                                           max_model_len=MAX_LEN,
                                           prefix_cache=True), script)
    assert rec["skips"][1] == min(window, 3)
    assert rec["counters"]["scheduler.cache_skips"] == min(window, 3)
    assert rec["order"].index(1) == 1 + min(window, 3)
    assert rec["order"][-1] == 5  # the priority-1 waiter stays last


def test_queue_overload_sheds(jax_model, model):
    """``max_queue=2``: the third waiting submit raises QueueOverloadError
    and counts in ``requests.shed``; ``shed=False`` bypasses the limit."""
    rng = np.random.default_rng(8)
    prompts = [_prompt(rng, 4) for _ in range(4)]
    raised = []

    def script(side):
        reqs = [side.submit(p, 2) for p in prompts[:2]]
        err = (QueueOverloadError if side.port
               else jax_resilience.QueueOverloadError)
        with pytest.raises(err):
            side.submit(prompts[2], 2)
        raised.append(side.port)
        reqs.append(side.submit(prompts[3], 2, shed=False))
        side.pump()
        return reqs

    rec = _both(jax_model, model, dict(num_slots=2, kv_block_size=BS,
                                       max_model_len=MAX_LEN), script,
                max_queue=2)
    assert raised == [False, True]
    assert rec["counters"]["requests.shed"] == 1
    assert rec["states"] == [RequestState.FINISHED] * 3


def test_overload_flag_is_the_default_limit(model):
    """Without ``max_queue`` the limit is ``FLAGS_serving_max_queue``
    (0 = unlimited)."""
    api = ServingAPI(model, ServingConfig(num_slots=1, kv_block_size=BS,
                                          max_model_len=MAX_LEN),
                     device="cpu")
    try:
        with _flags(serving_max_queue=1):
            r = api.submit(np.arange(4), max_new_tokens=2)
            with pytest.raises(QueueOverloadError):
                api.submit(np.arange(5), max_new_tokens=2)
        api.submit(np.arange(6), max_new_tokens=2)
        api.run_until_idle()
        assert r.state == RequestState.FINISHED
    finally:
        api.close()


def test_deadline_expiry_in_queue_and_mid_decode(jax_model, model):
    """An already expired request is culled in the queue before it costs a
    prefill; a running request whose deadline passes mid-decode fails at
    the next boundary with DeadlineExceededError and frees its slot, and
    the waiter behind it is admitted into that slot."""
    rng = np.random.default_rng(7)
    prompts = [_prompt(rng, 5) for _ in range(3)]

    def script(side):
        reqs = [side.submit(prompts[0], 2, timeout=0.0),
                side.submit(prompts[1], 30),
                side.submit(prompts[2], 4)]
        side.pump(3)
        assert reqs[1].state == RequestState.RUNNING
        reqs[1].deadline = type(reqs[1].deadline)(0.0)  # expired now
        side.pump()
        return reqs

    rec = _both(jax_model, model, dict(num_slots=1, kv_block_size=BS,
                                       max_model_len=MAX_LEN), script)
    assert rec["states"] == [RequestState.FAILED, RequestState.FAILED,
                             RequestState.FINISHED]
    assert rec["errors"][:2] == ["DeadlineExceededError"] * 2
    assert rec["order"] == [1, 2] and rec["tokens"][0] == []
    assert 0 < len(rec["tokens"][1]) < 30
    assert rec["counters"]["requests.expired"] == 2


def test_deadline_helpers():
    before = resilience.stats().get("deadline.exceeded", 0)
    assert not Deadline().expired() and Deadline().remaining() == float("inf")
    assert Deadline.after(3600).remaining() > 3500
    with pytest.raises(DeadlineExceededError):
        Deadline(0.0).check("unit")
    assert resilience.stats()["deadline.exceeded"] == before + 1
    resilience.check_overload(5, 0)  # 0 = unlimited
    with pytest.raises(QueueOverloadError):
        resilience.check_overload(2, 2, name="unit")
    assert resilience.stats()["overload.unit.shed"] >= 1


# -------------------------------------------------------------- journals


def test_journal_resubmit_streams_only_new_tokens(jax_model, model):
    """``submit(journal=)`` prefills prompt + journal and streams only the
    tokens past it; the whole output equals an uninterrupted run. A journal
    that exhausts max_new_tokens is refused."""
    rng = np.random.default_rng(31)
    p = _prompt(rng, 11)
    full = _alone(model, p, 12)
    streamed = []

    def script(side):
        with pytest.raises(ValueError, match="exhausts"):
            side.submit(p, 5, journal=full[:5])
        r = side.submit(p, 12, journal=full[:5])
        streamed.append(list(side.api.stream(r)))
        return [r]

    rec = _both(jax_model, model, dict(num_slots=2, kv_block_size=BS,
                                       max_model_len=MAX_LEN), script)
    assert rec["tokens"][0] == full
    assert streamed[0] == streamed[1] == full[5:]


KINDS = {"greedy": {}, "sampled": dict(sampling=dict(
    temperature=0.8, top_k=50, top_p=0.95, seed=7)),
    "constrained": dict(constraint=[[5, 6, 7, 8, 9, 10, 11, 12, 13, 14],
                                    [5, 6, 20, 21, 22, 23, 24, 25, 26]])}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_preempted_request_resumes_token_for_token(jax_model, model, kind):
    """The victim (priority 5, admitted second) is preempted by a
    priority-0 arrival after a few tokens and resumes from its journal:
    greedy, seeded sampled (positional keys) and constrained (the walker
    rebuilt from the journal) alike equal an uninterrupted run."""
    rng = np.random.default_rng(70)
    filler, victim, hp = _prompt(rng, 7), _prompt(rng, 10), _prompt(rng, 9)
    kw = KINDS[kind]

    def script(side):
        reqs = [side.submit(filler, 14, priority=2),
                side.submit(victim, 14, priority=5, **kw)]
        side.pump(4)
        reqs.append(side.submit(hp, 6, priority=0))
        side.pump()
        return reqs

    with _flags(serving_starvation_steps=1):
        rec = _both(jax_model, model, dict(num_slots=2, kv_block_size=BS,
                                           max_model_len=MAX_LEN), script)
    assert rec["preemptions"] == [0, 1, 0]
    assert rec["tokens"][1] == _alone(model, victim, 14, **kw)
    if kind == "constrained":
        assert rec["tokens"][1][-1] == STOP
        assert rec["tokens"][1][:-1] in KINDS[kind]["constraint"]
