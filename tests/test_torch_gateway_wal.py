"""The gateway's write-ahead log in the PyTorch port (``paddle_tpu_torch/
serving/gateway/wal.py``, the router's and the gateway's WAL hooks,
``wal_harness.py``) against the JAX package, on the CPU: every case of
``tests/test_gateway_wal.py`` -- the record framing, the torn tail,
rotation, compaction and its carries, recovery in process with greedy,
seeded-sampled and constrained streams, the exactly-once HTTP surface,
readiness during the replay, the order of the WAL's last sync and the
worker reap, and the SIGKILL of a gateway process restarted on its
directory (the port's harness with ``--device cpu``) -- and two of the
port's own: the same call sequence writes byte-equal segment files in both
packages, and each package replays the other's; and the ``gateway_kill``
fault, which SIGKILLs the harness at a WAL sweep.

``gpt_tiny`` float32 on ``gpt.seeded_state(0)``, the JAX model loaded with
the same arrays: recovered greedy streams equal the JAX model's
``generate()``; sampled and constrained ones equal a WAL-less reference
pool of the port's (the in-process reference pools are also the
``FLAGS_gateway_wal=0`` default path).
"""
import json
import os
import shutil
import signal
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving.gateway import GatewayWAL as JaxGatewayWAL
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (ReplicaPool, RequestState,
                                      SamplingParams, TrieConstraint,
                                      metrics, telemetry)
from paddle_tpu_torch.serving.gateway import (Gateway, GatewayWAL,
                                              ProcessReplicaPool)

torch.set_num_threads(1)

pytestmark = [pytest.mark.serving, pytest.mark.gateway]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, MAX_LEN = 1024, 64
POOL_KW = dict(num_slots=4, kv_block_size=8, max_model_len=MAX_LEN,
               device="cpu")
CHOICES = [[5, 6, 7], [5, 9]]


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.gpt_tiny(),
                                               device="cpu"), seed=0)


@pytest.fixture(scope="module")
def model(arrays):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    return m


@pytest.fixture(scope="module")
def jax_model(arrays):
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


def _prompt(rng, n):
    return rng.integers(0, VOCAB, (n,), dtype=np.int32)


def _jax_ref(jax_model, prompt, max_new):
    """The JAX model's greedy ``generate()``: prompt + new tokens."""
    out = jax_model.generate(JaxTensor(np.asarray(prompt, np.int32)[None]),
                             max_new_tokens=max_new)
    return np.asarray(out._data)[0]


def _rr(rid, prompt=(1, 2, 3), mnt=8, sampling=None):
    """A stand-in for ``RoutedRequest`` with exactly what
    ``GatewayWAL.accepted`` journals."""
    return types.SimpleNamespace(
        request_id=rid, tenant="default", prompt=list(prompt),
        max_new_tokens=mnt, stop_token_id=None, priority=1, adapter=0,
        sampling=sampling, trace_id=f"trace-{rid}")


def _read_sse(url, timeout=180):
    toks, done = [], None
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        event = None
        for line in resp:
            line = line.decode().strip()
            if line.startswith("event:"):
                event = line.split(":", 1)[1].strip()
            elif line.startswith("data:"):
                d = json.loads(line.split(":", 1)[1])
                if event == "done":
                    done = d
                else:
                    toks.append(d["token"])
                event = None
    return toks, done


def _wait_ready(base, deadline_s=120):
    """Poll ``/healthz`` until it reports ok; returns every status seen on
    the way (the 503 bodies included)."""
    seen = []
    deadline = time.time() + deadline_s
    while True:
        try:
            h = json.load(urllib.request.urlopen(base + "/healthz",
                                                 timeout=10))
        except urllib.error.HTTPError as e:
            h = json.load(e)
        seen.append(h["status"])
        if h["status"] == "ok":
            return seen
        assert time.time() < deadline, f"never became ready: {seen[-5:]}"
        time.sleep(0.02)


def _post(base, path, body, timeout=120):
    return json.load(urllib.request.urlopen(urllib.request.Request(
        base + path, data=json.dumps(body).encode(), method="POST"),
        timeout=timeout))


def _segments(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith("wal-")}


# --------------------------------------------------------- WAL file format


def test_wal_roundtrip_and_torn_tail(tmp_path):
    """Append, crash (no close), replay folds the records back; a torn tail
    (a frame cut short) ends the replay at the last good record and bumps
    the torn-tail counter instead of raising."""
    d = str(tmp_path / "wal")
    w = GatewayWAL(d)
    w.accepted(_rr("r1"), {"choices": CHOICES, "stop_token_id": 3})
    w.emitted("r1", [10, 11])
    w.moved("r1", "HANDOFF")
    w.accepted(_rr("r2"))
    w.emitted("r2", [20])
    w.terminal("r2", "FINISHED", [30], [20, 30])
    w.commit()
    # the crash: no close(), no sync beyond the committed batch

    w2 = GatewayWAL(d)
    rec = w2.recover()
    assert [e["rid"] for e in rec["live"]] == ["r1"]
    live = rec["live"][0]
    assert live["toks"] == [10, 11]
    assert live["phase"] == "decode"          # the HANDOFF move replayed
    assert live["prompt"] == [1, 2, 3]
    assert live["cspec"] == {"choices": CHOICES, "stop_token_id": 3}
    assert live["tid"] == "trace-r1"
    assert rec["results"]["r2"] == {"state": "FINISHED",
                                    "tokens": [20, 30]}
    # recover() hands its state out once
    assert w2.recover()["live"] == []

    # a torn tail: a header promising more body than was written
    with open(os.path.join(d, "wal-00000000.log"), "ab") as f:
        f.write(struct.pack("<II", 40, 0) + b"short")
    t0 = metrics.stats().get("wal.torn_tail", 0)
    rec3 = GatewayWAL(d).recover()
    assert [e["rid"] for e in rec3["live"]] == ["r1"]
    assert rec3["live"][0]["toks"] == [10, 11]
    assert metrics.stats().get("wal.torn_tail", 0) == t0 + 1


def test_wal_rotation_and_compaction_carry_forward(tmp_path):
    """With a 1-byte segment budget every commit rotates; a sealed segment
    whose every stream is terminal is deleted with its results carried
    forward, and a segment holding a live stream survives."""
    d = str(tmp_path / "wal")
    m0 = metrics.stats()
    w = GatewayWAL(d, segment_bytes=1, result_cap=8)
    w.accepted(_rr("c1"))
    w.emitted("c1", [1, 2])
    w.terminal("c1", "FINISHED", [], [1, 2])
    w.commit()  # seals segment 0: all terminal, carried and deleted
    assert not os.path.exists(os.path.join(d, "wal-00000000.log"))

    w.accepted(_rr("c2"))
    w.commit()  # seals the carry's segment: c2 is live, it survives
    assert len([n for n in os.listdir(d) if n.startswith("wal-")]) == 2

    w.terminal("c2", "FINISHED", [7], [7])
    w.commit()  # all terminal: only the active segment is left
    assert len([n for n in os.listdir(d) if n.startswith("wal-")]) == 1
    m1 = metrics.stats()
    assert m1.get("wal.rotations", 0) > m0.get("wal.rotations", 0)
    assert m1.get("wal.compactions", 0) >= m0.get("wal.compactions", 0) + 2
    assert m1.get("wal.carried", 0) > m0.get("wal.carried", 0)
    assert w.stats()["segments"] == 1
    w.close()

    # the carried summaries replay: nothing live, the results intact
    rec = GatewayWAL(d).recover()
    assert rec["live"] == []
    assert rec["results"]["c1"]["tokens"] == [1, 2]
    assert rec["results"]["c2"]["tokens"] == [7]


def test_wal_tombstone_replay_and_terminal_gc(tmp_path):
    """A terminal request whose result left the bounded cache compacts to a
    token-free tombstone while later segments still hold its records; its
    replay comes up clean (terminal, no result, not live). A rid compacted
    away with no record left leaves the terminal set."""
    d = str(tmp_path / "wal")
    w = GatewayWAL(d, segment_bytes=1, result_cap=1)
    # x spans three segments (A | E | T), so compacting the older ones
    # needs a tombstone; y evicts x's result from the cache of one first
    w.accepted(_rr("x"))
    w.commit()                    # seals seg0 (x live: kept)
    w.emitted("x", [1])
    w.commit()                    # seals seg1 (x still live)
    w.terminal("x", "FINISHED", [2], [1, 2])
    w.accepted(_rr("y"))
    w.terminal("y", "FINISHED", [3], [3])   # cap 1: x's result evicted
    w.commit()   # all terminal: seg0..2 compact through tombstones
    assert not os.path.exists(os.path.join(d, "wal-00000000.log"))
    w.close()

    rec = GatewayWAL(d).recover()   # the tombstone must not raise
    assert rec["live"] == []                 # x never comes back...
    assert "x" not in rec["results"]         # ...and stays forgotten
    assert rec["results"]["y"]["tokens"] == [3]

    # the terminal set's collection: z lives and dies inside seg0, its
    # result evicted before compaction: no carry, no record left
    d2 = str(tmp_path / "wal2")
    w2 = GatewayWAL(d2, segment_bytes=1, result_cap=1)
    w2.accepted(_rr("z"))
    w2.terminal("z", "FINISHED", [1], [1])
    w2.accepted(_rr("q"))
    w2.terminal("q", "FINISHED", [2], [2])   # evicts z's result
    w2.commit()   # seg0 compacts: q carried (R), z dropped whole
    assert w2.stats()["terminal"] == 1       # q only: z not leaked
    w2.close()


def test_wal_compaction_carry_durable_before_unlink(tmp_path):
    """Compaction syncs its carries into the active segment before it
    unlinks the compacted one: a crash right after the unlink (no close, no
    later commit) still replays the carried result."""
    d = str(tmp_path / "wal")
    w = GatewayWAL(d, segment_bytes=1, result_cap=8)
    w.accepted(_rr("c1"))
    w.terminal("c1", "FINISHED", [1, 2], [1, 2])
    w.commit()   # seals and compacts seg0, carrying c1's result
    assert not os.path.exists(os.path.join(d, "wal-00000000.log"))
    rec = GatewayWAL(d).recover()  # the crash: no close, no commit
    assert rec["live"] == []
    assert rec["results"]["c1"] == {"state": "FINISHED", "tokens": [1, 2]}


def _sequence(wal, samp_cls, rotate):
    """One call sequence on a WAL of either package (``samp_cls`` its
    ``SamplingParams``): accepted (greedy with a constraint spec, sampled),
    emitted, moved, terminal, commit; with ``rotate`` (a 1-byte segment
    budget) every commit rotates, and compaction carries R and T records."""
    wal.accepted(_rr("s1"), {"choices": CHOICES, "stop_token_id": 3})
    wal.emitted("s1", [10, 11])
    wal.accepted(_rr("s2", prompt=(4, 5, 6, 7), mnt=12, sampling=samp_cls(
        temperature=0.8, top_k=50, top_p=0.95, seed=42)))
    wal.commit()
    wal.emitted("s2", [20, 21, 22])
    wal.moved("s1", "REROUTE")
    wal.moved("s2", "HANDOFF")
    wal.terminal("s1", "FINISHED", [12, 3], [10, 11, 12, 3])
    wal.commit()
    wal.emitted("s2", [23])
    wal.terminal("s2", "FAILED", [24], [20, 21, 22, 23, 24])
    wal.accepted(_rr("s3"))
    wal.emitted("s3", [30])
    wal.commit()
    if rotate:
        wal.terminal("s3", "CANCELLED", [], [30])
        wal.commit()


@pytest.mark.parametrize("rotate", [False, True], ids=["one", "rotating"])
def test_segments_byte_equal_to_jax_and_cross_replay(tmp_path, rotate):
    """The same call sequence on the port's ``GatewayWAL`` and the JAX
    one writes byte-equal segment files (the same names, the same bytes:
    no field differs), and each package's replay of the other's directory
    equals the replay of its own."""
    kw = dict(segment_bytes=1, result_cap=8) if rotate else {}
    ours_d, theirs_d = str(tmp_path / "ours"), str(tmp_path / "theirs")
    ours, theirs = GatewayWAL(ours_d, **kw), JaxGatewayWAL(theirs_d, **kw)
    _sequence(ours, SamplingParams, rotate)
    _sequence(theirs, JaxSamplingParams, rotate)
    segs = _segments(ours_d)
    assert segs and segs == _segments(theirs_d)
    assert sum(len(b) for b in segs.values()) > 0
    # each replays the other's (a copy: a replay opens a new segment)
    for reader, src in ((GatewayWAL, theirs_d), (JaxGatewayWAL, ours_d)):
        dst = str(tmp_path / f"{reader.__module__}-{os.path.basename(src)}")
        shutil.copytree(src, dst)
        got = reader(dst).recover()
        mine = str(tmp_path / f"own-{reader.__module__}")
        shutil.copytree(ours_d if reader is GatewayWAL else theirs_d, mine)
        assert got == reader(mine).recover()
        live = {e["rid"]: e for e in got["live"]}
        if rotate:
            assert live == {}
            assert got["results"]["s3"] == {"state": "CANCELLED",
                                            "tokens": [30]}
        else:
            assert set(live) == {"s3"} and live["s3"]["toks"] == [30]
        assert got["results"]["s1"] == {"state": "FINISHED",
                                        "tokens": [10, 11, 12, 3]}
        assert got["results"]["s2"]["tokens"] == [20, 21, 22, 23, 24]
    ours.close()
    theirs.close()


# ------------------------------------------------- in-process recovery


def test_pool_crash_recovery_token_parity(model, jax_model, tmp_path):
    """In process: a WAL'd foreground pool left mid-decode (no close: the
    crash) is rebuilt by a new pool on the same directory, and every
    recovered stream finishes token for token as it would have: the greedy
    one equal to the JAX model's ``generate()``, the seeded-sampled and
    constrained ones to a WAL-less pool's. The journaled trace id keeps one
    timeline across the restart, with a RECOVERED span at the seam."""
    keep = flags.get_flags("serving_telemetry")
    flags.set_flags({"serving_telemetry": True})
    telemetry.reset_tracelog()
    d = str(tmp_path / "wal")
    pool2 = refpool = None
    try:
        rng = np.random.default_rng(11)
        p1, p2, p3 = _prompt(rng, 8), _prompt(rng, 8), _prompt(rng, 5)
        ref1 = _jax_ref(jax_model, p1, 8)

        pool = ReplicaPool(model, replicas=1, wal=GatewayWAL(d), **POOL_KW)
        pool.submit(p1, max_new_tokens=8, request_id="r1")
        pool.submit(p2, max_new_tokens=8, request_id="r2",
                    sampling=SamplingParams(temperature=0.8, seed=42))
        pool.submit(p3, max_new_tokens=8, stop_token_id=3, request_id="r3",
                    constraint=TrieConstraint(
                        CHOICES, vocab_size=pool.vocab_size(),
                        stop_token_id=3),
                    constraint_spec={"choices": CHOICES,
                                     "stop_token_id": 3})
        for _ in range(3):
            pool.pump_once()  # every stream mid-flight
        # the crash: the pool is left without close or drain

        refpool = ReplicaPool(model, replicas=1, **POOL_KW)
        q2 = refpool.submit(p2, max_new_tokens=8,
                            sampling=SamplingParams(temperature=0.8,
                                                    seed=42))
        q3 = refpool.submit(p3, max_new_tokens=8, stop_token_id=3,
                            constraint=TrieConstraint(
                                CHOICES, vocab_size=refpool.vocab_size(),
                                stop_token_id=3))
        refpool.run_until_idle(timeout=120)
        ref2, ref3 = list(q2.tokens()), list(q3.tokens())

        g0 = metrics.stats().get("gateway.recovered", 0)
        pool2 = ReplicaPool(model, replicas=1, wal=GatewayWAL(d), **POOL_KW)
        assert not pool2.recovering  # a foreground pool recovers inline
        rec = {rr.request_id: rr for rr in pool2.recovered_live()}
        assert set(rec) == {"r1", "r2", "r3"}
        assert metrics.stats().get("gateway.recovered", 0) == g0 + 3
        pool2.run_until_idle(timeout=120)

        assert rec["r1"].state == RequestState.FINISHED
        np.testing.assert_array_equal(
            np.concatenate([p1, rec["r1"].tokens()]), ref1)
        assert list(rec["r2"].tokens()) == ref2
        assert list(rec["r3"].tokens()) == ref3
        assert list(rec["r3"].tokens()) in ([5, 6, 7, 3], [5, 9, 3])

        # one trace over both pools: one SUBMITTED (the first life's), a
        # RECOVERED span at the seam, and the resubmission records no
        # second FIRST_TOKEN
        kinds = [e["event"] for e in telemetry.trace(rec["r1"].trace_id)]
        assert kinds.count(telemetry.SUBMITTED) == 1
        assert telemetry.RECOVERED in kinds
        assert kinds.count(telemetry.FIRST_TOKEN) == 1
        assert kinds.index(telemetry.RECOVERED) \
            > kinds.index(telemetry.SUBMITTED)
    finally:
        if refpool is not None:
            refpool.close()
        if pool2 is not None:
            pool2.close()
        flags.set_flags(keep)
        telemetry.reset_tracelog()


def test_wal_terminal_not_skipped_when_finalized_during_submit(
        model, jax_model, tmp_path):
    """A stream that finishes, and is swept, between its routing and its
    ACCEPTED record still gets its TERMINAL record: a log of the ACCEPTED
    alone would replay the finished stream as live."""
    d = str(tmp_path / "wal")
    rng = np.random.default_rng(23)
    p = _prompt(rng, 6)
    ref = _jax_ref(jax_model, p, 4)
    pool = ReplicaPool(model, replicas=1, wal=GatewayWAL(d), **POOL_KW)
    orig_route = ReplicaPool._route

    def route_then_sweep(self, rr, journal):
        # the race at its worst: the stream runs to its end and the sweep
        # finalizes it before submit appends the ACCEPTED record
        orig_route(self, rr, journal)
        self.run_until_idle(timeout=120)
        assert rr.finished

    ReplicaPool._route = route_then_sweep
    try:
        rr = pool.submit(p, max_new_tokens=4, request_id="early")
    finally:
        ReplicaPool._route = orig_route
    assert rr.state == RequestState.FINISHED
    toks = list(rr.tokens())
    np.testing.assert_array_equal(np.concatenate([p, toks]), ref)
    pool.close()

    rec = GatewayWAL(d).recover()
    assert rec["live"] == []        # the TERMINAL is in the log
    assert rec["results"]["early"]["state"] == RequestState.FINISHED
    assert rec["results"]["early"]["tokens"] == toks


# ------------------------------------------------ HTTP exactly-once


def test_http_restart_exactly_once(model, jax_model, tmp_path):
    """The client's contract across a restart: a WAL-live id submitted to
    the new pool is a 409 (never a second decode), a terminal id's result
    comes from the recovered cache with ``cached: true``, and ``GET
    /v1/stream/<id>?offset=N`` resumes the recovered stream with no token
    twice and none missing."""
    d = str(tmp_path / "wal")
    rng = np.random.default_rng(17)
    p_done, p_live = _prompt(rng, 6), _prompt(rng, 6)
    ref_done = [int(t) for t in _jax_ref(jax_model, p_done, 6)[6:]]
    ref_live = [int(t) for t in _jax_ref(jax_model, p_live, 48)[6:]]

    pool1 = ReplicaPool(model, replicas=1, wal=GatewayWAL(d), **POOL_KW)
    done_rr = pool1.submit(p_done, max_new_tokens=6, request_id="dup-done")
    pool1.run_until_idle(timeout=120)
    assert done_rr.state == RequestState.FINISHED
    live_rr = pool1.submit(p_live, max_new_tokens=48, request_id="dup-live")
    for _ in range(4):
        pool1.pump_once()
    assert not live_rr.finished
    prefix = [int(t) for t in live_rr.tokens()]
    assert prefix  # the client before the crash got a real prefix
    # the crash: pool1 is left without close

    pool2 = ReplicaPool(model, replicas=1, wal=GatewayWAL(d),
                        background=True, **POOL_KW)
    gw = Gateway(pool2, port=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        _wait_ready(base)

        # the recovered stream is live again: a duplicate submit is 409
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/submit", {"prompt": p_live.tolist(),
                                       "max_new_tokens": 48,
                                       "request_id": "dup-live"}, 60)
        assert ei.value.code == 409

        # resume after the prefix the client holds: exactly the rest
        toks, done = _read_sse(
            base + f"/v1/stream/dup-live?offset={len(prefix)}")
        assert prefix + toks == ref_live
        assert done["state"] == "FINISHED"
        toks_all, _ = _read_sse(base + "/v1/stream/dup-live?offset=0")
        assert toks_all == ref_live

        # a terminal id of the previous life: the recovered result cache
        res = json.load(urllib.request.urlopen(
            base + "/v1/result/dup-done", timeout=30))
        assert res["cached"] is True
        assert res["state"] == "FINISHED"
        assert res["tokens"] == ref_done
        # submitting the terminal id again answers from the cache too
        sub = _post(base, "/v1/submit", {"prompt": p_done.tolist(),
                                         "request_id": "dup-done"}, 30)
        assert sub["cached"] is True and sub["tokens"] == ref_done
    finally:
        gw.close()


def test_healthz_readiness_split_during_replay(model, tmp_path):
    """While the WAL replay runs the gateway is alive but not ready:
    ``/healthz`` 503 with Retry-After and the status ``recovering``,
    ``/livez`` 200 throughout; 200 only once recovery hands routing
    back."""
    gate = threading.Event()

    class BlockingWAL(GatewayWAL):
        def recover(self):
            gate.wait(30)
            return super().recover()

    pool = ReplicaPool(model, replicas=1, wal=BlockingWAL(
        str(tmp_path / "wal")), background=True, **POOL_KW)
    gw = Gateway(pool, port=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ei.value.code == 503
        assert float(ei.value.headers["Retry-After"]) > 0
        body = json.load(ei.value)
        assert body["status"] == "recovering"
        assert "wal" in body
        # liveness stays green: a gateway replaying its log must not be
        # restarted
        lv = json.load(urllib.request.urlopen(base + "/livez", timeout=10))
        assert lv["status"] == "alive"

        gate.set()
        seen = _wait_ready(base, 60)
        assert seen[-1] == "ok"
    finally:
        gate.set()
        gw.close()


# -------------------------------------------------- shutdown ordering


def test_close_orders_wal_flush_before_worker_reap(model, jax_model,
                                                   tmp_path):
    """On a clean close the WAL's terminal sweep and last fsync come
    strictly before the worker processes are reaped, and a reopened WAL
    replays nothing live."""
    d = str(tmp_path / "wal")
    wal = GatewayWAL(d)
    pool = ProcessReplicaPool(model, replicas=1, background=True,
                              wal=wal, respawn_backoff=0.5,
                              heartbeat_interval=0.2, heartbeat_misses=5,
                              worker_timeout=10.0, **POOL_KW)
    try:
        rng = np.random.default_rng(19)
        p = _prompt(rng, 6)
        ref = _jax_ref(jax_model, p, 6)
        rr = pool.submit(p, max_new_tokens=6, request_id="w1")
        out = pool.result(rr, timeout=180)
        np.testing.assert_array_equal(out, ref)
    except BaseException:
        pool.close()
        raise

    order = []
    orig_close, orig_reap = wal.close, pool._reap_workers

    def traced_close():
        order.append("wal-close")
        orig_close()

    def traced_reap(*a, **kw):
        order.append("reap")
        return orig_reap(*a, **kw)

    wal.close = traced_close
    pool._reap_workers = traced_reap
    pool.close()
    assert "wal-close" in order and "reap" in order
    assert order.index("wal-close") < order.index("reap")

    rec = GatewayWAL(d).recover()
    assert rec["live"] == []  # a clean shutdown leaves nothing live
    assert rec["results"]["w1"]["state"] == "FINISHED"
    assert rec["results"]["w1"]["tokens"] == [int(t) for t in ref[6:]]


# ------------------------------------------------------- chaos e2e


def _boot_harness(wal_dir, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.gateway.wal_harness",
         "--wal-dir", wal_dir, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        cwd=REPO, env=env, text=True)
    line = proc.stdout.readline()
    assert line, "the harness died before printing its port"
    info = json.loads(line)
    return proc, f"http://127.0.0.1:{info['port']}", info["pid"]


def _kill_proc(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    if proc.stdout is not None:
        proc.stdout.close()


def _submit_three(base, pg, ps, pc):
    for body in (
            {"prompt": pg.tolist(), "max_new_tokens": 24,
             "request_id": "cg"},
            {"prompt": ps.tolist(), "max_new_tokens": 24,
             "temperature": 0.9, "seed": 7, "request_id": "cs"},
            {"prompt": pc.tolist(), "max_new_tokens": 8,
             "stop_token_id": 3, "choices": CHOICES,
             "request_id": "cc"}):
        sub = _post(base, "/v1/submit", body)
        assert sub["request_id"] == body["request_id"]


def _chaos_refs(model, jax_model, pg, ps, pc):
    """The uninterrupted streams: greedy from the JAX model, sampled and
    constrained from a WAL-less pool of the port (the harness serves
    ``gpt.seeded_state(0)``, the weights of these models)."""
    ref_g = [int(t) for t in _jax_ref(jax_model, pg, 24)[6:]]
    refpool = ReplicaPool(model, replicas=1, **POOL_KW)
    qs = refpool.submit(ps, max_new_tokens=24,
                        sampling=SamplingParams(temperature=0.9, seed=7))
    qc = refpool.submit(pc, max_new_tokens=8, stop_token_id=3,
                        constraint=TrieConstraint(
                            CHOICES, vocab_size=refpool.vocab_size(),
                            stop_token_id=3))
    refpool.run_until_idle(timeout=120)
    refpool.close()
    return ref_g, list(qs.tokens()), list(qc.tokens())


def test_sigkill_chaos_exactly_once_across_restart(model, jax_model,
                                                   tmp_path):
    """A gateway process SIGKILLed mid-stream (greedy, seeded-sampled and
    constrained streams in flight), a second one booted on the same WAL
    directory, and every accepted stream finishes token for token as the
    uninterrupted one: the ``?offset=`` client sees no token twice and
    none missing, the terminal id's retry answers from the cache, and the
    build counters stay frozen once the first resumed stream finished (the
    journal replay builds nothing new)."""
    d = str(tmp_path / "wal")
    rng = np.random.default_rng(29)
    pg, ps, pc = _prompt(rng, 6), _prompt(rng, 6), _prompt(rng, 5)
    ref_g, ref_s, ref_c = _chaos_refs(model, jax_model, pg, ps, pc)

    proc1, base1, pid1 = _boot_harness(d)
    seen = []
    try:
        _wait_ready(base1)
        _submit_three(base1, pg, ps, pc)
        # the client before the crash reads a few greedy tokens, then the
        # process dies mid-decode (kill -9: no drain, no exit hook)
        try:
            with urllib.request.urlopen(base1 + "/v1/stream/cg",
                                        timeout=120) as resp:
                event = None
                for line in resp:
                    line = line.decode().strip()
                    if line.startswith("event:"):
                        event = line.split(":", 1)[1].strip()
                    elif line.startswith("data:"):
                        dd = json.loads(line.split(":", 1)[1])
                        if event != "done":
                            seen.append(dd["token"])
                        event = None
                    if len(seen) >= 4:
                        break
        except (OSError, urllib.error.URLError):
            pass
        assert len(seen) >= 4 and len(seen) < len(ref_g)
        os.kill(pid1, signal.SIGKILL)
        proc1.wait(timeout=60)
    finally:
        _kill_proc(proc1)

    proc2, base2, _ = _boot_harness(d)
    try:
        _wait_ready(base2)
        # resume where the dead connection left the client: the recovered
        # stream replays deterministically, so offset=N holds even for
        # tokens that outran the journal's fsync
        toks, done = _read_sse(base2 + f"/v1/stream/cg?offset={len(seen)}")
        assert seen + toks == ref_g
        assert done["state"] == "FINISHED"
        st1 = json.load(urllib.request.urlopen(base2 + "/v1/stats",
                                               timeout=30))

        rs = json.load(urllib.request.urlopen(
            base2 + "/v1/result/cs?timeout=120", timeout=150))
        assert rs["tokens"] == ref_s
        rc = json.load(urllib.request.urlopen(
            base2 + "/v1/result/cc?timeout=120", timeout=150))
        assert rc["tokens"] == ref_c
        assert rc["tokens"] in ([5, 6, 7, 3], [5, 9, 3])

        # the build counters froze once the first resumed stream finished
        st2 = json.load(urllib.request.urlopen(base2 + "/v1/stats",
                                               timeout=30))
        for key in ("serving.decode_compiles", "serving.prefill_compiles"):
            assert st2["compile"].get(key, 0) == st1["compile"].get(key, 0)
        assert st2["pool"]["wal"]["results_cached"] >= 3

        # let the background sweep commit the TERMINAL records before this
        # incarnation dies too
        time.sleep(0.3)
    finally:
        _kill_proc(proc2)

    # a third incarnation replays terminal records only: the retried id
    # answers from the cache with no decode at all
    proc3, base3, _ = _boot_harness(d)
    try:
        _wait_ready(base3)
        sub = _post(base3, "/v1/submit", {"prompt": pg.tolist(),
                                          "request_id": "cg"}, 30)
        assert sub["cached"] is True and sub["tokens"] == ref_g
        res = json.load(urllib.request.urlopen(
            base3 + "/v1/result/cs", timeout=30))
        assert res["cached"] is True and res["tokens"] == ref_s
        st3 = json.load(urllib.request.urlopen(base3 + "/v1/stats",
                                               timeout=30))
        assert st3["compile"].get("serving.decode_compiles", 0) == 0
    finally:
        _kill_proc(proc3)


def test_gateway_kill_probe_sigkills_at_a_sweep(model, jax_model, tmp_path):
    """The ``gateway_kill`` fault, armed from the environment, SIGKILLs
    the harness at a WAL sweep boundary once the three streams were
    accepted (mid-decode or past their ends: the sweep count decides); a
    harness restarted on the directory answers all three as the
    uninterrupted streams."""
    d = str(tmp_path / "wal")
    rng = np.random.default_rng(31)
    pg, ps, pc = _prompt(rng, 6), _prompt(rng, 6), _prompt(rng, 5)
    ref_g, ref_s, ref_c = _chaos_refs(model, jax_model, pg, ps, pc)
    # the sweeper runs every ~5 ms: 300 sweeps pass the boot and the three
    # submits, then the process kills itself mid-decode
    proc1, base1, _ = _boot_harness(d, {
        "FLAGS_fault_injection": "1",
        "FLAGS_inject_faults": "gateway_kill:1:300"})
    try:
        _wait_ready(base1)
        _submit_three(base1, pg, ps, pc)
        assert proc1.wait(timeout=60) == -signal.SIGKILL
    finally:
        _kill_proc(proc1)

    proc2, base2, _ = _boot_harness(d)
    try:
        _wait_ready(base2)
        got = []
        for rid in ("cg", "cs", "cc"):
            got.append(json.load(urllib.request.urlopen(
                base2 + f"/v1/result/{rid}?timeout=120",
                timeout=150))["tokens"])
        assert got == [ref_g, ref_s, ref_c]
    finally:
        _kill_proc(proc2)
