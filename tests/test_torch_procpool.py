"""The process replica pool of the PyTorch port (``paddle_tpu_torch/serving/
gateway/procpool.py`` and ``worker.py``) against the JAX package, on the CPU:
every case of ``tests/test_procpool.py`` -- the framing and its fuzz, the
error taxonomy, heartbeats, busy polls, ``worker_kill`` / ``worker_hang``
recovery, reaping, ``serve()`` switching on the flag -- and four of the
port's own: the sticky-error exit, the size of the spawn payload, the
weights file's directory removed at ``close()``, and the modules a worker
imports.

``gpt_tiny`` float32 on seeded weights (``gpt.seeded_state(0)``, loaded
into the JAX ``GPTForCausalLM`` too): every greedy stream of a worker pool,
after a killed and after a hung worker too, equals the JAX model's
``generate()`` token for token. A pool is given the model instance (its
workers load the file the pool writes) or a ``functools.partial`` of
``wal_harness.build_model``: workers import it by reference, never this
file (which imports JAX). Workers on the CPU run torch on one thread.
The module shares two pools: one for the cases that neither kill, hang
nor close a worker, and one for the kill, hang and sticky-error cases,
each of which starts once both workers are up again.
"""
import functools
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import ServingConfig, metrics, telemetry
from paddle_tpu_torch.serving.gateway import (ProcessReplicaPool,
                                              WorkerDiedError, WorkerHandle,
                                              WorkerProtocolError)
from paddle_tpu_torch.serving.gateway import worker as worker_mod
from paddle_tpu_torch.serving.gateway.procpool import RemoteRequest
from paddle_tpu_torch.serving.gateway.wal_harness import build_model
from paddle_tpu_torch.serving.scheduler import RequestState

torch.set_num_threads(1)

pytestmark = [pytest.mark.serving, pytest.mark.gateway]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, MAX_LEN = 1024, 64
POOL_KW = dict(num_slots=4, kv_block_size=8, max_model_len=MAX_LEN)
#: the seeded gpt_tiny the workers build by reference
FACTORY = functools.partial(build_model, "gpt_tiny", 0, "float32", "cpu", 0)


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


@pytest.fixture(scope="module")
def pool(model):
    """Two workers on the model instance, shared by the cases that neither
    kill, hang nor close one."""
    p = _mk_pool(model)
    yield p
    p.close()


@pytest.fixture
def flag_guard():
    keep = flags.all_flags()
    yield
    flags.set_flags(keep)
    resilience.clear_faults()


@pytest.fixture(scope="module")
def _chaos_holder():
    holder = {}
    yield holder
    if holder.get("pool") is not None:
        holder["pool"].close()


@pytest.fixture
def chaos_pool(_chaos_holder, model):
    """Two workers shared by the fault cases, with a tight heartbeat
    budget (0.1 s x 8 misses classifies a hang in ~0.8 s) and fault
    injection and telemetry in their flag snapshot (a respawn boots from
    the same payload). Each case gets it once both workers are healthy: a
    killed or hung one has respawned. A closed pool is built anew."""
    p = _chaos_holder.get("pool")
    if p is None or p._closed:
        keep = flags.all_flags()
        flags.set_flags({"fault_injection": True, "serving_telemetry": True})
        try:
            p = _chaos_holder["pool"] = _mk_pool(
                model, heartbeat_interval=0.1, heartbeat_misses=8,
                worker_timeout=3.0)
        finally:
            flags.set_flags(keep)
    deadline = time.monotonic() + 60.0
    while not all(r["healthy"] for r in p.stats()["replicas"]):
        assert time.monotonic() < deadline, p.stats()["replicas"]
        time.sleep(0.05)
    return p


def _mk_pool(model, **kw):
    base = dict(replicas=2, background=True, respawn_backoff=0.5,
                heartbeat_interval=0.2, heartbeat_misses=5,
                worker_timeout=10.0, device="cpu", **POOL_KW)
    base.update(kw)
    return ProcessReplicaPool(model, **base)


def _prompt(rng, n=8):
    return rng.integers(0, VOCAB, (n,), dtype=np.int32)


def _jax_ref(jax_model, prompt, max_new):
    """The JAX model's greedy ``generate()``: prompt + new tokens."""
    out = jax_model.generate(JaxTensor(np.asarray(prompt, np.int32)[None]),
                             max_new_tokens=max_new)
    return np.asarray(out._data)[0]


def _count(key):
    return resilience._counts.get(key, 0)


# ------------------------------------------------------------- framing unit


def test_frame_roundtrip():
    a, b = socket.socketpair()
    try:
        msg = {"op": "poll", "id": 7, "reqs": {"0.1": 3},
               "text": "héllo"}
        worker_mod.send_frame(a, msg)
        assert worker_mod.recv_frame(b) == msg
        # a clean EOF on a frame boundary is None, not an error
        a.close()
        assert worker_mod.recv_frame(b) is None
    finally:
        b.close()


def test_send_frame_rejects_oversized():
    a, b = socket.socketpair()
    try:
        with pytest.raises(worker_mod.FrameError):
            worker_mod.send_frame(
                a, {"blob": "x" * (worker_mod._MAX_FRAME + 1)})
    finally:
        a.close()
        b.close()


def test_error_taxonomy_roundtrip():
    for exc in (resilience.QueueOverloadError("full"),
                resilience.RequestDrainedError("drained"),
                resilience.DeadlineExceededError("late"),
                resilience.ServingDeviceError("chip pulled"),
                resilience.ArenaCorruptError("bad arena"),
                worker_mod.DeviceUnavailableError("no card"),
                ValueError("bad journal")):
        back = worker_mod.decode_error(worker_mod.encode_error(exc))
        assert type(back) is type(exc)
        assert str(exc) in str(back)
    # an unknown type decodes as RuntimeError: not re-routable, so a novel
    # worker failure fails its stream instead of bouncing on
    weird = worker_mod.decode_error({"type": "SegfaultGremlin",
                                     "message": "boom"})
    assert type(weird) is RuntimeError
    assert "boom" in str(weird)


# ------------------------------------------------------------ framing fuzz


def _fuzz_handle():
    """A WorkerHandle over a socketpair with no worker behind it: the
    reader thread and the call plumbing are real, the peer is the test."""
    ours, theirs = socket.socketpair()
    handle = WorkerHandle(idx=0, conn=ours, proc=None, pid=0,
                          num_slots=4, vocab=VOCAB,
                          call_timeout=5.0, hb_interval=0.2)
    return handle, theirs


@pytest.mark.parametrize("junk", [
    struct.pack(">I", 100) + b"abc",                 # cut mid-frame
    struct.pack(">I", worker_mod._MAX_FRAME + 1),    # oversized prefix
    struct.pack(">I", 0),                            # zero-length frame
    struct.pack(">I", 5) + b"\xff\xfe\xfd\xfc\xfb",  # not JSON
    struct.pack(">I", 4) + b"[1]\n",                 # JSON, not an object
], ids=["truncated", "oversized", "zero", "garbage", "non-object"])
def test_framing_fuzz_classifies_protocol_error(junk):
    before = _count("worker.protocol_errors")
    handle, peer = _fuzz_handle()
    try:
        peer.sendall(junk)
        peer.close()
        deadline = time.monotonic() + 5.0
        while handle._dead is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert isinstance(handle._dead, WorkerProtocolError), handle._dead
        assert _count("worker.protocol_errors") > before
        # the reader thread ends: a corrupt stream leaves nothing spinning
        handle._thread.join(2.0)
        assert not handle._thread.is_alive()
        # and the dead handle refuses at once instead of hanging
        with pytest.raises(WorkerProtocolError):
            handle._call("stats", {})
    finally:
        handle.mark_dead(WorkerDiedError("test cleanup"))


def test_fuzz_fails_pending_call_and_requests_fast():
    handle, peer = _fuzz_handle()
    try:
        # a live request that must not leak when the stream corrupts
        with handle._lock:
            req = RemoteRequest(handle, "0.1", "r1", "t1", None)
            handle._reqs["0.1"] = req
        results = []

        def call():
            try:
                handle._call("stats", {}, timeout=30.0)
                results.append("returned")
            except BaseException as e:  # held below
                results.append(e)

        t = threading.Thread(target=call, daemon=True)
        t.start()
        worker_mod.recv_frame(peer)  # take the call (no reset on close)
        peer.sendall(struct.pack(">I", 64) + b"short")
        peer.shutdown(socket.SHUT_WR)  # FIN: an EOF mid-frame, not a reset
        t.join(5.0)  # far before the call's 30 s budget
        assert not t.is_alive()
        assert len(results) == 1
        assert isinstance(results[0], WorkerProtocolError)
        # the registered request failed re-routably, not stranded
        assert req.finished
        assert req.state == RequestState.FAILED
        assert isinstance(req.error, WorkerProtocolError)
        assert handle.outstanding() == 0
    finally:
        handle.mark_dead(WorkerDiedError("test cleanup"))


def test_rpc_deadline_classifies_silent_worker():
    handle, peer = _fuzz_handle()
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerDiedError):
            handle._call("stats", {}, timeout=0.3)  # the peer never answers
        assert time.monotonic() - t0 < 3.0
        assert isinstance(handle._dead, WorkerDiedError)
    finally:
        peer.close()
        handle.mark_dead(WorkerDiedError("test cleanup"))


def test_busy_poll_tolerated_while_heartbeating():
    """A poll past its deadline on a live worker with fresh heartbeats is
    busy, not hung: tolerated and tried again, no ejection, until
    hb_misses busy cycles in a row show the main loop is wedged."""
    ours, theirs = socket.socketpair()
    handle = WorkerHandle(idx=0, conn=ours,
                          proc=types.SimpleNamespace(
                              is_alive=lambda: True, pid=12345,
                              exitcode=None, join=lambda t=None: None,
                              kill=lambda: None),
                          pid=12345, num_slots=4, vocab=VOCAB,
                          call_timeout=0.5, hb_interval=0.05, hb_misses=3)
    req = RemoteRequest(handle, "0.1", "r1", "", None)
    with handle._lock:
        handle._reqs["0.1"] = req
    busy0 = _count("worker.busy_polls")
    hangs0 = _count("worker.hangs")
    wl = threading.Lock()  # the feeder and the responder share the peer
    stop = threading.Event()

    def feed_heartbeats():
        # a busy worker's heartbeat thread runs on while its main loop is
        # stuck: the condition under test
        while not stop.is_set():
            try:
                worker_mod.send_frame(theirs, {
                    "hb": True, "ts": time.time(), "outstanding": 1,
                    "breaker_open": False, "spans": []}, wl)
            except (worker_mod.FrameError, OSError):
                return
            stop.wait(0.03)

    feeder = threading.Thread(target=feed_heartbeats, daemon=True)
    feeder.start()
    try:
        # two busy cycles: deadline passed, heartbeats fresh, no ejection
        for expect in (1, 2):
            handle.poll()  # the peer never answers: returns, no raise
            assert handle._dead is None
            assert handle._busy_polls == expect
        assert _count("worker.busy_polls") == busy0 + 2

        # one answered poll resets the count
        def respond():
            theirs.settimeout(1.0)
            while True:
                try:
                    msg = worker_mod.recv_frame(theirs)
                except (worker_mod.FrameError, OSError):
                    return
                if msg is None:
                    return
                worker_mod.send_frame(theirs, {
                    "id": msg["id"], "ok": True, "reqs": {},
                    "spans": [], "breaker_open": False,
                    "outstanding": 1}, wl)

        responder = threading.Thread(target=respond, daemon=True)
        responder.start()
        handle.poll()
        assert handle._busy_polls == 0
        responder.join(5.0)

        # wedged for real: hb_misses busy cycles in a row (heartbeats still
        # fresh) eject
        for _ in range(2):
            handle.poll()
        with pytest.raises(WorkerDiedError, match="wedged"):
            handle.poll()
        assert isinstance(handle._dead, WorkerDiedError)
        assert _count("worker.hangs") == hangs0 + 1
        assert req.state == RequestState.FAILED  # failed, not leaked
    finally:
        stop.set()
        feeder.join(2.0)
        theirs.close()
        handle.mark_dead(WorkerDiedError("test cleanup"))


def test_heartbeat_frame_updates_liveness():
    handle, peer = _fuzz_handle()
    try:
        handle._last_hb = time.monotonic() - 60.0
        assert handle.heartbeat_age() > 59.0
        worker_mod.send_frame(peer, {"hb": True, "ts": time.time(),
                                     "outstanding": 0,
                                     "breaker_open": True, "spans": []})
        deadline = time.monotonic() + 2.0
        while handle.heartbeat_age() > 1.0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handle.heartbeat_age() < 1.0
        assert handle.supervisor.breaker_open is True
    finally:
        peer.close()
        handle.mark_dead(WorkerDiedError("test cleanup"))


# --------------------------------------------------------- live worker pool


def test_spawn_payload_carries_no_weights(pool, model):
    """With the model as an instance, the spawn payload is the weights
    file's path, the config and the runtime settings: under 64 KiB, while
    the weights alone are larger."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    st = pool.stats()
    assert 0 < st["spawn_payload_bytes"] < 64 * 1024 < weights
    payload = pool._payload_for(0)
    assert payload["factory"] is None
    assert os.path.isfile(payload["model_file"])
    assert payload["device"] == {"type": "cpu", "index": None}
    assert payload["threads"] == 1
    assert all(r["boot_ms"] > 0 for r in st["replicas"])


def test_worker_imports_neither_jax_nor_paddle_tpu(pool):
    """A spawned worker (whose parent, this test process, imports both)
    has neither ``jax`` nor ``paddle_tpu`` in its ``sys.modules``."""
    ws = pool.worker_stats()
    assert set(ws) == {0, 1}
    for snap in ws.values():
        assert snap["imports"] == []


def test_modules_import_without_jax():
    """A fresh interpreter that imports the process pool, the worker and
    the WAL finds neither ``jax`` nor ``paddle_tpu`` in ``sys.modules``."""
    code = ("import sys\n"
            "import paddle_tpu_torch.serving.gateway.procpool\n"
            "import paddle_tpu_torch.serving.gateway.worker\n"
            "import paddle_tpu_torch.serving.gateway.wal\n"
            "import paddle_tpu_torch.serving.gateway.wal_harness\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'paddle_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_process_pool_token_parity_and_reaping(pool, jax_model):
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng) for _ in range(4)]
    rrs = [pool.submit(p, max_new_tokens=16) for p in prompts]
    outs = [pool.result(rr, timeout=120.0) for rr in rrs]
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _jax_ref(jax_model, p, 16))

    st = pool.stats()
    assert st["process_replicas"] is True
    assert len(st["replicas"]) == 2
    for row in st["replicas"]:
        assert row["pid"] > 0
        assert row["restarts"] == 0
        assert row["heartbeat_age_ms"] >= 0.0

    # each scrape carries its worker PROCESS's counters
    ws = pool.worker_stats()
    assert set(ws) == {0, 1}
    for idx, snap in ws.items():
        assert snap["pid"] == st["replicas"][idx]["pid"]
        assert snap["pid"] != os.getpid()
        assert snap["engine"]["decode_traces"] == 1
        assert snap["compile"].get("serving.decode_compiles", 0) >= 1
        assert set(snap["launches"]) >= {"paged_decode_attention",
                                         "sample_tokens"}
    assert sum(s["engine"]["prefills"] for s in ws.values()) == 4

    procs = [r.api.proc for r in pool.replicas()]
    pool.close()
    # close() reaps: no worker outlives its pool
    for proc in procs:
        assert not proc.is_alive()


def test_worker_kill_chaos_recovery(chaos_pool, jax_model, flag_guard):
    flags.set_flags({"fault_injection": True, "serving_telemetry": True})
    pool = chaos_pool
    kills0 = _count("worker.kills")
    ejected0 = metrics.stats().get("gateway.ejected", 0)
    restarts0 = sum(r["restarts"] for r in pool.stats()["replicas"])
    rng = np.random.default_rng(1)
    # warm both workers: their builds land before the fault
    warm = [pool.submit(_prompt(rng), max_new_tokens=4) for _ in range(2)]
    for rr in warm:
        pool.result(rr, timeout=120.0)

    prompts = [_prompt(rng) for _ in range(6)]
    rrs = [pool.submit(p, max_new_tokens=40) for p in prompts]
    # the watchdog's next sweep SIGKILLs a live worker
    resilience.inject_fault("worker_kill", times=1)
    outs = [pool.result(rr, timeout=180.0) for rr in rrs]

    # the journaled streams resumed on the survivor token for token: equal
    # to the JAX model's greedy generate()
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _jax_ref(jax_model, p, 40))

    assert _count("fault.worker_kill") >= 1
    assert _count("worker.kills") > kills0
    assert metrics.stats().get("gateway.ejected", 0) > ejected0

    # one timeline per trace: SUBMITTED first, FINISHED last, and the
    # killed worker's streams show REROUTED with the survivor's spans after
    # it
    rerouted = 0
    for rr in rrs:
        kinds = [ev["event"] for ev in telemetry.trace(rr.trace_id)]
        assert kinds[0] == telemetry.SUBMITTED
        assert kinds.count(telemetry.SUBMITTED) == 1
        assert kinds[-1] == telemetry.FINISHED
        if telemetry.REROUTED in kinds:
            rerouted += 1
            assert kinds.index(telemetry.REROUTED) < len(kinds) - 1
    assert rerouted >= 1

    # no tenant slot leaked
    assert pool.stats()["tenants"]["default"]["inflight"] == 0

    # the dead worker respawns once its backoff ran
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        rows = pool.stats()["replicas"]
        if (all(r["healthy"] for r in rows)
                and sum(r["restarts"] for r in rows) > restarts0):
            break
        time.sleep(0.2)
    rows = pool.stats()["replicas"]
    assert all(r["healthy"] for r in rows), rows
    assert sum(r["restarts"] for r in rows) > restarts0, rows


def test_worker_hang_chaos_recovery(chaos_pool, jax_model, flag_guard):
    flags.set_flags({"fault_injection": True})
    pool = chaos_pool
    hangs0 = _count("worker.hangs")
    rng = np.random.default_rng(2)
    warm = [pool.submit(_prompt(rng), max_new_tokens=4) for _ in range(2)]
    for rr in warm:
        pool.result(rr, timeout=120.0)

    prompts = [_prompt(rng) for _ in range(4)]
    rrs = [pool.submit(p, max_new_tokens=32) for p in prompts]
    # a worker stops heartbeating but holds its socket: only the heartbeat
    # age (not a reset) can classify it
    resilience.inject_fault("worker_hang", times=1)
    outs = [pool.result(rr, timeout=180.0) for rr in rrs]
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _jax_ref(jax_model, p, 32))

    assert _count("fault.worker_hang") >= 1
    assert _count("worker.hangs") > hangs0
    assert pool.stats()["tenants"]["default"]["inflight"] == 0


def test_sticky_cuda_error_exits_worker_and_respawns(chaos_pool, jax_model,
                                                     flag_guard):
    """A sticky CUDA error in a worker (injected there: its fifth step
    program from now, the fourth decode step of the one request it serves,
    raises ``RuntimeError("CUDA error: ...")``) fails the request it
    reached, as an in-process replica does, with no re-route; the worker
    exits with ``STICKY_EXIT``, the parent classifies the exit
    (``worker.sticky_exits``), the other replica's stream finishes equal to
    the JAX model's, and the worker respawns as a fresh process that
    serves again."""
    flags.set_flags({"fault_injection": True})
    pool = chaos_pool
    sticky0 = _count("worker.sticky_exits")
    rng = np.random.default_rng(5)
    warm = [pool.submit(_prompt(rng), max_new_tokens=2) for _ in range(2)]
    for rr in warm:
        pool.result(rr, timeout=120.0)
    victim = pool.replicas()[0]
    pid0, gen0 = victim.api.pid, victim.generation
    victim.api.inject_fault("serving_step", after=4, exc=RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    pa, pb = _prompt(rng), _prompt(rng)
    a = pool.submit(pa, max_new_tokens=MAX_LEN - 8)
    b = pool.submit(pb, max_new_tokens=MAX_LEN - 8)
    assert (a._replica_idx, b._replica_idx) == (0, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pool.result(a, timeout=120.0)
    assert a.state == RequestState.FAILED and a.reroutes == 0
    assert len(a.tokens()) == 4  # the prefill's token and 3 steps'

    np.testing.assert_array_equal(pool.result(b, timeout=120.0),
                                  _jax_ref(jax_model, pb, MAX_LEN - 8))
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and (
            victim.generation <= gen0 or not victim.healthy):
        time.sleep(0.05)
    assert _count("worker.sticky_exits") == sticky0 + 1
    assert victim.generation == gen0 + 1 and victim.api.pid != pid0
    assert pool.stats()["tenants"]["default"]["inflight"] == 0
    # the respawned worker serves again
    p = _prompt(rng)
    rrs = [pool.submit(p, max_new_tokens=6) for _ in range(2)]
    assert {rr._replica_idx for rr in rrs} == {0, 1}
    for rr in rrs:
        np.testing.assert_array_equal(pool.result(rr, timeout=120.0),
                                      _jax_ref(jax_model, p, 6))


def test_close_removes_weights_dir(chaos_pool):
    """The pool writes the instance once to a directory of its own, which
    lives as long as the pool (the fault cases' respawns loaded it again)
    and goes at ``close()``."""
    d = chaos_pool._weights_dir
    try:
        assert os.path.isfile(os.path.join(d, "model.pt"))
    finally:
        chaos_pool.close()
    assert not os.path.exists(d)


def test_worker_refuses_a_card_it_cannot_take():
    """A worker told to serve on a CUDA device no machine has (the index
    one past this machine's last card: 0 where there is none) fails its
    boot with ``DeviceUnavailableError``, raised by the spawn as
    ``WorkerDiedError`` from it; it never starts on the CPU."""
    payload = worker_mod.encode_payload(ServingConfig(**POOL_KW),
                                        torch.device("cpu"),
                                        factory=FACTORY)
    payload["device"] = {"type": "cuda",
                         "index": torch.cuda.device_count()}
    with pytest.raises(WorkerDiedError, match="failed to boot") as ei:
        WorkerHandle.spawn(0, payload, boot_timeout=60.0)
    assert isinstance(ei.value.__cause__, worker_mod.DeviceUnavailableError)


def test_serve_flag_switches_to_process_pool(flag_guard):
    flags.set_flags({"gateway_process_replicas": True})
    from paddle_tpu_torch.serving.gateway import serve

    gw = serve(FACTORY, replicas=1, guard=False, device="cpu", **POOL_KW)
    try:
        assert isinstance(gw.pool, ProcessReplicaPool)
        assert gw.pool._payload_for(0)["model_file"] is None
        base = f"http://127.0.0.1:{gw.port}"
        stats = urllib.request.urlopen(base + "/v1/stats",
                                       timeout=10).read().decode()
        assert '"process_replicas": true' in stats
        metrics_text = urllib.request.urlopen(base + "/v1/metrics",
                                              timeout=10).read().decode()
        assert "paddle_gateway_worker_pid" in metrics_text
        assert "paddle_gateway_worker_heartbeat_age_ms" in metrics_text
        procs = [r.api.proc for r in gw.pool.replicas()]
    finally:
        gw.close()
    # Gateway.close() -> pool.close() -> the reap: no orphans
    for proc in procs:
        assert not proc.is_alive()


def test_default_flag_keeps_thread_pool():
    assert flags.flag("gateway_process_replicas") is False
    # the fleet's fault kinds are registered probes
    assert "worker_kill" in resilience.KNOWN_FAULTS
    assert "worker_hang" in resilience.KNOWN_FAULTS
