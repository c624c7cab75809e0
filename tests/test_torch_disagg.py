"""Disaggregated prefill and decode in the PyTorch port (``paddle_tpu_torch/
serving/disagg/``, ``ServingEngine.prefetch``, ``ServingAPI.prefetch``, the
worker's ``prefetch`` op, ``HostKVCache.ensure(publish=)``, the router's
``_backend_budget`` seam and the disk tier's writers) against the JAX
package, on the CPU.

Every disaggregation case of ``tests/test_disagg.py``: role bands and flag
profiles (against the JAX functions on the same inputs), a pool without
both roles refused, handoff parity with the build counters frozen and
prefetch, a prefill worker's kill (its successor prefills only what was
not published), a decode worker's kill (the survivor restores the same
hashes), a role scaled to zero (unified routes), prefetch that never
starves admission, and admission sizing that counts a journal's restore and
no copy-on-write. The grammar cases of that file are held by
``tests/test_torch_constrain.py`` and ``tests/test_torch_gateway.py``.

And the port's own: ``ensure(publish=)`` (host only without the flag, on
disk with it); a WAL the JAX package wrote with a ``HANDOFF`` record
replays into the decode phase; the pool removes the disk directory it
minted and keeps one it was given; prefetch walks the request's adapter
root; a fresh interpreter importing the package imports no ``jax`` and no
``paddle_tpu``; and the disk tier's writers of one key, each with a
temporary file of its own (by hand: one writer paused between its write
and its rename while another writes in full; and two processes writing one
key while a third reads it).

``gpt_tiny`` float32 on ``gpt.seeded_state(0)``: workers build it by
reference (``wal_harness.build_model``, never this file, which imports
JAX), the JAX model loads the same arrays, and every greedy stream of a
pool equals the JAX model's ``generate()``; sampled and constrained streams
equal an in-process ``ServingAPI`` of the port. One pool of four workers
is shared by its cases, in file order, through a module fixture, as
``chaos_pool`` in ``tests/test_torch_procpool.py``.
"""
import concurrent.futures
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import flags as jax_flags
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import disagg as jax_disagg
from paddle_tpu.serving.gateway import GatewayWAL as JaxGatewayWAL
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (ServingAPI, ServingConfig, metrics,
                                      telemetry, tiered)
from paddle_tpu_torch.serving.adapters import LoraAdapter
from paddle_tpu_torch.serving.constrain import TrieConstraint
from paddle_tpu_torch.serving.disagg import (DECODE, PREFILL, UNIFIED,
                                             DisaggReplicaPool, role_counts,
                                             role_flag_overrides, role_of)
from paddle_tpu_torch.serving.gateway import GatewayWAL
from paddle_tpu_torch.serving.gateway.wal_harness import build_model
from paddle_tpu_torch.serving.sampling import SamplingParams
from paddle_tpu_torch.serving.tiered import DiskTier, HostKVCache, TierView

torch.set_num_threads(1)

pytestmark = [pytest.mark.serving, pytest.mark.gateway]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, MAX_LEN, BS = 1024, 96, 8
POOL_KW = dict(num_slots=4, kv_block_size=BS, max_model_len=MAX_LEN)
#: the seeded gpt_tiny the workers build by reference
FACTORY = functools.partial(build_model, "gpt_tiny", 0, "float32", "cpu", 0)
#: the shared pool's greedy cases: (prompt length, streams, new tokens).
#: "wal" is the stream a JAX-written log leaves handed off (the pool's
#: recovery); "fill" fills the decode workers' slots so that "queued"
#: waits for a slot, where the planner prefetches
GREEDY = {"wal": (16, 1, 12), "parity8": (8, 2, 24), "parity16": (16, 2, 24),
          "parity24": (24, 2, 24), "fill": (8, 8, 64), "queued": (16, 4, 24),
          "prefill_kill": (64, 16, 8), "decode_kill": (24, 2, 64),
          "scale": (16, 2, 12)}


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.gpt_tiny(),
                                               device="cpu"), seed=0)


@pytest.fixture(scope="module")
def model(arrays):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    return m


def _jax_model(arrays):
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


@pytest.fixture(scope="module", autouse=True)
def fresh_import():
    """The interpreter of ``test_modules_import_without_jax``, started at
    the module's start so that its start-up (importing torch) overlaps the
    cases before it."""
    code = ("import sys\n"
            "import paddle_tpu_torch.serving.disagg\n"
            "from paddle_tpu_torch.serving import DisaggReplicaPool, "
            "RestorePlanner\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'paddle_tpu')))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture
def flag_guard():
    keep = flags.all_flags()
    yield
    flags.set_flags(keep)
    resilience.clear_faults()


def _prompt(rng, n=8):
    return rng.integers(0, VOCAB, (n,), dtype=np.int32)


def _jax_refs(jax_model, prompts, max_new):
    """The JAX model's greedy ``generate()`` of equal-length prompts, one
    batched call (greedy rows do not depend on each other)."""
    batch = np.stack([np.asarray(p, np.int32) for p in prompts])
    out = jax_model.generate(JaxTensor(batch), max_new_tokens=max_new)
    return list(np.asarray(out._data))


@pytest.fixture(scope="module", autouse=True)
def greedy(arrays):
    """``greedy(case) -> (prompts, refs)`` for each case of GREEDY: its
    prompts (a generator seeded by the case's place) and the JAX model's
    greedy ``generate()`` of them. One batched call per prompt length, at
    the longest budget of that length (a greedy row's first tokens do not
    depend on a longer budget); the JAX model is built and the calls made
    on a thread from the module's start, so that they overlap the cases
    that wait on processes (the disk tier's, the import's, the pool's
    boot)."""
    prompts = {}
    for i, (case, (n, k, _)) in enumerate(GREEDY.items()):
        rng = np.random.default_rng(100 + i)
        prompts[case] = [_prompt(rng, n) for _ in range(k)]
    by_len = {}
    for case, (n, _, _) in GREEDY.items():
        by_len.setdefault(n, []).append(case)
    ex = concurrent.futures.ThreadPoolExecutor(1)
    jax_model = ex.submit(_jax_model, arrays)
    rows = {n: ex.submit(lambda ps, new: _jax_refs(jax_model.result(), ps,
                                                   new),
                         [p for c in cases for p in prompts[c]],
                         max(GREEDY[c][2] for c in cases))
            for n, cases in by_len.items()}
    ex.shutdown(wait=False)

    def get(case):
        n, k, new = GREEDY[case]
        cases = by_len[n]
        at = sum(GREEDY[c][1] for c in cases[:cases.index(case)])
        return prompts[case], [r[:n + new]
                               for r in rows[n].result()[at:at + k]]

    get.prompts = prompts  # without waiting for the references
    return get


def _metric(pool, idx, key, ws=None):
    ws = pool.worker_stats() if ws is None else ws
    return ws.get(idx, {}).get("metrics", {}).get(key, 0)


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _mk_pool(prefill, decode, **kw):
    base = dict(background=True, device="cpu", respawn_backoff=60.0,
                heartbeat_interval=0.1, heartbeat_misses=8,
                worker_timeout=10.0, **POOL_KW)
    base.update(kw)
    return DisaggReplicaPool(FACTORY, prefill_replicas=prefill,
                             decode_replicas=decode, **base)


@pytest.fixture(scope="module")
def wal_dir(tmp_path_factory, greedy, model):
    """A log the JAX package wrote: one stream accepted, its first token
    emitted and its HANDOFF moved, no TERMINAL (the gateway died with the
    stream in its decode phase). The first token is the port model's
    greedy one (the JAX references are still on their thread); the
    replayed stream is held to the JAX model's whole."""
    d = str(tmp_path_factory.mktemp("jax_wal"))
    (p,) = greedy.prompts["wal"]
    first = int(model.generate(torch.as_tensor(p[None], dtype=torch.long),
                               max_new_tokens=1)[0, -1])
    wal = JaxGatewayWAL(d)
    wal.accepted(types.SimpleNamespace(
        request_id="handed-off", tenant="default", prompt=list(p),
        max_new_tokens=GREEDY["wal"][2], stop_token_id=None, priority=0,
        adapter=0,
        sampling=None, trace_id="trace-handed-off"))
    wal.emitted("handed-off", [first])
    wal.moved("handed-off", "HANDOFF")
    wal.commit()
    wal.close()
    return d


@pytest.fixture(scope="module")
def _pool_holder():
    holder = {}
    yield holder
    if holder.get("pool") is not None:
        holder["pool"].close()


@pytest.fixture
def pool(_pool_holder, wal_dir, tmp_path_factory):
    """Two prefill and two decode workers, shared by the cases that follow
    in file order (parity, the kills, the scale-down, the close): chunks of 8 tokens (one
    block: a chain publishes block by block), fault injection and spans in
    the snapshot, no respawn within the module (a 60 s backoff), the disk
    directory minted by the pool, and the JAX-written log replayed at
    construction."""
    p = _pool_holder.get("pool")
    if p is None:
        keep = flags.all_flags()
        flags.set_flags({"serving_chunked_prefill": BS,
                         "fault_injection": True, "serving_telemetry": True})
        wal = str(tmp_path_factory.mktemp("port_wal"))
        shutil.copytree(wal_dir, wal, dirs_exist_ok=True)
        try:
            p = _pool_holder["pool"] = _mk_pool(2, 2, wal=GatewayWAL(wal))
        finally:
            flags.set_flags(keep)
    return p


# ---------------------------------------------------------------- roles


def test_role_bands_and_flag_profiles(flag_guard):
    keep = jax_flags.all_flags()
    try:
        for n_p, n_d in ((2, 3), (1, 1), (0, 2), (3, 0)):
            assert [role_of(i, n_p, n_d) for i in range(6)] == \
                [jax_disagg.role_of(i, n_p, n_d) for i in range(6)]
        assert [role_of(i, 2, 3) for i in range(6)] == \
            [PREFILL, PREFILL, DECODE, DECODE, DECODE, UNIFIED]
        for chunk in (0, 16):
            flags.set_flags({"serving_chunked_prefill": chunk})
            jax_flags.set_flags({"serving_chunked_prefill": chunk})
            for role in (PREFILL, DECODE, UNIFIED):
                ours = role_flag_overrides(role, "/kv")
                assert ours == jax_disagg.role_flag_overrides(role, "/kv")
            pre = role_flag_overrides(PREFILL, "/kv")
            assert pre["serving_chunked_prefill"] == (chunk or 32)
            assert pre["serving_tier_publish"] is True
            assert pre["serving_publish_chunks"] is True
        dec = role_flag_overrides(DECODE, "/kv")
        assert dec["serving_prefix_cache"] and dec["serving_kv_tiering"]
        assert "serving_tier_publish" not in dec  # decode never publishes
        assert role_flag_overrides(UNIFIED, "/kv") == {}
        flags.set_flags({"gateway_prefill_replicas": 2,
                         "gateway_decode_replicas": 3})
        jax_flags.set_flags({"gateway_prefill_replicas": 2,
                             "gateway_decode_replicas": 3})
        assert role_counts() == jax_disagg.role_counts() == (2, 3)
        assert role_counts(1, None) == jax_disagg.role_counts(1, None)
        for bad in ((-1, 2), (1, -2)):
            with pytest.raises(ValueError):
                role_counts(*bad)
            with pytest.raises(ValueError):
                jax_disagg.role_counts(*bad)
    finally:
        jax_flags.set_flags(keep)


def test_pool_requires_both_roles():
    # refused before any worker spawns or any directory is minted
    for p, d in ((0, 2), (1, 0), (0, 0)):
        with pytest.raises(ValueError, match="one worker per role"):
            DisaggReplicaPool(FACTORY, prefill_replicas=p,
                              decode_replicas=d, device="cpu", **POOL_KW)


def test_default_flags_and_serve_switch(flag_guard, monkeypatch):
    """The four flags exist with the JAX package's defaults; ``serve()``
    builds a ``DisaggReplicaPool`` (``replicas`` dropped: the role counts
    are the fleet) only with process replicas on and both counts above 0."""
    for name in ("gateway_prefill_replicas", "gateway_decode_replicas",
                 "gateway_prefetch", "serving_tier_publish",
                 "serving_publish_chunks"):
        assert flags.flag(name) == jax_flags.flag(name), name
    from paddle_tpu_torch.serving import disagg
    from paddle_tpu_torch.serving.gateway import gateway, procpool

    built = []

    class Stop(Exception):
        pass

    def fake(name):
        def pool(model, replicas=None, **kw):
            built.append((name, replicas))
            raise Stop
        return pool

    monkeypatch.setattr(disagg, "DisaggReplicaPool", fake("disagg"))
    monkeypatch.setattr(procpool, "ProcessReplicaPool", fake("process"))
    flags.set_flags({"gateway_process_replicas": True,
                     "gateway_prefill_replicas": 1,
                     "gateway_decode_replicas": 2})
    for p, d, want in ((1, 2, ("disagg", None)), (1, 0, ("process", 3)),
                       (0, 2, ("process", 3))):
        flags.set_flags({"gateway_prefill_replicas": p,
                         "gateway_decode_replicas": d})
        with pytest.raises(Stop):
            gateway.serve(FACTORY, replicas=3, guard=False)
        assert built[-1] == want


# ------------------------------------------------------ disk tier writers


def _payload(seed, nbytes=1 << 18):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 255, nbytes, dtype=np.uint8),)]


def test_disk_writers_of_one_key_never_share_a_temp_file(tmp_path,
                                                         monkeypatch):
    """Two ``DiskTier`` writers of one key in one directory, driven by
    hand: the first is paused between its write and its ``os.replace``
    while the second writes in full, then resumes. Each writer fills a
    temporary file of its own, so both writes succeed and the file reads
    back whole (one shared ``.tmp`` name loses the first's rename and, across
    processes, lets a reader meet a torn file)."""
    d = str(tmp_path)
    first, second = DiskTier(d), DiskTier(d)
    key = bytes(range(16))
    payload = _payload(0)
    paused, resume = threading.Event(), threading.Event()
    real = os.replace
    errors = []

    def replace(src, dst):
        if threading.current_thread().name == "first-writer":
            paused.set()
            assert resume.wait(30)
        return real(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    c0 = metrics.stats()
    failed0 = resilience._counts.get("tier.disk_write_failed", 0)

    def write_first():
        try:
            first.put(key, payload)
        except BaseException as e:  # held on the main thread
            errors.append(e)

    th = threading.Thread(target=write_first, name="first-writer")
    th.start()
    assert paused.wait(30)
    second.put(key, payload)  # in full while the first is paused
    resume.set()
    th.join(30)
    monkeypatch.setattr(os, "replace", real)
    c1 = metrics.stats()
    assert not errors and not th.is_alive()
    assert c1.get("tier.disk_write_failed", 0) == \
        c0.get("tier.disk_write_failed", 0)
    assert resilience._counts.get("tier.disk_write_failed", 0) == failed0
    assert c1.get("tier.disk_writes", 0) == c0.get("tier.disk_writes", 0) + 2
    got = DiskTier(d).get(key)
    assert got is not None
    np.testing.assert_array_equal(got[0][0], payload[0][0])
    assert c1.get("tier.disk_corrupt", 0) == c0.get("tier.disk_corrupt", 0)
    # no temporary file is left, and none would be indexed
    assert sorted(os.listdir(d)) == [key.hex() + ".kv"]
    assert DiskTier(d).stats()["entries"] == 1


def test_a_killed_writers_temp_file_goes_at_the_next_scan(tmp_path):
    """A writer SIGKILLed between its write and its ``os.replace`` leaves
    its temporary file; the next ``DiskTier`` on the directory deletes it
    (its process is gone), keeps a live writer's, and indexes neither."""
    d = str(tmp_path)
    key = bytes(range(16))
    path = os.path.join(d, key.hex() + ".kv")
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # the writer: paused for good before its rename
        try:
            os.close(r)

            def replace(src, dst):
                os.write(w, b"1")
                time.sleep(120)

            os.replace = replace
            DiskTier(d).put(key, _payload(0))
        finally:
            os._exit(1)
    os.close(w)
    try:
        assert os.read(r, 1) == b"1"
    finally:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
        os.close(r)
    left = os.listdir(d)
    assert len(left) == 1 and left[0].endswith(".tmp")
    assert left[0].startswith(f"{os.path.basename(path)}.{pid}.")
    live = DiskTier._tmp_path(path)  # this process's: alive
    open(live, "wb").close()
    tier = DiskTier(d)
    assert os.listdir(d) == [os.path.basename(live)]
    assert tier.stats()["entries"] == 0 and not tier.has(key)


_WRITER = """
import json, sys, numpy as np
from paddle_tpu_torch.core import resilience
from paddle_tpu_torch.serving.tiered import DiskTier
d, key, n = sys.argv[1], bytes.fromhex(sys.argv[2]), int(sys.argv[3])
tier = DiskTier(d)
payload = [(np.random.default_rng(0).integers(0, 255, 1 << 20,
                                              dtype=np.uint8),)]
for _ in range(n):
    tier.put(key, payload)
print(json.dumps({"failed": resilience._counts.get(
    "tier.disk_write_failed", 0)}))
"""

_READER = """
import json, os, sys, time, numpy as np
from paddle_tpu_torch.core import resilience
from paddle_tpu_torch.serving.tiered import DiskTier
d, key, stop = sys.argv[1], bytes.fromhex(sys.argv[2]), sys.argv[3]
tier = DiskTier(d)
want = np.random.default_rng(0).integers(0, 255, 1 << 20, dtype=np.uint8)
good = bad = 0
deadline = time.monotonic() + 120
while not os.path.exists(stop) and time.monotonic() < deadline:
    got = tier.get(key)
    if got is not None:
        if np.array_equal(got[0][0], want):
            good += 1
        else:
            bad += 1
print(json.dumps({"good": good, "bad": bad, "corrupt":
                  resilience._counts.get("tier.disk_corrupt", 0)}))
"""


def test_disk_tier_two_processes_write_one_key_while_a_third_reads(
        tmp_path):
    """Two spawned processes write one key of 1 MiB in a loop while a third
    reads it: no write fails, and every read the reader completes passes
    its crc and holds the written bytes."""
    d = str(tmp_path / "tier")
    os.makedirs(d)
    key = bytes(range(16)).hex()
    stop = str(tmp_path / "stop")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    reader = subprocess.Popen([sys.executable, "-c", _READER, d, key, stop],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              text=True)
    writers = [subprocess.Popen([sys.executable, "-c", _WRITER, d, key,
                                 "60"], cwd=REPO, env=env,
                                stdout=subprocess.PIPE, text=True)
               for _ in range(2)]
    try:
        outs = [json.loads(w.communicate(timeout=120)[0]) for w in writers]
        open(stop, "w").close()
        got = json.loads(reader.communicate(timeout=120)[0])
    finally:
        for p in writers + [reader]:
            if p.poll() is None:
                p.kill()
    assert all(w.returncode == 0 for w in writers)
    assert reader.returncode == 0
    assert [o["failed"] for o in outs] == [0, 0]
    assert got["bad"] == 0 and got["corrupt"] == 0, got
    assert got["good"] > 0, got
    assert [n for n in os.listdir(d) if not n.endswith(".kv")] == []


# ------------------------------------------------------ tiers in process


def test_ensure_publish_host_only_without_flag_on_disk_with_it(tmp_path,
                                                               flag_guard):
    store = HostKVCache(max_bytes=1 << 30, disk_dir=str(tmp_path))
    view = TierView(store, signature=("test", 1))
    reads = []

    def reader(seed):
        def read():
            reads.append(seed)
            return _payload(seed, 4096)
        return read

    pub0 = metrics.stats().get("tier.published_blocks", 0)
    flags.set_flags({"serving_tier_publish": False})
    view.write_through(b"a" * 16, reader(1))
    assert view.tier_of(b"a" * 16) == "host"
    assert not store.disk.has(view._k(b"a" * 16))
    assert metrics.stats().get("tier.published_blocks", 0) == pub0

    flags.set_flags({"serving_tier_publish": True})
    view.write_through(b"b" * 16, reader(2))   # new: host and disk
    view.write_through(b"a" * 16, reader(3))   # host already: to disk now
    view.write_through(b"b" * 16, reader(4))   # on disk: nothing to do
    assert reads == [1, 2]  # the reader runs only for a key in no tier
    for k in (b"a" * 16, b"b" * 16):
        assert store.disk.has(view._k(k))
        np.testing.assert_array_equal(
            DiskTier(str(tmp_path)).get(view._k(k))[0][0],
            _payload(1 if k == b"a" * 16 else 2, 4096)[0][0])
    assert metrics.stats().get("tier.published_blocks", 0) == pub0 + 2
    # a store without a disk tier publishes nothing
    bare = HostKVCache(max_bytes=1 << 30, disk_dir="")
    assert bare.ensure(b"c" * 16, reader(5), publish=True) > 0
    assert metrics.stats().get("tier.published_blocks", 0) == pub0 + 2


def _tier_api(model, disk, **kw):
    return ServingAPI(model, ServingConfig(
        prefix_cache=True, kv_tiering=True,
        tier_store=HostKVCache(max_bytes=1 << 30, disk_dir=disk), **POOL_KW,
        **kw), device="cpu")


def test_prefetch_never_starves_admission(model, tmp_path, flag_guard):
    """Two engines sharing one disk directory, the publish and restore pair
    in one process: the publisher's chains are on disk, the other engine's
    prefetch restores one without moving ``grantable()``, again finds it
    resident, and declines with no headroom above the evictable blocks."""
    disk = str(tmp_path)
    flags.set_flags({"serving_tier_publish": True})
    prompt = np.arange(48, dtype=np.int32) % VOCAB
    other = (np.arange(40, dtype=np.int32) * 7 + 1) % VOCAB
    pub = _tier_api(model, disk)
    try:
        pub.result(pub.submit(prompt, max_new_tokens=2), timeout=120)
        pub.result(pub.submit(other, max_new_tokens=2), timeout=120)
    finally:
        pub.close()
    flags.set_flags({"serving_tier_publish": False})
    sub = _tier_api(model, disk)
    try:
        eng = sub.engine
        g0 = eng.arena.grantable()
        b0 = metrics.stats().get("disagg.prefetched_blocks", 0)
        assert sub.prefetch(prompt, trace_id="t-prefetch") == 48 // BS
        assert eng.arena.grantable() == g0
        assert metrics.stats().get("disagg.prefetched_blocks", 0) == \
            b0 + 48 // BS
        assert sub.prefetch(prompt) == 0  # resident now
        res = eng.arena.reserve(eng.arena.blocks_free())
        assert (eng.arena.grantable()
                - eng.prefix_cache.evictable_blocks()) <= 0
        assert sub.prefetch(other) == 0  # restorable, but no headroom
        res.release()
        # the restored chain serves a hit equal to the publisher's stream
        out = sub.result(sub.submit(prompt, max_new_tokens=4), timeout=120)
        ref = model.generate(torch.as_tensor(prompt[None], dtype=torch.long),
                             max_new_tokens=4)[0].numpy()
        np.testing.assert_array_equal(out, ref)
        assert eng.prefix_cache.hits >= 1
    finally:
        sub.close()
    assert sub.prefetch(prompt) == 0  # a closed API declines


def test_prefetch_walks_the_adapter_root(model, tmp_path, flag_guard):
    """A chain published under an adapter is named by the adapter's root:
    another engine that registered the same adapter prefetches it only
    through ``adapter=`` (the base model's root names other blocks). The
    JAX package's prefetch walks tokens alone."""
    disk = str(tmp_path)
    lora = dict(lora_rank=4, lora_adapters=2)
    adapter = LoraAdapter.random(model.cfg, rank=4, seed=7, scale=0.25)
    prompt = (np.arange(32, dtype=np.int32) * 5 + 3) % VOCAB
    flags.set_flags({"serving_tier_publish": True})
    pub = _tier_api(model, disk, **lora)
    try:
        aid = pub.register_adapter(adapter)
        pub.result(pub.submit(prompt, max_new_tokens=2, adapter=aid),
                   timeout=120)
    finally:
        pub.close()
    sub = _tier_api(model, disk, **lora)
    try:
        sid = sub.register_adapter(adapter)
        assert sub.prefetch(prompt) == 0  # the base root: nothing there
        assert sub.prefetch(prompt, adapter=sid) == 32 // BS
        assert sub.prefetch(prompt, adapter=sid) == 0
    finally:
        sub.close()


def test_admit_sizing_counts_journal_restore_not_cow(model, flag_guard):
    flags.set_flags({"serving_prefix_cache": True})
    api = ServingAPI(model, ServingConfig(**POOL_KW), device="cpu")
    try:
        eng = api.engine
        prompt = (np.arange(32, dtype=np.int32) * 3 + 5) % VOCAB
        api.result(api.submit(prompt, max_new_tokens=2), timeout=120)
        # a handed-off admission prefills only its journal: a fully cached
        # block-aligned prompt and one journal token put the first new
        # position in a fresh block, so no copy-on-write block is charged
        plain, _ = eng.admit_sizing(len(prompt), 8, prompt=prompt)
        journal, _ = eng.admit_sizing(len(prompt), 8, prompt=prompt,
                                      journal_len=1)
        assert journal == plain - 1
    finally:
        api.close()


def test_modules_import_without_jax(fresh_import):
    """A fresh interpreter importing the disaggregation package (and the
    serving package's lazy names of it) finds neither ``jax`` nor
    ``paddle_tpu`` in ``sys.modules``."""
    out, err = fresh_import.communicate(timeout=120)
    assert fresh_import.returncode == 0, err
    assert out.strip() == "[]"


# ------------------------------------------------- the shared pool, in order


def test_jax_wal_handoff_replays_into_decode_phase(pool, greedy):
    """The pool was built on a copy of a log the JAX package wrote, whose
    one live stream had handed off: it comes back in its decode phase,
    routes to a decode worker with its whole budget (no prefill phase, no
    second handoff) and finishes equal to the JAX model's ``generate()``."""
    _wait(lambda: not pool.recovering, "the replay", 60)
    rec = {rr.request_id: rr for rr in pool.recovered_live()}
    assert set(rec) == {"handed-off"}
    rr = rec["handed-off"]
    assert pool._phase(rr) == "decode"
    out = pool.result(rr, timeout=120)
    np.testing.assert_array_equal(out, greedy("wal")[1][0])
    assert pool.role_of(rr._replica_idx) == DECODE
    assert rr.reroutes == 0


def test_handoff_parity_builds_frozen_and_prefetch(pool, model, greedy,
                                                   flag_guard):
    rng = np.random.default_rng(0)
    h0 = metrics.stats().get("disagg.handoffs", 0)
    st = pool.stats()
    assert [r["role"] for r in st["replicas"]] == \
        [PREFILL, PREFILL, DECODE, DECODE]
    assert st["disagg"]["prefill_healthy"] == 2
    assert st["disagg"]["decode_healthy"] == 2
    assert os.path.isdir(st["disagg"]["disk_dir"])
    assert pool._payload_for(0)["flags"]["serving_tier_publish"] is True
    assert pool._payload_for(2)["flags"]["serving_tier_publish"] is False
    assert pool._payload_for(2)["model_file"] is None  # by reference

    # warm every program the window below runs: each worker's buckets, the
    # restore, the sampled and constrained variants
    trie = TrieConstraint([[5, 6], [7, 8, 9]], vocab_size=VOCAB,
                          stop_token_id=3)
    warm = [pool.submit(_prompt(rng, n), max_new_tokens=4)
            for n in (8, 16, 24) * 2]
    warm.append(pool.submit(_prompt(rng, 16), max_new_tokens=4,
                            sampling=SamplingParams(temperature=0.8,
                                                    top_k=8, seed=1)))
    warm.append(pool.submit(_prompt(rng, 16), max_new_tokens=4,
                            stop_token_id=3, constraint=trie))
    for rr in warm:
        pool.result(rr, timeout=120)
    ws0 = pool.worker_stats()

    # greedy: equal to the JAX model's generate()
    cases = [greedy(f"parity{n}") for n in (8, 16, 24)]
    rrs = [[pool.submit(p, max_new_tokens=24) for p in ps]
           for ps, _ in cases]
    for subs, (_, refs) in zip(rrs, cases):
        for rr, ref in zip(subs, refs):
            np.testing.assert_array_equal(pool.result(rr, timeout=120), ref)
            assert rr.reroutes == 0  # a handoff is not a failure re-route

    # sampled (seeded) and constrained streams cross the processes and
    # equal an in-process engine's
    api = ServingAPI(model, ServingConfig(**POOL_KW), device="cpu")
    try:
        sp = SamplingParams(temperature=0.8, top_k=8, seed=7)
        p = _prompt(rng, 16)
        rr = pool.submit(p, max_new_tokens=16, sampling=sp)
        ref = api.result(api.submit(p, max_new_tokens=16, sampling=sp),
                         timeout=120)
        np.testing.assert_array_equal(pool.result(rr, timeout=120), ref)
        p = _prompt(rng, 16)
        rr = pool.submit(p, max_new_tokens=8, stop_token_id=3,
                         constraint=trie)
        ref = api.result(api.submit(p, max_new_tokens=8, stop_token_id=3,
                                    constraint=trie), timeout=120)
        np.testing.assert_array_equal(pool.result(rr, timeout=120), ref)
    finally:
        api.close()

    # restore-ahead: eight long streams fill the decode workers' slots, so
    # the next four hand off into a queue, where the planner prefetches
    flags.set_flags({"gateway_prefetch": 2})
    f0 = metrics.stats().get("disagg.prefetches", 0)
    (long_ps, want_long), (queued, want_queued) = (greedy("fill"),
                                                   greedy("queued"))
    longs = [pool.submit(p, max_new_tokens=64) for p in long_ps]
    waits = [pool.submit(p, max_new_tokens=24) for p in queued]
    for rr, ref in zip(longs, want_long):
        np.testing.assert_array_equal(pool.result(rr, timeout=120), ref)
    for rr, ref in zip(waits, want_queued):
        np.testing.assert_array_equal(pool.result(rr, timeout=120), ref)
    assert metrics.stats().get("disagg.prefetches", 0) > f0

    # the build counters froze across every handoff and prefetch
    ws1 = pool.worker_stats()
    for i in ws0:
        for key in ("serving.decode_compiles", "serving.prefill_compiles",
                    "serving.cow_compiles", "serving.restore_compiles"):
            assert ws1[i]["compile"].get(key, 0) == \
                ws0[i]["compile"].get(key, 0), (i, key)
        for key in ("decode_traces", "prefill_traces",
                    "prefix_prefill_traces"):
            assert ws1[i]["engine"][key] == ws0[i]["engine"][key], (i, key)
    # every stream crossed: the prefill side published, the decode side
    # restored the chain instead of prefilling it
    assert metrics.stats().get("disagg.handoffs", 0) >= h0 + 6 + 2 + 12
    assert metrics.stats().get("disagg.degraded_routes", 0) == 0
    assert sum(_metric(pool, i, "tier.published_blocks", ws1)
               for i in (0, 1)) > 0
    assert sum(_metric(pool, i, "tier.restored_blocks", ws1)
               for i in (2, 3)) > 0
    assert sum(_metric(pool, i, "tokens.prefill_avoided", ws1)
               for i in (2, 3)) > 0
    # the roles held: prefill workers never decoded past a first token,
    # decode workers never published
    for i in (2, 3):
        assert _metric(pool, i, "tier.published_blocks", ws1) == 0
    for i in ws1:
        assert ws1[i]["imports"] == []


def test_prefill_kill_reprefills_only_unpublished_suffix(pool, greedy,
                                                         flag_guard):
    """A prefill worker SIGKILLed while its chains are half published: its
    streams re-route in their prefill phase, the other prefill worker's
    walk finds the published blocks on the shared disk and prefills only
    the rest (``tokens.prefill_avoided``), and every stream equals the JAX
    model's."""
    flags.set_flags({"serving_telemetry": True})
    ej0 = resilience._counts.get("disagg.prefill_ejections", 0)
    ws = pool.worker_stats()
    pub0 = {i: _metric(pool, i, "tier.published_blocks", ws) for i in (0, 1)}
    avoided0 = {i: _metric(pool, i, "tokens.prefill_avoided", ws)
                for i in (0, 1)}
    # 8 prompts a prefill worker: 4 in its slots (8 chunks each), 4 queued
    prompts, refs = greedy("prefill_kill")
    rrs = [pool.submit(p, max_new_tokens=8) for p in prompts]
    victim = None
    deadline = time.monotonic() + 60.0
    while victim is None and time.monotonic() < deadline:
        ws = pool.worker_stats()
        for i in (0, 1):
            snap = ws.get(i, {})
            if (snap.get("outstanding", 0) > 0
                    and snap["metrics"].get("tier.published_blocks", 0)
                    >= pub0[i] + 2):
                victim = i
                break
    assert victim is not None, "no prefill worker caught mid-publish"
    survivor = 1 - victim
    os.kill(ws[victim]["pid"], 9)
    outs = [pool.result(rr, timeout=120) for rr in rrs]
    for rr, o, ref in zip(rrs, outs, refs):
        np.testing.assert_array_equal(o, ref)
    assert any(rr.reroutes >= 1 for rr in rrs)
    assert resilience._counts.get("disagg.prefill_ejections", 0) > ej0
    # the survivor walked the victim's published blocks: prompts are
    # random, so any prefill it avoided is a block the victim published
    assert _metric(pool, survivor, "tokens.prefill_avoided") \
        > avoided0[survivor]
    for rr in rrs:
        kinds = [ev["event"] for ev in telemetry.trace(rr.trace_id)]
        assert kinds.count(telemetry.SUBMITTED) == 1
        assert kinds[-1] == telemetry.FINISHED


def test_decode_kill_restores_same_hashes(pool, greedy, flag_guard):
    flags.set_flags({"serving_telemetry": True})
    ej0 = resilience._counts.get("disagg.decode_ejections", 0)
    prompts, refs = greedy("decode_kill")
    rrs = [pool.submit(p, max_new_tokens=64) for p in prompts]
    _wait(lambda: all(len(rr.tokens()) >= 4 for rr in rrs),
          "mid-decode on the decode side")
    ws = pool.worker_stats()
    victim = max((2, 3), key=lambda i: ws[i].get("outstanding", 0))
    survivor = 5 - victim
    assert ws[victim]["outstanding"] > 0
    restored0 = _metric(pool, survivor, "tier.restored_blocks", ws)
    os.kill(ws[victim]["pid"], 9)
    for rr, ref in zip(rrs, refs):
        np.testing.assert_array_equal(pool.result(rr, timeout=120), ref)
    assert any(rr.reroutes >= 1 for rr in rrs)
    assert resilience._counts.get("disagg.decode_ejections", 0) > ej0
    # the survivor restored the published chain instead of prefilling it
    assert _metric(pool, survivor, "tier.restored_blocks") > restored0
    for rr in rrs:
        kinds = [ev["event"] for ev in telemetry.trace(rr.trace_id)]
        assert kinds.count(telemetry.SUBMITTED) == 1
        assert telemetry.HANDOFF in kinds
        assert kinds[-1] == telemetry.FINISHED


def test_scale_to_zero_prefill_degrades_to_unified(pool, greedy):
    """Both prefill workers retired (the dead one first): each new request
    routes, degraded, to the surviving decode worker, which serves it end
    to end, equal to the JAX model's."""
    with pytest.raises(ValueError):
        pool.scale_to(2, prefill=1)  # a total and a role count
    with pytest.raises(ValueError):
        pool.scale_to(prefill=-1)
    d0 = metrics.stats().get("disagg.degraded_routes", 0)
    pool.scale_to(prefill=0)
    st = pool.stats()
    assert st["disagg"]["prefill_healthy"] == 0
    assert st["disagg"]["decode_healthy"] == 1
    assert [r["role"] for r in st["replicas"]][:2] == ["removed", "removed"]
    prompts, refs = greedy("scale")
    rrs = [pool.submit(p, max_new_tokens=12) for p in prompts]
    for rr, ref in zip(rrs, refs):
        np.testing.assert_array_equal(pool.result(rr, timeout=120), ref)
        assert pool.role_of(rr._replica_idx) == DECODE
    assert metrics.stats().get("disagg.degraded_routes", 0) >= d0 + 2


def test_close_removes_the_minted_disk_dir(pool):
    d = pool.disk_dir
    assert os.path.isdir(d) and any(n.endswith(".kv")
                                    for n in os.listdir(d))
    procs = [r.api.proc for r in pool.replicas()]
    pool.close()
    assert not os.path.exists(d)
    for proc in procs:
        assert not proc.is_alive()


def test_given_disk_dir_kept_minted_one_removed_on_failure(tmp_path,
                                                          monkeypatch,
                                                          flag_guard):
    """A directory the caller or ``FLAGS_serving_disk_cache_dir`` gave is
    the caller's: the pool never removes it (here at a failed boot, the
    same path as ``close()``); one the pool minted goes."""
    from paddle_tpu_torch.serving.disagg import pool as pool_mod

    minted, real_mint = [], pool_mod.shared_disk_dir

    def mint():
        minted.append(real_mint())
        return minted[-1]

    def boot_fails(self, n):
        raise RuntimeError("no worker booted")

    monkeypatch.setattr(pool_mod.DisaggReplicaPool, "_spawn_initial",
                        boot_fails)
    monkeypatch.setattr(pool_mod, "shared_disk_dir", mint)
    given = str(tmp_path / "given")
    os.makedirs(given)
    flagged = str(tmp_path / "flagged")
    os.makedirs(flagged)
    for kw, keep in (({"disk_dir": given}, given), ({}, None)):
        with pytest.raises(RuntimeError, match="no worker booted"):
            _mk_pool(1, 1, **kw)
        if keep is not None:
            assert os.path.isdir(keep) and not minted
    assert len(minted) == 1 and not os.path.exists(minted[0])
    flags.set_flags({"serving_disk_cache_dir": flagged})
    with pytest.raises(RuntimeError, match="no worker booted"):
        _mk_pool(1, 1)
    assert os.path.isdir(flagged)
