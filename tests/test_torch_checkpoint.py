"""Resilience, save/load and step checkpoints of the port, against the JAX
package where both have the behaviour.

* retry, fault injection, the atomic save and the checkpoint integrity
  tests follow ``tests/test_resilience.py`` against the port;
* manifests: ``_manifest_entries`` of the port equals the JAX package's
  for the same arrays (paths, shapes, dtypes and crc32s, exactly);
* ``paddle_tpu_torch.load`` reads files that ``paddle_tpu.save`` wrote
  (float32, float16, int and bfloat16 tensors, nested state) exactly.
"""
import json
import os
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu_torch import load, save
from paddle_tpu_torch.core import flags, resilience, rng
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.framework import random as prandom

torch.set_num_threads(1)

_FLAG_KEYS = ["fault_injection", "max_bad_steps", "ckpt_manifest",
              "ckpt_manifest_crc_max_bytes", "io_retries",
              "io_retry_backoff", "io_retry_deadline", "inject_faults"]


@pytest.fixture(autouse=True)
def _clean_state():
    keep = flags.get_flags(_FLAG_KEYS)
    resilience.reset_stats()
    try:
        yield
    finally:
        resilience.clear_faults()
        resilience.set_rollback_handler(None)
        flags.set_flags(keep)


def _state(seed=0):
    r = np.random.default_rng(seed)
    return {"w": torch.from_numpy(r.standard_normal((4, 8)).astype(
                np.float32)),
            "b": torch.from_numpy(r.standard_normal(8).astype(np.float32)),
            "h": torch.from_numpy(r.standard_normal(5).astype(
                np.float32)).bfloat16(),
            "opt": {"step": 3, "m": [torch.arange(4, dtype=torch.int32)]}}


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


# ------------------------------------------------------------------- retry


def test_retry_succeeds_after_transient_failures():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    out = resilience.call_with_retry(
        flaky, policy=resilience.RetryPolicy(max_attempts=5,
                                             base_delay=0.001), name="unit")
    assert out == "ok" and len(calls) == 3
    s = resilience.stats()
    assert s["retry.retries"] == 2 and s["retry.unit"] == 2


def test_retry_exhausts_and_reraises_original():
    @resilience.retry(resilience.RetryPolicy(max_attempts=2,
                                             base_delay=0.001))
    def always():
        raise ValueError("permanent")

    with pytest.raises(ValueError, match="permanent"):
        always()
    assert resilience.stats()["retry.exhausted"] == 1
    assert resilience.stats()["retry.always.exhausted"] == 1


def test_retry_giveup_and_io_policy():
    calls = []

    def fatal():
        calls.append(1)
        raise RuntimeError("already initialized")

    with pytest.raises(RuntimeError):
        resilience.call_with_retry(fatal, policy=resilience.RetryPolicy(
            max_attempts=5, base_delay=0.001,
            giveup=lambda e: "already" in str(e)))
    assert len(calls) == 1
    # the IO policy does not retry a structural error
    calls.clear()

    def torn():
        calls.append(1)
        raise ValueError("torn format")

    flags.set_flags({"io_retry_backoff": 0.001})
    with pytest.raises(ValueError):
        resilience.call_with_retry(torn, policy=resilience.io_policy())
    assert len(calls) == 1
    p = resilience.default_policy()
    assert (p.max_attempts, p.deadline) == (3, 120.0)


def test_retry_deadline_bounds_attempts():
    calls = []

    def slow_fail():
        calls.append(1)
        time.sleep(0.03)
        raise OSError("x")

    with pytest.raises(OSError):
        resilience.call_with_retry(slow_fail, policy=resilience.RetryPolicy(
            max_attempts=100, base_delay=0.001, deadline=0.05))
    assert len(calls) < 10


def test_faults_fire_deterministically():
    with pytest.raises(RuntimeError, match="FLAGS_fault_injection"):
        resilience.inject_fault("ckpt_io")
    assert resilience.maybe_fault("ckpt_io") is False
    flags.set_flags({"fault_injection": True})
    resilience.inject_fault("preempt", times=2, after=1)
    assert [resilience.maybe_fault("preempt") for _ in range(4)] == [
        False, True, True, False]
    assert resilience.stats()["fault.preempt"] == 2
    resilience.inject_fault("ckpt_io")
    with pytest.raises(OSError, match="injected ckpt_io"):
        resilience.maybe_fault("ckpt_io")
    for kind in ("ckpt_io", "nonfinite_grads", "preempt"):
        assert kind in resilience.KNOWN_FAULTS


# --------------------------------------------------------- save and load


def test_kill_mid_save_preserves_previous_file(tmp_path):
    path = str(tmp_path / "model.pdparams")
    save({"w": torch.arange(4, dtype=torch.float32)}, path)
    flags.set_flags({"fault_injection": True, "io_retries": 1})
    resilience.inject_fault("ckpt_io", exc=OSError("killed mid-save"))
    with pytest.raises(OSError):
        save({"w": torch.zeros(999)}, path)
    out = load(path, return_numpy=True)
    np.testing.assert_array_equal(out["w"], np.arange(4, dtype=np.float32))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_save_retries_transient_io(tmp_path):
    path = str(tmp_path / "model.pdparams")
    flags.set_flags({"fault_injection": True, "io_retry_backoff": 0.001})
    resilience.inject_fault("ckpt_io", times=1, exc=OSError("transient"))
    save({"w": torch.arange(3)}, path)
    assert resilience.stats()["retry.paddle.save"] >= 1
    assert torch.equal(load(path)["w"], torch.arange(3))


def test_port_file_round_trips(tmp_path):
    path = str(tmp_path / "x.pdopt")
    sd = _state()
    save(sd, path)
    assert _equal(load(path), sd)
    arrays = load(path, return_numpy=True)
    np.testing.assert_array_equal(arrays["h"], sd["h"].float().numpy())
    assert arrays["h"].dtype == np.float32
    np.testing.assert_array_equal(arrays["w"], sd["w"].numpy())


@pytest.mark.parametrize("return_numpy", [False, True])
def test_loads_files_the_jax_package_wrote(tmp_path, return_numpy):
    """A ``.pdparams`` (a model's state) and a ``.pdopt`` (an optimizer's
    state with a scheduler and bf16 moments) written by
    ``paddle_tpu.save``."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.optimizer import Adam
    from paddle_tpu.optimizer import lr as jlr

    paddle.seed(0)
    net = jnn.Linear(3, 4)
    opt = Adam(learning_rate=jlr.StepDecay(0.1, 2), parameters=
               net.parameters(), moment_dtype="bfloat16")
    (net(paddle.to_tensor(np.ones((2, 3), np.float32))) ** 2).sum().backward()
    opt.step()
    sd, osd = net.state_dict(), opt.state_dict()
    paddle.save(sd, str(tmp_path / "m.pdparams"))
    paddle.save(osd, str(tmp_path / "m.pdopt"))
    paddle.save({"half": Tensor(jnp.ones(3, jnp.float16)),
                 "raw": np.arange(3)}, str(tmp_path / "misc"))
    got = load(str(tmp_path / "m.pdparams"), return_numpy=return_numpy)
    gopt = load(str(tmp_path / "m.pdopt"), return_numpy=return_numpy)
    misc = load(str(tmp_path / "misc"), return_numpy=return_numpy)
    for k, v in sd.items():
        want = np.asarray(v._data)
        a = got[k] if return_numpy else got[k].numpy()
        np.testing.assert_array_equal(a, want)
    for k, v in osd.items():
        if isinstance(v, Tensor):
            want = np.asarray(v._data.astype(jnp.float32))
            g = gopt[k]
            if not return_numpy:
                assert g.dtype == (torch.bfloat16 if v._data.dtype ==
                                   jnp.bfloat16 else g.dtype)
                g = g.float().numpy()
            np.testing.assert_array_equal(g, want)
        else:
            assert gopt[k] == v
    assert gopt["LR_Scheduler"]["step_size"] == 2
    half = misc["half"] if return_numpy else misc["half"].numpy()
    assert half.dtype == np.float16 and (half == 1).all()
    np.testing.assert_array_equal(misc["raw"], np.arange(3))


def test_rng_state_aliases():
    rng.seed(5)
    state = prandom.get_cuda_rng_state()
    a = rng.next_key()
    prandom.set_cuda_rng_state(state)
    assert torch.equal(rng.next_key(), a)
    assert torch.equal(prandom.get_rng_state(), rng.get_rng_state())


# ---------------------------------------------------------------- manifests


@pytest.mark.parametrize("budget", [256 * 1024 * 1024, 100])
def test_manifest_entries_equal_jax(budget):
    """Paths, shapes, dtypes and crc32s equal the JAX package's for the
    same arrays, also when the byte budget leaves the larger leaves
    without a crc32."""
    from paddle_tpu.core import flags as jflags

    flags.set_flags({"ckpt_manifest_crc_max_bytes": budget})
    keep = jflags.flag("ckpt_manifest_crc_max_bytes")
    jflags.set_flags({"ckpt_manifest_crc_max_bytes": budget})
    try:
        sd = _state()
        jtree = {"w": jnp.asarray(sd["w"].numpy()),
                 "b": jnp.asarray(sd["b"].numpy()),
                 "h": jnp.asarray(sd["h"].float().numpy()).astype(
                     jnp.bfloat16),
                 "opt": {"step": 3, "m": [jnp.arange(4, dtype=jnp.int32)]}}
        assert ck._manifest_entries(sd) == jck._manifest_entries(jtree)
    finally:
        jflags.set_flags({"ckpt_manifest_crc_max_bytes": keep})


# ------------------------------------------------------------- checkpoints


def _two_steps(tmp_path, async_save=True):
    c = ck.TrainCheckpointer(str(tmp_path / "mgr"), max_to_keep=4,
                             async_save=async_save)
    sd1 = _state(1)
    c.save(1, sd1)
    c.save(2, _state(2))
    c.wait_until_finished()
    return c, sd1


def test_steps_retention_and_manifests(tmp_path):
    c = ck.TrainCheckpointer(str(tmp_path / "mgr"), max_to_keep=2,
                             save_interval_steps=2)
    assert c.save(1, _state()) is False  # not a multiple of the interval
    for s in (2, 4, 6):
        assert c.save(s, _state(s))
    assert c.save(6, _state()) is False  # in flight or saved
    c.wait_until_finished()
    assert c.all_steps() == [4, 6] and c.latest_step() == 6
    mdir = tmp_path / "mgr" / "manifests"
    assert sorted(int(n.split(".")[0]) for n in os.listdir(mdir)) == [4, 6]
    assert _equal(c.restore(), _state(6))
    assert _equal(c.restore(step=4), _state(4))
    with pytest.raises(ValueError, match=r"available steps: \[4, 6\]"):
        c.restore(step=7)
    c.close()


def test_truncated_newest_step_falls_back(tmp_path):
    c, sd1 = _two_steps(tmp_path)
    for name in ("data.bin", "tree.pkl"):
        open(tmp_path / "mgr" / "2" / name, "wb").close()
    flags.set_flags({"io_retries": 1})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = c.restore()
    assert c.last_restored_step == 1 and _equal(out, sd1)
    assert resilience.stats()["ckpt.invalid_steps"] >= 1


def test_checksum_mismatch_falls_back_and_explicit_step_raises(tmp_path):
    c, sd1 = _two_steps(tmp_path)
    mpath = tmp_path / "mgr" / "manifests" / "2.json"
    manifest = json.loads(mpath.read_text())
    manifest["leaves"]["['w']"]["crc32"] = 12345
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ck.CheckpointIntegrityError, match="checksum"):
        c.restore(step=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _equal(c.restore(), sd1)
    assert c.last_restored_step == 1
    assert c.latest_valid_step() == 1


def test_flipped_bytes_are_caught_by_the_manifest(tmp_path):
    c, sd1 = _two_steps(tmp_path)
    data = tmp_path / "mgr" / "2" / "data.bin"
    raw = bytearray(data.read_bytes())
    raw[5] ^= 0xFF
    data.write_bytes(bytes(raw))
    with pytest.raises(ck.CheckpointIntegrityError, match="checksum"):
        c.restore(step=2)


def test_save_restore_retry_a_transient_fault(tmp_path):
    c = ck.TrainCheckpointer(str(tmp_path / "mgr"))
    flags.set_flags({"fault_injection": True, "io_retry_backoff": 0.001})
    resilience.inject_fault("ckpt_io", times=1, exc=OSError("flaky fs"))
    c.save(1, _state())
    c.wait_until_finished()
    assert resilience.stats()["retry.ckpt.save"] >= 1
    resilience.inject_fault("ckpt_io", times=1, exc=OSError("flaky fs"))
    assert _equal(c.restore(), _state())
    assert resilience.stats()["retry.ckpt.restore"] >= 1


def test_failed_async_write_surfaces_and_leaves_no_step(tmp_path):
    c = ck.TrainCheckpointer(str(tmp_path / "mgr"))
    flags.set_flags({"fault_injection": True, "io_retries": 1})
    resilience.inject_fault("ckpt_io", times=1, exc=OSError("disk gone"))
    c.save(1, _state())
    with pytest.raises(OSError, match="disk gone"):
        c.wait_until_finished()
    assert c.all_steps() == []
    assert not [n for n in os.listdir(tmp_path / "mgr") if "tmp" in n]


def test_async_snapshot_ignores_the_next_in_place_update(tmp_path):
    """``save`` copies the state before it returns: an in-place update
    right after it (the next step's) does not reach the checkpoint, even
    while the write is held back."""
    c = ck.TrainCheckpointer(str(tmp_path / "mgr"), async_save=True)
    gate = threading.Event()
    c._pool.submit(gate.wait)  # the writer is busy until the gate opens
    sd = _state()
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in sd.items() if k != "opt"}
    c.save(1, {k: sd[k] for k in want})
    sd["w"].add_(1.0)
    sd["h"].mul_(0)
    gate.set()
    c.wait_until_finished()
    assert _equal(c.restore(), want)


def test_maybe_finalize_writes_the_step_and_marker_once(tmp_path):
    """A pending preemption at a step boundary: the in-flight async save
    of that step is committed, not written twice; the marker names it;
    without a pending preemption nothing happens; with exit_process the
    guard raises SystemExit(0)."""
    c = ck.TrainCheckpointer(str(tmp_path / "mgr"), async_save=True)
    guard = resilience.PreemptionGuard(install=False)
    assert guard.maybe_finalize(3, c, _state) is False
    gate = threading.Event()
    c._pool.submit(gate.wait)
    c.save(3, _state(3))
    calls = []
    real = c.save
    c.save = lambda *a, **k: calls.append(a) or real(*a, **k)
    flags.set_flags({"fault_injection": True})
    resilience.inject_fault("preempt")
    threading.Timer(0.05, gate.set).start()
    assert guard.maybe_finalize(3, c, lambda: _state(3),
                                exit_process=False) is True
    assert calls == [] and c.all_steps() == [3]
    assert c.resume_marker()["step"] == 3
    assert "injected" in c.resume_marker()["reason"]
    # a new step is saved synchronously, then the process exits
    with pytest.raises(SystemExit) as e:
        guard.maybe_finalize(4, c, _state(4))
    assert e.value.code == 0
    assert c.all_steps() == [3, 4] and c.resume_marker()["step"] == 4
    assert resilience.stats()["preempt.final_saves"] == 2
    c.clear_resume_marker()
    assert c.resume_marker() is None
    c.close()


def test_save_load_apply_state_dict(tmp_path):
    """One-path state dicts: an overwrite keeps the previous one aside
    until it commits; ``load_state_dict`` falls back to it; ``target``
    places tensors; ``apply_state_dict`` copies into a module."""
    path = str(tmp_path / "sd")
    ck.save_state_dict(_state(1), path)
    h = ck.save_state_dict(_state(2), path, blocking=False)
    h.wait()
    assert not os.path.exists(path + ".prev")
    assert _equal(ck.load_state_dict(path), _state(2))
    os.replace(path, path + ".prev")  # a save that died before its commit
    assert _equal(ck.load_state_dict(path, target=_state(0)), _state(2))
    lin = torch.nn.Linear(8, 4)
    ck.apply_state_dict(lin, {"weight": _state(3)["w"], "bias": np.zeros(4)})
    assert torch.equal(lin.weight.detach(), _state(3)["w"])
    assert torch.equal(lin.bias.detach(), torch.zeros(4))
