"""The port's fault registry and preemption guard
(``paddle_tpu_torch/core/resilience.py``) on the CPU, mirroring
``tests/test_resilience.py`` ``test_serving_fault_kinds_and_error_taxonomy``,
``test_serving_faults_default_to_their_error_classes``,
``test_preemption_guard_signal_requests_not_kills`` and
``test_preemption_guard_second_signal_escalates``; and the registry's
semantics (``FLAGS_fault_injection`` gate, ``after`` / ``times``, the
``FLAGS_inject_faults`` loader) held against the JAX package's on the same
schedule.
"""
import os
import signal
import time

import pytest

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu_torch.core import flags, resilience


@pytest.fixture()
def faults_on():
    keep = (paddle.get_flags(["fault_injection", "inject_faults"]),
            flags.get_flags(["fault_injection", "inject_faults"]))
    paddle.set_flags({"fault_injection": True})
    flags.set_flags({"fault_injection": True})
    yield
    for mod in (jax_resilience, resilience):
        mod.clear_faults()
        mod._env_faults_loaded = False
    paddle.set_flags(keep[0])
    flags.set_flags(keep[1])


def test_serving_fault_kinds_and_error_taxonomy():
    for kind in ("serving_device", "arena_corrupt", "preempt"):
        assert kind in resilience.KNOWN_FAULTS
    for klass in (resilience.ServingDeviceError, resilience.ArenaCorruptError,
                  resilience.RequestDrainedError):
        assert issubclass(klass, RuntimeError)
    assert issubclass(resilience.DeadlineExceededError, TimeoutError)


def test_arming_needs_the_flag():
    keep = flags.get_flags("fault_injection")
    flags.set_flags({"fault_injection": False})
    try:
        with pytest.raises(RuntimeError, match="FLAGS_fault_injection"):
            resilience.inject_fault("serving_device")
        assert resilience.maybe_fault("serving_device") is False
    finally:
        flags.set_flags(keep)


@pytest.mark.chaos
def test_serving_faults_default_to_their_error_classes(faults_on):
    resilience.inject_fault("serving_device")
    with pytest.raises(resilience.ServingDeviceError, match="injected"):
        resilience.maybe_fault("serving_device")
    resilience.inject_fault("arena_corrupt")
    with pytest.raises(resilience.ArenaCorruptError, match="injected"):
        resilience.maybe_fault("arena_corrupt")
    # arming through the environment defaults the same way
    flags.set_flags({"FLAGS_inject_faults": "serving_device:1"})
    resilience.clear_faults()
    resilience._env_faults_loaded = False
    with pytest.raises(resilience.ServingDeviceError):
        resilience.maybe_fault("serving_device")


@pytest.mark.chaos
def test_fault_schedule_equals_jax(faults_on):
    """``after`` probes pass, ``times`` fire, then the fault disarms; a
    flag kind returns True; ``fault_armed`` and ``faults.armed`` follow;
    the environment loader parses ``kind:times:after``: the same answers
    probe by probe as the JAX registry."""

    def script(mod, set_flags):
        out = []
        mod.inject_fault("preempt", times=2, after=1)
        out.append((mod.fault_armed("preempt"),
                    mod.stats()["faults.armed"]))
        out += [mod.maybe_fault("preempt") for _ in range(4)]
        out.append(mod.fault_armed("preempt"))
        mod.inject_fault("serving_device", times=1, after=2)
        for _ in range(4):
            try:
                out.append(mod.maybe_fault("serving_device"))
            except mod.ServingDeviceError:
                out.append("raised")
        mod.clear_faults()
        set_flags({"FLAGS_inject_faults": "preempt:1:1,arena_corrupt:1"})
        mod._env_faults_loaded = False
        out += [mod.maybe_fault("preempt") for _ in range(3)]
        with pytest.raises(mod.ArenaCorruptError):
            mod.maybe_fault("arena_corrupt")
        return out

    ref = script(jax_resilience, paddle.set_flags)
    got = script(resilience, flags.set_flags)
    assert got == ref
    assert got == [(True, 2), False, True, True, False, False,
                   False, False, "raised", False, False, True, False]


def test_preemption_guard_signal_requests_not_kills():
    guard = resilience.PreemptionGuard()
    try:
        assert not guard.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not guard.requested() and time.time() < deadline:
            time.sleep(0.01)
        assert guard.requested()  # alive: the signal became a request
        assert "signal" in guard.reason
    finally:
        guard.uninstall()


def test_preemption_guard_second_signal_escalates():
    hits = []
    sig = signal.SIGUSR1
    prev = signal.signal(sig, lambda s, f: hits.append(s))
    before = resilience.stats().get("preempt.escalations", 0)
    guard = resilience.PreemptionGuard(signals=(sig,))
    try:
        os.kill(os.getpid(), sig)
        deadline = time.time() + 5
        while not guard.requested() and time.time() < deadline:
            time.sleep(0.01)
        assert guard.requested() and not hits  # the first: a request only
        os.kill(os.getpid(), sig)
        deadline = time.time() + 5
        while not hits and time.time() < deadline:
            time.sleep(0.01)
        assert hits == [sig]  # the second: the previous handler
        assert resilience.stats()["preempt.escalations"] == before + 1
    finally:
        guard.uninstall()
        signal.signal(sig, prev)
