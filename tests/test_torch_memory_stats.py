"""The port's memory stat registry (``paddle_tpu_torch/core/memory_stats.py``)
and ``paddle_tpu_torch.device``'s memory functions against the JAX
package's, on the CPU: the contract of ``tests/test_memory_stats.py``
(``Stat``'s thread-local current summed on read and monotone peak, the
string-keyed host registry, providers in the stats and the summary, the
device half empty without stats, device ids validated), the summary's
lines, and the serving providers, the draft namespace's bytes among them.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.device as jax_device
from paddle_tpu.core import memory_stats as jms
from paddle_tpu.serving import metrics as _jax_serving_metrics  # noqa: F401
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.core import memory_stats as ms
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import ServingAPI, ServingConfig

torch.set_num_threads(1)

BOTH = pytest.mark.parametrize("mod", [jms, ms], ids=["jax", "port"])


@BOTH
def test_stat_current_and_peak(mod):
    s = mod.Stat()
    s.update(100)
    s.update(50)
    assert (s.current_value(), s.peak_value()) == (150, 150)
    s.update(-120)
    assert (s.current_value(), s.peak_value()) == (30, 150)  # monotone
    s.reset_peak()
    assert s.peak_value() == 30
    s.update(10)
    assert s.peak_value() == 40  # a new high after the reset


@BOTH
def test_stat_sums_threads_and_reused_idents(mod):
    s = mod.Stat()

    def work(n):
        for _ in range(n):
            s.update(10)

    for _ in range(2):  # the second round reuses the first's idents
        ts = [threading.Thread(target=work, args=(100,)) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert s.current_value() == 2 * 4 * 100 * 10
    assert s.peak_value() == s.current_value()


def _host_trace(mod, key):
    out = []
    for dev, inc in ((3, 4096), (3, -4096), (0, 7), (3, 100)):
        mod.host_memory_stat_update(key, dev, inc)
        out.append((mod.host_memory_stat_current_value(key, 3),
                    mod.host_memory_stat_peak_value(key, 3),
                    mod.host_memory_stat_current_value(key, 0)))
    mod.reset_peaks(3)
    out.append(mod.host_memory_stat_peak_value(key, 3))
    return out


def test_string_keyed_host_registry_matches_jax():
    """The same updates give the same current and peak values per (stat,
    device) key, and reset_peaks touches only its device's keys."""
    got = _host_trace(ms, "PortUnitStat")
    assert got == _host_trace(jms, "PortUnitStat")
    assert got[0] == (4096, 4096, 0) and got[-1] == 100


def test_stats_and_summary_lines_match_jax():
    """One host stat and one provider in both registries: the same keys
    and values in ``memory_stats`` and the same summary lines for them; a
    broken provider reads -1; an unregistered one is gone."""
    lines = []
    for mod in (jms, ms):
        mod.host_memory_stat_update("SummaryUnit", 0, 3 << 20)
        mod.register_stat_provider("unit_gauge", lambda: 12345)
        mod.register_stat_provider("unit_broken", lambda: 1 // 0)
        try:
            st = mod.memory_stats(0)
            assert st["provider.unit_gauge"] == 12345
            assert st["provider.unit_broken"] == -1
            assert st["host.SummaryUnit.current"] == 3 << 20
            assert st["host.SummaryUnit.peak"] == 3 << 20
            text = mod.memory_summary(0).splitlines()
            assert text[0].endswith("memory summary (device 0) ===")
            lines.append([ln for ln in text[1:] if "Unit" in ln
                          or "unit_" in ln or ln.startswith("stat")])
        finally:
            mod.unregister_stat_provider("unit_gauge")
            mod.unregister_stat_provider("unit_broken")
            mod.host_memory_stat_update("SummaryUnit", 0, -(3 << 20))
        assert "provider.unit_gauge" not in mod.memory_stats(0)
    assert lines[0] == lines[1]
    assert any("3.0 MiB" in ln for ln in lines[1])


@BOTH
def test_device_half_without_stats(mod):
    """Without device stats (the CPU) the device half reports nothing and
    the device functions read 0; a device id out of range and an unknown
    stat raise ValueError."""
    st = mod.memory_stats()
    assert not any(k.startswith("device.") for k in st)
    assert mod.device_memory_stat_current_value("Allocated") == 0
    assert mod.device_memory_stat_peak_value("Reserved") == 0
    with pytest.raises(ValueError):
        mod.device_memory_stat_current_value("Bogus")
    with pytest.raises(ValueError):
        mod.local_device(999)


@pytest.mark.parametrize("dev", [jax_device, pdevice], ids=["jax", "port"])
def test_device_namespace_memory_functions(dev):
    assert isinstance(dev.memory_stats(), dict)
    assert isinstance(dev.memory_summary(), str)
    dev.reset_max_memory_allocated()
    dev.reset_max_memory_reserved()
    for fn in (dev.memory_allocated, dev.max_memory_allocated,
               dev.memory_reserved, dev.max_memory_reserved):
        assert fn() == 0
        assert fn("gpu:0") == 0


def test_serving_providers_report_the_draft_namespace():
    """The serving counters and latency percentiles are providers (every
    JAX serving provider has its port counterpart), and the port's draft
    line reads the draft namespace's bytes of the engine last built."""
    jax_names = {k for k in jms.memory_stats()
                 if k.startswith("provider.serving.")}
    names = {k for k in ms.memory_stats() if k.startswith("provider.serving.")}
    assert jax_names <= names
    assert "provider.serving.kv_arena_draft_bytes" in names
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    api = ServingAPI(m, ServingConfig(num_slots=2, kv_block_size=8,
                                      max_model_len=64, spec_k=2,
                                      draft_model=m), device="cpu")
    try:
        by_ns = api.engine.arena.bytes_by_namespace()
        st = ms.memory_stats()
        assert st["provider.serving.kv_arena_draft_bytes"] == \
            by_ns["draft"]["bytes"] > 0
        assert st["provider.serving.kv_arena_bytes"] == \
            api.engine.arena.bytes_total() == 2 * by_ns["primary"]["bytes"]
        assert "serving.kv_arena_draft_bytes" in ms.memory_summary()
        req = api.submit(np.arange(1, 9), max_new_tokens=4)
        api.run_until_idle()
        assert ms.memory_stats()["provider.serving.ttft_p50_ms"] >= 0
        assert len(req.tokens) == 4
    finally:
        api.close()
