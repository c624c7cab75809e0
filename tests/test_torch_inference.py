"""The port's inference surface (``paddle_tpu_torch/inference``) and the
serving engine's ``serving_step`` retry against the JAX package's, on the
CPU.

``Config``'s model-path parsing equals the JAX ``Config``'s; the serving
route of ``create_predictor`` gives the JAX ``EnginePredictor``'s outputs
and ``generate(stop_token_id=)``'s row for row; the exported-program route
loads the config's ``.pdmodel`` through ``jit.load`` (a missing one raises
``FileNotFoundError`` in both packages; ``tests/test_torch_jit_export.py``
runs saved programs); the placement maps to a torch device. A ``serving_step`` fault (an IO-class error) is
retried around the step program's run as the JAX engine's ``_call`` retries
it, with the same ``retry.*`` counts, no rebuild and the same streams, in
the plain and the speculative engine; a fault that outlasts the policy
fails the requests with it in both packages.
"""
import contextlib
import logging
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jax_inference
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import inference
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (EnginePredictor, RequestState,
                                      ServingAPI, ServingConfig)

torch.set_num_threads(1)

MAX_LEN, VOCAB = 64, 1024


@contextlib.contextmanager
def _flags(**values):
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


def _ref(model, prompt, n, stop=None):
    return model.generate(torch.as_tensor(prompt)[None], max_new_tokens=n,
                          stop_token_id=stop)[0].numpy()


# ---------------------------------------------------------------- Config


@pytest.mark.parametrize("path", ["d/model.pdmodel", "d/model.pdiparams",
                                  "d/model.pdparams", "d/model", "d", None,
                                  "two", "none"])
def test_config_path_parsing_matches_jax(tmp_path, path):
    """A file with any of the three suffixes, a bare prefix, a directory
    with exactly one ``.pdmodel``, no path: the same ``model_prefix`` as the
    JAX Config; a directory with two or none raises ValueError in both."""
    d = tmp_path / "d"
    d.mkdir()
    (d / "model.pdmodel").write_bytes(b"")
    for name in ("two", "none"):
        (tmp_path / name).mkdir()
    (tmp_path / "two" / "a.pdmodel").write_bytes(b"")
    (tmp_path / "two" / "b.pdmodel").write_bytes(b"")
    arg = None if path is None else os.path.join(str(tmp_path), path)
    if path in ("two", "none"):
        for mod in (jax_inference, inference):
            with pytest.raises(ValueError, match="exactly one .pdmodel"):
                mod.Config(arg)
        return
    got = inference.Config(arg).model_prefix
    assert got == jax_inference.Config(arg).model_prefix
    assert got == ("" if path is None else str(d / "model"))


def test_config_switches_and_placement(model, caplog):
    """The no-op switches are accepted; the placement maps to a torch
    device: the port's default device, ``cuda:<id>`` after
    ``enable_use_gpu`` (which raises here, with no CUDA), or an
    ``enable_serving_engine`` ``device=``, logged once per pair."""
    cfg = inference.Config()
    cfg.enable_memory_optim(False)
    cfg.disable_glog_info()
    cfg.switch_ir_optim(True)
    cfg.set_cpu_math_library_num_threads(2)
    assert cfg._resolve_placement() == "cuda"
    cfg.enable_use_gpu(100, 1)
    cfg.enable_serving_engine(model=model)
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.inference"):
        assert cfg._resolve_placement() == "cuda:1"
        assert cfg._resolve_placement() == "cuda:1"
    assert caplog.text.count("gpu:1 requested, running on cuda:1") == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.create_predictor(cfg)
    cfg.enable_serving_engine(model=model, device="cpu")
    assert cfg._resolve_placement() == "cpu"


def test_create_predictor_routes(model, jax_model):
    """Without ``enable_serving_engine`` the exported-program route loads
    the prefix through ``jit.load``: a missing program raises
    FileNotFoundError in both packages; with it but no model, both
    packages raise ValueError."""
    cfg = inference.Config("some/model")
    cfg.disable_gpu()
    for mod, c in ((jax_inference, jax_inference.Config("some/model")),
                   (inference, cfg)):
        with pytest.raises(FileNotFoundError, match="some/model"):
            mod.create_predictor(c)
    for mod, m in ((jax_inference, jax_model), (inference, model)):
        cfg = mod.Config()
        cfg.enable_serving_engine(model=None)
        with pytest.raises(ValueError, match="in-memory GPT"):
            mod.create_predictor(cfg)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_create_predictor_serving_route_matches_jax(jax_model, model,
                                                    spec_k):
    """``create_predictor`` after ``enable_serving_engine`` is an
    ``EnginePredictor``; its outputs equal the JAX predictor's and
    ``generate(stop_token_id=)``'s row for row, spec-off and lockstep."""
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, VOCAB, 7) for _ in range(3)]).astype(
        np.int32)
    stop = int(_ref(model, ids[1], 6)[7 + 2])
    cfg = dict(num_slots=2, kv_block_size=8, max_model_len=MAX_LEN,
               spec_k=spec_k)
    jcfg = jax_inference.Config()
    jcfg.enable_serving_engine(model=jax_model, max_new_tokens=6,
                               stop_token_id=stop,
                               config=JaxServingConfig(**cfg))
    pcfg = inference.Config()
    pcfg.enable_serving_engine(model=model, max_new_tokens=6,
                               stop_token_id=stop, device="cpu",
                               config=ServingConfig(**cfg))
    jp = jax_inference.create_predictor(jcfg)
    pp = inference.create_predictor(pcfg)
    try:
        assert isinstance(pp, EnginePredictor)
        assert pp._api.engine.device.type == "cpu"
        outs = []
        for pred in (jp, pp):
            h = pred.get_input_handle("input_ids")
            h.copy_from_cpu(ids)
            pred.run()
            outs.append(pred.get_output_handle("output_0").copy_to_cpu())
        np.testing.assert_array_equal(outs[1], outs[0])
        for i in range(3):
            np.testing.assert_array_equal(outs[1][i],
                                          _ref(model, ids[i], 6, stop))
        assert (pp._api.engine.spec is None) == (spec_k == 0)
    finally:
        jp.close()
        pp.close()


# ------------------------------------------------------ serving_step retry


def _retry_counts(res, name):
    st = res.stats()
    return {k: st.get(k, 0) for k in (
        "retry.retries", f"retry.{name}", "retry.exhausted",
        f"retry.{name}.exhausted", "serving.rebuilds")}


@pytest.mark.parametrize("spec_k,times", [(0, 2), (3, 2), (0, 3)])
def test_serving_step_fault_is_retried_without_rebuild(jax_model, model,
                                                       spec_k, times):
    """Two prompts prefill (the fault lets their two probes pass), then the
    next step's run meets ``times`` injected OSErrors. Two are retried
    inside the run (``retry.serving.step``, or ``retry.serving.spec_step``
    in the speculative engine) with no rebuild, and the streams equal
    ``generate()``; three exhaust the policy's three attempts and the
    requests fail with the OSError. The same counts as the JAX engine."""
    cfg = dict(num_slots=2, kv_block_size=8, max_model_len=MAX_LEN,
               spec_k=spec_k)
    name = "serving.spec_step" if spec_k else "serving.step"
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, n) for n in (6, 11)]
    records = []
    with _flags(fault_injection=1, io_retry_backoff=0.001):
        for port in (False, True):
            if port:
                api, res = ServingAPI(model, ServingConfig(**cfg),
                                      device="cpu"), resilience
            else:
                # the JAX engine retries only without donation
                api, res = JaxServingAPI(jax_model, JaxServingConfig(
                    donate=False, **cfg)), jax_resilience
            try:
                before = _retry_counts(res, name)
                res.inject_fault("serving_step", times=times, after=2,
                                 exc=OSError("injected serving_step fault"))
                reqs = [api.submit(np.asarray(p, np.int32), max_new_tokens=8)
                        for p in prompts]
                try:
                    api.run_until_idle()
                    raised = None
                except OSError as e:  # the pump re-raises what it failed
                    raised = str(e)
                after = _retry_counts(res, name)
                moved = {k: after[k] - before[k] for k in after}
                states = [r.state for r in reqs]
                errors = [type(r.error).__name__ for r in reqs]
                outs = [[int(t) for t in r.output_ids()] for r in reqs]
                records.append((moved, states, errors, outs, raised))
            finally:
                api.close()
                res.clear_faults()
    assert records[0] == records[1]
    moved, states, errors, outs, raised = records[1]
    assert moved["serving.rebuilds"] == 0
    if times == 2:
        assert moved["retry.retries"] == moved[f"retry.{name}"] == 2
        assert states == [RequestState.FINISHED] * 2 and raised is None
        for p, toks in zip(prompts, outs):
            np.testing.assert_array_equal(toks, _ref(model, p, 8))
    else:
        assert moved["retry.exhausted"] == moved[f"retry.{name}.exhausted"] \
            == 1
        assert states == [RequestState.FAILED] * 2
        assert errors == ["OSError"] * 2
        assert raised == "injected serving_step fault"
