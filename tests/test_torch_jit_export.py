"""The port's deploy path -- ``jit.save`` / ``jit.load`` / ``TranslatedLayer``,
``inference.Predictor`` and ``static.save_inference_model`` -- against the
JAX package's own export, on the CPU.

The cases of ``tests/test_inference_export.py:16-100`` on a two-``Linear``
module and on ``gpt_tiny``, in f32 at atol 1e-5: the port's program runs
without the model's code and equals the JAX package's exported program on
the same weights. Also: one save with ``InputSpec([None, None])`` run at
two shapes (the JAX package exports each shape: its GPT does not export
with a symbolic sequence); unnamed specs sharing their symbols against
named ones; the flash route forced on the CPU, so that the program holds
the registered op ``paddle_tpu_torch::flash_forward`` run through its
plain version, held against the JAX ``flash_attention`` in interpret
mode; a threshold inside the exported range refused at ``jit.save``;
``.pdparams`` loading across the two packages both ways, bfloat16
included; the ``ValueError`` on a JAX ``.pdmodel``; and a subprocess that
loads and runs a program with ``paddle_tpu_torch.models`` never imported.
"""
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jax_inference
from paddle_tpu import nn as jnn
from paddle_tpu.jit import InputSpec as JaxInputSpec
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.functional import attention as jax_attention
from paddle_tpu_torch import inference, jit, static
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
            max_position_embeddings=256)
SHAPES = ((2, 16), (3, 40))


def _mlp_pair():
    """The two-Linear module of ``test_inference_export.py`` in both
    packages, on the same weights."""
    paddle.seed(7)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    jm.eval()
    m = torch.nn.Sequential(Linear(4, 8), torch.nn.ReLU(), Linear(8, 2))
    with torch.no_grad():
        for k, v in jm.state_dict().items():
            m.state_dict()[k].copy_(torch.from_numpy(np.asarray(v._data)))
    return m.eval(), jm


def _gpt_pair(cfg=TINY, seed=0):
    m = gpt.GPTForCausalLM(gpt.GPTConfig(**cfg), device="cpu")
    arrays = gpt.seeded_state(m, seed=seed)
    gpt.load_functional_state(m, arrays)
    jm = JaxGPT(JaxConfig(**cfg))
    for name, t in jm.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    jm.eval()
    return m, jm


def _ids(shape, seed=0, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_export_and_load_runs_without_model_code(tmp_path):
    m, jm = _mlp_pair()
    x = np.random.default_rng(1).random((3, 4)).astype(np.float32)
    prefix = os.path.join(str(tmp_path), "deploy", "model")
    jit.save(m, prefix, input_spec=[InputSpec([3, 4], "float32")])
    jprefix = os.path.join(str(tmp_path), "jax", "model")
    paddle.jit.save(jm, jprefix, input_spec=[JaxInputSpec([3, 4], "float32")])
    assert os.path.exists(prefix + ".pdmodel")
    out = jit.load(prefix, device="cpu")(torch.from_numpy(x))
    want = paddle.jit.load(jprefix)(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), m(torch.from_numpy(x))
                               .detach().numpy(), atol=1e-5)


def test_static_save_load_inference_model(tmp_path):
    m, jm = _mlp_pair()
    prefix = os.path.join(str(tmp_path), "infer")
    static.save_inference_model(prefix, m, [InputSpec([2, 4])])
    paddle.static.save_inference_model(prefix + "_jax", jm,
                                       [JaxInputSpec([2, 4])])
    x = np.random.default_rng(2).random((2, 4)).astype(np.float32)
    got = static.load_inference_model(prefix, device="cpu")(x)
    want = paddle.static.load_inference_model(prefix + "_jax")(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(NotImplementedError, match="Program"):
        static.save_inference_model(prefix, [torch.zeros(2)], [torch.ones(2)])


def test_predictor_api(tmp_path):
    m, jm = _mlp_pair()
    prefix = os.path.join(str(tmp_path), "pred")
    jit.save(m, prefix, input_spec=[InputSpec([2, 4])])
    paddle.jit.save(jm, prefix + "_jax", input_spec=[JaxInputSpec([2, 4])])
    x = np.random.default_rng(3).random((2, 4)).astype(np.float32)
    outs = []
    for mod, path in ((inference, prefix), (jax_inference, prefix + "_jax")):
        cfg = mod.Config(path + ".pdmodel")
        if mod is inference:
            cfg.disable_gpu()
        predictor = mod.create_predictor(cfg)
        assert predictor.get_input_names() == ["input_0"]
        h = predictor.get_input_handle("input_0")
        h.copy_from_cpu(x)
        assert h.shape() == [2, 4]
        assert predictor.run() is None
        assert predictor.get_output_names() == ["output_0"]
        out = predictor.get_output_handle("output_0").copy_to_cpu()
        np.testing.assert_array_equal(predictor.run([x])[0], out)
        outs.append(out)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)


# ------------------------------------------------------------------- GPT


@pytest.fixture(scope="module")
def saved_gpt(tmp_path_factory):
    """gpt_tiny saved once with InputSpec([None, None], "int64"), and the
    JAX model on the same weights."""
    m, jm = _gpt_pair()
    prefix = str(tmp_path_factory.mktemp("gpt") / "gpt")
    m.train()
    jit.save(m, prefix, input_spec=[InputSpec([None, None], "int64")])
    assert m.training  # export ran in eval mode, training mode restored
    m.eval()
    return m, jm, prefix


def test_gpt_dynamic_batch_and_sequence_match_jax_export(saved_gpt,
                                                         tmp_path):
    """One program at two shapes, each equal to the JAX package's program
    exported at that shape; the sequence stays symbolic (bounded by the
    position table), the weights stay out of the archive."""
    m, jm, prefix = saved_gpt
    layer = jit.load(prefix, device="cpu")
    program = layer._program
    ranges = list(program.range_constraints.values())
    assert len(ranges) == 2
    assert sum(r.lower == 2 and r.upper == 256 for r in ranges) == 1
    assert os.path.getsize(prefix + ".pdmodel") < \
        os.path.getsize(prefix + ".pdparams") / 4
    assert not program.state_dict
    for i, shape in enumerate(SHAPES):
        ids = _ids(shape, seed=i)
        jprefix = os.path.join(str(tmp_path), f"jax_{i}")
        paddle.jit.save(jm, jprefix,
                        input_spec=[JaxInputSpec(list(shape), "int32")])
        want = paddle.jit.load(jprefix)(
            paddle.to_tensor(ids.astype(np.int32))).numpy()
        got = layer(torch.from_numpy(ids))
        assert got.shape == (*shape, TINY["vocab_size"])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), m(torch.from_numpy(ids))
                                   .detach().numpy(), atol=1e-5)
    with pytest.raises(Exception, match="256"):
        layer(torch.zeros(1, 300, dtype=torch.long))


def test_predictor_on_gpt(saved_gpt):
    m, jm, prefix = saved_gpt
    cfg = inference.Config(prefix + ".pdmodel")
    cfg.disable_gpu()
    predictor = inference.create_predictor(cfg)
    for i, shape in enumerate(SHAPES):
        ids = _ids(shape, seed=10 + i)
        got = predictor.run([ids])[0]
        want = jm(paddle.to_tensor(ids.astype(np.int32))).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_scanned_config_exports_equal_to_jax_scanned_program(tmp_path):
    """``use_scan_layers`` (the JAX package scans the blocks; the port runs
    them unrolled) does not change what the saved program computes: the
    port's program equals the JAX package's scanned program at atol
    1e-5 (``test_inference_export.py::test_scanned_model_exports_and_
    roundtrips``)."""
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
               max_position_embeddings=64, use_scan_layers=True)
    m, jm = _gpt_pair(cfg, seed=3)
    ids = _ids((2, 16), seed=40, vocab=256)
    jit.save(m, str(tmp_path / "port"),
             input_spec=[InputSpec([2, 16], "int64")])
    paddle.jit.save(jm, str(tmp_path / "jax"),
                    input_spec=[JaxInputSpec([2, 16], "int32")])
    got = jit.load(str(tmp_path / "port"), device="cpu")(ids)
    want = paddle.jit.load(str(tmp_path / "jax"))(
        paddle.to_tensor(ids.astype(np.int32))).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


class _Two(torch.nn.Module):
    def forward(self, a, b):
        return (a * 2.0).sum() + (b + 1.0).sum()


class _JaxTwo(jnn.Layer):
    def forward(self, a, b):
        return (a * 2.0).sum() + (b + 1.0).sum()


@pytest.mark.parametrize("named", [False, True])
def test_shared_and_named_symbols_match_jax(tmp_path, named):
    """Unnamed specs share one symbol per axis: the saved program refuses
    two batch sizes at once, as the JAX package's does; named specs have
    their own symbols and take them."""
    specs = [dict(name="a" if named else None), dict(name="b" if named
                                                    else None)]
    prefix = str(tmp_path / "two")
    jit.save(_Two(), prefix, input_spec=[
        InputSpec([None, 3], "float32", **s) for s in specs])
    paddle.jit.save(_JaxTwo(), prefix + "_jax", input_spec=[
        JaxInputSpec([None, 3], "float32", **s) for s in specs])
    layer = jit.load(prefix, device="cpu")
    jlayer = paddle.jit.load(prefix + "_jax")
    a, b = np.ones((2, 3), np.float32), np.ones((3, 3), np.float32)
    same = np.ones((2, 3), np.float32)
    for x, y in ((a, same),) + (((a, b),) if named else ()):
        np.testing.assert_allclose(layer(x, y).numpy(),
                                   jlayer(x, y).numpy(), atol=1e-5)
    if not named:
        with pytest.raises(Exception):
            layer(a, b)
        with pytest.raises(Exception):
            jlayer(a, b)


def test_forced_flash_route_exports_the_registered_op(tmp_path, monkeypatch):
    """The route forced to flash on the CPU (head_dim 64): the program
    holds ``paddle_tpu_torch::flash_forward``, run through its plain
    version once per layer, and equals the JAX model forced onto its
    Pallas kernels in interpret mode; at the lengths 200 and 5 (outside
    ``_shapes_ok``) the program still takes the op, where the JAX model
    takes its reference."""
    cfg = dict(TINY, num_heads=2)  # head_dim 64: the flash gate takes it
    monkeypatch.setattr(attention, "_use_flash",
                        lambda q, sk: attention._effective_min_seqlen(sk) == 0)
    monkeypatch.setattr(jax_attention, "_use_pallas", lambda sk: True)
    old = flags.get_flags(["FLAGS_flash_attention_min_seqlen"])
    m, jm = _gpt_pair(cfg, seed=1)
    prefix = str(tmp_path / "flash")
    try:
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
        jit.save(m, prefix, input_spec=[InputSpec([None, None], "int64")])
    finally:
        flags.set_flags(old)
    layer = jit.load(prefix, device="cpu")
    targets = [str(n.target) for n in layer._program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paddle_tpu_torch.flash_forward.default") == 2
    calls = []
    ref = fa.flash_forward_ref

    def spy(*a):
        calls.append(a[0].shape)
        return ref(*a)

    monkeypatch.setattr(fa, "flash_forward_ref", spy)
    for i, shape in enumerate(((2, 128), (3, 64), (3, 200), (2, 5))):
        ids = _ids(shape, seed=20 + i)
        got = layer(torch.from_numpy(ids))
        want = jm(paddle.to_tensor(ids.astype(np.int32))).numpy()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert len(calls) == 8 and fa.launches["flash_forward"] == 0


def test_threshold_inside_the_exported_range_is_refused(tmp_path,
                                                        monkeypatch):
    """Under the auto route's rule (the CPU has no flash route: the gate
    is forced to read the flag as a CUDA tensor would), a threshold inside
    the sequence's range [2, 256] fails ``jit.save``; one above it takes
    the plain route."""
    monkeypatch.setattr(attention, "_use_flash", lambda q, sk: (
        attention._at_least(sk, attention._effective_min_seqlen(sk))))
    m, _ = _gpt_pair()
    old = flags.get_flags(["FLAGS_flash_attention_min_seqlen"])
    try:
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": 100})
        with pytest.raises(ValueError, match=r"range \[2, 256\]"):
            jit.save(m, str(tmp_path / "straddle"),
                     input_spec=[InputSpec([None, None], "int64")])
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": 512})
        jit.save(m, str(tmp_path / "below"),
                 input_spec=[InputSpec([None, None], "int64")])
    finally:
        flags.set_flags(old)
    layer = jit.load(str(tmp_path / "below"), device="cpu")
    assert not any("flash_forward" in str(n.target)
                   for n in layer._program.graph.nodes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pdparams_load_across_packages(tmp_path, dtype):
    """A ``.pdparams`` of either package loads in the other's model: the
    same names and the same bits, bfloat16 included."""
    m, jm = _gpt_pair(seed=2)
    if dtype == "bfloat16":
        m.to(torch.bfloat16)
        jm.to(dtype="bfloat16")
    jit.save(m, str(tmp_path / "port"))
    paddle.jit.save(jm, str(tmp_path / "jax"))
    with open(tmp_path / "port.pdparams", "rb") as f:
        theirs = pickle.load(f)  # as the JAX package reads it
    jm2 = JaxGPT(JaxConfig(**TINY))
    jm2.to(dtype=dtype)
    jm2.set_state_dict(paddle.load(str(tmp_path / "port.pdparams")))
    port_state = jit.load(str(tmp_path / "jax"))  # no .pdmodel: the dict
    m2 = gpt.GPTForCausalLM(gpt.GPTConfig(**TINY), device="cpu")
    m2.to(getattr(torch, dtype))
    m2.load_state_dict({k: torch.as_tensor(v) for k, v in
                        port_state.items()})
    for k, v in m.state_dict().items():
        want = v.float().numpy()
        assert str(theirs[k].dtype) == dtype
        np.testing.assert_array_equal(theirs[k].astype(np.float32), want)
        np.testing.assert_array_equal(
            np.asarray(jm2.state_dict()[k]._data).astype(np.float32), want)
        np.testing.assert_array_equal(m2.state_dict()[k].float().numpy(),
                                      want)


def test_jax_pdmodel_and_native_are_refused(tmp_path):
    m, jm = _mlp_pair()
    paddle.jit.save(jm, str(tmp_path / "jax"),
                    input_spec=[JaxInputSpec([2, 4])])
    with pytest.raises(ValueError, match="StableHLO"):
        jit.load(str(tmp_path / "jax"), device="cpu")
    with pytest.raises(NotImplementedError, match="native"):
        jit.save(m, str(tmp_path / "n"), input_spec=[InputSpec([2, 4])],
                 native=True)


def test_load_and_run_without_the_model_code(saved_gpt):
    """A fresh process loads the program and runs it: it imports neither
    ``paddle_tpu_torch.models`` nor JAX."""
    m, _, prefix = saved_gpt
    ids = _ids((2, 9), seed=30)
    want = m(torch.from_numpy(ids)).detach().numpy()
    np.save(prefix + "_ids.npy", ids)
    script = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from paddle_tpu_torch import jit\n"
        f"layer = jit.load({prefix!r}, device='cpu')\n"
        f"out = layer(np.load({prefix + '_ids.npy'!r}))\n"
        f"np.save({prefix + '_out.npy'!r}, out.numpy())\n"
        "bad = sorted(n for n in sys.modules if n.startswith("
        "('paddle_tpu_torch.models', 'jax', 'paddle_tpu.')) or n == "
        "'paddle_tpu')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   cwd=ROOT, timeout=300)
    np.testing.assert_allclose(np.load(prefix + "_out.npy"), want,
                               atol=1e-5)

