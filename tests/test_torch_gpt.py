"""GPT of the PyTorch port against the JAX package, and the port's package
boundary.

Both models run on the same numpy-seeded weights, carried into the port by
``load_functional_state`` under the JAX ``functional_state()`` names.
Logits are compared at atol/rtol 1e-4 (f32 rounding accumulates through two
layers of LayerNorm, GELU and the tied head); greedy tokens must match
exactly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.functional.attention import _sdpa_reference
from paddle_tpu_torch.models import gpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    arrays = gpt.seeded_state(model, seed=0)
    gpt.load_functional_state(model, arrays)
    return model, arrays


def _jax_model(arrays):
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    params, _ = m.functional_state()
    assert set(params) == set(arrays)
    for name, t in params.items():
        t._data = jnp.asarray(arrays[name])
    return m


def test_logits_match_graft_entry(weights):
    """The port's forward against ``__graft_entry__.entry()``'s JAX forward
    on the same weights and ids."""
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import entry

    model, arrays = weights
    fn, (param_arrays, ids) = entry()
    names = list(JaxGPT(jax_gpt_tiny()).functional_state()[0])
    assert len(names) == len(param_arrays)
    ids = np.random.default_rng(1).integers(0, 1024, ids.shape)
    ref = np.asarray(fn(tuple(jnp.asarray(arrays[n]) for n in names),
                        jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        out = model(torch.as_tensor(ids)).numpy()
    assert out.shape == ref.shape == (2, 64, 1024)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_greedy_generate_matches_jax(weights):
    model, arrays = weights
    jm = _jax_model(arrays)
    ids = np.random.default_rng(2).integers(0, 1024, (2, 9))
    free = model.generate(ids, max_new_tokens=12).numpy()
    ref = np.asarray(jm.generate(ids.astype(np.int32),
                                 max_new_tokens=12)._data)
    np.testing.assert_array_equal(free, ref)
    # a stop token both rows reach at different steps: finished rows are
    # filled with it and decoding ends early
    stop = int(free[0, 9 + 3])
    out = model.generate(ids, max_new_tokens=12, stop_token_id=stop).numpy()
    ref = np.asarray(jm.generate(ids.astype(np.int32), max_new_tokens=12,
                                 stop_token_id=stop)._data)
    np.testing.assert_array_equal(out, ref)
    assert (out[0, 9 + 3:] == stop).all()


def test_causal_attention_matches_sdpa_reference():
    """The non-cached attention route, including sq < sk (causal offset)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    ref = _sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=0.25, causal=True)
    out = gpt.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_load_functional_state_checks_names_and_shapes(weights):
    model, arrays = weights
    missing = dict(arrays)
    missing.pop("gpt.layers.1.attn.qkv.weight")
    with pytest.raises(KeyError, match="missing"):
        gpt.load_functional_state(model, missing)
    with pytest.raises(KeyError, match="unknown"):
        gpt.load_functional_state(model, {**arrays, "gpt.extra": np.zeros(1)})
    wrong = dict(arrays)
    wrong["gpt.layers.0.attn.qkv.weight"] = np.zeros((384, 128), np.float32)
    with pytest.raises(ValueError, match="qkv"):
        gpt.load_functional_state(model, wrong)
    # the layout is paddle's [in, out]: qkv is [h, 3h]
    assert tuple(model.gpt.layers[0].attn.qkv.weight.shape) == (128, 384)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt.GPTForCausalLM(gpt.gpt_tiny())


# ----------------------------------------------------- package boundary


def _port_sources():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_paddle_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module and _forbidden(node.module)):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import paddle_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
