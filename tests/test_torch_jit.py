"""``jit.to_static`` of the port (``paddle_tpu_torch/jit/static_function.py``)
against the JAX package's, on the CPU.

The same call sequences go through both packages' ``to_static`` and their
counters (``tests/test_compile_cache.py:102-215``): the warm counter, two
batches in one bucket, the global flag and the opt-out, the live path never
bucketed with gradients equal to eager; ``enable_to_static(False)``
(``tests/test_ecosystem.py:287``); a GPT loss on the same seeded weights
(f32, atol 1e-5, the bar of ``tests/test_inference_export.py``); parameter
discovery through closures, globals and nested functions. Then the port's
own capture path through ``test_torch_graphs.py``'s fake capture backend
(a warm-up, a "capture" that keeps its outputs, replays that rerun the
function with no counter moving): one build per signature, a rebuild after
``load_state_dict(..., assign=True)``, in-place updates (plain
``load_state_dict``, an optimizer step) seen with none, and a function that
draws random keys run eagerly with fresh keys.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import jit as jax_jit
from paddle_tpu import nn as jnn
from paddle_tpu.core import compile_cache as jcc
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.core import compile_cache as cc
from paddle_tpu_torch.core import flags, rng
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import SGD
from test_torch_graphs import _FakeGraphs

torch.set_num_threads(1)

CFG = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
           max_position_embeddings=256)


@pytest.fixture
def restore_flags():
    old = flags.get_flags(["FLAGS_shape_bucketing"])
    old_jax = pt.get_flags(["FLAGS_shape_bucketing"])
    yield
    flags.set_flags(old)
    pt.set_flags(old_jax)
    jit.enable_to_static(True)
    jax_jit.enable_to_static(True)


def _counts(stats):
    return {k: v for k, v in stats.items()
            if k.startswith(("to_static.", "bucket."))}


def _both(body):
    """Run ``body(jit_module, tensor_of, package)`` through each package
    from zeroed counters; returns each one's to_static and bucket counts
    and the body's result."""
    out = {}
    for name, mod, counters, wrap in (
            ("jax", jax_jit, jcc, lambda a: Tensor(jnp.asarray(a))),
            ("torch", jit, cc, torch.from_numpy)):
        counters.reset_stats()
        res = body(mod, wrap, name)
        out[name] = (_counts(counters.stats()), res)
    return out


def _np(x):
    return np.asarray(x._data) if isinstance(x, Tensor) else x.numpy()


def _linear(i, o, seed=0):
    """A port ``Linear`` with seeded weights (the layer starts
    uninitialised)."""
    lin = Linear(i, o)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return lin


# ------------------------------------------------------- counters (JAX's)


def test_warm_counter_matches_jax():
    def body(mod, wrap, _):
        f = mod.to_static(lambda x: x + 1.0)
        x = wrap(np.zeros((2, 4), np.float32))
        return [_np(f(x)), _np(f(x))]

    out = _both(body)
    assert out["torch"][0] == out["jax"][0] == {"to_static.misses": 1,
                                                "to_static.hits": 1}
    for a, b in zip(out["torch"][1], out["jax"][1]):
        np.testing.assert_array_equal(a, b)


def test_two_batches_one_bucket_matches_jax(restore_flags):
    x3 = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    x7 = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)

    def body(mod, wrap, _):
        f = mod.to_static(lambda x: x * 2.0 + 1.0, bucket_batch=True)
        return [_np(f(wrap(x3))), _np(f(wrap(x7)))]

    out = _both(body)
    assert out["torch"][0] == out["jax"][0] == {
        "to_static.misses": 1, "to_static.hits": 1, "bucket.padded": 2}
    for got, want, x in zip(out["torch"][1], out["jax"][1], (x3, x7)):
        assert got.shape == x.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got, x * 2.0 + 1.0, rtol=1e-6)


def test_global_flag_and_opt_out_match_jax(restore_flags):
    flags.set_flags({"FLAGS_shape_bucketing": True})
    pt.set_flags({"FLAGS_shape_bucketing": True})
    seen = {}

    def body(mod, wrap, name):
        f = mod.to_static(lambda x: x - 1.0)  # follows the global flag
        g = mod.to_static(lambda x: x - 1.0, bucket_batch=False)
        f(wrap(np.ones((3, 2), np.float32)))
        f(wrap(np.ones((5, 2), np.float32)))
        seen[name] = dict(_counts((jcc if name == "jax" else cc).stats()))
        g(wrap(np.ones((3, 2), np.float32)))
        g(wrap(np.ones((5, 2), np.float32)))

    out = _both(body)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["to_static.misses"] == 1
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["to_static.misses"] == 3  # g: no bucketing


def test_live_path_never_bucketed_grads_match_jax(restore_flags):
    """A live input takes the taped path: never bucketed, and the
    gradients equal eager's and the JAX package's."""
    w = np.random.default_rng(2).normal(size=(4, 2)).astype(np.float32)
    b = np.random.default_rng(3).normal(size=(2,)).astype(np.float32)
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)

    jlin = jnn.Linear(4, 2)
    jlin.weight._data, jlin.bias._data = jnp.asarray(w), jnp.asarray(b)
    jf = jax_jit.to_static(lambda t: (jlin(t) ** 2).mean(),
                           bucket_batch=True)
    jcc.reset_stats()
    jf(Tensor(jnp.asarray(x), stop_gradient=False)).backward()
    jax_counts = _counts(jcc.stats())

    lin = Linear(4, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    f = jit.to_static(lambda t: (lin(t) ** 2).mean(), bucket_batch=True)
    cc.reset_stats()
    f(torch.from_numpy(x).requires_grad_(True)).backward()
    assert _counts(cc.stats()) == jax_counts == {"to_static.taped_calls": 1}
    g_static = lin.weight.grad.clone()
    lin.weight.grad = None
    (lin(torch.from_numpy(x)) ** 2).mean().backward()
    torch.testing.assert_close(g_static, lin.weight.grad, rtol=0, atol=0)
    np.testing.assert_allclose(g_static.numpy(),
                               np.asarray(jlin.weight.grad._data),
                               rtol=1e-6, atol=1e-7)


def test_enable_to_static_false_matches_jax(restore_flags):
    def body(mod, wrap, _):
        calls = []

        @mod.to_static
        def f(x):
            calls.append(1)
            return x * 2

        x = wrap(np.ones(3, np.float32))
        f(x)
        mod.enable_to_static(False)
        try:
            n = len(calls)
            out = f(x)
            eager_calls = len(calls) - n
        finally:
            mod.enable_to_static(True)
        return eager_calls, _np(out)

    out = _both(body)
    assert out["torch"][1][0] == out["jax"][1][0] == 1
    np.testing.assert_array_equal(out["torch"][1][1], out["jax"][1][1])


# --------------------------------------------------------------- GPT loss


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.GPTConfig(**CFG),
                                               device="cpu"), seed=0)


def _models(arrays):
    m = gpt.GPTForCausalLM(gpt.GPTConfig(**CFG), device="cpu")
    gpt.load_functional_state(m, arrays)
    jm = JaxGPT(JaxConfig(**CFG))
    for name, t in jm.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m, jm


def _ids(seed, shape=(2, 33)):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"], shape)
    return ids[:, :-1], ids[:, 1:]


def test_gpt_loss_matches_jax(arrays):
    """``to_static(lambda a, b: model(a, b))`` on the same seeded weights:
    the loss of a non-taped and of a taped call within atol 1e-5 of the
    JAX package's, and the taped call's gradients within the training
    tests' bar (atol 1e-6 + rtol 1e-4)."""
    m, jm = _models(arrays)
    f = jit.to_static(lambda a, b: m(a, b))
    jf = jax_jit.to_static(lambda a, b: jm(a, b))
    x, y = _ids(1)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    jx, jy = Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y))
    cc.reset_stats()
    with torch.no_grad():
        cold = f(tx, ty)
    with pt.no_grad():
        jcold = jf(jx, jy)
    assert abs(float(cold) - float(jcold)) <= 1e-5
    loss, jloss = f(tx, ty), jf(jx, jy)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert cc.stats()["to_static.taped_calls"] == 1
    loss.backward()
    jloss.backward()
    jgrads = {n: np.asarray(t.grad._data)
              for n, t in jm.functional_state()[0].items()}
    for n, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], atol=1e-6,
                                   rtol=1e-4, err_msg=n)


# ------------------------------------------------------------- discovery

_GLOBAL_LIN = _linear(3, 2)
_SCALE = types.SimpleNamespace(attr=2.0)
attr = _linear(3, 2)  # shares its name with the attribute read below


def _global_fn(x):
    return _GLOBAL_LIN(x) * _SCALE.attr


def test_discovery_through_closures_globals_and_nesting():
    lin = _linear(3, 2, seed=1)
    pair = [_linear(3, 2, seed=2), _linear(2, 2, seed=3)]
    inner = jit.to_static(lambda x: lin(x))
    outer = jit.to_static(lambda x: pair[1](inner(x)) + pair[0](x).sum())
    glob = jit.to_static(_global_fn)

    def ids(sf):
        return {id(t) for t in sf._state()}

    assert ids(inner) == {id(p) for p in lin.parameters()}
    assert ids(glob) == {id(p) for p in _GLOBAL_LIN.parameters()}
    assert ids(outer) == {id(p) for p in (*lin.parameters(),
                                          *pair[0].parameters(),
                                          *pair[1].parameters())}
    # a global that only shares an attribute's name is not state
    assert not ids(glob) & {id(p) for p in attr.parameters()}
    # the discovered parameters make a call live: on the tape, with grads
    # (the outer call and the nested one it makes)
    cc.reset_stats()
    x = torch.ones(4, 3)
    outer(x).sum().backward()
    assert cc.stats()["to_static.taped_calls"] == 2
    assert all(p.grad is not None for m in (lin, *pair)
               for p in m.parameters())


def test_method_and_layer_forms():
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = _linear(3, 2)

        @jit.to_static
        def forward(self, x):
            return self.lin(x)

    a, b = M(), M()
    x = torch.ones(2, 3)
    with torch.no_grad():
        assert torch.equal(a(x), a.lin(x)) and torch.equal(b(x), b.lin(x))
    assert a.forward is a.forward and a.forward is not b.forward
    assert {id(t) for t in a.forward._state()} == {
        id(p) for p in a.lin.parameters()}
    layer = jit.to_static(_linear(3, 2), input_spec=[jit.InputSpec([None, 3])])
    assert isinstance(layer.forward, jit.StaticFunction)
    assert layer.forward.input_spec[0].shape == [None, 3]
    with torch.no_grad():
        assert torch.equal(layer(x), layer.forward._fn(x))


def test_amp_policy_is_part_of_the_signature():
    lin = _linear(4, 4)
    f = jit.to_static(lambda x: lin(x))
    x = torch.ones(2, 4)
    cc.reset_stats()
    with torch.no_grad():
        plain = f(x)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            cast = f(x)
        f(x)
    assert plain.dtype == torch.float32 and cast.dtype == torch.bfloat16
    assert _counts(cc.stats()) == {"to_static.misses": 2,
                                   "to_static.hits": 1}


def test_knobs():
    def g():
        return 1

    assert jit.not_to_static(g) is g and g._paddle_not_to_static
    jit.ignore_module([np])
    jit.set_code_level(100)
    jit.set_verbosity(3)


# ------------------------------------------ the capture path (fake backend)


def _fake(sf):
    sf.backend = _FakeGraphs((fa.launches,))
    return sf


def test_one_build_per_signature_and_replays_equal_eager(arrays):
    m, _ = _models(arrays)
    f = _fake(jit.to_static(lambda a: m(a)))
    cc.reset_stats()
    with torch.no_grad():
        for seed, shape in ((1, (2, 17)), (2, (2, 17)), (3, (3, 9)),
                            (4, (2, 17)), (5, (3, 9))):
            x = torch.as_tensor(_ids(seed, shape)[0])
            assert torch.equal(f(x), m(x))
    assert f.builds == 2 and f.backend.captures == 2
    assert f.backend.warmups == 2
    assert _counts(cc.stats()) == {"to_static.misses": 2,
                                   "to_static.hits": 3,
                                   "to_static.captures": 2}


def test_in_place_updates_seen_replacements_rebuild(arrays):
    """A graph reads the parameters by address: ``load_state_dict`` (a
    copy) and an optimizer step are seen by the next replay with no
    build; ``load_state_dict(..., assign=True)`` replaces the tensors and
    rebuilds once."""
    m, _ = _models(arrays)
    f = _fake(jit.to_static(lambda a: m(a)))
    x = torch.as_tensor(_ids(6)[0])
    with torch.no_grad():
        first = f(x)
        m.load_state_dict({k: v * 1.5 for k, v in m.state_dict().items()})
        moved = f(x)
        assert torch.equal(moved, m(x)) and not torch.equal(moved, first)
    assert f.builds == 1
    opt = SGD(learning_rate=0.1, parameters=m.parameters())
    m(x).float().pow(2).mean().backward()
    opt.step()
    with torch.no_grad():
        assert torch.equal(f(x), m(x))
    assert f.builds == 1
    cc.reset_stats()
    m.load_state_dict({k: v.clone() * 0.5 for k, v in m.state_dict().items()},
                      assign=True)
    with torch.no_grad():
        assert torch.equal(f(x), m(x))
        assert torch.equal(f(x), m(x))
    assert f.builds == 2
    assert _counts(cc.stats()) == {"to_static.hits": 2,
                                   "to_static.rebuilds": 1,
                                   "to_static.captures": 1}


def test_random_draws_run_eagerly_with_fresh_keys():
    """A function that draws keys is never captured: each call draws anew
    (a replay would repeat the first call's mask)."""
    def noisy(x):
        return x + rng.uniform(rng.next_key(), x.shape)

    f = _fake(jit.to_static(noisy))
    x = torch.zeros(4)
    rng.seed(3)
    cc.reset_stats()
    a, b, c = f(x), f(x), f(x)
    assert f.builds == 0 and f.backend.captures == 0
    assert not torch.equal(a, b) and not torch.equal(b, c)
    assert _counts(cc.stats()) == {"to_static.misses": 1,
                                   "to_static.hits": 2,
                                   "to_static.rng_eager_calls": 3}
    rng.seed(3)
    want = [x + rng.uniform(rng.next_key(), x.shape) for _ in range(3)]
    for got, w in zip((a, b, c), want):
        assert torch.equal(got, w)


def test_bucketed_capture_slices_and_shares_one_graph():
    lin = _linear(5, 3)
    f = _fake(jit.to_static(lambda x: lin(x), bucket_batch=True))
    with torch.no_grad():
        for b in (3, 5, 7):
            x = torch.randn(b, 5)
            got = f(x)
            assert got.shape == (b, 3)
            torch.testing.assert_close(got, lin(x), rtol=0, atol=1e-6)
    assert f.builds == 1


def test_bucket_helpers_match_jax():
    for n in range(1, 300):
        assert cc.bucket_dim(n) == jcc.bucket_dim(n)
    for shape, axes in (((13, 7), (0,)), ((13, 7), (0, 1)), ((5, 9, 3), (-1,)),
                        ((), (0,))):
        assert cc.bucket_shape(shape, axes) == jcc.bucket_shape(shape, axes)
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    cc.reset_stats()
    jcc.reset_stats()
    for axis in (0, 1):
        got, n = cc.pad_to_bucket(torch.from_numpy(x), axis)
        want, jn = jcc.pad_to_bucket(jnp.asarray(x), axis)
        assert n == jn
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got_np, _ = cc.pad_to_bucket(x, axis)
        np.testing.assert_array_equal(got_np, np.asarray(want))
    same = torch.zeros(8, 2)
    assert cc.pad_to_bucket(same)[0] is same
    assert cc.stats()["bucket.padded"] == 4
    assert jcc.stats()["bucket.padded"] == 2
