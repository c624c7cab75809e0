"""Training path of the PyTorch port against the JAX package.

A GPT with head_dim 64 (vocab 1024, hidden 128, 2 layers, 2 heads, seq 128,
batch 2), so that the flash gate accepts its attention, runs on the same
numpy-seeded weights in both packages (``seeded_state`` carried in under
the JAX ``functional_state()`` names).

Tolerances. Losses and gradients compare elementwise: f32 at rtol 1e-5
(the same f32 math summed in another order), AMP bf16 at rtol 5e-4.
Trained parameters compare by their updates, normwise per parameter:
``|dp_port - dp_jax| <= rel * |dp_jax|`` with ``dp = final - initial``.
Adam's step is about ``lr * sign(g)`` whatever the gradient's size, so
the elements whose gradient is near 0 take lr-sized steps in directions
set by rounding noise; an elementwise bound would have to allow a whole
step. rel is 1e-4 in f32 and 0.25 under bf16 AMP, where the two libraries'
bf16 gradients differ in sign on many such elements."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu.core import rng as jrng
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn.functional import attention as jax_attention
from paddle_tpu.nn.functional import cross_entropy as jax_cross_entropy
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp
from paddle_tpu_torch.core import compile_cache, rng
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.nn.functional import attention, cross_entropy
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW, lr

torch.set_num_threads(1)

CFG = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=256)
BATCH, SEQ = 2, 128


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.GPTConfig(**CFG),
                                               device="cpu"), seed=0)


def _port(arrays):
    m = gpt.GPTForCausalLM(gpt.GPTConfig(**CFG), device="cpu")
    gpt.load_functional_state(m, arrays)
    m.train()
    return m


def _jax(arrays):
    m = JaxGPT(JaxConfig(**CFG))
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    m.train()
    return m


def _batch(seed, batch=BATCH):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                               (batch, SEQ + 1))
    return ids[:, :-1], ids[:, 1:]


def _t(a):
    return torch.as_tensor(a, dtype=torch.long)


def _j(a):
    return Tensor(np.asarray(a, np.int32))


def _jax_params(jm):
    return {n: np.asarray(t._data.astype(jnp.float32))
            for n, t in jm.functional_state()[0].items()}


def _port_params(m):
    """A copy of every parameter, as f32 numpy arrays."""
    return {n: p.detach().float().numpy().copy()
            for n, p in m.named_parameters()}


def _jax_slots(jm, jopt):
    out = {"step": np.asarray(jopt._step_count)}
    for n, t in jm.functional_state()[0].items():
        for k, v in jopt._accumulators.get(id(t), {}).items():
            out[f"{n}.{k}"] = np.asarray(v.astype(jnp.float32))
    return out


def _assert_params(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=atol, rtol=rtol,
                                   err_msg=n)


def _assert_updates(got, want, init, rel):
    """Per array: ``|(got - init) - (want - init)| <= rel * |want -
    init|`` in the 2-norm (``init`` 0 compares the arrays themselves)."""
    assert set(got) == set(want)
    for n in want:
        base = init.get(n, 0.0) if isinstance(init, dict) else init
        d_want = want[n] - base
        err = np.linalg.norm((got[n] - base) - d_want)
        assert err <= rel * np.linalg.norm(d_want), (
            n, err, np.linalg.norm(d_want))


def _adamw_pair(m, jm, sched_steps=None, **kw):
    """Port and JAX AdamW with the same hyperparameters (lr 3e-3, decay
    0.01, epsilon 1e-6, global-norm clip 1.0; cosine over ``sched_steps``
    when given). An epsilon above the f32 rounding noise of the smallest
    gradients keeps Adam's ``g / sqrt(v)`` from amplifying that noise into
    lr-sized parameter differences, so parameters compare at 2e-6."""
    def lr_of(mod):
        return (mod.CosineAnnealingDecay(3e-3, T_max=sched_steps)
                if sched_steps else 3e-3)
    kw.setdefault("epsilon", 1e-6)
    opt = AdamW(learning_rate=lr_of(lr), parameters=m.named_parameters(),
                weight_decay=0.01, grad_clip=clip.ClipGradByGlobalNorm(1.0),
                **kw)
    jopt = JaxAdamW(learning_rate=lr_of(jlr), parameters=jm.parameters(),
                    weight_decay=0.01,
                    grad_clip=jclip.ClipGradByGlobalNorm(1.0), **kw)
    return opt, jopt


# ------------------------------------------------------------ loss, grads


def test_loss_matches_jax(arrays):
    m, jm = _port(arrays), _jax(arrays)
    x, y = _batch(1)
    loss = m(_t(x), _t(y)).detach()
    want = float(jm(_j(x), _j(y)))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    # without labels: the logits, as before
    logits = m(_t(x))
    assert tuple(logits.shape) == (BATCH, SEQ, CFG["vocab_size"])


def test_grads_match_jax_eager_backward(arrays):
    """Every parameter's gradient against the JAX eager
    ``loss.backward()``: atol 1e-6 + rtol 1e-4 (f32 gradients of O(1e-2)
    summed over 256 tokens in another order)."""
    m, jm = _port(arrays), _jax(arrays)
    x, y = _batch(2)
    m(_t(x), _t(y)).backward()
    jm(_j(x), _j(y)).backward()
    jgrads = {n: np.asarray(t.grad.numpy())
              for n, t in jm.functional_state()[0].items()}
    got = {n: p.grad.numpy() for n, p in m.named_parameters()}
    _assert_params(got, jgrads, atol=1e-6, rtol=1e-4)


def test_flash_route_matches_jax_pallas(arrays, monkeypatch):
    """Both packages forced onto their flash route (the port's plain
    kernels through the autograd.Function; the JAX Pallas kernels in the
    interpreter): loss and gradients agree at f32, and the port ran its
    three kernels' plain versions once per layer each."""
    monkeypatch.setattr(attention, "_use_flash", lambda q, sk: True)
    monkeypatch.setattr(jax_attention, "_use_pallas", lambda sk: True)
    calls = {}
    for name in ("flash_forward_ref", "flash_backward_dkv_ref",
                 "flash_backward_dq_ref"):
        def spy(*a, _f=getattr(fa, name), _n=name):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a)
        monkeypatch.setattr(fa, name, spy)
    m, jm = _port(arrays), _jax(arrays)
    x, y = _batch(3)
    loss = m(_t(x), _t(y))
    jloss = jm(_j(x), _j(y))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    loss.backward()
    jloss.backward()
    assert calls == {"flash_forward_ref": 2, "flash_backward_dkv_ref": 2,
                     "flash_backward_dq_ref": 2}
    jgrads = {n: np.asarray(t.grad.numpy())
              for n, t in jm.functional_state()[0].items()}
    _assert_params({n: p.grad.numpy() for n, p in m.named_parameters()},
                   jgrads, atol=1e-6, rtol=1e-4)


# --------------------------------------------------------------- training


def _run_both(arrays, steps=3, accumulate=1, amp_level=None, decorate=False,
              sched=True, batch=BATCH, **opt_kw):
    m, jm = _port(arrays), _jax(arrays)
    opt, jopt = _adamw_pair(m, jm, sched_steps=steps if sched else None,
                            **opt_kw)
    if decorate:
        amp.decorate(m, opt, level="O2")
        jamp.decorate(jm, jopt, level="O2")

    def fn(x, y):
        if amp_level is None:
            return m(x, y)
        with amp.auto_cast(level=amp_level):
            return m(x, y)

    def jfn(x, y):
        if amp_level is None:
            return jm(x, y)
        with jamp.auto_cast(level=amp_level):
            return jm(x, y)

    step = TrainStep(fn, opt, accumulate_steps=accumulate)
    jstep = JaxTrainStep(jfn, jopt, layers=jm, accumulate_steps=accumulate)
    losses, jlosses = [], []
    for i in range(steps):
        x, y = _batch(10 + i, batch)
        losses.append(float(step(_t(x), _t(y))))
        jlosses.append(float(jstep(_j(x), _j(y))))
        if sched:
            opt._learning_rate.step()
            jopt._learning_rate.step()
    return (m, opt, losses), (jm, jopt, jlosses)


def test_train_steps_match_jax(arrays):
    """3 TrainSteps of AdamW + CosineAnnealingDecay + ClipGradByGlobalNorm:
    losses within rtol 1e-5; parameter updates and moments within 1e-4
    normwise."""
    before = compile_cache.stats()
    (m, opt, losses), (jm, jopt, jlosses) = _run_both(arrays)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_updates(_port_params(m), _jax_params(jm), arrays, 1e-4)
    _assert_updates(opt.optimizer_state_arrays(), _jax_slots(jm, jopt), 0.0,
                    1e-4)
    after = compile_cache.stats()
    assert after["train_step.steps"] - before.get("train_step.steps", 0) == 3
    assert after["train_step.builds"] - before.get("train_step.builds", 0) \
        == 1


def test_accumulate_steps_matches_jax(arrays):
    """accumulate_steps=2 on batch 4: two microbatches of 2, f32 gradient
    accumulation, averaged (loss = microbatch mean)."""
    (m, opt, losses), (jm, jopt, jlosses) = _run_both(
        arrays, steps=2, accumulate=2, batch=4)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_updates(_port_params(m), _jax_params(jm), arrays, 1e-4)
    step = TrainStep(lambda x, y: m(x, y), opt, accumulate_steps=2)
    x, y = _batch(0, batch=3)
    with pytest.raises(ValueError, match="divisible"):
        step(_t(x), _t(y))


def test_amp_o1_matches_jax(arrays):
    """O1: f32 parameters, bf16 matmuls and attention, f32 LayerNorm and
    loss. Losses within rtol 5e-4 (bf16 products rounded at the same op
    boundaries by two libraries); updates within 0.25 normwise."""
    (m, opt, losses), (jm, jopt, jlosses) = _run_both(arrays,
                                                      amp_level="O1")
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4)
    _assert_updates(_port_params(m), _jax_params(jm), arrays, 0.25)
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_amp_o2_decorate_matches_jax(arrays):
    """O2: ``decorate`` casts the parameters to bf16 and keeps f32 master
    weights in the optimizer. Losses within rtol 5e-4; the master weights'
    updates within 0.25 normwise; each bf16 parameter is its master's
    cast."""
    (m, opt, losses), (jm, jopt, jlosses) = _run_both(
        arrays, amp_level="O2", decorate=True)
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4)
    slots, jslots = opt.optimizer_state_arrays(), _jax_slots(jm, jopt)
    masters = {k[:-len(".master_weight")]: v for k, v in slots.items()
               if k.endswith(".master_weight")}
    assert set(masters) == set(arrays)
    _assert_updates(masters, {n: jslots[n + ".master_weight"]
                              for n in masters}, arrays, 0.25)
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            torch.from_numpy(masters[n]).to(torch.bfloat16).float().numpy())


def test_moment_dtype_bfloat16_matches_jax(arrays):
    (m, opt, losses), (jm, jopt, jlosses) = _run_both(
        arrays, steps=2, moment_dtype="bfloat16")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_updates(_port_params(m), _jax_params(jm), arrays, 1e-4)
    state = opt._accumulators[id(m.gpt.wte.weight)]
    assert state["moment1"].dtype == torch.bfloat16
    # moments rounded to bf16 by both: equal up to a bf16 rounding
    _assert_updates(opt.optimizer_state_arrays(), _jax_slots(jm, jopt), 0.0,
                    8e-3)


def test_eager_backward_step_clear_grad_matches_jax(arrays):
    """The eager path, ``loss.backward(); opt.step(); opt.clear_grad()``,
    against the JAX package's eager path."""
    m, jm = _port(arrays), _jax(arrays)
    opt, jopt = _adamw_pair(m, jm)
    for i in range(2):
        x, y = _batch(20 + i)
        loss = m(_t(x), _t(y))
        jloss = jm(_j(x), _j(y))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        loss.backward()
        jloss.backward()
        opt.step()
        jopt.step()
        opt.clear_grad()
        jopt.clear_grad()
        assert all(p.grad is None for p in m.parameters())
    assert opt._step_count == jopt._step_count == 2
    _assert_updates(_port_params(m), _jax_params(jm), arrays, 1e-4)


def test_sentinel_skips_nonfinite_step(arrays):
    """A NaN loss (and so NaN gradients) leaves parameters, moments and the
    step count bit-identical and bumps sentinel.skipped; the next finite
    step updates as usual."""
    m = _port(arrays)
    opt = AdamW(learning_rate=3e-3, parameters=m.named_parameters(),
                grad_clip=clip.ClipGradByGlobalNorm(1.0))
    step = TrainStep(lambda x, y, s: m(x, y) * s, opt)
    x, y = _batch(4)
    one, nan = torch.tensor(1.0), torch.tensor(float("nan"))
    step(_t(x), _t(y), one)
    params, slots = _port_params(m), opt.optimizer_state_arrays()
    skipped = compile_cache.stats().get("sentinel.skipped", 0)
    loss = step(_t(x), _t(y), nan)
    assert not math.isfinite(float(loss))
    assert compile_cache.stats()["sentinel.skipped"] == skipped + 1
    for n, a in _port_params(m).items():
        np.testing.assert_array_equal(a, params[n], err_msg=n)
    for k, a in opt.optimizer_state_arrays().items():
        np.testing.assert_array_equal(a, slots[k], err_msg=k)
    assert opt._step_count == 1
    assert math.isfinite(float(step(_t(x), _t(y), one)))
    assert opt._step_count == 2
    assert not np.array_equal(_port_params(m)["gpt.wte.weight"],
                              params["gpt.wte.weight"])


def test_optimizer_state_from_jax_resumes(arrays):
    """JAX trains 2 steps; its parameters and AdamW slots (``moment1``,
    ``moment2`` under the functional_state names) load into the port, and
    the next step agrees."""
    m0, jm = _port(arrays), _jax(arrays)
    _, jopt = _adamw_pair(m0, jm)
    jstep = JaxTrainStep(lambda x, y: jm(x, y), jopt, layers=jm)
    for i in range(2):
        x, y = _batch(30 + i)
        jstep(_j(x), _j(y))
    jslots = _jax_slots(jm, jopt)
    params = _jax_params(jm)
    m = _port(params)
    opt, _ = _adamw_pair(m, _jax(arrays))
    opt.load_optimizer_state(jslots)
    assert opt._step_count == 2
    assert set(opt.optimizer_state_arrays()) == set(jslots)
    step = TrainStep(lambda x, y: m(x, y), opt)
    x, y = _batch(32)
    loss, jloss = float(step(_t(x), _t(y))), float(jstep(_j(x), _j(y)))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_updates(_port_params(m), _jax_params(jm), params, 1e-4)
    bad = dict(jslots)
    bad.pop("gpt.ln_f.bias.moment2")
    with pytest.raises(KeyError, match="ln_f.bias"):
        opt.load_optimizer_state(bad)


def test_apply_decay_param_fun_exempts_parameters(arrays):
    """Parameters the function rejects take no decay: with zero gradients
    their Adam step is 0, so they stay put while decayed ones shrink."""
    m = _port(arrays)
    opt = AdamW(learning_rate=0.1, parameters=m.named_parameters(),
                weight_decay=0.5,
                apply_decay_param_fun=lambda n: not n.endswith("bias"))
    before = _port_params(m)
    for p in m.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    after = _port_params(m)
    np.testing.assert_array_equal(after["gpt.ln_f.bias"],
                                  before["gpt.ln_f.bias"])
    np.testing.assert_allclose(after["gpt.wpe.weight"],
                               before["gpt.wpe.weight"] * (1 - 0.1 * 0.5),
                               rtol=1e-6)


# ------------------------------------------------------------ components


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((12, 50), dtype=np.float32) * 3
    labels = rng.integers(0, 50, 12)
    labels[[2, 7]] = -100
    want = jax_cross_entropy(Tensor(logits), Tensor(labels.astype(np.int32)),
                             reduction=reduction)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-6)
    # label smoothing, ported: the JAX package's smoothed targets
    want = jax_cross_entropy(Tensor(logits), Tensor(labels.astype(np.int32)),
                             reduction=reduction, label_smoothing=0.1)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        reduction=reduction, label_smoothing=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,args", [("ClipGradByValue", (0.05,)),
                                       ("ClipGradByNorm", (0.5,)),
                                       ("ClipGradByGlobalNorm", (1.0,))])
def test_clips_match_jax(name, args):
    rng = np.random.default_rng(6)
    grads = [rng.standard_normal(s, dtype=np.float32) * 0.3
             for s in ((7, 5), (11,), (3, 4, 2))]
    want = getattr(jclip, name)(*args)._clip_arrays(
        [jnp.asarray(g) for g in grads])
    got = getattr(clip, name)(*args)._clip_arrays(
        [torch.from_numpy(g) for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_schedulers_match_jax():
    port = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=10), 4,
                           0.0, 1e-3)
    ref = jlr.LinearWarmup(jlr.CosineAnnealingDecay(1e-3, T_max=10), 4, 0.0,
                           1e-3)
    got, want = [], []
    for _ in range(16):
        got.append(port())
        want.append(ref())
        port.step()
        ref.step()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_unported_options_raise(arrays):
    """The options this test once held unported (recompute, scan layers,
    the chunked loss, dropout while training) now run: each setting's loss
    equals the JAX package's on the same weights (rtol 1e-5), dropout from
    the same seed; dropout is still the identity in eval mode."""
    x, y = _batch(7)
    for kw in (dict(use_recompute=True), dict(use_scan_layers=True),
               dict(loss_chunk_size=64), dict(dropout=0.1)):
        m = gpt.GPTForCausalLM(gpt.GPTConfig(**CFG, **kw), device="cpu")
        gpt.load_functional_state(m, arrays)
        jm = JaxGPT(JaxConfig(**CFG, **kw))
        for name, t in jm.functional_state()[0].items():
            t._data = jnp.asarray(arrays[name])
        m.train()
        jm.train()
        rng.seed(1)
        jrng.seed(1)
        got = float(m(_t(x), _t(y)).detach())
        want = float(jm(_j(x), _j(y)))
        assert abs(got - want) <= 1e-5 * abs(want), kw
    m.eval()
    jm.eval()
    want = float(jm(_j(x), _j(y)))
    assert abs(float(m(_t(x), _t(y)).detach()) - want) <= 1e-5 * abs(want)
