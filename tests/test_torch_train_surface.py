"""The port's training surface against the JAX package: dropout through
``TrainStep``, activation recompute with live dropout, the chunked loss,
the untied head, ``use_scan_layers``, ``cross_entropy``'s arguments,
``GradScaler``, the regularizers and the clip's arguments.

The GPT is ``test_torch_train``'s (vocab 1024, hidden 128, 2 layers, 2
heads of 64, seq 64 here, batch 2) on the same numpy-seeded weights in both
packages, with dropout 0.1 where dropout is live. Both packages are seeded
after the models are built (building a JAX model draws keys).

Tolerances: f32 losses at rtol 1e-5 (the same math summed in another
order), gradients at 1e-6 abs + 1e-4 rel (as ``test_torch_train``), bf16
AMP losses at rtol 5e-4. Recompute on and off in the port run the same ops
on the same keys: equal bit for bit."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import regularizer as jreg
from paddle_tpu.core import rng as jrng
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import Linear as JaxLinear
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn.functional import cross_entropy as jax_cross_entropy
from paddle_tpu.nn.functional import \
    softmax_with_cross_entropy as jax_softmax_ce
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import amp, regularizer
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed.fleet.recompute import (
    RecomputeLayer, recompute, recompute_sequential)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.nn.functional import (cross_entropy,
                                            softmax_with_cross_entropy)
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.ops import dropout as do
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.serving import ServingAPI, ServingConfig

torch.set_num_threads(1)

CFG = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=256)
BATCH, SEQ = 2, 64
POLICIES = ["full", "core_attn", "full_attn"]


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.GPTConfig(**CFG),
                                               device="cpu"), seed=0)


def _untied(arrays):
    out = dict(arrays)
    out["lm_head.weight"] = np.random.default_rng(5).standard_normal(
        (CFG["hidden_size"], CFG["vocab_size"])).astype(np.float32) * 0.02
    return out


def _port(arrays, **kw):
    m = gpt.GPTForCausalLM(gpt.GPTConfig(**CFG, **kw), device="cpu")
    gpt.load_functional_state(m, arrays)
    m.train()
    return m


def _jax(arrays, **kw):
    m = JaxGPT(JaxConfig(**CFG, **kw))
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


def _seed_both(s=0):
    rng.seed(s)
    jrng.seed(s)


def _words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _grads(m):
    return {n: p.grad.numpy().copy() for n, p in m.named_parameters()}


def _jgrads(jm):
    return {n: np.asarray(t.grad.numpy())
            for n, t in jm.functional_state()[0].items()}


def _assert_close(got, want, atol=1e-6, rtol=1e-4):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=atol, rtol=rtol,
                                   err_msg=n)


def _adamw(m, jm):
    opt = AdamW(learning_rate=3e-3, parameters=m.named_parameters(),
                weight_decay=0.01, epsilon=1e-6,
                grad_clip=clip.ClipGradByGlobalNorm(1.0))
    jopt = JaxAdamW(learning_rate=3e-3, parameters=jm.parameters(),
                    weight_decay=0.01, epsilon=1e-6,
                    grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    return opt, jopt


def _train_both(arrays, steps=3, accumulate=1, amp_level=None, **kw):
    """``steps`` TrainSteps in both packages from the same weights and
    seed; the losses of each."""
    m, jm = _port(arrays, **kw), _jax(arrays, **kw)
    opt, jopt = _adamw(m, jm)

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
    _seed_both(0)
    losses, jlosses = [], []
    for i in range(steps):
        x, y = _batch(10 + i, BATCH * accumulate)
        losses.append(float(step(_t(x), _t(y))))
        jlosses.append(float(jstep(_j(x), _j(y))))
    return losses, jlosses


# ------------------------------------------------------------ dropout steps


@pytest.mark.parametrize("accumulate", [1, 2])
def test_trainstep_dropout_matches_jax(arrays, accumulate):
    """After seed(0) in both packages, 3 f32 TrainSteps with dropout 0.1
    draw the same masks: losses within rtol 1e-5 (microbatch i under
    fold_in(key, i) with accumulate_steps=2)."""
    losses, jlosses = _train_both(arrays, accumulate=accumulate, dropout=0.1)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_array_equal(rng.get_rng_state().numpy(),
                                  _words(jrng.get_rng_state()))


@pytest.mark.parametrize("policy", POLICIES)
def test_trainstep_recompute_dropout_matches_jax(arrays, policy):
    """Recompute under TrainStep (jax.checkpoint in the JAX package) with
    live dropout: the losses of 2 steps within rtol 1e-5."""
    losses, jlosses = _train_both(arrays, steps=2, dropout=0.1,
                                  use_recompute=True, recompute_policy=policy)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def _eager(m, x, y):
    loss = m(_t(x), _t(y))
    loss.backward()
    return float(loss.detach()), _grads(m)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_replays_dropout_keys(arrays, policy):
    """Eager forward and backward with dropout 0.1: recompute on gives the
    loss and gradients of recompute off bit for bit, and the JAX package's
    eager ones within tolerance; the global key ends where JAX's eager
    path leaves it (the recompute drew nothing)."""
    x, y = _batch(3)
    plain, remat = _port(arrays, dropout=0.1), _port(
        arrays, dropout=0.1, use_recompute=True, recompute_policy=policy)
    jm = _jax(arrays, dropout=0.1, use_recompute=True,
              recompute_policy=policy)
    _seed_both(4)
    want_loss, want = _eager(plain, x, y)
    _seed_both(4)
    got_loss, got = _eager(remat, x, y)
    jloss = jm(_j(x), _j(y))
    jloss.backward()
    assert got_loss == want_loss
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert abs(got_loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_close(got, _jgrads(jm))
    np.testing.assert_array_equal(rng.get_rng_state().numpy(),
                                  _words(jrng.get_rng_state()))


def test_key_tape_records_replayed_keys():
    """A tape that records while another replays receives the replayed
    keys (a checkpoint nested in a recomputed region), and its own replay
    hands them back; no draw moves the global key."""
    rng.seed(3)
    outer, inner = rng.KeyTape(), rng.KeyTape()
    with outer.record():
        drawn = [rng.next_key() for _ in range(3)]
    state = rng.get_rng_state()
    with outer.replay():
        assert torch.equal(rng.next_key(), drawn[0])
        with inner.record():
            got = [rng.next_key(), rng.next_key()]
    with inner.replay():
        again = [rng.next_key(), rng.next_key()]
        with pytest.raises(RuntimeError, match="drew more keys"):
            rng.next_key()
    for a, b, want in zip(got, again, drawn[1:]):
        assert torch.equal(a, want) and torch.equal(b, want)
    assert torch.equal(rng.get_rng_state(), state)


@pytest.mark.parametrize("policy", POLICIES)
def test_nested_recompute_replays_dropout_keys(arrays, policy):
    """Each decoder block a ``RecomputeLayer`` under ``policy``, inside one
    ``recompute`` of the whole model, with dropout 0.1: the loss and
    gradients of no recompute bit for bit, and the JAX package's (its
    eager recompute) within tolerance."""
    x, y = _batch(8)
    plain, nested = _port(arrays, dropout=0.1), _port(arrays, dropout=0.1)
    params = dict(nested.named_parameters())
    layers = nested.gpt.layers
    for i, block in enumerate(layers):
        layers[i] = RecomputeLayer(block, policy=policy)
    jm = _jax(arrays, dropout=0.1)
    _seed_both(9)
    want_loss, want = _eager(plain, x, y)
    _seed_both(9)
    loss = recompute(nested, _t(x), _t(y))
    loss.backward()
    jloss = jm(_j(x), _j(y))
    jloss.backward()
    assert float(loss.detach()) == want_loss
    got = {n: p.grad.numpy() for n, p in params.items()}
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert abs(want_loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_close(got, _jgrads(jm))
    np.testing.assert_array_equal(rng.get_rng_state().numpy(),
                                  _words(jrng.get_rng_state()))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(arrays, **kw):
    m = _port(arrays, dropout=0.1, **kw)
    x, y = _batch(5)
    loss = m(_t(x), _t(y))
    with _CountOps() as c:
        loss.backward()
    return c.counts


def test_recompute_policies_save_what_they_name(arrays):
    """In backward, "full" runs the blocks' matmuls again up to each
    block's last saved tensor (torch's early stop: qkv, proj and up, not
    the MLP's down matmul, whose output nothing saves) and both attention
    products (aten.bmm); "core_attn" the attention products but no weight
    matmul (aten.mm); "full_attn" neither."""
    layers = CFG["num_layers"]
    base = _backward_ops(arrays)
    full = _backward_ops(arrays, use_recompute=True)
    core = _backward_ops(arrays, use_recompute=True,
                         recompute_policy="core_attn")
    fattn = _backward_ops(arrays, use_recompute=True,
                          recompute_policy="full_attn")
    mm = "aten.mm"
    bmm = "aten.bmm"
    assert full[mm] - base[mm] == 3 * layers
    assert full[bmm] - base[bmm] == 2 * layers
    assert core[mm] == base[mm] and core[bmm] - base[bmm] == 2 * layers
    assert fattn[mm] == base[mm] and fattn[bmm] == base[bmm]


def test_recompute_dropout_launch_sites(arrays, monkeypatch):
    """The dropout function runs 1 + 3 per layer in the forward, 2 per
    layer in the recompute (torch stops a block's recompute after its last
    saved tensor, the MLP's down-matmul input, before the last residual
    dropout) and 1 + 3 per layer in backward: the counts phase 10c of
    chip_smoke.py expects of the kernel (``dropout_sites``)."""
    import chip_smoke

    calls = []
    real = do.dropout_apply
    monkeypatch.setattr(do, "dropout_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = _port(arrays, dropout=0.1, use_recompute=True)
    x, y = _batch(6)
    loss = m(_t(x), _t(y))
    layers = CFG["num_layers"]
    assert len(calls) == 1 + 3 * layers
    loss.backward()
    assert len(calls) == chip_smoke.dropout_sites(layers)


def test_recompute_layer_and_sequential():
    torch.manual_seed(0)
    blocks = [torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh())
              for _ in range(4)]
    x = torch.randn(3, 8, requires_grad=True)
    want = x
    for b in blocks:
        want = b(want)
    want.sum().backward()
    gx, gw = x.grad.clone(), blocks[0][0].weight.grad.clone()
    for b in blocks:
        b.zero_grad()
    x.grad = None
    got = recompute_sequential({"segments": 2}, blocks, x)
    got.sum().backward()
    assert torch.equal(got, want)
    assert torch.equal(x.grad, gx) and torch.equal(blocks[0][0].weight.grad,
                                                   gw)
    layer = RecomputeLayer(blocks[0], policy="core_attn")
    assert torch.equal(layer(x), blocks[0](x))
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(blocks[0], x, policy="bogus")
    with torch.no_grad():
        assert torch.equal(recompute(blocks[0], x), blocks[0](x))


def test_recompute_keeps_the_amp_policy(arrays):
    """A recomputed block casts as its forward did, though backward runs
    after the auto_cast block has exited: equal to no recompute."""
    x, y = _batch(7)
    out = {}
    for on in (False, True):
        m = _port(arrays, use_recompute=on)
        with amp.auto_cast(level="O1"):
            loss = m(_t(x), _t(y))
        loss.backward()
        out[on] = (float(loss.detach()), _grads(m))
    assert out[True][0] == out[False][0]
    for n, g in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][n], g, err_msg=n)


# ------------------------------------------------------------- chunked loss


@pytest.mark.parametrize("amp_level", [None, "O1"])
@pytest.mark.parametrize("tied", [True, False])
def test_chunked_loss_matches_jax(arrays, amp_level, tied):
    """loss_chunk_size 48 over 2 x 64 = 128 tokens (two whole chunks and a
    padded one) with some labels -100: equal to the JAX package's chunked
    loss and to the port's unchunked loss, gradients too."""
    w = arrays if tied else _untied(arrays)
    kw = {} if tied else dict(tie_word_embeddings=False)
    x, y = _batch(8)
    y = y.copy()
    y[0, :5] = -100
    chunked, plain = _port(w, loss_chunk_size=48, **kw), _port(w, **kw)
    jm = _jax(w, loss_chunk_size=48, **kw)
    rtol = 1e-5 if amp_level is None else 5e-4

    def run(m, ids, lbl):
        if amp_level is None:
            return m(ids, lbl)
        ctx = (amp.auto_cast(level=amp_level) if isinstance(m, torch.nn.Module)
               else jamp.auto_cast(level=amp_level))
        with ctx:
            return m(ids, lbl)

    got = run(chunked, _t(x), _t(y))
    want = run(plain, _t(x), _t(y))
    jloss = run(jm, _j(x), _j(y))
    g, w, j = float(got.detach()), float(want.detach()), float(jloss)
    assert abs(g - j) <= rtol * abs(j)
    assert abs(g - w) <= rtol * abs(w)
    got.backward()
    want.backward()
    jloss.backward()
    atol, grtol = (1e-6, 1e-4) if amp_level is None else (2e-3, 5e-2)
    _assert_close(_grads(chunked), _grads(plain), atol=atol, rtol=grtol)
    if amp_level is None:
        _assert_close(_grads(chunked), _jgrads(jm))


def test_chunked_loss_all_ignored(arrays):
    """No valid token: the total over max(count, 1) is 0."""
    m = _port(arrays, loss_chunk_size=32)
    x, _ = _batch(9)
    assert float(m(_t(x), _t(np.full_like(x, -100))).detach()) == 0.0


# --------------------------------------------------------------- untied head


def test_untied_head_matches_jax(arrays):
    """tie_word_embeddings=False: an lm_head [hidden, vocab] of its own.
    Logits and the loss match the JAX package's; greedy generate() and the
    CPU ServingAPI give the JAX package's generate() tokens."""
    w = _untied(arrays)
    m, jm = _port(w, tie_word_embeddings=False), _jax(
        w, tie_word_embeddings=False)
    assert tuple(m.lm_head.weight.shape) == (CFG["hidden_size"],
                                             CFG["vocab_size"])
    assert m.lm_head.bias is None
    x, y = _batch(11)
    np.testing.assert_allclose(m(_t(x)).detach().numpy(),
                               np.asarray(jm(_j(x)).numpy()), atol=1e-5,
                               rtol=1e-5)
    got, want = float(m(_t(x), _t(y))), float(jm(_j(x), _j(y)))
    assert abs(got - want) <= 1e-5 * abs(want)
    m.eval()
    jm.eval()
    prompts = np.random.default_rng(12).integers(0, CFG["vocab_size"],
                                                 (2, 7))
    tokens = m.generate(prompts, max_new_tokens=6).numpy()
    jtokens = np.asarray(jm.generate(Tensor(prompts.astype(np.int32)),
                                     max_new_tokens=6).numpy())
    np.testing.assert_array_equal(tokens, jtokens)
    api = ServingAPI(m, ServingConfig(num_slots=2, kv_block_size=16,
                                      max_model_len=64), device="cpu")
    reqs = [api.submit(p, max_new_tokens=6) for p in prompts]
    api.run_until_idle()
    japi = JaxServingAPI(jm, JaxServingConfig(num_slots=2, kv_block_size=16,
                                              max_model_len=64))
    try:
        jreqs = [japi.submit(p.astype(np.int32), max_new_tokens=6)
                 for p in prompts]
        japi.run_until_idle()
        for r, jr, row in zip(reqs, jreqs, jtokens):
            np.testing.assert_array_equal(r.output_ids(),
                                          np.asarray(jr.output_ids()))
            np.testing.assert_array_equal(r.output_ids(), row)
    finally:
        japi.close()
        api.close()


def test_untied_head_state_and_quantization(arrays):
    """seeded_state and load_functional_state carry lm_head.weight;
    serving quantization leaves the head alone."""
    m = gpt.GPTForCausalLM(gpt.GPTConfig(**CFG, tie_word_embeddings=False),
                           device="cpu")
    state = gpt.seeded_state(m, seed=1)
    assert state["lm_head.weight"].shape == (CFG["hidden_size"],
                                             CFG["vocab_size"])
    gpt.load_functional_state(m, state)
    np.testing.assert_array_equal(m.lm_head.weight.detach().numpy(),
                                  state["lm_head.weight"])
    assert gpt.quantize_serving_weights(m) == 4 * CFG["num_layers"]
    assert m.lm_head.weight.dtype == torch.float32
    assert getattr(m.lm_head, "weight_scale", None) is None


def test_generate_runs_in_eval_mode(arrays):
    """generate() on a model in train mode with dropout decodes as in eval
    mode (no draw), then restores train mode."""
    m = _port(arrays, dropout=0.3)
    prompts = np.random.default_rng(13).integers(0, CFG["vocab_size"], (1, 5))
    state = rng.get_rng_state()
    out = m.generate(prompts, max_new_tokens=4)
    assert m.training and torch.equal(rng.get_rng_state(), state)
    m.eval()
    assert torch.equal(out, m.generate(prompts, max_new_tokens=4))


def test_scan_layers_matches_jax_scan(arrays):
    """use_scan_layers: the port runs the unrolled stack, the JAX TrainStep
    its lax.scan: losses of 2 steps within rtol 1e-5."""
    losses, jlosses = _train_both(arrays, steps=2, use_scan_layers=True)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


# ------------------------------------------------------------ cross entropy


CE_CASES = {
    "weight": dict(weight=True),
    "weight_sum": dict(weight=True, reduction="sum"),
    "smoothing": dict(label_smoothing=0.1),
    "smoothing_weight_none": dict(label_smoothing=0.2, weight=True,
                                  reduction="none"),
    "soft_label": dict(soft_label=True),
    "soft_label_none": dict(soft_label=True, reduction="none"),
    "no_softmax": dict(use_softmax=False),
    "no_softmax_smoothing": dict(use_softmax=False, label_smoothing=0.1),
    "ignore_index": dict(ignore_index=3, weight=True),
    "label_dim_kept": dict(keep_dim=True),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_arguments_match_jax(case):
    """Each argument of cross_entropy against the JAX package: the loss
    within 1e-6 + 1e-6 rel and the logits' gradient within 1e-6 + 1e-5
    rel."""
    kw = dict(CE_CASES[case])
    r = np.random.default_rng(14)
    logits = r.standard_normal((12, 7)).astype(np.float32)
    if not kw.pop("soft_label", False):
        labels = r.integers(0, 7, (12,))
        labels[[2, 5]] = kw.get("ignore_index", -100)
        if kw.pop("keep_dim", False):
            labels = labels[:, None]
        soft = False
    else:
        labels = r.random((12, 7)).astype(np.float32)
        labels /= labels.sum(-1, keepdims=True)
        soft = True
    if not kw.get("use_softmax", True):
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if kw.pop("weight", False):
        kw["weight"] = r.random(7).astype(np.float32) + 0.5
    tw = {k: (torch.from_numpy(v) if k == "weight" else v)
          for k, v in kw.items()}
    jw = {k: (paddle.to_tensor(v) if k == "weight" else v)
          for k, v in kw.items()}
    x = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(x, torch.from_numpy(labels), soft_label=soft, **tw)
    jx = paddle.to_tensor(logits)
    jx.stop_gradient = False
    want = jax_cross_entropy(jx, paddle.to_tensor(labels), soft_label=soft,
                             **jw)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want.numpy()), atol=1e-6,
                               rtol=1e-6)
    got.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx.grad.numpy()),
                               atol=1e-6, rtol=1e-5)


def test_softmax_with_cross_entropy_matches_jax():
    r = np.random.default_rng(15)
    logits = r.standard_normal((6, 9)).astype(np.float32)
    labels = r.integers(0, 9, (6, 1))
    loss, sm = softmax_with_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels),
                                          return_softmax=True)
    jloss, jsm = jax_softmax_ce(paddle.to_tensor(logits),
                                paddle.to_tensor(labels),
                                return_softmax=True)
    assert tuple(loss.shape) == (6, 1)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss.numpy()),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm.numpy()),
                               atol=1e-7, rtol=1e-6)


# --------------------------------------------------------------- GradScaler


SCALER = dict(init_loss_scaling=2.0 ** 10, incr_ratio=2.0, decr_ratio=0.25,
              incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
# finite (True) and non-finite steps: a bad run shorter and one as long as
# decr_every, good runs reaching incr_every, and the floor of 1.0
SCRIPT = ([True] * 4 + [False, True, False, False] + [True] * 3
          + [False] * 12 + [True])


def _linear_pair(seed):
    r = np.random.default_rng(seed)
    w = r.standard_normal((4, 3)).astype(np.float32)
    b = r.standard_normal(3).astype(np.float32)
    lin, jlin = Linear(4, 3), JaxLinear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    jlin.weight._data = jnp.asarray(w)
    jlin.bias._data = jnp.asarray(b)
    return lin, jlin


@pytest.mark.parametrize("use_minimize", [False, True])
def test_grad_scaler_state_machine_matches_jax(use_minimize):
    """A scripted run of finite and non-finite steps through both
    packages' GradScaler with Adam: the scale and counts after every step
    equal, a non-finite step leaves parameters and slots bit-unchanged,
    and the parameters agree at the end."""
    lin, jlin = _linear_pair(16)
    opt = Adam(learning_rate=1e-2, parameters=lin.named_parameters())
    jopt = JaxAdam(learning_rate=1e-2, parameters=jlin.parameters())
    sc, jsc = amp.GradScaler(**SCALER), jamp.GradScaler(**SCALER)
    x = np.random.default_rng(17).standard_normal((5, 4)).astype(np.float32)
    for i, finite in enumerate(SCRIPT):
        c = np.full((5, 3), 1.0 if finite else np.inf, np.float32)
        before = [p.detach().clone() for p in lin.parameters()]
        slots = opt.optimizer_state_arrays()
        loss = (lin(torch.from_numpy(x)) * torch.from_numpy(c)).sum()
        jloss = (jlin(paddle.to_tensor(x)) * paddle.to_tensor(c)).sum()
        if use_minimize:
            sc.minimize(opt, sc.scale(loss))
            jsc.minimize(jopt, jsc.scale(jloss))
        else:
            sc.scale(loss).backward()
            sc.step(opt)
            jsc.scale(jloss).backward()
            jsc.step(jopt)
        opt.clear_grad()
        jopt.clear_grad()
        assert sc.state_dict() == jsc.state_dict(), i
        if not finite:
            for a, p in zip(before, lin.parameters()):
                assert torch.equal(a, p.detach())
            after = opt.optimizer_state_arrays()
            assert set(after) == set(slots)
            for k in slots:
                np.testing.assert_array_equal(after[k], slots[k])
    assert sc.get_loss_scaling() == 1.0  # the floor
    for p, jp in zip(lin.parameters(), jlin.parameters()):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp.numpy()), rtol=1e-5,
                                   atol=1e-6)


def test_grad_scaler_unscale_once_and_state_dict():
    lin, _ = _linear_pair(18)
    opt = Adam(parameters=lin.named_parameters())
    sc = amp.GradScaler(init_loss_scaling=8.0)
    sc.scale(lin(torch.ones(2, 4)).sum()).backward()
    g = lin.weight.grad.clone()
    sc.unscale_(opt)
    sc.unscale_(opt)  # a second call in the same step does nothing
    assert torch.equal(lin.weight.grad, g / 8.0)
    sc.step(opt)
    state = sc.state_dict()
    assert state == {"scale": 8.0, "good_steps": 1, "bad_steps": 0}
    other = amp.GradScaler()
    other.load_state_dict(state)
    assert other.state_dict() == state
    off = amp.GradScaler(enable=False)
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss and not off.is_enable()
    assert amp.AmpScaler is amp.GradScaler


# ----------------------------------------------------- regularizers and clip


@pytest.mark.parametrize("opt_name", ["Adam", "AdamW"])
@pytest.mark.parametrize("reg", ["L1Decay", "L2Decay", "float"])
def test_regularizers_match_jax(opt_name, reg):
    """weight_decay as L1Decay (along sign(p)), L2Decay or a float, with
    Adam (decay added to the gradient) and AdamW (decoupled): 3 eager
    steps, parameters within 1e-6 + 1e-5 rel."""
    lin, jlin = _linear_pair(19)
    wd = (getattr(regularizer, reg)(0.05) if reg != "float" else 0.05)
    jwd = (getattr(jreg, reg)(0.05) if reg != "float" else 0.05)
    cls, jcls = {"Adam": (Adam, JaxAdam), "AdamW": (AdamW, JaxAdamW)}[
        opt_name]
    opt = cls(learning_rate=1e-2, parameters=lin.named_parameters(),
              weight_decay=wd)
    jopt = jcls(learning_rate=1e-2, parameters=jlin.parameters(),
                weight_decay=jwd)
    x = np.random.default_rng(20).standard_normal((5, 4)).astype(np.float32)
    for _ in range(3):
        (lin(torch.from_numpy(x)) ** 2).sum().backward()
        opt.step()
        opt.clear_grad()
        (jlin(paddle.to_tensor(x)) ** 2).sum().backward()
        jopt.step()
        jopt.clear_grad()
    for p, jp in zip(lin.parameters(), jlin.parameters()):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp.numpy()), rtol=1e-5,
                                   atol=1e-6)
    assert repr(regularizer.L1Decay(0.5)) == "L1Decay, coeff=0.5"


def test_global_norm_clip_arguments_change_nothing():
    r = np.random.default_rng(21)
    grads = [r.standard_normal((4, 5)).astype(np.float32) * 3
             for _ in range(3)]
    base = clip.ClipGradByGlobalNorm(1.0)._clip_arrays(
        [torch.from_numpy(g) for g in grads])
    named = clip.ClipGradByGlobalNorm(1.0, group_name="decoder",
                                      auto_skip_clip=True)
    got = named._clip_arrays([torch.from_numpy(g) for g in grads])
    want = jclip.ClipGradByGlobalNorm(1.0, group_name="decoder",
                                      auto_skip_clip=True)._clip_arrays(
        [jnp.asarray(g) for g in grads])
    for a, b, c in zip(got, base, want):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6)
    assert named.group_name == "decoder" and named.auto_skip_clip
