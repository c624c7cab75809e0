"""Multi-rank training of the port (``distributed.mesh`` training mesh,
``parallel``, ``fleet``, ``sharding``, the repaired parallel layers, the
vocab-parallel loss, ``TrainStep`` and the clip on a mesh, dropout boxes,
``generate()`` on a split model) against the JAX package on the same
``functional_state()`` arrays.

Ranks are threads of this process over gloo (``parallel.run_thread_ranks``:
a shared ``HashStore``, each thread its own key state, backward on the
calling thread). Tolerances, each with its reason:

* a split computation against the whole one in f32: 1e-5, relative for
  losses and normwise for gradients (the largest difference over the
  largest entry): the same math, the ranks' partial sums added in another
  order;
* the hybrid ``TrainStep`` against the JAX run: rtol 2e-3 / atol 2e-4,
  ``tests/test_mesh_serving.py:369``'s own bound (AdamW steps of lr 1e-3
  amplify rounding), and within rtol 1e-5 of the port's one-rank run;
* tokens and ZeRO's sharded updates: equal (ZeRO within rtol 1e-6: the
  global mean's sums are taken per data rank first).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import rng as jrng
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.fleet.meta_parallel import (
    ParallelCrossEntropy as JaxParallelCE)
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import (checkpoint, collective, fleet,
                                          parallel, sharding)
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Embedding, Linear
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.serving import SamplingParams

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 4


def _ranks(fn, dp=1, mp=1, sharding_=1):
    """``fn(mesh)`` on every rank of a ``dp x sharding x mp`` gloo mesh."""
    world = dp * mp * sharding_

    def body(rank, store):
        mesh = mesh_mod.init_hybrid_mesh(dp=dp, mp=mp, sharding=sharding_,
                                         rank=rank, world_size=world,
                                         backend="gloo", store=store)
        return fn(mesh)

    return parallel.run_thread_ranks(body, world, timeout=300.0)


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.gpt_tiny(),
                                               device="cpu"), seed=0)


def _port(arrays, **kw):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(**kw), device="cpu")
    gpt.load_functional_state(m, arrays)
    return m


def _jax(arrays, **kw):
    m = JaxGPT(jax_gpt_tiny(**kw))
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


def _data():
    """``tests/test_mesh_serving.py:369``'s batch."""
    r = np.random.default_rng(0)
    x = r.integers(0, 1024, (8, 64)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _j(a):
    return Tensor(np.asarray(a, np.int32))


def _close(got, want, rel=1e-5, what=""):
    """``max |got - want| <= rel * max |want|``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= rel * float(np.max(np.abs(want))), (what, err)


# ----------------------------------------------------------- the §3 fault


@pytest.mark.parametrize("mp", [2, 4])
def test_split_pair_and_tied_head_gradients_equal_the_whole(mp):
    """The fault a split model trained with: a column / row pair and the
    vocab-parallel embedding with its tied head, forward and backward over
    ``mp`` ranks. ``x.grad`` and every weight's gradient equal the whole
    computation's (``jax.grad``) slices within 1e-5 (normwise)."""
    r = np.random.default_rng(4)
    V, h, inter = 64, 16, 32
    x = r.standard_normal((3, 5, h)).astype(np.float32)
    ids = r.integers(0, V, (3, 5))
    c1 = r.standard_normal((3, 5, h)).astype(np.float32)
    c2 = r.standard_normal((3, 5, V)).astype(np.float32)
    c3 = r.standard_normal((3, 5, h)).astype(np.float32)
    w = {"w1": r.standard_normal((h, inter)).astype(np.float32),
         "b1": r.standard_normal(inter).astype(np.float32),
         "w2": r.standard_normal((inter, h)).astype(np.float32),
         "b2": r.standard_normal(h).astype(np.float32),
         "emb": r.standard_normal((V, h)).astype(np.float32)}

    def whole(x, w):
        y = (x @ w["w1"] + w["b1"]) @ w["w2"] + w["b2"]
        return (jnp.sum(y * c1) + jnp.sum((y @ w["emb"].T) * c2)
                + jnp.sum(w["emb"][ids] * c3))

    gx, gw = jax.grad(whole, argnums=(0, 1))(jnp.asarray(x),
                                             {k: jnp.asarray(v)
                                              for k, v in w.items()})

    def rank(mesh):
        up, down = Linear(h, inter), Linear(inter, h)
        with torch.no_grad():
            up.weight.copy_(torch.from_numpy(w["w1"]))
            up.bias.copy_(torch.from_numpy(w["b1"]))
            down.weight.copy_(torch.from_numpy(w["w2"]))
            down.bias.copy_(torch.from_numpy(w["b2"]))
        emb = Embedding(V, h)
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(w["emb"]))
        lo, hi = (mesh.model_rank * inter // mp,
                  (mesh.model_rank + 1) * inter // mp)
        col = ColumnParallelLinear.from_linear(up, mesh, np.arange(lo, hi))
        row = RowParallelLinear.from_linear(down, mesh, (lo, hi))
        vemb = VocabParallelEmbedding.from_embedding(emb, mesh)
        xt = torch.from_numpy(x).requires_grad_()
        y = row(col(xt))
        loss = ((y * torch.from_numpy(c1)).sum()
                + (vemb.logits(y) * torch.from_numpy(c2)).sum()
                + (vemb(_t(ids)) * torch.from_numpy(c3)).sum())
        loss.backward()
        return (xt.grad.numpy(), (lo, hi), col.weight.grad.numpy(),
                col.bias.grad.numpy(), row.weight.grad.numpy(),
                row.bias.grad.numpy(), vemb.rows, vemb.weight.grad.numpy())

    for xg, (lo, hi), w1, b1, w2, b2, (vlo, vhi), eg in _ranks(rank, mp=mp):
        _close(xg, gx, what="x")
        _close(w1, gw["w1"][:, lo:hi], what="w1")
        _close(b1, gw["b1"][lo:hi], what="b1")
        _close(w2, gw["w2"][lo:hi], what="w2")
        _close(b2, gw["b2"], what="b2")
        _close(eg, gw["emb"][vlo:vhi], what="emb")


@pytest.mark.parametrize("mp", [2, 4])
def test_parallel_cross_entropy_matches_jax(mp):
    """``ParallelCrossEntropy`` on each rank's vocabulary columns against
    the JAX layer (``mp_layers.py:101``) on the whole logits: the per-token
    loss (labels -100 give 0) and the gradient of its sum (each rank its
    columns), within 1e-5."""
    r = np.random.default_rng(8)
    V = 48
    logits = (r.standard_normal((2, 6, V)) * 3).astype(np.float32)
    labels = r.integers(0, V, (2, 6))
    labels[0, 2] = labels[1, 5] = -100
    want = np.asarray(JaxParallelCE()(Tensor(logits), Tensor(
        labels.astype(np.int32))).numpy())
    jgrad = np.asarray(jax.grad(lambda z: jnp.sum(JaxParallelCE()(
        Tensor(z), Tensor(labels.astype(np.int32)))._data))(
            jnp.asarray(logits)))

    def rank(mesh):
        n = V // mp
        lo = mesh.model_rank * n
        z = torch.from_numpy(logits[..., lo:lo + n].copy()).requires_grad_()
        out = ParallelCrossEntropy()(z, _t(labels))
        out.sum().backward()
        return lo, n, out.detach().numpy(), z.grad.numpy()

    for lo, n, got, g in _ranks(rank, mp=mp):
        _close(got, want, what="loss")
        _close(g, jgrad[..., lo:lo + n], what="grad")


# ------------------------------------------------------------ TrainStep


@pytest.fixture(scope="module")
def jax_losses(arrays):
    """The JAX TrainStep of ``tests/test_mesh_serving.py:369`` on one
    device and on the port's arrays."""
    m = _jax(arrays)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=m.parameters())
    step = JaxTrainStep(lambda x, y: m(x, y), opt, layers=m)
    x, y = _data()
    xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
    return [float(step(xt, yt).numpy()) for _ in range(STEPS)]


def _port_train(arrays, x, y, steps=STEPS, **kw):
    m = _port(arrays, **kw)
    m.train()
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = TrainStep(lambda a, b: m(a, b), opt)
    return [float(step(_t(x), _t(y))) for _ in range(steps)]


@pytest.fixture(scope="module")
def port_losses(arrays):
    x, y = _data()
    return _port_train(arrays, x, y)


@pytest.mark.parametrize("dp,mp", [(1, 2), (1, 4), (2, 1), (2, 4)])
def test_trainstep_on_a_hybrid_mesh_matches_jax(arrays, jax_losses,
                                                port_losses, dp, mp):
    """``TrainStep`` on ``gpt_tiny`` over data ``dp`` x model ``mp``
    (``shard_model`` on the model axis, ``shard_batch`` on the data axis,
    AdamW, 4 steps): every rank's losses within rtol 2e-3 / atol 2e-4 of
    the JAX run and within rtol 1e-5 of the port's one-rank run, and
    decreasing."""
    x, y = _data()

    def rank(mesh):
        m = _port(arrays)
        gpt.shard_model(m, mesh)
        m.train()
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        step = TrainStep(lambda a, b: m(a, b), opt)
        xs, ys = parallel.shard_batch(_t(x)), parallel.shard_batch(_t(y))
        return [float(step(xs, ys)) for _ in range(STEPS)]

    for losses in _ranks(rank, dp=dp, mp=mp):
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(losses, port_losses, rtol=1e-5)


def test_chunked_loss_on_a_split_model_matches_jax(arrays):
    """The chunked loss (chunks of 48 tokens: the last one padded) with
    recompute on a model split over 2 ranks: the loss equals the JAX
    chunked loss, and each rank's gradients equal the JAX gradients'
    slices; ``gather_by_sum`` (the vocab gather) never runs, chunked or
    not: no ``[tokens, vocab]`` logits exist."""
    x, y = _data()
    y = y.copy()
    y[1, :30] = -100
    jm = _jax(arrays, loss_chunk_size=48, use_recompute=True)
    jm.train()
    loss = jm(_j(x), _j(y))
    want = float(loss)
    loss.backward()
    jgrads = {n: np.asarray(t.grad.numpy())
              for n, t in jm.functional_state()[0].items()}
    calls = []
    real = collective.gather_by_sum

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    def rank(mesh):
        out = []
        for chunk in (48, 0):
            m = _port(arrays, loss_chunk_size=chunk, use_recompute=True)
            gpt.shard_model(m, mesh)
            m.train()
            loss = m(_t(x), _t(y))
            loss.backward()
            out.append((float(loss.detach()),
                        _shard_grads(m, jgrads, mesh)))
        return out

    collective.gather_by_sum = counted
    try:
        results = _ranks(rank, mp=2)
    finally:
        collective.gather_by_sum = real
    assert not calls, calls
    for per_rank in results:
        for got, pairs in per_rank:
            assert abs(got - want) <= 1e-5 * abs(want)
            for name, g, w in pairs:
                _close(g, w, what=name)


@pytest.mark.parametrize("chunk", [0, 100])
def test_untied_split_head_matches_jax(chunk):
    """An untied ``lm_head`` split by vocabulary columns over 2 ranks: the
    loss (chunked or not) equals the JAX model's and each rank's
    ``lm_head`` gradient equals the JAX gradient's columns (1e-5)."""
    kw = dict(tie_word_embeddings=False, loss_chunk_size=chunk)
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(**kw), device="cpu")
    arrays = gpt.seeded_state(m, seed=3)
    x, y = (a[:2] for a in _data())
    jm = _jax(arrays, **kw)
    loss = jm(_j(x), _j(y))
    want = float(loss)
    loss.backward()
    jgrad = np.asarray(jm.functional_state()[0]["lm_head.weight"].grad
                       .numpy())

    def rank(mesh):
        mm = _port(arrays, **kw)
        gpt.shard_model(mm, mesh)
        got = mm(_t(x), _t(y))
        got.backward()
        lo = int(mm.lm_head.columns[0])
        return float(got.detach()), lo, mm.lm_head.weight.grad.numpy()

    for got, lo, g in _ranks(rank, mp=2):
        assert abs(got - want) <= 1e-5 * abs(want)
        _close(g, jgrad[:, lo:lo + g.shape[1]], what="lm_head")


def _shard_grads(m, jgrads, mesh):
    """``(name, this rank's gradient, the JAX gradient's same slice)`` for
    every parameter of a split ``gpt_tiny``."""
    heads, hd = 4, 32
    out = []
    for name, p in m.named_parameters():
        want = jgrads[name]
        if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
            cols = gpt.sharding_util.qkv_columns(heads, hd, mesh)
            want = want[..., cols]
        elif name.endswith("attn.proj.weight"):
            lo, hi = gpt.sharding_util.head_rows(heads, hd, mesh)
            want = want[lo:hi]
        elif name.endswith(("mlp.up.weight", "mlp.up.bias")):
            lo, hi = gpt.sharding_util.split_range(512, mesh)
            want = want[..., lo:hi]
        elif name.endswith("mlp.down.weight"):
            lo, hi = gpt.sharding_util.split_range(512, mesh)
            want = want[lo:hi]
        elif name == "gpt.wte.weight":
            lo, hi = gpt.sharding_util.split_range(1024, mesh)
            want = want[lo:hi]
        out.append((name, p.grad.numpy(), want))
    return out


def test_clip_global_norm_is_the_whole_models(arrays):
    """``ClipGradByGlobalNorm``'s norm over a model split over 2 ranks
    (split shards' squares summed over the model group, replicated ones
    once) equals the norm of the JAX model's whole gradients (rtol 1e-5),
    on every rank; the clipped step then moves each shard as the whole
    step moves its slice."""
    x, y = _data()
    jm = _jax(arrays)
    jm.train()
    jm(_j(x), _j(y)).backward()
    jgrads = [np.asarray(t.grad.numpy(), np.float64)
              for t in jm.functional_state()[0].values()]
    want = float(np.sqrt(sum(np.sum(g * g) for g in jgrads)))

    def rank(mesh):
        m = _port(arrays)
        gpt.shard_model(m, mesh)
        m.train()
        m(_t(x), _t(y)).backward()
        params = list(m.parameters())
        c = clip.ClipGradByGlobalNorm(1.0)
        return float(c.global_norm([p.grad for p in params],
                                   parallel.norm_groups(params)))

    for got in _ranks(rank, mp=2):
        assert abs(got - want) <= 1e-5 * want


def test_data_parallel_loss_is_the_global_token_mean(arrays):
    """Labels -100 in unequal numbers on the two data ranks: the loss on
    every rank is the JAX single-device loss over the whole batch (the
    global sum over the global valid count, not the mean of the ranks'
    means), at data 2 and at data 2 x model 2, chunked and not."""
    x, y = _data()
    y = y.copy()
    y[:4, :50] = -100  # rank 0's rows: 14 valid tokens a row
    y[6, 60:] = -100
    want = {c: float(_jax(arrays, loss_chunk_size=c)(_j(x), _j(y)))
            for c in (0, 64)}
    halves = [float(_jax(arrays)(_j(x[a:b]), _j(y[a:b])))
              for a, b in ((0, 4), (4, 8))]
    # the mean of the ranks' means is far outside the bound below
    assert abs(np.mean(halves) - want[0]) > 1e-3 * want[0]

    for dp, mp in ((2, 1), (2, 2)):
        def rank(mesh):
            out = {}
            for c in (0, 64):
                m = _port(arrays, loss_chunk_size=c)
                gpt.shard_model(m, mesh)
                xs, ys = (parallel.shard_batch(_t(x)),
                          parallel.shard_batch(_t(y)))
                out[c] = float(m(xs, ys).detach())
            return out

        for got in _ranks(rank, dp=dp, mp=mp):
            for c in (0, 64):
                assert abs(got[c] - want[c]) <= 1e-5 * want[c], (dp, mp, c)


@pytest.mark.parametrize("kind", ["soft_label", "plain_mean"])
def test_data_parallel_gradients_are_one_devices(kind):
    """A mean loss over data 2 trains as the JAX package's one device: the
    soft-label cross entropy (the global mean on every rank) and a plain
    ``.mean()`` of a squared error over each rank's equal rows (each
    rank's own mean; the average of the ranks' gradients is the global
    mean's). Through the eager ``DataParallel`` path (``.grad`` averaged
    as backward accumulates it) and through ``TrainStep`` (SGD at lr 1: the
    update is the gradient, averaged once), the gradients equal ``jax``'s
    within 1e-5 (normwise); the soft-label loss equals the JAX loss on
    every rank, and the plain means average to it."""
    r = np.random.default_rng(7)
    n, h, c = 8, 6, 5
    x = r.standard_normal((n, h)).astype(np.float32)
    w = (r.standard_normal((h, c)) * 0.5).astype(np.float32)
    b = (r.standard_normal(c) * 0.5).astype(np.float32)
    if kind == "soft_label":
        y = r.random((n, c)).astype(np.float32)
        y /= y.sum(1, keepdims=True)
    else:
        y = r.standard_normal((n, c)).astype(np.float32)

    def loss_of(logits, target, fn):
        if kind == "soft_label":
            return fn.cross_entropy(logits, target, soft_label=True)
        return ((logits - target) ** 2).mean()

    jw = paddle.to_tensor(w, stop_gradient=False)
    jb = paddle.to_tensor(b, stop_gradient=False)
    jloss = loss_of(paddle.matmul(paddle.to_tensor(x), jw) + jb,
                    paddle.to_tensor(y), paddle.nn.functional)
    jloss.backward()
    want = float(jloss), jw.grad.numpy(), jb.grad.numpy()

    def rank(mesh):
        lin = Linear(h, c)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(b))
        ys = parallel.shard_batch(torch.from_numpy(y))
        loss = loss_of(parallel.DataParallel(lin)(torch.from_numpy(x)), ys,
                       F)
        loss.backward()
        eager = (float(loss.detach()), lin.weight.grad.numpy().copy(),
                 lin.bias.grad.numpy().copy())
        lin.weight.grad = lin.bias.grad = None
        step = TrainStep(lambda a, t: loss_of(lin(a), t, F),
                         SGD(learning_rate=1.0,
                             parameters=list(lin.parameters())))
        loss = step(parallel.shard_batch(torch.from_numpy(x)), ys)
        return eager, (float(loss), w - lin.weight.detach().numpy(),
                       b - lin.bias.detach().numpy())

    got = _ranks(rank, dp=2)
    for path in (0, 1):
        losses = [g[path][0] for g in got]
        if kind == "soft_label":
            for v in losses:
                assert abs(v - want[0]) <= 1e-5 * abs(want[0]), (path, v)
        else:
            assert abs(np.mean(losses) - want[0]) <= 1e-5 * abs(want[0])
        for g in got:
            _close(g[path][1], want[1], what=(path, "w"))
            _close(g[path][2], want[2], what=(path, "b"))


def test_dropout_masks_are_boxes_of_the_whole_models(arrays):
    """Dropout 0.1 at data 2 x model 2: each rank draws its box (batch
    rows, and its heads of the attention probabilities) of the whole
    model's masks, so two ``TrainStep``\\ s from the same seed give the JAX
    single-device run's losses (rtol 1e-5), through ``shard_batch`` and
    through ``fleet.distributed_model``'s ``DataParallel``; and the plain
    mask of a box is the whole mask's box."""
    x, y = _data()
    jm = _jax(arrays, dropout=0.1)
    jm.train()
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=jm.parameters())
    step = JaxTrainStep(lambda a, b: jm(a, b), opt, layers=jm)
    jrng.seed(3)
    want = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
            for _ in range(2)]

    def rank(mesh, wrap):
        m = _port(arrays, dropout=0.1)
        if wrap:
            model = fleet.distributed_model(m)
            assert isinstance(model, parallel.DataParallel)
            xs, ys = _t(x), _t(y)
        else:
            gpt.shard_model(m, mesh)
            model = m
            xs, ys = parallel.shard_batch(_t(x)), parallel.shard_batch(_t(y))
        m.train()
        o = AdamW(learning_rate=1e-3, parameters=m.parameters())
        s = TrainStep(lambda a, b: model(a, b), o)
        return [float(s(xs, ys)) for _ in range(2)]

    for wrap in (False, True):
        rng.seed(3)
        for got in _ranks(lambda mesh: rank(mesh, wrap), dp=2, mp=2):
            np.testing.assert_allclose(got, want, rtol=1e-5)
    from paddle_tpu_torch.ops import dropout as do

    key = rng.prng_key(5)
    t = torch.randn(4, 6, 8, 8)
    whole = do.dropout_ref(t, key, 0.3)
    with do.box({0: (2, 4, 2), 1: (3, 6, 3)}):
        part = do.dropout(t[2:, 3:], key, 0.3)
    np.testing.assert_array_equal(part.numpy(), whole[2:, 3:].numpy())


# -------------------------------------------------------------- generate


@pytest.fixture(scope="module")
def jax_tokens(arrays):
    jm = _jax(arrays)
    ids = np.random.default_rng(9).integers(0, 1024, (2, 7)).astype(np.int32)
    greedy = np.asarray(jm.generate(Tensor(ids), max_new_tokens=8).numpy())
    sampled = np.asarray(jm.generate(
        Tensor(ids), max_new_tokens=8, sampling=JaxSamplingParams(
            temperature=0.8, top_k=50, top_p=0.95, seed=11)).numpy())
    legacy = np.asarray(jm.generate(Tensor(ids), max_new_tokens=8,
                                    do_sample=True, top_k=40, seed=4)
                        .numpy())
    return ids, greedy, sampled, legacy


@pytest.mark.parametrize("mp", [2, 4])
def test_generate_on_a_split_model_matches_jax(arrays, jax_tokens, mp):
    """``generate()`` on a model split over ``mp`` ranks, every rank
    running it: greedy, sampled (``SamplingParams``) and the legacy
    ``do_sample`` tokens equal the JAX package's, token for token."""
    ids, greedy, sampled, legacy = jax_tokens

    def rank(mesh):
        m = _port(arrays)
        gpt.shard_model(m, mesh)
        return (m.generate(ids, max_new_tokens=8).numpy(),
                m.generate(ids, max_new_tokens=8, sampling=SamplingParams(
                    temperature=0.8, top_k=50, top_p=0.95, seed=11)).numpy(),
                m.generate(ids, max_new_tokens=8, do_sample=True, top_k=40,
                           seed=4).numpy())

    for g, s, leg in _ranks(rank, mp=mp):
        np.testing.assert_array_equal(g, greedy)
        np.testing.assert_array_equal(s, sampled)
        np.testing.assert_array_equal(leg, legacy)


# ------------------------------------------------------------------ ZeRO


def _mlp(d=8):
    """``tests/test_sharding_ckpt.py``'s model, on numpy-seeded weights."""
    m = torch.nn.Sequential(Linear(d, 2 * d), torch.nn.ReLU(),
                            Linear(2 * d, 1))
    r = np.random.default_rng(2)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(
                r.standard_normal(tuple(p.shape)).astype(np.float32) * 0.3))
    return m


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_group_sharded_levels_train_as_the_unsharded_port(level, tmp_path):
    """``group_sharded_parallel`` at sharding 4 x data 2
    (``tests/test_sharding_ckpt.py:25``): 6 AdamW steps give the unsharded
    port's losses (rtol 1e-6) on every rank; the slots of parameters whose
    dim 0 divides 4 hold a quarter of the rows (``p_g_os``: the parameters
    too), the others whole; ``state_dict`` gathers the slots whole, equal
    to the unsharded optimizer's; ``save_group_sharded_model`` writes the
    whole model."""
    r = np.random.default_rng(1)
    X = torch.from_numpy(r.random((16, 8)).astype(np.float32))
    Y = torch.from_numpy(r.random((16, 1)).astype(np.float32))
    m = _mlp()
    o = AdamW(learning_rate=1e-2, parameters=m.parameters())
    s = TrainStep(lambda a, b: ((m(a) - b) ** 2).mean(), o)
    want = [float(s(X, Y)) for _ in range(6)]
    want_slots = o.state_dict()
    want_params = {k: v.clone() for k, v in m.state_dict().items()}
    out = str(tmp_path / "zero")

    def rank(mesh):
        mm = _mlp()
        oo = AdamW(learning_rate=1e-2, parameters=mm.parameters())
        sharding.group_sharded_parallel(mm, oo, level=level)
        ss = TrainStep(lambda a, b: parallel.global_mean((mm(a) - b) ** 2),
                       oo)
        xs, ys = parallel.shard_batch(X), parallel.shard_batch(Y)
        losses = [float(ss(xs, ys)) for _ in range(6)]
        shapes = {id(p): tuple(v.shape) for p in oo._parameter_list
                  for v in oo._accumulators[id(p)].values()}
        held = [tuple(p.shape) for p in mm.parameters()]
        slots = oo.state_dict()
        sharding.save_group_sharded_model(mm, out, oo)
        return losses, [shapes[id(p)] for p in oo._parameter_list], held, \
            slots

    for losses, slot_shapes, held, slots in _ranks(rank, dp=2, sharding_=4):
        np.testing.assert_allclose(losses, want, rtol=1e-6)
        assert slot_shapes == [(2, 16), (4,), (4, 1), (1,)]
        assert held == ([(2, 16), (4,), (4, 1), (1,)] if level == "p_g_os"
                        else [(8, 16), (16,), (16, 1), (1,)])
        for k, v in want_slots.items():
            np.testing.assert_allclose(np.asarray(slots[k]), np.asarray(v),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    from paddle_tpu_torch.framework import io as fio

    saved = fio.load(str(tmp_path / "zero" / "model.pdparams"))
    for k, v in want_params.items():
        np.testing.assert_allclose(np.asarray(saved[k]), v.numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_group_sharded_split_gpt_with_recompute(arrays, level):
    """ZeRO over a split GPT with recompute and the chunked loss, data 2 x
    sharding 2 x model 2: three AdamW steps under the global-norm clip
    give the port's one-rank losses (rtol 1e-5). At ``p_g_os`` a
    recomputed layer gathers its slices again in backward (and, stopping
    early, leaves them for the next step to put back)."""
    x, y = _data()
    kw = dict(use_recompute=True, loss_chunk_size=100)
    m = _port(arrays, **kw)
    m.train()
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                grad_clip=clip.ClipGradByGlobalNorm(1.0))
    step = TrainStep(lambda a, b: m(a, b), opt)
    want = [float(step(_t(x), _t(y))) for _ in range(3)]

    def rank(mesh):
        mm = _port(arrays, **kw)
        gpt.shard_model(mm, mesh)
        mm.train()
        oo = AdamW(learning_rate=1e-3, parameters=mm.parameters(),
                   grad_clip=clip.ClipGradByGlobalNorm(1.0))
        sharding.group_sharded_parallel(mm, oo, level=level)
        ss = TrainStep(lambda a, b: mm(a, b), oo)
        xs, ys = parallel.shard_batch(_t(x)), parallel.shard_batch(_t(y))
        return [float(ss(xs, ys)) for _ in range(3)]

    for got in _ranks(rank, dp=2, mp=2, sharding_=2):
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_checkpoint_reshards_on_load(tmp_path):
    """``tests/test_sharding_ckpt.py:92``: a state saved whole loads onto
    a target sharded over sharding 8 (each rank its rows, the spec kept);
    and a state of sharded leaves saves whole."""
    arr = np.arange(64, dtype=np.float32).reshape(16, 4)
    path = str(tmp_path / "whole")
    checkpoint.save_state_dict({"w": torch.from_numpy(arr)}, path)
    back = str(tmp_path / "from_shards")

    def rank(mesh):
        target = {"w": sharding._place(torch.zeros(16, 4))}
        restored = checkpoint.load_state_dict(path, target=target)
        w = restored["w"]
        checkpoint.save_state_dict({"w": sharding._place(
            torch.from_numpy(arr) + 1)}, back)
        return mesh.axis_rank("sharding"), w.numpy(), w.shard_spec.rows

    for k, w, rows in _ranks(rank, sharding_=8):
        np.testing.assert_array_equal(w, arr[2 * k:2 * k + 2])
        assert rows == 16
    np.testing.assert_array_equal(
        checkpoint.load_state_dict(back)["w"].numpy(), arr + 1)


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2), (2, 2)])
def test_checkpoint_of_a_mesh_is_one_whole_write(arrays, tmp_path, dp, mp,
                                                 monkeypatch):
    """Every rank of a data x model mesh saves its model's ``state_dict()``
    (over model 2 each holds its shards) to one path: world rank 0 alone
    writes it, once, the whole model's state (the split shards gathered by
    their ``split_index``), equal to the unsplit model's; loading it with
    each rank's state dict as the target gives every rank its own shards
    back."""
    real, writes = checkpoint._write_dir, []

    def counted(path, snap):
        writes.append(path)
        return real(path, snap)

    monkeypatch.setattr(checkpoint, "_write_dir", counted)
    path = str(tmp_path / "ckpt")
    whole = {k: v.clone() for k, v in _port(arrays).state_dict().items()}

    def rank(mesh):
        m = _port(arrays)
        gpt.shard_model(m, mesh)
        sd = m.state_dict()
        checkpoint.save_state_dict(sd, path)
        back = checkpoint.load_state_dict(path, target=m.state_dict())
        return [k for k, v in sd.items() if not torch.equal(back[k], v)]

    for wrong in _ranks(rank, dp=dp, mp=mp):
        assert wrong == []
    assert writes == [path]
    saved = checkpoint.load_state_dict(path)
    assert sorted(saved) == sorted(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(saved[k].numpy(), v.numpy(),
                                      err_msg=k)


# ----------------------------------------------------------------- fleet


def test_fleet_topology_and_distributed_model():
    """``tests/test_distributed.py:82`` and ``:96``: the default strategy
    fills the data axis with the world (8), a pure data mesh wraps a layer
    in ``DataParallel`` (each rank runs its rows of the global batch); dp 2
    x mp 2 x sharding 2 is hybrid with each rank's coordinates; expert
    parallelism is refused by name (its ROADMAP item)."""
    def pure(mesh):
        return None

    def rank(r, store):
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(),
                   backend="gloo", store=store, rank=r, world_size=8)
        hcg = fleet.get_hybrid_communicate_group()
        lin = Linear(4, 2)
        m = fleet.distributed_model(lin)
        y = m(torch.ones(8, 4))
        fleet.barrier_worker()
        return (hcg.get_data_parallel_world_size(), hcg.get_parallel_mode(),
                isinstance(m, parallel.DataParallel), tuple(y.shape),
                fleet.worker_index(), fleet.worker_num())

    got = parallel.run_thread_ranks(rank, 8)
    for r, g in enumerate(got):
        assert g == (8, "data_parallel", True, (1, 2), r, 8)

    def hybrid(r, store):
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                             "sharding_degree": 2}
        fleet.init(strategy=st, backend="gloo", store=store, rank=r,
                   world_size=8)
        hcg = fleet.get_hybrid_communicate_group()
        return (hcg.get_parallel_mode(), hcg.get_model_parallel_world_size(),
                hcg.get_data_parallel_rank(), hcg.get_sharding_parallel_rank(),
                hcg.get_model_parallel_rank(),
                collective.get_world_size(fleet.get_model_parallel_group()))

    for r, g in enumerate(parallel.run_thread_ranks(hybrid, 8)):
        assert g == ("hybrid", 2, r // 4, (r // 2) % 2, r % 2, 2)
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "ep_degree": 2}
    with pytest.raises(NotImplementedError, match="1i"):
        fleet.init(strategy=st, backend="gloo", rank=0, world_size=8)
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.init_hybrid_mesh(dp=1)


@pytest.mark.parametrize("name", ["distributed/parallel.py",
                                  "distributed/sharding/__init__.py",
                                  "distributed/fleet/__init__.py",
                                  "distributed/mesh.py"])
def test_new_modules_import_no_jax(name):
    """The modules this slice added or rewrote import neither jax nor the
    JAX package."""
    tree = ast.parse((ROOT / "paddle_tpu_torch" / name).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "paddle_tpu")]
