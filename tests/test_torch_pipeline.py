"""Pipeline parallelism of the port (``distributed.pipeline``: the GPipe and
interleaved schedules; ``fleet.meta_parallel`` ``PipelineLayer`` /
``PipelineParallel``; ``models.gpt.GPTForCausalLMPipe``; a pipe model's
checkpoint) against the JAX package (``paddle_tpu/distributed/
pipeline.py`` and the JAX pipe GPT on conftest's 8 virtual CPU devices) on
the same numpy-seeded inputs and weights.

Ranks are threads of this process over gloo (``parallel.
run_thread_ranks``); each pipe rank holds only its own stage's (or
chunks') parameters. Tolerances, each with its reason:

* the schedules against the JAX functions in f32: outputs within 1e-5
  absolute (``tests/test_pipeline.py``'s bound), each rank's stage
  gradients within 1e-5 relative L2 of the JAX gradients' slices (the same
  math; the microbatches' gradients summed in another order);
* ``GPTForCausalLMPipe`` against the JAX pipe GPT: first-step gradients
  within 1e-5 relative L2 per parameter (the tied ``wte`` included) of the
  JAX one-device run's, 2 ``train_batch`` losses within rtol 1e-5 of the
  JAX pp = 2 run's (the same schedule's math; AdamW amplifies rounding
  little in 2 steps), every rank the same loss; the dropout step within
  rtol 1e-5 (the JAX package's masks, bit for bit);
* a checkpoint's reload: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.core import rng as jrng
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed.fleet.meta_parallel import (
    PipelineParallel as JaxPipelineParallel)
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLMPipe as JaxGPTPipe
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import checkpoint, fleet
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed import parallel, pipeline
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, SharedLayerDesc)
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn.layers import Embedding, Linear
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)


def _ranks(fn, pp=1, mp=1, dp=1):
    world = pp * mp * dp

    def body(rank, store):
        mesh = mesh_mod.init_hybrid_mesh(pp=pp, mp=mp, dp=dp, rank=rank,
                                         world_size=world, backend="gloo",
                                         store=store)
        return fn(mesh)

    return parallel.run_thread_ranks(body, world, timeout=300.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _backward(loss):
    with torch.autograd.set_multithreading_enabled(False):
        loss.backward()


# ------------------------------------------------------------ schedules


def _stages(S, L_per=2, d=8, seed=0):
    r = np.random.default_rng(seed)
    return [((r.standard_normal((L_per, d, d)) * 0.3).astype(np.float32),
             (r.standard_normal((L_per, d)) * 0.1).astype(np.float32))
            for _ in range(S)]


def _jax_stage(p, h):
    return jax.lax.scan(lambda c, wb: (jnp.tanh(c @ wb[0] + wb[1]), None),
                        h, p)[0]


def _torch_stage(p, h):
    for w, b in zip(p[0].unbind(0), p[1].unbind(0)):
        h = torch.tanh(h @ w + b)
    return h


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("M", [2, 4])
def test_pipeline_apply_matches_jax(pp, M):
    """GPipe at pp x M (``tests/test_pipeline.py:40``, ``:53``): the output
    on every pipe rank equals the JAX ``pipeline_apply``'s within 1e-5, and
    each rank's stage gradients (of a mean squared error) equal the JAX
    gradients of its stage within 1e-5 relative L2; the schedule ran
    ``pipeline_tick_cost(M, pp)`` ticks."""
    stages = _stages(pp)
    r = np.random.default_rng(1)
    x = r.standard_normal((16, 8)).astype(np.float32)
    y = r.standard_normal((16, 8)).astype(np.float32)
    mesh = jdist.init_hybrid_mesh(pp=pp, dp=8 // pp)
    jstacked = jpipe.stack_stage_params(
        [tuple(jnp.asarray(a) for a in s) for s in stages], pp, mesh=mesh)

    def jloss(params):
        out = jpipe.pipeline_apply(_jax_stage, params, jnp.asarray(x),
                                   num_microbatches=M, mesh=mesh)
        return jnp.mean((out - y) ** 2), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstacked)
    jgrads = [np.asarray(g) for g in jgrads]

    def rank(mesh):
        local = pipeline.stack_stage_params(
            [tuple(torch.from_numpy(a).requires_grad_() for a in s)
             for s in stages], pp, mesh)
        out = pipeline.pipeline_apply(_torch_stage, local, torch.from_numpy(x),
                                      num_microbatches=M)
        _backward(((out - torch.from_numpy(y)) ** 2).mean())
        return (mesh.axis_rank("pipe"), out.detach().numpy(),
                [p.grad.numpy() for p in local], pipeline.last_schedule())

    for s, out, grads, sched in _ranks(rank, pp=pp):
        np.testing.assert_allclose(out, np.asarray(want), atol=1e-5)
        for g, jg in zip(grads, jgrads):
            assert _rel(g, jg[s]) <= 1e-5
        assert sched["ticks"] == jpipe.pipeline_tick_cost(M, pp)


def test_interleaved_matches_jax():
    """The interleaved schedule at pp 4 x V 2 (``tests/
    test_pipeline_interleaved.py:20``, ``:46``): outputs at M 6 and at M 3
    (microbatches padded to a multiple of S) equal the JAX
    ``pipeline_apply_interleaved``'s within 1e-5; at M 4 each rank's chunk
    gradients equal the JAX gradients of its chunks (global stages ``d,
    d+S``) within 1e-5 relative L2; each run's cost is
    ``pipeline_tick_cost(M, 4, 2)``."""
    S, V = 4, 2
    r = np.random.default_rng(0)
    Ws = [(r.standard_normal((16, 16)) * 0.3).astype(np.float32)
          for _ in range(S * V)]
    x = r.standard_normal((12, 16)).astype(np.float32)
    mesh = jdist.init_hybrid_mesh(pp=4, dp=2)
    cp = jpipe.stack_chunk_params([{"w": jnp.asarray(w)} for w in Ws], S, V,
                                  mesh=mesh)
    want = {M: np.asarray(jpipe.pipeline_apply_interleaved(
        lambda p, h, v: jnp.tanh(h @ p["w"]), cp, jnp.asarray(x),
        num_microbatches=M, num_chunks=V, mesh=mesh)) for M in (6, 3)}

    def jloss(ws):
        c = jpipe.stack_chunk_params([{"w": w} for w in ws], S, V, mesh=mesh)
        out = jpipe.pipeline_apply_interleaved(
            lambda p, h, v: jnp.tanh(h @ p["w"]), c, jnp.asarray(x[:8]),
            num_microbatches=4, num_chunks=V, mesh=mesh, remat=True)
        return (out ** 2).mean()

    jgrads = [np.asarray(g) for g in jax.grad(jloss)(
        [jnp.asarray(w) for w in Ws])]

    def chunk(p, h, v):
        return torch.tanh(h @ p)

    def rank(mesh):
        local = pipeline.stack_chunk_params(
            [torch.from_numpy(w).requires_grad_() for w in Ws], S, V, mesh)
        outs, costs = {}, {}
        for M in (6, 3):
            with torch.no_grad():
                outs[M] = pipeline.pipeline_apply_interleaved(
                    chunk, local, torch.from_numpy(x), num_microbatches=M,
                    num_chunks=V).numpy()
            costs[M] = pipeline.last_schedule()["cost"]
        out = pipeline.pipeline_apply_interleaved(
            chunk, local, torch.from_numpy(x[:8]), num_microbatches=4,
            num_chunks=V, remat=True)
        costs[4] = pipeline.last_schedule()["cost"]
        _backward((out ** 2).mean())
        return mesh.axis_rank("pipe"), outs, [p.grad.numpy() for p in local], \
            costs

    for d, outs, grads, costs in _ranks(rank, pp=S):
        for M in (6, 3):
            np.testing.assert_allclose(outs[M], want[M], atol=1e-5)
        for v, g in enumerate(grads):
            assert _rel(g, jgrads[v * S + d]) <= 1e-5
        for M, cost in costs.items():
            assert cost == jpipe.pipeline_tick_cost(M, S, V)


def test_interleaved_degenerate_paths():
    """``tests/test_pipeline_interleaved.py:121``: without a pipe axis every
    chunk runs in turn on each microbatch (V 3), and V 1 on pp 4 is the
    GPipe schedule (M + S - 1 ticks); both equal the JAX function's within
    1e-5."""
    r = np.random.default_rng(2)
    x = r.standard_normal((8, 8)).astype(np.float32)
    Ws = [(r.standard_normal((8, 8)) * 0.3).astype(np.float32)
          for _ in range(3)]
    Ws4 = [(r.standard_normal((8, 8)) * 0.3).astype(np.float32)
           for _ in range(4)]

    def jfn(p, h, v):
        return jnp.tanh(h @ p["w"])

    mesh1 = jdist.init_hybrid_mesh(dp=8)
    want1 = np.asarray(jpipe.pipeline_apply_interleaved(
        jfn, jpipe.stack_chunk_params([{"w": jnp.asarray(w)} for w in Ws], 1,
                                      3, mesh=mesh1),
        jnp.asarray(x), num_microbatches=2, num_chunks=3, mesh=mesh1))
    mesh2 = jdist.init_hybrid_mesh(pp=4, dp=2)
    want2 = np.asarray(jpipe.pipeline_apply_interleaved(
        jfn, jpipe.stack_chunk_params([{"w": jnp.asarray(w)} for w in Ws4],
                                      4, 1, mesh=mesh2),
        jnp.asarray(x), num_microbatches=4, num_chunks=1, mesh=mesh2))

    def chunk(p, h, v):
        return torch.tanh(h @ p)

    got1 = pipeline.pipeline_apply_interleaved(
        chunk, [torch.from_numpy(w) for w in Ws], torch.from_numpy(x),
        num_microbatches=2, num_chunks=3)
    np.testing.assert_allclose(got1.numpy(), want1, atol=1e-5)

    def rank(mesh):
        local = pipeline.stack_chunk_params(
            [torch.from_numpy(w) for w in Ws4], 4, 1, mesh)
        out = pipeline.pipeline_apply_interleaved(
            chunk, local, torch.from_numpy(x), num_microbatches=4,
            num_chunks=1)
        return out.numpy(), pipeline.last_schedule()

    for out, sched in _ranks(rank, pp=4):
        np.testing.assert_allclose(out, want2, atol=1e-5)
        assert (sched["ticks"], sched["chunks"]) == (4 + 4 - 1, 1)


def test_tick_cost_matches_jax():
    """``pipeline_tick_cost`` equals the JAX function over a grid of M, S
    and V, and a schedule that does not divide its batch raises
    ``ValueError`` (``:91-92``, ``:228-229``)."""
    for m in range(1, 13):
        for s in (1, 2, 3, 4, 8):
            for v in (1, 2, 3, 4):
                assert pipeline.pipeline_tick_cost(m, s, v) == \
                    jpipe.pipeline_tick_cost(m, s, v)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.pipeline_apply(lambda p, h: h, (), torch.zeros(5, 2),
                                num_microbatches=2)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.pipeline_apply_interleaved(lambda p, h, v: h, [(), ()],
                                            torch.zeros(5, 2),
                                            num_microbatches=2, num_chunks=2)


# ---------------------------------------------------------- PipelineLayer


class Emb(torch.nn.Module):
    def __init__(self, v, d):
        super().__init__()
        self.e = Embedding(v, d)

    def forward(self, x):
        return self.e(x)


class Block(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc1 = Linear(d, 2 * d)
        self.fc2 = Linear(2 * d, d)

    def forward(self, x):
        return x + self.fc2(torch.tanh(self.fc1(x)))


class Head(torch.nn.Module):
    def __init__(self, d, v):
        super().__init__()
        self.fc = Linear(d, v)

    def forward(self, x):
        return self.fc(x)


def _descs(v, d, L):
    return ([LayerDesc(Emb, v, d)] + [LayerDesc(Block, d) for _ in range(L)]
            + [LayerDesc(Head, d, v)])


def test_segmentation_and_its_errors():
    """``tests/test_pipeline_layer.py:55-111``: the blocks are the maximal
    homogeneous run with one pre and one post section; a run the stages do
    not divide raises ``ValueError``; a layer built for 4 stages on a pipe
    axis of 2 raises ``ValueError`` at its forward; on a pipe axis each
    rank holds only its stage's rows of the stacked blocks."""
    m = PipelineLayer(_descs(32, 8, 4), num_stages=2, num_microbatches=2)
    assert m.blocks.num_layers == 4 and m.blocks.rows == [0, 1, 2, 3]
    assert len(m._pre) == 1 and len(m._post) == 1
    assert tuple(m.blocks.fc1__weight.shape) == (4, 8, 16)
    with pytest.raises(ValueError):
        PipelineLayer(_descs(32, 8, 3), num_stages=2)

    def rank(mesh):
        bad = PipelineLayer(_descs(32, 8, 4), num_stages=4,
                            num_microbatches=2)
        with pytest.raises(ValueError, match="pipe degree"):
            bad(torch.zeros(4, 4, dtype=torch.long))
        good = PipelineLayer(_descs(32, 8, 4), num_microbatches=2)
        return good.blocks.rows, tuple(good.blocks.fc1__weight.shape)

    got = _ranks(rank, pp=2)
    assert got == [([0, 1], (2, 8, 16)), ([2, 3], (2, 8, 16))]


def test_pipe_rank_builds_only_its_rows():
    """On a pipe axis a rank builds only its own blocks for real: every
    block ``LayerDesc`` is built once on the meta device (to find the run)
    and this rank's two of four again on the CPU; a ``StackedLayers``
    given ``rows`` builds the others on the meta device; no parameter a
    rank holds is on the meta device."""
    from paddle_tpu_torch.nn.stacked import StackedLayers

    def counted():
        real = []

        class Counted(Block):
            def __init__(self, d):
                super().__init__(d)
                real.append(self.fc1.weight.device.type != "meta")

        return Counted, real

    def rank(mesh):
        Counted, real = counted()
        m = PipelineLayer([LayerDesc(Emb, 32, 8)]
                          + [LayerDesc(Counted, 8) for _ in range(4)]
                          + [LayerDesc(Head, 8, 32)], num_microbatches=2)
        return real, m.blocks.rows, {p.device.type for p in m.parameters()}

    for r, (real, rows, devices) in enumerate(_ranks(rank, pp=2)):
        assert sorted(real) == [False] * 4 + [True] * 2
        assert rows == [2 * r, 2 * r + 1] and devices == {"cpu"}
    Counted, real = counted()
    st = StackedLayers(lambda i: Counted(8), 4, rows=[1, 3])
    assert real == [False, True, False, True]
    assert tuple(st.fc1__weight.shape) == (2, 8, 16)
    assert st.fc1__weight.device.type == "cpu"


def test_gpt_pipe_init_is_the_same_on_every_pipe_degree():
    """``GPTForCausalLMPipe``'s seeded init draws each block's row on its
    own: at pp 2 each rank's rows, and its sections, equal the one-rank
    pipe model's."""
    cfg = gpt.GPTConfig(**_CFG)
    one = dict(gpt.GPTForCausalLMPipe(cfg, device="cpu").named_parameters())

    def rank(mesh):
        m = gpt.GPTForCausalLMPipe(cfg, device="cpu")
        return m.blocks.rows, {n: p.detach().clone()
                               for n, p in m.named_parameters()}

    for rows, got in _ranks(rank, pp=2):
        assert set(got) == set(one)
        for n, t in got.items():
            want = one[n].detach()[rows] if n.startswith("blocks.") \
                else one[n].detach()
            assert torch.equal(t, want), n
    std = float(one["blocks.attn__qkv__weight"].detach().std())
    assert std == pytest.approx(0.02, rel=0.05)


def test_shared_layer_desc_is_one_parameter():
    """A ``SharedLayerDesc`` key builds one instance: a tied embedding used
    by the pre and post sections is one parameter, and its gradient is the
    sum of both paths once (against the same model written out)."""
    torch.manual_seed(0)

    def tied_head(layer, x):
        return x @ layer.e.weight.t()

    descs = ([SharedLayerDesc("emb", Emb, 16, 8)]
             + [LayerDesc(Block, 8) for _ in range(2)]
             + [SharedLayerDesc("emb", Emb, 16, 8, forward_func=tied_head)])
    m = PipelineLayer(descs, num_stages=1)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0, 0.3)
    names = [n for n, _ in m.named_parameters()]
    assert sum("e.weight" in n for n in names) == 1
    x = torch.tensor([[1, 5, 7], [2, 3, 15]])
    m(x).square().sum().backward()
    w = m.pre_0.e.weight.detach().clone().requires_grad_()
    h = w[x]
    for i in range(2):
        h = h + torch.tanh(h @ m.blocks.fc1__weight[i] + m.blocks.fc1__bias[
            i]) @ m.blocks.fc2__weight[i] + m.blocks.fc2__bias[i]
    (h @ w.t()).square().sum().backward()
    torch.testing.assert_close(m.pre_0.e.weight.grad, w.grad)


# ------------------------------------------------------------- the GPT


_CFG = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
            max_position_embeddings=256)


def _batch():
    r = np.random.default_rng(0)
    ids = r.integers(0, 1024, (8, 32)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def arrays():
    m = gpt.GPTForCausalLMPipe(gpt.GPTConfig(**_CFG), device="cpu")
    return {n: (np.random.default_rng(7).standard_normal(p.shape) * 0.02
                ).astype(np.float32) + (1.0 if n.endswith(
                    ("ln1__weight", "ln2__weight", "ln_f.weight")) else 0.0)
            for n, p in m.named_parameters()}


def _jax_pipe(arrays, stages, virtual, n_dev, **kw):
    jdist.init_hybrid_mesh(pp=stages if n_dev > 1 else 1, dp=1,
                           devices=jax.devices()[:n_dev])
    m = JaxGPTPipe(JaxGPTConfig(**_CFG, **kw), num_stages=stages,
                   num_microbatches=2, num_virtual_pipeline_stages=virtual)
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


@pytest.fixture(scope="module")
def jax_runs(arrays):
    """The JAX references: the one-device pipe GPT's first-step gradients,
    the JAX pp = 2 run's 2 ``train_batch`` losses, and its dropout 0.1
    step (seeded 3 after the model is built)."""
    x, y = _batch()
    one = _jax_pipe(arrays, 1, None, 1)
    loss = one.loss_fn(one(Tensor(x)), Tensor(y))
    loss.backward()
    grads = {n: np.asarray(t.grad.numpy())
             for n, t in one.functional_state()[0].items()}
    out = {"grads": grads}
    for key, kw, steps in (("losses", {}, 2), ("dropout", {"dropout": 0.1},
                                              1)):
        m = _jax_pipe(arrays, 2, None, 2, **kw)
        w = JaxPipelineParallel(m)
        o = paddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=m.parameters())
        jrng.seed(3)
        out[key] = [float(w.train_batch((Tensor(x), Tensor(y)), o).numpy())
                    for _ in range(steps)]
    return out


def _whole_slice(name, whole, p):
    """The part of the whole JAX gradient that the port's parameter ``p``
    holds: its pipe rows, then its model-axis part."""
    out = torch.from_numpy(np.array(whole))
    if getattr(p, "pipe_rows", None) is not None:
        out = out.index_select(0, torch.as_tensor(p.pipe_rows))
    if getattr(p, "split_index", None) is not None:
        from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers \
            import split_indices
        out = out.index_select(p.split_index[0], split_indices(p))
    return out.numpy()


@pytest.mark.parametrize("pp,virtual,mp,dp", [(2, None, 1, 1),
                                              (2, 2, 1, 1),
                                              (2, None, 2, 2)])
def test_gpt_pipe_matches_jax(arrays, jax_runs, pp, virtual, mp, dp):
    """``GPTForCausalLMPipe`` (4 layers, 2 microbatches) at pp 2, pp 2 x V
    2 and pp 2 x mp 2 x dp 2 through ``fleet.distributed_model``: each
    rank's first-step gradients (averaged over the data group) equal the
    JAX one-device gradients' parts within 1e-5 relative L2 (the tied
    ``wte`` included: one parameter, its two paths summed once); 2
    ``train_batch`` steps give the JAX pp = 2 run's losses within rtol 1e-5
    on every rank."""
    x, y = _batch()
    jgrads = jax_runs["grads"]

    def rank(mesh):
        st = fleet.DistributedStrategy()
        fleet._state.strategy = st
        m = gpt.GPTForCausalLMPipe(gpt.GPTConfig(**_CFG),
                                   num_microbatches=2,
                                   num_virtual_pipeline_stages=virtual,
                                   device="cpu")
        gpt.load_pipe_state(m, arrays)
        model = fleet.distributed_model(m)
        assert isinstance(model, PipelineParallel)
        m.train()
        names, params = zip(*m.named_parameters())
        assert sum("wte" in n for n in names) == 1
        xs = parallel.shard_batch(torch.as_tensor(x, dtype=torch.long))
        ys = parallel.shard_batch(torch.as_tensor(y, dtype=torch.long))
        with torch.autograd.set_multithreading_enabled(False):
            g = parallel.sync_gradients(torch.autograd.grad(
                m.loss_fn(m(xs), ys), params))
        rel = {n: _rel(a.numpy(), _whole_slice(n, jgrads[n], p))
               for n, a, p in zip(names, g, params)}
        o = AdamW(learning_rate=1e-3, parameters=m.parameters())
        losses = [float(model.train_batch(
            (torch.as_tensor(x, dtype=torch.long),
             torch.as_tensor(y, dtype=torch.long)), o)) for _ in range(2)]
        return rel, losses

    for rel, losses in _ranks(rank, pp=pp, mp=mp, dp=dp):
        assert max(rel.values()) <= 1e-5, rel
        np.testing.assert_allclose(losses, jax_runs["losses"], rtol=1e-5)


def test_gpt_pipe_dropout_draws_the_jax_masks(arrays, jax_runs):
    """Dropout 0.1 at pp 2 (2 microbatches): each block folds its global
    index into the key the pipeline draws, so the port's step, seeded as
    the JAX run was, gives its loss within rtol 1e-5 on both ranks."""
    x, y = _batch()

    def rank(mesh):
        m = gpt.GPTForCausalLMPipe(gpt.GPTConfig(**_CFG, dropout=0.1),
                                   num_microbatches=2, device="cpu")
        gpt.load_pipe_state(m, arrays)
        m.train()
        w = PipelineParallel(m)
        o = AdamW(learning_rate=1e-3, parameters=m.parameters())
        return float(w.train_batch((torch.as_tensor(x, dtype=torch.long),
                                    torch.as_tensor(y, dtype=torch.long)),
                                   o))

    rng.seed(3)
    for got in _ranks(rank, pp=2):
        np.testing.assert_allclose(got, jax_runs["dropout"][0], rtol=1e-5)


def test_pipe_checkpoint_reloads_on_other_degrees(arrays, tmp_path):
    """A pipe model saved at pp 2 (every rank calls the save; world rank 0
    writes) holds the JAX package's stacked names, whole
    (``blocks.<name>`` ``[4, ...]``); reloaded on one rank it equals the
    arrays, and on pp 4 each rank takes its own rows."""
    path = str(tmp_path / "pipe")

    def save(mesh):
        m = gpt.GPTForCausalLMPipe(gpt.GPTConfig(**_CFG), device="cpu")
        gpt.load_pipe_state(m, arrays)
        checkpoint.save_state_dict(m.state_dict(), path)
        return tuple(m.blocks.attn__qkv__weight.shape)

    assert _ranks(save, pp=2) == [(2, 128, 384)] * 2
    one = gpt.GPTForCausalLMPipe(gpt.GPTConfig(**_CFG), device="cpu")
    restored = checkpoint.load_state_dict(path, target=one.state_dict())
    assert set(restored) == set(arrays)
    checkpoint.apply_state_dict(one, restored)
    for n, p in one.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[n])

    def load(mesh):
        m = gpt.GPTForCausalLMPipe(gpt.GPTConfig(**_CFG), device="cpu")
        got = checkpoint.load_state_dict(path, target=m.state_dict())
        checkpoint.apply_state_dict(m, got)
        return m.blocks.rows, m.blocks.attn__qkv__weight.detach().numpy()

    for rows, w in _ranks(load, pp=4):
        np.testing.assert_array_equal(w, arrays["blocks.attn__qkv__weight"][
            rows])


def test_dropout_over_data_and_pipe_raises(arrays):
    """Dropout in a pipe model over a data axis is refused by name (the
    JAX microbatches are slices of the global batch, a rank's would be of
    its rows): ``train_batch`` raises ``NotImplementedError`` on every
    rank; without dropout the same mesh trains."""
    x, y = _batch()

    def rank(mesh):
        m = gpt.GPTForCausalLMPipe(gpt.GPTConfig(**_CFG, dropout=0.1),
                                   num_microbatches=2, device="cpu")
        gpt.load_pipe_state(m, arrays)
        m.train()
        w = PipelineParallel(m)
        o = AdamW(learning_rate=1e-3, parameters=m.parameters())
        with pytest.raises(NotImplementedError, match="data axis"):
            w.train_batch((torch.as_tensor(x, dtype=torch.long),
                           torch.as_tensor(y, dtype=torch.long)), o)
        return True

    assert all(_ranks(rank, pp=2, dp=2))
