"""Context (sequence) parallelism of the port (``distributed.
context_parallel``: ring and Ulysses attention on the ``sep`` axis; the
attention route; the GPT trained over a ``sep`` axis) against the JAX
package (``paddle_tpu/distributed/context_parallel.py`` on conftest's 8
virtual CPU devices, and the JAX GPT on one device) on the same
numpy-seeded inputs and weights.

Ranks are threads of this process over gloo (``parallel.
run_thread_ranks``); each holds its rows of the sequence. Tolerances, each
with its reason:

* ring and Ulysses against the JAX functions in f32: outputs within 2e-6
  of the largest entry and gradients within 1e-5 relative L2 (the ring's
  online softmax adds its blocks in another order than one softmax);
* the GPT at sep 2 x model 2 x data 2 against the JAX one-device run:
  first-step gradients within 1e-4 relative L2 per parameter (the ring's
  order of sums, the split's partial sums and the data x sep mean), losses
  within rtol 2e-3 / atol 2e-4 over 2 AdamW steps (``tests/
  test_torch_mesh_training.py``'s bound) and within 1e-5 of the port's
  one-rank run; every rank the same loss.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.context_parallel import (
    ring_attention as jax_ring, ulysses_attention as jax_ulysses)
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.functional.attention import (
    _sdpa_reference as jax_reference)
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.distributed import context_parallel as cp
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed import parallel
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ranks(fn, sep=1, mp=1, dp=1):
    world = sep * mp * dp

    def body(rank, store):
        mesh = mesh_mod.init_hybrid_mesh(dp=dp, mp=mp, sep=sep, rank=rank,
                                         world_size=world, backend="gloo",
                                         store=store)
        return fn(mesh)

    return parallel.run_thread_ranks(body, world, timeout=300.0)


def _inputs(b=2, s=16, h=4, d=8, seed=0):
    r = np.random.default_rng(seed)
    return tuple((r.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
                 for _ in range(4))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_run(fn, q, k, v, c, causal, sep):
    mesh = jdist.init_hybrid_mesh(sep=sep, dp=8 // sep)
    scale = 1.0 / np.sqrt(q.shape[-1])

    def loss(a, b, e):
        return jnp.sum(fn(a, b, e, scale=scale, causal=causal, mesh=mesh)
                       * c)

    out = jax.jit(lambda a, b, e: fn(a, b, e, scale=scale, causal=causal,
                                     mesh=mesh))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sep", [2, 4])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_context_parallel_matches_jax(kind, sep, causal):
    """Each sep rank's rows of the output and of q/k/v's gradients (of
    ``sum(out * c)``) equal the JAX function's on the whole sequence:
    outputs within 2e-6 of the largest entry, gradients within 1e-5
    relative L2."""
    q, k, v, c = _inputs()
    jfn, fn = ((jax_ring, cp.ring_attention) if kind == "ring"
               else (jax_ulysses, cp.ulysses_attention))
    want, wgrads = _jax_run(jfn, q, k, v, c, causal, sep)
    scale = 1.0 / np.sqrt(q.shape[-1])
    n = q.shape[1] // sep

    def rank(mesh):
        j = mesh.axis_rank("sep")
        rows = slice(j * n, (j + 1) * n)
        ts = [torch.from_numpy(a[:, rows].copy()).requires_grad_()
              for a in (q, k, v)]
        out = fn(*ts, scale=scale, causal=causal)
        with torch.autograd.set_multithreading_enabled(False):
            (out * torch.from_numpy(c[:, rows].copy())).sum().backward()
        return rows, out.detach().numpy(), [t.grad.numpy() for t in ts]

    for rows, out, grads in _ranks(rank, sep=sep):
        err = np.max(np.abs(out - want[:, rows]))
        assert err <= 2e-6 * np.max(np.abs(want)), err
        for g, w in zip(grads, wgrads):
            assert _rel(g, w[:, rows]) <= 1e-5


def test_ring_hop_backward_is_the_reverse_hop():
    """``collective.ppermute`` by +1 (the ring's and the pipeline's hop in
    the forward) moves each rank's tensor to the next rank, and by -1 (the
    hop their backward runs) moves it back to the rank that sent it: on 3
    ranks the two hops in turn give each rank its own tensor.
    ``ppermute_by_sum`` (the gloo-on-CUDA form) gives the same tensors."""
    from paddle_tpu_torch.distributed import collective

    def rank(mesh):
        g = mesh.get_group("sep")
        r = mesh.axis_rank("sep")
        x = torch.arange(3.0) + 10 * r
        y = collective.ppermute(x, g, 1)
        back = collective.ppermute(y, g, -1)
        by_sum = collective.ppermute_by_sum(x, g, 1)
        by_sum_back = collective.ppermute_by_sum(y, g, -1)
        return y, back, by_sum, by_sum_back

    got = _ranks(rank, sep=3)
    for r, (y, back, by_sum, by_sum_back) in enumerate(got):
        mine = torch.arange(3.0) + 10 * r
        assert torch.equal(y, torch.arange(3.0) + 10 * ((r - 1) % 3))
        assert torch.equal(back, mine)
        assert torch.equal(by_sum, y) and torch.equal(by_sum_back, mine)


def test_ulysses_head_divisibility():
    """Heads that the sep degree does not divide raise ``ValueError``, as
    in the JAX package."""
    q, k, v, _ = _inputs(h=3)

    def rank(mesh):
        ts = [torch.from_numpy(a[:, :8].copy()) for a in (q, k, v)]
        with pytest.raises(ValueError, match="not divisible"):
            cp.ulysses_attention(*ts, scale=0.35, causal=True)
        return True

    assert all(_ranks(rank, sep=2))


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sep_degree_1_falls_back(kind):
    """Without a sep axis (no mesh, and a data-only mesh) both functions
    are ``_sdpa_reference``: equal to the JAX package's within 1e-6."""
    q, k, v, _ = _inputs(s=8)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = np.asarray(jax_reference(q, k, v, scale=scale, causal=True))
    fn = cp.ring_attention if kind == "ring" else cp.ulysses_attention
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    got = fn(*ts, scale=scale, causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    got2 = _ranks(lambda mesh: fn(*ts, scale=scale, causal=True).numpy(),
                  dp=2)
    for g in got2:
        np.testing.assert_allclose(g, want, atol=1e-6)


def test_attention_route_takes_the_sep_axis():
    """``scaled_dot_product_attention`` on a sep axis goes to the ring
    (``auto``) or to Ulysses (the flag), before the flash branch; live
    dropout there raises; without a sep axis ``auto`` is the plain
    route."""
    q, k, v, _ = _inputs(s=16)
    scale = 1.0 / np.sqrt(q.shape[-1])
    n = 8

    def rank(mesh):
        j = mesh.axis_rank("sep")
        ts = [torch.from_numpy(a[:, j * n:(j + 1) * n].copy())
              for a in (q, k, v)]
        modes = [attention._seq_parallel_mode()]
        auto = attention.scaled_dot_product_attention(*ts, is_causal=True)
        ring = cp.ring_attention(*ts, scale=scale, causal=True)
        with pytest.raises(NotImplementedError, match="sep axis"):
            attention.scaled_dot_product_attention(*ts, is_causal=True,
                                                   dropout_p=0.1)
        return modes, torch.equal(auto, ring)

    for modes, same in _ranks(rank, sep=2):
        assert modes == ["ring"] and same
    assert attention._seq_parallel_mode() == "none"
    flags.set_flags({"FLAGS_sequence_parallel_mode": "ulysses"})
    try:
        assert attention._seq_parallel_mode() == "ulysses"
    finally:
        flags.set_flags({"FLAGS_sequence_parallel_mode": "auto"})


@pytest.mark.parametrize("local", ["mask", "none"])
def test_local_attention_on_a_sep_axis_raises(local):
    """On a sep axis a rank holds only its block of positions, so attention
    over that block alone is refused by name: with a mask, and with
    ``FLAGS_sequence_parallel_mode=none`` (the JAX package's ``none``
    attends over the whole gathered sequence); without a sep axis both
    take the plain route."""
    q, k, v, _ = _inputs(s=16)
    mask = torch.ones(16, 16, dtype=torch.bool).tril()
    kw = {"attn_mask": mask[:8, :8]} if local == "mask" else {}

    def rank(mesh):
        ts = [torch.from_numpy(a[:, :8].copy()) for a in (q, k, v)]
        with pytest.raises(NotImplementedError, match="sep axis"):
            attention.scaled_dot_product_attention(*ts, **kw)
        return True

    if local == "none":
        flags.set_flags({"FLAGS_sequence_parallel_mode": "none"})
    try:
        assert all(_ranks(rank, sep=2))
        ts = [torch.from_numpy(a) for a in (q, k, v)]
        got = attention.scaled_dot_product_attention(
            *ts, **({"attn_mask": mask} if local == "mask" else
                    {"is_causal": True}))
        want = jax_reference(q, k, v, scale=1.0 / np.sqrt(q.shape[-1]),
                             causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6)
    finally:
        flags.set_flags({"FLAGS_sequence_parallel_mode": "auto"})


# ------------------------------------------------------------------ GPT


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.gpt_tiny(),
                                               device="cpu"), seed=0)


def _data():
    r = np.random.default_rng(0)
    x = r.integers(0, 1024, (4, 64)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _jax_model(arrays):
    m = JaxGPT(jax_gpt_tiny())
    for name, t in m.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m


@pytest.fixture(scope="module")
def jax_run(arrays):
    """The JAX one-device run: the first step's loss gradients, then 2
    AdamW TrainStep losses."""
    x, y = _data()
    m = _jax_model(arrays)
    m.train()
    loss = m(Tensor(x), Tensor(y))
    loss.backward()
    grads = {n: np.asarray(t.grad.numpy())
             for n, t in m.functional_state()[0].items()}
    m = _jax_model(arrays)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=m.parameters())
    step = JaxTrainStep(lambda a, b: m(a, b), opt, layers=m)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
              for _ in range(2)]
    return grads, losses


def _part(name, whole, mesh):
    """The slice of the whole gradient ``name`` a rank of ``mesh`` holds
    (``models.gpt.shard_model``'s rule for ``gpt_tiny``)."""
    su = gpt.sharding_util
    if name.endswith(("attn.qkv.weight", "attn.qkv.bias")):
        return whole[..., su.qkv_columns(4, 32, mesh)]
    if name.endswith("attn.proj.weight"):
        lo, hi = su.head_rows(4, 32, mesh)
        return whole[lo:hi]
    if name.endswith(("mlp.up.weight", "mlp.up.bias")):
        lo, hi = su.split_range(512, mesh)
        return whole[..., lo:hi]
    if name.endswith("mlp.down.weight"):
        lo, hi = su.split_range(512, mesh)
        return whole[lo:hi]
    if name == "gpt.wte.weight":
        lo, hi = su.split_range(1024, mesh)
        return whole[lo:hi]
    return whole


def test_gpt_on_a_sep_axis_matches_jax(arrays, jax_run):
    """``gpt_tiny`` at sep 2 x model 2 x data 2: each rank holds its
    ``[b/2, s/2]`` block of the batch (``shard_batch``), positions offset
    by its sep rank, attention on the ring; the first step's gradients
    (averaged over data x sep) equal the JAX one-device run's slices
    within 1e-4 relative L2, and 2 ``TrainStep``\\ s give its losses
    (rtol 2e-3 / atol 2e-4) and the port's one-rank losses (rtol 1e-5) on
    every rank."""
    jgrads, jlosses = jax_run
    x, y = _data()
    one = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(one, arrays)
    one.train()
    o = AdamW(learning_rate=1e-3, parameters=one.parameters())
    s = TrainStep(lambda a, b: one(a, b), o)
    ones = [float(s(_t(x), _t(y))) for _ in range(2)]

    def rank(mesh):
        m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
        gpt.load_functional_state(m, arrays)
        gpt.shard_model(m, mesh)
        m.train()
        xs, ys = parallel.shard_batch(_t(x)), parallel.shard_batch(_t(y))
        names, params = zip(*m.named_parameters())
        with torch.autograd.set_multithreading_enabled(False):
            g = parallel.sync_gradients(torch.autograd.grad(m(xs, ys),
                                                            params))
        rel = {n: _rel(a.numpy(), _part(n, jgrads[n], mesh))
               for n, a in zip(names, g)}
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        step = TrainStep(lambda a, b: m(a, b), opt)
        return tuple(xs.shape), rel, [float(step(xs, ys)) for _ in range(2)]

    for shape, rel, losses in _ranks(rank, sep=2, mp=2, dp=2):
        assert shape == (2, 32)
        assert max(rel.values()) <= 1e-4, rel
        np.testing.assert_allclose(losses, jlosses, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(losses, ones, rtol=1e-5)


def test_eager_step_through_distributed_model_on_a_sep_axis(arrays,
                                                            jax_run):
    """``fleet.distributed_model`` at sep 2 (data 1) wraps the GPT in
    ``DataParallel``, whose hooks average the eager ``loss.backward()``'s
    gradients over data x sep: every rank's ``.grad`` equals the JAX
    one-device run's within 1e-4 relative L2, and two eager AdamW steps
    give its losses (rtol 2e-3 / atol 2e-4), the same on every rank."""
    from paddle_tpu_torch.distributed import fleet

    jgrads, jlosses = jax_run
    x, y = _data()

    def rank(mesh):
        m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
        gpt.load_functional_state(m, arrays)
        m.train()
        dm = fleet.distributed_model(m)
        opt = AdamW(learning_rate=1e-3, parameters=dm.parameters())
        losses, rel = [], None
        with torch.autograd.set_multithreading_enabled(False):
            for _ in range(2):
                loss = dm(_t(x), _t(y))
                loss.backward()
                if rel is None:
                    rel = {n: _rel(p.grad.numpy(), jgrads[n])
                           for n, p in m.named_parameters()}
                opt.step()
                opt.clear_grad()
                losses.append(float(loss.detach()))
        return type(dm).__name__, rel, losses

    got = _ranks(rank, sep=2)
    for kind, rel, losses in got:
        assert kind == "DataParallel"
        assert max(rel.values()) <= 1e-4, rel
        np.testing.assert_allclose(losses, jlosses, rtol=2e-3, atol=2e-4)
        assert losses == got[0][2]


def test_shard_batch_and_groups_span_the_sep_axis():
    """``shard_batch`` gives a rank its rows and its block of positions
    (tagged for dropout boxes on both dims); ``data_group`` is the
    ``data_sep`` group of data x sep ranks; the mesh's pipe and sep
    queries read the real axes; the expert axis still raises, naming the
    MoE item."""
    t = torch.arange(4 * 8).reshape(4, 8)

    def rank(mesh):
        part = parallel.shard_batch(t)
        g = parallel.data_group()
        hcg = mesh_mod.HybridCommunicateGroup(mesh)
        return (part, parallel.batch_box([part]), g.size(), g.rank(),
                hcg.get_sep_parallel_world_size(),
                hcg.get_sep_parallel_rank())

    for r, (part, box, size, grank, sepw, sepr) in enumerate(
            _ranks(rank, sep=2, dp=2)):
        d, j = r // 2, r % 2
        assert torch.equal(part, t[2 * d:2 * d + 2, 4 * j:4 * j + 4])
        assert box == {0: (2 * d, 4, 2), 1: (4 * j, 8, 4)}
        assert (size, grank, sepw, sepr) == (4, 2 * d + j, 2, j)
    with pytest.raises(NotImplementedError, match="1i"):
        mesh_mod.init_hybrid_mesh(expert=2, rank=0, world_size=2,
                                  backend="gloo")


@pytest.mark.parametrize("name", ["distributed/context_parallel.py",
                                  "distributed/pipeline.py",
                                  "distributed/collective.py",
                                  "nn/stacked.py",
                                  "distributed/fleet/meta_parallel/"
                                  "pp_layers.py",
                                  "distributed/fleet/meta_parallel/"
                                  "pipeline_parallel.py"])
def test_new_modules_import_no_jax(name):
    """The modules this slice added import neither jax nor the JAX
    package."""
    tree = ast.parse((ROOT / "paddle_tpu_torch" / name).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "paddle_tpu")]
