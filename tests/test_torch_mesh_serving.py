"""Tensor-parallel serving of the port against the JAX package's mesh
engine (the port's counterpart of ``tests/test_mesh_serving.py:106-346``).

The JAX engine serves on ``serving_mesh(4)`` over conftest's 8 virtual CPU
devices; the port serves the same numpy-seeded ``gpt_tiny`` f32 weights
(4 heads of 32) at tp = 2 and tp = 4, its ranks as threads of this process
over gloo groups on an in-process ``HashStore`` (``launch="thread"``): rank
0 drives ``ServingAPI``, the followers replay its programs on their shards.

* Greedy tokens, and seeded sampled tokens, equal the JAX mesh engine's
  and the port's one-rank engine's token for token, in every scenario of
  the JAX file: decode, a prefix hit, lockstep speculation, int8 weights
  with the int8 arena, a LoRA adapter, seeded sampling. The row-parallel
  sums reassociate float reductions, so the tokens are held, not the
  logits (as the JAX file does).
* Churn builds nothing, on every rank; a rebuild and replay is
  token-identical and builds nothing; tp = 1 is bit-identical to no mesh
  yet keys apart; an explicit ``ServingConfig.mesh`` reaches the arena,
  the int8 weights and the adapters; at tp = 4 each rank holds at most
  0.55 of the one-rank engine's weight and arena bytes.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from paddle_tpu.distributed.mesh import serving_mesh as jax_serving_mesh
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LoraAdapter as JaxLoraAdapter
from paddle_tpu.serving import RequestState as JaxRequestState
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingAPI as JaxServingAPI
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.core import flags, resilience
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (LoraAdapter, RequestState,
                                      SamplingParams, ServingAPI,
                                      ServingConfig)

torch.set_num_threads(1)

MAX_LEN = 128
CFG = dict(num_slots=4, kv_block_size=16, max_model_len=MAX_LEN)
JAX_MP = 4   # the JAX reference's model axis (8 virtual devices)
TPS = (2, 4)


@pytest.fixture(autouse=True)
def _no_port_mesh():
    mesh_mod.clear_mesh()
    yield
    mesh_mod.clear_mesh()


@pytest.fixture(scope="module")
def arrays():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    return gpt.seeded_state(model, seed=0)


def _port_model(arrays):
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(model, arrays)
    return model


def _jax_model(arrays):
    """The JAX GPT on the same arrays, built under the installed mesh: a
    parameter the mesh placed keeps its sharding, the rest stay
    uncommitted."""
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    for name, t in m.functional_state()[0].items():
        a = jnp.asarray(arrays[name])
        sh = t._data.sharding
        t._data = (jax.device_put(a, sh) if isinstance(sh, NamedSharding)
                   else a)
    return m


def _mesh(tp):
    return mesh_mod.serving_mesh(tp, backend="gloo", launch="thread",
                                 install=False)


# ------------------------------------------------------------ scenarios


def _workload(rng, n=5, max_new=8):
    lens = [8, 12, 20, 7, 16]
    return [(rng.integers(0, 1024, (lens[i % len(lens)],)), max_new)
            for i in range(n)]


def _prefix_workload():
    rng = np.random.default_rng(2)
    sys_p = rng.integers(0, 1024, (32,))
    return [(np.concatenate([sys_p, rng.integers(0, 1024, (6,))]), 8)
            for _ in range(4)]


_SAMPLED = dict(temperature=0.8, top_k=40, seed=123)

#: the JAX file's scenarios: workload, engine config, per-request kwargs
SCENARIOS = {
    "decode": (lambda: _workload(np.random.default_rng(0)), {}, None),
    "prefix": (_prefix_workload, {"prefix_cache": True}, None),
    "spec": (lambda: _workload(np.random.default_rng(3), n=4),
             {"spec_k": 2}, None),
    "quant": (lambda: _workload(np.random.default_rng(4), n=4),
              {"quant_weights": True, "quant_kv": True}, None),
    "lora": (lambda: _workload(np.random.default_rng(5), n=3),
             {"lora_rank": 4}, ["adapter", None, "adapter"]),
    "sampling": (lambda: _workload(np.random.default_rng(6), n=3), {},
                 ["sampled", None, "sampled"]),
}


def _kw(tag, aid, sampling_cls):
    if tag == "adapter":
        return {"adapter": aid}
    if tag == "sampled":
        return {"sampling": sampling_cls(**_SAMPLED)}
    return {}


def _serve_jax(arrays, name):
    make, cfg, tags = SCENARIOS[name]
    work = make()
    jax_serving_mesh(JAX_MP)
    model = _jax_model(arrays)
    api = JaxServingAPI(model, JaxServingConfig(**CFG, **cfg))
    try:
        aid = 0
        if cfg.get("lora_rank"):
            aid = api.register_adapter(JaxLoraAdapter.random(
                model.cfg, rank=4, seed=7, scale=0.25, name="m"))
        kws = [_kw(t, aid, JaxSamplingParams) for t in tags or
               [None] * len(work)]
        reqs = [api.submit(p.astype(np.int32), max_new_tokens=n, **kw)
                for (p, n), kw in zip(work, kws)]
        api.run_until_idle()
        assert all(r.state == JaxRequestState.FINISHED for r in reqs)
        assert api.engine.stats()["mesh.key"] == (("model", JAX_MP),)
        return [np.asarray(r.output_ids(), np.int64) for r in reqs]
    finally:
        api.close()


def _serve_port(arrays, name, mesh=None, **extra):
    """Serve scenario ``name`` on the port (``mesh`` None: one rank, no
    mesh). Returns the tokens, rank 0's stats and its engine's report of
    every rank: ``[(weight bytes, arena bytes, local heads)]``."""
    make, cfg, tags = SCENARIOS[name]
    work = make()
    model = _port_model(arrays)
    api = ServingAPI(model, ServingConfig(**CFG, **cfg, **extra, mesh=mesh),
                     device="cpu")
    try:
        aid = 0
        if cfg.get("lora_rank"):
            aid = api.register_adapter(LoraAdapter.random(
                gpt.gpt_tiny(), rank=4, seed=7, scale=0.25, name="m"))
        kws = [_kw(t, aid, SamplingParams) for t in tags or
               [None] * len(work)]
        reqs = [api.submit(p, max_new_tokens=n, **kw)
                for (p, n), kw in zip(work, kws)]
        api.run_until_idle()
        assert all(r.state == RequestState.FINISHED for r in reqs), \
            [(r.state, r.error) for r in reqs]
        eng = api.engine
        ranks = [(_bytes(model), eng.arena.bytes_total(),
                  int(eng.arena.pools[0][0].shape[2]))]
        if eng._tp is not None:
            ranks += [(r["weight_bytes"], r["arena_bytes"], r["local_heads"])
                      for r in eng._tp.stats()]
        return [r.output_ids() for r in reqs], eng.stats(), ranks
    finally:
        api.close()


def _bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


_REFS = {}


def _refs(arrays, name):
    """The JAX mesh engine's and the port's one-rank engine's tokens of
    scenario ``name`` (computed once)."""
    if name not in _REFS:
        jax_out = _serve_jax(arrays, name)
        port_out, stats, ranks = _serve_port(arrays, name)
        assert stats["mesh.key"] is None
        for a, b in zip(jax_out, port_out):
            np.testing.assert_array_equal(a, b)
        _REFS[name] = (port_out, ranks[0])
    return _REFS[name]


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_token_parity_with_jax_mesh_engine(arrays, name, tp):
    """Every scenario's tokens at tp equal the JAX ``serving_mesh(4)``
    engine's and the one-rank engine's, token for token; every rank's KV
    pools hold ``H // tp`` heads."""
    ref, _ = _refs(arrays, name)
    outs, stats, ranks = _serve_port(arrays, name, _mesh(tp))
    assert stats["mesh.key"] == (("model", tp),)
    assert stats["arena.mesh"] == (("model", tp),)
    assert stats["kernel.route"] == f"plain@model{tp}"
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    assert [heads for _, _, heads in ranks] == [4 // tp] * tp
    if name == "spec":
        assert stats["spec.mode"] == "lockstep" and stats["spec.emitted"] > 0
    if name == "prefix":
        assert stats["prefix.hits"] >= 3
    if name == "quant":
        assert stats["quant.weights"] == 1 and stats["quant.kv"] == 1


def test_per_rank_share_at_tp4(arrays):
    """Tensor parallelism is real: at tp = 4 every rank holds at most 0.55
    of the one-rank engine's weight and arena bytes (the unsplit remainder
    -- positions, LayerNorms, the row linears' biases -- keeps it above a
    quarter)."""
    _, (w1, a1, _) = _refs(arrays, "decode")
    _, _, ranks = _serve_port(arrays, "decode", _mesh(4))
    assert len(ranks) == 4
    for w, a, _ in ranks:
        assert w + a <= 0.55 * (w1 + a1), (w, a, w1, a1)


def test_zero_new_programs_under_churn_on_every_rank(arrays):
    """Admit/retire churn on a live tp = 2 mesh is data: one decode
    program, one per prefill bucket, on rank 0 and on the follower alike,
    and a clean arena at the end."""
    work = _workload(np.random.default_rng(1), n=8, max_new=6)
    api = ServingAPI(_port_model(arrays), ServingConfig(**CFG, mesh=_mesh(2)),
                     device="cpu")
    try:
        reqs = [api.submit(p, max_new_tokens=n) for p, n in work]
        api.run_until_idle()
        assert all(r.state == RequestState.FINISHED for r in reqs)
        eng = api.engine
        st = eng.stats()
        assert st["decode_traces"] == 1
        assert all(v == 1 for v in eng.prefill_traces.values())
        assert st["arena.blocks_in_use"] == 0
        assert st["arena.blocks_reserved"] == 0
        assert st["arena.mesh"] == (("model", 2),)
        (follower,) = eng._tp.stats()
        assert follower["programs"] == sorted(map(str, eng._graphs.programs))
    finally:
        api.close()


def test_supervisor_rebuild_replay_on_mesh(arrays):
    """A transient device failure on a tp = 2 mesh: rank 0 rebuilds, the
    follower rebuilds with it, every journal replays, no program is built
    again, and the tokens equal the undisturbed one-rank engine's."""
    work = _workload(np.random.default_rng(8), n=3)
    ref = []
    api = ServingAPI(_port_model(arrays), ServingConfig(**CFG), device="cpu")
    try:
        ref = [api.submit(p, max_new_tokens=n) for p, n in work]
        api.run_until_idle()
        ref = [r.output_ids() for r in ref]
    finally:
        api.close()
    keep = flags.flag("fault_injection")
    flags.set_flags({"fault_injection": 1})
    api = ServingAPI(_port_model(arrays), ServingConfig(**CFG, mesh=_mesh(2)),
                     device="cpu")
    try:
        resilience.inject_fault("serving_device", times=1, after=6)
        reqs = [api.submit(p, max_new_tokens=n) for p, n in work]
        api.run_until_idle()
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert api.supervisor.rebuild_count == 1
        assert api.supervisor.replay_count >= 1
        assert api.engine.decode_traces == 1
        (follower,) = api.engine._tp.stats()
        assert follower["programs"] == sorted(
            map(str, api.engine._graphs.programs))
        for a, r in zip(ref, reqs):
            np.testing.assert_array_equal(a, r.output_ids())
    finally:
        api.close()
        resilience.clear_faults()
        flags.set_flags({"fault_injection": keep})


def test_one_rank_mesh_bit_identical_yet_keyed_apart(arrays):
    """tp = 1 runs the same ops (its collectives are identities): the
    tokens and every decode step's logits equal the engine without a
    mesh bit for bit, while the mesh key, the arena's mesh and the tier
    signature tell them apart."""
    def run(mesh):
        model = _port_model(arrays)
        api = ServingAPI(model, ServingConfig(**CFG, mesh=mesh, prefix_cache=True,
                                              kv_tiering=True),
                         device="cpu")
        logits = []
        head = model._head_logits

        def spy(h):
            out = head(h)
            logits.append(out.detach().clone())
            return out
        model._head_logits = spy
        try:
            reqs = [api.submit(p, max_new_tokens=n) for p, n in
                    _workload(np.random.default_rng(9), n=4)]
            api.run_until_idle()
            return ([r.output_ids() for r in reqs], logits, api.engine.stats(),
                    api.engine.tier.signature)
        finally:
            api.close()

    ref, ref_logits, ref_stats, ref_sig = run(None)
    out, logits, stats, sig = run(
        mesh_mod.serving_mesh(1, backend="gloo", install=False))
    assert ref_stats["mesh.key"] is None and ref_stats["arena.mesh"] is None
    assert stats["mesh.key"] == (("data", 1),)
    assert stats["arena.mesh"] == (("data", 1),)
    assert sig == ref_sig + ((1, 0),)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    assert len(logits) == len(ref_logits)
    assert all(torch.equal(a, b) for a, b in zip(ref_logits, logits))


def test_explicit_config_mesh_threads_everywhere(arrays):
    """An explicit ``ServingConfig.mesh`` wins over the installed one and
    reaches every engine-placed piece: the int8 weights (quantized whole,
    then split: a column linear's scale split with its columns, a row
    linear's whole), the arena, the adapter pools (shaped as each layer's
    shard) and the tier signature."""
    mesh_mod.serving_mesh(1, backend="gloo")  # installed, and ignored
    mesh = _mesh(2)
    model = _port_model(arrays)
    cfg = ServingConfig(**CFG, quant_weights=True, quant_kv=True,
                        lora_rank=4, prefix_cache=True, kv_tiering=True,
                        mesh=mesh)
    api = ServingAPI(model, cfg, device="cpu")
    try:
        eng = api.engine
        assert eng.mesh is mesh and eng.arena.mesh is mesh
        qkv = model.gpt.layers[0].attn.qkv
        proj = model.gpt.layers[0].attn.proj
        assert isinstance(qkv, ColumnParallelLinear)
        assert isinstance(proj, RowParallelLinear)
        assert isinstance(model.gpt.wte, VocabParallelEmbedding)
        assert qkv.weight.dtype == torch.int8
        assert tuple(qkv.weight.shape) == (128, 192)
        assert tuple(qkv.weight_scale.shape) == (1, 192)
        assert tuple(proj.weight.shape) == (64, 128)
        assert tuple(proj.weight_scale.shape) == (1, 128)
        site = eng.lora.site_of(qkv)
        assert tuple(eng.lora.pools(site)[1].shape[1:]) == (4, 192)
        site = eng.lora.site_of(proj)
        assert tuple(eng.lora.pools(site)[0].shape[1:]) == (64, 4)
        assert eng.arena.pools[0][0].shape[2] == 2
        assert eng.arena.pools[0][2].shape == eng.arena.pools[0][0].shape[:2]
        assert eng.tier.signature[-1] == (2, 0)
        aid = api.register_adapter(LoraAdapter.random(
            gpt.gpt_tiny(), rank=4, seed=7, scale=0.25, name="m"))
        r = api.submit(np.arange(8) + 1, max_new_tokens=4, adapter=aid)
        api.run_until_idle()
        assert r.state == RequestState.FINISHED
    finally:
        api.close()


def test_generate_on_a_mesh(arrays):
    """``generate()`` (the JAX file's runner-cache test): the port's
    ``generate()`` runs eagerly, with no runner to key, so a model sharded
    over a one-rank mesh generates what the whole model does, bit for
    bit; over two ranks (threads, each calling it) every rank generates
    the whole model's tokens."""
    ids = np.random.default_rng(10).integers(0, 1024, (1, 8))
    whole = _port_model(arrays)
    want = whole.generate(ids, max_new_tokens=4)
    one = _port_model(arrays)
    mesh = mesh_mod.serving_mesh(1, backend="gloo", install=False)
    mesh.open()
    mesh.connect()
    gpt.shard_model(one, mesh)
    assert torch.equal(one.generate(ids, max_new_tokens=4), want)
    root = mesh_mod.serving_mesh(2, backend="gloo", launch="thread",
                                 install=False)
    root.open()
    meshes = [root, root.peer(1)]
    got = [None, None]

    def rank(r):
        meshes[r].connect()
        two = _port_model(arrays)
        gpt.shard_model(two, meshes[r])
        got[r] = two.generate(ids, max_new_tokens=4)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for g in got:
        assert g is not None and torch.equal(g, want)
