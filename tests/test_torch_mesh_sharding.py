"""The sharding rules, the parallel layers and the kernels at local heads of
the port's tensor-parallel serving, against numpy references and the JAX
package's mesh kernels (``paddle_tpu/distributed/sharding_util.py``,
``paddle_tpu/ops/paged_attention.py`` ``_sharded_decode`` /
``_sharded_prefill``, run in the Pallas interpreter on conftest's 8
virtual CPU devices), and the mesh's edges: the data axis, the tier
signature's layout, the int8 arena's whole-row scales and a follower that
dies.

Tolerances: the kernels' plain versions at local heads against the JAX
kernels on the mesh as ``tests/test_paged_kernel.py::_tol`` (5e-6 f32,
2e-2 bf16); the parallel layers against numpy in f32 within 1e-5.
"""
import copy
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import quantization as jax_quantization
from paddle_tpu.distributed.mesh import serving_mesh as jax_serving_mesh
from paddle_tpu.ops import paged_attention as jpk
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed import sharding_util
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import (HostKVCache, RequestState, ServingAPI,
                                      ServingConfig, tp)

torch.set_num_threads(1)

CFG = dict(num_slots=4, kv_block_size=16, max_model_len=128)


@pytest.fixture(autouse=True)
def _no_port_mesh():
    mesh_mod.clear_mesh()
    yield
    mesh_mod.clear_mesh()


def _rank_mesh(mp, rank):
    """Rank ``rank``'s view of an ``mp``-rank mesh (no group: the rules
    only)."""
    return mesh_mod.ServingMesh(mp, backend="gloo", rank=rank)


def _tol(dtype):
    return dict(atol=5e-6, rtol=5e-6) if dtype == "float32" \
        else dict(atol=2e-2, rtol=2e-2)


def _tiny(seed=0):
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(model, gpt.seeded_state(model, seed=seed))
    return model


# ------------------------------------------------------------------ rules


@pytest.mark.parametrize("mp", [2, 4])
def test_qkv_split_takes_each_of_q_k_v_by_heads(mp):
    """The fused qkv weight is ``[in, 3h]`` laid out ``[3, H, D]``: a rank
    holds its heads of each of q, k and v (never one contiguous third),
    and the output projection's rows of the same heads."""
    H, D, fin = 8, 16, 24
    w = np.random.default_rng(0).standard_normal((fin, 3 * H * D))
    for r in range(mp):
        m = _rank_mesh(mp, r)
        nh = H // mp
        want = w.reshape(fin, 3, H, D)[:, :, r * nh:(r + 1) * nh]
        got = w[:, sharding_util.qkv_columns(H, D, m)]
        np.testing.assert_array_equal(got, want.reshape(fin, -1))
        assert sharding_util.head_rows(H, D, m) == (r * nh * D,
                                                    (r + 1) * nh * D)
        assert sharding_util.local_heads(H, m) == nh
    # heads that do not divide the ranks stay whole on every rank
    m = _rank_mesh(mp, mp - 1)
    assert sharding_util.local_heads(6 if mp == 4 else 5, m) \
        == (6 if mp == 4 else 5)
    assert sharding_util.split_range(10 if mp == 4 else 9, m) \
        == (0, 10 if mp == 4 else 9)


@pytest.mark.parametrize("mp", [2, 4])
def test_int8_weights_quantized_whole_then_split(mp):
    """``quantize_serving_weights`` quantizes the whole weights, then
    splits them: a column shard's payload and scale are the JAX
    quantizer's at its columns, a row shard's payload its rows and its
    scale the whole weight's. A row slice quantized alone would take other
    scales (the reason for the order)."""
    model = _tiny()
    lin_up = copy.deepcopy(model.gpt.layers[0].mlp.up)
    lin_down = copy.deepcopy(model.gpt.layers[0].mlp.down)
    q_up, s_up = jax_quantization.quantize_weight(
        lin_up.weight.detach().numpy(), channel_axis=1)
    q_down, s_down = jax_quantization.quantize_weight(
        lin_down.weight.detach().numpy(), channel_axis=1)
    mesh = _rank_mesh(mp, 1)
    gpt.quantize_serving_weights(model, mesh=mesh)
    up = model.gpt.layers[0].mlp.up
    down = model.gpt.layers[0].mlp.down
    assert isinstance(up, ColumnParallelLinear)
    assert isinstance(down, RowParallelLinear)
    lo, hi = sharding_util.split_range(512, mesh)
    np.testing.assert_array_equal(up.weight.numpy(), q_up[:, lo:hi])
    np.testing.assert_array_equal(up.weight_scale.numpy(), s_up[:, lo:hi])
    np.testing.assert_array_equal(down.weight.numpy(), q_down[lo:hi])
    np.testing.assert_array_equal(down.weight_scale.numpy(), s_down)
    _, alone = jax_quantization.quantize_weight(
        lin_down.weight.detach().numpy()[lo:hi], channel_axis=1)
    assert not np.array_equal(alone, s_down)
    with pytest.raises(ValueError, match="whole weights"):
        gpt.quantize_serving_weights(_split_unquantized(mp))


def _split_unquantized(mp):
    model = _tiny()
    gpt.shard_model(model, _rank_mesh(mp, 0))
    return model


def test_shard_kv_entry_rule():
    """Payload pools keep the local heads, the int8 scale pools stay
    whole, heads that do not divide stay whole (the JAX guard)."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((5, 4, 8, 16)).astype(np.float32)
    scales = rng.standard_normal((5, 4)).astype(np.float32)
    for r in range(4):
        out = sharding_util.shard_kv_entry((k, k, scales, scales),
                                           _rank_mesh(4, r))
        np.testing.assert_array_equal(out[0], k[:, :, 2 * r:2 * r + 2])
        assert out[2] is scales and out[3] is scales
    k6 = rng.standard_normal((5, 4, 6, 16)).astype(np.float32)
    assert sharding_util.shard_kv_entry((k6, k6), _rank_mesh(4, 2))[0] is k6
    assert sharding_util.mesh_axes_key(None) is None
    assert sharding_util.mesh_axes_key(_rank_mesh(1, 0)) == (("data", 1),)
    assert sharding_util.mesh_axes_key(_rank_mesh(4, 0)) == (("model", 4),)


@pytest.mark.parametrize("mp", [2, 4])
def test_parallel_layers_against_numpy(mp):
    """The vocab-parallel lookup and tied head, an untied head (a column
    linear gathered whole), a column / row pair, and ``broadcast`` /
    ``all_gather``, over ``mp`` ranks (threads on a gloo group) against
    the whole numpy computation: every rank gets the whole result."""
    rng = np.random.default_rng(4)
    V, h, inter = 64, 16, 32
    emb = rng.standard_normal((V, h)).astype(np.float32)
    w1 = rng.standard_normal((h, inter)).astype(np.float32)
    b1 = rng.standard_normal(inter).astype(np.float32)
    w2 = rng.standard_normal((inter, h)).astype(np.float32)
    b2 = rng.standard_normal(h).astype(np.float32)
    ids = rng.integers(0, V, (3, 5))
    x = rng.standard_normal((3, 5, h)).astype(np.float32)
    want_emb = emb[ids]
    want_mlp = (x @ w1 + b1) @ w2 + b2
    want_logits = x @ emb.T

    whole_emb = gpt.Embedding(V, h)
    whole_emb.weight.data = torch.from_numpy(emb)
    up, down = gpt.Linear(h, inter), gpt.Linear(inter, h)
    up.weight.data, up.bias.data = torch.from_numpy(w1), torch.from_numpy(b1)
    down.weight.data = torch.from_numpy(w2)
    down.bias.data = torch.from_numpy(b2)
    lm_head = gpt.Linear(h, V, bias=False)
    lm_head.weight.data = torch.from_numpy(np.ascontiguousarray(emb.T))

    root = mesh_mod.serving_mesh(mp, backend="gloo", launch="thread",
                                 install=False)
    root.open()
    meshes = [root] + [root.peer(r) for r in range(1, mp)]
    out, errors = {}, []

    def rank(r):
        try:
            m = meshes[r]
            m.connect()
            lo, hi = sharding_util.split_range(inter, m)
            e = VocabParallelEmbedding.from_embedding(whole_emb, m)
            c = ColumnParallelLinear.from_linear(up, m, np.arange(lo, hi))
            rw = RowParallelLinear.from_linear(down, m, (lo, hi))
            head = ColumnParallelLinear.from_linear(
                lm_head, m, np.arange(*sharding_util.split_range(V, m)),
                gather_output=True)
            b = torch.full((3,), float(r + 1))
            collective.broadcast(b, mp - 1, m.group)
            gathered = [torch.zeros(2) for _ in range(mp)]
            collective.all_gather(gathered, torch.full((2,), float(r)),
                                  m.group)
            with torch.no_grad():
                xt = torch.from_numpy(x)
                out[r] = (e(torch.from_numpy(ids)).numpy(),
                          rw(c(xt)).numpy(), e.logits(xt).numpy(),
                          head(xt).numpy(), b.numpy(),
                          torch.stack(gathered).numpy())
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(mp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    for r in range(mp):
        np.testing.assert_array_equal(out[r][0], want_emb)
        np.testing.assert_allclose(out[r][1], want_mlp, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out[r][2], want_logits, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[r][3], want_logits, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(out[r][4], np.full(3, float(mp)))
        np.testing.assert_array_equal(
            out[r][5], np.repeat(np.arange(mp, dtype=np.float32)[:, None], 2,
                                 axis=1))


# ---------------------------------------------------------------- kernels


def _pools(rng, nb, bs, h, d, dtype="float32", quantized=False):
    kf = jnp.asarray(rng.standard_normal((nb, bs, h, d)), dtype)
    vf = jnp.asarray(rng.standard_normal((nb, bs, h, d)), dtype)
    if not quantized:
        return (kf, vf)
    kq, ks = jax_quantization.quantize_kv(kf)
    vq, vs = jax_quantization.quantize_kv(vf)
    return (kq, vq, ks, vs)


def _t(a):
    """A JAX array as a torch tensor of the same dtype and values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _by_rank(fn, q, entry, mp):
    """``fn`` at each rank's local heads of ``q`` and the pools, the
    ranks' outputs joined along the heads."""
    outs = []
    for r in range(mp):
        m = _rank_mesh(mp, r)
        local = sharding_util.shard_kv_entry(entry, m)
        nh = local[0].shape[2]
        lo = r * nh if nh < q.shape[1] else 0
        outs.append(fn(q[:, lo:lo + nh], local))
        if nh == q.shape[1]:
            return outs[0]  # heads held whole: every rank computes all
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True], ids=["full", "int8"])
def test_decode_at_local_heads_matches_jax_sharded_kernel(dtype, quantized):
    """The plain decode at each rank's 2 local heads of 8 equals the JAX
    decode kernel on ``serving_mesh(4)`` (``_sharded_decode``, in the
    Pallas interpreter)."""
    mesh = jax_serving_mesh(4, install=False)
    rng = np.random.default_rng(9)
    S, H, D, NB, bs, MB = 4, 8, 32, 17, 8, 4
    entry = _pools(rng, NB, bs, H, D, dtype, quantized)
    q = jnp.asarray(rng.standard_normal((S, H, D)), dtype)
    bt = jnp.asarray(rng.integers(1, NB, (S, MB)), jnp.int32)
    pos = jnp.asarray([0, 7, 19, 31], jnp.int32)
    want = jpk.paged_decode_attention(q, entry, bt, pos, mesh=mesh)
    got = _by_rank(lambda ql, el: pa.paged_decode_attention(
        ql, el, _t(bt), _t(pos)), _t(q), tuple(_t(a) for a in entry), 4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("quantized", [False, True], ids=["full", "int8"])
def test_prefill_at_local_heads_matches_jax_sharded_kernel(quantized):
    """The plain suffix prefill at local heads against ``_sharded_prefill``
    at several runtime prefix lengths, and the full prefill's
    pseudo-table form at prefix 0."""
    mesh = jax_serving_mesh(4, install=False)
    rng = np.random.default_rng(10)
    sq, H, D, NB, bs, MB = 16, 8, 32, 19, 8, 6
    entry = _pools(rng, NB, bs, H, D, "float32", quantized)
    q = jnp.asarray(rng.standard_normal((sq, H, D)), jnp.float32)
    bt_row = jnp.asarray(rng.permutation(np.arange(1, MB + 1)), jnp.int32)
    tentry = tuple(_t(a) for a in entry)
    for prefix in (0, 5, 31):
        want = jpk.paged_prefill_attention(q, entry, bt_row, prefix,
                                           mesh=mesh)
        got = _by_rank(lambda ql, el: pa.paged_prefill_attention(
            ql, el, _t(bt_row), prefix), _t(q), tentry, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"prefix={prefix}",
                                   **_tol("float32"))
    k = jnp.asarray(rng.standard_normal((sq, H, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((sq, H, D)), jnp.float32)
    want = jpk.paged_full_prefill_attention(q, k, v, bs, mesh=mesh)
    got = _by_rank(lambda ql, el: pa.paged_full_prefill_attention(
        ql, el[0][0], el[1][0], bs), _t(q),
        (_t(k)[None], _t(v)[None]), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol("float32"))


def test_nondivisible_heads_run_whole_on_every_rank():
    """6 heads over 4 ranks: every rank holds and attends all of them (the
    JAX wrapper replicates its specs), equal to the JAX mesh kernel."""
    mesh = jax_serving_mesh(4, install=False)
    rng = np.random.default_rng(11)
    S, H, D, NB, bs, MB = 3, 6, 16, 9, 4, 3
    entry = _pools(rng, NB, bs, H, D)
    q = jnp.asarray(rng.standard_normal((S, H, D)), jnp.float32)
    bt = jnp.asarray(rng.integers(1, NB, (S, MB)), jnp.int32)
    pos = jnp.asarray([2, 7, 11], jnp.int32)
    want = jpk.paged_decode_attention(q, entry, bt, pos, mesh=mesh)
    got = _by_rank(lambda ql, el: pa.paged_decode_attention(
        ql, el, _t(bt), _t(pos)), _t(q), tuple(_t(a) for a in entry), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol("float32"))


# ------------------------------------------------------------------ edges


def test_data_axis_and_an_unnamed_backend_are_refused():
    """The JAX data axis (the slot batch sharded inside one engine, which
    the JAX package serves on a data-only mesh) is not ported: ``data >
    1`` raises ``NotImplementedError`` naming ROADMAP.md. The backend is
    always the caller's to name."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mesh_mod.serving_mesh(2, data=2, backend="gloo")
    with pytest.raises(NotImplementedError):
        mesh_mod.serving_mesh(1, data=2, backend="nccl")
    with pytest.raises(TypeError):
        mesh_mod.serving_mesh(2)  # noqa: the backend is keyword-only
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.serving_mesh(2, backend="mpi")
    assert mesh_mod.get_mesh() is None
    m = mesh_mod.serving_mesh(2, backend="gloo")
    assert mesh_mod.get_mesh() is m and mesh_mod.axis_size("model") == 2
    assert mesh_mod.axis_size("data") == 1 and not m.capturable
    assert mesh_mod.serving_mesh(1, backend="nccl", install=False).capturable


def test_engine_refuses_a_shard_it_cannot_serve():
    """A model already split over a mesh of two ranks serves on no other
    engine: its followers load the whole model. Its ``generate()`` runs
    over its own mesh's model group, which this mesh never formed."""
    model = _tiny()
    gpt.shard_model(model, _rank_mesh(2, 0))
    with pytest.raises(ValueError, match="sharded"):
        ServingAPI(model, ServingConfig(**CFG), device="cpu")
    with pytest.raises(RuntimeError, match="not formed"):
        model.generate(np.arange(4)[None], max_new_tokens=2)


def _tier_serve(store, mesh, prompt):
    api = ServingAPI(_tiny(), ServingConfig(**CFG, prefix_cache=True,
                                            kv_tiering=True, tier_store=store,
                                            mesh=mesh), device="cpu")
    try:
        r = api.submit(prompt, max_new_tokens=6)
        api.run_until_idle()
        assert r.state == RequestState.FINISHED
        st = api.engine.stats()
        return r.output_ids(), st["tier.restored_blocks"], \
            api.engine.tier.namespace
    finally:
        api.close()


def test_tier_entries_of_a_rank_never_restore_into_another_layout():
    """A tp = 2 rank's tier entries hold its half-head rows: a second tp = 2
    engine on the same store restores them (every rank its own), while a
    tp = 1 engine and one without a mesh find nothing to restore; all four
    emit the same tokens."""
    store = HostKVCache(max_bytes=1 << 26, disk_dir="")
    prompt = np.random.default_rng(12).integers(0, 1024, (40,))

    def tp2():
        return mesh_mod.serving_mesh(2, backend="gloo", launch="thread",
                                     install=False)

    first, restored, ns2 = _tier_serve(store, tp2(), prompt)
    assert restored == 0
    again, restored, _ = _tier_serve(store, tp2(), prompt)
    assert restored == 2  # the prompt's two full blocks, on both ranks
    one, restored1, ns1 = _tier_serve(
        store, mesh_mod.serving_mesh(1, backend="gloo", install=False),
        prompt)
    none, restored0, ns0 = _tier_serve(store, None, prompt)
    assert restored1 == 0 and restored0 == 0
    assert len({ns2, ns1, ns0}) == 3
    for out in (again, one, none):
        np.testing.assert_array_equal(first, out)


def test_int8_arena_scales_are_whole_rows_on_every_rank():
    """The int8 arena's per-row scales are the whole row's absmax on every
    rank (a max over the model group before quantizing), so every rank
    holds the same scale pools."""
    mesh = mesh_mod.serving_mesh(2, backend="gloo", launch="thread",
                                 install=False)
    api = ServingAPI(_tiny(), ServingConfig(**CFG, quant_kv=True, mesh=mesh),
                     device="cpu")
    try:
        r = api.submit(np.arange(20) + 3, max_new_tokens=5)
        api.run_until_idle()
        assert r.state == RequestState.FINISHED
        (follower,) = api.engine._tp.stats()
        mine = tp.scale_digest(api.engine.arena)
        assert mine is not None and follower["scale_digest"] == mine
    finally:
        api.close()


def test_a_follower_that_dies_fails_the_pending_requests():
    """A spawned follower process killed with requests pending: rank 0's next
    operation raises ``FollowerDiedError`` (a ``ServingDeviceError``; the
    supervisor's rebuild meets the dead rank too), every pending request
    fails with it, well inside the mesh's timeout, and
    ``close()`` reaps the process and removes the weights file."""
    mesh = mesh_mod.serving_mesh(2, backend="gloo", launch="process",
                                 timeout=20.0, install=False)
    api = ServingAPI(_tiny(), ServingConfig(**CFG, mesh=mesh), device="cpu")
    leader = api.engine._tp
    try:
        (report,) = api.engine.follower_reports
        assert report["rank"] == 1 and report["local_heads"] == 2
        assert not report["modules"]  # the follower imported no JAX
        warm = api.submit(np.arange(8) + 1, max_new_tokens=3)
        api.run_until_idle()
        assert warm.state == RequestState.FINISHED
        reqs = [api.submit(np.arange(n) + 5, max_new_tokens=40)
                for n in (9, 13)]
        os.kill(report["pid"], signal.SIGKILL)
        leader.followers[0].worker.join(10)
        t0 = time.monotonic()
        with pytest.raises(tp.FollowerDiedError):
            api.run_until_idle()  # fails every request, then raises
        assert time.monotonic() - t0 < 20.0
        assert all(r.state == RequestState.FAILED for r in reqs)
        assert all(isinstance(r.error, tp.FollowerDiedError) for r in reqs), \
            [repr(r.error) for r in reqs]
    finally:
        api.close()
    assert not leader.followers[0].worker.is_alive()
    assert leader._weights_dir is None


def test_rank0_waits_for_a_slow_answer_within_the_timeout():
    """Rank 0's control receive polls until its deadline: a follower that
    answers after many polls (a bf16 model still loading) is waited for,
    one that never answers fails within the mesh's timeout, and a dead
    one at once."""
    import pickle
    import queue

    def leader(answer_after=None, alive=True, timeout=5.0):
        to_f, from_f = queue.Queue(), queue.Queue()

        def follower():
            pickle.loads(to_f.get())
            if answer_after is not None:
                time.sleep(answer_after)
                from_f.put(pickle.dumps(("ok", {"rank": 1})))
            end = time.monotonic() + 10.0  # alive past the test's waits
            while alive and time.monotonic() < end:
                time.sleep(0.05)

        t = threading.Thread(target=follower, daemon=True)
        t.start()
        lead = tp.Leader.__new__(tp.Leader)
        lead.timeout, lead.closed = timeout, False
        lead.followers = [tp._Follower(1, tp._QueueEnd(from_f, to_f), t)]
        return lead

    assert leader(answer_after=0.4).ask("stats") == [{"rank": 1}]
    t0 = time.monotonic()
    with pytest.raises(tp.FollowerDiedError, match="did not answer"):
        leader(timeout=0.5).ask("stats")
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(tp.FollowerDiedError, match="died"):
        leader(alive=False, timeout=30.0).ask("stats")
    assert time.monotonic() - t0 < 10.0


@pytest.mark.parametrize("args", [["--phase", "3"], ["--phase"],
                                  ["--phase", "19", "again"], ["19"],
                                  ["--phase", "20", "again"],
                                  ["--phase", "21", "again"], ["21"]])
def test_chip_smoke_takes_only_phase_19(args):
    """``chip_smoke.py`` takes no argument, ``--phase 19``, ``--phase 20``
    or ``--phase 21``; anything else is refused before any work, with exit
    2 and no result line."""
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    r = subprocess.run([sys.executable, script, *args], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2
    assert ("the only ones taken are '--phase 19', '--phase 20' and "
            "'--phase 21'" in r.stderr)
    assert r.stdout.strip() == ""
