"""The optimizer family, the LR schedulers, LBFGS and the optimizer state
dicts of the port against the JAX package.

Tolerances:

* eager, on the goldens' 4-element setup (a parameter ``arange(1, 5)``, 3
  steps of the gradients of ``(p * g).sum()`` for three seeded g, lr 0.1):
  parameters within rtol 1e-6 (the same f32 arithmetic; XLA's ``pow`` and
  ``sqrt`` against torch's, one rounding apart at most);
* on a 2-layer GPT through ``TrainStep`` (3 steps, seeded batches, the
  same numpy-seeded weights in both packages): losses within rtol 1e-5;
  parameters and slots by their updates, normwise per array, ``|d_port -
  d_jax| <= 1e-4 |d_jax|`` with ``d = final - initial`` (the
  ``tests/test_torch_train.py`` bar: Adam-like steps are about ``lr *
  sign(g)`` whatever g's size, so an element whose gradient is near 0
  moves lr-sized in a direction rounding noise sets, and an elementwise
  bound would have to allow a whole step; Adam-like cases take epsilon
  1e-6, above the f32 noise of the smallest gradients, as there); with bf16 moments and master
  weights, losses within rtol 5e-4 and the master weights' updates within
  REL_BF16 normwise;
* schedulers: 40 values of ``get_lr()`` within 1e-12 relative (the same
  Python float arithmetic);
* LBFGS: the parameters and the loss within rtol 1e-5 after 2 calls of
  ``step`` (f32 dot products summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt_mod
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as opt_mod
from paddle_tpu_torch import regularizer as reg
from paddle_tpu_torch.core import compile_cache, flags, resilience
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.optimizer import lr

torch.set_num_threads(1)

GRADS = [np.random.default_rng(s).standard_normal(4).astype(np.float32)
         for s in range(3)]

# (id, class name, hyperparameters by package: a function of the package's
# regularizer module)
CASES = [
    ("sgd", "SGD", lambda r: {}),
    ("sgd_l2", "SGD", lambda r: {"weight_decay": 0.05}),
    ("sgd_l1", "SGD", lambda r: {"weight_decay": r.L1Decay(0.05)}),
    ("momentum", "Momentum", lambda r: {"momentum": 0.9}),
    ("nesterov", "Momentum", lambda r: {"momentum": 0.9, "use_nesterov": True,
                                        "weight_decay": 0.01,
                                        "rescale_grad": 0.5}),
    ("adam", "Adam", lambda r: {"beta1": 0.8, "epsilon": 1e-6}),
    ("adamw", "AdamW", lambda r: {"weight_decay": 0.05, "epsilon": 1e-6}),
    ("adagrad", "Adagrad", lambda r: {"initial_accumulator_value": 0.1,
                                      "weight_decay": 0.01}),
    ("adadelta", "Adadelta", lambda r: {"rho": 0.9, "epsilon": 1e-6}),
    ("rmsprop", "RMSProp", lambda r: {"rho": 0.9}),
    ("rmsprop_centered", "RMSProp", lambda r: {"rho": 0.9, "centered": True,
                                               "momentum": 0.5}),
    ("adamax", "Adamax", lambda r: {"beta1": 0.8, "epsilon": 1e-6}),
    ("lamb", "Lamb", lambda r: {"lamb_weight_decay": 0.01}),
    ("lars", "LarsMomentum", lambda r: {"lars_weight_decay": 0.0005,
                                        "lars_coeff": 0.01}),
]
IDS = [c[0] for c in CASES]


def _pair(name, kw, port_params, jax_params, lr_=0.1, **extra):
    opt = getattr(opt_mod, name)(learning_rate=lr_, parameters=port_params,
                                 **kw(reg), **extra)
    jopt = getattr(jopt_mod, name)(learning_rate=lr_,
                                   parameters=jax_params, **kw(jreg),
                                   **extra)
    return opt, jopt


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_eager_goldens_match_jax(case):
    _, name, kw = case
    p = torch.nn.Parameter(torch.arange(1.0, 5.0))
    jp = paddle.to_tensor(np.arange(1.0, 5.0, dtype=np.float32))
    jp.stop_gradient = False
    opt, jopt = _pair(name, kw, [p], [jp])
    for g in GRADS:
        (p * torch.from_numpy(g)).sum().backward()
        opt.step()
        opt.clear_grad()
        (jp * paddle.to_tensor(g)).sum().backward()
        jopt.step()
        jopt.clear_grad()
    np.testing.assert_allclose(p.detach().numpy(), jp.numpy(), rtol=1e-6)
    assert opt._step_count == jopt._step_count == 3


def test_minimize_and_functional_path_match_step():
    """``minimize`` is backward then step; ``apply_gradients`` over dicts
    gives the in-place path's parameters and slots."""
    p = torch.nn.Parameter(torch.arange(1.0, 5.0))
    q = torch.arange(1.0, 5.0)
    opt = opt_mod.Adam(learning_rate=0.1, parameters=[p])
    pure = opt_mod.Adam(learning_rate=0.1)
    state = pure.init_state({"p": q})
    for g in GRADS:
        opt.minimize((p * torch.from_numpy(g)).sum())
        opt.clear_grad()
        new, state = pure.apply_gradients({"p": q}, {"p": torch.from_numpy(g)},
                                          state)
        q = new["p"]
    assert torch.equal(p.detach(), q)
    assert state["step"] == 3
    assert torch.equal(state["slots"]["p"]["moment2"],
                       opt._accumulators[id(p)]["moment2"])


# ------------------------------------------------------------- on a model

REL_BF16 = 0.25
CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64)
BATCH, SEQ = 2, 32


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.GPTConfig(**CFG),
                                               device="cpu"), seed=0)


def _models(arrays, dtype=None):
    m = gpt.GPTForCausalLM(gpt.GPTConfig(**CFG), device="cpu")
    gpt.load_functional_state(m, arrays)
    m.train()
    jm = JaxGPT(JaxConfig(**CFG))
    for name, t in jm.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    jm.train()
    if dtype is not None:
        from paddle_tpu import amp as jamp
        from paddle_tpu_torch import amp

        amp.decorate(m, level="O2", dtype=dtype)
        jamp.decorate(jm, level="O2", dtype=dtype)
    return m, jm


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                               (BATCH, SEQ + 1))
    return ids[:, :-1], ids[:, 1:]


def _steps(m, jm, opt, jopt, n=3, first=0):
    step = TrainStep(lambda x, y: m(x, y), opt)
    jstep = JaxTrainStep(lambda x, y: jm(x, y), jopt, layers=jm)
    losses, jlosses = [], []
    for i in range(first, first + n):
        x, y = _batch(10 + i)
        losses.append(float(step(torch.as_tensor(x), torch.as_tensor(y))))
        jlosses.append(float(jstep(Tensor(np.asarray(x, np.int32)),
                                   Tensor(np.asarray(y, np.int32)))))
    return losses, jlosses


def _jax_slots(jm, jopt):
    out = {}
    for n, t in jm.functional_state()[0].items():
        for k, v in jopt._accumulators.get(id(t), {}).items():
            out[f"{n}.{k}"] = np.asarray(v.astype(jnp.float32))
    return out


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


def _port_params(m):
    return {n: p.detach().float().numpy() for n, p in m.named_parameters()}


def _jax_params(jm):
    return {n: np.asarray(t._data.astype(jnp.float32))
            for n, t in jm.functional_state()[0].items()}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_train_step_matches_jax(arrays, case):
    _, name, kw = case
    m, jm = _models(arrays)
    opt, jopt = _pair(name, kw, m.named_parameters(), jm.parameters(),
                      lr_=1e-3, grad_clip=None)
    losses, jlosses = _steps(m, jm, opt, jopt)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_updates(_port_params(m), _jax_params(jm), arrays, 1e-4)
    slots = opt.optimizer_state_arrays()
    assert int(slots.pop("step")) == jopt._step_count == 3
    _assert_updates(slots, _jax_slots(jm, jopt), 0.0, 1e-4)


@pytest.mark.parametrize("name", ["Lamb", "AdamW"])
def test_bf16_moments_and_master_weights_match_jax(arrays, name):
    m, jm = _models(arrays, dtype="bfloat16")
    kw = dict(multi_precision=True, moment_dtype="bfloat16",
              grad_clip=None, epsilon=1e-6)
    opt = getattr(opt_mod, name)(learning_rate=1e-3,
                                 parameters=m.named_parameters(), **kw)
    jopt = getattr(jopt_mod, name)(learning_rate=1e-3,
                                   parameters=jm.parameters(), **kw)
    losses, jlosses = _steps(m, jm, opt, jopt, n=2)
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4)
    slots, jslots = opt.optimizer_state_arrays(), _jax_slots(jm, jopt)
    for p in m.parameters():
        assert opt._accumulators[id(p)]["moment1"].dtype == torch.bfloat16
    init = {n: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            for n, a in arrays.items()}
    _assert_updates({n: slots[n + ".master_weight"] for n in arrays},
                    {n: jslots[n + ".master_weight"] for n in arrays}, init,
                    REL_BF16)


def _is_vector(p):
    return p.ndim == 1


@pytest.mark.parametrize("name", ["Lamb", "LarsMomentum"])
def test_weight_decay_exclusion_inside_train_step(arrays, name):
    """Lamb's ``exclude_from_weight_decay_fn`` (the 1-D parameters) and
    LARS's ``exclude_from_weight_decay`` (names with "ln"), with a global
    clip, hold inside TrainStep as in the JAX step; and they change the
    result (against no exclusion)."""
    if name == "Lamb":
        kw = dict(lamb_weight_decay=0.1,
                  exclude_from_weight_decay_fn=_is_vector)
    else:
        kw = dict(lars_weight_decay=0.01, lars_coeff=0.01,
                  exclude_from_weight_decay=["ln"])
    m, jm = _models(arrays)
    opt = getattr(opt_mod, name)(learning_rate=1e-2,
                                 parameters=m.named_parameters(),
                                 grad_clip=clip.ClipGradByGlobalNorm(0.5),
                                 **kw)
    jopt = getattr(jopt_mod, name)(learning_rate=1e-2,
                                   parameters=jm.parameters(),
                                   grad_clip=jclip.ClipGradByGlobalNorm(0.5),
                                   **kw)
    losses, jlosses = _steps(m, jm, opt, jopt, n=2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = _port_params(m)
    _assert_updates(got, _jax_params(jm), arrays, 1e-4)
    plain, _ = _models(arrays)
    kw.pop("exclude_from_weight_decay_fn", None)
    kw.pop("exclude_from_weight_decay", None)
    popt = getattr(opt_mod, name)(learning_rate=1e-2,
                                  parameters=plain.named_parameters(),
                                  grad_clip=clip.ClipGradByGlobalNorm(0.5),
                                  **kw)
    step = TrainStep(lambda x, y: plain(x, y), popt)
    for i in range(2):
        x, y = _batch(10 + i)
        step(torch.as_tensor(x), torch.as_tensor(y))
    assert not np.allclose(plain.gpt.ln_f.bias.detach().numpy(),
                           got["gpt.ln_f.bias"], atol=1e-9, rtol=0)


def test_state_dict_crosses_packages_and_resumes(arrays):
    """The JAX optimizer's state dict (``<param name>.<slot>``, ``step``,
    ``LR_Scheduler``) restores the port's optimizer under the same keys,
    and the reverse; both runs then continue equal to the uninterrupted
    JAX run. A set_state_dict between two TrainStep calls is what the next
    call continues from."""
    def make(mod, params, sched_mod):
        return mod.Lamb(learning_rate=sched_mod.LinearWarmup(
            sched_mod.CosineAnnealingDecay(1e-2, T_max=10), 2, 0.0, 1e-2),
            parameters=params, lamb_weight_decay=0.01)

    m, jm = _models(arrays)
    opt = make(opt_mod, m.named_parameters(), lr)
    jopt = make(jopt_mod, jm.parameters(), jlr)
    _steps(m, jm, opt, jopt, n=2)
    for o in (opt, jopt):
        o._learning_rate.step()
    jsd = jopt.state_dict()
    sd = opt.state_dict()
    assert set(sd) == set(jsd)
    assert sd["LR_Scheduler"] == jsd["LR_Scheduler"]
    # port <- JAX, JAX <- port, both continued one step
    m2, jm2 = _models(arrays)
    gpt.load_functional_state(m2, {n: np.asarray(t._data) for n, t in
                                   jm.functional_state()[0].items()})
    for n, t in jm2.functional_state()[0].items():
        # a copy: jnp.asarray may alias the numpy view of m's parameter
        t._data = jnp.asarray(
            dict(m.named_parameters())[n].detach().numpy().copy())
    opt2 = make(opt_mod, m2.named_parameters(), lr)
    jopt2 = make(jopt_mod, jm2.parameters(), jlr)
    opt2.set_state_dict({k: (np.asarray(v._data) if isinstance(v, Tensor)
                             else v) for k, v in jsd.items()})
    jopt2.set_state_dict({k: (v.numpy() if isinstance(v, torch.Tensor)
                              else v) for k, v in sd.items()})
    assert opt2._step_count == jopt2._step_count == 2
    assert opt2.get_lr() == jopt2.get_lr() == jopt.get_lr()
    (l0,), (jl0,) = _steps(m, jm, opt, jopt, n=1, first=2)
    (l2,), (jl2,) = _steps(m2, jm2, opt2, jopt2, n=1, first=2)
    np.testing.assert_allclose([l2, jl2, l0], [jl0] * 3, rtol=1e-5)
    jparams = _jax_params(jm)
    _assert_updates(_port_params(m2), jparams, arrays, 1e-4)
    _assert_updates(_jax_params(jm2), jparams, arrays, 1e-4)


def test_set_state_dict_fresh_and_master_rules():
    """A parameter with no entry starts fresh; a master_weight is read only
    under multi_precision; duplicate names get #0/#1 keys; index keys are
    read too."""
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
    opt = opt_mod.Momentum(learning_rate=0.1, parameters=[("w", a),
                                                          ("w", b)])
    assert opt._slot_keys() == ["w#0", "w#1"]
    opt.set_state_dict({"step": 4, "w#0.velocity": np.full(2, 0.5,
                                                           np.float32),
                        "1.velocity": np.full(3, 0.25, np.float32),
                        "w#0.master_weight": np.zeros(2, np.float32)})
    assert opt._step_count == 4
    assert torch.equal(opt._accumulators[id(a)]["velocity"],
                       torch.full((2,), 0.5))
    assert set(opt._accumulators[id(a)]) == {"velocity"}
    assert torch.equal(opt._accumulators[id(b)]["velocity"],
                       torch.full((3,), 0.25))
    opt.set_state_dict({"step": 0})
    assert opt._accumulators == {}


def test_max_bad_steps_triggers_rollback(arrays):
    """FLAGS_max_bad_steps consecutive nonfinite steps (the nonfinite_grads
    fault) call the rollback handler, or raise NonfiniteStepError without
    one; a skipped step leaves parameters, slots and the step count
    bit-identical; a finite step resets the count."""
    m, _ = _models(arrays)
    opt = opt_mod.Adam(learning_rate=1e-3, parameters=m.named_parameters())
    step = TrainStep(lambda x, y: m(x, y), opt)
    x, y = (torch.as_tensor(a) for a in _batch(0))
    step(x, y)
    keep = flags.get_flags(["fault_injection", "max_bad_steps"])
    reasons = []
    try:
        flags.set_flags({"fault_injection": 1, "max_bad_steps": 2})
        resilience.set_rollback_handler(reasons.append)
        before = {n: p.detach().clone() for n, p in m.named_parameters()}
        slots = opt.optimizer_state_arrays()
        resilience.inject_fault("nonfinite_grads", times=1)
        assert not np.isfinite(float(step(x, y)))
        for n, p in m.named_parameters():
            assert torch.equal(p.detach(), before[n])
        for k, v in opt.optimizer_state_arrays().items():
            np.testing.assert_array_equal(v, slots[k])
        step(x, y)  # finite: the count starts again
        resilience.inject_fault("nonfinite_grads", times=2)
        step(x, y)
        assert reasons == []
        step(x, y)
        assert len(reasons) == 1 and "2 consecutive" in reasons[0]
        resilience.set_rollback_handler(None)
        resilience.inject_fault("nonfinite_grads", times=2)
        step(x, y)
        with pytest.raises(resilience.NonfiniteStepError):
            step(x, y)
        assert compile_cache.stats()["sentinel.skipped"] >= 5
        assert resilience.stats()["sentinel.rollbacks"] == 2
    finally:
        resilience.clear_faults()
        resilience.set_rollback_handler(None)
        flags.set_flags(keep)


# ------------------------------------------------------------- schedulers


def _lam(e):
    return 0.95 ** e


SCHEDULERS = [
    ("NoamDecay", dict(d_model=64, warmup_steps=5, learning_rate=2.0)),
    ("PiecewiseDecay", dict(boundaries=[5, 12, 30],
                            values=[0.1, 0.05, 0.01, 0.001])),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.2)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=12, power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=12, cycle=True)),
    ("ExponentialDecay", dict(learning_rate=0.5, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.5, milestones=[3, 9, 27])),
    ("StepDecay", dict(learning_rate=0.5, step_size=7, gamma=0.5)),
    ("LambdaDecay", dict(learning_rate=0.5, lr_lambda=_lam)),
    ("CosineAnnealingDecay", dict(learning_rate=0.5, T_max=13)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.5, T_0=5,
                                         T_mult=2, eta_min=0.01)),
    ("ReduceOnPlateau", dict(learning_rate=0.5, patience=2, cooldown=1,
                             factor=0.5)),
    ("ReduceOnPlateau", dict(learning_rate=0.5, mode="max", patience=1,
                             threshold_mode="abs", threshold=0.1)),
    ("OneCycleLR", dict(max_learning_rate=0.5, total_steps=30)),
    ("MultiplicativeDecay", dict(learning_rate=0.5, lr_lambda=_lam)),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=4)),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=3, step_size_down=5, mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=3, mode="exp_range", exp_gamma=0.9)),
    ("LinearWarmup", None),
]
# ReduceOnPlateau's metric: falls, then stalls, then rises
METRICS = [5.0, 4.0, 3.5, 3.5, 3.6, 3.5, 3.4, 3.45, 3.5, 3.5] * 4


def _sched(mod, name, kw):
    if name == "LinearWarmup":
        return mod.LinearWarmup(mod.CosineAnnealingDecay(0.5, T_max=20), 6,
                                0.0, 0.5)
    return getattr(mod, name)(**kw)


def _advance(s, name, i):
    if name == "ReduceOnPlateau":
        s.step(METRICS[i])
    else:
        s.step()


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_matches_jax_and_round_trips(name, kw):
    s, js = _sched(lr, name, kw), _sched(jlr, name, kw)
    got, want = [], []
    for i in range(40):
        got.append(s())
        want.append(js())
        _advance(s, name, i)
        _advance(js, name, i)
        if i == 16:
            sd = s.state_dict()
            assert sd == js.state_dict()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # a fresh scheduler restored at step 17 continues as the original did
    r = _sched(lr, name, kw)
    r.set_state_dict(sd)
    again = _sched(lr, name, kw)
    for i in range(17):
        _advance(again, name, i)
    for i in range(17, 40):
        assert r() == again()
        _advance(r, name, i)
        _advance(again, name, i)


# ------------------------------------------------------------------ LBFGS

A = np.random.default_rng(5).standard_normal((12, 6)).astype(np.float32)
B = np.random.default_rng(6).standard_normal(12).astype(np.float32)


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    x0 = np.full(6, 0.5, np.float32)
    p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    jp = paddle.to_tensor(x0.copy())
    jp.stop_gradient = False
    kw = dict(learning_rate=1.0, max_iter=5, history_size=4,
              line_search_fn=line_search)
    opt = opt_mod.LBFGS(parameters=[p], **kw)
    jopt = jopt_mod.LBFGS(parameters=[jp], **kw)
    at, bt = torch.from_numpy(A), torch.from_numpy(B)
    ja, jb = paddle.to_tensor(A), paddle.to_tensor(B)

    def closure():
        opt.clear_grad()
        loss = ((at @ p - bt) ** 2).sum() + (p ** 4).sum() * 0.1
        loss.backward()
        return loss

    def jclosure():
        jopt.clear_grad()
        loss = ((paddle.matmul(ja, jp) - jb) ** 2).sum() + (
            jp ** 4).sum() * 0.1
        loss.backward()
        return loss

    first = float(closure())
    for _ in range(2):
        loss, jloss = opt.step(closure), jopt.step(jclosure)
    np.testing.assert_allclose(float(loss), float(jloss.numpy()), rtol=1e-5)
    np.testing.assert_allclose(p.detach().numpy(), jp.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(loss) < first
    # the history round-trips: a restored optimizer takes the same step
    sd = opt.state_dict()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = opt_mod.LBFGS(parameters=[q], **kw)
    opt2.set_state_dict(sd)

    def closure2():
        opt2.clear_grad()
        loss = ((at @ q - bt) ** 2).sum() + (q ** 4).sum() * 0.1
        loss.backward()
        return loss

    opt.step(closure)
    opt2.step(closure2)
    assert torch.equal(p.detach(), q.detach())
