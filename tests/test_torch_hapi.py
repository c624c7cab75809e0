"""hapi ``Model``, its callbacks and the metrics of the port against the
JAX package.

``Model.fit`` on gpt_tiny (the same numpy-seeded weights, the same
datasets, the same ``np.random.seed`` for the shuffle) with AdamW under a
step-decayed LR: the history's losses within rtol 1e-5 (f32 losses summed
in another order) and the LR of every step equal; ``evaluate``'s loss
within rtol 1e-5 and its top-1/top-5 accuracy equal (the hit counts are
integers); ``predict``'s logits within atol 1e-5. The metrics classes
compute on numpy in both packages, so their values are equal exactly.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import callbacks as jcallbacks
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.hapi import summary as jsummary
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import callbacks, io, load, metric
from paddle_tpu_torch.hapi import Model, summary
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr

torch.set_num_threads(1)

CFG = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
           max_position_embeddings=256)  # gpt_tiny
SEQ, N = 32, 8


@pytest.fixture(scope="module")
def arrays():
    return gpt.seeded_state(gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu"),
                            seed=0)


def _ids(seed, n=N):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                               (n, SEQ + 1))
    return ids[:, :-1], ids[:, 1:]


def _loss(logits, y):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           y.reshape(-1))


def _jloss(logits, y):
    return JF.cross_entropy(logits.reshape([-1, logits.shape[-1]]),
                            y.reshape([-1]))


def _models(arrays):
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu")
    gpt.load_functional_state(m, arrays)
    jm = JaxGPT(JaxConfig(**CFG))
    for name, t in jm.functional_state()[0].items():
        t._data = jnp.asarray(arrays[name])
    return m, jm


def _lr_recorder(base):
    """A callback of ``base`` recording the LR each step ran with."""
    class LRs(base):
        def __init__(self):
            super().__init__()
            self.seen = []

        def on_train_batch_begin(self, step, logs=None):
            self.seen.append(self.model._optimizer.get_lr())

    return LRs()


def test_fit_evaluate_predict_match_jax(arrays, tmp_path):
    m, jm = _models(arrays)
    opt = AdamW(learning_rate=lr.StepDecay(3e-3, step_size=3, gamma=0.5),
                parameters=m.named_parameters(), epsilon=1e-6)
    jopt = JaxAdamW(learning_rate=jlr.StepDecay(3e-3, step_size=3,
                                                gamma=0.5),
                    parameters=jm.parameters(), epsilon=1e-6)
    model, jmodel = Model(m), JaxModel(jm)
    model.prepare(opt, _loss, metric.Accuracy(topk=(1, 5)))
    jmodel.prepare(jopt, _jloss, jmetric.Accuracy(topk=(1, 5)))
    x, y = _ids(1)
    ex, ey = _ids(2, n=4)
    cbs = _lr_recorder(callbacks.Callback)
    jcbs = _lr_recorder(jcallbacks.Callback)
    np.random.seed(5)
    hist = model.fit(io.TensorDataset([x, y]), io.TensorDataset([ex, ey]),
                     batch_size=2, epochs=2, verbose=0,
                     callbacks=[cbs, callbacks.LRScheduler()])
    np.random.seed(5)
    jhist = jmodel.fit(jio.TensorDataset([x, y]),
                       jio.TensorDataset([ex, ey]), batch_size=2, epochs=2,
                       verbose=0, callbacks=[jcbs, jcallbacks.LRScheduler()])
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    assert cbs.seen == jcbs.seen and len(cbs.seen) == 8
    logs = model.evaluate(io.TensorDataset([ex, ey]), batch_size=2,
                          verbose=0)
    jlogs = jmodel.evaluate(jio.TensorDataset([ex, ey]), batch_size=2,
                            verbose=0)
    assert set(logs) == set(jlogs) == {"loss", "acc_top1", "acc_top5"}
    np.testing.assert_allclose(logs["loss"], jlogs["loss"], rtol=1e-5)
    assert logs["acc_top1"] == jlogs["acc_top1"]
    assert logs["acc_top5"] == jlogs["acc_top5"]
    out = model.predict(io.TensorDataset([ex]), batch_size=2,
                        stack_outputs=True)
    jout = jmodel.predict(jio.TensorDataset([ex]), batch_size=2,
                          stack_outputs=True)
    np.testing.assert_allclose(out[0], jout[0], atol=1e-5, rtol=0)
    assert m.training


def test_save_load_and_callbacks(arrays, tmp_path):
    """``save`` writes the network and the optimizer (an error in either
    raises); ``load`` restores both; ModelCheckpoint, VisualDL,
    EarlyStopping and ReduceLROnPlateau act as the JAX callbacks do."""
    m, _ = _models(arrays)
    opt = AdamW(learning_rate=1e-3, parameters=m.named_parameters())
    model = Model(m).prepare(opt, _loss)
    x, y = _ids(3)
    logdir = str(tmp_path / "vdl")
    stop = callbacks.EarlyStopping(monitor="loss", patience=0)
    plateau = callbacks.ReduceLROnPlateau(monitor="loss", patience=1,
                                          factor=0.5, verbose=0)
    np.random.seed(0)
    model.fit(io.TensorDataset([x, y]), io.TensorDataset([x, y]),
              batch_size=4, epochs=3, verbose=0,
              callbacks=[callbacks.ModelCheckpoint(1, str(tmp_path / "mc")),
                         callbacks.VisualDL(logdir), stop, plateau])
    for epoch in range(3 if not stop.stopped else 1):
        if os.path.exists(tmp_path / "mc" / str(epoch)):
            assert os.path.exists(tmp_path / "mc" / str(epoch) /
                                  "model.pdopt")
    rows = [json.loads(r) for r in open(os.path.join(logdir,
                                                     "scalars.jsonl"))]
    assert {r["tag"] for r in rows} >= {"train/loss", "eval/loss"}
    model.save(str(tmp_path / "final"))
    sd = load(str(tmp_path / "final.pdparams"))
    assert set(sd) == set(m.state_dict())
    m2, _ = _models(arrays)
    opt2 = AdamW(learning_rate=1e-3, parameters=m2.named_parameters())
    Model(m2).prepare(opt2, _loss).load(str(tmp_path / "final"))
    for (n, a), b in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
    assert opt2._step_count == opt._step_count > 0
    for k, v in opt.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, opt2.state_dict()[k]), k

    class Broken(AdamW):
        def state_dict(self):
            raise OSError("optimizer state unreadable")

    bad = Model(m).prepare(Broken(parameters=m.named_parameters()), _loss)
    with pytest.raises(OSError, match="unreadable"):
        bad.save(str(tmp_path / "broken"))
    with pytest.raises(ImportError, match="wandb"):
        callbacks.WandbCallback()


def test_summary_matches_jax(arrays, capsys):
    m, jm = _models(arrays)
    got, want = summary(m), jsummary(jm)
    assert got == want
    assert "Total params" in capsys.readouterr().out


def test_metrics_match_jax():
    r = np.random.default_rng(0)
    scores = r.random((50, 2)).astype(np.float32)
    labels = r.integers(0, 2, (50, 1))
    probs = r.random(50).astype(np.float32)
    for cls, jcls, pred in ((metric.Precision, jmetric.Precision, probs),
                            (metric.Recall, jmetric.Recall, probs),
                            (metric.Auc, jmetric.Auc, scores)):
        a, b = cls(), jcls()
        for lo in (0, 25):
            a.update(torch.from_numpy(pred[lo:lo + 25]),
                     torch.from_numpy(labels[lo:lo + 25]))
            b.update(pred[lo:lo + 25], labels[lo:lo + 25])
        assert a.accumulate() == b.accumulate() and a.name() == b.name()
    logits = r.standard_normal((40, 7)).astype(np.float32)
    lab = r.integers(0, 7, (40, 1))
    acc, jacc = metric.Accuracy(topk=(1, 3)), jmetric.Accuracy(topk=(1, 3))
    np.testing.assert_array_equal(acc.update(acc.compute(
        torch.from_numpy(logits), torch.from_numpy(lab))),
        jacc.update(jacc.compute(logits, lab)))
    assert acc.accumulate() == jacc.accumulate()
    assert acc.name() == jacc.name() == ["acc_top1", "acc_top3"]
    for k in (1, 3):
        got = metric.accuracy(torch.from_numpy(logits), torch.from_numpy(lab),
                              k=k)
        want = jmetric.accuracy(paddle.to_tensor(logits),
                                paddle.to_tensor(lab), k=k)
        assert float(got) == float(want.numpy())
