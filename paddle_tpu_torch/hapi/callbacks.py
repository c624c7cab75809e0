"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``LRScheduler``, ``EarlyStopping``, ``ReduceLROnPlateau``, ``VisualDL``
(scalars to ``<log_dir>/scalars.jsonl``, one ``{tag, step, value}`` record
a line) and ``WandbCallback`` (needs the ``wandb`` package)."""
from __future__ import annotations

import json
import os
import time

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau", "VisualDL",
           "WandbCallback"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                              for k, v in (logs or {}).items())
            print(f"epoch {self._epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                              for k, v in (logs or {}).items())
            print(f"epoch {epoch} done in {dt:.1f}s: {items}")


class ModelCheckpoint(Callback):
    """``model.save(<save_dir>/<epoch>/model)`` every ``save_freq``
    epochs."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoints"):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch), "model"))


class LRScheduler(Callback):
    """Steps the optimizer's LR scheduler after every batch (``by_step``)
    or every epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="min", patience=0, min_delta=0,
                 baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.wait = 0
        self.best = None
        self.mode = mode
        self.stopped = False

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self._better(float(cur)):
            self.best = float(cur)
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
                if self.model is not None:
                    self.model.stop_training = True


class ReduceLROnPlateau(Callback):
    """Scale the LR by ``factor`` after ``patience`` evals without metric
    improvement."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        if mode == "auto":  # accuracy-like monitors maximize
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.wait = 0
        self.cooldown_counter = 0
        self.best = None

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(cur)
        if self.cooldown_counter > 0:
            # inside the cooldown: track the best, count no misses
            self.cooldown_counter -= 1
            self.wait = 0
            if self._better(cur):
                self.best = cur
            return
        if self._better(cur):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is None:
                return
            old = opt.get_lr()
            new = max(old * self.factor, self.min_lr)
            if old - new > 1e-12:
                opt.set_lr(new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.3g} -> {new:.3g}")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class VisualDL(Callback):
    """Training-curve logger: the scalars stream to
    ``<log_dir>/scalars.jsonl`` (one ``{tag, step, value}`` record a
    line)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None
        self._step = 0
        self._eval_step = 0

    def _write(self, tag, value, step):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(f"{self.log_dir}/scalars.jsonl", "a")
        try:
            v = float(value[0] if isinstance(value, (list, tuple)) else value)
        except (TypeError, ValueError):
            return
        self._fh.write(json.dumps({"tag": tag, "step": step, "value": v})
                       + "\n")
        self._fh.flush()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            if k not in ("batch_size", "steps"):
                self._write(f"train/{k}", v, self._step)

    def on_eval_end(self, logs=None):
        # monotone, distinct x per eval — tracks the train step during
        # training and keeps advancing for standalone/repeated evals
        self._eval_step += 1
        for k, v in (logs or {}).items():
            if k not in ("batch_size", "steps"):
                self._write(f"eval/{k}", v, self._step + self._eval_step)

    def on_train_end(self, logs=None):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class WandbCallback(Callback):
    """Weights & Biases logger; needs the ``wandb`` package at
    construction."""

    def __init__(self, project=None, run_name=None, **kwargs):
        super().__init__()
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "WandbCallback requires the wandb package") from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=run_name, **kwargs)

    def on_train_batch_end(self, step, logs=None):
        self._run.log({f"train/{k}": v for k, v in (logs or {}).items()})

    def on_eval_end(self, logs=None):
        self._run.log({f"eval/{k}": v for k, v in (logs or {}).items()})

    def on_train_end(self, logs=None):
        self._run.finish()
