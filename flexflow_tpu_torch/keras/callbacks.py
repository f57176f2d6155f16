"""Keras callbacks, the PyTorch counterpart of
``flexflow_tpu/keras/callbacks.py`` (reference:
python/flexflow/keras/callbacks.py —
Callback, LearningRateScheduler, VerifyMetrics, EpochVerifyMetrics; the
accuracy gates of examples/python/keras/accuracy.py ModelAccuracy).

``fit(callbacks=[...])`` drives training one epoch at a time; batch-level
hooks are invoked per epoch-batch loop from the host (metrics stay
device-accumulated between hooks)."""

from __future__ import annotations

from enum import Enum
from typing import Callable, Dict, List, Optional


class ModelAccuracy(Enum):
    """Convergence gates (reference: examples/python/keras/accuracy.py —
    the 90% thresholds the reference CI asserts)."""

    MNIST_MLP = 90
    MNIST_CNN = 90
    REUTERS_MLP = 90
    CIFAR10_CNN = 90
    CIFAR10_ALEXNET = 90
    DIGITS_MLP = 90


class Callback:
    """reference: callbacks.py:21-47."""

    def __init__(self):
        self.model = None
        self.params: Dict = {}

    def set_params(self, params: Dict) -> None:
        self.params = params

    def set_model(self, model) -> None:
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch: int, logs=None):
        pass

    def on_epoch_end(self, epoch: int, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]], model, params):
        self.callbacks = list(callbacks or [])
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def __getattr__(self, hook):
        def fire(*args, **kw):
            for c in self.callbacks:
                getattr(c, hook)(*args, **kw)
        return fire


class History(Callback):
    """Keras-style history: per-epoch logs dict list."""

    def on_train_begin(self, logs=None):
        self.epochs: List[int] = []
        self.history: Dict[str, List[float]] = {}

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append(epoch)
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class LearningRateScheduler(Callback):
    """reference: callbacks.py:49-62 — schedule(epoch) -> float applied via
    the optimizer's set-learning-rate path (here FFModel.set_learning_rate;
    the port's step reads the rate on its next call)."""

    def __init__(self, schedule: Callable[[int], float]):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        lr = self.schedule(epoch)
        if not isinstance(lr, float):
            raise ValueError(
                'the output of the "schedule" function should be float')
        self.model.ffmodel.set_learning_rate(lr)


class VerifyMetrics(Callback):
    """reference: callbacks.py:64-73 — assert final accuracy meets the
    gate (the reference CI's convergence check)."""

    def __init__(self, accuracy: ModelAccuracy):
        super().__init__()
        self.accuracy = accuracy.value

    def on_train_end(self, logs=None):
        acc = 100.0 * (logs or {}).get("accuracy", 0.0)
        assert acc >= self.accuracy, (
            f"accuracy {acc:.2f}% below the {self.accuracy}% gate")


class EpochVerifyMetrics(Callback):
    """reference: callbacks.py:75-88 — stop early once the gate is met
    (early_stop=True), or assert it per epoch."""

    def __init__(self, accuracy: ModelAccuracy, early_stop: bool = True):
        super().__init__()
        self.accuracy = accuracy.value
        self.early_stop = early_stop
        self.reached = False

    def on_epoch_end(self, epoch, logs=None):
        acc = 100.0 * (logs or {}).get("accuracy", 0.0)
        if acc >= self.accuracy:
            self.reached = True
            if self.early_stop:
                self.model.stop_training = True


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (no reference
    equivalent; standard Keras surface)."""

    def __init__(self, monitor: str = "loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "min"):
        super().__init__()
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0

    def on_train_begin(self, logs=None):
        self.best, self.wait = None, 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            import warnings

            warnings.warn(
                f"EarlyStopping: monitored metric {self.monitor!r} not in "
                f"logs {sorted((logs or {}).keys())}; callback inactive "
                f"(include the metric in compile(metrics=...))",
                stacklevel=2)
            return
        better = (
            self.best is None
            or (self.mode == "min" and cur < self.best - self.min_delta)
            or (self.mode == "max" and cur > self.best + self.min_delta)
        )
        if better:
            self.best, self.wait = cur, 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True
