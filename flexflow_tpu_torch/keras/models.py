"""Keras Sequential / functional Model.

PyTorch counterpart of ``flexflow_tpu/keras/models.py`` (reference:
python/flexflow/keras/models/{sequential.py,model.py,base_model.py} —
``BaseModel.compile`` creates FFModel + input tensors + optimizer
(base_model.py:128); ``fit`` creates dataloaders and drives the loop
(base_model.py:198)). Building is deferred until the batch size is known,
then lowered through the port's FFModel builder, on the card unless
``compile(device="cpu")``. A learning-rate change
(:class:`~flexflow_tpu_torch.keras.callbacks.LearningRateScheduler`)
reaches the next step through ``FFModel.set_learning_rate``: the port's
step reads the optimizer's hyperparameters on every call."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import FFConfig
from ..ffconst import DataType, LossType, MetricsType
from ..runtime.model import FFModel
from .layers import Input, KerasLayer, SymTensor
from .optimizers import resolve as _resolve_opt

_LOSS = {
    "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
}
_METRIC = {
    "accuracy": MetricsType.ACCURACY,
    "categorical_crossentropy": MetricsType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.MEAN_ABSOLUTE_ERROR,
}


class _BaseModel:
    def __init__(self):
        self._opt = None
        self._loss: Optional[LossType] = None
        self._metrics: List[MetricsType] = []
        self.ffmodel: Optional[FFModel] = None
        self._mesh = None
        self._seed = 0
        self._device: Optional[str] = None

    # -- user API --------------------------------------------------------- #
    def compile(self, optimizer="sgd", loss="categorical_crossentropy",
                metrics: Sequence[Union[str, MetricsType]] = (),
                mesh=None, seed: int = 0, device: Optional[str] = None):
        """reference: BaseModel.compile (base_model.py:128). Building the
        FFModel is deferred to fit/evaluate when batch size is known.
        ``device``: ``FFConfig.device`` (the card by default)."""
        self._opt = _resolve_opt(optimizer)
        self._loss = _LOSS[loss] if isinstance(loss, str) else loss
        self._metrics = [
            _METRIC[m] if isinstance(m, str) else m for m in metrics
        ]
        self._mesh = mesh
        self._seed = seed
        self._device = device

    def fit(self, x, y, epochs: int = 1, batch_size: int = 32,
            shuffle: bool = True, verbose: bool = False, callbacks=None,
            guard=None):
        """reference: BaseModel.fit (base_model.py:198). A changed
        batch_size forces a rebuild (the graph is compiled batch-first);
        epochs is honored on every call. ``callbacks`` follow the
        reference's keras callback surface (keras/callbacks.py); with
        callbacks present, training runs one epoch per FFModel.fit call so
        epoch hooks see fresh metrics."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        if (self.ffmodel is not None
                and self.ffmodel.config.batch_size != batch_size):
            # rebuild for the new batch size but keep trained weights
            # (Keras semantics: fit() never resets weights)
            carried = {name: {w: v.detach().clone() for w, v in ws.items()}
                       for name, ws in self.ffmodel.compiled.params.items()}
            self.ffmodel = None
            self._build(xs, batch_size, epochs)
            with torch.no_grad():
                for name, ws in self.ffmodel.compiled.params.items():
                    for w, v in ws.items():
                        old = carried.get(name, {}).get(w)
                        if old is not None and old.shape == v.shape:
                            v.copy_(old)
        self._build(xs, batch_size, epochs)
        if not callbacks:
            return self.ffmodel.fit(list(xs), y, epochs=epochs,
                                    shuffle=shuffle, verbose=verbose,
                                    guard=guard)

        from .callbacks import CallbackList

        self.stop_training = False
        cl = CallbackList(callbacks, self,
                          {"epochs": epochs, "batch_size": batch_size})
        cl.on_train_begin()
        history = []
        logs: Dict[str, float] = {}
        base_seed = self.ffmodel.config.seed
        try:
            for epoch in range(epochs):
                cl.on_epoch_begin(epoch)
                # distinct shuffle permutation per epoch: each one-epoch
                # fit builds a fresh DataLoaderGroup from config.seed
                self.ffmodel.config.seed = base_seed + epoch
                pms = self.ffmodel.fit(list(xs), y, epochs=1,
                                       shuffle=shuffle, verbose=verbose,
                                       guard=guard)
                pm = pms[-1]
                history.extend(pms)
                logs = {"accuracy": pm.accuracy}
                loss_alias = None
                for k in ("cce_loss", "sparse_cce_loss", "mse_loss",
                          "rmse_loss", "mae_loss"):
                    v = getattr(pm, k)
                    if v:
                        logs[k] = v / max(1, pm.train_all)
                        loss_alias = loss_alias or logs[k]
                if loss_alias is not None:
                    logs["loss"] = loss_alias  # generic monitor key
                cl.on_epoch_end(epoch, logs)
                if getattr(self, "stop_training", False):
                    break
        finally:
            self.ffmodel.config.seed = base_seed
        cl.on_train_end(logs)
        return history

    def evaluate(self, x, y, batch_size: int = 32, verbose: bool = False):
        xs = x if isinstance(x, (list, tuple)) else [x]
        if self.ffmodel is None:
            self._build(xs, batch_size, 1)
        return self.ffmodel.eval(list(xs), y, verbose=verbose)

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """One prediction per input row; the ragged tail batch is padded to
        the compiled batch size and the padding rows dropped."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        if self.ffmodel is None:
            self._build(xs, batch_size or xs[0].shape[0], 1)
        cm = self.ffmodel.compiled
        outs = []
        bs = self.ffmodel.config.batch_size
        dev = self.ffmodel.config.torch_device()
        n = xs[0].shape[0]
        for i in range(0, n, bs):
            batch = [np.asarray(a[i : i + bs]) for a in xs]
            valid = batch[0].shape[0]
            if valid < bs:
                batch = [
                    np.concatenate(
                        [b, np.repeat(b[-1:], bs - valid, axis=0)], axis=0
                    )
                    for b in batch
                ]
            out = cm.forward_fn(cm.params, *(torch.from_numpy(np.ascontiguousarray(b)).to(dev)
                                             for b in batch))
            outs.append(out[:valid].float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    @property
    def layers(self):
        return self._keras_layers()

    def summary(self) -> str:
        lines = [f"{type(self).__name__}:"]
        for l in self._keras_layers():
            lines.append(f"  {l.name} ({type(l).__name__})")
        return "\n".join(lines)

    # -- build ------------------------------------------------------------ #
    def _build(self, xs: Sequence[np.ndarray], batch_size: int, epochs: int):
        if self.ffmodel is not None:
            return
        assert self._opt is not None, "call compile() before fit()"
        cfg = FFConfig(batch_size=batch_size, epochs=epochs, seed=self._seed)
        if self._device is not None:
            cfg.device = self._device
        ff = FFModel(cfg)
        self._lower(ff, xs, batch_size)
        ff.compile(optimizer=self._opt, loss_type=self._loss,
                   metrics=self._metrics, mesh=self._mesh)
        self.ffmodel = ff

    def _lower(self, ff: FFModel, xs, batch_size: int):
        raise NotImplementedError

    def _keras_layers(self) -> List[KerasLayer]:
        raise NotImplementedError


def _np_dtype_to_ff(a: np.ndarray) -> DataType:
    if np.issubdtype(a.dtype, np.integer):
        return DataType.INT32
    return DataType.FLOAT


class Sequential(_BaseModel):
    """reference: python/flexflow/keras/models/sequential.py."""

    def __init__(self, layers: Optional[Sequence[KerasLayer]] = None):
        super().__init__()
        self._layers: List[KerasLayer] = list(layers or [])

    def add(self, layer: KerasLayer) -> None:
        self._layers.append(layer)

    def _keras_layers(self):
        return self._layers

    def _lower(self, ff, xs, batch_size):
        assert len(xs) == 1, "Sequential takes one input"
        x0 = xs[0]
        t = ff.create_tensor((batch_size,) + tuple(x0.shape[1:]),
                             dtype=_np_dtype_to_ff(x0), name="input")
        for layer in self._layers:
            t = layer.emit(ff, [t])
        return t


class Model(_BaseModel):
    """Functional model over Input() symbolic tensors (reference:
    python/flexflow/keras/models/model.py)."""

    def __init__(self, inputs, outputs, name: Optional[str] = None):
        super().__init__()
        self._inputs: List[SymTensor] = (
            list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        )
        self._outputs: List[SymTensor] = (
            list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
        )

    def _keras_layers(self):
        seen, order = set(), []

        def walk(t: SymTensor):
            if t.layer is not None and id(t.layer) not in seen:
                for i in t.inputs:
                    walk(i)
                seen.add(id(t.layer))
                order.append(t.layer)
            else:
                for i in t.inputs:
                    walk(i)

        for o in self._outputs:
            walk(o)
        return order

    def _lower(self, ff, xs, batch_size):
        assert len(xs) == len(self._inputs), (
            f"model has {len(self._inputs)} inputs, got {len(xs)} arrays"
        )
        env: Dict[int, object] = {}
        for sym, arr in zip(self._inputs, xs):
            env[id(sym)] = ff.create_tensor(
                (batch_size,) + tuple(arr.shape[1:]),
                dtype=_np_dtype_to_ff(arr),
            )

        def lower(t: SymTensor):
            if id(t) in env:
                return env[id(t)]
            ins = [lower(i) for i in t.inputs]
            out = t.layer.emit(ff, ins)
            env[id(t)] = out
            return out

        outs = [lower(o) for o in self._outputs]
        return outs[0] if len(outs) == 1 else outs
