"""Host-side functions backing the flat C model-building API.

PyTorch counterpart of ``flexflow_tpu/capi_host.py`` (reference:
include/flexflow/flexflow_c.h:80-706 — the reference exposes model
build/compile/fit to non-Python hosts through a flat C surface backed by
its C++ runtime). The port's C surface (``native/model_capi.cc`` beside
this package, built by :func:`flexflow_tpu_torch.native_bridge.build_capi`)
embeds the CPython interpreter and calls these helpers; each takes only
C-friendly argument types (ints, doubles, utf-8 strings, memoryviews of
caller buffers).

Enum arguments use the reference's ffconst integer values (ActiMode
NONE=10/RELU=11/..., PoolType MAX=30/AVG=31, DataType, LossType 50-54),
so a C program written against the reference's constants runs unchanged.
The ABI has no device argument: the model runs on the card unless the
host process sets ``FLEXFLOW_TPU_DEVICE=cpu``.
"""

from __future__ import annotations

import os

import numpy as np

from . import FFConfig, FFModel
from .ffconst import ActiMode, DataType, LossType, PoolType
from .runtime.optimizer import AdamOptimizer, SGDOptimizer

_LOSS_NAMES = {
    "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
}


def model_create(batch_size: int, epochs: int, num_devices: int,
                 only_data_parallel: int, search_budget: int) -> FFModel:
    if num_devices > 1:
        # the port runs one device a process: ranks come from a launcher
        raise ValueError(f"num_devices={num_devices}: a C host drives one device; "
                         "launch ranks with flexflow_tpu_torch.parallel.launch")
    cfg = FFConfig(batch_size=int(batch_size), epochs=int(epochs),
                   device=os.environ.get("FLEXFLOW_TPU_DEVICE", "cuda"))
    cfg.only_data_parallel = bool(only_data_parallel)
    cfg.search_budget = int(search_budget)
    return FFModel(cfg)


def create_tensor(model: FFModel, dims, dtype: int):
    return model.create_tensor(
        [int(d) for d in dims],
        DataType(int(dtype)) if dtype else DataType.FLOAT)


def dense(model, t, out_dim: int, acti: int, use_bias: int):
    return model.dense(t, int(out_dim), ActiMode(int(acti)),
                       use_bias=bool(use_bias))


def conv2d(model, t, out_channels, kh, kw, sh, sw, ph, pw, acti, groups,
           use_bias):
    return model.conv2d(t, int(out_channels), int(kh), int(kw), int(sh),
                        int(sw), int(ph), int(pw), ActiMode(int(acti)),
                        int(groups), bool(use_bias))


def pool2d(model, t, kh, kw, sh, sw, ph, pw, pool_type, acti):
    return model.pool2d(t, int(kh), int(kw), int(sh), int(sw), int(ph),
                        int(pw), PoolType(int(pool_type)),
                        ActiMode(int(acti)))


def unary(model, t, kind: str):
    return getattr(model, kind)(t)


def softmax(model, t, axis: int):
    return model.softmax(t, int(axis))


def concat(model, tensors, axis: int):
    return model.concat(list(tensors), int(axis))


def embedding(model, t, num_entries, out_dim):
    return model.embedding(t, int(num_entries), int(out_dim))


def compile_model(model: FFModel, optimizer: str, lr: float, loss,
                  metrics_csv: str) -> int:
    opt = (AdamOptimizer(alpha=float(lr)) if optimizer == "adam"
           else SGDOptimizer(lr=float(lr)))
    if isinstance(loss, str):
        lt = _LOSS_NAMES[loss]
    else:
        lt = LossType(int(loss))
    metrics = [m for m in (metrics_csv or "").split(",") if m]
    model.compile(optimizer=opt, loss_type=lt, metrics=metrics)
    return 0


def _array(buf, dims, is_int: int) -> np.ndarray:
    """A writable copy of a caller's buffer (torch takes no read-only
    numpy array)."""
    a = np.frombuffer(buf, dtype=np.int32 if is_int else np.float32)
    return a.reshape([int(d) for d in dims]).copy()


def fit(model: FFModel, xbufs, xdims_list, y_buf, y_dims, y_is_int: int,
        epochs: int) -> int:
    xs = [_array(b, d, 0) for b, d in zip(xbufs, xdims_list)]
    y = _array(y_buf, y_dims, y_is_int)
    model.fit(xs if len(xs) > 1 else xs[0], y, epochs=int(epochs),
              verbose=False)
    return 0


def evaluate(model: FFModel, xbufs, xdims_list, y_buf, y_dims,
             y_is_int: int) -> list:
    """Returns [accuracy, summed_loss] from a full eval pass."""
    xs = [_array(b, d, 0) for b, d in zip(xbufs, xdims_list)]
    y = _array(y_buf, y_dims, y_is_int)
    pm = model.eval(xs if len(xs) > 1 else xs[0], y, verbose=False)
    loss = (pm.cce_loss + pm.sparse_cce_loss + pm.mse_loss + pm.rmse_loss
            + pm.mae_loss)
    return [float(pm.accuracy), float(loss)]


def forward(model: FFModel, xbufs, xdims_list, out_buf) -> int:
    """Inference: logits for one batch written into caller buffer."""
    xs = [_array(b, d, 0) for b, d in zip(xbufs, xdims_list)]
    model.set_batch(list(xs))
    flat = model.forward().float().cpu().numpy().ravel()
    out = np.frombuffer(out_buf, dtype=np.float32)
    if flat.size != out.size:
        raise ValueError(f"logits buffer size {out.size} != {flat.size}")
    out[:] = flat
    return 0


def tensor_dims(t) -> list:
    return [int(d) for d in t.dims]


def get_weight(model: FFModel, op_name: str, weight_name: str,
               out_buf) -> int:
    v = model.numpy_params()[op_name][weight_name].astype(np.float32).ravel()
    out = np.frombuffer(out_buf, dtype=np.float32)
    if v.size != out.size:
        raise ValueError(f"weight buffer size {out.size} != {v.size}")
    out[:] = v
    return 0
