"""The MLP workload: stacked dense layers with a softmax head (PyTorch
counterpart of ``flexflow_tpu/models/mlp.py``)."""

from __future__ import annotations

from typing import Sequence

from ..ffconst import ActiMode, DataType


def build_mlp(ff, batch_size: int, in_dim: int = 1024,
              hidden_dims: Sequence[int] = (2048, 2048, 2048, 2048),
              num_classes: int = 10):
    """Add the MLP to ``ff``: ``len(hidden_dims)`` ReLU dense layers, a
    dense head of ``num_classes`` and a softmax. Returns (input, output)."""
    x = ff.create_tensor((batch_size, in_dim), DataType.FLOAT, name="input")
    t = x
    for i, h in enumerate(hidden_dims):
        t = ff.dense(t, h, ActiMode.RELU, name=f"mlp_dense{i}")
    t = ff.dense(t, num_classes, name="mlp_head")
    t = ff.softmax(t)
    return x, t
