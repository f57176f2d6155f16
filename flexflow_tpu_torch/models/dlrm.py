"""DLRM.

PyTorch counterpart of ``flexflow_tpu/models/dlrm.py``: sum-aggregated
embedding tables and a bottom MLP on the dense features, their concat (the
"cat" interaction), then the top MLP with a sigmoid on its last layer.
``param_axis`` shards every table on its vocab dim over that mesh axis
(the JAX package's parameter parallelism for DLRM).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..ffconst import ActiMode, AggrMode, DataType
from ..runtime.model import FFModel


@dataclasses.dataclass
class DLRMConfig:
    sparse_feature_size: int = 64
    embedding_size: List[int] = dataclasses.field(
        default_factory=lambda: [1000000, 1000000, 1000000, 1000000])
    embedding_bag_size: int = 1
    mlp_bot: List[int] = dataclasses.field(default_factory=lambda: [4, 64, 64])
    mlp_top: List[int] = dataclasses.field(default_factory=lambda: [64, 64, 2])
    sigmoid_bot: int = -1
    sigmoid_top: int = -1


def _mlp(ff: FFModel, t, dims: List[int], sigmoid_layer: int, prefix: str):
    for i in range(len(dims) - 1):
        act = ActiMode.SIGMOID if i == sigmoid_layer else ActiMode.RELU
        t = ff.dense(t, dims[i + 1], act, name=f"{prefix}_{i}")
    return t


def build_dlrm(ff: FFModel, batch_size: int, cfg: Optional[DLRMConfig] = None,
               param_axis: Optional[str] = None):
    """Returns (the sparse id inputs + the dense input, the output).
    ``param_axis``: the mesh axis the tables' vocab dim shards over."""
    cfg = cfg or DLRMConfig()
    sparse_inputs = [
        ff.create_tensor((batch_size, cfg.embedding_bag_size), DataType.INT32,
                         name=f"sparse_{i}")
        for i in range(len(cfg.embedding_size))]
    dense_input = ff.create_tensor((batch_size, cfg.mlp_bot[0]), DataType.FLOAT,
                                   name="dense_input")
    strategy = {"vocab": param_axis} if param_axis else None
    ly = [ff.embedding(inp, vocab, cfg.sparse_feature_size, AggrMode.SUM, name=f"emb_{i}",
                       strategy=strategy)
          for i, (inp, vocab) in enumerate(zip(sparse_inputs, cfg.embedding_size))]
    x = _mlp(ff, dense_input, cfg.mlp_bot, cfg.sigmoid_bot, "bot")
    z = ff.concat(ly + [x], axis=-1)
    # sigmoid_top = -1: the sigmoid goes on the top MLP's last layer
    sigmoid_top = cfg.sigmoid_top if cfg.sigmoid_top >= 0 else len(cfg.mlp_top) - 2
    p = _mlp(ff, z, [z.dims[-1]] + cfg.mlp_top[1:], sigmoid_top, "top")
    return sparse_inputs + [dense_input], p
