"""XDL ads ranking.

PyTorch counterpart of ``flexflow_tpu/models/xdl.py``: sparse id inputs,
sum-aggregated embeddings, their concat, then a bias-free top MLP with a
sigmoid on its second-to-last layer. ``embedding_strategy`` (for
example ``{"vocab": "model"}``) is every table's strategy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..ffconst import ActiMode, AggrMode, DataType
from ..runtime.model import FFModel


@dataclasses.dataclass
class XDLConfig:
    embedding_size: List[int] = dataclasses.field(default_factory=lambda: [1_000_000] * 4)
    embedding_bag_size: int = 1
    sparse_feature_size: int = 64
    mlp_top: List[int] = dataclasses.field(default_factory=lambda: [256, 512, 512, 1])


def build_xdl(ff: FFModel, batch_size: int, cfg: Optional[XDLConfig] = None,
              embedding_strategy: Optional[dict] = None):
    """Returns (the sparse id inputs, the output); ``embedding_strategy``
    shards every table (the DLRM-style vocab sharding)."""
    cfg = cfg or XDLConfig()
    inputs, embedded = [], []
    for i, vocab in enumerate(cfg.embedding_size):
        s = ff.create_tensor((batch_size, cfg.embedding_bag_size), DataType.INT32,
                             name=f"sparse{i}")
        inputs.append(s)
        embedded.append(ff.embedding(s, vocab, cfg.sparse_feature_size, AggrMode.SUM,
                                     name=f"emb{i}", strategy=embedding_strategy))
    t = ff.concat(embedded, axis=-1)
    sigmoid_layer = len(cfg.mlp_top) - 2
    for i, out_dim in enumerate(cfg.mlp_top):
        act = ActiMode.SIGMOID if i == sigmoid_layer else ActiMode.RELU
        if i == len(cfg.mlp_top) - 1:
            act = ActiMode.NONE
        t = ff.dense(t, out_dim, act, use_bias=False, name=f"mlp{i}")
    return inputs, t
