"""Transformer workload.

PyTorch counterpart of ``build_transformer`` in
``flexflow_tpu/models/transformer.py``: the reference's headline benchmark
model (input (batch, seq=512, hidden=1024); 12 encoder layers of
[MHA(hidden, 16 heads) -> dense(hidden, RELU, no bias) -> dense(hidden)];
final dense(1, no bias)). The layer names match the JAX package's, so
params carry across by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ffconst import ActiMode, DataType
from ..runtime.model import FFModel


@dataclasses.dataclass
class TransformerConfig:
    hidden_size: int = 1024
    embedding_size: int = 1024
    num_heads: int = 16
    num_layers: int = 12
    sequence_length: int = 512


def _encoder_layer(ff: FFModel, t, cfg: TransformerConfig, i: int):
    """MHA then two dense layers, no residual/norm."""
    t = ff.multihead_attention(t, t, t, cfg.hidden_size, cfg.num_heads,
                               name=f"enc{i}_attn")
    t = ff.dense(t, cfg.hidden_size, ActiMode.RELU, use_bias=False,
                 name=f"enc{i}_ff1")
    return ff.dense(t, cfg.hidden_size, name=f"enc{i}_ff2")


def build_transformer(ff: FFModel, batch_size: int,
                      cfg: Optional[TransformerConfig] = None):
    cfg = cfg or TransformerConfig()
    x = ff.create_tensor((batch_size, cfg.sequence_length, cfg.hidden_size),
                         DataType.FLOAT, name="input")
    t = x
    for i in range(cfg.num_layers):
        t = _encoder_layer(ff, t, cfg, i)
    t = ff.dense(t, 1, use_bias=False, name="head")
    return x, t
