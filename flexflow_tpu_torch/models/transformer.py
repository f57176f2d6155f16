"""Transformer workload.

PyTorch counterpart of ``build_transformer`` in
``flexflow_tpu/models/transformer.py``: the reference's headline benchmark
model (input (batch, seq=512, hidden=1024); 12 encoder layers of
[MHA(hidden, 16 heads) -> dense(hidden, RELU, no bias) -> dense(hidden)];
final dense(1, no bias)); and of ``build_bert_proxy``, the BERT-style
encoder with residuals and LayerNorm (hidden 768, 12 heads, 12 layers, seq
128). The layer names match the JAX package's, so params carry across by
name.
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


def build_bert_proxy(ff: FFModel, batch_size: int,
                     cfg: Optional[TransformerConfig] = None,
                     tp_axis: Optional[str] = None):
    """BERT-style encoder: per layer MHA, residual, LayerNorm, a GELU MLP
    (4x hidden), residual, LayerNorm. Returns (input, output). ``tp_axis``
    raises until the port has a mesh (queue A7)."""
    if tp_axis is not None:
        raise NotImplementedError(
            f"build_bert_proxy(tp_axis={tp_axis!r}): tensor parallelism needs a "
            f"mesh (ROADMAP queue A7)")
    cfg = cfg or TransformerConfig(hidden_size=768, num_heads=12, num_layers=12,
                                   sequence_length=128)
    x = ff.create_tensor((batch_size, cfg.sequence_length, cfg.hidden_size),
                         DataType.FLOAT, name="input")
    t = x
    for i in range(cfg.num_layers):
        a = ff.multihead_attention(t, t, t, cfg.hidden_size, cfg.num_heads,
                                   name=f"bert{i}_attn")
        t = ff.layer_norm(ff.add(t, a), axes=(-1,), name=f"bert{i}_ln1")
        h = ff.dense(t, 4 * cfg.hidden_size, ActiMode.GELU, name=f"bert{i}_ff1")
        h = ff.dense(h, cfg.hidden_size, name=f"bert{i}_ff2")
        t = ff.layer_norm(ff.add(t, h), axes=(-1,), name=f"bert{i}_ln2")
    return x, t
