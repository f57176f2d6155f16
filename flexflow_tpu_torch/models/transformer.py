"""Transformer workload.

PyTorch counterpart of ``build_transformer`` in
``flexflow_tpu/models/transformer.py``: the reference's headline benchmark
model (input (batch, seq=512, hidden=1024); 12 encoder layers of
[MHA(hidden, 16 heads) -> dense(hidden, RELU, no bias) -> dense(hidden)];
final dense(1, no bias)); and of ``build_bert_proxy``, the BERT-style
encoder with residuals and LayerNorm (hidden 768, 12 heads, 12 layers, seq
128). The layer names match the JAX package's, so params carry across by
name. ``tp_axis`` shards the attention heads and the MLP hidden over a
mesh axis (``{"heads": ax}``, ``{"out": ax}`` then ``{"in": ax}``);
``seq_axis`` shards the attention over the sequence (``seq_mode``
``"ring"`` or ``"a2a"``), as the JAX builders' strategies do.
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


def _tp(key: str, tp_axis: Optional[str]):
    return {key: tp_axis} if tp_axis else None


def _encoder_layer(ff: FFModel, t, cfg: TransformerConfig, i: int,
                   tp_axis: Optional[str] = None, seq_axis: Optional[str] = None,
                   seq_mode: str = "ring"):
    """MHA then two dense layers, no residual/norm."""
    attn_strategy = _tp("heads", tp_axis)
    if seq_axis:
        attn_strategy = dict(attn_strategy or {}, seq=seq_axis, seq_mode=seq_mode)
    t = ff.multihead_attention(t, t, t, cfg.hidden_size, cfg.num_heads,
                               name=f"enc{i}_attn", strategy=attn_strategy)
    t = ff.dense(t, cfg.hidden_size, ActiMode.RELU, use_bias=False,
                 name=f"enc{i}_ff1", strategy=_tp("out", tp_axis))
    return ff.dense(t, cfg.hidden_size, name=f"enc{i}_ff2", strategy=_tp("in", tp_axis))


def build_transformer(ff: FFModel, batch_size: int,
                      cfg: Optional[TransformerConfig] = None,
                      tp_axis: Optional[str] = None, seq_axis: Optional[str] = None,
                      seq_mode: str = "ring"):
    cfg = cfg or TransformerConfig()
    x = ff.create_tensor((batch_size, cfg.sequence_length, cfg.hidden_size),
                         DataType.FLOAT, name="input")
    t = x
    for i in range(cfg.num_layers):
        t = _encoder_layer(ff, t, cfg, i, tp_axis, seq_axis, seq_mode)
    t = ff.dense(t, 1, use_bias=False, name="head")
    return x, t


def build_bert_proxy(ff: FFModel, batch_size: int,
                     cfg: Optional[TransformerConfig] = None,
                     tp_axis: Optional[str] = None):
    """BERT-style encoder: per layer MHA, residual, LayerNorm, a GELU MLP
    (4x hidden), residual, LayerNorm. Returns (input, output)."""
    cfg = cfg or TransformerConfig(hidden_size=768, num_heads=12, num_layers=12,
                                   sequence_length=128)
    x = ff.create_tensor((batch_size, cfg.sequence_length, cfg.hidden_size),
                         DataType.FLOAT, name="input")
    t = x
    for i in range(cfg.num_layers):
        a = ff.multihead_attention(t, t, t, cfg.hidden_size, cfg.num_heads,
                                   name=f"bert{i}_attn", strategy=_tp("heads", tp_axis))
        t = ff.layer_norm(ff.add(t, a), axes=(-1,), name=f"bert{i}_ln1")
        h = ff.dense(t, 4 * cfg.hidden_size, ActiMode.GELU, name=f"bert{i}_ff1",
                     strategy=_tp("out", tp_axis))
        h = ff.dense(h, cfg.hidden_size, name=f"bert{i}_ff2", strategy=_tp("in", tp_axis))
        t = ff.layer_norm(ff.add(t, h), axes=(-1,), name=f"bert{i}_ln2")
    return x, t
