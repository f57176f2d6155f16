"""GPT-style decoder-only causal language model.

PyTorch counterpart of ``flexflow_tpu/models/gpt.py``: token and learned
position embeddings, pre-LN blocks (causal multi-head attention, a GELU
MLP) with residuals, a final LayerNorm and an untied vocab head. The same
layer and weight names as the JAX package's, so ``load_numpy_params``
carries a JAX GPT across. The graph trains (sparse cross-entropy over the
(B, S, vocab) logits) and drives the KV-cache ``Generator``
(``serving/generation.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ffconst import ActiMode, DataType
from ..runtime.model import FFModel


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    max_positions: int = 1024
    hidden_size: int = 512
    num_heads: int = 8
    num_layers: int = 6
    mlp_ratio: int = 4


def build_gpt(ff: FFModel, batch_size: int, seq_length: int,
              cfg: Optional[GPTConfig] = None, tp_axis: Optional[str] = None):
    """Returns (tokens, positions, logits), the inputs int32 (B, S) and the
    logits (B, S, vocab) raw. ``tp_axis`` shards the attention heads and
    the MLP hidden over a mesh axis."""
    cfg = cfg or GPTConfig()
    heads = {"heads": tp_axis} if tp_axis else None
    up = {"out": tp_axis} if tp_axis else None
    down = {"in": tp_axis} if tp_axis else None
    tokens = ff.create_tensor((batch_size, seq_length), DataType.INT32, name="tokens")
    positions = ff.create_tensor((batch_size, seq_length), DataType.INT32,
                                 name="positions")
    h = ff.add(
        ff.embedding(tokens, cfg.vocab_size, cfg.hidden_size, name="wte"),
        ff.embedding(positions, cfg.max_positions, cfg.hidden_size, name="wpe"),
        name="embed_sum")
    for i in range(cfg.num_layers):
        ln1 = ff.layer_norm(h, axes=[-1], name=f"block{i}_ln1")
        attn = ff.multihead_attention(ln1, ln1, ln1, cfg.hidden_size, cfg.num_heads,
                                      causal=True, name=f"block{i}_attn", strategy=heads)
        h = ff.add(h, attn, name=f"block{i}_res1")
        ln2 = ff.layer_norm(h, axes=[-1], name=f"block{i}_ln2")
        m = ff.dense(ln2, cfg.mlp_ratio * cfg.hidden_size, ActiMode.GELU,
                     name=f"block{i}_mlp_up", strategy=up)
        m = ff.dense(m, cfg.hidden_size, name=f"block{i}_mlp_down", strategy=down)
        h = ff.add(h, m, name=f"block{i}_res2")
    h = ff.layer_norm(h, axes=[-1], name="ln_f")
    logits = ff.dense(h, cfg.vocab_size, use_bias=False, name="lm_head")
    return tokens, positions, logits
