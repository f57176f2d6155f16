"""NMT: an LSTM encoder-decoder translation model.

PyTorch counterpart of ``flexflow_tpu/models/nmt.py``: source embedding ->
stacked LSTM encoder whose last layer returns its final (h, c) ->
target embedding -> stacked LSTM decoder, its first layer seeded with that
state -> vocabulary projection and softmax. Trained teacher-forced with
sparse cross-entropy over the (batch, tgt_len, vocab) output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ffconst import DataType
from ..runtime.model import FFModel


@dataclasses.dataclass
class NMTConfig:
    src_vocab_size: int = 8000
    tgt_vocab_size: int = 8000
    embed_dim: int = 256
    hidden_size: int = 512
    num_layers: int = 2
    src_length: int = 32
    tgt_length: int = 32


def build_nmt(ff: FFModel, batch_size: int, cfg: Optional[NMTConfig] = None):
    """Returns (src ids (B, S_src), decoder input ids (B, S_tgt), the
    (B, S_tgt, V_tgt) distribution); both inputs int32."""
    cfg = cfg or NMTConfig()
    src = ff.create_tensor((batch_size, cfg.src_length), DataType.INT32, name="src_tokens")
    tgt = ff.create_tensor((batch_size, cfg.tgt_length), DataType.INT32, name="tgt_tokens")
    enc = ff.embedding(src, cfg.src_vocab_size, cfg.embed_dim, name="src_embed")
    state = None
    for i in range(cfg.num_layers):
        last = i == cfg.num_layers - 1
        out = ff.lstm(enc, cfg.hidden_size, return_sequences=True, return_state=last,
                      name=f"encoder_lstm_{i}")
        if last:
            enc, h, c = out
            state = (h, c)
        else:
            enc = out
    dec = ff.embedding(tgt, cfg.tgt_vocab_size, cfg.embed_dim, name="tgt_embed")
    for i in range(cfg.num_layers):
        dec = ff.lstm(dec, cfg.hidden_size, return_sequences=True,
                      initial_state=state if i == 0 else None, name=f"decoder_lstm_{i}")
    logits = ff.dense(dec, cfg.tgt_vocab_size, name="vocab_proj")
    probs = ff.softmax(logits, name="vocab_softmax")
    return src, tgt, probs
