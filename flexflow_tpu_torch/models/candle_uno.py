"""CANDLE-Uno drug response.

PyTorch counterpart of ``flexflow_tpu/models/candle_uno.py``: a bias-free
ReLU dense tower for each non-dose input (one tower an input, not shared
across inputs of a feature type), the concat of the seven encoded inputs,
the top dense stack and a scalar response (an MSE loss).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..ffconst import ActiMode, DataType
from ..runtime.model import FFModel


@dataclasses.dataclass
class CandleUnoConfig:
    dense_layers: List[int] = dataclasses.field(default_factory=lambda: [4192] * 4)
    dense_feature_layers: List[int] = dataclasses.field(default_factory=lambda: [4192] * 8)
    feature_shapes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "dose": 1,
            "cell.rnaseq": 942,
            "drug.descriptors": 5270,
            "drug.fingerprints": 2048,
        })
    input_features: Dict[str, str] = dataclasses.field(
        default_factory=lambda: {
            "dose1": "dose",
            "dose2": "dose",
            "cell.rnaseq": "cell.rnaseq",
            "drug1.descriptors": "drug.descriptors",
            "drug1.fingerprints": "drug.fingerprints",
            "drug2.descriptors": "drug.descriptors",
            "drug2.fingerprints": "drug.fingerprints",
        })


def build_candle_uno(ff: FFModel, batch_size: int, cfg: Optional[CandleUnoConfig] = None):
    """Returns (the seven inputs, the (batch, 1) response)."""
    cfg = cfg or CandleUnoConfig()
    inputs, encoded = [], []
    for name, ftype in cfg.input_features.items():
        tag = name.replace(".", "_")
        x = ff.create_tensor((batch_size, cfg.feature_shapes[ftype]), DataType.FLOAT,
                             name=tag)
        inputs.append(x)
        t = x
        if ftype != "dose":  # dose inputs skip the towers
            for li, width in enumerate(cfg.dense_feature_layers):
                t = ff.dense(t, width, ActiMode.RELU, use_bias=False, name=f"{tag}_t{li}")
        encoded.append(t)
    out = ff.concat(encoded, axis=-1)
    for li, width in enumerate(cfg.dense_layers):
        out = ff.dense(out, width, ActiMode.RELU, use_bias=False, name=f"top{li}")
    out = ff.dense(out, 1, ActiMode.NONE, use_bias=False, name="response")
    return inputs, out
