"""Mixture-of-experts workload: MNIST-sized 784-d inputs through the
``FFModel.moe`` composite (gate -> top_k -> group_by -> experts ->
aggregate), then a dense head and a softmax.

PyTorch counterpart of ``flexflow_tpu/models/moe.py``, with the same
defaults and layer names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ffconst import DataType
from ..runtime.model import FFModel


@dataclasses.dataclass
class MoeConfig:
    input_dim: int = 784
    num_classes: int = 10
    num_exp: int = 5
    num_select: int = 2
    expert_hidden_size: int = 64
    alpha: float = 2.0
    lambda_bal: float = 0.04


def build_moe_mnist(ff: FFModel, batch_size: int, cfg: Optional[MoeConfig] = None,
                    stacked: bool = False, expert_axis: Optional[str] = None):
    """Returns (input tensor, softmax output). ``stacked=True`` builds the
    stacked formulation; ``expert_axis`` shards its experts over that mesh
    axis (expert parallelism when it is the axis that shards the batch,
    ``"data"``)."""
    cfg = cfg or MoeConfig()
    x = ff.create_tensor((batch_size, cfg.input_dim), DataType.FLOAT, name="input")
    t = ff.moe(x, cfg.num_exp, cfg.num_select, cfg.expert_hidden_size,
               cfg.alpha, cfg.lambda_bal, stacked=stacked,
               expert_axis=expert_axis, name="moe")
    t = ff.dense(t, cfg.num_classes, name="moe_head")
    t = ff.softmax(t)
    return x, t
