"""Dropout operator.

PyTorch counterpart of ``flexflow_tpu/ops/dropout.py``: while training,
each element is kept with probability 1 - ``rate`` and scaled by 1 / keep,
the mask drawn from the op's ``torch.Generator`` for the step
(:meth:`~flexflow_tpu_torch.core.op.LowerCtx.generator`); in eval and
inference, or at rate 0, the identity. The masks cannot match JAX's bit
for bit: the two packages draw from different generators.
"""

from __future__ import annotations

import torch

from ..core.op import LowerCtx, Op, register_op
from ..ffconst import OpType


def drop(x: torch.Tensor, rate: float, ctx: LowerCtx, op_name: str) -> torch.Tensor:
    """``x`` with each element kept with probability 1 - ``rate`` and
    scaled by 1 / keep (the JAX package's ``where(mask, x / keep, 0)``)."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=ctx.generator(op_name, x.device),
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


@register_op
class Dropout(Op):
    op_type = OpType.DROPOUT

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        rate = float(self.attrs.get("rate", 0.5))
        if not ctx.training or rate <= 0.0:
            return [x]
        return [drop(x, rate, ctx, self.name)]
