"""Dropout operator.

PyTorch counterpart of ``flexflow_tpu/ops/dropout.py``: while training,
each element is kept with probability 1 - ``rate`` and scaled by 1 / keep,
the mask drawn from the op's ``torch.Generator`` for the step
(:meth:`~flexflow_tpu_torch.core.op.LowerCtx.generator`); in eval and
inference, or at rate 0, the identity. The masks cannot match JAX's bit
for bit: the two packages draw from different generators. Under a mesh a
rank draws the mask of the whole tensor and keeps its block, so a sharded
run drops what the one-rank run drops.
"""

from __future__ import annotations

import torch

from ..core.op import LowerCtx, Op, register_op
from ..ffconst import OpType


def drop(x: torch.Tensor, rate: float, ctx: LowerCtx, op_name: str,
         layout=None) -> torch.Tensor:
    """``x`` with each element kept with probability 1 - ``rate`` and
    scaled by 1 / keep (the JAX package's ``where(mask, x / keep, 0)``).
    ``layout``: the whole tensor's ``ParallelTensorShape`` when ``x`` is
    this rank's block of it under ``ctx.mesh``."""
    keep = 1.0 - rate
    gen = ctx.generator(op_name, x.device)
    if ctx.mesh is not None and layout is not None:
        u = torch.rand(layout.sizes, generator=gen,
                       device=x.device)[ctx.mesh.local_slices(layout)]
    else:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


@register_op
class Dropout(Op):
    op_type = OpType.DROPOUT

    def reads_across(self, i):
        return ()

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        rate = float(self.attrs.get("rate", 0.5))
        if not ctx.training or rate <= 0.0:
            return [x]
        return [drop(x, rate, ctx, self.name, self.input_layouts[0])]
