"""Softmax operator.

PyTorch counterpart of ``flexflow_tpu/ops/softmax.py``: softmax over the
``dim`` attribute (``FFModel.softmax``'s ``axis``), in the input's dtype.
"""

from __future__ import annotations

import math

import torch

from ..core.op import Op, register_op
from ..ffconst import OpType


@register_op
class Softmax(Op):
    op_type = OpType.SOFTMAX

    def reads_across(self, i):
        return (self.attrs.get("dim", -1) % len(self.input_shapes[0].dims),)

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        return [torch.softmax(inputs[0], dim=self.attrs.get("dim", -1))]

    def flops(self) -> float:
        return 5.0 * math.prod(self.input_shapes[0].sizes)
