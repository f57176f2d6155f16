"""LayerNorm operator.

PyTorch counterpart of ``LayerNorm`` in ``flexflow_tpu/ops/norm.py``: the
mean and the population variance (ddof 0) over any set of ``axes``, then
``scale`` and ``bias`` (shaped like the normalized dims) when
``elementwise_affine``. Where the axes are the trailing dims this is
``F.layer_norm``; elsewhere the same math in plain torch ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import OpType
from ..runtime.initializer import ConstantInitializer, ZeroInitializer


@register_op
class LayerNorm(Op):
    op_type = OpType.LAYERNORM

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        nd = len(input_shapes[0].sizes)
        self.axes = tuple(sorted({a % nd for a in self.attrs["axes"]}))
        self.eps = float(self.attrs.get("eps", 1e-5))
        self.affine = bool(self.attrs.get("elementwise_affine", True))
        self.norm_shape = tuple(input_shapes[0].sizes[a] for a in self.axes)
        self.trailing = self.axes == tuple(range(nd - len(self.axes), nd))

    def reads_across(self, i):
        return self.axes

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def weight_specs(self):
        if not self.affine:
            return []
        dt = self.input_shapes[0].dtype
        return [
            WeightSpec("scale", self.norm_shape, dt, ConstantInitializer(1.0),
                       weight_decay=False),
            WeightSpec("bias", self.norm_shape, dt, ZeroInitializer(), weight_decay=False),
        ]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        scale = weights["scale"] if self.affine else None
        bias = weights["bias"] if self.affine else None
        if self.trailing:
            return [F.layer_norm(x, self.norm_shape, scale, bias, self.eps)]
        mean = x.mean(dim=self.axes, keepdim=True)
        var = x.var(dim=self.axes, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            # broadcast scale/bias over the normalized axes
            shape = [1] * x.dim()
            for a in self.axes:
                shape[a] = x.shape[a]
            y = y * scale.reshape(shape) + bias.reshape(shape)
        return [y]
