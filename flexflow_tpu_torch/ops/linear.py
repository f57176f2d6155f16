"""Linear (dense) operator.

PyTorch counterpart of ``flexflow_tpu/ops/linear.py``. The product is
``torch.matmul`` (XLA's dot in the JAX package, outside any Pallas
kernel); the weight keeps the JAX layout, ``kernel`` (in, out).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..ffconst import ActiMode, OpType
from ..core.op import LowerCtx, Op, WeightSpec, register_op
from ..runtime.initializer import DefaultBiasInitializer, DefaultWeightInitializer


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``, the reference's ReLU: at an exact 0 the
    gradient is 0.5 (a tie's gradient is split), where ``torch.relu``'s is
    0."""
    return torch.maximum(x, torch.zeros_like(x))


def apply_activation(x: torch.Tensor, mode: ActiMode) -> torch.Tensor:
    if mode is ActiMode.NONE:
        return x
    if mode is ActiMode.RELU:
        return relu(x)
    if mode is ActiMode.SIGMOID:
        return torch.sigmoid(x)
    if mode is ActiMode.TANH:
        return torch.tanh(x)
    if mode is ActiMode.GELU:
        return F.gelu(x, approximate="none")
    raise ValueError(mode)


@register_op
class Linear(Op):
    op_type = OpType.LINEAR

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.out_dim: int = layer.attrs["out_dim"]
        self.activation: ActiMode = layer.attrs.get("activation", ActiMode.NONE)
        self.use_bias: bool = layer.attrs.get("use_bias", True)
        self.in_dim: int = input_shapes[0].sizes[-1]

    def infer_output_shapes(self):
        sizes = self.input_shapes[0].sizes[:-1] + (self.out_dim,)
        return [(sizes, self.input_shapes[0].dtype)]

    def weight_specs(self) -> List[WeightSpec]:
        dt = self.input_shapes[0].dtype
        specs = [WeightSpec(
            "kernel", (self.in_dim, self.out_dim), dt,
            self.attrs.get("kernel_initializer") or DefaultWeightInitializer())]
        if self.use_bias:
            specs.append(WeightSpec(
                "bias", (self.out_dim,), dt,
                self.attrs.get("bias_initializer") or DefaultBiasInitializer(),
                weight_decay=False))
        return specs

    def forward(self, ctx: LowerCtx, inputs: Sequence[torch.Tensor], weights):
        (x,) = inputs
        y = torch.matmul(x, weights["kernel"])
        if self.use_bias:
            y = y + weights["bias"]
        return [apply_activation(y, self.activation)]
