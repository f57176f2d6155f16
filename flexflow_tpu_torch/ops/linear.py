"""Linear (dense) operator.

PyTorch counterpart of ``flexflow_tpu/ops/linear.py``. The product is
``torch.matmul`` (XLA's dot in the JAX package, outside any Pallas
kernel); the weight keeps the JAX layout, ``kernel`` (in, out).

Tensor parallelism follows the strategy keys of the JAX op: ``"out"``
shards the out-features (column-parallel: the replicated input enters
through ``copy_to``, whose backward all-reduces its gradient), ``"in"``
the in-features (row-parallel: the input arrives sharded on its last dim,
the partial products are all-reduced, then the bias is added once).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..ffconst import ActiMode, OpType
from ..core.op import LowerCtx, Op, WeightSpec, register_op
from ..core.parallel_tensor import ParallelDim, ParallelTensorShape
from ..parallel import collectives as C
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
        # mesh axes the strategy shards the features over (propagate)
        self.out_axis = self.in_axis = None

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

    def propagate(self, input_shapes, strategy=None):
        """The JAX op's rule: ``"out"`` shards the kernel's and the output's
        feature dim, ``"in"`` the kernel's in dim (the input arrives
        sharded there), each when its axis has a degree above 1 that
        divides the dim and shards no other dim of the tensor."""
        strategy = strategy or {}
        sizes = strategy.get("_axis_sizes", {})
        self.honored_strategy_keys = set()
        in0 = input_shapes[0]
        out_dims = [ParallelDim(s, d.degree, d.axis) if d.is_partitioned else ParallelDim(s)
                    for s, d in zip(in0.sizes[:-1], in0.dims[:-1])]
        used = {d.axis for d in out_dims if d.is_partitioned}
        kdims = [ParallelDim(self.in_dim), ParallelDim(self.out_dim)]
        out_feat = ParallelDim(self.out_dim)
        in_feat = ParallelDim(self.in_dim)
        self.out_axis = self.in_axis = None
        ax = strategy.get("out")
        if ax and ax not in used and sizes.get(ax, 1) > 1 and self.out_dim % sizes[ax] == 0:
            kdims[1] = out_feat = ParallelDim(self.out_dim, sizes[ax], ax)
            self.out_axis = ax
        ax = strategy.get("in")
        if ax and ax not in used and sizes.get(ax, 1) > 1 and self.in_dim % sizes[ax] == 0:
            kdims[0] = in_feat = ParallelDim(self.in_dim, sizes[ax], ax)
            self.in_axis = ax
        self.input_layouts = [ParallelTensorShape(tuple(out_dims + [in_feat]), in0.dtype)]
        weight_shapes = {"kernel": ParallelTensorShape(tuple(kdims), in0.dtype)}
        if self.use_bias:
            weight_shapes["bias"] = ParallelTensorShape((out_feat,), in0.dtype)
        return [ParallelTensorShape(tuple(out_dims + [out_feat]), in0.dtype)], weight_shapes

    def flops(self) -> float:
        return 2.0 * math.prod(self.input_shapes[0].sizes[:-1]) * self.in_dim * self.out_dim

    def input_contraction_dims(self):
        return [(0, len(self.input_shapes[0].dims) - 1, "kernel", 0)]

    def forward(self, ctx: LowerCtx, inputs: Sequence[torch.Tensor], weights):
        (x,) = inputs
        mesh = ctx.mesh
        if mesh is not None and self.out_axis:
            x = C.copy_to(x, mesh.group([self.out_axis]))
        y = torch.matmul(x, weights["kernel"])
        if mesh is not None and self.in_axis:
            y = C.reduce_from(y, mesh.group([self.in_axis]))
        if self.use_bias:
            y = y + weights["bias"]
        return [apply_activation(y, self.activation)]
