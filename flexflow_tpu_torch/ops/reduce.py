"""Reduction operators.

PyTorch counterpart of ``flexflow_tpu/ops/reduce.py``: ReduceSum and Mean
over ``axes``, with or without ``keepdims``; reducing every dim without
``keepdims`` gives shape (1,), as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core.op import Op, register_op
from ..ffconst import OpType


def _reduced_shape(sizes, axes, keepdims):
    axes = {a % len(sizes) for a in axes}
    out = [1 if i in axes else s for i, s in enumerate(sizes) if keepdims or i not in axes]
    return tuple(out) if out else (1,)


class _Reduce(Op):
    def reads_across(self, i):
        nd = len(self.input_shapes[0].dims)
        return tuple(sorted({a % nd for a in self.attrs["axes"]}))

    def infer_output_shapes(self):
        sizes = _reduced_shape(self.input_shapes[0].sizes, self.attrs["axes"],
                               self.attrs.get("keepdims", False))
        return [(sizes, self.input_shapes[0].dtype)]

    def _reduce(self, x: torch.Tensor, dims, keepdim: bool) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        axes = tuple(self.attrs["axes"])
        # torch reads an empty dim list as "every dim"; numpy as "none"
        out = self._reduce(x, axes, self.attrs.get("keepdims", False)) if axes else x
        return [out.reshape(self.infer_output_shapes()[0][0])]


@register_op
class ReduceSum(_Reduce):
    op_type = OpType.REDUCE_SUM

    def _reduce(self, x, dims, keepdim):
        # torch sums int32 into int64; jnp.sum keeps the dtype
        return torch.sum(x, dim=dims, keepdim=keepdim).to(x.dtype)


@register_op
class Mean(_Reduce):
    op_type = OpType.MEAN

    def _reduce(self, x, dims, keepdim):
        return torch.mean(x, dim=dims, keepdim=keepdim)
