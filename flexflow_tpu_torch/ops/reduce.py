"""Reduction operators.

PyTorch counterpart of ``flexflow_tpu/ops/reduce.py``: ReduceSum and Mean
over ``axes``, with or without ``keepdims``; reducing every dim without
``keepdims`` gives shape (1,), as in the JAX package. Over a mesh whose
axis shards the batch dim 0, a reduction across it stays sharded: each
rank reduces its rows and the partial sums are all-reduced
(``collectives.reduce_from``; the mean divides by the global count), so
every rank holds the whole result, as GSPMD gives it in the JAX package.
Any other reduced dim that a strategy shards is gathered first.
"""

from __future__ import annotations

import math

import torch

from ..core.op import Op, register_op
from ..core.parallel_tensor import ParallelDim, ParallelTensorShape
from ..ffconst import OpType
from ..parallel import collectives as C


def _reduced_shape(sizes, axes, keepdims):
    axes = {a % len(sizes) for a in axes}
    out = [1 if i in axes else s for i, s in enumerate(sizes) if keepdims or i not in axes]
    return tuple(out) if out else (1,)


class _Reduce(Op):
    # the mesh axis sharding the reduced batch dim 0 (propagate); None: a
    # local reduction
    batch_axis = None

    def _axes(self):
        nd = len(self.input_shapes[0].dims)
        return tuple(sorted({a % nd for a in self.attrs["axes"]}))

    def reads_across(self, i):
        # a sharded batch dim among the axes stays sharded: a collective
        return tuple(a for a in self._axes() if a != 0)

    def infer_output_shapes(self):
        sizes = _reduced_shape(self.input_shapes[0].sizes, self.attrs["axes"],
                               self.attrs.get("keepdims", False))
        return [(sizes, self.input_shapes[0].dtype)]

    def propagate(self, input_shapes, strategy=None):
        """Input 0 arrives with every reduced dim but dim 0 gathered; the
        output keeps the partitioning of the dims it keeps, and is whole
        on every rank along the reduced ones."""
        self.honored_strategy_keys = set()
        in0 = self.readable(0, input_shapes[0])
        self.input_layouts = [in0]
        axes = set(self._axes())
        d0 = in0.dims[0]
        self.batch_axis = d0.axis if 0 in axes and d0.is_partitioned else None
        keep = self.attrs.get("keepdims", False)
        sizes, dtype = self.infer_output_shapes()[0]
        kept = [(i, d) for i, d in enumerate(in0.dims) if i not in axes or keep]
        if len(kept) == len(sizes):
            dims = tuple(ParallelDim(s, d.degree, d.axis) if d.is_partitioned and i not in axes
                         else ParallelDim(s) for (i, d), s in zip(kept, sizes))
        else:  # every dim reduced: shape (1,)
            dims = tuple(ParallelDim(s) for s in sizes)
        return [ParallelTensorShape(dims, dtype)], {}

    def _reduce(self, x: torch.Tensor, dims, keepdim: bool) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        axes = tuple(self.attrs["axes"])
        keep = self.attrs.get("keepdims", False)
        if ctx.mesh is not None and self.batch_axis:
            # the rows' partial sums, summed over the ranks holding the batch
            out = C.reduce_from(torch.sum(x, dim=axes, keepdim=keep).to(x.dtype),
                                ctx.mesh.group([self.batch_axis]))
            if self.op_type is OpType.MEAN:
                sizes = self.input_shapes[0].sizes
                out = out / math.prod(sizes[a] for a in self._axes())
        else:
            # torch reads an empty dim list as "every dim"; numpy as "none"
            out = self._reduce(x, axes, keep) if axes else x
        # this rank's block of the output (the whole output on one rank)
        shape = (self.output_shapes[0].local_sizes() if self.output_shapes
                 else self.infer_output_shapes()[0][0])
        return [out.reshape(shape)]


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
