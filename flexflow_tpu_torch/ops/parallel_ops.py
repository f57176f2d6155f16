"""Parallel operators and the layout transitions between ops.

PyTorch counterpart of ``flexflow_tpu/ops/parallel_ops.py``. The JAX
package's parallel ops only rewrite a tensor's ``ParallelTensorShape``
and let GSPMD move the data. Here each rank holds its block, so the data
movement is real: :func:`reshard` turns a block in one layout into the
block of another (an all-gather for each dim that stops being sharded, a
slice for each that starts), with the autograd pairs of
``parallel/collectives.py``. The compiler calls it wherever a producer's
layout differs from the layout its consumer's ``propagate`` asked for;
the ops below call it for the layout they name:

============  ================================  ============================
op            layout                            data movement (forward)
============  ================================  ============================
Repartition   shard one dim over an axis        slice (backward: all_gather)
Combine       unshard one dim                   all_gather (backward: slice)
Replicate     add a replica axis                identity
Reduction     sum over a replica axis           identity
AllReduce     (marker)                          identity
============  ================================  ============================

Replicate, Reduction and AllReduce leave values as they are, as in the
JAX package: an op whose output is a partial sum all-reduces it itself
(Linear ``"in"``, attention ``"heads"``), and one that computes on a
sharded copy of a replicated input all-reduces that input's gradient
itself (Linear ``"out"``, attention ``"heads"``), so a tensor between ops
is whole on every rank of its replica axes, and its gradient too. A
second sum here would multiply by the axis's degree. Without a mesh
every one of them is the identity.
"""

from __future__ import annotations

import torch

from ..core.op import Op, register_op
from ..core.parallel_tensor import ParallelTensorShape
from ..ffconst import OpType
from ..parallel import collectives as C


def reshard(x: torch.Tensor, src: ParallelTensorShape, dst: ParallelTensorShape,
            mesh) -> torch.Tensor:
    """This rank's block of ``dst`` from its block ``x`` of ``src`` (the
    same global tensor): gathers first, then slices; differentiable."""
    for d, (a, b) in enumerate(zip(src.dims, dst.dims)):
        if a.is_partitioned and (not b.is_partitioned or b.axis != a.axis):
            x = C.gather_from(x, mesh.group([a.axis]), d)
    for d, (a, b) in enumerate(zip(src.dims, dst.dims)):
        if b.is_partitioned and (not a.is_partitioned or b.axis != a.axis):
            x = C.scatter_to(x, mesh.group([b.axis]), d)
    return x


class _ParallelOpBase(Op):
    def reads_across(self, i):
        return ()

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        if ctx.mesh is None:
            return [x]
        return [reshard(x, self.input_layouts[0], self.output_shapes[0], ctx.mesh)]


@register_op
class Repartition(_ParallelOpBase):
    """Shard dim ``attrs["dim"]`` over mesh axis ``attrs["axis"]`` (degree:
    ``attrs["degree"]``, default the axis size)."""

    op_type = OpType.REPARTITION

    def propagate(self, input_shapes, strategy=None):
        in0 = input_shapes[0]
        self.input_layouts = [in0]
        dim = self.attrs["dim"] % len(in0.dims)
        axis = self.attrs["axis"]
        degree = self.attrs.get("degree") or (strategy or {}).get("_axis_sizes", {}).get(axis, 1)
        return [in0.partitioned(dim, degree, axis)], {}


@register_op
class Combine(_ParallelOpBase):
    """Gather dim ``attrs["dim"]`` back to whole."""

    op_type = OpType.COMBINE

    def propagate(self, input_shapes, strategy=None):
        in0 = input_shapes[0]
        self.input_layouts = [in0]
        return [in0.combined(self.attrs["dim"] % len(in0.dims))], {}


@register_op
class Replicate(_ParallelOpBase):
    """Replicate over mesh axis ``attrs["axis"]`` (a layout change only)."""

    op_type = OpType.REPLICATE

    def propagate(self, input_shapes, strategy=None):
        self.input_layouts = [input_shapes[0]]
        return [input_shapes[0].replicated(self.attrs["axis"])], {}


@register_op
class Reduction(_ParallelOpBase):
    """Drop the replica axis ``attrs["axis"]`` (a layout change only: the
    partial sums were reduced by the op that made them)."""

    op_type = OpType.REDUCTION

    def propagate(self, input_shapes, strategy=None):
        self.input_layouts = [input_shapes[0]]
        return [input_shapes[0].reduced(self.attrs["axis"])], {}


@register_op
class AllReduce(_ParallelOpBase):
    """The JAX package's explicit all-reduce marker."""

    op_type = OpType.ALLREDUCE
