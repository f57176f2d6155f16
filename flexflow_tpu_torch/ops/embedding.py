"""Embedding and Gather operators.

PyTorch counterpart of ``flexflow_tpu/ops/embedding.py``. The JAX package
looks rows up with ``jnp.take`` (``jnp.take_along_axis`` for Gather), whose
default mode gives a NaN row for an index at or above the dim's size or
below minus it and wraps a negative index from the end. Both ops here keep
those semantics without a device-side assert: the index is wrapped,
checked and clamped, the rows gathered, and the invalid ones set to NaN.
Their gradients reach only the valid rows, as JAX's drop the others.

Over a mesh Embedding takes the JAX op's strategies. ``{"vocab": axis}``
shards the table's rows: each rank looks up the ids in its own range
(zeros elsewhere), SUM/AVG reduce its bag, and the partial rows are
all-reduced over the axis (``collectives.reduce_from``), so the ids stay
where they are and no table moves; an id outside ``[-num_entries,
num_entries)`` still gives a NaN row after the sum, and a negative one
still wraps, as ``jnp.take`` on the whole table gives them. ``{"out":
axis}`` shards the table's columns and the output's feature dim: each rank
looks up its columns, no collective.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import AggrMode, DataType, OpType
from ..parallel import collectives as C
from ..runtime.initializer import DefaultWeightInitializer


def _take_index(idx: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(an index into [0, size) for every entry, which entries are valid):
    -size <= i < 0 wraps to i + size; entries outside [-size, size) are
    invalid and point at 0."""
    idx = idx.long()
    valid = (idx >= -size) & (idx < size)
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


@register_op
class Embedding(Op):
    op_type = OpType.EMBEDDING

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.num_entries = self.attrs["num_entries"]
        self.out_dim = self.attrs["out_dim"]
        self.aggr: AggrMode = self.attrs.get("aggr", AggrMode.NONE)
        self.out_dtype: DataType = self.attrs.get("dtype", DataType.FLOAT)
        # the mesh axis sharding the table's rows, and the ids' dims it
        # also shards (gathered for the lookup, cut back after) (propagate)
        self.vocab_axis = None
        self.scatter_dims: list = []

    def propagate(self, input_shapes, strategy=None):
        """The JAX op's rule: ``{"vocab": axis}`` shards the table on its
        rows, ``{"out": axis}`` on its columns with the output's feature
        dim, each when the axis degree divides the dim. Under ``vocab`` an
        ids dim sharded over the same axis arrives gathered: each rank
        looks up every id in its range and, after the all-reduce, keeps
        its own block of the output, which keeps the ids' layout."""
        strategy = strategy or {}
        out_shapes, weight_shapes = super().propagate(input_shapes, strategy)
        sizes = strategy.get("_axis_sizes", {})
        w = weight_shapes["weight"]
        self.vocab_axis = None
        self.scatter_dims = []
        if "vocab" in strategy:
            ax = strategy["vocab"]
            deg = sizes.get(ax, 1)
            if deg > 1 and self.num_entries % deg == 0:
                weight_shapes["weight"] = w.partitioned(0, deg, ax)
                self.vocab_axis = ax
                ids = self.input_layouts[0]
                self.scatter_dims = [d for d, dim in enumerate(ids.dims)
                                     if dim.is_partitioned and dim.axis == ax]
                for d in self.scatter_dims:
                    ids = ids.combined(d)
                self.input_layouts[0] = ids
        elif "out" in strategy:
            ax = strategy["out"]
            deg = sizes.get(ax, 1)
            if deg > 1 and self.out_dim % deg == 0:
                weight_shapes["weight"] = w.partitioned(1, deg, ax)
                out = out_shapes[0]
                out_shapes[0] = out.partitioned(len(out.dims) - 1, deg, ax)
        return out_shapes, weight_shapes

    def reads_across(self, i):
        # one table row per id; SUM/AVG reduce the trailing multi-hot dim
        nd = len(self.input_shapes[0].dims)
        return () if self.aggr is AggrMode.NONE else (nd - 1,)

    def infer_output_shapes(self):
        in_sizes = self.input_shapes[0].sizes
        if self.aggr is AggrMode.NONE:
            out = in_sizes + (self.out_dim,)
        else:
            # SUM/AVG reduce the trailing multi-hot dim
            out = in_sizes[:-1] + (self.out_dim,)
        return [(out, self.out_dtype)]

    def weight_specs(self):
        return [WeightSpec(
            "weight", (self.num_entries, self.out_dim), self.out_dtype,
            self.attrs.get("kernel_initializer") or DefaultWeightInitializer(),
            weight_decay=True)]

    def forward(self, ctx, inputs, weights):
        idx, valid = _take_index(inputs[0], self.num_entries)
        table = weights["weight"]
        if ctx.mesh is not None and self.vocab_axis:
            group = ctx.mesh.group([self.vocab_axis])
            emb = self._vocab_sharded(idx, valid, table, group)
            for d in self.scatter_dims:
                emb = C.scatter_to(emb, group, d)
            return [emb]
        emb = torch.where(valid[..., None], F.embedding(idx, table), torch.nan)
        if self.aggr is AggrMode.SUM:
            emb = emb.sum(dim=-2)
        elif self.aggr is AggrMode.AVG:
            emb = emb.mean(dim=-2)
        return [emb]

    def _vocab_sharded(self, idx, valid, table, group):
        """This rank's rows ``[lo, lo + rows)`` of the table: the ids in
        that range looked up, zeros elsewhere, the bag reduced, the ranks'
        partial rows all-reduced; then NaN where an id was invalid."""
        rows = table.shape[0]
        lo = group.index * rows
        mine = (idx >= lo) & (idx < lo + rows)
        emb = F.embedding(torch.where(mine, idx - lo, torch.zeros_like(idx)), table)
        emb = torch.where(mine[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                           device=emb.device))
        bad = ~valid
        if self.aggr is not AggrMode.NONE:
            emb = emb.sum(dim=-2)
            bad = bad.any(dim=-1)
        emb = C.reduce_from(emb, group)
        if self.aggr is AggrMode.AVG:
            emb = emb / idx.shape[-1]
        return torch.where(bad[..., None], torch.nan, emb)


@register_op
class Gather(Op):
    """``torch.gather`` along ``dim`` (``jnp.take_along_axis``): the output
    has the index's shape."""

    op_type = OpType.GATHER

    def infer_output_shapes(self):
        return [(self.input_shapes[1].sizes, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        x, index = inputs
        dim = self.attrs["dim"] % x.dim()
        idx, valid = _take_index(index, x.shape[dim])
        return [torch.where(valid, torch.gather(x, dim, idx), torch.nan)]
