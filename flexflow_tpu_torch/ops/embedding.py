"""Embedding and Gather operators.

PyTorch counterpart of ``flexflow_tpu/ops/embedding.py``. The JAX package
looks rows up with ``jnp.take`` (``jnp.take_along_axis`` for Gather), whose
default mode gives a NaN row for an index at or above the dim's size or
below minus it and wraps a negative index from the end. Both ops here keep
those semantics without a device-side assert: the index is wrapped,
checked and clamped, the rows gathered, and the invalid ones set to NaN.
Their gradients reach only the valid rows, as JAX's drop the others.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import AggrMode, DataType, OpType
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
        if self.attrs.get("strategy"):
            raise NotImplementedError(
                f"{self.name}: a sharded embedding table is ROADMAP A7b")
        self.num_entries = self.attrs["num_entries"]
        self.out_dim = self.attrs["out_dim"]
        self.aggr: AggrMode = self.attrs.get("aggr", AggrMode.NONE)
        self.out_dtype: DataType = self.attrs.get("dtype", DataType.FLOAT)

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
        emb = torch.where(valid[..., None], F.embedding(idx, weights["weight"]), torch.nan)
        if self.aggr is AggrMode.SUM:
            emb = emb.sum(dim=-2)
        elif self.aggr is AggrMode.AVG:
            emb = emb.mean(dim=-2)
        return [emb]


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
