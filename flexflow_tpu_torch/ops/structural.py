"""Structural / data-movement operators.

PyTorch counterpart of ``flexflow_tpu/ops/structural.py``: Flat, Reshape
(one ``-1`` inferred), Transpose, Reverse, Concat, Split, Cast, NoOp,
Constant and Slice, with the JAX package's shape rules. They are views,
copies and ``torch.cat``/``torch.split``, differentiated by autograd.
Constant becomes a tensor on the model's device once, when the model is
compiled (:meth:`Constant.materialize`). Slice keeps numpy's slice
semantics, negative steps included; torch indexing takes no negative step,
so such a dim is flipped first and sliced forward.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.op import Op, register_op
from ..ffconst import OpType


@register_op
class Flat(Op):
    op_type = OpType.FLAT

    def infer_output_shapes(self):
        sizes = self.input_shapes[0].sizes
        return [((sizes[0], math.prod(sizes[1:])), self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        return [x.reshape(x.shape[0], -1)]


@register_op
class Reshape(Op):
    op_type = OpType.RESHAPE

    def reads_across(self, i):
        # a reshape that keeps the batch dim keeps each rank's rows whole
        nd = len(self.input_shapes[0].dims)
        keeps = self.infer_output_shapes()[0][0][:1] == self.input_shapes[0].sizes[:1]
        return tuple(range(1 if keeps else 0, nd))

    def infer_output_shapes(self):
        in_sizes = self.input_shapes[0].sizes
        shape = list(self.attrs["shape"])
        n = math.prod(in_sizes)
        if -1 in shape:
            rest = math.prod(s for s in shape if s != -1)
            shape[shape.index(-1)] = n // rest
        if math.prod(shape) != n:
            raise ValueError(f"{self.name}: reshape {in_sizes} -> {tuple(shape)}")
        return [(tuple(shape), self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        return [inputs[0].reshape(self.infer_output_shapes()[0][0])]


@register_op
class Transpose(Op):
    op_type = OpType.TRANSPOSE

    def reads_across(self, i):
        return tuple(d for d, p in enumerate(self.attrs["perm"]) if d != p)

    def infer_output_shapes(self):
        sizes = self.input_shapes[0].sizes
        return [(tuple(sizes[p] for p in self.attrs["perm"]), self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        return [inputs[0].permute(*self.attrs["perm"])]


@register_op
class Reverse(Op):
    op_type = OpType.REVERSE

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        return [torch.flip(inputs[0], dims=(self.attrs["axis"],))]


@register_op
class Concat(Op):
    op_type = OpType.CONCAT

    def infer_output_shapes(self):
        sizes = list(self.input_shapes[0].sizes)
        axis = self.attrs["axis"] % len(sizes)
        sizes[axis] = sum(s.sizes[axis] for s in self.input_shapes)
        return [(tuple(sizes), self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        return [torch.cat(list(inputs), dim=self.attrs["axis"])]


@register_op
class Split(Op):
    op_type = OpType.SPLIT

    def infer_output_shapes(self):
        sizes = self.input_shapes[0].sizes
        axis = self.attrs["axis"] % len(sizes)
        splits = self.attrs["splits"]  # sizes along the axis
        if sum(splits) != sizes[axis]:
            raise ValueError(f"{self.name}: splits {splits} of a dim of {sizes[axis]}")
        outs = []
        for sp in splits:
            s = list(sizes)
            s[axis] = sp
            outs.append((tuple(s), self.input_shapes[0].dtype))
        return outs

    def forward(self, ctx, inputs, weights):
        return list(torch.split(inputs[0], list(self.attrs["splits"]),
                                dim=self.attrs["axis"]))


@register_op
class Cast(Op):
    op_type = OpType.CAST

    def reads_across(self, i):
        return ()

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.attrs["dtype"])]

    def forward(self, ctx, inputs, weights):
        return [inputs[0].to(self.attrs["dtype"].to_torch())]


@register_op
class NoOp(Op):
    """The PCG's OP_INPUT/OP_WEIGHT anchors: every input passes through."""

    op_type = OpType.NOOP

    def infer_output_shapes(self):
        return [(s.sizes, s.dtype) for s in self.input_shapes]

    def forward(self, ctx, inputs, weights):
        return list(inputs)


@register_op
class Constant(Op):
    """A baked-in constant tensor (no inputs, not trainable). The compiler
    puts it on the model's device once (:meth:`materialize`); each step
    reads that tensor."""

    op_type = OpType.CONSTANT

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.value: Optional[torch.Tensor] = None

    def infer_output_shapes(self):
        return [(tuple(np.shape(self.attrs["value"])), self.attrs["dtype"])]

    def materialize(self, device: torch.device) -> None:
        self.value = torch.as_tensor(np.asarray(self.attrs["value"]),
                                     dtype=self.attrs["dtype"].to_torch(), device=device)

    def forward(self, ctx, inputs, weights):
        if self.value is None:
            raise RuntimeError(f"{self.name}: compile the model before running it")
        return [self.value]


@register_op
class Slice(Op):
    """Static strided slicing and integer indexing (torch ``x[:, 0]``, ONNX
    Slice). ``attrs["items"]``: one spec per leading dim, ``{"kind":
    "slice", "start", "stop", "step"}`` keeps the dim, ``{"kind": "int",
    "i": k}`` drops it; trailing dims pass through."""

    op_type = OpType.SLICE

    def _index(self) -> List[Tuple[object, bool]]:
        """[(python index or slice, drop)] per input dim, with numpy's slice
        semantics; an out-of-range int index raises, as numpy's does."""
        sizes = self.input_shapes[0].sizes
        items = self.attrs["items"]
        out = []
        for d, size in enumerate(sizes):
            it = items[d] if d < len(items) else {"kind": "slice"}
            if it["kind"] == "int":
                i = it["i"]
                if not -size <= i < size:
                    raise ValueError(f"{self.name}: index {i} out of range for dim "
                                     f"{d} of size {size}")
                out.append((i + size if i < 0 else i, True))
            else:
                out.append((slice(it.get("start"), it.get("stop"), it.get("step")), False))
        return out

    def infer_output_shapes(self):
        sizes = [len(range(*ix.indices(size)))
                 for (ix, drop), size in zip(self._index(), self.input_shapes[0].sizes)
                 if not drop]
        return [(tuple(sizes), self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        flips, idx = [], []
        for d, ((ix, drop), size) in enumerate(zip(self._index(), x.shape)):
            if drop:
                idx.append(ix)
                continue
            start, stop, step = ix.indices(size)
            if step > 0:
                idx.append(slice(start, stop, step))
                continue
            # a negative step: in the flipped dim, element i sits at
            # size - 1 - i, and the same elements run forward
            n = len(range(start, stop, step))
            flips.append(d)
            first = size - 1 - start
            idx.append(slice(first, first + (n - 1) * -step + 1 if n else first, -step))
        if flips:
            x = torch.flip(x, dims=flips)
        return [x[tuple(idx)]]
