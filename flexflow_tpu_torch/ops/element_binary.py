"""Elementwise binary operators with numpy broadcasting.

PyTorch counterpart of ``flexflow_tpu/ops/element_binary.py``: add,
subtract, multiply, divide, max and min, one op class per type, each a
stock torch op (XLA's fused elementwise ops in the JAX package, outside
any Pallas kernel).

Over a mesh an input that is whole along an axis the output is sharded
over (a batch statistic broadcast against the rank's rows) enters through
``collectives.copy_to``: each rank's rows give only part of its gradient,
which is summed over that axis.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.op import Op, register_op
from ..ffconst import OpType
from ..parallel import collectives as C

_BINARY_FNS: Dict[OpType, Callable] = {
    OpType.EW_ADD: torch.add,
    OpType.EW_SUB: torch.subtract,
    OpType.EW_MUL: torch.multiply,
    OpType.EW_DIV: torch.true_divide,
    OpType.EW_MAX: torch.maximum,
    OpType.EW_MIN: torch.minimum,
}


class _ElementBinaryBase(Op):
    broadcasts_from_right = True

    def reads_across(self, i):
        return ()

    def infer_output_shapes(self):
        a, b = self.input_shapes
        out = np.broadcast_shapes(a.sizes, b.sizes)
        return [(tuple(int(s) for s in out), a.dtype)]

    def flops(self) -> float:
        return float(np.prod(self.infer_output_shapes()[0][0], dtype=np.float64))

    def _entered(self, ctx, inputs):
        """The inputs, each whole one entering the output's sharding
        through ``copy_to`` over the axes it lacks."""
        if ctx.mesh is None or not self.output_shapes:
            return inputs
        out_axes = self.output_shapes[0].partition_axes
        out = []
        for x, lay in zip(inputs, self.input_layouts):
            missing = [a for a in out_axes if a not in lay.partition_axes]
            if missing and x.is_floating_point():
                x = C.copy_to(x, ctx.mesh.group(missing))
            out.append(x)
        return out


def _make_binary(op_type: OpType):
    fn = _BINARY_FNS[op_type]
    cls = type(
        f"ElementBinary_{op_type.value}",
        (_ElementBinaryBase,),
        {
            "op_type": op_type,
            "forward": lambda self, ctx, inputs, weights, _fn=fn: [
                _fn(*self._entered(ctx, inputs))
            ],
        },
    )
    return register_op(cls)


for _t in _BINARY_FNS:
    _make_binary(_t)
