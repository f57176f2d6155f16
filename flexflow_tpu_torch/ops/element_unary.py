"""Elementwise unary operators.

PyTorch counterpart of ``flexflow_tpu/ops/element_unary.py``: exp, relu,
identity, sigmoid, tanh, elu, gelu (exact), rsqrt, sin and cos, and the
ops with a scalar (``scalar`` attribute: multiply, add, subtract, true and
floor divide, and ``pow``), each a stock torch op.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..core.op import Op, register_op
from ..ffconst import OpType
from .linear import relu

_UNARY_FNS: Dict[OpType, Callable] = {
    OpType.EXP: torch.exp,
    OpType.RELU: relu,
    OpType.IDENTITY: lambda x: x,
    OpType.SIGMOID: torch.sigmoid,
    OpType.TANH: torch.tanh,
    OpType.ELU: F.elu,
    OpType.GELU: lambda x: F.gelu(x, approximate="none"),
    OpType.RSQRT: torch.rsqrt,
    OpType.SIN: torch.sin,
    OpType.COS: torch.cos,
}

_SCALAR_FNS: Dict[OpType, Callable] = {
    OpType.SCALAR_MULTIPLY: lambda x, s: x * s,
    OpType.SCALAR_ADD: lambda x, s: x + s,
    OpType.SCALAR_SUB: lambda x, s: x - s,
    OpType.SCALAR_TRUE_DIV: lambda x, s: x / s,
    OpType.SCALAR_FLOOR_DIV: lambda x, s: torch.div(x, s, rounding_mode="floor"),
    OpType.POW: lambda x, s: torch.pow(x, s),
}


class _ElementUnaryBase(Op):
    def reads_across(self, i):
        return ()

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def flops(self) -> float:
        return float(math.prod(self.input_shapes[0].sizes))


def _make_unary(op_type: OpType):
    fn = _UNARY_FNS[op_type]
    cls = type(
        f"ElementUnary_{op_type.value}",
        (_ElementUnaryBase,),
        {
            "op_type": op_type,
            "forward": lambda self, ctx, inputs, weights, _fn=fn: [_fn(inputs[0])],
        },
    )
    return register_op(cls)


def _make_scalar(op_type: OpType):
    fn = _SCALAR_FNS[op_type]
    cls = type(
        f"ElementUnary_{op_type.value}",
        (_ElementUnaryBase,),
        {
            "op_type": op_type,
            "forward": lambda self, ctx, inputs, weights, _fn=fn: [
                _fn(inputs[0], self.attrs["scalar"])
            ],
        },
    )
    return register_op(cls)


for _t in _UNARY_FNS:
    _make_unary(_t)
for _t in _SCALAR_FNS:
    _make_scalar(_t)
