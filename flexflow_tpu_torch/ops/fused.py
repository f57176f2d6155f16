"""FusedOp: elementwise-chain fusion.

PyTorch counterpart of ``flexflow_tpu/ops/fused.py``. :func:`apply_fusion`
replaces each maximal straight chain of weightless single-input,
single-output unary ops (:data:`FUSIBLE`) by one ``FusedOp`` layer whose
forward applies the sub-ops in order; a chain breaks at a tensor with more
than one consumer and at a protected tensor (the logits). The pass is
``FFConfig.perform_fusion``, run by ``FFModel.compile``. It adds no kernel:
the sub-ops run as they run unfused (XLA in the reference, never Pallas),
and each keeps its own name, so a fused dropout draws the mask the unfused
one draws.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..core.layer import Layer
from ..core.op import Op, create_op, register_op
from ..ffconst import OpType

FUSIBLE = {
    OpType.RELU, OpType.IDENTITY, OpType.SIGMOID, OpType.TANH, OpType.ELU,
    OpType.GELU, OpType.RSQRT, OpType.POW, OpType.SIN, OpType.COS,
    OpType.EXP, OpType.SCALAR_MULTIPLY, OpType.SCALAR_ADD, OpType.SCALAR_SUB,
    OpType.SCALAR_TRUE_DIV, OpType.DROPOUT,
}


@register_op
class FusedOp(Op):
    op_type = OpType.FUSED

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.sub_layers: List[Layer] = layer.attrs["sub_layers"]
        # chain the sub-ops through their shapes
        self.sub_ops: List[Op] = []
        cur = list(input_shapes)
        for sl in self.sub_layers:
            op = create_op(sl, cur)
            outs, _ = op.propagate(cur)
            op.output_shapes = outs
            self.sub_ops.append(op)
            cur = outs

    def infer_output_shapes(self):
        last = self.sub_ops[-1].output_shapes[0]
        return [(last.sizes, last.dtype)]

    def forward(self, ctx, inputs, weights):
        x = inputs[0]
        for op in self.sub_ops:
            (x,) = op.forward(ctx, [x], {})
        return [x]


def apply_fusion(layers: List[Layer], protected: Set[int]) -> List[Layer]:
    """Fuse maximal chains of FUSIBLE layers. ``protected``: tensor ids
    that must stay real graph outputs (the logits). The builder's layers
    and tensors are not changed, so a later compile without fusion sees
    the original graph."""
    consumers: Dict[int, int] = {}
    for l in layers:
        for t in l.inputs:
            consumers[t.tensor_id] = consumers.get(t.tensor_id, 0) + 1

    fused: List[Layer] = []
    run: List[Layer] = []

    def chainable(prev: Layer, nxt: Layer) -> bool:
        out = prev.outputs[0]
        return (nxt.inputs[0].tensor_id == out.tensor_id
                and consumers.get(out.tensor_id, 0) == 1
                and out.tensor_id not in protected)

    def flush():
        if len(run) >= 2:
            fl = Layer(OpType.FUSED, name="fused_" + "_".join(l.name for l in run),
                       inputs=list(run[0].inputs), attrs={"sub_layers": list(run)})
            fl.outputs = list(run[-1].outputs)
            fused.append(fl)
        else:
            fused.extend(run)
        run.clear()

    for l in layers:
        is_fusible = (l.op_type in FUSIBLE and len(l.inputs) == 1
                      and len(l.outputs) == 1)
        if is_fusible and run and chainable(run[-1], l):
            run.append(l)
        else:
            flush()
            if is_fusible:
                run.append(l)
            else:
                fused.append(l)
    flush()
    return fused
