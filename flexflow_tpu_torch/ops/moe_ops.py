"""MoE operator family: TopK, GroupBy, Aggregate, AggregateSpec and the
stacked pipeline (GroupByStacked, ExpertLinear, AggregateStacked).

PyTorch counterpart of ``flexflow_tpu/ops/moe_ops.py``, on one device.
Routing is the capacity-based dispatch/combine of the JAX package: tokens
past an expert's capacity ``ceil(alpha * k / n * batch)`` are dropped, and
GroupBy and Aggregate recompute the same routing from ``gate_assign``. The
row movement goes through ``kernels.moe_kernels`` (the Hopper kernels on a
CUDA tensor, their plain versions on a CPU tensor or under
``LowerCtx.plain_kernels``); :func:`moe_dispatch_mask` keeps the one-hot
formulation for the tests.

The load-balancing term is the JAX package's straight-through auxiliary
loss, appended to ``LowerCtx.aux_losses``: its gradient with respect to the
full gate is ``(lambda_bal * n / batch) * count[e]``, zero-meaned per row.
The compiler adds it to the training loss only.

``Cache`` passes its input through, as in the JAX package, where a graph
reaches it as ``OpType.CACHE`` (neither package has a builder verb for it);
the trigger machinery it pairs with is ``runtime/recompile.py``.

Not ported yet: the expert-parallel branch of the stacked ops (a mesh axis
on the expert dim and the all-to-all), queue A7.
"""

from __future__ import annotations

import math

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, DataType, OpType
from ..kernels.moe_kernels import moe_combine, moe_dispatch, pick_ranks
from ..runtime.initializer import DefaultBiasInitializer, DefaultWeightInitializer
from .linear import apply_activation


@register_op
class TopK(Op):
    """The k largest values over the last dim, sorted, and their int32
    indices. Ties go to the lower index, as ``jax.lax.top_k`` breaks them:
    a stable descending sort (``torch.topk`` picks other indices among equal
    values, and a ReLU gate has many ties at 0). Always sorted, as the JAX
    op ignores ``sorted=False``."""

    op_type = OpType.TOPK

    def infer_output_shapes(self):
        sizes = self.input_shapes[0].sizes
        out = sizes[:-1] + (self.attrs["k"],)
        return [(out, self.input_shapes[0].dtype), (out, DataType.INT32)]

    def forward(self, ctx, inputs, weights):
        k = self.attrs["k"]
        vals, idx = torch.sort(inputs[0], dim=-1, descending=True, stable=True)
        return [vals[..., :k], idx[..., :k].to(torch.int32)]


def expert_capacity(batch: int, k: int, n: int, alpha: float) -> int:
    """ceil(alpha * k / n * batch), the reference's fixed expert capacity."""
    return int(math.ceil(alpha * k / n * batch))


def moe_dispatch_mask(assign: torch.Tensor, n: int, capacity: int) -> torch.Tensor:
    """The one-hot routing: (T = B*k, n, capacity) f32, 1 where flattened
    token pick t is the c-th pick routed to expert e (picks past capacity
    dropped). Not on the main path: the tests hold the kernels' routing
    against it, as the JAX package's fallback einsums use it."""
    flat, pos = pick_ranks(assign, n)
    onehot = (flat[:, None] == torch.arange(n, device=assign.device)).float()
    keep = (pos < capacity).float()
    poh = (pos[:, None] == torch.arange(capacity, device=assign.device)).float()
    return (onehot * keep[:, None])[:, :, None] * poh[:, None, :]


def _dispatch_rows(ctx, x, assign, n: int, capacity: int) -> torch.Tensor:
    """x (B, feat...) -> stacked (n, capacity, feat...) expert rows, in
    global token order (the shared scatter of GroupBy and GroupByStacked)."""
    return moe_dispatch(x, assign, n, capacity, plain=ctx.plain_kernels)


def _no_expert_axis(name: str, attrs) -> None:
    strategy = attrs.get("strategy") or {}
    if strategy.get("expert"):
        raise NotImplementedError(
            f"{name}: the expert-parallel path (strategy {strategy}) needs a "
            f"mesh, which the port does not have yet (ROADMAP queue A7)")


@register_op
class GroupBy(Op):
    """Scatter input rows into n fixed-capacity expert tensors by the gate
    assignment (one output per expert)."""

    op_type = OpType.GROUP_BY

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.n = self.attrs["n"]
        self.alpha = float(self.attrs["alpha"])
        self.k = input_shapes[1].sizes[-1]
        self.batch = input_shapes[0].sizes[0]
        self.capacity = expert_capacity(self.batch, self.k, self.n, self.alpha)

    def infer_output_shapes(self):
        d = self.input_shapes[0].sizes[1:]
        return [((self.capacity,) + d, self.input_shapes[0].dtype)] * self.n

    def forward(self, ctx, inputs, weights):
        x, assign = inputs
        rows = _dispatch_rows(ctx, x, assign, self.n, self.capacity)
        return [rows[e] for e in range(self.n)]


class _AggregateBase(Op):
    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.n = self.attrs["n"]
        self.lambda_bal = float(self.attrs["lambda_bal"])
        self.k = input_shapes[0].sizes[-1]
        self.batch = input_shapes[0].sizes[0]
        self.capacity = input_shapes[4].sizes[0]
        self.out_dim = input_shapes[4].sizes[-1]

    def infer_output_shapes(self):
        return [((self.batch, self.out_dim), self.input_shapes[4].dtype)]

    def _combine(self, ctx, gate_weights, assign, stacked):
        """Gate-weighted combine of stacked (n, capacity, d) expert rows.
        The batch comes from the run-time tensors, not the compiled shapes."""
        return moe_combine(stacked, assign, gate_weights.reshape(-1, self.k),
                           plain=ctx.plain_kernels)

    def _stack(self, exp_preds):
        return torch.stack([p.reshape(self.capacity, -1) for p in exp_preds])

    def _balance_aux(self, full_gate, assign):
        """Straight-through auxiliary loss whose gradient with respect to
        ``full_gate`` is the reference's balance gradient, (lambda*n/B) *
        count[e], zero-meaned per row; None when lambda_bal is 0."""
        if self.lambda_bal == 0.0:
            return None
        counts = torch.sum(
            (assign.reshape(-1, 1).long()
             == torch.arange(self.n, device=assign.device)).float(), dim=0)
        g = (self.lambda_bal * self.n / assign.shape[0]) * counts  # (n,)
        g = g - torch.mean(g)
        return torch.sum(g.detach()[None, :] * full_gate)

    def _append_aux(self, ctx, full_gate, assign) -> None:
        aux = self._balance_aux(full_gate, assign)
        if aux is not None and ctx.aux_losses is not None:
            ctx.aux_losses.append(aux)


@register_op
class Aggregate(_AggregateBase):
    """Gate-weighted combine of the n expert outputs, plus the
    load-balancing term."""

    op_type = OpType.AGGREGATE

    def forward(self, ctx, inputs, weights):
        gate_preds, assign, _true_assign, full_gate = inputs[:4]
        out = self._combine(ctx, gate_preds, assign, self._stack(inputs[4:]))
        self._append_aux(ctx, full_gate, assign)
        return [out]


@register_op
class AggregateSpec(_AggregateBase):
    """The variant used with replicated labels: the selected experts
    combine with the uniform weight 1/k."""

    op_type = OpType.AGGREGATE_SPEC

    def forward(self, ctx, inputs, weights):
        gate_preds, assign, _true_assign, full_gate = inputs[:4]
        uniform = torch.full_like(gate_preds, 1.0 / self.k)
        out = self._combine(ctx, uniform, assign, self._stack(inputs[4:]))
        self._append_aux(ctx, full_gate, assign)
        return [out]


@register_op
class GroupByStacked(Op):
    """GroupBy emitting one stacked (n, capacity, d) tensor."""

    op_type = OpType.GROUP_BY_STACKED

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        _no_expert_axis(self.name, self.attrs)
        self.n = self.attrs["n"]
        self.alpha = float(self.attrs["alpha"])
        self.k = input_shapes[1].sizes[-1]
        self.batch = input_shapes[0].sizes[0]
        self.capacity = expert_capacity(self.batch, self.k, self.n, self.alpha)

    def infer_output_shapes(self):
        d = self.input_shapes[0].sizes[1:]
        return [((self.n, self.capacity) + d, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        x, assign = inputs
        return [_dispatch_rows(ctx, x, assign, self.n, self.capacity)]


@register_op
class ExpertLinear(Op):
    """Per-expert dense over the stacked (n, capacity, d) tensor, weight
    (n, d, out) and bias (n, out)."""

    op_type = OpType.EXPERT_LINEAR

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.out_dim = layer.attrs["out_dim"]
        self.activation = layer.attrs.get("activation", ActiMode.NONE)
        self.use_bias = layer.attrs.get("use_bias", True)
        self.n = input_shapes[0].sizes[0]
        self.capacity = input_shapes[0].sizes[1]
        self.in_dim = input_shapes[0].sizes[-1]

    def infer_output_shapes(self):
        return [((self.n, self.capacity, self.out_dim), self.input_shapes[0].dtype)]

    def weight_specs(self):
        dt = self.input_shapes[0].dtype
        specs = [WeightSpec(
            "kernel", (self.n, self.in_dim, self.out_dim), dt,
            self.attrs.get("kernel_initializer") or DefaultWeightInitializer(),
            weight_decay=True)]
        if self.use_bias:
            specs.append(WeightSpec(
                "bias", (self.n, self.out_dim), dt,
                self.attrs.get("bias_initializer") or DefaultBiasInitializer(),
                weight_decay=False))
        return specs

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        y = torch.bmm(x, weights["kernel"])  # "ecd,edh->ech"
        if self.use_bias:
            y = y + weights["bias"][:, None, :]
        return [apply_activation(y, self.activation)]


@register_op
class AggregateStacked(_AggregateBase):
    """Aggregate over the stacked expert tensor. Inputs: gate_preds (B, k),
    gate_assign (B, k), full_gate (B, n), exp_stacked (n, capacity, f) ->
    (B, f)."""

    op_type = OpType.AGGREGATE_STACKED

    def __init__(self, layer, input_shapes):
        Op.__init__(self, layer, input_shapes)
        self.n = self.attrs["n"]
        self.lambda_bal = float(self.attrs["lambda_bal"])
        self.k = input_shapes[0].sizes[-1]
        self.batch = input_shapes[0].sizes[0]
        self.capacity = input_shapes[3].sizes[1]
        self.out_dim = input_shapes[3].sizes[-1]

    def infer_output_shapes(self):
        return [((self.batch, self.out_dim), self.input_shapes[3].dtype)]

    def forward(self, ctx, inputs, weights):
        gate_preds, assign, full_gate, stacked = inputs
        out = self._combine(ctx, gate_preds, assign,
                            stacked.reshape(self.n, self.capacity, -1))
        self._append_aux(ctx, full_gate, assign)
        return [out]


@register_op
class Cache(Op):
    """Caches an intermediate tensor (expert assignments) across
    iterations in the reference; here, as in the JAX package, a
    pass-through that pairs with recompile-on-condition."""

    op_type = OpType.CACHE

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        return [inputs[0]]
