"""MoE operator family: TopK, GroupBy, Aggregate, AggregateSpec and the
stacked pipeline (GroupByStacked, ExpertLinear, AggregateStacked).

PyTorch counterpart of ``flexflow_tpu/ops/moe_ops.py``. Routing is the
capacity-based dispatch/combine of the JAX package: tokens past an
expert's capacity ``ceil(alpha * k / n * batch)`` are dropped, and GroupBy
and Aggregate recompute the same routing from ``gate_assign``. The row
movement goes through ``kernels.moe_kernels`` (the Hopper kernels on a
CUDA tensor, their plain versions on a CPU tensor or under
``LowerCtx.plain_kernels``); :func:`moe_dispatch_mask` keeps the one-hot
formulation for the tests.

The load-balancing term is the JAX package's straight-through auxiliary
loss, appended to ``LowerCtx.aux_losses``: its gradient with respect to the
full gate is ``(lambda_bal * n / batch) * count[e]``, zero-meaned per row,
with ``batch`` and ``count`` over the whole batch. The compiler adds it to
the training loss only.

Over a mesh (one process per rank) the routing ops follow the JAX
package's two routings, chosen by the same predicate (:func:`_ep_axis`):

* expert parallelism: the stacked tensor's expert dim is sharded over the
  axis that shards the batch, and the capacity splits over it. Each rank
  dispatches its own tokens at the local capacity ``capacity // degree``
  (the row-gather kernel on the local shape), ``expert_all_to_all`` moves
  the rows to the experts' owners, ``ExpertLinear`` runs on the local
  experts only, ``experts_to_tokens`` moves them back and each rank
  combines its own tokens (the row-gather-sum kernel on the local shape),
  as the JAX package's ``shard_map`` bodies do. The balance term reads
  the counts summed over the batch axis;
* otherwise each rank gathers the batch and computes the whole routing,
  as GSPMD does: the combine's output is cut back to the rank's rows
  (``scatter_to``, whose backward all-gathers their gradients), the
  balance term reads the rank's rows of the full gate.

``Cache`` passes its input through, as in the JAX package, where a graph
reaches it as ``OpType.CACHE`` (neither package has a builder verb for it);
the trigger machinery it pairs with is ``runtime/recompile.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.op import Op, WeightSpec, register_op
from ..core.parallel_tensor import ParallelDim, ParallelTensorShape
from ..ffconst import ActiMode, DataType, OpType
from ..kernels.moe_kernels import moe_combine, moe_dispatch, pick_ranks
from ..parallel import collectives as C
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
    token order (the shared scatter of GroupBy and GroupByStacked)."""
    return moe_dispatch(x, assign, n, capacity, plain=ctx.plain_kernels)


def _whole(shape: ParallelTensorShape) -> ParallelTensorShape:
    return ParallelTensorShape.unpartitioned(shape.sizes, shape.dtype)


def _rows_only(shape: ParallelTensorShape) -> ParallelTensorShape:
    """``shape`` with every dim but the batch dim 0 whole."""
    return ParallelTensorShape((shape.dims[0],) + tuple(ParallelDim(d.size)
                                                        for d in shape.dims[1:]),
                               shape.dtype)


def _ep_axis(shape: ParallelTensorShape, token_dim: ParallelDim) -> Optional[Tuple[str, int]]:
    """The (axis, degree) of the expert-parallel routing, or None: the
    stacked (n, capacity, d) tensor's expert dim is sharded over the axis
    that shards the batch (``token_dim``, the assign's dim 0) and the
    capacity splits over it. The JAX package's predicate: dispatch and
    combine see the same shapes, so they always agree."""
    ed = shape.dims[0]
    if not (ed.is_partitioned and token_dim.is_partitioned and ed.axis == token_dim.axis):
        return None
    if shape.dims[1].size % ed.degree:
        return None
    return ed.axis, ed.degree


def _to_local_rows(ctx, out: torch.Tensor, layout: ParallelTensorShape) -> torch.Tensor:
    """The rank's rows of ``out``, computed whole, when ``layout`` shards
    the batch; the backward all-gathers the rows' gradients."""
    d0 = layout.dims[0]
    if not d0.is_partitioned:
        return out
    return C.scatter_to(out, ctx.mesh.group([d0.axis]), 0)


class _BatchRouting(Op):
    """An op whose routing reads the whole batch (capacity, balance): its
    inputs arrive gathered, and its outputs are whole."""

    def propagate(self, input_shapes, strategy=None):
        self.honored_strategy_keys = set()
        self.input_layouts = [_whole(s) for s in input_shapes]
        return ([ParallelTensorShape.unpartitioned(sizes, dtype)
                 for sizes, dtype in self.infer_output_shapes()], {})


@register_op
class GroupBy(_BatchRouting):
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
    """The combines: ``gate`` (input 0), ``assign`` (input 1) and the
    expert rows arrive whole (or, under expert parallelism, as the rank's
    rows and experts); ``full_gate`` keeps its batch sharding, and the
    output is sharded on the batch as it is."""

    # the input index of the full gate and of the first expert tensor, and
    # that tensor's capacity dim
    full_gate_at, experts_at, capacity_dim = 3, 4, 0

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.n = self.attrs["n"]
        self.lambda_bal = float(self.attrs["lambda_bal"])
        self.k = input_shapes[0].sizes[-1]
        self.batch = input_shapes[0].sizes[0]
        experts = input_shapes[self.experts_at].sizes
        self.capacity = experts[self.capacity_dim]
        self.out_dim = experts[-1]

    def infer_output_shapes(self):
        return [((self.batch, self.out_dim), self.input_shapes[self.experts_at].dtype)]

    def propagate(self, input_shapes, strategy=None):
        self.honored_strategy_keys = set()
        fg = _rows_only(input_shapes[self.full_gate_at])
        self.input_layouts = [fg if i == self.full_gate_at else _whole(s)
                              for i, s in enumerate(input_shapes)]
        out = ParallelTensorShape((fg.dims[0], ParallelDim(self.out_dim)),
                                  self.infer_output_shapes()[0][1])
        return [out], {}

    def _combine(self, ctx, gate_weights, assign, stacked):
        """Gate-weighted combine of stacked (n, capacity, d) expert rows.
        The batch comes from the run-time tensors, not the compiled shapes."""
        return moe_combine(stacked, assign, gate_weights.reshape(-1, self.k),
                           plain=ctx.plain_kernels)

    def _stack(self, exp_preds):
        return torch.stack([p.reshape(self.capacity, -1) for p in exp_preds])

    def _append_aux(self, ctx, full_gate, counts: torch.Tensor, batch: int) -> None:
        """The straight-through balance term on this rank's rows of the
        full gate: its gradient with respect to ``full_gate`` is the
        reference's balance gradient, (lambda*n/B) * count[e] zero-meaned
        per row, with ``counts`` and ``batch`` over the whole batch. Summed
        over the ranks of the batch axis, the terms make the one-rank
        term."""
        if self.lambda_bal == 0.0 or ctx.aux_losses is None:
            return
        g = (self.lambda_bal * self.n / batch) * counts  # (n,)
        g = g - torch.mean(g)
        ctx.aux_losses.append(torch.sum(g.detach()[None, :] * full_gate))

    def _counts(self, assign: torch.Tensor) -> torch.Tensor:
        return torch.sum((assign.reshape(-1, 1).long()
                          == torch.arange(self.n, device=assign.device)).float(), dim=0)

    def _whole_routing(self, ctx, gate_weights, assign, full_gate, stacked):
        """The combine over the gathered batch, cut back to this rank's
        rows, and the balance term from the whole batch's counts."""
        out = self._combine(ctx, gate_weights, assign, stacked)
        self._append_aux(ctx, full_gate, self._counts(assign), assign.shape[0])
        return out if ctx.mesh is None else _to_local_rows(ctx, out, self.output_shapes[0])


@register_op
class Aggregate(_AggregateBase):
    """Gate-weighted combine of the n expert outputs, plus the
    load-balancing term."""

    op_type = OpType.AGGREGATE

    def forward(self, ctx, inputs, weights):
        gate_preds, assign, _true_assign, full_gate = inputs[:4]
        return [self._whole_routing(ctx, gate_preds, assign, full_gate,
                                    self._stack(inputs[4:]))]


@register_op
class AggregateSpec(_AggregateBase):
    """The variant used with replicated labels: the selected experts
    combine with the uniform weight 1/k."""

    op_type = OpType.AGGREGATE_SPEC

    def forward(self, ctx, inputs, weights):
        gate_preds, assign, _true_assign, full_gate = inputs[:4]
        uniform = torch.full_like(gate_preds, 1.0 / self.k)
        return [self._whole_routing(ctx, uniform, assign, full_gate,
                                    self._stack(inputs[4:]))]


@register_op
class GroupByStacked(Op):
    """GroupBy emitting one stacked (n, capacity, d) tensor, whose expert
    dim shards over the mesh axis ``strategy={"expert": axis}`` names."""

    op_type = OpType.GROUP_BY_STACKED

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.n = self.attrs["n"]
        self.alpha = float(self.attrs["alpha"])
        self.k = input_shapes[1].sizes[-1]
        self.batch = input_shapes[0].sizes[0]
        self.capacity = expert_capacity(self.batch, self.k, self.n, self.alpha)

    def infer_output_shapes(self):
        d = self.input_shapes[0].sizes[1:]
        return [((self.n, self.capacity) + d, self.input_shapes[0].dtype)]

    def propagate(self, input_shapes, strategy=None):
        """The JAX package's rule: the output's expert dim is sharded over
        ``strategy["expert"]`` (a degree that does not divide the experts,
        or an axis the mesh lacks, raises), else whole, never the batch's
        sharding. The inputs keep their batch sharding on the
        expert-parallel routing and arrive gathered otherwise."""
        self.honored_strategy_keys = set()
        strategy = strategy or {}
        axis_sizes = strategy.get("_axis_sizes", {})
        ax = strategy.get("expert")
        (sizes, dtype), = self.infer_output_shapes()
        dims = [ParallelDim(s) for s in sizes]
        # one rank compiles without a mesh: the strategy changes nothing
        if ax and axis_sizes:
            deg = axis_sizes.get(ax, 1)
            if deg > 1 and self.n % deg:
                raise ValueError(f"{self.name}: expert axis {ax!r} (degree {deg}) does "
                                 f"not divide num experts {self.n}")
            if deg <= 1 and ax not in axis_sizes:
                raise ValueError(f"{self.name}: expert axis {ax!r} is not a mesh axis "
                                 f"(have {sorted(axis_sizes)})")
            if deg > 1:
                dims[0] = ParallelDim(self.n, deg, ax)
        out = ParallelTensorShape(tuple(dims), dtype)
        if _ep_axis(out, input_shapes[1].dims[0]) is not None:
            self.input_layouts = [_rows_only(s) for s in input_shapes]
        else:
            self.input_layouts = [_whole(s) for s in input_shapes]
        return [out], {}

    def forward(self, ctx, inputs, weights):
        x, assign = inputs
        feat = tuple(x.shape[1:])
        ep = _ep_axis(self.output_shapes[0], self.input_shapes[1].dims[0]) \
            if ctx.mesh is not None else None
        if ep is not None:
            ax, deg = ep
            # this rank's tokens at the local capacity, then each expert's
            # rows to the rank that owns it
            rows = _dispatch_rows(ctx, x, assign, self.n, self.capacity // deg)
            rows = C.expert_all_to_all(rows.reshape(self.n, self.capacity // deg, -1),
                                       ctx.mesh, ax)
            return [rows.reshape((self.n // deg, self.capacity) + feat)]
        rows = _dispatch_rows(ctx, x, assign, self.n, self.capacity)
        d0 = self.output_shapes[0].dims[0] if ctx.mesh is not None else ParallelDim(self.n)
        if d0.is_partitioned:
            rows = C.scatter_to(rows, ctx.mesh.group([d0.axis]), 0)
        return [rows]

    def flops(self) -> float:
        return 2.0 * self.batch * self.k * self.n * self.capacity * math.prod(
            self.input_shapes[0].sizes[1:])


@register_op
class ExpertLinear(Op):
    """Per-expert dense over the stacked (n, capacity, d) tensor, weight
    (n, d, out) and bias (n, out), both sharded on the expert dim with
    the input, so each rank computes only its experts."""

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

    def propagate(self, input_shapes, strategy=None):
        """The JAX package's rule: the expert axis is the strategy's, else
        the input's expert-dim axis; the output, the kernel and the bias
        shard on the expert dim over it when its degree divides the
        experts."""
        out_shapes, weight_shapes = super().propagate(input_shapes, strategy)
        strategy = strategy or {}
        in0 = input_shapes[0]
        ax = strategy.get("expert") or (in0.dims[0].axis if in0.dims[0].is_partitioned
                                        else None)
        if ax:
            deg = strategy.get("_axis_sizes", {}).get(ax, in0.dims[0].degree or 1)
            if deg > 1 and self.n % deg == 0:
                out_shapes[0] = out_shapes[0].partitioned(0, deg, ax)
                self.input_layouts[0] = ParallelTensorShape(
                    (ParallelDim(self.n, deg, ax),) + self.input_layouts[0].dims[1:],
                    in0.dtype)
                for w in weight_shapes:
                    weight_shapes[w] = weight_shapes[w].partitioned(0, deg, ax)
        return out_shapes, weight_shapes

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        y = torch.bmm(x, weights["kernel"])  # "ecd,edh->ech"
        if self.use_bias:
            y = y + weights["bias"][:, None, :]
        return [apply_activation(y, self.activation)]

    def flops(self) -> float:
        return 2.0 * self.n * self.capacity * self.in_dim * self.out_dim


@register_op
class AggregateStacked(_AggregateBase):
    """Aggregate over the stacked expert tensor. Inputs: gate_preds (B, k),
    gate_assign (B, k), full_gate (B, n), exp_stacked (n, capacity, f) ->
    (B, f). Its routing follows :func:`_ep_axis`, as GroupByStacked's."""

    op_type = OpType.AGGREGATE_STACKED
    full_gate_at, experts_at, capacity_dim = 2, 3, 1

    def propagate(self, input_shapes, strategy=None):
        if _ep_axis(input_shapes[3], input_shapes[1].dims[0]) is None:
            return super().propagate(input_shapes, strategy)
        self.honored_strategy_keys = set()
        rows = [_rows_only(s) for s in input_shapes[:3]]
        self.input_layouts = rows + [_rows_only(input_shapes[3])]
        out = ParallelTensorShape((rows[1].dims[0], ParallelDim(self.out_dim)),
                                  self.infer_output_shapes()[0][1])
        return [out], {}

    def forward(self, ctx, inputs, weights):
        gate_preds, assign, full_gate, stacked = inputs
        ep = _ep_axis(self.input_shapes[3], self.input_shapes[1].dims[0]) \
            if ctx.mesh is not None else None
        if ep is None:
            return [self._whole_routing(ctx, gate_preds, assign, full_gate,
                                        stacked.reshape(self.n, self.capacity, -1))]
        ax, deg = ep
        # the experts' outputs back to the ranks that own the tokens, then
        # this rank's combine at the local capacity
        rows = C.experts_to_tokens(stacked.reshape(self.n // deg, self.capacity, -1),
                                   ctx.mesh, ax)
        out = self._combine(ctx, gate_preds, assign, rows)
        group = ctx.mesh.group([ax])
        self._append_aux(ctx, full_gate, C.all_reduce_sum(self._counts(assign), group),
                         assign.shape[0] * group.size)
        return [out]

    def flops(self) -> float:
        return 2.0 * self.batch * self.k * self.n * self.capacity * self.out_dim


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
