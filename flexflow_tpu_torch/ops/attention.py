"""BatchMatmul and MultiHeadAttention operators.

PyTorch counterpart of ``flexflow_tpu/ops/attention.py``. BatchMatmul is
``torch.matmul`` over matching batch dims; with a positive
``LowerCtx.seq_length`` (``FFIterationConfig.seq_length``, or a step's
``seq_length``) it first slices its ``a_seq_length_dim`` /
``b_seq_length_dim`` (when >= 0) to that length, as the reference does.
MultiHeadAttention keeps the JAX op's weights in the same layouts
(``wq/wk/wv`` (E, H, D), ``wo`` (H, D, E), biases ``bq/bk/bv`` (H, D) and
``bo`` (E,)) and the same math. The attention itself goes through
:func:`~flexflow_tpu_torch.kernels.flash_attention.attend` at any sequence
length, which
launches the Hopper kernels on CUDA tensors (the forward, and under autograd
the two backward kernels) and runs their plain versions on CPU tensors.
With attention dropout while training the op takes the reference's own
route for it: neither package's kernel drops, so the JAX op leaves its
kernel for ``single_device_attention``, which drops the softmax
probabilities, and this op runs the same math in torch ops
(:func:`dropout_attention`).

Under a mesh the op takes the JAX op's strategy keys. ``"heads"`` shards
the projections on their head dim (the replicated input enters through
``copy_to``, the output projection's partial sums are all-reduced before
``bo``); then each rank's (B/dp, S, H/tp, D) block goes through
:func:`~flexflow_tpu_torch.kernels.flash_attention.sharded_flash_attention`,
the same kernels. ``"seq"`` shards the sequence: q/k/v arrive sliced on it
and ``parallel/ring_attention.py`` runs the ring, or with ``"seq_mode":
"a2a"`` (heads divisible by the degree) the all-to-all schedule. Dropout
under a mesh draws the mask of the whole probability matrix, as the
one-rank op does, and keeps this rank's block.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..ffconst import OpType
from ..core.op import Op, WeightSpec, register_op
from ..core.parallel_tensor import ParallelDim, ParallelTensorShape
from ..kernels import flash_attention as fa
from ..parallel import collectives as C
from ..parallel.ring_attention import ring_attention, ulysses_attention
from .dropout import drop
from ..runtime.initializer import DefaultWeightInitializer, ZeroInitializer


def dropout_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, scale: float, rate: float, ctx,
                      op_name: str, mask_layout=None) -> torch.Tensor:
    """Attention on (B, S, H, D) tensors with dropout on the probabilities:
    the reference's ``single_device_attention`` (top-left causal mask to
    -inf, softmax, drop, PV) in torch ops. ``mask_layout``: the layout of
    the whole (B, H, Sq, Sk) probabilities when this rank holds a block."""
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = drop(torch.softmax(s, dim=-1), rate, ctx, op_name, mask_layout)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@register_op
class BatchMatmul(Op):
    op_type = OpType.BATCHMATMUL

    def infer_output_shapes(self):
        a, b = self.input_shapes
        if not (len(a.sizes) == len(b.sizes) >= 3 and a.sizes[:-2] == b.sizes[:-2]
                and a.sizes[-1] == b.sizes[-2]):
            raise ValueError(f"{self.name}: batch_matmul of {a.sizes} and {b.sizes}")
        return [(a.sizes[:-1] + (b.sizes[-1],), a.dtype)]

    def forward(self, ctx, inputs, weights):
        a, b = inputs
        sl = ctx.seq_length
        if sl and sl > 0:
            ad = self.attrs.get("a_seq_length_dim", -1)
            bd = self.attrs.get("b_seq_length_dim", -1)
            if ad >= 0:
                a = a.narrow(ad, 0, sl)
            if bd >= 0:
                b = b.narrow(bd, 0, sl)
        return [torch.matmul(a, b)]

    def flops(self) -> float:
        a, b = self.input_shapes
        return 2.0 * math.prod(a.sizes[:-2]) * a.sizes[-2] * a.sizes[-1] * b.sizes[-1]


@register_op
class MultiHeadAttention(Op):
    op_type = OpType.MULTIHEAD_ATTENTION

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        a = self.attrs
        self.embed_dim = a["embed_dim"]
        self.num_heads = a["num_heads"]
        self.use_bias = bool(a.get("bias", True))
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads "
                f"{self.num_heads}")
        self.head_dim = self.embed_dim // self.num_heads
        self.q_in = input_shapes[0].sizes[-1]
        self.k_in = input_shapes[1].sizes[-1]
        self.v_in = input_shapes[2].sizes[-1]
        self.causal = bool(a.get("causal", False))
        # mesh axes the strategy engages (propagate)
        self.heads_axis = self.seq_axis = None
        self.seq_mode = "ring"  # "ring" | "a2a" (Ulysses)

    def infer_output_shapes(self):
        q = self.input_shapes[0].sizes
        return [(q[:-1] + (self.embed_dim,), self.input_shapes[0].dtype)]

    def reads_across(self, i):
        return (1, 2)

    def propagate(self, input_shapes, strategy=None):
        """The JAX op's rule: ``"heads"`` shards wq/wk/wv on dim 1, wo and
        the q/k/v biases on dim 0, when the axis degree divides the heads;
        ``"seq"`` shards the output's sequence dim when q/k/v share a
        length the degree divides, ``"seq_mode": "a2a"`` taking the
        all-to-all schedule where the heads divide too (else the ring).
        Under ``"seq"`` q/k/v arrive sliced on the sequence."""
        strategy = strategy or {}
        out_shapes, weight_shapes = super().propagate(input_shapes, strategy)
        sizes = strategy.get("_axis_sizes", {})
        self.heads_axis = self.seq_axis = None
        ax = strategy.get("heads")
        if ax and sizes.get(ax, 1) > 1 and self.num_heads % sizes[ax] == 0:
            deg = sizes[ax]
            for wn in ("wq", "wk", "wv"):
                weight_shapes[wn] = weight_shapes[wn].partitioned(1, deg, ax)
            weight_shapes["wo"] = weight_shapes["wo"].partitioned(0, deg, ax)
            for bn in ("bq", "bk", "bv"):
                if bn in weight_shapes:
                    weight_shapes[bn] = weight_shapes[bn].partitioned(0, deg, ax)
            self.heads_axis = ax
        sax = strategy.get("seq")
        if sax:
            deg = sizes.get(sax, 1)
            seqs = {s.sizes[1] for s in input_shapes[:3]}
            seq = input_shapes[0].sizes[1]
            if deg > 1 and len(seqs) == 1 and seq % deg == 0:
                self.seq_axis = sax
                local_heads = self.num_heads // (sizes[self.heads_axis] if self.heads_axis else 1)
                self.seq_mode = ("a2a" if strategy.get("seq_mode", "ring") == "a2a"
                                 and local_heads % deg == 0 else "ring")
                out_shapes[0] = out_shapes[0].partitioned(1, deg, sax)
                self.input_layouts = [s.partitioned(1, deg, sax) for s in self.input_layouts]
                self.honored_strategy_keys.add("seq")
        return out_shapes, weight_shapes

    def weight_specs(self) -> List[WeightSpec]:
        dt = self.input_shapes[0].dtype
        init = self.attrs.get("kernel_initializer") or DefaultWeightInitializer()
        h, d = self.num_heads, self.head_dim
        specs = [
            WeightSpec("wq", (self.q_in, h, d), dt, init),
            WeightSpec("wk", (self.k_in, h, d), dt, init),
            WeightSpec("wv", (self.v_in, h, d), dt, init),
            WeightSpec("wo", (h, d, self.embed_dim), dt, init),
        ]
        if self.use_bias:
            specs += [
                WeightSpec("bq", (h, d), dt, ZeroInitializer(), weight_decay=False),
                WeightSpec("bk", (h, d), dt, ZeroInitializer(), weight_decay=False),
                WeightSpec("bv", (h, d), dt, ZeroInitializer(), weight_decay=False),
                WeightSpec("bo", (self.embed_dim,), dt, ZeroInitializer(),
                           weight_decay=False),
            ]
        return specs

    def _project(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        # (B, S, E) x (E, H, D) -> (B, S, H, D); H is this rank's heads
        return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])

    def _mask_layout(self):
        """The layout of the whole (B, H, Sq, Sk) probabilities: batch as
        q arrives, heads as the weights are sharded."""
        q = self.input_layouts[0]
        h = self.weight_shapes["wq"].dims[1]
        return ParallelTensorShape((q.dims[0], h, ParallelDim(q.sizes[1]),
                                    ParallelDim(self.input_layouts[1].sizes[1])))

    def flops(self) -> float:
        b, s = self.input_shapes[0].sizes[0], self.input_shapes[0].sizes[1]
        e, h, d = self.embed_dim, self.num_heads, self.head_dim
        return 2.0 * b * s * e * h * d * 4 + 2.0 * b * h * s * s * d * 2

    def forward(self, ctx, inputs, weights):
        q, k, v = inputs
        mesh = ctx.mesh
        if mesh is not None and self.heads_axis:
            group = mesh.group([self.heads_axis])
            entered = {}
            q, k, v = [entered.setdefault(id(t), C.copy_to(t, group)) for t in (q, k, v)]
        qh = self._project(q, weights["wq"])
        kh = self._project(k, weights["wk"])
        vh = self._project(v, weights["wv"])
        if self.use_bias:
            qh = qh + weights["bq"]
            kh = kh + weights["bk"]
            vh = vh + weights["bv"]
        scale = 1.0 / math.sqrt(self.head_dim)
        rate = self.attrs.get("dropout", 0.0)
        if not (rate > 0.0 and ctx.training and ctx.rng is not None):
            rate = 0.0
        if mesh is not None and self.seq_axis:
            u = None
            if rate > 0.0:
                layout = self._mask_layout()
                u = ctx.uniform(self.name, layout.sizes,
                                qh.device)[mesh.local_slices(layout)[:2]]
            sp = ulysses_attention if self.seq_mode == "a2a" else ring_attention
            ctxv = sp(qh, kh, vh, mesh, self.seq_axis, causal=self.causal, scale=scale,
                      dropout_rate=rate, u=u)
        elif rate > 0.0:
            ctxv = dropout_attention(qh, kh, vh, self.causal, scale, rate, ctx, self.name,
                                     self._mask_layout() if mesh is not None else None)
        elif mesh is not None:
            bdim = self.input_layouts[0].dims[0]
            ctxv = fa.sharded_flash_attention(
                qh, kh, vh, mesh, bdim.axis if bdim.is_partitioned else None,
                self.heads_axis, self.causal, scale, plain=ctx.plain_kernels)
        else:
            # any sequence length: the kernels (their plain versions under
            # plain_kernels or on CPU tensors) take ragged tiles, where the
            # reference's op leaves its kernel for single_device_attention
            ctxv = fa.attend(qh, kh, vh, self.causal, scale, plain=ctx.plain_kernels)
        # (B, S, H, D) x (H, D, E) -> (B, S, E)
        out = torch.matmul(ctxv.flatten(-2), weights["wo"].flatten(0, 1))
        if mesh is not None and self.heads_axis:
            out = C.reduce_from(out, mesh.group([self.heads_axis]))
        if self.use_bias:
            out = out + weights["bo"]
        return [out]
