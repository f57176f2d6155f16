"""BatchMatmul and MultiHeadAttention operators.

PyTorch counterpart of ``flexflow_tpu/ops/attention.py``. BatchMatmul is
``torch.matmul`` over matching batch dims; its ``a_seq_length_dim`` /
``b_seq_length_dim`` attributes are accepted and have no effect, since
nothing in the port sets a sequence length to truncate to (ROADMAP A9).
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
(:func:`dropout_attention`). Sequence-parallel attention and the sharded
kernel wait for later slices.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..ffconst import OpType
from ..core.op import Op, WeightSpec, register_op
from ..kernels import flash_attention as fa
from .dropout import drop
from ..runtime.initializer import DefaultWeightInitializer, ZeroInitializer


def dropout_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, scale: float, rate: float, ctx,
                      op_name: str) -> torch.Tensor:
    """Attention on (B, S, H, D) tensors with dropout on the probabilities:
    the reference's ``single_device_attention`` (top-left causal mask to
    -inf, softmax, drop, PV) in torch ops."""
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = drop(torch.softmax(s, dim=-1), rate, ctx, op_name)
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
        return [torch.matmul(a, b)]


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

    def infer_output_shapes(self):
        q = self.input_shapes[0].sizes
        return [(q[:-1] + (self.embed_dim,), self.input_shapes[0].dtype)]

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
        # (B, S, E) x (E, H, D) -> (B, S, H, D)
        return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(
            -1, (self.num_heads, self.head_dim))

    def forward(self, ctx, inputs, weights):
        q, k, v = inputs
        qh = self._project(q, weights["wq"])
        kh = self._project(k, weights["wk"])
        vh = self._project(v, weights["wv"])
        if self.use_bias:
            qh = qh + weights["bq"]
            kh = kh + weights["bk"]
            vh = vh + weights["bv"]
        scale = 1.0 / math.sqrt(self.head_dim)
        rate = self.attrs.get("dropout", 0.0)
        if rate > 0.0 and ctx.training and ctx.rng is not None:
            ctxv = dropout_attention(qh, kh, vh, self.causal, scale, rate, ctx, self.name)
        else:
            # any sequence length: the kernels (their plain versions under
            # plain_kernels or on CPU tensors) take ragged tiles, where the
            # reference's op leaves its kernel for single_device_attention
            ctxv = fa.attend(qh, kh, vh, self.causal, scale, plain=ctx.plain_kernels)
        # (B, S, H, D) x (H, D, E) -> (B, S, E)
        out = torch.matmul(ctxv.flatten(-2), weights["wo"].flatten(0, 1))
        if self.use_bias:
            out = out + weights["bo"]
        return [out]
