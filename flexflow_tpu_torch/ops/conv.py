"""Convolution, pooling and batch-norm operators (NCHW, OIHW kernels).

PyTorch counterpart of ``flexflow_tpu/ops/conv.py``:

* Conv2D: ``F.conv2d`` (cuDNN on the card) with ``groups``, the bias added
  after it and the fused activation through ``ops/linear.py``'s, as the JAX
  op adds them after ``lax.conv_general_dilated``. A float32 convolution
  runs without TF32 in its forward and its backward, whatever
  ``torch.backends.cudnn.allow_tf32`` the caller set: the port's f32 is
  f32 (:class:`_Conv2dFn` holds the flag off around each launch).
* Pool2D: max pooling pads with -inf and routes a tied gradient to the
  window's first maximum in row-major order, as ``reduce_window``'s
  ``select_and_scatter`` does; average pooling divides by the full window,
  padding included (``count_include_pad=True``), as cuDNN's does.
* BatchNorm: batch statistics (the population variance to normalise) while
  training, the running statistics in eval, then ``scale``/``bias`` and an
  optional fused ReLU (on by default). The training forward leaves the
  updated running averages in ``LowerCtx.state_updates`` (momentum 0.1,
  the unbiased variance feeding ``running_var``); ``train_step`` writes
  them after the optimizer update. The arithmetic, and where it promotes
  bf16 to f32 (the statistics stay f32 under bf16), follows the JAX op.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List

import torch
import torch.nn.functional as F

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, OpType, PoolType
from ..runtime.initializer import (ConstantInitializer, DefaultBiasInitializer,
                                   DefaultWeightInitializer, ZeroInitializer)
from .linear import apply_activation, relu


def _conv_out(size: int, kernel: int, pad: int, stride: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


# cuDNN's TF32 switch is process-wide; f32 convolutions clear it around
# their launches under this lock, so two threads cannot restore it under
# each other's launch
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def _no_tf32(x: torch.Tensor):
    """cuDNN without TF32 for a float32 CUDA tensor's convolution."""
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    with _TF32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


class _Conv2dFn(torch.autograd.Function):
    """``F.conv2d`` without bias whose forward and backward both launch
    under :func:`_no_tf32` (autograd runs a backward after the forward's
    scope is gone, so the flag has to be held there too)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        with _no_tf32(x):
            return F.conv2d(x, w, None, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        with _no_tf32(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(stride), list(padding), [1, 1], False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride, padding, groups: int) -> torch.Tensor:
    """NCHW x OIHW -> NCHW, f32 without TF32 on the card."""
    return _Conv2dFn.apply(x, w, tuple(stride), tuple(padding), groups)


@register_op
class Conv2D(Op):
    op_type = OpType.CONV2D

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        a = self.attrs
        if a.get("strategy"):
            raise NotImplementedError(
                f"{self.name}: a sharded convolution is ROADMAP A7b")
        self.out_channels = a["out_channels"]
        self.kernel = tuple(a["kernel"])
        self.stride = tuple(a["stride"])
        self.padding = tuple(a["padding"])
        self.groups = a.get("groups", 1)
        self.use_bias = a.get("use_bias", True)
        self.activation = a.get("activation", ActiMode.NONE)
        self.in_channels = input_shapes[0].sizes[1]

    def infer_output_shapes(self):
        n, _, h, w = self.input_shapes[0].sizes
        oh = _conv_out(h, self.kernel[0], self.padding[0], self.stride[0])
        ow = _conv_out(w, self.kernel[1], self.padding[1], self.stride[1])
        return [((n, self.out_channels, oh, ow), self.input_shapes[0].dtype)]

    def weight_specs(self) -> List[WeightSpec]:
        dt = self.input_shapes[0].dtype
        specs = [WeightSpec(
            "kernel", (self.out_channels, self.in_channels // self.groups, *self.kernel),
            dt, self.attrs.get("kernel_initializer") or DefaultWeightInitializer())]
        if self.use_bias:
            specs.append(WeightSpec(
                "bias", (self.out_channels,), dt,
                self.attrs.get("bias_initializer") or DefaultBiasInitializer(),
                weight_decay=False))
        return specs

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        y = conv2d(x, weights["kernel"], self.stride, self.padding, self.groups)
        if self.use_bias:
            y = y + weights["bias"][None, :, None, None]
        return [apply_activation(y, self.activation)]

    def flops(self) -> float:
        (n, co, oh, ow), _ = self.infer_output_shapes()[0]
        return (2.0 * n * co * oh * ow * (self.in_channels // self.groups)
                * self.kernel[0] * self.kernel[1])


@register_op
class Pool2D(Op):
    op_type = OpType.POOL2D

    def infer_output_shapes(self):
        n, c, h, w = self.input_shapes[0].sizes
        (kh, kw), (ph, pw), (sh, sw) = (self.attrs[k] for k in ("kernel", "padding", "stride"))
        return [((n, c, _conv_out(h, kh, ph, sh), _conv_out(w, kw, pw, sw)),
                 self.input_shapes[0].dtype)]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        kernel, stride = tuple(self.attrs["kernel"]), tuple(self.attrs["stride"])
        ph, pw = self.attrs["padding"]
        is_max = self.attrs.get("pool_type", PoolType.MAX) is PoolType.MAX
        if ph > kernel[0] // 2 or pw > kernel[1] // 2:
            # torch pools pad at most half a window; pad explicitly (with
            # the value reduce_window pads with) and pool unpadded
            x = F.pad(x, (pw, pw, ph, ph), value=float("-inf") if is_max else 0.0)
            ph = pw = 0
        if is_max:
            # ties: torch's max pooling keeps the first maximum it meets
            # (a later element replaces it only when strictly greater), the
            # element select_and_scatter's >= picks
            y = F.max_pool2d(x, kernel, stride, (ph, pw))
        else:
            y = F.avg_pool2d(x, kernel, stride, (ph, pw), count_include_pad=True)
        return [apply_activation(y, self.attrs.get("activation", ActiMode.NONE))]


@register_op
class BatchNorm(Op):
    """Batch normalisation over N, H and W per channel (NCHW). The running
    mean and variance are weights with no weight decay that the loss never
    reaches (a zero gradient): they change only through ``train_step``'s
    write-back of ``LowerCtx.state_updates``."""

    op_type = OpType.BATCHNORM

    def reads_across(self, i):
        # the batch statistics: a sharded batch raises (SyncBN-style global
        # statistics are ROADMAP A7b)
        return (0, 2, 3)

    def infer_output_shapes(self):
        return [(self.input_shapes[0].sizes, self.input_shapes[0].dtype)]

    def weight_specs(self):
        c = self.input_shapes[0].sizes[1]
        dt = self.input_shapes[0].dtype
        return [
            WeightSpec("scale", (c,), dt, ConstantInitializer(1.0), weight_decay=False),
            WeightSpec("bias", (c,), dt, ZeroInitializer(), weight_decay=False),
            WeightSpec("running_mean", (c,), dt, ZeroInitializer(), weight_decay=False),
            WeightSpec("running_var", (c,), dt, ConstantInitializer(1.0),
                       weight_decay=False),
        ]

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        eps = float(self.attrs.get("eps", 1e-5))
        if ctx.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), keepdim=True, correction=0)
            if ctx.state_updates is not None:
                m = float(self.attrs.get("momentum", 0.1))
                n = x.shape[0] * x.shape[2] * x.shape[3]
                unbiased = var[0, :, 0, 0] * (n / max(1, n - 1))
                ctx.state_updates[(self.name, "running_mean")] = (
                    (1.0 - m) * weights["running_mean"] + m * mean[0, :, 0, 0])
                ctx.state_updates[(self.name, "running_var")] = (
                    (1.0 - m) * weights["running_var"] + m * unbiased)
        else:
            mean = weights["running_mean"][None, :, None, None]
            var = weights["running_var"][None, :, None, None]
        y = (x - mean) * torch.rsqrt(var + eps)
        y = y * weights["scale"][None, :, None, None] + weights["bias"][None, :, None, None]
        if self.attrs.get("relu", True):
            y = relu(y)
        return [y]
