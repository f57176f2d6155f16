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

Over a mesh, where the JAX package leaves the data movement to GSPMD:

* Conv2D ``{"out_channels": axis}`` computes this rank's output channels
  from the whole input; ``{"spatial": axis}`` shards the height, and each
  rank widens its rows by the halo its window reads from its neighbours
  (:func:`spatial_window`, point to point), whose gradients go back to
  them in the backward. Pool2D carries a height sharding through the same
  way.
* BatchNorm over a batch or a height sharded over mesh axes normalises by
  the global statistics (SyncBN): the per-channel sums, then the sums of
  squares about their mean, in f32 are all-reduced over those axes with
  the global count, and so are their gradients. A channel dim sharded upstream shards its
  four per-channel weights.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List

import torch
import torch.nn.functional as F

from ..core.op import Op, WeightSpec, register_op
from ..core.parallel_tensor import ParallelDim
from ..ffconst import ActiMode, OpType, PoolType
from ..parallel import collectives as C
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


def spatial_window(x: torch.Tensor, group, height: int, kernel: int, stride: int,
                   pad: int, value: float) -> torch.Tensor:
    """This rank's rows of a height-sharded NCHW ``x`` (rank ``q`` of the
    group holds rows ``[q h, (q+1) h)`` of ``height``) widened to the input
    window of its block of output rows: the halo rows from its neighbours
    (``collectives.halo_rows``) and, past the image's edges, the padding
    rows (``value``) a convolution or pooling of stride ``stride`` and
    padding ``pad`` reads. The result is convolved or pooled without
    padding along H."""
    n = group.size
    out_h = _conv_out(height, kernel, pad, stride)
    per = out_h // n
    windows = [(r * per * stride - pad, (r + 1) * per * stride - stride - pad + kernel)
               for r in range(n)]
    lo, hi = windows[group.index]
    rows = C.halo_rows(x, group, 2, windows)
    top, bottom = max(0, -lo), max(0, hi - height)
    if top or bottom:
        rows = F.pad(rows, (0, 0, top, bottom), value=value)
    return rows


@register_op
class Conv2D(Op):
    op_type = OpType.CONV2D

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        a = self.attrs
        self.out_channels = a["out_channels"]
        self.kernel = tuple(a["kernel"])
        self.stride = tuple(a["stride"])
        self.padding = tuple(a["padding"])
        self.groups = a.get("groups", 1)
        self.use_bias = a.get("use_bias", True)
        self.activation = a.get("activation", ActiMode.NONE)
        self.in_channels = input_shapes[0].sizes[1]
        # the mesh axes the strategy engages (propagate)
        self.oc_axis = self.sp_axis = None

    def propagate(self, input_shapes, strategy=None):
        """The JAX op's rule. ``{"out_channels": axis}`` shards the kernel's
        O dim, the bias and the output's channels (with ``groups`` > 1
        only when the axis degree divides the groups); the input arrives
        whole on the axis and enters through ``copy_to``. ``{"spatial":
        axis}`` shards the height of the input and of the output when both
        divide and each input shard is taller than the kernel's half
        height; a height sharding arriving on an input of the output's
        height carries through the same way (the JAX package's base rule),
        without the key. The input's width and channels arrive whole."""
        strategy = strategy or {}
        out_shapes, weight_shapes = super().propagate(input_shapes, strategy)
        sizes = strategy.get("_axis_sizes", {})
        self.oc_axis = self.sp_axis = None
        ax = strategy.get("out_channels")
        deg = sizes.get(ax, 1) if ax else 1
        if (deg > 1 and self.out_channels % deg == 0
                and (self.groups == 1 or self.groups % deg == 0)):
            dim = ParallelDim(self.out_channels, deg, ax)
            out_shapes[0] = out_shapes[0].with_dim(1, dim)
            weight_shapes["kernel"] = weight_shapes["kernel"].with_dim(0, dim)
            if self.use_bias:
                weight_shapes["bias"] = weight_shapes["bias"].with_dim(0, dim)
            self.oc_axis = ax
        hd = input_shapes[0].dims[2]
        in_h, out_h = input_shapes[0].sizes[2], out_shapes[0].sizes[2]
        ax = strategy.get("spatial") or (hd.axis if hd.is_partitioned and in_h == out_h
                                         else None)
        deg = sizes.get(ax, hd.degree if ax == hd.axis else 1) if ax else 1
        if (deg > 1 and ax not in out_shapes[0].partition_axes
                and in_h % deg == 0 and out_h % deg == 0 and in_h // deg > self.kernel[0] // 2):
            out_shapes[0] = out_shapes[0].with_dim(2, ParallelDim(out_h, deg, ax))
            self.input_layouts[0] = self.input_layouts[0].with_dim(2, ParallelDim(in_h, deg, ax))
            self.sp_axis = ax
            if strategy.get("spatial"):
                self.honored_strategy_keys.add("spatial")
        return out_shapes, weight_shapes

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
        groups, padding = self.groups, self.padding
        if ctx.mesh is not None and self.oc_axis:
            group = ctx.mesh.group([self.oc_axis])
            x = C.copy_to(x, group)
            if groups > 1:
                # this rank's output channels read its groups' input channels
                groups //= group.size
                c = x.shape[1] // group.size
                x = x.narrow(1, group.index * c, c)
        if ctx.mesh is not None and self.sp_axis:
            x = spatial_window(x, ctx.mesh.group([self.sp_axis]), self.input_shapes[0].sizes[2],
                               self.kernel[0], self.stride[0], padding[0], 0.0)
            padding = (0, padding[1])
        y = conv2d(x, weights["kernel"], self.stride, padding, groups)
        if self.use_bias:
            y = y + weights["bias"][None, :, None, None]
        return [apply_activation(y, self.activation)]

    def flops(self) -> float:
        (n, co, oh, ow), _ = self.infer_output_shapes()[0]
        return (2.0 * n * co * oh * ow * (self.in_channels // self.groups)
                * self.kernel[0] * self.kernel[1])

    def input_contraction_dims(self):
        return [(0, 1, "kernel", 1)]  # input C contracts with kernel I


@register_op
class Pool2D(Op):
    op_type = OpType.POOL2D

    def infer_output_shapes(self):
        n, c, h, w = self.input_shapes[0].sizes
        (kh, kw), (ph, pw), (sh, sw) = (self.attrs[k] for k in ("kernel", "padding", "stride"))
        return [((n, c, _conv_out(h, kh, ph, sh), _conv_out(w, kw, pw, sw)),
                 self.input_shapes[0].dtype)]

    # the mesh axis a height sharding carries through on (propagate)
    sp_axis = None

    def propagate(self, input_shapes, strategy=None):
        """The JAX op's rule: a height sharding of the input carries
        through when the pooled height still divides by its degree (the
        input arrives sharded on it; its neighbours' halo rows are
        exchanged); the width and channels arrive whole."""
        out_shapes, weight_shapes = super().propagate(input_shapes, strategy)
        hd = input_shapes[0].dims[2]
        out_h = out_shapes[0].sizes[2]
        self.sp_axis = None
        if (hd.is_partitioned and out_h % hd.degree == 0
                and hd.axis not in out_shapes[0].partition_axes):
            out_shapes[0] = out_shapes[0].with_dim(2, ParallelDim(out_h, hd.degree, hd.axis))
            self.input_layouts[0] = self.input_layouts[0].with_dim(2, hd)
            self.sp_axis = hd.axis
        return out_shapes, weight_shapes

    def forward(self, ctx, inputs, weights):
        (x,) = inputs
        kernel, stride = tuple(self.attrs["kernel"]), tuple(self.attrs["stride"])
        ph, pw = self.attrs["padding"]
        is_max = self.attrs.get("pool_type", PoolType.MAX) is PoolType.MAX
        if ctx.mesh is not None and self.sp_axis:
            x = spatial_window(x, ctx.mesh.group([self.sp_axis]), self.input_shapes[0].sizes[2],
                               kernel[0], stride[0], ph, float("-inf") if is_max else 0.0)
            ph = 0
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

    # the mesh axes sharding the batch dim 0 and the height dim 2
    # (propagate): the statistics are all-reduced over them
    stat_axes: tuple = ()

    def reads_across(self, i):
        # the batch and the height may stay sharded (global statistics);
        # the width is gathered
        return (3,)

    def propagate(self, input_shapes, strategy=None):
        """The output keeps the input's layout (the width gathered); a
        channel dim sharded by an upstream ``out_channels`` shards the four
        per-channel weights the same way; the axes sharding N and H carry
        the statistics' all-reduce."""
        out_shapes, weight_shapes = super().propagate(input_shapes, strategy)
        in0 = self.input_layouts[0]
        out_shapes[0] = in0.with_dim(1, in0.dims[1])
        c = in0.dims[1]
        if c.is_partitioned:
            weight_shapes = {k: w.partitioned(0, c.degree, c.axis)
                             for k, w in weight_shapes.items()}
        self.stat_axes = tuple(in0.dims[d].axis for d in (0, 2) if in0.dims[d].is_partitioned)
        return out_shapes, weight_shapes

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
            # this rank's block (a microbatch's, under grad accumulation)
            count = x.shape[0] * x.shape[2] * x.shape[3]
            if ctx.mesh is not None and self.stat_axes:
                group = ctx.mesh.group(self.stat_axes)
                count *= group.size  # every rank holds an equal block
                var, mean = self._global_stats(x, group, count)
            else:
                var, mean = torch.var_mean(x, dim=(0, 2, 3), keepdim=True, correction=0)
            if ctx.state_updates is not None:
                m = float(self.attrs.get("momentum", 0.1))
                unbiased = var[0, :, 0, 0] * (count / max(1, count - 1))
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

    @staticmethod
    def _global_stats(x: torch.Tensor, group, count: int):
        """(population variance, mean), each (1, C, 1, 1) f32, of the whole
        batch when the group's ranks hold its blocks: the per-channel sums
        in f32 all-reduced over the global count give the mean, then the
        sums of squares about it give the variance (two passes, as
        ``var_mean`` on one rank: squares about zero would lose the
        variance of a channel whose mean is large to cancellation). Both
        directions all-reduce: each rank's loss reads the statistics, so
        their gradient is summed over the group."""
        xf = x.float()
        mean = C.copy_to(C.reduce_from(xf.sum(dim=(0, 2, 3)), group), group) / count
        dev = xf - mean[None, :, None, None]
        var = C.copy_to(C.reduce_from((dev * dev).sum(dim=(0, 2, 3)), group), group) / count
        return var[None, :, None, None], mean[None, :, None, None]
