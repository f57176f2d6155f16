"""The port's float32 Conv2D on the card runs without TF32.

PyTorch lets cuDNN use TF32 for float32 convolutions by default
(``torch.backends.cudnn.allow_tf32 = True``); TF32 keeps 10 bits of
mantissa, about 5e-4 of a sum's size. The port's f32 is f32, so its
Conv2D clears the flag around its own launches, forward and backward.
With the default flag left on, the op's forward and its weight and input
gradients are held to a float64 computation on the card within 1e-5 of
the largest value, which TF32 products miss by far; the same convolution
through ``F.conv2d`` under the default flag is shown to miss it, so the
test sees TF32 where it is on.

Marked ``cuda``; skips without a card. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_conv_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.ffconst import OpType
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = 1e-5  # of the largest |value|; TF32 lands near 5e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 switch acts on cuDNN only")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


def _err(got, want):
    return float((got.detach().double() - want).abs().max() / want.abs().max())


def _conv(card, shape, co, k, s, p, groups):
    """(the port's Conv2D op, x, w) on the card, from a seed."""
    rng = np.random.default_rng(0)
    op = create_op(Layer(OpType.CONV2D, name="c", attrs=dict(
        out_channels=co, kernel=k, stride=s, padding=p, groups=groups, use_bias=False)),
        [ParallelTensorShape.unpartitioned(shape)])
    (wshape,) = [w.shape for w in op.weight_specs()]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.normal(size=wshape) / np.sqrt(np.prod(wshape[1:])))
                         .astype(np.float32)).to(card)
    return op, x.requires_grad_(True), w.requires_grad_(True)


# the weight gradient sums N*H*W products: at a few thousand, f32's own
# accumulation stays well under TOL (at 200,000, cuDNN's f32 weight
# gradient lands near 6e-5), while TF32's rounding of each product costs
# ~5e-4 at any length
@pytest.mark.cuda
@pytest.mark.parametrize("shape,co,k,s,p,groups", [
    ((16, 256, 14, 14), 64, (1, 1), (1, 1), (0, 0), 1),
    ((8, 64, 16, 16), 64, (3, 3), (1, 1), (1, 1), 1),
    ((8, 128, 14, 14), 128, (3, 3), (2, 2), (1, 1), 32),
    ((8, 160, 17, 17), 192, (7, 1), (1, 1), (3, 0), 1),
], ids=["1x1", "3x3", "grouped", "7x1"])
def test_f32_conv2d_runs_without_tf32(card, shape, co, k, s, p, groups):
    op, x, w = _conv(card, shape, co, k, s, p, groups)
    y = op.forward(LowerCtx(training=True), [x], {"kernel": w})[0]
    g = torch.randn(y.shape, device=card, generator=torch.Generator(card).manual_seed(1))
    gx, gw = torch.autograd.grad(y, [x, w], g)
    assert torch.backends.cudnn.allow_tf32  # the caller's flag is left as it was

    x64, w64 = x.detach().double().requires_grad_(True), w.detach().double().requires_grad_(True)
    y64 = F.conv2d(x64, w64, None, s, p, 1, groups)
    gx64, gw64 = torch.autograd.grad(y64, [x64, w64], g.double())
    errs = {"out": _err(y, y64), "grad_x": _err(gx, gx64), "grad_w": _err(gw, gw64)}
    assert max(errs.values()) < TOL, errs


@pytest.mark.cuda
def test_default_flags_take_tf32_where_the_op_does_not(card):
    """The bound above bites: with the default flag, ``F.conv2d`` itself
    lands far outside it on this shape, while the op stays inside."""
    op, x, w = _conv(card, (64, 256, 56, 56), 64, (1, 1), (1, 1), (0, 0), 1)
    want = F.conv2d(x.detach().double(), w.detach().double())
    port = op.forward(LowerCtx(training=False), [x.detach()], {"kernel": w.detach()})[0]
    default = F.conv2d(x.detach(), w.detach())
    assert _err(port, want) < TOL
    assert _err(default, want) > 10 * TOL, _err(default, want)
