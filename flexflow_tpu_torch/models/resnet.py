"""ResNet-50.

PyTorch counterpart of ``flexflow_tpu/models/resnet.py``: bottleneck blocks
with projection shortcuts, batch norm after each convolution with
``use_bn``, and the final average pool that adapts its window to the
feature map (7 at 229 px, smaller at the small test sizes).
"""

from __future__ import annotations

from ..ffconst import ActiMode, DataType, PoolType
from ..runtime.model import FFModel


def _bottleneck(ff: FFModel, t, in_channels: int, out_channels: int, stride: int,
                use_bn: bool, prefix: str):
    shortcut = t
    u = ff.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, ActiMode.NONE, name=f"{prefix}_c1")
    if use_bn:
        u = ff.batch_norm(u)
    u = ff.conv2d(u, out_channels, 3, 3, stride, stride, 1, 1, ActiMode.NONE,
                  name=f"{prefix}_c2")
    if use_bn:
        u = ff.batch_norm(u)
    u = ff.conv2d(u, 4 * out_channels, 1, 1, 1, 1, 0, 0, name=f"{prefix}_c3")
    if use_bn:
        u = ff.batch_norm(u, relu=False)
    if stride > 1 or in_channels != 4 * out_channels:
        shortcut = ff.conv2d(shortcut, 4 * out_channels, 1, 1, stride, stride, 0, 0,
                             ActiMode.NONE, name=f"{prefix}_proj")
        if use_bn:
            shortcut = ff.batch_norm(shortcut, relu=False)
    u = ff.add(shortcut, u)
    return ff.relu(u)


def build_resnet50(ff: FFModel, batch_size: int, num_classes: int = 1000,
                   image_size: int = 229, use_bn: bool = False):
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         DataType.FLOAT, name="input")
    t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3)
    if use_bn:
        t = ff.batch_norm(t)
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    in_ch = 64
    for stage, (blocks, ch) in enumerate([(3, 64), (4, 128), (6, 256), (3, 512)]):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            t = _bottleneck(ff, t, in_ch, ch, stride, use_bn, f"s{stage}b{i}")
            in_ch = 4 * ch
    # the window adapts to the map (a fixed 7 exceeds it below ~200 px)
    k = min(7, t.dims[2], t.dims[3])
    t = ff.pool2d(t, k, k, 1, 1, 0, 0, PoolType.AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    t = ff.softmax(t)
    return x, t
