"""ResNeXt-50 (32x4d).

PyTorch counterpart of ``flexflow_tpu/models/resnext.py``: bottleneck
blocks with grouped 3x3 convolutions (cardinality 32), projection
shortcuts at stage boundaries and the adaptive final average pool.
"""

from __future__ import annotations

from ..ffconst import ActiMode, DataType, PoolType
from ..runtime.model import FFModel


def _resnext_block(ff: FFModel, t, stride: int, out_channels: int, groups: int,
                   in_channels: int, prefix: str):
    """1x1 relu -> grouped 3x3 relu -> 1x1 to 2*out_channels, plus the
    (projected) shortcut."""
    shortcut = t
    u = ff.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{prefix}_c1")
    u = ff.conv2d(u, out_channels, 3, 3, stride, stride, 1, 1, ActiMode.RELU,
                  groups=groups, name=f"{prefix}_c2")
    u = ff.conv2d(u, 2 * out_channels, 1, 1, 1, 1, 0, 0, ActiMode.NONE,
                  name=f"{prefix}_c3")
    if stride > 1 or in_channels != 2 * out_channels:
        shortcut = ff.conv2d(shortcut, 2 * out_channels, 1, 1, stride, stride, 0, 0,
                             ActiMode.RELU, name=f"{prefix}_proj")
    return ff.relu(ff.add(shortcut, u))


def build_resnext50(ff: FFModel, batch_size: int, num_classes: int = 1000,
                    image_size: int = 224, cardinality: int = 32):
    """Stem, then stages [3, 4, 6, 3] at channels [128, 256, 512, 1024]."""
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         DataType.FLOAT, name="input")
    t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3, ActiMode.RELU, name="stem")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, PoolType.MAX)
    in_ch = 64
    for stage, (blocks, ch) in enumerate([(3, 128), (4, 256), (6, 512), (3, 1024)]):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            t = _resnext_block(ff, t, stride, ch, cardinality, in_ch, f"s{stage}b{i}")
            in_ch = 2 * ch
    k = min(7, t.dims[2], t.dims[3])
    t = ff.pool2d(t, k, k, 1, 1, 0, 0, PoolType.AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="logits")
    t = ff.softmax(t)
    return x, t
