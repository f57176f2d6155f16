"""AlexNet.

PyTorch counterpart of ``flexflow_tpu/models/alexnet.py``: the same
conv/pool/dense stack (NCHW), layer for layer.
"""

from __future__ import annotations

from ..ffconst import ActiMode, DataType
from ..runtime.model import FFModel


def build_alexnet(ff: FFModel, batch_size: int, num_classes: int = 10,
                  image_size: int = 229):
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         DataType.FLOAT, name="input")
    t = ff.conv2d(x, 64, 11, 11, 4, 4, 2, 2, ActiMode.RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.RELU)
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU)
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 4096, ActiMode.RELU)
    t = ff.dense(t, 4096, ActiMode.RELU)
    t = ff.dense(t, num_classes)
    t = ff.softmax(t)
    return x, t
