"""Inception-v3.

PyTorch counterpart of ``flexflow_tpu/models/inception.py``: the stem, then
3x InceptionA, InceptionB, 4x InceptionC, InceptionD, 2x InceptionE, the
8x8 average pool and the dense head, with the factorised 1x7/7x1 and
1x3/3x1 convolutions; the same layer names.
"""

from __future__ import annotations

from ..ffconst import ActiMode, DataType, PoolType
from ..runtime.model import FFModel

R = ActiMode.RELU


def _inception_a(ff: FFModel, x, pool_features: int, p: str):
    t1 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, R, name=f"{p}_b1")
    t2 = ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0, R, name=f"{p}_b2a")
    t2 = ff.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, R, name=f"{p}_b2b")
    t3 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, R, name=f"{p}_b3a")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, R, name=f"{p}_b3b")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, R, name=f"{p}_b3c")
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.AVG)
    t4 = ff.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, R, name=f"{p}_b4")
    return ff.concat([t1, t2, t3, t4], axis=1)


def _inception_b(ff: FFModel, x, p: str):
    t1 = ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0, name=f"{p}_b1")
    t2 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, name=f"{p}_b2a")
    t2 = ff.conv2d(t2, 96, 3, 3, 1, 1, 1, 1, name=f"{p}_b2b")
    t2 = ff.conv2d(t2, 96, 3, 3, 2, 2, 0, 0, name=f"{p}_b2c")
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def _inception_c(ff: FFModel, x, ch: int, p: str):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, name=f"{p}_b1")
    t2 = ff.conv2d(x, ch, 1, 1, 1, 1, 0, 0, name=f"{p}_b2a")
    t2 = ff.conv2d(t2, ch, 1, 7, 1, 1, 0, 3, name=f"{p}_b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, name=f"{p}_b2c")
    t3 = ff.conv2d(x, ch, 1, 1, 1, 1, 0, 0, name=f"{p}_b3a")
    t3 = ff.conv2d(t3, ch, 7, 1, 1, 1, 3, 0, name=f"{p}_b3b")
    t3 = ff.conv2d(t3, ch, 1, 7, 1, 1, 0, 3, name=f"{p}_b3c")
    t3 = ff.conv2d(t3, ch, 7, 1, 1, 1, 3, 0, name=f"{p}_b3d")
    t3 = ff.conv2d(t3, 192, 1, 7, 1, 1, 0, 3, name=f"{p}_b3e")
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.AVG)
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0, name=f"{p}_b4")
    return ff.concat([t1, t2, t3, t4], axis=1)


def _inception_d(ff: FFModel, x, p: str):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, name=f"{p}_b1a")
    t1 = ff.conv2d(t1, 320, 3, 3, 2, 2, 0, 0, name=f"{p}_b1b")
    t2 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, name=f"{p}_b2a")
    t2 = ff.conv2d(t2, 192, 1, 7, 1, 1, 0, 3, name=f"{p}_b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, name=f"{p}_b2c")
    t2 = ff.conv2d(t2, 192, 3, 3, 2, 2, 0, 0, name=f"{p}_b2d")
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def _inception_e(ff: FFModel, x, p: str):
    t1 = ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0, name=f"{p}_b1")
    t2i = ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0, name=f"{p}_b2a")
    t2 = ff.conv2d(t2i, 384, 1, 3, 1, 1, 0, 1, name=f"{p}_b2b")
    t3 = ff.conv2d(t2i, 384, 3, 1, 1, 1, 1, 0, name=f"{p}_b2c")
    t3i = ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0, name=f"{p}_b3a")
    t3i = ff.conv2d(t3i, 384, 3, 3, 1, 1, 1, 1, name=f"{p}_b3b")
    t4 = ff.conv2d(t3i, 384, 1, 3, 1, 1, 0, 1, name=f"{p}_b3c")
    t5 = ff.conv2d(t3i, 384, 3, 1, 1, 1, 1, 0, name=f"{p}_b3d")
    t6 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.AVG)
    t6 = ff.conv2d(t6, 192, 1, 1, 1, 1, 0, 0, name=f"{p}_b4")
    return ff.concat([t1, t2, t3, t4, t5, t6], axis=1)


def build_inception_v3(ff: FFModel, batch_size: int, num_classes: int = 10,
                       image_size: int = 299):
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         DataType.FLOAT, name="input")
    t = ff.conv2d(x, 32, 3, 3, 2, 2, 0, 0, R, name="stem1")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, R, name="stem2")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, R, name="stem3")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, R, name="stem4")
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, R, name="stem5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)

    t = _inception_a(ff, t, 32, "a1")
    t = _inception_a(ff, t, 64, "a2")
    t = _inception_a(ff, t, 64, "a3")
    t = _inception_b(ff, t, "b1")
    t = _inception_c(ff, t, 128, "c1")
    t = _inception_c(ff, t, 160, "c2")
    t = _inception_c(ff, t, 160, "c3")
    t = _inception_c(ff, t, 192, "c4")
    t = _inception_d(ff, t, "d1")
    t = _inception_e(ff, t, "e1")
    t = _inception_e(ff, t, "e2")
    t = ff.pool2d(t, 8, 8, 1, 1, 0, 0, PoolType.AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="logits")
    t = ff.softmax(t)
    return x, t
