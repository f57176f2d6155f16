"""Keras-style layer configs, the PyTorch counterpart of
``flexflow_tpu/keras/layers.py`` (reference: python/flexflow/keras/layers/ —
core.py Dense/Flatten/Dropout, convolutional.py Conv2D, pool.py
MaxPooling2D, merge.py Add/Concatenate, normalization.py
BatchNormalization). Each records into a symbolic graph; lowering happens
in models.py via FFModel's builder."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from ..ffconst import ActiMode, PoolType

_ACTI = {
    None: ActiMode.NONE, "linear": ActiMode.NONE, "relu": ActiMode.RELU,
    "sigmoid": ActiMode.SIGMOID, "tanh": ActiMode.TANH, "gelu": ActiMode.GELU,
    "softmax": "softmax",
}


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class SymTensor:
    """Symbolic tensor in the keras graph (pre-FFModel)."""

    def __init__(self, layer: Optional["KerasLayer"], inputs: List["SymTensor"],
                 shape: Optional[Tuple[int, ...]] = None):
        self.layer = layer
        self.inputs = inputs
        self.shape = shape  # without batch dim; None until known


class KerasLayer:
    _counter = 0

    def __init__(self, name: Optional[str] = None):
        type(self)._counter += 1
        cls = type(self).__name__.lower()
        self.name = name or f"{cls}_{type(self)._counter}"
        self.input_shape: Optional[Tuple[int, ...]] = None

    def __call__(self, x: Union[SymTensor, Sequence[SymTensor]]) -> SymTensor:
        ins = list(x) if isinstance(x, (list, tuple)) else [x]
        return SymTensor(self, ins)

    # lowering: emit FF builder calls; `x` are FF Tensors
    def emit(self, ff, x):
        raise NotImplementedError


def Input(shape: Sequence[int], name: Optional[str] = None) -> SymTensor:
    """reference: keras Input tensors created in BaseModel.compile."""
    return SymTensor(None, [], tuple(shape))


class Dense(KerasLayer):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 input_shape: Optional[Sequence[int]] = None,
                 kernel_initializer=None, bias_initializer=None,
                 kernel_regularizer=None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer
        if input_shape is not None:
            self.input_shape = tuple(input_shape)

    def emit(self, ff, x):
        act = _ACTI[self.activation]
        if act == "softmax":
            out = ff.dense(x[0], self.units, activation=ActiMode.NONE,
                           use_bias=self.use_bias,
                           kernel_initializer=self.kernel_initializer,
                           bias_initializer=self.bias_initializer,
                           kernel_regularizer=self.kernel_regularizer,
                           name=self.name)
            return ff.softmax(out, name=self.name + "_softmax")
        return ff.dense(x[0], self.units, activation=act,
                        use_bias=self.use_bias,
                        kernel_initializer=self.kernel_initializer,
                        bias_initializer=self.bias_initializer,
                        kernel_regularizer=self.kernel_regularizer,
                        name=self.name)


class Conv2D(KerasLayer):
    """NCHW, matching the reference keras frontend's layout."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: Union[str, int, Tuple[int, int]] = "valid",
                 activation=None, use_bias: bool = True, groups: int = 1,
                 input_shape: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.filters = filters
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        if padding == "same":
            self.padding = (self.kernel[0] // 2, self.kernel[1] // 2)
        elif padding == "valid":
            self.padding = (0, 0)
        else:
            self.padding = _pair(padding)
        self.activation = activation
        self.use_bias = use_bias
        self.groups = groups
        if input_shape is not None:
            self.input_shape = tuple(input_shape)

    def emit(self, ff, x):
        act = _ACTI[self.activation]
        assert act != "softmax"
        return ff.conv2d(x[0], self.filters, self.kernel[0], self.kernel[1],
                         self.strides[0], self.strides[1], self.padding[0],
                         self.padding[1], activation=act, groups=self.groups,
                         use_bias=self.use_bias, name=self.name)


class _Pool2D(KerasLayer):
    pool_type = PoolType.MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name: Optional[str] = None):
        super().__init__(name)
        self.pool = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool
        if padding == "same":
            self.padding = (self.pool[0] // 2, self.pool[1] // 2)
        elif padding == "valid":
            self.padding = (0, 0)
        else:
            self.padding = _pair(padding)

    def emit(self, ff, x):
        return ff.pool2d(x[0], self.pool[0], self.pool[1], self.strides[0],
                         self.strides[1], self.padding[0], self.padding[1],
                         pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = PoolType.MAX


class AveragePooling2D(_Pool2D):
    pool_type = PoolType.AVG


class Flatten(KerasLayer):
    def __init__(self, input_shape: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        if input_shape is not None:
            self.input_shape = tuple(input_shape)

    def emit(self, ff, x):
        return ff.flat(x[0], name=self.name)


class Dropout(KerasLayer):
    def __init__(self, rate: float, name: Optional[str] = None):
        super().__init__(name)
        self.rate = rate

    def emit(self, ff, x):
        return ff.dropout(x[0], rate=self.rate, name=self.name)


class BatchNormalization(KerasLayer):
    def __init__(self, relu: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.relu = relu

    def emit(self, ff, x):
        return ff.batch_norm(x[0], relu=self.relu, name=self.name)


class LayerNormalization(KerasLayer):
    def __init__(self, axis=-1, epsilon: float = 1e-5,
                 name: Optional[str] = None):
        super().__init__(name)
        self.axes = [axis] if isinstance(axis, int) else list(axis)
        self.eps = epsilon

    def emit(self, ff, x):
        return ff.layer_norm(x[0], axes=self.axes, eps=self.eps, name=self.name)


class Embedding(KerasLayer):
    def __init__(self, input_dim: int, output_dim: int,
                 input_shape: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim
        if input_shape is not None:
            self.input_shape = tuple(input_shape)

    def emit(self, ff, x):
        from ..ffconst import AggrMode

        return ff.embedding(x[0], self.input_dim, self.output_dim,
                            aggr=AggrMode.NONE, name=self.name)


class Activation(KerasLayer):
    def __init__(self, activation: str, name: Optional[str] = None):
        super().__init__(name)
        self.activation = activation

    def emit(self, ff, x):
        if self.activation == "softmax":
            return ff.softmax(x[0], name=self.name)
        return getattr(ff, self.activation)(x[0], name=self.name)


class Reshape(KerasLayer):
    def __init__(self, target_shape: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.target_shape = tuple(target_shape)

    def emit(self, ff, x):
        batch = x[0].dims[0]
        return ff.reshape(x[0], (batch,) + self.target_shape, name=self.name)


class Concatenate(KerasLayer):
    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def emit(self, ff, x):
        return ff.concat(list(x), axis=self.axis, name=self.name)


class _Merge(KerasLayer):
    op = "add"

    def emit(self, ff, x):
        out = x[0]
        for other in x[1:]:
            out = getattr(ff, self.op)(out, other, name=self.name)
        return out


class Add(_Merge):
    op = "add"


class Subtract(_Merge):
    op = "subtract"


class Multiply(_Merge):
    op = "multiply"
