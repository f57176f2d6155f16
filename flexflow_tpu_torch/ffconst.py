"""Framework-wide enums.

PyTorch counterpart of ``flexflow_tpu/ffconst.py``: the same names and the
same values, so a graph, a config or a params tree means the same thing in
both packages. ``DataType.to_torch`` takes the place of ``to_jnp``.
"""

from __future__ import annotations

import enum

import torch


class DataType(enum.Enum):
    """Tensor element types (reference: ffconst.h DT_*)."""

    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"
    NONE = "none"

    def to_torch(self) -> torch.dtype:
        if self is DataType.NONE:
            raise ValueError("DT_NONE has no torch dtype")
        return getattr(torch, self.value)

    @staticmethod
    def from_torch(dtype: torch.dtype) -> "DataType":
        return DataType(str(dtype).removeprefix("torch."))

    def itemsize(self) -> int:
        return self.to_torch().itemsize


class ActiMode(enum.Enum):
    """Fused activation modes (reference: ffconst.h AC_MODE_*)."""

    NONE = 10
    RELU = 11
    SIGMOID = 12
    TANH = 13
    GELU = 14


class AggrMode(enum.Enum):
    """Embedding aggregation (reference: ffconst.h AGGR_MODE_*)."""

    NONE = 20
    SUM = 21
    AVG = 22


class PoolType(enum.Enum):
    """Pooling modes (reference: ffconst.h POOL_MAX/POOL_AVG)."""

    MAX = 30
    AVG = 31


class LossType(enum.Enum):
    """Loss functions (reference: ffconst.h LOSS_*)."""

    CATEGORICAL_CROSSENTROPY = 50
    SPARSE_CATEGORICAL_CROSSENTROPY = 51
    MEAN_SQUARED_ERROR_AVG_REDUCE = 52
    MEAN_SQUARED_ERROR_SUM_REDUCE = 53
    IDENTITY = 54


class MetricsType(enum.Enum):
    """Metrics (reference: ffconst.h METRICS_*)."""

    ACCURACY = 1001
    CATEGORICAL_CROSSENTROPY = 1002
    SPARSE_CATEGORICAL_CROSSENTROPY = 1003
    MEAN_SQUARED_ERROR = 1004
    ROOT_MEAN_SQUARED_ERROR = 1005
    MEAN_ABSOLUTE_ERROR = 1006


class CompMode(enum.Enum):
    """Computation mode (reference: ffconst.h COMP_MODE_TRAINING/INFERENCE)."""

    TRAINING = 70
    INFERENCE = 71


class OpType(enum.Enum):
    """Operator types (reference: ffconst.h OperatorType OP_*). The full
    vocabulary of the JAX package; the port registers an op for a type as
    each slice brings it over."""

    INPUT = "input"
    WEIGHT = "weight"
    NOOP = "noop"
    CONSTANT = "constant"
    CONV2D = "conv2d"
    DROPOUT = "dropout"
    LINEAR = "linear"
    BATCHMATMUL = "batch_matmul"
    POOL2D = "pool2d"
    SCALAR_MULTIPLY = "scalar_multiply"
    SCALAR_ADD = "scalar_add"
    SCALAR_SUB = "scalar_sub"
    SCALAR_TRUE_DIV = "scalar_truediv"
    SCALAR_FLOOR_DIV = "scalar_floordiv"
    RELU = "relu"
    IDENTITY = "identity"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    ELU = "elu"
    GELU = "gelu"
    RSQRT = "rsqrt"
    POW = "pow"
    SIN = "sin"
    COS = "cos"
    EXP = "exp"
    FLAT = "flat"
    SOFTMAX = "softmax"
    BATCHNORM = "batch_norm"
    LAYERNORM = "layer_norm"
    CONCAT = "concat"
    SPLIT = "split"
    EMBEDDING = "embedding"
    GATHER = "gather"
    GROUP_BY = "group_by"
    CACHE = "cache"
    AGGREGATE = "aggregate"
    AGGREGATE_SPEC = "aggregate_spec"
    GROUP_BY_STACKED = "group_by_stacked"
    EXPERT_LINEAR = "expert_linear"
    AGGREGATE_STACKED = "aggregate_stacked"
    RESHAPE = "reshape"
    SLICE = "slice"
    REVERSE = "reverse"
    TRANSPOSE = "transpose"
    EW_ADD = "add"
    EW_MUL = "multiply"
    EW_SUB = "subtract"
    EW_DIV = "divide"
    EW_MAX = "max"
    EW_MIN = "min"
    REDUCE_SUM = "reduce_sum"
    MEAN = "mean"
    CAST = "cast"
    TOPK = "topk"
    MULTIHEAD_ATTENTION = "multihead_attention"
    LSTM = "lstm"
    RNN = "rnn"
    GRU = "gru"
    FUSED = "fused"
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"
    ALLREDUCE = "allreduce"
    FUSED_PARALLEL = "fused_parallel"
