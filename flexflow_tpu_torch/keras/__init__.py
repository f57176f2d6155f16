"""Keras-style frontend.

PyTorch counterpart of ``flexflow_tpu/keras`` (reference:
python/flexflow/keras/ — Sequential/functional ``Model`` whose
``BaseModel.compile`` creates the FFModel + tensors + optimizer,
models/base_model.py:128, and ``fit`` builds SingleDataLoaders and drives
the train loop, base_model.py:198; layer classes mirror Keras).

Layers here are declarative configs; ``__call__`` records a symbolic graph
that is lowered onto a :class:`flexflow_tpu_torch.FFModel` when the batch
size is known (at ``fit``/``evaluate``), as the reference defers building
to ``compile``.
"""

from .layers import (
    Activation,
    Add,
    AveragePooling2D,
    BatchNormalization,
    Concatenate,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    Input,
    LayerNormalization,
    MaxPooling2D,
    Multiply,
    Reshape,
    Subtract,
)
from .callbacks import (
    Callback,
    EarlyStopping,
    EpochVerifyMetrics,
    History,
    LearningRateScheduler,
    ModelAccuracy,
    VerifyMetrics,
)
from .models import Model, Sequential
from .optimizers import SGD, Adam
from . import datasets
from .regularizers import L1, L1L2, L2, Regularizer

__all__ = [
    "Activation", "Add", "AveragePooling2D", "BatchNormalization",
    "Concatenate", "Conv2D", "Dense", "Dropout", "Embedding", "Flatten",
    "Input", "LayerNormalization", "MaxPooling2D", "Multiply", "Reshape",
    "Subtract", "Model", "Sequential", "SGD", "Adam",
    "Callback", "EarlyStopping", "EpochVerifyMetrics", "History",
    "LearningRateScheduler", "ModelAccuracy", "VerifyMetrics",
    "datasets", "Regularizer", "L1", "L1L2", "L2",
]
