"""Partitioned-tensor shapes, single-device subset.

PyTorch counterpart of ``flexflow_tpu/core/parallel_tensor.py``. The port
runs on one device so far, so every dim has degree 1; the names stay so
that the ops read like their JAX counterparts and the parallelism slice
can widen these classes in place.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..ffconst import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One tensor dimension; ``degree`` is 1 until the port shards."""

    size: int
    degree: int = 1

    def __post_init__(self):
        if self.degree != 1:
            raise ValueError("the port runs on one device: degree must be 1")


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.FLOAT

    @staticmethod
    def unpartitioned(shape: Tuple[int, ...],
                      dtype: DataType = DataType.FLOAT) -> "ParallelTensorShape":
        return ParallelTensorShape(tuple(ParallelDim(s) for s in shape), dtype)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims)
