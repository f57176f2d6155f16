"""Partitioned-tensor shapes: the PCG algebra of dims, degrees and axes.

PyTorch counterpart of ``flexflow_tpu/core/parallel_tensor.py``. Each
dim carries its global ``size``, its partition ``degree`` and the mesh
``axis`` that realizes the partition; ``replica_axes`` records the mesh
axes a tensor is replicated over. The JAX package lowers a shape to a
GSPMD ``PartitionSpec``; the port runs one process per rank, each
holding the block :meth:`ParallelTensorShape.local_sizes` gives, and
:meth:`ParallelTensorShape.partition_spec` is the same spec as a tuple.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..ffconst import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One tensor dimension with its partitioning; ``axis`` is the mesh
    axis the dim is sharded over (None: degree 1)."""

    size: int
    degree: int = 1
    axis: Optional[str] = None

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"degree {self.degree} (must be at least 1)")
        if self.degree > 1:
            if self.axis is None:
                raise ValueError("a partitioned dim needs a mesh axis")
            if self.size % self.degree:
                raise ValueError(
                    f"dim size {self.size} not divisible by degree {self.degree}")

    @property
    def is_partitioned(self) -> bool:
        return self.degree > 1


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.FLOAT
    replica_axes: Tuple[str, ...] = ()  # mesh axes this tensor is replicated over

    @staticmethod
    def unpartitioned(shape: Tuple[int, ...],
                      dtype: DataType = DataType.FLOAT) -> "ParallelTensorShape":
        return ParallelTensorShape(tuple(ParallelDim(s) for s in shape), dtype)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims)

    @property
    def degrees(self) -> Tuple[int, ...]:
        return tuple(d.degree for d in self.dims)

    @property
    def num_parts(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.degree
        return n

    @property
    def partition_axes(self) -> Tuple[str, ...]:
        """The mesh axes that partition some dim, in dim order."""
        return tuple(d.axis for d in self.dims if d.is_partitioned)

    def local_sizes(self) -> Tuple[int, ...]:
        """The block one rank holds."""
        return tuple(d.size // d.degree for d in self.dims)

    def has_duplicate_axes(self) -> bool:
        """True when one mesh axis shards two dims of this tensor, a layout
        no rank grid can hold."""
        axes = self.partition_axes
        return len(set(axes)) != len(axes)

    def partition_spec(self) -> Tuple[Optional[str], ...]:
        """The axis of each partitioned dim, None elsewhere (the JAX
        package's ``PartitionSpec``, as a tuple)."""
        return tuple(d.axis if d.is_partitioned else None for d in self.dims)

    def layout(self) -> Tuple[Tuple[int, Optional[str]], ...]:
        """(degree, axis) per dim: what two shapes of one tensor must share
        for their blocks to be the same."""
        return tuple((d.degree, d.axis if d.is_partitioned else None) for d in self.dims)

    def with_dim(self, idx: int, dim: ParallelDim) -> "ParallelTensorShape":
        dims = list(self.dims)
        dims[idx] = dim
        return dataclasses.replace(self, dims=tuple(dims))

    def partitioned(self, idx: int, degree: int, axis: str) -> "ParallelTensorShape":
        """Repartition: shard one dim over ``axis``."""
        return self.with_dim(idx, ParallelDim(self.dims[idx].size, degree, axis))

    def combined(self, idx: int) -> "ParallelTensorShape":
        """Combine: drop the partitioning of one dim."""
        return self.with_dim(idx, ParallelDim(self.dims[idx].size))

    def replicated(self, axis: str) -> "ParallelTensorShape":
        """Replicate: add a replica axis."""
        if axis in self.replica_axes:
            return self
        return dataclasses.replace(self, replica_axes=self.replica_axes + (axis,))

    def reduced(self, axis: str) -> "ParallelTensorShape":
        """Reduction: consume a replica axis by summing over it."""
        return dataclasses.replace(
            self, replica_axes=tuple(a for a in self.replica_axes if a != axis))

    def __str__(self) -> str:
        parts = [f"{d.size}" + (f"/{d.axis}:{d.degree}" if d.is_partitioned else "")
                 for d in self.dims]
        rep = f" rep={list(self.replica_axes)}" if self.replica_axes else ""
        return f"[{', '.join(parts)}]{rep}"
