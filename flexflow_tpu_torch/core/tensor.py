"""Lazy frontend tensors.

PyTorch counterpart of ``flexflow_tpu/core/tensor.py``. A ``Tensor`` is a
symbolic handle made by a graph-construction call on
:class:`~flexflow_tpu_torch.runtime.model.FFModel`; no device memory exists
until ``compile()``.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Optional, Tuple

from ..ffconst import DataType

if TYPE_CHECKING:
    from .layer import Layer
    from ..runtime.model import FFModel

_tensor_ids = itertools.count()


class Tensor:
    """Symbolic tensor in the lazy layer graph; ``dims[0]`` is the
    outermost (batch) dimension."""

    def __init__(
        self,
        dims: Tuple[int, ...],
        dtype: DataType = DataType.FLOAT,
        owner_layer: Optional["Layer"] = None,
        owner_idx: int = 0,
        name: Optional[str] = None,
        model: Optional["FFModel"] = None,
        create_gradients: bool = True,
    ):
        self.tensor_id: int = next(_tensor_ids)
        self.dims: Tuple[int, ...] = tuple(int(d) for d in dims)
        self.dtype: DataType = dtype
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.name = name or f"tensor_{self.tensor_id}"
        self.model = model
        self.create_gradients = create_gradients

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dims

    def get_shape(self) -> Tuple[int, ...]:
        return self.dims

    def __repr__(self) -> str:
        return f"Tensor({self.name}, dims={self.dims}, dtype={self.dtype.name})"
