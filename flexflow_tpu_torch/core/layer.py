"""Lazy layer graph node.

PyTorch counterpart of ``flexflow_tpu/core/layer.py``: the op type, its
attributes, its input tensors and its output tensors. ``compile`` lowers
Layers to Ops.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

from ..ffconst import OpType
from .tensor import Tensor

_layer_ids = itertools.count()


class Layer:
    def __init__(
        self,
        op_type: OpType,
        name: Optional[str] = None,
        inputs: Optional[List[Tensor]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.layer_guid: int = next(_layer_ids)
        self.op_type = op_type
        self.name = name or f"{op_type.value}_{self.layer_guid}"
        self.inputs: List[Tensor] = list(inputs or [])
        self.outputs: List[Tensor] = []
        self.attrs: Dict[str, Any] = dict(attrs or {})

    def add_property(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def get_property(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)

    def __repr__(self) -> str:
        return f"Layer({self.name}, {self.op_type.value}, in={[t.name for t in self.inputs]})"
