"""Operator base class and registry.

PyTorch counterpart of ``flexflow_tpu/core/op.py``. An Op is a function
over torch tensors plus metadata: a shape rule, declared weights and a
forward. There is no mesh yet, so ``propagate`` only turns the shape rule
into unpartitioned shapes. Random draws (dropout) come from an explicit
``torch.Generator`` per op and step (:meth:`LowerCtx.generator`), where
the JAX package folds the op's index into the step's PRNG key.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import torch

from ..ffconst import DataType, OpType
from .layer import Layer
from .parallel_tensor import ParallelTensorShape


@dataclasses.dataclass
class WeightSpec:
    """A trainable weight declared by an op."""

    name: str
    shape: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT
    initializer: Optional[Any] = None  # Initializer instance or None => op default
    weight_decay: bool = True          # dense kernels yes, biases/norm scales no


@dataclasses.dataclass
class LowerCtx:
    """Context threaded through each op's forward (no mesh yet)."""

    # run every kernel's plain PyTorch version, on any device: the
    # reference the card's kernels are held against
    plain_kernels: bool = False
    # the training forward (train/grad steps) rather than eval/inference
    training: bool = True
    # auxiliary losses the ops append during the forward (the MoE
    # load-balancing term); the compiler passes a list and adds them to
    # the training loss. None: the caller does not collect them
    aux_losses: Optional[list] = None
    # the step's random key (``train_step``'s ``rng``, an int) and the
    # config's seed. Without a key the attention op drops nothing, as the
    # JAX package's does, and a training Dropout op raises
    rng: Optional[int] = None
    seed: int = 0
    # non-trainable state the training forward writes (BatchNorm's running
    # statistics): {(op_name, weight_name): new value}. ``train_step``
    # writes these into the params after the optimizer update; None: the
    # caller does not track state (eval, ``grad_step``, the manual verbs)
    state_updates: Optional[dict] = None

    def generator(self, op_name: str, device: torch.device) -> torch.Generator:
        """A fresh ``torch.Generator`` on ``device`` for one op's draws in
        this step, seeded from the config's seed, the step's key and the
        op's name: the same (seed, step, op) always draws the same mask."""
        if self.rng is None:
            raise ValueError(f"{op_name}: a random draw needs the step's rng key")
        gen = torch.Generator(device=device)
        gen.manual_seed((self.seed * 1_000_003 + int(self.rng) * 7919
                         + zlib.crc32(op_name.encode())) % (1 << 63))
        return gen


class Op:
    """Base operator. Subclasses set ``op_type`` and implement the hooks."""

    op_type: OpType = OpType.NOOP

    def __init__(self, layer: Layer, input_shapes: List[ParallelTensorShape]):
        self.layer = layer
        self.name = layer.name
        self.attrs = layer.attrs
        self.input_shapes = input_shapes
        # filled by the compiler:
        self.output_shapes: List[ParallelTensorShape] = []
        self.weight_shapes: Dict[str, ParallelTensorShape] = {}

    def infer_output_shapes(self) -> List[Tuple[Tuple[int, ...], DataType]]:
        raise NotImplementedError

    def weight_specs(self) -> List[WeightSpec]:
        return []

    def forward(
        self,
        ctx: LowerCtx,
        inputs: Sequence[torch.Tensor],
        weights: Dict[str, torch.Tensor],
    ) -> List[torch.Tensor]:
        raise NotImplementedError

    def materialize(self, device: torch.device) -> None:
        """Put what the op reads every step, besides its weights, on
        ``device`` once, when the model is compiled (Constant's value);
        most ops have nothing."""

    def propagate(
        self, input_shapes: List[ParallelTensorShape]
    ) -> Tuple[List[ParallelTensorShape], Dict[str, ParallelTensorShape]]:
        """Output and weight shapes on one device."""
        out_shapes = [ParallelTensorShape.unpartitioned(sizes, dtype)
                      for sizes, dtype in self.infer_output_shapes()]
        weight_shapes = {
            ws.name: ParallelTensorShape.unpartitioned(ws.shape, ws.dtype)
            for ws in self.weight_specs()
        }
        return out_shapes, weight_shapes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


# registry: OpType -> Op subclass
_OP_REGISTRY: Dict[OpType, Type[Op]] = {}


def register_op(cls: Type[Op]) -> Type[Op]:
    _OP_REGISTRY[cls.op_type] = cls
    return cls


def create_op(layer: Layer, input_shapes: List[ParallelTensorShape]) -> Op:
    try:
        cls = _OP_REGISTRY[layer.op_type]
    except KeyError:
        raise NotImplementedError(
            f"no op registered for {layer.op_type} in the port") from None
    return cls(layer, input_shapes)

