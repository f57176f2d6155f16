"""Operator base class and registry.

PyTorch counterpart of ``flexflow_tpu/core/op.py``. An Op is a function
over torch tensors plus metadata: a shape rule, declared weights and a
forward. ``propagate(input_shapes, strategy)`` maps the inputs' layouts
over the mesh (``ParallelTensorShape``) and the op's strategy to its
output and weight layouts, as the JAX package's does, and also records in
``input_layouts`` the layout each input must arrive in: where a producer's
layout differs, the compiler inserts the transition (a slice or an
all-gather), where the JAX package leaves the resharding to GSPMD. Under
a mesh each rank's forward sees its local blocks. Random draws (dropout)
come from an explicit ``torch.Generator`` per op and step
(:meth:`LowerCtx.generator`), where the JAX package folds the op's index
into the step's PRNG key.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import torch

from ..ffconst import DataType, OpType
from .layer import Layer
from .parallel_tensor import ParallelDim, ParallelTensorShape


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
    """Context threaded through each op's forward."""

    # the rank grid (``core/machine.Mesh``) under SPMD; None on one device
    mesh: Optional[Any] = None
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
    # FFIterationConfig.seq_length: > 0 truncates the sequence dims ops
    # declare (BatchMatmul's a/b_seq_length_dim); -1 truncates nothing
    seq_length: int = -1

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
    # inputs line up from their trailing dims (broadcasting elementwise ops)
    broadcasts_from_right = False

    def __init__(self, layer: Layer, input_shapes: List[ParallelTensorShape]):
        self.layer = layer
        self.name = layer.name
        self.attrs = layer.attrs
        self.input_shapes = input_shapes
        # filled by the compiler:
        self.output_shapes: List[ParallelTensorShape] = []
        self.weight_shapes: Dict[str, ParallelTensorShape] = {}
        # the layout each input must arrive in (propagate sets it)
        self.input_layouts: List[ParallelTensorShape] = list(input_shapes)
        self.honored_strategy_keys: set = set()

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

    def flops(self) -> float:
        """Forward FLOPs, the JAX package's estimate (the pipeline's stage
        split balances by it); 0 for ops it does not price."""
        return 0.0

    def materialize(self, device: torch.device) -> None:
        """Put what the op reads every step, besides its weights, on
        ``device`` once, when the model is compiled (Constant's value);
        most ops have nothing."""

    def reads_across(self, i: int) -> Tuple[int, ...]:
        """The dims of input ``i`` that one output element reads across (a
        reduction, a product, a reshape). A sharded one is gathered before
        the op runs, the batch dim 0 among them: the op then computes on
        the whole batch, as GSPMD's reshard does in the JAX package. Ops
        that reduce over the batch themselves (Reduce*, BatchNorm) keep
        dim 0 sharded and run a collective instead. Default: every dim but
        dim 0."""
        return tuple(range(1, len(self.input_shapes[i].dims)))

    def readable(self, i: int, shape: ParallelTensorShape) -> ParallelTensorShape:
        """``shape`` with the dims :meth:`reads_across` names unpartitioned."""
        for d in self.reads_across(i):
            if shape.dims[d].is_partitioned:
                shape = shape.combined(d)
        return shape

    def propagate(
        self, input_shapes: List[ParallelTensorShape],
        strategy: Optional[Dict[str, Any]] = None,
    ) -> Tuple[List[ParallelTensorShape], Dict[str, ParallelTensorShape]]:
        """Output and weight layouts under ``strategy`` (its
        ``"_axis_sizes"`` entry maps mesh axis to degree). The default rule,
        the JAX package's: outputs inherit input 0's partitioning on the
        dims they share its size with; weights are replicated. Input 0
        arrives with the dims it reads across gathered, the other inputs
        in input 0's partitioning where their dims line up with its own
        (from the right for broadcasting elementwise ops), unpartitioned
        elsewhere. ``honored_strategy_keys`` records the entries realized
        without changing a shape (attention's ``seq_mode``)."""
        self.honored_strategy_keys = set()
        in0 = self.readable(0, input_shapes[0]) if input_shapes else None
        self.input_layouts = ([in0] if input_shapes else []) + [
            self.readable(i, _aligned(s, in0, self.broadcasts_from_right))
            for i, s in enumerate(input_shapes[1:], start=1)]
        out_shapes = [_aligned(ParallelTensorShape.unpartitioned(sizes, dtype), in0, False)
                      for sizes, dtype in self.infer_output_shapes()]
        weight_shapes = {
            ws.name: ParallelTensorShape.unpartitioned(ws.shape, ws.dtype)
            for ws in self.weight_specs()
        }
        return out_shapes, weight_shapes

    def input_contraction_dims(self) -> List[Tuple[int, int, Optional[str], int]]:
        """(input index, input dim, weight name, weight dim) for each input
        dim summed against a weight dim, the JAX package's contraction
        structure: the simulator prices a contraction sharded on both
        sides as partial sums (an all-reduce) and one sharded on the input
        alone as an all-gather of the input. Default: none."""
        return []

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


# registry: OpType -> Op subclass
_OP_REGISTRY: Dict[OpType, Type[Op]] = {}


def register_op(cls: Type[Op]) -> Type[Op]:
    _OP_REGISTRY[cls.op_type] = cls
    return cls


def _aligned(shape: ParallelTensorShape, ref: Optional[ParallelTensorShape],
             from_right: bool) -> ParallelTensorShape:
    """``shape`` partitioned as ``ref`` on the dims that line up with one of
    ``ref``'s of the same size, unpartitioned elsewhere."""
    dims = []
    n, m = len(shape.dims), len(ref.dims) if ref is not None else 0
    for i, d in enumerate(shape.dims):
        j = i + m - n if from_right else i
        src = ref.dims[j] if ref is not None and 0 <= j < m else None
        if src is not None and src.size == d.size and src.is_partitioned:
            dims.append(ParallelDim(d.size, src.degree, src.axis))
        else:
            dims.append(ParallelDim(d.size))
    return ParallelTensorShape(tuple(dims), shape.dtype)


def create_op(layer: Layer, input_shapes: List[ParallelTensorShape]) -> Op:
    try:
        cls = _OP_REGISTRY[layer.op_type]
    except KeyError:
        raise NotImplementedError(
            f"no op registered for {layer.op_type} in the port") from None
    return cls(layer, input_shapes)

