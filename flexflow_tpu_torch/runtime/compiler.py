"""Compilation: lazy layer graph -> ops, params and an inference forward.

PyTorch counterpart of ``flexflow_tpu/runtime/compiler.py``, inference
only so far. The JAX package traces one jitted program per step; PyTorch
runs eagerly, so :func:`compile_model` builds the ops, draws the params on
the configured device and returns a forward that runs the op graph under
``torch.inference_mode()``. The training step arrives with the training
slice; sharding arrives with the parallelism slice.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import FFConfig
from ..core.layer import Layer
from ..core.op import LowerCtx, Op, create_op
from ..core.parallel_tensor import ParallelTensorShape
from ..core.tensor import Tensor
from ..ffconst import CompMode, OpType

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class CompiledModel:
    """Result of compile: everything needed to run inference."""

    config: FFConfig
    device: torch.device
    ops: List[Op]
    input_tensors: List[Tensor]
    logits_tensor: Tensor
    params: Params
    # forward_fn(params, *xs, plain_kernels=False) -> f32 logits;
    # plain_kernels=True runs every kernel's plain version instead
    forward_fn: Callable[..., torch.Tensor]


def toposort_layers(layers: List[Layer]) -> List[Layer]:
    """FFModel's layer order is already topological (each layer only consumes
    previously-created tensors); validate rather than re-sort."""
    produced = {t.tensor_id for l in layers for t in l.outputs}
    seen = set()
    for l in layers:
        for t in l.inputs:
            if t.tensor_id in produced and t.tensor_id not in seen:
                raise ValueError(
                    f"layer {l.name!r}: layer graph not topologically ordered "
                    f"(consumes tensor '{t.name}' produced by a later layer)")
        for t in l.outputs:
            seen.add(t.tensor_id)
    return layers


def build_ops(
    layers: List[Layer],
    input_pshapes: Dict[int, ParallelTensorShape],
) -> Tuple[List[Op], Dict[int, ParallelTensorShape]]:
    """Instantiate ops and propagate shapes through the graph."""
    pshapes: Dict[int, ParallelTensorShape] = dict(input_pshapes)
    ops: List[Op] = []
    for layer in toposort_layers(layers):
        in_shapes = [pshapes[t.tensor_id] for t in layer.inputs]
        op = create_op(layer, in_shapes)
        out_shapes, weight_shapes = op.propagate(in_shapes)
        op.output_shapes = out_shapes
        op.weight_shapes = weight_shapes
        for i, (t, ps) in enumerate(zip(layer.outputs, out_shapes)):
            if tuple(t.dims) != tuple(ps.sizes):
                raise ValueError(
                    f"layer {layer.name!r} output {i}: declared dims "
                    f"{tuple(t.dims)} vs propagated {tuple(ps.sizes)}")
            pshapes[t.tensor_id] = ps
        ops.append(op)
    return ops, pshapes


def _weight_seed(seed: int, op_name: str, index: int) -> int:
    # keyed on a stable hash of the op name, not its graph index, so the
    # same named layer always draws the same weights (as in the JAX package)
    return (seed * 1_000_003 + zlib.crc32(op_name.encode()) * 131 + index) % (1 << 63)


def init_params(ops: List[Op], seed: int, device: torch.device) -> Params:
    """Draw every weight on ``device`` from a ``torch.Generator`` seeded
    per (seed, op name, weight index)."""
    params: Params = {}
    for op in ops:
        specs = op.weight_specs()
        if not specs:
            continue
        params[op.name] = {}
        for wi, ws in enumerate(specs):
            gen = torch.Generator(device=device)
            gen.manual_seed(_weight_seed(seed, op.name, wi))
            params[op.name][ws.name] = ws.initializer(
                gen, ws.shape, ws.dtype.to_torch(), device)
    return params


# mixed precision: ops whose weights must stay full-precision in the
# forward pass (normalization statistics accumulate badly in bf16)
_FULL_PRECISION_PARAM_OPS = frozenset({OpType.BATCHNORM})


def _resolve_compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    if name in (None, "float32", "fp32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float16", "fp16", "f16"):
        raise ValueError(
            "compute_dtype float16 is unsupported (no loss scaling); "
            "use bfloat16")
    raise ValueError(f"unknown compute_dtype {name!r}")


def make_caster(compute_dtype: Optional[torch.dtype]):
    """Float tensors -> compute_dtype, everything else untouched; None ->
    identity."""
    if compute_dtype is None:
        return lambda x: x

    def cast(x: torch.Tensor) -> torch.Tensor:
        return x.to(compute_dtype) if x.is_floating_point() else x

    return cast


def cast_op_params(cast, op: Op, params: Dict[str, torch.Tensor],
                   compute_dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """Per-op weight cast under the full-precision exception list."""
    if compute_dtype is None or op.op_type in _FULL_PRECISION_PARAM_OPS:
        return params
    return {k: cast(v) for k, v in params.items()}


def _forward_graph(ops: List[Op], params: Params,
                   inputs: Dict[int, torch.Tensor],
                   compute_dtype: Optional[torch.dtype] = None,
                   plain_kernels: bool = False) -> Dict[int, torch.Tensor]:
    """Run the op graph; returns every activation by tensor id. With a
    ``compute_dtype`` (bf16) activations and op weights are cast on entry
    to each op and outputs cast back, while ``params`` stay f32."""
    ctx = LowerCtx(plain_kernels=plain_kernels)
    cast = make_caster(compute_dtype)
    acts = {k: cast(v) for k, v in inputs.items()}
    for op in ops:
        ins = [acts[t.tensor_id] for t in op.layer.inputs]
        p = cast_op_params(cast, op, params.get(op.name, {}), compute_dtype)
        for out, t in zip(op.forward(ctx, ins, p), op.layer.outputs):
            acts[t.tensor_id] = cast(out)
    return acts


def compile_model(
    config: FFConfig,
    layers: List[Layer],
    input_tensors: List[Tensor],
    logits_tensor: Tensor,
    comp_mode: CompMode = CompMode.INFERENCE,
) -> CompiledModel:
    """The compile entry point, for inference."""
    if comp_mode is not CompMode.INFERENCE:
        raise NotImplementedError(
            "the port compiles for inference only so far; use "
            "FFConfig(computation_mode=CompMode.INFERENCE)")
    if config.search_budget != 0:
        raise NotImplementedError(
            "the strategy search is not ported; search_budget must be 0")
    device = config.torch_device()
    input_pshapes = {t.tensor_id: ParallelTensorShape.unpartitioned(t.dims, t.dtype)
                     for t in input_tensors}
    ops, _ = build_ops(layers, input_pshapes)
    params = init_params(ops, config.seed, device)
    cdt = _resolve_compute_dtype(config.compute_dtype)
    input_ids = [t.tensor_id for t in input_tensors]
    logits_id = logits_tensor.tensor_id

    def forward_fn(params: Params, *xs: torch.Tensor,
                   plain_kernels: bool = False) -> torch.Tensor:
        with torch.inference_mode():
            acts = _forward_graph(ops, params, dict(zip(input_ids, xs)), cdt,
                                  plain_kernels)
            return acts[logits_id].float()

    return CompiledModel(config=config, device=device, ops=ops,
                         input_tensors=list(input_tensors),
                         logits_tensor=logits_tensor, params=params,
                         forward_fn=forward_fn)
