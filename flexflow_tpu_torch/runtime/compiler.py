"""Compilation: lazy layer graph -> ops, params and the step functions.

PyTorch counterpart of ``flexflow_tpu/runtime/compiler.py``. The JAX
package traces one jitted program per step; PyTorch runs eagerly, so
:func:`compile_model` builds the ops, draws the params on the configured
device and returns plain functions over the op graph: ``forward_fn``
(under ``torch.inference_mode()``), and with an optimizer and a loss
``train_step``, ``eval_step`` and ``grad_step``, on the JAX package's
signatures without ``seq_length``. Gradients come from autograd through
the op graph (and through the kernels' ``torch.autograd.Function`` classes);
the auxiliary losses that ops append to ``LowerCtx.aux_losses`` (the MoE
balance term) join the training loss only, and the state the training
forward leaves in ``LowerCtx.state_updates`` (BatchNorm's running
statistics) is written into the params by ``train_step`` alone, after the
optimizer update. A training step's ``rng`` is an
int key (``FFModel`` passes a counter, as the JAX package folds one into
its root key); each op's random draws come from a generator seeded by the
config's seed, that key and the op's name. Gradient accumulation,
multi-step dispatch, ZeRO, regularizers and sharding arrive with later
slices.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..config import FFConfig
from ..core.layer import Layer
from ..core.op import LowerCtx, Op, create_op
from ..core.parallel_tensor import ParallelTensorShape
from ..core.tensor import Tensor
from ..ffconst import CompMode, DataType, LossType, MetricsType, OpType
from .loss import compute_loss
from .metrics import compute_batch_metrics
from .optimizer import Optimizer

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class CompiledModel:
    """Result of compile: the ops, the params and the step functions."""

    config: FFConfig
    device: torch.device
    ops: List[Op]
    input_tensors: List[Tensor]
    logits_tensor: Tensor
    params: Params
    # forward_fn(params, *xs, plain_kernels=False) -> f32 logits;
    # plain_kernels=True runs every kernel's plain version instead. Every
    # step function below takes the same keyword.
    forward_fn: Callable[..., torch.Tensor]
    label_tensor: Optional[Tensor] = None
    loss_type: Optional[LossType] = None
    metrics: List[MetricsType] = dataclasses.field(default_factory=list)
    optimizer: Optional[Optimizer] = None
    opt_state: Any = None
    # {op: {weight: bool}}: which weights get weight decay
    wd_mask: Dict[str, Dict[str, bool]] = dataclasses.field(default_factory=dict)
    # train_step(params, opt_state, rng, *xs, y) -> (params, opt_state,
    # loss, batch metrics), the params and state updated in place; ``rng``:
    # the step's int key for dropout (None: no draws, see LowerCtx)
    train_step: Optional[Callable[..., tuple]] = None
    # eval_step(params, *xs, y) -> (loss, logits, batch metrics)
    eval_step: Optional[Callable[..., tuple]] = None
    # grad_step(params, rng, *xs, y) -> grads, a tree like params
    grad_step: Optional[Callable[..., Params]] = None
    # the graph has no trailing softmax: CE losses take log-softmax
    from_logits: bool = True


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


def init_params(ops: List[Op], seed: int,
                device: torch.device) -> Tuple[Params, Dict[str, Dict[str, bool]]]:
    """Draw every weight on ``device`` from a ``torch.Generator`` seeded
    per (seed, op name, weight index). Returns (params, wd_mask), the mask
    from each ``WeightSpec.weight_decay``."""
    params: Params = {}
    wd_mask: Dict[str, Dict[str, bool]] = {}
    for op in ops:
        specs = op.weight_specs()
        if not specs:
            continue
        params[op.name] = {}
        wd_mask[op.name] = {}
        for wi, ws in enumerate(specs):
            gen = torch.Generator(device=device)
            gen.manual_seed(_weight_seed(seed, op.name, wi))
            params[op.name][ws.name] = ws.initializer(
                gen, ws.shape, ws.dtype.to_torch(), device)
            wd_mask[op.name][ws.name] = ws.weight_decay
    return params, wd_mask


# mixed precision: ops whose weights must stay full-precision in the
# forward pass (normalization statistics accumulate badly in bf16)
_FULL_PRECISION_PARAM_OPS = frozenset({OpType.BATCHNORM})


def causal_lm_signature(cm: CompiledModel) -> Dict[str, Optional[int]]:
    """The vocab and position contract of a compiled causal LM: the vocab
    size (the logits' trailing dim) and the position capacity (the position
    embedding's ``num_entries``, None without one). A speculative draft
    must share the target's vocab and cover its serving ``max_length``."""
    vocab = int(cm.logits_tensor.dims[-1])
    max_positions: Optional[int] = None
    if len(cm.input_tensors) >= 2:
        pos_tid = cm.input_tensors[1].tensor_id
        for op in cm.ops:
            if (op.op_type is OpType.EMBEDDING
                    and op.layer.inputs[0].tensor_id == pos_tid):
                max_positions = int(op.attrs["num_entries"])
    return {"vocab_size": vocab, "max_positions": max_positions}


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
                   plain_kernels: bool = False,
                   training: bool = False,
                   rng: Optional[int] = None,
                   seed: int = 0,
                   state_updates: Optional[dict] = None
                   ) -> Tuple[Dict[int, torch.Tensor], List[torch.Tensor]]:
    """Run the op graph; returns (every activation by tensor id, the
    auxiliary losses the ops appended). With a ``compute_dtype`` (bf16)
    activations and op weights are cast on entry to each op and outputs
    cast back, while ``params`` stay f32: autograd through the casts gives
    f32 gradients against the f32 master params. Integer inputs (token
    ids) are never cast. ``rng``/``seed``: the step's key and the config's
    seed, from which each op draws (``LowerCtx.generator``).
    ``state_updates``: a dict the training forward fills with the ops' new
    non-trainable state."""
    ctx = LowerCtx(plain_kernels=plain_kernels, training=training, aux_losses=[],
                   rng=rng, seed=seed, state_updates=state_updates)
    cast = make_caster(compute_dtype)
    acts = {k: cast(v) for k, v in inputs.items()}
    for op in ops:
        ins = [acts[t.tensor_id] for t in op.layer.inputs]
        p = cast_op_params(cast, op, params.get(op.name, {}), compute_dtype)
        for out, t in zip(op.forward(ctx, ins, p), op.layer.outputs):
            acts[t.tensor_id] = cast(out)
    return acts, ctx.aux_losses


# value-preserving tail ops walked through when deciding whether the graph
# ends in a softmax
_PASSTHROUGH = frozenset({OpType.IDENTITY, OpType.RESHAPE, OpType.TRANSPOSE,
                          OpType.DROPOUT})


def _ends_without_softmax(ops: List[Op], logits_id: int) -> bool:
    """CE losses: a graph without a trailing Softmax gives raw logits (a
    fused log-softmax in the loss); a softmax-terminated one gives
    probabilities, as in the reference's Loss::backward."""
    producer = {t.tensor_id: op for op in ops for t in op.layer.outputs}
    op = producer.get(logits_id)
    while op is not None and op.op_type in _PASSTHROUGH:
        op = producer.get(op.layer.inputs[0].tensor_id)
    return op is None or op.op_type is not OpType.SOFTMAX


def _label_tensor(loss_type: LossType, logits_tensor: Tensor) -> Tensor:
    """The label the loss takes: (batch, 1) int32 for sparse CE, else the
    logits' dims and dtype."""
    if loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        return Tensor((logits_tensor.dims[0], 1), DataType.INT32, name="label")
    return Tensor(tuple(logits_tensor.dims), logits_tensor.dtype, name="label")


def compile_model(
    config: FFConfig,
    layers: List[Layer],
    input_tensors: List[Tensor],
    logits_tensor: Tensor,
    optimizer: Optional[Optimizer] = None,
    loss_type: Optional[LossType] = None,
    metrics: Optional[List[MetricsType]] = None,
    comp_mode: CompMode = CompMode.TRAINING,
) -> CompiledModel:
    """The compile entry point. ``eval_step`` exists when a loss is given,
    ``train_step``/``grad_step`` when an optimizer and a loss are given and
    ``comp_mode`` is TRAINING (an inference model never gets them)."""
    if config.search_budget != 0:
        raise NotImplementedError(
            "the strategy search is not ported; search_budget must be 0")
    metrics = list(metrics or [])
    device = config.torch_device()
    input_pshapes = {t.tensor_id: ParallelTensorShape.unpartitioned(t.dims, t.dtype)
                     for t in input_tensors}
    ops, _ = build_ops(layers, input_pshapes)
    for op in ops:
        op.materialize(device)
    params, wd_mask = init_params(ops, config.seed, device)
    cdt = _resolve_compute_dtype(config.compute_dtype)
    n_inputs = len(input_tensors)
    input_ids = [t.tensor_id for t in input_tensors]
    logits_id = logits_tensor.tensor_id
    from_logits = _ends_without_softmax(ops, logits_id)

    def run(params: Params, xs, plain_kernels: bool, training: bool,
            rng: Optional[int] = None, state_updates: Optional[dict] = None
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(f32 logits, the auxiliary losses in f32): loss and metrics are
        f32 whatever the compute dtype."""
        acts, aux = _forward_graph(ops, params, dict(zip(input_ids, xs)), cdt,
                                   plain_kernels, training, rng, config.seed,
                                   state_updates)
        return acts[logits_id].float(), [a.float() for a in aux]

    def forward_fn(params: Params, *xs: torch.Tensor,
                   plain_kernels: bool = False) -> torch.Tensor:
        with torch.inference_mode():
            return run(params, xs, plain_kernels, training=False)[0]

    def value_and_grad(params: Params, batch, plain_kernels: bool, rng,
                       state_updates: Optional[dict] = None):
        """(loss, logits, grads) of one batch; the loss includes the
        auxiliary losses (the training loss only, as in the JAX package's
        train and grad steps), and the grads are f32 trees like
        ``params``. ``state_updates`` collects the forward's new state."""
        xs, y = batch[:n_inputs], batch[n_inputs]
        leaves = {op: {w: t.detach().requires_grad_(True) for w, t in ws.items()}
                  for op, ws in params.items()}
        flat = [t for ws in leaves.values() for t in ws.values()]
        with torch.enable_grad():
            logits, aux = run(leaves, xs, plain_kernels, training=True, rng=rng,
                              state_updates=state_updates)
            loss = compute_loss(loss_type, logits, y, from_logits)
            for a in aux:
                loss = loss + a
        gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        grads = {op: {w: _or_zeros(next(gs), t) for w, t in ws.items()}
                 for op, ws in leaves.items()}
        return loss.detach(), logits.detach(), grads

    def grad_step(params: Params, rng, *batch: torch.Tensor,
                  plain_kernels: bool = False) -> Params:
        return value_and_grad(params, batch, plain_kernels, rng)[2]

    def train_step(params: Params, opt_state, rng, *batch: torch.Tensor,
                   plain_kernels: bool = False):
        updates: dict = {}
        loss, logits, grads = value_and_grad(params, batch, plain_kernels, rng, updates)
        bm = compute_batch_metrics(metrics, loss_type, logits, batch[n_inputs],
                                   from_logits)
        params, opt_state = optimizer.update(params, grads, opt_state, wd_mask,
                                             optimizer.hyperparams())
        # non-trainable state (BatchNorm's running statistics), written after
        # the optimizer update in the master dtype, outside autograd
        with torch.no_grad():
            for (op_name, w_name), v in updates.items():
                params[op_name][w_name].copy_(v.detach())
        return params, opt_state, loss, bm

    def eval_step(params: Params, *batch: torch.Tensor,
                  plain_kernels: bool = False):
        y = batch[n_inputs]
        with torch.inference_mode():
            # the auxiliary losses are dropped: eval reports the model's loss
            logits = run(params, batch[:n_inputs], plain_kernels, training=False)[0]
            loss = compute_loss(loss_type, logits, y, from_logits)
            return loss, logits, compute_batch_metrics(metrics, loss_type, logits,
                                                       y, from_logits)

    training = (comp_mode is CompMode.TRAINING and optimizer is not None
                and loss_type is not None)
    return CompiledModel(
        config=config, device=device, ops=ops, input_tensors=list(input_tensors),
        logits_tensor=logits_tensor, params=params, forward_fn=forward_fn,
        label_tensor=_label_tensor(loss_type, logits_tensor) if loss_type else None,
        loss_type=loss_type, metrics=metrics, optimizer=optimizer,
        opt_state=optimizer.init_state(params) if training else None,
        wd_mask=wd_mask,
        train_step=train_step if training else None,
        eval_step=eval_step if loss_type is not None else None,
        grad_step=grad_step if training else None,
        from_logits=from_logits)


def _or_zeros(grad: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    # a weight the loss does not reach gets a zero gradient, as jax.grad gives
    return torch.zeros_like(like) if grad is None else grad
