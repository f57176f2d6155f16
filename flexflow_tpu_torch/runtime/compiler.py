"""Compilation: lazy layer graph -> ops, params and the step functions.

PyTorch counterpart of ``flexflow_tpu/runtime/compiler.py``. The JAX
package traces one jitted program per step, donating the params and the
optimizer state; :func:`compile_model` builds the ops, draws the params
on the configured device and returns the step functions over the op
graph: ``forward_fn`` (under ``torch.inference_mode()``), and with an
optimizer and a loss ``train_step``, ``train_k_steps``, ``eval_step`` and
``grad_step``, on the JAX package's signatures; each takes ``seq_length``
(default -1) into ``LowerCtx.seq_length``. On one CUDA device each step
is captured into a CUDA graph once per key and replayed, updating the
params and the state in place (``runtime/graphs.py``); a mesh and the CPU
run the steps eagerly (``graphs.capture_rule``, recorded on
``CompiledModel.capture``). ``CompiledModel.eager`` keeps the eager
functions, which the program audit records. Gradients come from autograd through the op graph
(and through the kernels' ``torch.autograd.Function`` classes); the
auxiliary losses that ops append to ``LowerCtx.aux_losses`` (the MoE
balance term) and the ``kernel_regularizer`` penalties on the f32 master
kernels join ``train_step``'s loss only (``grad_step`` adds the auxiliary
losses and no penalty, ``eval_step`` neither), and the state the training
forward leaves in ``LowerCtx.state_updates`` (BatchNorm's running
statistics) is written into the params by ``train_step`` alone, after the
optimizer update. A training step's ``rng`` is an int key (``FFModel``
passes a counter, as the JAX package folds one into its root key); each
op's random draws come from a generator seeded by the config's seed, that
key and the op's name.

``config.grad_accum_steps`` K > 1 splits each training batch into K
microbatches, sums their gradients, metrics and BatchNorm state, divides
the gradients and the state by K and updates once. Microbatch ``i`` of a
step whose key is ``r`` draws with key ``r * K + i`` (distinct across
steps and microbatches; K = 1 keeps ``r``), where the JAX package splits
its key; dropout masks therefore differ between the packages under
accumulation, and parity holds at rate 0. Under ``config.seq_buckets`` the
sparse-CE loss and metrics mask ``-1`` positions (``mask_padding``).

Over a mesh (``config.mesh_shape`` or ``mesh=``, one process per rank)
the JAX package's GSPMD program becomes explicit SPMD: inputs are sharded
on the batch over ``data``, :func:`build_ops` propagates the layouts
under each layer's strategy, every rank draws each weight whole from the
seed and keeps its block, and the forward hands each op its inputs in the
layout its ``propagate`` asked for (``ops/parallel_ops.reshard``). Each
rank's loss is its share of the global mean (its local sum over the
global count), so the step's loss is the sum over the ranks the logits'
rows are sharded over. Logits whose class dim is sharded take the loss
and the metrics class-parallel (``runtime/loss.py`` ``ClassShard``): the
ranks of the class axis hold the whole rows' loss. A weight's gradient is
all-reduced over the axes its op's output is sharded on and the weight
is not (``data``, ``seq``). The metrics' sums are all-reduced the same
way. An expert weight sharded over the axis that also shards the batch
is all-reduced over neither: each rank owns its experts, whose gradients
the all-to-all's backward brings in from every rank's tokens.

``train_step`` and ``grad_step`` all-reduce the gradients while the
backward runs, as XLA's latency-hiding scheduler overlaps the psum
inside the JAX package's jitted step: ``parallel/grad_buckets.py`` cuts
the weights of each set of axes, in reverse op order, into buckets of
``GRAD_BUCKET_BYTES``; a hook on each gradient leaf stages its gradient,
and a bucket is issued (``collectives.all_reduce_coalesced_async``) once
all its gradients exist and every bucket before it has been issued, so
every rank issues the same sequence on each group, interleaved with the
backward's own collectives in the autograd engine's order. A weight the
loss does not reach joins its bucket as zeros once ``autograd.grad``
returns. The step waits on the buckets just before the optimizer update;
``CompiledModel.last_sync`` records the last wait. Under accumulation
only the last microbatch's backward issues buckets, each gradient
joining the earlier microbatches' sum and divided by K first, so the sum
keeps its order. With two ranks each sum has two addends, so the results
equal an all-reduce after the backward bit for bit. The pipeline engines
sync after their schedule through ``CompiledModel.sync_grads``, one flat
buffer a set of axes.

``config.zero_optimizer`` over a data axis above 1 is ZeRO-1, as the JAX
package lays it out: each optimizer-state array is sharded over ``data``
on its weight's first dim that is unsharded and divisible by the data
degree (a weight already sharded over ``data`` keeps its own layout, as
do weights with no such dim). Each rank updates its slice of such a
parameter with its slice of the state, from the whole all-reduced
gradient, then the slices are all-gathered, one buffer for all of them.
The pipeline engines (``parallel/pipeline.py``) run the ops of
:func:`compile_model` chunk by chunk through :func:`_forward_graph`.

``CompiledModel.audit_exec`` lists the step programs the program audit
(``analysis/program_audit.py``) records one real call of, as the JAX
package lists its jitted executables: ``train_step`` (and
``train_k_steps`` when ``config.steps_per_dispatch`` > 1) on clones of
the params and the optimizer state, ``eval_step`` (the forward pass for
an inference-only compile), each on the zero batch at the compiled
shapes (this rank's rows under a mesh).
"""

from __future__ import annotations

import dataclasses
import functools
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..config import FFConfig
from ..core.layer import Layer
from ..core.machine import DATA_AXIS, Mesh, make_mesh
from ..core.op import LowerCtx, Op, create_op
from ..core.parallel_tensor import ParallelDim, ParallelTensorShape
from ..core.tensor import Tensor
from ..ffconst import CompMode, DataType, LossType, MetricsType, OpType
from ..ops.parallel_ops import reshard
from ..parallel import collectives as C
from ..parallel.grad_buckets import plan_grad_buckets, sync_axes
from .loss import ClassShard, compute_loss
from .metrics import compute_batch_metrics
from .graphs import StepGraphs, capture_rule, graph_key, tensor_leaves
from .optimizer import Optimizer

Params = Dict[str, Dict[str, torch.Tensor]]


class _GradSync:
    """One backward's gradient all-reduce, bucket by bucket (module
    docstring). ``buckets``: ``plan_grad_buckets``' list, keys (axes,
    dtype); ``acc``: the earlier microbatches' gradient sum, which each
    gradient joins before it is divided by ``k`` and staged."""

    def __init__(self, buckets: List[tuple], mesh: Mesh, leaves: Params,
                 acc: Optional[Params], k: int):
        self.buckets, self.mesh, self.acc, self.k = buckets, mesh, acc, k
        self.got: List[Dict[Tuple[str, str], torch.Tensor]] = [{} for _ in buckets]
        self.pending: List[Any] = []
        self.before: List[bool] = []  # issued before autograd.grad returned
        self.t_return: Optional[float] = None
        for b, (_, names, _) in enumerate(buckets):
            for name in names:
                leaves[name[0]][name[1]].register_hook(functools.partial(self._ready, b, name))

    def _final(self, name: Tuple[str, str], g: torch.Tensor) -> torch.Tensor:
        return g if self.acc is None else (self.acc[name[0]][name[1]] + g) / self.k

    def _ready(self, b: int, name: Tuple[str, str], g: torch.Tensor) -> None:
        self.got[b][name] = self._final(name, g)
        # in bucket order: a ready bucket waits for the ones before it
        while (len(self.pending) < len(self.buckets)
               and len(self.got[len(self.pending)]) == len(self.buckets[len(self.pending)][1])):
            i = len(self.pending)
            (axes, _), names, _ = self.buckets[i]
            self.pending.append(C.all_reduce_coalesced_async(
                [self.got[i][n] for n in names], self.mesh.group(axes),
                f"gradient bucket {i} of {len(self.buckets)}"))
            self.before.append(self.t_return is None)

    def returned(self, grads: Params) -> None:
        """``autograd.grad`` has returned ``grads`` (zeros where the loss
        does not reach): the weights whose hook never ran join their
        buckets, and every bucket left is issued."""
        self.t_return = time.perf_counter()
        for b, (_, names, _) in enumerate(self.buckets):
            for name in names:
                if name not in self.got[b]:
                    self._ready(b, name, grads[name[0]][name[1]])

    def wait(self, grads: Params, record: Dict[str, Any]) -> Params:
        """``grads`` with every bucket's sums in place, the others joined to
        ``acc`` as the buckets' were; ``record`` becomes this sync's."""
        synced = {name for _, names, _ in self.buckets for name in names}
        out = {op: {w: g if (op, w) in synced else self._final((op, w), g)
                    for w, g in ws.items()} for op, ws in grads.items()}
        for (_, names, _), p in zip(self.buckets, self.pending):
            for (o, w), s in zip(names, p.wait()):
                out[o][w] = s
        record.clear()
        record.update(
            buckets=[dict(axes=list(axes), bytes=nbytes, index=i, before_return=before)
                     for i, (((axes, _), _, nbytes), before)
                     in enumerate(zip(self.buckets, self.before))],
            exposed_ms=(time.perf_counter() - self.t_return) * 1e3)
        return out


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
    # train_k_steps(params, opt_state, rngs, *stacked, fold_from=None) ->
    # (params, opt_state, (k,) losses, metrics folded in step order onto
    # ``fold_from``): k train_steps over (k, batch, ...) super-batches in
    # one host call, equal to k serial train_steps bit for bit
    train_k_steps: Optional[Callable[..., tuple]] = None
    # global step counter, monotonic across fits and recompiles
    iteration: int = 0
    # bumped whenever the params are replaced or restored (guard rollback,
    # checkpoint restore); derived caches (the serving bf16 cast) key on it
    params_version: int = 0
    # every (kind, rows, seq_length) bucketed fit/eval has dispatched
    _seen_shapes: set = dataclasses.field(default_factory=set)
    # the rank grid (None on one device) and every tensor's layout over it
    # by tensor id; under a mesh ``params`` hold this rank's blocks, the
    # step functions take the rank's rows of a batch (``batch_rows``) and
    # return the global loss and metrics, and ``forward_fn``/``eval_step``
    # the whole logits
    mesh: Optional[Mesh] = None
    layouts: Dict[int, ParallelTensorShape] = dataclasses.field(default_factory=dict)
    # update_fn(params, grads, opt_state) -> (params, opt_state): the
    # optimizer step train_step takes (ZeRO-1's sliced update under
    # ``config.zero_optimizer``), for the manual ``update`` verb
    update_fn: Optional[Callable[..., tuple]] = None
    # ZeRO-1: {(op, weight): the dim its optimizer state is sharded on}
    zero_dims: Dict[Tuple[str, str], int] = dataclasses.field(default_factory=dict)
    # the mesh's share of a loss, for the pipeline engines:
    # loss_share(loss of this rank's block, labels) -> the rank's share of
    # the global mean; sync_grads(grads) -> all-reduced over the mesh;
    # label_block(y) -> the labels of this rank's logits block
    loss_share: Optional[Callable] = None
    sync_grads: Optional[Callable] = None
    label_block: Optional[Callable] = None
    # the last mesh step's gradient sync (module docstring): ``buckets``,
    # each {axes, bytes, index (the issue order), before_return (issued
    # before autograd.grad returned)}, and ``exposed_ms``, host ms from
    # the backward's return to the last bucket's completion; empty until
    # a mesh step has synced
    last_sync: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the program audit's specs (analysis/program_audit.ExecutableSpec)
    audit_exec: List[Any] = dataclasses.field(default_factory=list)
    # the eager step functions by name (forward_fn, eval_step, train_step,
    # train_k_steps, grad_step): the program audit records them and a
    # caller may hold the captured steps against them; fit and serving
    # call the attributes above
    eager: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    # the capture cache (runtime/graphs.StepGraphs) when the steps are
    # captured, and capture_rule's answer: {"captured": bool, "reason": str}
    graphs: Any = None
    capture: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def batch_rows(self, i: int) -> slice:
        """This rank's rows of a global batch of input ``i`` (the label
        when ``i`` is the input count): all of them unless its dim 0 is
        sharded."""
        if self.mesh is None:
            return slice(None)
        if i == len(self.input_tensors):
            layout = self.layouts[self.logits_tensor.tensor_id]
        else:
            layout = self.layouts[self.input_tensors[i].tensor_id]
        return self.mesh.local_slices(layout)[0]

    def weight_layout(self, op_name: str, w_name: str) -> ParallelTensorShape:
        return next(op.weight_shapes[w_name] for op in self.ops if op.name == op_name)

    def note_dispatch_shape(self, kind: str, rows: int, seq_length: int) -> bool:
        """Record a (kind, rows, seq_length) dispatch shape; True the first
        time it is seen (fit counts it on ``fit.bucket_compiles``)."""
        key = (kind, int(rows), int(seq_length))
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        return True

    def bump_params_version(self) -> None:
        """Call after replacing or restoring ``params``."""
        self.params_version += 1

    def resume_state(self) -> Dict[str, int]:
        """The JSON-scalar resume view (the checkpoint sidecar)."""
        return {"iteration": int(self.iteration)}

    def load_resume_state(self, state: Optional[Dict[str, int]]) -> None:
        self.iteration = int((state or {}).get("iteration", 0))


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


def _provenance(layer: Layer) -> str:
    return f"layer {layer.name!r} ({layer.op_type.name})"


def build_ops(
    layers: List[Layer],
    input_pshapes: Dict[int, ParallelTensorShape],
    axis_sizes: Optional[Dict[str, int]] = None,
    strategies: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Tuple[List[Op], Dict[int, ParallelTensorShape]]:
    """Instantiate ops and propagate layouts through the graph under each
    layer's strategy (``strategies[layer name]``) over a mesh of
    ``axis_sizes``; every failure names the layer."""
    axis_sizes = dict(axis_sizes or {})
    strategies = strategies or {}
    pshapes: Dict[int, ParallelTensorShape] = dict(input_pshapes)
    ops: List[Op] = []
    for layer in toposort_layers(layers):
        in_shapes = [pshapes[t.tensor_id] for t in layer.inputs]
        op = create_op(layer, in_shapes)
        strategy = dict(strategies.get(layer.name, {}))
        strategy["_axis_sizes"] = axis_sizes
        # the mesh the op runs on, which the simulator prices the gradient
        # sync of weights over (sim/cost_model.py _axis_sizes_from)
        op.axis_sizes = dict(axis_sizes)
        try:
            out_shapes, weight_shapes = op.propagate(in_shapes, strategy)
        except (ValueError, KeyError, IndexError) as e:
            raise ValueError(
                f"{_provenance(layer)}: sharding propagation rejected strategy "
                f"{strategies.get(layer.name)} on inputs {[str(s) for s in in_shapes]}: "
                f"{e}") from e
        for ps in list(out_shapes) + list(weight_shapes.values()) + list(op.input_layouts):
            if ps.has_duplicate_axes():
                raise ValueError(
                    f"{_provenance(layer)}: strategy {strategies.get(layer.name)} maps one "
                    f"mesh axis onto two dims of a tensor ({ps.partition_spec()}); pick "
                    f"a different axis for this op")
        op.output_shapes = out_shapes
        op.weight_shapes = weight_shapes
        for i, (t, ps) in enumerate(zip(layer.outputs, out_shapes)):
            if tuple(t.dims) != tuple(ps.sizes):
                raise ValueError(
                    f"{_provenance(layer)} output {i}: declared dims "
                    f"{tuple(t.dims)} vs propagated {tuple(ps.sizes)}")
            pshapes[t.tensor_id] = ps
        ops.append(op)
    return ops, pshapes


def _weight_seed(seed: int, op_name: str, index: int) -> int:
    # keyed on a stable hash of the op name, not its graph index, so the
    # same named layer always draws the same weights (as in the JAX package)
    return (seed * 1_000_003 + zlib.crc32(op_name.encode()) * 131 + index) % (1 << 63)


def init_params(ops: List[Op], seed: int, device: torch.device,
                mesh: Optional[Mesh] = None) -> Tuple[Params, Dict[str, Dict[str, bool]]]:
    """Draw every weight on ``device`` from a ``torch.Generator`` seeded
    per (seed, op name, weight index). Returns (params, wd_mask), the mask
    from each ``WeightSpec.weight_decay``. Under a mesh each weight is
    drawn whole and the rank keeps its block, so a sharded model starts
    from the one-rank model's values."""
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
            w = ws.initializer(gen, ws.shape, ws.dtype.to_torch(), device)
            if mesh is not None:
                w = w[mesh.local_slices(op.weight_shapes[ws.name])].contiguous()
            params[op.name][ws.name] = w
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


def _forward_graph(ops: List[Op], layouts: Dict[int, ParallelTensorShape],
                   mesh: Optional[Mesh], params: Params,
                   inputs: Dict[int, torch.Tensor],
                   compute_dtype: Optional[torch.dtype] = None,
                   plain_kernels: bool = False,
                   training: bool = False,
                   rng: Optional[int] = None,
                   seed: int = 0,
                   state_updates: Optional[dict] = None,
                   seq_length: int = -1,
                   check_shapes: bool = True,
                   ) -> Tuple[Dict[int, torch.Tensor], List[torch.Tensor]]:
    """Run the op graph on this rank's blocks; returns (every activation by
    tensor id, in its producer's layout, the auxiliary losses the ops
    appended). Under a ``mesh`` each op gets its inputs in the layouts its
    ``propagate`` asked for, resharded from the producer's once a forward
    (cached by tensor and layout), and each output's block is checked
    against its layout; without one every layout is whole. With a
    ``compute_dtype`` (bf16) activations and op weights are cast on entry
    to each op and outputs cast back, while ``params`` stay f32: autograd
    through the casts gives f32 gradients against the f32 master params.
    Integer inputs (token ids) are never cast. ``rng``/``seed``: the step's
    key and the config's seed, from which each op draws
    (``LowerCtx.generator``). ``state_updates``: a dict the training
    forward fills with the ops' new non-trainable state. ``seq_length``:
    ``LowerCtx.seq_length``. ``check_shapes=False`` leaves the blocks'
    shapes unchecked, for a pipeline's microbatches of the compiled batch;
    ``inputs`` then hold every tensor the ``ops`` read from outside."""
    ctx = LowerCtx(mesh=mesh, plain_kernels=plain_kernels, training=training,
                   aux_losses=[], rng=rng, seed=seed, state_updates=state_updates,
                   seq_length=seq_length)
    cast = make_caster(compute_dtype)
    acts = {k: cast(v) for k, v in inputs.items()}
    moved: Dict[Tuple[int, tuple], torch.Tensor] = {}

    def fetch(tid: int, want: ParallelTensorShape) -> torch.Tensor:
        src = layouts[tid]
        if mesh is None or want.layout() == src.layout():
            return acts[tid]
        key = (tid, want.layout())
        if key not in moved:
            moved[key] = reshard(acts[tid], src, want, mesh)
        return moved[key]

    for op in ops:
        ins = [fetch(t.tensor_id, want) for t, want in zip(op.layer.inputs, op.input_layouts)]
        p = cast_op_params(cast, op, params.get(op.name, {}), compute_dtype)
        for out, t, ps in zip(op.forward(ctx, ins, p), op.layer.outputs, op.output_shapes):
            if check_shapes and mesh is not None and tuple(out.shape) != ps.local_sizes():
                raise RuntimeError(
                    f"{_provenance(op.layer)}: this rank's output block is "
                    f"{tuple(out.shape)}, its layout {ps} gives {ps.local_sizes()}")
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
    strategies: Optional[Dict[str, Dict[str, Any]]] = None,
    mesh: Optional[Mesh] = None,
) -> CompiledModel:
    """The compile entry point. ``eval_step`` exists when a loss is given,
    ``train_step``/``grad_step`` when an optimizer and a loss are given and
    ``comp_mode`` is TRAINING (an inference model never gets them).
    ``strategies`` maps a layer name to its strategy; ``mesh`` defaults to
    ``make_mesh(config.mesh_shape)`` (None on one rank)."""
    metrics = list(metrics or [])
    device = config.torch_device()
    if mesh is None:
        mesh = make_mesh(config.mesh_shape)
    axis_sizes = dict(mesh.shape) if mesh is not None else {}
    data_degree = axis_sizes.get(DATA_AXIS, 1)
    input_pshapes = {}
    for t in input_tensors:
        dims = [ParallelDim(s) for s in t.dims]
        if (dims and data_degree > 1 and t.dims[0] % data_degree == 0
                and config.enable_sample_parallel):
            dims[0] = ParallelDim(t.dims[0], data_degree, DATA_AXIS)
        input_pshapes[t.tensor_id] = ParallelTensorShape(tuple(dims), t.dtype)
    ops, layouts = build_ops(layers, input_pshapes, axis_sizes, strategies)
    for op in ops:
        op.materialize(device)
    params, wd_mask = init_params(ops, config.seed, device, mesh)
    cdt = _resolve_compute_dtype(config.compute_dtype)
    n_inputs = len(input_tensors)
    input_ids = [t.tensor_id for t in input_tensors]
    logits_id = logits_tensor.tensor_id
    from_logits = _ends_without_softmax(ops, logits_id)

    # bucketed sequences pad rows with -1 labels, masked out of the loss
    # and the metrics; off, the unmasked path is untouched
    mask_pad = config.seq_buckets != "off"
    accum = max(1, int(config.grad_accum_steps))
    regularized = [(op.name, op.attrs["kernel_regularizer"]) for op in ops
                   if op.attrs.get("kernel_regularizer") is not None
                   and hasattr(op.attrs["kernel_regularizer"], "penalty")]

    # ---- the mesh's share of the step: each rank's loss is its local sum
    # over the global count; gradients and metric sums are all-reduced
    logits_layout = layouts[logits_id]
    weight_layouts = {op.name: op.weight_shapes for op in ops}
    loss_group = reduce_plan = shard = None
    if mesh is not None:
        # rows cut over a mesh axis hold other samples: their losses and
        # metric sums add over loss_group. A cut class dim holds one row's
        # classes: its ranks reduce every class sum (shard) and hold the
        # same loss.
        row_axes = logits_layout.partition_axes
        cls = logits_layout.dims[-1]
        if cls.is_partitioned:
            shard = ClassShard(mesh.group([cls.axis]),
                               mesh.coords[cls.axis] * (cls.size // cls.degree), cls.size)
            row_axes = tuple(a for a in row_axes if a != cls.axis)
        if row_axes:
            loss_group = mesh.group(row_axes)
        reduce_plan = {}
        for op in ops:
            for w_name, axes in sync_axes(op).items():
                reduce_plan.setdefault(axes, []).append((op.name, w_name))
    grad_buckets = plan_grad_buckets(ops) if reduce_plan else []
    last_sync: Dict[str, Any] = {}

    def sync_grads(grads: Params) -> Params:
        """All-reduce each weight's gradient over its plan's axes, one flat
        buffer a set of axes (DP's bucket); the weights ``grads`` holds (a
        pipeline stage's)."""
        for axes, names in (reduce_plan or {}).items():
            names = [(o, w) for o, w in names if o in grads]
            if not names:
                continue
            summed = C.all_reduce_coalesced([grads[o][w] for o, w in names],
                                            mesh.group(axes))
            for (o, w), g in zip(names, summed):
                grads[o][w] = g
        return grads

    def sync_metrics(bm: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if loss_group is None or not bm:
            return bm
        keys = sorted(bm)
        summed = C.all_reduce_sum(torch.stack([bm[k].double() for k in keys]), loss_group)
        return {k: summed[i].to(bm[k].dtype) for i, k in enumerate(keys)}

    # ---- ZeRO-1: the dim each weight's optimizer state is sharded on
    zero_dims: Dict[Tuple[str, str], int] = {}
    if config.zero_optimizer and data_degree > 1:
        for op in ops:
            for w_name, ws in op.weight_shapes.items():
                if DATA_AXIS in ws.partition_axes:
                    continue
                d = next((d for d, dim in enumerate(ws.dims) if not dim.is_partitioned
                          and dim.size % data_degree == 0 and dim.size >= data_degree), None)
                if d is not None:
                    zero_dims[(op.name, w_name)] = d

    def zero_slices(tree: Params) -> Params:
        """This rank's slice of each ZeRO-sharded tensor of ``tree`` (a
        view: in-place updates land in the tensor), the rest whole."""
        out: Params = {}
        for op_name, ws in tree.items():
            out[op_name] = {}
            for w_name, t in ws.items():
                d = zero_dims.get((op_name, w_name))
                if d is not None:
                    step = t.shape[d] // data_degree
                    t = t.narrow(d, mesh.coords[DATA_AXIS] * step, step)
                out[op_name][w_name] = t
        return out

    def apply_update(params: Params, grads: Params, opt_state, hyper=None):
        """The optimizer step; under ZeRO-1 on this rank's slices, then the
        updated slices all-gathered into the params. ``hyper``: the
        optimizer's device hyperparameters as filled for this step (None:
        fill them now from its attributes)."""
        if hyper is None:
            hyper = optimizer.load_hyper(device)
        if not zero_dims:
            return optimizer.update(params, grads, opt_state, wd_mask, hyper)
        views = zero_slices(params)
        _, opt_state = optimizer.update(views, zero_slices(grads), opt_state, wd_mask, hyper)
        names = list(zero_dims)
        with torch.no_grad():
            whole = C.all_gather_coalesced([views[o][w] for o, w in names],
                                           mesh.group([DATA_AXIS]),
                                           [zero_dims[k] for k in names])
            for (o, w), t in zip(names, whole):
                params[o][w].copy_(t)
        return params, opt_state

    def label_block(y: torch.Tensor) -> torch.Tensor:
        """The labels of this rank's logits block: its rows arrive from the
        loader; the other dims are cut as the logits' are."""
        if mesh is None:
            return y
        for d in range(1, min(y.dim(), len(logits_layout.dims))):
            ld = logits_layout.dims[d]
            if ld.is_partitioned and y.shape[d] == ld.size:
                y = C.scatter_to(y, mesh.group([ld.axis]), d)
        return y

    def loss_share(loss: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global mean: its local mean times its
        share of the global count."""
        if loss_group is None:
            return loss
        if (mask_pad and loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY
                and len(logits_layout.dims) >= 3):
            n = (y >= 0).sum().double()
            total = C.all_reduce_sum(n, loss_group)
            return loss * (n / total.clamp(min=1)).to(loss.dtype)
        return loss / loss_group.size

    def global_loss(share: torch.Tensor) -> torch.Tensor:
        return share if loss_group is None else C.all_reduce_sum(share, loss_group)

    def run(params: Params, xs, plain_kernels: bool, training: bool,
            rng: Optional[int] = None, state_updates: Optional[dict] = None,
            seq_length: int = -1, micro: bool = False
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(f32 logits, the auxiliary losses in f32): loss and metrics are
        f32 whatever the compute dtype. Under a mesh, this rank's block of
        the logits. ``micro``: the batch is one of K microbatches."""
        # packed (bucketed) batches come in many row counts and widths, and
        # microbatches in 1/K of the rows: their blocks are not the
        # compiled layout's
        acts, aux = _forward_graph(ops, layouts, mesh, params, dict(zip(input_ids, xs)), cdt,
                                   plain_kernels, training, rng, config.seed,
                                   state_updates, seq_length,
                                   check_shapes=not (mask_pad or micro))
        return acts[logits_id].float(), [a.float() for a in aux]

    def whole(logits: torch.Tensor) -> torch.Tensor:
        if mesh is None:
            return logits
        return reshard(logits, logits_layout,
                       ParallelTensorShape.unpartitioned(logits_layout.sizes), mesh)

    def forward_fn(params: Params, *xs: torch.Tensor, plain_kernels: bool = False,
                   seq_length: int = -1) -> torch.Tensor:
        with torch.inference_mode():
            return whole(run(params, xs, plain_kernels, training=False,
                             seq_length=seq_length)[0])

    def value_and_grad(params: Params, batch, plain_kernels: bool, rng,
                       state_updates: Optional[dict] = None, seq_length: int = -1,
                       regularize: bool = False, sync: bool = False,
                       acc: Optional[Params] = None, micro: bool = False):
        """(loss, logits, grads, sync) of one batch; the loss includes the
        auxiliary losses (the training loss only, as in the JAX package's
        train and grad steps) and, with ``regularize`` (train_step), each
        ``kernel_regularizer``'s penalty on the f32 master kernel; the
        grads are this rank's, f32 trees like ``params``. ``state_updates``
        collects the forward's new state. With ``sync`` over a mesh whose
        weights need a gradient all-reduce, the buckets are issued while
        the backward runs and ``sync`` is their :class:`_GradSync`
        (``wait`` gives the synced tree; ``acc``: the earlier microbatches'
        gradient sum, each gradient joining it before it is divided by K),
        else None. ``micro``: the batch is one of K microbatches."""
        xs, y = batch[:n_inputs], label_block(batch[n_inputs])
        leaves = {op: {w: t.detach().requires_grad_(True) for w, t in ws.items()}
                  for op, ws in params.items()}
        flat = [t for ws in leaves.values() for t in ws.values()]
        gsync = (_GradSync(grad_buckets, mesh, leaves, acc, accum)
                 if sync and grad_buckets else None)
        with torch.enable_grad():
            logits, aux = run(leaves, xs, plain_kernels, training=True, rng=rng,
                              state_updates=state_updates, seq_length=seq_length,
                              micro=micro)
            loss = loss_share(compute_loss(loss_type, logits, y, from_logits, mask_pad, shard), y)
            for a in aux:
                loss = loss + a
            if regularize:
                for op_name, reg in regularized:
                    if "kernel" in leaves.get(op_name, {}):
                        loss = loss + penalty_share(op_name, reg, leaves[op_name]["kernel"])
        gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        grads = {op: {w: _or_zeros(next(gs), t) for w, t in ws.items()}
                 for op, ws in leaves.items()}
        if gsync is not None:
            gsync.returned(grads)
        return loss.detach(), logits.detach(), grads, gsync

    def penalty_share(op_name: str, reg, kernel: torch.Tensor) -> torch.Tensor:
        """A regularizer's penalty: on a sharded kernel the blocks' partial
        penalties are summed; each loss rank adds its share."""
        pen = reg.penalty(kernel)
        if mesh is None:
            return pen
        axes = weight_layouts[op_name]["kernel"].partition_axes
        if axes:
            pen = C.reduce_from(pen, mesh.group(axes))
        return pen / (loss_group.size if loss_group is not None else 1)

    def grad_step(params: Params, rng, *batch: torch.Tensor,
                  plain_kernels: bool = False, seq_length: int = -1) -> Params:
        _, _, grads, gsync = value_and_grad(params, batch, plain_kernels, rng,
                                            seq_length=seq_length, sync=True)
        return grads if gsync is None else gsync.wait(grads, last_sync)

    def accumulated(params: Params, batch, plain_kernels: bool, rng, seq_length: int):
        """(loss, grads, batch metrics, state updates, sync) of one batch as
        K microbatches: sums in microbatch order, the gradients, the loss
        and the state divided by K. Over a mesh the last microbatch's
        backward issues the buckets (``sync``, its :class:`_GradSync`; the
        grads are then its own, to be joined in ``sync.wait``)."""
        n = batch[n_inputs].shape[0]
        if n % accum:
            raise ValueError(f"batch {n} not divisible by grad_accum_steps {accum}")
        micro = list(zip(*(b.chunk(accum) for b in batch)))
        loss_sum = grads = bm = upd_sum = gsync = None
        for i, mb in enumerate(micro):
            upd: dict = {}
            last = i == accum - 1
            li, lgi, gi, gsync = value_and_grad(params, mb, plain_kernels,
                                                None if rng is None else rng * accum + i,
                                                upd, seq_length, regularize=True,
                                                sync=last, acc=grads if last else None,
                                                micro=True)
            bmi = compute_batch_metrics(metrics, loss_type, lgi, label_block(mb[n_inputs]),
                                        from_logits, mask_pad, shard)
            if grads is None:
                loss_sum, grads, bm, upd_sum = li, gi, bmi, upd
                continue
            loss_sum = loss_sum + li
            bm = {k: bm[k] + v for k, v in bmi.items()}
            upd_sum = {k: upd_sum[k] + v for k, v in upd.items()}
            if gsync is not None:
                grads = gi
                continue
            grads = {op: {w: g + gi[op][w] for w, g in ws.items()}
                     for op, ws in grads.items()}
        if gsync is None:
            grads = {op: {w: g / accum for w, g in ws.items()} for op, ws in grads.items()}
        return (loss_sum / accum, grads, bm,
                {k: v / accum for k, v in upd_sum.items()}, gsync)

    def train_step(params: Params, opt_state, rng, *batch: torch.Tensor,
                   plain_kernels: bool = False, seq_length: int = -1, hyper=None):
        if accum == 1:
            updates: dict = {}
            loss, logits, grads, gsync = value_and_grad(params, batch, plain_kernels, rng,
                                                        updates, seq_length, regularize=True,
                                                        sync=True)
            bm = compute_batch_metrics(metrics, loss_type, logits, label_block(batch[n_inputs]),
                                       from_logits, mask_pad, shard)
        else:
            loss, grads, bm, updates, gsync = accumulated(params, batch, plain_kernels, rng,
                                                          seq_length)
        if mesh is not None:
            bm, loss = sync_metrics(bm), global_loss(loss)
        if gsync is not None:
            grads = gsync.wait(grads, last_sync)
        params, opt_state = apply_update(params, grads, opt_state, hyper)
        # non-trainable state (BatchNorm's running statistics), written after
        # the optimizer update in the master dtype, outside autograd
        with torch.no_grad():
            for (op_name, w_name), v in updates.items():
                params[op_name][w_name].copy_(v.detach())
        return params, opt_state, loss, bm

    def k_steps(step: Callable[..., tuple]):
        def train_k_steps(params: Params, opt_state, rngs, *stacked: torch.Tensor,
                          plain_kernels: bool = False, seq_length: int = -1,
                          fold_from: Optional[dict] = None):
            """``len(rngs)`` train_steps over the super-batches' leading dim
            in one host call: a plain loop (k replays when captured), so it
            equals as many serial train_steps bit for bit. The metrics fold
            on the device in step order onto ``fold_from`` (fit passes its
            epoch's running sums, so the epoch totals equal the serial
            loop's too); the losses come back stacked (k,)."""
            losses, folded = [], fold_from
            for i, r in enumerate(rngs):
                params, opt_state, loss, bm = step(
                    params, opt_state, r, *(s[i] for s in stacked),
                    plain_kernels=plain_kernels, seq_length=seq_length)
                losses.append(loss)
                folded = dict(bm) if folded is None else {
                    **folded, **{k: folded[k] + v if k in folded else v for k, v in bm.items()}}
            return params, opt_state, torch.stack(losses), folded
        return train_k_steps

    def eval_step(params: Params, *batch: torch.Tensor,
                  plain_kernels: bool = False, seq_length: int = -1):
        y = label_block(batch[n_inputs])
        with torch.inference_mode():
            # the auxiliary losses are dropped: eval reports the model's loss
            logits = run(params, batch[:n_inputs], plain_kernels, training=False,
                         seq_length=seq_length)[0]
            loss = global_loss(loss_share(
                compute_loss(loss_type, logits, y, from_logits, mask_pad, shard), y))
            bm = sync_metrics(compute_batch_metrics(metrics, loss_type, logits, y,
                                                    from_logits, mask_pad, shard))
            return loss, whole(logits), bm

    training = (comp_mode is CompMode.TRAINING and optimizer is not None
                and loss_type is not None)
    eager = {"forward_fn": forward_fn}
    if loss_type is not None:
        eager["eval_step"] = eval_step
    if training:
        eager.update(train_step=train_step, train_k_steps=k_steps(train_step),
                     grad_step=grad_step)
    captured, reason = capture_rule(device, mesh)
    graphs = StepGraphs(device, "compiled model") if captured else None
    # a replayed update bumps no tensor's version: the model's params
    # version tells derived caches (the serving bf16 cast) instead
    steps = _graphed_steps(graphs, eager, optimizer if training else None, device, cdt,
                           lambda: cm.bump_params_version()) if captured else dict(eager)
    if captured and training:
        steps["train_k_steps"] = k_steps(steps["train_step"])
    cm = CompiledModel(
        config=config, device=device, ops=ops, input_tensors=list(input_tensors),
        logits_tensor=logits_tensor, params=params, forward_fn=steps["forward_fn"],
        label_tensor=_label_tensor(loss_type, logits_tensor) if loss_type else None,
        loss_type=loss_type, metrics=metrics, optimizer=optimizer,
        opt_state=optimizer.init_state(zero_slices(params)) if training else None,
        wd_mask=wd_mask, update_fn=apply_update if training else None,
        zero_dims=zero_dims, loss_share=loss_share, sync_grads=sync_grads,
        label_block=label_block, last_sync=last_sync,
        train_step=steps.get("train_step"), train_k_steps=steps.get("train_k_steps"),
        eval_step=steps.get("eval_step"), grad_step=steps.get("grad_step"),
        from_logits=from_logits, mesh=mesh, layouts=layouts,
        eager=eager, graphs=graphs, capture={"captured": captured, "reason": reason})
    cm.audit_exec = _audit_specs(cm)
    return cm


def _graphed_steps(graphs: StepGraphs, eager: Dict[str, Callable], optimizer,
                   device: torch.device, cdt: Optional[torch.dtype],
                   bump: Callable[[], None]) -> Dict[str, Callable]:
    """The step functions of a captured model: each call goes through
    ``graphs`` at its key (the step kind, the inputs' shapes and dtypes,
    ``seq_length``, the compute dtype), reading and updating the params
    and the optimizer state in place; ``plain_kernels=True`` calls the
    eager function. Every replayed update bumps the model's params
    version (a replay bumps no tensor's ``_version``, which derived caches
    read)."""
    dtype = str(cdt or torch.float32)
    out: Dict[str, Callable] = {}

    def key(kind, args, seq_length):
        return graph_key(kind, args, seq_length=seq_length, plain_kernels=False,
                         compute_dtype=dtype)

    if "train_step" in eager:
        eager_train = eager["train_step"]

        def train_step(params, opt_state, rng, *batch, plain_kernels=False, seq_length=-1):
            if plain_kernels:
                return eager_train(params, opt_state, rng, *batch, plain_kernels=True,
                                   seq_length=seq_length)
            hyper = optimizer.load_hyper(device)

            def body(rng_t, *b):
                _, _, loss, bm = eager_train(params, opt_state, rng_t, *b,
                                             seq_length=seq_length, hyper=hyper)
                return loss, bm

            args = (rng, *batch)
            loss, bm = graphs.run(key("train_step", args, seq_length), body, args,
                                  tensor_leaves(params, opt_state, hyper), after_replay=bump)
            return params, opt_state, loss, bm

        eager_grad = eager["grad_step"]

        def grad_step(params, rng, *batch, plain_kernels=False, seq_length=-1):
            if plain_kernels:
                return eager_grad(params, rng, *batch, plain_kernels=True,
                                  seq_length=seq_length)
            args = (rng, *batch)
            return graphs.run(key("grad_step", args, seq_length),
                              lambda rng_t, *b: eager_grad(params, rng_t, *b,
                                                           seq_length=seq_length),
                              args, tensor_leaves(params))

        out.update(train_step=train_step, grad_step=grad_step)

    if "eval_step" in eager:
        eager_eval = eager["eval_step"]

        def eval_step(params, *batch, plain_kernels=False, seq_length=-1):
            if plain_kernels:
                return eager_eval(params, *batch, plain_kernels=True, seq_length=seq_length)
            return graphs.run(key("eval_step", batch, seq_length),
                              lambda *b: eager_eval(params, *b, seq_length=seq_length),
                              batch, tensor_leaves(params))

        out["eval_step"] = eval_step

    eager_forward = eager["forward_fn"]

    def forward_fn(params, *xs, plain_kernels=False, seq_length=-1):
        if plain_kernels:
            return eager_forward(params, *xs, plain_kernels=True, seq_length=seq_length)
        return graphs.run(key("forward_fn", xs, seq_length),
                          lambda *b: eager_forward(params, *b, seq_length=seq_length),
                          xs, tensor_leaves(params))

    out["forward_fn"] = forward_fn
    return out


def _clone_tree(tree):
    """A copy of a dict/list/tuple tree with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def _audit_specs(cm: CompiledModel) -> list:
    """The step programs the program audit records (module docstring):
    each spec builds fresh arguments when the audit runs, so nothing is
    held between compile and the audit, and the recorded call touches
    none of the model's own params, optimizer state or counters. The audit
    records one real eager call of each (``cm.eager``), captured or not."""
    from ..analysis.program_audit import ExecutableSpec

    n_inputs = len(cm.input_tensors)

    def zero_batch(lead: tuple = ()) -> list:
        out = []
        tensors = list(cm.input_tensors)
        if cm.label_tensor is not None:
            tensors.append(cm.label_tensor)
        for i, t in enumerate(tensors):
            z = torch.zeros(tuple(t.dims), dtype=t.dtype.to_torch(), device=cm.device)
            z = z[cm.batch_rows(i)]
            out.append(z.expand(*lead, *z.shape).contiguous() if lead else z)
        return out

    specs = []
    if cm.train_step is not None:
        specs.append(ExecutableSpec(
            "train_step", cm.eager["train_step"], donated=(0, 1),
            make_args=lambda: (_clone_tree(cm.params), _clone_tree(cm.opt_state), 0,
                               *zero_batch())))
        k = max(1, int(cm.config.steps_per_dispatch))
        if k > 1:
            specs.append(ExecutableSpec(
                "train_k_steps", cm.eager["train_k_steps"], donated=(0, 1),
                make_args=lambda: (_clone_tree(cm.params), _clone_tree(cm.opt_state),
                                   [0] * k, *zero_batch((k,)))))
    if cm.eval_step is not None:
        specs.append(ExecutableSpec("eval_step", cm.eager["eval_step"],
                                    make_args=lambda: (cm.params, *zero_batch())))
    else:
        specs.append(ExecutableSpec(
            "forward", cm.eager["forward_fn"],
            make_args=lambda: (cm.params, *zero_batch()[:n_inputs])))
    return specs


def _or_zeros(grad: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    # a weight the loss does not reach gets a zero gradient, as jax.grad gives
    return torch.zeros_like(like) if grad is None else grad
