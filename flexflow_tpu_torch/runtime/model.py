"""FFModel: the user-facing model API.

PyTorch counterpart of ``flexflow_tpu/runtime/model.py``: the graph calls
the port's slices need (``create_tensor``, ``dense`` with its
``kernel_regularizer``, ``conv2d``, ``pool2d``, ``batch_norm``,
``multihead_attention``, ``batch_matmul``, ``softmax``, ``layer_norm``,
the elementwise binary and unary verbs, the structural verbs from
``flat`` to ``constant``, ``mean`` and ``reduce_sum``, ``dropout``,
``embedding``, ``gather``, the recurrent ``lstm``/``gru``/``rnn`` and the
MoE family up to ``moe``), ``compile`` with an optimizer, a loss and
metrics (and the fusion pass under ``FFConfig.perform_fusion``),
``fit``/``eval``, the manual ``set_batch``/``forward``/``zero_gradients``/
``backward``/``update`` verbs (``forward``/``backward`` take the
iteration's ``seq_length``, default ``iter_config.seq_length``),
``save_checkpoint``/``load_checkpoint``, and :func:`load_numpy_params` to
carry the JAX package's params across. Each training step gets the next
value of a counter as its dropout key, as the JAX package folds its
counter into its root key. ``compile()`` and ``fit()`` arm the config's
span tracer and fault plan (``FFConfig.trace``, ``FFConfig.fault_plan``),
``eval()`` its tracer.

``fit`` is the JAX package's step loop: the ``Prefetcher``
(``prefetch_depth``), ``steps_per_dispatch`` batches a host call through
``train_k_steps``, at most ``max_inflight_steps`` steps in flight on the
card, ``grad_accum_steps`` (in the compiled step), sequence buckets with
masked padding (``seq_buckets``, ``token_budget``, ``seq_bucket_pad_max``;
each unseen (rows, width) counted on ``fit.bucket_compiles``), a
``TrainingGuard`` (``guard=``), crash-safe checkpoints every
``checkpoint_interval_steps`` and ``resume_from=`` (a multi-process
group, or a directory a cohort wrote, takes the
``MultiHostCheckpointManager``), recompile-on-condition
(``recompile_state=``) and the fault sites ``train.nan_loss``,
``train.stall``, ``train.kill``, ``multihost.slow_peer`` and
``multihost.peer_kill``. Each epoch's :class:`EpochThroughput` record
lands in ``fit_profile``; the fit's tail adds divergence
(``config.divergence``), attribution and advice (``fit_profile
["attribution"]``, ``["advice"]``), the cost corpus, one ledger record and
the cohort export (``obs/``), and the stall watchdog watches the loop
(``config.watchdog``).

Over a mesh (``FFConfig.mesh_shape``, one process per rank, see
``core/machine.py``) ``compile`` takes ``strategies=`` and the layers'
``strategy=`` entries (``dense``, ``multihead_attention``), as the JAX
package does; ``export_strategy``/``import_strategy`` write and read its
JSON. The batch is the global one: ``fit``, ``eval`` and ``set_batch``
take each rank's rows of it, ``load_numpy_params`` takes whole arrays and
keeps each rank's blocks, and :meth:`FFModel.numpy_params` gathers them
back. The parallel verbs (``repartition``, ``combine``, ``replicate``,
``reduction``, ``allreduce``) move the data they name.

``compile(pipeline=PipelineConfig(...))`` trains through a pipeline
engine (``parallel/pipeline.py``), and a mesh with a ``pipe`` axis above
1 enables one when the graph has at least that many ops, with
``config.pipeline_schedule``/``pipeline_interleave``/``pipeline_remat``;
``schedule="auto"`` takes the simulator's ranking
(``sim/simulator.py``). ``config.grad_accum_steps`` folds into its
microbatch count. With an
engine, ``fit``, ``eval``, ``set_batch`` and ``forward`` take the global
batch on every rank and go through it, ``fit_profile["pipeline"]``
records it, and :meth:`FFModel.numpy_params` gathers every stage's
params.

With ``config.search_budget`` nonzero and no strategy given, ``compile``
runs the strategy search (``search/``: the Unity DP over the layers and
every mesh shape of the world, or on the pinned ``mesh_shape``; MCMC
under ``search_method="mcmc"``), priced by the simulator (``sim/``) on
the platform's machine model or ``machine_model_file``, through the
strategy cache under ``search_cache``; ``search_profile`` records it.
``playoff_steps`` > 0 races the searched plan against plain data
parallelism at the first ``fit`` and keeps the faster.
"""

from __future__ import annotations

import collections
import os
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import ops as _ops  # noqa: F401  (registers the op library)
from ..config import FFConfig, FFIterationConfig
from ..core.layer import Layer
from ..core.machine import DATA_AXIS
from ..core.op import create_op
from ..core.parallel_tensor import ParallelTensorShape
from ..core.tensor import Tensor
from ..ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType, MetricsType,
                       OpType, PoolType)
from ..obs.metrics import EpochThroughput, metrics_registry
from ..obs.trace import configure_tracer, span, tracer
from . import faults as _fx
from .buckets import DynamicShapeError, PackingSpec, resolve_ladder, row_lengths
from .compiler import CompiledModel, Params, compile_model
from .dataloader import DataLoaderGroup, Prefetcher, SingleDataLoader
from .faults import configure_faults
from .loss import loss_from_string
from .metrics import PerfMetrics
from .optimizer import Optimizer, SGDOptimizer

_METRICS_FROM_STRING = {
    "accuracy": MetricsType.ACCURACY,
    "categorical_crossentropy": MetricsType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.MEAN_ABSOLUTE_ERROR,
}


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        # raises here, at the entry point, when the config asks for a
        # card that is not there
        self.device = self.config.torch_device()
        self.layers: List[Layer] = []
        self.input_tensors: List[Tensor] = []
        self.compiled: Optional[CompiledModel] = None
        self.optimizer: Optional[Optimizer] = None
        self._cur_batch: Optional[List[torch.Tensor]] = None
        self._cur_grads: Optional[Params] = None
        self._rng_counter = 0
        # per-iteration config: seq_length truncates declared sequence dims
        self.iter_config = FFIterationConfig()
        # fit's and eval's step-loop records (steps/s, the knobs, buckets,
        # the guard's narrative)
        self.fit_profile: Optional[dict] = None
        self.eval_profile: Optional[dict] = None
        self._resolved_ladder: Tuple[int, ...] = ()
        self._resolved_token_budget = 0
        # the strategies of the last compile, by layer name
        self._strategies: Dict[str, Dict[str, str]] = {}
        # the pipeline engine of the last compile (parallel/pipeline.py)
        self.pipelined = None
        # the last search's GraphSearchResult and its profile (timing,
        # coverage, the cache outcome); the graph a structural rewrite won
        self.search_result = None
        self.search_profile: Optional[dict] = None
        self._search_layers: Optional[List[Layer]] = None
        self._strategy_cache_key: Optional[str] = None
        # schedule="auto"'s per-candidate pricing records
        self._pipe_schedule_records: list = []
        # the execution playoff (fit's first call after a search)
        self._compile_ctx: Optional[dict] = None
        self._playoff_done = True
        self._playoff_record: Optional[dict] = None
        # the last compile's executable telemetry (config.exec_telemetry)
        # and the last fit's OBS001 report (config.divergence)
        self.exec_telemetry: Optional[dict] = None
        self.obs_report = None

    # ---- graph construction ---------------------------------------------
    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.FLOAT,
                      name: Optional[str] = None,
                      create_grad: bool = True) -> Tensor:
        """Dims are batch-first (numpy order)."""
        t = Tensor(tuple(dims), dtype, name=name, model=self,
                   create_gradients=create_grad)
        self.input_tensors.append(t)
        return t

    def _add_layer(self, op_type: OpType, inputs: List[Tensor],
                   attrs: Dict[str, Any],
                   out_dims_list: List[Tuple[Tuple[int, ...], DataType]],
                   name: Optional[str]) -> Union[Tensor, List[Tensor]]:
        layer = Layer(op_type, name=name, inputs=inputs, attrs=attrs)
        for i, (dims, dtype) in enumerate(out_dims_list):
            layer.outputs.append(Tensor(dims, dtype, owner_layer=layer,
                                        owner_idx=i, model=self,
                                        name=f"{layer.name}:out{i}"))
        self.layers.append(layer)
        return layer.outputs[0] if len(layer.outputs) == 1 else list(layer.outputs)

    def _infer_and_add(self, op_type, inputs, attrs, name):
        """Build a probe op to run shape inference at build time."""
        probe = create_op(
            Layer(op_type, name="__probe__", inputs=inputs, attrs=attrs),
            [ParallelTensorShape.unpartitioned(t.dims, t.dtype) for t in inputs])
        return self._add_layer(op_type, inputs, attrs,
                               probe.infer_output_shapes(), name)

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.NONE, use_bias: bool = True,
              kernel_initializer=None, bias_initializer=None,
              kernel_regularizer=None, name: Optional[str] = None,
              strategy: Optional[Dict[str, str]] = None) -> Tensor:
        """``kernel_regularizer`` (``keras.regularizers``) adds its penalty
        on the kernel to the training loss. ``strategy``: ``{"out": axis}``
        shards the out-features over a mesh axis, ``{"in": axis}`` the
        in-features."""
        attrs = dict(out_dim=out_dim, activation=activation, use_bias=use_bias,
                     kernel_initializer=kernel_initializer,
                     bias_initializer=bias_initializer)
        if kernel_regularizer is not None:
            attrs["kernel_regularizer"] = kernel_regularizer
        if strategy:
            attrs["strategy"] = strategy
        return self._infer_and_add(OpType.LINEAR, [input], attrs, name)

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               activation: ActiMode = ActiMode.NONE, groups: int = 1,
               use_bias: bool = True, kernel_initializer=None, bias_initializer=None,
               name: Optional[str] = None,
               strategy: Optional[Dict[str, str]] = None) -> Tensor:
        """NCHW convolution with an OIHW kernel. ``strategy``:
        ``{"out_channels": axis}`` or ``{"spatial": axis}`` (ops/conv.py)."""
        attrs = dict(out_channels=out_channels, kernel=(kernel_h, kernel_w),
                     stride=(stride_h, stride_w), padding=(padding_h, padding_w),
                     activation=activation, groups=groups, use_bias=use_bias,
                     kernel_initializer=kernel_initializer,
                     bias_initializer=bias_initializer)
        if strategy:
            attrs["strategy"] = strategy
        return self._infer_and_add(OpType.CONV2D, [input], attrs, name)

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int, stride_h: int,
               stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.MAX,
               activation: ActiMode = ActiMode.NONE, name: Optional[str] = None) -> Tensor:
        attrs = dict(kernel=(kernel_h, kernel_w), stride=(stride_h, stride_w),
                     padding=(padding_h, padding_w), pool_type=pool_type,
                     activation=activation)
        return self._infer_and_add(OpType.POOL2D, [input], attrs, name)

    def batch_norm(self, input: Tensor, relu: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> Tensor:
        """Per-channel batch norm of an NCHW tensor, with a fused ReLU
        unless ``relu=False``; its running statistics update in ``fit``'s
        training steps only."""
        return self._infer_and_add(OpType.BATCHNORM, [input],
                                   dict(relu=relu, eps=float(eps)), name)

    def batch_matmul(self, A: Tensor, B: Tensor, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name=None) -> Tensor:
        """A @ B over matching batch dims. With a positive iteration
        ``seq_length`` the op first slices ``a_seq_length_dim`` /
        ``b_seq_length_dim`` (when >= 0) to it."""
        attrs = dict(a_seq_length_dim=a_seq_length_dim, b_seq_length_dim=b_seq_length_dim)
        return self._infer_and_add(OpType.BATCHMATMUL, [A, B], attrs, name)

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, kernel_initializer=None,
                            causal: bool = False, name=None,
                            strategy: Optional[Dict[str, str]] = None) -> Tensor:
        """``strategy``: ``{"heads": axis}`` shards the heads over a mesh
        axis, ``{"seq": axis, "seq_mode": "ring" | "a2a"}`` the sequence."""
        attrs = dict(embed_dim=embed_dim, num_heads=num_heads,
                     kdim=kdim or embed_dim, vdim=vdim or embed_dim,
                     dropout=dropout, bias=bias,
                     kernel_initializer=kernel_initializer, causal=causal)
        if strategy:
            attrs["strategy"] = strategy
        return self._infer_and_add(OpType.MULTIHEAD_ATTENTION,
                                   [query, key, value], attrs, name)

    def softmax(self, input: Tensor, axis: int = -1, name=None) -> Tensor:
        return self._infer_and_add(OpType.SOFTMAX, [input], dict(dim=axis), name)

    # ---- structural and reductions ----------------------------------------
    def flat(self, input: Tensor, name=None) -> Tensor:
        return self._infer_and_add(OpType.FLAT, [input], {}, name)

    def reshape(self, input: Tensor, shape: Sequence[int], name=None) -> Tensor:
        return self._infer_and_add(OpType.RESHAPE, [input], dict(shape=tuple(shape)), name)

    def transpose(self, input: Tensor, perm: Sequence[int], name=None) -> Tensor:
        return self._infer_and_add(OpType.TRANSPOSE, [input], dict(perm=tuple(perm)), name)

    def reverse(self, input: Tensor, axis: int, name=None) -> Tensor:
        return self._infer_and_add(OpType.REVERSE, [input], dict(axis=axis), name)

    def concat(self, tensors: List[Tensor], axis: int, name=None) -> Tensor:
        return self._infer_and_add(OpType.CONCAT, list(tensors), dict(axis=axis), name)

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]], axis: int,
              name=None) -> List[Tensor]:
        """``sizes``: the parts' sizes along ``axis``, or how many equal parts."""
        if isinstance(sizes, int):
            total = input.dims[axis % len(input.dims)]
            if total % sizes:
                raise ValueError(f"split of a dim of {total} into {sizes} equal parts")
            splits = [total // sizes] * sizes
        else:
            splits = list(sizes)
        out = self._infer_and_add(OpType.SPLIT, [input], dict(axis=axis, splits=splits),
                                  name)
        return out if isinstance(out, list) else [out]

    def cast(self, input: Tensor, dtype: DataType, name=None) -> Tensor:
        return self._infer_and_add(OpType.CAST, [input], dict(dtype=dtype), name)

    def slice_tensor(self, input: Tensor, items, name=None) -> Tensor:
        """Static strided slice and integer indexing (``Slice``'s items)."""
        return self._infer_and_add(OpType.SLICE, [input], dict(items=list(items)), name)

    def constant(self, value, name=None) -> Tensor:
        """A baked-in constant: integers become int32, bools stay bool,
        everything else float32, as in the JAX package."""
        v = np.asarray(value)
        if np.issubdtype(v.dtype, np.integer):
            dt, v = DataType.INT32, v.astype(np.int32)
        elif v.dtype == np.bool_:
            dt = DataType.BOOL
        else:
            dt, v = DataType.FLOAT, v.astype(np.float32)
        return self._infer_and_add(OpType.CONSTANT, [], dict(value=v, dtype=dt), name)

    def mean(self, input: Tensor, dims: Sequence[int], keepdims: bool = False,
             name=None) -> Tensor:
        return self._infer_and_add(OpType.MEAN, [input],
                                   dict(axes=tuple(dims), keepdims=keepdims), name)

    def reduce_sum(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                   name=None) -> Tensor:
        return self._infer_and_add(OpType.REDUCE_SUM, [input],
                                   dict(axes=tuple(axes), keepdims=keepdims), name)

    # ---- recurrent --------------------------------------------------------
    def _recurrent(self, op_type, input, initial_state, attrs, name):
        inputs = [input]
        if initial_state is not None:
            inputs.extend(initial_state if isinstance(initial_state, (list, tuple))
                          else [initial_state])
        return self._infer_and_add(op_type, inputs, attrs, name)

    def lstm(self, input: Tensor, hidden_size: int, return_sequences: bool = True,
             return_state: bool = False, initial_state=None, kernel_initializer=None,
             recurrent_initializer=None, name=None):
        """LSTM over (batch, seq, features). ``initial_state``: (h0, c0).
        Returns the sequence (or the last hidden state), then (h, c) with
        ``return_state``."""
        attrs = dict(hidden_size=hidden_size, return_sequences=return_sequences,
                     return_state=return_state, kernel_initializer=kernel_initializer,
                     recurrent_initializer=recurrent_initializer)
        return self._recurrent(OpType.LSTM, input, initial_state, attrs, name)

    def gru(self, input: Tensor, hidden_size: int, return_sequences: bool = True,
            return_state: bool = False, initial_state=None, kernel_initializer=None,
            recurrent_initializer=None, name=None):
        """GRU with nn.GRU's gates (r, z, n)."""
        attrs = dict(hidden_size=hidden_size, return_sequences=return_sequences,
                     return_state=return_state, kernel_initializer=kernel_initializer,
                     recurrent_initializer=recurrent_initializer)
        return self._recurrent(OpType.GRU, input, initial_state, attrs, name)

    def rnn(self, input: Tensor, hidden_size: int, activation: ActiMode = ActiMode.TANH,
            return_sequences: bool = True, return_state: bool = False,
            initial_state=None, name=None):
        """Vanilla RNN, tanh or ReLU."""
        attrs = dict(hidden_size=hidden_size, activation=activation,
                     return_sequences=return_sequences, return_state=return_state)
        return self._recurrent(OpType.RNN, input, initial_state, attrs, name)

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> Tensor:
        """Normalise over ``axes`` (any dims, not only trailing ones)."""
        attrs = dict(axes=tuple(axes), elementwise_affine=elementwise_affine, eps=eps)
        return self._infer_and_add(OpType.LAYERNORM, [input], attrs, name)

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name=None) -> Tensor:
        """Drop elements at ``rate`` while training. ``seed`` is kept as an
        attribute, as in the JAX package, whose draws do not read it either:
        the masks come from the config's seed, the step and the op's name."""
        return self._infer_and_add(OpType.DROPOUT, [input], dict(rate=rate, seed=seed),
                                   name)

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.NONE, dtype: DataType = DataType.FLOAT,
                  kernel_initializer=None, name=None,
                  strategy: Optional[Dict[str, str]] = None) -> Tensor:
        """Rows of a (num_entries, out_dim) table; SUM/AVG reduce the
        trailing multi-hot dim. ``strategy``: ``{"vocab": axis}`` or
        ``{"out": axis}`` (ops/embedding.py)."""
        attrs = dict(num_entries=num_entries, out_dim=out_dim, aggr=aggr, dtype=dtype,
                     kernel_initializer=kernel_initializer)
        if strategy:
            attrs["strategy"] = strategy
        return self._infer_and_add(OpType.EMBEDDING, [input], attrs, name)

    def gather(self, input: Tensor, index: Tensor, dim: int, name=None) -> Tensor:
        """``torch.gather`` along ``dim``."""
        return self._infer_and_add(OpType.GATHER, [input, index], dict(dim=dim), name)

    # ---- elementwise -----------------------------------------------------
    # ``inplace``/``inplace_a`` are accepted for the JAX package's
    # signatures and ignored there too
    def _binary(self, op_type: OpType, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._infer_and_add(op_type, [x, y], {}, name)

    def add(self, x, y, name=None, inplace_a=False):
        return self._binary(OpType.EW_ADD, x, y, name)

    def subtract(self, x, y, name=None, inplace_a=False):
        return self._binary(OpType.EW_SUB, x, y, name)

    def multiply(self, x, y, name=None, inplace_a=False):
        return self._binary(OpType.EW_MUL, x, y, name)

    def divide(self, x, y, name=None, inplace_a=False):
        return self._binary(OpType.EW_DIV, x, y, name)

    def max(self, x, y, name=None, inplace_a=False):
        return self._binary(OpType.EW_MAX, x, y, name)

    def min(self, x, y, name=None, inplace_a=False):
        return self._binary(OpType.EW_MIN, x, y, name)

    def _unary(self, op_type: OpType, x: Tensor, name=None, **attrs) -> Tensor:
        return self._infer_and_add(op_type, [x], attrs, name)

    def exp(self, x, name=None):
        return self._unary(OpType.EXP, x, name)

    def relu(self, x, name=None, inplace=True):
        return self._unary(OpType.RELU, x, name)

    def identity(self, x, name=None):
        return self._unary(OpType.IDENTITY, x, name)

    def sigmoid(self, x, name=None):
        return self._unary(OpType.SIGMOID, x, name)

    def tanh(self, x, name=None):
        return self._unary(OpType.TANH, x, name)

    def elu(self, x, name=None, inplace=True):
        return self._unary(OpType.ELU, x, name)

    def gelu(self, x, name=None):
        return self._unary(OpType.GELU, x, name)

    def rsqrt(self, x, name=None):
        return self._unary(OpType.RSQRT, x, name)

    def sin(self, x, name=None):
        return self._unary(OpType.SIN, x, name)

    def cos(self, x, name=None):
        return self._unary(OpType.COS, x, name)

    def pow(self, x, exponent: float, name=None):
        return self._unary(OpType.POW, x, name, scalar=exponent)

    def scalar_multiply(self, x, scalar: float, name=None, inplace=True):
        return self._unary(OpType.SCALAR_MULTIPLY, x, name, scalar=scalar)

    def scalar_add(self, x, scalar: float, name=None, inplace=True):
        return self._unary(OpType.SCALAR_ADD, x, name, scalar=scalar)

    def scalar_sub(self, x, scalar: float, name=None, inplace=True):
        return self._unary(OpType.SCALAR_SUB, x, name, scalar=scalar)

    def scalar_true_divide(self, x, scalar: float, name=None, inplace=True):
        return self._unary(OpType.SCALAR_TRUE_DIV, x, name, scalar=scalar)

    # ---- MoE family ------------------------------------------------------
    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name=None) -> List[Tensor]:
        """[values, int32 indices] of the k largest entries of the last
        dim, always sorted (as in the JAX package)."""
        out = self._infer_and_add(OpType.TOPK, [input], dict(k=k, sorted=sorted), name)
        return out if isinstance(out, list) else [out]

    def group_by(self, input: Tensor, assign: Tensor, n: int, alpha: float,
                 name=None) -> List[Tensor]:
        """Scatter ``input`` rows into n fixed-capacity expert tensors."""
        out = self._infer_and_add(OpType.GROUP_BY, [input, assign],
                                  dict(n=n, alpha=alpha), name)
        return out if isinstance(out, list) else [out]

    def aggregate(self, inputs: List[Tensor], n: int, lambda_bal: float,
                  name=None) -> Tensor:
        """inputs = [gate_preds, gate_assign, true_gate_assign,
        full_gate_grads, exp_pred_1, ..., exp_pred_n]."""
        return self._infer_and_add(OpType.AGGREGATE, list(inputs),
                                   dict(n=n, lambda_bal=lambda_bal), name)

    def aggregate_spec(self, inputs: List[Tensor], n: int, lambda_bal: float,
                       name=None) -> Tensor:
        return self._infer_and_add(OpType.AGGREGATE_SPEC, list(inputs),
                                   dict(n=n, lambda_bal=lambda_bal), name)

    def group_by_stacked(self, input: Tensor, assign: Tensor, n: int,
                         alpha: float, name=None,
                         strategy: Optional[Dict[str, str]] = None) -> Tensor:
        """GroupBy emitting one stacked (n, capacity, d) tensor.
        ``strategy={"expert": axis}`` shards the experts over a mesh axis;
        on the axis that shards the batch that is expert parallelism (each
        rank routes its own tokens, an all-to-all carries them to the
        experts' owners)."""
        attrs = dict(n=n, alpha=alpha)
        if strategy:
            attrs["strategy"] = strategy
        return self._infer_and_add(OpType.GROUP_BY_STACKED, [input, assign],
                                   attrs, name)

    def expert_linear(self, input: Tensor, out_dim: int,
                      activation: ActiMode = ActiMode.NONE,
                      use_bias: bool = True, kernel_initializer=None,
                      name=None) -> Tensor:
        """Per-expert dense over a stacked (n, capacity, d) tensor."""
        attrs = dict(out_dim=out_dim, activation=activation, use_bias=use_bias)
        if kernel_initializer is not None:
            attrs["kernel_initializer"] = kernel_initializer
        return self._infer_and_add(OpType.EXPERT_LINEAR, [input], attrs, name)

    def aggregate_stacked(self, gate_preds: Tensor, assign: Tensor,
                          full_gate: Tensor, exp_stacked: Tensor, n: int,
                          lambda_bal: float, name=None) -> Tensor:
        return self._infer_and_add(
            OpType.AGGREGATE_STACKED, [gate_preds, assign, full_gate, exp_stacked],
            dict(n=n, lambda_bal=lambda_bal), name)

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0, lambda_bal: float = 0.04,
            stacked: bool = False, expert_axis: Optional[str] = None,
            name=None) -> Tensor:
        """The composite MoE layer: gate = dense(input, num_exp, RELU);
        top-k of the gate; group_by; per expert softmax(dense(rows,
        hidden, RELU)); aggregate with softmax(top-k values) as the gate
        weights. ``stacked=True`` builds the same math as one
        group_by_stacked -> expert_linear -> aggregate_stacked chain.
        Layer names follow the JAX package's (``{name}_gate``,
        ``{name}_exp{i}`` or ``{name}_experts``, ``{name}_agg``)."""
        if expert_axis is not None and not stacked:
            raise ValueError("expert_axis requires stacked=True (the "
                             "n-branch formulation cannot shard experts)")
        nm = name or "moe"
        gate = self.dense(input, num_exp, ActiMode.RELU, name=f"{nm}_gate")
        topk_out, topk_idx = self.top_k(gate, num_select, sorted=False)
        gate_sm = self.softmax(topk_out)
        if stacked:
            grouped = self.group_by_stacked(
                input, topk_idx, num_exp, alpha, name=f"{nm}_group",
                strategy={"expert": expert_axis} if expert_axis else None)
            h = self.expert_linear(grouped, expert_hidden_size, ActiMode.RELU,
                                   name=f"{nm}_experts")
            h = self.softmax(h)
            return self.aggregate_stacked(gate_sm, topk_idx, gate, h, num_exp,
                                          lambda_bal, name=f"{nm}_agg")
        agg_inputs = [gate_sm, topk_idx, topk_idx, gate]
        for i, g in enumerate(self.group_by(input, topk_idx, num_exp, alpha)):
            h = self.dense(g, expert_hidden_size, ActiMode.RELU, name=f"{nm}_exp{i}")
            agg_inputs.append(self.softmax(h))
        return self.aggregate(agg_inputs, num_exp, lambda_bal, name=f"{nm}_agg")

    # ---- parallel ops -------------------------------------------------------
    def repartition(self, input: Tensor, dim: int, axis: str,
                    degree: Optional[int] = None, name=None) -> Tensor:
        """Shard ``dim`` over mesh axis ``axis``."""
        attrs = dict(dim=dim, axis=axis)
        if degree:
            attrs["degree"] = degree
        return self._infer_and_add(OpType.REPARTITION, [input], attrs, name)

    def combine(self, input: Tensor, dim: int, name=None) -> Tensor:
        """Gather a sharded ``dim`` back to whole."""
        return self._infer_and_add(OpType.COMBINE, [input], dict(dim=dim), name)

    def replicate(self, input: Tensor, axis: str, name=None) -> Tensor:
        """Replicate over ``axis``; the backward sums the replicas' gradients."""
        return self._infer_and_add(OpType.REPLICATE, [input], dict(axis=axis), name)

    def reduction(self, input: Tensor, axis: str, name=None) -> Tensor:
        """Sum partial values over ``axis``."""
        return self._infer_and_add(OpType.REDUCTION, [input], dict(axis=axis), name)

    def allreduce(self, input: Tensor, name=None) -> Tensor:
        return self._infer_and_add(OpType.ALLREDUCE, [input], {}, name)

    # ---- strategies ---------------------------------------------------------
    def export_strategy(self, path: str) -> None:
        """Write the strategies in effect (the last compile's, and the
        layers' own) as ``{"version": 1, "strategies": {layer: {...}}}``."""
        import json

        merged = dict(self._strategies)
        for layer in self.layers:
            if layer.attrs.get("strategy"):
                merged[layer.name] = layer.attrs["strategy"]
        strat = {name: clean for name, s in merged.items()
                 if (clean := {k: v for k, v in s.items() if not k.startswith("_")})}
        with open(path, "w") as f:
            json.dump({"version": 1, "strategies": strat}, f, indent=2)

    def import_strategy(self, path: str) -> Dict[str, Dict[str, str]]:
        """Read a file :meth:`export_strategy` wrote (or a bare
        ``{layer: strategy}`` map) onto the layers; returns the map."""
        import json

        with open(path) as f:
            data = json.load(f)
        strat = data.get("strategies", data)
        for layer in self.layers:
            if layer.name in strat:
                layer.attrs["strategy"] = dict(strat[layer.name])
        return strat

    def numpy_params(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The whole params as numpy on every rank (each sharded weight's
        blocks all-gathered): the JAX package's ``np.asarray`` of a sharded
        param."""
        from ..ops.parallel_ops import reshard

        cm = self.compiled
        if cm is None:
            raise RuntimeError("compile() before numpy_params()")
        if self.pipelined is not None:
            self.pipelined.sync_to(cm)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        with torch.no_grad():
            for op_name, ws in cm.params.items():
                out[op_name] = {}
                for w_name, t in ws.items():
                    if cm.mesh is not None:
                        lay = cm.weight_layout(op_name, w_name)
                        t = reshard(t, lay, ParallelTensorShape.unpartitioned(lay.sizes),
                                    cm.mesh)
                    out[op_name][w_name] = t.cpu().numpy().copy()
        return out

    # ---- compile ----------------------------------------------------------
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: Optional[Union[LossType, str]] = None,
                metrics: Optional[Sequence[Union[MetricsType, str]]] = None,
                comp_mode: Optional[CompMode] = None,
                logits_tensor: Optional[Tensor] = None,
                strategies: Optional[Dict[str, Dict[str, str]]] = None,
                mesh=None, pipeline=None) -> None:
        """Compile the graph. With a loss and TRAINING mode (the config's
        ``computation_mode`` unless ``comp_mode`` says otherwise) the model
        gets its training steps; without an optimizer it trains with the
        JAX package's default, SGD at lr 0.01 and weight decay 1e-4 (its
        ``FFConfig.learning_rate``/``weight_decay`` defaults). Under
        ``config.perform_fusion`` chains of weightless unary ops compile as
        one ``FusedOp`` each, the logits never fused away. ``strategies``
        maps layer names to strategies (a layer's own ``strategy=`` wins);
        ``mesh`` (``core.machine.Mesh``) defaults to
        ``make_mesh(config.mesh_shape)``. ``pipeline``
        (``parallel.pipeline.PipelineConfig``) trains through a pipeline
        engine over the mesh's pipe axis; a pipe axis above 1 enables one
        from the config's ``pipeline_*`` fields."""
        configure_tracer(self.config)
        # mistyped observability modes fail here, before any search work
        from ..obs.attribution import attribution_mode
        from ..obs.costcorpus import corpus_mode
        from ..obs.exec_telemetry import telemetry_mode
        from ..obs.ledger import ledger_mode
        from ..obs.server import configure_obs_server

        ledger_mode(self.config)
        telemetry_mode(self.config)
        attribution_mode(self.config)
        corpus_mode(self.config)
        configure_faults(self.config)  # a malformed plan fails before any work
        # config.obs_server_port arms the scrape surface (ratchet-on; a bad
        # port raises here)
        configure_obs_server(self.config)
        t0_compile = time.perf_counter()
        if comp_mode is None:
            comp_mode = self.config.computation_mode
        if isinstance(loss_type, str):
            loss_type = loss_from_string(loss_type)
        if optimizer is not None:
            self.optimizer = optimizer
        elif self.optimizer is None and loss_type is not None:
            self.optimizer = SGDOptimizer(lr=0.01, weight_decay=1e-4)
        mtypes = [_METRICS_FROM_STRING[m] if isinstance(m, str) else m
                  for m in metrics or []]
        logits = logits_tensor if logits_tensor is not None else self._final_output()
        strat = dict(strategies or {})
        for layer in self.layers:
            if layer.attrs.get("strategy") and layer.name not in strat:
                strat[layer.name] = layer.attrs["strategy"]
        self._search_layers = None
        if self.config.only_data_parallel:
            strat = {}
        elif self.config.search_budget != 0 and not strat:
            # the search (search/unity.py, or search/mcmc.py under
            # search_method="mcmc"); explicit strategies win over it
            strat, mesh = self._run_search(mesh, logits)
        self._strategies = strat
        # a structural rewrite the search chose compiles its graph; its
        # boundary tensors (the logits among them) are the builder's
        layers = self._search_layers or self.layers
        if self.config.perform_fusion:
            from ..ops.fused import apply_fusion

            layers = apply_fusion(layers, {logits.tensor_id})
        self.compiled = compile_model(self.config, layers, self._used_inputs(),
                                      logits, self.optimizer, loss_type, mtypes,
                                      comp_mode, strat, mesh)
        self.pipelined = None
        cm = self.compiled
        if pipeline is None and cm.mesh is not None and cm.train_step is not None:
            pipe_deg = cm.mesh.shape.get("pipe", 1)
            if pipe_deg > 1 and len(layers) >= pipe_deg:
                from ..parallel.pipeline import PipelineConfig, pipe_microbatches

                cfg = self.config
                pipeline = PipelineConfig(
                    num_stages=pipe_deg, num_microbatches=pipe_microbatches(cfg.batch_size),
                    schedule=cfg.pipeline_schedule,
                    interleave=(max(2, int(cfg.pipeline_interleave))
                                if cfg.pipeline_schedule == "interleaved" else 1),
                    remat=cfg.pipeline_remat)
        if pipeline is not None:
            from ..parallel.pipeline import make_pipelined_model

            self.pipelined = make_pipelined_model(cm, self._resolve_pipeline(pipeline))
        # what the execution playoff recompiles as plain data parallelism
        self._compile_ctx = dict(loss_type=loss_type, mtypes=mtypes, comp_mode=comp_mode,
                                 logits=logits)
        self._playoff_done = False
        self._playoff_record = None
        # executable telemetry (config.exec_telemetry): one step's flops and
        # the card's peak bytes, reconciled with the simulator's estimate
        self.exec_telemetry = None
        if telemetry_mode(self.config) == "on":
            from ..obs.exec_telemetry import collect_compiled_model

            with span("compile.exec_telemetry", cat="compile"):
                self.exec_telemetry = collect_compiled_model(
                    self, config=self.config, allow=self.config.exec_mem_allow)
        # graph exports the flags ask for (reference: --compgraph and
        # --taskgraph, written right after compile, model.cc:3666-3674)
        if self.config.export_strategy_computation_graph_file:
            self.export_computation_graph(self.config.export_strategy_computation_graph_file,
                                          include_costs=self.config.include_costs_dot_graph)
        if self.config.export_strategy_task_graph_file:
            self.export_task_graph(self.config.export_strategy_task_graph_file)
        dt_compile = time.perf_counter() - t0_compile
        tracer().complete("compile", t0_compile, dt_compile, cat="compile",
                          args={"n_ops": len(cm.ops), "pipelined": self.pipelined is not None})
        # one ledger record a compile (config.ledger)
        from ..obs.ledger import record_compile

        record_compile(self, dt_compile)

    def profile_ops(self, iters: int = 10, backward: bool = False):
        """Each compiled op timed standalone (``runtime/profiling.py``)."""
        from .profiling import profile_ops

        return profile_ops(self, iters=iters, backward=backward)

    def export_computation_graph(self, path: str, include_costs: bool = False) -> None:
        from .profiling import export_computation_graph

        export_computation_graph(self, path, include_costs)

    def export_task_graph(self, path: str, fmt: str = "dot") -> None:
        from .profiling import export_task_graph

        export_task_graph(self, path, fmt)

    def profiler_trace(self, logdir: str):
        """Context manager: a ``torch.profiler`` trace of the region into
        ``logdir`` (reference analog: Legion Prof)."""
        from .profiling import trace

        return trace(logdir)

    def _resolve_pipeline(self, pipeline):
        """A PipelineConfig finalized against the config and the compiled
        model: ``grad_accum_steps`` K folds into the microbatch count (K
        times the microbatches: the same averaging); ``schedule="auto"``
        takes the search's schedule when a search ran on this pipe mesh,
        else the simulator's ranking over the compiled ops
        (``sim/simulator.py`` ``rank_pipeline_schedules``), its records in
        ``self._pipe_schedule_records``."""
        import dataclasses as _dc

        cfg = self.config
        accum = max(1, int(cfg.grad_accum_steps))
        if accum > 1 and not pipeline.accum_folded:
            pipeline = _dc.replace(pipeline, num_microbatches=pipeline.num_microbatches * accum,
                                   accum_folded=True)
        self._pipe_schedule_records = []
        if pipeline.schedule != "auto":
            return pipeline
        sr = self.search_result
        if (sr is not None and sr.pipe_schedule
                and sr.mesh_shape.get(pipeline.axis) == pipeline.num_stages):
            self._pipe_schedule_records = list(sr.pipe_schedule_records)
            return _dc.replace(pipeline, schedule=sr.pipe_schedule,
                               interleave=sr.pipe_interleave)
        from ..parallel.pipeline_compiled import dp_unsupported_reason
        from ..search.unity import _stage_cut_bytes
        from ..sim import OpCostModel
        from ..sim.simulator import (compiled_envelope_ok, pipeline_schedule_candidates,
                                     rank_pipeline_schedules)

        cm = self.compiled
        sizes = dict(cm.mesh.shape) if cm.mesh is not None else {pipeline.axis: 1}
        machine = self._machine_model(int(np.prod(list(sizes.values()))))
        cost = OpCostModel(machine)
        t_sub = sum(cost.measure(op).total_time for op in cm.ops)
        n_ops = len(cm.ops)
        layers = [op.layer for op in cm.ops]
        cands = pipeline_schedule_candidates("auto", cfg.pipeline_interleave,
                                             pipeline.num_stages, n_ops)

        def cut_fn(nc: int) -> float:
            return float("inf") if nc > n_ops else _stage_cut_bytes(layers, nc)

        # the single-call engine's envelope for this mesh and graph, so
        # auto ranks with the dispatch overhead the engine choice delivers
        compiled_ok = (compiled_envelope_ok(sizes, pipeline.axis)
                       and dp_unsupported_reason(cm.ops, sizes.get("data", 1)) is None)
        kind, v, recs = rank_pipeline_schedules(
            cands, pipeline.num_stages, pipeline.num_microbatches, t_sub, machine,
            cut_bytes_fn=cut_fn, data_degree=sizes.get("data", 1),
            compiled_ok=compiled_ok, bwd_ratio=OpCostModel.BWD_FACTOR)
        self._pipe_schedule_records = recs
        if cfg.profiling:
            ranking = ", ".join("%s=%.3fms" % (r["schedule"], r["est_step_time"] * 1e3)
                                for r in recs)
            print(f"[pipeline] auto schedule -> {kind}" + (f" x{v}" if v > 1 else "")
                  + f" ({ranking})", flush=True)
        return _dc.replace(pipeline, schedule=kind, interleave=v)

    # ---- the search ---------------------------------------------------------
    def _machine_model(self, n: Optional[int] = None):
        """``config.machine_model_file`` when given, else the platform's
        model (``sim/machine_model.py`` ``detect_machine_model``) over
        ``n`` devices (default: the process group's world size)."""
        from ..sim import detect_machine_model, load_machine_model

        cfg = self.config
        if cfg.machine_model_file:
            return load_machine_model(cfg.machine_model_file)
        return detect_machine_model(n, compute_dtype=cfg.compute_dtype, device=cfg.device)

    def _run_search(self, mesh, logits):
        """The auto-parallelization search: the Unity DP
        (``search/unity.py``: :func:`graph_optimize` on a pinned mesh,
        :func:`full_search` over every mesh shape of the world otherwise)
        or, under ``search_method="mcmc"``, simulated annealing bounded by
        ``search_budget``/``search_alpha``. The strategy cache
        (``search_cache``) is consulted first. Returns (strategies, mesh);
        an unpinned search pins ``config.mesh_shape`` to its mesh."""
        import json as _json

        from ..core.machine import make_mesh
        from ..search.mcmc import mcmc_optimize
        from ..search.unity import _pipe_adjusted, data_parallel_input_pshapes, full_search
        from ..sim import OpCostModel, Simulator

        cfg = self.config
        # extra rules scoped to this config: the reference's GraphXfer
        # rule collection ({"rule": [...]}, translated to structural
        # rewrites) or the strategy-template schema ({"rules": {...}})
        cfg._substitution_rules = None
        cfg._graphxfer_rewrites = None
        if cfg.substitution_json_path:
            with open(cfg.substitution_json_path) as f:
                peek = _json.load(f)
            if "rule" in peek:
                from ..search.graph_xfer import load_graphxfer_rules
                from ..search.rule_interpreter import interpret_rules

                coll = load_graphxfer_rules(peek)
                cfg._graphxfer_rewrites, xfer_report = interpret_rules(coll)
                if cfg.profiling:
                    print(f"[search] graphxfer rules: {xfer_report} -> "
                          f"{len(cfg._graphxfer_rewrites)} rewrites", flush=True)
            else:
                from ..search.substitution import load_substitution_rules

                cfg._substitution_rules = load_substitution_rules(cfg.substitution_json_path)

        inputs = self._used_inputs()
        use_mcmc = cfg.search_method == "mcmc"
        beam = max(cfg.base_optimize_threshold, 8)
        protected = frozenset({logits.tensor_id})
        # the pipe-stage bound: the post-fusion graph needs one op a stage
        n_effective = len(self.layers)
        if cfg.perform_fusion:
            from ..ops.fused import apply_fusion

            n_effective = len(apply_fusion(self.layers, set(protected)))
        t_search = time.perf_counter()
        pinned = mesh is not None or bool(cfg.mesh_shape)
        if mesh is None and cfg.mesh_shape:
            mesh = make_mesh(cfg.mesh_shape)
        full_axis_sizes = (dict(mesh.shape) if mesh is not None
                           else dict(cfg.mesh_shape or {}))
        n_pinned = int(np.prod(list(full_axis_sizes.values()) or [1]))
        machine = self._machine_model(n_pinned if pinned else None)
        cache_mode = cfg.search_cache or "off"
        if cache_mode not in ("on", "off", "refresh"):
            raise ValueError(f"search_cache={cache_mode!r}: expected 'on', 'off' or 'refresh'")
        cache_key = None
        self._strategy_cache_key = None
        cache_dir = cfg.search_cache_dir
        if cache_mode in ("on", "refresh") and not use_mcmc:
            from ..search.cache import (cache_path, load_payload, result_from_payload,
                                        strategy_cache_key)

            cache_key = strategy_cache_key(self.layers, inputs, machine, cfg,
                                           mesh_axes=full_axis_sizes if pinned else None,
                                           protected=protected)
            self._strategy_cache_key = cache_key
            if cache_mode == "on":
                payload = load_payload(cache_dir, cache_key)
                result = (result_from_payload(payload, self.layers, cfg, protected)
                          if payload is not None else None)
                if result is not None and not self._validate_cached(
                        result, inputs, cache_path(cache_dir, cache_key)):
                    result = None
                if result is not None:
                    if not pinned:
                        cfg.mesh_shape = dict(result.mesh_shape)
                        mesh = make_mesh(result.mesh_shape)
                    return self._finish_search(result, mesh, t_search, "hit")
        if pinned:
            # the pinned mesh: strategies only. A pipe axis is handled as
            # full_search does: the inner DP on the per-stage submesh, the
            # device-memory cap scaled by the stage count, the schedule
            # model on top
            pipe = full_axis_sizes.get("pipe", 1)
            axis_sizes = {a: s for a, s in full_axis_sizes.items() if a != "pipe"}
            cap = machine.chip.hbm_capacity * pipe
            input_pshapes = data_parallel_input_pshapes(inputs, axis_sizes,
                                                        cfg.enable_sample_parallel)
            if use_mcmc:
                sim = Simulator(machine, OpCostModel(machine),
                                overlap_grad_sync=cfg.search_overlap_backward_update)
                result = mcmc_optimize(self.layers, input_pshapes, axis_sizes, sim, cfg,
                                       seed=cfg.seed)
                if pipe > 1:
                    result = _pipe_adjusted(result, self.layers, pipe, machine,
                                            cfg.batch_size, fused=cfg.perform_fusion,
                                            config=cfg)
            else:
                result = self._search_pinned(full_axis_sizes, inputs, machine, beam,
                                             protected, n_effective, input_pshapes, cap)
        else:
            result = full_search(self.layers, inputs, machine, cfg, beam_width=beam,
                                 max_pipe=max(1, n_effective // 2), protected=protected)
            cfg.mesh_shape = dict(result.mesh_shape)
            mesh = make_mesh(result.mesh_shape)
        if cache_key is not None:
            from ..search.cache import store_result, strategy_cache_key

            store_result(cache_dir, cache_key, result, layers=self.layers)
            if not pinned:
                # a recompile keys the cache with the searched mesh pinned
                key2 = strategy_cache_key(self.layers, inputs, machine, cfg,
                                          mesh_axes=result.mesh_shape, protected=protected)
                if key2 != cache_key:
                    store_result(cache_dir, key2, result, layers=self.layers)
        return self._finish_search(result, mesh, t_search,
                                   "off" if cache_key is None else
                                   ("refresh" if cache_mode == "refresh" else "miss"))

    def _search_pinned(self, full_axis_sizes, inputs, machine, beam, protected,
                       n_effective, input_pshapes, cap):
        """The Unity search on a pinned mesh: every graph variant by the
        candidate body full_search uses (``unity._evaluate_candidate``),
        then the adoption margin against plain data parallelism."""
        from ..search.graph_xfer import graph_variants
        from ..search.unity import (_effective_layer_count, _evaluate_candidate,
                                    _is_sharded_result, _memory_budget, _pipe_adjusted,
                                    adoption_margin, graph_optimize)
        from ..sim import OpCostModel, Simulator

        cfg = self.config
        pipe = full_axis_sizes.get("pipe", 1)
        axis_sizes = {a: s for a, s in full_axis_sizes.items() if a != "pipe"}
        result, errs, n_cand = None, [], 0
        shared_cm = OpCostModel(machine)
        for rewrites, vlayers in graph_variants(
                self.layers, cfg, rewrites=getattr(cfg, "_graphxfer_rewrites", None),
                protected=protected):
            # a variant too small for the pipe degree would un-pipe at
            # compile: skip it, unless the original cannot pipe either
            n_var = _effective_layer_count(vlayers, cfg.perform_fusion, protected)
            if pipe > 1 and n_var < pipe and n_effective >= pipe:
                continue
            n_cand += 1
            r = _evaluate_candidate(vlayers, full_axis_sizes, inputs, machine, cfg, beam,
                                    shared_cm, _memory_budget(cfg, machine), err_sink=errs,
                                    strict_budget=False)
            if r is None:
                continue
            if rewrites:
                r.rewrites, r.layers = list(rewrites), vlayers
            if result is None or r.est_step_time < result.est_step_time:
                result = r
        if result is None:
            raise RuntimeError("no feasible strategy on the pinned mesh") from (
                errs[0] if errs else None)
        if _is_sharded_result(result):
            # sharding over the pinned axes must beat leaving them idle
            # by more than the cost model's error bar, priced under the
            # same accounting (the loop's memo; ZeRO's sharded state)
            dp_mult = 2.0 / axis_sizes.get("data", 1) if cfg.zero_optimizer else 2.0
            dp_sim = Simulator(machine, shared_cm,
                               overlap_grad_sync=cfg.search_overlap_backward_update,
                               optimizer_state_mult=dp_mult)
            try:
                dp_r = graph_optimize(self.layers, input_pshapes, axis_sizes, dp_sim, cfg,
                                      beam, memory_cap=cap, dp_only=True)
                if (cfg.perform_memory_search
                        and dp_r.est_memory > _memory_budget(cfg, machine) * pipe):
                    dp_r = None
                elif pipe > 1:
                    dp_r = _pipe_adjusted(dp_r, self.layers, pipe, machine, cfg.batch_size,
                                          fused=cfg.perform_fusion, config=cfg)
            except RuntimeError:
                dp_r = None
            if (dp_r is not None and result.est_step_time * adoption_margin(cfg, machine)
                    > dp_r.est_step_time):
                result = dp_r
        result.candidates = n_cand
        result.workers = 1
        return result

    def _validate_cached(self, result, inputs, entry_path: str) -> bool:
        """A strategy rehydrated from the cache must build: ``build_ops``
        over the stored strategies and mesh (the JAX package's PCG
        validation is ROADMAP A11). A failure prints a line and demotes
        the hit to a miss."""
        from ..runtime.compiler import build_ops
        from ..search.unity import data_parallel_input_pshapes

        axis_sizes = {a: int(s) for a, s in result.mesh_shape.items()}
        try:
            build_ops(result.layers or self.layers,
                      data_parallel_input_pshapes(inputs, axis_sizes,
                                                  self.config.enable_sample_parallel),
                      axis_sizes, result.strategies)
        except (ValueError, KeyError, IndexError, NotImplementedError) as e:
            print(f"[search] cached strategy {entry_path} does not build "
                  f"({type(e).__name__}: {e}); treating as a miss", flush=True)
            return False
        return True

    def _finish_search(self, result, mesh, t_start: float, cache_label: str):
        """The shared tail of a searched or cache-hit result: the result
        and its profile, the span and the cache counter, the profiling
        line; returns (strategies, mesh)."""
        self.search_result = result
        self._search_layers = result.layers
        self.search_profile = {
            "search_time_s": time.perf_counter() - t_start,
            "cache": cache_label,
            "cache_key": self._strategy_cache_key,
            "candidates": result.candidates,
            "pruned": result.pruned,
            "states_explored": result.states_explored,
            "workers": result.workers,
            "mesh_shape": dict(result.mesh_shape),
            "est_step_time": result.est_step_time,
            "pipe_schedule": result.pipe_schedule,
        }
        tracer().complete("compile.search", t_start, self.search_profile["search_time_s"],
                          cat="compile",
                          args={"cache": cache_label, "candidates": result.candidates,
                                "mesh": dict(result.mesh_shape),
                                "est_step_time": result.est_step_time})
        metrics_registry().counter(f"search.cache.{cache_label}").inc()
        metrics_registry().gauge("search.est_step_time_s").set(result.est_step_time)
        if self.config.profiling:
            p = self.search_profile
            print(f"[search] mesh={result.mesh_shape} est_step={result.est_step_time*1e3:.3f}ms "
                  f"mem={result.est_memory/2**20:.1f}MiB states={result.states_explored}"
                  f" cand={p['candidates']} pruned={p['pruned']} cache={cache_label}"
                  f" t={p['search_time_s']:.3f}s"
                  + (f" rewrites={result.rewrites}" if result.rewrites else ""), flush=True)
        return result.strategies, mesh

    # ---- the execution playoff: the searched plan against plain data
    # parallelism, a few real steps each on fit's first batches ------------
    def _time_compiled(self, cm: CompiledModel, pipelined, xs, y_arr, bs: int,
                       steps: int) -> float:
        """Seconds a train step of ``cm`` (through ``pipelined`` when
        given) over ``steps`` steps after one warmup, each on the next
        batch of ``xs``/``y_arr`` as fit gives them (CUDA events on the
        card). The params and optimizer state are restored afterwards,
        a pipeline stage's own too (under ZeRO-1 its optimizer state is
        not a view of ``cm.opt_state``)."""
        def trees():
            return [cm.params, cm.opt_state] + ([] if pipelined is None else
                                                [pipelined.stage_params,
                                                 pipelined.stage_opt_state])

        snaps = [_clone_tree(t) for t in trees()]
        y_np = np.asarray(y_arr)
        if cm.loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            y_np = y_np.reshape(y_np.shape[0], -1).astype(np.int32)
        arrays = [np.asarray(a) for a in xs] + [y_np]
        n_batches = max(1, len(y_np) // bs)

        def one(i: int) -> None:
            lo = (i % n_batches) * bs
            rows = (lambda j: slice(None)) if pipelined is not None else cm.batch_rows
            b = [torch.as_tensor(a[lo:lo + bs][rows(j)]).to(cm.device)
                 for j, a in enumerate(arrays)]
            rng = (1 << 20) | i
            if pipelined is not None:
                pipelined.train_step(rng, b[:-1], b[-1])
            else:
                cm.params, cm.opt_state, _, _ = cm.train_step(cm.params, cm.opt_state, rng, *b)

        one(0)
        cuda = cm.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(cm.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(steps):
            one(i + 1)
        if cuda:
            end.record()
            end.synchronize()
            elapsed = start.elapsed_time(end) / 1e3 / steps
        else:
            elapsed = (time.perf_counter() - t0) / steps
        for tree, snap in zip(trees(), snaps):
            _copy_tree_(tree, snap)
        return elapsed

    def _maybe_playoff(self, xs, y_arr, bs: int) -> None:
        """``config.playoff_steps`` > 0, at the first fit after a compile
        whose plan is more than plain data parallelism: time the compiled
        plan and a data-parallel compile of the builder graph, and keep
        the faster (each rank's slowest time decides, so every rank keeps
        the same plan). The decision lands in ``self._playoff_record``."""
        cfg = self.config
        steps = int(cfg.playoff_steps)
        if steps <= 0 or self._playoff_done or self.compiled is None:
            return
        cm = self.compiled
        mesh_axes = dict(cm.mesh.shape) if cm.mesh is not None else {}
        nontrivial = (any(v for v in self._strategies.values())
                      or self._search_layers is not None or self.pipelined is not None
                      or any(a != DATA_AXIS and s > 1 for a, s in mesh_axes.items()))
        if not nontrivial:
            self._playoff_done = True
            return
        if len(y_arr) < bs:
            return  # too little data this call; the next fit tries again
        self._playoff_done = True
        if cm.iteration:
            self._playoff_record = {"skipped": "the compiled plan has trained already"}
            return
        import dataclasses as _dc

        t_searched = self._time_compiled(cm, self.pipelined, xs, y_arr, bs, steps)
        dp_cfg = _dc.replace(cfg, only_data_parallel=True, mesh_shape=None, playoff_steps=0,
                             search_budget=0)
        ctx = self._compile_ctx
        layers = self.layers
        if cfg.perform_fusion:
            from ..ops.fused import apply_fusion

            layers = apply_fusion(list(layers), {ctx["logits"].tensor_id})
        dp_cm = compile_model(dp_cfg, layers, self._used_inputs(), ctx["logits"],
                              self.optimizer, ctx["loss_type"], ctx["mtypes"],
                              ctx["comp_mode"], {}, None)
        whole = self.numpy_params()
        with torch.no_grad():
            for op_name, ws in dp_cm.params.items():
                for w_name, cur in ws.items():
                    arr = whole.get(op_name, {}).get(w_name)
                    if arr is None:
                        continue  # a layer a rewrite replaced keeps its init
                    if dp_cm.mesh is not None:
                        if tuple(arr.shape) != dp_cm.weight_layout(op_name, w_name).sizes:
                            continue
                        arr = arr[dp_cm.mesh.local_slices(dp_cm.weight_layout(op_name, w_name))]
                    if tuple(arr.shape) == tuple(cur.shape):
                        cur.copy_(torch.as_tensor(arr))
        t_dp = self._time_compiled(dp_cm, None, xs, y_arr, bs, steps)
        if cm.mesh is not None or dp_cm.mesh is not None:
            from ..parallel import collectives

            times = collectives.all_gather_objects((t_searched, t_dp))
            t_searched = max(t for t, _ in times)
            t_dp = max(t for _, t in times)
        kept = "dp" if t_dp < t_searched else "searched"
        print(f"[playoff] searched {t_searched*1e3:.2f}ms/step vs "
              f"dp {t_dp*1e3:.2f}ms/step -> {kept}", flush=True)
        self._playoff_record = {"searched_ms": t_searched * 1e3, "dp_ms": t_dp * 1e3,
                                "kept": kept}
        if kept == "dp":
            self.compiled = dp_cm
            self.pipelined = None
            self._strategies = {}
            self._search_layers = None

    def _used_inputs(self) -> List[Tensor]:
        used = {t.tensor_id for layer in self.layers for t in layer.inputs
                if t.owner_layer is None}
        return [t for t in self.input_tensors if t.tensor_id in used]

    def _final_output(self) -> Tensor:
        """The last leaf of the graph (the final op's output)."""
        produced = {}
        consumed = set()
        for layer in self.layers:
            for t in layer.outputs:
                produced[t.tensor_id] = t
            for t in layer.inputs:
                consumed.add(t.tensor_id)
        leaves = [t for tid, t in produced.items() if tid not in consumed]
        if not leaves:
            raise ValueError("empty model")
        return leaves[-1]

    # ---- fit / eval ---------------------------------------------------------
    def _training_model(self) -> CompiledModel:
        cm = self.compiled
        if cm is None or cm.train_step is None:
            raise RuntimeError(
                "compile() with an optimizer and a loss (in TRAINING mode) "
                "before training")
        return cm

    def _dynamic_shapes_spec(self, cm: CompiledModel, loaders, y_arr):
        """(PackingSpec, row lengths) under ``config.seq_buckets``, None
        with it off. Every misconfiguration raises a coded
        :class:`DynamicShapeError` (DYN003 and the ladder's own) here, at
        fit or eval entry, before a step runs."""
        cfg = self.config
        mode = cfg.seq_buckets
        budget = max(0, int(cfg.token_budget or 0))
        pad_max = cfg.seq_bucket_pad_max
        if pad_max not in ("on", "off"):
            raise DynamicShapeError("DYN003", f"seq_bucket_pad_max={pad_max!r} "
                                    "(expected 'on' or 'off')")
        if mode == "off":
            if budget:
                raise DynamicShapeError(
                    "DYN003", "token_budget requires seq_buckets (the packing plan "
                    "is defined per bucket ladder)")
            return None
        if cm.loss_type is not LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            raise DynamicShapeError(
                "DYN003", "seq_buckets needs token-level sparse-CE labels (the row "
                "lengths come from their -1 padding)")
        lengths = row_lengths(y_arr)
        seq_dim = y_arr.shape[1]
        hi = int(cfg.seq_bucket_max or 0) or seq_dim
        ladder = resolve_ladder(mode, cfg.seq_bucket_min, min(hi, seq_dim))
        # the loaders that carry the sequence axis: dim 1 matching the
        # labels' (tokens, positions, labels); feature inputs keep theirs
        seq_axes = tuple(l.data.ndim >= 2 and l.data.shape[1] == seq_dim for l in loaders)
        pad_values = tuple([0] * (len(loaders) - 1) + [-1])
        self._resolved_ladder = ladder
        self._resolved_token_budget = budget
        # every packed row count is a multiple of the data degree, so each
        # packed batch splits over the data axis (the JAX package's rule)
        quantum = cm.mesh.degree(DATA_AXIS) if cm.mesh is not None else 1
        return PackingSpec(ladder=ladder, token_budget=budget,
                           batch_size=loaders[0].batch_size, quantum=quantum,
                           pad_max=(pad_max == "on"), seq_axes=seq_axes,
                           pad_values=pad_values), lengths

    def _loader_group(self, xs, y, batch_size: int, shuffle: bool) -> DataLoaderGroup:
        """One loader per input plus the label loader (sparse-CE labels
        reshaped to (N, -1) int32 once, on the host); under
        ``seq_buckets`` the group carries the packing spec."""
        cm = self.compiled
        # a pipeline engine takes the global batch on every rank
        rows = (lambda i: slice(None)) if self.pipelined is not None else cm.batch_rows
        loaders = [SingleDataLoader(np.asarray(a), batch_size, cm.device, rows(i))
                   for i, a in enumerate(xs)]
        y_arr = np.asarray(y)
        _check_label(cm, y_arr.shape)
        if cm.loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            y_arr = y_arr.reshape(y_arr.shape[0], -1).astype(np.int32)
        loaders.append(SingleDataLoader(y_arr, batch_size, cm.device, rows(len(xs))))
        dyn = self._dynamic_shapes_spec(cm, loaders, y_arr)
        if dyn is None:
            return DataLoaderGroup(loaders, seed=self.config.seed, shuffle=shuffle)
        spec, lengths = dyn
        shard = None
        if cm.mesh is not None and self.pipelined is None and spec.quantum > 1:
            shard = (cm.mesh.coords[DATA_AXIS], spec.quantum)
        return DataLoaderGroup(loaders, seed=self.config.seed, shuffle=shuffle,
                               packing=spec, lengths=lengths, shard=shard)

    def _step_loop_knobs(self, cm: CompiledModel, recompile_state=None):
        """(prefetch depth, steps in flight, steps per dispatch). Multi-step
        dispatch is off under a recompile state (it needs every step) and
        under sequence buckets (batches of different shapes do not stack)."""
        cfg = self.config
        depth = max(0, int(cfg.prefetch_depth))
        max_inflight = max(1, int(cfg.max_inflight_steps))
        k = max(1, int(cfg.steps_per_dispatch))
        if (recompile_state is not None or cm.train_k_steps is None
                or cfg.seq_buckets != "off" or self.pipelined is not None):
            k = 1
        return depth, max_inflight, k

    def _advance_window(self, stats, inflight: collections.deque, max_inflight: int,
                        n_steps: int, nbytes: int) -> float:
        """The dispatch-ahead window shared by fit and eval: record the
        occupancy sample and the steps, then, on the card, wait for the
        oldest step once more than ``max_inflight`` are outstanding (host
        memory and the launch queue stay bounded); the CPU runs each step
        to its end anyway. Returns the seconds the host waited."""
        stats.record_inflight(len(inflight))
        stats.record_steps(n_steps, nbytes)
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        # on the CPU a finished step holds the window's slot all the same,
        # so the occupancy series reads as the JAX package's
        inflight.append(ev)
        waited = 0.0
        while len(inflight) > max_inflight:
            done = inflight.popleft()
            if done is not None:
                t0 = time.perf_counter()
                done.synchronize()
                waited += time.perf_counter() - t0
        return waited

    @staticmethod
    def _step_loop_profile(epoch_records, depth, max_inflight, k) -> dict:
        total_steps = sum(r["steps"] for r in epoch_records)
        total_wall = sum(r["wall_s"] for r in epoch_records)
        return {"epochs": epoch_records,
                "steps_per_s": round(total_steps / total_wall, 3) if total_wall > 0 else 0.0,
                "prefetch_depth": depth, "max_inflight_steps": max_inflight,
                "steps_per_dispatch": k}

    def _buckets_profile(self, group: DataLoaderGroup, missed: int, valid: int,
                         total: int) -> dict:
        return {"ladder": list(self._resolved_ladder),
                "token_budget": self._resolved_token_budget,
                "pad_max": group.packing.pad_max, "new_compiles": missed,
                "known_shapes": len(self.compiled._seen_shapes),
                "padded_token_fraction": round(1.0 - valid / max(1, total), 6)}

    def _resume_setup(self, guard, resume_from: Optional[str], verbose: bool):
        """Open the checkpoint manager (periodic checkpoints or a resume)
        and, with ``resume_from``, restore the newest intact step (payload
        and sidecar): params, optimizer state, iteration, the dropout
        counter, lr and the guard's state. Returns (manager, interval,
        start epoch, steps to skip in it); an empty directory starts fresh."""
        from .checkpoint import (CheckpointManager, CheckpointTopologyError,
                                 MultiHostCheckpointManager, _process_count, is_multihost_dir)

        cfg = self.config
        interval = max(0, int(cfg.checkpoint_interval_steps or 0))
        mgr = None
        start_epoch = skip_steps = 0
        if interval or resume_from:
            ckpt_dir = resume_from or cfg.checkpoint_dir or os.path.join(".ffcache", "ckpt")
            keep = max(1, int(cfg.checkpoint_max_to_keep or 3))
            if _process_count() > 1 or is_multihost_dir(ckpt_dir):
                # a cohort (or a resized relaunch reading a cohort's
                # directory): each rank's shard and rank 0's manifest
                mgr = MultiHostCheckpointManager(
                    ckpt_dir, max_to_keep=keep, barrier_timeout_s=cfg.checkpoint_barrier_timeout_s)
            else:
                mgr = CheckpointManager(ckpt_dir, max_to_keep=keep)
        if resume_from and mgr.latest_step() is not None:
            try:
                step = mgr.restore(self, require_extra=True)
            except CheckpointTopologyError as e:
                if not cfg.elastic_resume:
                    raise
                print(f"[resume] topology changed ({e}); performing the elastic "
                      f"portable restore", file=sys.stderr, flush=True)
                step = mgr.restore_elastic(self)
            extra = mgr.restore_extra(step) or {}
            self._rng_counter = int(extra.get("rng_counter", self._rng_counter))
            lr = extra.get("lr")
            if lr is not None:
                self.set_learning_rate(float(lr))
            if guard is not None:
                guard.load_state(extra.get("guard"))
            start_epoch = int(extra.get("epoch", 0))
            skip_steps = int(extra.get("step_in_epoch", 0))
            metrics_registry().counter("checkpoint.resumes").inc()
            if verbose:
                print(f"[resume] restored step {step} from {mgr.directory} (epoch "
                      f"{start_epoch}, step-in-epoch {skip_steps})", flush=True)
        return mgr, interval, start_epoch, skip_steps

    def _save_resume_checkpoint(self, mgr, epoch: int, steps_in_epoch: int, guard) -> None:
        """A full-resume checkpoint: params and optimizer state, and in the
        sidecar the loop's position (epoch, step in epoch, the dropout
        counter, lr, the guard's state) with the topology stamp."""
        from .checkpoint import topology_signature

        cm = self.compiled
        opt = self.optimizer
        lr = getattr(opt, "lr", getattr(opt, "alpha", None))
        extra = {
            "schema": 1,
            "epoch": int(epoch),
            "step_in_epoch": int(steps_in_epoch),
            "rng_counter": int(self._rng_counter),
            "lr": float(lr) if lr is not None else None,
            "guard": guard.state() if guard is not None else None,
            "topology": topology_signature(cm.device, mesh=cm.mesh),
            **cm.resume_state(),
        }
        mgr.save(self, cm.iteration, extra=extra)
        metrics_registry().counter("checkpoint.saves").inc()

    def fit(self, x: Union[np.ndarray, List[np.ndarray]], y: np.ndarray,
            batch_size: Optional[int] = None, epochs: Optional[int] = None,
            shuffle: bool = True, verbose: bool = True, recompile_state=None,
            guard=None, resume_from: Optional[str] = None) -> List[PerfMetrics]:
        """Train ``epochs`` epochs (default ``config.epochs``); returns one
        :class:`PerfMetrics` per epoch, its sums kept on the device until
        the epoch's end.

        ``guard`` (:class:`~flexflow_tpu_torch.runtime.guard.TrainingGuard`):
        an epoch whose loss sum is not finite rolls back to the last
        healthy snapshot with the lr backed off; past the budget
        :class:`~flexflow_tpu_torch.runtime.guard.DivergenceError`.
        ``config.checkpoint_interval_steps`` > 0 saves a full resume
        checkpoint every N steps (after the guard's check);
        ``resume_from=dir`` restores the newest intact one and replays the
        loop from there, with the same shuffles, dropout keys and batch
        boundaries, so the resumed run's params equal the uninterrupted
        run's. ``recompile_state``
        (:class:`~flexflow_tpu_torch.runtime.recompile.RecompileState`)
        is checked after every step. The step-loop record lands in
        ``self.fit_profile``."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        self._training_model()
        tr = configure_tracer(self.config)
        # mistyped observability modes fail before training, not after
        from ..obs.attribution import attribution_mode
        from ..obs.cohort import cohort_obs_mode
        from ..obs.costcorpus import corpus_mode
        from ..obs.divergence import divergence_mode
        from ..obs.ledger import ledger_mode
        from ..obs.server import configure_obs_server
        from ..obs.watchdog import beat as wd_beat
        from ..obs.watchdog import configure_watchdog

        divergence_mode(self.config)
        ledger_mode(self.config)
        attribution_mode(self.config)
        corpus_mode(self.config)
        if cohort_obs_mode(self.config) == "on":
            # the fit.step spans are the cross-rank skew's input
            configure_tracer(enabled=True)
        configure_faults(self.config)
        configure_obs_server(self.config)
        # config.watchdog="on" arms the stall monitor; the loop below beats
        # it through the Prefetcher's watched section and once a step
        configure_watchdog(self.config)
        self._maybe_playoff(xs, y, batch_size or self.config.batch_size)
        cm = self._training_model()
        if guard is not None and self.pipelined is not None:
            raise ValueError("TrainingGuard does not support pipelined training")
        epochs = epochs or self.config.epochs
        group = self._loader_group(xs, y, batch_size or self.config.batch_size, shuffle)
        depth, max_inflight, k = self._step_loop_knobs(cm, recompile_state)
        dyn = group.packing is not None
        bucket_missed = tok_valid = tok_total = 0
        ckpt_mgr, ckpt_interval, start_epoch, skip_steps = self._resume_setup(
            guard, resume_from, verbose)
        steps_since_ckpt = 0
        history: List[PerfMetrics] = []
        epoch_records: List[dict] = []
        # the most recent step's loss, read by the recompile trigger one
        # step late so the read finds it finished
        prev_loss = None
        if guard is not None:
            guard.ensure_snapshot(self)  # a first-epoch divergence rolls back too
        if start_epoch:
            # replay the finished epochs' shuffles: the resume epoch draws
            # the permutation the original run drew
            group.advance_epochs(start_epoch)
        for epoch in range(epochs):
            if epoch < start_epoch:
                continue
            stats = EpochThroughput()
            pm = PerfMetrics()
            last_loss = None
            loss_accum = None  # on the device; a NaN in any batch survives
            inflight: collections.deque = collections.deque()
            steps_in_epoch = skip_steps if epoch == start_epoch else 0
            pf = Prefetcher(group, depth, steps_per_item=k, stats=stats)
            for nk, batch in pf.epoch(skip=steps_in_epoch):
                # a span a step: host dispatch and window control
                ts = tr.now() if tr.enabled else 0.0
                if nk > 1:
                    rngs = [self._next_rng() for _ in range(nk)]
                    cm.params, cm.opt_state, losses, pm.pending = cm.train_k_steps(
                        cm.params, cm.opt_state, rngs, *batch,
                        seq_length=self.iter_config.seq_length, fold_from=pm.pending)
                    loss, bm = losses[-1], None
                    guard_add = losses.sum() if guard is not None else None
                else:
                    sl = self.iter_config.seq_length
                    if dyn:
                        # each (rows, width) is its own dispatch shape; an
                        # unseen one is counted
                        rows, sl = batch[-1].shape[0], batch[-1].shape[1]
                        if cm.note_dispatch_shape("train", rows, sl):
                            bucket_missed += 1
                            metrics_registry().counter("fit.bucket_compiles").inc()
                    if self.pipelined is not None:
                        loss, bm = self.pipelined.train_step(self._next_rng(), batch[:-1],
                                                             batch[-1])
                    else:
                        cm.params, cm.opt_state, loss, bm = cm.train_step(
                            cm.params, cm.opt_state, self._next_rng(), *batch, seq_length=sl)
                    guard_add = loss
                if _fx.active() and _fx.fire("train.nan_loss") is not None:
                    # poisons the guard's accumulator as a real overflow would
                    loss = loss * float("nan")
                    if guard_add is not None:
                        guard_add = guard_add * float("nan")
                if bm is not None:
                    pm.accumulate(bm)
                last_loss = loss
                if guard is not None:
                    # the sum, not the last value: a mid-epoch NaN must not
                    # hide behind a finite last batch
                    loss_accum = guard_add if loss_accum is None else loss_accum + guard_add
                waited = self._advance_window(stats, inflight, max_inflight, nk,
                                              group.batch_nbytes * nk)
                wd_beat("fit.loop")
                cm.iteration += nk
                steps_in_epoch += nk
                if ckpt_interval and ckpt_mgr is not None:
                    steps_since_ckpt += nk
                    if steps_since_ckpt >= ckpt_interval:
                        steps_since_ckpt = 0
                        # with a guard, check the partial epoch first: a
                        # diverged snapshot or checkpoint would poison the
                        # rollback point and the resume
                        healthy = True
                        if guard is not None and loss_accum is not None:
                            healthy = bool(torch.isfinite(loss_accum).item())
                        if healthy:
                            if guard is not None:
                                guard.snapshot(self, scope="interval")
                            self._save_resume_checkpoint(ckpt_mgr, epoch, steps_in_epoch,
                                                         guard)
                if _fx.active():
                    # a slow step, then a hard kill after the checkpoint
                    # above ("kill at step N" leaves steps <= N)
                    rule = _fx.fire("train.stall")
                    if rule is not None:
                        time.sleep(float(rule.get("stall_s", 1.0)))
                    rule = _fx.fire("train.kill")
                    if rule is not None:
                        sys.stdout.flush()
                        sys.stderr.flush()
                        os._exit(int(rule.get("exit_code", 41)))
                    # a cohort's chaos: a slow peer stalls its heartbeat
                    # (the supervisor's hang detector), a killed peer dies
                    # after the checkpoint block, as train.kill
                    rule = _fx.fire("multihost.slow_peer")
                    if rule is not None:
                        time.sleep(float(rule.get("stall_s", 2.0)))
                    rule = _fx.fire("multihost.peer_kill")
                    if rule is not None:
                        sys.stdout.flush()
                        sys.stderr.flush()
                        os._exit(int(rule.get("exit_code", 43)))
                if recompile_state is not None:
                    from .recompile import recompile_on_condition

                    ci = max(1, recompile_state.check_interval)
                    if (recompile_state.iteration + 1) % ci == 0:
                        src = prev_loss if prev_loss is not None else loss
                        recompile_state.last_metric = float(src)
                    with span("fit.recompile_check", cat="fit"):
                        fired = recompile_on_condition(self, recompile_state)
                    if fired:
                        cm = self.compiled
                prev_loss = loss
                if tr.enabled:
                    # the window's wait rides the span: attribution leaves it
                    # out of host dispatch (the card was busy, not the host)
                    args = {"k": nk}
                    if waited:
                        args["wait_s"] = round(waited, 9)
                    tr.complete("fit.step", ts, tr.now() - ts, cat="fit", args=args)
            with span("fit.host_sync", cat="fit", epoch=epoch):
                pm.flush()  # the epoch's one read of the metric sums
            if dyn:
                v, t = group.epoch_token_stats
                stats.record_tokens(v, t)
                tok_valid += v
                tok_total += t
            epoch_records.append(stats.finish())
            if self.config.profiling:
                r = epoch_records[-1]
                print(f"[fit] epoch {epoch}: {r['steps_per_s']:.1f} steps/s"
                      f" input_wait {r['input_wait_s']*1e3:.1f}ms"
                      f" occupancy {r['dispatch_ahead_occupancy']:.2f}"
                      f" depth_hist {r['queue_depth_hist']}", flush=True)
            if guard is not None:
                accum = float(loss_accum) if loss_accum is not None else 0.0
                if not np.isfinite(accum):
                    from .guard import DivergenceError

                    if not guard.recover(self, verbose=verbose):
                        raise DivergenceError(
                            f"epoch {epoch} loss sum {accum} and the guard's restore "
                            f"budget is exhausted")
                    history.append(pm)
                    continue
                guard.snapshot(self)
            if verbose:
                lv = float(last_loss) if last_loss is not None else float("nan")
                print(f"epoch {epoch}: loss {lv:.4f}  {pm.report(cm.metrics)}", flush=True)
            history.append(pm)
        self.fit_profile = self._step_loop_profile(epoch_records, depth, max_inflight, k)
        if dyn:
            self.fit_profile["buckets"] = self._buckets_profile(
                group, bucket_missed, tok_valid, tok_total)
        if guard is not None:
            self.fit_profile["guard"] = guard.report()
        if self.pipelined is not None:
            bs = batch_size or self.config.batch_size
            self.fit_profile["pipeline"] = self.pipelined.profile(
                bs // self.pipelined.cfg.num_microbatches)
            if self.config.profiling:
                p = self.fit_profile["pipeline"]
                print(f"[fit] pipeline {p['engine']}:{p['schedule']} "
                      f"bubble {p['bubble_fraction']:.3f} "
                      f"dispatches/step {p['dispatches_per_step']}", flush=True)
            # every stage's trained params into the compiled model
            self.pipelined.sync_to(cm)
        self._fit_tail()
        return history

    def _fit_tail(self) -> None:
        """The observability tail of a fit, in the JAX package's order:
        divergence, attribution (after divergence, so the per-op rows
        join), the advisor, the cost corpus, the ledger record and the
        cohort export."""
        from ..obs.advisor import maybe_advise
        from ..obs.attribution import format_phase_table, maybe_attribute
        from ..obs.cohort import maybe_export_cohort
        from ..obs.costcorpus import maybe_collect_corpus
        from ..obs.divergence import maybe_record_divergence
        from ..obs.ledger import record_fit

        maybe_record_divergence(self)
        maybe_attribute(self)
        fp = self.fit_profile or {}
        if self.config.profiling and fp.get("attribution"):
            print(format_phase_table(fp["attribution"]), flush=True)
        maybe_advise(self)
        if self.config.profiling and fp.get("advice"):
            top = fp["advice"]["suggestions"][0]
            print(f"[advise] {top['phase']} -> {top['knob']}="
                  f"{top['proposed']} (expected "
                  f"-{top['expected']['step_delta_frac'] * 100:.1f}% "
                  f"step time, {top['expected']['basis']})", flush=True)
        maybe_collect_corpus(self)
        record_fit(self)
        maybe_export_cohort(self)

    def eval(self, x, y, batch_size: Optional[int] = None,
             verbose: bool = True) -> PerfMetrics:
        """One pass over the batches (the packed plan under
        ``seq_buckets``, unseen shapes counted on ``eval.bucket_compiles``)
        without updates, through fit's Prefetcher and window; returns the
        accumulated :class:`PerfMetrics`, the record in
        ``self.eval_profile``."""
        cm = self.compiled
        if cm is None or cm.eval_step is None:
            raise RuntimeError("compile() with a loss before eval()")
        tr = configure_tracer(self.config)
        from ..obs.ledger import ledger_mode, record_fit
        from ..obs.watchdog import beat as wd_beat
        from ..obs.watchdog import configure_watchdog

        ledger_mode(self.config)  # a typo fails before the eval, not after
        configure_watchdog(self.config)
        xs = x if isinstance(x, (list, tuple)) else [x]
        group = self._loader_group(xs, y, batch_size or self.config.batch_size, False)
        depth, max_inflight, _ = self._step_loop_knobs(cm)
        dyn = group.packing is not None
        bucket_missed = 0
        stats = EpochThroughput(prefix="eval")  # the eval.* registry series
        pm = PerfMetrics()
        inflight: collections.deque = collections.deque()
        for _nk, batch in Prefetcher(group, depth, stats=stats).epoch(reshuffle=False):
            ts = tr.now() if tr.enabled else 0.0
            sl = self.iter_config.seq_length
            if dyn:
                rows, sl = batch[-1].shape[0], batch[-1].shape[1]
                if cm.note_dispatch_shape("eval", rows, sl):
                    bucket_missed += 1
                    metrics_registry().counter("eval.bucket_compiles").inc()
            if self.pipelined is not None:
                _, _, bm = self.pipelined.eval_step(batch[:-1], batch[-1])
            else:
                _, _, bm = cm.eval_step(cm.params, *batch, seq_length=sl)
            pm.accumulate(bm)
            self._advance_window(stats, inflight, max_inflight, 1, group.batch_nbytes)
            wd_beat("eval.loop")
            if tr.enabled:
                tr.complete("eval.step", ts, tr.now() - ts, cat="eval")
        with span("eval.host_sync", cat="eval"):
            pm.flush()
        if dyn:
            stats.record_tokens(*group.epoch_token_stats)
        self.eval_profile = self._step_loop_profile([stats.finish()], depth, max_inflight, 1)
        if dyn:
            self.eval_profile["buckets"] = self._buckets_profile(
                group, bucket_missed, *group.epoch_token_stats)
        if self.config.profiling:
            rec = self.eval_profile["epochs"][0]
            print(f"[eval] {rec['steps_per_s']:.1f} steps/s input_wait "
                  f"{rec['input_wait_s']*1e3:.1f}ms occupancy "
                  f"{rec['dispatch_ahead_occupancy']:.2f}", flush=True)
        if verbose:
            print(f"eval: {pm.report(cm.metrics)}", flush=True)
        record_fit(self, kind="eval")
        return pm

    # ---- manual-loop verbs ------------------------------------------------
    def set_batch(self, xs: Sequence[np.ndarray], y: Optional[np.ndarray] = None) -> None:
        if not isinstance(xs, (list, tuple)):  # single-input convenience
            xs = [xs]
        if y is not None and self.compiled is not None:
            _check_label(self.compiled, np.shape(y))
        batch = list(xs) + ([y] if y is not None else [])
        cm = self.compiled
        whole = cm is None or self.pipelined is not None
        rows = [slice(None) if whole else cm.batch_rows(i) for i in range(len(batch))]
        if y is not None and not whole:
            rows[-1] = cm.batch_rows(len(cm.input_tensors))
        self._cur_batch = [torch.as_tensor(np.asarray(a)[r], device=self.device)
                           for a, r in zip(batch, rows)]

    def forward(self, seq_length: Optional[int] = None) -> torch.Tensor:
        """The current batch's logits; ``seq_length`` truncates the
        declared sequence dims for this iteration (default
        ``iter_config.seq_length``)."""
        cm = self.compiled
        if cm is None or self._cur_batch is None:
            raise RuntimeError("compile() and set_batch() before forward()")
        sl = self.iter_config.seq_length if seq_length is None else seq_length
        if self.pipelined is not None:
            return self.pipelined.forward_only(self._cur_batch[: len(cm.input_tensors)])
        return cm.forward_fn(cm.params, *self._cur_batch[: len(cm.input_tensors)],
                             seq_length=sl)

    def zero_gradients(self) -> None:
        """Gradients are computed afresh by each backward(); this drops any
        that update() has not consumed."""
        self._cur_grads = None

    def backward(self, seq_length: Optional[int] = None) -> None:
        """The current batch's gradients (set_batch with a label first),
        with no regularizer penalty, as the JAX package's ``grad_step``.
        The manual verbs do not advance BatchNorm's running statistics:
        only ``fit``'s training steps write them."""
        cm = self._training_model()
        if self._cur_batch is None or len(self._cur_batch) != len(cm.input_tensors) + 1:
            raise RuntimeError("set_batch(xs, y) with a label before backward()")
        sl = self.iter_config.seq_length if seq_length is None else seq_length
        self._cur_grads = cm.grad_step(cm.params, self._next_rng(), *self._cur_batch,
                                       seq_length=sl)

    def update(self) -> None:
        """One optimizer step with the gradients of the last backward()."""
        cm = self._training_model()
        if self._cur_grads is None:
            raise RuntimeError("backward() before update()")
        cm.params, cm.opt_state = cm.update_fn(cm.params, self._cur_grads, cm.opt_state)
        self._cur_grads = None

    def set_learning_rate(self, lr: float) -> None:
        """Change the optimizer's learning rate (``alpha`` for Adam); the
        next step reads it."""
        opt = self.optimizer
        if hasattr(opt, "lr"):
            opt.lr = float(lr)
        elif hasattr(opt, "alpha"):
            opt.alpha = float(lr)
        else:
            raise ValueError("optimizer has no learning-rate attribute")
        if self.pipelined is not None:
            self.pipelined.refresh_updates()

    def _next_rng(self) -> int:
        """The next training step's dropout key."""
        self._rng_counter += 1
        return self._rng_counter

    def save_checkpoint(self, path: str, step: int = 0) -> None:
        """Save the params, the optimizer state and the iteration under
        ``path`` as step ``step`` (``runtime/checkpoint.py``)."""
        from .checkpoint import save_checkpoint

        save_checkpoint(self, path, step)

    def load_checkpoint(self, path: str, step: Optional[int] = None) -> int:
        """Restore step ``step`` (default the newest intact one) from
        ``path`` into the compiled model; returns the step."""
        from .checkpoint import load_checkpoint

        return load_checkpoint(self, path, step)

    def get_perf_metrics(self) -> PerfMetrics:
        """An empty PerfMetrics, as the JAX package returns: fit() and
        eval() return the accumulated ones."""
        return PerfMetrics()


def _clone_tree(tree):
    """A copy of a tree of dicts, lists and tensors (params, optimizer
    state) with every tensor cloned."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _copy_tree_(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s in place (same structure)."""
    if isinstance(dst, dict):
        for k in dst:
            if isinstance(dst[k], (dict, list, tuple, torch.Tensor)):
                _copy_tree_(dst[k], src[k])
            else:
                dst[k] = src[k]
    elif isinstance(dst, (list, tuple)):
        for d, s_ in zip(dst, src):
            _copy_tree_(d, s_)
    elif isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(src)


def _check_label(cm: CompiledModel, shape: Tuple[int, ...]) -> None:
    """Dense losses take labels of the logits' per-sample shape; another
    shape would broadcast against the logits and train on the wrong loss.
    Sparse cross-entropy labels are class indices, one per sample or per
    position, and are reshaped by the loss."""
    if cm.label_tensor is None or cm.loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        return
    want = tuple(cm.label_tensor.dims[1:])
    if tuple(shape[1:]) != want:
        raise ValueError(f"labels of per-sample shape {tuple(shape[1:])}; the "
                         f"{cm.loss_type.name} loss takes {want}")


def load_numpy_params(ff: FFModel,
                      tree: Mapping[str, Mapping[str, np.ndarray]]) -> None:
    """Copy a JAX-package params tree (``{op_name: {weight_name: array}}``,
    as ``np.asarray`` gives it from ``ff.compiled.params``) into a compiled
    port model. Op names, weight names, shapes and dtypes must match; the
    layouts are the same in both packages, so this is a checked copy. It
    copies into the existing tensors, so an optimizer state built for them
    stays valid. Under a mesh the arrays are whole and each rank copies its
    blocks."""
    cm = ff.compiled
    if cm is None:
        raise RuntimeError("compile() the port model before loading params")
    if set(tree) != set(cm.params):
        raise ValueError(
            f"op names differ: missing {sorted(set(cm.params) - set(tree))}, "
            f"unexpected {sorted(set(tree) - set(cm.params))}")
    for op_name, weights in cm.params.items():
        src = tree[op_name]
        if set(src) != set(weights):
            raise ValueError(
                f"{op_name}: weight names {sorted(src)} vs {sorted(weights)}")
        for w_name, cur in weights.items():
            arr = np.asarray(src[w_name])
            want = cm.weight_layout(op_name, w_name).sizes if cm.mesh else tuple(cur.shape)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"{op_name}.{w_name}: shape {arr.shape} vs {tuple(want)}")
            if DataType(arr.dtype.name).to_torch() != cur.dtype:
                raise ValueError(
                    f"{op_name}.{w_name}: dtype {arr.dtype} vs {cur.dtype}")
    with torch.no_grad():
        for op_name, weights in cm.params.items():
            for w_name, cur in weights.items():
                arr = np.asarray(tree[op_name][w_name])
                if cm.mesh is not None:
                    arr = arr[cm.mesh.local_slices(cm.weight_layout(op_name, w_name))]
                cur.copy_(torch.tensor(arr))
