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
``checkpoint_interval_steps`` and ``resume_from=``, recompile-on-condition
(``recompile_state=``) and the fault sites ``train.nan_loss``,
``train.stall`` and ``train.kill``. The stall watchdog, the per-epoch
throughput series and the ledger records are ROADMAP queue A10.
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
from ..core.op import create_op
from ..core.parallel_tensor import ParallelTensorShape
from ..core.tensor import Tensor
from ..ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType, MetricsType,
                       OpType, PoolType)
from ..obs.metrics import metrics_registry
from ..obs.trace import configure_tracer
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
              kernel_regularizer=None, name: Optional[str] = None) -> Tensor:
        """``kernel_regularizer`` (``keras.regularizers``) adds its penalty
        on the kernel to the training loss."""
        attrs = dict(out_dim=out_dim, activation=activation, use_bias=use_bias,
                     kernel_initializer=kernel_initializer,
                     bias_initializer=bias_initializer)
        if kernel_regularizer is not None:
            attrs["kernel_regularizer"] = kernel_regularizer
        return self._infer_and_add(OpType.LINEAR, [input], attrs, name)

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               activation: ActiMode = ActiMode.NONE, groups: int = 1,
               use_bias: bool = True, kernel_initializer=None, bias_initializer=None,
               name: Optional[str] = None,
               strategy: Optional[Dict[str, str]] = None) -> Tensor:
        """NCHW convolution with an OIHW kernel. A ``strategy`` raises:
        sharding it needs a mesh (queue A7)."""
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
                            causal: bool = False, name=None) -> Tensor:
        attrs = dict(embed_dim=embed_dim, num_heads=num_heads,
                     kdim=kdim or embed_dim, vdim=vdim or embed_dim,
                     dropout=dropout, bias=bias,
                     kernel_initializer=kernel_initializer, causal=causal)
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
        trailing multi-hot dim. A ``strategy`` raises: sharding the table
        needs a mesh (queue A7)."""
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
        """GroupBy emitting one stacked (n, capacity, d) tensor. A pinned
        ``strategy={"expert": axis}`` raises: the expert-parallel path
        needs a mesh (queue A7)."""
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

    # ---- compile ----------------------------------------------------------
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: Optional[Union[LossType, str]] = None,
                metrics: Optional[Sequence[Union[MetricsType, str]]] = None,
                comp_mode: Optional[CompMode] = None,
                logits_tensor: Optional[Tensor] = None) -> None:
        """Compile the graph. With a loss and TRAINING mode (the config's
        ``computation_mode`` unless ``comp_mode`` says otherwise) the model
        gets its training steps; without an optimizer it trains with the
        JAX package's default, SGD at lr 0.01 and weight decay 1e-4 (its
        ``FFConfig.learning_rate``/``weight_decay`` defaults). Under
        ``config.perform_fusion`` chains of weightless unary ops compile as
        one ``FusedOp`` each, the logits never fused away."""
        configure_tracer(self.config)
        configure_faults(self.config)  # a malformed plan fails before any work
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
        layers = self.layers
        if self.config.perform_fusion:
            from ..ops.fused import apply_fusion

            layers = apply_fusion(layers, {logits.tensor_id})
        self.compiled = compile_model(self.config, layers, self._used_inputs(),
                                      logits, self.optimizer, loss_type, mtypes,
                                      comp_mode)

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
        return PackingSpec(ladder=ladder, token_budget=budget,
                           batch_size=loaders[0].batch_size, quantum=1,
                           pad_max=(pad_max == "on"), seq_axes=seq_axes,
                           pad_values=pad_values), lengths

    def _loader_group(self, xs, y, batch_size: int, shuffle: bool) -> DataLoaderGroup:
        """One loader per input plus the label loader (sparse-CE labels
        reshaped to (N, -1) int32 once, on the host); under
        ``seq_buckets`` the group carries the packing spec."""
        cm = self.compiled
        loaders = [SingleDataLoader(np.asarray(a), batch_size, cm.device) for a in xs]
        y_arr = np.asarray(y)
        _check_label(cm, y_arr.shape)
        if cm.loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            y_arr = y_arr.reshape(y_arr.shape[0], -1).astype(np.int32)
        loaders.append(SingleDataLoader(y_arr, batch_size, cm.device))
        dyn = self._dynamic_shapes_spec(cm, loaders, y_arr)
        if dyn is None:
            return DataLoaderGroup(loaders, seed=self.config.seed, shuffle=shuffle)
        spec, lengths = dyn
        return DataLoaderGroup(loaders, seed=self.config.seed, shuffle=shuffle,
                               packing=spec, lengths=lengths)

    def _step_loop_knobs(self, cm: CompiledModel, recompile_state=None):
        """(prefetch depth, steps in flight, steps per dispatch). Multi-step
        dispatch is off under a recompile state (it needs every step) and
        under sequence buckets (batches of different shapes do not stack)."""
        cfg = self.config
        depth = max(0, int(cfg.prefetch_depth))
        max_inflight = max(1, int(cfg.max_inflight_steps))
        k = max(1, int(cfg.steps_per_dispatch))
        if (recompile_state is not None or cm.train_k_steps is None
                or cfg.seq_buckets != "off"):
            k = 1
        return depth, max_inflight, k

    def _advance_window(self, inflight: collections.deque, max_inflight: int) -> None:
        """The dispatch-ahead window: on the card, wait for the oldest
        step once more than ``max_inflight`` are outstanding (host memory
        and the launch queue stay bounded); the CPU runs each step to its
        end anyway."""
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record()
        inflight.append(ev)
        while len(inflight) > max_inflight:
            inflight.popleft().synchronize()

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
        from .checkpoint import CheckpointManager, CheckpointTopologyError

        cfg = self.config
        interval = max(0, int(cfg.checkpoint_interval_steps or 0))
        mgr = None
        start_epoch = skip_steps = 0
        if interval or resume_from:
            ckpt_dir = resume_from or cfg.checkpoint_dir or os.path.join(".ffcache", "ckpt")
            mgr = CheckpointManager(ckpt_dir,
                                    max_to_keep=max(1, int(cfg.checkpoint_max_to_keep or 3)))
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
            "topology": topology_signature(cm.device),
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
        cm = self._training_model()
        configure_tracer(self.config)
        configure_faults(self.config)
        xs = x if isinstance(x, (list, tuple)) else [x]
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
            t_epoch = time.perf_counter()
            n_steps = 0
            pm = PerfMetrics()
            last_loss = None
            loss_accum = None  # on the device; a NaN in any batch survives
            inflight: collections.deque = collections.deque()
            steps_in_epoch = skip_steps if epoch == start_epoch else 0
            pf = Prefetcher(group, depth, steps_per_item=k)
            for nk, batch in pf.epoch(skip=steps_in_epoch):
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
                self._advance_window(inflight, max_inflight)
                cm.iteration += nk
                steps_in_epoch += nk
                n_steps += nk
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
                if recompile_state is not None:
                    from .recompile import recompile_on_condition

                    ci = max(1, recompile_state.check_interval)
                    if (recompile_state.iteration + 1) % ci == 0:
                        src = prev_loss if prev_loss is not None else loss
                        recompile_state.last_metric = float(src)
                    if recompile_on_condition(self, recompile_state):
                        cm = self.compiled
                prev_loss = loss
            pm.flush()  # the epoch's one read of the metric sums
            epoch_records.append({"steps": n_steps, "wall_s": time.perf_counter() - t_epoch})
            if dyn:
                v, t = group.epoch_token_stats
                tok_valid += v
                tok_total += t
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
        return history

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
        configure_tracer(self.config)
        xs = x if isinstance(x, (list, tuple)) else [x]
        group = self._loader_group(xs, y, batch_size or self.config.batch_size, False)
        depth, max_inflight, _ = self._step_loop_knobs(cm)
        dyn = group.packing is not None
        bucket_missed = 0
        t0 = time.perf_counter()
        n_steps = 0
        pm = PerfMetrics()
        inflight: collections.deque = collections.deque()
        for _nk, batch in Prefetcher(group, depth).epoch(reshuffle=False):
            sl = self.iter_config.seq_length
            if dyn:
                rows, sl = batch[-1].shape[0], batch[-1].shape[1]
                if cm.note_dispatch_shape("eval", rows, sl):
                    bucket_missed += 1
                    metrics_registry().counter("eval.bucket_compiles").inc()
            _, _, bm = cm.eval_step(cm.params, *batch, seq_length=sl)
            pm.accumulate(bm)
            self._advance_window(inflight, max_inflight)
            n_steps += 1
        pm.flush()
        self.eval_profile = self._step_loop_profile(
            [{"steps": n_steps, "wall_s": time.perf_counter() - t0}], depth, max_inflight, 1)
        if dyn:
            self.eval_profile["buckets"] = self._buckets_profile(
                group, bucket_missed, *group.epoch_token_stats)
        if verbose:
            print(f"eval: {pm.report(cm.metrics)}", flush=True)
        return pm

    # ---- manual-loop verbs ------------------------------------------------
    def set_batch(self, xs: Sequence[np.ndarray], y: Optional[np.ndarray] = None) -> None:
        if not isinstance(xs, (list, tuple)):  # single-input convenience
            xs = [xs]
        if y is not None and self.compiled is not None:
            _check_label(self.compiled, np.shape(y))
        batch = list(xs) + ([y] if y is not None else [])
        self._cur_batch = [torch.as_tensor(np.asarray(a), device=self.device)
                           for a in batch]

    def forward(self, seq_length: Optional[int] = None) -> torch.Tensor:
        """The current batch's logits; ``seq_length`` truncates the
        declared sequence dims for this iteration (default
        ``iter_config.seq_length``)."""
        cm = self.compiled
        if cm is None or self._cur_batch is None:
            raise RuntimeError("compile() and set_batch() before forward()")
        sl = self.iter_config.seq_length if seq_length is None else seq_length
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
        cm.params, cm.opt_state = cm.optimizer.update(
            cm.params, self._cur_grads, cm.opt_state, cm.wd_mask)
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
    stays valid."""
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
            if tuple(arr.shape) != tuple(cur.shape):
                raise ValueError(
                    f"{op_name}.{w_name}: shape {arr.shape} vs "
                    f"{tuple(cur.shape)}")
            if DataType(arr.dtype.name).to_torch() != cur.dtype:
                raise ValueError(
                    f"{op_name}.{w_name}: dtype {arr.dtype} vs {cur.dtype}")
    with torch.no_grad():
        for op_name, weights in cm.params.items():
            for w_name, cur in weights.items():
                cur.copy_(torch.tensor(np.asarray(tree[op_name][w_name])))
