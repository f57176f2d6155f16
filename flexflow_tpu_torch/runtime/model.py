"""FFModel: the user-facing model API.

PyTorch counterpart of ``flexflow_tpu/runtime/model.py``: the graph calls
the port's slices need (``create_tensor``, ``dense``, ``conv2d``,
``pool2d``, ``batch_norm``, ``multihead_attention``, ``batch_matmul``,
``softmax``, ``layer_norm``, the elementwise binary and unary verbs, the
structural verbs from ``flat`` to ``constant``, ``mean`` and
``reduce_sum``, ``dropout``, ``embedding``, ``gather``, the recurrent
``lstm``/``gru``/``rnn`` and the MoE family up to ``moe``), ``compile`` with an optimizer, a loss and
metrics, ``fit``/``eval`` over the numpy data loader, the manual
``set_batch``/``forward``/``zero_gradients``/``backward``/``update``
verbs, and :func:`load_numpy_params` to carry the JAX package's params
across. Each training step gets the next value of a counter as its
dropout key, as the JAX package folds its counter into its root key.
``compile()`` and ``fit()`` arm the config's span tracer and fault plan
(``FFConfig.trace``, ``FFConfig.fault_plan``), ``eval()`` its tracer.
Training guards, resume, checkpoints, prefetching, multi-step dispatch
and the rest of the observability hooks wait for later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import ops as _ops  # noqa: F401  (registers the op library)
from ..config import FFConfig
from ..core.layer import Layer
from ..core.op import create_op
from ..core.parallel_tensor import ParallelTensorShape
from ..core.tensor import Tensor
from ..ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType, MetricsType,
                       OpType, PoolType)
from ..obs.trace import configure_tracer
from .compiler import CompiledModel, Params, compile_model
from .dataloader import DataLoaderGroup, SingleDataLoader
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
              name: Optional[str] = None) -> Tensor:
        attrs = dict(out_dim=out_dim, activation=activation, use_bias=use_bias,
                     kernel_initializer=kernel_initializer,
                     bias_initializer=bias_initializer)
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
        """A @ B over matching batch dims. The seq-length dims are kept as
        attributes and have no effect (queue A9)."""
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
        ``FFConfig.learning_rate``/``weight_decay`` defaults)."""
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
        self.compiled = compile_model(self.config, self.layers, self._used_inputs(),
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

    def _loader_group(self, xs, y, batch_size: int, shuffle: bool) -> DataLoaderGroup:
        """One loader per input plus the label loader (sparse-CE labels
        reshaped to (N, -1) int32 once, on the host)."""
        cm = self.compiled
        loaders = [SingleDataLoader(np.asarray(a), batch_size, cm.device) for a in xs]
        y_arr = np.asarray(y)
        _check_label(cm, y_arr.shape)
        if cm.loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            y_arr = y_arr.reshape(y_arr.shape[0], -1).astype(np.int32)
        loaders.append(SingleDataLoader(y_arr, batch_size, cm.device))
        return DataLoaderGroup(loaders, seed=self.config.seed, shuffle=shuffle)

    def fit(self, x: Union[np.ndarray, List[np.ndarray]], y: np.ndarray,
            batch_size: Optional[int] = None, epochs: Optional[int] = None,
            shuffle: bool = True, verbose: bool = True) -> List[PerfMetrics]:
        """Train ``epochs`` epochs (default ``config.epochs``) over whole
        batches of ``x``/``y``; returns one :class:`PerfMetrics` per epoch.
        Metrics stay on the device until each epoch's end."""
        cm = self._training_model()
        configure_tracer(self.config)
        configure_faults(self.config)
        xs = x if isinstance(x, (list, tuple)) else [x]
        group = self._loader_group(xs, y, batch_size or self.config.batch_size, shuffle)
        history: List[PerfMetrics] = []
        for epoch in range(epochs or self.config.epochs):
            group.reset(reshuffle=True)
            pm = PerfMetrics()
            loss = None
            for _ in range(group.num_batches):
                cm.params, cm.opt_state, loss, bm = cm.train_step(
                    cm.params, cm.opt_state, self._next_rng(), *group.next_batch())
                pm.accumulate(bm)
            pm.flush()
            if verbose:
                lv = loss.item() if loss is not None else float("nan")
                print(f"epoch {epoch}: loss {lv:.4f}  {pm.report(cm.metrics)}", flush=True)
            history.append(pm)
        return history

    def eval(self, x, y, batch_size: Optional[int] = None,
             verbose: bool = True) -> PerfMetrics:
        """One pass over whole batches without updates; returns the
        accumulated :class:`PerfMetrics`."""
        cm = self.compiled
        if cm is None or cm.eval_step is None:
            raise RuntimeError("compile() with a loss before eval()")
        configure_tracer(self.config)
        xs = x if isinstance(x, (list, tuple)) else [x]
        group = self._loader_group(xs, y, batch_size or self.config.batch_size, False)
        group.reset(reshuffle=False)
        pm = PerfMetrics()
        for _ in range(group.num_batches):
            _, _, bm = cm.eval_step(cm.params, *group.next_batch())
            pm.accumulate(bm)
        pm.flush()
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

    def forward(self) -> torch.Tensor:
        cm = self.compiled
        if cm is None or self._cur_batch is None:
            raise RuntimeError("compile() and set_batch() before forward()")
        return cm.forward_fn(cm.params, *self._cur_batch[: len(cm.input_tensors)])

    def zero_gradients(self) -> None:
        """Gradients are computed afresh by each backward(); this drops any
        that update() has not consumed."""
        self._cur_grads = None

    def backward(self) -> None:
        """The current batch's gradients (set_batch with a label first).
        The manual verbs do not advance BatchNorm's running statistics:
        only ``fit``'s training steps write them."""
        cm = self._training_model()
        if self._cur_batch is None or len(self._cur_batch) != len(cm.input_tensors) + 1:
            raise RuntimeError("set_batch(xs, y) with a label before backward()")
        self._cur_grads = cm.grad_step(cm.params, self._next_rng(), *self._cur_batch)

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
