"""FFModel: the user-facing model API.

PyTorch counterpart of ``flexflow_tpu/runtime/model.py``, inference only
so far: the graph calls the slice needs (``create_tensor``, ``dense``,
``multihead_attention``), ``compile`` for inference, the manual
``set_batch``/``forward`` verbs, and :func:`load_numpy_params` to carry
the JAX package's params across.
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
from ..ffconst import ActiMode, CompMode, DataType, OpType
from .compiler import CompiledModel, compile_model


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        # raises here, at the entry point, when the config asks for a
        # card that is not there
        self.device = self.config.torch_device()
        self.layers: List[Layer] = []
        self.input_tensors: List[Tensor] = []
        self.compiled: Optional[CompiledModel] = None
        self._cur_batch: Optional[List[torch.Tensor]] = None

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

    # ---- compile ----------------------------------------------------------
    def compile(self, optimizer=None, loss_type=None, metrics=None,
                comp_mode: Optional[CompMode] = None,
                logits_tensor: Optional[Tensor] = None) -> None:
        """Compile for inference. Training (optimizer, loss, metrics)
        arrives with the training slice."""
        if optimizer is not None or loss_type is not None or metrics:
            raise NotImplementedError(
                "the port compiles for inference only so far: no optimizer, "
                "loss or metrics")
        if comp_mode is None:
            comp_mode = self.config.computation_mode
        logits = logits_tensor if logits_tensor is not None else self._final_output()
        self.compiled = compile_model(self.config, self.layers,
                                      self._used_inputs(), logits, comp_mode)

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

    # ---- manual-loop verbs ------------------------------------------------
    def set_batch(self, xs: Sequence[np.ndarray]) -> None:
        if not isinstance(xs, (list, tuple)):  # single-input convenience
            xs = [xs]
        self._cur_batch = [torch.as_tensor(np.asarray(a), device=self.device)
                           for a in xs]

    def forward(self) -> torch.Tensor:
        cm = self.compiled
        if cm is None or self._cur_batch is None:
            raise RuntimeError("compile() and set_batch() before forward()")
        return cm.forward_fn(cm.params, *self._cur_batch[: len(cm.input_tensors)])


def load_numpy_params(ff: FFModel,
                      tree: Mapping[str, Mapping[str, np.ndarray]]) -> None:
    """Copy a JAX-package params tree (``{op_name: {weight_name: array}}``,
    as ``np.asarray`` gives it from ``ff.compiled.params``) into a compiled
    port model. Op names, weight names, shapes and dtypes must match; the
    layouts are the same in both packages, so this is a checked copy."""
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
    for op_name, weights in cm.params.items():
        for w_name in weights:
            weights[w_name] = torch.tensor(np.asarray(tree[op_name][w_name]),
                                           device=cm.device)
