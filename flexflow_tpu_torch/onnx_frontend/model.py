"""ONNX → flexflow_tpu_torch importer.

PyTorch counterpart of ``flexflow_tpu/onnx_frontend/model.py``, handler
for handler. Mirrors the reference's walker design (reference:
python/flexflow/onnx/model.py:56-375 — ``ONNXModel`` dispatches each onnx
node to a ``handleX`` method that calls the FFModel builder). Covered ops
are the set the reference handles (Conv/MaxPool/AveragePool/Gemm/MatMul/
Relu/Softmax/Flatten/Concat/Split/Add/Sub/Mul/Dropout/Reshape/Transpose/
BatchNormalization) plus Gelu/Sigmoid/Tanh. The initializers bind after
``compile`` through :meth:`ONNXModel.copy_weights`, into the port's
params (``torch_frontend.model.set_weight``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ffconst import PoolType


def _require_onnx():
    try:
        import onnx  # noqa: F401

        return onnx
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "the ONNX frontend requires the `onnx` package; it is not "
            "bundled in this environment"
        ) from e


def _attrs(node) -> Dict:
    out = {}
    if not node.attribute:  # no onnx import needed for attribute-less nodes
        return out
    import onnx

    for a in node.attribute:
        out[a.name] = onnx.helper.get_attribute_value(a)
    return out


class ONNXModel:
    """reference: ONNXModel (python/flexflow/onnx/model.py:56)."""

    def __init__(self, filename_or_model):
        onnx = _require_onnx()
        if isinstance(filename_or_model, (str, bytes)):
            self.model = onnx.load(filename_or_model)
        else:
            self.model = filename_or_model
        self.inits: Dict[str, np.ndarray] = {}
        from onnx import numpy_helper

        for init in self.model.graph.initializer:
            self.inits[init.name] = numpy_helper.to_array(init)
        # pending (layer, weight-leaf-name, array-in-FF-layout) recorded by
        # the handlers; bound post-compile by copy_weights() (reference:
        # triton/src/onnx_parser.cc loads initializer weights — without this
        # an imported model runs on random init and returns garbage)
        self.weight_bindings: List[tuple] = []

    def _bind(self, out_tensor, leaf: str, arr) -> None:
        self.weight_bindings.append(
            (out_tensor.owner_layer, leaf, np.asarray(arr)))

    def _init(self, node, i: int, what: str) -> np.ndarray:
        """Fetch a parameter that MUST be an initializer; a clear error
        beats a raw KeyError or a silently-default weight."""
        name = node.input[i]
        if name not in self.inits:
            raise ValueError(
                f"{node.op_type} {node.name!r}: {what} {name!r} is not an "
                f"initializer (computed parameters are unsupported — export "
                f"with constant weights)")
        return self.inits[name]

    def copy_weights(self, ffmodel) -> int:
        """Bind the recorded ONNX initializer weights into the compiled
        model (call after ``ffmodel.compile()``). Returns the number of
        arrays bound. Mirrors torch_frontend.copy_weights."""
        if getattr(ffmodel, "_search_layers", None) is not None:
            raise ValueError(
                "the search chose a structurally-rewritten graph; imported "
                "weights cannot be mapped onto merged layers — set "
                "config.enable_graph_rewrites = False before compile()")
        import torch

        from ..torch_frontend.model import set_weight

        bound = 0
        for layer, leaf, arr in self.weight_bindings:
            have = ffmodel.compiled.params.get(layer.name, {})
            if leaf not in have:
                raise ValueError(
                    f"layer {layer.name!r} has no weight {leaf!r} to bind "
                    f"(weights: {sorted(have)})")
            set_weight(ffmodel, layer.name, leaf, torch.from_numpy(np.ascontiguousarray(arr)))
            bound += 1
        return bound

    def input_tensors(self, ffmodel, batch_size: int) -> List:
        """One FF input per graph input (initializers excluded), a dynamic
        or zero batch dim set to ``batch_size``; other dims must be static."""
        inputs = []
        for gi in self.model.graph.input:
            if gi.name in self.inits:
                continue
            dims = [d.dim_value for d in gi.type.tensor_type.shape.dim]
            dims[0] = dims[0] if dims[0] > 0 else int(batch_size)
            if any(d <= 0 for d in dims[1:]):
                raise ValueError(
                    f"ONNX input {gi.name!r} has dynamic non-batch dims "
                    f"{dims}: export with static shapes")
            inputs.append(ffmodel.create_tensor(tuple(dims), name=gi.name))
        return inputs

    # ------------------------------------------------------------------ #
    def apply(self, ffmodel, input_tensors: Sequence) -> List:
        """Replay the onnx graph onto ``ffmodel``; ``input_tensors`` bind
        the graph inputs (initializers excluded) in declaration order."""
        env: Dict[str, object] = {}
        # bindings belong to THIS apply's layers; a stale list from a prior
        # apply would bind tensors owned by a different FFModel
        self.weight_bindings = []
        graph_inputs = [
            i for i in self.model.graph.input if i.name not in self.inits
        ]
        assert len(graph_inputs) == len(input_tensors), (
            f"graph has {len(graph_inputs)} inputs, got {len(input_tensors)}"
        )
        for gi, t in zip(graph_inputs, input_tensors):
            env[gi.name] = t
        for node in self.model.graph.node:
            handler = getattr(self, f"handle{node.op_type}", None)
            if handler is None:
                raise ValueError(f"unsupported ONNX op {node.op_type}")
            outs = handler(ffmodel, node, env)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, val in zip(node.output, outs):
                env[name] = val
        return [env[o.name] for o in self.model.graph.output]

    # ---- handlers (reference: model.py handleX methods) ---------------- #
    def handleConv(self, ff, node, env):
        a = _attrs(node)
        w = self._init(node, 1, "weight")
        out_c, _, kh, kw = w.shape
        strides = a.get("strides", [1, 1])
        pads = a.get("pads", [0, 0, 0, 0])
        group = a.get("group", 1)
        # reject silently-wrong imports instead of dropping attributes
        # (reference walker handles only the symmetric/undilated subset too)
        dil = list(a.get("dilations", [1, 1]))
        if any(d != 1 for d in dil):
            raise ValueError(
                f"Conv {node.name!r}: dilations={dil} unsupported")
        if len(pads) >= 4 and list(pads[:2]) != list(pads[2:4]):
            raise ValueError(
                f"Conv {node.name!r}: asymmetric pads={list(pads)} "
                f"unsupported (begin must equal end)")
        auto_pad = a.get("auto_pad", b"NOTSET")
        auto_pad = auto_pad.decode() if isinstance(auto_pad, bytes) else auto_pad
        if auto_pad not in ("NOTSET", "VALID"):
            raise ValueError(
                f"Conv {node.name!r}: auto_pad={auto_pad!r} unsupported "
                f"(export with explicit pads)")
        out = ff.conv2d(env[node.input[0]], out_c, kh, kw, strides[0],
                        strides[1], pads[0], pads[1], groups=group,
                        use_bias=len(node.input) > 2, name=node.name or None)
        self._bind(out, "kernel", w)  # ONNX W is OIHW = FF conv layout
        if len(node.input) > 2:
            self._bind(out, "bias", self._init(node, 2, "bias"))
        return out

    def _pool(self, ff, node, env, pt):
        a = _attrs(node)
        k = a.get("kernel_shape", [2, 2])
        s = a.get("strides", k)
        p = a.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], k[0], k[1], s[0], s[1], p[0],
                         p[1], pool_type=pt, name=node.name or None)

    def handleMaxPool(self, ff, node, env):
        return self._pool(ff, node, env, PoolType.MAX)

    def handleAveragePool(self, ff, node, env):
        return self._pool(ff, node, env, PoolType.AVG)

    def handleGemm(self, ff, node, env):
        w = self._init(node, 1, "weight B")
        a = _attrs(node)
        # reject attribute values the dense lowering would silently ignore
        if a.get("transA", 0):
            raise ValueError(f"Gemm {node.name!r}: transA=1 unsupported")
        if float(a.get("alpha", 1.0)) != 1.0:
            raise ValueError(
                f"Gemm {node.name!r}: alpha={a.get('alpha')} unsupported")
        # beta only matters when a C (bias) input exists
        if len(node.input) > 2 and float(a.get("beta", 1.0)) != 1.0:
            raise ValueError(
                f"Gemm {node.name!r}: beta={a.get('beta')} unsupported")
        out_dim = w.shape[0] if a.get("transB", 0) else w.shape[1]
        out = ff.dense(env[node.input[0]], int(out_dim),
                       use_bias=len(node.input) > 2, name=node.name or None)
        # FF dense kernel is (in, out); transB=1 stores (out, in)
        self._bind(out, "kernel", w.T if a.get("transB", 0) else w)
        if len(node.input) > 2:
            b = np.asarray(self._init(node, 2, "bias C"))
            try:
                # ONNX Gemm C is unidirectionally broadcastable to (M, N);
                # per-batch-row bias (an (M, N) or (M, 1) C that varies
                # over M) can't map onto a (N,) dense bias
                b = np.broadcast_to(b.reshape(-1) if b.ndim > 1
                                    and b.shape[0] == 1 else b,
                                    (int(out_dim),)).copy()
            except ValueError:
                raise ValueError(
                    f"Gemm {node.name!r}: bias C shape {b.shape} not "
                    f"broadcastable to ({out_dim},)") from None
            self._bind(out, "bias", b)
        return out

    def handleMatMul(self, ff, node, env):
        if node.input[1] in self.inits:
            w = self.inits[node.input[1]]
            if w.ndim != 2:
                raise ValueError(
                    f"MatMul {node.name!r}: initializer weight of rank "
                    f"{w.ndim} unsupported (dense kernels are 2-D)")
            out = ff.dense(env[node.input[0]], int(w.shape[-1]),
                           use_bias=False, name=node.name or None)
            self._bind(out, "kernel", w)  # (K, N) = FF (in, out)
            return out
        return ff.batch_matmul(env[node.input[0]], env[node.input[1]],
                               name=node.name or None)

    def handleRelu(self, ff, node, env):
        return ff.relu(env[node.input[0]], name=node.name or None)

    def handleGelu(self, ff, node, env):
        return ff.gelu(env[node.input[0]], name=node.name or None)

    def handleSigmoid(self, ff, node, env):
        return ff.sigmoid(env[node.input[0]], name=node.name or None)

    def handleTanh(self, ff, node, env):
        return ff.tanh(env[node.input[0]], name=node.name or None)

    def handleSoftmax(self, ff, node, env):
        a = _attrs(node)
        return ff.softmax(env[node.input[0]], axis=a.get("axis", -1),
                          name=node.name or None)

    def handleFlatten(self, ff, node, env):
        return ff.flat(env[node.input[0]], name=node.name or None)

    def handleAdd(self, ff, node, env):
        return ff.add(env[node.input[0]], env[node.input[1]],
                      name=node.name or None)

    def handleSub(self, ff, node, env):
        return ff.subtract(env[node.input[0]], env[node.input[1]],
                           name=node.name or None)

    def handleMul(self, ff, node, env):
        return ff.multiply(env[node.input[0]], env[node.input[1]],
                           name=node.name or None)

    def handleConcat(self, ff, node, env):
        a = _attrs(node)
        return ff.concat([env[i] for i in node.input], axis=a.get("axis", 0),
                         name=node.name or None)

    def handleSplit(self, ff, node, env):
        a = _attrs(node)
        if "split" in a:
            sizes = list(a["split"])
        elif len(node.input) > 1 and node.input[1] in self.inits:
            sizes = self.inits[node.input[1]].tolist()
        else:
            sizes = len(node.output)
        return ff.split(env[node.input[0]], sizes, axis=a.get("axis", 0),
                        name=node.name or None)

    def handleDropout(self, ff, node, env):
        a = _attrs(node)
        rate = a.get("ratio", 0.5)
        if len(node.input) > 1 and node.input[1] in self.inits:
            rate = float(self.inits[node.input[1]])
        return ff.dropout(env[node.input[0]], rate=rate,
                          name=node.name or None)

    def handleReshape(self, ff, node, env):
        shape = self.inits[node.input[1]].tolist()
        x = env[node.input[0]]
        # ONNX: a 0 copies the input's dim, then -1 takes the rest (the JAX
        # package infers -1 first and so mis-sizes a (0, -1) shape)
        shape = [x.dims[i] if s == 0 else s for i, s in enumerate(shape)]
        if any(s == -1 for s in shape):
            known = int(np.prod([s for s in shape if s > 0]))
            total = int(np.prod(x.dims))
            shape = [total // known if s == -1 else s for s in shape]
        return ff.reshape(x, shape, name=node.name or None)

    def handleTranspose(self, ff, node, env):
        a = _attrs(node)
        x = env[node.input[0]]
        perm = a.get("perm", list(reversed(range(len(x.dims)))))
        return ff.transpose(x, list(perm), name=node.name or None)

    def handleBatchNormalization(self, ff, node, env):
        a = _attrs(node)
        out = ff.batch_norm(env[node.input[0]], relu=False,
                            eps=float(a.get("epsilon", 1e-5)),
                            name=node.name or None)
        # ONNX inputs: X, scale, B, input_mean, input_var
        for i, leaf in ((1, "scale"), (2, "bias"),
                        (3, "running_mean"), (4, "running_var")):
            if len(node.input) > i and node.input[i]:
                self._bind(out, leaf, self._init(node, i, leaf))
        return out

    def handleIdentity(self, ff, node, env):
        return ff.identity(env[node.input[0]], name=node.name or None)

    def handleDiv(self, ff, node, env):
        return ff.divide(env[node.input[0]], env[node.input[1]],
                         name=node.name or None)

    def handleMax(self, ff, node, env):
        return ff.max(env[node.input[0]], env[node.input[1]],
                      name=node.name or None)

    def handleMin(self, ff, node, env):
        return ff.min(env[node.input[0]], env[node.input[1]],
                      name=node.name or None)

    def handleExp(self, ff, node, env):
        return ff.exp(env[node.input[0]], name=node.name or None)

    def handleSin(self, ff, node, env):
        return ff.sin(env[node.input[0]], name=node.name or None)

    def handleCos(self, ff, node, env):
        return ff.cos(env[node.input[0]], name=node.name or None)

    def handleElu(self, ff, node, env):
        a = _attrs(node)
        if float(a.get("alpha", 1.0)) != 1.0:
            raise ValueError(f"Elu {node.name!r}: alpha != 1 unsupported")
        return ff.elu(env[node.input[0]], name=node.name or None)

    def handlePow(self, ff, node, env):
        if node.input[1] not in self.inits:
            raise ValueError(f"Pow {node.name!r}: dynamic exponent unsupported")
        e = float(np.asarray(self.inits[node.input[1]]).reshape(-1)[0])
        return ff.pow(env[node.input[0]], e, name=node.name or None)

    def handleSqrt(self, ff, node, env):
        return ff.pow(env[node.input[0]], 0.5, name=node.name or None)

    def handleNeg(self, ff, node, env):
        return ff.scalar_multiply(env[node.input[0]], -1.0,
                                  name=node.name or None)

    def _reduce_axes(self, node, env):
        a = _attrs(node)
        axes = list(a.get("axes", []))
        if not axes and len(node.input) > 1 and node.input[1]:
            if node.input[1] not in self.inits:
                raise ValueError(
                    f"{node.op_type} {node.name!r}: dynamic axes unsupported")
            axes = self.inits[node.input[1]].tolist()
        if not axes:
            # ONNX default: no axes means reduce ALL dims
            axes = list(range(len(env[node.input[0]].dims)))
        return axes, bool(a.get("keepdims", 1))

    def handleReduceMean(self, ff, node, env):
        axes, keep = self._reduce_axes(node, env)
        return ff.mean(env[node.input[0]], axes, keepdims=keep,
                       name=node.name or None)

    def handleReduceSum(self, ff, node, env):
        axes, keep = self._reduce_axes(node, env)
        return ff.reduce_sum(env[node.input[0]], axes, keepdims=keep,
                             name=node.name or None)

    def handleGlobalAveragePool(self, ff, node, env):
        # NCHW: mean over H, W keeping dims (reference examples use this
        # before the classifier head)
        return ff.mean(env[node.input[0]], [2, 3], keepdims=True,
                       name=node.name or None)

    def handleCast(self, ff, node, env):
        from ..ffconst import DataType as DT

        a = _attrs(node)
        # onnx TensorProto dtype codes → framework dtypes
        m = {1: DT.FLOAT, 6: DT.INT32, 7: DT.INT32, 9: DT.BOOL,
             10: DT.HALF, 11: DT.FLOAT, 16: DT.BFLOAT16}
        to = m.get(int(a.get("to", 1)))
        if to is None:
            raise ValueError(f"Cast {node.name!r}: dtype {a.get('to')} unsupported")
        return ff.cast(env[node.input[0]], to, name=node.name or None)

    def handleSqueeze(self, ff, node, env):
        x = env[node.input[0]]
        axes = _attrs(node).get("axes")
        if axes is None and len(node.input) > 1 and node.input[1]:
            if node.input[1] not in self.inits:
                raise ValueError(
                    f"Squeeze {node.name!r}: dynamic axes unsupported")
            axes = self.inits[node.input[1]].tolist()
        nd = len(x.dims)
        axes = ([a % nd for a in axes] if axes is not None
                else [i for i, s in enumerate(x.dims) if s == 1])
        shape = [s for i, s in enumerate(x.dims) if i not in axes]
        return ff.reshape(x, shape, name=node.name or None)

    def handleUnsqueeze(self, ff, node, env):
        x = env[node.input[0]]
        axes = _attrs(node).get("axes")
        if axes is None and len(node.input) > 1 and node.input[1] in self.inits:
            axes = self.inits[node.input[1]].tolist()
        if axes is None:
            raise ValueError(
                f"Unsqueeze {node.name!r}: dynamic axes unsupported")
        out_nd = len(x.dims) + len(axes)
        axes = sorted(a % out_nd for a in axes)
        shape = list(x.dims)
        for a in axes:
            shape.insert(a, 1)
        return ff.reshape(x, shape, name=node.name or None)

    def handleSlice(self, ff, node, env):
        """Opset ≥10: starts/ends/axes/steps as initializer inputs."""
        x = env[node.input[0]]

        def init(i, default):
            if len(node.input) > i and node.input[i]:
                if node.input[i] not in self.inits:
                    raise ValueError(
                        f"Slice {node.name!r}: dynamic input "
                        f"{node.input[i]!r} unsupported (export with "
                        f"constant slice parameters)")
                return self.inits[node.input[i]].tolist()
            return default
        starts = init(1, None)
        ends = init(2, None)
        if starts is None or ends is None:
            a = _attrs(node)  # opset 1 fallback: attributes
            starts = list(a.get("starts", []))
            ends = list(a.get("ends", []))
            if not starts and not ends:
                raise ValueError(
                    f"Slice {node.name!r}: dynamic starts/ends unsupported "
                    f"(export with constant slice bounds)")
            axes = list(a.get("axes", range(len(starts))))
            steps = [1] * len(starts)
        else:
            axes = init(3, list(range(len(starts))))
            steps = init(4, [1] * len(starts))
        nd = len(x.dims)
        items = [{"kind": "slice", "start": None, "stop": None, "step": None}
                 for _ in range(nd)]
        for s, e, ax, st in zip(starts, ends, axes, steps):
            # onnx uses INT_MAX/MIN sentinels for open ends
            big = 1 << 30
            items[ax % nd] = {
                "kind": "slice",
                "start": None if abs(int(s)) >= big else int(s),
                "stop": None if abs(int(e)) >= big else int(e),
                "step": int(st)}
        return ff.slice_tensor(x, items, name=node.name or None)

    def handleGather(self, ff, node, env):
        """Embedding lookup when the data input is an initializer matrix
        (the standard exported-embedding pattern); tensor gather otherwise."""
        a = _attrs(node)
        axis = int(a.get("axis", 0))
        if node.input[0] in self.inits:
            if axis != 0:
                raise ValueError(
                    f"Gather {node.name!r}: initializer data with "
                    f"axis={axis} unsupported (only axis=0 embedding lookup)")
            w = self.inits[node.input[0]]
            if w.ndim != 2:
                raise ValueError(
                    f"Gather {node.name!r}: initializer data of rank "
                    f"{w.ndim} unsupported (embedding matrices are 2-D)")
            out = ff.embedding(env[node.input[1]], int(w.shape[0]),
                               int(w.shape[1]), name=node.name or None)
            self._bind(out, "weight", w)
            return out
        return ff.gather(env[node.input[0]], env[node.input[1]], axis,
                         name=node.name or None)

    def handleLayerNormalization(self, ff, node, env):
        a = _attrs(node)
        x = env[node.input[0]]
        axis = int(a.get("axis", -1)) % len(x.dims)
        # onnx normalizes over ALL dims in [axis, rank)
        axes = list(range(axis, len(x.dims)))
        out = ff.layer_norm(x, axes=axes,
                            elementwise_affine=len(node.input) > 1,
                            eps=float(a.get("epsilon", 1e-5)),
                            name=node.name or None)
        for i, leaf in ((1, "scale"), (2, "bias")):
            if len(node.input) > i and node.input[i]:
                self._bind(out, leaf, self._init(node, i, leaf))
        return out

    def handleLSTM(self, ff, node, env):
        raise ValueError(
            f"LSTM {node.name!r}: import the torch module directly "
            f"(ff.lstm / torch frontend) — onnx LSTM's packed layout is "
            f"not supported")


class ONNXBuilder:
    """``builder(ff, batch_size)`` of an ONNX file: the graph replayed onto
    ``ff`` (its weights are bound after compile, by ``copy_weights`` or
    by a group's op-order weights). Picklable, so a rank group can build
    it (``serving/group.py``)."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, ff, batch_size: int):
        om = ONNXModel(self.path)
        return om.apply(ff, om.input_tensors(ff, batch_size))
