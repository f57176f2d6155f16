"""torch.fx → flexflow_tpu_torch importer.

PyTorch counterpart of ``flexflow_tpu/torch_frontend/model.py`` (reference:
python/flexflow/torch/model.py): ``torch.fx.symbolic_trace`` walks the
module into a node list; each node is lowered to a serializable IR record;
the IR replays onto an ``FFModel`` through its builder API
(``PyTorchModel.apply``). :func:`copy_weights` copies the module's
parameters into the compiled model after ``compile`` (layout transposes
handled here), tensor to tensor: a module on the card copies to a model
on the card without a host round trip. ``nn.MultiheadAttention``
replays as ``FFModel.multihead_attention``, whose forward and backward
are the flash-attention kernels on the card.

IR format: JSON lines, one record per fx node, record for record the JAX
package's, so an IR file written by either package replays in the other:
    {"name": ..., "kind": "module|function|input|output",
     "op": <builder op>, "inputs": [...], "attrs": {...}}
"""

from __future__ import annotations

import json
import operator
import sys
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..ffconst import ActiMode, AggrMode, PoolType


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


# --------------------------------------------------------------------- trace
def _is_hf_conv1d(mod) -> bool:
    """transformers.pytorch_utils.Conv1D (GPT-2's projection layer),
    duck-typed so torch_frontend works without transformers installed.
    THE single predicate shared by tracing (leaf-module policy), record
    mapping, and weight copy — they must agree on what a Conv1D is."""
    return type(mod).__name__ == "Conv1D" and hasattr(mod, "nf")


def _module_record(name, mod, inputs):
    import torch.nn as nn

    a: Dict = {}
    if isinstance(mod, nn.Linear):
        op = "dense"
        a = dict(out_dim=mod.out_features, use_bias=mod.bias is not None)
    elif isinstance(mod, nn.Conv2d):
        op = "conv2d"
        kh, kw = _pair(mod.kernel_size)
        sh, sw = _pair(mod.stride)
        ph, pw = _pair(mod.padding)
        a = dict(out_channels=mod.out_channels, kernel=(kh, kw),
                 stride=(sh, sw), padding=(ph, pw), groups=mod.groups,
                 use_bias=mod.bias is not None)
    elif isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
        op = "pool2d"
        kh, kw = _pair(mod.kernel_size)
        sh, sw = _pair(mod.stride if mod.stride is not None else mod.kernel_size)
        ph, pw = _pair(mod.padding)
        a = dict(kernel=(kh, kw), stride=(sh, sw), padding=(ph, pw),
                 pool_type="MAX" if isinstance(mod, nn.MaxPool2d) else "AVG")
    elif isinstance(mod, nn.BatchNorm2d):
        op = "batch_norm"
        a = dict(relu=False)
    elif isinstance(mod, nn.LayerNorm):
        op = "layer_norm"
        a = dict(axes=list(range(-len(mod.normalized_shape), 0)),
                 elementwise_affine=mod.elementwise_affine,
                 eps=mod.eps)
    elif isinstance(mod, nn.Dropout):
        op = "dropout"
        a = dict(rate=mod.p)
    elif isinstance(mod, nn.Embedding):
        op = "embedding"
        a = dict(num_entries=mod.num_embeddings, out_dim=mod.embedding_dim)
    elif isinstance(mod, nn.ReLU):
        op = "relu"
    elif isinstance(mod, nn.GELU):
        op = "gelu"
    elif isinstance(mod, nn.Sigmoid):
        op = "sigmoid"
    elif isinstance(mod, nn.Tanh):
        op = "tanh"
    elif isinstance(mod, nn.ELU):
        op = "elu"
    elif isinstance(mod, nn.Softmax):
        op = "softmax"
        a = dict(axis=mod.dim if mod.dim is not None else -1)
    elif isinstance(mod, nn.Flatten):
        op = "flat"
        if mod.start_dim != 1 or mod.end_dim != -1:
            raise ValueError(f"unsupported Flatten({mod.start_dim},{mod.end_dim})")
    elif isinstance(mod, nn.Identity):
        op = "identity"
    elif _is_hf_conv1d(mod):
        # x @ W + b with W stored (in, out) — a dense whose kernel needs
        # NO transpose in copy_weights (unlike nn.Linear's (out, in))
        op = "dense"
        a = dict(out_dim=int(mod.nf), use_bias=mod.bias is not None)
    elif isinstance(mod, nn.MultiheadAttention):
        # fx treats nn.MultiheadAttention as a leaf module, so it arrives
        # as one call_module node mapping 1:1 onto
        # FFModel.multihead_attention (reference: the torch frontend's
        # attn handling, model.py:199-2400). Only the batch-first,
        # self/cross Q-K-V form is representable.
        if not mod.batch_first:
            raise ValueError(
                f"{name}: nn.MultiheadAttention(batch_first=False) uses the "
                f"(seq, batch, embed) layout; construct it with "
                f"batch_first=True to import"
            )
        if mod.bias_k is not None or mod.add_zero_attn:
            raise ValueError(
                f"{name}: add_bias_kv/add_zero_attn are unsupported")
        if getattr(mod, "_qkv_same_embed_dim", True) is False:
            raise ValueError(
                f"{name}: kdim/vdim != embed_dim is unsupported")
        op = "multihead_attention"
        a = dict(embed_dim=mod.embed_dim, num_heads=mod.num_heads,
                 dropout=float(mod.dropout),
                 bias=mod.in_proj_bias is not None)
    elif isinstance(mod, (nn.LSTM, nn.GRU, nn.RNN)):
        # our recurrent ops share torch's gate order and weight layout
        # (ops/recurrent.py), so single-layer unidirectional cells map 1:1
        if not mod.batch_first:
            raise ValueError(
                f"{name}: {type(mod).__name__}(batch_first=False) uses the "
                f"(seq, batch, feat) layout; construct with batch_first=True")
        if mod.num_layers != 1 or mod.bidirectional:
            raise ValueError(
                f"{name}: only single-layer unidirectional "
                f"{type(mod).__name__} imports (stack ff.lstm calls for "
                f"multi-layer)")
        if isinstance(mod, nn.RNN) and mod.nonlinearity != "tanh":
            raise ValueError(f"{name}: RNN(nonlinearity='relu') unsupported")
        if getattr(mod, "proj_size", 0):
            raise ValueError(f"{name}: LSTM proj_size > 0 unsupported")
        # isinstance, not type(): user subclasses import like their base
        op = ("lstm" if isinstance(mod, nn.LSTM)
              else "gru" if isinstance(mod, nn.GRU) else "rnn")
        a = dict(hidden_size=mod.hidden_size)
    else:
        raise ValueError(f"unsupported module at {name}: {type(mod).__name__}")
    return {"name": name, "kind": "module", "op": op, "inputs": inputs,
            "attrs": a, "module": True}


_UNARY_FN = {
    "relu": "relu", "gelu": "gelu", "sigmoid": "sigmoid", "tanh": "tanh",
    "exp": "exp", "sin": "sin", "cos": "cos", "rsqrt": "rsqrt",
}

_BINARY_FN = {
    operator.add: "add", operator.sub: "subtract", operator.mul: "multiply",
    operator.truediv: "divide",
}
_BINARY_SCALAR = {
    operator.add: "scalar_add", operator.sub: "scalar_sub",
    operator.mul: "scalar_multiply", operator.truediv: "scalar_true_divide",
}


def _node_arg(a):
    import torch.fx as fx

    if isinstance(a, fx.Node):
        return {"ref": a.name}
    if isinstance(a, (tuple, list)):
        return [_node_arg(x) for x in a]
    return a


def _trace(module) -> List[Dict]:
    import torch
    import torch.fx as fx
    import torch.nn.functional as F

    gm = fx.symbolic_trace(module)
    records: List[Dict] = []
    outputs: List[str] = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            records.append({"name": node.name, "kind": "input", "op": "input",
                            "inputs": [], "attrs": {}})
        elif node.op == "call_module":
            mod = gm.get_submodule(node.target)
            ins = [a.name for a in node.args if isinstance(a, fx.Node)]
            # never silently drop a tensor-valued kwarg (e.g. attn_mask /
            # key_padding_mask on nn.MultiheadAttention)
            bad_kwargs = [k for k, v in node.kwargs.items()
                          if isinstance(v, fx.Node)]
            if bad_kwargs:
                raise ValueError(
                    f"{node.name}: tensor kwargs {bad_kwargs} on "
                    f"{type(mod).__name__} are not importable")
            rec = _module_record(node.name, mod, ins)
            if rec["op"] == "multihead_attention" and len(ins) != 3:
                raise ValueError(
                    f"{node.name}: MultiheadAttention expects exactly "
                    f"(query, key, value) tensor args, got {len(ins)} "
                    f"(masks are not importable)")
            rec["module_path"] = node.target
            records.append(rec)
        elif node.op == "call_function" or node.op == "call_method":
            records.append(_function_record(node, torch, F))
        elif node.op == "get_attr":
            raise ValueError(
                f"get_attr node {node.target}: free tensors are not "
                f"importable; wrap them in a module"
            )
        elif node.op == "output":
            def _flat(a):
                if isinstance(a, fx.Node):
                    outputs.append(a.name)
                elif isinstance(a, (tuple, list)):
                    for x in a:
                        _flat(x)
            _flat(node.args)
    records.append({"name": "__outputs__", "kind": "output", "op": "output",
                    "inputs": outputs, "attrs": {}})
    return records


class NodeRef:
    """Duck-typed stand-in for an fx.Node whose producer was already
    resolved to an IR name (used by the HF importer, hf.py)."""

    def __init__(self, name: str):
        self.name = name


def _function_record(node, torch, F) -> Dict:
    import torch.fx as fx

    tgt = node.target
    name = node.name
    args = node.args

    def rec(op, inputs, attrs=None):
        return {"name": name, "kind": "function", "op": op,
                "inputs": inputs, "attrs": attrs or {}}

    def is_node(a):
        return isinstance(a, (fx.Node, NodeRef))

    # method calls arrive as strings
    if node.op == "call_method":
        m = tgt
        self_arg = args[0].name
        if m in _UNARY_FN:
            return rec(_UNARY_FN[m], [self_arg])
        if m in ("view", "reshape"):
            shape = [a for a in args[1:]]
            if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
                shape = list(shape[0])
            if any(is_node(s) for s in shape[1:]):
                # non-leading dynamic dims are not importable statically
                raise ValueError(
                    f"{name}: view/reshape with a dynamic non-batch dim is "
                    f"not importable (the imported graph's shapes are static)"
                )
            if len(shape) == 2 and shape[1] == -1:
                # x.view(x.size(0), -1) / x.view(B, -1) → flatten
                return rec("flat", [self_arg])
            # a leading x.size(0) (or any Node) means "keep the batch dim":
            # serialize as 0, resolved against the input dims at apply time
            out = [0 if is_node(s) else int(s) for s in shape]
            return rec("reshape", [self_arg], {"shape": out})
        if m == "flatten":
            return rec("flat", [self_arg])
        if m in ("transpose",):
            return rec("transpose2", [self_arg],
                       {"dims": [int(args[1]), int(args[2])]})
        if m == "permute":
            perm = args[1:] if not isinstance(args[1], (tuple, list)) else args[1]
            return rec("transpose", [self_arg], {"perm": [int(p) for p in perm]})
        if m == "size" or m == "dim":
            return rec("size", [self_arg], {"args": [a for a in args[1:]
                                                    if not is_node(a)]})
        if m == "contiguous" or m == "clone" or m == "detach":
            return rec("identity", [self_arg])
        if m == "split":
            sizes = args[1]
            axis = int(node.kwargs.get("dim", args[2] if len(args) > 2 else 0))
            sizes = (list(sizes) if isinstance(sizes, (tuple, list))
                     else int(sizes))
            return rec("split", [self_arg], {"sizes": sizes, "axis": axis})
        if m == "softmax":
            return rec("softmax", [self_arg], {"axis": int(args[1])})
        if m == "mean":
            dims = args[1] if len(args) > 1 else None
            dims = [dims] if isinstance(dims, int) else list(dims or [])
            return rec("mean", [self_arg],
                       {"dims": dims, "keepdims": bool(node.kwargs.get("keepdim", False))})
        raise ValueError(f"unsupported method: {m}")

    # binary arithmetic (tensor-tensor or tensor-scalar)
    if tgt in _BINARY_FN or tgt in (torch.add, torch.sub, torch.mul, torch.div):
        fn_map = {torch.add: operator.add, torch.sub: operator.sub,
                  torch.mul: operator.mul, torch.div: operator.truediv}
        base = fn_map.get(tgt, tgt)
        a, b = args[0], args[1]
        if is_node(a) and is_node(b):
            return rec(_BINARY_FN[base], [a.name, b.name])
        if is_node(a):
            return rec(_BINARY_SCALAR[base], [a.name], {"scalar": float(b)})
        # scalar op tensor: only add/mul commute
        if base in (operator.add, operator.mul):
            return rec(_BINARY_SCALAR[base], [b.name], {"scalar": float(a)})
        raise ValueError(f"unsupported scalar-tensor {base}")
    if tgt in (F.relu, torch.relu):
        return rec("relu", [args[0].name])
    if tgt is F.gelu:
        return rec("gelu", [args[0].name])
    if tgt in (torch.sigmoid, F.sigmoid):
        return rec("sigmoid", [args[0].name])
    if tgt in (torch.tanh, F.tanh):
        return rec("tanh", [args[0].name])
    if tgt in (torch.exp,):
        return rec("exp", [args[0].name])
    if tgt in (torch.pow,):
        if is_node(args[1]):
            raise ValueError("pow with tensor exponent is not importable")
        return rec("pow", [args[0].name], {"exponent": float(args[1])})
    if tgt is F.softmax or tgt is torch.softmax:
        axis = node.kwargs.get("dim", args[1] if len(args) > 1 else -1)
        return rec("softmax", [args[0].name], {"axis": int(axis)})
    if tgt is F.dropout:
        return rec("dropout", [args[0].name],
                   {"rate": float(node.kwargs.get("p", args[1] if len(args) > 1 else 0.5))})
    if tgt in (torch.flatten,):
        return rec("flat", [args[0].name])
    if tgt in (torch.cat,):
        tensors = args[0]
        axis = node.kwargs.get("dim", args[1] if len(args) > 1 else 0)
        return rec("concat", [t.name for t in tensors], {"axis": int(axis)})
    if tgt in (torch.split,):
        sizes = args[1]
        axis = int(node.kwargs.get("dim", args[2] if len(args) > 2 else 0))
        sizes = list(sizes) if isinstance(sizes, (tuple, list)) else int(sizes)
        return rec("split", [args[0].name], {"sizes": sizes, "axis": axis})
    if tgt in (torch.matmul, torch.bmm):
        return rec("batch_matmul", [args[0].name, args[1].name])
    if tgt in (torch.reshape,):
        return rec("reshape", [args[0].name], {"shape": [int(s) for s in args[1]]})
    if tgt in (torch.transpose,):
        return rec("transpose2", [args[0].name],
                   {"dims": [int(args[1]), int(args[2])]})
    if tgt in (torch.mean,):
        dims = args[1] if len(args) > 1 else node.kwargs.get("dim")
        dims = [dims] if isinstance(dims, int) else list(dims or [])
        return rec("mean", [args[0].name],
                   {"dims": dims, "keepdims": bool(node.kwargs.get("keepdim", False))})
    if tgt is operator.getitem:
        idx = args[1]
        if isinstance(idx, int):
            return rec("getitem", [args[0].name], {"index": idx})
        # tensor slicing (x[:, -1], x[:, 1:3]) -> the static Slice op
        items = []
        for it in (idx if isinstance(idx, tuple) else (idx,)):
            if isinstance(it, slice):
                if any(is_node(v) for v in (it.start, it.stop, it.step)):
                    raise ValueError(f"{name}: dynamic slice bounds are "
                                     f"not importable")
                items.append({"kind": "slice",
                              "start": it.start, "stop": it.stop,
                              "step": it.step})
            elif isinstance(it, int):
                items.append({"kind": "int", "i": it})
            else:
                raise ValueError(f"{name}: unsupported index {it!r}")
        return rec("slice", [args[0].name], {"items": items})
    raise ValueError(f"unsupported function: {tgt}")


class _UnexportedMarker:
    """Poison value for traced-but-unexportable results (e.g. attention
    weights): raises with an actionable message only when actually used."""

    def __init__(self, message: str):
        self._message = message

    def _fail(self, *_a, **_k):
        raise ValueError(self._message)

    __getitem__ = __iter__ = __int__ = __index__ = __add__ = __radd__ = _fail
    __mul__ = __rmul__ = __sub__ = __truediv__ = __call__ = _fail
    # any attribute access (e.g. .dims during a consuming op) fails too
    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        self._fail()


class _SizeMarker:
    """Placeholder for a traced ``tensor.size()`` value. view/reshape
    consumers are rewritten at trace time and never read it; anything else
    touching it gets the actionable error the importer used to raise."""

    def __init__(self, node_name: str):
        self._node = node_name

    def _fail(self, *_a, **_k):
        raise ValueError(
            f"tensor.size() at node '{self._node}' feeds an operation "
            f"other than view/reshape — not importable (the imported "
            f"graph's shapes are static)"
        )

    __getitem__ = __iter__ = __int__ = __index__ = __add__ = __radd__ = _fail
    __mul__ = __rmul__ = __sub__ = __truediv__ = __call__ = _fail


def _is_hf_model(module) -> bool:
    """A transformers ``PreTrainedModel``. A module of that class exists
    only once transformers is imported, so this never imports it (the
    card's machine does not have it)."""
    tf = sys.modules.get("transformers")
    return tf is not None and isinstance(module, tf.PreTrainedModel)


# -------------------------------------------------------------------- replay
class PyTorchModel:
    """reference: PyTorchModel (python/flexflow/torch/model.py:2408).

    Construct from a live ``torch.nn.Module`` or a serialized IR file path;
    ``apply(ffmodel, input_tensors)`` replays the graph through FFModel's
    builder and returns the output Tensors.
    """

    def __init__(self, model_or_path: Union[str, "object"],
                 input_names: Optional[Sequence[str]] = None,
                 batch_size: int = 2, seq_length: int = 16):
        if isinstance(model_or_path, str):
            with open(model_or_path) as f:
                self.ir = [json.loads(line) for line in f if line.strip()]
            self.module = None
            return
        self.module = model_or_path
        if _is_hf_model(model_or_path):
            # HF-aware tracing (reference: model.py:2430 swaps the tracer
            # for transformers models); see hf.py for the additions
            from .hf import trace_hf

            self.ir = trace_hf(model_or_path,
                               input_names=input_names or ("input_ids",),
                               batch_size=batch_size, seq_length=seq_length)
        else:
            self.ir = _trace(model_or_path)

    def torch_to_file(self, path: str) -> None:
        """reference: torch_to_file (model.py:2597)."""
        with open(path, "w") as f:
            for r in self.ir:
                f.write(json.dumps(r) + "\n")

    # -- replay ---------------------------------------------------------- #
    def apply(self, ffmodel, input_tensors: Sequence) -> List:
        env: Dict[str, object] = {}
        outputs: List = []
        it = iter(input_tensors)
        self.layer_names: Dict[str, str] = {}  # fx node -> FF layer name
        # FF layer name -> torch module path (for exact weight binding in
        # copy_weights; records carry it for call_module nodes)
        self.module_paths: Dict[str, str] = {}
        for r in self.ir:
            if "module_path" in r:
                self.module_paths[r["name"]] = r["module_path"]
            op, name, ins = r["op"], r["name"], r["inputs"]
            a = dict(r["attrs"])
            if r["kind"] == "input":
                env[name] = next(it)
                continue
            if r["kind"] == "constant":
                env[name] = ffmodel.constant(
                    np.array(a["value"], dtype=np.dtype(a["vdtype"])),
                    name=name)
                continue
            if r["kind"] == "output":
                outputs = [env[i] for i in ins]
                continue
            x = [env[i] for i in ins]
            out = self._emit(ffmodel, op, name, x, a, env)
            env[name] = out
        return outputs

    def _emit(self, ff, op, name, x, a, env):
        self.layer_names[name] = name
        if op == "dense":
            act = ActiMode.NONE
            return ff.dense(x[0], a["out_dim"], activation=act,
                            use_bias=a.get("use_bias", True), name=name)
        if op == "conv2d":
            k, s, p = a["kernel"], a["stride"], a["padding"]
            return ff.conv2d(x[0], a["out_channels"], k[0], k[1], s[0], s[1],
                             p[0], p[1], groups=a.get("groups", 1),
                             use_bias=a.get("use_bias", True), name=name)
        if op == "pool2d":
            k, s, p = a["kernel"], a["stride"], a["padding"]
            pt = PoolType.MAX if a["pool_type"] == "MAX" else PoolType.AVG
            return ff.pool2d(x[0], k[0], k[1], s[0], s[1], p[0], p[1],
                             pool_type=pt, name=name)
        if op == "batch_norm":
            return ff.batch_norm(x[0], relu=a.get("relu", False), name=name)
        if op == "layer_norm":
            return ff.layer_norm(x[0], axes=a.get("axes", [-1]),
                                 elementwise_affine=a.get("elementwise_affine", True),
                                 eps=a.get("eps", 1e-5), name=name)
        if op == "dropout":
            return ff.dropout(x[0], rate=a.get("rate", 0.5), name=name)
        if op == "embedding":
            return ff.embedding(x[0], a["num_entries"], a["out_dim"],
                                aggr=AggrMode.NONE, name=name)
        if op in ("relu", "gelu", "sigmoid", "tanh", "elu", "exp", "sin",
                  "cos", "rsqrt", "identity"):
            return getattr(ff, op)(x[0], name=name)
        if op == "pow":
            return ff.pow(x[0], a["exponent"], name=name)
        if op == "softmax":
            return ff.softmax(x[0], axis=a.get("axis", -1), name=name)
        if op == "flat":
            return ff.flat(x[0], name=name)
        if op == "reshape":
            # 0 = copy the input dim at that position (dynamic batch);
            # -1 = infer from the remaining volume
            shape = [
                x[0].dims[i] if s == 0 else s
                for i, s in enumerate(a["shape"])
            ]
            if any(s == -1 for s in shape):
                known = int(np.prod([s for s in shape if s != -1]))
                total = int(np.prod(x[0].dims))
                shape = [total // known if s == -1 else s for s in shape]
            return ff.reshape(x[0], shape, name=name)
        if op == "transpose":
            return ff.transpose(x[0], a["perm"], name=name)
        if op == "transpose2":
            nd = len(x[0].dims)
            d0, d1 = [d % nd for d in a["dims"]]
            perm = list(range(nd))
            perm[d0], perm[d1] = perm[d1], perm[d0]
            return ff.transpose(x[0], perm, name=name)
        if op == "mean":
            return ff.mean(x[0], a["dims"], keepdims=a.get("keepdims", False),
                           name=name)
        if op in ("add", "subtract", "multiply", "divide"):
            return getattr(ff, op)(x[0], x[1], name=name)
        if op in ("scalar_add", "scalar_sub", "scalar_multiply",
                  "scalar_true_divide"):
            return getattr(ff, op)(x[0], a["scalar"], name=name)
        if op == "concat":
            return ff.concat(x, axis=a["axis"], name=name)
        if op == "split":
            sizes = a["sizes"]
            if isinstance(sizes, int):
                # torch semantics: int = CHUNK SIZE with a short final
                # remainder chunk (ff.split's int means equal part COUNT)
                total = x[0].dims[a["axis"] % len(x[0].dims)]
                chunk = sizes
                sizes = [chunk] * (total // chunk)
                if total % chunk:
                    sizes.append(total % chunk)
            return ff.split(x[0], sizes, axis=a["axis"], name=name)
        if op == "batch_matmul":
            return ff.batch_matmul(x[0], x[1], name=name)
        if op == "multihead_attention":
            return ff.multihead_attention(
                x[0], x[1], x[2], a["embed_dim"], a["num_heads"],
                dropout=a.get("dropout", 0.0), bias=a.get("bias", True),
                name=name)
        if op in ("lstm", "gru", "rnn"):
            outs = getattr(ff, op)(x[0], a["hidden_size"],
                                   return_sequences=True, return_state=True,
                                   name=name)
            # mirror torch's return structure so traced getitems resolve:
            # LSTM -> (output, (h, c)); GRU/RNN -> (output, h). torch's
            # states carry a leading num_layers dim — FF's don't — so wrap
            # each state in a 1-element list: h[0] and h[-1] (the common
            # final-state idioms) both resolve to the (B, H) tensor
            if op == "lstm":
                y, h, c = outs
                return [y, ([h], [c])]
            y, h = outs
            return [y, [h]]
        if op == "slice":
            return ff.slice_tensor(x[0], a["items"], name=name)
        if op == "getitem":
            if isinstance(x[0], (list, tuple)):
                return x[0][a["index"]]
            # tuple-returning torch modules (nn.MultiheadAttention returns
            # (output, attn_weights)) lower to a single FF tensor: [0]
            # passes through; [1] (the weights) is traced even when the
            # caller discards it (`a, _ = attn(...)`), so poison it — the
            # error fires only if something actually consumes it
            if a["index"] == 0:
                return x[0]
            return _UnexportedMarker(
                f"{name}: getitem[{a['index']}] on a single-output op "
                f"(attention weights are not exported)")
        if op == "size":
            # live only because view/reshape consumed it; those consumers
            # were already rewritten to flat/reshape records, so the value
            # itself must never be read — emit a marker that raises with an
            # actionable message on any actual use
            return _SizeMarker(name)
        raise ValueError(f"unknown IR op {op}")


def torch_to_flexflow(module, path: str) -> PyTorchModel:
    """reference: fx.torch_to_flexflow (python/flexflow/torch/fx.py) —
    trace and serialize in one step."""
    m = PyTorchModel(module)
    m.torch_to_file(path)
    return m


def set_weight(ffmodel, layer: str, weight: str, value) -> None:
    """Copy one whole weight (a torch tensor, any device) into the
    compiled params: checked against the weight's whole shape, cast to its
    dtype, on a mesh this rank's block."""
    import torch

    cm = ffmodel.compiled
    cur = cm.params[layer][weight]
    src = value.detach()
    want = cm.weight_layout(layer, weight).sizes if cm.mesh is not None else tuple(cur.shape)
    if tuple(src.shape) != tuple(want):
        raise ValueError(f"{layer}.{weight}: torch shape {tuple(src.shape)} vs {tuple(want)}")
    if cm.mesh is not None:
        src = src[cm.mesh.local_slices(cm.weight_layout(layer, weight))]
    with torch.no_grad():
        cur.copy_(src.to(device=cur.device, dtype=cur.dtype))


def copy_weights(ffmodel, torch_module,
                 module_paths: Optional[Dict[str, str]] = None):
    """Copy a traced module's parameters into the compiled FFModel
    (post-``compile``). Layout mapping: torch Linear stores (out, in) →
    FF kernel (in, out); Conv2d OIHW matches; Embedding matches; the
    attention's packed ``in_proj_weight`` (3E, E) splits into (E, H, D)
    ``wq``/``wk``/``wv`` and ``out_proj`` into (H, D, E) ``wo``.

    ``module_paths``: FF layer name → torch module path
    (``PyTorchModel.module_paths``, filled by ``apply``) — the exact
    binding; without it a dot→underscore name heuristic is used, which can
    be ambiguous for paths that flatten identically.
    """
    import torch

    if getattr(ffmodel, "_search_layers", None) is not None:
        raise ValueError(
            "the search chose a structurally-rewritten graph; imported "
            "weights cannot be mapped onto merged layers — set "
            "config.enable_graph_rewrites = False before compile()")
    if ffmodel.compiled is None:
        raise RuntimeError("compile() before copy_weights()")
    if ffmodel.pipelined is not None:
        raise ValueError("copy_weights into a pipelined model is unsupported: "
                         "copy before splitting it into stages")
    name_of = {}  # FF layer name -> torch submodule
    gm_modules = dict(torch_module.named_modules())
    for layer in ffmodel.layers:
        path = (module_paths or {}).get(layer.name)
        if path is not None and path in gm_modules:
            name_of[layer.name] = gm_modules[path]
        elif layer.name in gm_modules:
            name_of[layer.name] = gm_modules[layer.name]
        else:
            # fx node names flatten '.' to '_'
            for path, mod in gm_modules.items():
                if path.replace(".", "_") == layer.name:
                    name_of[layer.name] = mod
                    break
    params = ffmodel.compiled.params
    for layer in ffmodel.layers:
        mod = name_of.get(layer.name)
        if mod is None or not params.get(layer.name):
            continue
        ws = params[layer.name]

        def put(w, value):
            set_weight(ffmodel, layer.name, w, value)

        if _is_hf_conv1d(mod):
            # transformers Conv1D stores (in, out) — the FF layout
            # already; NO transpose (nn.Linear below needs one)
            put("kernel", mod.weight)
            if "bias" in ws and mod.bias is not None:
                put("bias", mod.bias)
        elif isinstance(mod, torch.nn.Linear):
            put("kernel", mod.weight.t())
            if "bias" in ws and mod.bias is not None:
                put("bias", mod.bias)
        elif isinstance(mod, torch.nn.Conv2d):
            put("kernel", mod.weight)
            if "bias" in ws and mod.bias is not None:
                put("bias", mod.bias)
        elif isinstance(mod, torch.nn.Embedding):
            put("weight", mod.weight)
        elif isinstance(mod, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
            if "scale" in ws and getattr(mod, "weight", None) is not None:
                put("scale", mod.weight)
            if "bias" in ws and getattr(mod, "bias", None) is not None:
                put("bias", mod.bias)
            if isinstance(mod, torch.nn.BatchNorm2d):
                # eval normalizes with the running stats (ops/conv.py), so
                # a pretrained import carries them over
                if "running_mean" in ws and mod.running_mean is not None:
                    put("running_mean", mod.running_mean)
                if "running_var" in ws and mod.running_var is not None:
                    put("running_var", mod.running_var)
        elif isinstance(mod, (torch.nn.LSTM, torch.nn.GRU, torch.nn.RNN)):
            # same gate order/layout as ops/recurrent.py (torch's)
            put("kernel", mod.weight_ih_l0.t())
            put("recurrent_kernel", mod.weight_hh_l0.t())
            if getattr(mod, "bias_ih_l0", None) is not None:
                put("bias", mod.bias_ih_l0)
                put("recurrent_bias", mod.bias_hh_l0)
        elif isinstance(mod, torch.nn.MultiheadAttention):
            # torch packs the q/k/v projections row-wise into
            # in_proj_weight (3E, E); FF stores (E_in, H, D) per projection
            # and wo (H, D, E_out) (ops/attention.py weight_specs)
            E, H = mod.embed_dim, mod.num_heads
            D = E // H
            for i, wn in enumerate(("wq", "wk", "wv")):
                put(wn, mod.in_proj_weight[i * E:(i + 1) * E].t().reshape(E, H, D))
            put("wo", mod.out_proj.weight.t().reshape(H, D, E))
            if mod.in_proj_bias is not None and "bq" in ws:
                for i, bn in enumerate(("bq", "bk", "bv")):
                    put(bn, mod.in_proj_bias[i * E:(i + 1) * E].reshape(H, D))
                put("bo", mod.out_proj.bias)
