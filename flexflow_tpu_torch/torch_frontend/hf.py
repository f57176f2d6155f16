"""HF-aware torch.fx import: transformers models → FF IR.

PyTorch counterpart of ``flexflow_tpu/torch_frontend/hf.py`` (reference:
python/flexflow/torch/model.py:2430 — it swaps torch.fx's tracer for
transformers' when the module is a PreTrainedModel), record for record:

* **shape propagation**: ``torch.fx.passes.shape_prop.ShapeProp`` runs an
  example batch, made on the module's own device, through the graph so
  every ``view``/``size``/``expand`` resolves to static dims; the module
  is never moved;
* **constant folding**: buffers (position ids, token-type ids) and the
  whole attention-mask preparation chain (``ones → to → sub → mul`` etc.)
  have no placeholder ancestry; they are executed at trace time and become
  graph constants (ops/structural.py Constant). Modules with trainable
  parameters are never folded, so a constant-fed ``nn.Embedding``
  (position embeddings) imports as a trainable embedding over a
  constant-id input;
* **SDPA decomposition**: ``F.scaled_dot_product_attention`` lowers to
  transpose → batch_matmul → scale → (+additive mask) → softmax →
  batch_matmul on the framework's own ops, as in the JAX package (so an
  imported HF model launches no flash-attention kernel).

The importer and the runtime share one ``torch``: the trace patches
(:func:`_hf_trace_patches`) touch transformers' own attributes only, and
every one is restored when the trace ends, an exception included, before
any op of the port runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _shape_of(node) -> Optional[Tuple[int, ...]]:
    tm = node.meta.get("tensor_meta")
    if tm is None or not hasattr(tm, "shape"):
        # multi-output nodes (split) carry a TUPLE of metadata — no single
        # shape exists; callers treat that like "unknown"
        return None
    return tuple(int(s) for s in tm.shape)


@contextlib.contextmanager
def _hf_trace_patches(model, batch_size: int, seq_length: int):
    """Work around upstream fx blockers during the trace (restored after):

    * ``masking_utils.create_causal_mask`` runs ``torch.vmap`` over fx
      proxies (untraceable); under static shapes the causal mask IS a
      constant, so return it as one (HF's own fx tests stub mask creation
      the same way).
    * GPT-2's attention unpacks ``key_states.shape`` (proxy iteration —
      metadata is lost on ``split`` outputs in transformers>=4.5x); swap
      in a functionally identical forward with STATIC shapes — the same
      static-shape contract the whole importer already assumes.
      Covers the no-cache, self-attention form (what an encoder-style
      import needs); cross-attention raises.
    """
    import sys

    import torch

    undo = []
    S = int(seq_length)
    # the constant mask lives where the module does (ShapeProp runs there)
    dev = next(iter(model.parameters()), torch.empty(0)).device

    def _const_causal(*a, **kw):
        # a padding mask proxy means the user wants masked attention —
        # the constant causal mask would silently attend padded positions
        import torch.fx as _fx

        am = kw.get("attention_mask")
        if am is None and len(a) > 2:
            am = a[2]
        if isinstance(am, _fx.Proxy):
            raise NotImplementedError(
                "decoder import with a padding attention_mask is not "
                "supported — trace with input_names=['input_ids'] (full "
                "sequences) or pre-pack the batch")
        m = torch.full((1, 1, S, S), -1e9, device=dev)
        return torch.triu(m, diagonal=1)

    # installed inside the try: a failure halfway restores what was set
    try:
        for name, mod in list(sys.modules.items()):
            if (name.startswith("transformers")
                    and getattr(mod, "create_causal_mask", None) is not None):
                undo.append((mod, "create_causal_mask", mod.create_causal_mask))
                mod.create_causal_mask = _const_causal

        try:
            from transformers.models.gpt2.modeling_gpt2 import GPT2Attention
        except ImportError:  # pragma: no cover - transformers layout change
            GPT2Attention = None
        if GPT2Attention is not None and any(
                isinstance(m, GPT2Attention) for m in model.modules()):
            B = int(batch_size)

            def gpt2_attn_forward(self, hidden_states, past_key_values=None,
                                  cache_position=None, attention_mask=None,
                                  head_mask=None, encoder_hidden_states=None,
                                  encoder_attention_mask=None,
                                  output_attentions=False, **kwargs):
                import torch.nn.functional as F

                if encoder_hidden_states is not None:
                    raise ValueError(
                        "GPT-2 cross-attention import is unsupported")
                if getattr(self, "scale_attn_by_inverse_layer_idx", False):
                    raise ValueError(
                        "scale_attn_by_inverse_layer_idx import unsupported")
                if not getattr(self, "scale_attn_weights", True):
                    # SDPA always scales by 1/sqrt(head_dim); an unscaled
                    # checkpoint would import silently wrong
                    raise ValueError(
                        "scale_attn_weights=False import unsupported")
                if head_mask is not None:
                    raise ValueError("GPT-2 head_mask import is unsupported")
                if self.training and getattr(self.attn_dropout, "p", 0.0) > 0:
                    # SDPA below runs with dropout_p=0: a checkpoint with
                    # attn_pdrop>0 imported for FINETUNING would silently
                    # diverge from torch (inference is exact either way)
                    raise ValueError(
                        "attn_pdrop>0 in training mode import unsupported")
                q, k, v = self.c_attn(hidden_states).split(self.split_size,
                                                           dim=2)
                H, D = self.num_heads, self.head_dim
                q = q.view(B, S, H, D).transpose(1, 2)
                k = k.view(B, S, H, D).transpose(1, 2)
                v = v.view(B, S, H, D).transpose(1, 2)
                out = F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attention_mask,
                    is_causal=attention_mask is None)
                out = out.transpose(1, 2).contiguous().view(B, S, H * D)
                out = self.c_proj(out)
                out = self.resid_dropout(out)
                return out, None

            undo.append((GPT2Attention, "forward", GPT2Attention.forward))
            GPT2Attention.forward = gpt2_attn_forward
        yield
    finally:
        for obj, attr, val in reversed(undo):
            setattr(obj, attr, val)


def trace_hf(model, input_names: Sequence[str] = ("input_ids",),
             batch_size: int = 2, seq_length: int = 16) -> List[Dict]:
    """Trace a transformers PreTrainedModel into the FF IR record list
    (the same schema torch_frontend.model._trace emits)."""
    import torch
    import torch.fx as fx
    from torch.fx.passes.shape_prop import ShapeProp
    from transformers.utils import fx as hf_fx

    from .model import _is_hf_conv1d

    class _Tracer(hf_fx.HFTracer):
        def is_leaf_module(self, m, module_qualified_name):
            # transformers' Conv1D (GPT-2 projections) must stay a leaf:
            # traced through, its weight/bias surface as raw get_attr
            # params with an addmm — opaque to the importer; as a leaf it
            # maps 1:1 onto dense (see _module_record)
            if _is_hf_conv1d(m):
                return True
            return super().is_leaf_module(m, module_qualified_name)

    with _hf_trace_patches(model, batch_size, seq_length):
        gm = hf_fx.symbolic_trace(model, input_names=list(input_names),
                                  tracer_cls=_Tracer)

    # example batch for shape propagation (ids → zeros; masks → ones), on
    # the module's device: the trace never moves the user's module
    dev = next(iter(model.parameters()), torch.empty(0)).device
    examples = []
    for n in input_names:
        if "mask" in n:
            examples.append(torch.ones(batch_size, seq_length, dtype=torch.long, device=dev))
        else:
            examples.append(torch.zeros(batch_size, seq_length, dtype=torch.long, device=dev))
    ShapeProp(gm).propagate(*examples)

    records: List[Dict] = []
    outputs: List[str] = []
    const_val: Dict[str, object] = {}   # fx node name -> torch value
    emitted_const: set = set()          # const nodes materialized as records
    name_of: Dict[str, str] = {}        # fx node name -> IR name producing it

    def is_const(node) -> bool:
        return node.name in const_val

    def ref(node) -> str:
        """IR name for a node used as a dynamic input; materializes folded
        constants on first use."""
        if is_const(node) and node.name not in emitted_const:
            v = const_val[node.name]
            if not isinstance(v, torch.Tensor):
                raise ValueError(
                    f"{node.name}: non-tensor constant {type(v).__name__} "
                    f"cannot feed a dynamic op")
            records.append({
                "name": node.name, "kind": "constant", "op": "constant",
                "inputs": [],
                "attrs": {"value": v.detach().cpu().numpy().tolist(),
                          "vdtype": str(v.dtype).replace("torch.", "")},
            })
            emitted_const.add(node.name)
        return name_of.get(node.name, node.name)

    def fold_args(a):
        if isinstance(a, fx.Node):
            if not is_const(a):
                raise _Dynamic(a)
            return const_val[a.name]
        if isinstance(a, (tuple, list)):
            return type(a)(fold_args(x) for x in a)
        if isinstance(a, dict):
            return {k: fold_args(v) for k, v in a.items()}
        if isinstance(a, slice):
            return slice(fold_args(a.start), fold_args(a.stop),
                         fold_args(a.step))
        return a

    class _Dynamic(Exception):
        def __init__(self, node):
            self.node = node

    def try_fold(node) -> bool:
        """Execute the node at trace time when its inputs are constants.
        Modules with parameters are never folded (stay trainable)."""
        try:
            if node.op == "get_attr":
                target = node.target
                obj = gm
                for part in target.split("."):
                    obj = getattr(obj, part)
                if isinstance(obj, torch.nn.Parameter):
                    return False  # trainable → keep dynamic
                const_val[node.name] = obj
                return True
            if node.op == "call_function":
                args = fold_args(node.args)
                kwargs = fold_args(node.kwargs)
                const_val[node.name] = node.target(*args, **kwargs)
                return True
            if node.op == "call_method":
                args = fold_args(node.args)
                kwargs = fold_args(node.kwargs)
                const_val[node.name] = getattr(args[0], node.target)(*args[1:], **kwargs)
                return True
            if node.op == "call_module":
                mod = gm.get_submodule(node.target)
                if any(True for _ in mod.parameters()):
                    return False
                args = fold_args(node.args)
                kwargs = fold_args(node.kwargs)
                was = mod.training
                mod.eval()
                with torch.no_grad():
                    const_val[node.name] = mod(*args, **kwargs)
                mod.train(was)
                return True
        except _Dynamic:
            return False
        except Exception:
            return False
        return False

    def rec(name, op, inputs, attrs=None, kind="function"):
        records.append({"name": name, "kind": kind, "op": op,
                        "inputs": inputs, "attrs": attrs or {}})

    def emit_sdpa(node):
        """F.scaled_dot_product_attention(q, k, v, attn_mask=...,
        is_causal=...) → transpose/batch_matmul/scale/softmax records."""
        q, k, v = node.args[:3]
        attn_mask = node.kwargs.get("attn_mask",
                                    node.args[3] if len(node.args) > 3 else None)
        is_causal = bool(node.kwargs.get("is_causal", False))
        if is_causal:
            qs = _shape_of(q)
            ks = _shape_of(k)
            m = np.triu(np.full((qs[-2], ks[-2]), -1e9, np.float32), k=1)
            mask_val = torch.from_numpy(m)
        elif attn_mask is None:
            mask_val = None
        elif isinstance(attn_mask, torch.Tensor):
            # a raw tensor baked in at trace time (the patched
            # create_causal_mask returns a concrete constant)
            mask_val = attn_mask
        else:
            if not is_const(attn_mask):
                raise ValueError(
                    f"{node.name}: dynamic attn_mask is not importable "
                    f"(mask must fold to a constant at trace time)")
            mask_val = const_val[attn_mask.name]
            if torch.count_nonzero(mask_val) == 0:
                mask_val = None  # all-zero additive mask: no-op
        d = _shape_of(q)[-1]
        scale = node.kwargs.get("scale")
        if scale is None:
            scale = 1.0 / math.sqrt(d)
        # dropout_p is a train-time knob; import carries eval semantics
        # (the same convention the module path uses for nn.Dropout rates)
        kt = f"{node.name}__kT"
        rec(kt, "transpose2", [ref(k)], {"dims": [-1, -2]})
        s = f"{node.name}__scores"
        rec(s, "batch_matmul", [ref(q), kt])
        sc = f"{node.name}__scaled"
        rec(sc, "scalar_multiply", [s], {"scalar": float(scale)})
        cur = sc
        if mask_val is not None:
            mname = f"{node.name}__mask"
            records.append({
                "name": mname, "kind": "constant", "op": "constant",
                "inputs": [],
                "attrs": {"value": mask_val.detach().cpu().float().numpy().tolist(),
                          "vdtype": "float32"}})
            masked = f"{node.name}__masked"
            rec(masked, "add", [cur, mname])
            cur = masked
        p = f"{node.name}__probs"
        rec(p, "softmax", [cur], {"axis": -1})
        rec(node.name, "batch_matmul", [p, ref(v)])

    import operator

    from .model import NodeRef, _function_record, _module_record

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            rec(node.name, "input", [], kind="input")
            continue
        if node.op == "output":
            def _flat(a):
                if isinstance(a, fx.Node):
                    outputs.append(ref(a))
                elif isinstance(a, (tuple, list)):
                    for x in a:
                        _flat(x)
                elif isinstance(a, dict):
                    for x in a.values():
                        _flat(x)
                elif hasattr(a, "__dict__"):  # HF ModelOutput dataclass
                    for x in vars(a).values():
                        _flat(x)
            _flat(node.args)
            continue
        if try_fold(node):
            continue

        # ---- dynamic node → IR ------------------------------------------
        if node.op == "call_module":
            mod = gm.get_submodule(node.target)
            bad_kwargs = [k for k, v in node.kwargs.items()
                          if isinstance(v, fx.Node) and not is_const(v)]
            if bad_kwargs:  # same guard as the plain tracer (model.py)
                raise ValueError(
                    f"{node.name}: tensor kwargs {bad_kwargs} on "
                    f"{type(mod).__name__} are not importable")
            ins = [ref(a) for a in node.args if isinstance(a, fx.Node)]
            r = _module_record(node.name, mod, ins)
            r["module_path"] = node.target
            records.append(r)
            continue

        tgt = node.target
        if node.op == "call_function" and getattr(
                tgt, "__name__", "") == "scaled_dot_product_attention":
            emit_sdpa(node)
            continue
        if node.op == "call_method" and tgt in ("view", "reshape", "expand"):
            out_shape = _shape_of(node)
            in_shape = _shape_of(node.args[0])
            if out_shape is None:
                raise ValueError(f"{node.name}: no propagated shape")
            if tgt == "expand":
                if tuple(in_shape) == tuple(out_shape):
                    name_of[node.name] = ref(node.args[0])
                    continue
                raise ValueError(
                    f"{node.name}: dynamic expand {in_shape}->{out_shape} "
                    f"is a broadcast, not importable as reshape")
            if int(np.prod(in_shape)) != int(np.prod(out_shape)):
                raise ValueError(
                    f"{node.name}: view {in_shape}->{out_shape} changes volume")
            shape = [0 if i == 0 and s == batch_size else int(s)
                     for i, s in enumerate(out_shape)]
            rec(node.name, "reshape", [ref(node.args[0])], {"shape": shape})
            continue
        if node.op == "call_method" and tgt in ("size", "dim"):
            # folds via shape propagation: consumers see plain ints
            shp = _shape_of(node.args[0])
            if tgt == "dim":
                const_val[node.name] = len(shp)
            elif len(node.args) > 1:
                const_val[node.name] = int(shp[int(node.args[1])])
            else:
                const_val[node.name] = torch.Size(shp)
            continue
        if node.op == "call_method" and tgt == "to":
            # dtype casts on dynamic tensors: identity under fp32 import
            name_of[node.name] = ref(node.args[0])
            continue
        if node.op == "call_function" and tgt is getattr \
                and isinstance(node.args[0], fx.Node):
            # attribute reads on dynamic tensors fold through shape prop
            attr = node.args[1]
            if attr == "shape":
                const_val[node.name] = torch.Size(_shape_of(node.args[0]))
                continue
            if attr in ("dtype", "device"):
                tm = node.args[0].meta.get("tensor_meta")
                const_val[node.name] = getattr(tm, "dtype", torch.float32) \
                    if attr == "dtype" else torch.device("cpu")
                continue
            raise ValueError(f"{node.name}: getattr({attr!r}) not importable")
        if node.op == "call_function" and tgt is operator.getitem \
                and isinstance(node.args[0], fx.Node) and is_const(node.args[0]):
            # e.g. shape[1] on a folded torch.Size, or slicing a folded
            # buffer where the slice bounds were themselves folded ints
            try:
                idx = fold_args(node.args[1])
            except _Dynamic:
                raise ValueError(
                    f"{node.name}: dynamic index into a constant is not "
                    f"importable")
            const_val[node.name] = const_val[node.args[0].name][idx]
            continue

        if node.op == "call_function" and tgt is operator.getitem \
                and isinstance(node.args[0], fx.Node) \
                and _shape_of(node.args[0]) is not None:
            # tensor slicing on a dynamic tensor (e.g. the pooler's
            # hidden_states[:, 0]) → the static Slice op
            try:
                idx = fold_args(node.args[1])
            except _Dynamic:
                idx = None
            if idx is not None:
                if not isinstance(idx, tuple):
                    idx = (idx,)
                items = []
                ok = True
                for it in idx:
                    if isinstance(it, slice):
                        items.append({
                            "kind": "slice",
                            "start": None if it.start is None else int(it.start),
                            "stop": None if it.stop is None else int(it.stop),
                            "step": None if it.step is None else int(it.step)})
                    elif isinstance(it, int):
                        items.append({"kind": "int", "i": int(it)})
                    else:
                        ok = False
                        break
                if ok:
                    rec(node.name, "slice", [ref(node.args[0])],
                        {"items": items})
                    continue

        # generic path: reuse the plain-fx converter, with const args
        # materialized as constant records and already-renamed dynamic
        # inputs wrapped as NodeRefs
        class _Shim:
            pass

        shim = _Shim()
        shim.op = node.op
        shim.target = node.target
        shim.name = node.name
        shim.kwargs = {k: v for k, v in node.kwargs.items()}
        shim.args = tuple(
            NodeRef(ref(a)) if isinstance(a, fx.Node) else a
            for a in node.args)
        records.append(_function_record(shim, torch, torch.nn.functional))
    rec("__outputs__", "output", outputs, kind="output")
    return records
