"""Structural graph substitutions (GraphXfer), the rewrite half.

PyTorch counterpart of the first half of ``flexflow_tpu/search/graph_xfer.py``
(the reference's ``GraphXfer::run``, substitution.cc:596, and its
programmatic generators). The hand-written compute rewrites compete in the
same frontier DP as the original graph (``search/unity.py``):

- :class:`LinearActivationFusion`: ``linear → relu/sigmoid/tanh/gelu``
  becomes one Linear with the activation fused (the reference's
  ``create_linear_relu_merge``, substitution.cc:1790);
- :class:`ParallelLinearMerge`: ``concat(linear_1(x)..linear_k(x))`` on the
  feature dim becomes one Linear with the summed out-dim, one large GEMM
  in place of k small ones;
- :class:`ParallelConvMerge`: the same for same-geometry parallel Conv2Ds
  feeding a channel concat (inception blocks).

Rewrites never mutate the builder graph: new Layers are created and the
replaced subgraph's boundary output Tensor is re-used as the new layer's
output, so consumers and the logits tensor are untouched.

The reference's GraphXfer JSON schema (``{"rule": [...]}``,
substitution_loader.h:168) is read by :func:`load_graphxfer_rules`, which
classifies every rule (resharding, structural, unsupported);
:mod:`.rule_interpreter` turns its compute rewrites into
:class:`GraphRewrite` passes that compete with the ones above.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from ..ffconst import ActiMode, OpType
from ..core.layer import Layer

# ---------------------------------------------------------------- rewrites

_ACT_OF_UNARY = {
    OpType.RELU: ActiMode.RELU,
    OpType.SIGMOID: ActiMode.SIGMOID,
    OpType.TANH: ActiMode.TANH,
    OpType.GELU: ActiMode.GELU,
}


def _consumer_count(layers: Sequence[Layer]) -> Dict[int, int]:
    n: Dict[int, int] = {}
    for l in layers:
        for t in l.inputs:
            n[t.tensor_id] = n.get(t.tensor_id, 0) + 1
    return n


class GraphRewrite:
    """One structural substitution kind (reference: one GraphXfer).

    ``protected`` carries tensor ids that must survive as produced graph
    outputs (the logits tensor, an explicit ``logits_tensor=`` override) —
    a rewrite that would eliminate one is not a legal site, the same
    contract ops/fused.py's ``apply_fusion`` honors."""

    name: str = "rewrite"

    def find(self, layers: Sequence[Layer],
             protected: frozenset = frozenset()) -> List[Tuple]:
        raise NotImplementedError

    def apply(self, layers: List[Layer], site: Tuple) -> List[Layer]:
        raise NotImplementedError

    def apply_all(self, layers: List[Layer],
                  protected: frozenset = frozenset()) -> List[Layer]:
        """Apply at every non-overlapping site until fixpoint (bounded —
        each application strictly shrinks the layer count, so this
        terminates)."""
        for _ in range(len(layers)):
            sites = self.find(layers, protected)
            if not sites:
                break
            layers = self.apply(layers, sites[0])
        return layers


class LinearActivationFusion(GraphRewrite):
    """reference: create_linear_relu_merge (substitution.cc:1790) —
    generalized to sigmoid/tanh/gelu (the op set dense() itself fuses)."""

    name = "linear_activation_fusion"

    def find(self, layers, protected=frozenset()):
        # producers resolved from THIS list (a prior rewrite's clone reuses
        # the original output tensor, whose .owner_layer still points at
        # the builder layer — tensor id is the truth here, like compile's
        # toposort)
        produced = {l.outputs[0].tensor_id: i
                    for i, l in enumerate(layers) if l.outputs}
        consumers = _consumer_count(layers)
        sites = []
        for ui, unary in enumerate(layers):
            act = _ACT_OF_UNARY.get(unary.op_type)
            if act is None or len(unary.inputs) != 1:
                continue
            li = produced.get(unary.inputs[0].tensor_id)
            if li is None:
                continue
            src = layers[li]
            if src.op_type is not OpType.LINEAR:
                continue
            if src.attrs.get("activation", ActiMode.NONE) is not ActiMode.NONE:
                continue
            tid = src.outputs[0].tensor_id
            if consumers.get(tid, 0) != 1 or tid in protected:
                continue  # the intermediate is read elsewhere: keep it
            sites.append((li, ui, act))
        return sites

    def apply(self, layers, site):
        li, ui, act = site
        lin, unary = layers[li], layers[ui]
        fused = Layer(OpType.LINEAR, name=lin.name, inputs=list(lin.inputs),
                      attrs={**lin.attrs, "activation": act,
                             "_origin_rewrite": self.name})
        fused.outputs = [unary.outputs[0]]
        out = []
        for i, l in enumerate(layers):
            if i == li:
                out.append(fused)
            elif i != ui:
                out.append(l)
        return out


def _concat_axis(layer: Layer) -> int:
    axis = layer.attrs.get("axis", 0)
    nd = len(layer.inputs[0].dims)
    return axis % nd


class _ParallelMerge(GraphRewrite):
    """Shared machinery: k same-shaped ops on ONE input, all feeding one
    concat, merged into a single wide op producing the concat's tensor."""

    op_type: OpType = OpType.LINEAR
    concat_axis_of = staticmethod(lambda nd: nd - 1)

    def _mergeable(self, branches: List[Layer]) -> bool:
        raise NotImplementedError

    def _merged_layer(self, branches: List[Layer]) -> Layer:
        raise NotImplementedError

    def find(self, layers, protected=frozenset()):
        produced = {l.outputs[0].tensor_id: i
                    for i, l in enumerate(layers) if l.outputs}
        consumers = _consumer_count(layers)
        sites = []
        for ci, cat in enumerate(layers):
            if cat.op_type is not OpType.CONCAT or len(cat.inputs) < 2:
                continue
            if any(t.tensor_id in protected for t in cat.inputs):
                continue  # a branch output must survive as a graph output
            nd = len(cat.inputs[0].dims)
            if _concat_axis(cat) != self.concat_axis_of(nd):
                continue
            bidx = [produced.get(t.tensor_id) for t in cat.inputs]
            if any(i is None for i in bidx):
                continue
            branches = [layers[i] for i in bidx]
            if any(b.op_type is not self.op_type for b in branches):
                continue
            if len(set(bidx)) != len(bidx):
                continue  # one branch used twice: widths would double-count
            # all branches read the SAME tensor and are consumed ONLY here
            x = branches[0].inputs[0]
            if any(len(b.inputs) != 1 or b.inputs[0].tensor_id != x.tensor_id
                   for b in branches):
                continue
            if any(consumers.get(b.outputs[0].tensor_id, 0) != 1
                   for b in branches):
                continue
            if not self._mergeable(branches):
                continue
            sites.append((ci, tuple(bidx)))
        return sites

    def apply(self, layers, site):
        ci, branch_idx = site
        cat = layers[ci]
        branches = [layers[i] for i in branch_idx]
        merged = self._merged_layer(branches)
        # provenance: validator/compiler findings on this layer name the
        # rule that created it
        merged.attrs["_origin_rewrite"] = self.name
        merged.outputs = [cat.outputs[0]]
        drop = set(branch_idx) | {ci}
        first = min(branch_idx)
        out = []
        for i, l in enumerate(layers):
            if i == first:
                out.append(merged)
            if i not in drop:
                out.append(l)
        return out


class ParallelLinearMerge(_ParallelMerge):
    """concat(linear_i(x), axis=-1) → one Linear(sum out_dims): k GEMMs
    become one large matmul (reference inception combine family,
    substitution.cc:3099; the merged weight is the block-column concat, so
    the function class is identical)."""

    name = "parallel_linear_merge"
    op_type = OpType.LINEAR

    def _mergeable(self, branches):
        a0 = branches[0].attrs
        return all(
            b.attrs.get("activation", ActiMode.NONE)
            == a0.get("activation", ActiMode.NONE)
            and b.attrs.get("use_bias", True) == a0.get("use_bias", True)
            and not b.attrs.get("kernel_initializer")
            and not b.attrs.get("bias_initializer")
            for b in branches
        )

    def _merged_layer(self, branches):
        out_dim = sum(b.attrs["out_dim"] for b in branches)
        a0 = branches[0].attrs
        return Layer(
            OpType.LINEAR,
            name="merged_" + "_".join(b.name for b in branches),
            inputs=[branches[0].inputs[0]],
            attrs=dict(out_dim=out_dim,
                       activation=a0.get("activation", ActiMode.NONE),
                       use_bias=a0.get("use_bias", True)),
        )


class ParallelConvMerge(_ParallelMerge):
    """concat(conv_i(x), axis=1) → one Conv2D(sum out_channels) for
    same-geometry branches (inception blocks; NCHW channel axis)."""

    name = "parallel_conv_merge"
    op_type = OpType.CONV2D
    concat_axis_of = staticmethod(lambda nd: 1)

    _GEOM = ("kernel", "stride", "padding", "groups", "activation",
             "use_bias")

    def _mergeable(self, branches):
        a0 = branches[0].attrs
        return all(
            all(b.attrs.get(k) == a0.get(k) for k in self._GEOM)
            and b.attrs.get("groups", 1) == 1
            and not b.attrs.get("kernel_initializer")
            and not b.attrs.get("bias_initializer")
            for b in branches
        )

    def _merged_layer(self, branches):
        a0 = dict(branches[0].attrs)
        a0["out_channels"] = sum(b.attrs["out_channels"] for b in branches)
        return Layer(
            OpType.CONV2D,
            name="merged_" + "_".join(b.name for b in branches),
            inputs=[branches[0].inputs[0]],
            attrs=a0,
        )


BUILTIN_REWRITES: List[GraphRewrite] = [
    LinearActivationFusion(),
    ParallelLinearMerge(),
    ParallelConvMerge(),
]


def graph_variants(
    layers: List[Layer],
    config=None,
    rewrites: Optional[Sequence[GraphRewrite]] = None,
    max_variants: int = 8,
    protected: Optional[frozenset] = None,
) -> List[Tuple[List[str], List[Layer]]]:
    """Bounded graph-variant enumeration for the search.

    Variant 0 is always the original graph. Each rewrite kind applied at
    all its sites contributes one variant, plus the all-kinds fixpoint —
    the DP then picks the cheapest graph by simulated step time
    (reference: GraphSearchHelper's best-first search over xfer-derived
    graphs, substitution.cc:1898; kind-granularity keeps the candidate
    count bounded the way its budget does).
    """
    if config is not None and not getattr(config, "enable_graph_rewrites", True):
        return [([], layers)]
    rewrites = list(rewrites if rewrites is not None else BUILTIN_REWRITES)
    protected = frozenset(protected or ())

    def sig(ls: Sequence[Layer]) -> Tuple:
        return tuple(
            (l.op_type, tuple(t.tensor_id for t in l.inputs),
             tuple(t.tensor_id for t in l.outputs))
            for l in ls
        )

    variants: List[Tuple[List[str], List[Layer]]] = [([], layers)]
    seen = {sig(layers)}
    # composed fixpoint over all kinds (e.g. merge parallel linears, then
    # fuse the following activation into the merged GEMM) goes FIRST so a
    # large interpreted-rule set cannot push it past the variant cap
    cur, applied = list(layers), []
    for _ in range(4):
        before = sig(cur)
        for rw in rewrites:
            nxt = rw.apply_all(cur, protected)
            if sig(nxt) != sig(cur):
                applied.append(rw.name)
                cur = nxt
        if sig(cur) == before:
            break
    if sig(cur) not in seen:
        seen.add(sig(cur))
        variants.append((applied, cur))
    for rw in rewrites:
        if len(variants) >= max_variants:
            break
        nl = rw.apply_all(list(layers), protected)
        if sig(nl) not in seen:
            seen.add(sig(nl))
            variants.append(([rw.name], nl))
    return variants[:max_variants]


def rehydrate_variant(
    layers: List[Layer],
    rewrites: Sequence[str],
    config=None,
    protected: Optional[frozenset] = None,
) -> Optional[List[Layer]]:
    """Re-derive the layer list a stored rewrite signature referred to, by
    replaying the SAME bounded variant enumeration the search ran
    (search/cache.py stores only rewrite names — Layer objects never leave
    the process). Returns None when no current variant carries that
    signature: the rule set or the graph changed, and the caller must
    treat the stored result as a cache miss."""
    rewrites = list(rewrites)
    if not rewrites:
        return list(layers)
    for applied, vlayers in graph_variants(
            layers, config,
            rewrites=getattr(config, "_graphxfer_rewrites", None)
            if config is not None else None,
            protected=protected):
        if list(applied) == rewrites:
            return vlayers
    return None


# ------------------------------------------------- reference JSON rule file

RESHARDING_OPS = {
    "OP_PARTITION", "OP_COMBINE", "OP_REPLICATE", "OP_REDUCE", "OP_NOOP",
    "OP_PIPELINE", "OP_FUSED_PARALLEL",
}

# op names whose compute semantics exist in this framework
SUPPORTED_COMPUTE_OPS = {
    "OP_LINEAR", "OP_CONV2D", "OP_POOL2D_MAX", "OP_RELU", "OP_SIGMOID",
    "OP_TANH", "OP_GELU", "OP_ELU", "OP_IDENTITY", "OP_CONCAT", "OP_SPLIT",
    "OP_SOFTMAX", "OP_EW_ADD", "OP_EW_MUL", "OP_EW_SUB", "OP_EW_DIV",
    "OP_EW_MAX", "OP_EW_MIN", "OP_RESHAPE", "OP_TRANSPOSE", "OP_FLAT",
    "OP_BATCHNORM", "OP_LAYERNORM", "OP_EMBEDDING", "OP_MULTIHEAD_ATTENTION",
    "OP_BATCHMATMUL", "OP_MATMUL", "OP_DROPOUT", "OP_CAST", "OP_EXP",
    "OP_SIN", "OP_COS", "OP_POW", "OP_SQRT", "OP_RSQRT", "OP_SCALAR_ADD",
    "OP_SCALAR_MULTIPLY", "OP_SCALAR_SUB", "OP_SCALAR_TRUE_DIV", "OP_TOPK",
    "OP_GROUP_BY", "OP_AGGREGATE", "OP_AGG_SPEC", "OP_CACHE", "OP_MEAN",
    "OP_REDUCE_SUM", "OP_REDUCE_MEAN", "OP_SLICE", "OP_SQUEEZE",
    "OP_UNSQUEEZE", "OP_REVERSE", "OP_GATHER",
}


@dataclasses.dataclass
class XferRuleOp:
    """One Operator node in a rule (substitution_loader.h:151)."""

    type: str
    inputs: List[Tuple[int, int]]  # (opId, tsId); opId<0 = graph input
    params: Dict[str, int]


@dataclasses.dataclass
class XferRule:
    """One Rule (substitution_loader.h:168). ``kind``:

    * ``"resharding"`` — every op is a parallel op: the rule moves
      collectives, which GSPMD derives from sharding specs; subsumed.
    * ``"structural"`` — contains compute ops we implement; candidates for
      translation to :class:`GraphRewrite` moves.
    * ``"unsupported"`` — uses TASO-specific ops with no analog here
      (OP_ENLARGE, OP_MERGE_GCONV, constant folding helpers...).
    """

    name: str
    src_ops: List[XferRuleOp]
    dst_ops: List[XferRuleOp]
    mapped_outputs: List[Tuple[int, int, int, int]]
    kind: str = "unsupported"


@dataclasses.dataclass
class RuleCollection:
    rules: List[XferRule]

    def counts(self) -> Dict[str, int]:
        out = {"resharding": 0, "structural": 0, "unsupported": 0}
        for r in self.rules:
            out[r.kind] += 1
        return out


def _parse_op(j: dict) -> XferRuleOp:
    return XferRuleOp(
        type=str(j["type"]),
        inputs=[(int(t["opId"]), int(t["tsId"])) for t in j.get("input", [])],
        params={str(p["key"]): int(p["value"]) for p in j.get("para", [])},
    )


def _classify(rule: XferRule) -> str:
    ops = {o.type for o in rule.src_ops} | {o.type for o in rule.dst_ops}
    if ops <= RESHARDING_OPS:
        return "resharding"
    if ops <= (RESHARDING_OPS | SUPPORTED_COMPUTE_OPS):
        return "structural"
    return "unsupported"


def load_graphxfer_rules(path_or_data) -> RuleCollection:
    """Load a rule file in the REFERENCE's schema
    (substitutions/graph_subst_3_v2.json; substitution_loader.cc:55-78:
    ``{"rule": [{name, srcOp, dstOp, mappedOutput}]}``) and classify every
    rule. Accepts a path or an already-parsed dict (callers that peeked at
    the schema needn't re-parse). Never raises on a well-formed file —
    unknown op/param names classify the rule as unsupported rather than
    failing the load, because the library spans TASO's op set, not ours."""
    if isinstance(path_or_data, dict):
        data = path_or_data
    else:
        with open(path_or_data) as f:
            data = json.load(f)
    rules = []
    for j in data.get("rule", []):
        r = XferRule(
            name=str(j.get("name", f"rule_{len(rules)}")),
            src_ops=[_parse_op(o) for o in j.get("srcOp", [])],
            dst_ops=[_parse_op(o) for o in j.get("dstOp", [])],
            mapped_outputs=[
                (int(m["srcOpId"]), int(m["srcTsId"]),
                 int(m["dstOpId"]), int(m["dstTsId"]))
                for m in j.get("mappedOutput", [])
            ],
        )
        r.kind = _classify(r)
        rules.append(r)
    return RuleCollection(rules)


def rules_to_rewrites(collection: RuleCollection) -> List[GraphRewrite]:
    """Subsumed by the generic interpreter: every rule is normalized to
    activation-dataflow graphlets and compute rewrites are instantiated
    as generic :class:`~.rule_interpreter.JsonRuleRewrite` passes (the
    reference builds a GraphXfer per rule, substitution.cc:596 — though
    its own ``create_xfers`` filter keeps only 3 of the 640,
    substitution.cc:1666-1706). Kept as the stable entry point; see
    :func:`~.rule_interpreter.interpret_rules` for the audit report."""
    from .rule_interpreter import interpret_rules

    rewrites, _ = interpret_rules(collection)
    return rewrites
