"""The reference's GraphXfer rule schema in the port
(``flexflow_tpu_torch/search/graph_xfer.py``'s loader and
``search/rule_interpreter.py``) held to the JAX package on rule sets the
tests write in the reference's schema: the counterparts of
``tests/test_graph_xfer.py:174-289`` and
``tests/test_rule_interpreter.py:153``. The loader's taxonomy, the
interpreter's report and classes, and each rewrite's sites and rewritten
layer lists (names, op types, shapes and wiring) equal JAX's; a rewritten
graph's forward equals the unrewritten one within f32 1e-5 of the largest
|logit|, and ``compile`` with a ``{"rule": [...]}`` file picks JAX's
variant. The 640-rule library itself (``graph_subst_3_v2.json``) is not in
the repository, so its taxonomy waits (ROADMAP)."""

import json
import re

import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.search import graph_xfer as jxfer
from flexflow_tpu.search import rule_interpreter as jri
from flexflow_tpu_torch.runtime.model import load_numpy_params
from flexflow_tpu_torch.search import graph_xfer as txfer
from flexflow_tpu_torch.search import rule_interpreter as tri

FWD_TOL = 1e-5  # f32, of the largest |logit|


def _op(kind, inputs, **para):
    return {"type": kind, "input": [{"opId": o, "tsId": t} for o, t in inputs],
            "para": [{"key": k, "value": v} for k, v in para.items()]}


def _rule(name, src, dst, mapped):
    return {"name": name, "srcOp": src, "dstOp": dst,
            "mappedOutput": [{"srcOpId": a, "srcTsId": b, "dstOpId": c, "dstTsId": d}
                             for a, b, c, d in mapped]}


# linear (weight -4) + relu -> one linear with the relu fused (PM_ACTI 2)
FUSE = _rule("fuse",
             [_op("OP_LINEAR", [(-1, 0), (-4, 0)], PM_ACTI=0), _op("OP_RELU", [(0, 0)])],
             [_op("OP_LINEAR", [(-1, 0), (-4, 0)], PM_ACTI=2)],
             [(1, 0, 0, 0)])
# linear_relu_merge as tests/test_graph_xfer.py writes it (no weight operand)
LINEAR_RELU_MERGE = _rule(
    "linear_relu_merge",
    [_op("OP_LINEAR", [(-1, 0)], PM_ACTI=0), _op("OP_RELU", [(0, 0)])],
    [_op("OP_LINEAR", [(-1, 0)], PM_ACTI=2)], [(1, 0, 0, 0)])
# two linears on one input into a feature concat -> one linear over the
# concatenated weights
PARALLEL_MERGE = _rule(
    "parallel_linear_merge",
    [_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0),
     _op("OP_LINEAR", [(-1, 0), (-3, 0)], PM_ACTI=0),
     _op("OP_CONCAT", [(0, 0), (1, 0)], PM_AXIS=2, PM_NUMDIM=3)],
    [_op("OP_CONCAT", [(-2, 0), (-3, 0)], PM_AXIS=1, PM_NUMDIM=2),
     _op("OP_LINEAR", [(-1, 0), (0, 0)], PM_ACTI=0)],
    [(2, 0, 1, 0)])
PARTITION_SWAP = _rule(
    "partition_swap",
    [_op("OP_PARTITION", [(-1, 0)], PM_PARALLEL_DIM=1, PM_PARALLEL_DEGREE=2)],
    [_op("OP_PARTITION", [(-1, 0)], PM_PARALLEL_DIM=2, PM_PARALLEL_DEGREE=2)],
    [(0, 0, 0, 0)])
ENLARGE = _rule("enlarge_rule", [_op("OP_ENLARGE", [(-1, 0)])],
                [_op("OP_NOOP", [(-1, 0)])], [])
# a tensor-parallel decomposition: replicate -> linear -> reduce
TP_DECOMP = _rule(
    "tp_decomp",
    [_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0)],
    [_op("OP_REPLICATE", [(-1, 0)], PM_PARALLEL_DIM=2, PM_PARALLEL_DEGREE=2),
     _op("OP_LINEAR", [(0, 0), (-2, 0)], PM_ACTI=0),
     _op("OP_REDUCE", [(1, 0)], PM_PARALLEL_DIM=2, PM_PARALLEL_DEGREE=2)],
    [(0, 0, 2, 0)])
# the same graphlet on both sides, a partition moved past a relu
MOTION = _rule(
    "relu_partition_motion",
    [_op("OP_PARTITION", [(-1, 0)], PM_PARALLEL_DIM=1, PM_PARALLEL_DEGREE=2),
     _op("OP_RELU", [(0, 0)])],
    [_op("OP_RELU", [(-1, 0)]),
     _op("OP_PARTITION", [(0, 0)], PM_PARALLEL_DIM=1, PM_PARALLEL_DEGREE=2)],
    [(1, 0, 1, 0)])
# tied weights: one weight external feeding two linears
TIED = _rule(
    "tied",
    [_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0),
     _op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0),
     _op("OP_EW_ADD", [(0, 0), (1, 0)])],
    [_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0),
     _op("OP_EW_ADD", [(0, 0), (0, 0)])],
    [(2, 0, 1, 0)])

# an op outside the activation graphlets' set (softmax) on the path
SOFTMAX = _rule(
    "linear_softmax",
    [_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0), _op("OP_SOFTMAX", [(0, 0)])],
    [_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0), _op("OP_SOFTMAX", [(0, 0)])],
    [(1, 0, 1, 0)])

RULE_SETS = {
    "mini": [LINEAR_RELU_MERGE, PARTITION_SWAP, ENLARGE],
    "fuse": [FUSE],
    "merge": [PARALLEL_MERGE],
    "mixed": [FUSE, PARALLEL_MERGE, TP_DECOMP, MOTION, TIED, ENLARGE, PARTITION_SWAP,
              SOFTMAX, dict(FUSE, name="fuse_again")],
}


@pytest.fixture(autouse=True)
def _ledger_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_LEDGER_DIR", str(tmp_path / "ledger"))


# ------------------------------------------------------------- the models
def _mlp(pkg, n_hidden=2, B=16):
    """dense→relu chains: what the fusion rules target."""
    ff = (J.FFModel(J.FFConfig(batch_size=B)) if pkg == "jax"
          else T.FFModel(T.FFConfig(batch_size=B, device="cpu")))
    x = ff.create_tensor((B, 32), name="x")
    h = x
    for i in range(n_hidden):
        h = ff.relu(ff.dense(h, 64, name=f"d{i}"), name=f"r{i}")
    ff.dense(h, 8, name="out")
    return ff


def _branchy(pkg, B=16):
    """Parallel linears into a feature concat: what the merge rule targets."""
    ff = (J.FFModel(J.FFConfig(batch_size=B)) if pkg == "jax"
          else T.FFModel(T.FFConfig(batch_size=B, device="cpu")))
    x = ff.create_tensor((B, 32), name="x")
    a = ff.dense(x, 24, name="ba")
    b = ff.dense(x, 24, name="bb")
    cat = ff.concat([a, b], axis=-1, name="cat")
    h = ff.relu(ff.dense(cat, 48, name="mid"), name="act")
    ff.dense(h, 8, name="out")
    return ff


MODELS = {"mlp": _mlp, "branchy": _branchy}
_AUTO = re.compile(r"^[a-z_]+_\d+$")


def _canon(layers):
    """A layer list without the process-global name counters: explicit
    names, op types, activations, output dims and each input's producer
    (list index and output slot, or the graph input's name)."""
    pos = {t.tensor_id: (i, k) for i, l in enumerate(layers) for k, t in enumerate(l.outputs)}
    rows = []
    for l in layers:
        act = l.attrs.get("activation")
        rows.append((
            "<auto>" if _AUTO.match(l.name) else l.name,
            l.op_type.value,
            None if act is None else act.name,
            tuple(tuple(t.dims) for t in l.outputs),
            tuple(pos.get(t.tensor_id, ("in", t.name)) for t in l.inputs),
            l.attrs.get("_origin_rewrite")))
    return rows


def _interpret(mod, rules):
    load = jxfer.load_graphxfer_rules if mod is jri else txfer.load_graphxfer_rules
    return mod.interpret_rules(load({"rule": rules}))


# ------------------------------------------------------------- the loader
def test_reference_rule_schema_roundtrip(tmp_path):
    """tests/test_graph_xfer.py's miniature file in the reference schema:
    the same taxonomy from a path, one JSON rewrite named as JAX names it."""
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rule": RULE_SETS["mini"]}))
    coll = txfer.load_graphxfer_rules(str(p))
    jcoll = jxfer.load_graphxfer_rules(str(p))
    assert coll.counts() == jcoll.counts() == {"resharding": 1, "structural": 1,
                                               "unsupported": 1}
    rewrites = txfer.rules_to_rewrites(coll)
    jrw = jxfer.rules_to_rewrites(jcoll)
    assert [r.name for r in rewrites] == [r.name for r in jrw] == ["json:linear_relu_merge"]
    assert rewrites[0].rule_names == jrw[0].rule_names == ["linear_relu_merge"]


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_taxonomy_equals_jax(name):
    """The loader's kinds, every rule's refined class and the
    interpreter's report, rule by rule, equal JAX's."""
    rules = RULE_SETS[name]
    coll, jcoll = (txfer.load_graphxfer_rules({"rule": rules}),
                   jxfer.load_graphxfer_rules({"rule": rules}))
    assert coll.counts() == jcoll.counts()
    assert [r.kind for r in coll.rules] == [r.kind for r in jcoll.rules]
    assert ([tri.classify_rule(r)[0] for r in coll.rules]
            == [jri.classify_rule(r)[0] for r in jcoll.rules])
    (rw, rep), (jrw, jrep) = _interpret(tri, rules), _interpret(jri, rules)
    assert rep == jrep
    assert [(r.name, getattr(r, "rule_names", None)) for r in rw] == \
        [(r.name, getattr(r, "rule_names", None)) for r in jrw]


def test_mixed_taxonomy_classes():
    """Each kind of rule lands in its class (the JAX package's table)."""
    _, rep = _interpret(tri, RULE_SETS["mixed"])
    assert rep == {"resharding": 2, "parallel_decomposition": 1, "sharding_motion": 1,
                   "compute_rewrite": 3, "uninterpretable_wiring": 1,
                   "uninterpretable_structure": 1, "kept_by_reference": 1,
                   "distinct_rewrites": 2}


def test_loader_accepts_a_parsed_dict_and_names_unnamed_rules():
    rules = {"rule": [{k: v for k, v in FUSE.items() if k != "name"}, ENLARGE]}
    coll, jcoll = txfer.load_graphxfer_rules(rules), jxfer.load_graphxfer_rules(rules)
    assert [r.name for r in coll.rules] == [r.name for r in jcoll.rules] == \
        ["rule_0", "enlarge_rule"]
    assert [(o.type, o.inputs, o.params) for r in coll.rules for o in r.src_ops + r.dst_ops] \
        == [(o.type, o.inputs, o.params) for r in jcoll.rules for o in r.src_ops + r.dst_ops]
    assert [r.mapped_outputs for r in coll.rules] == [r.mapped_outputs for r in jcoll.rules]


# ------------------------------------------------------------ the rewrites
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("rules", ["fuse", "merge", "mixed"])
def test_sites_and_rewritten_layers_equal_jax(model, rules):
    """Every interpreted rewrite finds JAX's sites on the same graph and
    rewrites it into JAX's layer list, and the variant enumeration the
    search walks gives JAX's variants."""
    tff, jff = MODELS[model]("port"), MODELS[model]("jax")
    (rw, _), (jrw, _) = _interpret(tri, RULE_SETS[rules]), _interpret(jri, RULE_SETS[rules])
    tprot = frozenset({tff._final_output().tensor_id})
    jprot = frozenset({jff._final_output().tensor_id})
    for r, jr in zip(rw, jrw):
        assert r.find(tff.layers, tprot) == jr.find(jff.layers, jprot)
        assert _canon(r.apply_all(list(tff.layers), tprot)) == \
            _canon(jr.apply_all(list(jff.layers), jprot))
    tv = txfer.graph_variants(tff.layers, rewrites=rw, protected=tprot)
    jv = jxfer.graph_variants(jff.layers, rewrites=jrw, protected=jprot)
    assert [(a, _canon(ls)) for a, ls in tv] == [(a, _canon(ls)) for a, ls in jv]


def test_relu_fusion_rule_roundtrip_semantics():
    """tests/test_rule_interpreter.py:153: the interpreted fusion keeps the
    donor's name, absorbs the RELU, and the fused op computes relu(xW+b)."""
    rewrites, report = _interpret(tri, [FUSE])
    assert report["compute_rewrite"] == 1 and len(rewrites) == 1
    ff = _mlp("port", n_hidden=1)
    out = ff._final_output()
    layers = rewrites[0].apply_all(list(ff.layers), protected=frozenset({out.tensor_id}))
    names = [l.name for l in layers]
    assert "d0" in names and "r0" not in names
    fused = [l for l in layers if l.name == "d0"][0]
    assert fused.attrs["activation"] is T.ActiMode.RELU
    assert fused.op_type is T.OpType.LINEAR
    assert fused.attrs["_origin_rewrite"] == "json:fuse"


def test_protected_logits_are_never_rewritten():
    """The fusion may not eat the tensor the loss trains on."""
    rewrites, _ = _interpret(tri, [FUSE])
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu"))
    d = ff.dense(ff.create_tensor((8, 16), name="x"), 10, name="d")
    ff.relu(d, name="r")
    assert rewrites[0].find(ff.layers, frozenset({d.tensor_id})) == []
    assert len(rewrites[0].find(ff.layers, frozenset())) == 1


# ----------------------------------------------------- compile and forward
def _compile(ff, path=None, budget=-1, logits=None):
    """Compile (searching unless ``budget`` is 0); JAX's on a one-device
    mesh, as the port's single process searches."""
    kw = {}
    if isinstance(ff, J.FFModel):
        import jax

        from flexflow_tpu.core.machine import make_mesh

        pkg = J
        kw["mesh"] = make_mesh({"data": 1}, jax.devices()[:1])
    else:
        pkg = T
    if path is not None:
        ff.config.substitution_json_path = str(path)
    ff.config.search_budget = budget
    ff.compile(optimizer=pkg.SGDOptimizer(lr=0.1),
               loss_type=pkg.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
               logits_tensor=logits, **kw)
    return ff


@pytest.mark.parametrize("model,rules", [("mlp", "fuse"), ("branchy", "merge"),
                                         ("branchy", "mixed")])
def test_substitution_json_path_compiles_jax_variant(tmp_path, model, rules):
    """``substitution_json_path`` in the reference schema: compile's search
    takes the interpreted rewrites and picks the variant JAX picks (on
    one device each)."""
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rule": RULE_SETS[rules]}))
    tff = _compile(MODELS[model]("port"), p)
    jff = _compile(MODELS[model]("jax"), p)
    tl = tff._search_layers or tff.layers
    jl = jff._search_layers or jff.layers
    assert _canon(tl) == _canon(jl)
    assert tff._search_layers is not None  # a json: rewrite won


def _forward(ff, x):
    cm = ff.compiled
    with torch.no_grad():
        return cm.forward_fn(cm.params, torch.as_tensor(x)).numpy()


def test_rewritten_forward_equals_unrewritten_fusion(tmp_path):
    """The fused graph keeps every weight's name: with the unrewritten
    model's params it computes its logits within f32 1e-5."""
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rule": [FUSE]}))
    base = _compile(_mlp("port"), budget=0)
    rew = _compile(_mlp("port"), p)
    assert [o.name for o in rew.compiled.ops] == ["d0", "d1", "out"]
    load_numpy_params(rew, base.numpy_params())
    x = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32)
    want, got = _forward(base, x), _forward(rew, x)
    assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max()


def test_rewritten_forward_equals_unrewritten_merge(tmp_path):
    """The merged linear's kernel is the branches' kernels side by side:
    with those weights the rewritten graph computes the unrewritten
    logits within f32 1e-5."""
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rule": [PARALLEL_MERGE]}))
    base = _compile(_branchy("port"), budget=0)
    rew = _compile(_branchy("port"), p)
    bp = base.numpy_params()
    merged = [n for n in rew.numpy_params() if n not in bp]
    assert len(merged) == 1 and len(rew.compiled.ops) == len(base.compiled.ops) - 2
    tree = {k: v for k, v in bp.items() if k not in ("ba", "bb")}
    tree[merged[0]] = {w: np.concatenate([bp["ba"][w], bp["bb"][w]], axis=-1)
                       for w in bp["ba"]}
    load_numpy_params(rew, tree)
    x = np.random.default_rng(1).normal(size=(16, 32)).astype(np.float32)
    want, got = _forward(base, x), _forward(rew, x)
    assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max()


def test_logits_tensor_protected_through_compile(tmp_path):
    """tests/test_graph_xfer.py:290 with a rule file: an explicit
    logits_tensor whose only consumer is a relu stays an op."""
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rule": [FUSE]}))
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu"))
    d = ff.dense(ff.create_tensor((8, 16), name="x"), 10, name="d")
    ff.relu(d, name="r")
    _compile(ff, p, logits=d)
    assert "d" in [o.name for o in ff.compiled.ops]


def test_attention_is_left_whole(tmp_path):
    """A Transformer under both rules: no rewrite touches an attention op."""
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rule": [FUSE, PARALLEL_MERGE]}))
    ff = T.FFModel(T.FFConfig(batch_size=4, device="cpu", substitution_json_path=str(p),
                              search_budget=-1))
    build_transformer(ff, 4, TransformerConfig(hidden_size=16, embedding_size=16, num_heads=2,
                                               num_layers=1, sequence_length=8))
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    attn = [o for o in ff.compiled.ops if o.op_type is T.OpType.MULTIHEAD_ATTENTION]
    assert attn and all(o.attrs.get("_origin_rewrite") is None for o in attn)
