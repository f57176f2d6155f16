"""The mesh's bookkeeping, without a process group: the ParallelDim
algebra, the layouts every op of the Transformer, GPT and the BERT proxy
propagates under ``tp_axis`` and ``seq_axis`` against the JAX package's
``partition_spec()``s, the errors (duplicate axes, a mesh that does not
match the world), the A7b strategies against the JAX layouts, and the strategy
file round trip. The runs over ranks are in
``test_torch_parallel_training.py``."""

import json

import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.parallel_tensor import ParallelDim as JParallelDim
from flexflow_tpu.core.parallel_tensor import ParallelTensorShape as JParallelTensorShape
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_bert_proxy as jbuild_bert_proxy
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.runtime.compiler import build_ops as jbuild_ops
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, LossType
from flexflow_tpu_torch.core.machine import LAUNCH_HINT, Group, Mesh, make_mesh
from flexflow_tpu_torch.core.parallel_tensor import ParallelDim, ParallelTensorShape
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.models import GPTConfig, TransformerConfig, build_gpt
from flexflow_tpu_torch.models.dlrm import build_dlrm
from flexflow_tpu_torch.models.transformer import build_bert_proxy, build_transformer
from flexflow_tpu_torch.models.xdl import build_xdl
from flexflow_tpu_torch.ops.moe_ops import expert_capacity
from flexflow_tpu_torch.runtime.compiler import build_ops, compile_model
from flexflow_tpu_torch.serving.placement import instance_meshes
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH = 8
SHAPE = dict(hidden_size=64, embedding_size=64, num_heads=4, num_layers=2, sequence_length=16)
GPT_SHAPE = dict(vocab_size=64, max_positions=32, hidden_size=64, num_heads=4, num_layers=2)


def test_parallel_dim_algebra_matches_jax():
    t = ParallelTensorShape.unpartitioned((8, 16, 64))
    j = JParallelTensorShape.unpartitioned((8, 16, 64))
    steps = [lambda s: s.partitioned(0, 2, "data"), lambda s: s.partitioned(2, 4, "model"),
             lambda s: s.replicated("seq"), lambda s: s.replicated("seq"),
             lambda s: s.combined(2), lambda s: s.reduced("seq"),
             lambda s: s.partitioned(1, 2, "data")]
    for f in steps:
        t, j = f(t), f(j)
        assert t.partition_spec() == tuple(j.partition_spec())
        assert t.sizes == j.sizes and t.degrees == j.degrees
        assert t.num_parts == j.num_parts and t.replica_axes == j.replica_axes
        assert t.has_duplicate_axes() == j.has_duplicate_axes()
        assert str(t) == str(j)
    assert t.has_duplicate_axes()  # data on dims 0 and 1
    s = ParallelTensorShape.unpartitioned((8, 16, 64)).partitioned(0, 2, "data") \
        .partitioned(2, 4, "model")
    assert s.local_sizes() == (4, 16, 16) and s.partition_axes == ("data", "model")
    for bad in (dict(size=6, degree=4, axis="data"), dict(size=8, degree=2),
                dict(size=8, degree=0)):
        with pytest.raises(ValueError):
            ParallelDim(**bad)
    with pytest.raises(AssertionError):
        JParallelDim(6, 4, "data")


def test_local_slices_follow_the_rank_grid():
    """Rank r's coordinates are its index in arange(world).reshape(sizes),
    the order make_mesh's reshape gives the JAX devices."""
    s = ParallelTensorShape.unpartitioned((8, 16, 64)).partitioned(0, 2, "data") \
        .partitioned(2, 2, "model")
    got = []
    for rank in range(4):
        m = Mesh({"data": 2, "model": 2}, rank, {})
        sl = m.local_slices(s)
        got.append((m.coords, (sl[0].start, sl[0].stop), (sl[2].start, sl[2].stop)))
    assert got == [({"data": 0, "model": 0}, (0, 4), (0, 32)),
                   ({"data": 0, "model": 1}, (0, 4), (32, 64)),
                   ({"data": 1, "model": 0}, (4, 8), (0, 32)),
                   ({"data": 1, "model": 1}, (4, 8), (32, 64))]


def _graph(pkg: str, model: str, **kw):
    """(layers, inputs) of a model built by one package (no compile)."""
    if pkg == "jax":
        ff = JFFModel(JFFConfig(batch_size=BATCH))
        tcfg, gcfg = JTransformerConfig(**SHAPE), JGPTConfig(**GPT_SHAPE)
        fns = dict(transformer=jbuild_transformer, bert=jbuild_bert_proxy, gpt=jbuild_gpt)
    else:
        ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
        tcfg, gcfg = TransformerConfig(**SHAPE), GPTConfig(**GPT_SHAPE)
        fns = dict(transformer=build_transformer, bert=build_bert_proxy, gpt=build_gpt)
    if model == "gpt":
        fns[model](ff, BATCH, SHAPE["sequence_length"], gcfg, **kw)
    else:
        fns[model](ff, BATCH, tcfg, **kw)
    return ff.layers, ff.input_tensors


def _propagated(pkg: str, model: str, axis_sizes: dict, **kw):
    layers, inputs = _graph(pkg, model, **kw)
    pd, pts = (JParallelDim, JParallelTensorShape) if pkg == "jax" else \
        (ParallelDim, ParallelTensorShape)
    data = axis_sizes.get("data", 1)
    pshapes = {t.tensor_id: pts(tuple(pd(s, data, "data") if i == 0 and data > 1 else pd(s)
                                      for i, s in enumerate(t.dims)), t.dtype)
               for t in inputs}
    strategies = {l.name: l.attrs["strategy"] for l in layers if l.attrs.get("strategy")}
    build = jbuild_ops if pkg == "jax" else build_ops
    ops, _ = build(layers, pshapes, axis_sizes, strategies)
    # in op order: unnamed layers take each package's own counter
    return [(op.op_type.value, [tuple(s.partition_spec()) for s in op.output_shapes],
             {w: tuple(s.partition_spec()) for w, s in op.weight_shapes.items()},
             getattr(op, "seq_axis", None), getattr(op, "seq_mode", None))
            for op in ops]


CASES = {
    "transformer-data": ("transformer", {"data": 2}, {}),
    "transformer-tp": ("transformer", {"data": 2, "model": 2}, dict(tp_axis="model")),
    "transformer-tp4": ("transformer", {"model": 4}, dict(tp_axis="model")),
    "transformer-seq-ring": ("transformer", {"data": 2, "seq": 2}, dict(seq_axis="seq")),
    "transformer-seq-a2a": ("transformer", {"data": 2, "seq": 2},
                            dict(seq_axis="seq", seq_mode="a2a")),
    "transformer-seq4-a2a": ("transformer", {"seq": 4}, dict(seq_axis="seq", seq_mode="a2a")),
    "transformer-tp-seq": ("transformer", {"model": 2, "seq": 2},
                           dict(tp_axis="model", seq_axis="seq", seq_mode="a2a")),
    "gpt-tp": ("gpt", {"data": 2, "model": 2}, dict(tp_axis="model")),
    "bert-tp": ("bert", {"data": 2, "model": 2}, dict(tp_axis="model")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_propagated_layouts_match_jax(case):
    model, axis_sizes, kw = CASES[case]
    got = _propagated("port", model, axis_sizes, **kw)
    want = _propagated("jax", model, axis_sizes, **kw)
    assert got == want
    specs = [spec for _, outs, ws, _, _ in got for spec in outs + list(ws.values())]
    assert any(a is not None for spec in specs for a in spec)


def test_attention_inputs_arrive_as_the_strategy_asks():
    layers, inputs = _graph("port", "transformer", seq_axis="seq", tp_axis="model")
    pshapes = {t.tensor_id: ParallelTensorShape.unpartitioned(t.dims) for t in inputs}
    strategies = {l.name: l.attrs["strategy"] for l in layers if l.attrs.get("strategy")}
    ops, _ = build_ops(layers, pshapes, {"model": 2, "seq": 2}, strategies)
    attn, ff1, ff2 = ops[:3]
    assert [l.partition_spec() for l in attn.input_layouts] == [(None, "seq", None)] * 3
    assert (attn.heads_axis, attn.seq_axis, attn.seq_mode) == ("model", "seq", "ring")
    assert ff1.input_layouts[0].partition_spec() == (None, "seq", None)
    assert ff2.input_layouts[0].partition_spec() == (None, "seq", "model")
    assert (ff1.out_axis, ff1.in_axis, ff2.out_axis, ff2.in_axis) == \
        ("model", None, None, "model")


def test_duplicate_axes_raise_in_both_packages():
    def build(pkg):
        ff = JFFModel(JFFConfig(batch_size=BATCH)) if pkg == "jax" else \
            FFModel(FFConfig(batch_size=BATCH, device="cpu"))
        x = ff.create_tensor((BATCH, 64), name="x")
        ff.dense(x, 64, ActiMode.RELU, name="d", strategy={"out": "model", "in": "model"})
        pd = JParallelDim if pkg == "jax" else ParallelDim
        pts = JParallelTensorShape if pkg == "jax" else ParallelTensorShape
        return ff.layers, {x.tensor_id: pts((pd(BATCH), pd(64)))}

    for pkg, fn in (("jax", jbuild_ops), ("port", build_ops)):
        layers, pshapes = build(pkg)
        with pytest.raises(ValueError, match="two dims"):
            fn(layers, pshapes, {"model": 2}, {"d": {"out": "model", "in": "model"}})


def test_a_mesh_that_is_not_the_world_raises_with_the_launch():
    with pytest.raises(ValueError, match="needs 4 ranks; this process group has 1") as e:
        make_mesh({"data": 2, "model": 2})
    assert LAUNCH_HINT in str(e.value)
    assert make_mesh({"data": 1}) is None and make_mesh() is None
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", mesh_shape={"data": 2}))
    build_transformer(ff, BATCH, TransformerConfig(**SHAPE))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node N"):
        ff.compile(loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)


def _data_mesh_ops(build, axis_sizes=None):
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    build(ff)
    pshapes = {t.tensor_id: ParallelTensorShape(
        (ParallelDim(t.dims[0], 2, "data"),) + tuple(ParallelDim(s) for s in t.dims[1:]))
        for t in ff.input_tensors}
    strategies = {l.name: l.attrs["strategy"] for l in ff.layers if l.attrs.get("strategy")}
    return build_ops(ff.layers, pshapes, axis_sizes or {"data": 2}, strategies)


def _bn(ff):
    x = ff.create_tensor((BATCH, 3, 8, 8), name="x")
    ff.batch_norm(ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="c"), name="bn")


def _batch_sum(ff):
    ff.reduce_sum(ff.create_tensor((BATCH, 16), name="x"), axes=[0], name="sum")


def _moe(ff, stacked=False, expert_axis=None):
    ff.moe(ff.create_tensor((BATCH, 16), name="x"), 4, 2, 8, stacked=stacked,
           expert_axis=expert_axis, name="moe")


def _jax_data_mesh_ops(build, axis_sizes=None, strategies=None):
    jff = JFFModel(JFFConfig(batch_size=BATCH))
    build(jff)
    pshapes = {t.tensor_id: JParallelTensorShape(
        (JParallelDim(t.dims[0], 2, "data"),) + tuple(JParallelDim(s) for s in t.dims[1:]))
        for t in jff.input_tensors}
    strategies = {**{l.name: l.attrs["strategy"] for l in jff.layers if l.attrs.get("strategy")},
                  **(strategies or {})}
    return jbuild_ops(jff.layers, pshapes, axis_sizes or {"data": 2}, strategies)


@pytest.mark.parametrize("build, op", [(_bn, "bn"), (_batch_sum, "sum")],
                         ids=["batch_norm", "reduce_over_batch"])
def test_a_reduction_across_the_sharded_batch_raises_naming_a7b(build, op):
    """A reduction over the batch sharded over ``data`` no longer raises:
    it keeps the batch sharded and reduces globally (BatchNorm's statistics
    and ReduceSum are all-reduced over ``data``), with the JAX package's
    layouts; ``test_torch_sharded_ops.py`` holds the values to JAX over
    ranks."""
    ops, _ = _data_mesh_ops(build)
    by = {o.name: o for o in ops}
    jby = {o.name: o for o in _jax_data_mesh_ops(build)[0]}
    assert by[op].input_layouts[0].partition_spec()[0] == "data"
    if op == "bn":
        assert by[op].stat_axes == ("data",)
    else:
        assert by[op].batch_axis == "data"
    for name, o in by.items():
        assert o.output_shapes[0].partition_spec() == \
            tuple(jby[name].output_shapes[0].partition_spec()), name


@pytest.mark.parametrize("stacked, expert_axis", [(False, None), (True, None), (True, "data")],
                         ids=["n_branch", "stacked", "expert_parallel"])
def test_moe_routing_over_the_sharded_batch_layouts(stacked, expert_axis):
    """The routing ops over {data: 2}: without expert parallelism they read
    the batch gathered and their combine comes out sharded on the batch;
    with ``expert_axis="data"`` the stacked ops keep the batch sharded, the
    experts and their weights shard over ``data``. The stacked layouts
    match the JAX package's."""
    ops, _ = _data_mesh_ops(lambda ff: _moe(ff, stacked, expert_axis))
    by = {op.name: op for op in ops}
    agg = by["moe_agg"]
    assert agg.output_shapes[0].partition_spec() == ("data", None)
    if expert_axis is None:
        assert all(not ps.partition_axes for i, ps in enumerate(agg.input_layouts)
                   if i != agg.full_gate_at)
        assert agg.input_layouts[agg.full_gate_at].partition_spec() == ("data", None)
        return
    group, experts = by["moe_group"], by["moe_experts"]
    assert [ps.partition_spec() for ps in group.input_layouts] == [("data", None)] * 2
    assert group.output_shapes[0].partition_spec() == ("data", None, None)
    assert experts.weight_shapes["kernel"].partition_spec() == ("data", None, None)
    assert experts.weight_shapes["bias"].partition_spec() == ("data", None)
    jff = JFFModel(JFFConfig(batch_size=BATCH))
    _moe(jff, stacked, expert_axis)
    pshapes = {t.tensor_id: JParallelTensorShape(
        (JParallelDim(t.dims[0], 2, "data"),) + tuple(JParallelDim(s) for s in t.dims[1:]))
        for t in jff.input_tensors}
    strategies = {l.name: l.attrs["strategy"] for l in jff.layers if l.attrs.get("strategy")}
    jops = {op.name: op for op in jbuild_ops(jff.layers, pshapes, {"data": 2}, strategies)[0]}
    for name in ("moe_group", "moe_experts", "moe_agg"):
        assert by[name].output_shapes[0].partition_spec() == \
            tuple(jops[name].output_shapes[0].partition_spec()), name
    for w in ("kernel", "bias"):
        assert experts.weight_shapes[w].partition_spec() == \
            tuple(jops["moe_experts"].weight_shapes[w].partition_spec())


def test_a_reduction_across_a_sharded_feature_dim_gathers_it():
    """LayerNorm over a dim a strategy shards reads it whole: the compiler
    gathers it first, where the JAX package's GSPMD reshards."""
    def build(ff):
        x = ff.create_tensor((BATCH, 16, 64), name="x")
        h = ff.dense(x, 64, name="up", strategy={"out": "model"})
        ff.layer_norm(h, axes=[-1], name="ln")

    ops, layouts = _data_mesh_ops(build, {"data": 2, "model": 2})
    up, ln = ops
    assert up.output_shapes[0].partition_spec() == ("data", None, "model")
    assert ln.input_layouts[0].partition_spec() == ("data", None, None)
    assert ln.output_shapes[0].partition_spec() == ("data", None, None)


def test_a7b_strategies_raise_naming_a7b():
    """The strategies of ROADMAP A7b compile (they raised before it was
    ported): sharded tables, DLRM/XDL, a convolution's strategy, instance
    placement over a mesh, the expert strategy and ZeRO-1."""
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    x = ff.create_tensor((BATCH, 16), name="x")
    gate = ff.dense(x, 4, name="gate")
    _, assign = ff.top_k(gate, 2, sorted=False)
    # the sharded tables and convolutions compile, with the JAX package's
    # layouts over {data: 2, model: 2}
    from flexflow_tpu import ffconst as jns
    from flexflow_tpu.models.dlrm import DLRMConfig as JDLRMConfig
    from flexflow_tpu.models.dlrm import build_dlrm as jbuild_dlrm
    from flexflow_tpu.models.xdl import XDLConfig as JXDLConfig
    from flexflow_tpu.models.xdl import build_xdl as jbuild_xdl
    from flexflow_tpu.serving.placement import instance_meshes as jinstance_meshes
    from flexflow_tpu_torch import ffconst as tns
    from flexflow_tpu_torch.models import DLRMConfig, XDLConfig

    def emb(ns):
        return lambda f: f.embedding(f.create_tensor((BATCH, 4), ns.DataType.INT32, name="ids"),
                                     32, 8, strategy={"vocab": "model"}, name="emb")

    def conv(strategy):
        return lambda f: f.conv2d(f.create_tensor((BATCH, 3, 8, 8), name="img"), 4, 3, 3,
                                  1, 1, 1, 1, name="cv", **strategy)

    tables = dict(embedding_size=[64] * 4, sparse_feature_size=8)
    cases = [
        (emb(tns), emb(jns), None),
        # "out" is not a convolution's key: both packages leave it unsharded
        (conv({"strategy": {"out": "model"}}), conv({}), {"cv": {"out": "model"}}),
        (lambda f: build_dlrm(f, BATCH, DLRMConfig(**tables), param_axis="model"),
         lambda f: jbuild_dlrm(f, BATCH, JDLRMConfig(**tables), param_axis="model"), None),
        (lambda f: build_xdl(f, BATCH, XDLConfig(**tables), embedding_strategy={"vocab": "model"}),
         lambda f: jbuild_xdl(f, BATCH, JXDLConfig(**tables),
                              embedding_strategy={"vocab": "model"}), None),
    ]
    sizes = {"data": 2, "model": 2}
    for build, jbuild, jstrategies in cases:
        ops = _data_mesh_ops(build, sizes)[0]
        jops = {o.name: o for o in _jax_data_mesh_ops(jbuild, sizes, jstrategies)[0]}
        named = [o for o in ops if o.name in jops]  # auto names count per package
        assert any(o.weight_shapes for o in named)
        for o in named:
            assert o.output_shapes[0].partition_spec() == \
                tuple(jops[o.name].output_shapes[0].partition_spec()), o.name
            for w, ws in o.weight_shapes.items():
                assert ws.partition_spec() == \
                    tuple(jops[o.name].weight_shapes[w].partition_spec()), (o.name, w)
        assert any("model" in ws.partition_axes for o in ops for ws in o.weight_shapes.values()
                   ) == (jstrategies is None)
    # a device list may name one card twice: an instance's two ranks share it
    import jax

    (place,) = instance_meshes(1, {"data": 2}, devices=["cpu", "cpu"])
    (jmesh,) = jinstance_meshes(1, {"data": 2}, jax.devices()[:2])
    assert place.mesh_shape == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    assert [str(d) for d in place.devices] == ["cpu", "cpu"]
    # an expert strategy and ZeRO-1 no longer raise: their layouts compile.
    # An axis the mesh lacks, or a degree that does not divide the
    # experts, raises the JAX package's ValueError
    grouped = ff.group_by_stacked(x, assign, 4, 2.0, strategy={"expert": "data"}, name="grp")
    assert grouped.dims == (4, expert_capacity(BATCH, 2, 4, 2.0), 16)
    for axes, strategy, msg in (({"data": 2}, {"expert": "e"}, "not a mesh axis"),
                                ({"data": 3}, {"expert": "data"}, "does not divide")):
        with pytest.raises(ValueError, match=msg):
            build_ops(ff.layers, {t.tensor_id: ParallelTensorShape.unpartitioned(t.dims, t.dtype)
                                  for t in ff.input_tensors}, axes, {"grp": strategy})
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", zero_optimizer=True))
    build_transformer(ff, BATCH, TransformerConfig(**SHAPE))
    cm = compile_model(ff.config, ff.layers, ff.input_tensors, ff._final_output(),
                       optimizer=AdamOptimizer(), loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                       mesh=Mesh({"data": 2}, 0, {("data",): Group(("data",), None, (0, 1), 0)}))
    for (op, w), d in cm.zero_dims.items():
        full, m = cm.params[op][w], cm.opt_state["m"][op][w]
        assert m.shape[d] * 2 == full.shape[d] and m.dim() == full.dim()
    assert cm.zero_dims and all(
        cm.opt_state["m"][op][w].shape == t.shape for op, ws in cm.params.items()
        for w, t in ws.items() if (op, w) not in cm.zero_dims)


def test_strategy_files_round_trip_with_jax(tmp_path):
    """The JAX package's export_strategy file imports into the port's
    layers, and the port writes the same file back."""
    jff = JFFModel(JFFConfig(batch_size=BATCH))
    jbuild_gpt(jff, BATCH, SHAPE["sequence_length"], JGPTConfig(**GPT_SHAPE), tp_axis="model")
    jff._search_strategies = {}
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    jff.export_strategy(str(jpath))
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    build_gpt(ff, BATCH, SHAPE["sequence_length"], GPTConfig(**GPT_SHAPE))
    assert not any(l.attrs.get("strategy") for l in ff.layers)
    strat = ff.import_strategy(str(jpath))
    assert strat and {l.name: l.attrs.get("strategy") for l in ff.layers if l.name in strat} \
        == strat
    ff.export_strategy(str(tpath))
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())
    assert json.loads(tpath.read_text())["version"] == 1
    # compiled on one rank the strategies change nothing
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    assert ff.compiled.mesh is None
    assert all(not any(ps.partition_axes for ps in op.weight_shapes.values())
               for op in ff.compiled.ops)
    assert np.isfinite(ff.numpy_params()["lm_head"]["kernel"]).all()
