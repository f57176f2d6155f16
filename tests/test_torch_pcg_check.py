"""The port's PCG validator and strategy linter against the JAX package's.

Every seeded case builds the same graph in both packages (the builders
and the graph API share their names), validates it under the same
strategy and mesh, and holds the port's codes, severities and layer
names to the JAX package's: the seeded PCG/LINT cases of
``tests/test_analysis.py`` plus one case for each code those leave out
(PCG005, PCG008, PCG009, PCG014, PCG015, PCG016). Then the compile
gate: ``validate_pcg`` "error"/"warn"/"off", the cache's coded
rejection of a corrupted entry, and the attention departure where the
two packages' layouts differ."""

import json
import types

import pytest
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu import analysis as JA
from flexflow_tpu.core.layer import Layer as JLayer
from flexflow_tpu.core.tensor import Tensor as JTensor
from flexflow_tpu.models import build_mlp as jbuild_mlp
from flexflow_tpu.models import zoo_smoke_builders as jzoo
from flexflow_tpu.models.transformer import TransformerConfig as JTC
from flexflow_tpu.models.transformer import build_transformer as jbuild_tf
from flexflow_tpu.search.graph_xfer import ParallelLinearMerge as JMerge
from flexflow_tpu_torch import analysis as TA
from flexflow_tpu_torch.core.layer import Layer as TLayer
from flexflow_tpu_torch.core.tensor import Tensor as TTensor
from flexflow_tpu_torch.models import build_mlp as tbuild_mlp
from flexflow_tpu_torch.models import zoo_smoke_builders as tzoo
from flexflow_tpu_torch.models.transformer import TransformerConfig as TTC
from flexflow_tpu_torch.models.transformer import build_transformer as tbuild_tf
from flexflow_tpu_torch.search.graph_xfer import ParallelLinearMerge as TMerge

BS = 16
TP_MESH = {"data": 2, "model": 4}

JAXP = types.SimpleNamespace(
    name="jax", FFModel=J.FFModel, cfg=lambda **kw: J.FFConfig(**kw), DataType=J.DataType,
    ActiMode=J.ActiMode, OpType=J.OpType, Layer=JLayer, Tensor=JTensor, build_mlp=jbuild_mlp,
    zoo=jzoo(), TC=JTC, build_transformer=jbuild_tf, Merge=JMerge, A=JA)
PORT = types.SimpleNamespace(
    name="port", FFModel=T.FFModel, cfg=lambda **kw: T.FFConfig(device="cpu", **kw),
    DataType=T.DataType, ActiMode=T.ActiMode, OpType=T.OpType, Layer=TLayer, Tensor=TTensor,
    build_mlp=tbuild_mlp, zoo=tzoo(), TC=TTC, build_transformer=tbuild_tf, Merge=TMerge, A=TA)


def _mlp(P, **cfg):
    ff = P.FFModel(P.cfg(batch_size=BS, **cfg))
    P.zoo["mlp"](ff, BS)
    return ff


def _validate(P, ff, strategies, axes, layers=None, protect=True):
    return P.A.validate_pcg(layers if layers is not None else ff.layers, ff._used_inputs(),
                            strategies, axes,
                            protected={ff._final_output().tensor_id} if protect else None,
                            config=ff.config)


def _lint(P, ff, strategies, axes, **kw):
    return P.A.lint_strategy(ff.layers, ff._used_inputs(), strategies, axes,
                             config=ff.config, **kw)


# ----------------------------------------------------------- the cases
def case_pcg006_indivisible(P):
    return _validate(P, _mlp(P), {"mlp_head": {"out": "model"}}, TP_MESH)


def case_pcg006_inherited_axis(P):
    return _validate(P, _mlp(P), {"mlp_dense0": {"out": "data"}}, {"data": 8})


def case_seq_entry_is_schedule_only(P):
    ff = P.FFModel(P.cfg(batch_size=8))
    P.build_transformer(ff, 8, P.TC(hidden_size=32, num_heads=4, num_layers=2,
                                    sequence_length=16), seq_axis="seq", seq_mode="a2a")
    strat = {l.name: l.attrs["strategy"] for l in ff.layers if l.attrs.get("strategy")}
    return _validate(P, ff, strat, {"data": 2, "seq": 4})


def _conv_stack(P, second_axis):
    ff = P.FFModel(P.cfg(batch_size=8))
    x = ff.create_tensor((8, 3, 16, 16), P.DataType.FLOAT, name="img")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, P.ActiMode.RELU, name="sc1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="sp1")
    t = ff.conv2d(t, 16, 3, 3, 1, 1, 1, 1, name="sc2")
    t = ff.flat(t)
    t = ff.dense(t, 5, name="shead")
    ff.softmax(t)
    return _validate(P, ff, {"sc1": {"spatial": "model"}, "sc2": {"spatial": second_axis}},
                     {"data": 2, "model": 4})


def case_spatial_already_realized(P):
    return _conv_stack(P, "model")


def case_spatial_other_axis_pcg006(P):
    return _conv_stack(P, "data")


def case_pcg001_cycle(P):
    ff = _mlp(P)
    layers = list(ff.layers)
    layers[0].inputs.append(layers[-2].outputs[0])
    return P.A.validate_pcg(layers, ff._used_inputs(), {}, {"data": 8}, config=ff.config)


def case_pcg002_dangling(P):
    ff = _mlp(P)
    layers = [l for l in ff.layers if l.name != "mlp_dense1"]
    return P.A.validate_pcg(layers, ff._used_inputs(), {}, {"data": 8}, config=ff.config)


def case_pcg004_shape_flow(P):
    ff = _mlp(P)
    head = [l for l in ff.layers if l.name == "mlp_head"][0]
    head.outputs[0].dims = (BS, 12)
    return _validate(P, ff, {}, {"data": 8})


def case_pcg005_dtype_flow(P):
    ff = _mlp(P)
    head = [l for l in ff.layers if l.name == "mlp_head"][0]
    head.outputs[0].dtype = P.DataType.DOUBLE
    return _validate(P, ff, {}, {"data": 8})


def case_pcg012_unregistered(P):
    ff = _mlp(P)
    t_in = ff.layers[-1].outputs[0]
    bogus = P.Layer(P.OpType.FUSED_PARALLEL, name="bogus", inputs=[t_in])
    bogus.outputs.append(P.Tensor((BS, 10), P.DataType.FLOAT, owner_layer=bogus,
                                  name="bogus:out0"))
    return P.A.validate_pcg(ff.layers + [bogus], ff._used_inputs(), {}, {"data": 8},
                            config=ff.config)


def case_pcg013_stale_name(P):
    return _validate(P, _mlp(P), {"no_such_layer": {"out": "model"}}, TP_MESH)


def case_pcg007_unknown_axis(P):
    return _validate(P, _mlp(P), {"mlp_dense0": {"out": "model"}}, {"data": 8})


def case_pcg003_dead_layer(P):
    ff = _mlp(P)
    x = ff.layers[0].inputs[0]
    dead = P.Layer(P.OpType.RELU, name="dead_relu", inputs=[x])
    dead.outputs.append(P.Tensor(x.dims, P.DataType.FLOAT, owner_layer=dead,
                                 name="dead:out0"))
    layers = ff.layers[:-1] + [dead] + ff.layers[-1:]
    return _validate(P, ff, {}, {"data": 8}, layers=layers)


def _big_mlp(P, **cfg):
    ff = P.FFModel(P.cfg(batch_size=BS, **cfg))
    P.build_mlp(ff, BS, in_dim=1024, hidden_dims=(2048,), num_classes=10)
    return ff


def case_pcg010_budget(P):
    return _validate(P, _big_mlp(P, memory_threshold_mb=1), {}, {"data": 8})


def case_pcg010_budget_zero(P):
    return _validate(P, _big_mlp(P, memory_threshold_mb=1, zero_optimizer=True), {},
                     {"data": 8})


def case_pcg010_budget_pipe(P):
    return _validate(P, _big_mlp(P, memory_threshold_mb=2), {}, {"data": 1, "pipe": 16})


def case_pcg011_pipe_oversubscribed(P):
    return _validate(P, _mlp(P), {}, {"pipe": 8, "data": 1})


def case_rewrite_provenance(P):
    ff = P.FFModel(P.cfg(batch_size=BS))
    x = ff.create_tensor((BS, 32), P.DataType.FLOAT, name="in")
    a = ff.dense(x, 24, name="branch_a")
    b = ff.dense(x, 24, name="branch_b")
    ff.concat([a, b], axis=-1, name="cat")
    merged = P.Merge().apply_all(list(ff.layers))
    mname = [l.name for l in merged if l.attrs.get("_origin_rewrite")][0]
    return P.A.validate_pcg(merged, ff._used_inputs(), {mname: {"out": "model"}},
                            {"data": 1, "model": 5}, config=ff.config)


def case_pcg008_duplicate_axis(P):
    ff = P.FFModel(P.cfg(batch_size=BS))
    x = ff.create_tensor((BS, 32), P.DataType.FLOAT, name="in")
    t = ff.repartition(x, 1, "data", name="rep1")
    ff.dense(t, 8, name="head")
    return _validate(P, ff, {}, {"data": 2})


def case_pcg009_edge_shardings(P):
    ff = P.FFModel(P.cfg(batch_size=BS))
    x = ff.create_tensor((BS, 32), P.DataType.FLOAT, name="in")
    whole = ff.combine(x, 0, name="gather_rows")
    ff.add(x, whole, name="mix")
    return _validate(P, ff, {}, {"data": 2})


def case_pcg014_propagation(P):
    ff = P.FFModel(P.cfg(batch_size=BS))
    x = ff.create_tensor((BS, 32), P.DataType.FLOAT, name="in")
    t = ff.dense(x, 8, name="d0")
    ff.dense(t, 4, name="head")
    del ff.layers[0].attrs["out_dim"]   # the op cannot be built from these attrs
    return _validate(P, ff, {}, {"data": 2})


def case_pcg015_schedule(P):
    return _validate(P, _mlp(P, pipeline_schedule="zigzag"), {}, {"pipe": 2, "data": 1})


def case_pcg015_interleave(P):
    return _validate(P, _mlp(P, pipeline_schedule="interleaved", pipeline_interleave=4), {},
                     {"pipe": 2, "data": 1})


def case_pcg016_nonpositive_dim(P):
    ff = P.FFModel(P.cfg(batch_size=8))
    x = ff.create_tensor((8, 3, 4, 4), P.DataType.FLOAT, name="tiny")
    t = ff.conv2d(x, 4, 7, 7, 1, 1, 0, 0, name="toowide")
    t = ff.flat(t)
    ff.dense(t, 5, name="h")
    return _validate(P, ff, {}, {"data": 1})


def case_lint001_replicated_weight(P):
    ff = P.FFModel(P.cfg(batch_size=BS))
    P.build_mlp(ff, BS, in_dim=1024, hidden_dims=(1024,), num_classes=16)
    return _lint(P, ff, {}, {"data": 2, "model": 4})


def case_lint002_degree_one(P):
    return _lint(P, _mlp(P), {"mlp_dense0": {"out": "model"}}, {"data": 2, "model": 1})


def case_lint003_float_cast(P):
    ff = P.FFModel(P.cfg(batch_size=BS))
    x = ff.create_tensor((BS, 16), P.DataType.FLOAT, name="in")
    t = ff.cast(x, P.DataType.HALF, name="to_half")
    t = ff.cast(t, P.DataType.FLOAT, name="back")
    ff.dense(t, 4, name="head")
    return _lint(P, ff, {}, {"data": 1})


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


def _key(report):
    return sorted((f.code, f.severity, f.layer or "") for f in report.findings)


@pytest.mark.parametrize("case", sorted(CASES))
def test_seeded_case_codes_equal_the_jax_validators(case):
    want, got = CASES[case](JAXP), CASES[case](PORT)
    assert _key(got) == _key(want), (got.format(), want.format())


def test_every_validator_code_is_seeded():
    """Each PCG/LINT code either package can emit has a seeded case that
    fires it in both (PCG011's post-fusion variant is the compile gate's)."""
    fired = set()
    for fn in CASES.values():
        fired |= {f.code for f in fn(PORT).findings}
    codes = {c for c in TA.CODE_CATALOG if c.startswith(("PCG0", "LINT"))}
    assert codes - {"PCG000"} <= fired, sorted(codes - fired)


# the port's MoE routing ops read the whole batch: their inputs are
# gathered over the data axis (parallel/collectives.gather_from), so the
# aggregate's inputs arrive with different batch shardings and the port
# reports the gather it really runs there (PCG009, a warning); the JAX
# package's GSPMD ops keep the batch sharded
ZOO_DEPARTURES = {"moe": [("PCG009", "warning", "moe_agg")]}


@pytest.mark.parametrize("name", sorted(tzoo()))
def test_zoo_validates_clean_in_both(name):
    reports = []
    for P in (JAXP, PORT):
        ff = P.FFModel(P.cfg(batch_size=BS))
        P.zoo[name](ff, BS)
        reports.append(_validate(P, ff, {}, {"data": 8}))
    assert reports[0].ok() and reports[1].ok(), reports[1].format()
    assert _key(reports[1]) == sorted(_key(reports[0]) + ZOO_DEPARTURES.get(name, []))


# ------------------------------------------------------- the compile gate
def _tp_mlp(mode):
    ff = T.FFModel(T.FFConfig(batch_size=BS, device="cpu", validate_pcg=mode))
    tbuild_mlp(ff, BS, in_dim=64, hidden_dims=(128,), num_classes=10)
    return ff


def test_compile_raises_under_error(monkeypatch):
    ff = _tp_mlp("error")
    with pytest.raises(TA.PCGValidationError) as ei:
        ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   strategies={"mlp_head": {"out": "model"}},
                   mesh=_FakeMesh({"data": 1, "model": 4}))
    assert "PCG006" in str(ei.value) and "mlp_head" in str(ei.value)
    assert ei.value.report.errors[0].op_type == "linear"


class _FakeMesh:
    """The gate reads only the mesh's axis sizes; compile never gets past it."""

    def __init__(self, shape):
        self.shape = dict(shape)


def test_compile_prints_under_warn_and_lowering_error_names_the_finding(capsys):
    ff = _tp_mlp("warn")
    with pytest.raises(Exception):
        ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   strategies={"mlp_head": {"out": "model"}},
                   mesh=_FakeMesh({"data": 1, "model": 4}))
    out = capsys.readouterr()
    assert "[pcg] PCG006 [error]" in out.out
    assert "proceeded past 1 error-severity finding" in out.err


def test_compile_skips_under_off_and_publishes_report_by_default():
    ff = _tp_mlp("off")
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    assert ff.pcg_report is None
    ff = _tp_mlp("error")
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    assert ff.pcg_report is not None and ff.pcg_report.ok()
    assert ff.config.validate_pcg == "error" == T.FFConfig().validate_pcg


def test_compile_gate_typo_mode_rejected():
    ff = _tp_mlp("eror")
    with pytest.raises(ValueError, match="validate_pcg"):
        ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)


def test_imported_strategy_file_goes_through_the_gate(tmp_path):
    path = tmp_path / "s.json"
    path.write_text(json.dumps({"version": 1, "strategies": {"mlp_head": {"out": "model"}}}))
    ff = _tp_mlp("error")
    ff.import_strategy(str(path))
    with pytest.raises(TA.PCGValidationError, match="PCG006"):
        ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   mesh=_FakeMesh({"data": 1, "model": 4}))


def test_post_fusion_unpipe_is_pcg011():
    """A pipe axis the graph fills before fusion but not after: the gate
    ran on the builder's layers (no PCG011 there), so compile adds the
    post-fusion PCG011 when it falls back un-piped, as the JAX compile."""
    import _torch_mesh_workers as workers
    from flexflow_tpu_torch.parallel.distributed import spawn

    for r in spawn(workers.fused_unpipe, 2):
        assert r["codes"] == ["PCG011"] and r["severities"] == ["warning"]
        assert "post-fusion graph has only 1 ops" in r["messages"][0]
        assert not r["pipelined"]


def _cache_cfg(tmp_path, mode):
    return T.FFConfig(batch_size=8, device="cpu", search_budget=1, search_cache="on",
                      search_cache_dir=str(tmp_path / "sc"), validate_pcg=mode)


def _cached_mlp(cfg):
    ff = T.FFModel(cfg)
    tbuild_mlp(ff, 8, in_dim=16, hidden_dims=(32,), num_classes=4)
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _corrupt_entry(ff, tmp_path):
    """Shard the 4-wide head over a 3-wide model axis in the stored plan."""
    entry = tmp_path / "sc" / f"{ff._strategy_cache_key}.json"
    doc = json.loads(entry.read_text())
    doc["result"]["strategies"]["mlp_head"] = {"out": "model"}
    doc["result"]["mesh_shape"] = {"data": 1, "model": 3}
    entry.write_text(json.dumps(doc))


def test_corrupted_cache_entry_is_a_coded_finding_and_a_demoted_miss(tmp_path, capsys):
    first = _cached_mlp(_cache_cfg(tmp_path, "error"))
    assert first.search_profile["cache"] == "miss"
    _corrupt_entry(first, tmp_path)
    # "warn": the coded finding prints and the hit demotes to a miss
    ff = _cached_mlp(_cache_cfg(tmp_path, "warn"))
    out = capsys.readouterr().out
    assert "[pcg] PCG006 [error]" in out and "treating as a miss" in out
    assert ff.search_profile["cache"] != "hit"


def test_corrupted_cache_entry_raises_under_error(tmp_path):
    _corrupt_entry(_cached_mlp(_cache_cfg(tmp_path, "error")), tmp_path)
    with pytest.raises(TA.PCGValidationError) as ei:
        _cached_mlp(_cache_cfg(tmp_path, "error"))
    assert ei.value.report.source.startswith("cache:")


def test_clean_cache_hit_reuses_its_validation(tmp_path):
    _cached_mlp(_cache_cfg(tmp_path, "error"))
    ff = _cached_mlp(_cache_cfg(tmp_path, "error"))
    assert ff.search_profile["cache"] == "hit"
    assert ff.pcg_report is not None and ff.pcg_report.source.startswith("cache:")


def test_attention_departure_where_layouts_differ():
    """The attention op's strategy keys are the JAX package's, but the
    port lays a TP attention out as separate Q/K/V/O blocks over the
    heads, so a head count the model axis does not divide is dropped in
    both (PCG006) while a divisible one validates in both."""
    for heads, ok in ((4, True), (6, False)):
        keys = []
        for P in (JAXP, PORT):
            ff = P.FFModel(P.cfg(batch_size=8))
            P.build_transformer(ff, 8, P.TC(hidden_size=48, num_heads=heads, num_layers=1,
                                            sequence_length=16), tp_axis="model")
            strat = {l.name: l.attrs["strategy"] for l in ff.layers if l.attrs.get("strategy")}
            rep = _validate(P, ff, strat, {"data": 2, "model": 4})
            keys.append(_key(rep))
            assert rep.ok() is ok, rep.format()
        assert keys[0] == keys[1]
