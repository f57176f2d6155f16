"""The pipeline: ``split_stages`` against the JAX package's, and the
reference Transformer trained through both engines under every schedule
on {pipe: 2} and {pipe: 2, data: 2}, the port's ranks spawned over gloo
on the CPU. Each run's losses and params after three SGD steps are held
against the JAX package's pipeline over the same mesh on as many host
devices and against the one-rank port, and the schedules and engines
against each other bit for bit (as ``tests/test_pipe_zoo.py`` holds the
JAX package's). Then the MoE graph pipelined (int32 routing tensors
crossing the cut), ``forward_only``, ``grad_accum_steps`` folded into the
microbatches, the single-call engine's fallback for a batch-coupled graph
under a data submesh, and ``schedule="auto"`` resolved by the simulator
to the schedule the JAX package picks.

Tolerances (f32), as ``test_torch_parallel_training.py``: 1e-5 of the
largest |value|, and for params 2^-4 of each tensor's largest update."""

import functools

import numpy as np
import pytest

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models.moe import MoeConfig as JMoeConfig
from flexflow_tpu.models.moe import build_moe_mnist as jbuild_moe_mnist
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.parallel.pipeline import PipelineConfig as JPipelineConfig
from flexflow_tpu.parallel.pipeline import split_stages as jsplit_stages
from flexflow_tpu.parallel.pipeline_compiled import \
    compiled_engine_unsupported as jcompiled_engine_unsupported
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import FFConfig, FFModel, LossType
from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist
from flexflow_tpu_torch.parallel.distributed import spawn
from flexflow_tpu_torch.parallel.pipeline import PipelineConfig, split_stages
from flexflow_tpu_torch.parallel.pipeline_compiled import compiled_engine_unsupported

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH, STEPS = 8, 3
SHAPE = dict(hidden_size=32, embedding_size=32, num_heads=4, num_layers=2, sequence_length=8)
MOE = dict(input_dim=16, num_classes=4, num_exp=4, num_select=2, expert_hidden_size=16, alpha=4.0)
MSE, SCE = "MEAN_SQUARED_ERROR_AVG_REDUCE", "SPARSE_CATEGORICAL_CROSSENTROPY"
TOL, UPDATE_TOL = 1e-5, 2 ** -4
VARIANTS = [("gpipe", 1, "host", False), ("gpipe", 1, "compiled", False),
            ("1f1b", 1, "host", False), ("1f1b", 1, "compiled", False),
            ("interleaved", 2, "host", False), ("interleaved", 2, "compiled", False),
            ("1f1b", 1, "host", True)]


def _pcfg(schedule, interleave, engine, remat, m=4):
    return dict(num_stages=2, num_microbatches=m, schedule=schedule, interleave=interleave,
                engine=engine, remat=remat)


@functools.lru_cache(maxsize=None)
def _case(model: str):
    """(params, batches) from a seed, shaped by the port's one-rank build."""
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    if model == "moe":
        build_moe_mnist(ff, BATCH, MoeConfig(**MOE), stacked=True)
    else:
        workers.build(ff, model, BATCH, SHAPE)
    ff.compile()
    rng = np.random.default_rng(17)
    def std(w, shape):
        # variance-preserving, as test_torch_parallel_training.py draws them
        if len(shape) == 1 or w.startswith("b"):
            return 0.1
        if model == "moe":
            return np.sqrt(1.0 / shape[-2])
        return np.sqrt(1.0 / (shape[0] if w in ("wq", "wk", "wv") else np.prod(shape[:-1])))

    params = {op: {w: (rng.normal(size=tuple(t.shape)) * std(w, tuple(t.shape)))
                   .astype(np.float32) for w, t in ws.items()}
              for op, ws in ff.compiled.params.items()}
    batches = []
    for _ in range(STEPS):
        if model == "moe":
            batches.append((rng.standard_normal((BATCH, MOE["input_dim"])).astype(np.float32),
                            rng.integers(0, MOE["num_classes"], (BATCH, 1)).astype(np.int32)))
        else:
            s, h = SHAPE["sequence_length"], SHAPE["hidden_size"]
            batches.append((rng.standard_normal((BATCH, s, h)).astype(np.float32),
                            rng.standard_normal((BATCH, s, 1)).astype(np.float32)))
    return params, batches


def _jbuild(jff, model):
    if model == "moe":
        return jbuild_moe_mnist(jff, BATCH, JMoeConfig(**MOE), stacked=True)
    return jbuild_transformer(jff, BATCH, JTransformerConfig(**SHAPE))


def _jax_pipe(model, mesh_shape, pipeline):
    """The JAX package's pipeline over the same mesh: (losses, params)."""
    params, batches = _case(model)
    n = int(np.prod(list(mesh_shape.values())))
    jff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                             attribution="off"))
    _jbuild(jff, model)
    jff.compile(optimizer=JSGDOptimizer(lr=0.01),
                loss_type=getattr(JLossType, SCE if model == "moe" else MSE),
                mesh=jmake_mesh(mesh_shape, jax.devices()[:n]),
                pipeline=JPipelineConfig(**pipeline))
    cm, pm = jff.compiled, jff.pipelined
    cm.params = jax.tree_util.tree_map(lambda a, sh: jax.device_put(a, sh), params,
                                       cm.param_shardings)
    pm.sync_from(cm)
    losses = [float(pm.train_step(jax.random.key(0), list(b[:-1]), b[-1])[0]) for b in batches]
    return losses, {op: {w: np.asarray(a) for w, a in ws.items()}
                    for op, ws in pm.all_params().items()}


def _job(model, mesh_shape, pipeline, **kw):
    params, batches = _case(model)
    return ("pipe", (mesh_shape, model, MOE if model == "moe" else SHAPE, params, batches,
                     SCE if model == "moe" else MSE, pipeline, kw.get("kw"), kw.get("config"),
                     kw.get("forward_x")))


def _close(got, want, start):
    np.testing.assert_allclose(got["losses"], want[0], rtol=TOL)
    for op, ws in want[1].items():
        for w, a in ws.items():
            atol = TOL * float(np.abs(a).max()) + UPDATE_TOL * float(np.abs(a - start[op][w]).max())
            np.testing.assert_allclose(got["params"][op][w], a, rtol=TOL, atol=atol,
                                       err_msg=f"{op}.{w}")


def _bitwise(a, b):
    assert a["losses"] == b["losses"]
    for op, ws in b["params"].items():
        for w, t in ws.items():
            assert np.array_equal(a["params"][op][w], t), f"{op}.{w}"


def _one_rank(model):
    params, batches = _case(model)
    if model == "moe":
        return workers.moe(0, 1, None, MOE, True, None, params, batches)
    return workers.train(0, 1, model, None, SHAPE, {}, params, batches, MSE)


@pytest.mark.parametrize("model", ["transformer", "moe"])
def test_split_stages_matches_jax(model):
    """The FLOP-balanced contiguous split of the port's ops equals the JAX
    package's for 2 to 6 chunks."""
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    if model == "moe":
        build_moe_mnist(ff, BATCH, MoeConfig(**MOE), stacked=True)
    else:
        workers.build(ff, model, BATCH, SHAPE)
    ff.compile()
    jff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                             attribution="off"))
    _jbuild(jff, model)
    jff.compile(optimizer=JSGDOptimizer(lr=0.01), loss_type=JLossType.MEAN_SQUARED_ERROR_AVG_REDUCE
                if model != "moe" else JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                mesh=jmake_mesh({"data": 1}, jax.devices()[:1]))
    # by position: auto-named layers (top_k, softmax) carry a process-wide
    # counter in either package
    ops, jops = ff.compiled.ops, jff.compiled.ops
    assert [op.op_type.value for op in ops] == [op.op_type.value for op in jops]
    assert [op.flops() for op in ops] == [op.flops() for op in jops]
    for n in range(2, 7):
        got = [len(ch) for ch in split_stages(ops, n)]
        assert got == [len(ch) for ch in jsplit_stages(jops, n)], n


def test_every_schedule_and_engine_on_pipe2_matches_jax_and_each_other():
    """{pipe: 2}: gpipe, 1f1b and interleaved (V 2) on both engines, and
    1f1b with remat on the host engine: the same losses and params bit for
    bit; against the JAX package's pipeline (gpipe, host) and the one-rank
    port; ``forward_only`` against one rank."""
    params, batches = _case("transformer")
    x = batches[0][0]
    todo = [_job("transformer", {"pipe": 2}, _pcfg(*v), forward_x=(x,)) for v in VARIANTS]
    got = spawn(workers.jobs, 2, todo)
    runs = [r for r in got[0]]
    for v, r, r1 in zip(VARIANTS, runs, got[1]):
        assert r["engine"] == v[2] and r["fallback_reason"] is None
        assert r1["losses"] == r["losses"] and r1["stage"] == 1 and r["stage"] == 0
        _bitwise(r, runs[0])
        _bitwise(r1, runs[0])
    want = _jax_pipe("transformer", {"pipe": 2}, _pcfg("gpipe", 1, "host", False))
    _close(runs[0], want, params)
    one = _one_rank("transformer")
    _close(runs[0], (one["losses"], one["params"]), params)
    # forward_only after the steps: the trained model's logits, on every rank
    from flexflow_tpu_torch import load_numpy_params

    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    workers.build(ff, "transformer", BATCH, SHAPE)
    ff.compile()
    load_numpy_params(ff, runs[0]["params"])
    import torch

    ref = ff.compiled.forward_fn(ff.compiled.params, torch.from_numpy(x)).numpy()
    for r in runs + list(got[1]):
        np.testing.assert_allclose(r["logits"], ref, rtol=TOL, atol=TOL * np.abs(ref).max())


def test_pipe_data_matches_jax_and_each_other_and_falls_back_for_moe():
    """{pipe: 2, data: 2}: the three schedules on both engines agree bit
    for bit and with the JAX package's pipe×data pipeline and one rank.
    The MoE graph there is batch-coupled: engine "auto" falls back to the
    host engine with the JAX package's reason, and trains as the JAX
    package's pipeline does."""
    params, _ = _case("transformer")
    variants = VARIANTS[:6]
    todo = [_job("transformer", {"pipe": 2, "data": 2}, _pcfg(*v, m=2)) for v in variants]
    todo.append(_job("moe", {"pipe": 2, "data": 2}, _pcfg("1f1b", 1, "auto", False, m=2),
                     kw=dict(stacked=True)))
    got = spawn(workers.jobs, 4, todo)
    runs = got[0][:len(variants)]
    for i, (v, r) in enumerate(zip(variants, runs)):
        assert r["engine"] == v[2] and r["fallback_reason"] is None
        for rank in got:
            _bitwise(rank[i], runs[0])
    want = _jax_pipe("transformer", {"pipe": 2, "data": 2}, _pcfg("gpipe", 1, "host", False, 2))
    _close(runs[0], want, params)
    one = _one_rank("transformer")
    _close(runs[0], (one["losses"], one["params"]), params)
    moe = got[0][-1]
    assert moe["engine"] == "host"
    jff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                             attribution="off"))
    _jbuild(jff, "moe")
    jff.compile(optimizer=JSGDOptimizer(lr=0.01), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                mesh=jmake_mesh({"pipe": 2, "data": 2}, jax.devices()[:4]))
    jreason = jcompiled_engine_unsupported(jff.compiled.mesh,
                                           JPipelineConfig(**_pcfg("1f1b", 1, "auto", False, 2)),
                                           ops=jff.compiled.ops, batch_size=BATCH)
    assert moe["fallback_reason"] == jreason and "batch-coupled" in jreason
    # routing and the balance term read each microbatch, so the reference
    # is the JAX package's pipeline (its "auto" falls back to host too)
    want = _jax_pipe("moe", {"pipe": 2, "data": 2}, _pcfg("1f1b", 1, "auto", False, 2))
    _close(moe, want, _case("moe")[0])


def test_moe_pipelined_with_routing_tensors_crossing_the_cut():
    """The stacked MoE on {pipe: 2}: the cut falls where the int32 top-k
    indices cross it; both engines against the JAX package's two engines
    (routing and the balance term read each microbatch, so an unpipelined
    run is no reference)."""
    params, _ = _case("moe")
    todo = [_job("moe", {"pipe": 2}, _pcfg("1f1b", 1, engine, False), kw=dict(stacked=True))
            for engine in ("host", "compiled")]
    got = spawn(workers.jobs, 2, todo)
    host, compiled = got[0]
    assert (host["engine"], compiled["engine"]) == ("host", "compiled")
    _bitwise(compiled, host)
    first, second = host["chunks"]
    assert "moe_agg" in second and "moe_gate" in first  # the assignment crosses
    for engine in ("host", "compiled"):
        _close(host, _jax_pipe("moe", {"pipe": 2}, _pcfg("1f1b", 1, engine, False)), params)


def test_grad_accum_folds_into_microbatches():
    """grad_accum_steps 2 with 2 microbatches is the 4-microbatch pipeline
    bit for bit, on both engines."""
    todo = [_job("transformer", {"pipe": 2}, _pcfg("1f1b", 1, engine, False, m),
                 config=dict(grad_accum_steps=accum))
            for engine in ("host", "compiled") for m, accum in ((4, 1), (2, 2))]
    got = spawn(workers.jobs, 2, todo)[0]
    assert [r["microbatches"] for r in got] == [4, 4, 4, 4]
    for r in got[1:]:
        _bitwise(r, got[0])


def _auto_rank(rank, world, mesh_shape, config):
    """Rank body: the Transformer compiled over ``mesh_shape`` with
    ``schedule="auto"``; the schedule, interleave and engine it resolved."""
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", mesh_shape=mesh_shape, **config))
    workers.build(ff, "transformer", BATCH, SHAPE)
    ff.compile(loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               pipeline=PipelineConfig(num_stages=2, schedule="auto"))
    pm = ff.pipelined
    return (pm.cfg.schedule, pm.cfg.interleave, pm.engine_name,
            [r["schedule"] for r in ff._pipe_schedule_records])


@pytest.mark.parametrize("mesh_shape", [{"pipe": 2}, {"pipe": 2, "data": 2}],
                         ids=["pipe2", "pipe2-data2"])
def test_compiled_envelope_and_auto_schedule(mesh_shape):
    """The single-call engine's envelope reasons equal the JAX package's;
    ``schedule="auto"`` compiles with the schedule the JAX package picks
    on {pipe: 2} and {pipe: 2, data: 2} (both price on the cpu-host
    machine over the same device count), one mesh a case."""
    class _Mesh:
        def __init__(self, shape):
            self.shape = shape
    for shape in ({"pipe": 2}, {"pipe": 2, "model": 2}, {"pipe": 1, "data": 2},
                  {"pipe": 2, "data": 2}):
        for sched in ("gpipe", "1f1b", "interleaved", "zigzag"):
            cfg = PipelineConfig(num_stages=2, schedule=sched)
            jcfg = JPipelineConfig(num_stages=2, schedule=sched)
            n = int(np.prod(list(shape.values())))
            jm = jmake_mesh(shape, jax.devices()[:n])
            assert compiled_engine_unsupported(_Mesh(shape), cfg, batch_size=6) == \
                jcompiled_engine_unsupported(jm, jcfg, batch_size=6)
    n = int(np.prod(list(mesh_shape.values())))
    jff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                             attribution="off"))
    _jbuild(jff, "transformer")
    jff.compile(loss_type=JLossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                mesh=jmake_mesh(mesh_shape, jax.devices()[:n]),
                pipeline=JPipelineConfig(num_stages=2, schedule="auto"))
    jcfg = jff.pipelined.cfg
    got = spawn(_auto_rank, n, mesh_shape, {})
    assert all(g == got[0] for g in got)
    assert got[0][:2] == (jcfg.schedule, jcfg.interleave), (got[0], jcfg)
    assert got[0][3] == [r["schedule"] for r in jff._pipe_schedule_records]
    assert FFConfig().pipeline_schedule == "auto" and FFConfig().pipeline_interleave == 2
    cfg = FFConfig.parse_args(["--pipeline-schedule", "1f1b", "--pipeline-interleave", "3",
                               "--pipeline-remat"])
    assert (cfg.pipeline_schedule, cfg.pipeline_interleave, cfg.pipeline_remat) == \
        ("1f1b", 3, True)
