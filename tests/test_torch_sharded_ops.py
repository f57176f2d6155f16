"""Sharded tables, spatial and channel-sharded convolution, global batch
statistics and bucketed batches over a mesh: the port's ranks spawned over
gloo on the CPU (one process group of 2 for the file), each run held to
the JAX package compiled over the same mesh on as many host devices, and
to the one-rank port.

* Embedding ``{"vocab": axis}`` (NONE, SUM and AVG) on {model: 2}, and on
  {data: 2} where the ids' batch is sharded over the table's own axis;
  ``{"out": axis}`` on {model: 2}; ids past the table and below minus it
  give NaN rows, negative ids wrap, as ``jnp.take`` on the JAX mesh gives.
* Conv2D ``{"spatial": axis}`` (``tests/test_parallel.py``'s stack, and an
  odd kernel at stride 2 with padding at the top and bottom shards, the
  pooling carrying the height sharding) and ``{"out_channels": axis}``
  (with a channel-sharded BatchNorm and grouped convolution) on {model: 2}.
* BatchNorm over {data: 2} and over a height sharded by the ResNet-50
  stem's spatial convolution: global statistics, running averages
  included.
* ReduceSum and Mean over the sharded batch on {data: 2}.
* DLRM (``param_axis``) and XDL (``embedding_strategy``) on {model: 2}.
* ``seq_buckets`` over {data: 2}: every packed row count a multiple of 2.

Tolerances (f32), as ``test_torch_parallel_training.py``: sums run in
another order (partial rows all-reduced, the statistics from sums and sums
of squares, gradients summed over ranks): 1e-5 of the largest |value|, and
the params besides 2^-4 of the largest update of their tensor."""

import numpy as np

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import ffconst as jns
from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models.dlrm import DLRMConfig as JDLRMConfig
from flexflow_tpu.models.dlrm import build_dlrm as jbuild_dlrm
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.models.xdl import XDLConfig as JXDLConfig
from flexflow_tpu.models.xdl import build_xdl as jbuild_xdl
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH, STEPS = 8, 2
TOL, UPDATE_TOL = 1e-5, 2 ** -4
MSE, SCE = "MEAN_SQUARED_ERROR_AVG_REDUCE", "SPARSE_CATEGORICAL_CROSSENTROPY"
EMB = ("emb_none", "emb_sum", "emb_avg")

# name: (kind, mesh, strategies, loss)
RUNS = {
    "emb-vocab-model2": ("emb", {"model": 2}, {n: {"vocab": "model"} for n in EMB}, MSE),
    "emb-vocab-data2": ("emb", {"data": 2}, {n: {"vocab": "data"} for n in EMB}, MSE),
    "emb-out-model2": ("emb", {"model": 2}, {n: {"out": "model"} for n in EMB}, MSE),
    "conv-spatial-model2": ("conv_stack", {"model": 2},
                            {"c1": {"spatial": "model"}, "c2": {"spatial": "model"}}, SCE),
    "conv-odd-spatial-model2": ("conv_odd", {"model": 2}, {"c1": {"spatial": "model"}}, SCE),
    "conv-out-channels-model2": ("conv_oc", {"model": 2},
                                 {"c1": {"out_channels": "model"},
                                  "c2": {"out_channels": "model"}}, SCE),
    "bn-data2": ("bn", {"data": 2}, {}, SCE),
    "stem-spatial-model2": ("stem", {"model": 2}, {"c1": {"spatial": "model"}}, SCE),
    "stem-data2": ("stem", {"data": 2}, {}, SCE),
    "reduce-data2": ("reduce", {"data": 2}, {}, MSE),
    "reduce-all-data2": ("reduce_all", {"data": 2}, {}, MSE),
    "dlrm-model2": ("dlrm", {"model": 2}, {}, MSE),
    "xdl-model2": ("xdl", {"model": 2}, {}, MSE),
}
# forward only, ids past the table and negative: name: (kind, strategies)
FORWARDS = {"rows": ("emb_rows", {"emb_none": {"vocab": "model"}}),
            "bags": ("emb_bag", {"emb_sum": {"vocab": "model"}, "emb_avg": {"vocab": "model"}})}
GPT = dict(vocab_size=32, max_positions=32, hidden_size=16, num_heads=2, num_layers=1)


def _port_model(kind, mesh_shape=None):
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", mesh_shape=mesh_shape))
    workers._port_graph(ff, kind, BATCH)
    ff.compile()
    return ff


def _draw_params(ff, rng):
    params = {}
    for op, ws in ff.compiled.params.items():
        params[op] = {}
        for w, t in ws.items():
            shape = tuple(t.shape)
            if w.startswith("running"):
                params[op][w] = t.numpy().copy()
                continue
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            std = 0.1 if len(shape) == 1 else np.sqrt(1.0 / fan_in)
            params[op][w] = (rng.normal(size=shape) * std).astype(np.float32)
    return params


def _inputs(kind, rng, invalid=False):
    if kind.startswith("emb"):
        lo, hi = (-24, 24) if invalid else (-16, 16)
        return [rng.integers(lo, hi, size=(BATCH, 3)).astype(np.int32)]
    if kind.startswith("reduce"):
        return [rng.standard_normal((BATCH, 16)).astype(np.float32)]
    if kind == "dlrm":
        return [rng.integers(0, 32, size=(BATCH, 1)).astype(np.int32),
                rng.integers(0, 64, size=(BATCH, 1)).astype(np.int32),
                rng.standard_normal((BATCH, 4)).astype(np.float32)]
    if kind == "xdl":
        return [rng.integers(0, 32, size=(BATCH, 1)).astype(np.int32) for _ in range(2)]
    shape = {"conv_stack": (3, 16, 16), "conv_odd": (3, 16, 16), "conv_oc": (4, 8, 8),
             "bn": (3, 8, 8), "stem": (3, 32, 32)}[kind]
    return [rng.standard_normal((BATCH,) + shape).astype(np.float32)]


def _case(name):
    kind, _, _, loss = RUNS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    params = _draw_params(_port_model(kind), rng)
    batches = []
    for _ in range(STEPS):
        xs = _inputs(kind, rng)
        if loss == SCE:
            y = rng.integers(0, 5, size=(BATCH, 1)).astype(np.int32)
        else:
            y = rng.standard_normal((BATCH, 2 if kind == "dlrm" else 1)).astype(np.float32)
        batches.append(tuple(xs) + (y,))
    return params, batches


def _forward_case(name):
    kind, _ = FORWARDS[name]
    rng = np.random.default_rng(5)
    return _draw_params(_port_model(kind), rng), _inputs(kind, rng, invalid=True)


def _jax_model(kind, mesh_shape, strategies, loss):
    jff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                             attribution="off"))
    if kind == "dlrm":
        jbuild_dlrm(jff, BATCH, JDLRMConfig(embedding_size=[32, 64], sparse_feature_size=8,
                                            mlp_bot=[4, 8, 8], mlp_top=[8, 8, 2]),
                    param_axis="model")
    elif kind == "xdl":
        jbuild_xdl(jff, BATCH, JXDLConfig(embedding_size=[32] * 2, sparse_feature_size=8,
                                          mlp_top=[16, 1]),
                   embedding_strategy={"vocab": "model"})
    else:
        workers.sharded_graph(jff, kind, BATCH, jns)
    n = int(np.prod(list(mesh_shape.values())))
    jff.compile(optimizer=JSGDOptimizer(lr=0.05) if loss else None,
                loss_type=getattr(JLossType, loss) if loss else None, metrics=[],
                mesh=jmake_mesh(mesh_shape, jax.devices()[:n]), strategies=strategies)
    return jff


def _jax_load(jff, params):
    cm = jff.compiled
    cm.params = jax.tree_util.tree_map(lambda a, sh: jax.device_put(a, sh), params,
                                       cm.param_shardings)
    if jff.optimizer is not None and cm.opt_state is not None:
        cm.opt_state = jff.optimizer.init_state(cm.params)
    return cm


def _jax_run(name):
    kind, mesh_shape, strategies, loss = RUNS[name]
    params, batches = _case(name)
    jff = _jax_model(kind, mesh_shape, strategies, loss)
    cm = _jax_load(jff, params)
    losses = []
    for b in batches:
        cm.params, cm.opt_state, l, _ = cm.train_step(cm.params, cm.opt_state,
                                                      jax.random.key(0), *b)
        losses.append(float(l))
    specs = {op.name: tuple(op.output_shapes[0].partition_spec()) for op in cm.ops}
    return losses, {op: {w: np.asarray(a) for w, a in ws.items()}
                    for op, ws in cm.params.items()}, specs


def _close(got, want, start):
    for op, ws in want.items():
        for w, a in ws.items():
            atol = TOL * float(np.abs(a).max()) + UPDATE_TOL * float(
                np.abs(a - start[op][w]).max())
            np.testing.assert_allclose(got[op][w], a, rtol=TOL, atol=atol, err_msg=f"{op}.{w}")


def _todo():
    todo = []
    for name, (kind, mesh, strategies, loss) in RUNS.items():
        params, batches = _case(name)
        todo.append(("sharded_ops", (kind, mesh, strategies, params, batches, loss)))
    for name, (kind, strategies) in FORWARDS.items():
        params, xs = _forward_case(name)
        todo.append(("sharded_ops", (kind, {"model": 2}, strategies, params, None, None, xs)))
    params, x, pos, y = _bucket_case()
    todo.append(("bucket_fit", ({"data": 2}, GPT, params, x, pos, y)))
    return todo


def _bucket_case():
    ff = FFModel(FFConfig(batch_size=8, device="cpu", seed=3))
    from flexflow_tpu_torch.models import GPTConfig, build_gpt

    build_gpt(ff, 8, 32, GPTConfig(**GPT))
    ff.compile()
    rng = np.random.default_rng(13)
    params = _draw_params(ff, rng)
    n, s = 24, 32
    lengths = rng.integers(3, s + 1, size=n)
    x = rng.integers(0, GPT["vocab_size"], size=(n, s)).astype(np.int32)
    y = rng.integers(0, GPT["vocab_size"], size=(n, s)).astype(np.int32)
    for i, length in enumerate(lengths):
        y[i, length:] = -1  # the row's padding
    pos = np.tile(np.arange(s, dtype=np.int32), (n, 1))
    return params, x, pos, y


def _jax_bucket_fit():
    params, x, pos, y = _bucket_case()
    jff = JFFModel(JFFConfig(batch_size=8, seed=3, seq_buckets="pow2", seq_bucket_min=4,
                             token_budget=64, ledger="off", audit_programs="off",
                             attribution="off"))
    jbuild_gpt(jff, 8, 32, JGPTConfig(**GPT))
    jff.compile(optimizer=JSGDOptimizer(lr=0.05),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
                mesh=jmake_mesh({"data": 2}, jax.devices()[:2]))
    _jax_load(jff, params)
    jff.fit([x, pos], y, epochs=1, shuffle=False, verbose=False)
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in jff.compiled.params.items()}, jff.fit_profile["buckets"]


# one process group for the file: a module fixture would spawn again on
# every xdist worker that runs one of its tests
def test_sharded_tables_convolution_statistics_and_buckets_match_jax():
    ranks = spawn(workers.jobs, 2, _todo())
    names = list(RUNS)
    for i, name in enumerate(names):
        _check_run(name, [r[i] for r in ranks])
    for j, name in enumerate(FORWARDS, start=len(names)):
        _check_forward(name, [r[j] for r in ranks])
    _check_buckets([r[-1] for r in ranks])


def _check_run(name, ranks):
    kind, mesh_shape, strategies, loss = RUNS[name]
    params, batches = _case(name)
    losses = ranks[0]["losses"]
    assert all(r["losses"] == losses for r in ranks), name  # the global loss on every rank
    one = workers.sharded_ops(0, 1, kind, None, None, params, batches, loss)
    jlosses, jparams, jspecs = _jax_run(name)
    np.testing.assert_allclose(losses, one["losses"], rtol=TOL, err_msg=name)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, err_msg=name)
    _close(ranks[0]["params"], one["params"], params)
    _close(ranks[0]["params"], jparams, params)
    # the layouts the strategies give are the JAX package's
    for op in list(strategies) + [n for n in ("p1", "bn1") if n in jspecs]:
        assert ranks[0]["specs"][op] == jspecs[op], (name, op)


def _check_forward(name, ranks):
    kind, strategies = FORWARDS[name]
    params, xs = _forward_case(name)
    jff = _jax_model(kind, {"model": 2}, strategies, None)
    cm = _jax_load(jff, params)
    want = np.asarray(cm.forward_fn(cm.params, *xs))
    one = workers.sharded_ops(0, 1, kind, None, None, params, None, None, xs)["forward"]
    assert np.isnan(want).any() and not np.isnan(want).all()  # some ids fall off the table
    for r in ranks:
        np.testing.assert_array_equal(np.isnan(r["forward"]), np.isnan(want))
        np.testing.assert_allclose(r["forward"], want, rtol=TOL,
                                   atol=TOL * float(np.nanmax(np.abs(want))))
        np.testing.assert_allclose(r["forward"], one, rtol=TOL,
                                   atol=TOL * float(np.nanmax(np.abs(want))))


def _check_buckets(ranks):
    params = _bucket_case()[0]
    jparams, jbuckets = _jax_bucket_fit()
    for r in ranks:
        # the JAX package's plan at quantum 2: every packed batch splits
        for key in ("ladder", "padded_token_fraction", "new_compiles"):
            assert r["buckets"][key] == (list(jbuckets[key]) if key == "ladder"
                                         else jbuckets[key]), key
    assert ranks[0]["shapes"] == ranks[1]["shapes"]
    _close(ranks[0]["params"], jparams, params)
