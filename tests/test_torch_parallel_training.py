"""Training over a mesh: the reference Transformer on {data: 2} and
{data: 2, model: 2} (``tp_axis="model"``), GPT on {data: 2, model: 2},
a tensor-parallel MLP whose kernels carry L1L2 penalties, and the
parallel verbs between two dense layers, each through three SGD train
steps of the same global batches from the same params, the port's ranks
spawned over gloo on the CPU. Each run's
losses and gathered params are held against the JAX package compiled
over the same mesh on as many host devices, and against the one-rank
port; then ``fit`` with the Prefetcher on {data: 2} against the one-rank
``fit``. The sequence-parallel runs ({data: 2, seq: 2}, ring and a2a) are
``test_torch_parallel_training_seq.py``, on these helpers.

Tolerances (f32): sums run in another order (partial products
all-reduced, a ring's online softmax, gradients summed over ranks):
1e-5 of the largest |value|. The params get, besides, 2^-4 of the
largest update of their tensor: a ReLU input that rounds to the other
side of 0 moves a hidden unit's gradient by its share of the batch (the
same allowance as ``test_torch_training.py``)."""

import functools

import numpy as np

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH, STEPS = 8, 3
SHAPE = dict(hidden_size=64, embedding_size=64, num_heads=4, num_layers=2, sequence_length=16)
GPT_SHAPE = {"seq": 16, "cfg": dict(vocab_size=64, max_positions=32, hidden_size=64,
                                   num_heads=4, num_layers=2)}
TOL, UPDATE_TOL = 1e-5, 2 ** -4
MSE, SCE = "MEAN_SQUARED_ERROR_AVG_REDUCE", "SPARSE_CATEGORICAL_CROSSENTROPY"

# name: (model, mesh, builder kwargs, loss)
RUNS = {
    "transformer-data2": ("transformer", {"data": 2}, {}, MSE),
    "transformer-data2-model2": ("transformer", {"data": 2, "model": 2},
                                 {"tp_axis": "model"}, MSE),
    "gpt-data2-model2": ("gpt", {"data": 2, "model": 2}, {"tp_axis": "model"}, SCE),
    "mlp_l1l2-data2-model2": ("mlp_l1l2", {"data": 2, "model": 2}, {"tp_axis": "model"}, MSE),
    "verbs-data2-model2": ("verbs", {"data": 2, "model": 2}, {"tp_axis": "model"}, MSE),
    "transformer-data2-seq2-ring": ("transformer", {"data": 2, "seq": 2},
                                    {"seq_axis": "seq", "seq_mode": "ring"}, MSE),
    "transformer-data2-seq2-a2a": ("transformer", {"data": 2, "seq": 2},
                                   {"seq_axis": "seq", "seq_mode": "a2a"}, MSE),
}
SEQ_RUNS = ("transformer-data2-seq2-ring", "transformer-data2-seq2-a2a")


def _shape(model):
    return GPT_SHAPE if model == "gpt" else SHAPE


@functools.lru_cache(maxsize=None)
def _case(model):
    """(params, batches) from a seed: variance-preserving random weights
    and small biases, as tests/test_torch_training.py draws them."""
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    workers.build(ff, model, BATCH, _shape(model))
    ff.compile()
    rng = np.random.default_rng(7)
    params = {}
    for op, ws in ff.compiled.params.items():
        params[op] = {}
        for w, t in ws.items():
            shape = tuple(t.shape)
            if len(shape) == 1 or w.startswith("b"):
                std = 0.1
            else:
                std = np.sqrt(1.0 / (shape[0] if w in ("wq", "wk", "wv")
                                     else int(np.prod(shape[:-1]))))
            params[op][w] = (rng.normal(size=shape) * std).astype(np.float32)
    batches = []
    for _ in range(STEPS):
        if model in ("mlp_l1l2", "verbs"):
            h = SHAPE["hidden_size"]
            batches.append((rng.standard_normal((BATCH, h)).astype(np.float32),
                            rng.standard_normal((BATCH, 1)).astype(np.float32)))
        elif model == "gpt":
            s, v = GPT_SHAPE["seq"], GPT_SHAPE["cfg"]["vocab_size"]
            tok = rng.integers(0, v, size=(BATCH, s)).astype(np.int32)
            pos = np.tile(np.arange(s, dtype=np.int32), (BATCH, 1))
            batches.append((tok, pos, rng.integers(0, v, size=(BATCH, s)).astype(np.int32)))
        else:
            s, h = SHAPE["sequence_length"], SHAPE["hidden_size"]
            batches.append((rng.standard_normal((BATCH, s, h)).astype(np.float32),
                            rng.standard_normal((BATCH, s, 1)).astype(np.float32)))
    return params, batches


def _todo(name):
    model, mesh_shape, kw, loss = RUNS[name]
    params, batches = _case(model)
    return ("train", (model, mesh_shape, _shape(model), kw, params, batches, loss))


def spawn_runs(names, world: int, extra=()) -> dict:
    """The named runs (and ``extra`` jobs, keyed by their index) in one
    process group of ``world`` ranks: {name: every rank's record}."""
    todo = [_todo(name) for name in names] + list(extra)
    got = spawn(workers.jobs, world, todo)
    keys = list(names) + list(range(len(extra)))
    return {k: [r[i] for r in got] for i, k in enumerate(keys)}


def _jax_run(name):
    """The JAX package over the same mesh on as many host devices: three
    train steps from the same params; (losses, params)."""
    model, mesh_shape, kw, loss = RUNS[name]
    params, batches = _case(model)
    n = int(np.prod(list(mesh_shape.values())))
    jff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                             attribution="off"))
    if model == "gpt":
        jbuild_gpt(jff, BATCH, GPT_SHAPE["seq"], JGPTConfig(**GPT_SHAPE["cfg"]), **kw)
    elif model == "mlp_l1l2":
        from flexflow_tpu.ffconst import ActiMode as JActiMode
        from flexflow_tpu.keras.regularizers import L1L2 as JL1L2

        h, reg = SHAPE["hidden_size"], JL1L2(l1=1e-3, l2=1e-2)
        x = jff.create_tensor((BATCH, h), name="input")
        t = jff.dense(x, 4 * h, JActiMode.RELU, name="up", kernel_regularizer=reg,
                      strategy={"out": kw["tp_axis"]})
        t = jff.dense(t, h, name="down", kernel_regularizer=reg, strategy={"in": kw["tp_axis"]})
        jff.dense(t, 1, name="head", kernel_regularizer=reg)
    elif model == "verbs":
        from flexflow_tpu.ffconst import ActiMode as JActiMode

        workers.verbs(jff, JActiMode.RELU, BATCH, SHAPE["hidden_size"], kw["tp_axis"])
    else:
        jbuild_transformer(jff, BATCH, JTransformerConfig(**SHAPE), **kw)
    jff.compile(optimizer=JSGDOptimizer(lr=0.01), loss_type=getattr(JLossType, loss),
                mesh=jmake_mesh(mesh_shape, jax.devices()[:n]))
    cm = jff.compiled
    cm.params = jax.tree_util.tree_map(
        lambda a, sh: jax.device_put(a, sh), params, cm.param_shardings)
    cm.opt_state = jff.optimizer.init_state(cm.params)
    losses = []
    for b in batches:
        cm.params, cm.opt_state, l, _ = cm.train_step(cm.params, cm.opt_state,
                                                      jax.random.key(0), *b)
        losses.append(float(l))
    return losses, {op: {w: np.asarray(a) for w, a in ws.items()}
                    for op, ws in cm.params.items()}


def _close_params(got, want, start):
    for op, ws in want.items():
        for w, a in ws.items():
            atol = TOL * float(np.abs(a).max()) + UPDATE_TOL * float(np.abs(a - start[op][w]).max())
            np.testing.assert_allclose(got[op][w], a, rtol=TOL, atol=atol, err_msg=f"{op}.{w}")


# one process group a test: a module fixture would spawn again on every
# xdist worker that runs one of its tests
def test_data_parallel_matches_jax_and_one_rank_and_fit_takes_each_ranks_rows():
    """{data: 2}: three steps against JAX and one rank; then fit
    (shuffled, Prefetcher depth 2) and eval: each rank takes its rows of
    the same global batches, so the params, the epoch's count and its
    summed MSE are the one-rank fit's."""
    x, y = _fit_data()
    params = _case("transformer")[0]
    runs = spawn_runs(["transformer-data2"], 2, [("fit", ({"data": 2}, SHAPE, params, x, y, 2))])
    check_run("transformer-data2", runs["transformer-data2"])
    one = workers.fit(0, 1, None, SHAPE, params, x, y, 2)
    for r in runs[0]:
        assert r["train_all"] == one["train_all"] == 4 * BATCH
        assert r["eval_all"] == one["eval_all"] == 4 * BATCH
        assert r["profile_depth"] == 2
        np.testing.assert_allclose(r["mse"], one["mse"], rtol=TOL)
        np.testing.assert_allclose(r["eval_mse"], one["eval_mse"], rtol=TOL)
        _close_params(r["params"], one["params"], params)


TP_RUNS = ("transformer-data2-model2", "gpt-data2-model2", "mlp_l1l2-data2-model2",
           "verbs-data2-model2")


def test_tensor_parallel_matches_jax_and_one_rank():
    """{data: 2, model: 2}: the Transformer and GPT with tp_axis, a
    tensor-parallel MLP whose kernels carry penalties (a sharded kernel's
    penalty is the sum of its blocks'), and repartition, combine,
    replicate and reduction between two dense layers (the losses carry
    the values through the verbs, the params the gradients back through
    them; in the JAX package the verbs only move the data)."""
    runs = spawn_runs(list(TP_RUNS), 4)
    for name in TP_RUNS:
        check_run(name, runs[name])


def check_run(name, ranks):
    model, mesh_shape, kw, loss = RUNS[name]
    params, batches = _case(model)
    assert len(ranks) == int(np.prod(list(mesh_shape.values())))
    assert {r["backend"] for r in ranks} == {"gloo"}
    losses = ranks[0]["losses"]
    assert all(r["losses"] == losses for r in ranks)  # every rank reports the global loss
    one = workers.train(0, 1, model, None, _shape(model), kw, params, batches, loss)
    jlosses, jparams = _jax_run(name)
    np.testing.assert_allclose(losses, one["losses"], rtol=TOL)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    _close_params(ranks[0]["params"], one["params"], params)
    _close_params(ranks[0]["params"], jparams, params)


def _fit_data():
    rng = np.random.default_rng(11)
    s, h = SHAPE["sequence_length"], SHAPE["hidden_size"]
    return (rng.standard_normal((4 * BATCH + 3, s, h)).astype(np.float32),
            rng.standard_normal((4 * BATCH + 3, s, 1)).astype(np.float32))
