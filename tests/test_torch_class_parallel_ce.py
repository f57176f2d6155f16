"""Cross-entropy over logits whose class dim is sharded (ROADMAP C9): the
two-dense MLP whose head shards its 10 classes over ``model``, on
``{model: 2}``, with sparse and dense categorical cross-entropy (and
mean squared error against one-hot targets, whose class sums run the
same way, its metric counts once per row). The
port's two gloo ranks are held to the JAX package compiled over the same
mesh on two host devices: one step's gradients, three train steps'
losses, the params after them, and the PerfMetrics of a ``fit`` epoch
and of an eval whose labels include one past the classes (a NaN loss in
both packages) and a negative one (wraps). The class-parallel argmax is
held to ``torch.argmax`` of the whole rows, ties and NaNs included.

Tolerances (f32): the log-softmax's sums run per block and are then
all-reduced: 1e-5 of the largest |value| for losses, gradients and the
summed CE; the params, besides, 2^-4 of their largest update (as
``test_torch_parallel_training.py``); counts exactly."""

import functools

import numpy as np
import pytest

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.ffconst import MetricsType as JMetricsType
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH, STEPS, CLASSES = 8, 3, 10
TOL, UPDATE_TOL = 1e-5, 2 ** -4
LOSSES = ("SPARSE_CATEGORICAL_CROSSENTROPY", "CATEGORICAL_CROSSENTROPY",
          "MEAN_SQUARED_ERROR_AVG_REDUCE")


def _labels(loss, ids):
    if loss.startswith("SPARSE"):
        return ids.reshape(-1, 1).astype(np.int32)
    return np.eye(CLASSES, dtype=np.float32)[ids % CLASSES]


@functools.lru_cache(maxsize=None)
def _case(loss):
    rng = np.random.default_rng(23)
    params = {"hidden": {"kernel": rng.normal(size=(16, 32)).astype(np.float32) * 0.25,
                         "bias": rng.normal(size=32).astype(np.float32) * 0.1},
              "head": {"kernel": rng.normal(size=(32, CLASSES)).astype(np.float32) * 0.18,
                       "bias": rng.normal(size=CLASSES).astype(np.float32) * 0.1}}
    batches = [(rng.standard_normal((BATCH, 16)).astype(np.float32),
                _labels(loss, rng.integers(0, CLASSES, BATCH))) for _ in range(STEPS)]
    px = rng.standard_normal((BATCH, 16)).astype(np.float32)
    ids = rng.integers(0, CLASSES, BATCH)
    if loss.startswith("SPARSE"):
        ids[2], ids[5] = CLASSES, -3  # past the classes: NaN; negative: wraps
    return params, batches, (px, _labels(loss, ids))


@functools.lru_cache(maxsize=None)
def _port_runs():
    """Every loss and the argmax case in one process group of 2 ranks, once
    a worker: a group's start-up costs more than all its jobs."""
    todo = [("class_ce", ({"model": 2}, loss, *_case(loss))) for loss in LOSSES]
    todo.append(("class_argmax", (_argmax_case(),)))
    got = spawn(workers.jobs, 2, todo)
    return {k: [r[i] for r in got] for i, k in enumerate(list(LOSSES) + ["argmax"])}


def _jax_run(loss):
    params, batches, probe = _case(loss)
    jff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                             attribution="off"))
    workers.class_ce_graph(jff, JActiMode.RELU, BATCH)
    jff.compile(optimizer=JSGDOptimizer(lr=0.1), loss_type=getattr(JLossType, loss),
                metrics=[JMetricsType.ACCURACY, workers.class_ce_metric(JMetricsType, loss)],
                mesh=jmake_mesh({"model": 2}, jax.devices()[:2]))
    cm = jff.compiled
    cm.params = jax.tree_util.tree_map(lambda a, sh: jax.device_put(a, sh), params,
                                       cm.param_shardings)
    cm.opt_state = jff.optimizer.init_state(cm.params)
    grads = cm.grad_step(cm.params, jax.random.key(0), *batches[0])
    losses = []
    for b in batches:
        cm.params, cm.opt_state, l, _ = cm.train_step(cm.params, cm.opt_state,
                                                      jax.random.key(0), *b)
        losses.append(float(l))
    after = {op: {w: np.asarray(a) for w, a in ws.items()} for op, ws in cm.params.items()}
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    fit = jff.fit(xs, ys, epochs=1, shuffle=False, verbose=False)[-1]
    ev = jff.eval(probe[0], probe[1], verbose=False)
    return dict(grads={op: {w: np.asarray(a) for w, a in ws.items()}
                       for op, ws in grads.items()},
                losses=losses, params=after, metrics=workers.class_ce_sums(fit, ev))


def _close(got, want, err_msg, start=None):
    atol = TOL * float(np.abs(want).max())
    if start is not None:
        atol += UPDATE_TOL * float(np.abs(want - start).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=atol, err_msg=err_msg)


@pytest.mark.parametrize("loss", LOSSES)
def test_class_sharded_cross_entropy_matches_jax(loss):
    ranks = _port_runs()[loss]
    want = _jax_run(loss)
    start = _case(loss)[0]
    for r in ranks:  # every rank of the class axis holds the whole rows' loss
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=TOL)
        for op, ws in want["grads"].items():
            for w, a in ws.items():
                _close(r["grads"][op][w], a, f"grad {op}.{w}")
        for op, ws in want["params"].items():
            for w, a in ws.items():
                _close(r["params"][op][w], a, f"{op}.{w}", start[op][w])
        for phase in ("fit", "eval"):
            got, exp = r["metrics"][phase], want["metrics"][phase]
            assert (got["train_all"], got["train_correct"]) == \
                (exp["train_all"], exp["train_correct"]), phase
            for k in ("cce_loss", "sparse_cce_loss", "mse_loss"):
                if np.isnan(exp[k]):
                    assert np.isnan(got[k]), (phase, k)
                else:
                    np.testing.assert_allclose(got[k], exp[k], rtol=TOL, err_msg=f"{phase} {k}")
    if loss.startswith("SPARSE"):
        assert np.isnan(want["metrics"]["eval"]["sparse_cce_loss"])


def _argmax_case():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 3, size=(12, 8)).astype(np.float32)  # many ties
    x[3, 6] = np.nan
    x[4, 1] = x[4, 5] = np.nan
    x[5, :] = -np.inf
    x[6, 7] = np.inf
    return x


def test_class_argmax_is_the_whole_rows_first_maximum():
    want = np.argmax(_argmax_case(), axis=1)  # NumPy and torch both take the first
    import torch

    assert torch.argmax(torch.from_numpy(_argmax_case()), dim=1).tolist() == want.tolist()
    for got in _port_runs()["argmax"]:
        assert got == want.tolist()
