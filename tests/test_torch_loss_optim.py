"""The port's losses, metrics and optimizers against the JAX package's.

The same logits, labels, params and gradients, made with numpy from a seed,
go through ``flexflow_tpu.runtime.{loss,metrics,optimizer}`` and their
counterparts in ``flexflow_tpu_torch.runtime``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.ffconst import MetricsType as JMetricsType
from flexflow_tpu.runtime import loss as jloss
from flexflow_tpu.runtime import metrics as jmetrics
from flexflow_tpu.runtime import optimizer as joptim
from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.runtime import loss as tloss
from flexflow_tpu_torch.runtime import metrics as tmetrics
from flexflow_tpu_torch.runtime import optimizer as toptim
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

# f32 on both sides, the same reductions in another order: a few ulps of
# the result (sums of up to 64 terms)
TOL = dict(rtol=2e-6, atol=1e-6)
BATCH, CLASSES = 8, 5


def _case(kind, rank, seed=0):
    """(logits, labels) for a loss family; ``rank`` 3 adds a position axis."""
    rng = np.random.default_rng(seed)
    lead = (BATCH, 4) if rank == 3 else (BATCH,)
    logits = rng.normal(size=lead + (CLASSES,)).astype(np.float32)
    if kind == "sparse":
        labels = rng.integers(0, CLASSES, size=lead + (1,)).astype(np.int32)
    elif kind == "probs":
        labels = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, size=lead)]
    else:
        labels = rng.normal(size=lead + (CLASSES,)).astype(np.float32)
    return logits, labels


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


LOSSES = [("SPARSE_CATEGORICAL_CROSSENTROPY", "sparse", 2),
          ("SPARSE_CATEGORICAL_CROSSENTROPY", "sparse", 3),
          ("CATEGORICAL_CROSSENTROPY", "probs", 2),
          ("MEAN_SQUARED_ERROR_AVG_REDUCE", "dense", 2),
          ("MEAN_SQUARED_ERROR_SUM_REDUCE", "dense", 2),
          ("IDENTITY", "dense", 2)]


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("name,kind,rank", LOSSES)
def test_compute_loss_matches_jax(name, kind, rank, from_logits):
    logits, labels = _case(kind, rank)
    if not from_logits:  # a softmax-terminated graph hands over probabilities
        logits = _softmax(logits)
    want = jloss.compute_loss(getattr(JLossType, name), jnp.asarray(logits),
                              jnp.asarray(labels), from_logits)
    got = tloss.compute_loss(getattr(LossType, name), torch.from_numpy(logits),
                             torch.from_numpy(labels), from_logits)
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_loss_from_string_matches_jax():
    for s in ("categorical_crossentropy", "sparse_categorical_crossentropy",
              "mean_squared_error", "mse", "identity"):
        assert tloss.loss_from_string(s).name == jloss.loss_from_string(s).name
    with pytest.raises(KeyError):
        tloss.loss_from_string("hinge")


@pytest.mark.parametrize("metric", [m.name for m in MetricsType])
@pytest.mark.parametrize("name,kind,rank", [LOSSES[0], LOSSES[1], LOSSES[2], LOSSES[3]])
def test_batch_metrics_match_jax(metric, name, kind, rank):
    logits, labels = _case(kind, rank, seed=1)
    args = ([getattr(JMetricsType, metric)], getattr(JLossType, name))
    want = jmetrics.compute_batch_metrics(*args, jnp.asarray(logits),
                                          jnp.asarray(labels), True)
    got = tmetrics.compute_batch_metrics([getattr(MetricsType, metric)],
                                         getattr(LossType, name),
                                         torch.from_numpy(logits),
                                         torch.from_numpy(labels), True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL, err_msg=k)


def test_perf_metrics_accumulate_and_flush_like_jax():
    logits, labels = _case("dense", 2, seed=2)
    mts = [MetricsType.MEAN_SQUARED_ERROR, MetricsType.MEAN_ABSOLUTE_ERROR]
    jmts = [JMetricsType.MEAN_SQUARED_ERROR, JMetricsType.MEAN_ABSOLUTE_ERROR]
    got, want = tmetrics.PerfMetrics(), jmetrics.PerfMetrics()
    for i in range(3):
        got.accumulate(tmetrics.compute_batch_metrics(
            mts, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
            torch.from_numpy(logits * i), torch.from_numpy(labels)))
        want.accumulate(jmetrics.compute_batch_metrics(
            jmts, JLossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
            jnp.asarray(logits * i), jnp.asarray(labels)))
    got.flush()
    want.flush()
    assert got.train_all == want.train_all == 3 * BATCH
    np.testing.assert_allclose(got.mse_loss, want.mse_loss, **TOL)
    np.testing.assert_allclose(got.mae_loss, want.mae_loss, **TOL)
    assert got.report(mts) == want.report(jmts)


def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"dense": {"kernel": (6, 4), "bias": (4,)},
              "attn": {"wq": (4, 2, 3), "bq": (2, 3)}}
    return {op: {w: rng.normal(size=s).astype(np.float32) for w, s in ws.items()}
            for op, ws in shapes.items()}


# a mixed weight-decay mask: kernels decay, biases do not
WD_MASK = {"dense": {"kernel": True, "bias": False}, "attn": {"wq": True, "bq": False}}


@pytest.mark.parametrize("make", [
    lambda m: m.SGDOptimizer(lr=0.05),
    lambda m: m.SGDOptimizer(lr=0.05, momentum=0.9, weight_decay=0.1),
    lambda m: m.SGDOptimizer(lr=0.05, momentum=0.9, nesterov=True, weight_decay=0.1),
    lambda m: m.AdamOptimizer(alpha=0.01, weight_decay=0.1),
], ids=["sgd", "momentum_wd", "nesterov_wd", "adam_wd"])
def test_optimizer_updates_match_jax(make):
    jopt, topt = make(joptim), make(toptim)
    params = _tree(0)
    jp = {op: {w: jnp.asarray(a) for w, a in ws.items()} for op, ws in params.items()}
    tp = {op: {w: torch.from_numpy(a.copy()) for w, a in ws.items()}
          for op, ws in params.items()}
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for step in range(4):
        if step == 2:  # hyperparams are read at every step
            for o in (jopt, topt):
                if hasattr(o, "lr"):
                    o.lr = 0.02
                else:
                    o.alpha = 0.002
        grads = _tree(10 + step)
        jp, js = jopt.update(jp, {op: {w: jnp.asarray(a) for w, a in ws.items()}
                                  for op, ws in grads.items()},
                             js, WD_MASK, jopt.hyperparams())
        same = topt.update(tp, {op: {w: torch.from_numpy(a) for w, a in ws.items()}
                                for op, ws in grads.items()}, ts, WD_MASK)
        assert same[0] is tp  # updated in place
        tp, ts = same
    for op, ws in tp.items():
        for w, t in ws.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[op][w]), **TOL,
                                       err_msg=f"{op}.{w}")
