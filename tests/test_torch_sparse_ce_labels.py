"""Sparse cross-entropy at labels outside [0, V), against the JAX package.

The reference picks the label's log-probability with
``jnp.take_along_axis``, which wraps a label in [-V, 0) from the end and
gives NaN for one at or past V (or below -V). The port's ``compute_loss``
and ``compute_batch_metrics`` must give the same numbers, NaN where JAX
gives NaN, and raise nothing (on a card, nothing may fire a device-side
assert). Per sample ((N, V) logits, (N, 1) labels) and token level
((B, S, V) logits, (B, S) labels), from raw logits and from a softmax's
probabilities, on the CPU. f32 on both sides: 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.ffconst import MetricsType as JMetricsType
from flexflow_tpu.runtime.loss import compute_loss as jcompute_loss
from flexflow_tpu.runtime.metrics import compute_batch_metrics as jcompute_batch_metrics
from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import compute_batch_metrics
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

V = 5
TOL = dict(rtol=1e-6, atol=1e-6)
SPARSE = LossType.SPARSE_CATEGORICAL_CROSSENTROPY
JSPARSE = JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")

# (label set, whether JAX's loss is NaN): -1 wraps to V - 1; V and -V - 1
# are out of range
LABEL_SETS = [([0, 1, 2, -1], False), ([0, 1, 2, V], True), ([3, -V, 4, -V - 1], True),
              ([-1, -2, V - 1, 0], False)]


def _logits(rng, shape, from_logits):
    x = rng.normal(size=shape).astype(np.float32)
    if from_logits:
        return x
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _both(logits, labels, from_logits):
    """(port loss, JAX loss, port metrics, JAX metrics) as floats."""
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    loss = compute_loss(SPARSE, tl, tlab, from_logits).item()
    jloss = float(jcompute_loss(JSPARSE, logits, labels, from_logits))
    got = compute_batch_metrics([getattr(MetricsType, m) for m in METRICS], SPARSE, tl, tlab,
                                from_logits)
    want = jcompute_batch_metrics([getattr(JMetricsType, m) for m in METRICS], JSPARSE,
                                  logits, labels, from_logits)
    return loss, jloss, {k: float(v) for k, v in got.items()}, \
        {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize("from_logits", [True, False], ids=["logits", "probabilities"])
@pytest.mark.parametrize("labels,nan", LABEL_SETS, ids=lambda v: str(v))
def test_per_sample_labels_wrap_or_nan_as_jax(labels, nan, from_logits):
    logits = _logits(np.random.default_rng(0), (4, V), from_logits)
    lab = np.asarray(labels, np.int32)[:, None]
    loss, jloss, got, want = _both(logits, lab, from_logits)
    assert np.isnan(jloss) == nan
    np.testing.assert_allclose(loss, jloss, **TOL)  # NaN where JAX's is NaN
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("from_logits", [True, False], ids=["logits", "probabilities"])
def test_token_level_labels_wrap_or_nan_as_jax(from_logits):
    """(2, 3, V) logits: one row's labels hold -1 (wraps), the other's V
    (NaN); then the finite row alone."""
    rng = np.random.default_rng(1)
    logits = _logits(rng, (2, 3, V), from_logits)
    labels = np.asarray([[0, -1, 2], [V, 1, 3]], np.int32)
    loss, jloss, got, want = _both(logits, labels, from_logits)
    assert np.isnan(jloss) and np.isnan(loss)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    loss, jloss, got, want = _both(logits[:1], labels[:1], from_logits)
    assert np.isfinite(jloss)
    np.testing.assert_allclose(loss, jloss, **TOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def test_wrapped_label_has_the_wrapped_gradient():
    """A label of -1 trains class V - 1: the gradient equals the one of the
    label V - 1, and an out-of-range label's row gets none (its loss is NaN,
    but nothing raises)."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, V)).astype(np.float32)

    def grad(labels):
        x = torch.from_numpy(logits.copy()).requires_grad_(True)
        compute_loss(SPARSE, x, torch.tensor(labels, dtype=torch.int32)[:, None],
                     True).backward()
        return x.grad.numpy()

    np.testing.assert_allclose(grad([0, -1, 2]), grad([0, V - 1, 2]), **TOL)
    g = grad([0, V, 2])
    assert np.isfinite(g).all()
    np.testing.assert_array_equal(g[1], 0.0)
