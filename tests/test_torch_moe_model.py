"""The MoE slice as a whole: ``build_moe_mnist`` served and trained by both
packages.

The model is built small in both packages (input 16, 4 experts, top-2,
expert hidden 32, 10 classes, batch 8), in its n-branch and its stacked
form, and compiled with Adam, sparse categorical cross-entropy and
accuracy, as ``examples/python/native/moe.py`` trains it. The JAX model is
compiled on one device with the Pallas kernels in the interpreter, so its
dispatch and combine run ``row_gather``/``row_gather_sum``; its params are
copied into the port with ``load_numpy_params``. Then the forward, one
gradient, five ``train_step``s, a ``fit`` epoch and ``eval`` must agree, in
float32 and with ``compute_dtype="bfloat16"``, and the training loss must
carry the load-balancing term that the eval loss leaves out.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.ffconst import MetricsType as JMetricsType
from flexflow_tpu.models.moe import MoeConfig as JMoeConfig
from flexflow_tpu.models.moe import build_moe_mnist as jbuild_moe_mnist
from flexflow_tpu.runtime.optimizer import AdamOptimizer as JAdamOptimizer
from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel, LossType,
                                MetricsType, load_numpy_params)
from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH = 8
SHAPE = dict(input_dim=16, num_exp=4, expert_hidden_size=32)
ALPHA = 0.003  # Adam's step, as examples/python/native/moe.py trains
METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")
# Tolerances, relative to the largest value of the compared tensor.
# f32: the same graph in the same precision, with sums (the dense layers'
# products, the softmaxes) in another order: a few f32 ulps, which five
# Adam steps (each a normalised step of up to ALPHA) keep at that scale.
F32_TOL = 2e-5
# bf16: both packages cast each op's inputs, weights and outputs to bf16
# but round intermediates at other places (the softmaxes' sums, the
# products' accumulators); one bf16 ulp is 2^-8 of a value, and a few pass
# through the gate, the experts and the head.
BF16_TOL = 2 ** -5
# params after Adam steps: a bf16 rounding that differs between the
# packages can flip the sign of a tiny gradient, which Adam turns into a
# whole step of ALPHA the other way; each step may do so once
ADAM_FLIP = 2 * ALPHA


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _params(op_weights, seed=0):
    """Random params: kernels of std 1/sqrt(fan_in), biases of std 0.1, so
    the gate's ReLU leaves some experts at exactly 0 (ties that the top-k
    must break as JAX does) and others apart."""
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in op_weights.items():
        tree[op] = {}
        for w, v in ws.items():
            shape = tuple(v.shape)
            std = 0.1 if w == "bias" else 1.0 / np.sqrt(shape[-2])
            tree[op][w] = (rng.normal(size=shape) * std).astype(np.float32)
    return tree


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, SHAPE["input_dim"])).astype(np.float32)
    y = rng.integers(0, 10, size=(n, 1)).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _compiled_pair(stacked, compute_dtype):
    """(JAX model, port model), built once per form and dtype so the JAX
    steps compile once for the file."""
    jff = JFFModel(JFFConfig(batch_size=BATCH, compute_dtype=compute_dtype,
                             ledger="off", audit_programs="off", attribution="off"))
    jbuild_moe_mnist(jff, BATCH, JMoeConfig(**SHAPE), stacked=stacked)
    jff.compile(optimizer=JAdamOptimizer(alpha=ALPHA),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[getattr(JMetricsType, m) for m in METRICS],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype, device="cpu"))
    build_moe_mnist(tff, BATCH, MoeConfig(**SHAPE), stacked=stacked)
    tff.compile(optimizer=AdamOptimizer(alpha=ALPHA),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[getattr(MetricsType, m) for m in METRICS])
    return jff, tff


def _models(stacked, compute_dtype):
    """The pair with the same fresh params and fresh optimizer state."""
    jff, tff = _compiled_pair(stacked, compute_dtype)
    tree = _params(jff.compiled.params)
    jff.compiled.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jff.compiled.opt_state = jff.optimizer.init_state(jff.compiled.params)
    load_numpy_params(tff, tree)
    tff.compiled.opt_state = tff.optimizer.init_state(tff.compiled.params)
    return jff, tff


def _tol(compute_dtype):
    return BF16_TOL if compute_dtype else F32_TOL


def _close(got, want, tol, what, atol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale + atol, err_msg=what)


def _close_params(tff, jff, compute_dtype, steps):
    for op, ws in tff.compiled.params.items():
        for w, t in ws.items():
            _close(t.detach().numpy(), jff.compiled.params[op][w], _tol(compute_dtype),
                   f"{op}.{w}", atol=ADAM_FLIP * steps if compute_dtype else 0.0)


def _close_metrics(got, want, tol):
    assert got.train_all == want.train_all
    assert got.train_correct == want.train_correct
    _close(got.sparse_cce_loss, want.sparse_cce_loss, tol, "sparse_cce_loss")


FORMS = pytest.mark.parametrize("stacked", [False, True], ids=["n_branch", "stacked"])
DTYPES = pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                                 ids=["float32", "bfloat16"])


@FORMS
def test_layer_names_and_weights_match_jax(stacked):
    jff, tff = _compiled_pair(stacked, None)
    want = {op: {w: tuple(v.shape) for w, v in ws.items()}
            for op, ws in jff.compiled.params.items()}
    got = {op: {w: tuple(v.shape) for w, v in ws.items()}
           for op, ws in tff.compiled.params.items()}
    assert got == want
    assert ("moe_experts" in got) == stacked and ("moe_exp0" in got) != stacked
    assert [op.op_type.name for op in tff.compiled.ops] == \
        [op.op_type.name for op in jff.compiled.ops]


@FORMS
@DTYPES
def test_forward_matches_jax(stacked, compute_dtype):
    jff, tff = _models(stacked, compute_dtype)
    x, _ = _data(BATCH, seed=2)
    want = jff.compiled.forward_fn(jff.compiled.params, x)
    got = tff.compiled.forward_fn(tff.compiled.params, torch.from_numpy(x))
    assert got.shape == (BATCH, 10) and got.dtype == torch.float32
    _close(got.numpy(), want, _tol(compute_dtype), "forward")
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-2)  # a softmax


@FORMS
@DTYPES
def test_grad_step_matches_jax(stacked, compute_dtype):
    """Every weight's gradient, the gate's balance term included."""
    jff, tff = _models(stacked, compute_dtype)
    x, y = _data(BATCH, seed=3)
    want = jff.compiled.grad_step(jff.compiled.params, jax.random.key(0), x, y)
    got = tff.compiled.grad_step(tff.compiled.params, None, torch.from_numpy(x),
                                 torch.from_numpy(y))
    for op, ws in got.items():
        for w, g in ws.items():
            assert g.dtype == torch.float32
            _close(g.numpy(), want[op][w], _tol(compute_dtype), f"{op}.{w}")


@FORMS
@DTYPES
def test_five_adam_steps_match_jax(stacked, compute_dtype):
    jff, tff = _models(stacked, compute_dtype)
    x, y = _data(5 * BATCH, seed=4)
    jcm, tcm = jff.compiled, tff.compiled
    for i in range(5):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        jcm.params, jcm.opt_state, jloss, jbm = jcm.train_step(
            jcm.params, jcm.opt_state, jax.random.key(0), xb, yb)
        tcm.params, tcm.opt_state, tloss, tbm = tcm.train_step(
            tcm.params, tcm.opt_state, None, torch.from_numpy(xb), torch.from_numpy(yb))
        assert tloss.dtype == torch.float32 and tloss.dim() == 0
        _close(tloss.item(), float(jloss), _tol(compute_dtype), f"loss at step {i}")
        assert int(tbm["correct"]) == int(jbm["correct"]), f"correct at step {i}"
    _close_params(tff, jff, compute_dtype, steps=5)


@FORMS
@DTYPES
def test_fit_epoch_then_eval_match_jax(stacked, compute_dtype):
    jff, tff = _models(stacked, compute_dtype)
    x, y = _data(4 * BATCH + 3, seed=5)  # the last samples are not a whole batch
    want = jff.fit(x, y, epochs=1, shuffle=False, verbose=False)
    got = tff.fit(x, y, epochs=1, shuffle=False, verbose=False)
    assert len(got) == len(want) == 1 and got[0].train_all == 4 * BATCH
    _close_metrics(got[0], want[0], _tol(compute_dtype))
    _close_params(tff, jff, compute_dtype, steps=4)
    xe, ye = _data(2 * BATCH, seed=6)
    _close_metrics(tff.eval(xe, ye, verbose=False), jff.eval(xe, ye, verbose=False),
                   _tol(compute_dtype))


def _balance_term(tff, x):
    """The load-balancing loss by hand: gate = relu(x Wg + bg), the top-2
    picks (lowest index first among ties), counts per expert, g = (lambda
    n / B) counts less its mean, and sum(g * gate)."""
    p = tff.compiled.params["moe_gate"]
    gate = torch.relu(x @ p["kernel"] + p["bias"])
    n, lam = SHAPE["num_exp"], MoeConfig().lambda_bal
    picks = torch.sort(gate, dim=-1, descending=True, stable=True)[1][:, :2]
    counts = torch.bincount(picks.reshape(-1), minlength=n).float()
    g = lam * n / x.shape[0] * counts
    return float(torch.sum((g - g.mean()) * gate))


@FORMS
def test_training_loss_carries_the_balance_term_and_eval_loss_does_not(stacked):
    jff, tff = _models(stacked, None)
    x, y = _data(BATCH, seed=7)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    aux = _balance_term(tff, tx)
    assert abs(aux) > 1e-4
    t_eval = tff.compiled.eval_step(tff.compiled.params, tx, ty)[0].item()
    j_eval = float(jff.compiled.eval_step(jff.compiled.params, x, y)[0])
    t_train = tff.compiled.train_step(tff.compiled.params, tff.compiled.opt_state, None,
                                      tx, ty)[2].item()
    j_train = float(jff.compiled.train_step(jff.compiled.params, jff.compiled.opt_state,
                                            jax.random.key(0), x, y)[2])
    np.testing.assert_allclose(t_train - t_eval, aux, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(j_train - j_eval, aux, rtol=1e-4, atol=1e-6)


def test_serving_a_softmax_of_shape_batch_by_classes():
    """InferenceEngine serves the MoE model; each answer is its row of the
    padded dispatch batch run through forward_fn, padding included (the
    routing ranks picks over the whole compiled batch)."""
    from flexflow_tpu_torch import CompMode
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    ff = FFModel(FFConfig(batch_size=BATCH, computation_mode=CompMode.INFERENCE,
                          device="cpu"))
    build_moe_mnist(ff, BATCH, MoeConfig(**SHAPE))
    ff.compile()
    x, _ = _data(5, seed=8)
    engine = InferenceEngine()
    inst = engine.register_ffmodel(ff, "moe")
    try:
        got = np.stack([engine.infer("moe", [row], timeout=60) for row in x[:2]])
    finally:
        engine.stop()
    assert inst.dispatches == 2 and got.shape == (2, 10)
    for i in range(2):
        padded = np.zeros((BATCH, SHAPE["input_dim"]), np.float32)
        padded[0] = x[i]
        want = ff.compiled.forward_fn(ff.compiled.params, torch.from_numpy(padded))
        np.testing.assert_array_equal(got[i], want[0].numpy())
