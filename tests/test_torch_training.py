"""The training slice as a whole: the reference Transformer trained by both
packages.

``build_transformer`` is built small in both packages (2 layers, seq 32,
hidden 128, 4 heads, batch 2) and compiled with the same optimizer and
MSE-avg loss. The JAX model is compiled on one device with the Pallas
kernels in the interpreter, so its attention really runs the flash forward
and backward kernels; its params are copied into the port with
``load_numpy_params``. Then five ``train_step``s, one ``fit`` epoch,
``eval`` and the manual verbs must agree, in float32 and with
``compute_dtype="bfloat16"``.
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
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.runtime.optimizer import AdamOptimizer as JAdamOptimizer
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel, LossType,
                                MetricsType, SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH = 2
SHAPE = dict(hidden_size=128, embedding_size=128, num_heads=4, num_layers=2,
             sequence_length=32)
METRICS = ("MEAN_SQUARED_ERROR", "ROOT_MEAN_SQUARED_ERROR", "MEAN_ABSOLUTE_ERROR")
# Tolerances, relative to the largest value of the compared tensor.
# f32: the same graph in the same precision with sums in another order;
# after five updates params agree to a few f32 ulps of their scale.
F32_TOL = 2e-5
# bf16: both packages cast each op's inputs, weights and outputs to bf16
# and round intermediates at other places; one bf16 ulp is 2^-8 of a value,
# and a few of them pass through two layers and five updates.
BF16_TOL = 2 ** -5
# losses agree to a few f32 ulps until a ReLU flip (see _close_params)
# shifts the params by a share of an update
F32_LOSS_TOL = 1e-4
UPDATE_TOL = 2 ** -4

ADAM_ALPHA = 1e-3
OPTIMIZER_ARGS = {
    "sgd": dict(lr=0.01),
    "sgd_momentum_wd": dict(lr=0.01, momentum=0.9, weight_decay=1e-2),
    "nesterov": dict(lr=0.01, momentum=0.9, nesterov=True),
    "adam": dict(alpha=ADAM_ALPHA, weight_decay=1e-2),
}
OPTIMIZERS = {name: ((JAdamOptimizer, AdamOptimizer) if name == "adam"
                     else (JSGDOptimizer, SGDOptimizer))
              for name in OPTIMIZER_ARGS}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _params(op_weights, seed=0):
    """Random params with a variance-preserving scale and small random
    biases, as tests/test_torch_serving.py draws them (the Glorot init
    shrinks every layer of this residual-free stack)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in op_weights.items():
        tree[op] = {}
        for w, v in ws.items():
            shape = tuple(v.shape)
            if len(shape) == 1 or w.startswith("b"):
                std = 0.1
            else:
                fan_in = shape[0] if w in ("wq", "wk", "wv") else int(np.prod(shape[:-1]))
                std = np.sqrt((2.0 if op.endswith("ff2") else 1.0) / fan_in)
            tree[op][w] = (rng.normal(size=shape) * std).astype(np.float32)
    return tree


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, SHAPE["sequence_length"], SHAPE["hidden_size"]))
    y = rng.normal(size=(n, SHAPE["sequence_length"], 1))
    return x.astype(np.float32), y.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _compiled_pair(opt, compute_dtype):
    """(JAX model, port model) compiled for training, built once per
    (optimizer, dtype) so the JAX steps compile once for the file."""
    jopt, topt = OPTIMIZERS[opt]
    args = OPTIMIZER_ARGS[opt]
    jff = JFFModel(JFFConfig(batch_size=BATCH, compute_dtype=compute_dtype,
                             ledger="off", audit_programs="off",
                             attribution="off"))
    jbuild_transformer(jff, BATCH, JTransformerConfig(**SHAPE))
    jff.compile(optimizer=jopt(**args), loss_type=JLossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                metrics=[getattr(JMetricsType, m) for m in METRICS],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype,
                           device="cpu"))
    build_transformer(tff, BATCH, TransformerConfig(**SHAPE))
    tff.compile(optimizer=topt(**args), loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                metrics=[getattr(MetricsType, m) for m in METRICS])
    return jff, tff


def _models(opt, compute_dtype):
    """The pair with the same fresh params and fresh optimizer state."""
    jff, tff = _compiled_pair(opt, compute_dtype)
    tree = _params(jff.compiled.params)
    jff.compiled.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jff.compiled.opt_state = jff.optimizer.init_state(jff.compiled.params)
    load_numpy_params(tff, tree)
    tff.compiled.opt_state = tff.optimizer.init_state(tff.compiled.params)
    args = OPTIMIZER_ARGS[opt]
    for ff in (jff, tff):  # a test may have changed it
        ff.set_learning_rate(args.get("lr", args.get("alpha")))
    return jff, tff


def _tol(compute_dtype):
    return BF16_TOL if compute_dtype else F32_TOL


def _loss_tol(compute_dtype):
    return BF16_TOL if compute_dtype else F32_LOSS_TOL


def _snapshot(jff):
    return {op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in jff.compiled.params.items()}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _close_params(tff, jff, tol, p0, adam_steps=0):
    """Params after training, against the JAX package's, which started from
    ``p0``. A ReLU input that rounds to the other side of 0 in one package
    moves one hidden unit's gradient by that row's share (1/64 at batch 2,
    seq 32): such flips happen over a few steps, so each tensor also gets
    ``UPDATE_TOL`` of its largest update. ``adam_steps``: Adam updates taken.
    The key bias ``bk`` adds q.bk to every logit of a row, which the softmax
    cancels, so its exact gradient is 0 and both packages see only rounding
    noise; Adam scales noise up to a step of up to ``alpha`` per update in
    either direction, so ``bk`` gets twice that much leeway per update."""
    for op, ws in tff.compiled.params.items():
        for w, t in ws.items():
            want = np.asarray(jff.compiled.params[op][w])
            got = t.detach().numpy()
            if w == "bk" and adam_steps:
                atol = 2 * adam_steps * ADAM_ALPHA
            else:
                atol = (tol * float(np.abs(want).max())
                        + UPDATE_TOL * float(np.abs(want - p0[op][w]).max()))
            np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=f"{op}.{w}")


def _close_metrics(got, want, tol):
    assert got.train_all == want.train_all
    for k in ("mse_loss", "rmse_loss", "mae_loss"):
        _close(getattr(got, k), getattr(want, k), tol, k)


DTYPES = pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                                 ids=["float32", "bfloat16"])


@DTYPES
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_five_train_steps_match_jax(opt, compute_dtype):
    jff, tff = _models(opt, compute_dtype)
    x, y = _data(5 * BATCH)
    jcm, tcm = jff.compiled, tff.compiled
    tol, p0 = _tol(compute_dtype), _snapshot(jff)
    for i in range(5):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        jcm.params, jcm.opt_state, jloss, jbm = jcm.train_step(
            jcm.params, jcm.opt_state, jax.random.key(0), xb, yb)
        tcm.params, tcm.opt_state, tloss, tbm = tcm.train_step(
            tcm.params, tcm.opt_state, None, torch.from_numpy(xb),
            torch.from_numpy(yb))
        assert tloss.dtype == torch.float32 and tloss.dim() == 0
        _close(tloss.item(), float(jloss), _loss_tol(compute_dtype), f"loss at step {i}")
        for k, v in jbm.items():
            _close(tbm[k].item(), float(v), _loss_tol(compute_dtype), f"{k} at step {i}")
    _close_params(tff, jff, tol, p0, adam_steps=5 if opt == "adam" else 0)


@DTYPES
@pytest.mark.parametrize("shuffle", [False, True])
def test_fit_epoch_then_eval_match_jax(shuffle, compute_dtype):
    jff, tff = _models("sgd_momentum_wd", compute_dtype)
    x, y = _data(4 * BATCH + 1, seed=2)  # the last sample is not a whole batch
    p0 = _snapshot(jff)
    want = jff.fit(x, y, epochs=1, shuffle=shuffle, verbose=False)
    got = tff.fit(x, y, epochs=1, shuffle=shuffle, verbose=False)
    assert len(got) == len(want) == 1
    assert got[0].train_all == 4 * BATCH
    _close_metrics(got[0], want[0], _loss_tol(compute_dtype))
    _close_params(tff, jff, _tol(compute_dtype), p0)
    xe, ye = _data(3 * BATCH, seed=3)
    _close_metrics(tff.eval(xe, ye, verbose=False), jff.eval(xe, ye, verbose=False),
                   _loss_tol(compute_dtype))


@DTYPES
def test_manual_verbs_match_jax(compute_dtype):
    jff, tff = _models("adam", compute_dtype)
    x, y = _data(2 * BATCH, seed=4)
    tol, p0 = _tol(compute_dtype), _snapshot(jff)
    for i in range(2):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        for ff in (jff, tff):
            ff.set_batch([xb], yb)
            ff.zero_gradients()
        _close(tff.forward().numpy(), jff.forward(), tol, f"forward {i}")
        jff.backward()
        tff.backward()
        jff.update()
        tff.update()
    _close_params(tff, jff, tol, p0, adam_steps=2)


def test_fit_runs_epochs_and_learning_rate_is_live():
    _, tff = _models("sgd", None)
    x, y = _data(2 * BATCH, seed=5)
    hist = tff.fit(x, y, batch_size=BATCH, epochs=2, verbose=False)
    assert len(hist) == 2 and all(np.isfinite(h.mse_loss) for h in hist)
    before = {op: {w: t.clone() for w, t in ws.items()}
              for op, ws in tff.compiled.params.items()}
    tff.set_learning_rate(0.0)
    tff.fit(x, y, epochs=1, verbose=False)
    for op, ws in tff.compiled.params.items():
        for w, t in ws.items():
            assert torch.equal(t, before[op][w]), f"{op}.{w} moved at lr 0"


def test_labels_of_the_wrong_shape_are_rejected():
    _, tff = _models("sgd", None)
    x, y = _data(BATCH, seed=7)
    for bad in (y[..., 0], np.repeat(y, 2, axis=-1)):  # would broadcast in the MSE
        with pytest.raises(ValueError, match="per-sample shape"):
            tff.fit(x, bad, verbose=False)
        with pytest.raises(ValueError, match="per-sample shape"):
            tff.set_batch([x], bad)


def test_grads_reach_every_param_and_params_stay_leaves():
    _, tff = _models("sgd", None)
    x, y = _data(BATCH, seed=6)
    cm = tff.compiled
    grads = cm.grad_step(cm.params, None, torch.from_numpy(x), torch.from_numpy(y))
    for op, ws in cm.params.items():
        for w, t in ws.items():
            assert grads[op][w].shape == t.shape and grads[op][w].dtype == torch.float32
            assert grads[op][w].abs().sum() > 0, f"{op}.{w} got no gradient"
            assert t.grad_fn is None and not t.requires_grad


def test_attention_dropout_raises_while_training():
    """Attention dropout trains: a step with a key drops (the same key the
    same gradients), a step without one drops nothing, as the reference's
    op; what still raises while training is a Dropout op's draw without
    the step's key. Inference and eval run without dropout, as the JAX
    package's do."""
    tff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    x = tff.create_tensor((BATCH, 16, 32))
    tff.dense(tff.multihead_attention(x, x, x, 32, 2, dropout=0.1), 1)
    tff.compile(optimizer=SGDOptimizer(), loss_type="mse")
    xb, yb = _data(BATCH)[0][:, :16, :32], np.zeros((BATCH, 16, 1), np.float32)
    xb = np.ascontiguousarray(xb)
    cm = tff.compiled
    batch = (torch.from_numpy(xb), torch.from_numpy(yb))
    g_none, g1, g1b, g2 = (cm.grad_step(cm.params, key, *batch) for key in (None, 1, 1, 2))

    def same(a, b):
        return all(torch.equal(a[op][w], b[op][w]) for op in a for w in a[op])

    assert same(g1, g1b) and not same(g1, g_none) and not same(g1, g2)
    assert torch.equal(cm.eval_step(cm.params, *batch)[0], cm.eval_step(cm.params, *batch)[0])
    tff.set_batch([xb], yb)
    assert tff.forward().shape == (BATCH, 16, 1)
    drop = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    xd = drop.create_tensor((BATCH, 16, 32))
    drop.dense(drop.dropout(xd, 0.5), 1)
    drop.compile(optimizer=SGDOptimizer(), loss_type="mse")
    with pytest.raises(ValueError, match="rng"):
        drop.compiled.train_step(drop.compiled.params, drop.compiled.opt_state, None, *batch)
    drop.set_batch([xb], yb)
    drop.backward()  # the verbs pass the model's step key
    drop.update()
