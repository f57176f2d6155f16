"""Gradient accumulation: the port's ``grad_accum_steps`` against the JAX
package's.

The same batches go through three ``train_step``s of each package with K
microbatches, K in {2, 4}, for an MLP (SGD with momentum) and a tiny GPT
(2 layers, vocab 64, S 32, SGD; the JAX package's Pallas kernels in the
interpreter): the losses, the params and the metrics agree within
``F32_TOL``, the counts exactly. BatchNorm's running statistics advance
once a step, from the mean of the microbatches' statistics, as the JAX
package's do; a batch that K does not divide raises. No dropout runs here:
the packages draw a microbatch's mask from different keys, so parity holds
at rate 0.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.ffconst import MetricsType as JMetricsType
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType, MetricsType,
                                SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch.models import GPTConfig, build_gpt
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

# f32, relative to the largest value compared: the same graphs in the same
# precision, sums in another order, over three updates
F32_TOL = 2e-5
METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")
V, S = 64, 32


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


@pytest.fixture(autouse=True)
def _jax_init(monkeypatch):
    """The JAX package draws each weight with its own jitted program; its
    compile here draws numpy normals instead (every test then copies the
    JAX params into the port)."""
    from flexflow_tpu.runtime import compiler as jcompiler

    def init_params(ops, mesh, seed, dtype_override=None):
        rng = np.random.default_rng(seed)
        params, shardings, wd_mask = {}, {}, {}
        for op in ops:
            for ws in op.weight_specs():
                fan_in = ws.shape[0] if len(ws.shape) > 1 else 10
                a = rng.normal(size=ws.shape) / np.sqrt(fan_in)
                if ws.name in ("scale", "running_var"):
                    a = 1.0 + 0.1 * a
                params.setdefault(op.name, {})[ws.name] = jax.numpy.asarray(
                    a, dtype_override or ws.dtype.to_jnp())
                shardings.setdefault(op.name, {})[ws.name] = jcompiler._named_sharding(
                    mesh, op.weight_shapes[ws.name])
                wd_mask.setdefault(op.name, {})[ws.name] = ws.weight_decay
        return params, shardings, wd_mask

    monkeypatch.setattr(jcompiler, "init_params", init_params)


_JKW = dict(ledger="off", audit_programs="off", attribution="off")


def _jcompile(jff, opt, loss=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY):
    jff.compile(optimizer=opt, loss_type=loss,
                metrics=[getattr(JMetricsType, m) for m in METRICS],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    return jff


def _tcompile(ff, opt, loss=LossType.SPARSE_CATEGORICAL_CROSSENTROPY):
    ff.compile(opt, loss, [getattr(MetricsType, m) for m in METRICS])
    return ff


@functools.lru_cache(maxsize=None)
def _mlp_pair(k):
    jff = JFFModel(JFFConfig(batch_size=8, grad_accum_steps=k, **_JKW))
    x = jff.create_tensor((8, 16), name="input")
    jff.dense(jff.dense(x, 32, JActiMode.RELU, name="body"), 4, name="head")
    ff = FFModel(FFConfig(batch_size=8, grad_accum_steps=k, device="cpu"))
    t = ff.create_tensor((8, 16), name="input")
    ff.dense(ff.dense(t, 32, ActiMode.RELU, name="body"), 4, name="head")
    args = dict(lr=0.1, momentum=0.9)
    return _jcompile(jff, JSGDOptimizer(**args)), _tcompile(ff, SGDOptimizer(**args))


@functools.lru_cache(maxsize=None)
def _gpt_pair(k):
    shape = dict(vocab_size=V, max_positions=S, hidden_size=32, num_heads=4, num_layers=2)
    jff = JFFModel(JFFConfig(batch_size=4, grad_accum_steps=k, **_JKW))
    jbuild_gpt(jff, 4, S, JGPTConfig(**shape))
    ff = FFModel(FFConfig(batch_size=4, grad_accum_steps=k, device="cpu"))
    build_gpt(ff, 4, S, GPTConfig(**shape))
    return _jcompile(jff, JSGDOptimizer(lr=0.5)), _tcompile(ff, SGDOptimizer(lr=0.5))


def _mlp_batches(seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(8, 16)).astype(np.float32),
             rng.integers(0, 4, size=(8, 1)).astype(np.int32)] for _ in range(3)]


def _gpt_batches(seed=0):
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (4, S)).copy()
    out = []
    for _ in range(3):
        tok = rng.integers(0, V, size=(4, S + 1)).astype(np.int32)
        out.append([tok[:, :-1].copy(), pos, tok[:, 1:].copy()])
    return out


def _steps(pair, batches):
    """Three train_steps in each package from the same params; returns
    ((jax losses, jax metrics), (port losses, port metrics))."""
    jff, ff = pair
    jcm, cm = jff.compiled, ff.compiled
    load_numpy_params(ff, {op: {w: np.asarray(v) for w, v in ws.items()}
                           for op, ws in jcm.params.items()})
    cm.opt_state = ff.optimizer.init_state(cm.params)
    jparams, jopt = jcm.params, jff.optimizer.init_state(jcm.params)
    jl, tl, jm, tm = [], [], [], []
    for i, b in enumerate(batches):
        jparams, jopt, loss, bm = jcm.train_step(jparams, jopt, jax.random.key(i),
                                                 *[jax.numpy.asarray(a) for a in b])
        jl.append(float(loss))
        jm.append({k: float(v) for k, v in bm.items()})
        cm.params, cm.opt_state, loss, bm = cm.train_step(
            cm.params, cm.opt_state, i + 1, *[torch.from_numpy(a) for a in b])
        tl.append(float(loss))
        tm.append({k: float(v) for k, v in bm.items()})
    return jparams, (jl, jm), (tl, tm)


def _close_tree(got, want, tol=F32_TOL):
    for op in want:
        for w in want[op]:
            b = np.asarray(want[op][w])
            a = got[op][w].detach().numpy()
            assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), (op, w)


def _check(pair, batches):
    jparams, (jl, jm), (tl, tm) = _steps(pair, batches)
    np.testing.assert_allclose(tl, jl, rtol=F32_TOL)
    for a, b in zip(tm, jm):
        assert set(a) == set(b)
        assert (a["count"], a["correct"]) == (b["count"], b["correct"])
        assert a["sparse_cce_loss"] == pytest.approx(b["sparse_cce_loss"], rel=F32_TOL)
    _close_tree(pair[1].compiled.params, jparams)


@pytest.mark.parametrize("k", [2, 4])
def test_mlp_accumulation_matches_jax(k):
    _check(_mlp_pair(k), _mlp_batches())


@pytest.mark.parametrize("k", [2, 4])
def test_gpt_accumulation_matches_jax(k):
    _check(_gpt_pair(k), _gpt_batches())


def test_accumulation_averages_to_the_full_batch_gradient():
    """K microbatches of equal size give the full batch's mean gradient:
    one step with K = 4 lands within F32_TOL of K = 1 (SGD without
    momentum, the same params)."""
    b = _mlp_batches(seed=3)[0]
    after = {}
    for k in (1, 4):
        ff = FFModel(FFConfig(batch_size=8, grad_accum_steps=k, device="cpu", seed=5))
        t = ff.create_tensor((8, 16), name="input")
        ff.dense(ff.dense(t, 32, ActiMode.RELU, name="body"), 4, name="head")
        _tcompile(ff, SGDOptimizer(lr=1.0))
        cm = ff.compiled
        cm.train_step(cm.params, cm.opt_state, 1, *[torch.from_numpy(a) for a in b])
        after[k] = {op: {w: t.detach().numpy() for w, t in ws.items()}
                    for op, ws in cm.params.items()}
    for op in after[1]:
        for w in after[1][op]:
            np.testing.assert_allclose(after[4][op][w], after[1][op][w], rtol=0,
                                       atol=F32_TOL * np.abs(after[1][op][w]).max())


def _cnn_pair(k):
    jff = JFFModel(JFFConfig(batch_size=4, grad_accum_steps=k, **_JKW))
    x = jff.create_tensor((4, 3, 6, 6), name="image")
    jff.dense(jff.flat(jff.batch_norm(jff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="conv"),
                                      name="bn"), name="flat"), 4, name="head")
    ff = FFModel(FFConfig(batch_size=4, grad_accum_steps=k, device="cpu"))
    t = ff.create_tensor((4, 3, 6, 6), name="image")
    ff.dense(ff.flat(ff.batch_norm(ff.conv2d(t, 4, 3, 3, 1, 1, 1, 1, name="conv"),
                                   name="bn"), name="flat"), 4, name="head")
    return _jcompile(jff, JSGDOptimizer(lr=0.05)), _tcompile(ff, SGDOptimizer(lr=0.05))


def test_batch_norm_statistics_advance_once_from_the_mean():
    rng = np.random.default_rng(4)
    batches = [[rng.normal(size=(4, 3, 6, 6)).astype(np.float32) + 2.0,
                rng.integers(0, 4, size=(4, 1)).astype(np.int32)] for _ in range(3)]
    pair = _cnn_pair(2)
    jparams, _, _ = _steps(pair, batches)
    bn = pair[1].compiled.params["bn"]
    for w in ("running_mean", "running_var"):
        np.testing.assert_allclose(bn[w].detach().numpy(), np.asarray(jparams["bn"][w]),
                                   rtol=F32_TOL, atol=1e-6)
    # one EMA advance a step from the microbatches' mean statistics: after
    # the first step the running mean sits at momentum * the batch mean
    ff = _cnn_pair(2)[1]
    cm = ff.compiled
    mean0 = cm.params["bn"]["running_mean"].clone()
    conv = torch.nn.functional.conv2d(torch.from_numpy(batches[0][0]),
                                      cm.params["conv"]["kernel"].detach(),
                                      cm.params["conv"]["bias"].detach(), padding=1)
    micro = torch.stack([c.mean(dim=(0, 2, 3)) for c in conv.chunk(2)]).mean(0)
    cm.train_step(cm.params, cm.opt_state, 1, *[torch.from_numpy(a) for a in batches[0]])
    got = cm.params["bn"]["running_mean"]
    m = float(((got - mean0) / (micro - mean0)).mean())
    np.testing.assert_allclose(got.numpy(), (1 - m) * mean0.numpy() + m * micro.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_indivisible_batch_raises():
    ff = FFModel(FFConfig(batch_size=8, grad_accum_steps=3, device="cpu"))
    t = ff.create_tensor((8, 16), name="input")
    ff.dense(t, 4, name="head")
    _tcompile(ff, SGDOptimizer(lr=0.1))
    b = _mlp_batches()[0]
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps 3"):
        ff.fit(b[0], b[1], verbose=False)
